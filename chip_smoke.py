"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. the card: exit non-zero without CUDA; print the card's name and
     power limit as ``nvidia-smi`` reports them;
  2. build: compile every kernel from ``csrc/`` (one ``nvcc`` per
     source, all started together);
  3. kernels: each packed-GEMM kernel (K1 none, K2 sign, K3 affine
     epilogue; each packs fp32 x itself) against its plain PyTorch
     version (``pack_bits`` then the GEMM) on the card, ``torch.equal``,
     at the serving paths' shapes (K1 at every (K, N) of the LM's
     projections and at the MLP's layer 2), at ragged and multi-chunk
     shapes, and with g < 0, g == 0 and exact tie columns: on ±1 x, and
     on raw x with zeros, -0.0, NaN, ±inf and subnormals under both pack
     rules (x > 0; x >= 0, the LM's binarizing K1 entry), two runs
     ``torch.equal``; K1 is timed at M = 1, 4, 16, 32, 64 and 256, each
     row with its entry's time (``entry_ms``);
     K7 (fused bitplane-unpack GEMM, bf16 ``mma.sync`` on an exact
     three-piece split of x) the same way on ±1 x and to rtol 1e-5 on
     real x, two runs bitwise equal; K8 (paged attention) against the
     gather path to atol = rtol = 1e-5 in decode, prefill (16 and 20
     queries) and verify shapes over scrambled, reused and null pages,
     at head dims 64, 36, 7 and 128, then every query of a 4-slot decode
     call and of two 16-query prefill chunks against the same query
     launched alone, and two runs, ``torch.equal``. Then CUDA-graph
     timings of each kernel at its main path's shapes (K7 also at M = 1
     and 64; K8 at decode, prefill and verify), its plain version, one
     PyTorch library call computing the same function, and the bound;
     and the floor under any launch, an in-place add on one element
     (``launch_floor_ms``);
  4. MLP slice: ``bnn-mlp-large`` at full width (784-3072-1536-768-10)
     from a seeded ``torch.Generator`` with random BN statistics,
     frozen, exported, ``load_packed`` on ``cuda``, checked against the
     live eval model, then served by the port's HTTP server (batch 32)
     and queried through the port's client; the launch counters are
     zeroed just before this phase and read just after it. Then the
     frozen predictor's time per batch of 32 on the host clock and, from
     ``torch.profiler``, its device time, kernel launches and largest
     kernels;
  5. LM slice: the ``BinarizedLM`` of ``bench.py --lm-serve-bench``
     (vocab 256, max_len 256, embed 256, depth 4, 4 heads, MLP 512)
     from a seeded ``torch.Generator`` with random biases and LayerNorm
     parameters, frozen and exported; a 60-token
     sequence teacher-forced through the paged decoder (K7 prefill, K1
     decode projections, K8 attention) and the contiguous decoder on the
     card; then the continuous-batching server (4 slots, pages of 16)
     answers 6 concurrent greedy ``/generate`` requests (prompts of 5 to
     150 tokens, 32 new tokens each, one sent as text), each stream
     equal to the decoder driven directly for that prompt alone. The
     counters are zeroed just before the requests and read just after:
     K1 24 times (4 blocks x 6 projections) per decode iteration, K7 24
     times per prefill chunk and K8 once a layer per decode iteration and
     per prefill chunk. Then decode-iteration and prefill-chunk times,
     device time and kernel launches from ``torch.profiler``, and the
     requests' time to first token and time per token;
  6. flash attention: K4 (forward: exact fp32 scores, P V in 3xTF32 on
     the tensor cores), K5 (dq) and K6 (dk, dv; 3xTF32) against their
     plain versions on the card at
     the six shapes of ``tests_tpu/test_hardware_kernels.py``, at the
     training width (B, H, L, D) = (8, 4, 1024, 64), causal, and at two
     ragged head dims: out and lse to atol = rtol = 2e-5, the gradients
     (g_lse != 0) to ``FLASH_GRAD_TOL``; two runs of each kernel bitwise
     equal. Then CUDA-graph timings at the training width against the
     plain versions, PyTorch's fp32 memory-efficient attention (SDPA's
     forward for K4; its backward kernel, also in a CUDA graph, for K5,
     K6 and the port's whole backward, ``flash_bwd_total``) and the
     bound;
  7. LM training: the ``bench.py --lm-bench`` step (vocab 256, max_len
     1024, embed 256, depth 4, 4 heads, MLP 512, batch 8 x 1024, Adam
     1e-3, latent clamp). One step with flash attention against one with
     the exact softmax from the same seeded weights (random biases and
     LayerNorm parameters) and batch: losses within 1e-4 relative, each
     parameter's gradient within ``LM_GRAD_RTOL`` in relative L2 norm
     (the key bias's, exactly 0 in exact arithmetic, printed). Then
     ``examples/lm_demo.py::run`` trains 20 steps on the periodic corpus
     with flash attention and exports the model, the counters zeroed
     just before and read just after: each flash kernel launched
     depth x steps times, every loss finite, the last below the first.
     A second run from the same seed must give a bitwise-equal loss
     history, as the JAX package's training does; the token embedding's
     one-hot weight gradient, which makes it so, is timed against
     PyTorch's embedding backward.
     The artifact's full forward is held against the trained model.
     Then step time on the host clock and device time from
     ``torch.profiler``;
  8. MLP training: ``train.Trainer`` trains ``bnn-mlp-large`` (Adam
     0.01, batch 64, seed 0, backend bf16, dropout 0.3) one epoch of the
     synthetic 19,200/10,000 split (300 steps), evaluated before and
     after: every logged loss finite, the epoch's train loss below the
     first logged one, test accuracy above 55 and up by 20 points (the
     JAX package's convergence test). The trained model is checkpointed,
     exported through ``cli export --checkpoint-dir`` and served by
     ``load_packed`` on a batch of 32 (K2 and K3, counted) against the
     live eval model: argmax equal, log-probs within 1e-4. Two runs of 50
     steps from one seed with dropout give bitwise-equal loss histories
     and parameters. 20 steps on each of the xla, int8, xnor and
     pallas_xnor backends (dropout 0) give bitwise-equal loss histories
     and parameters, and the pallas_xnor run launches K1 exactly 40
     times (layers 2 and 3; layer 1 runs xla). Then the step time and
     examples per second on the host clock twice: of the epoch above,
     in this process after phases 1-7, and of the same training (seed
     0, one epoch) run through ``cli train`` in a process of its own,
     which must also converge; and the device time, kernels per step and
     busy share (against both step times) of a bf16 and a pallas_xnor
     step from ``torch.profiler``, K1's share beside the cuBLAS GEMMs.
     The first is the step in a process that has run phases 1-7
     (``torch.profiler`` sessions, objects left alive); the second is
     the step a user of ``cli train`` sees
     (``scripts/torch_mlp_train_timing.py`` times the step before and
     after each earlier phase);
  9. data-parallel MLP training (``parallel/``, ``train.Trainer`` with
     ``data_parallel``; ``MLP_TRAIN`` with dropout 0): (a) one NCCL rank
     a card, 50 steps of the 1-bit exchange with error feedback
     (``sign_ef``): every rank's state bitwise equal, and at world 1
     equal to a single-process ``Trainer(grad_compress="sign_ef")``;
     then ``cli train --dp auto --grad-compress sign_ef`` one epoch of
     100 steps (``DP_CLI_SYNTH``) in a process of its own, which must
     converge; (b) 4 gloo ranks sharing
     card 0 (16 rows each of the global batch of 64): the first 100
     steps of the epoch (``DP_EPOCH_STEPS``) uncompressed (global-batch
     BatchNorm, the gradients averaged in DDP's order) and again with
     ``sign_ef``, each passing phase 8's
     convergence thresholds (which 100 steps in one process meet too,
     checked beside), ``sign_ef`` within 2 points of the uncompressed
     run, then 10 steps of ``sign`` (majority vote, lr 0.001); (c) 10
     steps of (b)'s ``sign_ef`` on pallas_xnor and on xla (bf16 rounds
     layer 1's raw pixels, which the ±1 backends take in fp32), bitwise
     equal, K1 launched exactly 2 x 10 times in every rank (counted in
     each rank, zeroed just before the run); (d) 10 steps of the
     two-level exchange (2 hosts x 2). The ranks also run the three
     demos (``examples/demos.py``), which phase 22 checks. In every run the ranks end
     bitwise equal, every logged loss is finite, and each rank's wire
     bytes per step, measured from the buffers its collectives were
     handed, equal ``CommPlan.wire_bytes_per_step`` (the fp32 plan
     uncompressed; ``HierPlan``'s intra and inter bytes in (d)). Each
     run prints its step time on the host clock, examples per second,
     the exchange's time per step from CUDA events around the
     optimizer's transform and the wire bytes;
 10. the conv families: (a) K1 against its plain version, ``torch.equal``,
     on ±1 x and on patches with zero taps, two runs equal, at the conv
     path's shapes (``CNN_K1_SHAPES``: conv2's patch GEMM (B*196, 576,
     128) and the dense layer (B, 6272, 1024; 196 words, packed to 256)
     at batch 32 and 64), each timed in a CUDA graph beside its plain
     version, bf16 ``torch.matmul`` and its bound; (b) ``bnn-cnn`` at
     its defaults (widths 64, 128, hidden 1024) trained through
     ``train.Trainer`` on bf16 for the 200 steps of a synthetic
     12,800/2,048 split (loss falls, test accuracy above 55 and up 20
     points), two bf16 runs of 30 steps bitwise equal, 20 steps each on
     xla, xnor and pallas_xnor from one seed (K1 exactly twice a
     pallas_xnor step, the counters zeroed just before and read just
     after; pallas_xnor and xnor, one lowering, bitwise equal; the
     trained model's logits on pallas_xnor equal to those on xla), and
     each step's device time, kernels and K1 time from ``torch.profiler``;
     (c) the trained model through ``cli export --checkpoint-dir``,
     ``load_packed`` on the card against the live model (first conv
     fp32; argmax equal, atol 1e-4; K1 exactly twice a batch), served
     over HTTP at batch 32 (K1 twice per predictor batch, the warm-up
     included; every answer equal to the predictor), with the
     predictor's host and device time a batch; (d) ``convnet`` and
     ``deep-cnn``, 100 steps each at fp32 and at bf16 (the loss falls),
     step and device times, then ``scripts/torch_conv_fp32_check.py`` in
     a process of its own: ``cli train --model convnet``, which sets no
     TF32 flag, must give conv outputs within fp32 rounding of a float64
     conv; (e) 20 steps of ``convnet`` uncompressed and of ``bnn-cnn``
     with ``sign_ef`` on pallas_xnor over 2 gloo ranks sharing card 0
     (and ``convnet`` over NCCL, one rank a card, where there are two or
     more cards): ranks bitwise equal, wire bytes a step equal to the
     plan's, K1 twice a step in each rank. K1's launches on these paths
     enter the kernels line as ``launches_conv_path``, and its conv-shape
     rows as ``conv_shapes``;
 11. the training runtime (``RT_TRAIN``: phase 8's recipe on
     ``pallas_xnor``, dropout 0.3, two epochs of a synthetic 6,400/1,024
     split, 100 steps each): (a) ``cli train --checkpoint-dir`` in a
     subprocess, sent SIGTERM once epoch 1 has logged step 30, must exit
     75 with a mid-epoch checkpoint, and ``cli train --resume`` exit 0
     with a final checkpoint equal in every tensor (params, batch stats,
     optimizer state) to an uninterrupted ``cli train``'s, run beside
     it; (b) the same run in this process, again with
     ``timing_csv_prefix`` (equal states; step and dispatch times with
     and without the CSVs), the checkpoint's bytes and its save
     (synchronous, async handoff and total), digest and restore times;
     (c) the stopped checkpoint with its newest generation truncated
     rolls back to the one before it and (d) the stopped checkpoint
     shipped over loopback by ``utils.transfer`` (MB/s printed), each
     resumed in this process and ending on the uninterrupted state;
     (e) the trained model exported by ``cli export`` to the JAX
     package's msgpack artifact and served through K2/K3 on a batch of
     32, within 1e-4 of the live model; (f) two "nodes" of one gloo rank
     each sharing the card, meeting at ``tcp://127.0.0.1:<free port>``,
     20 ``sign_ef`` steps on ``pallas_xnor`` bitwise equal to one
     ``spawn`` of 2 run beside them, K1 twice a step in every rank.
     K1's launches in (b)-(d) and (f)'s nodes and K2/K3's in (e) enter
     the kernels line as ``launches_runtime_path``;
 12. the captured training step (``train.capture``: ``scan_steps``,
     ``device_data``, ``grad_accum``, ``remat``): (a) phase 8's recipe
     (dropout 0.3, bf16) one epoch of a synthetic 20,480/2,048 split
     (160 steps) eager, with ``scan_steps=8`` (20 graph replays) and
     with ``device_data`` (the dataset on the card, 64-step graphs):
     parameters, BatchNorm statistics, Adam's state and the train
     generator ``torch.equal``, each dispatch's mean loss the mean of
     the eager losses it covers, the device eval's counts equal and its
     loss within ``SCAN_EVAL_RTOL`` of the streaming eval's; (b)
     ``pallas_xnor``, dropout 0, 40 steps eager against ``scan_steps=8``,
     bitwise, K1 launched 2 x 40 times inside the graphs (recorded
     launches x replays), and ``torch.profiler`` sees as many K1
     kernels a replay as the capture recorded; (c) ``remat`` (eager
     and captured) bitwise the plain step, ``grad_accum=4`` captured
     bitwise eager, dropout 0.3; (d) a ``scan_steps=8`` run stopped
     in-process after 5 dispatches checkpoints at batch 40 and resumes
     to the uninterrupted state; (e) ``bnn-cnn`` on bf16 captured
     (``scan_steps=4``, its convs in ``conv_precision``) bitwise eager;
     (f) ``cli train --scan-steps 8 --device-data`` one 19,200-example
     epoch in a process of its own, converging. Then the host step time,
     examples/s, device time a step and busy share (``torch.profiler``)
     of eager, scan and device-data, replays, capture seconds and each
     graph's pool bytes. K1's launches here enter the kernels line as
     ``launches_capture_path`` (eager launches plus those run inside
     graphs) and ``launches_in_graphs``;
 13. data parallelism captured (``parallel.fsdp``, ``SignCompressFsdp``,
     ``parallel.remesh``, ``TrainScan`` over the data-parallel steps), in
     this process as the one rank of an NCCL group: (a) fp32 FSDP and
     compressed FSDP bitwise the single-card trainers'; (b) uncompressed
     DP, flat ``sign_ef``, fp32 FSDP and compressed FSDP each eager and
     with ``scan_steps=8`` (and ``device_data``), bitwise, K1 2 x steps
     times inside the graphs, wire bytes recorded x replays equal to the
     plans; (c) ``grad_accum`` and ``remat`` captured bitwise eager; (d)
     a 2-rank gloo ``sign_ef`` checkpoint resumed at world 1 with
     ``elastic``; (e) ``cli train --dp-mode fsdp --scan-steps 8
     --device-data`` in a process of its own. K1's launches enter the
     kernels line as ``launches_dp_capture_path``;
 14. model parallelism (``parallel.mesh``, ``model_parallel``,
     ``pipeline``, ``pipeline_model``, ``tp_pipeline``), gloo ranks
     sharing the card: (a) ``bnn-mlp-large`` at full width on
     pallas_xnor, 10 SGD steps at tp = 2 and at data 2 x model 2 against
     the single-process trainer (losses 1e-4, parameters 1e-3), ranks'
     losses equal, replicated leaves bitwise equal, K1 2 x 10 times in
     each rank, wire bytes a step equal to the plan in PERF.md, the
     trained model's forward up to the head ``torch.equal`` to the
     unsharded model's; (b) the LM at the --lm-bench width, flash
     attention, pipelined over 2 stages of 2 microbatches: the forward
     within 1e-4 of the sequential one, each of 5 Adam steps (loss,
     gradients within ``LM_GRAD_RTOL``) against the sequential step on
     the same parameters, 5 steps of ``lm_demo.run(pp=2)`` twice bitwise
     equal, K4, K5 and K6 20 times in each rank; (c) ``cli train --model
     bnn-vit-tiny --pp 2`` one epoch, converging, in a process of its
     own; (d) ``make_tp_pipeline_fn`` at (data 1, model 2, pipe 2), each
     of 5 SGD steps against ``tp_pipeline_reference`` on the same
     parameters (output, loss, gradients); K1 at
     the shards' shapes equal to its plain version and timed
     (``mp_shapes`` in K1's row). K1's and K4-K6's launches enter the
     kernels line as ``launches_mp_path``.
 16. model parallelism finished (``mp2_phase``): (a) a row-parallel
     ``BinarizedDense(scale=True)`` at tp 2 on gloo ranks sharing the
     card: the all-reduced +-1 sums ``torch.equal`` to the unsharded
     GEMM's, alpha and the output within 1e-6 of the unsharded layer's;
     (b) bnn-vit-tiny at tp 2, pallas_xnor, flash attention, the alpha:
     3 steps each against the unsharded step on the same parameters;
     (c) the TP and pipelined steps captured at one NCCL rank in this
     process, bitwise eager, launches recorded x replays. K1 and K4-K6
     enter the kernels line as ``launches_mp2_path``;
 17. the fault-tolerant runtime (``resilience_phase``): (a) chaos
     ``step_fault``, ``preempt`` and ``ckpt_corrupt`` in one
     ``Trainer.fit`` under ``run_with_policy``, bitwise the
     uninterrupted run, ``fault_injected`` records equal to the fires;
     (b) elastic DP 2 -> 1 -> 2 on gloo ranks and (c) two host
     processes through ``host_lost`` and ``host_restore``, run at once,
     each generation bitwise a fresh resume of the one before; (d) both
     servers under ``infer_error`` (the breaker opens and closes; the
     LM engine retries). K1-K3, K7 and K8 enter the kernels line as
     ``launches_resilience_path``.
 18. transformer serving finished and ring attention
     (``transformer_phase``): first K1 at the ViT's projections (M =
     1,568: 32 images of 49 tokens) and K4-K6 at the ring's per-rank
     shapes (8, 4, 512, 512, 64), causal and full, against their plain
     versions and timed (``vit_shapes`` in K1's row, ``ring_shapes`` in
     K4-K6's); then, while (d) runs in the background: (a)
     ``bnn-vit-small`` with drawn biases and LayerNorm parameters
     frozen, exported and served over HTTP at micro-batch 32, every
     answer against the CPU plain predictor and the live eval forward
     (argmax equal, log-probs within ``VIT_LOGPROB_ATOL``, example by
     example), K1 24 times a batch; (b) the verifier's bf16 GEMM bitwise
     K1 at K = 999 (sums of +-999), then the LM of phase 5 with
     ``spec_k = 4`` on ``LM_PROMPTS`` token for token the ``spec_k = 1``
     engine, every decoder call's kernels counted, K8's verify launches
     > 0, the acceptance rate printed; (c) requests behind a shared
     two-page prefix through the prefix cache and a cold engine: tokens
     equal, K7 and K8 down by the shared pages, an undersized pool
     evicting LRU entries, spec decoding with the cache equal to it
     without; (e) ``cli lm --load --sample 32`` in this process, greedy
     at temperature 0, one seed's two draws at 0.8 equal. (d): 2 gloo
     ranks sharing the card run the ring at the LM training width
     (batch 8, 4 heads, D 64, L 1,024): the flash local step's forward
     and backward (its K4-K6 launches counted) against ``flash_attention``
     over the whole sequence, the dense one against
     ``attention_reference``, and one ``lm_demo.ring_train_step``
     against a plain step on the same parameters. K1, K7, K8 and K4-K6
     enter the kernels line as ``launches_vit_path``,
     ``launches_spec_path``, ``launches_prefix_path`` and
     ``launches_ring_path``, and K8's row carries ``launches_verify``.
 15. observability (``obs/``; the trainer's and both servers'
     telemetry), run last, ~14 min into the process: (a)
     ``bnn-mlp-large`` on pallas_xnor, batch 64, a 50-step epoch through ``Trainer.fit`` with ``telemetry_dir``,
     ``trace`` and the profile window 8:24, eager and at
     ``scan_steps=8``: the logs read back (``read_events``,
     ``summarize``), one step event a dispatch, examples = steps x batch,
     the build counter's captures = ``TrainScan``'s, MFU in (0, 1], K1
     inside the window's ``jg_step`` regions as often as the counters
     launched it (taken as the window starts and stops), and what the
     capture says of the card's clock against the host's
     (``capture_clock``); (b) phase 12's captured step timed with telemetry off
     and on (printed); (c) the frozen MLP served with telemetry and
     trace: /metrics in Prometheus text counting the requests, request
     events with their span trees, a /admin/profile capture under
     traffic showing K2 and K3, a /admin/reload answering bitwise alike;
     (d) the LM served with telemetry: six streams during a capture
     showing K7 and K8, /metrics, ``lm_decode`` events. The kernels'
     launches there enter the kernels line as ``launches_obs_path``.

 19. the QNN and MoE families: K1 at the served MoE's shapes (the
     experts' (10, 512, 512), capacity ceil(1.25 * 32 * 2 / 8), and the
     head's (32, 512, 10)) ``torch.equal`` its plain version and timed
     against bf16 ``torch.matmul``; the QNN's int8 GEMM (cuBLASLt, a
     library GEMM) at (784, 3072), (3072, 1536), (1536, 768), M = 32 and
     1, its int32 sums equal to the float64 product of the same integers
     (sums past 2^24), timed against a bf16 GEMM; (a) ``qnn-mlp-large``
     trained 8 steps, exported, served over HTTP at micro-batch 32, every
     answer against the CPU plain predictor stage by stage (its two fp32
     GEMMs within fp32's a-priori error bounds, the integer layers
     bitwise from the same levels, the argmax equal; the log-prob
     differences and the flipped levels printed); (b) ``bnn-moe-mlp`` on
     pallas_xnor: a step's logged loss bitwise CE plus the recorded aux
     loss, 8 steps eager (K1 9 a step, every kernel counted from 0)
     against ``scan_steps=4`` bitwise, exported and served over HTTP (K1
     9 a served batch: 8 experts and the head), every answer
     ``torch.equal`` to the frozen path with K1's plain version on the
     card; (c) 2 gloo ranks in the background under (a)'s and (b)'s
     checks, whose timings (the served batches, the eager and the
     captured MoE step) run once the ranks have ended: the
     expert-parallel MoE at full width against
     ``moe_reference`` (output 1e-5, gradients 1e-4 relative), the
     sharded predictor of both families ``torch.equal`` the per-shard
     forwards, and one MoE step at dp 2 (global routing) and tp 2
     (experts sharded) within atol and rtol 1e-5 of the unsharded step
     on the same parameters. The kernels line's K1 row carries
     ``launches_moe_path``, ``launches_moe_train_path`` and
     ``moe_shapes``.
 20. the XNOR-ResNet family: (e) K1 at each stage's 3x3 conv of
     xnor-resnet18 at batch 64 and at resnet50's widest M (100,352
     rows), K2 at resnet50's stage-1 and stage-4 conv0, ``torch.equal``
     to their plain versions, then timed against them, bf16
     ``torch.matmul`` and the bound; then ``cli train --dataset cifar10
     --augment`` in the background under: (a) ``xnor-resnet18`` at full
     width on synthetic CIFAR-10, batch 64, ``augment``, pallas_xnor:
     20 eager steps twice from one seed, bitwise equal (K1 16 a step,
     counted from 0), the same steps at ``scan_steps=4`` bitwise the
     eager run, one bf16 step, one ``fp32-resnet18`` step; (b) (a)
     exported and served over HTTP at a micro-batch of 32, 3 batches
     (K1 16 a batch, the warm-up's too), each answer ``torch.equal`` to
     the predictor, held stage by stage to the live eval model on the
     card (each threshold against the live BatchNorm's sign: a flip
     must be a tie within ``TIE_ULPS`` ulps; the packed convs bitwise on
     the live bits; stem, shortcuts and head within fp32's a-priori
     bounds; the argmax equal) and, on 8 of its images, to the CPU's
     plain predictor (the thresholds, K1, K2 and the block sums bitwise
     from the card's inputs, the fp32 stages within their bounds); (c) ``xnor-resnet50``
     (ImageNet stem, 1000 classes) on synthetic ImageNet at 224 x 224:
     2 steps at batch 8, frozen, a micro-batch of 8 through the
     predictor (K1 32 and K2 16 a batch, counted from 0) held to the
     live model as (b), the export's bytes equal to a fresh export's
     and to its load re-serialized; (d) ``Trainer.fit_stream`` over a
     folder of PNGs written here, if PIL imports (else a line says
     where the stream is held). The served batches and an eager step
     are timed once the CLI process has ended. The kernels line's K1 and
     K2 rows carry ``launches_resnet_path``,
     ``launches_resnet_train_path`` and ``resnet_shapes``.
 21. the native loaders, the sanitizers and the serving fleet: (a) the
     native library (``native/``) built by ``g++`` from the checkout and
     loaded, no fallback; a BatchPool epoch bitwise the numpy iterator's
     batches in order, ``pack_bits_native`` bitwise ``pack_bits_np``,
     an idx file and a CIFAR-10 batch decoded natively; (b) ``cli train
     --sanitize recompile,nan --scan-steps 8 --native-loader`` on
     ``pallas_xnor`` (32 captured steps; no fence trips) and a run with
     a NaN learning rate stopped by the NaN fence with its
     ``sanitizer_trip`` event; (c) ``cli fleet`` over 2 ``cli serve``
     replicas of the frozen ``bnn-mlp-large`` on the card: full
     micro-batches through the router bitwise the in-process
     predictor's, one replica SIGKILLed under traffic (every request
     answered 200, the supervisor's replacement live), a bad artifact
     rolled out and rolled back, the router's latency against a direct
     replica's, a SIGTERM drain (rc 0, every replica's rc 0); (d) a
     2-replica ``cli fleet --lm`` whose greedy streams equal one
     in-process engine's; (e) ``convnet`` and ``bnn-moe-mlp`` with
     ``--augment``, eager and captured at ``scan_steps=4``, bitwise.
     (b)'s CLI run, (c) and (d) are processes of their own and run
     together beside (a), (b)'s trip and (e). The
     replicas' K2/K3 (classifier) and K1/K7/K8 (LM) launches come from
     their ``/metrics`` (``kernel_launches_total``): the kernels line's
     ``launches_fleet_path``.
 22. the AOT store of kernel libraries (``aot/``): (a) ``cli aot build``
     banks the classifier (``bnn-mlp-large`` at micro-batch 32), the LM
     of phase 5 with its verify program (``--spec-decode 4``) and the
     ``pallas_xnor`` train step into an empty store, ``nvcc`` into an
     empty build directory, the seconds of each source printed; (b)-(d)
     one process that cannot find ``nvcc`` (``CUDA_HOME`` at nothing, no
     ``nvcc`` on ``PATH``) boots the classifier server, the LM server
     and the trainer from the store: each a hit, zero ``kernel_build``
     records, both servers' budget-0 fences armed and never tripped,
     answers bitwise this process's predictor, greedy streams equal to
     an engine built here, the train steps bitwise the online steps; K2
     and K3, K1, K7 and K8 read from each server's ``/metrics``, K1
     from the trainer's counts (the kernels line's
     ``launches_aot_path``); (e) one byte of the classifier's banked
     library flipped and the train step's truncated, in a copy of the
     store: quarantined before any ``dlopen`` (``ctypes.CDLL`` sees only
     the rebuilt library), re-banked, answers and steps bitwise; (f) the
     cold-start worker's serve boot against an empty store and build
     directory (alone) and, as the first thing (b)-(d)'s process does,
     against the full store (alone): ``boot_s``, ``first_s``,
     ``compiles`` and the split of the process start; (g) the three
     demos (``examples/demos.py``, run in phase 9's 4 gloo ranks, held
     to the same in this process) and a one-epoch accuracy report on a
     small synthetic split.

 23. the analyses (``analysis/``), in this process's main thread with
     no background check alive: (a) ``cli lint --format json`` over the
     package as it stands on the card's host, 0 unsuppressed findings;
     (b) the lockstep check of the collective exchanges
     (``analysis/spmd.verify_shipped``) with the recorder's tensors on
     ``cuda:0``: the DP, FSDP and remesh exchanges at worlds 2, 4, 8 and
     the hierarchical one at 2x2, 2x4, 4x2 in lockstep, and a seeded
     divergence mutant (a collective issued on rank 0 only) caught at
     its index. It launches no kernel.

Phases 16 to 23 run after 14, phase 15 last. Checks that wait on
processes of their own (spawned ranks, CLI runs, host processes) run two
at a time (``_background``), never beside a kernel timing or a
``torch.profiler`` device time; the host step times those processes
print then share the host's cores, and are read as such: phase
9's gloo ranks beside its CLI run, phase 10's fresh-process fp32 check
beside its data-parallel ranks, phase 11's two nodes beside its CLI
runs, phase 12's CLI beside its checks (b)-(e) (after its times), phase
13's CLI beside its elastic ranks, phase 14's (c) beside (a)
and (d) beside (b), phase 17's (b) and (c) beside phase 16 and its own
(a), phase 18's ring ranks
beside its in-process checks (after its timings), phase 19's ranks
beside its (a) and (b) (after its timings), phase 20's CLI run beside
its (a)-(d) (after its timings), phase 21's fleets and CLI run
beside its (a) and (b), phase 22's bank beside its references and (g),
its warm process's checks beside (e). Every ``parallel.spawn``
and CLI process prints its seconds, every phase its ``phase_s``, and the
summary line before the card's name gives them all and ``total_s``.

The last lines are the per-kernel JSON lines, the card's name and power
limit, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

if __name__ == "__main__" and sys.argv[1:2] == ["--aot-child"]:
    # Phase 22's fresh processes. The cold-start worker boots first,
    # before this file imports torch, so that its split sees the import;
    # then this file's helpers run, imported as a module.
    from distributed_mnist_bnns_tpu_torch.aot import coldstart

    _SPEC = json.loads(sys.argv[3])
    if coldstart.main(_SPEC["coldstart"]) != 0:
        sys.exit(1)
    import chip_smoke

    _RC = chip_smoke.aot_child(sys.argv[2], _SPEC)
    # its line is out: exit without the interpreter's and CUDA's teardown
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(_RC)

import numpy as np
import torch

T_START = time.perf_counter()   # the process's age at each capture
H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak, the lowest
# precision the data sheet lists; a ±1 GEMM counts 2*M*N*K operations
H100_FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores (data sheet)
H100_TF32_OPS_PER_S = 495e12  # dense TF32 tensor-core peak (data sheet);
# an fp32-accurate product in 3xTF32 takes three TF32 products
H100_BF16_OPS_PER_S = 989e12  # dense bf16 tensor-core peak (data sheet);
# fp32 x times a ±1 weight is exact in three bf16 products (x in three
# pieces, ±1 exact in bf16)
# The card's rates for fp32-accurate products of fp32 operands: fp32 on
# the CUDA cores, or TF32 on the tensor cores over three (3xTF32).
FP32_RATES = {"fp32 CUDA cores": H100_FP32_OPS_PER_S,
              "3xTF32 tensor cores": H100_TF32_OPS_PER_S / 3}

MAIN_M = 32  # the MLP server's micro-batch: the shape its path runs
LAYER2 = (3072, 1536)  # (K, N) of K2 in bnn-mlp-large
LAYER3 = (1536, 768)   # (K, N) of K3

LM_WIDTH = dict(vocab=256, max_len=256, embed_dim=256, depth=4,
                num_heads=4, mlp_ratio=2)
LM_SLOTS = 4           # decode rows: K1's M on the LM path
LM_CHUNK = 16          # prefill rows: K7's M on the LM path
LM_PAGE = 16
LM_MLP1 = (256, 512)   # (K, N) of the LM's widest projection
# (K, N) of every packed LM projection: q/k/v/out, mlp1, mlp2
LM_PROJ = ((256, 256), LM_MLP1, (512, 256))
LM_PROMPTS = (5, 16, 17, 40, 100, 150)
LM_NEW_TOKENS = 32
LM_TEXT = "chip_smoke: text!"   # 17 bytes: the request sent as "text"

# (B, H, Lq, Lk, D, causal): the six shapes tests_tpu holds the Pallas
# kernels to on the TPU, then the training width, which is timed.
FLASH_SHAPES = (
    (2, 4, 256, 256, 64, False), (2, 4, 256, 256, 64, True),
    (1, 2, 512, 512, 128, True), (1, 1, 7, 7, 16, False),
    (1, 2, 200, 333, 64, False), (1, 2, 96, 128, 64, True),
    (8, 4, 1024, 1024, 64, True),
)
# Head dims that are no multiple of 8 (D = 36: 16-byte copies, a zero-filled
# tail) and of 4 (D = 7: 4-byte copies), checked before FLASH_SHAPES.
FLASH_EDGE_SHAPES = ((1, 2, 33, 40, 36, False), (1, 3, 70, 99, 7, True))
# The gradients sum up to 1024 products of O(1) terms in another order
# than the plain version's einsums, so they agree to fp32 rounding of
# such sums, not bitwise.
FLASH_GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
# The flash LM step's gradients against the exact-softmax step's, each
# parameter in relative L2 norm: ten times the kernels' own gradient
# tolerance, for four blocks of attention backward stacked.
LM_GRAD_RTOL = 1e-3
# bench.py --lm-bench (_bench_lm, bench.py:840-909; widths :1739-1743)
LM_TRAIN = dict(vocab=256, embed_dim=256, depth=4, num_heads=4, mlp_ratio=2)
LM_TRAIN_SEQ, LM_TRAIN_BATCH, LM_TRAIN_LR, LM_TRAIN_STEPS = 1024, 8, 1e-3, 20
# MLP training: the flagship's MIGRATION.md recipe, one epoch of a
# synthetic 19,200/10,000 split (300 steps of 64; cut from the 60,000
# examples' 937 steps for phase 20's time: 300 steps reached 100% test
# accuracy against phase 8's thresholds, 55 and a 20-point gain).
MLP_TRAIN = dict(model="bnn-mlp-large", batch_size=64, optimizer="adam",
                 learning_rate=0.01, seed=0)
MLP_SYNTH = (19200, 10000)
MLP_DET_STEPS = 50          # two runs from one seed, dropout on
MLP_BACKEND_STEPS = 20      # per backend, dropout 0, deterministic signs
MLP_TRAIN_BACKENDS = ("xla", "int8", "xnor", "pallas_xnor")
# the JAX test_trainer_end_to_end_convergence thresholds
MLP_MIN_ACC, MLP_MIN_GAIN = 55.0, 20.0
# Data-parallel training (phase 9): MLP_TRAIN, dropout 0.
DP_NCCL_STEPS = 50          # (a) sign_ef, one NCCL rank a card
DP_GLOO_RANKS = 4           # (b)-(d) gloo ranks sharing card 0: 16 rows each
# (b) the epoch cut to its first steps: the whole 937 took phase 9
# to 366 s on an H100 80GB HBM3 at 700 W (gloo moves each collective
# through the host; the uncompressed step took 130 ms, the sign_ef one
# 107). Phase 8's convergence thresholds hold, and the single-process
# steps must meet them too (checked beside). Cut from 300 steps
# for phase 15's time (300 reached 100% test accuracy on the synthetic
# split, against the thresholds' 55 and a 20-point gain).
DP_EPOCH_STEPS = 100        # cut from 150 for phases 16 and 17 (at 50
# the epoch's mean loss stays above its first step's: the check fails)
# (a) cli train --dp auto: 100 steps of 64 (cut from the whole 937 for
# phases 16 and 17; phase 13's CLI converges in as many)
DP_CLI_SYNTH = (6400, 1024)
# (b) majority vote (JAX's lr): ranks equal and the plan's bytes, no
# convergence threshold; cut from 200 steps in PR 15 for phase 14's time
DP_SIGN_STEPS, DP_SIGN_LR = 10, 0.001   # 50 before phases 16 and 17,
# 20 before phase 22
DP_SHORT_STEPS = 10         # (c) K1 under DP, (d) two-level (20 before
# phase 22)
DP_HOSTS = 2                # (d) 2 hosts x 2 local ranks
# Conv families (phase 10): bnn-cnn at its defaults (widths 64, 128,
# hidden 1024); K1 at its serving (batch 32) and training (batch 64)
# shapes: conv2's patch GEMM (B*196, 9*64, 128), the dense layer (B,
# 49*128, 1024).
CNN_BATCH = 64
CNN_K1_SHAPES = tuple((b * m, k, n) for b in (MAIN_M, CNN_BATCH)
                      for m, k, n in ((196, 576, 128), (1, 6272, 1024)))
CNN_TRAIN = dict(model="bnn-cnn", batch_size=CNN_BATCH, optimizer="adam",
                 learning_rate=0.01, seed=0)
CNN_SYNTH = (12800, 2048)   # 200 steps of 64; a test split of 2048
CNN_DET_STEPS = 30          # two bf16 runs from one seed
CNN_BACKEND_STEPS = 20      # xla, xnor and pallas_xnor
CNN_FP_STEPS = 100          # convnet and deep-cnn at fp32 and bf16 (cut
# from 200 steps for phase 15's time: the check is a falling loss)
CNN_DP_STEPS = 20           # 2 gloo ranks sharing card 0
# The training runtime (phase 11): MLP_TRAIN on pallas_xnor (K1 in the
# step) with the MLP's dropout (0.3), so the generator's state matters;
# two epochs of a synthetic split of 100 steps.
RT_TRAIN = dict(MLP_TRAIN, backend="pallas_xnor")
RT_SYNTH = (6400, 1024)
RT_EPOCHS = 2
RT_LOG_INTERVAL = 10
RT_SIGTERM_AFTER = 30       # epoch 1's logged step before the SIGTERM
RT_NODE_STEPS = 20          # the two-node sign_ef run
# The captured training step (phase 12): MLP_TRAIN (dropout 0.3, bf16)
# on one epoch of a synthetic 10,240/2,048 split (160 steps of 64; cut
# from 320 for phase 15's time).
SCAN_SYNTH = (10240, 2048)
SCAN_STEPS = 8              # steps a dispatch of the scan runs
SCAN_K1_STEPS = 40          # (b) pallas_xnor, dropout 0
SCAN_SHORT_STEPS = 20       # (c) remat and grad_accum, (e) bnn-cnn
SCAN_ACCUM = 4              # (c) microbatches a step
SCAN_CNN_STEPS = 4          # (e) steps a dispatch
SCAN_STOP_STEPS = 80        # (d) an epoch of 10 dispatches
SCAN_STOP_AFTER = 5         # (d) dispatches before the stop request
# Device eval sums each chunk's float32 totals in float32, the streaming
# eval in float64: over 32 chunks the loss sums differ by ~1e-6 relative;
# the counts are integers, exact in both.
SCAN_EVAL_RTOL = 1e-5
# Phase 13: data parallelism captured, one NCCL rank (this process)
DPC_STEPS = 24              # (a), (b): 3 dispatches of SCAN_STEPS (cut
# from 40 for phase 15's time)
DPC_SHORT_STEPS = 16        # (c) grad_accum and remat, (d) elastic
DPC_CLI_SYNTH = (6400, 1024)  # (e) 100 steps
_GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")  # cuBLAS kernels

# Phase 14: model parallelism, gloo ranks sharing the card
MP_BATCH = 64               # the global batch of (a)
MP_TP_STEPS = 10            # cut from 20 for phase 15's time
# the JAX TP test's recipe (tests/test_tensor_parallel.py: SGD 0.05) on
# bnn-mlp-large at full width, pallas_xnor, dropout 0
MP_TRAIN = dict(model="bnn-mlp-large", batch_size=MP_BATCH, optimizer="sgd",
                learning_rate=0.05, seed=0, backend="pallas_xnor",
                model_kwargs={"dropout_rate": 0.0})
MP_LOSS_ATOL, MP_PARAM_TOL = 1e-4, 1e-3   # the JAX TP test's tolerances
# (data, model) -> wire bytes a step and rank, the plan written in
# PERF.md before the run: ring all-reduces (2 (n-1)/n of the buffer) of
# fc2's and the head's fp32 outputs and fc3's input gradient over the
# model group, of the rank's gradient shards over the data group
MP_TP_PLAN = {(1, 2): {"model": 788992, "data": 0},
              (2, 2): {"model": 394496, "data": 16670248}}
# (b) the LM at the --lm-bench width, pp = 2, two microbatches
# (MP_PP_STEPS cut from 10 for phase 15's time)
MP_PP, MP_PP_MICRO, MP_PP_STEPS = 2, 2, 5
MP_PP_FWD_ATOL = 1e-4       # the flash checks' tolerance (FLASH_GRAD_TOL)
# Each pipelined training step is held to the sequential model's step
# from the same parameters (its loss, as phase 12's flash step: 1e-4
# relative; every gradient within LM_GRAD_RTOL), not the two
# trajectories: the binarized LM turns rounding into sign flips, and two
# runs of one model that differ only in the gradients' order of
# summation part after a few steps (after 10 Adam steps mlp1's bias of
# block 0 was 6.3e-3, relative L2, from the sequential run's on an H100;
# on the CPU at a small width a sign flip at step 6 moved a query bias by
# 70% under SGD while every step's gradients agreed to 2e-7)
MP_PP_LOSS_RTOL = 1e-4
# (c) cli train --model bnn-vit-tiny --pp 2: 256 steps of 64 (128 reached
# 59.6% on an H100, too near phase 8's 55)
MP_VIT_SYNTH = (16384, 1024)
# (d) make_tp_pipeline_fn at (data 1, model 2, pipe 2)
# (steps cut from 10 for phase 15's time)
MP_TPP = dict(d_model=256, d_hidden=1024, batch=64, steps=5, lr=0.05)
# Each step is held to the reference on the same parameters (its output
# relative to its scale and its loss: the row-parallel sums reassociate
# fp32 products of up to 1024 terms; this rank's gradient slices in
# relative L2), not the two trajectories: a +-1 weight flips where
# rounding puts a latent on either side of 0, and the runs part (after
# 10 steps at lr 1e-3 the slices were 0.046 apart on an H100, the
# forwards 3.5e-6; at lr 0.05, 1.6 apart on the card and the CPU alike)
# Tolerances from the arithmetic: the output relative to its scale
# 1e-4, above the fp32 bound on a sum of K <= 1,024 products (K * 2^-24
# = 6.1e-5 of the sum of |terms|); the loss 1e-5; this rank's gradient
# slices LM_GRAD_RTOL, the repo's bound for gradients summed in another
# order. A first setting of 1e-5 and 1e-4, chosen without that
# arithmetic, failed on an H100 at 1.0e-5 and 1.4e-4 (loss 9.8e-8); the
# CPU gives 0, 0 and 1.4e-7.
MP_TPP_RTOL = 1e-4
MP_TPP_LOSS_RTOL = 1e-5
MP_TPP_GRAD_RTOL = LM_GRAD_RTOL
# K1 at the tensor-parallel shards' (M, K, N): fc2's row shard and fc3's
# column shard at tp = 2 (M = 64; 32 under data 2) and tp = 4
MP_K1_SHAPES = ((64, 1536, 1536), (64, 1536, 384), (32, 1536, 1536),
                (32, 1536, 384), (64, 768, 1536), (64, 1536, 192))
# Observability (phase 15): bnn-mlp-large on pallas_xnor, batch 64, one
# epoch of 50 steps with the profile window over steps 8 to 24 (eager:
# 16 dispatches; scan_steps=8: the graph's 2nd and 3rd replays);
# a 320-step epoch of phase 12's step for the telemetry on/off times
OBS_SYNTH = (3200, 1024)
OBS_WINDOW = "8:24"
OBS_COST_SYNTH = (20480, 2048)
OBS_REQUESTS = 8
OBS_PROFILE_MS = 1000.0
OBS_LM_PROFILE_MS = 2500.0
OBS_LM_DECODE_EVERY = 10

_SRC = "distributed_mnist_bnns_tpu_torch/csrc/"
_TPU = "distributed_mnist_bnns_tpu/ops/"
KERNEL_ROWS = {
    # name -> (TPU kernel it replaces, source, timed (M, K, N))
    "xnor": (_TPU + "xnor_gemm.py:81", _SRC + "xnor_gemm.cu",
             (LM_SLOTS, *LM_MLP1)),
    "xnor_sign": (_TPU + "xnor_gemm.py:124", _SRC + "xnor_gemm.cu",
                  (MAIN_M, *LAYER2)),
    "xnor_affine": (_TPU + "xnor_gemm.py:149", _SRC + "xnor_gemm.cu",
                    (MAIN_M, *LAYER3)),
    "xnor_unpack": (_TPU + "xnor_gemm.py:374", _SRC + "xnor_unpack.cu",
                    (LM_CHUNK, *LM_MLP1)),
    "paged_attn": (_TPU + "paged_kv.py:355", _SRC + "paged_attn.cu", None),
    "flash_fwd": (_TPU + "flash_attention.py:53", _SRC + "flash_attn.cu",
                  None),
    "flash_bwd_dq": (_TPU + "flash_attention.py:307",
                     _SRC + "flash_bwd.cu", None),
    "flash_bwd_dkv": (_TPU + "flash_attention.py:353",
                      _SRC + "flash_bwd.cu", None),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


BACKGROUND = "smoke-background"   # the name of _background's threads


def _background(fn):
    """Start ``fn()`` in a thread; returns what joins it and gives its
    result (or raises its exception). For checks that wait on processes
    of their own (spawned ranks, a CLI run), so that two such checks
    overlap; nothing timed runs beside one."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # re-raised by the join
            box["error"] = e

    thread = threading.Thread(target=run, name=BACKGROUND)
    thread.start()

    def join():
        thread.join()
        if "error" in box:
            raise box["error"]
        return box["out"]

    return join


def _pm1(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.where(torch.rand(*shape, generator=gen) > 0.5, 1.0, -1.0)


def _sign_vectors(gen, n: int, o_row: torch.Tensor):
    """(a, t, bias) of K2 from BN parameters with g > 0, g < 0 and
    g == 0 columns, through the port's own folding; every fourth column
    gets a threshold equal to row 0's value, an exact >= tie."""
    from distributed_mnist_bnns_tpu_torch.infer import _bn_sign_epilogue

    g = torch.randn(n, generator=gen)
    g[::5] = 0.0
    g[1::3] = -g[1::3].abs()
    params = {"scale": g, "bias": torch.randn(n, generator=gen)}
    stats = {"mean": torch.randn(n, generator=gen) * 8.0,
             "var": torch.rand(n, generator=gen) * 50.0 + 1.0}
    a, t = _bn_sign_epilogue(params, stats)
    bias = torch.randn(n, generator=gen)
    ties = torch.arange(n) % 4 == 0
    t = torch.where(ties, a * (o_row.cpu() + bias), t)
    return a, t, bias


def _affine_vectors(gen, n: int):
    a = torch.randn(n, generator=gen) / 16.0
    a[::7] = 0.0
    c = torch.randn(n, generator=gen)
    bias = torch.randn(n, generator=gen)
    return a, c, bias


def _graph_ms(fn, iters: int = 50, reps: int = 15) -> float:
    """Median device time of one ``fn()``: ``iters`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events, so host
    launch overhead is not in the number. Operands stay in L2 between
    calls, as the serving path's weights do from batch to batch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _events_ms(fn, iters: int = 50, reps: int = 5) -> float:
    """Median time of one ``fn()``: ``iters`` eager calls between CUDA
    events, ``reps`` times (for a call a CUDA graph may not capture)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _roofline(nbytes: float, ops: float, rates: dict):
    """Least time (ms) of a function that moves ``nbytes`` and does
    ``ops`` operations: the larger of the bytes against HBM bandwidth and
    the operations at the fastest of ``rates`` (name -> per second).
    Returns (ms, "bytes" or "operations", the peak that bounds)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    peak = max(rates, key=rates.get)
    t_ops = ops / rates[peak] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "HBM"
    return t_ops, "operations", peak


def _bound(name: str, m: int, k: int, n: int):
    """K1-K3's bound: the fp32 x (4*M*K bytes: the kernels take the
    activations as they are and pack them themselves, so the bits are not
    an input any more) and the real weight words read once, the epilogue
    vectors read once, the fp32 output written once; 2*M*N*K ±1
    operations at the int8 tensor-core peak."""
    kw = -(-k // 32)
    vecs = 0 if name == "xnor" else 3
    nbytes = 4 * (m * k + kw * n + vecs * n + m * n)
    return _roofline(nbytes, 2.0 * m * n * k,
                     {"int8 tensor cores": H100_INT8_OPS_PER_S})


def _raw_x(gen: torch.Generator, m: int, k: int) -> torch.Tensor:
    """Real x holding exact zeros, -0.0, NaN, ±inf and ±subnormals: where
    the two pack rules and the sign of zero differ."""
    x = torch.randn(m, k, generator=gen)
    flat = x.view(-1)
    for i, val in enumerate((0.0, -0.0, float("nan"), float("inf"),
                             -float("inf"), 1e-40, -1e-40)):
        flat[i::7 + 2 * i] = val
    return x


def kernel_phase(name: str, device: torch.device, gen: torch.Generator):
    """Compare packed-GEMM kernel ``name`` (K1-K3) with its plain
    version at every listed shape, on ±1 x and on raw x under both pack
    rules, two runs each; time it at the main paths' (K, N). Returns the
    timing rows and the largest absolute difference seen."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.binarize import _sign_pm1
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    main_m, *main_kn = KERNEL_ROWS[name][2]
    main_kn = tuple(main_kn)
    ms = sorted({1, main_m, MAIN_M, 256} | ({16, 64} if name == "xnor"
                                            else set()))
    shapes = [(m, *main_kn) for m in ms]
    if name == "xnor":
        # every (K, N) the LM decode path gives K1, and the MLP's layer 2
        shapes += [(m, k, n) for m in ms for k, n in LM_PROJ
                   if (k, n) != main_kn]
        shapes += [(m, *LAYER2) for m in (1, MAIN_M, 256)]
    shapes += [(17, 100, 130), (5, 31, 1), (3, 4160, 200), (9, 9000, 257)]
    max_err = 0.0
    rows = []
    for m, k, n in shapes:
        x = _pm1(gen, m, k).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        xp = pack_bits(x)
        if name == "xnor":
            vecs = ()
            entry = xg.xnor_matmul_packed
            plain = xg.xnor_gemm_plain
        elif name == "xnor_sign":
            o_row = xg.xnor_gemm_plain(xp[:1], wp, k)[0, :n]
            vecs = _sign_vectors(gen, n, o_row)
            entry = xg.xnor_matmul_packed_sign
            plain = xg.xnor_sign_plain
        else:
            vecs = _affine_vectors(gen, n)
            entry = xg.xnor_matmul_packed_affine
            plain = xg.xnor_affine_plain
        vecs = tuple(v.to(device) for v in vecs)
        vf = tuple(v.to(torch.float32).contiguous() for v in vecs)
        xr = _raw_x(gen, m, k).to(device)
        # (what, the kernel's output, its plain version's): the entry on
        # ±1 x, then the kernel on raw x under each pack rule
        cases = [("±1 x", entry(x, wp, k, n, *vecs),
                  plain(xp, wp, k, *vecs)[:, :n])]
        for rule, bits in ((_kernels.PACK_GT0, xr),
                           (_kernels.PACK_GE0, _sign_pm1(xr))):
            cases.append((f"raw x, rule {rule}",
                          _kernels.xnor_gemm(name, xr, wp, k, n, *vf,
                                             rule=rule),
                          plain(pack_bits(bits), wp, k, *vecs)[:, :n]))
        if name == "xnor":   # the LM decoder's entry: x >= 0 packed in K1
            cases.append(("raw x, binarizing entry",
                          xg._xnor_matmul_binarize(xr, wp, k, n),
                          plain(pack_bits(_sign_pm1(xr)), wp, k)[:, :n]))
        again = [entry(x, wp, k, n, *vecs)] + [
            _kernels.xnor_gemm(name, xr, wp, k, n, *vf, rule=rule)
            for rule in (_kernels.PACK_GT0, _kernels.PACK_GE0)]
        torch.cuda.synchronize()
        for what, got_c, want in cases:
            err = (got_c - want).abs().nan_to_num(0.0).max().item()
            max_err = max(max_err, err)
            if not torch.equal(got_c, want):
                raise AssertionError(
                    f"{name} at (M={m}, K={k}, N={n}) on {what} differs "
                    f"from its plain version: max |diff| = {err}"
                )
        for (what, first, _), second in zip(cases, again):
            if not torch.equal(first, second):
                raise AssertionError(
                    f"{name} at (M={m}, K={k}, N={n}) on {what}: two runs "
                    f"differ")
        got = cases[0][1]
        if name == "xnor_sign":
            ties = (torch.arange(n, device=device) % 4 == 0)
            if not bool((got[0][ties] == 1.0).all()):
                raise AssertionError(f"{name}: an exact tie did not give +1")
        if (k, n) != main_kn:
            continue
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": name, "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(
                lambda: _kernels.xnor_gemm(name, x, wp, k, n, *vf)),
            "entry_ms": _graph_ms(lambda: entry(x, wp, k, n, *vecs)),
            "plain_ms": _graph_ms(
                lambda: plain(pack_bits(x), wp, k, *vecs)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        if name == "xnor":
            row["binarize_entry_ms"] = _graph_ms(
                lambda: xg._xnor_matmul_binarize(x, wp, k, n))
        row["tiling"] = list(_kernels.xnor_tiling(m, k, n))
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            name, m, k, n)
        rows.append(row)
        print(json.dumps(row), flush=True)
    torch.cuda.synchronize()
    return rows, max_err


def _unpack_bound(m: int, k: int, n: int):
    """K7's bound: fp32 x, the real weight words and the fp32 output moved
    once; 2*M*N*K fp32-accurate operations at the fastest rate for them,
    which with ±1 weights includes bf16 on the tensor cores over three."""
    nbytes = 4 * (m * k + -(-k // 32) * n + m * n)
    return _roofline(nbytes, 2.0 * m * n * k, {
        **FP32_RATES, "3xbf16 tensor cores": H100_BF16_OPS_PER_S / 3})


def unpack_phase(device: torch.device, gen: torch.Generator):
    """K7 against its plain version: ``torch.equal`` on ±1 x at the LM
    path's shapes, ragged and multi-chunk ones; rtol 1e-5 on real x; two
    runs bitwise equal. Returns (timing rows at the prefill shape and at
    M = 1 and 64, the prefill row first; largest |diff| on ±1 x)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg

    shapes = [(m, k, n) for m in (1, LM_CHUNK, 64) for k, n in LM_PROJ]
    shapes += [(17, 100, 130), (LM_CHUNK, 4160, 257)]
    max_err = 0.0
    for m, k, n in shapes:
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        x = _pm1(gen, m, k).to(device)
        got = xg.xnor_matmul_fused_unpack(x, wp, k, n)
        want = xg.fused_unpack_plain(x, wp, k, n)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            raise AssertionError(
                f"xnor_unpack at (M={m}, K={k}, N={n}) on ±1 x differs "
                f"from its plain version: max |diff| = {err}"
            )
        # Real x: both sum in fp32 in other orders. An entry that cancels
        # to near 0 keeps no relative precision, so the absolute term is
        # rtol times the typical size of an entry (sqrt(K) for unit x).
        xr = torch.randn(m, k, generator=gen).to(device)
        got_r = xg.xnor_matmul_fused_unpack(xr, wp, k, n)
        want = xg.fused_unpack_plain(xr, wp, k, n)
        torch.testing.assert_close(got_r, want, rtol=1e-5,
                                   atol=1e-5 * k ** 0.5)
        again = (xg.xnor_matmul_fused_unpack(x, wp, k, n),
                 xg.xnor_matmul_fused_unpack(xr, wp, k, n))
        torch.cuda.synchronize()
        if not (torch.equal(again[0], got) and torch.equal(again[1], got_r)):
            raise AssertionError(
                f"xnor_unpack at (M={m}, K={k}, N={n}): two runs differ")
    rows = []
    _, k, n = KERNEL_ROWS["xnor_unpack"][2]
    for m in (LM_CHUNK, 1, 64):
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        x = _pm1(gen, m, k).to(device)
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": "xnor_unpack", "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(lambda: _kernels.xnor_unpack(x, wp, k, n)),
            "plain_ms": _graph_ms(lambda: xg.fused_unpack_plain(x, wp, k, n)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _unpack_bound(
            m, k, n)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows, max_err


def _paged_case(gen, device, s, c, qpos, tables, num_pages, h=4, d=64):
    """Pools full of random rows (every page, the null page included,
    holds another sequence's old K/V), queries (S, C, H, D)."""
    k_pool = torch.randn(num_pages, LM_PAGE, h, d, generator=gen)
    v_pool = torch.randn(num_pages, LM_PAGE, h, d, generator=gen)
    q = torch.randn(s, c, h, d, generator=gen)
    return [t.to(device) for t in (
        q, torch.as_tensor(qpos, dtype=torch.int32), k_pool, v_pool,
        torch.as_tensor(tables, dtype=torch.int32))]


def _paged_bound(qpos: torch.Tensor, n_table: int, h: int, d: int):
    """Least time of one paged-attention call: q and the output once,
    and each slot's K/V rows at positions <= its largest query position
    (not the whole table); 4*H*D fp32-accurate operations per (query,
    visible key)."""
    s, c = qpos.shape
    keys = (qpos.max(dim=1).values + 1).clamp(max=n_table * LM_PAGE)
    nbytes = 4 * (2 * s * c * h * d + 2 * int(keys.sum()) * h * d)
    visible = (qpos + 1).clamp(min=0, max=n_table * LM_PAGE)
    flops = 4.0 * h * d * int(visible.sum())
    return _roofline(nbytes, flops, FP32_RATES)


def paged_phase(device: torch.device, gen: torch.Generator):
    """K8's three entries against the gather path (the plain versions)
    on the card, atol = rtol = 1e-5, over page boundaries, scrambled
    tables, reused pages, null pages and positions up to 255 with P = 16,
    at the LM's head dim and at D = 36, 7 and 128 (the kernel's other
    instances and its 4-byte copies); then every query of a 4-slot decode
    call and of a 16-query prefill chunk against the same query launched
    alone, and two runs, bitwise; then timings at every shape the LM
    path gives K8: decode at a full (qpos 255) and a short (qpos 20)
    context, prefill chunks at positions 240-255 and 32-47, verify
    windows of 4. Returns (timing rows, largest |diff|), the decode row
    at qpos 255 first."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import paged_kv as pk

    num_pages, n_table = LM_SLOTS * 16 + 1, 16
    alloc = pk.PageAllocator(num_pages)
    perm = torch.randperm(num_pages - 1, generator=gen) + 1
    tables = torch.zeros(LM_SLOTS, n_table, dtype=torch.int32)
    tables[0] = perm[:16]                         # full: positions 0..255
    tables[1, :2] = perm[16:18]                   # 17 positions
    tables[2, :1] = perm[18:19]                   # one page
    # slot 3 stays all null: an inactive slot at position 0
    first = alloc.alloc(5)
    alloc.free(first)
    reused = torch.as_tensor(alloc.alloc(5)[::-1], dtype=torch.int32)
    full = torch.zeros(LM_SLOTS, n_table, dtype=torch.int32)
    for s_ in range(LM_SLOTS):
        full[s_] = perm[16 * s_:16 * s_ + 16]
    max_err = 0.0

    def check(what, got, want):
        nonlocal max_err
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        if not (torch.isfinite(got).all() and torch.allclose(
                got, want, atol=1e-5, rtol=1e-5)):
            raise AssertionError(f"paged_attn {what}: max |diff| = {err}")

    for d in (64, 36, 7, 128):
        # decode, S = 4, C = 1, at page boundaries and the last position
        for pos in ([255, 16, 15, 0], [15, 0, 3, 0], [128, 10, 0, 0]):
            q, qpos, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 1,
                                              [[p] for p in pos], tables,
                                              num_pages, d=d)
            check(f"decode {pos} D={d}",
                  pk.paged_attention_kernel(q[:, 0], kp, vp, tb, qpos[:, 0]),
                  pk.paged_attention(q[:, 0], kp, vp, tb, qpos[:, 0]))
        # prefill, S = 1: whole chunks, a ragged last chunk whose padding
        # queries lie past the length, queries past the table's end, and a
        # call of 20 queries (two query blocks)
        for start, table, c in ((240, tables[0], LM_CHUNK),
                                (32, tables[0], LM_CHUNK),
                                (0, reused, LM_CHUNK), (72, reused, LM_CHUNK),
                                (100, tables[0], 20)):
            qp = list(range(start, start + c))
            q, qpos, kp, vp, tb = _paged_case(gen, device, 1, c, [qp],
                                              table[None], num_pages, d=d)
            check(f"prefill start {start} C={c} D={d}",
                  pk.paged_prefill_attention_kernel(q[0], kp, vp, tb[0],
                                                    qpos[0]),
                  pk.paged_prefill_attention(q[0], kp, vp, tb[0], qpos[0]))
        # verify, S = 4, C = 4: windows straddling page boundaries
        base = torch.as_tensor([252, 14, 13, 0], dtype=torch.int32)
        q, _, kp, vp, tb = _paged_case(gen, device, LM_SLOTS, 4,
                                       [[0] * 4] * 4, tables, num_pages, d=d)
        base = base.to(device)
        check(f"verify D={d}",
              pk.paged_verify_attention_kernel(q, kp, vp, tb, base),
              pk.paged_verify_attention(q, kp, vp, tb, base))

    # A query's bits depend on its own inputs alone: each query of a
    # batched call equals the same query launched alone (S = 1, C = 1),
    # and a second run equals the first.
    n_alone = 0
    for what, qpos_list, tb_cpu in (
            ("decode", [[255], [100], [17], [0]], full),
            ("prefill", [list(range(240, 256))], full[:1]),
            ("prefill", [list(range(32, 48))], full[1:2])):
        q, qpos, kp, vp, tb = _paged_case(gen, device, len(qpos_list),
                                          len(qpos_list[0]), qpos_list,
                                          tb_cpu, num_pages)
        batched = _kernels.paged_attn(q, qpos, kp, vp, tb)
        again = _kernels.paged_attn(q, qpos, kp, vp, tb)
        for si in range(q.shape[0]):
            for ci in range(q.shape[1]):
                alone = _kernels.paged_attn(
                    q[si:si + 1, ci:ci + 1].contiguous(),
                    qpos[si:si + 1, ci:ci + 1].contiguous(), kp, vp,
                    tb[si:si + 1].contiguous())
                n_alone += 1
                if not torch.equal(alone[0, 0], batched[si, ci]):
                    raise AssertionError(
                        f"paged_attn {what}: query ({si}, {ci}) at qpos "
                        f"{qpos_list[si][ci]} differs launched alone")
        if not torch.equal(batched, again):
            raise AssertionError(f"paged_attn {what}: two runs differ")
    print(json.dumps({"paged_attn_alone_vs_batched_bitwise": n_alone,
                      "paged_attn_two_runs_bitwise": True}), flush=True)

    rows = []
    lib = torch.nn.functional.scaled_dot_product_attention
    shapes = (("decode", [[255]] * LM_SLOTS, full),
              ("decode", [[20]] * LM_SLOTS, full),
              ("prefill", [list(range(240, 256))], full[:1]),
              ("prefill", [list(range(32, 48))], full[:1]),
              ("verify", [list(range(252, 256))] * LM_SLOTS, full))
    for what, qpos_list, tb_cpu in shapes:
        s_, c_ = len(qpos_list), len(qpos_list[0])
        q, qpos, kp, vp, tb = _paged_case(gen, device, s_, c_, qpos_list,
                                          tb_cpu, num_pages)
        h, d = q.shape[2], q.shape[3]
        kc, vc = pk.gather_kv(kp, tb), pk.gather_kv(vp, tb)  # (S, L, H, D)
        mask = (torch.arange(kc.shape[1], device=device)[None, None, :]
                <= qpos[:, :, None])[:, None]                # (S, 1, C, L)
        qs, ks, vs = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        got = _kernels.paged_attn(q, qpos, kp, vp, tb)
        yard = lib(qs, ks, vs, attn_mask=mask).transpose(1, 2)
        log(f"paged_attn {what} at qpos {qpos_list[0][0]}..{qpos_list[0][-1]}"
            f": max |diff| to the SDPA yardstick "
            f"{(yard - got).abs().max().item():.3g}")
        row = {
            "kernel": "paged_attn", "call": what, "s": s_, "c": c_,
            "p": n_table,
            "qpos": (qpos_list[0][0] if c_ == 1
                     else [qpos_list[0][0], qpos_list[0][-1]]),
            "kernel_ms": _graph_ms(
                lambda: _kernels.paged_attn(q, qpos, kp, vp, tb)),
            "plain_ms": _graph_ms(
                lambda: pk.paged_attn_plain(q, qpos, kp, vp, tb)),
            "library_ms": _graph_ms(lambda: lib(qs, ks, vs, attn_mask=mask)),
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _paged_bound(
            qpos, n_table, h, d)
        rows.append(row)
        print(json.dumps(row), flush=True)

    # The floor under any launch: one in-place add on a one-element
    # tensor, timed as the kernels are. Measurement only.
    one = torch.zeros(1, device=device)
    print(json.dumps({"launch_floor_ms": _graph_ms(lambda: one.add_(1.0))}),
          flush=True)
    return rows, max_err


def _random_bn_stats(model, gen) -> None:
    """Non-trivial eval statistics: running means and variances on the
    scale of each layer's pre-activations, scales with negative and
    exactly-zero entries, non-zero biases."""
    fan_in = (784, model.hidden[0], model.hidden[1])
    _draw_bn_stats(zip((model.bn1, model.bn2, model.bn3), fan_in), gen)


def _draw_bn_stats(bns_fan_in, gen) -> None:
    """``_random_bn_stats`` for each (BatchNorm, fan-in of its producer)."""
    with torch.no_grad():
        for bn, fi in bns_fan_in:
            c = bn.num_features
            bn.running_mean.copy_(torch.randn(c, generator=gen) * fi ** 0.5 / 4)
            bn.running_var.copy_((torch.rand(c, generator=gen) + 0.5) * fi / 4)
            w = torch.randn(c, generator=gen)
            w[::11] = 0.0
            bn.weight.copy_(w)
            bn.bias.copy_(torch.randn(c, generator=gen) * 0.5)


def slice_phase(device: torch.device, gen: torch.Generator,
                model_name: str = "bnn-mlp-large", batch: int = MAIN_M):
    """Freeze, export, load and serve ``model_name``; check every answer.
    Returns (counts of launches in the phase, timing dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client

    model = get_model(model_name, generator=gen)
    _random_bn_stats(model, gen)
    model.eval()
    # Pixels are multiples of 1/256: exact in bf16 and fp32, so the live
    # model's bf16 first layer and the frozen fp32 one give equal sums.
    images = torch.randint(0, 256, (batch, 28, 28, 1), generator=gen) / 256.0

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.msgpack")
        _kernels.reset_launches()
        info = export_packed(model, path)
        fn, _ = load_packed(path, device=device)
        frozen = fn(images)
        live = model.to(device)(images.to(device))
        torch.cuda.synchronize()
        diff = (frozen - live).abs().max().item()
        if not (torch.equal(frozen.argmax(-1), live.argmax(-1))
                and diff <= 1e-4 and frozen.shape == (batch, 10)
                and bool(torch.isfinite(frozen).all())):
            raise AssertionError(
                f"frozen vs live eval: max |diff| = {diff}, argmax equal "
                f"{torch.equal(frozen.argmax(-1), live.argmax(-1))}"
            )
        log(f"frozen == live eval (max |diff| {diff:.3g}); {info}")

        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=batch,
            default_deadline_ms=30000.0, stall_timeout_s=30.0,
        ))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        try:
            code, body = client.healthz(base)
            if code != 200 or json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {code} {body[:200]!r}")
            imgs = images.numpy()
            answers = []
            lat = []
            for i, n_req in enumerate((1, batch, 3, batch, 7)):
                x = np.roll(imgs, -5 * i, axis=0)[:n_req]
                t0 = time.perf_counter()
                code, body = client.predict(base, x.tolist())
                lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"/predict: {code} {body[:200]!r}")
                answers.append((x, json.loads(body)))
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        counts = dict(_kernels.LAUNCHES)
        if not stats["flushed"]:
            raise AssertionError(f"drain did not flush: {stats}")
        # Checked after the counts are read: these predictor calls are
        # the reference, not the path under test.
        for x, out in answers:
            n_req = x.shape[0]
            padded = np.zeros((batch, 28, 28, 1), np.float32)
            padded[:n_req] = x
            want = fn(padded)[:n_req].cpu().numpy()
            got = np.asarray(out["log_probs"], np.float32)
            if out["argmax"] != want.argmax(-1).tolist() \
                    or not np.allclose(got, want, atol=1e-6, rtol=0):
                raise AssertionError(
                    f"/predict of {n_req} differs from the predictor: "
                    f"max |diff| {np.abs(got - want).max()}"
                )
        served = sum(x.shape[0] for x, _ in answers)
        log(f"served {served} examples in {len(answers)} requests, each "
            f"equal to the predictor; drain {stats}")

    x32 = images.to(device)
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x32)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, top, n_kernels = _profile_device_ms(lambda: fn(x32))
    t0 = time.perf_counter()
    json.dumps({"images": imgs.tolist()})
    timing = {
        "predict_ms_batch": statistics.median(ms),
        "predict_device_ms_batch": device_ms,
        "predict_kernels_per_batch": n_kernels,
        "predict_device_busy_share": (
            None if device_ms is None else device_ms / statistics.median(ms)
        ),
        "predict_top_device_ms": top,
        "request_ms_median": statistics.median(lat) * 1e3,
        "request_json_encode_ms_batch": (time.perf_counter() - t0) * 1e3,
    }
    return counts, timing


def _profile_device_ms(fn, calls: int = 20, top: int = 6):
    """Device time of one ``fn()`` from ``torch.profiler``: the sum of
    the CUDA kernels' own times over ``calls`` calls, the ``top``
    largest kernels (name, ms per call, launches per call) and the
    kernels launched per call. A ``record_function`` range mirrored on
    the device timeline (the optimizer's step) is no kernel and is left
    out. (None, [], 0) when the profiler reports no device activity."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # One warm-up call inside the profiler, not counted: the device trace
    # starts late and would lose the first kernels of the window.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        for _ in range(calls + 1):
            fn()
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        return None, [], 0
    kernels.sort(key=lambda e: -e.self_device_time_total)
    total_us = sum(e.self_device_time_total for e in kernels)
    largest = [[e.key[:70], e.self_device_time_total / calls / 1e3,
                e.count / calls] for e in kernels[:top]]
    return (total_us / calls / 1e3, largest,
            sum(e.count for e in kernels) / calls)


def _random_lm_params(model, gen) -> None:
    """Non-zero biases and LayerNorm parameters. At init every bias is 0,
    so every projection's output is an integer: attention scores are
    multiples of 1/8 and tie exactly, a tied pair of opposite values
    cancels to nearly 0, and the sign a binarized projection then takes
    rests on rounding, which differs between any two attention codes.
    A trained model (and this one) has no such ties."""
    from distributed_mnist_bnns_tpu_torch.models.transformer import LayerNorm

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, LayerNorm):
                mod.weight.copy_(1.0 + 0.2 * torch.randn(
                    mod.weight.shape, generator=gen))
                mod.bias.normal_(0.0, 0.2, generator=gen)
            elif getattr(mod, "bias", None) is not None:
                mod.bias.normal_(0.0, 0.5, generator=gen)


def _drive_alone(dec, prompt, n_new: int, chunk_ms=None):
    """Greedy tokens of ``prompt`` through the paged decoder ``dec``
    driven as the engine drives it, with slot 0 active and the other
    slots idle (all-null tables at position 0). ``chunk_ms`` collects
    the host-clock time of each prefill chunk (synchronised)."""
    from distributed_mnist_bnns_tpu_torch.ops.paged_kv import pages_needed

    plen = len(prompt)
    total = min(plen + n_new, dec.max_len)
    table = np.zeros((dec.slots, dec.max_pages), np.int32)
    table[0, :pages_needed(total, dec.page_size)] = np.arange(
        1, 1 + pages_needed(total, dec.page_size))
    pools = dec.init_pools()
    padded = -(-plen // dec.prefill_chunk) * dec.prefill_chunk
    toks = np.zeros(padded, np.int32)
    toks[:plen] = prompt
    for start in range(0, padded, dec.prefill_chunk):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pools, lp = dec.prefill(pools, toks[start:start + dec.prefill_chunk],
                                table[0], start, plen)
        torch.cuda.synchronize()
        if chunk_ms is not None:
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
    out = [int(lp[plen - 1 - (padded - dec.prefill_chunk)].argmax())]
    tokens = np.zeros(dec.slots, np.int32)
    positions = np.zeros(dec.slots, np.int32)
    pos = plen
    while len(out) < n_new and pos + 1 <= total - 1:
        tokens[0], positions[0] = out[-1], pos
        pools, lp = dec.decode(pools, tokens, table, positions)
        out.append(int(lp[0].argmax()))
        pos += 1
    return out


def lm_slice_phase(device: torch.device, gen: torch.Generator):
    """Freeze, export and serve the LM; check the paged decoder against
    the contiguous one and every stream against the decoder driven
    alone. Returns (launch counts of the requests, timing dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
    )
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_lm_decoder,
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    model = BinarizedLM(**LM_WIDTH, generator=gen).eval()
    _random_lm_params(model, gen)
    vocab = LM_WIDTH["vocab"]
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in LM_PROMPTS]
    text_i = LM_PROMPTS.index(len(LM_TEXT))
    prompts[text_i] = [b % vocab for b in LM_TEXT.encode("utf-8")]
    seq = torch.randint(0, vocab, (60,), generator=gen).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm.msgpack")
        info = export_packed(model, path)
        frozen = load_frozen(path)
        log(f"LM artifact: {info['frozen_weight_bytes']} packed bytes, "
            f"compression {info['compression']}")

        # Teacher forcing: 48 prompt positions in 3 prefill chunks, then
        # 12 decode steps, against the contiguous decoder position by
        # position (a reference, not the serving path).
        dec = make_paged_lm_decoder(frozen, slots=LM_SLOTS,
                                    page_size=LM_PAGE,
                                    prefill_chunk=LM_CHUNK, device=device)
        pools = dec.init_pools()
        table = np.zeros((dec.slots, dec.max_pages), np.int32)
        table[0, :4] = [7, 3, 11, 5]
        paged = []
        for start in range(0, 48, LM_CHUNK):
            pools, lp = dec.prefill(pools, seq[start:start + LM_CHUNK],
                                    table[0], start, 48)
            paged.append(lp)
        for t in range(48, 60):
            toks = np.zeros(dec.slots, np.int32)
            poss = np.zeros(dec.slots, np.int32)
            toks[0], poss[0] = seq[t], t
            pools, lp = dec.decode(pools, toks, table, poss)
            paged.append(lp[:1])
        paged = torch.cat(paged)
        init, step = make_lm_decoder(frozen, device=device)
        caches = init(1)
        ref = []
        for t in range(60):
            caches, lp = step(caches, seq[None, t], t)
            ref.append(lp)
        ref = torch.cat(ref)
        torch.cuda.synchronize()
        per_pos = (paged - ref).abs().amax(dim=-1)
        diff = per_pos.max().item()
        agree = (paged.argmax(-1) == ref.argmax(-1)).float().mean().item()
        # A sign flipped by a last-ulp attention difference moves a whole
        # position's log-probs, so the limit holds position by position,
        # with the same room as the argmax: 95% of positions within 1e-3.
        close = (per_pos <= 1e-3).float().mean().item()
        print(json.dumps({"lm_teacher_forced": 60,
                          "max_abs_logprob_diff": diff,
                          "share_within_1e-3": close,
                          "argmax_agreement": agree}), flush=True)
        if not (bool(torch.isfinite(paged).all()) and agree >= 0.95
                and close >= 0.95):
            raise AssertionError(
                f"paged vs contiguous decoder: argmax agreement {agree}, "
                f"positions within 1e-3 {close}, max |diff| {diff}, "
                f"finite {bool(torch.isfinite(paged).all())}"
            )

        srv = LMServer(LMServeConfig(
            artifact=path, device=str(device), port=0, slots=LM_SLOTS,
            page_size=LM_PAGE, prefill_chunk=LM_CHUNK,
        ))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        results = [None] * len(prompts)

        def ask(i):
            body = LM_TEXT if i == text_i else prompts[i]
            t0 = time.perf_counter()
            code, resp = lc.open_stream(base, body,
                                        max_new_tokens=LM_NEW_TOKENS,
                                        deadline_ms=120000.0)
            events, stamps = [], []
            if code == 200:
                for ev in lc.iter_lines(resp):
                    events.append(ev)
                    stamps.append(time.perf_counter())
            results[i] = (code, events, t0, stamps)

        try:
            code, body = lc.healthz(base)
            if code != 200 or json.loads(body)["status"] != "ok":
                raise AssertionError(f"/healthz: {code} {body[:200]!r}")
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(len(prompts))]
            _kernels.reset_launches()
            for th in threads:
                th.start()
            for th in threads:
                th.join(300)
            counts = dict(_kernels.LAUNCHES)
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        eng = srv.engine
        if not stats["flushed"] or eng.allocator.free_count() \
                != eng.allocator.capacity:
            raise AssertionError(f"drain left pages in use: {stats}")
        log(f"served {len(prompts)} concurrent streams; drain {stats}")

        # Checked after the counts are read: these calls are the
        # reference, not the path under test.
        chunk_ms = []
        ttft, per_token = [], []
        for i, prompt in enumerate(prompts):
            code, events, t0, stamps = results[i]
            if code != 200 or not events or not events[-1].get("done") \
                    or events[-1]["status"] != "ok":
                raise AssertionError(f"stream {i}: {code} {events[-1:]}")
            got = [ev["token"] for ev in events[:-1]]
            want = _drive_alone(
                dec, prompt, LM_NEW_TOKENS,
                chunk_ms if len(prompt) == max(LM_PROMPTS) else None,
            )
            if got != want:
                raise AssertionError(
                    f"stream {i} (prompt {len(prompt)}) differs from the "
                    f"decoder driven alone:\n{got}\n{want}"
                )
            ttft.append((stamps[0] - t0) * 1e3)
            per_token.append((stamps[-2] - stamps[0]) * 1e3 / (len(got) - 1))
        log("every stream equals the decoder driven alone")

        # Device time of one decode iteration with every slot active and
        # of one prefill chunk.
        pools = dec.init_pools()
        tables = np.zeros((dec.slots, dec.max_pages), np.int32)
        tables[:, :8] = np.arange(1, 1 + 8 * dec.slots).reshape(dec.slots, 8)
        toks = np.arange(dec.slots, dtype=np.int32)
        poss = np.full(dec.slots, 100, np.int32)
        decode_ms, decode_top, decode_kernels = _profile_device_ms(
            lambda: dec.decode(pools, toks, tables, poss))
        chunk = np.arange(LM_CHUNK, dtype=np.int32)
        prefill_ms, prefill_top, prefill_kernels = _profile_device_ms(
            lambda: dec.prefill(pools, chunk, tables[0], 96, 112))
    iter_ms = list(eng.iter_ms)
    timing = {
        "decode_iteration_ms_median": statistics.median(iter_ms),
        "decode_iterations": len(iter_ms),
        "decode_device_ms": decode_ms,
        "decode_kernels_per_iteration": decode_kernels,
        "decode_top_device_ms": decode_top,
        "prefill_chunk_ms_median": statistics.median(chunk_ms),
        "prefill_chunk_device_ms": prefill_ms,
        "prefill_kernels_per_chunk": prefill_kernels,
        "prefill_top_device_ms": prefill_top,
        "ttft_ms_median": statistics.median(ttft),
        "per_token_ms_median": statistics.median(per_token),
    }
    if decode_ms is not None:
        timing["decode_device_busy_share"] = (
            decode_ms / timing["decode_iteration_ms_median"])
    if prefill_ms is not None:
        timing["prefill_device_busy_share"] = (
            prefill_ms / timing["prefill_chunk_ms_median"])
    return counts, timing


def _flash_bound(name: str, b: int, h: int, lq: int, lk: int, d: int,
                 causal: bool):
    """Least time (ms) of one flash kernel's work: its operands read once
    and its outputs written once against HBM bandwidth, and 4D (K4), 6D
    (K5) or 8D (K6) fp32-accurate operations per unmasked (query, key)
    pair at the faster of ``FP32_RATES``."""
    if causal:
        pairs = sum(min(lk, i + lk - lq + 1) for i in range(lq))
    else:
        pairs = lq * lk
    pairs *= b * h
    qd, kd, rows = b * h * lq * d, b * h * lk * d, b * h * lq
    words, per_pair = {
        "flash_fwd": (2 * qd + 2 * kd + rows, 4),          # q k v -> out lse
        "flash_bwd_dq": (3 * qd + 2 * kd + 2 * rows, 6),   # q do k v lse c -> dq
        "flash_bwd_dkv": (2 * qd + 4 * kd + 2 * rows, 8),  # -> dk dv
    }[name]
    return _roofline(4 * words, per_pair * d * pairs, FP32_RATES)


def _library_bwd(q, k, v, g_out, causal: bool = True):
    """A call of the kernel SDPA's autograd runs for an fp32 backward
    (PyTorch's memory-efficient attention, CUTLASS) on (B, L, H, D) q, k,
    v, from its own forward's out and lse; it returns (dq, dk, dv).
    Called directly so that a CUDA graph captures it."""
    ops = torch.ops.aten
    lq, lk = q.shape[1], k.shape[1]
    # causal top-left, equal to bottom-right alignment at Lq == Lk
    mask_type = 1 if causal else 0
    out, lse, seed, offset, _, _ = ops._efficient_attention_forward(
        q, k, v, None, None, None, None, None, 0.0, mask_type, True)
    return lambda: ops._efficient_attention_backward(
        g_out, q, k, v, None, out, None, None, lq, lk, lse, 0.0, seed,
        offset, mask_type, False)[:3]


def _sdpa_kernels(qs, ks, vs) -> list:
    """Names of the largest CUDA kernels of one causal SDPA forward and
    backward: which of PyTorch's attention backends ran."""
    qs, ks, vs = (x.detach().requires_grad_() for x in (qs, ks, vs))
    lib = torch.nn.functional.scaled_dot_product_attention
    _, top, _ = _profile_device_ms(
        lambda: lib(qs, ks, vs, is_causal=True).sum().backward(), calls=1,
        top=3)
    return [name for name, _, _ in top]


def flash_phase(device: torch.device, gen: torch.Generator):
    """K4, K5 and K6 against their plain versions at
    ``FLASH_EDGE_SHAPES`` and ``FLASH_SHAPES``; two runs bitwise equal;
    timings at the training width. Returns ({kernel: timing row},
    {kernel: largest |diff|})."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import flash_attention as fa

    max_err = dict.fromkeys(FLASH, 0.0)

    def check(name, got, want, tol):
        err = max((g - w).abs().max().item() for g, w in zip(got, want))
        max_err[name] = max(max_err[name], err)
        for g, w in zip(got, want):
            if not (bool(torch.isfinite(g).all())
                    and torch.allclose(g, w, **tol)):
                raise AssertionError(
                    f"{name} at {shape} differs from its plain version: "
                    f"max |diff| = {err}")

    for shape in FLASH_EDGE_SHAPES + FLASH_SHAPES:
        b, h, lq, lk, d, causal = shape
        q, k, v, g_out = (torch.randn(b, n, h, d, generator=gen).to(device)
                          for n in (lq, lk, lk, lq))
        g_lse = (0.5 * torch.randn(b, lq, h, generator=gen)).to(device)
        out, lse = _kernels.flash_fwd(q, k, v, causal)
        check("flash_fwd", (out, lse), fa.flash_fwd_plain(q, k, v, causal),
              dict(atol=2e-5, rtol=2e-5))
        coeff = (g_lse - (g_out * out).sum(dim=-1)).contiguous()
        args = (q, k, v, g_out, lse, coeff, causal)
        dq = _kernels.flash_bwd_dq(*args)
        dk, dv = _kernels.flash_bwd_dkv(*args)
        check("flash_bwd_dq", (dq,), (fa.flash_bwd_dq_plain(*args),),
              FLASH_GRAD_TOL)
        check("flash_bwd_dkv", (dk, dv), fa.flash_bwd_dkv_plain(*args),
              FLASH_GRAD_TOL)
        again = (*_kernels.flash_fwd(q, k, v, causal),
                 _kernels.flash_bwd_dq(*args), *_kernels.flash_bwd_dkv(*args))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y)
                   for x, y in zip((out, lse, dq, dk, dv), again)):
            raise AssertionError(f"flash kernels at {shape}: two runs differ")
        log(f"flash {shape}: K4/K5/K6 within tolerance of their plain "
            f"versions, two runs bitwise equal")

    # Timings at the training width (the last shape's tensors). The
    # library backward is the call SDPA's autograd makes, checked against
    # autograd's gradients so that the graph times the same work.
    lib = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    gos = g_out.transpose(1, 2).contiguous()
    qg, kg, vg = (x.detach().requires_grad_() for x in (qs, ks, vs))
    want = torch.autograd.grad(lib(qg, kg, vg, is_causal=True),
                               (qg, kg, vg), gos)
    lib_bwd = _library_bwd(q, k, v, g_out)
    got = lib_bwd()
    lib_err = max((g.transpose(1, 2) - w).abs().max().item()
                  for g, w in zip(got, want))
    port_err = max((g - w).abs().max().item() for g, w in zip(
        got, fa._backward(q, k, v, out, lse, g_out, torch.zeros_like(lse),
                          causal)))
    log(f"library backward: max |diff| {lib_err:.3g} to SDPA's autograd, "
        f"{port_err:.3g} to the port's (g_lse = 0)")
    if not all(torch.allclose(g.transpose(1, 2), w, **FLASH_GRAD_TOL)
               for g, w in zip(got, want)):
        raise AssertionError(f"the library backward is not SDPA's: {lib_err}")
    lib_bwd_ms = _graph_ms(lib_bwd, iters=20, reps=10)
    sdpa = _sdpa_kernels(qs, ks, vs)
    log(f"SDPA (fp32, causal) ran: {sdpa}")
    plain = {
        "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, causal),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(*args),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(*args),
    }
    kernel = {
        "flash_fwd": lambda: _kernels.flash_fwd(q, k, v, causal),
        "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(*args),
        "flash_bwd_dkv": lambda: _kernels.flash_bwd_dkv(*args),
    }
    rows = {}
    for name in FLASH:
        row = {
            "kernel": name, "b": b, "h": h, "lq": lq, "lk": lk, "d": d,
            "causal": causal,
            "kernel_ms": _graph_ms(kernel[name], iters=20, reps=10),
            "plain_ms": _graph_ms(plain[name], iters=5, reps=5),
            "library_ms": (_graph_ms(lambda: lib(qs, ks, vs, is_causal=True),
                                     iters=20, reps=10)
                           if name == "flash_fwd" else lib_bwd_ms),
            "library": ("scaled_dot_product_attention forward"
                        if name == "flash_fwd" else
                        "memory-efficient attention backward (dq, dk, dv)"),
            "sdpa_kernels": sdpa,
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _flash_bound(
            name, *shape)
        rows[name] = row
        print(json.dumps(row), flush=True)
    # The port's whole backward as the training step runs it: coeff, K5
    # and K6, against the library's.
    total = {
        "kernel": "flash_bwd_total", "b": b, "h": h, "lq": lq, "lk": lk,
        "d": d, "causal": causal,
        "kernel_ms": _graph_ms(lambda: fa._backward(
            q, k, v, out, lse, g_out, g_lse, causal), iters=20, reps=10),
        "library_ms": lib_bwd_ms,
        "library": "memory-efficient attention backward (dq, dk, dv)",
        "bound_ms": sum(rows[n]["bound_ms"] for n in FLASH[1:]),
    }
    total["vs_library"] = total["kernel_ms"] / total["library_ms"]
    print(json.dumps(total), flush=True)
    return rows, max_err


def lm_train_phase(device: torch.device, gen: torch.Generator):
    """Flash vs exact-softmax step parity (loss and gradients), then 20
    steps through ``examples.lm_demo.run`` with export, twice from one
    seed, its artifact against the trained model, and step timings. Returns (launch counts of the run,
    timing dict)."""
    import copy

    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import (
        BinarizedLM,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.models.transformer import (
        embed_weight_grad,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    vocab, draw = lm_demo.token_stream(LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                       LM_TRAIN["vocab"], seed=0)
    toks = torch.from_numpy(draw()).to(device)

    # One step with each attention from the same weights and batch.
    models = {}
    for att in ("flash", "xla"):
        if not models:
            m = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention=att,
                            generator=gen)
            _random_lm_params(m, gen)
            state = copy.deepcopy(m.state_dict())
        else:
            m = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention=att)
            m.load_state_dict(state)
        models[att] = m.to(device)
    losses, grads = {}, {}
    for att, m in models.items():
        opt = lm_demo.make_optimizer(m, LM_TRAIN_LR)
        losses[att] = float(lm_demo.train_step(
            m, opt, list(latent_clamp_mask(m).values()), toks))
        grads[att] = {n: p.grad for n, p in m.named_parameters()}
    pf = dict(models["flash"].named_parameters())
    n_far = n_all = 0
    for name, p in models["xla"].named_parameters():
        n_far += int(((p - pf[name]).abs() > 1e-5).sum())
        n_all += p.numel()
    rel = abs(losses["flash"] - losses["xla"]) / abs(losses["xla"])
    # The gradients of that step: K5 and K6 recompute the scores in 3xTF32
    # against K4's lse of exact fp32 scores, autograd differentiates the
    # exact softmax. Each parameter's gradient is held to LM_GRAD_RTOL in
    # relative L2 norm, except the key bias's: adding a vector to every
    # key moves each query row's scores by one constant, so its exact
    # gradient is 0 and both sides give rounding noise (printed).
    grad_rel = {n: ((grads["flash"][n] - g).norm() / g.norm()).item()
                for n, g in grads["xla"].items()}
    held = {n: r for n, r in grad_rel.items()
            if not n.endswith("attn.k.bias")}
    worst = max(held, key=held.get)
    flat = {att: torch.cat([g.flatten() for g in gs.values()])
            for att, gs in grads.items()}
    key_bias = {att: sum(g.norm().item() for n, g in gs.items()
                         if n.endswith("attn.k.bias"))
                for att, gs in grads.items()}
    print(json.dumps({
        "lm_train_step_parity": losses, "loss_rel_diff": rel,
        "share_params_over_1e-5": n_far / n_all,
        "grad_rel_l2_worst": [worst, held[worst]],
        "grad_rel_l2_all": ((flat["flash"] - flat["xla"]).norm()
                            / flat["xla"].norm()).item(),
        "key_bias_grad_l2": key_bias}), flush=True)
    if not rel <= 1e-4:
        raise AssertionError(f"flash vs xla step: losses {losses}")
    if not held[worst] <= LM_GRAD_RTOL:
        raise AssertionError(
            f"flash vs xla step: {worst}'s gradient differs by "
            f"{held[worst]} (relative L2) > {LM_GRAD_RTOL}")
    del models, grads, flat

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "lm_trained.msgpack")
        _kernels.reset_launches()
        res = lm_demo.run(
            steps=LM_TRAIN_STEPS, seq_len=LM_TRAIN_SEQ,
            batch=LM_TRAIN_BATCH, lr=LM_TRAIN_LR, seed=0, attention="flash",
            log_every=1, export=path, device=device, **LM_TRAIN,
        )
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
        hist = res.history
        if not (len(hist) == LM_TRAIN_STEPS and all(np.isfinite(hist))
                and hist[-1] < hist[0]):
            raise AssertionError(f"training losses: {hist}")
        want = LM_TRAIN["depth"] * LM_TRAIN_STEPS
        if any(counts[name] != want for name in FLASH):
            raise AssertionError(
                f"flash launches {[counts[n] for n in FLASH]}, want {want}")
        log(f"trained {LM_TRAIN_STEPS} steps: loss {hist[0]:.4f} -> "
            f"{hist[-1]:.4f}; flash launches {want} each")
        again = lm_demo.run(
            steps=LM_TRAIN_STEPS, seq_len=LM_TRAIN_SEQ,
            batch=LM_TRAIN_BATCH, lr=LM_TRAIN_LR, seed=0, attention="flash",
            log_every=1, device=device, **LM_TRAIN,
        ).history
        print(json.dumps({"lm_train_runs_bitwise_equal": again == hist,
                          "loss_history_second_run": again}), flush=True)
        if again != hist:
            raise AssertionError(
                f"two training runs from seed 0 differ:\n{hist}\n{again}")
        log("a second run from seed 0 gave a bitwise-equal loss history")

        # What the bitwise-equal runs cost: the token embedding's weight
        # gradient as the model computes it (one-hot product) against
        # PyTorch's embedding backward, which is not bitwise equal from run
        # to run, at the step's shape.
        g = torch.randn(*toks.shape, LM_TRAIN["embed_dim"],
                        generator=gen).to(device)
        n_vocab = LM_TRAIN["vocab"]
        print(json.dumps({"embed_weight_grad_ms": {
            "one_hot": _events_ms(
                lambda: embed_weight_grad(toks, g, n_vocab)),
            "embedding_backward": _events_ms(
                lambda: torch.ops.aten.embedding_dense_backward(
                    g, toks, n_vocab, -1, False))}}), flush=True)

        # The artifact against the trained model in eval mode: the twin
        # with exact-softmax attention runs the frozen forward's own
        # attention code, so it agrees everywhere; the flash model only
        # where no binarized input sits within rounding of 0.
        fn, _ = load_packed(path, device=device)
        model = res.model.eval()
        twin = BinarizedLM(**LM_TRAIN, max_len=LM_TRAIN_SEQ, attention="xla")
        twin.load_state_dict(model.state_dict())
        twin = twin.to(device).eval()
        x = toks[:2]
        with torch.no_grad():
            frozen, live, live_x = fn(x), model(x), twin(x)
        torch.cuda.synchronize()
        d_x = (frozen - live_x).abs().max().item()
        per_pos = (frozen - live).abs().amax(dim=-1)
        close = (per_pos <= 1e-4).float().mean().item()
        agree = (frozen.argmax(-1) == live.argmax(-1)).float().mean().item()
        print(json.dumps({"export_vs_live_xla_max_abs": d_x,
                          "export_vs_live_flash_max_abs":
                              per_pos.max().item(),
                          "export_vs_live_flash_share_within_1e-4": close,
                          "export_vs_live_flash_argmax_agreement": agree}),
              flush=True)
        if not (d_x <= 1e-4 and close >= 0.99 and agree >= 0.99
                and bool(torch.isfinite(frozen).all())):
            raise AssertionError(
                f"exported LM vs the trained model: {d_x}, {close}, {agree}")

    # Step time and device time, continuing from the trained model.
    model = res.model.train()
    opt = lm_demo.make_optimizer(model, LM_TRAIN_LR)
    latents = list(latent_clamp_mask(model).values())
    step = lambda: lm_demo.train_step(model, opt, latents, toks)  # noqa: E731
    ms = []
    for i in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if i >= 3:
            ms.append((time.perf_counter() - t0) * 1e3)
    device_ms, top, n_kernels = _profile_device_ms(step, calls=5, top=12)
    step_ms = statistics.median(ms)
    timing = {
        "train_step_ms_median": step_ms,
        "train_tokens_per_s": LM_TRAIN_BATCH * LM_TRAIN_SEQ / step_ms * 1e3,
        "train_step_device_ms": device_ms,
        "train_step_device_busy_share": (
            None if device_ms is None else device_ms / step_ms),
        "train_step_top_device_ms": top,
        "train_step_kernels": n_kernels,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "loss_history": hist,
    }
    return counts, timing


def _mlp_trainer(device, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(MLP_TRAIN, epochs=1, device=str(device))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _first_steps(data, steps: int, batch: int):
    """``data`` cut to ``steps`` whole training batches (test set kept)."""
    from distributed_mnist_bnns_tpu_torch.data import ImageClassData

    n = steps * batch
    return ImageClassData(data.train_images[:n], data.train_labels[:n],
                          data.test_images, data.test_labels,
                          source=data.source)


def _state(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}


def _states_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _cli_train_row() -> dict:
    """The flagship's epoch (``MLP_TRAIN``, synthetic data) through
    ``cli train`` in a process of its own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]),
            "--synthetic-sizes", *map(str, MLP_SYNTH)]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def mlp_train_phase(device: torch.device, gen: torch.Generator):
    """Train ``bnn-mlp-large`` one epoch through ``train.Trainer``
    (convergence), twice 50 steps from one seed (bitwise equal), 20 steps
    on each ±1 backend (bitwise equal; K1 launched 2 x 20 times on
    ``pallas_xnor``), export the trained model through ``cli export
    --checkpoint-dir`` and serve a batch through K2/K3 against the live
    eval model; then step times. Returns (launch counts, timing dict)."""
    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    # The step's fp32 products (the first layer on "xla", the head, the
    # backward pair) must be fp32 ones, not TF32.
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on; the MLP step is fp32")
    torch.cuda.init()      # the allocator's stats exist from here on
    torch.cuda.reset_peak_memory_stats(device)
    held_at_start = torch.cuda.memory_allocated(device)  # earlier phases'
    bs = MLP_TRAIN["batch_size"]
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=MLP_SYNTH, seed=0)

        # 1. The flagship: one epoch at full width, evaluated before and
        # after.
        tr = _mlp_trainer(device)
        before = tr.evaluate(data)
        row = tr.fit(data)[-1]
        losses = tr.loss_history
        print(json.dumps({"mlp_train_epoch": row, "test_before": before,
                          "logged_losses": losses}), flush=True)
        if not (losses and all(np.isfinite(losses))
                and row["train_loss"] < losses[0]):
            raise AssertionError(f"flagship losses: {losses}, {row}")
        if not (row["test_acc"] > MLP_MIN_ACC and row["test_acc"]
                >= before["test_acc"] + MLP_MIN_GAIN):
            raise AssertionError(
                f"flagship test_acc {before['test_acc']} -> "
                f"{row['test_acc']}: want > {MLP_MIN_ACC} and a gain of "
                f"{MLP_MIN_GAIN}")
        log(f"bnn-mlp-large: {row['steps']} steps, test_acc "
            f"{before['test_acc']:.2f} -> {row['test_acc']:.2f}")

        # 4. The trained model through the CLI's export into the packed
        # artifact, served on the card through K2 and K3, against the live
        # eval model (first layer in fp32, as the artifact's).
        ckpt = os.path.join(tmp, "ckpt")
        tr.save_checkpoint(ckpt)
        path = os.path.join(tmp, "trained.msgpack")
        if cli.main(["--log-level", "WARNING", "export", "--model",
                     MLP_TRAIN["model"], "--checkpoint-dir", ckpt,
                     "--out", path]) != 0:
            raise AssertionError("cli export --checkpoint-dir failed")
        fn, _ = load_packed(path, device=device)
        x = torch.from_numpy(data.test_images[:MAIN_M]).to(device)
        fn(x)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        frozen = fn(x)
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
        live = get_model(MLP_TRAIN["model"], backend="xla")
        live.load_state_dict(tr.model.state_dict())
        with torch.no_grad():
            want = live.to(device).eval()(x)
        diff = (frozen - want).abs().max().item()
        print(json.dumps({"mlp_trained_export_vs_live_max_abs": diff,
                          "serve_launches": counts}), flush=True)
        if not (torch.equal(frozen.argmax(-1), want.argmax(-1))
                and diff <= 1e-4 and bool(torch.isfinite(frozen).all())):
            raise AssertionError(f"trained artifact vs live model: {diff}")
        for name in ("xnor_sign", "xnor_affine"):
            if counts[name] == 0:
                raise AssertionError(f"the trained artifact never launched "
                                     f"{name}")
        log(f"trained model exported and served: max |diff| {diff:.3g}")

    # 2. Determinism: two runs of 50 steps from one seed, dropout on.
    det_data = _first_steps(data, MLP_DET_STEPS, bs)
    runs = []
    for _ in range(2):
        t = _mlp_trainer(device, log_interval=1)
        t.train_epoch(det_data, 0)
        runs.append((t.loss_history, _state(t)))
    same = runs[0][0] == runs[1][0] and _states_equal(runs[0][1], runs[1][1])
    print(json.dumps({"mlp_train_runs_bitwise_equal": same,
                      "loss_history": runs[0][0]}), flush=True)
    if not same:
        raise AssertionError("two MLP training runs from seed 0 differ")
    del runs

    # 3. The four ±1 backends from one seed and one batch order, dropout
    # 0: equal loss histories and parameters; K1 twice a step.
    be_data = _first_steps(data, MLP_BACKEND_STEPS, bs)
    ref = None
    be_trainers = {}
    for backend in MLP_TRAIN_BACKENDS:
        t = _mlp_trainer(device, log_interval=1, backend=backend,
                         model_kwargs={"dropout_rate": 0.0})
        _kernels.reset_launches()
        t.train_epoch(be_data, 0)
        torch.cuda.synchronize()
        got = (t.loss_history, _state(t))
        if backend == "pallas_xnor":
            k1 = dict(_kernels.LAUNCHES)
        if ref is None:
            ref = got
        elif not (got[0] == ref[0] and _states_equal(got[1], ref[1])):
            raise AssertionError(f"backend {backend} differs from xla")
        be_trainers[backend] = t
    want = 2 * MLP_BACKEND_STEPS
    others = {n: c for n, c in k1.items() if n != "xnor" and c}
    print(json.dumps({"mlp_train_backends_bitwise_equal":
                      list(MLP_TRAIN_BACKENDS),
                      "pallas_xnor_launches": k1}), flush=True)
    if k1["xnor"] != want or others:
        raise AssertionError(f"pallas_xnor run: K1 {k1['xnor']} launches, "
                             f"want {want}; others {others}")
    counts["xnor"] = k1["xnor"]
    log(f"{MLP_BACKEND_STEPS} steps equal on {MLP_TRAIN_BACKENDS}; K1 "
        f"launched {want} times")

    # 5. Step time on the host clock (the epoch's, ending in a
    # synchronize) in this process and in a fresh one through the CLI,
    # device time from torch.profiler on one batch.
    cli_row = _cli_train_row()
    print(json.dumps({"mlp_cli_train": cli_row}), flush=True)
    if not (np.isfinite(cli_row["train_loss"])
            and cli_row["test_acc"] > MLP_MIN_ACC
            and cli_row["steps"] == row["steps"]):
        raise AssertionError(f"cli train of the flagship: {cli_row}")
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)

    def step_of(t):
        return lambda: t.train_step(t.model, t.optimizer, xb, yb)

    dev_ms, top, n_kernels = _profile_device_ms(step_of(tr), calls=20,
                                                top=1000)
    gemm = lambda ks: sum(k[1] for k in ks  # noqa: E731
                          if any(g in k[0].lower() for g in _GEMM_NAMES))
    p_ms, p_top, p_kernels = _profile_device_ms(
        step_of(be_trainers["pallas_xnor"]), calls=20, top=1000)
    k1_ms = sum(k[1] for k in p_top if "xnor_gemm" in k[0])
    step_ms = row["epoch_time_s"] / row["steps"] * 1e3
    cli_ms = cli_row["batch_time_s"] * 1e3
    timing = {
        "train_steps": row["steps"],
        "train_step_ms": step_ms,
        "train_examples_per_s": bs / step_ms * 1e3,
        "cli_train_step_ms": cli_ms,
        "cli_train_examples_per_s": bs / cli_ms * 1e3,
        "cli_train_test_acc": cli_row["test_acc"],
        "cli_train_equals_in_process": (
            cli_row["train_loss"] == row["train_loss"]
            and cli_row["test_acc"] == row["test_acc"]),
        "train_step_device_ms": dev_ms,
        "train_step_device_busy_share": (
            None if dev_ms is None else dev_ms / step_ms),
        "cli_train_step_device_busy_share": (
            None if dev_ms is None else dev_ms / cli_ms),
        "train_step_kernels": n_kernels,
        "train_step_top_device_ms": top[:10],
        "bf16_step_gemm_ms": None if dev_ms is None else gemm(top),
        "pallas_xnor_step_device_ms": p_ms,
        "pallas_xnor_step_kernels": p_kernels,
        "pallas_xnor_step_k1_ms": k1_ms,
        "pallas_xnor_step_other_gemm_ms": None if p_ms is None else gemm(p_top),
        "test_acc_before": before["test_acc"],
        "test_acc_after": row["test_acc"],
        "peak_memory_gb": torch.cuda.max_memory_allocated(device) / 1e9,
        "peak_memory_above_start_gb": (
            torch.cuda.max_memory_allocated(device) - held_at_start) / 1e9,
    }
    return counts, timing


# -- phase 9: data-parallel MLP training ------------------------------------


class _ExchangeTimer:
    """A step's gradient exchange with CUDA events around each call: the
    optimizer's 1-bit exchange (``SignCompress``, ``SignCompressFsdp``:
    compression, collectives and decoding), or a function of the step
    (the gradient all-reduce, FSDP's reduce-scatter and all-gather).
    Eager steps only: a captured step records no timed events."""

    def __init__(self, transform):
        self.transform = transform
        self.events = []

    def __call__(self, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.transform(*args)
        end.record()
        self.events.append((start, end))
        return out

    def __getattr__(self, name):
        return getattr(self.transform, name)

    def ms_per_call(self):
        torch.cuda.synchronize()
        if not self.events:
            return None
        return sum(s.elapsed_time(e) for s, e in self.events) / len(
            self.events)


def _digest(model) -> str:
    """sha256 of every tensor of the model's state dict, in order."""
    import hashlib

    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _dp_data(tmp: str, steps=None):
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    data = load_mnist(os.path.join(tmp, "no-idx-files"),
                      synthetic_sizes=MLP_SYNTH, seed=0)
    return data if steps is None else _first_steps(data, steps,
                                                   MLP_TRAIN["batch_size"])


def _dp_run(device, data, evaluate: bool = False, base=MLP_TRAIN,
            **cfg) -> dict:
    """One data-parallel run of ``base`` (default ``MLP_TRAIN``, dropout
    0) in this rank: one epoch over ``data``, the launch counters zeroed
    just before and read just after it; times, bytes, this run's peak
    memory and a digest of the end state. On the eager steps CUDA events
    time the exchange; a captured run (``scan_steps``) times a second
    epoch on its graphs as well (``replayed_step_ms``)."""
    import gc

    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import data_parallel
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    kw = dict(base, epochs=1, model_kwargs={"dropout_rate": 0.0},
              device=str(device), data_parallel="auto")
    kw.update(cfg)
    gc.collect()     # an earlier run's trainer must not count in the peak
    torch.cuda.empty_cache()
    t = Trainer(TrainConfig(**kw))
    timers, restore = [], None
    if kw.get("scan_steps", 1) <= 1 and not kw.get("device_data"):
        opt = t.optimizer
        for attr in ("grad_transform", "fsdp_compress"):
            if getattr(opt, attr) is not None:
                timers.append(_ExchangeTimer(getattr(opt, attr)))
                setattr(opt, attr, timers[-1])
        if t.fsdp is not None:
            for attr in ("reduce_grads", "gather"):
                timers.append(_ExchangeTimer(getattr(t.fsdp, attr)))
                setattr(t.fsdp, attr, timers[-1])
        elif not timers and t.distributed:
            saved = data_parallel.all_reduce_grads
            timers.append(_ExchangeTimer(saved))
            data_parallel.all_reduce_grads = timers[-1]

            def restore():
                data_parallel.all_reduce_grads = saved
    before = t.evaluate(data) if evaluate else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _kernels.reset_launches()
    try:
        row = t.train_epoch(data, 0)
    finally:
        if restore is not None:
            restore()
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(device)
    after = t.evaluate(data) if evaluate else None
    plan, hier = t.comm_plan, t.hier_plan
    steps = row["steps"]
    out = {
        "steps": steps, "losses": list(t.loss_history),
        "digest": _digest(t.model), "train_loss": row["train_loss"],
        "step_ms": row["batch_time_s"] * 1e3,
        "examples_per_s": base["batch_size"] / row["batch_time_s"],
        "exchange_ms": (sum(x.ms_per_call() for x in timers) if timers
                        else None),
        "max_memory_allocated": peak,
        "optimizer_state_bytes": _opt_state_bytes(t),
        "wire_bytes_per_step": t.comm_bytes() / steps,
        "plan_bytes_per_step": (0 if plan is None
                                else plan.wire_bytes_per_step),
        "mode": "none" if plan is None else plan.mode, "launches": launches,
    }
    if hier is not None:
        out.update(intra_bytes_per_step=t.comm_bytes(level="intra") / steps,
                   inter_bytes_per_step=t.comm_bytes(level="inter") / steps,
                   plan_intra=hier.intra_bytes_per_step,
                   plan_inter=hier.inter_bytes_per_step)
    if evaluate:
        out.update(test_acc_before=before["test_acc"],
                   test_acc=after["test_acc"])
    if t._train_scan is not None:
        out["replayed_step_ms"] = t.train_epoch(data, 1)[
            "batch_time_s"] * 1e3
    return out


def _dp_nccl_rank(rank: int, world: int, device, steps: int) -> dict:
    """Phase 9 (a) in one NCCL rank: ``steps`` steps of sign_ef."""
    with tempfile.TemporaryDirectory() as tmp:
        return _dp_run(device, _dp_data(tmp, steps), log_interval=1,
                       grad_compress="sign_ef")


def _dp_gloo_rank(rank: int, world: int, device, epoch_steps) -> dict:
    """Phase 9 (b)-(d) in one of the gloo ranks sharing a card, and the
    three demos (``examples/demos.py``; checked in phase 22 (g))."""
    from distributed_mnist_bnns_tpu_torch.examples import demos

    with tempfile.TemporaryDirectory() as tmp:
        epoch = _dp_data(tmp, epoch_steps)
        return {
            "demos": demos.run_all(rank, world, device, 0,
                                   model_kwargs=DEMO_KW),
            "gspmd": _dp_run(device, epoch, evaluate=True),
            "sign_ef": _dp_run(device, epoch, evaluate=True,
                               grad_compress="sign_ef"),
            "sign": _dp_run(device, _first_steps(epoch, DP_SIGN_STEPS,
                                                 MLP_TRAIN["batch_size"]),
                            grad_compress="sign",
                            learning_rate=DP_SIGN_LR),
            **{f"k1_{b}": _dp_run(
                device, _first_steps(epoch, DP_SHORT_STEPS,
                                     MLP_TRAIN["batch_size"]),
                grad_compress="sign_ef", backend=b)
               for b in ("pallas_xnor", "xla")},
            "hier": _dp_run(device, _first_steps(
                epoch, DP_SHORT_STEPS, MLP_TRAIN["batch_size"]),
                grad_compress="sign_ef", dp_hosts=DP_HOSTS),
        }


def _check_ranks(name: str, ranks: list) -> None:
    """Every rank's run ended bitwise equal, every loss finite, and each
    rank's measured bytes per step equal the plan's."""
    r0 = ranks[0]
    for r in ranks:
        if r["digest"] != r0["digest"] or r["losses"] != r0["losses"]:
            raise AssertionError(f"{name}: ranks end in different states")
        if not all(np.isfinite(r["losses"])):
            raise AssertionError(f"{name}: losses {r['losses']}")
        if r["wire_bytes_per_step"] != r["plan_bytes_per_step"] and (
                "plan_intra" not in r):
            raise AssertionError(
                f"{name}: {r['wire_bytes_per_step']} wire bytes a step, "
                f"the plan's {r['plan_bytes_per_step']}")
        if "plan_intra" in r and (
                r["intra_bytes_per_step"] != r["plan_intra"]
                or r["inter_bytes_per_step"] != r["plan_inter"]):
            raise AssertionError(f"{name}: intra/inter bytes {r}")


def _cli_dp_row() -> dict:
    """``cli train --dp auto --grad-compress sign_ef --epochs 1`` in a
    process of its own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]),
            "--dp", "auto", "--grad-compress", "sign_ef",
            "--synthetic-sizes", *map(str, DP_CLI_SYNTH)]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --dp auto exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def dp_train_phase(device: torch.device, smi: str):
    """Data-parallel training of ``bnn-mlp-large``: (a) NCCL, one rank a
    card, 50 steps of sign_ef (ranks equal; at world 1 equal to one
    process), then ``cli train --dp auto``; (b) 4 gloo ranks sharing
    card 0: ``DP_EPOCH_STEPS`` steps uncompressed (global-batch
    BatchNorm) and of sign_ef (convergence, sign_ef within 2 points),
    ``DP_SIGN_STEPS`` steps of sign;
    (c) ``DP_SHORT_STEPS`` steps of sign_ef on pallas_xnor and on xla
    (equal; K1 2 x ``DP_SHORT_STEPS`` a rank); (d) ``DP_SHORT_STEPS``
    steps two-level (2 x 2); the three demos in the same ranks. Every run: ranks bitwise
    equal, wire bytes per step equal to the plan's. Returns (each
    kernel's launches summed over every run and every rank, the rows)."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    rows = []
    # (a) NCCL, one rank a card
    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    if world == 1:
        # the one rank in this process (as phase 13's): no process start
        from distributed_mnist_bnns_tpu_torch.parallel import init_world

        with tempfile.TemporaryDirectory() as tmp:
            init_world(0, 1, backend="nccl", init_file=os.path.join(tmp, "pg"))
            try:
                nccl = [_dp_nccl_rank(0, 1, device, DP_NCCL_STEPS)]
            finally:
                torch.distributed.destroy_process_group()
    else:
        nccl = spawn(_dp_nccl_rank, world, backend="nccl", device="cuda",
                     args=(DP_NCCL_STEPS,))
    _check_ranks("nccl", nccl)
    row = {"dp_run": "nccl_sign_ef", "world": world, "card": smi,
           "wall_s": time.perf_counter() - t0,
           **{k: v for k, v in nccl[0].items()
              if k not in ("losses", "digest")}}
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            alone = _dp_run(device, _dp_data(tmp, DP_NCCL_STEPS),
                            log_interval=1, grad_compress="sign_ef",
                            data_parallel=None)
        row["equals_single_process"] = (
            alone["digest"] == nccl[0]["digest"]
            and alone["losses"] == nccl[0]["losses"])
        if not row["equals_single_process"]:
            raise AssertionError("world-1 NCCL sign_ef run differs from a "
                                 "single-process Trainer")
    print(json.dumps(row), flush=True)
    rows.append(row)
    # (b)-(d): gloo ranks sharing card 0, beside the single-process epoch
    # and (a)'s CLI process below
    t0 = time.perf_counter()
    gloo_ranks = _background(lambda: spawn(
        _dp_gloo_rank, DP_GLOO_RANKS, backend="gloo", device="cuda",
        args=(DP_EPOCH_STEPS,)))
    # The threshold of (b)'s cut epoch, met by one process alone
    with tempfile.TemporaryDirectory() as tmp:
        alone = _dp_run(device, _dp_data(tmp, DP_EPOCH_STEPS), evaluate=True,
                        data_parallel=None)
    print(json.dumps({"dp_run": "single_process_cut_epoch", "card": smi,
                      **{k: v for k, v in alone.items()
                         if k not in ("losses", "digest")}}), flush=True)
    if not (alone["test_acc"] > MLP_MIN_ACC and alone["test_acc"]
            >= alone["test_acc_before"] + MLP_MIN_GAIN):
        raise AssertionError(f"{DP_EPOCH_STEPS} single-process steps miss "
                             f"phase 8's thresholds: {alone}")
    cli_row = _cli_dp_row()
    print(json.dumps({"dp_run": "cli_train_dp_auto", "card": smi,
                      **cli_row}), flush=True)
    if not (np.isfinite(cli_row["train_loss"])
            and cli_row["test_acc"] > MLP_MIN_ACC):
        raise AssertionError(f"cli train --dp auto: {cli_row}")

    gloo = gloo_ranks()
    wall = time.perf_counter() - t0
    DEMO_LOSSES[:] = [g.pop("demos") for g in gloo]
    for name in gloo[0]:
        ranks = [g[name] for g in gloo]
        _check_ranks(name, ranks)
        row = {"dp_run": f"gloo_{name}", "world": DP_GLOO_RANKS,
               "card": smi, **{k: v for k, v in ranks[0].items()
                               if k not in ("losses", "digest")},
               "launches_by_rank": [r["launches"] for r in ranks]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    runs = {r["dp_run"]: r for r in rows}
    for name in ("gloo_gspmd", "gloo_sign_ef"):
        r = runs[name]
        if not (r["test_acc"] > MLP_MIN_ACC
                and r["test_acc"] >= r["test_acc_before"] + MLP_MIN_GAIN
                and r["train_loss"] < gloo[0][name[5:]]["losses"][0]):
            raise AssertionError(f"{name} did not converge: {r}")
    if runs["gloo_sign_ef"]["test_acc"] < runs["gloo_gspmd"]["test_acc"] - 2:
        raise AssertionError("sign_ef more than 2 points below the "
                             "uncompressed run")
    if gloo[0]["k1_pallas_xnor"]["digest"] != gloo[0]["k1_xla"]["digest"]:
        raise AssertionError("pallas_xnor and xla DP runs differ")
    want = 2 * DP_SHORT_STEPS
    for g in gloo:
        k1 = g["k1_pallas_xnor"]["launches"]
        others = {n: c for n, c in k1.items() if n != "xnor" and c}
        if k1["xnor"] != want or others:
            raise AssertionError(f"DP pallas_xnor run: K1 {k1['xnor']} "
                                 f"launches a rank, want {want}; {others}")
    counts = {name: sum(r["launches"][name] for r in nccl)
              + sum(run["launches"][name] for g in gloo for run in g.values())
              for name in KERNEL_ROWS}
    log(f"data parallel: nccl x{world}, gloo x{DP_GLOO_RANKS} on one card "
        f"({wall:.1f} s): ranks equal, bytes equal to the plans, K1 "
        f"{want} launches a rank")
    return counts, rows


# -- phase 10: the conv families ---------------------------------------------


def _k1_conv_rows(device, gen):
    """(a) K1 at the conv path's shapes (``CNN_K1_SHAPES``) against its
    plain version, ``torch.equal``, on ±1 x and on patches holding zero
    taps (packed as -1, as the padding correction assumes), two runs
    equal; then CUDA-graph times of the kernel, its plain version and
    bf16 ``torch.matmul``, with the bound. Returns (rows, max |diff|)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    rows, max_err = [], 0.0
    for m, k, n in CNN_K1_SHAPES:
        w = _pm1(gen, k, n).to(device)
        wp, _, _ = xg.prepack_weights(w)
        x = _pm1(gen, m, k).to(device)
        taps = x * (torch.rand(m, k, generator=gen) > 0.1).to(device)
        for what, xx in (("±1 x", x), ("zero taps", taps)):
            got = xg.xnor_matmul_packed(xx, wp, k, n)
            again = xg.xnor_matmul_packed(xx, wp, k, n)
            want = xg.xnor_gemm_plain(pack_bits(xx), wp, k)[:, :n]
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            max_err = max(max_err, err)
            if not (torch.equal(got, want) and torch.equal(got, again)):
                raise AssertionError(
                    f"K1 at (M={m}, K={k}, N={n}) on {what}: max |diff| "
                    f"{err} from its plain version, or two runs differ")
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        row = {"kernel": "xnor", "path": "conv", "m": m, "k": k, "n": n,
               "words": -(-k // 32), "packed_words": wp.shape[0],
               "tiling": list(_kernels.xnor_tiling(m, k, n)),
               "kernel_ms": _graph_ms(
                   lambda: _kernels.xnor_gemm("xnor", x, wp, k, n)),
               "plain_ms": _graph_ms(
                   lambda: xg.xnor_gemm_plain(pack_bits(x), wp, k),
                   iters=5, reps=5),
               "library_ms": _graph_ms(lambda: torch.matmul(xb, wb))}
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            "xnor", m, k, n)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows, max_err


def _cnn_trainer(device, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(CNN_TRAIN, epochs=1, device=str(device))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _step_profile(trainer, xb, yb):
    """Device time, kernels and K1's time a step (``torch.profiler``)."""
    ms, top, n = _profile_device_ms(
        lambda: trainer.train_step(trainer.model, trainer.optimizer, xb, yb),
        calls=10, top=1000)
    return {"step_device_ms": ms, "step_kernels": n,
            "step_k1_ms": sum(t[1] for t in top if "xnor_gemm" in t[0]),
            "step_top_device_ms": top[:6]}


def _cnn_train(device, data, smi):
    """(b) bnn-cnn training: an epoch of ``CNN_SYNTH`` on bf16 (the loss
    falls, accuracy rises); two bf16 runs of ``CNN_DET_STEPS`` bitwise
    equal; ``CNN_BACKEND_STEPS`` on xla, xnor and pallas_xnor from one
    seed (K1 exactly twice a pallas_xnor step; pallas_xnor and xnor share
    the im2col lowering and end bitwise equal; the trained model's logits
    on pallas_xnor equal those on xla). Returns (the trained bf16
    trainer, K1's launches, rows)."""
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    bs = CNN_TRAIN["batch_size"]
    tr = _cnn_trainer(device, log_interval=20)
    before = tr.evaluate(data)
    row = tr.fit(data)[-1]
    losses = tr.loss_history
    out = {"cnn_run": "bnn-cnn_bf16_epoch", "card": smi, **row,
           "test_before": before, "logged_losses": losses}
    print(json.dumps(out), flush=True)
    if not (losses and all(np.isfinite(losses))
            and row["train_loss"] < losses[0]
            and row["test_acc"] > MLP_MIN_ACC
            and row["test_acc"] >= before["test_acc"] + MLP_MIN_GAIN):
        raise AssertionError(f"bnn-cnn did not learn: {out}")
    rows = [out]
    runs = []
    for _ in range(2):
        det = _cnn_trainer(device, log_interval=1)
        det.train_epoch(_first_steps(data, CNN_DET_STEPS, bs), 0)
        runs.append((det.loss_history, _state(det)))
    same = runs[0][0] == runs[1][0] and _states_equal(runs[0][1], runs[1][1])
    print(json.dumps({"cnn_train_runs_bitwise_equal": same,
                      "loss_history": runs[0][0]}), flush=True)
    if not same:
        raise AssertionError("two bnn-cnn bf16 runs from seed 0 differ")
    del runs
    few = _first_steps(data, CNN_BACKEND_STEPS, bs)
    xt = torch.from_numpy(data.test_images[:bs]).to(device)
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)
    trainers, k1 = {}, None
    for backend in ("xla", "xnor", "pallas_xnor"):
        t = _cnn_trainer(device, log_interval=1, backend=backend)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        t.train_epoch(few, 0)
        torch.cuda.synchronize()
        if backend == "pallas_xnor":
            k1 = dict(_kernels.LAUNCHES)
        trainers[backend] = t
    want = 2 * CNN_BACKEND_STEPS
    others = {n: c for n, c in k1.items() if n != "xnor" and c}
    if k1["xnor"] != want or others:
        raise AssertionError(f"bnn-cnn pallas_xnor: K1 {k1['xnor']} "
                             f"launches, want {want}; others {others}")
    px, xn = trainers["pallas_xnor"], trainers["xnor"]
    if not (px.loss_history == xn.loss_history
            and _states_equal(_state(px), _state(xn))):
        raise AssertionError("bnn-cnn pallas_xnor and xnor runs differ")
    twin = get_model("bnn-cnn", backend="xla").to(device)
    twin.load_state_dict(px.model.state_dict())
    with torch.no_grad():
        logits_x = twin.eval()(xt)
        logits_p = px.model.eval()(xt)
    torch.cuda.synchronize()
    xla_gap = max(abs(a - b) / abs(b) for a, b in zip(
        trainers["xla"].loss_history, px.loss_history))
    res = {"cnn_run": "bnn-cnn_backends", "card": smi,
           "pallas_xnor_k1_launches": k1["xnor"],
           "pallas_xnor_equals_xnor": True,
           "trained_logits_pallas_xnor_equal_xla":
               torch.equal(logits_x, logits_p),
           "xla_vs_pallas_xnor_loss_max_rel": xla_gap}
    if not res["trained_logits_pallas_xnor_equal_xla"]:
        raise AssertionError("bnn-cnn logits on pallas_xnor differ from xla")
    # profiled on throwaway trainers: ``tr`` goes on to be served as it
    # converged, and ``det``'s state was taken above
    for b, t in (("bf16", det), *trainers.items()):
        t.model.train()
        res[f"{b}_profile"] = _step_profile(t, xb, yb)
    res["bf16_step_ms"] = row["batch_time_s"] * 1e3
    res["bf16_examples_per_s"] = bs / row["batch_time_s"]
    print(json.dumps(res), flush=True)
    rows.append(res)
    return tr, k1["xnor"], rows


def _cnn_serve(device, tr, data, smi):
    """(c) The trained bnn-cnn through ``cli export --checkpoint-dir``,
    ``load_packed`` on the card against the live eval model (first conv
    fp32, as the artifact's; argmax equal, atol 1e-4), then served over
    HTTP at batch 32: K1 exactly twice a predictor batch. Returns (K1's
    launches, row)."""
    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
        client,
    )

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        tr.save_checkpoint(ckpt)
        path = os.path.join(tmp, "cnn.msgpack")
        if cli.main(["--log-level", "WARNING", "export", "--model",
                     "bnn-cnn", "--checkpoint-dir", ckpt, "--out",
                     path]) != 0:
            raise AssertionError("cli export --model bnn-cnn failed")
        fn, info = load_packed(path, device=device)
        x = torch.from_numpy(data.test_images[:MAIN_M]).to(device)
        fn(x)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        frozen = fn(x.reshape(MAIN_M, -1))
        torch.cuda.synchronize()
        one = dict(_kernels.LAUNCHES)
        if one["xnor"] != 2 or any(c for n, c in one.items() if n != "xnor"):
            raise AssertionError(f"a bnn-cnn predictor batch launched {one}")
        live = get_model("bnn-cnn", backend="xla").to(device)
        live.load_state_dict(tr.model.state_dict())
        with torch.no_grad():
            want = live.eval()(x)
        diff = (frozen - want).abs().max().item()
        if not (torch.equal(frozen.argmax(-1), want.argmax(-1))
                and diff <= 1e-4 and bool(torch.isfinite(frozen).all())):
            raise AssertionError(f"frozen bnn-cnn vs live model: {diff}")

        imgs = data.test_images[:MAIN_M]
        _kernels.reset_launches()
        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=MAIN_M,
            default_deadline_ms=30000.0, stall_timeout_s=30.0))
        host, port = srv.start()
        base = f"http://{host}:{port}"
        answers, lat = [], []
        try:
            for i, n_req in enumerate((1, MAIN_M, 5, MAIN_M)):
                xs = np.roll(imgs, -3 * i, axis=0)[:n_req]
                t0 = time.perf_counter()
                code, body = client.predict(base, xs.tolist())
                lat.append(time.perf_counter() - t0)
                if code != 200:
                    raise AssertionError(f"/predict: {code} {body[:200]!r}")
                answers.append((xs, json.loads(body)))
        finally:
            srv.request_stop("smoke over")
            stats = srv.drain_and_stop()
        served = dict(_kernels.LAUNCHES)
        batches = stats["batches_total"] + 1   # + the warm-up call
        if served["xnor"] != 2 * batches:
            raise AssertionError(f"served bnn-cnn: K1 {served['xnor']} "
                                 f"launches for {batches} batches")
        for xs, out in answers:
            padded = np.zeros((MAIN_M, 28, 28, 1), np.float32)
            padded[:len(xs)] = xs
            ref = fn(padded)[:len(xs)].cpu().numpy()
            if out["argmax"] != ref.argmax(-1).tolist() or not np.allclose(
                    np.asarray(out["log_probs"], np.float32), ref,
                    atol=1e-6, rtol=0):
                raise AssertionError("/predict differs from the predictor")
    ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    dev_ms, top, n_kernels = _profile_device_ms(lambda: fn(x))
    row = {"cnn_run": "bnn-cnn_serve", "card": smi, "info": info,
           "frozen_vs_live_max_abs": diff, "k1_per_batch": one["xnor"],
           "served_batches": batches, "served_k1": served["xnor"],
           "predict_ms_batch": statistics.median(ms),
           "predict_device_ms_batch": dev_ms,
           "predict_kernels_per_batch": n_kernels,
           "predict_top_device_ms": top,
           "request_ms_median": statistics.median(lat) * 1e3}
    print(json.dumps(row), flush=True)
    return one["xnor"] + served["xnor"], row


def _fp_runs(device, data, smi):
    """(d) convnet and deep-cnn, ``CNN_FP_STEPS`` steps at fp32 and at
    bf16 (the loss falls), then the fresh-process check that an fp32
    conv trained through ``cli train`` is fp32, not TF32."""
    bs = CNN_TRAIN["batch_size"]
    cut = _first_steps(data, CNN_FP_STEPS, bs)
    xb = torch.from_numpy(data.train_images[:bs]).to(device)
    yb = torch.from_numpy(data.train_labels[:bs].astype(np.int64)).to(device)
    rows = []
    for name in ("convnet", "deep-cnn"):
        for precision in ("fp32", "bf16"):
            t = _cnn_trainer(device, model=name, precision=precision,
                             log_interval=20)
            row = t.train_epoch(cut, 0)
            losses = t.loss_history
            r = {"cnn_run": f"{name}_{precision}", "card": smi,
                 "steps": row["steps"], "first_loss": losses[0],
                 "train_loss": row["train_loss"], "last_loss": losses[-1],
                 "step_ms": row["batch_time_s"] * 1e3,
                 "examples_per_s": bs / row["batch_time_s"],
                 **_step_profile(t, xb, yb)}
            print(json.dumps(r), flush=True)
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and row["train_loss"] < losses[0]):
                raise AssertionError(f"{name} at {precision}: the loss did "
                                     f"not fall: {losses}")
            rows.append(r)
    return rows


def _fp32_check() -> dict:
    """(d) the fresh-process check that an fp32 conv trained through
    ``cli train`` is fp32, not TF32 (``scripts/torch_conv_fp32_check.py``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, os.path.join(here, "scripts",
                                      "torch_conv_fp32_check.py")],
        cwd=here, capture_output=True, text=True, timeout=300)
    line = json.loads(out.stdout.strip().splitlines()[-1]) \
        if out.stdout.strip() else {}
    print(json.dumps({"cnn_run": "fresh_process_fp32_conv", **line}),
          flush=True)
    if out.returncode != 0 or not line.get("ok"):
        raise AssertionError(f"fresh-process convnet conv is not fp32: "
                             f"{line} {out.stderr[-2000:]}")
    return line


def _conv_dp_rank(rank: int, world: int, device, steps: int,
                  nccl: bool) -> dict:
    """(e) in one rank: ``steps`` steps of convnet uncompressed and, over
    gloo, of bnn-cnn with ``sign_ef`` on pallas_xnor."""
    with tempfile.TemporaryDirectory() as tmp:
        from distributed_mnist_bnns_tpu_torch.data import load_mnist

        data = _first_steps(load_mnist(os.path.join(tmp, "no-idx-files"),
                                       synthetic_sizes=CNN_SYNTH, seed=0),
                            steps, CNN_TRAIN["batch_size"])
        runs = {"convnet": _dp_run(device, data, base=CNN_TRAIN,
                                   model="convnet", model_kwargs={},
                                   log_interval=1)}
        if not nccl:
            runs["bnn-cnn"] = _dp_run(device, data, base=CNN_TRAIN,
                                      model_kwargs={}, log_interval=1,
                                      grad_compress="sign_ef",
                                      backend="pallas_xnor")
        return runs


def _conv_dp(device, smi):
    """(e) Data parallel: 2 gloo ranks sharing card 0 (and one NCCL rank
    a card where there are two or more): every rank bitwise equal, the
    wire bytes a step the plan's, K1 twice a pallas_xnor step in each
    rank. Returns (K1's launches, rows)."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    rows, k1 = [], 0
    kinds = [("gloo", 2)]
    if torch.cuda.device_count() > 1:
        kinds.append(("nccl", torch.cuda.device_count()))
    for backend, world in kinds:
        t0 = time.perf_counter()
        ranks = spawn(_conv_dp_rank, world, backend=backend, device="cuda",
                      args=(CNN_DP_STEPS, backend == "nccl"))
        wall = time.perf_counter() - t0
        for name in ranks[0]:
            runs = [r[name] for r in ranks]
            _check_ranks(f"{backend} {name}", runs)
            row = {"cnn_run": f"dp_{backend}_{name}", "world": world,
                   "card": smi, "wall_s": wall,
                   **{k: v for k, v in runs[0].items()
                      if k not in ("losses", "digest")},
                   "launches_by_rank": [r["launches"] for r in runs]}
            print(json.dumps(row), flush=True)
            rows.append(row)
            k1 += sum(r["launches"]["xnor"] for r in runs)
            if name == "bnn-cnn" and any(
                    r["launches"]["xnor"] != 2 * CNN_DP_STEPS for r in runs):
                raise AssertionError(f"DP bnn-cnn: K1 launches by rank "
                                     f"{row['launches_by_rank']}")
    if len(kinds) == 1:
        print(json.dumps({"cnn_run": "dp_nccl", "skipped":
                          "one card: NCCL refuses two ranks on one card"}),
              flush=True)
    return k1, rows


def conv_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 10, the conv families: (a) K1 at the conv shapes; (b)
    bnn-cnn training; (c) bnn-cnn frozen and served; (d) convnet and
    deep-cnn at fp32 and bf16, and the fresh-process fp32 check; (e)
    data parallel. Returns (each kernel's launches on the conv path,
    K1's conv-shape rows)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    t0 = time.perf_counter()
    k1_rows, k1_err = _k1_conv_rows(device, gen)
    log(f"K1 equal to its plain version at {len(k1_rows)} conv shapes")
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=CNN_SYNTH, seed=0)
    tr, k1_train, _ = _cnn_train(device, data, smi)
    log(f"bnn-cnn trained; K1 {k1_train} launches on pallas_xnor")
    k1_serve, _ = _cnn_serve(device, tr, data, smi)
    log(f"bnn-cnn frozen and served; K1 {k1_serve} launches")
    _fp_runs(device, data, smi)
    log("convnet and deep-cnn train at fp32 and bf16")
    fp32 = _background(_fp32_check)    # a process of its own, beside (e)
    k1_dp, _ = _conv_dp(device, smi)
    fp32()
    log("fresh-process conv is fp32")
    log(f"conv DP: ranks equal, bytes equal to the plans, K1 {k1_dp}")
    counts = {name: 0 for name in KERNEL_ROWS}
    counts["xnor"] = k1_train + k1_serve + k1_dp
    for row in k1_rows:
        row["max_abs_err"] = k1_err
    print(json.dumps({"slice": "conv", "launches": counts,
                      "phase_s": time.perf_counter() - t0}), flush=True)
    return counts, k1_rows


# -- phase 11: the training runtime ------------------------------------------


def _rt_argv(ckpt: str, *extra: str) -> list:
    """``cli train`` of ``RT_TRAIN`` for ``RT_EPOCHS`` epochs into
    ``ckpt``."""
    return [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "train", "--model", RT_TRAIN["model"],
            "--epochs", str(RT_EPOCHS),
            "--batch-size", str(RT_TRAIN["batch_size"]),
            "--optimizer", RT_TRAIN["optimizer"],
            "--lr", str(RT_TRAIN["learning_rate"]),
            "--seed", str(RT_TRAIN["seed"]), "--backend", RT_TRAIN["backend"],
            "--log-interval", str(RT_LOG_INTERVAL),
            "--synthetic-sizes", *map(str, RT_SYNTH),
            "--checkpoint-dir", ckpt, *extra]


def _rt_popen(argv: list) -> subprocess.Popen:
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))


def _rt_finish(proc: subprocess.Popen, what: str, want_rc: int) -> dict:
    """Wait for ``proc`` (killed after 300 s); its JSON line, if any."""
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != want_rc:
        raise AssertionError(f"{what} exited {proc.returncode}, want "
                             f"{want_rc}: {err[-2000:]}")
    lines = out.strip().splitlines()
    return json.loads(lines[-1]) if lines else {}


def _rt_sigterm_run(ckpt: str) -> dict:
    """``cli train`` stopped by SIGTERM once epoch 1 has logged step
    ``RT_SIGTERM_AFTER``: it must exit with 75."""
    import re
    import signal

    proc = _rt_popen(_rt_argv(ckpt))
    seen = []
    try:
        for line in proc.stderr:
            seen.append(line)
            m = re.search(r"epoch 1 step (\d+) ", line)
            if m and int(m.group(1)) >= RT_SIGTERM_AFTER:
                t0 = time.perf_counter()
                proc.send_signal(signal.SIGTERM)
                break
        else:
            raise AssertionError("cli train ended before the SIGTERM: "
                                 + "".join(seen[-20:]))
    except BaseException:
        proc.kill()
        proc.wait()
        raise
    _rt_finish(proc, "cli train after SIGTERM", 75)
    return {"sigterm_to_exit_s": time.perf_counter() - t0}


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _tree_digest(path: str) -> str:
    """sha256 over every leaf (path and bytes) of a checkpoint file's
    train state: step, params, batch stats, optimizer state."""
    import hashlib

    from distributed_mnist_bnns_tpu_torch.utils import msgpack

    h = hashlib.sha256()

    def walk(tree, prefix):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{prefix}/{k}")
        else:
            h.update(prefix.encode())
            h.update(np.ascontiguousarray(tree).tobytes())

    with open(path, "rb") as f:
        walk(msgpack.from_bytes(f.read()), "")
    return h.hexdigest()


def _rt_trainer(device, ckpt, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(RT_TRAIN, epochs=RT_EPOCHS, device=str(device),
               log_interval=RT_LOG_INTERVAL, checkpoint_dir=ckpt)
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _rt_node_rank(rank: int, world: int, device, steps: int) -> dict:
    """``steps`` steps of sign_ef on pallas_xnor in one rank (phase 11's
    two-node run and its one-launch twin)."""
    with tempfile.TemporaryDirectory() as tmp:
        return _dp_run(device, _dp_data(tmp, steps), base=RT_TRAIN,
                       log_interval=1, grad_compress="sign_ef")


def _rt_two_nodes(smi: str) -> tuple:
    """Two "nodes" of one gloo rank each, sharing card 0, meeting at
    ``tcp://127.0.0.1:<free port>``, against one ``spawn`` of 2 (a
    ``file://`` rendezvous), run at the same time: every rank bitwise
    equal, K1 twice a step in each. Returns (K1's launches, row)."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    port = _free_port()
    out, errors = {}, []

    def launch(key, **kw):
        try:
            out[key] = spawn(_rt_node_rank, kw.pop("world"), backend="gloo",
                             device="cuda", args=(RT_NODE_STEPS,), **kw)
        except BaseException as e:   # re-raised below
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=launch, args=("one_launch",),
                                kwargs={"world": 2}),
               threading.Thread(target=launch, args=("node1",), kwargs=dict(
                   world=1, coordinator=f"127.0.0.1:{port}", nodes=2,
                   node_rank=1))]
    for t in threads:
        t.start()
    launch("node0", world=1, coordinator=f"127.0.0.1:{port}", nodes=2,
           node_rank=0)
    for t in threads:
        t.join(timeout=600)
    if errors:
        raise errors[0]
    wall = time.perf_counter() - t0
    nodes = out["node0"] + out["node1"]
    ranks = nodes + out["one_launch"]
    _check_ranks("two nodes", nodes)
    _check_ranks("one launch", out["one_launch"])
    if nodes[0]["digest"] != out["one_launch"][0]["digest"] or (
            nodes[0]["losses"] != out["one_launch"][0]["losses"]):
        raise AssertionError("two nodes over tcp differ from one spawn")
    k1 = [r["launches"]["xnor"] for r in ranks]
    if any(n != 2 * RT_NODE_STEPS for n in k1):
        raise AssertionError(f"two-node run: K1 launches by rank {k1}")
    row = {"runtime": "two_nodes_tcp", "card": smi, "steps": RT_NODE_STEPS,
           "wall_s": wall, "equal_to_one_spawn": True,
           "k1_launches_by_rank": k1,
           "step_ms": [r["step_ms"] for r in nodes]}
    return sum(k1[:2]), row


def runtime_phase(device: torch.device, smi: str):
    """Phase 11, the training runtime of ``bnn-mlp-large`` (``RT_TRAIN``):
    (a) ``cli train`` stopped by SIGTERM in epoch 1 exits 75, ``cli
    train --resume`` exits 0, and its final checkpoint equals an
    uninterrupted ``cli train``'s in every tensor; (b) in this process
    the same run, with and without ``--timing-csv``'s CSVs (equal states;
    step times), checkpoint bytes and save, async, digest and restore
    times; (c) the stopped checkpoint with its newest generation
    truncated rolls back to the one before it, and (d) shipped over
    loopback by ``utils.transfer``, each resumed here and ending on the
    uninterrupted state; (e) the trained model exported to msgpack and
    served through K2/K3 against the live model; (f) two nodes over
    ``tcp://``. Returns (each kernel's launches on this path, rows)."""
    import shutil

    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.infer import load_packed
    from distributed_mnist_bnns_tpu_torch.interop import (
        train_state_from_jax,
        train_state_to_jax,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.utils import checkpoint as ck
    from distributed_mnist_bnns_tpu_torch.utils import transfer

    t_phase = time.perf_counter()
    counts = {name: 0 for name in KERNEL_ROWS}
    rows = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rt_")
    try:
        whole, cut = os.path.join(tmp, "whole"), os.path.join(tmp, "cut")
        # (f) the two nodes' ranks run beside (a)'s CLI processes
        two_nodes = _background(lambda: _rt_two_nodes(smi))
        # (a) the uninterrupted cli run beside the one SIGTERM stops
        whole_proc = _rt_popen(_rt_argv(whole))
        stop = _rt_sigterm_run(cut)
        meta = ck.read_meta(cut)
        if not (meta.get("preempted") and meta.get("epoch_in_progress") == 1
                and meta.get("batch_in_epoch", 0) >= RT_SIGTERM_AFTER):
            raise AssertionError(f"the stopped run's meta: {meta}")
        # copies of the stopped checkpoint for (c) and (d)
        rolled = os.path.join(tmp, "rolled")
        shutil.copytree(cut, rolled)
        newest = meta["generations"][0]["file"]
        for name in (newest, ck.LATEST):
            os.truncate(os.path.join(rolled, name),
                        os.path.getsize(os.path.join(rolled, name)) // 2)
        shipped = os.path.join(tmp, "shipped")
        ship = {}
        for name in (ck.LATEST, ck.META):
            port = _free_port()
            recv = threading.Thread(target=transfer.receive_file,
                                    args=(shipped, port))
            recv.start()
            time.sleep(0.2)   # the receiver binds
            t0 = time.perf_counter()
            sent = transfer.send_file(os.path.join(cut, name), "127.0.0.1",
                                      port)
            dt = time.perf_counter() - t0
            recv.join(timeout=120)
            if name == ck.LATEST:
                ship.update(bytes=sent, ship_s=dt)
        resumed = _rt_finish(_rt_popen(_rt_argv(cut, "--resume")),
                             "cli train --resume", 0)
        whole_row = _rt_finish(whole_proc, "cli train", 0)
        same = (_tree_digest(os.path.join(cut, ck.LATEST))
                == _tree_digest(os.path.join(whole, ck.LATEST)))
        row = {"runtime": "preempt_resume", "card": smi,
               "exit_codes": [75, 0], "stopped_at": {
                   "epoch": meta["epoch_in_progress"],
                   "batch": meta["batch_in_epoch"], "step": meta["step"]},
               **stop, "resumed_test_acc": resumed.get("test_acc"),
               "uninterrupted_test_acc": whole_row.get("test_acc"),
               "bitwise_equal": same}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not same:
            raise AssertionError("cli train stopped and resumed differs "
                                 "from the uninterrupted run")
        log(f"SIGTERM at epoch 1 batch {meta['batch_in_epoch']}: exit 75, "
            "--resume exit 0, final state bitwise the uninterrupted one")

        # (b) in this process: the run, then again with the timing CSVs
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=RT_SYNTH, seed=0)
        ref_dir = os.path.join(tmp, "ref")
        ref = _rt_trainer(device, ref_dir)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        hist = ref.fit(data)
        torch.cuda.synchronize()
        k1_ref = _kernels.LAUNCHES["xnor"]
        ref_digest = _tree_digest(os.path.join(ref_dir, ck.LATEST))
        csv = _rt_trainer(device, os.path.join(tmp, "csv"),
                          timing_csv_prefix=os.path.join(tmp, "timing"))
        csv_hist = csv.fit(data)
        steps = sum(h["steps"] for h in hist)
        # layers 2 and 3 of every training step and every eval batch
        evals = RT_EPOCHS * -(-RT_SYNTH[1] // RT_TRAIN["batch_size"])
        if k1_ref != 2 * (steps + evals):
            raise AssertionError(f"K1 {k1_ref} launches in {steps} "
                                 f"pallas_xnor steps and {evals} eval "
                                 "batches")
        with open(os.path.join(tmp, "timing_batch_time.csv")) as f:
            n_rows = sum(1 for _ in f) - 1
        row = {"runtime": "timing_csv", "card": smi, "steps": steps,
               "step_ms_without": [h["batch_time_s"] * 1e3 for h in hist],
               "step_ms_with": [h["batch_time_s"] * 1e3 for h in csv_hist],
               "dispatch_ms_without": [h["dispatch_time_s"] * 1e3
                                       for h in hist],
               "dispatch_ms_with": [h["dispatch_time_s"] * 1e3
                                    for h in csv_hist],
               "batch_csv_rows": n_rows,
               "states_equal": _tree_digest(os.path.join(
                   tmp, "csv", ck.LATEST)) == ref_digest,
               "in_process_equals_cli": ref_digest == _tree_digest(
                   os.path.join(whole, ck.LATEST))}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if n_rows != steps or not row["states_equal"]:
            raise AssertionError(f"the --timing-csv run: {row}")

        # checkpoint bytes and times
        path = os.path.join(ref_dir, ck.LATEST)
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        ref.save_checkpoint(os.path.join(tmp, "sync"))
        save_s = time.perf_counter() - t0
        ref._checkpointer = ck.AsyncCheckpointer()
        t0 = time.perf_counter()
        ref.save_checkpoint(os.path.join(tmp, "async"))
        handoff_s = time.perf_counter() - t0
        ref._checkpointer.close()
        async_s = time.perf_counter() - t0
        ref._checkpointer = None
        t0 = time.perf_counter()
        ck.file_digest(path)
        digest_s = time.perf_counter() - t0
        fresh = _rt_trainer(device, ref_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, _ = ck.load_checkpoint_resilient(
            train_state_to_jax(fresh, values=False), ref_dir)
        load_s = time.perf_counter() - t0
        train_state_from_jax(tree, fresh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        row = {"runtime": "checkpoint", "card": smi,
               "checkpoint_bytes": size, "save_sync_s": save_s,
               "save_async_handoff_s": handoff_s,
               "save_async_total_s": async_s, "digest_s": digest_s,
               "restore_read_verify_decode_s": load_s,
               "restore_s": restore_s}
        print(json.dumps(row), flush=True)
        rows.append(row)
        log(f"checkpoint {size / 1e6:.1f} MB: save {save_s:.3f} s, async "
            f"handoff {handoff_s:.3f} s, digest {digest_s:.3f} s, restore "
            f"{restore_s:.3f} s")

        # (c) rollback and (d) the shipped copy, each resumed here
        _kernels.reset_launches()
        res = {}
        for name, where in (("rollback", rolled), ("shipped", shipped)):
            if name == "rollback":
                _, info = ck.load_checkpoint_resilient(
                    train_state_to_jax(fresh, values=False), where)
                if not (info["rolled_back"] and info["file"]
                        == meta["generations"][1]["file"]):
                    raise AssertionError(f"no rollback: {info}")
            t = _rt_trainer(device, where, resume=True)
            t.fit(data)
            res[name] = _tree_digest(os.path.join(where, ck.LATEST))
        torch.cuda.synchronize()
        k1_resumed = _kernels.LAUNCHES["xnor"]
        row = {"runtime": "rollback_and_ship", "card": smi,
               "rolled_back_to": meta["generations"][1]["file"],
               "rollback_equal": res["rollback"] == ref_digest,
               "shipped_equal": res["shipped"] == ref_digest,
               "ship_bytes": ship["bytes"], "ship_s": ship["ship_s"],
               "ship_mb_per_s": ship["bytes"] / ship["ship_s"] / 1e6,
               "k1_launches_after_resume": k1_resumed}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not (row["rollback_equal"] and row["shipped_equal"]):
            raise AssertionError(f"resumes differ from the uninterrupted "
                                 f"run: {row}")
        counts["xnor"] += k1_ref + k1_resumed
        log(f"rollback past the truncated {newest} and the shipped copy "
            f"({row['ship_mb_per_s']:.0f} MB/s) both resume to the "
            "uninterrupted state")

        # (e) the trained model exported to msgpack, served through K2/K3
        art = os.path.join(tmp, "trained.msgpack")
        if cli.main(["--log-level", "WARNING", "export", "--model",
                     RT_TRAIN["model"], "--checkpoint-dir", ref_dir,
                     "--out", art]) != 0:
            raise AssertionError("cli export to msgpack failed")
        fn, _ = load_packed(art, device=device)
        x = torch.from_numpy(data.test_images[:MAIN_M]).to(device)
        fn(x)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        frozen = fn(x)
        torch.cuda.synchronize()
        serve = dict(_kernels.LAUNCHES)
        live = get_model(RT_TRAIN["model"], backend="xla")
        live.load_state_dict(ref.model.state_dict())
        with torch.no_grad():
            want = live.to(device).eval()(x)
        diff = (frozen - want).abs().max().item()
        row = {"runtime": "msgpack_artifact", "card": smi,
               "bytes": os.path.getsize(art), "max_abs_vs_live": diff,
               "launches": serve}
        print(json.dumps(row), flush=True)
        rows.append(row)
        if not (torch.equal(frozen.argmax(-1), want.argmax(-1))
                and diff <= 1e-4 and serve["xnor_sign"] > 0
                and serve["xnor_affine"] > 0):
            raise AssertionError(f"the msgpack artifact: {row}")
        for name in ("xnor_sign", "xnor_affine"):
            counts[name] += serve[name]
        log(f"msgpack artifact served through K2/K3: max |diff| {diff:.3g}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (f) two nodes over tcp://
    k1_nodes, row = two_nodes()
    print(json.dumps(row), flush=True)
    rows.append(row)
    counts["xnor"] += k1_nodes
    log(f"two nodes over tcp:// equal one spawn; K1 {k1_nodes} launches")
    print(json.dumps({"slice": "runtime", "launches": counts,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    return counts, rows


# -- phase 12: the captured training step ------------------------------------


def _full_state(trainer):
    """Parameters, buffers, optimizer state tensors and the train
    generator's state, cloned."""
    out = _state(trainer)
    for i, st in enumerate(trainer.optimizer.state.values()):
        for k, v in st.items():
            out[f"opt{i}.{k}"] = (v.detach().clone() if torch.is_tensor(v)
                                  else torch.tensor(v))
    gen_fn = getattr(trainer.model, "train_generator", None)
    if gen_fn is not None:
        out["train_generator"] = gen_fn(trainer.device).get_state()
    return out


def _graph_stats(trainer) -> dict:
    """The trainer's captured steps: graphs, replays, capture seconds,
    pool bytes (none on the eager path)."""
    scan = trainer._train_scan
    return {"graphs": [], "replays": 0} if scan is None else scan.stats()


def _diff_keys(a, b) -> list:
    return [k for k in a if k not in b or not torch.equal(a[k], b[k])]


def _same_run(what: str, a, b) -> None:
    bad = _diff_keys(_full_state(a), _full_state(b))
    if bad or a.step != b.step:
        raise AssertionError(f"{what}: steps {a.step} / {b.step}, "
                             f"{len(bad)} tensors differ: {bad[:6]}")


def _chunk(data, start: int, n: int, device, bs: int):
    """Batches ``start``..``start + n`` of epoch 0's order, as pinned
    ``(n, B, ...)`` host tensors."""
    from distributed_mnist_bnns_tpu_torch.data import batch_iterator
    from distributed_mnist_bnns_tpu_torch.train.capture import pinned

    it = batch_iterator(data.train_images, data.train_labels, bs, epoch=0,
                        seed=MLP_TRAIN["seed"])
    batches = [b for i, b in enumerate(it) if start <= i < start + n]
    return (pinned(np.stack([b[0] for b in batches]), np.float32, device),
            pinned(np.stack([b[1] for b in batches]), np.int64, device))


def _cli_scan_row() -> dict:
    """``cli train --scan-steps 8 --device-data``: the flagship's epoch
    (``MLP_TRAIN``, synthetic 19,200/10,000) in a process of its own."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]),
            "--synthetic-sizes", *map(str, MLP_SYNTH),
            "--scan-steps", str(SCAN_STEPS), "--device-data"]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --scan-steps --device-data exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def scan_phase(device: torch.device, smi: str):
    """Phase 12, the captured training step (``train.capture``,
    ``TrainConfig.scan_steps`` / ``device_data`` / ``grad_accum`` /
    ``remat``): (a) ``bnn-mlp-large`` on phase 8's recipe, one epoch of
    ``SCAN_SYNTH`` eager, with ``scan_steps=8`` and with
    ``device_data``: params, BatchNorm statistics, Adam's state and the
    train generator ``torch.equal``, each dispatch's mean loss the mean
    of the eager per-step losses it covers, the device eval equal to the
    streaming one (counts exactly, loss within ``SCAN_EVAL_RTOL``); (b)
    ``pallas_xnor``, dropout 0, 40 steps eager against ``scan_steps=8``,
    bitwise, K1 2 x 40 times inside the replayed graphs (recorded
    launches x replays), cross-checked by ``torch.profiler``'s kernel
    names over two more replays; (c) dropout 0.3, 20 steps: ``remat``
    (eager and under ``scan_steps=4``) bitwise the plain step,
    ``grad_accum=4`` under ``scan_steps=4`` bitwise ``grad_accum=4``
    eager; (d) a ``scan_steps=8`` epoch stopped in-process after its 5th
    dispatch writes its checkpoint at batch 40, and a resume with
    ``scan_steps=8`` ends on the uninterrupted run's state; (e)
    ``bnn-cnn`` on bf16, 20 steps, ``scan_steps=4`` bitwise eager (its
    convs captured inside ``conv_precision``); (f) ``cli train
    --scan-steps 8 --device-data`` one 19,200-example epoch in a process
    of its own, converging to phase 8's thresholds. Then step times and
    examples/s on the host clock, device time a step and busy share
    (``torch.profiler``), replays, capture seconds and pool bytes.
    Returns (each kernel's launches on this path: eager launches plus
    the replays' recorded launches x replays; K1's launches inside
    graphs)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.resilience import Preempted
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import read_meta

    t_phase = time.perf_counter()
    bs = MLP_TRAIN["batch_size"]
    raw0 = dict(_kernels.LAUNCHES)
    trainers = []      # every trainer whose graphs ran

    def made(t):
        trainers.append(t)
        return t

    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=SCAN_SYNTH, seed=0)
    steps = SCAN_SYNTH[0] // bs

    # (a) eager, scan and device-data: one epoch each from one seed.
    t_e = _mlp_trainer(device, log_interval=1)
    t_s = made(_mlp_trainer(device, log_interval=1, scan_steps=SCAN_STEPS))
    t_d = made(_mlp_trainer(device, device_data=True))
    rows = {}
    for name, t in (("eager", t_e), ("scan", t_s), ("device_data", t_d)):
        rows[name] = t.train_epoch(data, 0)
    _same_run("scan_steps=8 against eager", t_e, t_s)
    _same_run("device_data against eager", t_e, t_d)
    eager = torch.tensor(t_e.loss_history, dtype=torch.float32,
                         device=device)
    want = [eager[k:k + SCAN_STEPS].mean().item()
            for k in range(0, steps, SCAN_STEPS)]
    if t_s.loss_history != want or len(want) != steps // SCAN_STEPS:
        raise AssertionError(f"dispatch means {t_s.loss_history[:4]} ... "
                             f"against eager {want[:4]} ...")
    if t_d.loss_history != [eager.mean().item()]:
        raise AssertionError(f"device_data epoch loss {t_d.loss_history} "
                             f"against the eager mean {eager.mean().item()}")
    ev_stream, ev_dev = t_e.evaluate(data), t_d.evaluate(data)
    eval_rel = (abs(ev_dev["test_loss"] - ev_stream["test_loss"])
                / abs(ev_stream["test_loss"]))
    if not (ev_dev["test_acc"] == ev_stream["test_acc"]
            and ev_dev["test_acc_top5"] == ev_stream["test_acc_top5"]
            and eval_rel <= SCAN_EVAL_RTOL):
        raise AssertionError(f"device eval {ev_dev} against streaming "
                             f"{ev_stream}")
    print(json.dumps({"scan_bitwise_equal": ["eager", "scan_steps=8",
                                             "device_data"],
                      "steps": steps, "dispatch_means": len(want),
                      "eval_streaming": ev_stream, "eval_device": ev_dev,
                      "eval_loss_rel_diff": eval_rel}), flush=True)
    log(f"(a) {steps} steps eager, scan_steps={SCAN_STEPS} and device_data "
        f"bitwise equal; device eval within {eval_rel:.2g}")

    # Times: a second epoch of each (graphs captured), its host clock,
    # and one step's device time from torch.profiler.
    timing = {}
    xs, ys = _chunk(data, 0, SCAN_STEPS, device, bs)
    xd, yd = (t.to(device) for t in _chunk(data, 0, 64, device, bs))
    profiled = {
        "eager": (lambda: t_e.train_step(t_e.model, t_e.optimizer,
                                         xs[0].to(device),
                                         ys[0].to(device)), 1),
        "scan": (lambda: t_s._train_scan(t_s.model, t_s.optimizer, xs, ys),
                 SCAN_STEPS),
        "device_data": (lambda: t_d._train_scan(t_d.model, t_d.optimizer,
                                                xd, yd), 64),
    }
    for name, t in (("eager", t_e), ("scan", t_s), ("device_data", t_d)):
        t.config.log_interval = 100    # TrainConfig's default
        row = t.train_epoch(data, 1)
        fn, n = profiled[name]
        dev_ms, top, kernels = _profile_device_ms(fn, calls=5, top=1000)
        step_ms = row["epoch_time_s"] / row["steps"] * 1e3
        per_step = None if dev_ms is None else dev_ms / n
        timing[name] = {
            "first_epoch_step_ms": (rows[name]["epoch_time_s"]
                                    / rows[name]["steps"] * 1e3),
            "step_ms": step_ms, "examples_per_s": bs / step_ms * 1e3,
            "device_ms_per_step": per_step,
            "kernels_per_step": kernels / n,
            "busy_share": None if per_step is None else per_step / step_ms,
            "dispatches_per_epoch": row.get("dispatches", (
                steps if name == "eager" else steps // SCAN_STEPS)),
            **_graph_stats(t),
        }
    print(json.dumps({"scan_timing": timing, "card": smi}), flush=True)
    # (f)'s CLI process runs beside the checks (b)-(e), after the times
    cli = _background(_cli_scan_row)

    # (b) pallas_xnor, dropout 0: K1 inside the graphs.
    be_data = _first_steps(data, SCAN_K1_STEPS, bs)
    kw = dict(log_interval=1, backend="pallas_xnor",
              model_kwargs={"dropout_rate": 0.0})
    t_be = _mlp_trainer(device, **kw)
    before = _kernels.LAUNCHES["xnor"]
    t_be.train_epoch(be_data, 0)
    torch.cuda.synchronize()
    k1_eager = _kernels.LAUNCHES["xnor"] - before
    t_bs = made(_mlp_trainer(device, scan_steps=SCAN_STEPS, **kw))
    t_bs.train_epoch(be_data, 0)
    _same_run("pallas_xnor scan_steps=8 against eager", t_be, t_bs)
    k1_graph = t_bs._train_scan.ran.get("xnor", 0)
    if k1_eager != 2 * SCAN_K1_STEPS or k1_graph != 2 * SCAN_K1_STEPS:
        raise AssertionError(f"K1: {k1_eager} eager launches, {k1_graph} "
                             f"in the graphs; want {2 * SCAN_K1_STEPS}")
    per_graph = 2 * SCAN_STEPS
    _, top, _ = _profile_device_ms(
        lambda: t_bs._train_scan(t_bs.model, t_bs.optimizer, xs, ys),
        calls=2, top=1000)
    k1_seen = sum(k[2] for k in top if "xnor_gemm" in k[0])
    print(json.dumps({"scan_pallas_xnor_bitwise_equal": True,
                      "k1_eager": k1_eager, "k1_in_graphs": k1_graph,
                      "k1_profiler_per_replay": k1_seen,
                      "k1_recorded_per_graph": per_graph}), flush=True)
    if k1_seen != per_graph:
        raise AssertionError(f"torch.profiler saw {k1_seen} K1 kernels a "
                             f"replay, the capture recorded {per_graph}")
    log(f"(b) pallas_xnor scan bitwise eager; K1 {k1_graph} launches in "
        f"the graphs, {k1_seen} a replay in torch.profiler")

    # (c) remat and grad_accum, dropout 0.3.
    short = _first_steps(data, SCAN_SHORT_STEPS, bs)
    runs = {}
    for name, kw in (("plain", {}), ("remat", dict(remat=True)),
                     ("remat_scan", dict(remat=True, scan_steps=4)),
                     ("accum", dict(grad_accum=SCAN_ACCUM)),
                     ("accum_scan", dict(grad_accum=SCAN_ACCUM,
                                         scan_steps=4))):
        t = _mlp_trainer(device, **kw)
        if "scan" in name:
            made(t)
        t.train_epoch(short, 0)
        runs[name] = t
    _same_run("remat against the plain step", runs["plain"], runs["remat"])
    _same_run("remat under scan_steps=4 against the plain step",
              runs["plain"], runs["remat_scan"])
    _same_run("grad_accum=4 under scan_steps=4 against eager",
              runs["accum"], runs["accum_scan"])
    print(json.dumps({"scan_remat_bitwise_equal": True,
                      "scan_grad_accum_bitwise_equal": True}), flush=True)
    log("(c) remat bitwise the plain step (eager and captured); grad_accum "
        "captured bitwise eager")
    del runs

    # (d) a stop after the 5th dispatch, then the resume.
    stop_data = _first_steps(data, SCAN_STOP_STEPS, bs)
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(ckpt, **kw):
            return made(_mlp_trainer(
                device, scan_steps=SCAN_STEPS, checkpoint_dir=ckpt,
                handle_preemption=False, **kw))

        whole = trainer(os.path.join(tmp, "whole"))
        whole.fit(stop_data, eval_every=0)
        cut_dir = os.path.join(tmp, "cut")
        cut = trainer(cut_dir)
        scan = cut._get_train_scan()
        run, calls = scan.run, [0]

        def stopping_run(*args):
            out = run(*args)
            calls[0] += 1
            if calls[0] == SCAN_STOP_AFTER:
                cut.stop.request("phase 12: a stop after 5 dispatches")
            return out

        scan.run = stopping_run
        try:
            cut.fit(stop_data, eval_every=0)
            raise AssertionError("the stop request did not stop the run")
        except Preempted:
            pass
        meta = read_meta(cut_dir)
        at = meta.get("batch_in_epoch")
        if at != SCAN_STOP_AFTER * SCAN_STEPS:
            raise AssertionError(f"mid-epoch checkpoint at batch {at}, want "
                                 f"{SCAN_STOP_AFTER * SCAN_STEPS}")
        resumed = trainer(cut_dir, resume=True)
        resumed.fit(stop_data, eval_every=0)
        _same_run("the resume against the uninterrupted run", whole, resumed)
    print(json.dumps({"scan_stop_at_batch": at,
                      "scan_resume_bitwise_equal": True}), flush=True)
    log(f"(d) stopped at batch {at}; the resume ends on the uninterrupted "
        "state")

    # (e) bnn-cnn on bf16, its convs inside the graph.
    t_ce = _cnn_trainer(device, log_interval=1)
    t_cs = made(_cnn_trainer(device, log_interval=1,
                             scan_steps=SCAN_CNN_STEPS))
    for t in (t_ce, t_cs):
        t.train_epoch(short, 0)
    _same_run("bnn-cnn scan_steps=4 against eager", t_ce, t_cs)
    print(json.dumps({"scan_bnn_cnn_bitwise_equal": True,
                      "cnn_dispatch": _graph_stats(t_cs)}), flush=True)
    log("(e) bnn-cnn captured bitwise eager")

    # (f) the CLI in a process of its own.
    cli_row = cli()
    cli_ms = cli_row["batch_time_s"] * 1e3
    per_step = timing["scan"]["device_ms_per_step"]
    cli = {"cli_scan_device_data_row": cli_row, "step_ms": cli_ms,
           "examples_per_s": bs / cli_ms * 1e3,
           "busy_share": None if per_step is None else per_step / cli_ms}
    print(json.dumps(cli), flush=True)
    full = MLP_SYNTH[0] // bs
    if not (np.isfinite(cli_row["train_loss"])
            and cli_row["test_acc"] > MLP_MIN_ACC
            and cli_row["steps"] == full
            and cli_row.get("dispatches") == -(-full // SCAN_STEPS)):
        raise AssertionError(f"cli train --scan-steps --device-data: "
                             f"{cli_row}")
    log(f"(f) cli train --scan-steps {SCAN_STEPS} --device-data: test_acc "
        f"{cli_row['test_acc']:.2f}, {cli_ms:.3f} ms a step")

    torch.cuda.synchronize()
    recorded, ran = {}, {}
    for scan in (t._train_scan for t in trainers):
        for k in scan.recorded:
            recorded[k] = recorded.get(k, 0) + scan.recorded[k]
            ran[k] = ran.get(k, 0) + scan.ran.get(k, 0)
    counts = {k: _kernels.LAUNCHES[k] - raw0[k] - recorded.get(k, 0)
              + ran.get(k, 0) for k in KERNEL_ROWS}
    print(json.dumps({"slice": "scan", "launches": counts,
                      "launches_in_graphs": ran,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    return counts, ran


# -- phase 13: data parallelism captured -----------------------------------------


def _dpc_trainer(device, **kw):
    """Phase 13's recipe: phase 9's (``MLP_TRAIN``) on pallas_xnor,
    dropout 0.3, one rank of the process group (``data_parallel=1``)."""
    cfg = dict(backend="pallas_xnor", model_kwargs={"dropout_rate": 0.3},
               data_parallel=1, log_interval=1)
    cfg.update(kw)
    return _mlp_trainer(device, **cfg)


def _opt_state_bytes(trainer) -> int:
    """The bytes of this rank's optimizer state: moments (of its shards
    or segment), the exchange's rows and an FSDP rank's master shards;
    not the model's parameters."""
    opt = trainer.optimizer
    own = {id(p) for p in trainer.model.parameters()}
    return sum(t.numel() * t.element_size() for t in opt.state_tensors()
               if id(t) not in own)


class _CollectiveCalls:
    """Counts the ``torch.distributed`` collectives called from Python
    while it is entered (a replayed graph calls none)."""

    NAMES = ("all_reduce", "reduce_scatter_tensor", "all_gather_into_tensor",
             "all_to_all_single", "all_gather")

    def __enter__(self):
        import torch.distributed as dist

        self.calls = 0
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def counted(fn):
            def call(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return call

        for n, fn in self.saved.items():
            setattr(dist, n, counted(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self.saved.items():
            setattr(dist, n, fn)
        return False


def _dpc_save_rank(rank: int, world: int, device, steps: int, ckpt: str):
    """Phase 13 (d) in one of 2 gloo ranks sharing the card: ``steps``
    steps of sign_ef, checkpointed; the error-feedback rows."""
    with tempfile.TemporaryDirectory() as tmp:
        data = _dp_data(tmp, steps)
    t = _dpc_trainer(device, grad_compress="sign_ef", data_parallel="auto",
                     checkpoint_dir=ckpt)
    t.fit(data, eval_every=0)
    return {k: v.cpu().numpy() for k, v in t.ef_rows().items()}


def _cli_dp_capture_row() -> dict:
    """``cli train --dp 1 --dp-mode fsdp --scan-steps 8 --device-data``
    in a process of its own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", MLP_TRAIN["model"],
            "--epochs", "1", "--batch-size", str(MLP_TRAIN["batch_size"]),
            "--optimizer", MLP_TRAIN["optimizer"],
            "--lr", str(MLP_TRAIN["learning_rate"]),
            "--seed", str(MLP_TRAIN["seed"]), "--backend", "pallas_xnor",
            "--synthetic-sizes", *map(str, DPC_CLI_SYNTH),
            "--dp", "1", "--dp-mode", "fsdp",
            "--scan-steps", str(SCAN_STEPS), "--device-data"]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --dp 1 --dp-mode fsdp exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def dp_capture_phase(device: torch.device, smi: str):
    """Phase 13, data parallelism captured (``parallel.fsdp``,
    ``SignCompressFsdp``, ``parallel.remesh``, ``TrainScan`` over the
    data-parallel steps), in this process as the one rank of an NCCL
    group, ``bnn-mlp-large`` on phase 9's recipe on pallas_xnor with
    dropout 0.3 (``_dpc_trainer``):

    (a) ``DPC_STEPS`` steps of fp32 FSDP bitwise the single-card
    trainer's (the reduce-scatter and all-gather of one rank are
    copies), and of compressed FSDP bitwise the single-process
    compressed FSDP trainer's;
    (b) uncompressed DP (the gradient all-reduce and the metrics'), the
    flat ``sign_ef`` exchange, fp32 FSDP and compressed FSDP, each eager
    and with ``scan_steps=8`` (uncompressed DP also with
    ``device_data``): every tensor and the generator ``torch.equal``;
    K1 2 x ``DPC_STEPS`` times inside the graphs (recorded launches x
    replays), as many K1 kernels a replay in ``torch.profiler`` as
    recorded; the collectives recorded into each graph counted from
    Python at capture (a replay calls none); wire bytes recorded x
    replays equal to the plan's;
    (c) ``grad_accum=4`` and ``remat`` under uncompressed DP and fp32
    FSDP, captured, bitwise eager;
    (d) a ``sign_ef`` checkpoint of 2 gloo ranks sharing the card
    resumed here at world 1 with ``elastic=True``: the rows after the
    restore equal ``remesh_compress_state`` of the saved rows, and
    training continues;
    (e) ``cli train --dp 1 --dp-mode fsdp --scan-steps 8 --device-data``
    in a process of its own.
    Then each mode's eager and captured step time on the host clock,
    device time a step and busy share, and its optimizer-state bytes.
    Returns (each kernel's launches on this path, K1's inside graphs)."""
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.parallel import (
        init_world,
        remesh_compress_state,
        spawn,
    )
    from distributed_mnist_bnns_tpu_torch.utils import msgpack
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import LATEST

    t_phase = time.perf_counter()
    bs = MLP_TRAIN["batch_size"]
    raw0 = dict(_kernels.LAUNCHES)
    trainers = []      # every trainer whose graphs ran

    def made(t):
        trainers.append(t)
        return t

    tmp = tempfile.mkdtemp(prefix="phase13-")
    init_world(0, 1, backend="nccl", init_file=os.path.join(tmp, "pg"))
    try:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=SCAN_SYNTH, seed=0)
        steps = _first_steps(data, DPC_STEPS, bs)

        # (a) FSDP at world 1 against one process
        runs = {}
        for name, kw in (("single", dict(data_parallel=None)),
                         ("fsdp", dict(dp_mode="fsdp")),
                         ("cfsdp_single", dict(data_parallel=None,
                                               dp_mode="fsdp",
                                               grad_compress="sign_ef")),
                         ("cfsdp", dict(dp_mode="fsdp",
                                        grad_compress="sign_ef"))):
            runs[name] = t = _dpc_trainer(device, **kw)
            t.train_epoch(steps, 0)
        if not (runs["fsdp"].distributed and runs["fsdp"].fsdp is not None):
            raise AssertionError("the FSDP trainer did not shard")
        _same_run("fp32 FSDP at world 1 against the single-card trainer",
                  runs["single"], runs["fsdp"])
        _same_run("compressed FSDP at world 1 against one process",
                  runs["cfsdp_single"], runs["cfsdp"])
        print(json.dumps({"dpc_fsdp_world1_bitwise_single_card": True,
                          "dpc_cfsdp_world1_bitwise_one_process": True,
                          "steps": DPC_STEPS}), flush=True)
        log(f"(a) FSDP and compressed FSDP at world 1 bitwise one process "
            f"({DPC_STEPS} steps)")

        # (b) every mode eager and captured
        modes = {"dp": {}, "sign_ef": dict(grad_compress="sign_ef"),
                 "fsdp": dict(dp_mode="fsdp"),
                 "cfsdp": dict(dp_mode="fsdp", grad_compress="sign_ef")}
        eager, captured, rows = {}, {}, {}
        xs, ys = _chunk(data, 0, SCAN_STEPS, device, bs)
        for name, kw in modes.items():
            eager[name] = _dpc_trainer(device, **kw)
            t_e = eager[name]
            with _CollectiveCalls() as per_eager:
                t_e.train_epoch(steps, 0)
            variants = [("scan", dict(scan_steps=SCAN_STEPS))]
            if name == "dp":
                variants.append(("device_data", dict(
                    scan_steps=SCAN_STEPS, device_data=True,
                    log_interval=100)))
            for vname, vkw in variants:
                t = made(_dpc_trainer(device, **kw, **vkw))
                captured[(name, vname)] = t
                with _CollectiveCalls() as calls:
                    t.train_epoch(steps, 0)
                _same_run(f"{name} {vname} against eager", t_e, t)
                scan = t._train_scan
                k1 = scan.ran.get("xnor", 0)
                if k1 != 2 * DPC_STEPS:
                    raise AssertionError(f"{name} {vname}: K1 {k1} times "
                                         f"in the graphs, want "
                                         f"{2 * DPC_STEPS}")
                plan = t.comm_plan
                plan_bytes = 0 if plan is None else plan.wire_bytes_per_step
                if t.comm_bytes() != DPC_STEPS * plan_bytes:
                    raise AssertionError(f"{name} {vname}: {t.comm_bytes()} "
                                         f"wire bytes, the plan's "
                                         f"{DPC_STEPS * plan_bytes}")
                # one eager step's collectives (the warm-up) and then the
                # capture's; replays call none from Python
                per_step = per_eager.calls / DPC_STEPS
                in_graph = calls.calls - per_step
                rows[(name, vname)] = {
                    "collectives_per_step_eager": per_step,
                    "collectives_recorded_per_graph": in_graph,
                    "graphs": len(scan.graphs), "replays": sum(
                        g.replays for g in scan.graphs.values()),
                    "k1_in_graphs": k1, "wire_bytes": t.comm_bytes(),
                    "plan_bytes": DPC_STEPS * plan_bytes}
                if in_graph < per_step * SCAN_STEPS:
                    raise AssertionError(f"{name} {vname}: {in_graph} "
                                         "collectives recorded, want "
                                         f"{per_step * SCAN_STEPS}")
            _, top, _ = _profile_device_ms(
                lambda: captured[(name, "scan")]._train_scan(
                    captured[(name, "scan")].model,
                    captured[(name, "scan")].optimizer, xs, ys),
                calls=2, top=1000)
            k1_seen = sum(k[2] for k in top if "xnor_gemm" in k[0])
            nccl_seen = sum(k[2] for k in top if "nccl" in k[0].lower())
            rows[(name, "scan")].update(k1_profiler_per_replay=k1_seen,
                                        nccl_kernels_per_replay=nccl_seen)
            if k1_seen != 2 * SCAN_STEPS:
                raise AssertionError(f"{name}: torch.profiler saw {k1_seen} "
                                     f"K1 kernels a replay, the capture "
                                     f"recorded {2 * SCAN_STEPS}")
        print(json.dumps({"dpc_bitwise": {f"{m}/{v}": r for (m, v), r
                                          in rows.items()}}), flush=True)
        log("(b) dp, sign_ef, fsdp, cfsdp: scan_steps=8 (and dp's "
            "device_data) bitwise eager; K1 and the collectives inside the "
            "graphs")

        # (c) grad_accum and remat under DP, captured
        short = _first_steps(data, DPC_SHORT_STEPS, bs)
        for name in ("dp", "fsdp"):
            kw = modes[name]
            plain = _dpc_trainer(device, **kw)
            accum = _dpc_trainer(device, grad_accum=SCAN_ACCUM, **kw)
            accum_s = made(_dpc_trainer(device, grad_accum=SCAN_ACCUM,
                                        scan_steps=SCAN_STEPS, **kw))
            remat_s = made(_dpc_trainer(device, remat=True,
                                        scan_steps=SCAN_STEPS, **kw))
            for t in (plain, accum, accum_s, remat_s):
                t.train_epoch(short, 0)
            _same_run(f"{name} grad_accum=4 captured against eager", accum,
                      accum_s)
            _same_run(f"{name} remat captured against the plain step",
                      plain, remat_s)
        print(json.dumps({"dpc_grad_accum_bitwise": ["dp", "fsdp"],
                          "dpc_remat_bitwise": ["dp", "fsdp"]}), flush=True)
        log("(c) grad_accum=4 and remat under DP and FSDP captured bitwise "
            "eager")

        # (e)'s CLI process runs beside (d)'s ranks
        cli = _background(_cli_dp_capture_row)
        # (d) a world-2 sign_ef checkpoint resumed at world 1, elastic
        ckpt = os.path.join(tmp, "elastic")
        saved = spawn(_dpc_save_rank, 2, backend="gloo", device="cuda",
                      args=(DPC_SHORT_STEPS, ckpt))[0]
        with open(os.path.join(ckpt, LATEST), "rb") as f:
            tree = msgpack.from_bytes(f.read())
        t_el = _dpc_trainer(device, grad_compress="sign_ef", elastic=True,
                            checkpoint_dir=ckpt, resume=True, epochs=2)
        start, _ = t_el.try_resume()
        want, n = remesh_compress_state(tree["opt_state"], t_el.comm_plan)
        got = {k: v.cpu().numpy() for k, v in t_el.ef_rows().items()}
        node = want["inner_state"]["0"]
        if not (n == 1 and start == 1 and all(
                np.array_equal(got[k], node[k]) for k in got)
                and np.array_equal(np.asarray(tree["opt_state"][
                    "inner_state"]["0"]["ef_residual"]),
                    saved["ef_residual"])):
            raise AssertionError("the elastic restore's rows differ from "
                                 "remesh_compress_state of the saved rows")
        t_el.train_epoch(short, 1)
        if not all(np.isfinite(t_el.loss_history)):
            raise AssertionError(f"after the elastic restore: losses "
                                 f"{t_el.loss_history}")
        print(json.dumps({"dpc_elastic": {
            "saved_world": 2, "resumed_world": t_el.world,
            "rows": {k: list(v.shape) for k, v in got.items()},
            "steps_after": DPC_SHORT_STEPS,
            "last_loss": t_el.loss_history[-1]}}), flush=True)
        log("(d) a world-2 sign_ef checkpoint resumed at world 1 with "
            "elastic=True: rows equal remesh_compress_state's")

        # (e) the CLI
        cli_row = cli()
        print(json.dumps({"dpc_cli_row": cli_row}), flush=True)
        if not (np.isfinite(cli_row["train_loss"]) and cli_row["steps"]
                == DPC_CLI_SYNTH[0] // bs):
            raise AssertionError(f"cli train --dp 1 --dp-mode fsdp: "
                                 f"{cli_row}")
        log("(e) cli train --dp 1 --dp-mode fsdp --scan-steps 8 "
            "--device-data ran")

        # Times: eager against captured, each mode
        timing = {}
        for name in modes:
            for vname, t in (("eager", eager[name]),
                             ("scan", captured[(name, "scan")])):
                t.config.log_interval = 100
                row = t.train_epoch(steps, 1)
                step_ms = row["epoch_time_s"] / row["steps"] * 1e3
                if vname == "eager":
                    x0, y0 = xs[0].to(device), ys[0].to(device)
                    fn, n_steps = (lambda t=t, x0=x0, y0=y0: t.train_step(
                        t.model, t.optimizer, x0, y0)), 1
                else:
                    fn, n_steps = (lambda t=t: t._train_scan(
                        t.model, t.optimizer, xs, ys)), SCAN_STEPS
                dev_ms, _, _ = _profile_device_ms(fn, calls=5, top=1)
                per = None if dev_ms is None else dev_ms / n_steps
                timing[f"{name}/{vname}"] = {
                    "step_ms": step_ms, "examples_per_s": bs / step_ms * 1e3,
                    "device_ms_per_step": per,
                    "busy_share": None if per is None else per / step_ms,
                    "optimizer_state_bytes": _opt_state_bytes(t)}
        print(json.dumps({"dpc_timing": timing, "card": smi}), flush=True)
    finally:
        torch.cuda.synchronize()
        dist.destroy_process_group()
    recorded, ran = {}, {}
    for scan in (t._train_scan for t in trainers):
        for k in scan.recorded:
            recorded[k] = recorded.get(k, 0) + scan.recorded[k]
            ran[k] = ran.get(k, 0) + scan.ran.get(k, 0)
    counts = {k: _kernels.LAUNCHES[k] - raw0[k] - recorded.get(k, 0)
              + ran.get(k, 0) for k in KERNEL_ROWS}
    print(json.dumps({"slice": "dp_capture", "launches": counts,
                      "launches_in_graphs": ran,
                      "phase_s": time.perf_counter() - t_phase}), flush=True)
    return counts, ran


# -- phase 14: model parallelism ---------------------------------------------


def _mlp_features(model, x: torch.Tensor) -> torch.Tensor:
    """``BnnMLP``'s forward up to the head (the activation entering it):
    on a tensor-parallel model, this rank's features."""
    from distributed_mnist_bnns_tpu_torch.models.layers import hard_tanh

    x = x.reshape(x.shape[0], -1)
    x = hard_tanh(model.bn1(model.fc1(x)))
    x = hard_tanh(model.bn2(model.fc2(x)))
    return hard_tanh(model.bn3(model.dropout(model.fc3(x))))


def _np_tree(tree):
    """A nested dict of tensors as numpy copies."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return np.array(tree.detach().cpu() if torch.is_tensor(tree) else tree)


def _mp_tp_rank(rank: int, world: int, device, dp: int, xs, ys, x_eval):
    """Phase 14 (a) in one of ``world`` gloo ranks sharing the card:
    ``MP_TP_STEPS`` steps of the (dp x world/dp) tensor-parallel trainer,
    its K1 launches and wire bytes; then its eval forward up to the head
    against the unsharded model holding the gathered weights."""
    import hashlib

    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.interop import (
        params_from_jax,
        train_state_to_jax,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    t = Trainer(TrainConfig(device=str(device), data_parallel=dp,
                            tensor_parallel=world // dp, log_interval=1,
                            **MP_TRAIN))
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else lambda: None)
    _kernels.reset_launches()
    losses = []
    sync()
    t0 = time.perf_counter()
    for x, y in zip(xs, ys):
        xb = torch.from_numpy(t._shard(x)).to(device)
        yb = torch.from_numpy(t._shard(y).astype(np.int64)).to(device)
        loss, _ = t.train_step(t.model, t.optimizer, xb, yb)
        losses.append(loss)
    sync()
    step_ms = (time.perf_counter() - t0) / len(xs) * 1e3
    k1 = _kernels.LAUNCHES["xnor"]
    wire = {f"{lv}/{ph}": n for (lv, ph), n in sorted(t.wire.items())}
    repl = hashlib.sha256()
    for name, v in sorted({**dict(t.model.named_parameters()),
                           **dict(t.model.named_buffers())}.items()):
        if t.tp.dims.get(v, 0) is None:
            repl.update(name.encode() + v.detach().cpu().numpy().tobytes())
    state = train_state_to_jax(t)
    full = params_from_jax(
        {"params": state["params"], "batch_stats": state["batch_stats"]},
        get_model("bnn-mlp-large", backend="pallas_xnor")).to(device)
    t.model.eval()
    xe = torch.from_numpy(x_eval).to(device)
    with torch.no_grad():
        part = _mlp_features(t.model, xe)
        shards = [torch.empty_like(part) for _ in range(t.tp.tp)]
        dist.all_gather(shards, part.contiguous(), group=t.tp.group)
        feats = torch.cat(shards, dim=1)
        want = _mlp_features(full, xe)
        logits_err = float((t.model(xe) - full(xe)).abs().max())
    return {"losses": [float(v) for v in losses], "k1": k1, "wire": wire,
            "step_ms": step_ms, "repl": repl.hexdigest(),
            "model_rank": t.tp.rank,
            "features_equal": bool(torch.equal(feats, want)),
            "features_err": float((feats - want).abs().max()),
            "logits_err": logits_err,
            "params": _np_tree(state["params"]) if rank == 0 else None,
            "stats": _np_tree(state["batch_stats"]) if rank == 0 else None}


def _mp_tp(device, smi: str) -> dict:
    """Phase 14 (a): 2 ranks at tp = 2, then 4 at data 2 x model 2,
    against the single-process trainer (the data-parallel run of world 1:
    the same global batch, BatchNorm over it) on the card."""
    from distributed_mnist_bnns_tpu_torch.interop import train_state_to_jax
    from distributed_mnist_bnns_tpu_torch.parallel import spawn, tp_wire_plan
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.RandomState(14)
    xs = rng.randn(MP_TP_STEPS, MP_BATCH, 784).astype(np.float32)
    ys = rng.randint(0, 10, (MP_TP_STEPS, MP_BATCH)).astype(np.int32)
    ref = Trainer(TrainConfig(device="cuda", log_interval=1, **MP_TRAIN))
    ref_losses = []
    for x, y in zip(xs, ys):
        loss, _ = ref.train_step(
            ref.model, ref.optimizer, torch.from_numpy(x).to(device),
            torch.from_numpy(y.astype(np.int64)).to(device))
        ref_losses.append(float(loss))
    ref_state = _np_tree(train_state_to_jax(ref))
    out = {}
    total_k1 = 0
    layouts = ((1, 2), (2, 2))
    # both layouts' ranks at once (6 processes sharing the card)
    joins = [_background(lambda dp=dp, tp=tp: spawn(
        _mp_tp_rank, dp * tp, backend="gloo", device="cuda",
        args=(dp, xs, ys, xs[0]))) for dp, tp in layouts]
    for (dp, tp), join in zip(layouts, joins):
        name = f"dp{dp}xtp{tp}"
        ranks = join()
        plan = tp_wire_plan(ref.model, tp=tp, dp=dp, batch=MP_BATCH)
        want_plan = MP_TP_PLAN[(dp, tp)]
        if {k: plan[k] for k in want_plan} != want_plan:
            raise AssertionError(f"{name}: tp_wire_plan {plan} is not the "
                                 f"plan in PERF.md {want_plan}")
        for r in ranks:
            if r["k1"] != 2 * MP_TP_STEPS:
                raise AssertionError(f"{name}: K1 launched {r['k1']} times "
                                     f"in a rank, want {2 * MP_TP_STEPS}")
            got_model = sum(n for k, n in r["wire"].items()
                            if k.startswith("model/")) // MP_TP_STEPS
            got_data = sum(n for k, n in r["wire"].items()
                           if k.startswith("inter/")) // MP_TP_STEPS
            if (got_model, got_data) != (want_plan["model"],
                                         want_plan["data"]):
                raise AssertionError(
                    f"{name}: {got_model} model-group and {got_data} "
                    f"data-group bytes a step, the plan's {want_plan}")
            if not r["features_equal"]:
                raise AssertionError(
                    f"{name}: the TP forward up to the head differs from "
                    f"the unsharded one by {r['features_err']}")
            if r["losses"] != ranks[0]["losses"]:
                raise AssertionError(f"{name}: ranks' losses differ")
        repl = [r["repl"] for r in ranks]
        if len(set(repl)) != 1:
            raise AssertionError(f"{name}: replicated leaves differ "
                                 f"between model ranks")
        loss_err = max(abs(a - b) for a, b in zip(ranks[0]["losses"],
                                                  ref_losses))
        if loss_err > MP_LOSS_ATOL:
            raise AssertionError(f"{name}: losses {loss_err} from the "
                                 "data-parallel run's")
        param_err = 0.0
        for layer, leaves in ref_state["params"].items():
            for leaf, want in leaves.items():
                got = ranks[0]["params"][layer][leaf]
                np.testing.assert_allclose(got, want, atol=MP_PARAM_TOL,
                                           rtol=MP_PARAM_TOL,
                                           err_msg=f"{name} {layer}/{leaf}")
                param_err = max(param_err, float(np.abs(got - want).max()))
        total_k1 += sum(r["k1"] for r in ranks)
        out[name] = {"ranks": dp * tp, "loss_err": loss_err,
                     "param_err": param_err,
                     "logits_err": max(r["logits_err"] for r in ranks),
                     "wire_per_step": want_plan,
                     "step_ms_host": [round(r["step_ms"], 3) for r in ranks],
                     "k1_per_rank": ranks[0]["k1"],
                     "final_loss": ranks[0]["losses"][-1], "card": smi}
        print(json.dumps({"phase": "14a", "run": name, **out[name]}),
              flush=True)
    out["k1_launches"] = total_k1
    return out


def _mp_lm(device):
    """The LM of (b): the --lm-bench widths, flash attention, seeded, with
    non-zero biases and LayerNorm parameters."""
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM

    model = BinarizedLM(max_len=LM_TRAIN_SEQ, attention="flash",
                        generator=torch.Generator().manual_seed(0),
                        **LM_TRAIN)
    _random_lm_params(model, torch.Generator().manual_seed(1))
    return model.to(device)


def _mp_pp_train_rank(rank: int, world: int, device, tokens):
    """Phase 14 (b): this stage of the pipelined LM (random biases): its
    eval forward, then ``MP_PP_STEPS`` steps of ``lm_demo._pp_step``
    (Adam). Before each,
    the parameters and that step's gradients are gathered from the
    stages, and rank 0 runs the sequential model on those parameters:
    each step's loss and each leaf's gradient (relative L2) against it.
    Returns rank 0's (forward, per-step errors and losses)."""
    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.interop import (
        Layout,
        _layout_tree,
        lm_params_from_jax,
    )
    from distributed_mnist_bnns_tpu_torch.models import (
        latent_clamp_mask,
        lm_loss,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        PipelinedModel,
        sequential_params,
    )
    from distributed_mnist_bnns_tpu_torch.train import clamp_latent

    torch.backends.cuda.matmul.allow_tf32 = False
    pm = PipelinedModel(_mp_lm(device), Mesh((world,), ("pipe",)),
                        n_micro=MP_PP_MICRO)
    latents = list(latent_clamp_mask(pm).values())
    opt = lm_demo.make_optimizer(pm, LM_TRAIN_LR)
    tok = torch.from_numpy(tokens).to(device)
    with torch.no_grad():
        fwd = pm.eval()(tok).cpu().numpy()   # the eval forward first
    pm.train()

    def tree_of(fn):
        return sequential_params(_layout_tree(pm, "params", fn),
                                 LM_TRAIN["depth"])

    steps = []
    for _ in range(MP_PP_STEPS):
        params = tree_of(lambda p: p.detach().clone())
        opt.zero_grad(set_to_none=True)
        loss = lm_loss(pm(tok), tok)
        loss.backward()
        pm.sync_grads()
        grads = tree_of(lambda p: p.grad)
        opt.step()
        clamp_latent(latents)
        if rank:
            continue
        seq = lm_params_from_jax(
            {k: _np_tree(v) for k, v in params.items()},
            num_heads=LM_TRAIN["num_heads"], attention="flash").to(device)
        seq.train()
        seq_loss = lm_loss(seq(tok), tok)
        seq_loss.backward()
        want = _np_tree(_layout_tree(Layout(seq), "params",
                                     lambda p: p.grad))
        steps.append({"loss": float(loss.detach()),
                      "seq_loss": float(seq_loss.detach()),
                      "grad_rel_l2": _rel_l2(_np_tree(grads), want)})
    return (fwd, steps) if rank == 0 else None


# the key projection's bias: an exact-zero gradient (softmax ignores a
# constant added to a row's scores), rounding noise that Adam turns into
# moves of up to lr; printed, not held (ROADMAP queue 3)
_KEY_BIAS = "BinarizedSelfAttention_0/BinarizedDense_1/bias"


def _rel_l2(got, want) -> dict:
    """Each leaf's relative L2 distance, by '/'-joined flax path."""
    out = {}

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], path + (k,))
            return
        out["/".join(path)] = float(np.linalg.norm(a - b)
                                    / max(np.linalg.norm(b), 1e-30))

    walk(got, want, ())
    return out


def _mp_pp(device, smi: str) -> dict:
    """Phase 14 (b): the LM pipelined over 2 gloo ranks sharing the card,
    random biases and LayerNorm parameters: the eval forward against the
    sequential model's in this process; 10 Adam steps, each one's loss
    and gradients against the sequential model's on the same parameters
    (``_mp_pp_train_rank``); then ``lm_demo.run(pp=2)`` 10 steps twice
    (bitwise equal), K4-K6 each (depth / pp) x n_micro x steps times in
    each rank."""
    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.parallel import (
        pipeline_bubble_fraction,
        spawn,
    )

    t0 = time.perf_counter()
    tokens = np.random.RandomState(15).randint(
        0, LM_TRAIN["vocab"], (LM_TRAIN_BATCH, LM_TRAIN_SEQ))
    tok = torch.from_numpy(tokens).to(device)
    got, steps = spawn(_mp_pp_train_rank, MP_PP, backend="gloo",
                       device="cuda", args=(tokens,))[0]
    with torch.no_grad():
        want = _mp_lm(device).eval()(tok)
    fwd_err = float(np.abs(got - want.cpu().numpy()).max())
    if not fwd_err <= MP_PP_FWD_ATOL:
        raise AssertionError(f"the pipelined LM forward is {fwd_err} from "
                             "the sequential one")
    key_bias, grad_worst, loss_rel = 0.0, 0.0, 0.0
    for i, st in enumerate(steps):
        loss_rel = max(loss_rel, abs(st["loss"] - st["seq_loss"])
                       / abs(st["seq_loss"]))
        for path, v in st["grad_rel_l2"].items():
            if _KEY_BIAS in path:
                key_bias = max(key_bias, v)
            elif v > LM_GRAD_RTOL:
                raise AssertionError(
                    f"pipelined LM step {i}: gradient {path} is {v} "
                    "(relative L2) from the sequential model's")
            else:
                grad_worst = max(grad_worst, v)
    if loss_rel > MP_PP_LOSS_RTOL:
        raise AssertionError(f"pipelined LM losses {loss_rel} (relative) "
                             "from the sequential model's")
    t1 = time.perf_counter()
    kw = dict(steps=MP_PP_STEPS, seq_len=LM_TRAIN_SEQ,
              batch=LM_TRAIN_BATCH, lr=LM_TRAIN_LR, attention="flash",
              log_every=MP_PP_STEPS, **LM_TRAIN)
    joins = [_background(lambda: lm_demo.run(pp=MP_PP, backend="gloo",
                                             device="cuda", **kw))
             for _ in range(2)]   # the two runs at once
    runs = [join() for join in joins]
    a, b = runs
    if a.history != b.history or any(
            not torch.equal(v, b.model.state_dict()[k])
            for k, v in a.model.state_dict().items()):
        raise AssertionError("two pipelined LM runs differ")
    want_launches = (LM_TRAIN["depth"] // MP_PP) * MP_PP_MICRO * MP_PP_STEPS
    for r in a.ranks + b.ranks:
        for name in FLASH:
            if r["launches"][name] != want_launches:
                raise AssertionError(
                    f"{name} launched {r['launches'][name]} times in a "
                    f"pipelined rank, want {want_launches}")
    launches = {name: sum(r["launches"][name] for r in a.ranks + b.ranks)
                for name in FLASH}
    out = {"fwd_max_abs_err": fwd_err, "loss_rel_err": loss_rel,
           "grad_rel_l2": grad_worst, "key_bias_grad_rel_l2": key_bias,
           "losses": [st["loss"] for st in steps],
           "launches_per_rank": want_launches,
           "launches": launches, "checks_s": t1 - t0,
           "run_s": (time.perf_counter() - t1) / 2,
           "bubble_fraction": pipeline_bubble_fraction(MP_PP, MP_PP_MICRO),
           "card": smi}
    print(json.dumps({"phase": "14b", **out}), flush=True)
    return out


def _mp_cli_vit(smi: str) -> dict:
    """Phase 14 (c): ``cli train --model bnn-vit-tiny --pp 2`` one epoch
    in a process of its own (2 gloo ranks sharing the card)."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", "bnn-vit-tiny",
            "--epochs", "1", "--batch-size", "64", "--optimizer", "adam",
            "--lr", "0.003", "--seed", "0", "--pp", "2",
            "--dist-backend", "gloo",
            "--synthetic-sizes", *map(str, MP_VIT_SYNTH)]
    t0 = time.perf_counter()
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --pp 2 failed: {out.stderr[-3000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    if not (row["test_acc"] > MLP_MIN_ACC
            and np.isfinite(row["train_loss"])):
        raise AssertionError(f"cli train --pp 2 did not converge: {row}")
    row["process_s"] = time.perf_counter() - t0
    print(json.dumps({"phase": "14c", **{k: row[k] for k in (
        "test_acc", "train_loss", "batch_time_s", "epoch_time_s",
        "process_s")}, "card": smi}), flush=True)
    return row


def _mp_tpp_rank(rank: int, world: int, device, params):
    """Phase 14 (d) in one of 4 gloo ranks: ``make_tp_pipeline_fn`` at
    (data 1, model 2, pipe 2), ``MP_TPP["steps"]`` SGD steps (latents
    clamped). Each rank holds the full stage-major tensors and updates
    its slices; before each step the current parameters are assembled
    from every rank's slices, and ``tp_pipeline_reference`` runs on
    them: the step's output (relative to its scale), loss (relative) and
    this rank's slices of the gradients (relative L2) against it."""
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.parallel import (
        latent_mask,
        make_mesh,
        make_tp_pipeline_fn,
        tp_pipeline_param_specs,
        tp_pipeline_reference,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(data=1, model=2, pipe=2)
    f = make_tp_pipeline_fn(mesh)
    specs = tp_pipeline_param_specs()
    got = {k: torch.tensor(v, device=device, requires_grad=True)
           for k, v in params.items()}
    rng = np.random.RandomState(5)
    xd = torch.from_numpy(rng.randn(MP_TPP["batch"], MP_TPP["d_model"])
                          .astype(np.float32)).to(device)
    td = torch.from_numpy(rng.randn(MP_TPP["batch"], MP_TPP["d_model"])
                          .astype(np.float32)).to(device)
    mask = latent_mask(params)

    def local(k, t):
        """This rank's slice of stage-major leaf ``k`` (a view)."""
        t = t[mesh.index("pipe")]
        for dim, name in enumerate(specs[k][1:]):
            if name is not None:
                n = t.shape[dim] // mesh.size(name)
                t = t.narrow(dim, mesh.index(name) * n, n)
        return t

    def assembled():
        """The current full parameters: every rank's slices summed over
        the world, each divided by the ranks that hold it."""
        out = {}
        for k, v in got.items():
            part = torch.zeros_like(v.detach())
            local(k, part).copy_(local(k, v.detach()))
            dist.all_reduce(part)
            holders = 1 if "model" in specs[k] else mesh.size("model")
            out[k] = (part / holders).requires_grad_()
        return out

    err = {"fwd": 0.0, "loss": 0.0, "grad": 0.0}
    losses = []
    for _ in range(MP_TPP["steps"]):
        ref = assembled()
        want = tp_pipeline_reference(ref, xd)
        y = f(got, xd)
        err["fwd"] = max(err["fwd"], float((y - want).abs().max()
                                           / want.abs().max()))
        loss = ((y - td) ** 2).mean()
        ref_loss = ((want - td) ** 2).mean()
        loss.backward()
        ref_loss.backward()
        err["loss"] = max(err["loss"], abs(float(loss) - float(ref_loss))
                          / abs(float(ref_loss)))
        with torch.no_grad():
            for k, v in got.items():
                a, b = local(k, v.grad), local(k, ref[k].grad)
                err["grad"] = max(err["grad"], float(
                    (a - b).norm() / b.norm().clamp_min(1e-30)))
                v -= MP_TPP["lr"] * v.grad
                v.grad = None
                if mask[k]:
                    v.clamp_(-1.0, 1.0)
        losses.append(float(loss.detach()))
    return {**err, "losses": losses}


def _mp_tpp(smi: str) -> dict:
    """Phase 14 (d): the three-axis composition on 4 gloo ranks."""
    from distributed_mnist_bnns_tpu_torch.parallel import (
        init_tp_pipeline_params,
        spawn,
    )

    params = {k: v.numpy() for k, v in init_tp_pipeline_params(
        torch.Generator().manual_seed(3), 2, MP_TPP["d_model"],
        MP_TPP["d_hidden"]).items()}
    params["b1"] = np.random.RandomState(4).randn(
        *params["b1"].shape).astype(np.float32) * 0.1
    ranks = spawn(_mp_tpp_rank, 4, backend="gloo", device="cuda",
                  args=(params,))
    out = {k: max(r[k] for r in ranks) for k in ("fwd", "loss", "grad")}
    out.update(losses=ranks[0]["losses"], card=smi)
    if not (out["fwd"] <= MP_TPP_RTOL and out["loss"] <= MP_TPP_LOSS_RTOL
            and out["grad"] <= MP_TPP_GRAD_RTOL):
        raise AssertionError(f"tp_pipeline against its reference: {out}")
    if not out["losses"][-1] < out["losses"][0]:
        raise AssertionError(f"tp_pipeline did not train: {out}")
    print(json.dumps({"phase": "14d", **out}), flush=True)
    return out


def _k1_mp_rows(device, gen) -> list:
    """K1 at the tensor-parallel shards' shapes: equal to its plain
    version, timed with its plain version, bf16 ``torch.matmul`` of the
    same ±1 values and its bound."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    rows = []
    for m, k, n in MP_K1_SHAPES:
        x = _pm1(gen, m, k).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        got = _kernels.xnor_gemm("xnor", x, wp, k, n)
        want = xg.xnor_gemm_plain(pack_bits(x), wp, k)[:, :n]
        if not torch.equal(got, want):
            raise AssertionError(f"K1 at the TP shard (M={m}, K={k}, N={n}) "
                                 "differs from its plain version")
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {"m": m, "k": k, "n": n,
               "kernel_ms": _graph_ms(
                   lambda: _kernels.xnor_gemm("xnor", x, wp, k, n)),
               "plain_ms": _graph_ms(
                   lambda: xg.xnor_gemm_plain(pack_bits(x), wp, k)),
               "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
               "max_abs_err": float((got - want).abs().max())}
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            "xnor", m, k, n)
        rows.append(row)
        print(json.dumps({"phase": "14", "k1_tp_shard": row}), flush=True)
    return rows


def mp_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 14, model parallelism (``parallel.mesh``,
    ``model_parallel``, ``pipeline``, ``pipeline_model``,
    ``tp_pipeline``; the trainer's ``tensor_parallel`` and
    ``pipeline_parallel``), gloo ranks sharing the card (NCCL runs one
    rank a card: the four-card runs are ``scripts/torch_mp_timing.py``):

    (a) ``bnn-mlp-large`` at full width on pallas_xnor, dropout 0, SGD
    0.05, global batch 64, 10 steps at tp = 2 and at data 2 x model 2:
    losses within 1e-4 and parameters within 1e-3 of the single-process
    trainer's, every rank's losses equal, the replicated leaves bitwise
    equal on every rank, K1 launched 2 x 10 times in each rank, the wire
    bytes a step equal to ``MP_TP_PLAN`` (PERF.md), and the trained
    model's eval forward up to the head ``torch.equal`` to the unsharded
    model's on the gathered weights (logits: the row-parallel head's
    partial sums reassociate, printed);
    (b) the LM at the --lm-bench width with flash attention pipelined
    over 2 stages of 2 microbatches, random biases: the eval forward
    within 1e-4 of the sequential model's; 5 Adam steps, each one's
    loss within 1e-4 (relative) and gradients within ``LM_GRAD_RTOL``
    (each leaf in relative L2; the key biases printed) of the sequential
    model's step on the same parameters; ``lm_demo.run(pp=2)`` 5 steps
    twice, bitwise equal; K4,
    K5 and K6 each launched (depth / pp) x n_micro x steps = 20 times in
    each rank;
    (c) ``cli train --model bnn-vit-tiny --pp 2 --dist-backend gloo``
    one epoch, converging, in a process of its own;
    (d) ``make_tp_pipeline_fn`` at (data 1, model 2, pipe 2): 10 SGD
    steps, each one's output, loss and gradients against
    ``tp_pipeline_reference`` on the same parameters;
    then K1 at the shards' shapes against its plain version, timed.
    Returns ({kernel: launches on the model-parallel path}, K1's rows)."""
    t0 = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t0, 3)

    k1_rows = _k1_mp_rows(device, gen)     # timed: nothing beside it
    mark("k1")
    # each check waits on processes of its own: (c) beside (a), (d)
    # beside (b)
    cli_vit = _background(lambda: _mp_cli_vit(smi))
    tp = _mp_tp(device, smi)
    mark("a")
    cli_vit()
    mark("c")
    tpp = _background(lambda: _mp_tpp(smi))
    pp = _mp_pp(device, smi)
    mark("b")
    tpp()
    mark("d")
    launches = {name: 0 for name in KERNEL_ROWS}
    launches["xnor"] = tp["k1_launches"]
    launches.update(pp["launches"])
    print(json.dumps({"phase": 14, "launches": launches,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return launches, k1_rows


# -- phase 15: observability -------------------------------------------------


def _obs_summary(path: str) -> dict:
    """The port's summary of a run log; fails unless the log reads."""
    from distributed_mnist_bnns_tpu_torch.obs import read_events, summarize

    events = list(read_events(path))
    if not events or events[0]["kind"] != "run_manifest":
        raise AssertionError(f"{path}: no run manifest first: {events[:1]}")
    return {"events": events, "summary": summarize(path)}


def capture_clock(artifact_dir: str) -> dict:
    """What a capture's Chrome trace says of the card's clock against the
    host's. ``lag_*_us``: a kernel's start less its launch call's start
    (the first kernel of each launch; a few us on an idle card, and never
    below 0 while the two clocks agree). ``orphans``: kernel launch calls
    left without any kernel (a kernel the profiler dropped), each with
    its distance in us from the window's first launch call and to its
    last. ``kernels``: the package's kernels in the trace by counter
    name."""
    from distributed_mnist_bnns_tpu_torch.obs.profile import (
        find_trace_json,
        load_trace_events,
        port_kernel,
    )

    events = [e for e in load_trace_events(find_trace_json(artifact_dir))
              if e.get("ph") == "X"]
    calls, first_kernel, port = {}, {}, {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        cat, name = str(e.get("cat", "")), str(e.get("name", ""))
        if cat in ("cuda_runtime", "cuda_driver") and corr is not None \
                and "Launch" in name:
            calls[corr] = float(e.get("ts", 0.0))
        elif cat == "kernel":
            ts = float(e.get("ts", 0.0))
            if corr is not None:
                first_kernel[corr] = min(ts, first_kernel.get(corr, ts))
            kernel = port_kernel(name)
            if kernel is not None:
                port[kernel] = port.get(kernel, 0) + 1
    lags = sorted(first_kernel[c] - t for c, t in calls.items()
                  if c in first_kernel)
    t_first = min(calls.values(), default=0.0)
    t_last = max(calls.values(), default=0.0)
    return {
        "lag_min_us": lags[0] if lags else None,
        "lag_p50_us": lags[len(lags) // 2] if lags else None,
        "launch_calls": len(calls),
        "orphans": [[round(t - t_first, 1), round(t_last - t, 1)]
                    for c, t in sorted(calls.items(), key=lambda kv: kv[1])
                    if c not in first_kernel],
        "kernels": dict(sorted(port.items())),
    }


def _window_hook(trainer, marks: dict):
    """Take the kernel launches that ran (eager launches, less what
    graph captures recorded, plus what the replays ran) as the trainer's
    profile window starts (``marks["start"]``) and stops
    (``marks["stop"]``), through the process's ``ProfileManager``;
    returns the function that removes the hook."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    prof = trainer._profiler
    start, stop = prof.start, prof.stop

    def ran() -> dict:
        scan = trainer._train_scan
        rec = scan.recorded if scan is not None else {}
        replayed = scan.ran if scan is not None else {}
        return {k: v - rec.get(k, 0) + replayed.get(k, 0)
                for k, v in _kernels.LAUNCHES.items()}

    def hooked_start(artifact_dir):
        start(artifact_dir)
        marks["start"] = ran()

    def hooked_stop(**kw):
        marks["stop"] = ran()
        return stop(**kw)

    prof.start, prof.stop = hooked_start, hooked_stop

    def remove():
        del prof.start, prof.stop

    return remove


def _obs_train(device, data, tmp: str, scan_steps: int, smi: str) -> dict:
    """Phase 15 (a), one run: ``bnn-mlp-large`` on pallas_xnor through
    ``Trainer.fit`` with telemetry, trace and the profile window; the
    run's checks. Returns its numbers and the run's kernel launches."""
    from distributed_mnist_bnns_tpu_torch.obs import (
        get_tracker,
        summarize_capture,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    name = "eager" if scan_steps == 1 else f"scan_steps={scan_steps}"
    td = os.path.join(tmp, name)
    bs = MLP_TRAIN["batch_size"]
    tracker = get_tracker()
    captures0 = tracker.kind_count("capture")
    before = dict(_kernels.LAUNCHES)
    t = _mlp_trainer(device, backend="pallas_xnor", log_interval=10,
                     scan_steps=scan_steps, telemetry_dir=td, trace=True,
                     profile_step_window=OBS_WINDOW)
    marks = {}
    unhook = _window_hook(t, marks)
    t0 = time.perf_counter()
    try:
        t.fit(data)
    finally:
        unhook()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    scan = t._train_scan
    launches = {k: _kernels.LAUNCHES[k] - before[k]
                - (scan.recorded.get(k, 0) if scan else 0)
                + (scan.ran.get(k, 0) if scan else 0) for k in KERNEL_ROWS}
    got = _obs_summary(os.path.join(td, "events.jsonl"))
    events, summary = got["events"], got["summary"]
    steps = [e for e in events if e["kind"] == "step"]
    n_steps = len(data.train_labels) // bs
    dispatches = (n_steps if scan_steps == 1
                  else n_steps // scan_steps + n_steps % scan_steps)
    examples = t.telemetry.registry.counter(
        "train_examples_total").total()
    captures = tracker.kind_count("capture") - captures0
    mfus = [e["mfu"] for e in steps]
    caps = [e for e in events if e["kind"] == "profile_capture"]
    if len(caps) != 1:
        raise AssertionError(f"{name}: {len(caps)} profile captures")
    prof = summarize_capture(caps[0]["dir"])
    clock = capture_clock(caps[0]["dir"])
    k1_window = marks["stop"]["xnor"] - marks["start"]["xnor"]
    k1_in_steps = prof["kernel_launches_in_steps"].get("xnor", 0)
    row = {
        "obs_train": name, "card": smi, "wall_s": wall,
        "step_events": len(steps), "dispatches": dispatches,
        "steps": summary["steps"]["count"],
        "examples_total": examples,
        "summary_examples": summary["steps"]["examples"],
        "captures_counted": captures,
        "train_scan_captures": scan.captures if scan else 0,
        "mfu_mean": summary["steps"]["mfu_mean"],
        "mfu_max": summary["steps"]["mfu_max"],
        "step_latency_s": summary["steps"]["latency_s"],
        "step_latency_ms": [round(e["latency_s"] * 1e3, 3) for e in steps],
        "examples_per_sec_mean": summary["steps"]["examples_per_sec_mean"],
        "analytic_step_flops": t._step_flops,
        "peak_flops": t._peak_flops, "peak_precision": t._peak_precision,
        "event_counts": summary["event_counts"],
        "profile_window": OBS_WINDOW, "k1_launched_in_window": k1_window,
        "k1_in_jg_step_regions": k1_in_steps,
        "profile_kernel_launches": prof["kernel_launches"],
        "profile_annotated_steps": prof["annotated_steps"],
        "process_age_s": time.perf_counter() - T_START,
        "capture_clock": clock,
        "launches": launches,
    }
    print(json.dumps(row), flush=True)
    bad = []
    if len(steps) != dispatches or summary["steps"]["count"] != n_steps:
        bad.append(f"{len(steps)} step events for {dispatches} dispatches "
                   f"({summary['steps']['count']} steps, want {n_steps})")
    if examples != n_steps * bs or summary["steps"]["examples"] != \
            n_steps * bs:
        bad.append(f"examples_total {examples} / {summary['steps']} != "
                   f"{n_steps} x {bs}")
    if captures != row["train_scan_captures"] or (
            scan_steps > 1 and captures != 2):
        bad.append(f"capture counter {captures}, TrainScan "
                   f"{row['train_scan_captures']}")
    if not mfus or not all(0 < m <= 1 for m in mfus) \
            or t._peak_precision != "bf16":
        bad.append(f"MFU outside (0, 1] or not against the card's bf16 "
                   f"peak: {mfus[:4]} {t._peak_precision}")
    if not (k1_window > 0 and k1_in_steps == k1_window):
        bad.append(f"profile window: K1 {k1_in_steps} in jg_step regions, "
                   f"the counters say {k1_window}")
    for kind in ("run_manifest", "epoch", "eval", "span", "metrics",
                 "run_end"):
        if kind not in summary["event_counts"]:
            bad.append(f"no {kind} event")
    if bad:
        raise AssertionError(f"phase 15 (a) {name}: " + "; ".join(bad))
    log(f"(a) {name}: {len(steps)} step events for {dispatches} "
        f"dispatches, {examples:.0f} examples, {captures} captures, MFU "
        f"mean {row['mfu_mean']:.4g}; K1 {k1_in_steps} in jg_step regions "
        f"= {k1_window} launched in the window")
    return row


def _obs_cost(device, smi: str) -> dict:
    """Phase 15 (b): phase 12's captured step (``MLP_TRAIN``, bf16,
    ``scan_steps=8``) timed with telemetry off (the registry only) and
    on (events, trace), off / on / on / off, each a second epoch on the
    host clock after the capture epoch. Printed, nothing gated."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=OBS_COST_SYNTH, seed=0)
        ms = {"off": [], "on": []}
        for i, mode in enumerate(("off", "on", "on", "off")):
            kw = ({} if mode == "off" else
                  dict(telemetry_dir=os.path.join(tmp, f"t{i}"), trace=True))
            t = _mlp_trainer(device, scan_steps=SCAN_STEPS, **kw)
            t.train_epoch(data, 0)
            row = t.train_epoch(data, 1)
            ms[mode].append(row["epoch_time_s"] / row["steps"] * 1e3)
            t.telemetry.close()
    out = {"obs_telemetry_cost": True, "card": smi,
           "steps_per_epoch": OBS_COST_SYNTH[0] // MLP_TRAIN["batch_size"],
           "step_ms_off": ms["off"], "step_ms_on": ms["on"],
           "on_over_off": statistics.mean(ms["on"])
           / statistics.mean(ms["off"])}
    print(json.dumps(out), flush=True)
    log(f"(b) captured step {statistics.mean(ms['off']):.4f} ms off, "
        f"{statistics.mean(ms['on']):.4f} ms on")
    return out


def _prom(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"/metrics has no {series}")


def _obs_mlp_server(device, gen, tmp: str, smi: str) -> dict:
    """Phase 15 (c): the frozen ``bnn-mlp-large`` served with telemetry
    and trace: N requests, /metrics as Prometheus text counting N, N
    request events each with its span tree, a /admin/profile capture
    under traffic showing K2 and K3, a /admin/reload answering bitwise
    alike. Returns the path's launches."""
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.obs import (
        load_spans,
        summarize_capture,
    )
    from distributed_mnist_bnns_tpu_torch.obs.trace import children_index
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client

    model = get_model("bnn-mlp-large", generator=gen)
    _random_bn_stats(model, gen)
    path = os.path.join(tmp, "mlp.msgpack")
    export_packed(model.eval(), path)
    td = os.path.join(tmp, "serve")
    imgs = (torch.randint(0, 256, (MAIN_M, 28, 28, 1), generator=gen)
            / 256.0).numpy()
    before = dict(_kernels.LAUNCHES)
    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device=str(device), port=0, batch_size=MAIN_M,
        default_deadline_ms=30000.0, stall_timeout_s=30.0,
        telemetry_dir=td, trace=True))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    stop = threading.Event()
    extra = [0]

    def traffic():
        while not stop.is_set():
            if client.predict(base, imgs[:8].tolist())[0] == 200:
                extra[0] += 1

    try:
        answers = []
        for i in range(OBS_REQUESTS):
            code, body = client.predict(base, imgs[:1 + 4 * i].tolist(),
                                        trace=True)
            if code != 200:
                raise AssertionError(f"/predict: {code} {body[:200]!r}")
            answers.append(body)
        code, text = client.metrics(base, prometheus=True)
        n_ok = _prom(text.decode(), 'serve_requests_total{status="ok"}')
        th = threading.Thread(target=traffic)
        th.start()
        time.sleep(0.2)
        code_p, body_p = client.profile(base, OBS_PROFILE_MS)
        stop.set()
        th.join(60)
        code_r, _ = client.reload_artifact(base)
        again = client.predict(base, imgs[:1].tolist())[1]
    finally:
        stop.set()
        srv.request_stop("smoke over")
        srv.drain_and_stop()
    launches = {k: _kernels.LAUNCHES[k] - before[k] for k in KERNEL_ROWS}
    got = _obs_summary(os.path.join(td, "events.jsonl"))
    events = got["events"]
    reqs = [e for e in events if e["kind"] == "request"]
    spans = load_spans(os.path.join(td, "events.jsonl"))
    kids = children_index(spans)
    roots = [s for s in spans if s["span_kind"] == "request"]
    trees = sum({"queue", "assemble", "infer", "respond"} <= {
        k["span_kind"] for k in kids.get((r["trace"], r["span"]), [])}
        for r in roots)
    prof = (summarize_capture(json.loads(body_p)["dir"])
            if code_p == 200 else {})
    total = OBS_REQUESTS + extra[0] + 1
    row = {"obs_serve": "bnn-mlp-large", "card": smi,
           "requests_before_profile": OBS_REQUESTS,
           "metrics_ok_count": n_ok, "request_events": len(reqs),
           "requests_total": total, "span_trees": trees,
           "profile_status": code_p,
           "profile_kernel_launches": prof.get("kernel_launches"),
           "reload_status": code_r, "reload_same_answer":
               again == answers[0], "launches": launches,
           "event_counts": got["summary"]["event_counts"]}
    print(json.dumps(row), flush=True)
    k = prof.get("kernel_launches") or {}
    if not (n_ok == OBS_REQUESTS and len(reqs) == total
            and trees == total and code_p == 200
            and k.get("xnor_sign", 0) > 0 and k.get("xnor_affine", 0) > 0
            and code_r == 200 and row["reload_same_answer"]
            and "reload" in row["event_counts"]):
        raise AssertionError(f"phase 15 (c): {row}")
    log(f"(c) server: /metrics counted {n_ok:.0f} requests, {len(reqs)} "
        f"request events with their span trees, profile K2 x"
        f"{k['xnor_sign']} K3 x{k['xnor_affine']}, reload bitwise")
    return row


def _obs_lm_server(device, gen, tmp: str, smi: str) -> dict:
    """Phase 15 (d): the LM (``LM_WIDTH``) served with telemetry: six
    streams during a /admin/profile capture, which must show K7 (the
    prefill chunks) and K8; /metrics; ``lm_decode`` events. Returns the
    path's launches."""
    from distributed_mnist_bnns_tpu_torch.infer import export_packed
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM
    from distributed_mnist_bnns_tpu_torch.obs import summarize_capture
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    model = BinarizedLM(**LM_WIDTH, generator=gen).eval()
    _random_lm_params(model, gen)
    path = os.path.join(tmp, "lm.msgpack")
    export_packed(model, path)
    td = os.path.join(tmp, "lm")
    prompts = [torch.randint(0, LM_WIDTH["vocab"], (n,),
                             generator=gen).tolist() for n in LM_PROMPTS]
    before = dict(_kernels.LAUNCHES)
    srv = LMServer(LMServeConfig(
        artifact=path, device=str(device), port=0, slots=LM_SLOTS,
        page_size=LM_PAGE, prefill_chunk=LM_CHUNK, telemetry_dir=td,
        trace=True))
    host, port = srv.start()
    srv.engine.decode_event_every = OBS_LM_DECODE_EVERY
    base = f"http://{host}:{port}"
    codes = [None] * len(prompts)

    def ask(i):
        code, events = lc.generate(base, prompts[i],
                                   max_new_tokens=LM_NEW_TOKENS,
                                   deadline_ms=120000.0, trace=True)
        codes[i] = (code, events[-1])

    prof_reply = {}

    def profile():
        prof_reply["r"] = lc.profile(base, OBS_LM_PROFILE_MS)

    try:
        pt = threading.Thread(target=profile)
        pt.start()
        time.sleep(0.3)
        threads = [threading.Thread(target=ask, args=(i,))
                   for i in range(len(prompts))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        pt.join(120)
        code_m, body_m = lc.metrics(base)
        snap = json.loads(body_m)
    finally:
        srv.request_stop("smoke over")
        srv.drain_and_stop()
    launches = {k: _kernels.LAUNCHES[k] - before[k] for k in KERNEL_ROWS}
    got = _obs_summary(os.path.join(td, "events.jsonl"))
    counts = got["summary"]["event_counts"]
    code_p, body_p = prof_reply.get("r", (None, b"{}"))
    prof = (summarize_capture(json.loads(body_p)["dir"])
            if code_p == 200 else {})
    k = prof.get("kernel_launches") or {}
    ok = [c for c, last in codes if c == 200 and last.get("status") == "ok"]
    req_ok = [s["value"] for s in snap["lm_requests_total"]["series"]
              if s["labels"] == {"status": "ok"}]
    row = {"obs_serve": "bnn-lm", "card": smi, "streams_ok": len(ok),
           "metrics_status": code_m, "lm_requests_ok": req_ok,
           "event_counts": counts, "profile_status": code_p,
           "profile_kernel_launches": k, "launches": launches}
    print(json.dumps(row), flush=True)
    if not (len(ok) == len(prompts) and req_ok == [len(prompts)]
            and counts.get("lm_decode", 0) >= 1
            and counts.get("lm_admit") == counts.get("lm_evict")
            == len(prompts) and code_p == 200
            and k.get("xnor_unpack", 0) > 0 and k.get("paged_attn", 0) > 0):
        raise AssertionError(f"phase 15 (d): {row}")
    log(f"(d) LM server: {len(ok)} streams, {counts['lm_decode']} lm_decode "
        f"events, profile K7 x{k['xnor_unpack']} K8 x{k['paged_attn']}")
    return row


def obs_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 15, observability (``obs/``, the trainer's and the servers'
    telemetry): (a) ``bnn-mlp-large`` on pallas_xnor, batch 64, one
    epoch of ``OBS_SYNTH`` through ``Trainer.fit`` with ``telemetry_dir``,
    ``trace`` and ``profile_step_window``, eager and at ``scan_steps=8``:
    the logs read back through ``read_events`` and ``summarize``, one
    ``step`` event a dispatch, ``train_examples_total`` = steps x batch,
    the build counter's ``kind=capture`` = ``TrainScan.captures``, every
    step's MFU in (0, 1] against the card's bf16 peak, the window's
    capture holding as many K1 kernels inside ``jg_step`` regions as the
    counters launched there (recorded x replays in the graphs); (b)
    phase 12's captured step timed with telemetry off and on; (c) the
    frozen MLP served with telemetry (``_obs_mlp_server``); (d) the LM
    served with telemetry (``_obs_lm_server``). The launch counters are
    zeroed just before and read just after. Returns ({kernel: launches
    on the observability path}, the rows)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    marks = {}
    _kernels.reset_launches()
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = load_mnist(os.path.join(tmp, "no-idx-files"),
                          synthetic_sizes=OBS_SYNTH, seed=0)
        train = [_obs_train(device, data, tmp, s, smi)
                 for s in (1, SCAN_STEPS)]
        marks["a"] = round(time.perf_counter() - t0, 3)
        rows["cost"] = _obs_cost(device, smi)
        marks["b"] = round(time.perf_counter() - t0, 3)
        serve = _obs_mlp_server(device, gen, tmp, smi)
        marks["c"] = round(time.perf_counter() - t0, 3)
        lm = _obs_lm_server(device, gen, tmp, smi)
        marks["d"] = round(time.perf_counter() - t0, 3)
    launches = {k: sum(r["launches"][k] for r in (*train, serve, lm))
                for k in KERNEL_ROWS}
    rows["train"], rows["serve"], rows["lm"] = train, serve, lm
    for name in ("xnor", "xnor_sign", "xnor_affine", "xnor_unpack",
                 "paged_attn"):
        if launches[name] == 0:
            raise AssertionError(f"the observability path never launched "
                                 f"{name}")
    print(json.dumps({"phase": 15, "launches": launches,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return launches, rows


# -- phase 16: model parallelism finished ------------------------------------

# (a) the row-parallel XNOR-Net alpha at bnn-vit-tiny's second MLP dense
# (hidden 256 -> 128) over batch 32 x 16 tokens, tp = 2
MP2_ALPHA = (512, 256, 128)      # (M, K, N)
MP2_ALPHA_RTOL = 1e-6            # alpha's fp32 sum runs in another order
# (b) bnn-vit-tiny at full width (embed 128, depth 2, 4 heads, 16 tokens),
# pallas_xnor, flash attention, scale=True, dropout 0, Adam 1e-3,
# batch 32, tp = 2: each step's loss within MP_TPP_LOSS_RTOL (relative)
# and every gradient within LM_GRAD_RTOL (relative L2) of the unsharded
# model's step on the same parameters
MP2_VIT = dict(model="bnn-vit-tiny", batch_size=32, optimizer="adam",
               learning_rate=1e-3, seed=0, backend="pallas_xnor",
               model_kwargs={"attention": "flash", "scale": True,
                             "dropout": 0.0})
MP2_VIT_STEPS = 3
# (c) the captured TP and PP steps at one NCCL rank per axis: 2 replays
# of an 8-step graph against 16 eager steps, bitwise
MP2_SCAN, MP2_SCAN_CHUNKS = 8, 2


def _mp2_rank(rank: int, world: int, device, xs, ys) -> dict:
    """Phase 16 (a) and (b) in one of 2 gloo ranks sharing the card."""
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.models.layers import BinarizedDense
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops.binarize import binarize_ste
    from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import binary_matmul
    from distributed_mnist_bnns_tpu_torch.parallel import make_mesh
    from distributed_mnist_bnns_tpu_torch.parallel.model_parallel import (
        RowBinarizedDense,
        TpContext,
        reduce_from_model,
    )
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
    from distributed_mnist_bnns_tpu_torch.train.trainer import (
        clamp_latent,
        forward_backward,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    # (a) the row-parallel alpha forward
    m, k, n = MP2_ALPHA
    gen = torch.Generator().manual_seed(16)
    full = BinarizedDense(k, n, scale=True, backend="pallas_xnor",
                          generator=gen).to(device)
    with torch.no_grad():   # a bias of either sign: no exact ties
        full.bias.copy_(0.2 * torch.randn(
            n, generator=torch.Generator().manual_seed(17)))
    x = torch.randn(m, k, generator=torch.Generator().manual_seed(18)
                    ).to(device)
    ctx = TpContext(make_mesh(data=1, model=world).group("model"))
    row = RowBinarizedDense(full, ctx)
    lo = ctx.rank * row.in_features
    x_loc = x[:, lo:lo + row.in_features]
    with torch.no_grad():
        _kernels.reset_launches()
        y = row(x_loc)
        k1 = _kernels.LAUNCHES["xnor"]
        raw = reduce_from_model(binary_matmul(
            binarize_ste(x_loc), binarize_ste(row.weight), "pallas_xnor"),
            ctx.group)
        alpha = reduce_from_model(row.weight.abs().sum(dim=1),
                                  ctx.group) / k
        raw_full = binary_matmul(binarize_ste(x), binarize_ste(full.weight),
                                 "pallas_xnor")
        alpha_full = full.weight.abs().mean(dim=1)
        y_full = full(x)
        scale_y = (raw_full * alpha_full).abs() + full.bias.abs()
    out["alpha"] = {
        "k1": k1, "raw_equal": bool(torch.equal(raw, raw_full)),
        "alpha_rel": float(((alpha - alpha_full).abs()
                            / alpha_full.abs()).max()),
        "y_rel": float(((y - y_full).abs() / scale_y).max()),
    }
    # (b) the ViT at tp = 2 against the unsharded step, step by step
    t = Trainer(TrainConfig(device=str(device), tensor_parallel=world,
                            log_interval=1, **MP2_VIT))
    ref = get_model("bnn-vit-tiny", backend="pallas_xnor",
                    **MP2_VIT["model_kwargs"]).to(device)
    refs = dict(ref.named_parameters())
    latents = list(t.clamp_mask.values())
    steps = []
    for xb, yb in zip(xs, ys):
        xb = torch.from_numpy(xb).to(device)
        yb = torch.from_numpy(yb.astype(np.int64)).to(device)
        with torch.no_grad():
            for name, p in t.model.named_parameters():
                refs[name].copy_(t.tp.gather_leaf(p, p))
        ref.zero_grad(set_to_none=True)
        ref_loss, _ = forward_backward(ref, xb, yb, loss_fn=t._loss_fn)
        t.model.train()
        t.optimizer.zero_grad(set_to_none=True)
        _kernels.reset_launches()
        loss, _ = forward_backward(t.model, xb, yb, loss_fn=t._loss_fn)
        t.optimizer.step()
        clamp_latent(latents)
        launches = dict(_kernels.LAUNCHES)
        rel = {}
        for name, p in t.model.named_parameters():
            g = t.tp.gather_leaf(p, p.grad)
            want = refs[name].grad
            rel[name] = float(torch.linalg.vector_norm(g - want)
                              / max(float(torch.linalg.vector_norm(want)),
                                    1e-30))
        steps.append({"loss": float(loss), "ref_loss": float(ref_loss),
                      "rel": rel, "launches": launches})
    out["vit"] = steps
    out["vit_shapes"] = {k: tuple(v.shape)
                         for k, v in t.model.named_parameters()}
    dist.barrier()
    return out


def _mp2_captured(device) -> dict:
    """Phase 16 (c): one NCCL rank in this process; the TP step over a
    (data 1 x model 1) mesh and the pipelined step over (data 1 x pipe
    1), each captured as an 8-step graph (``TrainScan``) and replayed
    against the same steps run eagerly from the same seed: bitwise, the
    graph's recorded launches run once a replay."""
    import tempfile

    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.models import (
        get_model,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import WireBytes
    from distributed_mnist_bnns_tpu_torch.ops.losses import (
        cross_entropy_loss,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import (
        Mesh,
        PipelinedModel,
        TpShards,
        init_world,
        make_mesh,
        make_pp_train_step,
        make_tp_train_step,
    )
    from distributed_mnist_bnns_tpu_torch.train.capture import pinned
    from distributed_mnist_bnns_tpu_torch.train.optim import make_optimizer
    from distributed_mnist_bnns_tpu_torch.train.trainer import (
        make_train_scan,
    )

    def tp_run():
        model = get_model("bnn-mlp-large", backend="pallas_xnor",
                          dropout_rate=0.0,
                          generator=torch.Generator().manual_seed(0)
                          ).to(device)
        wire = WireBytes()
        shards = TpShards(model, "bnn-mlp-large",
                          make_mesh(data=1, model=1), wire=wire)
        mask = latent_clamp_mask(model)
        opt = make_optimizer("sgd", list(model.parameters()), 0.05,
                             tp=shards)
        return model, opt, make_tp_train_step(mask, model, shards,
                                              wire=wire), mask, wire

    def pp_run():
        model = get_model("bnn-vit-tiny", backend="pallas_xnor",
                          attention="flash", dropout=0.0,
                          generator=torch.Generator().manual_seed(0),
                          ).to(device)
        wire = WireBytes()
        mesh = Mesh((1, 1), ("data", "pipe"))
        pm = PipelinedModel(model, mesh, n_micro=2, wire=wire)
        mask = latent_clamp_mask(pm)
        opt = make_optimizer("adam", list(pm.parameters()), 1e-3)
        return pm, opt, make_pp_train_step(
            mask, pm, mesh.group("data"), loss_fn=cross_entropy_loss,
            wire=wire), mask, wire

    rng = np.random.RandomState(16)
    n = MP2_SCAN * MP2_SCAN_CHUNKS
    xs = rng.randn(n, 32, 28, 28, 1).astype(np.float32)
    ys = rng.randint(0, 10, (n, 32)).astype(np.int64)
    out = {}
    tmp = tempfile.mkdtemp(prefix="mp2_pg_")
    init_world(0, 1, backend="nccl", init_file=os.path.join(tmp, "pg"))
    try:
        for name, build in (("tp", tp_run), ("pp", pp_run)):
            model, opt, step, mask, wire = build()
            for x, y in zip(xs, ys):
                step(model, opt, torch.from_numpy(x).to(device),
                     torch.from_numpy(y).to(device))
            eager = {k: v.detach().clone()
                     for k, v in model.state_dict().items()}
            model, opt, step, mask, wire = build()
            scan = make_train_scan(mask, step=step, wire=wire,
                                   groups=(dist.group.WORLD,))
            for c in range(MP2_SCAN_CHUNKS):
                sl = slice(c * MP2_SCAN, (c + 1) * MP2_SCAN)
                scan(model, opt, pinned(xs[sl], np.float32, device),
                     pinned(ys[sl], np.int64, device))
            torch.cuda.synchronize(device)
            got = model.state_dict()
            equal = all(torch.equal(got[k], eager[k]) for k in eager)
            out[name] = {"bitwise": equal,
                         "recorded": dict(scan.recorded),
                         "ran": dict(scan.ran),
                         "replays": scan.stats()["replays"]}
            if not equal:
                bad = [k for k in eager if not torch.equal(got[k], eager[k])]
                raise AssertionError(f"phase 16 (c) {name}: the captured "
                                     f"steps differ from the eager ones in "
                                     f"{bad[:4]}")
            for kname, v in scan.recorded.items():
                if scan.ran.get(kname) != v * MP2_SCAN_CHUNKS:
                    raise AssertionError(
                        f"phase 16 (c) {name}: {kname} recorded {v} a graph "
                        f"but ran {scan.ran.get(kname)} in "
                        f"{MP2_SCAN_CHUNKS} replays")
    finally:
        dist.destroy_process_group()
    return out


def mp2_phase(device: torch.device, smi: str):
    """Phase 16, model parallelism finished:

    (a) a row-parallel ``BinarizedDense(scale=True)`` (the XNOR-Net
    alpha summed over the model group) at bnn-vit-tiny's second MLP
    dense, tp = 2 on gloo ranks sharing the card: the all-reduced +-1
    partial sums ``torch.equal`` to the unsharded GEMM's, alpha and the
    output within ``MP2_ALPHA_RTOL`` of the unsharded layer, K1 counted;
    (b) bnn-vit-tiny at tp = 2 (heads 2 a rank), pallas_xnor, flash
    attention, scale=True: 3 steps, each one's loss and every gradient
    (gathered) against the unsharded model's step on the same parameters
    (``MP_TPP_LOSS_RTOL``, ``LM_GRAD_RTOL``), every rank's losses equal,
    K1 and K4-K6 launched in every step;
    (c) the TP step and the pipelined step captured (``TrainScan``) at
    one NCCL rank per axis: 2 replays of 8 steps bitwise 16 eager steps,
    the graphs' launches counted once a replay (the 4-card captures are
    ``scripts/torch_mp_timing.py --scan-steps 8``).
    Returns {kernel: launches on this path}."""
    from distributed_mnist_bnns_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    rng = np.random.RandomState(160)
    xs = rng.rand(MP2_VIT_STEPS, MP2_VIT["batch_size"], 28, 28, 1).astype(
        np.float32)
    ys = rng.randint(0, 10, (MP2_VIT_STEPS, MP2_VIT["batch_size"]))
    ranks = spawn(_mp2_rank, 2, backend="gloo", device="cuda",
                  args=(xs, ys))
    launches = {name: 0 for name in KERNEL_ROWS}
    for r in ranks:
        a = r["alpha"]
        print(json.dumps({"phase": 16, "alpha": a}), flush=True)
        if not a["raw_equal"]:
            raise AssertionError("phase 16 (a): the all-reduced +-1 partial "
                                 "sums differ from the unsharded GEMM's")
        if a["alpha_rel"] > MP2_ALPHA_RTOL or a["y_rel"] > MP2_ALPHA_RTOL:
            raise AssertionError(f"phase 16 (a): alpha {a['alpha_rel']} / "
                                 f"output {a['y_rel']} past "
                                 f"{MP2_ALPHA_RTOL} of the unsharded layer")
        if a["k1"] == 0:
            raise AssertionError("phase 16 (a): K1 never launched")
        launches["xnor"] += a["k1"]
        for i, s in enumerate(r["vit"]):
            loss_rel = abs(s["loss"] - s["ref_loss"]) / abs(s["ref_loss"])
            # the key biases' gradients are 0 in exact arithmetic (softmax
            # is shift-invariant): rounding noise, printed only
            worst = max(((k, v) for k, v in s["rel"].items()
                         if not k.endswith("attn.k.bias")),
                        key=lambda kv: kv[1])
            print(json.dumps({"phase": 16, "vit_step": i, "loss": s["loss"],
                              "loss_rel": loss_rel, "worst_grad": worst,
                              "key_bias": {k: v for k, v in s["rel"].items()
                                           if k.endswith("attn.k.bias")},
                              "launches": {k: v for k, v in
                                           s["launches"].items() if v}}),
                  flush=True)
            if loss_rel > MP_TPP_LOSS_RTOL or worst[1] > LM_GRAD_RTOL:
                raise AssertionError(f"phase 16 (b) step {i}: loss {loss_rel}"
                                     f", gradient {worst} past the bounds")
            for name in ("xnor", *FLASH):
                if s["launches"].get(name, 0) == 0:
                    raise AssertionError(f"phase 16 (b): {name} never "
                                         "launched in a TP step")
                launches[name] += s["launches"][name]
        if [s["loss"] for s in r["vit"]] != [s["loss"]
                                             for s in ranks[0]["vit"]]:
            raise AssertionError("phase 16 (b): the ranks' losses differ")
    if ranks[0]["vit_shapes"]["blocks.0.attn.q.weight"] != (64, 128):
        raise AssertionError("phase 16 (b): q is not column-sharded")
    mark_ab = time.perf_counter() - t0
    cap = _mp2_captured(device)
    for name, c in cap.items():
        print(json.dumps({"phase": 16, "captured": name, **c}), flush=True)
        for k, v in c["ran"].items():
            launches[k] += v
    if not cap["tp"]["ran"].get("xnor"):
        raise AssertionError("phase 16 (c): the captured TP step ran no K1")
    if not all(cap["pp"]["ran"].get(k) for k in ("xnor", *FLASH)):
        raise AssertionError("phase 16 (c): the captured pipelined step ran "
                             "no K1 or flash kernel")
    print(json.dumps({"phase": 16, "launches": launches,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after_ab": mark_ab}), flush=True)
    return launches


# -- phase 17: the fault-tolerant runtime ------------------------------------

# bnn-mlp-large on pallas_xnor, batch 64, dropout on; (a) Adam 0.01
# (MLP_TRAIN); (b) SGD 0.05 (MP_TRAIN's: no moments in the checkpoints
# the ranks write and read)
RS_TRAIN = dict(MLP_TRAIN, backend="pallas_xnor")
RS_SGD = dict(optimizer="sgd", learning_rate=0.05)
# (a) 3 epochs of 10 steps: a transient fault at step 3 (the run
# restarts), a preemption at step 13 whose checkpoint is corrupted (the
# resume rolls back to the epoch-0 generation)
RS_CHAOS = "step_fault@step=3;preempt@step=13;ckpt_corrupt@step=13"
RS_CHAOS_SYNTH = (640, 128)
# (b) elastic DP, 2 gloo ranks sharing the card, sign_ef, one epoch of 8
RS_ELASTIC = "worker_lost@step=2,world=1;worker_restore@step=5"
RS_ELASTIC_SYNTH = (512, 128)
# (c) 2 host processes on the card over loopback, 3 epochs of 4 steps
RS_HOSTS = "host_lost@step=2,hosts=1;host_restore@step=6"
RS_HOSTS_SYNTH = ("256", "64")
# (d) serving: 3 injected errors trip the breaker (threshold 3); the LM
# engine retries 2 failed decode iterations
RS_SERVE_CHAOS = "infer_error@step=0,times=3"
RS_LM_CHAOS = "infer_error@step=2,times=2"
RS_BREAKER_RESET_S = 0.5


def _rs_data(sizes):
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    return load_mnist("/nonexistent-mnist-dir", synthetic_sizes=sizes,
                      seed=0)


def _rs_config(**kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig

    cfg = dict(RS_TRAIN, device="cuda", log_interval=1,
               handle_preemption=False)
    cfg.update(kw)
    return TrainConfig(**cfg)


def _rs_elastic_trainer(kw, world):
    """``run_elastic``'s factory (phase 17 (b)) in a rank."""
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.train import Trainer

    if world is None:
        return Trainer(_rs_config(data_parallel=dist.get_world_size(), **kw))
    return Trainer(_rs_config(data_parallel=world, resume=True, **kw))


def _rs_fit(trainer):
    trainer.fit(_rs_data(RS_ELASTIC_SYNTH), eval_every=0)
    return {"step": trainer.step, "world": trainer.world}


def _rs_resume_rank(rank: int, world: int, device, kw) -> dict:
    """A fresh trainer of ``world`` ranks resuming ``kw``'s checkpoint
    directory, fitted to the end (or to a chaos stop)."""
    from distributed_mnist_bnns_tpu_torch.resilience import Preempted
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    t = Trainer(_rs_config(data_parallel=world, resume=True, **kw))
    try:
        t.fit(_rs_data(RS_ELASTIC_SYNTH), eval_every=0)
    except Preempted:
        pass
    return {"step": t.step}


def _ckpt_leaves(path: str) -> dict:
    from distributed_mnist_bnns_tpu_torch.utils import msgpack

    with open(path, "rb") as f:
        tree = msgpack.from_bytes(f.read())
    out = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{p}/{k}")
        else:
            out[p] = np.asarray(t)

    walk(tree, "")
    return out


def _same_tree(what: str, got: dict, want: dict) -> None:
    bad = [k for k in want if k not in got
           or not np.array_equal(got[k], want[k])]
    if bad or got.keys() != want.keys():
        raise AssertionError(f"{what}: differs in {bad[:4]}")


def _generation_dir(src: str, record: dict, dst: str) -> None:
    """``dst`` holding only the generation ``record`` of ``src`` as its
    latest checkpoint (a fresh resume from that generation)."""
    import shutil

    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import LATEST

    os.makedirs(dst)
    shutil.copyfile(os.path.join(src, record["file"]),
                    os.path.join(dst, LATEST))
    shutil.copyfile(os.path.join(src, record["file"]),
                    os.path.join(dst, record["file"]))
    meta = {k: v for k, v in record.items() if k != "file"}
    meta["generations"] = [record]
    with open(os.path.join(dst, "checkpoint_meta.json"), "w") as f:
        json.dump(meta, f)


def _rs_chaos(tmp: str) -> dict:
    """(a): one ``Trainer.fit`` under ``run_with_policy`` with
    ``RS_CHAOS`` against the uninterrupted run: bitwise; the
    ``fault_injected`` events are the fires."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.resilience import (
        RetryPolicy,
        reset_fire_counts,
        run_with_policy,
    )
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    data = _rs_data(RS_CHAOS_SYNTH)
    plain = Trainer(_rs_config(epochs=3, checkpoint_dir=os.path.join(
        tmp, "plain")))
    plain.fit(data, eval_every=0)
    reset_fire_counts()
    tel = os.path.join(tmp, "chaos_tel")
    made = []

    def make():
        made.append(Trainer(_rs_config(
            epochs=3, resume=True, chaos=RS_CHAOS, telemetry_dir=tel,
            checkpoint_dir=os.path.join(tmp, "chaos"))))
        return made[-1]

    _kernels.reset_launches()
    run_with_policy(make, lambda t: t.fit(data, eval_every=0),
                    policy=RetryPolicy(base_backoff_s=0.0),
                    sleep=lambda s: None)
    launches = dict(_kernels.LAUNCHES)
    last = made[-1]
    want = plain.model.state_dict()
    got = last.model.state_dict()
    if last.step != plain.step or not all(torch.equal(got[k], want[k])
                                          for k in want):
        raise AssertionError("phase 17 (a): the recovered run is not the "
                             "uninterrupted one")
    events = [json.loads(line)
              for line in open(os.path.join(tel, "events.jsonl"))]
    fires = [(e["fault"], e["step"]) for e in events
             if e["kind"] == "fault_injected"]
    if fires != [("step_fault", 3), ("preempt", 13), ("ckpt_corrupt", 13)]:
        raise AssertionError(f"phase 17 (a): fault_injected records {fires}")
    rollbacks = [e["outcome"] for e in events if e["kind"] == "rollback"]
    if rollbacks != ["generation"]:
        raise AssertionError(f"phase 17 (a): rollbacks {rollbacks}")
    return {"trainers": len(made), "fires": fires, "steps": last.step,
            "launches": launches}


def _rs_elastic(tmp: str) -> dict:
    """(b), its processes: elastic DP 2 -> 1 -> 2 on gloo ranks sharing
    the card, and the final world-2 state bitwise a fresh resume of the
    generation it resumed from. It starts no process group, capture or
    launch in this process, so it may run in a thread beside other
    phases; ``_rs_elastic_world1`` checks the world-1 generation after
    it, in the main thread."""
    import functools

    from distributed_mnist_bnns_tpu_torch.obs import Telemetry
    from distributed_mnist_bnns_tpu_torch.resilience import (
        RetryPolicy,
        run_elastic,
    )

    kw = _rs_elastic_kw(tmp)
    tel = Telemetry(os.path.join(tmp, "elastic_tel"), heartbeat=False)
    out = run_elastic(functools.partial(_rs_elastic_trainer, kw), _rs_fit,
                      world=2, backend="gloo", device="cuda",
                      policy=RetryPolicy(max_restarts=0, max_preemptions=0),
                      telemetry=tel)
    tel.close()
    events = [json.loads(line) for line in open(
        os.path.join(tmp, "elastic_tel", "events.jsonl"))]
    remesh = [(e["direction"], e["world_from"], e["world_to"])
              for e in events if e["kind"] == "remesh"]
    if out != {"step": 8, "world": 2} or remesh != [("shrink", 2, 1),
                                                    ("grow", 1, 2)]:
        raise AssertionError(f"phase 17 (b): {out}, remesh {remesh}")
    # generation 0: world 2 stopped at step 2; 1: world 1 at step 5;
    # 2: world 2 at the epoch's end
    _rs_elastic_resume(tmp, 2, 1, None)
    return {"remesh": remesh, "steps": out["step"]}


def _rs_elastic_kw(tmp: str) -> dict:
    return {"checkpoint_dir": os.path.join(tmp, "elastic"),
            "chaos": RS_ELASTIC, "elastic": True, "grad_compress": "sign_ef",
            "epochs": 1, **RS_SGD}


def _rs_elastic_resume(tmp: str, world: int, gen: int, stop) -> None:
    """Generation ``gen + 1`` of (b)'s run bitwise a fresh resume at
    ``world`` from generation ``gen``, stopped by the chaos ``stop``;
    world 1 runs in this process (a world-1 gloo group, the spawned
    generation's trainer without a process start)."""
    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.parallel import init_world, spawn
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import (
        LATEST,
        read_meta,
    )

    kw = _rs_elastic_kw(tmp)
    ck = kw.pop("checkpoint_dir")
    gens = {g["generation"]: g for g in read_meta(ck)["generations"]}
    ref = os.path.join(tmp, f"elastic_ref{gen}")
    _generation_dir(ck, gens[gen], ref)
    args = (dict(kw, checkpoint_dir=ref, chaos=stop),)
    if world == 1:
        init_world(0, 1, backend="gloo",
                   init_file=os.path.join(tmp, "world1"))
        try:
            _rs_resume_rank(0, 1, torch.device("cuda", 0), *args)
        finally:
            dist.destroy_process_group()
    else:
        spawn(_rs_resume_rank, world, backend="gloo", device="cuda",
              args=args)
    _same_tree(f"phase 17 (b) world {world} from generation {gen}",
               _ckpt_leaves(os.path.join(ck, gens[gen + 1]["file"])),
               _ckpt_leaves(os.path.join(ref, LATEST)))


def _rs_elastic_world1(tmp: str) -> None:
    """(b)'s world-1 generation bitwise a fresh world-1 resume from
    generation 0; in the main thread, after ``_rs_elastic`` has joined,
    since it holds a process group and launches K1 in this process."""
    _rs_elastic_resume(tmp, 1, 0, "preempt@step=5")


def _rs_multihost(tmp: str) -> dict:
    """(c): 2 host processes on the card (each ``cli train`` with the
    ``JG_MH_*`` environment, on ``cuda:0``, over a loopback
    ``HostChannel``) through ``host_lost`` and ``host_restore``; the final
    state bitwise 2 hosts freshly resumed from the generation the regrown
    world resumed from; ``membership.json`` records both transitions."""
    from distributed_mnist_bnns_tpu_torch.resilience import (
        read_membership,
        run_elastic_multihost,
    )
    from distributed_mnist_bnns_tpu_torch.utils.checkpoint import (
        LATEST,
        read_meta,
    )

    def cmd(ck, chaos=None):
        argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
                "train", "--model", "bnn-mlp-large", "--backend",
                "pallas_xnor", "--epochs", "3", "--batch-size", "64",
                "--optimizer", RS_SGD["optimizer"],
                "--lr", str(RS_SGD["learning_rate"]), "--seed", "0",
                "--synthetic-sizes",
                *RS_HOSTS_SYNTH, "--data-dir", "/nonexistent-mnist-dir",
                "--grad-compress", "sign_ef", "--elastic", "--resume",
                "--no-preemption",
                "--checkpoint-dir", ck]
        return argv + (["--chaos", chaos] if chaos else [])

    env = {"PYTHONPATH": os.path.dirname(os.path.abspath(__file__))}
    store = os.path.join(tmp, "hosts")
    ck = os.path.join(store, "ck")
    rc = run_elastic_multihost(cmd(ck, RS_HOSTS), hosts=2, store=store,
                               env=env, generation_timeout_s=240)
    view = read_membership(store)
    history = [(h["event"], h.get("hosts_from"), h.get("hosts_to"))
               for h in view["history"]]
    if rc != 0 or history != [("lost", 2, 1), ("restored", 1, 2),
                              ("complete", None, None)]:
        raise AssertionError(f"phase 17 (c): rc {rc}, membership {history}")
    gens = read_meta(ck)["generations"]    # newest first
    ref_store = os.path.join(tmp, "hosts_ref")
    ref = os.path.join(ref_store, "ck")
    os.makedirs(ref_store)
    _generation_dir(ck, gens[1], ref)
    if run_elastic_multihost(cmd(ref), hosts=2, store=ref_store, env=env,
                             generation_timeout_s=240) != 0:
        raise AssertionError("phase 17 (c): the fresh 2-host resume failed")
    _same_tree("phase 17 (c) the regrown world",
               _ckpt_leaves(os.path.join(ck, LATEST)),
               _ckpt_leaves(os.path.join(ref, LATEST)))
    return {"membership": history, "generations": view["generation"]}


def _rs_serve(device, gen, tmp: str) -> dict:
    """(d): the classifier server's breaker trips on 3 injected errors and
    closes on the probe after its reset; the LM server retries 2 failed
    decode iterations and its stream equals the decoder driven alone."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
    )
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM, get_model
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    model = get_model("bnn-mlp-large", generator=gen)
    _random_bn_stats(model, gen)
    path = os.path.join(tmp, "mlp.msgpack")
    export_packed(model.eval(), path)
    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device=str(device), port=0, batch_size=MAIN_M,
        breaker_threshold=3, breaker_reset_s=RS_BREAKER_RESET_S,
        stall_timeout_s=30.0, chaos=RS_SERVE_CHAOS))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    imgs = torch.rand(4, 28, 28, 1, generator=gen).numpy().tolist()
    codes = []
    try:
        _kernels.reset_launches()
        codes += [client.predict(base, imgs)[0] for _ in range(3)]
        opened = json.loads(client.healthz(base)[1])["breaker"]
        codes.append(client.predict(base, imgs)[0])
        time.sleep(RS_BREAKER_RESET_S + 0.05)
        codes.append(client.predict(base, imgs)[0])
        closed = json.loads(client.healthz(base)[1])["breaker"]
        mlp_launches = dict(_kernels.LAUNCHES)
    finally:
        srv.request_stop("smoke over")
        srv.drain_and_stop()
    if codes != [502, 502, 502, 503, 200] or (opened, closed) != (
            "open", "closed"):
        raise AssertionError(f"phase 17 (d): classifier codes {codes}, "
                             f"breaker {opened} then {closed}")
    lm = BinarizedLM(**LM_WIDTH, generator=gen).eval()
    _random_lm_params(lm, gen)
    lm_path = os.path.join(tmp, "lm.msgpack")
    export_packed(lm, lm_path)
    prompt = torch.randint(0, LM_WIDTH["vocab"], (20,),
                           generator=gen).tolist()
    srv = LMServer(LMServeConfig(
        artifact=lm_path, device=str(device), port=0, slots=LM_SLOTS,
        page_size=LM_PAGE, prefill_chunk=LM_CHUNK, chaos=RS_LM_CHAOS))
    host, port = srv.start()
    try:
        _kernels.reset_launches()
        code, events = lc.generate(f"http://{host}:{port}", prompt,
                                   max_new_tokens=8)
        lm_launches = dict(_kernels.LAUNCHES)
        errors = srv.engine.errors_ctr.value(kind="ChaosInferError")
    finally:
        srv.request_stop("smoke over")
        srv.drain_and_stop()
    dec = make_paged_lm_decoder(load_frozen(lm_path), slots=LM_SLOTS,
                                page_size=LM_PAGE, prefill_chunk=LM_CHUNK,
                                device=device)
    want = _drive_alone(dec, prompt, 8)
    got = [e["token"] for e in events[:-1]]
    if code != 200 or events[-1].get("status") != "ok" or got != want \
            or errors != 2:
        raise AssertionError(f"phase 17 (d): LM stream {code} "
                             f"{events[-1:]}, {got} vs {want}, {errors} "
                             "injected errors counted")
    return {"codes": codes, "mlp_launches": mlp_launches,
            "lm_launches": lm_launches, "lm_errors": errors}


def resilience_processes(tmp: str) -> dict:
    """Phase 17's process-bound checks, (b)'s ranks and (c)'s host
    processes, started in ``tmp``: {name: join}. ``main`` starts them
    beside phase 16, whose spawn holds no timing either: neither starts a
    process group, a capture or a launch in this process (``resilience_
    phase`` runs (b)'s in-process world-1 check after the join)."""
    return {"elastic": _background(lambda: _rs_elastic(tmp)),
            "multihost": _background(lambda: _rs_multihost(tmp))}


def resilience_phase(device: torch.device, gen: torch.Generator, smi: str,
                     tmp: str = None, started: dict = None):
    """Phase 17, the fault-tolerant runtime (``resilience/chaos``,
    ``elastic``, ``multihost``, ``parallel/hostcomm``):

    (a) chaos ``step_fault``, ``preempt`` and ``ckpt_corrupt`` in one
    ``Trainer.fit`` of ``bnn-mlp-large`` on pallas_xnor, recovered by
    ``run_with_policy`` (a restart, a resume, a generation rollback):
    the final state ``torch.equal`` to the uninterrupted run's, the
    ``fault_injected`` records equal to the fires;
    (b) elastic DP: ``worker_lost`` 2 -> 1 then ``worker_restore`` -> 2
    on gloo ranks sharing the card (``sign_ef``), each generation's state
    bitwise a fresh resume at its world from the generation before it;
    (c) multihost: 2 host processes on the card over a loopback
    ``HostChannel``, ``host_lost@hosts=1`` then ``host_restore``: the
    final state bitwise a fresh 2-host resume, ``membership.json``
    holding both transitions;
    (d) both servers under ``infer_error``: the classifier's breaker
    opens and closes (K2/K3 counted), the LM engine retries and its
    stream equals the decoder alone (K1, K7, K8 counted).
    (b) and (c) run at once; ``started`` holds them when ``main``
    started them in ``tmp`` already (``resilience_processes``).
    Returns {kernel: launches on this path}."""
    import shutil

    t0 = time.perf_counter()
    marks = {}
    launches = {name: 0 for name in KERNEL_ROWS}
    if tmp is None:
        tmp = tempfile.mkdtemp(prefix="resilience_")
    try:
        a = _rs_chaos(tmp)
        marks["a"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"phase": 17, "chaos": a}), flush=True)
        # (b)'s ranks and (c)'s host processes at once
        if started is None:
            started = resilience_processes(tmp)
        c = started["multihost"]()
        marks["c"] = round(time.perf_counter() - t0, 1)
        b = started["elastic"]()
        _rs_elastic_world1(tmp)
        marks["b"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"phase": 17, "elastic": b}), flush=True)
        print(json.dumps({"phase": 17, "multihost": c}), flush=True)
        d = _rs_serve(device, gen, tmp)
        marks["d"] = round(time.perf_counter() - t0, 1)
        print(json.dumps({"phase": 17, "serve": d}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for counts in (a["launches"], d["mlp_launches"], d["lm_launches"]):
        for k, v in counts.items():
            launches[k] += v
    for name in ("xnor", "xnor_sign", "xnor_affine", "xnor_unpack",
                 "paged_attn"):
        if launches[name] == 0:
            raise AssertionError(f"phase 17: {name} never launched")
    print(json.dumps({"phase": 17, "launches": launches,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return launches


# Phase 18: transformer serving finished (ViT, speculative decoding, the
# prefix cache, sampling) and sequence-parallel ring attention.
VIT_BATCH = MAIN_M            # the classifier server's micro-batch
VIT_TOKENS = 49               # bnn-vit-small on 28 x 28 images: patch 4
VIT_M = VIT_BATCH * VIT_TOKENS  # K1's rows a projection: 1,568
VIT_PROJ = ((256, 256), (256, 512), (512, 256))   # (K, N): q/k/v/out, mlp
VIT_REQUESTS = (32, 5, 1)     # images a request, one micro-batch each
# The frozen ViT against the CPU plain predictor and the live eval
# forward: both sides' projections are exact integer sums, and the fp32
# rest (patch embedding, LayerNorm, softmax, head) sums at most 512
# products of O(1) terms in another order, within 512 * 2^-24 = 3e-5 of
# the sum of their magnitudes; 1e-4 on a log-prob, every example, and
# the argmax equal (measured on an H100: at most 7.2e-7).
VIT_LOGPROB_ATOL = 1e-4
VIT_TAIL_M = (5 * VIT_TOKENS, VIT_TOKENS)   # K1 on 5 and 1 unpadded images
SPEC_K = 4                    # the speculative window
SPEC_K999 = (16, 999, 256)    # (M, K, N) of the verifier GEMM's check:
                              # M = LM_SLOTS x SPEC_K, K7's route
PREFIX_SUFFIXES = (8, 17, 40)  # behind a shared prefix of two pages
PREFIX_POOL_PAGES = 8         # 7 allocatable: the undersized pool
SAMPLE_N, SAMPLE_SEED = 32, 3
# The ring at the LM training width: B 8, H 4, D 64, L 1,024 (512 a rank)
RING_RANKS = 2
RING_SHAPE = (8, 4, 1024, 64)
RING_OUT_TOL = dict(atol=2e-5, rtol=2e-5)   # phase 6's K4 tolerance
RING_LM_LOSS_RTOL = 1e-4                    # phase 7's step tolerance


def _k1_vit_rows(device, gen) -> list:
    """K1 at the ViT's projections, M = 1,568 rows (a micro-batch of 32
    images of 49 tokens), real x packed x >= 0 on chip (the frozen
    projections' entry): ``torch.equal`` to its plain version there and
    at ``VIT_TAIL_M`` (a predictor called on a partial batch; the server
    pads to 32), then its time, the entry's, the plain version's, bf16
    ``torch.matmul``'s and the bound."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.binarize import _sign_pm1
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    rows = []
    for k, n in VIT_PROJ:
        x = torch.randn(VIT_M, k, generator=gen).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        for m in (VIT_M, *VIT_TAIL_M):
            got = xg._xnor_matmul_binarize(x[:m], wp, k, n)
            want = xg.xnor_gemm_plain(pack_bits(_sign_pm1(x[:m])), wp,
                                      k)[:, :n]
            if not torch.equal(got, want):
                raise AssertionError(f"K1 at the ViT's ({m}, {k}, {n}) "
                                     "differs from its plain version")
        xb = _sign_pm1(x).to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": "xnor", "m": VIT_M, "k": k, "n": n,
            "kernel_ms": _graph_ms(lambda: _kernels.xnor_gemm(
                "xnor", x, wp, k, n, rule=_kernels.PACK_GE0)),
            "entry_ms": _graph_ms(
                lambda: xg._xnor_matmul_binarize(x, wp, k, n)),
            "plain_ms": _graph_ms(lambda: xg.xnor_gemm_plain(
                pack_bits(_sign_pm1(x)), wp, k)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
            "library": "bf16 torch.matmul",
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            "xnor", VIT_M, k, n)
        rows.append(row)
        print(json.dumps({"phase": 18, "vit_k1": row}), flush=True)
    return rows


def _flash_ring_rows(device, gen):
    """K4, K5 and K6 at the ring's per-rank shapes (the causal diagonal
    step and a full off-diagonal one): against their plain versions, then
    timed beside them, the library's and the bound. Returns (rows,
    {kernel: largest |diff|})."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import flash_attention as fa

    b, h, length, d = RING_SHAPE
    lq = length // RING_RANKS
    lib = torch.nn.functional.scaled_dot_product_attention
    rows, max_err = [], dict.fromkeys(FLASH, 0.0)
    for causal in (True, False):
        q, k, v, g_out = (torch.randn(b, lq, h, d, generator=gen).to(device)
                          for _ in range(4))
        g_lse = (0.5 * torch.randn(b, lq, h, generator=gen)).to(device)
        out, lse = _kernels.flash_fwd(q, k, v, causal)
        coeff = (g_lse - (g_out * out).sum(dim=-1)).contiguous()
        args = (q, k, v, g_out, lse, coeff, causal)
        pairs = {
            "flash_fwd": ((out, lse), fa.flash_fwd_plain(q, k, v, causal),
                          RING_OUT_TOL),
            "flash_bwd_dq": ((_kernels.flash_bwd_dq(*args),),
                             (fa.flash_bwd_dq_plain(*args),),
                             FLASH_GRAD_TOL),
            "flash_bwd_dkv": (_kernels.flash_bwd_dkv(*args),
                              fa.flash_bwd_dkv_plain(*args), FLASH_GRAD_TOL),
        }
        for name, (got, want, tol) in pairs.items():
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            max_err[name] = max(max_err[name], err)
            if not all(torch.allclose(g, w, **tol) for g, w in zip(got,
                                                                   want)):
                raise AssertionError(f"{name} at the ring's shape, causal "
                                     f"{causal}: max |diff| {err}")
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        lib_bwd_ms = _graph_ms(_library_bwd(q, k, v, g_out, causal),
                               iters=20, reps=10)
        kernel = {
            "flash_fwd": lambda: _kernels.flash_fwd(q, k, v, causal),
            "flash_bwd_dq": lambda: _kernels.flash_bwd_dq(*args),
            "flash_bwd_dkv": lambda: _kernels.flash_bwd_dkv(*args),
        }
        plain = {
            "flash_fwd": lambda: fa.flash_fwd_plain(q, k, v, causal),
            "flash_bwd_dq": lambda: fa.flash_bwd_dq_plain(*args),
            "flash_bwd_dkv": lambda: fa.flash_bwd_dkv_plain(*args),
        }
        for name in FLASH:
            row = {
                "kernel": name, "b": b, "h": h, "lq": lq, "lk": lq, "d": d,
                "causal": causal,
                "kernel_ms": _graph_ms(kernel[name], iters=20, reps=10),
                "plain_ms": _graph_ms(plain[name], iters=5, reps=5),
                "library_ms": (_graph_ms(
                    lambda: lib(qs, ks, vs, is_causal=causal), iters=20,
                    reps=10) if name == "flash_fwd" else lib_bwd_ms),
            }
            row["bound_ms"], row["bound_by"], row["bound_peak"] = (
                _flash_bound(name, b, h, lq, lq, d, causal))
            rows.append(row)
            print(json.dumps({"phase": 18, "ring_shape": row}), flush=True)
    return rows, max_err


def _ring_lm_step(device, seed: int) -> dict:
    """One ``lm_demo.ring_train_step`` (dense local step, as ``run(ring=
    True)``) against one ``train_step`` of the same parameters with the
    exact softmax, at phase 7's width: the loss within
    ``RING_LM_LOSS_RTOL``, each gradient within ``LM_GRAD_RTOL`` in
    relative L2 (the key bias's, exactly 0 in exact arithmetic, only
    printed)."""
    from distributed_mnist_bnns_tpu_torch.examples import lm_demo
    from distributed_mnist_bnns_tpu_torch.models import (
        BinarizedLM,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import make_ring_attention

    gen = torch.Generator().manual_seed(seed)
    plain = BinarizedLM(**LM_TRAIN, max_len=RING_SHAPE[2], generator=gen)
    _random_lm_params(plain, gen)
    ring = BinarizedLM(**LM_TRAIN, max_len=RING_SHAPE[2],
                       attention_fn=make_ring_attention(causal=True))
    ring.load_state_dict(plain.state_dict())
    _, draw = lm_demo.token_stream(RING_SHAPE[2], RING_SHAPE[0],
                                   LM_TRAIN["vocab"], seed=seed)
    toks = torch.from_numpy(draw()).to(device)
    losses, grads = {}, {}
    for name, m in (("ring", ring.to(device)), ("plain", plain.to(device))):
        opt = lm_demo.make_optimizer(m, LM_TRAIN_LR)
        latents = list(latent_clamp_mask(m).values())
        step = (lm_demo.ring_train_step if name == "ring"
                else lm_demo.train_step)
        losses[name] = float(step(m, opt, latents, toks))
        grads[name] = {n: p.grad for n, p in m.named_parameters()}
    rel = {n: ((grads["ring"][n] - g).norm() / g.norm()).item()
           for n, g in grads["plain"].items()}
    held = {n: r for n, r in rel.items() if not n.endswith("attn.k.bias")}
    worst = max(held, key=held.get)
    return {"losses": losses,
            "loss_rel_diff": abs(losses["ring"] - losses["plain"])
            / abs(losses["plain"]),
            "grad_rel_l2_worst": [worst, held[worst]],
            "key_bias_rel_l2": {n: r for n, r in rel.items()
                                if n.endswith("attn.k.bias")}}


def _ring_rank(rank: int, world: int, device, seed: int) -> dict:
    """A rank of phase 18 (d): the ring's flash local step, causal and
    full, forward and backward (the path; its K4-K6 launches counted),
    then held against ``flash_attention`` over the whole sequence on
    this rank; the dense local step against ``attention_reference``;
    one ``lm_demo`` ring step against a plain one."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import flash_attention as fa
    from distributed_mnist_bnns_tpu_torch.parallel import (
        attention_reference,
        make_ring_attention,
    )

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    b, h, length, d = RING_SHAPE
    lo, hi = rank * length // world, (rank + 1) * length // world
    q, k, v, g = (torch.randn(b, length, h, d, generator=gen).to(device)
                  for _ in range(4))

    def ring_run(local, causal):
        ring = make_ring_attention(causal=causal, local=local)
        shards = [t[:, lo:hi].clone().requires_grad_() for t in (q, k, v)]
        out = ring(*shards)
        out.backward(g[:, lo:hi])
        return [out.detach()] + [s.grad for s in shards]

    _kernels.reset_launches()
    got = {causal: ring_run("flash", causal) for causal in (True, False)}
    torch.cuda.synchronize()
    counts = dict(_kernels.LAUNCHES)
    errs = {}

    def hold(what, ring_out, full_fn, tol):
        full = [t.clone().requires_grad_() for t in (q, k, v)]
        out = full_fn(*full)
        out.backward(g)
        want = [out.detach()] + [t.grad for t in full]
        for name, a, w in zip(("out", "dq", "dk", "dv"), ring_out, want):
            w = w[:, lo:hi]
            errs[f"{what} {name}"] = (a - w).abs().max().item()
            if not torch.allclose(a, w, **(tol if name == "out"
                                            else FLASH_GRAD_TOL)):
                raise AssertionError(
                    f"rank {rank}: ring {what} {name} differs by "
                    f"{errs[f'{what} {name}']}")

    for causal in (True, False):
        hold(f"flash causal={causal}", got[causal],
             lambda *t, c=causal: fa.flash_attention(*t, causal=c),
             RING_OUT_TOL)
        hold(f"dense causal={causal}", ring_run("dense", causal),
             lambda *t, c=causal: attention_reference(*t, causal=c),
             RING_OUT_TOL)
    return {"rank": rank, "launches": counts, "max_abs_err": errs,
            "lm": _ring_lm_step(device, seed),
            "s": time.perf_counter() - t0}


def _lm_artifact(gen, tmp: str):
    """The LM at ``LM_WIDTH`` with random biases and LayerNorm
    parameters, exported; (path, frozen dict)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
    )
    from distributed_mnist_bnns_tpu_torch.models import BinarizedLM

    model = BinarizedLM(**LM_WIDTH, generator=gen).eval()
    _random_lm_params(model, gen)
    path = os.path.join(tmp, "lm18.msgpack")
    export_packed(model, path)
    return path, load_frozen(path)


def _counted_decoder(frozen, device, **kw):
    """The paged decoder at the LM path's geometry, its calls counted,
    and the K8 launches of its verify calls (delta of the counters
    around each: the engine's thread is the one launching)."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    dec = make_paged_lm_decoder(frozen, slots=LM_SLOTS, page_size=LM_PAGE,
                                prefill_chunk=LM_CHUNK, device=device, **kw)
    calls = {"prefill": 0, "decode": 0, "verify": 0, "verify_k8": 0}

    def counted(name, fn):
        def call(*args):
            before = _kernels.LAUNCHES["paged_attn"]
            out = fn(*args)
            calls[name] += 1
            if name == "verify":
                calls["verify_k8"] += _kernels.LAUNCHES["paged_attn"] - before
            return out
        return call

    wrapped = {n: counted(n, getattr(dec, n))
               for n in ("prefill", "decode", "verify")
               if getattr(dec, n) is not None}
    return dec._replace(**wrapped), calls


def _run_engine(dec, calls, device, requests, *, sequential=False,
                **kw):
    """Start an ``LMEngine`` over ``dec`` (the warm-up runs first), zero
    the counters and ``calls``, serve ``requests`` ((prompt, n) pairs: at
    once, or one after another), stop. Returns (tokens of each, launch
    counts, the engine)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine

    eng = LMEngine(dec, queue_depth=16, device=device, **kw).start()

    def drain(req):
        toks = []
        while True:
            ev = req.events.get(timeout=300)
            if ev["kind"] == "done":
                if ev["status"] != "ok":
                    raise AssertionError(f"stream ended {ev}")
                return toks
            toks.append(ev["token"])

    try:
        for key in calls:
            calls[key] = 0
        _kernels.reset_launches()
        deadline = time.monotonic() + 600
        if sequential:
            out = [drain(eng.submit(np.asarray(p, np.int32), n, deadline))
                   for p, n in requests]
        else:
            reqs = [eng.submit(np.asarray(p, np.int32), n, deadline)
                    for p, n in requests]
            out = [drain(r) for r in reqs]
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
    finally:
        eng.stop()
    return out, counts, eng


def _spec_check(device, gen, frozen) -> dict:
    """Phase 18 (b): the verifier GEMM bitwise K1 at K = 999; the LM at
    ``LM_WIDTH`` with ``spec_k = 4`` on the staggered ``LM_PROMPTS``,
    token for token the ``spec_k = 1`` engine's, every call's kernels
    counted; the plain engine (``spec_k = 0``) run beside for its round
    time (its tokens may part from the verifier's: not held). The three
    engines run twice, in the order 4, 1, 0, 0, 1, 4, before the ring's
    ranks start, so nothing else runs on the card or the host's cores;
    each engine's second run repeats its first's tokens, and its median
    is over both runs' iterations."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        FUSED_UNPACK_MIN_M,
        _packed_dense_fn,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg

    m, k, n = SPEC_K999
    w = _pm1(gen, k, n)
    x = torch.randn(m, k, generator=gen)
    x[0], x[1] = w[:, 0], -w[:, 1]          # sums of +-999: odd, > 256
    wp, _, _ = xg.prepack_weights(w.to(device))
    layer = {"wp": wp, "k": k, "n": n,
             "bias": torch.zeros(n, device=device)}
    before = _kernels.LAUNCHES["xnor_unpack"]
    got = _packed_dense_fn(layer, fused=True)(x.to(device))   # K7: verify's
    k7 = _kernels.LAUNCHES["xnor_unpack"] - before
    want = _packed_dense_fn(layer)(x.to(device))              # K1
    exact = torch.where(x >= 0, 1.0, -1.0).double() @ w.double()
    gemm = {"shape": list(SPEC_K999), "k7_launches": k7,
            "bitwise_k1": torch.equal(got, want),
            "sums_exact": bool((want.double().cpu() == exact).all()),
            "largest_sum": float(want.abs().max())}
    print(json.dumps({"phase": 18, "verifier_gemm": gemm}), flush=True)
    if not (k7 == 1 and gemm["bitwise_k1"] and gemm["sums_exact"]
            and gemm["largest_sum"] == k):
        raise AssertionError(f"the verifier's GEMM is not K1's: {gemm}")

    vocab = LM_WIDTH["vocab"]
    requests = [(torch.randint(0, vocab, (p,), generator=gen).tolist(),
                 LM_NEW_TOKENS) for p in LM_PROMPTS]
    runs = {}
    for spec_k in (SPEC_K, 1, 0, 0, 1, SPEC_K):
        dec, calls = _counted_decoder(frozen, device, spec_k=spec_k)
        t0 = time.perf_counter()
        toks, counts, eng = _run_engine(dec, calls, device, requests)
        runs.setdefault(spec_k, []).append(dict(
            toks=toks, counts=counts, calls=dict(calls), eng=eng,
            s=time.perf_counter() - t0))
    if any(r[0]["toks"] != r[1]["toks"] for r in runs.values()):
        raise AssertionError("an engine's two runs differ")
    spec, alone, plain = runs[SPEC_K][0], runs[1][0], runs[0][0]
    if spec["toks"] != alone["toks"]:
        raise AssertionError("spec_k = 4 differs from the verifier alone")
    eng, calls, counts = spec["eng"], spec["calls"], spec["counts"]
    depth = LM_WIDTH["depth"]
    # verify's projections take LM_SLOTS x SPEC_K rows: K7 from 16 on
    k7 = calls["verify"] if LM_SLOTS * SPEC_K >= FUSED_UNPACK_MIN_M else 0
    want = {"xnor": 6 * depth * (calls["decode"] + calls["verify"] - k7),
            "xnor_unpack": 6 * depth * (calls["prefill"] + k7),
            "paged_attn": depth * (calls["decode"] + calls["prefill"]
                                   + calls["verify"])}
    if any(counts[key] != v for key, v in want.items()) \
            or calls["verify_k8"] != depth * eng.spec_rounds \
            or calls["verify_k8"] == 0:
        raise AssertionError(f"spec path launches {counts}, calls {calls}, "
                             f"want {want}, rounds {eng.spec_rounds}")
    rate = eng.spec_acceptance_rate

    def median_ms(spec_k):
        return statistics.median(t for r in runs[spec_k]
                                 for t in r["eng"].iter_ms)

    def seconds(spec_k):
        return [r["s"] for r in runs[spec_k]]

    info = {"spec_k": SPEC_K, "acceptance_rate": rate,
            "tokens_per_slot_round": 1 + rate * (SPEC_K - 1),
            "spec_rounds": eng.spec_rounds, "calls": calls,
            "k8_verify_launches": calls["verify_k8"],
            "round_ms_median": median_ms(SPEC_K),
            "verifier_alone_round_ms_median": median_ms(1),
            "plain_round_ms_median": median_ms(0),
            "engine_s": seconds(SPEC_K), "verifier_alone_s": seconds(1),
            "plain_s": seconds(0),
            "plain_tokens_equal": plain["toks"] == spec["toks"],
            "launches": counts}
    print(json.dumps({"phase": 18, "spec": info}), flush=True)
    return info


def _prefix_check(device, gen, frozen) -> dict:
    """Phase 18 (c): requests behind a shared two-page prefix, one after
    another, through the cache and through a cold engine: tokens equal,
    K7/K8's prefill launches down by the shared pages; an undersized pool
    evicts LRU entries and admits; spec decoding with the cache equals
    spec decoding alone."""
    from distributed_mnist_bnns_tpu_torch.serve.core import labeled

    vocab, depth = LM_WIDTH["vocab"], LM_WIDTH["depth"]
    shared = torch.randint(0, vocab, (2 * LM_PAGE,), generator=gen).tolist()
    requests = [(shared + torch.randint(0, vocab, (s,),
                                        generator=gen).tolist(),
                 LM_NEW_TOKENS) for s in PREFIX_SUFFIXES]
    runs = {}
    for cache in (True, False):
        dec, calls = _counted_decoder(frozen, device)
        toks, counts, eng = _run_engine(dec, calls, device, requests,
                                        sequential=True, prefix_cache=cache)
        runs[cache] = dict(toks=toks, counts=counts, calls=dict(calls),
                           eng=eng)
    hit, cold = runs[True], runs[False]
    if hit["toks"] != cold["toks"]:
        raise AssertionError("prefix-cache hits differ from a cold engine")
    hits = labeled(hit["eng"].prefix_hits_ctr).get("result=hit", 0)
    chunks = {c: sum(-(-(len(p) - (2 * LM_PAGE if c and i else 0))
                        // LM_CHUNK) for i, (p, _) in enumerate(requests))
              for c in (True, False)}
    saved = chunks[False] - chunks[True]
    if not (hits == len(requests) - 1 and saved > 0
            and hit["calls"]["prefill"] == chunks[True]
            and cold["counts"]["xnor_unpack"] - hit["counts"]["xnor_unpack"]
            == 6 * depth * saved
            and cold["counts"]["paged_attn"] - hit["counts"]["paged_attn"]
            == depth * saved):
        raise AssertionError(
            f"prefix cache: hits {hits}, chunks {chunks}, launches "
            f"{hit['counts']} against cold {cold['counts']}")
    launches = dict(hit["counts"])

    # An undersized pool: the first request's published pages must be
    # evicted for the next (another prompt, more pages) to be admitted.
    other = torch.randint(0, vocab, (60,), generator=gen).tolist()
    small = [(requests[2][0], LM_NEW_TOKENS), (other, LM_NEW_TOKENS)]
    outs = {}
    for cache in (True, False):
        dec, calls = _counted_decoder(frozen, device,
                                      num_pages=PREFIX_POOL_PAGES)
        toks, counts, eng = _run_engine(dec, calls, device, small,
                                        sequential=True, prefix_cache=cache)
        outs[cache] = toks
        if cache:
            for key, v in counts.items():
                launches[key] += v
    if outs[True] != outs[False]:
        raise AssertionError("the undersized pool's streams differ")

    # Speculative decoding with the cache against without it.
    spec = {}
    for cache in (True, False):
        dec, calls = _counted_decoder(frozen, device, spec_k=SPEC_K)
        toks, counts, eng = _run_engine(dec, calls, device, requests,
                                        sequential=True, prefix_cache=cache)
        spec[cache] = toks
        if cache:
            for key, v in counts.items():
                launches[key] += v
    if spec[True] != spec[False]:
        raise AssertionError("spec decoding with the prefix cache differs "
                             "from spec decoding alone")
    info = {"hits": hits, "prefill_chunks": chunks, "saved_chunks": saved,
            "k7_launches_hit_cold": [hit["counts"]["xnor_unpack"],
                                     cold["counts"]["xnor_unpack"]],
            "k8_launches_hit_cold": [hit["counts"]["paged_attn"],
                                     cold["counts"]["paged_attn"]],
            "launches": launches}
    print(json.dumps({"phase": 18, "prefix": info}), flush=True)
    return info


def _vit_check(device, gen, smi: str) -> dict:
    """Phase 18 (a): ``bnn-vit-small`` with drawn biases and LayerNorm
    parameters frozen, exported, served over HTTP at micro-batch 32 (K1
    at M = 1,568): every answer against the CPU plain predictor and the
    live eval forward."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import bnn_vit_small
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    model = bnn_vit_small(backend="xla", generator=gen).eval()
    _random_lm_params(model, gen)
    images = [torch.rand(n, 28, 28, 1, generator=gen) for n in VIT_REQUESTS]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit.msgpack")
        info = export_packed(model, path)
        srv = PackedInferenceServer(ServeConfig(
            artifact=path, device=str(device), port=0, batch_size=VIT_BATCH,
            queue_depth=8, default_deadline_ms=60000.0,
            input_shape=(28, 28, 1)))
        host, port = srv.start()
        answers = []
        try:
            _kernels.reset_launches()
            for x in images:
                answers.append(sc.predict(f"http://{host}:{port}",
                                          x.tolist()))
            torch.cuda.synchronize()
            counts = dict(_kernels.LAUNCHES)
        finally:
            srv.request_stop("smoke over")
            srv.drain_and_stop()
        plain, _ = load_packed(path, device="cpu")
    live = model.to(device)
    worst, far, n_ex = 0.0, 0, 0
    for x, (code, body) in zip(images, answers):
        if code != 200:
            raise AssertionError(f"/predict: {code} {body[:200]!r}")
        got = torch.tensor(json.loads(body)["log_probs"])
        with torch.no_grad():
            refs = (plain(x), live(x.to(device)).cpu())
        for ref in refs:
            diff = (got - ref).abs().amax(dim=-1)
            worst = max(worst, diff.max().item())
            far += int((diff > VIT_LOGPROB_ATOL).sum())
            n_ex += len(diff)
            if not torch.equal(got.argmax(-1), ref.argmax(-1)):
                raise AssertionError("the served ViT's argmax differs")
    batches = len(VIT_REQUESTS)
    if counts["xnor"] != 6 * 4 * batches or far:
        raise AssertionError(f"ViT: K1 {counts['xnor']} launches (want "
                             f"{24 * batches}), {far} of {n_ex} examples "
                             f"beyond {VIT_LOGPROB_ATOL} (worst {worst})")
    out = {"compression": info["compression"], "requests": len(images),
           "max_abs_logprob_diff": worst, "examples_beyond_tol": far,
           "compared": n_ex, "launches": counts}
    print(json.dumps({"phase": 18, "vit": out}), flush=True)
    return out


def _sample_check(device, path: str, frozen) -> dict:
    """Phase 18 (e): ``cli lm --load --sample 32`` in this process: at
    temperature 0 the greedy ``generate``'s tokens, at 0.8 one seed's
    two runs equal."""
    import contextlib
    import io

    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        generate,
        make_lm_decoder,
    )

    def sample(*flags):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["lm", "--load", path, "--sample", str(SAMPLE_N),
                           "--device", str(device), "--prompt", LM_TEXT,
                           *flags])
        if rc != 0:
            raise AssertionError(f"cli lm --load: exit {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])["tokens"]

    prompt = [b % LM_WIDTH["vocab"] for b in LM_TEXT.encode("utf-8")]
    greedy = sample("--temperature", "0")
    want = generate(frozen, [prompt], SAMPLE_N,
                    decoder=make_lm_decoder(frozen, device=device))
    a = sample("--temperature", "0.8", "--seed", str(SAMPLE_SEED))
    b = sample("--temperature", "0.8", "--seed", str(SAMPLE_SEED))
    out = {"greedy_equal": greedy == want[0, len(prompt):].tolist(),
           "seeded_equal": a == b, "sampled_differs_from_greedy": a != greedy}
    print(json.dumps({"phase": 18, "sampling": out}), flush=True)
    if not (out["greedy_equal"] and out["seeded_equal"]):
        raise AssertionError(f"sampling: {out}")
    return out


def transformer_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 18: the timings at the ViT's and the ring's shapes and (b)
    speculative decoding, whose engines are timed, first; then the ring's
    2 gloo ranks in the background beside the in-process checks (a) ViT
    serving, (c) the prefix cache, (e) sampling. Returns ({path: launch counts}, K1's ViT rows,
    the flash rows at the ring's shapes, K8's verify launches)."""
    import distributed_mnist_bnns_tpu_torch.parallel as par

    t0 = time.perf_counter()
    marks = {}
    vit_rows = _k1_vit_rows(device, gen)
    ring_rows, _ = _flash_ring_rows(device, gen)
    marks["timings"] = round(time.perf_counter() - t0, 1)
    with tempfile.TemporaryDirectory() as tmp:
        path, frozen = _lm_artifact(gen, tmp)
        spec = _spec_check(device, gen, frozen)    # timed: nothing beside
        marks["b"] = round(time.perf_counter() - t0, 1)
        ring_join = _background(lambda: par.spawn(
            _ring_rank, RING_RANKS, backend="gloo", device=device.type,
            args=(18,)))
        try:
            vit = _vit_check(device, gen, smi)
            marks["a"] = round(time.perf_counter() - t0, 1)
            prefix = _prefix_check(device, gen, frozen)
            marks["c"] = round(time.perf_counter() - t0, 1)
            _sample_check(device, path, frozen)
            marks["e"] = round(time.perf_counter() - t0, 1)
        finally:
            ranks = ring_join()
    marks["d"] = round(time.perf_counter() - t0, 1)
    ring = dict.fromkeys(KERNEL_ROWS, 0)
    for r in ranks:
        for key, v in r["launches"].items():
            ring[key] += v
    # each rank runs its diagonal step and the earlier ranks' shards
    # causal, every shard full: one K4, K5 and K6 each
    want = sum(r + 1 for r in range(RING_RANKS)) + RING_RANKS ** 2
    lm = ranks[0]["lm"]
    print(json.dumps({"phase": 18, "ring": {
        "ranks": RING_RANKS, "shape": list(RING_SHAPE), "launches": ring,
        "max_abs_err": {k: max(r["max_abs_err"][k] for r in ranks)
                        for k in ranks[0]["max_abs_err"]},
        "lm_step": lm, "rank_s": [round(r["s"], 1) for r in ranks]}}),
        flush=True)
    if any(ring[name] != want for name in FLASH):
        raise AssertionError(f"ring launches {ring}, want {want} each")
    if not (lm["loss_rel_diff"] <= RING_LM_LOSS_RTOL
            and lm["grad_rel_l2_worst"][1] <= LM_GRAD_RTOL):
        raise AssertionError(f"ring LM step against the plain one: {lm}")
    paths = {"vit": vit["launches"], "spec": spec["launches"],
             "prefix": prefix["launches"], "ring": ring}
    print(json.dumps({"phase": 18, "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return paths, vit_rows, ring_rows, spec["k8_verify_launches"]


# -- phase 19: the QNN and MoE families -------------------------------------------

FAM_SYNTH = (512, 256)        # 8 training steps of 64; a test split of 256
FAM_TRAIN = dict(batch_size=64, optimizer="adam", learning_rate=0.01,
                 seed=0, log_interval=1)
QNN_MODEL = "qnn-mlp-large"   # 784-3072-1536-768-10, 8 bits
MOE_MODEL = "bnn-moe-mlp"     # hidden 512, 8 experts of 512, top-2, cf 1.25
FAM_REQUESTS = (32, 5, 1)     # images a request, one micro-batch each
MOE_E, MOE_D = 8, 512
MOE_CAP = 10                  # ceil(1.25 * 32 * 2 / 8): the served capacity
MOE_K1 = ((MOE_CAP, MOE_D, MOE_D), (MAIN_M, MOE_D, 10))   # experts, head
QNN_GEMMS = ((784, 3072), (3072, 1536), (1536, 768))      # (K, N)
FP32_U = 2.0 ** -24           # fp32's unit roundoff
MOE_SCAN_STEPS = 4
FAM_RANKS = 2
FAM_RANK_ATOL = 1e-5


def _k1_moe_rows(device, gen) -> list:
    """K1 at the served MoE's shapes, the experts' (10, 512, 512) and the
    head's (32, 512, 10), on ±1 x: ``torch.equal`` to its plain version,
    then its time, the entry's, the plain version's, bf16
    ``torch.matmul``'s and the bound."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    rows = []
    for m, k, n in MOE_K1:
        x = _pm1(gen, m, k).to(device)
        wp, _, _ = xg.prepack_weights(_pm1(gen, k, n).to(device))
        got = xg.xnor_matmul_packed(x, wp, k, n)
        want = xg.xnor_gemm_plain(pack_bits(x), wp, k)[:, :n]
        if not torch.equal(got, want):
            raise AssertionError(f"K1 at the MoE's ({m}, {k}, {n}) differs "
                                 "from its plain version")
        xb = x.to(torch.bfloat16)
        wb = xg.unpacked_pm1(wp, k, n, torch.bfloat16).contiguous()
        row = {
            "kernel": "xnor", "m": m, "k": k, "n": n,
            "kernel_ms": _graph_ms(lambda: _kernels.xnor_gemm(
                "xnor", x, wp, k, n)),
            "entry_ms": _graph_ms(lambda: xg.xnor_matmul_packed(x, wp, k,
                                                                n)),
            "plain_ms": _graph_ms(lambda: xg.xnor_gemm_plain(
                pack_bits(x), wp, k)),
            "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
            "library": "bf16 torch.matmul",
        }
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            "xnor", m, k, n)
        rows.append(row)
        print(json.dumps({"phase": 19, "moe_k1": row}), flush=True)
    return rows


def _qnn_gemm_rows(device, gen) -> list:
    """The QNN's int8 GEMM (``ops.xnor_gemm.int8_matmul``, cuBLASLt's
    ``torch._int_mm``: a library GEMM, not a port of a TPU kernel) at
    its three weight shapes: its int32 sums against the float64 product
    of the same integers on the card (every partial sum an integer below
    2^53: exact), at M = 32 and M = 1, with sums past 2^24; then its time
    and a bf16 GEMM's at M = 32."""
    from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import int8_matmul

    rows = []
    for k, n in QNN_GEMMS:
        def draw(*shape):
            # mostly +127: sums up to K * 127^2, past fp32's 2^24 at K=3,072
            r = torch.rand(*shape, generator=gen)
            v = torch.where(r < 0.9, 127.0, torch.where(r < 0.95, -128.0,
                                                        3.0))
            return v.to(torch.int8).to(device)

        a, wt = draw(MAIN_M, k), draw(n, k)
        worst = 0
        for m in (MAIN_M, 1):
            got = int8_matmul(a[:m], wt)
            want = a[:m].double() @ wt.double().t()
            if got.dtype != torch.int32 or not torch.equal(got.double(),
                                                           want):
                raise AssertionError(f"int8 GEMM at ({m}, {k}, {n}): not "
                                     "the exact integer sums")
            worst = max(worst, int(want.abs().max().item()))
        ab = a.to(torch.bfloat16)
        wb = wt.t().to(torch.bfloat16).contiguous()
        row = {"m": MAIN_M, "k": k, "n": n, "max_abs_sum": worst,
               "int8_ms": _events_ms(lambda: int8_matmul(a, wt)),
               "bf16_ms": _events_ms(lambda: torch.matmul(ab, wb))}
        rows.append(row)
        print(json.dumps({"phase": 19, "qnn_int8_gemm": row}), flush=True)
    return rows


def _fam_trainer(device, model, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(FAM_TRAIN, model=model, epochs=1, device=str(device))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg))


def _moe_plain(fn, images) -> torch.Tensor:
    """A ``FrozenMoE``'s forward with K1's plain version for each expert
    and the head, on the predictor's device."""
    from distributed_mnist_bnns_tpu_torch.ops.binarize import binarize_ste
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits
    from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import (
        xnor_gemm_plain,
    )

    x, dispatch, combine = fn.route(images)
    xb = binarize_ste(torch.einsum("tec,td->ecd", dispatch, x))
    ex_out = torch.stack([
        xnor_gemm_plain(pack_bits(xb[e]), fn.experts_wp[e], fn.ek)[:, :fn.en]
        + fn.experts_b[e] for e in range(fn.num_experts)])
    y = torch.einsum("tec,ecd->td", combine, ex_out)
    bits = torch.where(fn.a1 * y >= fn.t1, 1.0, -1.0)
    logits = xnor_gemm_plain(pack_bits(bits), fn.head_wp,
                             fn.hk)[:, :fn.hn] + fn.head_b
    return torch.log_softmax(logits, dim=-1)


def _serve_answers(path: str, device, images) -> tuple:
    """``images`` (a list of (n, 28, 28, 1) batches) through the classifier
    server at micro-batch 32, one request each: (answers, the kernels'
    launches while they were served)."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device=str(device), port=0, batch_size=MAIN_M,
        queue_depth=8, default_deadline_ms=60000.0,
        input_shape=(28, 28, 1)))
    host, port = srv.start()
    answers = []
    try:
        _kernels.reset_launches()
        for x in images:
            code, body = sc.predict(f"http://{host}:{port}", x.tolist())
            if code != 200:
                raise AssertionError(f"/predict: {code} {body[:200]!r}")
            answers.append(torch.tensor(json.loads(body)["log_probs"]))
        torch.cuda.synchronize()
        counts = dict(_kernels.LAUNCHES)
    finally:
        srv.request_stop("smoke over")
        srv.drain_and_stop()
    return answers, counts


def _padded(x: torch.Tensor) -> torch.Tensor:
    """A request's images as the server's micro-batch: zero rows to 32."""
    return torch.cat([x, torch.zeros(MAIN_M - len(x), *x.shape[1:])])


def _gamma(k: int) -> float:
    """The a-priori relative error bound of an fp32 sum of ``k`` products
    in any order: k·u / (1 - k·u)."""
    return k * FP32_U / (1 - k * FP32_U)


def _qnn_walk(fn, x: torch.Tensor, levels=None) -> dict:
    """``FrozenQNN.__call__``'s stages on (n, 28, 28, 1) images: the first
    layer's output ``y1``; ``v``, 2^(b-1)·hardtanh of the first BN's
    affine of it (the value ``quantize`` rounds); ``levels``, the first
    hidden GEMM's int8 inputs; the head's input ``h``; ``logits`` and
    ``logp``. Given ``levels`` (another device's), the walk goes on from
    those."""
    from distributed_mnist_bnns_tpu_torch.models.layers import hard_tanh
    from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import (
        _fma_f32,
        int8_matmul,
    )

    x = x.to(fn.device).reshape(len(x), -1)
    y1 = (x @ fn.w0) / fn.scale + fn.b0
    a, c = fn.bns[0]
    out = {"y1": y1, "v": hard_tanh(_fma_f32(a, y1, c)) * fn.scale,
           "levels": (fn.int_inputs(y1, 0) if levels is None
                      else levels.to(fn.device))}
    q, y = out["levels"], y1
    for i, (wt, b) in enumerate(fn.hidden):
        if i:
            q = fn.int_inputs(y, i)
        y = int8_matmul(q, wt).to(torch.float32) / (fn.scale ** 2) + b
    a, c = fn.bns[2]
    out["h"] = hard_tanh(_fma_f32(a, y, c))
    out["logits"] = out["h"] @ fn.wh + fn.bh
    out["logp"] = torch.log_softmax(out["logits"], dim=-1)
    return out


def _qnn_against_cpu(fn, plain, images, answers) -> dict:
    """The served QNN answers against the CPU plain predictor of the same
    artifact, stage by stage. Only the two fp32 GEMMs (the first layer,
    the head) may differ by summation order; everything between is
    integer or elementwise IEEE arithmetic, the same on both devices.
    So: (1) each served answer is ``torch.equal`` to the card's walk of
    its padded micro-batch; (2) the card's and the CPU's ``v`` agree
    within twice the first layer's error bound carried through the BN
    affine, so a level may flip only where ``v`` lies that close to a
    rounding boundary; (3) the CPU walk from the card's first levels
    gives the card's head input bitwise; (4) the logits then agree within
    twice the head's bound; (5) the argmax agrees with the CPU's own
    answer. Returns what the run measured: the log-prob differences
    against the CPU's own answer, the flipped levels, and the worst
    differences as fractions of the bounds."""
    out = {"max_abs_logprob_diff_vs_cpu": 0.0, "examples_beyond_1e-5": 0,
           "levels_flipped": 0, "examples_with_a_flip": 0,
           "max_abs_logprob_diff_with_a_flip": 0.0,
           "max_abs_logprob_diff_without": 0.0,
           "v_diff_over_bound": 0.0, "logit_diff_over_bound": 0.0,
           "compared": 0}
    a, c = (t.cpu().double() for t in plain.bns[0])
    w0 = plain.w0.double().abs()
    wh = plain.wh.double().abs()
    for x, got in zip(images, answers):
        n = len(x)
        card = _qnn_walk(fn, _padded(x))
        if not torch.equal(got, card["logp"][:n].cpu()):
            raise AssertionError("a served QNN answer differs from the "
                                 "card's predictor on its micro-batch")
        cpu = _qnn_walk(plain, x)
        ey1 = _gamma(w0.shape[0] + 1) * (
            x.reshape(n, -1).double().abs() @ w0 / plain.scale
            + plain.b0.double().abs())
        y1 = cpu["y1"].double()
        v_bound = plain.scale * ((1 + FP32_U) * a.abs() * 2 * ey1
                                 + 2 * FP32_U * (a.abs() * y1.abs()
                                                 + c.abs()))
        dv = (card["v"][:n].cpu().double() - cpu["v"].double()).abs()
        if not bool((dv <= v_bound).all()):
            raise AssertionError("the QNN's first layer on the card is "
                                 "beyond fp32's error bound of the CPU's")
        mid = _qnn_walk(plain, x, levels=card["levels"][:n].cpu())
        if not torch.equal(mid["h"], card["h"][:n].cpu()):
            raise AssertionError("the QNN's integer layers differ between "
                                 "the card and the CPU on the same levels")
        z_bound = 2 * _gamma(wh.shape[0] + 1) * (
            mid["h"].double().abs() @ wh + plain.bh.double().abs())
        dz = (card["logits"][:n].cpu().double()
              - mid["logits"].double()).abs()
        if not bool((dz <= z_bound).all()):
            raise AssertionError("the QNN's head on the card is beyond "
                                 "fp32's error bound of the CPU's")
        want = cpu["logp"]
        if not torch.equal(got.argmax(-1), want.argmax(-1)):
            raise AssertionError("served QNN: the argmax differs from the "
                                 "CPU plain path's")
        diff = (got - want).abs().amax(dim=-1)
        flips = (card["levels"][:n].cpu() != cpu["levels"]).sum(dim=-1)
        out["compared"] += n
        out["levels_flipped"] += int(flips.sum())
        out["examples_with_a_flip"] += int((flips > 0).sum())
        out["examples_beyond_1e-5"] += int((diff > 1e-5).sum())
        for key, sel in (("max_abs_logprob_diff_vs_cpu", diff),
                         ("max_abs_logprob_diff_with_a_flip",
                          diff[flips > 0]),
                         ("max_abs_logprob_diff_without", diff[flips == 0]),
                         ("v_diff_over_bound", dv / v_bound),
                         ("logit_diff_over_bound", dz / z_bound)):
            if sel.numel():
                out[key] = max(out[key], sel.max().item())
    return out


def _qnn_check(device, gen, data, tmp: str):
    """Phase 19 (a): ``qnn-mlp-large`` trained 8 steps, frozen, exported,
    loaded and served over HTTP; every answer against the CPU plain
    predictor of the same artifact (``_qnn_against_cpu``). Returns (the
    results, {name: what times the served batch})."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )

    t = _fam_trainer(device, QNN_MODEL)
    row = t.train_epoch(data, 0)
    if not np.isfinite(row["train_loss"]):
        raise AssertionError(f"qnn training: {row}")
    path = os.path.join(tmp, "qnn.msgpack")
    info = export_packed(t.model, path)
    images = [torch.rand(n, 28, 28, 1, generator=gen) for n in FAM_REQUESTS]
    answers, counts = _serve_answers(path, device, images)
    fn, _ = load_packed(path, device=device)
    plain, _ = load_packed(path, device="cpu")
    out = {"train": {k: row[k] for k in ("train_loss", "steps")},
           "compression": info["compression"],
           **_qnn_against_cpu(fn, plain, images, answers),
           "launches": counts}
    print(json.dumps({"phase": 19, "qnn": out}), flush=True)
    xpad = _padded(images[0]).to(device)
    return out, {"served_batch_ms": lambda: _events_ms(lambda: fn(xpad),
                                                       iters=20)}


def _epoch_step_ms(t, data) -> float:
    """Wall-clock ms a step of one more eager epoch of trainer ``t``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = t.train_epoch(data, 1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / row["steps"] * 1e3


def _moe_check(device, gen, data, tmp: str) -> dict:
    """Phase 19 (b): ``bnn-moe-mlp`` on pallas_xnor: one step's logged
    loss is its CE plus the recorded aux loss (bitwise a twin's forward);
    8 steps eager against ``scan_steps=4`` (two captured graphs)
    bitwise, K1 9 times an eager step (8 experts and the head); then
    frozen, exported, loaded and served over HTTP, every answer
    ``torch.equal`` to the frozen path with K1's plain version on the
    card (padded batches: the padded rows take capacity slots), K1 9
    times a served batch. Returns (the results with the launch counts
    of the served and the eager training path, {name: what times the
    eager step, the captured step and the served batch})."""
    import copy

    from distributed_mnist_bnns_tpu_torch.data import batch_iterator
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops.losses import (
        cross_entropy_loss,
    )

    kw = dict(backend="pallas_xnor")
    t_aux = _fam_trainer(device, MOE_MODEL, **kw)
    xb, yb = next(iter(batch_iterator(data.train_images, data.train_labels,
                                      FAM_TRAIN["batch_size"])))
    xb = torch.from_numpy(np.ascontiguousarray(xb)).to(device)
    yb = torch.from_numpy(np.asarray(yb, np.int64)).to(device)
    twin = copy.deepcopy(t_aux.model).train()
    want = cross_entropy_loss(twin(xb), yb) + twin.aux_loss
    loss, _ = t_aux.train_step(t_aux.model, t_aux.optimizer, xb, yb)
    if not torch.equal(loss, want) or twin.aux_loss.item() <= 0:
        raise AssertionError(f"logged loss {loss.item()} against CE + aux "
                             f"{want.item()}")

    t_e = _fam_trainer(device, MOE_MODEL, **kw)
    t_s = _fam_trainer(device, MOE_MODEL, scan_steps=MOE_SCAN_STEPS, **kw)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    row = t_e.train_epoch(data, 0)
    torch.cuda.synchronize()
    train_counts = {name: _kernels.LAUNCHES[name] for name in KERNEL_ROWS}
    t_s.train_epoch(data, 0)
    _same_run("MoE scan_steps=4 against eager", t_e, t_s)
    steps = row["steps"]
    if train_counts["xnor"] != (MOE_E + 1) * steps:
        raise AssertionError(f"MoE training launched K1 "
                             f"{train_counts['xnor']} times in {steps} "
                             "eager steps, want 9 a step")
    scan = t_s._train_scan
    xs, ys = _chunk(data, 0, MOE_SCAN_STEPS, device,
                    FAM_TRAIN["batch_size"])
    xs, ys = xs.to(device), ys.to(device)

    path = os.path.join(tmp, "moe.msgpack")
    info = export_packed(t_e.model, path)
    images = [torch.rand(n, 28, 28, 1, generator=gen) for n in FAM_REQUESTS]
    answers, counts = _serve_answers(path, device, images)
    fn, _ = load_packed(path, device=device)
    for x, got in zip(images, answers):
        with torch.no_grad():
            want = _moe_plain(fn, _padded(x).to(device))[:len(x)].cpu()
        if not torch.equal(got, want):
            raise AssertionError("served MoE differs from the plain frozen "
                                 "path on the card")
    batches = len(FAM_REQUESTS)
    if counts["xnor"] != (MOE_E + 1) * batches:
        raise AssertionError(f"served MoE: K1 {counts['xnor']} launches, "
                             f"want {(MOE_E + 1) * batches}")
    out = {"train": {k: row[k] for k in ("train_loss", "steps")},
           "aux_loss": twin.aux_loss.item(),
           "compression": info["compression"],
           "capture": _graph_stats(t_s),
           "served_launches": counts, "train_launches": train_counts,
           "requests": batches}
    print(json.dumps({"phase": 19, "moe": out}), flush=True)
    xpad = _padded(images[0]).to(device)
    return out, {
        "eager_step_ms": lambda: _epoch_step_ms(t_e, data),
        "captured_step_ms": lambda: _events_ms(
            lambda: scan(t_s.model, t_s.optimizer, xs, ys),
            iters=5) / MOE_SCAN_STEPS,
        "served_batch_ms": lambda: _events_ms(lambda: fn(xpad), iters=20)}


def _fam_rank(rank: int, world: int, device, frozen: dict, seed: int):
    """Phase 19 (c) in each of 2 gloo ranks sharing the card: the
    expert-parallel MoE at full width against ``moe_reference`` (output
    and gradients), ``make_sharded_predictor`` of both frozen families
    against the per-shard forwards, and one step of the MoE at dp 2
    (global routing) and at tp 2 (experts sharded) against the unsharded
    step on the same parameters (rank 0 runs the references)."""
    import copy

    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch.infer import (
        _build_any,
        make_sharded_predictor,
    )
    from distributed_mnist_bnns_tpu_torch.interop import (
        frozen_from_jax,
        params_from_jax,
        train_state_to_jax,
    )
    from distributed_mnist_bnns_tpu_torch.models import (
        get_model,
        latent_clamp_mask,
    )
    from distributed_mnist_bnns_tpu_torch.parallel import (
        init_expert_params,
        make_expert_parallel_moe,
        moe_reference,
    )
    from distributed_mnist_bnns_tpu_torch.train import (
        TrainConfig,
        Trainer,
        make_optimizer,
        make_step_body,
    )

    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(seed)
    out = {}
    # expert parallelism: 64 tokens, 8 experts of 512 -> 512, top-2
    params = {k: v.to(device).requires_grad_(True) for k, v in
              init_expert_params(gen, MOE_E, MOE_D, MOE_D).items()}
    gate_w = (torch.randn(MOE_D, MOE_E, generator=gen) * 0.05).to(
        device).requires_grad_(True)
    x = torch.randn(64, MOE_D, generator=gen).to(device)
    cap = 16
    y = make_expert_parallel_moe(None, capacity=cap, k=2)(params, gate_w, x)
    (y ** 2).sum().backward()
    grads = [params["w"].grad, params["b"].grad, gate_w.grad]
    for g in grads:
        dist.all_reduce(g)
    rows = [torch.empty(y.shape) for _ in range(world)]
    dist.all_gather(rows, y.detach().cpu())
    if rank == 0:
        ref_p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
        ref_g = gate_w.detach().clone().requires_grad_(True)
        want = moe_reference(ref_p, ref_g, x, capacity=cap, n_shards=world,
                             k=2)
        (want ** 2).sum().backward()
        out["ep_out_err"] = (torch.cat(rows).to(device)
                             - want).abs().max().item()
        out["ep_grad_err"] = max(
            ((g - w).abs().max() / w.abs().max().clamp_min(1e-30)).item()
            for g, w in zip(grads, (ref_p["w"].grad, ref_p["b"].grad,
                                    ref_g.grad)))
    # the sharded predictor of both families
    images = torch.rand(world * MAIN_M, 28, 28, 1, generator=gen)
    for name, fz in frozen.items():
        fz = frozen_from_jax(fz)
        got = make_sharded_predictor(fz, device=device)(images.to(device))
        single = _build_any(fz, device)
        per = [single(images[i * MAIN_M:(i + 1) * MAIN_M].to(device))
               for i in range(world)]
        out[f"sharded_{name}_equal"] = bool(torch.equal(got, torch.cat(per)))
    # one step at dp 2 and at tp 2 against the unsharded step
    xs = torch.rand(64, 28, 28, 1, generator=gen)
    ys = torch.randint(0, 10, (64,), generator=gen)
    for mode, kw in (("dp", dict(data_parallel=2)),
                     ("tp", dict(tensor_parallel=2))):
        t = Trainer(TrainConfig(model=MOE_MODEL, batch_size=64,
                                optimizer="sgd", learning_rate=0.05,
                                backend="pallas_xnor", seed=0,
                                device=str(device), **kw))
        start = copy.deepcopy(train_state_to_jax(t))   # leaves alias
        xb, yb = (v.to(device) for v in (t._shard(xs), t._shard(ys)))
        loss, _ = t.train_step(t.model, t.optimizer, xb, yb)
        after = train_state_to_jax(t)
        if rank != 0:
            continue
        ref = params_from_jax(
            {k: start[k] for k in ("params", "batch_stats")},
            get_model(MOE_MODEL, backend="pallas_xnor")).to(device)
        opt = make_optimizer("sgd", ref.parameters(), 0.05)
        want_loss, _ = make_step_body(latent_clamp_mask(ref))(
            ref, opt, xs.to(device), ys.to(device))
        want = params_from_jax(
            {k: after[k] for k in ("params", "batch_stats")},
            get_model(MOE_MODEL)).to(device).state_dict()
        got = {k: v for k, v in ref.state_dict().items()
               if "num_batches" not in k}
        out[f"{mode}_state_err"] = max((want[k] - v).abs().max().item()
                                       for k, v in got.items())
        # the running variances reach ~1e2: an fp32 ulp there is 1.5e-5
        out[f"{mode}_state_close"] = all(
            torch.allclose(v, want[k], atol=FAM_RANK_ATOL,
                           rtol=FAM_RANK_ATOL) for k, v in got.items())
        out[f"{mode}_loss_err"] = abs(loss.item() - want_loss.item())
    out["s"] = time.perf_counter() - t0
    return out


def _fam_frozen(gen) -> dict:
    """Seeded full-width QNN and MoE with drawn BN statistics, frozen (the
    numpy artifacts the ranks serve)."""
    from distributed_mnist_bnns_tpu_torch.infer import _freeze_any, _to_cpu
    from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
    from distributed_mnist_bnns_tpu_torch.models import get_model

    out = {}
    qnn = get_model(QNN_MODEL, generator=gen).eval()
    _random_bn_stats(qnn, gen)
    moe = get_model(MOE_MODEL, generator=gen).eval()
    _draw_bn_stats(((moe.bn1, 784), (moe.bn2, MOE_D)), gen)
    for name, model in ((QNN_MODEL, qnn), (MOE_MODEL, moe)):
        out[name] = frozen_to_jax(_to_cpu(_freeze_any(model)))
    return out


def families_phase(device: torch.device, gen: torch.Generator):
    """Phase 19: K1 at the served MoE's shapes and the QNN's int8 GEMM
    (timed first), then 2 gloo ranks in the background under the
    in-process checks (a) the QNN and (b) the MoE, and (a)'s and (b)'s
    timings once the ranks have ended. Returns ({path: launch counts},
    K1's MoE rows)."""
    import distributed_mnist_bnns_tpu_torch.parallel as par
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    t0 = time.perf_counter()
    marks = {}
    k1_rows = _k1_moe_rows(device, gen)
    gemm_rows = _qnn_gemm_rows(device, gen)
    marks["timings"] = round(time.perf_counter() - t0, 1)
    frozen = _fam_frozen(gen)
    rank_join = _background(lambda: par.spawn(
        _fam_rank, FAM_RANKS, backend="gloo", device=device.type,
        args=(frozen, 19)))
    with tempfile.TemporaryDirectory() as tmp:
        try:
            data = load_mnist(os.path.join(tmp, "no-idx-files"),
                              synthetic_sizes=FAM_SYNTH, seed=0)
            qnn, qnn_timers = _qnn_check(device, gen, data, tmp)
            marks["a"] = round(time.perf_counter() - t0, 1)
            moe, moe_timers = _moe_check(device, gen, data, tmp)
            marks["b"] = round(time.perf_counter() - t0, 1)
        finally:
            ranks = rank_join()
        marks["c"] = round(time.perf_counter() - t0, 1)
        # timed alone: no rank shares the card or the host's cores
        timed = {"qnn": {k: f() for k, f in qnn_timers.items()},
                 "moe": {k: f() for k, f in moe_timers.items()}}
    marks["timed_alone"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": 19, "timed_alone": timed}), flush=True)
    r0 = ranks[0]
    print(json.dumps({"phase": 19, "ranks": r0,
                      "rank_s": [round(r["s"], 1) for r in ranks]}),
          flush=True)
    bad = [k for k, v in r0.items()
           if k.endswith(("_equal", "_close")) and not v]
    bad += [k for k in ("ep_out_err", "dp_loss_err", "tp_loss_err")
            if not r0[k] <= FAM_RANK_ATOL]
    if bad or not r0["ep_grad_err"] <= 1e-4:
        raise AssertionError(f"phase 19 ranks: {bad} {r0}")
    paths = {"moe": moe["served_launches"], "qnn": qnn["launches"],
             "moe_train": moe["train_launches"]}
    print(json.dumps({"phase": 19, "int8_gemm": gemm_rows,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return paths, k1_rows


RN_BATCH = 64                 # (a) xnor-resnet18 on CIFAR-10-shaped data
RN_STEPS = 20                 # eager steps a run; two runs, then captured
RN_SYNTH = (RN_STEPS * RN_BATCH, 256)
RN_SCAN = 4                   # steps a CUDA graph of the captured run
RN_MODEL_KW: dict = {}        # full width: stem 64, widths 64-512
RN_TRAIN = dict(model="xnor-resnet18", batch_size=RN_BATCH,
                optimizer="adam", learning_rate=0.01, seed=0,
                log_interval=RN_STEPS, backend="pallas_xnor", augment=True)
RN_SERVE_REQUESTS = 3         # (b) full micro-batches of MAIN_M images
RN_CIFAR = (32, 32, 3)
RN50_BATCH = 8                # (c) xnor-resnet50 on synthetic ImageNet
RN50_SIZE = 224
RN50_CLASSES = 1000
RN50_MODEL_KW: dict = {}      # full width: stem 64, widths 64-2048
RN_CLI_SYNTH = (256, 64)      # the CLI run: 4 steps of 64
# K1 at each stage's 3x3 conv of (a) at batch 64: (M, K, N); and at
# resnet50's stage-1 3x3 at a micro-batch of 32 (M = 100,352, the
# widest M the family gives K1)
RN18_K1 = ((64 * 32 * 32, 576, 64), (64 * 16 * 16, 1152, 128),
           (64 * 8 * 8, 2304, 256), (64 * 4 * 4, 4608, 512))
RN50_K1_WIDE = (32 * 56 * 56, 576, 64)
# K2 at resnet50's stage-1 and stage-4 conv0 (a block after the first:
# K = 4 x width) at the served micro-batch of 8
RN50_K2 = ((8 * 56 * 56, 256, 64), (8 * 7 * 7, 2048, 512))
TIE_ULPS = 8.0                # a threshold flip's allowance, in fp32 ulps
RN_CPU_IMAGES = 8             # (b)'s images walked on the CPU's plain path


def _rn_gemm_rows(device, gen) -> list:
    """(e) K1 at ``RN18_K1`` and ``RN50_K1_WIDE``, K2 at ``RN50_K2``, on ±1
    patches with zero taps (packed as -1) and drawn BN thresholds with
    exact ties: ``torch.equal`` to the plain versions, two runs equal;
    then CUDA-graph times of the kernel, its plain version and bf16
    ``torch.matmul``, with the bound. Timed first, with nothing else on
    the card or the host."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.ops import xnor_gemm as xg
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits

    cases = ([("xnor", s) for s in RN18_K1] + [("xnor", RN50_K1_WIDE)]
             + [("xnor_sign", s) for s in RN50_K2])
    rows = []
    for name, (m, k, n) in cases:
        w = _pm1(gen, k, n).to(device)
        wp, _, _ = xg.prepack_weights(w)
        x = (_pm1(gen, m, k) * (torch.rand(m, k, generator=gen) > 0.05)
             ).to(device)
        vecs = ()
        if name == "xnor":
            def entry():
                return xg.xnor_matmul_packed(x, wp, k, n)

            def plain():
                return xg.xnor_gemm_plain(pack_bits(x), wp, k)[:, :n]
        else:
            o_row = xg.xnor_gemm_plain(pack_bits(x[:1]), wp, k)[0, :n]
            vecs = tuple(v.to(device) for v in _sign_vectors(gen, n, o_row))

            def entry():
                return xg.xnor_matmul_packed_sign(x, wp, k, n, *vecs)

            def plain():
                return xg.xnor_sign_plain(pack_bits(x), wp, k,
                                          *vecs)[:, :n]
        got, again, want = entry(), entry(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(
                f"{name} at the resnet shape ({m}, {k}, {n}): max |diff| "
                f"{(got - want).abs().max().item()} from its plain version, "
                "or two runs differ")
        xb = x.to(torch.bfloat16)
        wb = w.to(torch.bfloat16)
        row = {"kernel": name, "path": "resnet", "m": m, "k": k, "n": n,
               "tiling": list(_kernels.xnor_tiling(m, k, n)),
               "kernel_ms": _graph_ms(lambda: _kernels.xnor_gemm(
                   name, x, wp, k, n, *vecs)),
               "plain_ms": _graph_ms(plain, iters=3, reps=3),
               "library_ms": _graph_ms(lambda: torch.matmul(xb, wb)),
               "library": "bf16 torch.matmul", "max_abs_err": 0.0}
        row["bound_ms"], row["bound_by"], row["bound_peak"] = _bound(
            name, m, k, n)
        print(json.dumps({"phase": 20, "gemm": row}), flush=True)
        rows.append(row)
    return rows


def _rn_trainer(device, **kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    cfg = dict(RN_TRAIN, epochs=1, device=str(device),
               model_kwargs=dict(RN_MODEL_KW))
    cfg.update(kw)
    return Trainer(TrainConfig(**cfg), input_shape=RN_CIFAR)


def _cli_resnet_row(tmp: str) -> dict:
    """``cli train --model xnor-resnet18 --dataset cifar10 --augment`` on
    ``pallas_xnor`` (synthetic CIFAR-10, 4 steps) in a process of its
    own: its JSON line."""
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", "xnor-resnet18",
            "--dataset", "cifar10", "--augment", "--backend", "pallas_xnor",
            "--epochs", "1", "--batch-size", str(RN_BATCH),
            "--log-interval", "1", "--seed", "0",
            "--data-dir", os.path.join(tmp, "no-cifar-files"),
            "--synthetic-sizes", *map(str, RN_CLI_SYNTH)]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"cli train --dataset cifar10 --augment exited "
                             f"{out.returncode}: {out.stderr[-2000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    if not (row["steps"] == RN_CLI_SYNTH[0] // RN_BATCH
            and np.isfinite(row["train_loss"])):
        raise AssertionError(f"cli train --dataset cifar10: {row}")
    return row


def _rn_train(device, data) -> dict:
    """(a) xnor-resnet18 on ``pallas_xnor`` with ``augment``: an eager
    epoch of ``RN_STEPS`` twice from one seed (bitwise equal; K1 16
    times a step), the same steps at ``scan_steps=RN_SCAN`` (bitwise the
    eager run), one ``bf16`` step, one step of ``fp32-resnet18``."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    out = {}
    _kernels.reset_launches()
    t1 = _rn_trainer(device)
    row = t1.train_epoch(data, 0)
    torch.cuda.synchronize()
    out["train_launches"] = dict(_kernels.LAUNCHES)
    if out["train_launches"]["xnor"] != 16 * RN_STEPS or any(
            c for k, c in out["train_launches"].items() if k != "xnor"):
        raise AssertionError(f"xnor-resnet18 training launched "
                             f"{out['train_launches']} in {RN_STEPS} steps")
    if not np.isfinite(row["train_loss"]):
        raise AssertionError(f"xnor-resnet18 training: {row}")
    t2 = _rn_trainer(device)
    t2.train_epoch(data, 0)
    if not _states_equal(_state(t1), _state(t2)):
        raise AssertionError("two augmented xnor-resnet18 runs from one "
                             "seed differ")
    t3 = _rn_trainer(device, scan_steps=RN_SCAN)
    t3.train_epoch(data, 0)
    scan = t3._train_scan
    if not _states_equal(_state(t1), _state(t3)):
        raise AssertionError("the captured augmented xnor-resnet18 run "
                             "differs from the eager one")
    one = _first_steps(data, 1, RN_BATCH)
    for model, backend in (("xnor-resnet18", "bf16"),
                           ("fp32-resnet18", "bf16")):
        t = _rn_trainer(device, model=model, backend=backend)
        r = t.train_epoch(one, 0)
        if r["steps"] != 1 or not np.isfinite(r["train_loss"]):
            raise AssertionError(f"{model} on {backend}: {r}")
        out[f"{model}_{backend}_loss"] = r["train_loss"]
    out.update({"train_loss": row["train_loss"], "steps": row["steps"],
                "eager_step_ms": row["batch_time_s"] * 1e3,
                "captured_k1_recorded": scan.recorded.get("xnor", 0),
                "captured_k1_ran": scan.ran.get("xnor", 0),
                "captures": scan.captures})
    return {"trainer": t1, "row": out}


def _frozen_walk(fn, x: torch.Tensor, given=None) -> dict:
    """``FrozenResNet.__call__``'s stages on (B, H, W, C) images: the stem
    (after the ImageNet stem's pool), and per block its input, the ±1
    bits at each BN threshold, each packed conv's output (a fused 1x1's
    is its next bits), the shortcut and the output; then the head's
    input and the logits. With ``given`` (another device's walk), each
    stage starts from that walk's inputs to it, so only the stage itself
    is compared."""
    from distributed_mnist_bnns_tpu_torch.infer_conv import (
        _fp32_conv_nhwc,
        _PackedConv1x1Sign,
    )
    from distributed_mnist_bnns_tpu_torch.models.resnet import max_pool_same

    dev = fn.device

    def src(key, mine):
        return mine if given is None else given[key].to(dev)

    with torch.no_grad():
        x = x.to(dev, torch.float32)
        h = _fp32_conv_nhwc(x, fn.stem_w, fn.stem_strides)
        if not fn.cifar_stem:
            h = max_pool_same(h.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out = {"stem": h}
        h = src("stem", h)
        for i, (pairs, shortcut) in enumerate(fn.blocks):
            y = h
            for j, (sign, conv) in enumerate(pairs):
                if sign is not None:
                    a, t = sign
                    bits = torch.where(a * y >= t, 1.0, -1.0)
                    out[f"b{i}.bits{j}"] = bits
                    y = src(f"b{i}.bits{j}", bits)
                y = conv(y)
                key = (f"b{i}.bits{j + 1}"
                       if isinstance(conv, _PackedConv1x1Sign)
                       else f"b{i}.conv{j}")
                out[key] = y
                y = src(key, y)
            s = h if shortcut is None else _fp32_conv_nhwc(h, *shortcut)
            out[f"b{i}.short"] = s
            h = y + src(f"b{i}.short", s)
            out[f"b{i}.out"] = h
            h = src(f"b{i}.out", h)
        head = torch.relu(fn.a_fin * h + fn.c_fin).mean(dim=(1, 2))
        out["head"] = head
        out["logits"] = src("head", head) @ fn.wh + fn.bh
    return out


def _conv_bound(x: torch.Tensor, w: torch.Tensor, strides) -> torch.Tensor:
    """The a-priori error bound of an fp32 SAME conv of x (B, H, W, C) by
    w (OIHW) summed in any order: gamma_K times the conv of |x| by |w|
    (in float64 on the CPU), (B, Ho, Wo, F)."""
    from distributed_mnist_bnns_tpu_torch.ops.xnor_gemm import (
        conv_pads,
        _pad_hw,
    )

    xa = x.detach().cpu().double().abs().permute(0, 3, 1, 2)
    wa = w.detach().cpu().double().abs()
    k = wa.shape[1] * wa.shape[2] * wa.shape[3]
    xp, pad = _pad_hw(xa, conv_pads("SAME", xa.shape[2:], wa.shape[2:],
                                    strides))
    return _gamma(k) * torch.nn.functional.conv2d(
        xp, wa, None, tuple(strides), pad).permute(0, 2, 3, 1)


def _head_bound(fn, h: torch.Tensor) -> torch.Tensor:
    """Twice the bound of the head's fp32 GEMM on inputs ``h`` (B, C):
    either side's sum in any order; (B, classes), float64 on the CPU."""
    wh = fn.wh.detach().cpu().double().abs()
    return 2 * _gamma(wh.shape[0] + 1) * (
        h.detach().cpu().double().abs() @ wh
        + fn.bh.detach().cpu().double().abs())


def _pool_bound(fn, last: torch.Tensor, mu=None) -> torch.Tensor:
    """The bound of the head's input (B, C) of two computations of
    ``relu(BN(last)).mean(H, W)`` from the same (B, H, W, C) ``last``:
    each BN within ``2 * TIE_ULPS`` ulps of |a x| + |a mu| + |c| (the
    live model's ``batch_norm`` and the frozen ``a x + c`` round
    differently; ``mu`` None: both are ``a x + c``, 4 ulps), relu
    1-Lipschitz, each mean within gamma_HW of its sum; float64 on the
    CPU."""
    x = last.detach().cpu().double()
    a, c = fn.a_fin.cpu().double(), fn.c_fin.cpu().double()
    terms = a.abs() * x.abs() + c.abs()
    if mu is not None:
        terms = terms + (a * mu.cpu().double()).abs()
    ulps = 4 if mu is None else 2 * TIE_ULPS
    hw = x.shape[1] * x.shape[2]
    return ((ulps * FP32_U * terms).mean(dim=(1, 2))
            + 2 * _gamma(hw) * torch.relu(a * x + c).mean(dim=(1, 2)))


def _final_bound(fn, last, head, mu=None) -> torch.Tensor:
    """The logits' bound from the last block's output on: the head input's
    (``_pool_bound``) through |W| plus the head GEMM's."""
    wh = fn.wh.detach().cpu().double().abs()
    return _pool_bound(fn, last, mu) @ wh + _head_bound(fn, head)


def _resnet_against_cpu(fn, plain, x: torch.Tensor) -> dict:
    """The card's frozen resnet against the CPU's plain predictor of the
    same artifact, stage by stage from the card's inputs: the thresholds,
    the packed convs (K1, K2 against their plain versions) and the block
    sums are exact given the same inputs, so bitwise; the stem and the
    shortcuts (fp32 convs) within gamma_K of |x|*|w|; the head's input
    within the final BN's, ReLU's and mean's rounding, the logits within
    the head GEMM's bound. Returns the worst fractions of the bounds."""
    from distributed_mnist_bnns_tpu_torch.models.resnet import max_pool_same

    card = _frozen_walk(fn, x)
    cpu = _frozen_walk(plain, x.cpu(), given={k: v.cpu()
                                              for k, v in card.items()})
    worst = {"stem": 0.0, "short": 0.0, "head": 0.0, "logits": 0.0}
    for key, got in card.items():
        want = cpu[key]
        if ".bits" in key or ".conv" in key or key.endswith(".out"):
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"frozen resnet stage {key}: the card "
                                     "and the CPU differ on the same input")
            continue
        diff = (got.cpu().double() - want.double()).abs()
        if key == "stem":
            bound = _conv_bound(x, plain.stem_w, plain.stem_strides)
            if not plain.cifar_stem:   # |max a - max b| <= max |a - b|
                bound = max_pool_same(bound.permute(0, 3, 1, 2)).permute(
                    0, 2, 3, 1)
            slot = "stem"
        elif key.endswith(".short"):
            i = int(key[1:key.index(".")])
            sc = plain.blocks[i][1]
            if sc is None:   # the identity: the same tensor
                bound = torch.zeros_like(diff)
            else:
                src = card["stem"] if i == 0 else card[f"b{i - 1}.out"]
                bound = _conv_bound(src, *sc)
            slot = "short"
        elif key == "head":
            bound = _pool_bound(plain, card[f"b{len(plain.blocks) - 1}.out"])
            slot = "head"
        else:   # the logits
            bound = _head_bound(plain, card["head"])
            slot = "logits"
        worst[slot] = max(worst[slot], (diff / bound.clamp_min(
            1e-300)).max().item())
        if not bool((diff <= bound).all()):
            raise AssertionError(f"frozen resnet {key}: the card's beyond "
                                 "fp32's bound of the CPU's")
    return {"stages": len(card), "bound_fraction": worst}


def _resnet_against_live(fn, live, x: torch.Tensor) -> dict:
    """The frozen resnet against the live model's eval forward on the
    same card, stage by stage on the live model's activations: each BN
    -> sign of the live model (``binarize_ste`` of its BatchNorm)
    against the frozen threshold compare on the same pre-activation (a
    flip must be a tie: |BN(y)| within ``TIE_ULPS`` ulps of its terms),
    the packed convs bitwise given the live model's bits, the stem and
    the shortcuts (fp32 convs) within twice gamma_K of |x|*|w|, the head
    stage within its fp32 bound. Then end to end: the argmax equal.
    Returns the flips, the worst fractions of the bounds and the largest
    logit difference."""
    from distributed_mnist_bnns_tpu_torch.infer_conv import (
        _fp32_conv_nhwc,
        _PackedConv1x1Sign,
    )
    from distributed_mnist_bnns_tpu_torch.models.layers import nhwc_input
    from distributed_mnist_bnns_tpu_torch.models.resnet import max_pool_same
    from distributed_mnist_bnns_tpu_torch.ops.binarize import binarize_ste

    live = live.eval()
    flips, tie_frac, blocks_equal = 0, 0.0, 0
    conv_frac = 0.0

    def fp32_conv(got_nhwc, want_nchw, src_nhwc, w, strides):
        nonlocal conv_frac
        d = (got_nhwc.cpu().double()
             - want_nchw.permute(0, 2, 3, 1).cpu().double()).abs()
        bound = 2 * _conv_bound(src_nhwc, w, strides)
        conv_frac = max(conv_frac, (d / bound.clamp_min(1e-300)).max().item())
        if not bool((d <= bound).all()):
            raise AssertionError("a frozen resnet fp32 conv beyond fp32's "
                                 "bound of the live one")

    with torch.no_grad():
        h = live.stem(nhwc_input(x))
        fp32_conv(_fp32_conv_nhwc(x, fn.stem_w, fn.stem_strides), h, x,
                  fn.stem_w, fn.stem_strides)
        if not live.cifar_stem:
            h = max_pool_same(h)
        for blk, (pairs, shortcut) in zip(live.blocks, fn.blocks):
            xin = h
            if shortcut is not None:
                xn = xin.permute(0, 2, 3, 1)
                fp32_conv(_fp32_conv_nhwc(xn, *shortcut), blk.shortcut(xin),
                          xn, *shortcut)
            y = h
            block_flips = 0
            nxt = None     # a fused conv's bits, checked at the next pair
            for j, (sign, conv) in enumerate(pairs):
                bn = getattr(blk, f"bn{j}")
                z = bn(y)
                want = binarize_ste(z)
                if nxt is not None:   # the previous conv's K2 bits
                    got = nxt
                else:
                    a, t = sign
                    got = torch.where(a * y.permute(0, 2, 3, 1) >= t,
                                      1.0, -1.0)
                wrong = got != want.permute(0, 2, 3, 1)
                if bool(wrong.any()):
                    g = bn.weight.abs()[None, :, None, None]
                    s = torch.sqrt(bn.running_var + bn.eps)[None, :, None,
                                                            None]
                    tie = TIE_ULPS * FP32_U * (
                        (y.abs() + bn.running_mean.abs()[None, :, None, None])
                        * g / s + bn.bias.abs()[None, :, None, None])
                    zz = z.abs().permute(0, 2, 3, 1)[wrong]
                    tt = tie.permute(0, 2, 3, 1)[wrong]
                    tie_frac = max(tie_frac, (zz / tt).max().item())
                    if not bool((zz <= tt).all()):
                        raise AssertionError(
                            "a frozen resnet threshold disagrees with the "
                            "live BatchNorm's sign beyond a tie")
                    block_flips += int(wrong.sum())
                conv_live = getattr(blk, f"conv{j}")
                y_live = conv_live(want)
                if isinstance(conv, _PackedConv1x1Sign):
                    nxt = conv(want.permute(0, 2, 3, 1))
                else:
                    nxt = None
                    y_frz = conv(want.permute(0, 2, 3, 1))
                    if not torch.equal(y_frz, y_live.permute(0, 2, 3, 1)):
                        raise AssertionError("a frozen resnet conv differs "
                                             "from the live one on the same "
                                             "bits")
                y = y_live
            h = blk(xin)
            if block_flips == 0:
                blocks_equal += 1
            flips += block_flips
        head_live = torch.relu(live.bn(h)).mean(dim=(2, 3))
        hn = h.permute(0, 2, 3, 1)
        head_frz = torch.relu(fn.a_fin * hn + fn.c_fin).mean(dim=(1, 2))
        bound = _final_bound(fn, hn, head_live, mu=live.bn.running_mean)
        d = (live.head(head_live) - (head_frz @ fn.wh + fn.bh)).abs()
        head_frac = (d.cpu().double() / bound).max().item()
        if head_frac > 1.0:
            raise AssertionError("frozen resnet's head stage beyond its "
                                 "fp32 bound of the live model's")
        e2e_live = live(x)
        e2e_frz = fn(x)
    diff = (e2e_live - e2e_frz).abs().max().item()
    if not torch.equal(e2e_live.argmax(-1), e2e_frz.argmax(-1)):
        raise AssertionError(f"frozen resnet vs live: argmax differs "
                             f"({flips} threshold flips)")
    return {"threshold_flips": flips, "blocks_without_flip": blocks_equal,
            "flip_over_tie_bound": tie_frac,
            "fp32_conv_over_bound": conv_frac,
            "head_stage_over_bound": head_frac,
            "max_abs_logit_diff": diff}


def _rn_serve(device, trainer, data, tmp: str) -> dict:
    """(b) The trained xnor-resnet18 exported, loaded and served over
    HTTP at a micro-batch of ``MAIN_M``, ``RN_SERVE_REQUESTS`` full
    batches: K1 16 times a batch (the warm-up's included), each answer
    ``torch.equal`` to the predictor on its batch, held to the live eval
    model (``_resnet_against_live``) and to the CPU
    (``_resnet_against_cpu``)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    path = os.path.join(tmp, "resnet18.msgpack")
    info = export_packed(trainer.model, path, input_shape=RN_CIFAR)
    batches = [torch.from_numpy(data.test_images[i * MAIN_M:(i + 1) * MAIN_M])
               for i in range(RN_SERVE_REQUESTS)]
    srv = PackedInferenceServer(ServeConfig(
        artifact=path, device=str(device), port=0, batch_size=MAIN_M,
        queue_depth=8, default_deadline_ms=60000.0, input_shape=RN_CIFAR))
    _kernels.reset_launches()
    host, port = srv.start()
    answers = []
    try:
        for xb in batches:
            code, body = sc.predict(f"http://{host}:{port}", xb.tolist())
            if code != 200:
                raise AssertionError(f"/predict: {code} {body[:200]!r}")
            answers.append(torch.tensor(json.loads(body)["log_probs"]))
        torch.cuda.synchronize()
        served = dict(_kernels.LAUNCHES)
    finally:
        srv.request_stop("smoke over")
        stats = srv.drain_and_stop()
    n_batches = stats["batches_total"] + 1   # + the warm-up call
    if served["xnor"] != 16 * n_batches or any(
            c for k, c in served.items() if k != "xnor"):
        raise AssertionError(f"served xnor-resnet18: {served} for "
                             f"{n_batches} batches")
    fn, _ = load_packed(path, device=device)
    plain, _ = load_packed(path, device="cpu")
    for xb, got in zip(batches, answers):
        if not torch.equal(got, fn(xb).cpu()):
            raise AssertionError("a served resnet answer differs from the "
                                 "predictor on its batch")
    live = _resnet_against_live(fn, trainer.model,
                                torch.cat(batches).to(device))
    cpu = _resnet_against_cpu(fn, plain, batches[0][:RN_CPU_IMAGES])
    xpad = batches[0].to(device)
    return {"served_launches": served, "served_batches": n_batches,
            "compression": info["compression"], "vs_live": live,
            "vs_cpu": cpu, "predictor": fn, "x": xpad}


def _rn50_check(device, gen, tmp: str) -> dict:
    """(c) xnor-resnet50 (ImageNet stem, stages (3, 4, 6, 3)) on
    synthetic ImageNet at ``RN50_SIZE``: 2 steps at batch
    ``RN50_BATCH`` on ``pallas_xnor``; frozen; a served micro-batch of 8
    through the predictor: 16 K2 and 32 K1 launches, from counters set
    to 0 before; held to the live eval model; the export's bytes equal a
    fresh export's and survive a load and re-serialization."""
    from distributed_mnist_bnns_tpu_torch.data import load_imagenet
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_frozen,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.utils import msgpack

    shape = (RN50_SIZE, RN50_SIZE, 3)
    data = load_imagenet(os.path.join(tmp, "no-imagenet"),
                         image_size=RN50_SIZE,
                         synthetic_sizes=(2 * RN50_BATCH, RN50_BATCH),
                         synthetic_classes=RN50_CLASSES, seed=0)
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    t = Trainer(TrainConfig(**dict(
        RN_TRAIN, model="xnor-resnet50", batch_size=RN50_BATCH, epochs=1,
        device=str(device), log_interval=1,
        model_kwargs=dict(RN50_MODEL_KW, num_classes=RN50_CLASSES))),
        input_shape=shape)
    _kernels.reset_launches()
    row = t.train_epoch(data, 0)
    torch.cuda.synchronize()
    train_launches = dict(_kernels.LAUNCHES)
    n_binconv = 16 * 3
    if row["steps"] != 2 or not np.isfinite(row["train_loss"]) or (
            train_launches["xnor"] != n_binconv * 2):
        raise AssertionError(f"xnor-resnet50 training: {row} "
                             f"{train_launches}")
    p1, p2 = (os.path.join(tmp, f"r50_{i}.msgpack") for i in (1, 2))
    info = export_packed(t.model, p1, input_shape=shape)
    export_packed(t.model, p2, input_shape=shape)
    with open(p1, "rb") as f1, open(p2, "rb") as f2:
        b1, b2 = f1.read(), f2.read()
    again = msgpack.msgpack_serialize(frozen_to_jax(load_frozen(p1)))
    if not (b1 == b2 == again):
        raise AssertionError("xnor-resnet50 artifact bytes differ between "
                             "exports or after a load")
    fn, _ = load_packed(p1, device=device)
    x = torch.from_numpy(data.test_images[:RN50_BATCH]).to(device)
    fn(x)
    torch.cuda.synchronize()
    _kernels.reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    served = dict(_kernels.LAUNCHES)
    if (served["xnor"], served["xnor_sign"]) != (32, 16) or any(
            c for k, c in served.items() if k not in ("xnor", "xnor_sign")):
        raise AssertionError(f"a resnet50 batch of {RN50_BATCH} launched "
                             f"{served}")
    if not bool(torch.isfinite(out).all()) or out.shape != (
            RN50_BATCH, RN50_CLASSES):
        raise AssertionError(f"resnet50 predictor output {out.shape}")
    live = _resnet_against_live(fn, t.model, x)
    return {"train": {"loss": row["train_loss"], "steps": row["steps"],
                      "step_ms": row["batch_time_s"] * 1e3},
            "train_launches": train_launches, "served_launches": served,
            "compression": info["compression"], "artifact_bytes": len(b1),
            "vs_live": live, "predictor": fn, "x": x}


def _rn_stream(device, tmp: str) -> dict:
    """(d) ``Trainer.fit_stream`` over a folder of 16 PNGs in 4 classes
    (train) and 8 (val), written here, decoded at 32 x 32; or, without
    PIL on this host, where the stream is held instead."""
    try:
        from PIL import Image
    except ImportError:
        return {"pil": False, "held_in": "tests/test_torch_imagenet.py "
                                         "(CPU; PIL there)"}
    from distributed_mnist_bnns_tpu_torch.data import (
        ImageClassData,
        open_imagenet_stream,
    )

    root = os.path.join(tmp, "imagenet-folder")
    rng = np.random.RandomState(20)
    for split, n in (("train", 4), ("val", 2)):
        for c in range(4):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(n):
                Image.fromarray(rng.randint(0, 256, (40, 48, 3), np.uint8)
                                ).save(os.path.join(d, f"{i}.png"))
    stream = open_imagenet_stream(root, "train", image_size=32, workers=2)
    val = open_imagenet_stream(root, "val", image_size=32, workers=2,
                               wnids=stream.index.wnids)
    vx, vy = val.materialize(None)
    eval_data = ImageClassData(np.zeros((1, 32, 32, 3), np.float32),
                               np.zeros(1, np.int32), vx, vy,
                               n_classes=stream.n_classes)
    t = _rn_trainer(device, batch_size=8, log_interval=1,
                    model_kwargs=dict(RN_MODEL_KW, num_classes=4))
    hist = t.fit_stream(stream, eval_data=eval_data)
    if len(hist) != 1 or hist[0]["steps"] != 2 or not np.isfinite(
            hist[0]["train_loss"]):
        raise AssertionError(f"fit_stream: {hist}")
    return {"pil": True, "train_images": len(stream),
            "history": {k: hist[0][k] for k in ("train_loss", "steps",
                                                "test_acc")}}


def resnet_phase(device: torch.device, gen: torch.Generator):
    """Phase 20: the XNOR-ResNet family. (e) K1 and K2 at the family's
    shapes, timed first; then ``cli train --dataset cifar10 --augment``
    in the background under (a) xnor-resnet18 trained (eager twice,
    captured, bf16, fp32 twin), (b) frozen and served, (c) xnor-resnet50
    trained two steps, frozen, a micro-batch served, (d) ``fit_stream``;
    the served batches and the steps are timed once the CLI process has
    ended. Returns ({path: launch counts}, the GEMM rows)."""
    from distributed_mnist_bnns_tpu_torch.data import load_cifar10

    t0 = time.perf_counter()
    marks = {}
    rows = _rn_gemm_rows(device, gen)
    marks["e"] = round(time.perf_counter() - t0, 1)
    with tempfile.TemporaryDirectory() as tmp:
        cli_join = _background(lambda: _cli_resnet_row(tmp))
        try:
            data = load_cifar10(os.path.join(tmp, "no-cifar-files"),
                                synthetic_sizes=RN_SYNTH, seed=0)
            trained = _rn_train(device, data)
            marks["a"] = round(time.perf_counter() - t0, 1)
            serve = _rn_serve(device, trained["trainer"], data, tmp)
            marks["b"] = round(time.perf_counter() - t0, 1)
            r50 = _rn50_check(device, gen, tmp)
            marks["c"] = round(time.perf_counter() - t0, 1)
            stream = _rn_stream(device, tmp)
            marks["d"] = round(time.perf_counter() - t0, 1)
        finally:
            cli = cli_join()
        marks["cli"] = round(time.perf_counter() - t0, 1)
        # timed alone: the CLI process has ended
        fn18, x18 = serve.pop("predictor"), serve.pop("x")
        fn50, x50 = r50.pop("predictor"), r50.pop("x")
        timed = {"served_resnet18_batch_ms": _events_ms(lambda: fn18(x18),
                                                        iters=10),
                 "served_resnet50_batch_ms": _events_ms(lambda: fn50(x50),
                                                        iters=10),
                 "eager_step_ms": _epoch_step_ms(trained["trainer"], data)}
    marks["timed_alone"] = round(time.perf_counter() - t0, 1)
    train_row = trained["row"]
    print(json.dumps({"phase": 20, "train": train_row, "serve": serve,
                      "resnet50": r50, "stream": stream,
                      "cli": {k: cli[k] for k in ("train_loss", "steps",
                                                  "data_source")},
                      "timed_alone": timed}, default=str), flush=True)
    paths = {"resnet": {k: serve["served_launches"][k]
                        + r50["served_launches"][k]
                        for k in serve["served_launches"]},
             "resnet_train": {k: train_row["train_launches"][k]
                              + r50["train_launches"][k]
                              for k in train_row["train_launches"]}}
    print(json.dumps({"phase": 20, "launches": paths,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return paths, rows


NATIVE_SYNTH = (4096, 512)    # (a) a BatchPool epoch over 64 batches
NATIVE_PACK = (4096, 784)     # (a) pack_bits_native's (rows, K)
SAN_SYNTH = (2048, 256)       # (b) 32 steps of 64: 4 captured chunks of 8
SAN_SCAN = 8
FLEET_REPLICAS = 2            # (c), (d): replicas on the one card
FLEET_FULL = 4                # (c) full micro-batches, each held bitwise
FLEET_KILL_REQUESTS = 24      # (c) requests in flight while one dies
FLEET_LATENCY_N = 20          # (c) 1-image requests: router, then direct
FLEET_LM_REQUESTS = ((5, 12), (17, 12), (40, 8), (16, 8), (100, 6))
FLEET_BOOT_S = 300.0          # a fleet's replicas live, at most
AUG_STEPS = 8                 # (e) augmented steps of 64, eager and in
AUG_SCAN = 4                  # graphs of 4 steps
PROC_DEVICE = "cuda"          # --device of phase 21's processes


def _native_check(tmp: str) -> dict:
    """Phase 21 (a): the native library builds from the checkout's
    sources with ``g++`` and loads (no fallback); a BatchPool epoch is
    the numpy iterator's batches bitwise, in order; ``pack_bits_native``
    is ``pack_bits_np`` bitwise; an idx file and a CIFAR-10 binary batch
    decode natively to their bytes."""
    import struct

    from distributed_mnist_bnns_tpu_torch import native
    from distributed_mnist_bnns_tpu_torch.data import (
        batch_iterator,
        load_mnist,
        native_batch_iterator,
        shard_indices,
    )
    from distributed_mnist_bnns_tpu_torch.ops.bitpack import pack_bits_np

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 21: the native library did not build "
                             "or load (g++ on this machine?)")
    build_s = time.perf_counter() - t0
    data = load_mnist(os.path.join(tmp, "no-mnist-files"),
                      synthetic_sizes=NATIVE_SYNTH, seed=0)
    x, y = data.train_images, data.train_labels
    idx = shard_indices(len(y), epoch=1, seed=42)
    t0 = time.perf_counter()
    pool = native.BatchPool.create(x, y, idx, 64, n_threads=4, n_slots=8)
    if pool is None:
        raise AssertionError("phase 21: BatchPool.create fell back")
    with pool:
        got = list(pool)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = list(batch_iterator(x, y, 64, epoch=1, seed=42))
    numpy_s = time.perf_counter() - t0
    through = list(native_batch_iterator(x, y, 64, epoch=1, seed=42))
    if not (len(got) == len(want) == len(through) == len(y) // 64):
        raise AssertionError(f"phase 21: {len(got)} pool batches, "
                             f"{len(want)} numpy ones")
    for (gi, gl), (ti, tl), (wi, wl) in zip(got, through, want):
        if not (gi.tobytes() == ti.tobytes() == wi.tobytes()
                and gl.tobytes() == tl.tobytes() == wl.tobytes()):
            raise AssertionError("phase 21: a BatchPool batch differs from "
                                 "the numpy iterator's")
    rng = np.random.RandomState(21)
    pm1 = np.where(rng.rand(*NATIVE_PACK) > 0.5, 1.0, -1.0).astype(
        np.float32)
    if native.pack_bits_native(pm1).tobytes() != pack_bits_np(pm1).tobytes():
        raise AssertionError("phase 21: pack_bits_native differs from "
                             "pack_bits_np")
    u8 = rng.randint(0, 256, (16, 28, 28)).astype(np.uint8)
    path = os.path.join(tmp, "t-idx3-ubyte")
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x803) + struct.pack(">3I", *u8.shape)
                + u8.tobytes())
    rec = rng.randint(0, 256, (6, 3073)).astype(np.uint8)
    rec[:, 0] %= 10
    rec.tofile(os.path.join(tmp, "data_batch_1.bin"))
    images, labels = native.cifar_bin_decode_native(
        os.path.join(tmp, "data_batch_1.bin"), 6)
    if (native.load_idx_native(path).tobytes() != u8.tobytes()
            or images.tobytes() != rec[:, 1:].reshape(-1, 3, 32, 32)
            .transpose(0, 2, 3, 1).tobytes()
            or labels.tolist() != rec[:, 0].tolist()):
        raise AssertionError("phase 21: a native decode differs")
    log(f"native: built and loaded in {build_s:.2f} s; a {len(got)}-batch "
        "epoch, packed bits and decodes bitwise numpy's")
    return {"available": True, "library": os.path.basename(native.lib_path()),
            "build_load_s": build_s, "pool_epoch_s": native_s,
            "numpy_epoch_s": numpy_s, "batches": len(got)}


def _sanitized_cli(tmp: str) -> dict:
    """Phase 21 (b), a process of its own: ``cli train --sanitize
    recompile,nan`` captured (``--scan-steps 8``, K1 on ``pallas_xnor``)
    over the native loader; no fence trips, and no trip in its log."""
    tel = os.path.join(tmp, "sanitized")
    argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "--log-level", "WARNING", "train", "--model", "bnn-mlp-large",
            "--epochs", "1", "--batch-size", "64", "--lr", "0.01",
            "--backend", "pallas_xnor", "--synthetic-sizes",
            *map(str, SAN_SYNTH), "--scan-steps", str(SAN_SCAN),
            "--native-loader", "--sanitize", "recompile,nan",
            "--nan-check-every", str(SAN_SCAN), "--telemetry-dir", tel,
            "--device", PROC_DEVICE]
    out = subprocess.run(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"sanitized cli train exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    row = json.loads(out.stdout.strip().splitlines()[-1])
    with open(os.path.join(tel, "events.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    if "sanitizer_trip" in kinds or row["total_steps"] != SAN_SYNTH[0] // 64:
        raise AssertionError(f"phase 21: the sanitized run tripped or cut "
                             f"short: {row}, {kinds.count('sanitizer_trip')} "
                             "trips")
    return {k: row[k] for k in ("train_loss", "total_steps", "data_source")}


def _nan_trip(device, tmp: str) -> dict:
    """Phase 21 (b): a poisoned run (a NaN learning rate: NaN parameters,
    a NaN loss on the next step) is stopped by the NaN fence, with the
    ``sanitizer_trip`` event in its log."""
    from distributed_mnist_bnns_tpu_torch.analysis import NaNFenceError
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    tel = os.path.join(tmp, "poisoned")
    data = load_mnist(os.path.join(tmp, "no-mnist-files"),
                      synthetic_sizes=(512, 64), seed=0)
    t = Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=1,
        batch_size=64, learning_rate=float("nan"), sanitize="nan",
        nan_check_every=1, telemetry_dir=tel, log_interval=1,
        backend="pallas_xnor", device=str(device)))
    try:
        t.fit(data, eval_every=0)
    except NaNFenceError as e:
        error = str(e)
    else:
        raise AssertionError("phase 21: the NaN fence let a NaN loss pass")
    with open(os.path.join(tel, "events.jsonl")) as f:
        trips = [e for e in map(json.loads, f) if e["kind"] ==
                 "sanitizer_trip"]
    if len(trips) != 1 or trips[0]["fence"] != "nan":
        raise AssertionError(f"phase 21: trip events {trips}")
    return {"tripped_at_step": trips[0]["step"], "error": error[:80]}


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get_json(url: str, timeout: float = 10.0):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_json(url: str, body: dict, timeout: float = 120.0):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class _Fleet:
    """A ``cli fleet`` process on a free port, its log in ``tmp``; the
    replicas it runs are its children."""

    def __init__(self, tmp: str, name: str, artifact: str, extra):
        self.port = _free_port()
        self.base = f"http://127.0.0.1:{self.port}"
        self.tel = os.path.join(tmp, name)
        self.log_path = os.path.join(tmp, f"{name}.log")
        argv = [sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
                "fleet", "--artifact", artifact,
                "--replicas", str(FLEET_REPLICAS),
                "--min-replicas", str(FLEET_REPLICAS),
                "--max-replicas", str(FLEET_REPLICAS), "--no-autoscale",
                "--port", str(self.port), "--device", PROC_DEVICE,
                "--telemetry-dir", self.tel, "--boot-timeout-s",
                str(FLEET_BOOT_S), "--drain-timeout-s", "120", *extra]
        self.t0 = time.perf_counter()
        self.log_file = open(self.log_path, "w")
        self.proc = subprocess.Popen(
            argv, cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=self.log_file, stderr=subprocess.STDOUT)

    def health(self) -> dict:
        return _get_json(self.base + "/healthz")

    def wait_live(self, n: int, exclude=()) -> tuple:
        """Wait until ``n`` replicas are live, none of them in
        ``exclude``; (seconds waited, the healthz)."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < FLEET_BOOT_S:
            if self.proc.poll() is not None:
                raise AssertionError(f"cli fleet exited {self.proc.returncode}"
                                     f": {self.tail()}")
            try:
                h = self.health()
            except OSError:
                h = None
            if h is not None:
                live = [r for r in h["replicas"] if r["healthy"]]
                if (len(live) >= n and not
                        {r["id"] for r in live} & set(exclude)):
                    return time.perf_counter() - t0, h
            time.sleep(0.5)
        raise AssertionError(f"phase 21: {n} replicas never went live: "
                             f"{self.tail()}")

    def replica_pid(self, url: str) -> int:
        """The pid of the replica serving ``url`` (a child of the fleet
        process, found through /proc)."""
        port = url.rsplit(":", 1)[1].strip("/")
        task = f"/proc/{self.proc.pid}/task"
        for tid in os.listdir(task):
            with open(f"{task}/{tid}/children") as f:
                for pid in f.read().split():
                    with open(f"/proc/{pid}/cmdline", "rb") as c:
                        argv = c.read().split(b"\0")
                    if b"serve" in argv and port.encode() in argv:
                        return int(pid)
        raise AssertionError(f"phase 21: no replica process for {url}")

    def launches(self) -> dict:
        """Every live replica's kernel launches, from its /metrics."""
        from distributed_mnist_bnns_tpu_torch.ops import _kernels

        total = {name: 0 for name in _kernels.LAUNCHES}
        for row in self.health()["replicas"]:
            snap = _get_json(row["url"] + "/metrics")
            for s in snap.get("kernel_launches_total", {}).get("series", []):
                total[s["labels"]["kernel"]] += int(s["value"])
        return total

    def drain(self) -> dict:
        """SIGTERM: the fleet drains every replica and exits 0."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=240)
        self.log_file.close()
        with open(os.path.join(self.tel, "events.jsonl")) as f:
            drains = [e for e in map(json.loads, f) if e["kind"] == "drain"]
        if rc != 0 or len(drains) != 1 or any(
                v != 0 for v in drains[0]["replica_rcs"].values()):
            raise AssertionError(f"phase 21: the fleet's drain: rc {rc}, "
                                 f"{drains}: {self.tail()}")
        print(json.dumps({"process": f"cli fleet {os.path.basename(self.tel)}",
                          "s": round(time.perf_counter() - self.t0, 1)}),
              flush=True)
        return {"rc": rc, "drain_s": time.perf_counter() - t0,
                "replica_rcs": drains[0]["replica_rcs"]}

    def stop(self) -> None:
        """On a failure: end the fleet and any replica it leaves."""
        if self.proc.poll() is None:
            kids = []
            try:
                task = f"/proc/{self.proc.pid}/task"
                for tid in os.listdir(task):
                    with open(f"{task}/{tid}/children") as f:
                        kids += [int(p) for p in f.read().split()]
            except OSError:
                pass
            self.proc.terminate()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            for pid in kids:
                try:
                    os.kill(pid, 9)
                except OSError:
                    pass
        if not self.log_file.closed:
            self.log_file.close()

    def tail(self) -> str:
        self.log_file.flush()
        with open(self.log_path) as f:
            return f.read()[-3000:]


def _classifier_fleet(device, gen, tmp: str) -> dict:
    """Phase 21 (c): ``cli fleet`` over 2 ``cli serve`` replicas of the
    frozen ``bnn-mlp-large`` on the one card. Full micro-batches through
    the router, bitwise the in-process predictor's; one replica killed
    under traffic, every request answered 200 and the supervisor's
    replacement live; a bad artifact rolled out and rolled back, answers
    unchanged; the router's latency over a direct replica; the replicas'
    kernel launches from their /metrics; a SIGTERM drain."""
    import signal

    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model
    from distributed_mnist_bnns_tpu_torch.serve import client

    model = get_model("bnn-mlp-large", generator=gen)
    _random_bn_stats(model, gen)
    path = os.path.join(tmp, "fleet_model.msgpack")
    export_packed(model.eval(), path)
    bad = os.path.join(tmp, "bad.msgpack")
    with open(bad, "wb") as f:
        f.write(b"not an artifact" * 64)
    fn, _ = load_packed(path, device=device)
    xs = [(torch.randint(0, 256, (MAIN_M, 28, 28, 1), generator=gen)
           / 256.0).numpy() for _ in range(FLEET_FULL)]
    want = [fn(x).cpu().numpy().tobytes() for x in xs]
    marks = {}
    fleet = _Fleet(tmp, "fleet", path, ["--deadline-ms", "30000",
                                        "--replica-arg=--stall-timeout-s",
                                        "--replica-arg=30"])

    def predict(x, base=None):
        code, body = client.predict(base or fleet.base, x.tolist(),
                                    deadline_ms=30000.0, timeout=120.0)
        if code != 200:
            raise AssertionError(f"phase 21: /predict {code} {body[:300]!r}")
        return np.asarray(json.loads(body)["log_probs"], np.float32)

    def check_bitwise(what):
        for i, x in enumerate(xs):
            if predict(x).tobytes() != want[i]:
                raise AssertionError(f"phase 21: {what}: a routed batch "
                                     "differs from the predictor")

    try:
        marks["boot_s"], h = fleet.wait_live(FLEET_REPLICAS)
        check_bitwise("first answers")
        one = xs[0][:1]
        lat = {"router": [], "direct": []}
        direct = h["replicas"][0]["url"]
        for _ in range(FLEET_LATENCY_N):
            for key, base in (("router", fleet.base), ("direct", direct)):
                t0 = time.perf_counter()
                predict(one, base)
                lat[key].append((time.perf_counter() - t0) * 1e3)
        # kill one replica while requests are in flight
        victim = h["replicas"][0]
        pid = fleet.replica_pid(victim["url"])
        codes = []

        def traffic():
            for i in range(FLEET_KILL_REQUESTS):
                codes.append(client.predict(
                    fleet.base, xs[i % FLEET_FULL][:4].tolist(),
                    deadline_ms=30000.0, timeout=120.0)[0])
                time.sleep(0.05)

        sender = threading.Thread(target=traffic)
        sender.start()
        time.sleep(0.3)
        t_kill = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        sender.join()
        if codes != [200] * FLEET_KILL_REQUESTS:
            raise AssertionError(f"phase 21: requests lost around the kill: "
                                 f"{codes}")
        marks["respawn_s"], h = fleet.wait_live(FLEET_REPLICAS,
                                                exclude=(victim["id"],))
        marks["respawn_s"] = time.perf_counter() - t_kill
        check_bitwise("after the respawn")
        code, rollout = _post_json(fleet.base + "/admin/rollout",
                                   {"artifact": bad})
        if code != 200 or rollout.get("status") != "rolled_back":
            raise AssertionError(f"phase 21: the bad rollout: {code} "
                                 f"{rollout}")
        check_bitwise("after the rollback")
        time.sleep(2.5)   # a scrape after the last request
        launches = fleet.launches()
        merged = _get_json(fleet.base + "/metrics").get(
            "kernel_launches_total", {}).get("series", [])
        health = fleet.health()
        drained = fleet.drain()
    finally:
        fleet.stop()
    for name in ("xnor_sign", "xnor_affine"):
        if launches[name] == 0:
            raise AssertionError(f"phase 21: the classifier replicas never "
                                 f"launched {name}")
    med = {k: statistics.median(v) for k, v in lat.items()}
    log(f"classifier fleet: booted in {marks['boot_s']:.1f} s, a killed "
        f"replica replaced in {marks['respawn_s']:.1f} s with "
        f"{FLEET_KILL_REQUESTS} of {FLEET_KILL_REQUESTS} requests "
        f"answered, a bad rollout rolled back; router {med['router']:.2f} "
        f"ms against direct {med['direct']:.2f} ms")
    return {"launches": launches, "marks": marks,
            "latency_ms": {"router_median": med["router"],
                           "direct_median": med["direct"],
                           "router_added_median": med["router"]
                           - med["direct"],
                           "router_p90": float(np.percentile(lat["router"],
                                                             90)),
                           "direct_p90": float(np.percentile(lat["direct"],
                                                             90))},
            "rollout": {k: rollout.get(k) for k in ("status", "tripped",
                                                    "reason")},
            "merged_launches": {s["labels"]["kernel"]: s["value"]
                                for s in merged},
            "replicas_live_end": health["live"], "drain": drained}


def _lm_fleet(device, gen, tmp: str) -> dict:
    """Phase 21 (d): a 2-replica ``cli fleet --lm`` on the one card:
    greedy streams through the router equal to one in-process engine's
    at the replicas' geometry; the replicas' K1, K7 and K8 launches from
    their /metrics; a SIGTERM drain."""
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    path, frozen = _lm_artifact(gen, os.path.join(tmp))
    prompts = [(torch.randint(0, LM_WIDTH["vocab"], (n,), generator=gen)
                .tolist(), k) for n, k in FLEET_LM_REQUESTS]
    fleet = _Fleet(tmp, "lm_fleet", path, [
        "--lm", "--page-size", str(LM_PAGE), "--deadline-ms", "120000",
        f"--replica-arg=--slots", f"--replica-arg={LM_SLOTS}",
        "--replica-arg=--prefill-chunk", f"--replica-arg={LM_CHUNK}"])
    try:
        boot_s, _ = fleet.wait_live(FLEET_REPLICAS)
        got = []
        for prompt, n in prompts:
            code, events = lc.generate(fleet.base, prompt, max_new_tokens=n,
                                       temperature=0.0, deadline_ms=120000.0)
            if code != 200 or events[-1].get("status") != "ok":
                raise AssertionError(f"phase 21: /generate {code} "
                                     f"{events[-1:]}")
            got.append([e["token"] for e in events[:-1]])
        launches = fleet.launches()
        drained = fleet.drain()
    finally:
        fleet.stop()
    want = _lm_reference(frozen, device, prompts)
    if got != want:
        raise AssertionError(f"phase 21: the LM fleet's greedy streams "
                             f"differ from one engine's: {got} vs {want}")
    for name in ("xnor", "xnor_unpack", "paged_attn"):
        if launches[name] == 0:
            raise AssertionError(f"phase 21: the LM replicas never launched "
                                 f"{name}")
    log(f"LM fleet: booted in {boot_s:.1f} s; {len(got)} greedy streams "
        "equal to one engine's")
    return {"launches": launches, "boot_s": boot_s,
            "tokens": sum(map(len, got)), "drain": drained}


def _lm_reference(frozen, device, prompts) -> list:
    """Greedy tokens of ``prompts`` ((tokens, n) pairs) from one
    in-process engine at the replicas' geometry, one after another. Its
    fence is off: this process captures graphs beside it ((e))."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine

    dec = make_paged_lm_decoder(frozen, slots=LM_SLOTS, page_size=LM_PAGE,
                                prefill_chunk=LM_CHUNK, device=device)
    eng = LMEngine(dec, queue_depth=16, device=device,
                   recompile_fence=False).start()
    out = []
    try:
        for prompt, n in prompts:
            req = eng.submit(np.asarray(prompt, np.int32), n,
                             time.monotonic() + 600)
            toks = []
            while True:
                ev = req.events.get(timeout=300)
                if ev["kind"] == "done":
                    if ev["status"] != "ok":
                        raise AssertionError(f"reference stream {ev}")
                    break
                toks.append(ev["token"])
            out.append(toks)
    finally:
        eng.stop()
    return out


def _augment_no_draw(device, tmp: str) -> dict:
    """Phase 21 (e): ``convnet`` (fp32) and ``bnn-moe-mlp`` (at its
    defaults, on ``pallas_xnor``) train with ``augment``, their crops
    drawn from a generator of their own: ``AUG_STEPS`` eager steps, and
    the same steps captured at ``scan_steps=AUG_SCAN``, bitwise equal
    (parameters, statistics, generator)."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    data = load_mnist(os.path.join(tmp, "no-mnist-files"),
                      synthetic_sizes=(AUG_STEPS * 64, 64), seed=0)
    out = {}
    for model, backend in (("convnet", None), ("bnn-moe-mlp",
                                                "pallas_xnor")):
        runs = []
        for scan in (1, AUG_SCAN):
            t = Trainer(TrainConfig(
                model=model, backend=backend, batch_size=64, epochs=1,
                optimizer="adam", learning_rate=0.01, seed=21,
                augment=True, scan_steps=scan, device=str(device)))
            row = t.train_epoch(data, 0)
            torch.cuda.synchronize()
            runs.append((t, row))
        (t1, r1), (t2, _) = runs
        gens = [t.model.train_generator(device).get_state() for t, _ in runs]
        if not (_states_equal(_state(t1), _state(t2))
                and torch.equal(gens[0], gens[1])
                and np.isfinite(r1["train_loss"])):
            raise AssertionError(f"phase 21: {model} augmented, captured "
                                 "differs from eager")
        out[model] = {"train_loss": r1["train_loss"],
                      "captures": t2._train_scan.captures}
    log("augment: convnet and bnn-moe-mlp captured bitwise eager")
    return out


def fleet_phase(device: torch.device, gen: torch.Generator):
    """Phase 21: the native loaders, the sanitizers and the serving
    fleet. (c) the classifier fleet, (d) the LM fleet and (b)'s
    sanitized ``cli train`` run as processes of their own, together,
    while (a) the native library's checks, (b)'s NaN-fence trip and (e)
    the augmented steps of the two models that draw nothing run here. Returns ({path: the replicas' launch counts}, the rows)."""
    t0 = time.perf_counter()
    marks = {}
    with tempfile.TemporaryDirectory() as tmp:
        fleet_gen = torch.Generator().manual_seed(int(
            torch.randint(0, 2 ** 31, (1,), generator=gen)))
        lm_gen = torch.Generator().manual_seed(int(
            torch.randint(0, 2 ** 31, (1,), generator=gen)))
        joins = {
            "classifier": _background(lambda: _classifier_fleet(
                device, fleet_gen, tmp)),
            "lm": _background(lambda: _lm_fleet(device, lm_gen, tmp)),
            "cli": _background(lambda: _sanitized_cli(tmp)),
        }
        out = {}
        try:
            out["native"] = _native_check(tmp)
            marks["a"] = round(time.perf_counter() - t0, 1)
            out["nan_trip"] = _nan_trip(device, tmp)
            marks["b"] = round(time.perf_counter() - t0, 1)
            out["augment"] = _augment_no_draw(device, tmp)
            marks["e"] = round(time.perf_counter() - t0, 1)
        finally:
            for name, join in joins.items():
                out[name] = join()
                marks[name] = round(time.perf_counter() - t0, 1)
    paths = {"fleet_classifier": out["classifier"].pop("launches"),
             "fleet_lm": out["lm"].pop("launches")}
    print(json.dumps({"phase": 21, **out}, default=str), flush=True)
    print(json.dumps({"phase": 21, "launches": paths,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    return paths, out


# -- phase 22: the AOT store, the cold-start worker, the examples -----------

AOT_BATCH = MAIN_M           # the classifier server's micro-batch
AOT_SPEC_K = 4               # the LM server's speculative window
AOT_LM_REQUESTS = ((5, 12), (17, 12), (40, 8))   # (prompt, new tokens)
AOT_TRAIN_STEPS = 3          # steps of the train step from the store
AOT_TRAIN = dict(MLP_TRAIN, backend="pallas_xnor",
                 model_kwargs={"infl_ratio": 3})
AOT_REPORT_SIZES = (1280, 256)   # the accuracy report's synthetic split
DEMO_LOSSES: list = []       # the demos' losses in phase 9's gloo ranks
DEMO_KW = {"dropout_rate": 0.0}   # the demos' model: no dropout draws, so
#                                   that every world draws alike


def _no_nvcc_env(kernel_dir: str) -> dict:
    """The environment of a process that cannot find ``nvcc``: CUDA_HOME
    at nothing, and no PATH entry holding an ``nvcc``."""
    env = dict(os.environ, JG_KERNEL_DIR=kernel_dir,
               CUDA_HOME=os.path.join(kernel_dir, "no-cuda-home"))
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    return env


def _aot_train_data(tmp: str):
    from distributed_mnist_bnns_tpu_torch.data import load_mnist

    return load_mnist(os.path.join(tmp, "no-mnist-files"), synthetic_sizes=(
        AOT_TRAIN_STEPS * AOT_TRAIN["batch_size"], 64), seed=0)


def _aot_train_steps(device, tmp: str, **kw) -> dict:
    """``AOT_TRAIN_STEPS`` steps of ``AOT_TRAIN`` (pallas_xnor): losses,
    the state's digest, the AOT status, K1's launches."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    data = _aot_train_data(tmp)
    t = Trainer(TrainConfig(**AOT_TRAIN, epochs=1, device=str(device),
                            log_interval=10 ** 9, handle_preemption=False,
                            **kw))
    bs = AOT_TRAIN["batch_size"]
    _kernels.reset_launches()
    losses = []
    for s in range(AOT_TRAIN_STEPS):
        xb = torch.from_numpy(data.train_images[s * bs:(s + 1) * bs])
        yb = torch.from_numpy(data.train_labels[s * bs:(s + 1) * bs].astype(
            np.int64))
        loss, _ = t.train_step(t.model, t.optimizer, xb.to(device),
                               yb.to(device))
        losses.append(float(loss))
    return {"losses": losses, "digest": _digest(t.model),
            "aot_status": t.aot_status,
            "launches": dict(_kernels.LAUNCHES)}


def _metrics_launches(base: str) -> dict:
    """``kernel_launches_total{kernel}`` from a server's /metrics text."""
    import urllib.request

    req = urllib.request.Request(base + "/metrics",
                                 headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=30) as r:
        text = r.read().decode()
    return {name: int(_prom(text, f'kernel_launches_total{{kernel="{name}"}}'))
            if f'kernel="{name}"' in text else 0 for name in KERNEL_ROWS}


def _aot_bank(spec: dict) -> dict:
    """(a) the classifier, the LM (with its verify program) and the
    pallas_xnor train step banked through ``cli aot build`` into the
    empty store, in the cold process after its boot: their libraries
    built by ``nvcc`` into that process's build directory (its
    ``JG_KERNEL_DIR``, empty at its start). Its JSON line."""
    import contextlib
    import io

    from distributed_mnist_bnns_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--log-level", "WARNING", "aot", "build",
                       "--store", spec["store"],
                       "--device", spec["device"],
                       "--artifact", spec["cls"],
                       "--batch-size", str(AOT_BATCH),
                       "--lm-artifact", spec["lm"],
                       "--slots", str(LM_SLOTS), "--page-size", str(LM_PAGE),
                       "--prefill-chunk", str(LM_CHUNK),
                       "--spec-decode", str(AOT_SPEC_K), "--train",
                       "--model", AOT_TRAIN["model"], "--backend",
                       AOT_TRAIN["backend"], "--train-batch-size",
                       str(AOT_TRAIN["batch_size"])])
    if rc != 0:
        raise AssertionError(f"cli aot build exited {rc}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _aot_child_warm(spec: dict) -> dict:
    """(b)-(d) in a process that cannot find ``nvcc``: the classifier
    server, the LM server and the train step, each from the store."""
    import shutil

    from distributed_mnist_bnns_tpu_torch.obs import get_tracker
    from distributed_mnist_bnns_tpu_torch.ops import _kernels
    from distributed_mnist_bnns_tpu_torch.serve import (
        PackedInferenceServer,
        ServeConfig,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import (
        LMServeConfig,
        LMServer,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    try:
        _kernels._nvcc()
        nvcc = "found"
    except RuntimeError:
        nvcc = "unreachable"
    out = {"nvcc": nvcc, "which_nvcc": shutil.which("nvcc")}
    device = torch.device(spec["device"])
    # (b) the classifier server
    images = np.load(spec["images"])
    _kernels.reset_launches()
    srv = PackedInferenceServer(ServeConfig(
        artifact=spec["cls"], device=spec["device"], port=0,
        batch_size=AOT_BATCH,
        aot=True, aot_dir=spec["store"]))
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        code, body = _post_json(base + "/predict", {
            "images": images.tolist(), "deadline_ms": 60000.0})
        out["classifier"] = {"code": code,
                             "log_probs": body.get("log_probs"),
                             "health": _get_json(base + "/healthz"),
                             "launches": _metrics_launches(base)}
    finally:
        srv.request_stop()
        srv.drain_and_stop()
    # (c) the LM server, speculative
    _kernels.reset_launches()
    lm = LMServer(LMServeConfig(
        artifact=spec["lm"], device=spec["device"], port=0, slots=LM_SLOTS,
        page_size=LM_PAGE, prefill_chunk=LM_CHUNK, spec_decode=AOT_SPEC_K,
        aot=True, aot_dir=spec["store"]))
    host, port = lm.start()
    base = f"http://{host}:{port}"
    try:
        streams = []
        for prompt, n in spec["prompts"]:
            code, events = lc.generate(base, prompt, max_new_tokens=n,
                                       temperature=0.0,
                                       deadline_ms=120000.0)
            if code != 200 or events[-1].get("status") != "ok":
                raise AssertionError(f"/generate {code} {events[-1:]}")
            streams.append([e["token"] for e in events[:-1]])
        out["lm"] = {"streams": streams,
                     "health": _get_json(base + "/healthz"),
                     "launches": _metrics_launches(base)}
    finally:
        lm.request_stop()
        lm.drain_and_stop()
    # (d) the train step from the store (the smoke's process runs it
    # online)
    with tempfile.TemporaryDirectory() as tmp:
        out["train"] = _aot_train_steps(device, tmp, aot=True,
                                        aot_dir=spec["store"])
    out["kernel_builds"] = get_tracker().kind_count("kernel_build")
    return out


def aot_child(mode: str, spec: dict) -> int:
    """Phase 22's processes after their cold-start boots: the bank (a)
    in the cold one, (b)-(d) in the warm one. One ``{"aot_child": ...}``
    line."""
    t0 = time.perf_counter()
    out = ({"bank": _aot_bank(spec)} if mode == "cold"
           else _aot_child_warm(spec))
    print(json.dumps({"aot_child": mode, "s": time.perf_counter() - t0,
                      **out}), flush=True)
    return 0


def _aot_process(mode: str, spec: dict, env: dict,
                 booted: threading.Event = None) -> dict:
    """``chip_smoke.py --aot-child mode`` in a fresh process: the
    cold-start worker, then ``aot_child``'s part for ``mode``. Its lines
    parsed: the split, the worker's record, the child's. ``booted`` is
    set when the worker's record arrives (its boot and first answer are
    done)."""
    t0 = time.perf_counter()
    argv = [sys.executable, os.path.abspath(__file__), "--aot-child", mode,
            json.dumps(spec)]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    err = _background(proc.stderr.read)
    rec = {}
    try:
        for ln in proc.stdout:
            if not ln.startswith("{"):
                continue
            row = json.loads(ln)
            if "coldstart_split" in row:
                rec["split"] = row["coldstart_split"]
            elif "aot_child" in row:
                rec["child"] = row
            elif "boot_s" in row:
                rec["coldstart"] = row
                if booted is not None:
                    booted.set()
        rc = proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
        if booted is not None:
            booted.set()   # a failed process must not hold its waiter
    rec["process_s"] = time.perf_counter() - t0
    print(json.dumps({"process": f"aot {mode}",
                      "s": round(rec["process_s"], 1)}), flush=True)
    if rc != 0:
        raise AssertionError(f"phase 22: the {mode} process exited {rc}: "
                             f"{err()[-3000:]}")
    err()
    return rec


def _aot_lm_reference(frozen, device, prompts) -> list:
    """Greedy tokens of ``prompts`` from one engine at the LM server's
    geometry and speculative window, built without the store."""
    from distributed_mnist_bnns_tpu_torch.infer_transformer import (
        make_paged_lm_decoder,
    )
    from distributed_mnist_bnns_tpu_torch.serve.lm import LMEngine

    dec = make_paged_lm_decoder(frozen, slots=LM_SLOTS, page_size=LM_PAGE,
                                prefill_chunk=LM_CHUNK, spec_k=AOT_SPEC_K,
                                device=device)
    eng = LMEngine(dec, queue_depth=16, device=device,
                   recompile_fence=False).start()
    out = []
    try:
        for prompt, n in prompts:
            req = eng.submit(np.asarray(prompt, np.int32), n,
                             time.monotonic() + 600)
            toks = []
            while True:
                ev = req.events.get(timeout=300)
                if ev["kind"] == "done":
                    if ev["status"] != "ok":
                        raise AssertionError(f"reference stream {ev}")
                    break
                toks.append(ev["token"])
            out.append(toks)
    finally:
        eng.stop()
    return out


def _aot_corrupt(device, tmp: str, store: str, cls_path: str, images,
                 want, train_want) -> dict:
    """(e): in a copy of the store, one byte of the classifier's banked
    library flipped and the train step's library cut in half. Each load
    quarantines its entry (``aot_fallback``, the ``.quarantined`` files)
    and rebuilds it through the builder, in a build directory of its own
    that holds only this process's built library (so the rebuild runs no
    ``nvcc``, and its install is a file no process has loaded): no
    library reaches ``ctypes.CDLL`` but the rebuilt one, and the answers
    and the steps stay bitwise."""
    import ctypes
    import glob
    import hashlib
    import shutil

    from distributed_mnist_bnns_tpu_torch.aot import AotStore, load_packed_aot
    from distributed_mnist_bnns_tpu_torch.aot.store import DeferredEvents
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    copy = os.path.join(tmp, "store_e")
    shutil.copytree(store, copy)
    (cls_bin,) = glob.glob(os.path.join(copy, "classifier_predict", "*.bin"))
    (train_bin,) = glob.glob(os.path.join(copy, "train_step", "*.bin"))
    with open(cls_bin, "r+b") as f:
        blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0x01
        f.seek(0)
        f.write(blob)
    bad = {hashlib.sha256(bytes(blob)).hexdigest()}
    with open(train_bin, "r+b") as f:
        f.truncate(os.path.getsize(train_bin) // 2)
    loaded = []
    real_cdll, real_dir = ctypes.CDLL, _kernels.BUILD_DIR
    source = "xnor_gemm.cu"
    kernels_e = os.path.join(tmp, "kernels_e")
    os.makedirs(kernels_e)
    shutil.copy(_kernels._lib_path(source), kernels_e)
    handle = _kernels._libs.pop(source)

    def cdll(path, *a, **kw):
        with open(path, "rb") as f:
            loaded.append(hashlib.sha256(f.read()).hexdigest())
        return real_cdll(path, *a, **kw)

    events = DeferredEvents()   # holds the store's events, never flushed
    ctypes.CDLL, _kernels.BUILD_DIR = cdll, kernels_e
    try:
        fn, _, meta = load_packed_aot(
            cls_path, batch_size=AOT_BATCH, input_shape=(28, 28, 1),
            device=device, store=AotStore(copy, telemetry=events))
        got = fn(images).cpu().numpy()
        _kernels._libs.pop(source)   # the train step's load, from nothing
        train = _aot_train_steps(device, tmp, aot=True, aot_dir=copy)
    finally:
        ctypes.CDLL, _kernels.BUILD_DIR = real_cdll, real_dir
        _kernels._libs[source] = handle
    rebuilt = [f for k, f in events.events if k == "aot_bank"]
    fallbacks = [f for k, f in events.events if k == "aot_fallback"]
    quarantined = sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(copy, "*", "*.quarantined")))
    banked = set()
    for man in glob.glob(os.path.join(copy, "*", "*.json")):
        with open(man) as f:
            banked |= {r["sha256"] for r in json.load(f)["libraries"]}
    row = {"fallbacks": [e["reason"] for e in fallbacks],
           "classifier_status": meta["status"],
           "train_status": train["aot_status"],
           "quarantined": len(quarantined), "cdll_calls": len(loaded)}
    if meta["status"] != "miss" or train["aot_status"] != "miss":
        raise AssertionError(f"phase 22 (e): a corrupt entry loaded: {row}")
    # each entry's payload and manifest set aside: 2 entries, 4 files
    if row["fallbacks"] != ["payload_digest_mismatch"] or len(
            quarantined) != 4:
        raise AssertionError(f"phase 22 (e): not quarantined: {row}, "
                             f"{quarantined}")
    if not rebuilt or not loaded or any(h in bad or h not in banked
                                        for h in loaded):
        raise AssertionError(f"phase 22 (e): a library that was not "
                             f"rebuilt and banked reached dlopen: {row}")
    if not np.array_equal(got, want):
        raise AssertionError("phase 22 (e): the rebuilt classifier's "
                             "answers differ")
    if (train["losses"], train["digest"]) != (train_want["losses"],
                                              train_want["digest"]):
        raise AssertionError("phase 22 (e): the rebuilt train step's steps "
                             "differ")
    return row


def _demos_check(device) -> dict:
    """(g) the demos: phase 9's gloo ranks ran them at world
    ``DP_GLOO_RANKS``; the same in this process at world 1 (the DP
    demos' losses to rtol 1e-5, the TP demo's to atol 1e-4, the DP and
    TP parity tests' tolerances)."""
    from distributed_mnist_bnns_tpu_torch.examples import demos

    alone = demos.run_all(0, 1, str(device), 0, model_kwargs=DEMO_KW)
    if not DEMO_LOSSES:
        raise AssertionError("phase 22: phase 9's ranks ran no demos")
    for ranks in DEMO_LOSSES:
        for name, loss in ranks.items():
            tol = (dict(atol=1e-4, rtol=0) if name == "demo_model_parallel"
                   else dict(rtol=1e-5, atol=0))
            if not np.isclose(loss, alone[name], **tol):
                raise AssertionError(f"phase 22: {name} at world "
                                     f"{DP_GLOO_RANKS}: {loss}, alone "
                                     f"{alone[name]}")
    return {"world": DP_GLOO_RANKS, "ranks": DEMO_LOSSES[0], "alone": alone}


def _report_check(device, tmp: str) -> dict:
    """(g) the accuracy report: one epoch of bnn-mlp-large on a small
    synthetic split, written to a file of its own."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.examples import accuracy_report

    data = load_mnist(os.path.join(tmp, "no-mnist-files"),
                      synthetic_sizes=AOT_REPORT_SIZES, seed=0)
    out = os.path.join(tmp, "report.md")
    rows = accuracy_report.run(["bnn-mlp-large"], 1, 64, 0.01, [0], out,
                               device=str(device), data=data)
    with open(out) as f:
        text = f.read()
    r = rows[0]
    if not (np.isfinite(r["test_loss"]) and 0 <= r["test_acc"] <= 100
            and "`synthetic`" in text and len(r["epoch_times_s"]) == 1):
        raise AssertionError(f"phase 22: the accuracy report: {r}")
    return {"test_acc": r["test_acc"], "epoch_s": r["epoch_times_s"][0]}


def aot_phase(device: torch.device, gen: torch.Generator, smi: str):
    """Phase 22: the AOT store. (f) the cold-start worker's cold boot
    (an empty store and build directory, alone); (a) in the same process
    after it, ``cli aot build`` banks the classifier, the LM with its
    verify program and the pallas_xnor train step into an empty store,
    ``nvcc`` into that build directory, beside the references built here
    without the store; (b)-(d) a
    process that cannot find ``nvcc`` boots the classifier server
    (answers bitwise the predictor built here, K2 and K3 from its
    /metrics), the LM server (greedy streams equal to an engine built
    here, K1, K7, K8) and the train step (bitwise the online steps run
    here, K1),
    each a hit with zero kernel builds and a budget-0 fence that never
    tripped; (e) a flipped and a truncated library quarantined and
    rebuilt; (f) the warm boot (the first thing (b)-(d)'s process does,
    alone); (g) the demos (run in phase 9's ranks) and the accuracy
    report, here beside (a); (e) here beside (b)-(d). Returns
    ({path: launches}, the rows)."""
    from distributed_mnist_bnns_tpu_torch.infer import (
        export_packed,
        load_packed,
    )
    from distributed_mnist_bnns_tpu_torch.models import get_model

    t0 = time.perf_counter()
    marks = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        cls_path = os.path.join(tmp, "cls.msgpack")
        model = get_model("bnn-mlp-large", backend="xla", generator=gen)
        _random_bn_stats(model, gen)
        export_packed(model.eval(), cls_path)
        lm_path, frozen = _lm_artifact(gen, tmp)
        images = torch.randn(AOT_BATCH, 28, 28, 1, generator=gen).numpy()
        np.save(os.path.join(tmp, "images.npy"), images)
        prompts = [(torch.randint(0, LM_WIDTH["vocab"], (n,), generator=gen)
                    .tolist(), k) for n, k in AOT_LM_REQUESTS]
        spec = {"store": store, "cls": cls_path, "lm": lm_path,
                "images": os.path.join(tmp, "images.npy"),
                "prompts": prompts, "device": device.type}
        boot = ["--mode", "serve", "--artifact", cls_path, "--store", store,
                "--batch-size", str(AOT_BATCH), "--device", device.type]
        cold_dir, warm_dir = (os.path.join(tmp, d) for d in ("k_cold",
                                                             "k_warm"))
        # (f) the cold boot alone, against an empty store of its own;
        # then (a), the bank, in the same process beside the references
        # built here without the store and (g)
        cold_booted = threading.Event()
        cold_join = _background(lambda: _aot_process(
            "cold", {**spec, "coldstart": [
                *boot[:boot.index("--store") + 1],
                os.path.join(tmp, "cold_store"),
                *boot[boot.index("--store") + 2:]]},
            dict(os.environ, JG_KERNEL_DIR=cold_dir), cold_booted))
        cold_booted.wait()     # its record is out: it banks now
        marks["cold"] = round(time.perf_counter() - t0, 1)
        fn, _ = load_packed(cls_path, device=device)
        want = fn(images).cpu().numpy()
        lm_want = _aot_lm_reference(frozen, device, prompts)
        train_want = _aot_train_steps(device, tmp)
        marks["references"] = round(time.perf_counter() - t0, 1)
        demos = _demos_check(device)
        report = _report_check(device, tmp)
        marks["g"] = round(time.perf_counter() - t0, 1)
        cold = cold_join()
        bank = cold["child"]["bank"]
        marks["bank"] = round(time.perf_counter() - t0, 1)
        # the warm process's boot alone; (e) beside its checks
        booted = threading.Event()
        warm_join = _background(lambda: _aot_process(
            "warm", {**spec, "coldstart": boot}, _no_nvcc_env(warm_dir),
            booted))
        booted.wait()
        marks["warm_boot"] = round(time.perf_counter() - t0, 1)
        corrupt = _aot_corrupt(device, tmp, store, cls_path, images, want,
                               train_want)
        marks["e"] = round(time.perf_counter() - t0, 1)
        warm = warm_join()
        marks["warm"] = round(time.perf_counter() - t0, 1)
    w = warm["child"]
    built = {b["program"]: b for b in bank["built"]}
    banked_cls = built.pop("classifier_predict")
    # nvcc seconds per source: the cold boot's (K1-K3's source), then the
    # bank's (the LM's others) in the same build directory
    bank_nvcc = {**cold["coldstart"]["nvcc_s"], **bank["nvcc_s"]}
    checks = {
        "cold_miss": cold["coldstart"]["aot_status"] == "miss"
        and cold["coldstart"]["compiles"] > 0,
        # an empty store and build directory: all banked, nvcc ran
        "banked": len(built) == 2 and banked_cls["status"] == "miss"
        and all(b.get("status") == "miss" for b in built.values())
        and set(bank_nvcc) >= {"xnor_gemm.cu", "xnor_unpack.cu",
                               "paged_attn.cu"},
        "warm_hit": warm["coldstart"]["aot_status"] == "hit"
        and warm["coldstart"]["compiles"] == 0,
        "nvcc_unreachable": w["nvcc"] == "unreachable"
        and w["which_nvcc"] is None,
        "zero_kernel_builds": w["kernel_builds"] == 0,
    }
    for name, part in (("classifier", w["classifier"]), ("lm", w["lm"])):
        h = part["health"]
        checks[f"{name}_fenced"] = (
            h["aot"] == "hit" and h["fence_budget"] == 0
            and h["fence_error"] is None and h["status"] == "ok")
    checks["classifier_bitwise"] = (
        w["classifier"]["code"] == 200 and np.array_equal(
            np.asarray(w["classifier"]["log_probs"], np.float32), want))
    checks["lm_tokens"] = w["lm"]["streams"] == lm_want
    checks["train_hit_bitwise"] = (
        w["train"]["aot_status"] == "hit"
        and (w["train"]["losses"], w["train"]["digest"])
        == (train_want["losses"], train_want["digest"]))
    paths = {"aot_classifier": w["classifier"]["launches"],
             "aot_lm": w["lm"]["launches"],
             "aot_train": w["train"]["launches"]}
    for path, names in (("aot_classifier", ("xnor_sign", "xnor_affine")),
                        ("aot_lm", ("xnor", "xnor_unpack", "paged_attn")),
                        ("aot_train", ("xnor",))):
        for name in names:
            checks[f"{path}_{name}"] = paths[path][name] > 0
    bad = [k for k, ok in checks.items() if not ok]
    row = {
        "phase": 22, "card": smi,
        "cold": {"process_s": cold["process_s"], **cold["coldstart"],
                 "split": cold["split"]},
        "bank": {"s": marks["bank"], "nvcc_s": bank_nvcc, "built": {
            "classifier_predict": banked_cls, **built}},
        "warm": {"process_s": warm["process_s"], **warm["coldstart"],
                 "split": warm["split"], "checks_s": w["s"]},
        "corrupt": corrupt, "demos": demos, "report": report,
        "train": {"hit": w["train"]["losses"],
                  "online": train_want["losses"]},
        "checks": checks,
    }
    print(json.dumps(row, default=str), flush=True)
    if bad:
        raise AssertionError(f"phase 22: failed {bad}")
    print(json.dumps({"phase": 22, "launches": paths,
                      "phase_s": time.perf_counter() - t0,
                      "elapsed_s_after": marks}), flush=True)
    log(f"AOT store: cold boot {cold['coldstart']['boot_s']:.1f} s (miss), "
        f"warm boot {warm['coldstart']['boot_s']:.1f} s (hit, no nvcc); "
        "both servers and the train step from the store, bitwise")
    return paths, row


# -- phase 23: the analyses ---------------------------------------------------

def analysis_phase(device: torch.device, smi: str):
    """Phase 23: ``cli lint`` over the package and the lockstep check of
    the collective exchanges with their tensors on ``device``, in the
    main thread with no ``_background`` check alive (the lockstep
    simulation replaces ``torch.distributed``'s functions process-wide).
    Returns the phase's row."""
    import contextlib
    import io

    import torch.distributed as dist

    from distributed_mnist_bnns_tpu_torch import cli
    from distributed_mnist_bnns_tpu_torch.analysis import spmd

    t0 = time.perf_counter()
    if threading.current_thread() is not threading.main_thread():
        raise AssertionError("phase 23 must run in the main thread")
    alive = [t.name for t in threading.enumerate()
             if t.name == BACKGROUND and t.is_alive()]
    if alive:
        raise AssertionError(f"phase 23: background checks alive: {alive}")
    # (a) the lint, as `cli lint --format json` prints it
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["lint", "--format", "json"])
    lint = json.loads(out.getvalue())
    lint_row = {"rc": rc, "unsuppressed": lint["unsuppressed"],
                "suppressed": lint["suppressed"],
                "s": round(time.perf_counter() - t0, 3)}
    if rc != 0 or lint["unsuppressed"]:
        bad = [f for f in lint["findings"] if not f["suppressed"]]
        raise AssertionError(f"phase 23 (a): cli lint rc {rc}: {bad}")
    # (b) every shipped exchange in lockstep, tensors on the card
    t1 = time.perf_counter()
    report = spmd.verify_shipped(device=str(device))
    places = []

    def probe(pid, world):
        fn, args = spmd.SHIPPED_PROGRAMS["dp_exchange"](world, device)(
            pid, world)
        places.append(args[1][0].device.type)
        return fn, args

    spmd.run_lockstep(probe, 2)
    if places != ["cuda", "cuda"]:
        raise AssertionError(f"phase 23 (b): the exchange ran on {places}")

    def mutant(pid, world):
        x = torch.ones(4, device=device)

        def exchange():
            g = spmd.sim_group("data")
            dist.broadcast(x, 0, group=g)
            if pid == 0:          # the divergence: rank 0 only
                dist.all_reduce(x, group=g)
            dist.all_gather_into_tensor(
                torch.empty(world * 4, device=device), x, group=g)

        return exchange, ()

    try:
        spmd.run_lockstep(mutant, 4)
    except spmd.LockstepError as e:
        caught = e.divergence_index
    else:
        raise AssertionError("phase 23 (b): the divergence mutant passed")
    if caught != 1:
        raise AssertionError(f"phase 23 (b): the mutant diverged at {caught}, "
                             "not at its index 1")
    row = {"phase": 23, "card": smi, "lint": lint_row,
           "spmd": [{k: r[k] for k in ("program", "world", "n_collectives")}
                    for r in report],
           "spmd_s": round(time.perf_counter() - t1, 3),
           "mutant_divergence_index": caught,
           "phase_s": round(time.perf_counter() - t0, 3)}
    if not all(r["ok"] for r in report) or len(report) != 12:
        raise AssertionError(f"phase 23 (b): {report}")
    print(json.dumps(row), flush=True)
    log(f"analyses: lint clean ({lint['suppressed']} reasoned suppressions), "
        f"{len(report)} exchanges in lockstep on {device}, the mutant "
        "caught at index 1")
    return row


PHASE_S: dict = {}   # phase -> seconds of command time, for the summary


def _time_processes() -> None:
    """Print the seconds of every ``parallel.spawn`` and ``subprocess.run``
    of the phases (``{"spawn": ...}`` / ``{"process": ...}`` lines): where
    a phase's time goes."""
    import distributed_mnist_bnns_tpu_torch.parallel as par

    spawn, run = par.spawn, subprocess.run

    def timed_spawn(fn, world, **kw):
        t0 = time.perf_counter()
        try:
            return spawn(fn, world, **kw)
        finally:
            print(json.dumps({"spawn": getattr(fn, "__name__", str(fn)),
                              "world": world, "backend": kw.get("backend"),
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)

    def timed_run(argv, *a, **kw):
        t0 = time.perf_counter()
        try:
            return run(argv, *a, **kw)
        finally:
            if isinstance(argv, (list, tuple)) and "-m" in argv:
                print(json.dumps({"process": " ".join(map(str, argv[2:6])),
                                  "s": round(time.perf_counter() - t0, 1)}),
                      flush=True)

    par.spawn, subprocess.run = timed_spawn, timed_run


def _timed(phase: str, fn, *args):
    """``fn(*args)``, its seconds printed as ``{"phase", "phase_s"}`` and
    kept in ``PHASE_S``."""
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_S[phase] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"phase": phase, "phase_s": PHASE_S[phase]}),
          flush=True)
    return out


def main() -> int:
    t_main = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: fp32
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)

    # The package's profiler keeps CUPTI up between torch.profiler
    # sessions (TEARDOWN_CUPTI=0, obs/profile.py), as a program of the
    # package does from its first capture on; imported here, before this
    # process's first session.
    from distributed_mnist_bnns_tpu_torch.obs import profile as _profile
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    print(json.dumps({"teardown_cupti": os.environ.get("TEARDOWN_CUPTI"),
                      "profile_edge_s": _profile.EDGE_S}), flush=True)
    _time_processes()
    t0 = time.perf_counter()
    built = _kernels.build()
    PHASE_S["2"] = round(time.perf_counter() - t0, 1)
    print(json.dumps({"build_s": round(time.perf_counter() - t0, 3),
                      "sources": built}), flush=True)

    gen = torch.Generator().manual_seed(0)
    results = {}
    for name in ("xnor", "xnor_sign", "xnor_affine"):
        rows, max_err = _timed(f"3:{name}", kernel_phase, name, device, gen)
        m, k, n = KERNEL_ROWS[name][2]
        results[name] = (next(r for r in rows if (r["m"], r["k"], r["n"])
                              == (m, k, n)), max_err)
        torch.cuda.synchronize()
        log(f"{name}: equal to its plain version at every shape")
    unpack_rows, unpack_err = _timed("3:xnor_unpack", unpack_phase, device,
                                     gen)
    results["xnor_unpack"] = (unpack_rows[0], unpack_err)
    log("xnor_unpack: equal to its plain version on ±1 x at every shape, "
        "two runs bitwise equal")
    paged_rows, paged_err = _timed("3:paged_attn", paged_phase, device, gen)
    results["paged_attn"] = (paged_rows[0], paged_err)
    log("paged_attn: within 1e-5 of the gather path at every case")
    mlp_counts, timing = _timed("4", slice_phase, device, gen)
    print(json.dumps({"slice": "bnn-mlp-large", "launches": mlp_counts,
                      **timing}), flush=True)
    for name in ("xnor_sign", "xnor_affine"):
        if mlp_counts[name] == 0:
            raise AssertionError(f"the MLP path never launched {name}")
    lm_counts, lm_timing = _timed("5", lm_slice_phase, device, gen)
    print(json.dumps({"slice": "bnn-lm", "launches": lm_counts,
                      **lm_timing}), flush=True)
    for name in ("xnor", "xnor_unpack", "paged_attn"):
        if lm_counts[name] == 0:
            raise AssertionError(f"the LM path never launched {name}")
    # Prompts of M >= FUSED_UNPACK_MIN_M rows go to K7: every prefill
    # chunk, once per packed projection (4 a block, 2 in its MLP).
    chunks = sum(-(-n // LM_CHUNK) for n in LM_PROMPTS)
    want = chunks * LM_WIDTH["depth"] * 6
    if lm_counts["xnor_unpack"] != want:
        raise AssertionError(
            f"K7 launched {lm_counts['xnor_unpack']} times on the LM path, "
            f"want {want} ({chunks} prefill chunks)")
    # K1: every packed projection of a decode iteration (M = slots rows,
    # below FUSED_UNPACK_MIN_M), 6 a block, and nothing else.
    want = LM_WIDTH["depth"] * 6 * lm_timing["decode_iterations"]
    if lm_counts["xnor"] != want:
        raise AssertionError(
            f"K1 launched {lm_counts['xnor']} times on the LM path, want "
            f"{want} ({lm_timing['decode_iterations']} decode iterations)")
    # K8: one launch a layer per decode iteration and per prefill chunk.
    want = LM_WIDTH["depth"] * (lm_timing["decode_iterations"] + chunks)
    if lm_counts["paged_attn"] != want:
        raise AssertionError(
            f"K8 launched {lm_counts['paged_attn']} times on the LM path, "
            f"want {want} ({lm_timing['decode_iterations']} decode "
            f"iterations, {chunks} prefill chunks)")

    flash_rows, flash_err = _timed("6", flash_phase, device, gen)
    for name in FLASH:
        results[name] = (flash_rows[name], flash_err[name])
    log("flash: K4/K5/K6 within tolerance of their plain versions at "
        "every shape")
    train_counts, train_timing = _timed("7", lm_train_phase, device, gen)
    print(json.dumps({"slice": "bnn-lm-train", "launches": train_counts,
                      **train_timing}), flush=True)
    mlp_train_counts, mlp_train_timing = _timed("8", mlp_train_phase,
                                                device, gen)
    print(json.dumps({"slice": "bnn-mlp-train",
                      "launches": mlp_train_counts, **mlp_train_timing}),
          flush=True)
    dp_counts, _ = _timed("9", dp_train_phase, device, smi)
    conv_counts, conv_rows = _timed("10", conv_phase, device, gen, smi)
    rt_counts, _ = _timed("11", runtime_phase, device, smi)
    scan_counts, in_graphs = _timed("12", scan_phase, device, smi)
    dpc_counts, dpc_in_graphs = _timed("13", dp_capture_phase, device, smi)
    if dpc_counts["xnor"] == 0:
        raise AssertionError("the captured DP path never launched K1")
    mp_counts, mp_k1_rows = _timed("14", mp_phase, device, gen, smi)
    for name in ("xnor", *FLASH):
        if mp_counts[name] == 0:
            raise AssertionError(f"the model-parallel path never launched "
                                 f"{name}")
    # phase 17's process-bound checks start beside phase 16's spawn:
    # neither holds a timing
    rs_tmp = tempfile.mkdtemp(prefix="resilience_")
    rs_started = resilience_processes(rs_tmp)
    mp2_counts = _timed("16", mp2_phase, device, smi)
    rs_counts = _timed("17", resilience_phase, device,
                       torch.Generator().manual_seed(17), smi, rs_tmp,
                       rs_started)
    tf_paths, vit_rows, ring_rows, verify_k8 = _timed(
        "18", transformer_phase, device, torch.Generator().manual_seed(18),
        smi)
    for name, paths in (("xnor", ("vit", "spec")),
                        ("xnor_unpack", ("spec", "prefix")),
                        ("paged_attn", ("spec", "prefix")),
                        *((n, ("ring",)) for n in FLASH)):
        for path in paths:
            if tf_paths[path][name] == 0:
                raise AssertionError(f"phase 18: the {path} path never "
                                     f"launched {name}")
    fam_paths, moe_rows = _timed("19", families_phase, device,
                                 torch.Generator().manual_seed(19))
    for path in ("moe", "moe_train"):
        if fam_paths[path]["xnor"] == 0:
            raise AssertionError(f"phase 19: the {path} path never launched "
                                 "xnor")
    rn_paths, rn_rows = _timed("20", resnet_phase, device,
                               torch.Generator().manual_seed(20))
    for path, names in (("resnet", ("xnor", "xnor_sign")),
                        ("resnet_train", ("xnor",))):
        for name in names:
            if rn_paths[path][name] == 0:
                raise AssertionError(f"phase 20: the {path} path never "
                                     f"launched {name}")
    fleet_paths, _ = _timed("21", fleet_phase, device,
                            torch.Generator().manual_seed(21))
    for path, names in (("fleet_classifier", ("xnor_sign", "xnor_affine")),
                        ("fleet_lm", ("xnor", "xnor_unpack", "paged_attn"))):
        for name in names:
            if fleet_paths[path][name] == 0:
                raise AssertionError(f"phase 21: the {path} path never "
                                     f"launched {name}")
    aot_paths, _ = _timed("22", aot_phase, device,
                          torch.Generator().manual_seed(22), smi)
    _timed("23", analysis_phase, device, smi)
    # Phase 15 runs last, in the oldest process the smoke has: its
    # profile windows are held to the launch counters there.
    obs_counts, _ = _timed("15", obs_phase, device,
                           torch.Generator().manual_seed(15), smi)

    kernels = []
    for name, (replaces, source, _) in KERNEL_ROWS.items():
        row, max_err = results[name]
        if name == "paged_attn":
            shape = [row["s"], row["c"], row["p"], row["qpos"]]
        elif name in FLASH:
            shape = [row["b"], row["h"], row["lq"], row["lk"], row["d"],
                     row["causal"]]
        else:
            shape = [row["m"], row["k"], row["n"]]
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": (mlp_counts[name] + lm_counts[name]
                         + train_counts[name] + mlp_train_counts[name]
                         + dp_counts[name] + conv_counts[name]
                         + rt_counts[name] + scan_counts[name]
                         + dpc_counts[name] + mp_counts[name]
                         + mp2_counts[name] + rs_counts[name]
                         + obs_counts[name]
                         + sum(c[name] for c in tf_paths.values())
                         + sum(c[name] for c in fam_paths.values())
                         + sum(c[name] for c in rn_paths.values())
                         + sum(c[name] for c in fleet_paths.values())
                         + sum(c[name] for c in aot_paths.values())),
            "launches_mlp_path": mlp_counts[name],
            "launches_lm_path": lm_counts[name],
            "launches_train_path": (train_counts[name]
                                    + mlp_train_counts[name]),
            "launches_lm_train_path": train_counts[name],
            "launches_mlp_train_path": mlp_train_counts[name],
            "launches_dp_path": dp_counts[name],
            "launches_conv_path": conv_counts[name],
            "launches_runtime_path": rt_counts[name],
            "launches_capture_path": scan_counts[name],
            "launches_dp_capture_path": dpc_counts[name],
            "launches_mp_path": mp_counts[name],
            "launches_mp2_path": mp2_counts[name],
            "launches_resilience_path": rs_counts[name],
            "launches_obs_path": obs_counts[name],
            "launches_spec_path": tf_paths["spec"][name],
            "launches_prefix_path": tf_paths["prefix"][name],
            "launches_vit_path": tf_paths["vit"][name],
            "launches_ring_path": tf_paths["ring"][name],
            "launches_moe_path": fam_paths["moe"][name],
            "launches_moe_train_path": fam_paths["moe_train"][name],
            "launches_qnn_path": fam_paths["qnn"][name],
            "launches_resnet_path": rn_paths["resnet"][name],
            "launches_resnet_train_path": rn_paths["resnet_train"][name],
            # read from the replicas' /metrics, not this process (21)
            "launches_fleet_path": sum(c[name]
                                       for c in fleet_paths.values()),
            "launches_fleet_classifier_path":
                fleet_paths["fleet_classifier"][name],
            "launches_fleet_lm_path": fleet_paths["fleet_lm"][name],
            # a process that booted from the AOT store (22)
            "launches_aot_path": sum(c[name] for c in aot_paths.values()),
            "launches_aot_classifier_path":
                aot_paths["aot_classifier"][name],
            "launches_aot_lm_path": aot_paths["aot_lm"][name],
            "launches_aot_train_path": aot_paths["aot_train"][name],
            "launches_in_graphs": (in_graphs.get(name, 0)
                                   + dpc_in_graphs.get(name, 0)),
            "max_abs_err": max_err,
            "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_peak": row["bound_peak"],
            "library_ms": row["library_ms"],
            "shape": shape,
        }
        if name == "xnor":   # K1 at the conv path's shapes (phase 10)
            entry["conv_shapes"] = conv_rows
            entry["mp_shapes"] = mp_k1_rows   # and the TP shards' (14)
            entry["vit_shapes"] = vit_rows    # and the ViT's (18)
            entry["moe_shapes"] = moe_rows    # and the MoE's (19)
        if name in ("xnor", "xnor_sign"):   # the ResNets' shapes (20)
            entry["resnet_shapes"] = [r for r in rn_rows
                                      if r["kernel"] == name]
        elif name in FLASH:  # K4-K6 at the ring's per-rank shapes (18)
            entry["ring_shapes"] = [r for r in ring_rows
                                    if r["kernel"] == name]
        elif name == "paged_attn":   # K8's verify entry on the spec path
            entry["launches_verify"] = verify_k8
        print(json.dumps({"kernel": name, "kernel_ms": entry["ms"],
                          "plain_ms": entry["plain_ms"],
                          "library_ms": entry["library_ms"],
                          "launches": entry["launches"]}), flush=True)
        kernels.append(entry)
    print(json.dumps({"phase_s": PHASE_S, "total_s": round(
        time.perf_counter() - t_main, 1)}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
