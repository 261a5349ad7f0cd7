#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA
H100: the quickest proof that the port still builds, serves and trains on
the GPU.

    python3 chip_smoke.py

Every serving engine runs its steps as CUDA graph replays (the port's
default; ``paddle_tpu_torch/jit/programs.py``).  A phase that times or
counts a serve first calls the engine's ``warmup()`` (every graph captured
before the serve) and then zeroes the kernels' launch counts, which count
each replay's launches.

Phases (any failure exits non-zero before the result lines):

0. build every CUDA kernel of the ported paths from ``paddle_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once; ptxas's register and spill
   report printed, and the dynamic shared memory of the wgmma flash
   kernels, the ragged tile kernel, the paged decode kernel (with its tile
   size) and the LN backward (with its warps a block));
1. kernel vs plain version on the card: the ragged paged attention kernel
   against ``ragged_attention_ref`` at gpt2-small attention shapes (nh 12,
   hd 64, bs 16, T 256, S 8, C 32) over a pack that mixes decode rows,
   prefill chunks, a zero-length sequence, padding rows and left pads of
   more than one block — bf16, fp16, fp32 and int8 pools (plus hd 128);
   a decode-only pack whose rows reach the table's last column (C*bs - 1)
   in bf16 and int8, the mixed pack's 256 rows in a random order, and one
   prefill chunk of 256 rows of one sequence at hd 128.  Real rows within
   the dtype's tolerance, padding rows and rows inside their pad zero;
2. card vs CPU: the port's ragged engine at gpt2-small width with 2 layers
   in fp32 serves the same 4 requests × 16 greedy tokens on both devices
   from the same weights; the streams must be equal, or diverge only where
   the CPU's top-2 logit gap is under 1e-3;
3. the full-width serve: gpt2-small (12 layers, bf16) with the repo's
   ``gpt_serving`` traffic (24 requests of 32-128 prompt tokens and 48-96
   new tokens, 8 slots, max_len 512, block 16, token budget 256, prompt
   buckets [64, 128], 2 arrivals per step) and a short int8-pool run;
   every request gets exactly its tokens, the allocator balances, and the
   kernel launched exactly 12 times per ragged step.  A warm-up serve of
   the same traffic traces 20 mid-run steps with ``torch.profiler`` and
   prints device time by kernel and the device's busy share (graph
   replays show their kernels one by one).

4. flash kernels vs plain versions on the card: ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` (through ``_FlashAttention``'s
   autograd) against ``flash_fwd_ref`` and its PyTorch autograd, in fp32,
   fp16 and bf16, causal and not, L 64/128/192/256/512/1024 (64 and 192
   are not multiples of the 16-bit kernels' 128-row tiles), with a key
   mask that drops ~30% of the keys plus a run longer than a 64-key tile
   (or one covering a whole 128-key tile), with dropout 0.1, and at head
   dim 128 in fp16, bf16 and fp32 (bf16 causal L 1024 with dropout the
   heaviest dQ case).  O within 2e-5 (fp32) / 2e-2 (16-bit), lse within
   1e-4, gradients' max abs error relative to the plain gradient's max
   abs within 1e-4 (fp32) / 3e-2 (16-bit); ``flash_attention`` with a key
   mask that is a view 4 bytes into its storage, held to the same
   tolerances; and ``flash_fwd`` as the serving admission prefill calls
   it (B 1, L 128, 12 heads, causal, the left-pad key mask, pads
   0/1/37/64, bf16 and fp32), its real rows against the plain version at
   the same tolerances;
5. card vs CPU: ``make_gpt_train_step`` at gpt2-small width with 2 layers
   in fp32, B 2, L 256, AdamW(3e-4, wd 0.01), 5 steps from the same
   weights on both devices: losses within 1e-4 relative, final parameters
   within 3e-3 (5 steps x 2·lr: Adam's normalised step can turn a last-bit
   gradient difference on a near-zero gradient into up to 2·lr);
6. the full-width train: ``bench.py``'s gpt2s config (vocab 50304, hidden
   768, 12 layers, 12 heads, bf16 compute, fp32 params, B 16, L 1024,
   remat off, AdamW(3e-4, wd 0.01), tokens from RandomState(0)): 3 warm-up
   steps, 3 traced by ``torch.profiler``, 10 timed; every loss finite, the
   last below the first, exactly 12 launches of each flash kernel a step;
7. fused kernels vs plain versions on the card: ``fused_ln_fwd`` and
   ``fused_ln_bwd`` (through ``_FusedLN``'s autograd) against
   ``ln_fwd_ref``/``ln_bwd_ref`` in fp32, fp16 and bf16, H 64/768/1024/100,
   N 8192/24/200, with and without bias and the rout cotangent, dropout 0
   and 0.1 (the keep pattern equal to the plain version's exactly), and
   for the persistent backward fewer rows than its grid's warps (N 1000),
   a row count no multiple of them (N 5000, N 4099 at H 100 on the scalar
   path), operands misaligned by one element (the scalar path), fp32 H
   1024 and a row too wide for registers (bf16 H 2000): out
   and rout within 2e-5 (fp32) / 2e-2 (16-bit), gradients within 1e-4 /
   3e-2 of the plain gradient's max abs; the backward launched twice on
   the same inputs gives the same bits; ``fused_adamw_flat`` over 3 steps
   at BERT-base's 110,111,042 parameters in fp32 (1e-6 of the max abs) and
   one bf16-parameter case;
8. card vs CPU: ``make_bert_train_step`` at bert-base width with 2 layers
   in fp32 and ``FLAGS_use_fused_ln`` on, B 2, L 128, AdamW(1e-4, wd
   0.01), 5 steps from the same weights: losses within 1e-4 relative,
   final parameters within 3e-3; ``forward`` with a padding mask, h and
   pooled within 1e-4;
9. the full-width BERT train: ``bench.py``'s bert_base TPU config uncut
   (vocab 30528, hidden 768, 12 layers, 12 heads, max_pos 512, bf16
   compute, fp32 params, B 16, L 512, remat off, AdamW(1e-4, wd 0.01),
   ids and labels from RandomState(0)) with ``FLAGS_use_fused_ln`` on: 3
   warm-up steps, 3 traced, 10 timed; every loss finite, the last below
   the first, exactly 24 launches each of ``fused_ln_fwd``/``fused_ln_bwd``
   and 12 of each flash kernel a step; then, on the same model, 1 warm-up
   and 3 traced steps with the flag off (the reference's default path) and
   10-step windows off, off, on, so the timed windows alternate on, off,
   off, on;
10. paged decode kernel vs plain version on the card:
   ``paged_decode_attention_cuda`` against ``paged_decode_attention_ref``
   in bf16, fp16 and fp32, hd 64 and 128, block sizes 4, 16 and 32, with
   and without left pads, over slots whose clocks include 0 and
   ``C*bs - 1``, one all-trash table row, one parked clock past the table
   (``t // bs >= C``) and one row with nothing to attend (zeros), the serve
   shape in bf16 and fp32, tiles spanning several pool blocks at the
   serve's 12 heads (bs 4), fp32 hd 128 at 12 heads (4-position tiles) and
   slots whose ranges leave whole tiles skipped at both ends: every
   element within 2e-5 (fp32), or 2e-5 plus one ulp of the element (2^-7
   of it in bf16, 2^-10 in fp16); two launches on the serve case give the
   same bits;
   and the ragged kernel on a pack of one decode row per slot agrees with
   it within the same tolerance;
11. card vs CPU for the bucketed engines: gpt2-small width, 2 layers, fp32,
   6 requests x 24 greedy tokens through ``PagedContinuousBatchingEngine``
   (``ticks_per_sync=2``, prompt buckets 64 and 128 so that half the admission prefills go
   through ``flash_fwd`` on the card, a 28-block pool small enough to
   preempt) with
   ``prefill_chunk`` off and 32, on both devices; on the card also the
   contiguous engine, solo ``generate()`` and the ragged engine.  Every
   pair of streams must be equal, or diverge only where the CPU's top-2
   logit gap is under 1e-3.  One int8-pool run on both devices: the same
   rule, and the paged kernel's launch count must not move (int8 pools
   take the gather path);
12. the full-width bucketed paged serve: gpt2-small (vocab 50304, 12
   layers, max_pos 1024, bf16) under ``tools/serve_bench.py``'s
   accelerator settings uncut (8 slots, one prompt bucket of 128, 24
   prompts of 64-128 tokens from ``RandomState(0)``, budgets
   ``[64, 128, 256, 512] * 6`` = 5760 tokens, ``ticks_per_sync=8``, block
   32, ``max_len`` 640, every request queued up front): every request gets
   exactly its budget, the allocator balances, the paged kernel launched
   exactly 12 x the decode ticks and ``flash_fwd`` 12 x 24 times.  A
   warm-up of the serve's first 60 syncs traces the last 20 with
   ``torch.profiler``.  Then the same requests through the contiguous
   engine and through batched ``generate()`` with a prompt mask (the
   bench's static arm), each warmed by one batch of 16-token budgets;
13. the prefix cache at full width: ``bench.py bench_gpt_kv_tier``'s
   settings without the tiered store (gpt2-small bf16, 4 slots, max_len
   512, block 16, token budget 64, buckets [64, 256], one 240-token
   prompt from ``RandomState(0)``, 16 new tokens, 5 repeats) through a
   cold ragged engine and a warm one (cache on, primed once): TTFT p50 of
   each printed, 5 hits of 15 blocks, warm streams equal to cold or
   diverging only at a bf16 near-tie (top-2 gap under 2^-5, printed), the
   allocator balanced (blocks in use = cached blocks, 0 after
   ``flush_prefix``), the ragged kernel launched 12 times a step; then
   the bucketed paged engine with the cache on hits on its second serve
   of the prompt (the paged kernel 12 launches a tick, ``flash_fwd`` 12
   for the one cold admission);
14. speculation at full width: phase 3's traffic and settings with
   ``draft_model=model`` (a self-draft, as ``bench.py``'s speculative
   arm) and ``draft_k=4``: every request gets exactly its tokens, the
   allocator balances, acceptance >= 0.5, each stream equals phase 3's or
   diverges at a bf16 near-tie; the ragged kernel launched (12 + 12)
   times a step (target pass and draft ingest) and the paged decode
   kernel 4 x 12 times a step (the draft's proposals, in every step's
   program); a
   warm-up serve traces 20 steps, plain and speculative serves are timed
   back to back, then an int8-pool speculative serve of 8 requests (no
   paged-kernel launch: int8 pools take the gather path);
15. per-request sampling at phase 12's settings: its first 12 requests as
   greedy, greedy with repetition_penalty 1.3, min_new_tokens 16 and an
   EOS, and sampled (temperature 0.8, top_k 50, top_p 0.95), twice from
   one generator seed through the bucketed engine and twice through the
   ragged engine: identical serves, budgets and EOS windows held, greedy
   rows equal to each engine's greedy-only serve or diverging at a bf16
   near-tie, launches exact; then card vs CPU at gpt2-small width with 2
   layers in fp32 (6 requests x 24 tokens, both engines): greedy and
   penalised rows equal, or diverging where the CPU's processed top-2 gap
   is under 1e-3;
16. the programs as CUDA graphs against eager (``disable_graphs()``) at
   full width: phase 3's ragged serve, the same with a self-draft at K 4,
   phase 12's bucketed paged serve and the contiguous engine at phase
   12's settings, each warmed and served both ways: no program built
   while serving, budgets held, launches exact (B1 L a ragged step and 2L
   a speculative one, B5 K x L a speculative step and L a bucketed tick,
   B2 L an admission), streams equal or diverging at a bf16 near-tie;
   per mode the warmup wall, the graph pool's memory, ms a step, tokens/s
   and a 10-round device profile; then per-request sampled serves (phase
   15's three kinds, one seed) through the ragged and the bucketed paged
   engine draw identical tokens both ways;
17. GPT generation and the tiered KV page store at gpt2-small width (vocab
   50304, 12 layers, bf16, seed 0): batched ``generate()`` (B 8, P 128,
   128 new tokens) greedy and sampled (t 0.8, top_k 50, top_p 0.95),
   each with graphs and under ``disable_graphs()``: tokens equal both
   ways, the memoised programs reused at the second call, ``flash_fwd``
   L times a call, ms/token and tokens/s printed; ``generate_beam`` (B 2,
   P 64, 64 new tokens, 4 beams, an EOS the best beam reaches) graphs
   against eager (sequences equal, scores within 1e-4), finished beams
   frozen at their EOS, one beam equal to greedy ``generate()``;
   ``generate_speculative`` greedy at K 4 (B 4, P 128, 128 new tokens)
   with a self-draft and with the target's first two layers as the
   draft, streams equal to greedy ``generate()`` or diverging at a bf16
   near-tie, rounds, acceptance and tokens/s against ``generate()``
   printed, the fp32 self-draft's rounds exactly ceil((N - 1)/(K + 1)),
   and one sampled run; ``save_generate_program`` then
   ``load_generate_program`` under a temporary directory, the loaded
   function's tokens equal to ``generate()``'s; then ``bench.py
   bench_gpt_kv_tier``'s settings uncut (4 slots, max_len 512, block 16,
   token budget 64, buckets [64, 256], one 240-token prompt, 16 new
   tokens, 5 repeats) through the ragged and the bucketed paged engine:
   cold (no cache), a ``TieredKVStore()`` flushed before each repeat (each
   hit a DRAM restore of 15 pages) and one whose DRAM holds less than a
   page over a disk directory (each hit a disk restore): streams equal
   to solo ``generate()`` or diverging at a near-tie, no program built
   while serving, ``kvio`` in the grid, 16 blocks demoted and 15 restored
   a repeat, the allocator balanced, a page from the card round-tripping
   ``to_bytes`` bit for bit, the kernels launched L times a step; TTFT
   p50 cold, DRAM restore and disk restore printed.
18. telemetry at full width (gpt2-small bf16, seed 0): phase 3's ragged
   serve with graphs, untraced and traced (``telemetry.Tracer``), served
   in the order untraced, traced, traced, untraced: token streams equal,
   no program built while serving and every compile event of the
   warmup ``expected``, each request's tracer TTFT inside its host
   interval from ``add_request`` to the ``on_token`` of its first token;
   TTFT and ITL p50/p99 under the 2-arrivals-a-step load, traced against
   untraced ms/step and each traced serve's goodput (a ``RunLedger``
   reset just before it; its ``compute`` equal to the serve's tick walls)
   printed;
   a ``MemoryLedger`` census of that engine (``kv_pages`` bytes equal to
   the pools', ``params`` to the parameters', ``device_allocator_stats()``
   non-empty, ``torch.cuda.memory_allocated()`` beside it); phase 12's
   bucketed paged serve traced (tick ``decode_rows`` x ``ticks_per_sync``
   equal to the tokens emitted, launches exact); phase 6's gpt2s step
   under a ``TrainMonitor`` and a ``RunLedger`` for 4 steps and one loss
   fetch (1 compile event, 3 step samples of B·L tokens, the monitor's
   tokens/s beside the wall clock's, the goodput), then 2 more monitored
   steps under a host-side ``torch.profiler`` trace: each step's host
   dispatch and the CUDA runtime calls by their host time.
19. ERNIE-MoE (``bench.py bench_ernie_moe``'s accelerator config: vocab
   30528, hidden 768, 6 layers, 12 heads, 8 experts, top-2, expert hidden
   3072, max_pos 512, bf16, weights from seed 0) and the optimizer
   surface: (1) card vs CPU at hidden 768, 8 experts, 2 layers, fp32, B 2,
   L 256, 3 steps of AdamW under LinearWarmup(CosineAnnealingDecay) with
   ClipGradByGlobalNorm(1.0) from the same weights: losses within 1e-4
   relative, final parameters within 1e-5 and their change within 1e-2
   of its largest element, routing flips (tokens whose
   top-2 experts differ, before and after training) only where the CPU's
   k-th and next gate probabilities are within 1e-5; (2) the full-width
   train at B 8, L 512, AdamW(1e-4, wd 0.01), remat off: 3 warm-up steps,
   3 profiled, 10 timed, losses finite and falling, 6 launches of each
   flash kernel a step; (3) phase 3's traffic through the ragged engine
   with graphs (B1 6 a step, the graph pool printed), 4 streams against
   ``generate()``, then again with a 1-layer GPT draft at K 2 (B1 7 and
   B5 2 a step, streams equal to the plain arm's); (4) its first 8
   requests through the bucketed paged engine (ticks_per_sync 8; B5 6 a
   tick, B2 6 an admission at bucket 128, streams equal to the ragged
   arm's); the decode
   FFN's every-expert form timed against the literal per-token gather at
   T 1, 8 and 256; (5) the ten optimizers for 3 eager ``step()`` calls
   with no clip and each clip, card vs CPU in fp32 within 1e-6 + 1e-5 of
   the value.  A bf16 stream here may leave another where the top-2
   logit gap is under 2^-5, or at a routing flip that roundings alone
   caused: both paths of the request are replayed alone and eagerly with
   routing recorded (each replay must reproduce its stream), the flips
   of the shared context are found, and each root flip's gate-logit gap
   must be under 2^-5 too.
20. the serving fleet over the engines (gpt2-small bf16, seed 0, graphs,
   every engine warmed): (a) ``bench_gpt_gateway``'s accelerator cell,
   uncut: two ragged replicas (4 slots, max_len 256, block 16, budget
   128, bucket 64) behind a ``ServingGateway``, 48 requests of 32-64
   prompt and 24-48 new tokens, two arrivals a gateway step, a warm run,
   an unbounded arm and a bounded arm (depth 4) carrying an
   ``SLOMonitor`` and an unstarted ``OpsServer`` scraped by a
   ``FleetCollector``: no silent drops, every shed structured, no block
   in use at quiescence, shed only when bounded, bounded TTFT p99 below
   unbounded, no program built while serving, B1 L times a ragged step;
   (b) a prefill-role and a decode-role ragged replica (with a
   ``TieredKVStore``) serve ``bench_gpt_kv_tier``'s 240-token prompt 3
   times: one migration of 15 pages a serve, restored on the decode
   replica, its stream equal to a ragged engine's after an HBM prefix
   hit and to the cold unified stream or at a near-tie; (c) phase 3's
   24 requests through two ragged replicas and one bucketed paged, each
   a ``FaultyEngine`` on the real clock under ``bench_gpt_chaos``'s
   ``ResiliencePolicy``, with a crash of one ragged replica at 0.2 s and
   dispatch errors on the other for 0.4 s: every request terminal,
   retries within budget, the faults in the resilience counters and a
   quarantine, each finished stream a prefix of the unfaulted fleet's
   (or at a near-tie); (d) an ``OpsServer`` on 127.0.0.1 port 0 over
   (a)'s bounded gateway: ``/healthz?probe=1`` runs ``compute_probe()``
   on the card, and a ``FleetCollector`` scraping it over HTTP rolls up
   a TTFT p99 within the sketch's 2% of the gateway's own; (e)
   ``bench_gpt_autoscale``'s and ``bench_gpt_chaos``'s simulated A/Bs on
   the port's modules with their contracts.
21. data parallelism at gpt2-small width (vocab 50304, hidden 768, 12
   heads, bf16, weights from seed 0): (a) ``bench_gpt_grad_comm``'s
   accelerator cell over NCCL at world size 1 (``init_parallel_env()``,
   ``fleet.init``, ``make_sharded_gpt_train_step``, 12 layers, B 16, L
   1024), fp32, bf16 and int8_ef, each 2 warm-up and 10 timed steps: the
   wire savings equal ``wire_bytes``' formula, every loss finite, the
   int8_ef curve within 0.02 of fp32's; then one spawn of two ranks that
   share the card over gloo (NCCL refuses two ranks on one device; gloo
   copies through pinned host memory where it takes no CUDA tensor):
   (b) ``bench_gpt_weight_update_sharding`` at R 2 (12 layers, B 16 as 8 a
   rank, L 1024), the replicated and the update-sharded arm, 1 warm-up and
   3 timed steps each: opt-state bytes a replica cut >= 1.8x by
   ``per_device_state_bytes`` and by a ``MemoryLedger`` census, final
   losses within rtol 1e-4, atol 1e-6; (c) ZeRO stages 1, 2, 3 and offload
   at 2 layers, B 8, L 1024, each 3-step curve within 1e-2 relative of one
   rank's on the whole batch, the offload state on pinned host memory, an
   inf in rank 0's rows skipping the step on both ranks (loss scale halved,
   step counter kept), and BERT-base at 2 layers with the fused LN over dp
   2 against one rank; (d) ``TrainMonitor.aggregate()`` over (b)'s sharded
   arm (world 2, the summed steps and tokens, straggler skew >= 1.0) and
   ``RunLedger.aggregate()`` agreeing with it.
22. crash-consistent training (``train_resilience``, the sharded
   checkpoint, the TCP store, the launcher) at gpt2-small width (vocab
   50304, bf16, fp32 parameters, weights from seed 0): (a)
   ``bench_gpt_train_resilience``'s accelerator branch uncut (12 layers,
   B 16, L 1024, AdamW, 24 steps, a save every 6, ``alloc_fail`` at step
   9, a torn write of save 1, preempted at step 15): the uninterrupted
   oracle under a ``TrainSupervisor``, a supervisor-off run that dies at
   the fault, the supervised chaos run and a fresh supervisor that
   resumes from the emergency checkpoint: resumed losses and final
   parameters equal the oracle's bit for bit, the torn step skipped as
   ``uncommitted`` and never loaded; the bench's record, one save's
   snapshot, write, fsync, digest and commit seconds and its bytes, the
   free disk (the roots removed after); (b) the elastic rescale at 2
   layers (B 8, L 1024, ZeRO-2): a state saved by two gloo ranks sharing
   the card resumes on 1 rank and on 2, one saved by 1 rank on 2; the
   next 3 losses equal the uninterrupted run of the same layout exactly
   and the other layout's within 1e-3 relative; replicated leaves written
   once (rank 0), the moments split, each rank's bytes printed; (c)
   ``python -m paddle_tpu_torch.distributed.launch --nproc_per_node 2
   --devices 0,0 --backend gloo --elastic_level 1`` with the TCP store it
   hosts, a 2-layer ZeRO-2 trainer (B 4, L 256) under the supervisor:
   rank 1 SIGKILLs itself after the step-4 commit, the pod restarts and
   both ranks resume at step 4 with losses equal to an unkilled launch's
   (each launch under its own timeout).
23. vision training (``nn``'s conv, BatchNorm, pooling and linear
   layers, ``F.cross_entropy``, ``vision.models``) through the port's
   ``make_train_step`` with ``Momentum(momentum=0.9, weight_decay=1e-4)``,
   as ``bench.py``'s ``_vision_step`` builds it, weights from seed 0: (a)
   ``bench_resnet50``'s accelerator cell uncut (``resnet50(data_format=
   "NHWC")``, 1000 classes, B 128, a 224x224x3 bf16 input, fp32
   parameters, lr 0.1), 2 warm-up steps, a 2-step device profile and 10
   steps timed with CUDA events: ms/step p50 and range, imgs/s, peak
   memory, conv1's output dtype (bf16) and the logits' (fp32; the first
   BatchNorm's fp32 weight promotes everything after the stem), every
   loss finite and all 106 running statistics moved; (b)
   ``bench_mnist_lenet``'s (``LeNet``, B 512, 1x28x28 fp32, lr 0.01), 3
   warm-up and 30 timed steps, the same numbers; (c) card vs CPU from one
   set of weights: ``resnet50(num_classes=10)`` NHWC at B 8, 64x64 in
   float64 for one step (the loss, every parameter and every running
   statistic within 1e-8 of the CPU's, relative to 1 + |value|), and
   ``LeNet`` at B 64 in fp32 for 3 steps (losses within 1e-4 relative).
   No kernel of the port runs here: cuDNN convolutions and plain PyTorch
   pooling and BatchNorm, as XLA computed them for the reference.
24. the other eight vision families with dropout drawn from the step key
   (``core.rng``'s threefry, ``nn.Dropout``, ``vision.models``), through
   phase 23's step: (a) each at its published width and 1000 classes
   (``alexnet``, ``vgg16``, ``squeezenet1_1``, ``mobilenet_v2``,
   ``googlenet``, ``inception_v3``, ``densenet121``,
   ``shufflenet_v2_x1_0``), B 32, a 224x224x3 fp32 input (299x299x3 for
   InceptionV3), lr 0.1 with BatchNorm and 0.01 without (AlexNet, VGG,
   SqueezeNet; ``bench.py``'s rates for its resnet50 and LeNet cells),
   step keys ``fold_in_step_key(base, t)``: 2
   warm-up steps, a 2-step device profile (the cuDNN/cuBLAS share) and 5
   steps timed with CUDA events: ms/step, imgs/s, peak memory, the
   convolutions' bound and the ratio to it, every loss finite and every
   running statistic moved; (b) card vs CPU from one set of weights, each
   family with 10 classes at B 4, 64x64 (112x112 for InceptionV3: at
   80x80 its 1x1 maps leave its last BatchNorms 4 values), float64, 2
   steps with the same step keys, so the dropout masks are compared
   too: losses, parameters and running statistics within 1e-8 relative
   to 1 + |value|; (c) one ``F.dropout`` of a (4096, 4096) fp32 tensor
   at p 0.5 under one key: the card's keep-mask bit-equal to the CPU's,
   its keep rate within 1e-3 of 0.5, and its time (CUDA events over 10
   calls).  No kernel of the port runs here: the masks are plain int64
   PyTorch arithmetic (the reference drew them through XLA's threefry,
   not a Pallas kernel).
25. tensor and sequence parallelism at gpt2s width (12 layers, B 8, L
   1024, bf16): mp 2, sep 2 ring and sep 2 Ulysses on two gloo ranks
   sharing the card against the one-rank step (losses within 1e-3
   relative, the weights' move, B2-B4 launches a rank, the bytes a rank
   holds, gloo's share of each step), and B2-B4 at the arms' 6-head shape
   against their plain versions.
26. the expert and model axes at bench widths, on gloo ranks sharing the
   card: ERNIE-MoE at ``bench_ernie_moe``'s widths (8 experts, top-2, B 8,
   L 512, bf16, remat on; C 1280) at ep 2 (dp 2, 4 experts a rank) and
   dp 2 x mp 2, ep 2 in fp32 at 2 of its 6 layers (losses within 1e-4
   relative, root flips under 1e-5, as phase 19's card against the CPU),
   and BERT at ``bench_bert_base``'s (12 layers, B 16, L 512,
   bf16, fused LN on, a padding mask) at mp 2; 3 steps each from the
   one-rank step's weights: losses within 1e-3 relative of it at the
   first step and within 1e-3 or a quarter of its drop after, ERNIE's
   root routing flips (nothing upstream of the token routed otherwise)
   only where the one-rank top-2 gap is under 2^-5, B2-B4
   (and B6-B7 for BERT) launches a rank, the bytes a rank holds, each
   step's time split into gloo and the rest, the bytes into gloo by
   collective and the host-staged copies; B2-B4 at the two new shapes
   against their plain versions.
27. the pipe axis at gpt2s width (B 8, L 1024, 4 micro-batches of 2 rows,
   AdamW 3e-4, remat off), on gloo ranks sharing the card: pp 2 1F1B, pp
   2 x V 2 interleaved and pp 2 x mp 2 (four ranks) at 12 layers in bf16,
   and pp 2 in fp32 at 4 layers; 3 steps each from the one-rank step's
   weights: the bf16 arms' losses held as phase 26's and the weights'
   move as phase 25's, the fp32 arm's losses and each rank's blocks of
   the parameters (by the norm over them all) within 1e-5 relative of the
   one-rank step's; B2-B4
   launches a rank (its layers times the micro-batches), each step's time
   split into gloo (the p2p exchanges apart) and the rest, the bytes a
   rank holds against one rank's; B2-B4 at a micro-batch's shapes
   against their plain versions.

28. data-parallel vision on gloo ranks sharing the card (resnet50,
   SyncBatchNorm, the vision families' dropout rows) and the
   normalization layers card vs CPU.
29. the eager surface a user's own model touches: (a) an encoder at
   ``bench_bert_base``'s widths (vocab 30528, d 768, 12 heads, ff 3072,
   12 post-LN ``nn.TransformerEncoderLayer``s with gelu, token and
   position ``nn.Embedding``s, an ``nn.Linear`` head, bf16) trained
   eagerly with ``nn.CrossEntropyLoss``, ``backward()`` and the eager
   AdamW (multi_precision) at B 16, L 512 with a (B, 1, 1, L) bool
   key-padding mask (odd rows drop their last 64 keys), dropout and
   attention dropout 0.1: 2 warm and 5 timed steps on one batch, every
   loss finite and the fifth timed below the first, exactly 12 launches
   of each flash kernel a step; ``paddle_tpu_torch.grad`` of the loss in
   the token embedding against its ``.grad`` from a separate backward
   (bf16 tier, ``.grad`` untouched); (b) the same layers at 2 layers and
   full width (B 2, L 128, both dropouts, one seed) on the card against
   the CPU: the loss and every parameter's gradient within 1e-4 (fp32,
   TF32 off) and 2e-2 (bf16) of the tensor's scale; (c) every function
   and layer of the slice (activations, losses, common functionals and
   layers, the tensor namespace, ``MultiHeadAttention`` and the
   ``Transformer*`` layers, the flash rows on the kernels) card vs CPU in
   fp32 within 1e-5 of each tensor's scale, integer, bool and index
   outputs exactly; (d) ``save``
   of (a)'s trained ``state_dict`` and ``load`` into a fresh model on the
   card: logits bit-equal, bytes and seconds printed.
30. the random surface, the RNNs and beam search, with no kernel of the
   port on the path (the phase fails if any of the eight launches): (a)
   every ``core.rng`` law at 2^20 draws on the card against the same
   draw on the CPU — bits, uniforms (f32, bf16, fp16, f64 on [0, 1)),
   bernoulli, randint and permutation bit-equal, f64 uniform on other
   bounds within 1 ulp, normal, truncated normal and exponential within
   4 ulp, gumbel within 4 ulp of max(1, |x|), categorical, poisson and
   binomial flipping at most 1e-4 of the draws; one 4096^2 uniform,
   normal and randint draw timed against its bytes bound; (b) the PTB
   "medium" LSTM language model of Zaremba, Sutskever & Vinyals 2014
   (vocab 10000, 2 layers of 650, 35 steps, batch 20, dropout 0.5, SGD lr
   1 with a global-norm clip of 5, the layers' default initializers)
   built on the card after ``seed(0)`` bit-equal to the CPU build, 2 warm
   and 5 timed eager steps on Zipf-distributed tokens (ms/step,
   tokens/s, peak memory), and card vs CPU at 2 layers of 64 (losses and
   gradients within 1e-5 of their scale, the dropout masks drawn alike);
   (c) ``dynamic_decode`` of a ``BeamSearchDecoder`` over
   ``LSTMCell(650, 650)`` with (b)'s embedding and head, beam 4, batch
   20, 35 steps: ms a call, ids equal the CPU's but where a row leaves
   them at a step whose top candidates lie within 1e-4 (printed), the
   other rows' log-probs within 1e-4.

Then each kernel is timed at its main path's shapes beside its plain
version, one PyTorch call computing the same function (``library_ms``,
timed here and never called by the port: ``scaled_dot_product_attention``
over the gathered dense K/V for the ragged and the paged decode kernels,
its forward for
``flash_fwd``, its backward for the dQ and dK/dV pair, whose two rows
share that one number, each flash line with the kernel's ratio to it, and
``flash_fwd`` also at the admission prefill's shape (B 1, L 128); ``F.layer_norm`` on the pre-added rows, LN
alone, for the fused LN forward and its autograd backward for the LN
backward; ``torch._fused_adamw_`` on one flat tensor for the AdamW sweep)
and its memory/compute bound.  Every launch runs with the L2 cache
flushed.  The kernels JSON counts the main paths' launches (phases 3, 6,
9 and 12) plus phase 17's (``flash_fwd`` in generation's prefills, the
ragged and paged decode kernels in the tiered store's serves) and phase
18's (the ragged kernel in its four serves, the paged decode kernel and
``flash_fwd`` in its bucketed serve, the three flash kernels in its 6
train steps) and phase 19's (the ragged kernel in its two ERNIE-MoE
serves, the paged decode kernel in the bucketed one and in the draft's
proposals, ``flash_fwd`` in the bucketed admissions, the three flash
kernels in the 10 timed ERNIE-MoE train steps) and phase 20's (the
ragged kernel in the gateway's two timed arms, the disaggregated serves
and the faulted fleet, ``flash_fwd`` and the paged decode kernel in the
faulted fleet's bucketed replica) and phase 21's (the three flash
kernels in (a)'s 36 steps and, on both ranks, in (c)'s GPT and BERT
arms; the fused LN kernels in (c)'s BERT arm) and phase 22's (the three
flash kernels in every step of 22a and of 22b's two ranks) and phases
25's, 26's and 27's (the three flash kernels on every rank of their
arms, the fused LN kernels on 26's BERT ranks) and phase 29's (the three
flash kernels in (a)'s 5 timed eager steps).  The last two lines are the
kernels JSON and the device JSON.

Without CUDA, or run without the rest of the repository, it exits
non-zero and prints no result.
"""

import contextlib
import gc
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense, per the H100 SXM data sheet
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-2, torch.float32: 2e-5}
GRAD_TOL = {torch.bfloat16: 3e-2, torch.float16: 3e-2, torch.float32: 1e-4}
LSE_TOL = 1e-4             # fp32 in every case, other summation order
KERNEL_SOURCE = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
KERNEL_REPLACES = "paddle_tpu/ops/ragged_paged_attention.py:77"
FLASH_SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"flash_fwd": "paddle_tpu/ops/attention.py:103",
                  "flash_bwd_dq": "paddle_tpu/ops/attention.py:241",
                  "flash_bwd_dkv": "paddle_tpu/ops/attention.py:273"}
FUSED_SOURCE = "paddle_tpu_torch/csrc/fused.cu"
FUSED_REPLACES = {"fused_ln_fwd": "paddle_tpu/ops/fused.py:52",
                  "fused_ln_bwd": "paddle_tpu/ops/fused.py:75",
                  "fused_adamw_flat": "paddle_tpu/ops/fused.py:263"}
PAGED_SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
PAGED_REPLACES = "paddle_tpu/ops/paged_attention.py:30"
BERT_PARAMS = 110_111_042          # bench_bert_base's parameter count


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def say(*parts):
    print(*parts, flush=True)


def seed_build(n):
    """Seed a build: the port's layers draw their weights from
    ``core.rng``'s stream (``paddle_tpu_torch.seed``), anything else from
    torch's generator."""
    import paddle_tpu_torch
    torch.manual_seed(n)
    paddle_tpu_torch.seed(n)


# ------------------------------------------------------------- phase 1 --

# the phase-3 serve's pack: seq 0 has no rows; 1-4 decode one row; 5-7
# prefill chunks whose pads cover whole blocks (rows left of a pad attend
# nothing real)
MIXED_ROWS = [(s, p) for s, ps in {1: [100], 2: [250], 3: [511], 4: [37],
                                    5: range(0, 120), 6: range(64, 124),
                                    7: range(200, 270)}.items() for p in ps]
PACK_PADS = [0, 0, 17, 0, 3, 40, 20, 33]
# a decode-only step: one row a sequence, three at the table's last column
# (C * bs - 1), one inside its pad (zeros)
DECODE_ROWS = [(0, 511), (1, 511), (2, 256), (3, 255), (4, 128), (5, 64),
               (6, 1), (7, 511)]


def make_pack(dtype, quantized, seed, nh=12, hd=64, rows=MIXED_ROWS,
              shuffle=False):
    """One ragged pack at the serving step's shapes: S 8 sequences, 32
    table columns of 16-position blocks, T 256 rows: ``rows`` (sequence,
    position) pairs then padding rows, or with ``shuffle`` all 256 rows in
    a random order (sequences' rows out of order and interleaved)."""
    from paddle_tpu_torch.models._decode import quantize_kv

    dev = torch.device("cuda")
    S, bs, MB, T = 8, 16, 32, 256
    NB1 = S * MB + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(NB1, bs, nh, hd, generator=g, device=dev)
    v = torch.randn(NB1, bs, nh, hd, generator=g, device=dev)
    if quantized:
        pk, pv = quantize_kv(k), quantize_kv(v)
    else:
        pk, pv = k.to(dtype), v.to(dtype)
    table = (torch.randperm(NB1 - 1, generator=g, device=dev) + 1) \
        .view(S, MB).to(torch.int32)
    rows = list(rows) + [(-1, -1)] * (T - len(rows))
    if shuffle:
        order = np.random.RandomState(seed).permutation(T)
        rows = [rows[i] for i in order]
    row_seq = np.asarray([s for s, _ in rows], np.int32)
    row_pos = np.asarray([p for _, p in rows], np.int32)
    q = torch.randn(T, nh, hd, generator=g, device=dev).to(dtype)
    meta = [torch.from_numpy(a).to(dev)
            for a in (row_seq, row_pos, np.asarray(PACK_PADS, np.int32))]
    return dict(q=q, pk=pk, pv=pv, table=table, row_seq=meta[0],
                row_pos=meta[1], pad_lens=meta[2], rows=rows,
                pads=PACK_PADS, quantized=quantized)


def pack_args(c):
    return (c["q"], c["pk"], c["pv"], c["table"], c["row_seq"],
            c["row_pos"], c["pad_lens"])


def compare_pack(c, label):
    """Kernel vs plain on the real rows (a position at or past the row's
    pad); padding rows and rows inside their pad must be zeros.  Returns
    the max abs error."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    got = rpa.ragged_attention_cuda(*pack_args(c))
    want = rpa.ragged_attention_ref(*pack_args(c))
    torch.cuda.synchronize()
    real = [i for i, (s, p) in enumerate(c["rows"])
            if p >= 0 and p >= c["pads"][s]]
    zero = sorted(set(range(len(c["rows"]))) - set(real))
    g, w = got[real].float(), want[real].float()
    tol = TOL[c["q"].dtype]
    err = (g - w).abs().max().item()
    check(torch.isfinite(got).all().item(), f"{label}: non-finite output")
    check(torch.allclose(g, w, rtol=tol, atol=tol),
          f"{label}: kernel vs plain max abs err {err} > tol {tol}")
    check(not zero or got[zero].abs().max().item() == 0.0,
          f"{label}: padding rows or rows inside their pad are not zero")
    say(f"phase1 {label}: rows {len(real)} max_abs_err {err:.3e} "
        f"(tol {tol}), {len(zero)} zero rows")
    return err


def pack_bound(c):
    """Least time for the pack's work: each sequence's K/V over
    [pad, deepest row] read once, q read and out written once, metadata
    read once — over the memory rate; 4·nh·hd flops per (row, position)
    over the peak rate of q's type.  Returns (ms, "bytes"|"operations")."""
    q = c["q"]
    T, nh, hd = q.shape
    deepest = {}
    flops = 0
    for s, p in c["rows"]:
        if p >= 0 and p >= c["pads"][s]:
            deepest[s] = max(deepest.get(s, -1), p)
            flops += 4 * nh * hd * (p - c["pads"][s] + 1)
    per_pos = nh * hd * (1 if c["quantized"] else q.element_size())
    if c["quantized"]:
        per_pos += nh * 4                                   # fp32 scales
    positions = sum(p - c["pads"][s] + 1 for s, p in deepest.items())
    nbytes = (2 * positions * per_pos + 2 * q.numel() * q.element_size()
              + 4 * (c["table"].numel() + 2 * T + len(c["pads"])))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_cold_ms(fn, iters=30, warmup=3):
    """Mean device time of ``fn`` with the 50 MB L2 flushed before each
    launch.  A GPU spin (``torch.cuda._sleep``) queued ahead of the start
    event keeps the stream busy while the host runs ``fn``'s Python, so
    the events bracket device work only, not launch overhead."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for a, b in ev:
        flush.zero_()
        torch.cuda._sleep(20_000_000)              # ~10 ms at 2 GHz
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def time_pack(c):
    """(kernel ms, plain ms, library ms, bound ms, bound_by, plan ms) for a
    pack.  The kernel is timed as the main path calls it, with the pack's
    plan built beforehand (``decode_ragged`` builds it once for all 12
    layers); the plan's own time is the last entry."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models._decode import dequantize_cache
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    args = pack_args(c)
    plan = rpa.ragged_plan(*args[4:])
    ms = time_cold_ms(lambda: rpa.ragged_attention_cuda(*args, plan=plan))
    plan_ms = time_cold_ms(lambda: rpa.ragged_plan(*args[4:]))
    plain_ms = time_cold_ms(lambda: rpa.ragged_attention_ref(*args))
    # the library yardstick: SDPA over each row's gathered dense K/V with
    # a boolean mask of [pad, row_pos] — the gather is not timed
    q, table = c["q"], c["table"].long()
    S, C = table.shape
    seq = c["row_seq"].long().clamp(0, S - 1)

    def dense(pool):
        picked = (tuple(p[table] for p in pool) if isinstance(pool, tuple)
                  else pool[table])
        g = dequantize_cache(picked, q.dtype)
        g = g.reshape(S, C * g.shape[2], *g.shape[3:])[seq]
        return g.permute(0, 2, 1, 3).contiguous()         # (T, nh, K, hd)

    k, v = dense(c["pk"]), dense(c["pv"])
    col = torch.arange(k.shape[2], device=q.device)
    mask = ((col[None] <= c["row_pos"].long()[:, None])
            & (col[None] >= c["pad_lens"].long()[seq][:, None]))
    mask = mask[:, None, None, :]
    qs = q[:, :, None, :]
    library_ms = time_cold_ms(
        lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask))
    bound_ms, bound_by = pack_bound(c)
    return ms, plain_ms, library_ms, bound_ms, bound_by, plan_ms


def say_pack_time(label, t, card):
    say(f"timing {label} on {card}: kernel {t[0]:.4f} ms (plan built "
        f"beforehand, once a pack: {t[5]:.4f} ms), plain {t[1]:.4f} ms, "
        f"sdpa {t[2]:.4f} ms, bound {t[3]:.4f} ms ({t[4]})")


def phase1():
    """Every ragged case against the plain version; returns (the mixed bf16
    pack, its error, the int8 pack, the decode-only bf16 pack)."""
    main_pack = make_pack(torch.bfloat16, False, seed=0)
    err = compare_pack(main_pack, "bf16 pools")
    compare_pack(make_pack(torch.float16, False, seed=1), "fp16 pools")
    compare_pack(make_pack(torch.float32, False, seed=2), "fp32 pools")
    int8_pack = make_pack(torch.bfloat16, True, seed=3)
    compare_pack(int8_pack, "int8 pools, bf16 q")
    compare_pack(make_pack(torch.float32, True, seed=4), "int8 pools, fp32 q")
    compare_pack(make_pack(torch.bfloat16, False, seed=5, nh=6, hd=128),
                 "bf16 pools, hd 128")
    decode_pack = make_pack(torch.bfloat16, False, seed=6, rows=DECODE_ROWS)
    compare_pack(decode_pack, "decode-only to C*bs - 1, bf16 pools")
    compare_pack(make_pack(torch.bfloat16, True, seed=7, rows=DECODE_ROWS),
                 "decode-only to C*bs - 1, int8 pools")
    compare_pack(make_pack(torch.bfloat16, False, seed=8, shuffle=True),
                 "rows out of sequence order, bf16 pools")
    compare_pack(make_pack(torch.bfloat16, False, seed=9, nh=6, hd=128,
                           rows=[(3, p) for p in range(100, 356)]),
                 "one prefill chunk of 256 rows, hd 128, bf16 pools")
    return main_pack, err, int8_pack, decode_pack


# ------------------------------------------------------------- phase 2 --

def logits_at(model, ids, pad):
    """The model's fp32 logits after ``ids`` (left pad ``pad``), through the
    port's own ragged path over a fresh one-sequence pool on the model's
    device, in its compute dtype."""
    c = model.config
    dev = model.wte.device
    n, bs = len(ids), 16
    nblk = -(-n // bs)
    nh = c.num_attention_heads
    shape = (c.num_layers, nblk + 1, bs, nh, c.hidden_size // nh)
    pools = tuple(torch.zeros(shape, dtype=model.compute_dtype, device=dev)
                  for _ in range(2))

    def i32(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev)

    table = i32(np.arange(1, nblk + 1))[None]
    seq = i32(np.zeros(n))
    pos = i32(np.arange(n))
    pads = i32([pad])
    with torch.no_grad():
        h = model._embed_ragged(i32(ids), seq, pos, pads)
        h, _ = model.decode_ragged(h, pools, table, seq, pos, pads)
        return model.decode_logits(h[0, -1:][:, None])[0, -1]


def phase2():
    from paddle_tpu_torch.jit.bucketing import select_bucket
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             params_from_numpy)
    from paddle_tpu_torch.serving_paged import \
        RaggedPagedContinuousBatchingEngine

    cfg = gpt_preset("gpt2-small", num_layers=2, compute_dtype="float32")
    cpu_model = GPTModel(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = {n: p.detach().numpy() for n, p in cpu_model.named_parameters()}
    gpu_model = params_from_numpy(state, cfg, device="cuda")
    rng = np.random.RandomState(1)
    reqs = [[int(t) for t in rng.randint(1, cfg.vocab_size,
                                         rng.randint(10, 61))]
            for _ in range(4)]
    streams = {}
    for dev, model in (("cuda", gpu_model), ("cpu", cpu_model)):
        eng = RaggedPagedContinuousBatchingEngine(
            model, max_slots=4, max_len=128, block_size=16,
            prompt_buckets=[32, 64], token_budget=64, device=dev)
        rids = [eng.add_request(p, 16) for p in reqs]
        got = eng.run_to_completion(max_ticks=200)
        streams[dev] = [got[r] for r in rids]
        check(eng.blocks_in_use == 0, f"phase2 {dev}: blocks leaked")
    worst_gap = None
    for i, (g, c) in enumerate(zip(streams["cuda"], streams["cpu"])):
        check(len(g) == len(c) == 16, f"phase2: request {i} short")
        if g == c:
            continue
        k = next(j for j in range(16) if g[j] != c[j])
        pad = select_bucket(len(reqs[i]), [32, 64]) - len(reqs[i])
        ids = [0] * pad + reqs[i] + c[:k]
        top2 = torch.topk(logits_at(cpu_model, ids, pad), 2).values
        gap = float(top2[0] - top2[1])
        say(f"phase2: request {i} diverges at token {k}: cuda {g[k]} cpu "
            f"{c[k]}, CPU top-2 logit gap {gap:.3e}")
        check(gap < 1e-3, f"phase2: request {i} diverged where the CPU "
                          f"top-2 gap is {gap} (>= 1e-3)")
        worst_gap = gap if worst_gap is None else max(worst_gap, gap)
    same = sum(g == c for g, c in zip(streams["cuda"], streams["cpu"]))
    say(f"phase2 card vs CPU (gpt2-small width, 2 layers, fp32): "
        f"{same}/4 streams equal, 64 greedy tokens each side"
        + ("" if worst_gap is None else f", worst tie gap {worst_gap:.3e}"))


# ------------------------------------------------------------- phase 3 --

def serving_traffic(vocab):
    """The repo's ``gpt_serving`` traffic (bench.py bench_gpt_serving):
    24 requests, 32-128 prompt tokens, 48-96 new tokens, seed 0."""
    rng = np.random.RandomState(0)
    return [([int(t) for t in rng.randint(1, vocab, rng.randint(32, 129))],
             int(rng.randint(48, 97))) for _ in range(24)]


def serve(model, reqs, profile_steps=None, **kw):
    """Serve ``reqs`` with 2 arrivals per step at phase 3's settings (``kw``
    adds engine arguments); returns (engine, wall s, {rid: tokens}, {rid:
    budget}).  ``profile_steps=(a, b)`` traces steps [a, b) with
    ``torch.profiler`` and prints where their time went.  ``warm``'s
    result for the engine is left in ``serve.last_warm``."""
    from paddle_tpu_torch.serving_paged import \
        RaggedPagedContinuousBatchingEngine

    eng = RaggedPagedContinuousBatchingEngine(
        model, max_slots=8, max_len=512, block_size=16,
        prompt_buckets=[64, 128], token_budget=256, device="cuda", **kw)
    serve.last_warm = warm(eng)
    budgets, added, step, prof = {}, 0, 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while added < len(reqs) or eng.pending():
        for _ in range(2):
            if added < len(reqs):
                p, n = reqs[added]
                budgets[eng.add_request(p, n)] = n
                added += 1
        if profile_steps and step == profile_steps[0]:
            prof = start_profile()
        eng.step()
        step += 1
        if prof is not None and step == profile_steps[1]:
            report_profile(prof, step - profile_steps[0])
            prof = None
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0, eng.pop_finished(), budgets


def reset_launches():
    """Zero the launch counts of the serving paths' kernels."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    rpa.ragged_attention_cuda.launches = 0
    pa.paged_decode_attention_cuda.launches = 0
    A.flash_fwd_cuda.launches = 0


def warm(eng):
    """Build the engine's programs (``warmup()``: its CUDA graphs), then
    zero the kernels' launch counts, so no capture falls inside a timed
    serve and the counts that follow are the serve's own.  Returns the
    warmup report, the bytes of the engine's graph memory pool (its
    segments in ``torch.cuda.memory_snapshot()``) and the growth of
    ``torch.cuda.memory_reserved()`` over the warmup with the allocator's
    free cache emptied on both sides (the graph pool plus whatever else
    the first runs allocated for good, such as the weights' cast copies)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r0 = torch.cuda.memory_reserved()
    report = eng.warmup()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    grown = torch.cuda.memory_reserved() - r0
    pool = eng._graph_pool
    graph_bytes = 0 if pool is None else sum(
        s["total_size"] for s in torch.cuda.memory_snapshot()
        if tuple(s.get("segment_pool_id", ())) == tuple(pool))
    reset_launches()
    return report, graph_bytes, grown


def start_profile(cpu=True):
    """A running profiler of the device (and of the host's PyTorch ops
    with ``cpu``: a window's host trace costs its report time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU] * cpu
                   + [ProfilerActivity.CUDA])
    prof.__enter__()
    prof.t0 = time.perf_counter()
    return prof


def report_profile(prof, n_steps, ticks_per_step=None, kernel=None):
    """Device time by kernel over the traced steps, and the device's busy
    share of their wall time (the profiler itself slows the host side).
    Where a step is a sync of several decode ticks, ``ticks_per_step``
    adds the per-tick figures; ``kernel`` adds the ms a step of the device
    kernels whose name contains it.  Returns the device's busy ms a
    step."""
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    wall = time.perf_counter() - prof.t0
    prof.__exit__(None, None, None)
    # device-side events only: an aten op's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    say(f"profile {n_steps} steps: wall {1e3 * wall / n_steps:.3f} ms/step,"
        f" device busy {busy_us / 1e3 / n_steps:.3f} ms/step "
        f"({100 * busy_us / 1e6 / wall:.1f}% of wall), "
        f"{launches / n_steps:.0f} device kernels/step"
        + ("" if ticks_per_step is None else
           f" = {busy_us / 1e3 / n_steps / ticks_per_step:.3f} ms and "
           f"{launches / n_steps / ticks_per_step:.0f} device kernels a "
           f"tick"))
    if kernel is not None:
        mine = [e for e in rows if kernel in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / n_steps
        say(f"  {kernel}*: {ms:.4f} ms/step in "
            f"{sum(e.count for e in mine) / n_steps:.0f} launches/step")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        say(f"  {e.self_device_time_total / 1e3 / n_steps:8.4f} ms/step "
            f"{e.count // n_steps:5d}/step  {e.key[:90]}")
    report_profile.last = dict(wall_ms=1e3 * wall / n_steps,
                               busy_ms=busy_us / 1e3 / n_steps,
                               busy_share=busy_us / 1e6 / wall,
                               kernels=launches / n_steps)
    return busy_us / 1e3 / n_steps


def check_serve(label, eng, got, budgets, L):
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    check(sorted(got) == sorted(budgets), f"{label}: requests missing")
    for rid, n in budgets.items():
        check(len(got[rid]) == n, f"{label}: request {rid} got "
                                  f"{len(got[rid])} tokens, not {n}")
    m = eng.metrics()
    check(eng.blocks_in_use == 0, f"{label}: {eng.blocks_in_use} blocks "
                                  f"still in use")
    check(m["blocks_allocated"] == m["blocks_released"],
          f"{label}: allocated {m['blocks_allocated']} != released "
          f"{m['blocks_released']}")
    launches = rpa.ragged_attention_cuda.launches
    check(launches == L * eng.ragged_steps > 0,
          f"{label}: kernel launches {launches} != {L} x ragged steps "
          f"{eng.ragged_steps}")
    for pool in eng.caches:
        for plane in (pool if isinstance(pool, tuple) else (pool,)):
            check(torch.isfinite(plane.float()).all().item(),
                  f"{label}: non-finite KV pool")
    return launches


def phase3():
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = gpt_preset("gpt2-small", compute_dtype="bfloat16")
    L = cfg.num_layers

    def model_for(kv):
        c = gpt_preset("gpt2-small", compute_dtype="bfloat16",
                       kv_cache_dtype=kv)
        return GPTModel(c, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))

    reqs = serving_traffic(cfg.vocab_size)
    model = model_for(None)
    # warm-up serve (cuBLAS handles, the caching allocator), with steps
    # 60-79 traced by torch.profiler
    serve(model, reqs, profile_steps=(60, 80))
    rpa.ragged_attention_cuda.launches = 0        # the measured main path
    eng, wall, got, budgets = serve(model, reqs)
    launches = check_serve("phase3 bf16", eng, got, budgets, L)
    streams = [got[r] for r in sorted(got)]       # rid i is reqs[i]
    tokens = sum(len(v) for v in got.values())
    say(f"phase3 gpt2-small bf16 serve: {len(got)} requests, {tokens} "
        f"tokens, {eng.ragged_steps} ragged steps ({eng.mixed_steps} "
        f"mixed), {tokens / wall:.1f} tokens/s, "
        f"{1e3 * wall / eng.ragged_steps:.3f} ms/step, wall {wall:.3f} s, "
        f"kernel launches {launches} = {L} x {eng.ragged_steps}, "
        f"preemptions {eng.preemptions}")
    del model, eng
    m8 = model_for("int8")
    rpa.ragged_attention_cuda.launches = 0
    eng8, wall8, got8, budgets8 = serve(m8, reqs[:8])
    check_serve("phase3 int8", eng8, got8, budgets8, L)
    tokens8 = sum(len(v) for v in got8.values())
    say(f"phase3 gpt2-small int8-pool serve (first 8 requests): {tokens8} "
        f"tokens, {eng8.ragged_steps} ragged steps, "
        f"{tokens8 / wall8:.1f} tokens/s, "
        f"{1e3 * wall8 / eng8.ragged_steps:.3f} ms/step")
    return launches, streams, [got8[r] for r in sorted(got8)]


# ------------------------------------------------------------- phase 4 --

FLASH_SEED = 1234

# (label, dtype, causal, L, head dim, key mask, dropout p)
FLASH_CASES = [
    ("fp32 causal L512", torch.float32, True, 512, 64, False, 0.0),
    ("fp32 L512", torch.float32, False, 512, 64, False, 0.0),
    ("fp16 causal L512", torch.float16, True, 512, 64, False, 0.0),
    ("fp16 L512", torch.float16, False, 512, 64, False, 0.0),
    ("bf16 causal L1024", torch.bfloat16, True, 1024, 64, False, 0.0),
    ("bf16 L128", torch.bfloat16, False, 128, 64, False, 0.0),
    ("fp32 key mask causal L512", torch.float32, True, 512, 64, True, 0.0),
    ("bf16 key mask L1024", torch.bfloat16, False, 1024, 64, True, 0.0),
    ("fp32 dropout 0.1 causal L512", torch.float32, True, 512, 64, False,
     0.1),
    ("bf16 dropout 0.1 key mask L512", torch.bfloat16, False, 512, 64, True,
     0.1),
    ("bf16 hd128 causal L512", torch.bfloat16, True, 512, 128, False, 0.0),
    ("fp32 hd128 key mask dropout 0.1 L256", torch.float32, False, 256, 128,
     True, 0.1),
    # the 16-bit kernels' edges: 128-row tiles over L = 64 * odd, keys past
    # L; fp16 through the transposed (MN-major) operands at head dim 128; a
    # masked run of keys 128..255 that covers a whole 128-key tile; the
    # dropout hash at the wgmma accumulator's positions at head dim 128
    ("bf16 causal L64", torch.bfloat16, True, 64, 64, False, 0.0),
    ("bf16 causal L192", torch.bfloat16, True, 192, 64, False, 0.0),
    ("fp16 hd128 causal L1024", torch.float16, True, 1024, 128, False, 0.0),
    ("bf16 key mask tile run causal L512", torch.bfloat16, True, 512, 64,
     (128, 256), 0.0),
    ("bf16 hd128 dropout 0.1 L256", torch.bfloat16, False, 256, 128, False,
     0.1),
    # dQ's heaviest: head dim 128's 64-key tiles, the causal edge and the
    # dropout pass together over 16 key tiles a block
    ("bf16 hd128 causal dropout 0.1 L1024", torch.bfloat16, True, 1024, 128,
     False, 0.1),
]


def flash_inputs(B, L, H, D, dtype, masked, seed):
    """q, k, v, dO (B, L, H, D) in ``dtype`` and the fp32 key mask: ~30%
    of keys at -1e30 (key 0 kept) plus a masked run, keys 64..191 for
    ``masked=True`` (longer than a 64-key tile, across two 128-key tiles)
    or the keys of a ``(start, end)`` pair."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(B, L, H, D, generator=g, device=dev)
                   .to(dtype) for _ in range(4))
    km = torch.zeros(B, L, device=dev)
    if masked:
        drop = torch.rand(B, L, generator=g, device=dev) < 0.3
        drop[:, 0] = False
        start, end = (64, 192) if masked is True else masked
        drop[:, start:end] = True
        km = torch.where(drop, torch.full_like(km, -1e30), km)
    return q, k, v, do, km


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def phase4():
    """Each flash case through the kernels (forward and ``_FlashAttention``
    backward) and through the plain forward plus PyTorch's autograd."""
    from paddle_tpu_torch.ops import attention as A

    for label, dt, causal, L, D, masked, p in FLASH_CASES:
        q, k, v, do, km = flash_inputs(2, L, 4, D, dt, masked, seed=L + D)
        scale = 1.0 / D ** 0.5
        qk = [t.clone().requires_grad_() for t in (q, k, v)]
        out = A._FlashAttention.apply(*qk, km, FLASH_SEED, causal, scale, p)
        grads = torch.autograd.grad(out, qk, do)
        _, lse = A.flash_fwd_cuda(q, k, v, km, FLASH_SEED, causal, scale, p)
        qp = [t.clone().requires_grad_() for t in (q, k, v)]
        out_p, lse_p = A.flash_fwd_ref(*qp, km, FLASH_SEED, causal, scale, p)
        grads_p = torch.autograd.grad(out_p, qp, do)
        torch.cuda.synchronize()
        tol = TOL[dt]
        err = (out.float() - out_p.float()).abs().max().item()
        check(torch.isfinite(out).all().item(), f"phase4 {label}: non-finite")
        check(torch.allclose(out.float(), out_p.float(), rtol=tol, atol=tol),
              f"phase4 {label}: O max abs err {err} > tol {tol}")
        lerr = (lse - lse_p).abs().max().item()
        check(lerr <= LSE_TOL, f"phase4 {label}: lse err {lerr} > {LSE_TOL}")
        gerr = [rel_err(a, b) for a, b in zip(grads, grads_p)]
        check(max(gerr) <= GRAD_TOL[dt],
              f"phase4 {label}: dq/dk/dv relative errors {gerr} > "
              f"{GRAD_TOL[dt]}")
        say(f"phase4 {label}: O max abs err {err:.3e} (tol {tol}), lse "
            f"{lerr:.3e}, dq/dk/dv err / max|grad| "
            + "/".join(f"{e:.3e}" for e in gerr)
            + f" (tol {GRAD_TOL[dt]})")
    phase4_misaligned_mask()
    phase4_prefill()


def phase4_misaligned_mask():
    """``flash_attention`` with a key mask that is a view 4 bytes into its
    storage (``big[:, 1:L + 1]``): the public function copies it to an
    aligned tensor, so the kernels run and agree with the plain version."""
    from paddle_tpu_torch.ops import attention as A

    B, L, H, D, dt = 1, 256, 4, 64, torch.bfloat16
    q, k, v, do, km = flash_inputs(B, L, H, D, dt, True, seed=77)
    big = torch.zeros(B, L + 44, device="cuda")
    big[:, 1:L + 1] = km
    view = big[:, 1:L + 1]
    check(view.data_ptr() % 16 != 0, "phase4 misaligned mask: view aligned")
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    before = A.flash_fwd_cuda.launches
    out = A.flash_attention(*qk, causal=True, key_mask=view)
    grads = torch.autograd.grad(out, qk, do)
    check(A.flash_fwd_cuda.launches == before + 1,
          "phase4 misaligned mask: the flash kernel did not run")
    qp = [t.clone().requires_grad_() for t in (q, k, v)]
    out_p, _ = A.flash_fwd_ref(*qp, km, 0, True, 1.0 / D ** 0.5, 0.0)
    grads_p = torch.autograd.grad(out_p, qp, do)
    torch.cuda.synchronize()
    err = (out.float() - out_p.float()).abs().max().item()
    check(torch.allclose(out.float(), out_p.float(), rtol=TOL[dt],
                         atol=TOL[dt]),
          f"phase4 misaligned mask: O max abs err {err} > tol {TOL[dt]}")
    gerr = [rel_err(a, b) for a, b in zip(grads, grads_p)]
    check(max(gerr) <= GRAD_TOL[dt],
          f"phase4 misaligned mask: dq/dk/dv relative errors {gerr}")
    say(f"phase4 misaligned key mask view (offset 4 bytes, B {B}, L {L}, "
        f"bf16, causal): O max abs err {err:.3e} (tol {TOL[dt]}), dq/dk/dv "
        f"err / max|grad| " + "/".join(f"{e:.3e}" for e in gerr)
        + f" (tol {GRAD_TOL[dt]})")


def phase4_prefill():
    """``flash_fwd`` as the admission prefill calls it (``GPTModel.prefill``
    at one prompt bucket of 128): B 1, L 128, 12 heads of 64, causal, with
    the left-pad key mask ``_prefill_key_mask`` builds.  Rows before the pad
    see no key at all and nothing reads them: they must be finite, and the
    real rows are held against the plain version."""
    from paddle_tpu_torch.models.gpt import GPTModel
    from paddle_tpu_torch.ops import attention as A

    L, H, D = 128, 12, 64
    scale = 1.0 / D ** 0.5
    for dt in (torch.bfloat16, torch.float32):
        for pad in (0, 1, 37, 64):
            q, k, v, _, _ = flash_inputs(1, L, H, D, dt, False,
                                         seed=900 + pad)
            km = GPTModel._prefill_key_mask(
                L, torch.tensor([pad], dtype=torch.int32, device="cuda"))
            out, lse = A.flash_fwd_cuda(q, k, v, km, 0, True, scale, 0.0)
            out_p, lse_p = A.flash_fwd_ref(q, k, v, km, 0, True, scale, 0.0)
            torch.cuda.synchronize()
            label = f"phase4 prefill call {dt} L{L} causal left pad {pad}"
            tol = TOL[dt]
            check(torch.isfinite(out).all().item(), f"{label}: non-finite")
            g, w = out[:, pad:].float(), out_p[:, pad:].float()
            err = (g - w).abs().max().item()
            check(torch.allclose(g, w, rtol=tol, atol=tol),
                  f"{label}: O max abs err {err} > tol {tol}")
            lerr = (lse[..., pad:] - lse_p[..., pad:]).abs().max().item()
            check(lerr <= LSE_TOL, f"{label}: lse err {lerr} > {LSE_TOL}")
            say(f"{label}: {L - pad} real rows, O max abs err {err:.3e} "
                f"(tol {tol}), lse {lerr:.3e}")


# ------------------------------------------------------------- phase 5 --

def train_losses(model, batches, dev):
    from paddle_tpu_torch.models.gpt import make_gpt_train_step
    from paddle_tpu_torch.optimizer import AdamW

    step, state = make_gpt_train_step(model, AdamW(3e-4, weight_decay=0.01),
                                      remat=False)
    losses = []
    for i, (x, y) in enumerate(batches):
        state, loss = step(state, i, 3e-4, torch.from_numpy(x).to(dev),
                           torch.from_numpy(y).to(dev))
        losses.append(loss.item())
    return losses


def phase5():
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             params_from_numpy)

    cfg = gpt_preset("gpt2-small", num_layers=2, compute_dtype="float32")
    cpu_model = GPTModel(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = {n: p.detach().numpy().copy()
             for n, p in cpu_model.named_parameters()}
    gpu_model = params_from_numpy(state, cfg, device="cuda")
    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, cfg.vocab_size, (2, 256)),
                rng.randint(0, cfg.vocab_size, (2, 256))) for _ in range(5)]
    gl = train_losses(gpu_model, batches, "cuda")
    cl = train_losses(cpu_model, batches, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    perr = max((p.detach().cpu() - dict(cpu_model.named_parameters())[n]
                .detach()).abs().max().item()
               for n, p in gpu_model.named_parameters())
    say(f"phase5 card vs CPU train (gpt2-small width, 2 layers, fp32, B 2, "
        f"L 256, 5 AdamW steps): losses cuda {[round(x, 6) for x in gl]} "
        f"cpu {[round(x, 6) for x in cl]}, max rel diff {rel:.3e} (tol "
        f"1e-4), final params max abs diff {perr:.3e} (tol 3e-3)")
    check(all(np.isfinite(gl)), "phase5: non-finite card loss")
    check(rel <= 1e-4, f"phase5: losses differ by {rel} relative")
    check(perr <= 3e-3, f"phase5: parameters differ by {perr}")


# ------------------------------------------------------------- phase 6 --

def phase6():
    """The full-width gpt2s train; returns the flash kernels' launches in
    the 10 timed steps."""
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_preset("gpt2-small", vocab_size=50304,
                     max_position_embeddings=1024, compute_dtype="bfloat16")
    Lyr, B, L = cfg.num_layers, 16, 1024
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    step, state = make_gpt_train_step(model, AdamW(3e-4, weight_decay=0.01),
                                      remat=False)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    losses = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, loss = step(state, len(losses), 3e-4, x, y)
            losses.append(loss)

    run(3)                                            # warm-up
    prof = start_profile()
    run(3)
    report_profile(prof, 3)
    kernels = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda)
    for k in kernels:                                 # the measured run
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    vals = [v.item() for v in losses]
    check(all(np.isfinite(vals)), f"phase6: non-finite loss in {vals}")
    check(vals[-1] < vals[0], f"phase6: loss did not fall: {vals}")
    check(launches == [Lyr * 10] * 3,
          f"phase6: flash launches {launches} != {Lyr} x 10 steps each")
    say(f"phase6 gpt2s train (B {B}, L {L}, bf16, 12 layers): losses "
        f"{[round(v, 4) for v in vals]}; {1e3 * wall / 10:.3f} ms/step, "
        f"{B * L * 10 / wall:.1f} tokens/s over 10 steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, flash "
        f"launches fwd/dq/dkv {launches} = {Lyr} x 10")
    return launches


def flash_bound(kind, B, L, H, D, dtype, causal):
    """Least time for one call: q/k/v (and dO) read once, outputs written
    once, plus the fp32 rows (lse, delta) and the key mask; 2·D flops per
    (query, key) pair and product — 2 products forward, 3 for dQ (S, dP,
    dQ), 4 for dK/dV (S, dP, dV, dK) — over the pairs the causal mask
    keeps.  Returns (ms, "bytes"|"operations")."""
    pairs = B * H * (L * (L + 1) // 2 if causal else L * L)
    n = B * L * H * D * torch.tensor([], dtype=dtype).element_size()
    rows, km = 4 * B * H * L, 4 * B * L
    flops, nbytes = {
        "flash_fwd": (4 * D * pairs, 4 * n + rows + km),
        "flash_bwd_dq": (6 * D * pairs, 5 * n + 2 * rows + km),
        "flash_bwd_dkv": (8 * D * pairs, 6 * n + 2 * rows + km)}[kind]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_flash(B=16, L=1024, causal=True):
    """Each flash kernel at one training path's attention shapes (the
    phase-6 default: B 16, L 1024, H 12, D 64, bf16, causal; BERT's is
    L 512, not causal): kernel, plain and library ms, its bound and its
    max abs error against the plain version."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import attention as A

    H, D, dt = 12, 64, torch.bfloat16
    q, k, v, do, km = flash_inputs(B, L, H, D, dt, False, seed=7)
    scale = 1.0 / D ** 0.5
    out, lse = A.flash_fwd_cuda(q, k, v, km, 0, causal, scale, 0.0)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
        .reshape(B * H, L).contiguous()
    bwd = (q, k, v, km, 0, do, lse, delta, causal, scale, 0.0)
    dq = A.flash_bwd_dq_cuda(*bwd)
    dk, dv = A.flash_bwd_dkv_cuda(*bwd)
    out_p, lse_p = A.flash_fwd_ref(q, k, v, km, 0, causal, scale, 0.0)
    dq_p, dk_p, dv_p = A.flash_bwd_ref(*bwd)
    torch.cuda.synchronize()
    errs = {"flash_fwd": (out.float() - out_p.float()).abs().max().item(),
            "flash_bwd_dq": (dq.float() - dq_p.float()).abs().max().item(),
            "flash_bwd_dkv": max((dk.float() - dk_p.float()).abs().max(),
                                 (dv.float() - dv_p.float()).abs().max())
            .item()}
    check(torch.allclose(out.float(), out_p.float(), rtol=TOL[dt],
                         atol=TOL[dt]), "timing shapes: O disagrees")
    check((lse - lse_p).abs().max().item() <= LSE_TOL,
          "timing shapes: lse disagrees")
    for name, a, b in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        e = rel_err(a, b)
        check(e <= GRAD_TOL[dt], f"timing shapes: {name} rel err {e}")
    ms = {"flash_fwd": time_cold_ms(lambda: A.flash_fwd_cuda(
              q, k, v, km, 0, causal, scale, 0.0)),
          "flash_bwd_dq": time_cold_ms(lambda: A.flash_bwd_dq_cuda(*bwd)),
          "flash_bwd_dkv": time_cold_ms(lambda: A.flash_bwd_dkv_cuda(*bwd))}
    plain_fwd = time_cold_ms(lambda: A.flash_fwd_ref(q, k, v, km, 0, causal,
                                                     scale, 0.0), iters=10)
    plain_bwd = time_cold_ms(lambda: A.flash_bwd_ref(*bwd), iters=10)
    plain = {"flash_fwd": plain_fwd, "flash_bwd_dq": plain_bwd,
             "flash_bwd_dkv": plain_bwd}
    qh, kh, vh, doh = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    lib_fwd = time_cold_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=causal))
    leaves = [t.requires_grad_() for t in (qh, kh, vh)]
    o = F.scaled_dot_product_attention(*leaves, is_causal=causal)
    lib_bwd = time_cold_ms(lambda: torch.autograd.grad(
        o, leaves, doh, retain_graph=True))
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    rows = {}
    for name in ms:
        bound_ms, bound_by = flash_bound(name, B, L, H, D, dt, causal)
        rows[name] = dict(ms=ms[name], plain_ms=plain[name],
                          library_ms=library[name], bound_ms=bound_ms,
                          bound_by=bound_by, max_abs_err=errs[name])
    return rows


def say_flash(rows, shape, card, only=None):
    """One timing line per flash kernel, with its ratio to the library
    call (SDPA's forward, or its whole backward for the two backward
    kernels)."""
    for name, r in rows.items():
        if only is not None and name not in only:
            continue
        lib = "backward" if "bwd" in name else "forward"
        say(f"timing {name} at {shape} on {card}: kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms, sdpa {lib} "
            f"{r['library_ms']:.4f} ms, kernel / sdpa "
            f"{r['ms'] / r['library_ms']:.2f}x, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), max abs err {r['max_abs_err']:.3e}")


# ------------------------------------------------------------- phase 7 --

LN_SEED = 4321

# (label, dtype, N, H, bias, dropout p, rout cotangent, eps[, offset]):
# an offset views every (N, H) operand that many elements into its storage,
# so no row pointer is 16-byte aligned and the kernels take the scalar path
LN_CASES = [
    ("bf16 N8192 H768 bias", torch.bfloat16, 8192, 768, True, 0.0, False,
     1e-12),
    ("bf16 N8192 H768 bias dropout 0.1 drout", torch.bfloat16, 8192, 768,
     True, 0.1, True, 1e-12),
    ("fp32 N8192 H768 bias drout", torch.float32, 8192, 768, True, 0.0,
     True, 1e-12),
    ("fp32 N200 H1024 dropout 0.1", torch.float32, 200, 1024, False, 0.1,
     False, 1e-5),
    ("fp16 N24 H64 bias drout", torch.float16, 24, 64, True, 0.0, True,
     1e-5),
    ("fp16 N8192 H1024 bias dropout 0.1", torch.float16, 8192, 1024, True,
     0.1, False, 1e-5),
    ("bf16 N200 H100 bias dropout 0.1 drout", torch.bfloat16, 200, 100, True,
     0.1, True, 1e-12),
    ("fp32 N24 H100", torch.float32, 24, 100, False, 0.0, False, 1e-5),
    ("bf16 N24 H64", torch.bfloat16, 24, 64, False, 0.0, False, 1e-12),
    # the persistent backward: fewer rows than its grid's warps (132 blocks
    # of 16 warps), a row count no multiple of them, H 100 on the scalar
    # path at many rows, misaligned operands, fp32 H 1024 (32 sums a lane
    # in registers) and a row too wide for registers
    ("bf16 N1000 H768 bias drout (fewer rows than warps)", torch.bfloat16,
     1000, 768, True, 0.0, True, 1e-12),
    ("bf16 N5000 H768 bias dropout 0.1 (not a multiple)", torch.bfloat16,
     5000, 768, True, 0.1, False, 1e-12),
    ("fp16 N4099 H100 bias drout (scalar)", torch.float16, 4099, 100, True,
     0.0, True, 1e-5),
    ("bf16 N3000 H768 bias drout, misaligned (scalar)", torch.bfloat16,
     3000, 768, True, 0.0, True, 1e-12, 1),
    ("fp32 N4096 H1024 bias drout", torch.float32, 4096, 1024, True, 0.0,
     True, 1e-5),
    ("bf16 N600 H2000 bias dropout 0.1 drout (wide)", torch.bfloat16, 600,
     2000, True, 0.1, True, 1e-12),
]


def ln_inputs(N, H, dtype, bias, seed, offset=0):
    """x, residual, dout, drout (N, H) in ``dtype``, each ``offset``
    elements into its storage; fp32 w, b, bias (H,)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, res, dout, drout = (torch.randn(N * H + offset, generator=g,
                                       device="cuda").to(dtype)[offset:]
                           .view(N, H) for _ in range(4))
    w = torch.rand(H, generator=g, device="cuda") + 0.5
    b, bb = (0.1 * torch.randn(H, generator=g, device="cuda")
             for _ in range(2))
    return x, res, w, b, (bb if bias else None), dout, drout


def phase7():
    """The LN cases through the kernels (``_FusedLN`` forward and backward)
    and through the plain versions; then AdamW.  Returns the kernels'
    launch counts."""
    from paddle_tpu_torch.ops import fused as TF

    for label, dt, N, H, bias, p, with_drout, eps, *offset in LN_CASES:
        x, res, w, b, bb, dout, drout = ln_inputs(N, H, dt, bias, N + H,
                                                  *offset)
        leaves = [x.detach().requires_grad_(), res.detach().requires_grad_()]
        leaves += [t.clone().requires_grad_() for t in (w, b)]
        if bias:
            leaves.append(bb.clone().requires_grad_())
        out, rout = TF._FusedLN.apply(*leaves[:4], leaves[4] if bias else
                                      None, LN_SEED, p, eps)
        outs, cts = ((out, rout), (dout, drout)) if with_drout else \
            ((out,), (dout,))
        grads = torch.autograd.grad(outs, leaves, cts)
        _, _, mu, rstd = TF.fused_ln_fwd_cuda(x, res, w, b, bb, LN_SEED, p,
                                              eps)
        out_p, rout_p, mu_p, rstd_p = TF.ln_fwd_ref(x, res, w, b, bb,
                                                    LN_SEED, p, eps)
        grads_p = TF.ln_bwd_ref(dout, drout if with_drout else None, rout_p,
                                mu_p, rstd_p, w, LN_SEED, p, bias)
        torch.cuda.synchronize()
        tol = TOL[dt]
        errs = [(a.float() - c.float()).abs().max().item()
                for a, c in ((out, out_p), (rout, rout_p))]
        check(torch.isfinite(out).all().item(), f"phase7 {label}: non-finite")
        for a, c, n in ((out, out_p, "out"), (rout, rout_p, "rout")):
            check(torch.allclose(a.float(), c.float(), rtol=tol, atol=tol),
                  f"phase7 {label}: {n} max abs err "
                  f"{(a.float() - c.float()).abs().max().item()} > tol {tol}")
        serr = max(rel_err(mu, mu_p), rel_err(rstd, rstd_p))
        check(serr <= 1e-5, f"phase7 {label}: mu/rstd rel err {serr}")
        gerr = [rel_err(a, c) for a, c in zip(grads, [
            t for t in grads_p if t is not None])]
        check(max(gerr) <= GRAD_TOL[dt],
              f"phase7 {label}: dx/dres/dw/db/dbias relative errors {gerr} "
              f"> {GRAD_TOL[dt]}")
        dx, dx_p = grads[0], grads_p[0]
        check(torch.equal(dx != 0, dx_p != 0),
              f"phase7 {label}: kernel and plain dx differ in zeros")
        if p > 0:
            keep = TF._keep_mask(LN_SEED, 0, (N, H), p, device="cuda")
            check(not dx[~keep].any().item(),
                  f"phase7 {label}: a dropped position has a gradient")
            # fp16 can underflow a kept |dx| < 3e-8 to zero; bf16 cannot
            check(dt == torch.float16 or torch.equal(dx != 0, keep),
                  f"phase7 {label}: dropout keep pattern differs from the "
                  f"position hash")
        say(f"phase7 {label}: out/rout max abs err {errs[0]:.3e}/"
            f"{errs[1]:.3e} (tol {tol}), mu/rstd rel {serr:.3e}, "
            f"dx/dres/dw/db" + ("/dbias" if bias else "") + " err / max|grad| "
            + "/".join(f"{e:.3e}" for e in gerr) + f" (tol {GRAD_TOL[dt]})"
            + (f", keep pattern exact ({p})" if p > 0 else ""))
    # two launches of the backward on the same inputs: the same bits (the
    # column sums go through a fixed tree and a fixed-order sum)
    x, res, w, b, bb, dout, drout = ln_inputs(8192, 768, torch.bfloat16,
                                              True, seed=5)
    _, rout, mu, rstd = TF.fused_ln_fwd_cuda(x, res, w, b, bb, LN_SEED, 0.1,
                                             1e-12)
    runs = [TF.fused_ln_bwd_cuda(dout, drout, rout, mu, rstd, w, LN_SEED,
                                 0.1, True) for _ in range(2)]
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(*runs)),
          "phase7: two fused_ln_bwd launches on the same inputs differ")
    say("phase7 fused_ln_bwd launched twice on the same inputs (bf16 N8192 "
        "H768 bias dropout 0.1 drout): dx, dres, dw, db, dbias bit-identical")
    TF.fused_adamw_flat_cuda.launches = 0
    adamw_check(BERT_PARAMS, torch.float32, 1e-6, "fp32")
    adamw_check(1_000_003, torch.bfloat16, 1e-2, "bf16 params, fp32 moments")
    return TF.fused_adamw_flat_cuda.launches


def adamw_state(n, pdtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, generator=g, device="cuda").to(pdtype)
    m = 0.1 * torch.randn(n, generator=g, device="cuda")
    v = 0.01 * torch.rand(n, generator=g, device="cuda")
    return p, m, v, g


def adamw_check(n, pdtype, ptol, label):
    """3 steps of ``fused_adamw_flat`` (the kernel) against 3 of
    ``adamw_flat_ref`` on the same state and gradients: p within ``ptol``
    of its max abs, m and v within 1e-6 (fp32 moments)."""
    from paddle_tpu_torch.ops import fused as TF

    p, m, v, g = adamw_state(n, pdtype, seed=n)
    kern, plain = (p, m, v), (p, m, v)
    for step in (1, 2, 3):
        grad = torch.randn(n, generator=g, device="cuda").to(pdtype)
        kw = dict(lr=1e-4 * step, beta1=0.9, beta2=0.999, eps=1e-8,
                  weight_decay=0.01)
        kern = TF.fused_adamw_flat(*kern[:1], grad, *kern[1:], step, **kw)
        plain = TF.adamw_flat_ref(plain[0], grad, *plain[1:], TF._adamw_scalars(
            step, kw["lr"], 0.9, 0.999, 1e-8, 0.01))
    torch.cuda.synchronize()
    errs = [rel_err(a, c) for a, c in zip(kern, plain)]
    check(all(torch.isfinite(t.float()).all().item() for t in kern),
          f"phase7 adamw {label}: non-finite")
    check(errs[0] <= ptol and max(errs[1:]) <= 1e-6,
          f"phase7 adamw {label}: p/m/v rel errors {errs} > {ptol}/1e-6")
    say(f"phase7 fused_adamw_flat {label}, n {n}, 3 steps: p/m/v err / "
        f"max abs " + "/".join(f"{e:.3e}" for e in errs)
        + f" (tol {ptol}/1e-6/1e-6)")


# ------------------------------------------------------------- phase 8 --

def bert_train_losses(model, batches, dev):
    from paddle_tpu_torch.models.bert import make_bert_train_step
    from paddle_tpu_torch.optimizer import AdamW

    step, state = make_bert_train_step(model, AdamW(1e-4, weight_decay=0.01),
                                       remat=False)
    losses = []
    for ids, mlm, nsp in batches:
        state, loss = step(state, 1e-4, *(torch.from_numpy(a).to(dev)
                                          for a in (ids, mlm, nsp)))
        losses.append(loss.item())
    return losses


def phase8():
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.models.bert import (BertModel, bert_preset,
                                              params_from_numpy)

    set_flags({"FLAGS_use_fused_ln": True})
    cfg = bert_preset("bert-base", num_hidden_layers=2,
                      compute_dtype="float32")
    cpu_model = BertModel(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    state = {n: p.detach().numpy().copy()
             for n, p in cpu_model.named_parameters()}
    gpu_model = params_from_numpy(state, cfg, device="cuda")
    rng = np.random.RandomState(1)
    am = np.ones((2, 128), np.int64)
    am[0, 90:] = 0
    am[1, 30:] = 0
    ids = rng.randint(0, cfg.vocab_size, (2, 128))
    with torch.no_grad():
        got = [t.cpu() for t in gpu_model(torch.from_numpy(ids).cuda(),
                                          attention_mask=torch.from_numpy(
                                              am).cuda())]
        want = cpu_model(torch.from_numpy(ids),
                         attention_mask=torch.from_numpy(am))
    ferr = [(a - c).abs().max().item() for a, c in zip(got, want)]
    check(max(ferr) <= 1e-4, f"phase8: forward h/pooled differ by {ferr}")
    batches = []
    for _ in range(5):
        mlm = rng.randint(0, cfg.vocab_size, (2, 128))
        mlm[rng.rand(2, 128) < 0.3] = -100
        batches.append((rng.randint(0, cfg.vocab_size, (2, 128)), mlm,
                        rng.randint(0, 2, (2,))))
    gl = bert_train_losses(gpu_model, batches, "cuda")
    cl = bert_train_losses(cpu_model, batches, "cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    perr = max((p.detach().cpu() - dict(cpu_model.named_parameters())[n]
                .detach()).abs().max().item()
               for n, p in gpu_model.named_parameters())
    say(f"phase8 card vs CPU (bert-base width, 2 layers, fp32, fused LN on): "
        f"forward with a padding mask h/pooled max abs diff "
        f"{ferr[0]:.3e}/{ferr[1]:.3e} (tol 1e-4); train B 2, L 128, 5 AdamW "
        f"steps: losses cuda {[round(x, 6) for x in gl]} cpu "
        f"{[round(x, 6) for x in cl]}, max rel diff {rel:.3e} (tol 1e-4), "
        f"final params max abs diff {perr:.3e} (tol 3e-3)")
    check(all(np.isfinite(gl)), "phase8: non-finite card loss")
    check(rel <= 1e-4, f"phase8: losses differ by {rel} relative")
    check(perr <= 3e-3, f"phase8: parameters differ by {perr}")
    set_flags({"FLAGS_use_fused_ln": False})


# ------------------------------------------------------------- phase 9 --

BERT_B, BERT_L = 16, 512


def bert_base_train():
    """``bench.py``'s bert_base config on the card (bf16, seed 0) with its
    train step, AdamW state and one batch from RandomState(0)."""
    from paddle_tpu_torch.models.bert import (BertConfig, BertModel,
                                              make_bert_train_step)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig(vocab_size=30528, hidden_size=768, num_hidden_layers=12,
                     num_attention_heads=12, max_position_embeddings=512,
                     compute_dtype="bfloat16", scan_unroll=12)
    model = BertModel(cfg, device="cuda",
                      generator=torch.Generator("cuda").manual_seed(0))
    step, state = make_bert_train_step(model, AdamW(1e-4, weight_decay=0.01),
                                       remat=False)
    rng = np.random.RandomState(0)
    batch = [torch.from_numpy(a).cuda() for a in (
        rng.randint(0, cfg.vocab_size, (BERT_B, BERT_L)),
        rng.randint(0, cfg.vocab_size, (BERT_B, BERT_L)),
        rng.randint(0, 2, (BERT_B,)))]
    return cfg, model, step, state, batch


def phase9():
    """The full-width BERT-base train with the fused LN; returns the LN
    kernels' launches in the 10 timed steps."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import fused as TF

    cfg, model, step, state, batch = bert_base_train()
    Lyr, B, L = cfg.num_hidden_layers, BERT_B, BERT_L
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == BERT_PARAMS, f"phase9: {n_params} parameters, not "
                                   f"{BERT_PARAMS}")
    losses = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, loss = step(state, 1e-4, *batch)
            losses.append(loss)

    ln = (TF.fused_ln_fwd_cuda, TF.fused_ln_bwd_cuda)
    flash = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda)

    def timed(n):
        for k in ln + flash:                          # the measured run
            k.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0, [k.launches for k in ln],
                [k.launches for k in flash])

    set_flags({"FLAGS_use_fused_ln": True})
    run(3)                                            # warm-up
    say("phase9 profile, fused LN on:")
    prof = start_profile()
    run(3)
    busy = report_profile(prof, 3, kernel="ln_bwd_kernel")
    wall, ln_launches, flash_launches = timed(10)
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals = [v.item() for v in losses]
    check(all(np.isfinite(vals)), f"phase9: non-finite loss in {vals}")
    check(vals[-1] < vals[0], f"phase9: loss did not fall: {vals}")
    check(ln_launches == [2 * Lyr * 10] * 2,
          f"phase9: fused LN launches fwd/bwd {ln_launches} != "
          f"{2 * Lyr} x 10 steps each")
    check(flash_launches == [Lyr * 10] * 3,
          f"phase9: flash launches {flash_launches} != {Lyr} x 10 steps each")
    # the reference's default path on the same model: flag off
    set_flags({"FLAGS_use_fused_ln": False})
    run(1)
    say("phase9 profile, fused LN off:")
    prof = start_profile()
    run(3)
    busy_off = report_profile(prof, 3)
    wall_off, ln_off, flash_off = timed(10)
    peak_off = torch.cuda.max_memory_allocated() / 2**30
    off_vals = [v.item() for v in losses[len(vals):]]
    check(all(np.isfinite(off_vals)), f"phase9 flag off: non-finite loss")
    check(ln_off == [0, 0] and flash_off == [Lyr * 10] * 3,
          f"phase9 flag off: launches LN {ln_off}, flash {flash_off}")
    say(f"phase9 flag off (plain LN epilogue, the reference's default): "
        f"{1e3 * wall_off / 10:.3f} ms/step, {B * L * 10 / wall_off:.1f} "
        f"tokens/s over 10 steps, device busy {busy_off:.3f} ms/step = "
        f"{100 * busy_off / (1e3 * wall_off / 10):.1f}% of an unprofiled "
        f"step, peak memory {peak_off:.3f} GiB, losses "
        f"{[round(v, 4) for v in off_vals]}")
    # one more window of each, so the windows run on, off, off, on
    wall_off2 = timed(10)[0]
    set_flags({"FLAGS_use_fused_ln": True})
    wall2, ln2, _ = timed(10)
    check(ln2 == [2 * Lyr * 10] * 2, f"phase9: fused LN launches {ln2}")
    rest = [v.item() for v in losses[len(vals) + len(off_vals):]]
    check(all(np.isfinite(rest)), "phase9: non-finite loss")
    ms = lambda w: 1e3 * w / 10
    say(f"phase9 flag on vs off, 10-step windows in the order on, off, off, "
        f"on: on {ms(wall):.3f}/{ms(wall2):.3f} ms/step, off "
        f"{ms(wall_off):.3f}/{ms(wall_off2):.3f} ms/step; means on "
        f"{ms(wall + wall2) / 2:.3f}, off {ms(wall_off + wall_off2) / 2:.3f}")
    say(f"phase9 bert-base train with the fused LN (B {B}, L {L}, bf16, "
        f"{Lyr} layers, {n_params} parameters): losses "
        f"{[round(v, 4) for v in vals]}; {1e3 * wall / 10:.3f} ms/step, "
        f"{B * L * 10 / wall:.1f} tokens/s over 10 steps, device busy "
        f"{busy:.3f} ms/step = {100 * busy / (1e3 * wall / 10):.1f}% of an "
        f"unprofiled step, peak memory "
        f"{peak:.3f} GiB, fused LN launches fwd/bwd {ln_launches} = "
        f"{2 * Lyr} x 10, flash launches fwd/dq/dkv {flash_launches} = "
        f"{Lyr} x 10")
    return ln_launches


# ------------------------------------------------------------ phase 10 --

# (atol, rtol) an element: all three versions accumulate in fp32 and round
# once, so fp32 outputs differ by summation order (2e-5) and 16-bit outputs
# by that plus at most one ulp of the element itself (2^-7 of a bf16 value,
# 2^-10 of an fp16 value)
DECODE_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2e-5, 2.0 ** -7),
              torch.float16: (2e-5, 2.0 ** -10)}

# (label, dtype, head dim, nh, block size, table columns, left pads)
DECODE_CASES = [
    ("bf16 hd64 bs32 C20 (the serve shape)", torch.bfloat16, 64, 12, 32, 20,
     True),
    ("fp32 hd64 bs32 C20 (the serve shape in fp32)", torch.float32, 64, 12,
     32, 20, True),
    ("bf16 hd64 bs32 C20 no pads", torch.bfloat16, 64, 12, 32, 20, False),
    ("fp16 hd64 bs16 C8", torch.float16, 64, 12, 16, 8, True),
    ("fp32 hd64 bs4 C16", torch.float32, 64, 4, 4, 16, True),
    ("fp32 hd128 bs32 C4 no pads", torch.float32, 128, 6, 32, 4, False),
    ("bf16 hd128 bs16 C8", torch.bfloat16, 128, 6, 16, 8, True),
    ("fp16 hd128 bs4 C32", torch.float16, 128, 3, 4, 32, True),
    # the tiled kernel: a tile of 16 positions spans 4 pool blocks at the
    # serve's nh; fp32 hd 128 at the serve's nh (4-position tiles)
    ("bf16 hd64 nh12 bs4 C40", torch.bfloat16, 64, 12, 4, 40, True),
    ("fp32 hd128 nh12 bs32 C20", torch.float32, 128, 12, 32, 20, True),
]

# slots whose [pad, t] leave whole tiles skipped at both ends, at the serve
# shape: (clock, pad) a slot
SKIP_SLOTS = [(300, 100), (639, 200), (47, 33), (450, 17), (16, 15),
              (17, 16), (500, 480), (200, 0)]


def make_decode_case(dtype, hd, nh, bs, C, padded, seed, clocks=None,
                     pads=None):
    """One decode tick's operands for S 8 slots.  Without ``clocks`` the
    slots are the edge cases: clock 0, clock C*bs - 1, an all-trash table
    row, a parked clock past the table, a row with nothing to attend
    (pad > t, only with ``padded``) and three ordinary ones.  With
    ``clocks`` the pads are ``pads``, or clock // 7."""
    dev = torch.device("cuda")
    S = 8
    NB1 = S * C + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    pk = torch.randn(NB1, bs, nh, hd, generator=g, device=dev).to(dtype)
    pv = torch.randn(NB1, bs, nh, hd, generator=g, device=dev).to(dtype)
    table = (torch.randperm(NB1 - 1, generator=g, device=dev) + 1) \
        .view(S, C).to(torch.int32)
    full = C * bs
    empty = []
    if clocks is None:
        clocks = [0, full - 1, full // 3, full + bs + 3, full // 2,
                  full - bs, 1, full // 5]
        pads = [0, bs + 1, 0, 3, full // 4, 2 * bs, 0, full // 5]
        table[2] = 0                                   # an inactive slot
        if padded:
            pads[6], empty = 5, [6]                    # pad 5 > clock 1
    elif pads is None:
        pads = [c // 7 for c in clocks]
    q = torch.randn(S, nh, hd, generator=g, device=dev).to(dtype)
    i32 = dict(dtype=torch.int32, device=dev)
    return dict(q=q, pk=pk, pv=pv, table=table,
                t=torch.tensor(clocks, **i32),
                pad=torch.tensor(pads, **i32) if padded else None,
                clocks=clocks, pads=pads if padded else [0] * S, empty=empty)


def decode_args(c):
    return c["q"], c["pk"], c["pv"], c["table"], c["t"], c["pad"]


def compare_decode(c, label):
    """Paged decode kernel vs plain on every slot with something to attend
    (the others must be zeros), and the ragged kernel on the same slots as
    one decode row each.  Returns the max abs error against the plain
    version."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    got = pa.paged_decode_attention_cuda(*decode_args(c))
    want = pa.paged_decode_attention_ref(*decode_args(c))
    S, (bs, C) = c["q"].shape[0], (c["pk"].shape[1], c["table"].shape[1])
    # a decode row's position must lie inside the table: a parked clock
    # past it attends the same C * bs positions
    row_pos = c["t"].clamp(max=C * bs - 1)
    rag = rpa.ragged_attention_cuda(
        c["q"], c["pk"], c["pv"], c["table"],
        torch.arange(S, dtype=torch.int32, device="cuda"), row_pos, c["pad"])
    torch.cuda.synchronize()
    real = [s for s in range(S) if s not in c["empty"]]
    atol, rtol = DECODE_TOL[c["q"].dtype]
    tol = f"{atol} + {rtol:.3e} |want|"
    g, w, r = got[real].float(), want[real].float(), rag[real].float()
    err = (g - w).abs().max().item()
    rerr = (g - r).abs().max().item()
    check(torch.isfinite(got).all().item(), f"phase10 {label}: non-finite")
    check(torch.allclose(g, w, rtol=rtol, atol=atol),
          f"phase10 {label}: kernel vs plain max abs err {err}, some "
          f"element past {tol}")
    check(torch.allclose(g, r, rtol=rtol, atol=atol),
          f"phase10 {label}: paged vs ragged kernel max abs err {rerr}, "
          f"some element past {tol}")
    for s in c["empty"]:
        check(got[s].abs().max().item() == 0.0,
              f"phase10 {label}: slot {s} attends nothing and is not zero")
    say(f"phase10 {label}: slots {len(real)} max_abs_err {err:.3e} vs "
        f"plain, {rerr:.3e} vs the ragged kernel (tol {tol})"
        + (f", {len(c['empty'])} empty slot zero" if c["empty"] else ""))
    return err


def phase10():
    """Every decode case, the skipped-tile slots, and two launches on the
    same inputs; returns the serve-shape case's max abs error."""
    from paddle_tpu_torch.ops import paged_attention as pa

    errs = [compare_decode(make_decode_case(dt, hd, nh, bs, C, padded,
                                            seed=20 + i), label)
            for i, (label, dt, hd, nh, bs, C, padded)
            in enumerate(DECODE_CASES)]
    clocks, pads = zip(*SKIP_SLOTS)
    compare_decode(make_decode_case(torch.bfloat16, 64, 12, 32, 20, True,
                                    seed=39, clocks=list(clocks),
                                    pads=list(pads)),
                   "bf16 hd64 bs32 C20, whole tiles skipped at both ends")
    c = serve_decode_case()
    runs = [pa.paged_decode_attention_cuda(*decode_args(c)) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*runs), "phase10: two paged kernel launches on the "
                              "same inputs differ")
    say("phase10 paged_decode_attention launched twice on the serve case: "
        "bit-identical")
    return errs[0]


def serve_decode_case():
    """The phase-12 decode shape: S 8, nh 12, hd 64, bs 32, C 20 (the
    power-of-two cover 32 capped at MB = 20), clocks spread over 128-639,
    bf16."""
    return make_decode_case(torch.bfloat16, 64, 12, 32, 20, True, seed=40,
                            clocks=[128, 201, 274, 347, 420, 493, 566, 639])


def time_decode(c):
    """(kernel ms, plain ms, sdpa ms, sdpa + gather ms, bound ms, bound_by)
    for one decode tick's attention."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import paged_attention as pa

    args = decode_args(c)
    ms = time_cold_ms(lambda: pa.paged_decode_attention_cuda(*args))
    plain_ms = time_cold_ms(lambda: pa.paged_decode_attention_ref(*args))
    q, table = c["q"], c["table"].long()
    S, nh, hd = q.shape
    C, bs = table.shape[1], c["pk"].shape[1]

    def dense(pool):
        return pool[table].reshape(S, C * bs, nh, hd).permute(0, 2, 1, 3)

    col = torch.arange(C * bs, device=q.device)
    mask = ((col[None] <= c["t"].long()[:, None])
            & (col[None] >= c["pad"].long()[:, None]))[:, None, None, :]
    qs = q[:, :, None, :]
    k, v = dense(c["pk"]).contiguous(), dense(c["pv"]).contiguous()
    library_ms = time_cold_ms(
        lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask))
    gather_ms = time_cold_ms(lambda: F.scaled_dot_product_attention(
        qs, dense(c["pk"]), dense(c["pv"]), attn_mask=mask))
    return (ms, plain_ms, library_ms, gather_ms, *decode_bound(c))


def decode_bound(c):
    """(ms, "bytes"|"operations") of one decode tick's attention: the K and
    V positions each slot attends, q and out, the table and the two clock
    vectors; 4·nh·hd flops a position."""
    q, table = c["q"], c["table"]
    S, nh, hd = q.shape
    C, bs = table.shape[1], c["pk"].shape[1]
    positions = sum(max(min(t, C * bs - 1) - p + 1, 0)
                    for t, p in zip(c["clocks"], c["pads"]))
    el = q.element_size()
    nbytes = (2 * positions * nh * hd * el + 2 * q.numel() * el
              + 4 * (table.numel() + 2 * S))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 4 * nh * hd * positions / PEAK_FLOPS[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------ phase 11 --

def streams_agree(label, a, b, reqs, buckets, cpu_model, tol=1e-3):
    """Two engines' greedy streams for the same requests must be equal,
    or diverge only where ``cpu_model``'s top-2 logit gap (on its own
    device: the CPU, or the card for the bf16 checks) is under ``tol``.
    Returns how many are equal."""
    from paddle_tpu_torch.jit.bucketing import select_bucket

    same = 0
    for i, (x, y) in enumerate(zip(a, b)):
        check(len(x) == len(y) == reqs[i][1], f"{label}: request {i} short")
        if x == y:
            same += 1
            continue
        k = next(j for j in range(len(x)) if x[j] != y[j])
        prompt = reqs[i][0]
        pad = select_bucket(len(prompt), buckets) - len(prompt)
        ids = [0] * pad + prompt + y[:k]
        top2 = torch.topk(logits_at(cpu_model, ids, pad), 2).values
        gap = float(top2[0] - top2[1])
        say(f"{label}: request {i} diverges at token {k}: {x[k]} vs {y[k]}, "
            f"top-2 logit gap {gap:.3e}")
        check(gap < tol, f"{label}: request {i} diverged where the top-2 "
                         f"gap is {gap} (>= {tol})")
    return same


def phase11():
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             params_from_numpy)
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)

    # the 128 bucket's admission prefill goes through flash_fwd on the
    # card (the 64 bucket's through dense attention), so the streams below
    # hold that kernel's causal left-padded call against the CPU too
    buckets = [64, 128]
    rng = np.random.RandomState(2)
    lens = [rng.randint(10, 61) if i % 2 else rng.randint(65, 125)
            for i in range(6)]
    reqs = [([int(t) for t in rng.randint(1, 50304, n)], 24) for n in lens]

    def models(kv):
        cfg = gpt_preset("gpt2-small", num_layers=2,
                         compute_dtype="float32", kv_cache_dtype=kv)
        cpu = GPTModel(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
        state = {n: p.detach().numpy() for n, p in cpu.named_parameters()}
        return {"cpu": cpu, "cuda": params_from_numpy(state, cfg,
                                                      device="cuda")}

    def run(cls, model, dev, **kw):
        eng = cls(model, max_slots=4, max_len=256, prompt_buckets=buckets,
                  device=dev, **kw)
        rids = [eng.add_request(p, n) for p, n in reqs]
        got = eng.run_to_completion(max_ticks=2000)
        return [got[r] for r in rids], eng

    paged = dict(block_size=16, num_blocks=28, ticks_per_sync=2)
    fp = models(None)
    pa.paged_decode_attention_cuda.launches = 0
    streams, preempt = {}, {}
    for chunk in (None, 32):
        for dev in ("cuda", "cpu"):
            got, eng = run(PagedContinuousBatchingEngine, fp[dev], dev,
                           prefill_chunk=chunk, **paged)
            streams[chunk, dev], preempt[chunk, dev] = got, eng.preemptions
            check(eng.blocks_in_use == 0, f"phase11 {dev}: blocks leaked")
        check(preempt[chunk, "cuda"] == preempt[chunk, "cpu"] >= 1,
              f"phase11: preemptions {preempt} (expected the same, >= 1)")
    check(pa.paged_decode_attention_cuda.launches > 0,
          "phase11: the paged kernel never launched")
    card = streams[None, "cuda"]
    others = {
        "CPU": streams[None, "cpu"],
        "prefill_chunk 32": streams[32, "cuda"],
        "prefill_chunk 32 on the CPU": streams[32, "cpu"],
        "contiguous engine": run(ContinuousBatchingEngine, fp["cuda"],
                                 "cuda", ticks_per_sync=2)[0],
        "ragged engine": run(RaggedPagedContinuousBatchingEngine, fp["cuda"],
                             "cuda", block_size=16, token_budget=68)[0]}
    solo = []
    for p, n in reqs:
        P = next(b for b in buckets if b >= len(p))
        mask = [[0] * (P - len(p)) + [1] * len(p)]
        solo.append(fp["cuda"].generate([[0] * (P - len(p)) + p], n,
                                        prompt_mask=mask)[0].tolist())
    others["solo generate()"] = solo
    same = {name: streams_agree(f"phase11 paged vs {name}", card, got, reqs,
                                buckets, fp["cpu"])
            for name, got in others.items()}
    del fp
    q8 = models("int8")
    before = pa.paged_decode_attention_cuda.launches
    i8 = {dev: run(PagedContinuousBatchingEngine, q8[dev], dev,
                   block_size=16, ticks_per_sync=2)[0]
          for dev in ("cuda", "cpu")}
    check(pa.paged_decode_attention_cuda.launches == before,
          "phase11: an int8 pool reached the paged kernel")
    same["int8 pools, card vs CPU"] = streams_agree(
        "phase11 int8 card vs CPU", i8["cuda"], i8["cpu"], reqs, buckets,
        q8["cpu"])
    whole, chunked = preempt[None, "cuda"], preempt[32, "cuda"]
    say(f"phase11 card's paged engine (gpt2-small width, 2 layers, fp32, "
        f"ticks_per_sync 2, 28-block pool, {whole} preemptions; {chunked} "
        f"with prefill_chunk 32), 6 "
        f"requests x 24 greedy tokens, streams equal to: "
        + "; ".join(f"{name} {n}/6" for name, n in same.items()))


# ------------------------------------------------------------ phase 12 --

def bench_requests(vocab):
    """``tools/serve_bench.py``'s accelerator traffic: 24 prompts of 64-128
    tokens from ``RandomState(0)``, budgets [64, 128, 256, 512] * 6."""
    rng = np.random.RandomState(0)
    prompts = [[int(t) for t in rng.randint(1, vocab, rng.randint(64, 129))]
               for _ in range(24)]
    return list(zip(prompts, [64, 128, 256, 512] * 6))


def serve_upfront(eng, reqs, profile_steps=None, kernel=None):
    """Queue every request, then step to quiescence; returns (wall s,
    {rid: tokens}, {rid: budget}).  ``profile_steps=(a, b)`` traces
    scheduler rounds [a, b), one decode sync each, and abandons the serve
    after round b (a warm-up that only the trace is wanted from)."""
    warm(eng)
    budgets = {eng.add_request(p, n): n for p, n in reqs}
    step, prof = 0, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.pending() and not (profile_steps and step >= profile_steps[1]):
        if profile_steps and step == profile_steps[0]:
            prof = start_profile()
        eng.step()
        step += 1
        if prof is not None and step == profile_steps[1]:
            report_profile(prof, step - profile_steps[0],
                           eng.ticks_per_sync, kernel)
            prof = None
    torch.cuda.synchronize()
    return time.perf_counter() - t0, eng.pop_finished(), budgets


SERVE_SLOTS, SERVE_TICKS, SERVE_BUCKET, SERVE_BLOCK = 8, 8, 128, 32


def bucketed_serve():
    """The phase-12 gpt2-small model (bf16, seed 0), its requests, the
    engines' max_len and a factory of the paged engine at its settings."""
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset
    from paddle_tpu_torch.serving_paged import PagedContinuousBatchingEngine

    cfg = gpt_preset("gpt2-small", vocab_size=50304,
                     max_position_embeddings=1024, compute_dtype="bfloat16")
    S, k, P, blk = SERVE_SLOTS, SERVE_TICKS, SERVE_BUCKET, SERVE_BLOCK
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    reqs = bench_requests(cfg.vocab_size)
    max_len = P + -(-max(n for _, n in reqs) // k) * k
    max_len = -(-max_len // blk) * blk

    def paged(**kw):
        return PagedContinuousBatchingEngine(
            model, max_slots=S, max_len=max_len, block_size=blk,
            prompt_buckets=[P], ticks_per_sync=k, device="cuda", **kw)
    return model, reqs, max_len, paged


def phase12():
    """The bucketed paged serve at full width; returns the paged kernel's
    launches in the measured serve."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import ContinuousBatchingEngine

    model, reqs, max_len, paged = bucketed_serve()
    L, S, k, P, blk = (model.config.num_layers, SERVE_SLOTS, SERVE_TICKS,
                       SERVE_BUCKET, SERVE_BLOCK)
    total = sum(n for _, n in reqs)

    def check_budgets(label, got, budgets):
        check(sorted(got) == sorted(budgets), f"{label}: requests missing")
        for rid, n in budgets.items():
            check(len(got[rid]) == n, f"{label}: request {rid} got "
                                      f"{len(got[rid])} tokens, not {n}")

    # warm-up: the first 60 scheduler rounds of the serve, the last 20 of
    # them traced by torch.profiler (each round here is one sync of 8
    # ticks, plus any admissions)
    say("phase12 profile, 20 syncs of 8 ticks (a step is a sync):")
    serve_upfront(paged(), reqs, profile_steps=(40, 60),
                  kernel="paged_decode")
    pa.paged_decode_attention_cuda.launches = 0   # the measured main path
    A.flash_fwd_cuda.launches = 0
    eng = paged()
    wall, got, budgets = serve_upfront(eng, reqs)
    launches = pa.paged_decode_attention_cuda.launches
    prefills = A.flash_fwd_cuda.launches
    check_budgets("phase12 paged", got, budgets)
    m = eng.metrics()
    check(eng.blocks_in_use == 0, f"phase12: {eng.blocks_in_use} blocks "
                                  f"still in use")
    check(m["blocks_allocated"] == m["blocks_released"] > 0,
          f"phase12: allocated {m['blocks_allocated']} != released "
          f"{m['blocks_released']}")
    ticks = eng.decode_syncs * k
    check(launches == L * ticks > 0,
          f"phase12: paged kernel launches {launches} != {L} x {ticks} "
          f"decode ticks")
    check(prefills == L * len(reqs),
          f"phase12: flash_fwd launches {prefills} != {L} x {len(reqs)} "
          f"admission prefills")
    for pool in eng.caches:
        check(torch.isfinite(pool.float()).all().item(),
              "phase12: non-finite KV pool")
    say(f"phase12 gpt2-small bf16 bucketed paged serve (8 slots, "
        f"ticks_per_sync {k}, block {blk}, max_len {max_len}): {len(got)} "
        f"requests, {total} tokens, {eng.decode_syncs} syncs = {ticks} "
        f"ticks, {total / wall:.1f} tokens/s, "
        f"{1e3 * wall / eng.decode_syncs:.3f} ms/sync, wall {wall:.3f} s, "
        f"blocks_high_water {eng.blocks_high_water} of {eng.NB}, paged "
        f"kernel launches {launches} = {L} x {ticks}, flash_fwd launches "
        f"{prefills} = {L} x {len(reqs)}, preemptions {eng.preemptions}")
    del eng

    def contiguous():
        return ContinuousBatchingEngine(
            model, max_slots=S, max_len=max_len, prompt_buckets=[P],
            ticks_per_sync=k, device="cuda")

    serve_upfront(contiguous(), [(p, 16) for p, _ in reqs[:S]])  # warm-up
    ceng = contiguous()
    cwall, cgot, cbudgets = serve_upfront(ceng, reqs)
    check_budgets("phase12 contiguous", cgot, cbudgets)
    say(f"phase12 the same requests through the contiguous engine: "
        f"{total / cwall:.1f} tokens/s, "
        f"{1e3 * cwall / ceng.decode_syncs:.3f} ms/sync over "
        f"{ceng.decode_syncs} syncs, wall {cwall:.3f} s")
    del ceng

    # the bench's static arm: batches of S left-padded prompts, each run to
    # its LONGEST budget by generate() (members cannot retire early)
    def static(reqs):
        n = 0
        for i in range(0, len(reqs), S):
            chunk = reqs[i:i + S]
            ids = [[0] * (P - len(p)) + p for p, _ in chunk]
            mask = [[0] * (P - len(p)) + [1] * len(p) for p, _ in chunk]
            out = model.generate(ids, max(b for _, b in chunk),
                                 prompt_mask=mask)
            n += out.shape[0] * out.shape[1]
        torch.cuda.synchronize()
        return n

    static([(p, 16) for p, _ in reqs[:S]])                      # warm-up
    t0 = time.perf_counter()
    made = static(reqs)
    swall = time.perf_counter() - t0
    check(made == 24 * 512, f"phase12 static: {made} tokens generated")
    say(f"phase12 the same requests through batched generate() with a "
        f"prompt mask (static batches of {S}): {total / swall:.1f} useful "
        f"tokens/s ({total} of {made} generated), wall {swall:.3f} s")
    return launches


# ------------------------------------------------------------ phase 13 --

# a near-tie at bf16: the top-2 gap of the bf16 logits under 2^-5 (a few
# of bf16's 8-bit ulps at the logits' magnitude, ~1); another schedule of
# the same bf16 work (another pack, another chunk, another cuBLAS
# algorithm) may flip such an argmax
BF16_TIE = 2.0 ** -5


def tie_gap(model, prompt, buckets, prefix):
    """``model``'s top-2 logit gap after ``prompt`` + ``prefix``
    (left-padded to its bucket), on the model's own device and dtype."""
    from paddle_tpu_torch.jit.bucketing import select_bucket

    pad = select_bucket(len(prompt), buckets) - len(prompt)
    top2 = torch.topk(logits_at(model, [0] * pad + prompt + prefix, pad),
                      2).values
    return float(top2[0] - top2[1])


def same_or_tie(label, got, want, prompt, buckets, model):
    """``got`` equals ``want`` (the reference stream of the same request),
    or first diverges where ``model``'s top-2 gap on ``want``'s context is
    under BF16_TIE (printed).  Returns True when equal."""
    n = min(len(got), len(want))
    k = next((j for j in range(n) if got[j] != want[j]), None)
    if k is None:
        check(len(got) == len(want), f"{label}: lengths {len(got)} vs "
                                     f"{len(want)} with no differing token")
        return True
    gap = tie_gap(model, prompt, buckets, want[:k])
    say(f"{label}: diverges at token {k}: {got[k]} vs {want[k]}, top-2 "
        f"logit gap {gap:.3e}")
    check(gap < BF16_TIE, f"{label}: diverged where the top-2 gap is {gap} "
                          f"(>= {BF16_TIE})")
    return False


def full_width_model(kv=None):
    """Phase 3's gpt2-small (vocab 50304, 12 layers, bf16) from seed 0."""
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset

    cfg = gpt_preset("gpt2-small", compute_dtype="bfloat16",
                     kv_cache_dtype=kv)
    return GPTModel(cfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))


def balanced_with_cache(label, eng):
    """The allocator balances with a prefix cache: every block off the
    free list is a cached one, every pin released, allocations equal
    releases; after ``flush_prefix`` the pool is empty."""
    m = eng.metrics()
    check(m["blocks_allocated"] == m["blocks_released"] > 0,
          f"{label}: allocated {m['blocks_allocated']} != released "
          f"{m['blocks_released']}")
    check(eng.blocks_in_use == len(eng._prefix_cache),
          f"{label}: {eng.blocks_in_use} blocks in use, "
          f"{len(eng._prefix_cache)} cached")
    check(all(eng._refs[b] == 0 for b in eng._prefix_cache.values()),
          f"{label}: a cached block is still pinned")
    eng.flush_prefix()
    check(eng.blocks_in_use == 0, f"{label}: {eng.blocks_in_use} blocks in "
                                  f"use after flush_prefix()")


def phase13():
    """The prefix cache at full width, ``bench.py bench_gpt_kv_tier``'s
    settings without the tiered store: gpt2-small bf16 (seed 0), 4 slots,
    max_len 512, block 16, token budget 64, buckets [64, 256], one
    240-token prompt from RandomState(0), 16 new tokens, 5 repeats, through
    a cold ragged engine (no cache) and a warm one (cache on, primed once).
    Warm streams equal the cold stream or diverge at a bf16 near-tie; 5
    hits of 15 blocks; the allocator balances; the ragged kernel launched
    L times a ragged step in each arm.  Then the bucketed paged engine
    with the cache on serves the prompt twice: the second admission hits
    and runs its 16-token suffix through the chunk path; its stream equals
    the first or diverges at a near-tie; the paged kernel launched L times
    a decode tick and ``flash_fwd`` L times (the one cold admission)."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)

    model = full_width_model()
    L = model.config.num_layers
    buckets, n_new, reps = [64, 256], 16, 5
    prompt = [int(t) for t in np.random.RandomState(0).randint(
        1, model.config.vocab_size, 240)]
    settings = dict(max_slots=4, max_len=512, block_size=16,
                    prompt_buckets=buckets, device="cuda")

    def ragged(prefix):
        eng = RaggedPagedContinuousBatchingEngine(
            model, token_budget=64, enable_prefix_cache=prefix, **settings)
        warm(eng)
        return eng

    def ttft_once(eng):
        first = []
        rid = eng.add_request(
            prompt, n_new, on_token=lambda r, t, d:
            first.append(time.perf_counter()) if not first else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.pending():
            eng.step()
        return (first[0] - t0) * 1e3, eng.pop_finished()[rid]

    ttft_once(ragged(False))                              # warm-up
    arms = {}
    for name, prefix in (("cold", False), ("warm", True)):
        eng = ragged(prefix)
        rpa.ragged_attention_cuda.launches = 0
        if prefix:
            prime = ttft_once(eng)[1]                     # publishes blocks
        runs = [ttft_once(eng) for _ in range(reps)]
        launches = rpa.ragged_attention_cuda.launches
        check(launches == L * eng.ragged_steps > 0,
              f"phase13 {name}: kernel launches {launches} != {L} x ragged "
              f"steps {eng.ragged_steps}")
        arms[name] = (eng, [r[0] for r in runs], [r[1] for r in runs],
                      launches)
    cold_eng, cold_ttft, cold_streams, cold_launches = arms["cold"]
    warm_eng, warm_ttft, warm_streams, warm_launches = arms["warm"]
    want = cold_streams[0]
    check(all(len(s) == n_new for s in cold_streams + warm_streams + [prime]),
          "phase13: a stream is short")
    check(all(s == want for s in cold_streams),
          "phase13: the cold repeats differ from one another")
    same = sum(same_or_tie(f"phase13 warm repeat {i} vs cold", s, want,
                           prompt, buckets, model)
               for i, s in enumerate([prime] + warm_streams))
    check(cold_eng.prefix_hits == 0, "phase13: the cold arm hit")
    check(warm_eng.prefix_hits == reps
          and warm_eng.prefix_blocks_reused == reps * 15,
          f"phase13: prefix_hits {warm_eng.prefix_hits}, blocks reused "
          f"{warm_eng.prefix_blocks_reused} (want {reps}, {reps * 15})")
    check(cold_eng.blocks_in_use == 0, "phase13 cold: blocks leaked")
    balanced_with_cache("phase13 warm", warm_eng)
    say(f"phase13 gpt2-small bf16 prefix cache (240-token prompt, bucket "
        f"256, block 16, budget 64, 16 new tokens, {reps} repeats): TTFT "
        f"p50 cold {float(np.median(cold_ttft)):.3f} ms, warm "
        f"{float(np.median(warm_ttft)):.3f} ms (cold {cold_ttft}, warm "
        f"{warm_ttft}); hits {warm_eng.prefix_hits}, blocks reused "
        f"{warm_eng.prefix_blocks_reused}; ragged steps cold "
        f"{cold_eng.ragged_steps} warm {warm_eng.ragged_steps}, kernel "
        f"launches {cold_launches} = {L} x {cold_eng.ragged_steps} and "
        f"{warm_launches} = {L} x {warm_eng.ragged_steps}; warm streams "
        f"equal to cold {same}/{reps + 1}")

    eng = PagedContinuousBatchingEngine(model, enable_prefix_cache=True,
                                        **settings)
    warm(eng)          # the hit's cpre program is built at its dispatch
    pa.paged_decode_attention_cuda.launches = 0
    A.flash_fwd_cuda.launches = 0
    first = ttft_once(eng)[1]
    second = ttft_once(eng)[1]
    decode, prefills = (pa.paged_decode_attention_cuda.launches,
                        A.flash_fwd_cuda.launches)
    ticks = eng.decode_syncs * eng.ticks_per_sync
    check(decode == L * ticks > 0, f"phase13 bucketed: paged kernel "
                                   f"launches {decode} != {L} x {ticks}")
    check(prefills == L, f"phase13 bucketed: flash_fwd launches {prefills} "
                         f"!= {L} (one cold admission)")
    check(eng.prefix_hits == 1 and eng.prefix_blocks_reused == 15,
          f"phase13 bucketed: hits {eng.prefix_hits}, reused "
          f"{eng.prefix_blocks_reused}")
    check(len(first) == len(second) == n_new, "phase13 bucketed: short")
    hit_same = same_or_tie("phase13 bucketed hit vs its cold stream",
                           second, first, prompt, buckets, model)
    cold_same = same_or_tie("phase13 bucketed cold vs the ragged cold",
                            first, want, prompt, buckets, model)
    balanced_with_cache("phase13 bucketed", eng)
    say(f"phase13 bucketed paged engine, prefix cache on: the repeat hit "
        f"15 blocks, stream equal to its cold one {hit_same}, cold equal to "
        f"the ragged cold {cold_same}; paged kernel launches {decode} = {L} "
        f"x {ticks} ticks, flash_fwd {prefills}")


# ------------------------------------------------------------ phase 14 --

SPEC_K = 4


def phase14(plain_streams, plain_streams8):
    """Speculation at full width: phase 3's traffic and settings uncut
    (gpt2-small bf16, 24 requests, 8 slots, max_len 512, block 16, budget
    256, buckets [64, 128], 2 arrivals a step) with ``draft_model=model``
    (a self-draft, as ``bench.py`` bench_gpt_serving's speculative arm)
    and ``draft_k=4``.  Every request gets exactly its tokens, the
    allocator balances, acceptance >= 0.5, each stream equals phase 3's
    plain stream for the request or diverges at a bf16 near-tie.  The
    eager step launches the ragged kernel (L + L_d) times a step (the
    target's pass and the draft's ingest of the same pack) and the paged
    decode kernel K x L_d times a step (the draft's K proposal steps run
    in every step's program).  A warm-up serve
    traces 20 mid-run steps; a plain serve and the spec serve are timed
    back to back; then an int8-pool spec serve of the first 8 requests
    (int8 draft pools take the gather path: no paged-kernel launch)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    model = full_width_model()
    L = Ld = model.config.num_layers
    K = SPEC_K
    reqs = serving_traffic(model.config.vocab_size)
    spec = dict(draft_model=model, draft_k=K)
    say("phase14 profile, 20 steps of the speculative serve:")
    serve(model, reqs, profile_steps=(20, 40), **spec)      # warm-up
    _, pwall, pgot, _ = serve(model, reqs)                 # plain, timed
    ptokens = sum(len(v) for v in pgot.values())

    def run(model, reqs, label):
        rpa.ragged_attention_cuda.launches = 0
        pa.paged_decode_attention_cuda.launches = 0
        eng, wall, got, budgets = serve(model, reqs,
                                        draft_model=model, draft_k=K)
        ragged = rpa.ragged_attention_cuda.launches
        decode = pa.paged_decode_attention_cuda.launches
        check(sorted(got) == sorted(budgets), f"{label}: requests missing")
        for rid, n in budgets.items():
            check(len(got[rid]) == n, f"{label}: request {rid} got "
                                      f"{len(got[rid])} tokens, not {n}")
        m = eng.metrics()
        check(eng.blocks_in_use == 0,
              f"{label}: {eng.blocks_in_use} blocks still in use")
        check(m["blocks_allocated"] == m["blocks_released"] > 0,
              f"{label}: allocated {m['blocks_allocated']} != released "
              f"{m['blocks_released']}")
        check(ragged == (L + Ld) * eng.ragged_steps > 0,
              f"{label}: ragged kernel launches {ragged} != ({L} + {Ld}) x "
              f"{eng.ragged_steps} steps")
        for pool in eng.caches + eng.draft_caches:
            for plane in (pool if isinstance(pool, tuple) else (pool,)):
                check(torch.isfinite(plane.float()).all().item(),
                      f"{label}: non-finite KV pool")
        check(eng.acceptance_rate >= 0.5,
              f"{label}: acceptance {eng.acceptance_rate} < 0.5")
        return eng, wall, [got[r] for r in sorted(got)], ragged, decode

    eng, wall, streams, ragged, decode = run(model, reqs, "phase14 bf16")
    check(decode == K * Ld * eng.ragged_steps > 0,
          f"phase14: paged kernel launches {decode} != {K} x {Ld} x "
          f"{eng.ragged_steps} steps")
    tokens = sum(len(s) for s in streams)
    same = sum(same_or_tie(f"phase14 request {i} spec vs plain", s,
                           plain_streams[i], reqs[i][0], [64, 128], model)
               for i, s in enumerate(streams))
    say(f"phase14 gpt2-small bf16 speculative serve (self-draft, K {K}): "
        f"{len(streams)} requests, {tokens} tokens, {eng.ragged_steps} "
        f"ragged steps ({eng.spec_rounds} speculating), acceptance "
        f"{eng.acceptance_rate:.4f} ({eng.tokens_accepted}/"
        f"{eng.tokens_drafted}), {tokens / wall:.1f} tokens/s, "
        f"{1e3 * wall / eng.ragged_steps:.3f} ms/step, wall {wall:.3f} s; "
        f"plain (phase 3's serve, timed just before) {ptokens / pwall:.1f} "
        f"tokens/s, wall {pwall:.3f} s; ragged kernel launches {ragged} = "
        f"({L} + {Ld}) x {eng.ragged_steps}, paged kernel launches {decode} "
        f"= {K} x {Ld} x {eng.ragged_steps}; streams equal to phase 3's "
        f"{same}/{len(streams)}")
    del model, eng
    m8 = full_width_model("int8")
    eng8, wall8, streams8, ragged8, decode8 = run(m8, reqs[:8],
                                                  "phase14 int8")
    check(decode8 == 0, f"phase14 int8: {decode8} paged kernel launches "
                        f"(int8 pools take the gather path)")
    same8 = sum(same_or_tie(f"phase14 int8 request {i} spec vs plain", s,
                            plain_streams8[i], reqs[i][0], [64, 128], m8)
                for i, s in enumerate(streams8))
    tokens8 = sum(len(s) for s in streams8)
    say(f"phase14 gpt2-small int8-pool speculative serve (first 8 "
        f"requests): {tokens8} tokens, {eng8.ragged_steps} ragged steps, "
        f"acceptance {eng8.acceptance_rate:.4f}, {tokens8 / wall8:.1f} "
        f"tokens/s, ragged kernel launches {ragged8} = ({L} + {Ld}) x "
        f"{eng8.ragged_steps}; streams equal to phase 3's int8 {same8}/8")


# ------------------------------------------------------------ phase 15 --

def mixed_sampling(eos):
    """Phase 15's three request kinds, by request index mod 3."""
    return [{},
            dict(repetition_penalty=1.3, min_new_tokens=16,
                 eos_token_id=eos),
            dict(greedy=False, temperature=0.8, top_k=50, top_p=0.95)]


def check_windows(label, streams, budgets, kinds, eos):
    """Greedy and sampled rows get exactly their budget; a penalised row
    gets at least 16 tokens, no EOS among its first 16, and stops early
    only on its EOS."""
    for i, (s, n) in enumerate(zip(streams, budgets)):
        if i % 3 != 1:
            check(len(s) == n, f"{label}: request {i} got {len(s)} tokens, "
                               f"not {n}")
            continue
        check(16 <= len(s) <= n, f"{label}: request {i} got {len(s)} tokens")
        check(eos not in s[:16], f"{label}: request {i} emitted EOS inside "
                                 f"its min_new_tokens window")
        check(len(s) == n or s[-1] == eos,
              f"{label}: request {i} stopped early without EOS")


def penalised_gap(model, prompt, bucket, prefix, kind):
    """The top-2 gap of ``model``'s logits after ``prompt`` + ``prefix``
    with the request's processors applied (the penalty over the prompt
    and ``prefix``, EOS masked inside the window)."""
    from paddle_tpu_torch.models._decode import (apply_repetition_penalty,
                                                 suppress_eos)

    pad = bucket - len(prompt)
    l2 = logits_at(model, [0] * pad + prompt + prefix, pad)[None]
    if kind:
        seen = torch.zeros_like(l2, dtype=torch.bool)
        seen[0, prompt + prefix] = True
        l2 = apply_repetition_penalty(l2, seen, kind["repetition_penalty"])
        if len(prefix) < kind["min_new_tokens"]:
            l2 = suppress_eos(l2, kind["eos_token_id"], True)
    top2 = torch.topk(l2[0], 2).values
    return float(top2[0] - top2[1])


def phase15():
    """Per-request sampling and the logits processors at full width:
    phase 12's bucketed paged engine settings (gpt2-small bf16 seed 0, 8
    slots, ticks_per_sync 8, block 32, bucket 128, max_len 640) with
    ``per_request_sampling=True`` and its first 12 requests split three
    ways: greedy; greedy with repetition_penalty 1.3, min_new_tokens 16
    and an EOS (the second token of request 1's greedy stream); sampled
    (temperature 0.8, top_k 50, top_p 0.95).  Served twice from one
    generator seed, then through the ragged engine.  Token counts and
    windows hold, the two serves are identical, greedy rows equal a
    greedy-only engine's or diverge at a bf16 near-tie, and each engine
    launched its kernels exactly (paged: L a decode tick, ``flash_fwd`` L
    an admission; ragged: L a step).  Then card vs CPU at gpt2-small width
    with 2 layers in fp32 (the first 6 requests, 24 tokens each, through
    both engines): greedy and penalised rows equal, or diverging where
    the CPU's processed top-2 gap is under 1e-3."""
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             params_from_numpy)
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)

    model, reqs, max_len, _ = bucketed_serve()
    L = model.config.num_layers
    reqs = reqs[:12]
    budgets = [n for _, n in reqs]
    P, blk = SERVE_BUCKET, SERVE_BLOCK

    def bucketed(**kw):
        eng = PagedContinuousBatchingEngine(
            model, max_slots=SERVE_SLOTS, max_len=max_len, block_size=blk,
            prompt_buckets=[P], ticks_per_sync=SERVE_TICKS, device="cuda",
            **kw)
        warm(eng)
        return eng

    def ragged(**kw):
        eng = RaggedPagedContinuousBatchingEngine(
            model, max_slots=SERVE_SLOTS, max_len=max_len, block_size=16,
            prompt_buckets=[P], token_budget=256, device="cuda", **kw)
        warm(eng)
        return eng

    def run(eng, sampling=None):
        """(streams in request order, wall s)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.add_request(p, n, **({} if sampling is None
                                         else sampling[i % 3]))
                for i, (p, n) in enumerate(reqs)]
        got = eng.run_to_completion(max_ticks=5000)
        torch.cuda.synchronize()
        return [got[r] for r in rids], time.perf_counter() - t0

    greedy, walls = {}, {}
    greedy["bucketed"], walls["bucketed greedy-only"] = run(bucketed())
    greedy["ragged"], walls["ragged greedy-only"] = run(ragged())
    eos = greedy["bucketed"][1][1]
    kinds = mixed_sampling(eos)

    def seeded(make, name):
        label = f"phase15 {name}"
        streams = []
        for i in range(2):
            eng = make(per_request_sampling=True,
                       generator=torch.Generator("cuda").manual_seed(15))
            rpa.ragged_attention_cuda.launches = 0
            pa.paged_decode_attention_cuda.launches = 0
            A.flash_fwd_cuda.launches = 0
            got, walls[f"{name} per-request {i}"] = run(eng, kinds)
            streams.append(got)
            launches = (rpa.ragged_attention_cuda.launches,
                        pa.paged_decode_attention_cuda.launches,
                        A.flash_fwd_cuda.launches)
            check(eng.blocks_in_use == 0, f"{label}: blocks leaked")
        check(streams[0] == streams[1],
              f"{label}: two serves from one generator seed differ")
        check_windows(label, streams[0], budgets, kinds, eos)
        return streams[0], eng, launches

    pstreams, peng, (r_l, d_l, f_l) = seeded(bucketed, "bucketed")
    ticks = peng.decode_syncs * peng.ticks_per_sync
    check(d_l == L * ticks > 0 and f_l == L * len(reqs) and r_l == 0,
          f"phase15 bucketed: launches paged {d_l} (want {L} x {ticks}), "
          f"flash_fwd {f_l} (want {L} x {len(reqs)}), ragged {r_l}")
    rstreams, reng, (r_l2, d_l2, f_l2) = seeded(ragged, "ragged")
    check(r_l2 == L * reng.ragged_steps > 0 and d_l2 == 0 and f_l2 == 0,
          f"phase15 ragged: launches ragged {r_l2} (want {L} x "
          f"{reng.ragged_steps}), paged {d_l2}, flash_fwd {f_l2}")
    same = {"bucketed": 0, "ragged": 0}
    for name, streams in (("bucketed", pstreams), ("ragged", rstreams)):
        for i in range(0, len(reqs), 3):
            same[name] += same_or_tie(
                f"phase15 {name} greedy request {i} vs greedy-only",
                streams[i], greedy[name][i], reqs[i][0], [P], model)
    pen = [i for i in range(1, len(reqs), 3)]
    say(f"phase15 gpt2-small bf16 per-request sampling (12 requests: 4 "
        f"greedy, 4 penalised 1.3 with min_new_tokens 16 and EOS {eos}, 4 "
        f"sampled t 0.8 top_k 50 top_p 0.95): two serves from one seed "
        f"identical on both engines; penalised lengths bucketed "
        f"{[len(pstreams[i]) for i in pen]}, ragged "
        f"{[len(rstreams[i]) for i in pen]} of {[budgets[i] for i in pen]}; "
        f"greedy rows equal to the greedy-only engine: bucketed "
        f"{same['bucketed']}/4, ragged {same['ragged']}/4; launches paged "
        f"{d_l} = {L} x {ticks}, flash_fwd {f_l} = {L} x {len(reqs)}, "
        f"ragged {r_l2} = {L} x {reng.ragged_steps}; walls "
        + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))
    del model, peng, reng

    # card vs CPU at gpt2-small width, 2 layers, fp32
    cfg = gpt_preset("gpt2-small", num_layers=2, compute_dtype="float32")
    cpu = GPTModel(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    state = {n: p.detach().numpy() for n, p in cpu.named_parameters()}
    card = params_from_numpy(state, cfg, device="cuda")
    small = [(p, 24) for p, _ in reqs[:6]]
    # the EOS: the second token of request 1's greedy stream on the CPU
    probe = PagedContinuousBatchingEngine(
        cpu, max_slots=4, max_len=256, block_size=blk, prompt_buckets=[P],
        ticks_per_sync=2, device="cpu")
    rid = probe.add_request(*small[1])
    ks = mixed_sampling(probe.run_to_completion(max_ticks=500)[rid][1])
    out = {}
    for dev, m in (("cuda", card), ("cpu", cpu)):
        for name, cls, kw in (
                ("bucketed", PagedContinuousBatchingEngine,
                 dict(block_size=blk, ticks_per_sync=2)),
                ("ragged", RaggedPagedContinuousBatchingEngine,
                 dict(block_size=16, token_budget=68))):
            eng = cls(m, max_slots=4, max_len=256, prompt_buckets=[P],
                      device=dev, per_request_sampling=True, **kw)
            rids = [eng.add_request(p, n, **ks[i % 3])
                    for i, (p, n) in enumerate(small)]
            got = eng.run_to_completion(max_ticks=2000)
            out[name, dev] = [got[r] for r in rids]
    agree = {}
    for name in ("bucketed", "ragged"):
        gs, cs = out[name, "cuda"], out[name, "cpu"]
        agree[name] = 0
        for i in (0, 1, 3, 4):                     # greedy and penalised
            g, c = gs[i], cs[i]
            kind = ks[i % 3]
            k = next((j for j in range(min(len(g), len(c)))
                      if g[j] != c[j]), None)
            if k is None:
                check(len(g) == len(c), f"phase15 card vs CPU {name}: "
                                        f"request {i} lengths differ")
                agree[name] += 1
                continue
            gap = penalised_gap(cpu, small[i][0], P, c[:k], kind)
            say(f"phase15 card vs CPU {name}: request {i} diverges at token "
                f"{k}: {g[k]} vs {c[k]}, processed CPU top-2 gap {gap:.3e}")
            check(gap < 1e-3, f"phase15 card vs CPU {name}: request {i} "
                              f"diverged where the CPU gap is {gap}")
    say(f"phase15 card vs CPU (gpt2-small width, 2 layers, fp32, per-request "
        f"planes, 6 requests x 24 tokens): greedy and penalised rows equal "
        f"bucketed {agree['bucketed']}/4, ragged {agree['ragged']}/4")


# ------------------------------------------------------------ phase 16 --

def drive(eng, reqs, arrivals=None, window=None, ticks=None):
    """Serve ``reqs`` through a warmed ``eng``: ``arrivals`` a scheduler
    round (all queued up front when None).  ``window=(a, b)`` traces rounds
    [a, b) with ``torch.profiler`` and stops after round b (a run that only
    the trace is wanted from).  Returns (wall s, streams in request order,
    rounds)."""
    rids, added, step, prof = [], 0, 0, None
    if arrivals is None:
        rids = [eng.add_request(p, n) for p, n in reqs]
        added = len(reqs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while added < len(reqs) or eng.pending():
        if window is not None and step >= window[1]:
            break
        for _ in range(arrivals or 0):
            if added < len(reqs):
                rids.append(eng.add_request(*reqs[added]))
                added += 1
        if window is not None and step == window[0]:
            prof = start_profile(cpu=False)
        eng.step()
        step += 1
        if prof is not None and step == window[1]:
            report_profile(prof, window[1] - window[0], ticks)
            prof = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = eng.pop_finished()
    return wall, [got.get(r) for r in rids], step


#: phase 16's depth: the first 2 of gpt2-small's 12 layers (cut to make
#: room for phase 25; the 12-layer phase took 166.6 s on an H100)
PROGRAM_LAYERS = 2


def phase16():
    """The engines' programs as CUDA graphs at full width (gpt2-small
    bf16, seed 0, its first ``PROGRAM_LAYERS`` layers): the ragged engine
    and the speculative one (self-draft,
    K 4) at phase 3's settings and traffic, the bucketed paged engine and
    the contiguous one at phase 12's, each warmed and served with graphs
    (the default) and then under ``disable_graphs()``.  Per mode and
    engine: warmup wall, the graph pool's memory, ms a step (a ragged
    step, or a sync of 8 decode ticks), tokens/s, and a 10-round profile
    of the device alone (device busy, device kernels a round) in a
    separate run.  Checks: no
    program is built while an engine serves (``compile_misses`` does not
    move), every request gets its budget, the kernels launched exactly
    (B1 L a ragged step, 2L a speculative one; B5 K x L a speculative
    step and L a bucketed tick; B2 L an admission of the bucketed
    engines), streams equal to the eager serve's or diverge at a bf16
    near-tie; and a per-request sampled serve (greedy, penalised and
    sampled rows) draws identical tokens both ways, on the ragged and on
    the bucketed paged engine."""
    from paddle_tpu_torch.jit.programs import disable_graphs
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ContinuousBatchingEngine
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)

    model, breqs, max_len, _ = bucketed_serve()    # phase 3's model too
    model = truncated_model(model, PROGRAM_LAYERS)
    L, K = model.config.num_layers, SPEC_K
    rreqs = serving_traffic(model.config.vocab_size)
    ragged_kw = dict(max_slots=8, max_len=512, block_size=16,
                     prompt_buckets=[64, 128], token_budget=256,
                     device="cuda")
    bucket_kw = dict(max_slots=SERVE_SLOTS, max_len=max_len,
                     prompt_buckets=[SERVE_BUCKET],
                     ticks_per_sync=SERVE_TICKS, device="cuda")

    def ragged(**kw):
        return RaggedPagedContinuousBatchingEngine(model, **ragged_kw, **kw)

    def spec(**kw):
        return ragged(draft_model=model, draft_k=K, **kw)

    def paged(**kw):
        return PagedContinuousBatchingEngine(model, block_size=SERVE_BLOCK,
                                             **bucket_kw, **kw)

    def contiguous(**kw):
        return ContinuousBatchingEngine(model, **bucket_kw, **kw)

    # name -> (factory, requests, arrivals a round, buckets, profile window)
    arms = {"ragged": (ragged, rreqs, 2, [64, 128], (40, 50)),
            "speculative": (spec, rreqs, 2, [64, 128], (10, 20)),
            "bucketed paged": (paged, breqs, None, [SERVE_BUCKET], (20, 30)),
            "contiguous": (contiguous, breqs, None, [SERVE_BUCKET],
                           (20, 30))}

    def steps_of(eng):
        return (eng.ragged_steps if hasattr(eng, "ragged_steps")
                else eng.decode_syncs)

    def serve_mode(name, make, reqs, arrivals, window):
        eng = make()
        report, pool, grown = warm(eng)
        misses = eng._compile_misses
        wall, streams, _ = drive(eng, reqs, arrivals)
        launches = (rpa.ragged_attention_cuda.launches,
                    pa.paged_decode_attention_cuda.launches,
                    A.flash_fwd_cuda.launches)
        check(eng._compile_misses == misses,
              f"phase16 {name}: {eng._compile_misses - misses} programs "
              f"built while serving")
        check(report["programs"] == len(eng.compile_grid()),
              f"phase16 {name}: warmup built {report['programs']} programs")
        for s, (_, n) in zip(streams, reqs):
            check(s is not None and len(s) == n,
                  f"phase16 {name}: a request did not get its {n} tokens")
        steps = steps_of(eng)
        ticks = steps * getattr(eng, "ticks_per_sync", 1)
        r_l, d_l, f_l = launches
        if name.startswith("ragged"):
            want = (L * steps, 0, 0)
        elif name.startswith("speculative"):
            want = (2 * L * steps, K * L * steps, 0)
        elif name.startswith("bucketed"):
            want = (0, L * ticks, L * len(reqs))
        else:
            want = (0, 0, L * len(reqs))
        check(launches == want and steps > 0,
              f"phase16 {name}: launches ragged/paged/flash_fwd {launches}, "
              f"want {want} ({steps} steps)")
        del eng
        peng = make()
        warm(peng)
        say(f"phase16 {name} profile, rounds {window[0]}-{window[1] - 1}:")
        drive(peng, reqs, arrivals, window,
              getattr(peng, "ticks_per_sync", None)
              if not hasattr(peng, "ragged_steps") else None)
        prof = report_profile.last
        tokens = sum(len(s) for s in streams)
        say(f"phase16 {name}: {tokens} tokens in {wall:.3f} s = "
            f"{tokens / wall:.1f} tokens/s, {1e3 * wall / steps:.3f} ms a "
            f"step over {steps} steps; warmup {report['programs']} programs "
            f"in {report['wall_s']:.3f} s, graph pool {pool / 2**20:.1f} "
            f"MiB (reserved memory grew {grown / 2**20:.1f} MiB); profile "
            f"{prof['wall_ms']:.3f} ms a "
            f"round, device busy {prof['busy_ms']:.3f} ms "
            f"({100 * prof['busy_share']:.1f}%), {prof['kernels']:.0f} "
            f"device kernels a round; launches ragged/paged/flash_fwd "
            f"{launches}")
        return streams, tokens / wall, 1e3 * wall / steps

    results = {}
    for name, (make, reqs, arrivals, buckets, window) in arms.items():
        g = serve_mode(f"{name} graphs", make, reqs, arrivals, window)
        with disable_graphs():
            e = serve_mode(f"{name} eager", make, reqs, arrivals, window)
        same = sum(same_or_tie(f"phase16 {name} request {i} graphs vs "
                               f"eager", a, b, reqs[i][0], buckets, model)
                   for i, (a, b) in enumerate(zip(g[0], e[0])))
        results[name] = (g, e, same)
        say(f"phase16 {name} ({L} layers): graphs {g[1]:.1f} tokens/s at "
            f"{g[2]:.3f} ms a step against eager {e[1]:.1f} tokens/s at "
            f"{e[2]:.3f} ms "
            f"({g[1] / e[1]:.2f}x); streams equal {same}/{len(reqs)}")
    gr, gs = results["ragged"][0], results["speculative"][0]
    say(f"phase16 speculative against plain ragged, both with graphs: "
        f"{gs[1]:.1f} against {gr[1]:.1f} tokens/s ({gs[1] / gr[1]:.2f}x)")

    # per-request sampling: the same seed draws the same tokens both ways
    eos = results["ragged"][0][0][1][1]
    kinds = mixed_sampling(eos)
    for name, make, reqs in (
            ("ragged", ragged, rreqs[:8]),
            ("bucketed paged", paged, [breqs[i] for i in (0, 1, 2, 4, 5, 6)])):
        out = []
        for mode in ("graphs", "eager"):
            ctx = disable_graphs() if mode == "eager" else \
                contextlib.nullcontext()
            with ctx:
                eng = make(per_request_sampling=True,
                           generator=torch.Generator("cuda").manual_seed(16))
                warm(eng)
                rids = [eng.add_request(p, n, **kinds[i % 3])
                        for i, (p, n) in enumerate(reqs)]
                got = eng.run_to_completion(max_ticks=5000)
                out.append([got[r] for r in rids])
        check_windows(f"phase16 sampled {name}", out[0],
                      [n for _, n in reqs], kinds, eos)
        check(out[0] == out[1], f"phase16 sampled {name}: graphs and eager "
                                f"drew different tokens")
        say(f"phase16 per-request sampled serve through the {name} engine "
            f"({len(reqs)} requests, greedy/penalised/sampled, one seed): "
            f"graphs and eager drew identical tokens "
            f"({sum(len(s) for s in out[0])})")


# ------------------------------------------------------------ phase 17 --

GEN_B, GEN_P, GEN_N, GEN_K = 8, 128, 128, 4
GEN_TRACE_N = 32        # the traced call's new tokens (a shorter trace)
SAMPLED = dict(greedy=False, temperature=0.8, top_k=50, top_p=0.95)


def ttft_serve(eng, prompt, n):
    """Serve ``prompt`` alone through ``eng``; returns (ms to its first
    token, its stream)."""
    first = []
    rid = eng.add_request(
        prompt, n, on_token=lambda r, t, d:
        first.append(time.perf_counter()) if not first else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while eng.pending():
        eng.step()
    return (first[0] - t0) * 1e3, eng.pop_finished()[rid]


def truncated_model(model, num_layers, compute_dtype=None):
    """A copy of ``model`` keeping its first ``num_layers`` layers (all of
    them when None is asked), in ``compute_dtype`` (its own by default)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTModel

    cfg = dict(vars(model.config), num_layers=num_layers)
    if compute_dtype is not None:
        cfg["compute_dtype"] = compute_dtype
    out = GPTModel(GPTConfig(**cfg), device="meta").to_empty(
        device=model.wte.device)
    with torch.no_grad():
        for n, p in out.named_parameters():
            src = getattr(model, n)
            p.copy_(src[:num_layers] if n.startswith("blocks_") else src)
    return out


def say_gen_pools(model, what, card):
    """Print the graph-pool memory of every generation signature memoised
    on ``model``: the bytes of the segments of each run's prefill and
    step graph pools in ``torch.cuda.memory_snapshot()`` (the prefill
    pool holds the run's caches and outputs, the step pool its
    intermediates)."""
    torch.cuda.synchronize()
    sizes = {}
    for s in torch.cuda.memory_snapshot():
        pid = tuple(s.get("segment_pool_id", ()))
        sizes[pid] = sizes.get(pid, 0) + s["total_size"]
    for key, run in model._gen_programs.items():
        mib = [sizes.get(tuple(p.graph.pool()), 0) / 2**20
               if p.graph is not None else 0.0
               for p in (run.prefill, run.step)]
        say(f"phase17 {what} graph pools on {card}: signature {key}: "
            f"prefill {mib[0]:.1f} MiB, step {mib[1]:.1f} MiB")


def phase17_generate(model, card):
    """(a) batched ``generate()``: greedy and sampled, with graphs and
    eager; (d) the saved artifact.  Returns the greedy tokens."""
    import contextlib
    import tempfile

    from paddle_tpu_torch.jit.programs import disable_graphs
    from paddle_tpu_torch.models._decode import (load_generate_program,
                                                 save_generate_program)
    from paddle_tpu_torch.ops import attention as A

    L, V = model.config.num_layers, model.config.vocab_size
    ids = np.random.RandomState(17).randint(1, V, (GEN_B, GEN_P))

    def timed(**kw):
        gen = (None if kw.get("greedy", True) else
               torch.Generator("cuda").manual_seed(170))
        torch.cuda.synchronize()
        f0 = A.flash_fwd_cuda.launches
        t0 = time.perf_counter()
        out = model.generate(ids, GEN_N, generator=gen, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, A.flash_fwd_cuda.launches - f0

    outs = {}
    for kind, kw in (("greedy", {}), ("sampled", SAMPLED)):
        for mode in ("graphs", "eager"):
            ctx = (disable_graphs() if mode == "eager"
                   else contextlib.nullcontext())
            with ctx:
                first, wall0, _ = timed(**kw)       # builds the programs
                progs = dict(model._gen_programs)
                out, wall, b2 = timed(**kw)
            check(model._gen_programs.keys() == progs.keys() and all(
                model._gen_programs[k] is v for k, v in progs.items()),
                f"phase17 generate {kind} {mode}: a program was rebuilt")
            check(torch.equal(first, out), f"phase17 generate {kind} "
                                           f"{mode}: two runs differ")
            check(out.shape == (GEN_B, GEN_N)
                  and int(out.min()) >= 0 and int(out.max()) < V,
                  f"phase17 generate {kind} {mode}: bad tokens")
            check(b2 == L, f"phase17 generate {kind} {mode}: flash_fwd "
                           f"launched {b2} times, not {L}")
            outs[kind, mode] = out
            say(f"phase17 generate() {kind} with {mode} (B {GEN_B}, P "
                f"{GEN_P}, {GEN_N} new tokens) on {card}: "
                f"{1e3 * wall / GEN_N:.3f} ms/token, "
                f"{GEN_B * GEN_N / wall:.1f} tokens/s, wall {wall:.3f} s "
                f"(first call {wall0:.3f} s), flash_fwd launches {b2}")
    for kind in ("greedy", "sampled"):
        check(torch.equal(outs[kind, "graphs"], outs[kind, "eager"]),
              f"phase17 generate {kind}: graphs and eager differ")
    check(not torch.equal(outs["greedy", "graphs"],
                          outs["sampled", "graphs"]),
          "phase17 generate: sampling drew the greedy tokens")
    # one new token: no step runs, so none is built
    one = model.generate(ids, 1)
    with disable_graphs():
        one_e = model.generate(ids, 1)
    check(torch.equal(one, one_e)
          and torch.equal(one, outs["greedy", "graphs"][:, :1]),
          "phase17 generate: one new token differs from eager")
    say("phase17 generate() with one new token: graphs equal eager and "
        "the first column of the 128-token run")
    say_gen_pools(model, "generate()", card)
    say(f"phase17 generate() greedy with graphs, one call traced (a step "
        f"is a token of all {GEN_B} rows; the prefill included):")
    model.generate(ids, GEN_TRACE_N)          # its programs, untraced
    prof = start_profile(cpu=False)
    model.generate(ids, GEN_TRACE_N)
    report_profile(prof, GEN_TRACE_N)

    f0 = A.flash_fwd_cuda.launches
    with tempfile.TemporaryDirectory() as d:
        save_generate_program(model, f"{d}/gpt2s", GEN_P, GEN_N,
                              batch_size=GEN_B)
        fn, meta = load_generate_program(f"{d}/gpt2s", device="cuda")
        save_generate_program(model, f"{d}/gpt2s1", GEN_P, 1,
                              batch_size=GEN_B)
        fn1, _ = load_generate_program(f"{d}/gpt2s1", device="cuda")
    loaded = fn(ids)
    loaded2 = fn(ids)
    check(torch.equal(loaded, outs["greedy", "graphs"])
          and torch.equal(loaded2, loaded),
          "phase17 loaded artifact: tokens differ from generate()")
    check(torch.equal(fn1(ids), one),
          "phase17 loaded one-token artifact: tokens differ from generate()")
    say(f"phase17 save_generate_program -> load_generate_program "
        f"({sorted(meta)}): the loaded function's tokens equal generate()'s "
        f"(2 calls, and one call of a one-token artifact; flash_fwd "
        f"launches {A.flash_fwd_cuda.launches - f0})")
    return outs["greedy", "graphs"]


def phase17_beam(model, card):
    """(b) ``generate_beam``: 4 beams with an EOS, graphs against eager; 1
    beam against greedy ``generate()``."""
    import contextlib

    from paddle_tpu_torch.jit.programs import disable_graphs

    V = model.config.vocab_size
    ids = np.random.RandomState(18).randint(1, V, (2, 64))
    free, _ = model.generate_beam(ids, 64, num_beams=4)
    eos = int(free[0, 1])                   # a token the best beam reaches
    res = {}
    for mode in ("graphs", "eager"):
        ctx = (disable_graphs() if mode == "eager"
               else contextlib.nullcontext())
        with ctx:
            model.generate_beam(ids, 64, num_beams=4, eos_token_id=eos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            seq, score = model.generate_beam(ids, 64, num_beams=4,
                                             eos_token_id=eos)
            torch.cuda.synchronize()
            res[mode] = (seq, score, time.perf_counter() - t0)
    (sg, cg, wg), (se, ce, we) = res["graphs"], res["eager"]
    check(torch.equal(sg, se), "phase17 beam: graphs and eager sequences "
                               "differ")
    gap = float((cg - ce).abs().max())
    check(gap <= 1e-4 and bool(torch.isfinite(cg).all()),
          f"phase17 beam: scores differ by {gap}")
    frozen = 0
    for row in sg.tolist():
        if eos in row:
            k = row.index(eos)
            check(all(t == eos for t in row[k:]),
                  "phase17 beam: a finished beam emitted past its EOS")
            frozen += 1
    say_gen_pools(model, "generate_beam", card)
    one, _ = model.generate_beam(ids, 64, num_beams=1)
    check(torch.equal(one, model.generate(ids, 64)),
          "phase17 beam: num_beams=1 differs from greedy generate()")
    # one new token: no step runs, so none is built
    s1, c1 = model.generate_beam(ids, 1, num_beams=4, eos_token_id=eos)
    with disable_graphs():
        s1e, c1e = model.generate_beam(ids, 1, num_beams=4,
                                       eos_token_id=eos)
    check(torch.equal(s1, s1e) and torch.equal(s1, one[:, :1])
          and float((c1 - c1e).abs().max()) <= 1e-4,
          "phase17 beam: one new token differs from eager")
    say(f"phase17 generate_beam (B 2, P 64, 64 new tokens, 4 beams, EOS "
        f"{eos}) on {card}: graphs {1e3 * wg:.1f} ms, eager "
        f"{1e3 * we:.1f} ms, sequences equal, scores {cg.tolist()} within "
        f"{gap:.2e}; {frozen} best beams end at the EOS; 1 beam equals "
        f"greedy generate(); one new token equals eager")


def phase17_speculative(model, card):
    """(c) ``generate_speculative``: a self-draft and a 2-layer draft,
    greedy, against greedy ``generate()``; the self-draft's exact round
    count in fp32; one sampled run."""
    V = model.config.vocab_size
    B, P, N, K = 4, GEN_P, GEN_N, GEN_K
    ids = np.random.RandomState(19).randint(1, V, (B, P))
    minimal = -(-(N - 1) // (K + 1))

    def timed(fn):
        fn()                                       # builds the programs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    want, wall = timed(lambda: model.generate(ids, N))
    base = B * N / wall
    draft2 = truncated_model(model, 2)
    for name, draft in (("self-draft", model), ("2-layer draft", draft2)):
        (toks, rounds), w = timed(lambda: model.generate_speculative(
            ids, N, draft, draft_k=K, return_rounds=True))
        rounds = int(rounds)
        same = sum(same_or_tie(f"phase17 speculative {name} row {r}",
                               toks[r].tolist(), want[r].tolist(),
                               ids[r].tolist(), [P], model)
                   for r in range(B))
        check(minimal <= rounds <= N - 1,
              f"phase17 speculative {name}: {rounds} rounds")
        # the slowest row advanced in every round: (N - 1) tokens over its
        # rounds, one of each round's advance the target's own
        rate = (N - 1 - rounds) / (K * rounds)
        if name == "2-layer draft":
            say_gen_pools(model, "generate_speculative", card)
        say(f"phase17 generate_speculative greedy, {name} (B {B}, P {P}, "
            f"{N} new tokens, K {K}) on {card}: {rounds} rounds (fewest "
            f"{minimal}), acceptance {rate:.3f} (slowest row), "
            f"{B * N / w:.1f} tokens/s against generate()'s {base:.1f} "
            f"({B * N / w / base:.2f}x); streams equal to generate() "
            f"{same}/{B}")
    # every proposal of a self-draft is accepted where the arithmetic
    # agrees bit for bit across the draft's steps and the verify chunk:
    # in fp32, where a top-2 gap under the rounding is all but absent
    m32 = truncated_model(model, model.config.num_layers, "float32")
    want32 = m32.generate(ids, N)
    toks32, r32 = m32.generate_speculative(ids, N, m32, draft_k=K,
                                           return_rounds=True)
    check(torch.equal(toks32, want32) and int(r32) == minimal,
          f"phase17 speculative fp32 self-draft: {int(r32)} rounds (want "
          f"{minimal}), tokens equal {torch.equal(toks32, want32)}")
    say(f"phase17 generate_speculative fp32 self-draft: {int(r32)} rounds "
        f"= ceil(({N} - 1) / ({K} + 1)), tokens equal generate()'s")
    del m32
    gen = torch.Generator("cuda").manual_seed(171)
    (toks, rounds) = model.generate_speculative(
        ids, N, draft2, draft_k=K, generator=gen, return_rounds=True,
        **SAMPLED)
    rounds = int(rounds)
    check(1 <= rounds <= N - 1 and toks.shape == (B, N)
          and int(toks.min()) >= 0 and int(toks.max()) < V,
          f"phase17 speculative sampled: {rounds} rounds")
    say(f"phase17 generate_speculative sampled (t 0.8, top_k 50, top_p "
        f"0.95, 2-layer draft): {rounds} rounds")


def phase17_store(model, card):
    """(e) the tiered store at ``bench_gpt_kv_tier``'s settings through the
    ragged and the bucketed paged engine: cold, DRAM restores and disk
    restores.  Returns (ragged, paged decode) launches."""
    import tempfile

    from paddle_tpu_torch.kv_store import KVPage, TieredKVStore
    from paddle_tpu_torch.models._decode import cache_leaves
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)

    L = model.config.num_layers
    buckets, n_new, reps = [64, 256], 16, 5
    prompt = [int(t) for t in np.random.RandomState(0).randint(
        1, model.config.vocab_size, 240)]
    oracle = model.generate([prompt], n_new)[0].tolist()
    settings = dict(max_slots=4, max_len=512, block_size=16,
                    prompt_buckets=buckets, device="cuda")
    # a page: k and v of one 16-position block in every layer
    page = 2 * L * 16 * model.config.hidden_size * model.compute_dtype.itemsize
    launched = [0, 0]
    tmp = tempfile.TemporaryDirectory()

    def make(kind, store):
        cache = store is not None
        if kind == "ragged":
            eng = RaggedPagedContinuousBatchingEngine(
                model, token_budget=64, enable_prefix_cache=cache,
                kv_store=store, **settings)
        else:
            eng = PagedContinuousBatchingEngine(
                model, enable_prefix_cache=cache, kv_store=store, **settings)
        check(("kvio" in eng.compile_grid()) == cache,
              f"phase17 {kind}: kvio in the grid is not {cache}")
        warm(eng)
        return eng

    for kind in ("ragged", "bucketed paged"):
        ttft = {}
        for tier in ("cold", "dram", "disk"):
            label = f"phase17 {kind} {tier}"
            store = (None if tier == "cold" else TieredKVStore()
                     if tier == "dram" else TieredKVStore(
                         dram_capacity_bytes=page // 2,
                         disk_dir=f"{tmp.name}/{kind[0]}"))
            eng = make(kind, store)
            if store is not None:
                ttft_serve(eng, prompt, n_new)     # publishes the blocks
                eng.flush_prefix()
                ttft_serve(eng, prompt, n_new)     # a first restore
            misses = eng._compile_misses
            m0 = eng.metrics()
            steps0 = (eng.ragged_steps if kind == "ragged"
                      else eng.decode_syncs * eng.ticks_per_sync)
            r0 = rpa.ragged_attention_cuda.launches
            p0 = pa.paged_decode_attention_cuda.launches
            runs = []
            for _ in range(reps):
                if store is not None:
                    check(eng.flush_prefix() == 16,
                          f"{label}: flush_prefix did not demote 16 blocks")
                    snap = store.snapshot()
                    check((snap["dram"]["pages"], snap["disk"]["pages"])
                          == ((16, 0) if tier == "dram" else (0, 16)),
                          f"{label}: tiers hold {snap}")
                runs.append(ttft_serve(eng, prompt, n_new))
            m = eng.metrics()
            check(eng._compile_misses == misses,
                  f"{label}: {eng._compile_misses - misses} programs built "
                  f"while serving")
            same = sum(same_or_tie(f"{label} repeat {i} vs generate()", s,
                                   oracle, prompt, buckets, model)
                       for i, (_, s) in enumerate(runs))
            check(m["blocks_allocated"] == m["blocks_released"],
                  f"{label}: allocated {m['blocks_allocated']} != released "
                  f"{m['blocks_released']}")
            if store is not None:
                restored = (m["kvstore_restored_blocks"]
                            - m0["kvstore_restored_blocks"])
                demoted = (m["kvstore_demoted_blocks"]
                           - m0["kvstore_demoted_blocks"])
                check(restored == 15 * reps and demoted == 16 * reps
                      and m["prefix_hits"] - m0["prefix_hits"] == reps,
                      f"{label}: restored {restored}, demoted {demoted}")
            if kind == "ragged":
                steps = eng.ragged_steps - steps0
                got = rpa.ragged_attention_cuda.launches - r0
                launched[0] += got
            else:
                steps = eng.decode_syncs * eng.ticks_per_sync - steps0
                got = pa.paged_decode_attention_cuda.launches - p0
                launched[1] += got
            check(got == L * steps > 0, f"{label}: kernel launches {got} != "
                                        f"{L} x {steps}")
            if tier == "dram":
                chain, bid = next(iter(eng._prefix_cache.items()))
                got_page = eng._page(chain, bid)
                back = KVPage.from_bytes(got_page.to_bytes())
                dev = [leaf[:, bid].contiguous().view(torch.uint8).cpu()
                       .numpy().tobytes()
                       for leaf in cache_leaves(eng.caches)]
                check(back.meta == got_page.meta and back.nbytes == page
                      and back.dtypes == ("bfloat16",) * 2
                      and [a.tobytes() for a in back.payload] == dev,
                      f"{label}: a page did not round-trip bit for bit")
            ttft[tier] = [t for t, _ in runs]
            say(f"{label}: TTFT {[round(t, 3) for t in ttft[tier]]} ms, "
                f"streams equal to generate() {same}/{reps}, kernel "
                f"launches {got} = {L} x {steps}")
            del eng
        say(f"phase17 {kind} engine, tiered store ({len(prompt)}-token "
            f"prompt, bucket 256, block 16, 16 new tokens, {reps} repeats, "
            f"a restore of 15 pages of {page} bytes) on {card}: TTFT "
            f"p50 cold {float(np.median(ttft['cold'])):.3f} ms, DRAM "
            f"restore {float(np.median(ttft['dram'])):.3f} ms, disk restore "
            f"{float(np.median(ttft['disk'])):.3f} ms; compile misses flat")
    tmp.cleanup()
    return launched


def phase17(card):
    """GPT generation and the tiered KV page store at gpt2-small width
    (vocab 50304, 12 layers, bf16, weights from seed 0).  Returns the
    launches of the ragged kernel and the paged decode kernel in the
    store's timed serves (over restored blocks, and the cold arms') and of
    ``flash_fwd`` in generation's prefills."""
    from paddle_tpu_torch.ops import attention as A

    t0 = time.perf_counter()
    model = full_width_model()
    reset_launches()
    phase17_generate(model, card)
    phase17_beam(model, card)
    phase17_speculative(model, card)
    flash = A.flash_fwd_cuda.launches     # generation's prefills
    ragged, paged = phase17_store(model, card)   # over restored blocks
    say(f"phase17 took {time.perf_counter() - t0:.1f} s; launches ragged "
        f"{ragged}, paged decode {paged}, flash_fwd {flash}")
    return ragged, paged, flash


# ------------------------------------------------------------ phase 18 --

def arrivals_serve(eng, reqs, t_add, t_first):
    """Phase 3's load on a warmed engine: 2 arrivals a step, each
    request's host clock taken at ``add_request`` (``t_add[rid]``) and at
    the ``on_token`` of its first token (``t_first[rid]``).  Returns (wall
    s, {rid: tokens}, ragged steps)."""
    def on_token(rid, tok, done):
        if tok is not None and rid not in t_first:
            t_first[rid] = time.monotonic()

    steps0, added = eng.ragged_steps, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while added < len(reqs) or eng.pending():
        for _ in range(2):
            if added < len(reqs):
                p, n = reqs[added]
                t = time.monotonic()
                t_add[eng.add_request(p, n, on_token=on_token)] = t
                added += 1
        eng.step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0, eng.pop_finished(),
            eng.ragged_steps - steps0)


def phase18_ragged(model, card):
    """(a) phase 3's ragged serve with graphs, untraced and traced (serves
    in the order untraced, traced, traced, untraced); (c) a memory ledger
    attached to the traced engine.  Returns the ragged kernel's
    launches."""
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving_paged import \
        RaggedPagedContinuousBatchingEngine
    from paddle_tpu_torch.telemetry import Tracer
    from paddle_tpu_torch.telemetry_ledger import RunLedger
    from paddle_tpu_torch.telemetry_memory import (MemoryLedger,
                                                   device_allocator_stats)

    L = model.config.num_layers
    reqs = serving_traffic(model.config.vocab_size)
    kw = dict(max_slots=8, max_len=512, block_size=16,
              prompt_buckets=[64, 128], token_budget=256, device="cuda")
    tr = Tracer(capacity=1 << 15)
    engs = {"untraced": RaggedPagedContinuousBatchingEngine(model, **kw),
            "traced": RaggedPagedContinuousBatchingEngine(model, tracer=tr,
                                                          **kw)}
    for eng in engs.values():
        warm(eng)
    led = engs["traced"].attach_ledger(RunLedger())
    comp = tr.events("compile")
    check(comp and all(e["expected"] and not e["hit"] for e in comp),
          f"phase18: warmup compile events {comp} not all expected misses")
    misses = {k: e.metrics()["compile_misses"] for k, e in engs.items()}
    walls = {k: [] for k in engs}
    clocks = {k: ({}, {}) for k in engs}        # rid -> host add, first
    streams, launches, goodput = {}, 0, []
    for arm in ("untraced", "traced", "traced", "untraced"):
        eng = engs[arm]
        rpa.ragged_attention_cuda.launches = 0
        # the ledger sees the traced engine only: it covers each traced
        # serve alone, from just before to just after it
        led.reset()
        n_ticks = len(tr.events("tick"))
        wall, got, steps = arrivals_serve(eng, reqs, *clocks[arm])
        if arm == "traced":
            snap = led.snapshot()
            tick_s = sum(e["dur_s"] for e in tr.events("tick")[n_ticks:])
            check(abs(snap["buckets_s"]["compute"] - tick_s) < 1e-6,
                  f"phase18: ledger compute {snap['buckets_s']['compute']} "
                  f"!= the serve's tick walls {tick_s}")
            goodput.append((snap["goodput"], snap["elapsed_s"], tick_s, wall))
        n = rpa.ragged_attention_cuda.launches
        check(n == L * steps > 0, f"phase18 {arm}: ragged launches {n} != "
                                  f"{L} x {steps} steps")
        launches += n
        check(sorted(len(v) for v in got.values())
              == sorted(b for _, b in reqs), f"phase18 {arm}: budgets")
        s = [got[r] for r in sorted(got)]
        check(streams.setdefault(arm, s) == s,
              f"phase18 {arm}: two serves of one engine differ")
        walls[arm].append((wall, steps))
    check(streams["traced"] == streams["untraced"],
          "phase18: traced and untraced token streams differ")
    for k, e in engs.items():
        check(e.metrics()["compile_misses"] == misses[k],
              f"phase18 {k}: a program was built while serving")
    check(len(tr.events("compile")) == len(comp),
          "phase18: a compile event while serving")
    # TTFT: the tracer's interval lies inside the host's add_request ->
    # first on_token interval of the same request
    t_add, t_first = clocks["traced"]
    tls = {tl.rid: tl for tl in tr.timelines()}
    check(len(tls) == 2 * len(reqs) and all(
        tl.retired_at is not None for tl in tls.values()),
        "phase18: traced requests missing from the tracer")
    worst = 0.0
    for rid, tl in tls.items():
        q, f = tr.t0 + tl.queued_at, tr.t0 + tl.first_token_at
        check(t_add[rid] <= q and f <= t_first[rid],
              f"phase18: request {rid}'s tracer TTFT [{q}, {f}] is not "
              f"inside its host interval [{t_add[rid]}, {t_first[rid]}]")
        worst = max(worst, (t_first[rid] - t_add[rid]) - tl.ttft_s)
    rs = tr.request_summary()
    ttft, itl = rs["ttft_s"], rs["inter_token_s"]
    ms = {k: 1e3 * sum(w for w, _ in v) / sum(s for _, s in v)
          for k, v in walls.items()}
    say(f"phase18 ragged serve at phase 3's load (2 arrivals a step, "
        f"graphs) on {card}: TTFT p50 {1e3 * ttft['p50']:.3f} ms p99 "
        f"{1e3 * ttft['p99']:.3f} ms, ITL p50 {1e3 * itl['p50']:.3f} ms "
        f"p99 {1e3 * itl['p99']:.3f} ms over {ttft['count']} requests "
        f"(tracer TTFT at most {1e3 * worst:.3f} ms under the host's); "
        f"traced {ms['traced']:.3f} ms/step against untraced "
        f"{ms['untraced']:.3f} ms/step ({ms['traced'] / ms['untraced']:.3f}"
        f"x, 2 serves each, order U T T U); streams equal 24/24; "
        f"{len(comp)} expected compile events, none while serving; "
        f"serving goodput of each traced serve (a RunLedger reset just "
        f"before it): " + ", ".join(
            f"{g:.3f} of {e:.3f} s (tick walls {t:.3f} s, the serve's wall "
            f"{w:.3f} s)" for g, e, t, w in goodput))
    # (c) the memory ledger on the traced engine
    eng = engs["traced"]
    ml = MemoryLedger()
    eng.attach_memory(ml)
    gc.collect()
    t0 = time.perf_counter()
    c = ml.census()
    census_s = time.perf_counter() - t0
    pools = c["pools"]
    kv = sum(t.numel() * t.element_size() for t in eng.caches)
    params = sum(p.numel() * p.element_size() for p in model.parameters())
    check(pools["kv_pages"] == kv, f"phase18: census kv_pages "
                                   f"{pools['kv_pages']} != pools {kv}")
    check(pools["params"] == params, f"phase18: census params "
                                     f"{pools['params']} != {params}")
    alloc = device_allocator_stats()
    check(bool(alloc) and alloc["bytes_in_use"] > 0,
          f"phase18: device_allocator_stats() {alloc}")
    m = eng.metrics()
    check(m["memory_device_bytes"] == float(c["total_bytes"]),
          "phase18: metrics() memory_device_bytes")
    say(f"phase18 memory census of the ragged engine ({census_s:.3f} s, "
        f"{c['arrays']} storages on cuda): params {pools['params']} B, "
        f"kv_pages {pools['kv_pages']} B, other {pools['other']} B, total "
        f"{c['total_bytes']} B; torch.cuda.memory_allocated() "
        f"{c['allocated_bytes']} B; allocator bytes_in_use "
        f"{alloc['bytes_in_use']} B, peak {alloc['peak_bytes_in_use']} B, "
        f"reserved {alloc['bytes_reserved']} B")
    return launches


def phase18_bucketed(model, reqs, paged, card):
    """(b) phase 12's bucketed paged serve, traced.  Returns the paged
    decode kernel's and ``flash_fwd``'s launches."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.telemetry import Tracer

    L, k = model.config.num_layers, SERVE_TICKS
    tr = Tracer(capacity=1 << 15)
    eng = paged(tracer=tr)
    wall, got, budgets = serve_upfront(eng, reqs)
    total = sum(len(v) for v in got.values())
    check(total == sum(budgets.values()) == 5760,
          f"phase18 bucketed: {total} tokens")
    ticks = tr.events("tick")
    rows = sum(e.get("decode_rows", 0) for e in ticks)
    check(rows * k == total, f"phase18 bucketed: tick decode_rows {rows} x "
                             f"ticks_per_sync {k} != {total} tokens")
    check(sum(e["tokens_emitted"] for e in ticks) == total,
          "phase18 bucketed: tick tokens_emitted deltas")
    check(sum(e.get("prefill_tokens", 0) for e in ticks)
          == SERVE_BUCKET * len(reqs), "phase18 bucketed: prefill tokens")
    check(not any(e.get("compiles") for e in ticks),
          "phase18 bucketed: a program was built while serving")
    syncs = eng.decode_syncs
    paged_n, flash_n = pa.paged_decode_attention_cuda.launches, \
        A.flash_fwd_cuda.launches
    check(paged_n == L * k * syncs and flash_n == L * len(reqs),
          f"phase18 bucketed: launches paged {paged_n} (not {L} x {k} x "
          f"{syncs} syncs) flash_fwd {flash_n}")
    rs = tr.request_summary()
    say(f"phase18 bucketed paged serve traced (phase 12's settings) on "
        f"{card}: {total} tokens in {wall:.3f} s, "
        f"{1e3 * wall / syncs:.3f} ms a sync over {syncs} syncs, "
        f"decode_rows {rows} x {k} = tokens emitted; TTFT p50 "
        f"{1e3 * rs['ttft_s']['p50']:.3f} ms p99 "
        f"{1e3 * rs['ttft_s']['p99']:.3f} ms (all 24 queued up front), ITL "
        f"p50 {1e3 * rs['inter_token_s']['p50']:.3f} ms p99 "
        f"{1e3 * rs['inter_token_s']['p99']:.3f} ms (a sync delivers 8 "
        f"tokens at once); launches paged {paged_n}, flash_fwd {flash_n}")
    return paged_n, flash_n


def phase18_train(card):
    """(d) phase 6's gpt2s step under a ``TrainMonitor`` and a
    ``RunLedger``: 4 steps, then one timed loss fetch recorded as the
    sync; then 2 more monitored steps under a host-side trace, whose CUDA
    runtime calls say where a step's dispatch waits.  Returns the three
    flash kernels' launches."""
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import TrainMonitor
    from paddle_tpu_torch.telemetry_ledger import RunLedger

    cfg = gpt_preset("gpt2-small", vocab_size=50304,
                     max_position_embeddings=1024, compute_dtype="bfloat16")
    Lyr, B, L = cfg.num_layers, 16, 1024
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    mon, led = TrainMonitor(), RunLedger()
    mon.set_ledger(led)
    step, state = make_gpt_train_step(model, AdamW(3e-4, weight_decay=0.01),
                                      remat=False, monitor=mon)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    kernels = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda)
    for k in kernels:
        k.launches = 0
    led.reset()
    losses = []
    for i in range(4):
        if i == 1:
            t0 = time.perf_counter()      # the steady-state window
        state, loss = step(state, i, 3e-4, x, y)
        losses.append(loss)
    ts = time.perf_counter()
    last = losses[-1].item()              # the log-cadence loss fetch
    mon.record_sync(time.perf_counter() - ts, loss=last)
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    check(launches == [Lyr * 4] * 3,
          f"phase18 train: flash launches {launches} != {Lyr} x 4")
    comp, samples = mon.events("compile"), mon.events("train_step")
    check(len(comp) == 1 and len(samples) == 3
          and all(e["tokens"] == B * L for e in samples),
          f"phase18 train: {len(comp)} compile events, {len(samples)} "
          f"samples")
    vals = [v.item() for v in losses]
    check(all(np.isfinite(vals)) and not mon.events("watchdog"),
          f"phase18 train: losses {vals}")
    s, snap = mon.summary(), led.snapshot()
    say(f"phase18 gpt2s train under a TrainMonitor and a RunLedger (B {B}, "
        f"L {L}, bf16) on {card}: compile event {comp[0]['wall_s']:.3f} s, "
        f"3 step samples (host dispatch p50 "
        f"{1e3 * s['step_wall_s']['p50']:.3f} ms), monitor "
        f"{s['tokens_per_sec']:.1f} tokens/s against the phase's wall clock "
        f"{3 * B * L / wall:.1f} tokens/s over the same 3 steps and the "
        f"loss fetch; goodput {snap['goodput']:.3f} (compute "
        f"{snap['buckets_s']['compute']:.3f} s, compile "
        f"{snap['buckets_s']['compile']:.3f} s, host_dispatch "
        f"{snap['buckets_s']['host_dispatch']:.3f} s of "
        f"{snap['elapsed_s']:.3f} s); losses {[round(v, 4) for v in vals]}")
    # where the dispatch waits: 2 more monitored steps traced on the host
    # (the first from a drained queue); the CUDA runtime calls' own host
    # time splits it between launches and copies or syncs
    prof = start_profile()
    for i in (4, 5):
        state, loss = step(state, i, 3e-4, x, y)
    report_profile(prof, 2)
    rt = sorted((e for e in prof.key_averages() if e.key.startswith("cu")),
                key=lambda e: -e.self_cpu_time_total)
    disp = [e["dur_s"] for e in mon.events("train_step")[-2:]]
    say(f"phase18 gpt2s host trace of 2 monitored steps: host dispatch "
        f"{1e3 * disp[0]:.3f} ms (from a drained queue) and "
        f"{1e3 * disp[1]:.3f} ms; CUDA runtime calls by host time over both "
        f"steps: " + "; ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms in {e.count}"
            for e in rt[:6]))
    launches = [k.launches for k in kernels]
    check(launches == [Lyr * 6] * 3,
          f"phase18 train: flash launches {launches} != {Lyr} x 6")
    return launches


def phase18(card):
    """Telemetry at full width (gpt2-small bf16, seed 0): the ragged and
    the bucketed paged serves traced, a memory census, and the gpt2s step
    monitored.  Returns the launches of the ragged kernel, the paged
    decode kernel and the three flash kernels."""
    t0 = time.perf_counter()
    model, reqs, _, paged_engine = bucketed_serve()   # phase 3's model too
    ragged = phase18_ragged(model, card)
    gc.collect()
    paged, flash_fwd = phase18_bucketed(model, reqs, paged_engine, card)
    del model, paged_engine
    gc.collect()
    flash = phase18_train(card)
    say(f"phase18 took {time.perf_counter() - t0:.1f} s")
    return ragged, paged, (flash[0] + flash_fwd, *flash[1:])


# ------------------------------------------------------------ phase 19 --

# bench.py bench_ernie_moe's accelerator config (bench.py:346-351)
ERNIE_BENCH = dict(vocab_size=30528, hidden_size=768, num_layers=6,
                   num_attention_heads=12, num_experts=8, top_k=2,
                   max_position_embeddings=512, compute_dtype="bfloat16")
# card vs CPU, fp32: the losses' relative difference; the parameters'
# largest absolute difference (5 AdamW steps move an element by ~1e-3, so
# the bound sits well under that); the largest difference of the
# parameters' change, relative to the change's norm
ERNIE_LOSS_TOL, ERNIE_PARAM_TOL, ERNIE_DELTA_TOL = 1e-4, 1e-5, 1e-2
# the depth of (1) and (4): 3 card-vs-CPU steps (5 before, cut for the
# script's time limit: the CPU's fp32 steps dominate (1)) and the first 8
# requests through the bucketed engine (12 before: each diverging stream
# costs two eager replays)
ERNIE_CPU_STEPS, ERNIE_BUCKETED_REQS = 3, 8
ROUTE_TIE = 1e-5       # fp32 gate probabilities this close may route apart

OPT_RTOL, OPT_ATOL = 1e-5, 1e-6   # eager optimizers, card vs CPU, fp32


def ernie_model(dev, generator_device=None, **over):
    """An ERNIE-MoE at ``bench_ernie_moe``'s width (``over`` cuts it) with
    weights from seed 0."""
    from paddle_tpu_torch.models.ernie_moe import (ErnieMoeConfig,
                                                   ErnieMoeModel)

    cfg = ErnieMoeConfig(**dict(ERNIE_BENCH, **over))
    gen = torch.Generator(generator_device or dev).manual_seed(0)
    return ErnieMoeModel(cfg, device=dev, generator=gen)


@contextlib.contextmanager
def recorded_routing():
    """Record (gate logits, expert indices) of every ``topk_gating_indices``
    call made inside the block."""
    from paddle_tpu_torch.ops import moe

    calls, inner = [], moe.topk_gating_indices

    def record(logits, *a, **kw):
        out = inner(logits, *a, **kw)
        calls.append((logits.detach().float().cpu(), out[0].cpu()))
        return out

    moe.topk_gating_indices = record
    try:
        yield calls
    finally:
        moe.topk_gating_indices = inner


def routing_flips(model_a, model_b, ids, k):
    """Tokens whose chosen experts differ between two models' forwards of
    ``ids`` (every layer), and the smallest gap between the k-th and the
    next gate probability of ``model_b``'s routing over all tokens."""
    runs = []
    for m in (model_a, model_b):
        with recorded_routing() as calls, torch.no_grad():
            m(ids.to(m.wte.device))
        runs.append(calls)
    flips, gap = 0, float("inf")
    for (_, ea), (lb, eb) in zip(*runs):
        flips += int((ea.sort(-1).values != eb.sort(-1).values).any(-1)
                     .sum())
        p = torch.softmax(lb, -1).sort(-1, descending=True).values
        gap = min(gap, float((p[:, k - 1] - p[:, k]).min()))
    return flips, gap


@contextlib.contextmanager
def routes_by_position():
    """For runs made inside the block with graphs off: the experts, the
    gate gap (the k-th chosen less the next gate logit) and the gate
    logits of every row that an ERNIE-MoE serving path routes, keyed by
    (logical position, layer).  A row's position comes from its call: a prefill row's index
    less its pad, a decode row's clock less its pad (active slots only),
    a ragged row's kv position less its sequence's pad; pad rows and an
    inactive slot's rows are skipped.  Yields (records, clashes): a key's
    first record, and the count of later records of a key that chose
    other experts."""
    from paddle_tpu_torch import serving as SV
    from paddle_tpu_torch.jit.programs import disable_graphs
    from paddle_tpu_torch.models import ernie_moe as EM

    M, rec, ctx, clashes = EM.ErnieMoeModel, {}, {"active": None}, [0]
    saved = [(o, n, o.__dict__.get(n), getattr(o, n)) for o, n in (
        (M, "prefill"), (M, "_block_decode"), (M, "_block_decode_ragged"),
        (M, "_block_post_attn"), (SV.ContinuousBatchingEngine,
                                  "_decode_tick"))]
    inner = {n: f for _, n, _, f in saved}
    gather = EM.moe_ffn_gather

    def prefill(self, input_ids, max_len, pad_lens=None):
        B, P = input_ids.shape
        pos = torch.arange(P, device=input_ids.device).expand(B, P)
        if pad_lens is not None:
            pos = pos - pad_lens.long().reshape(-1, 1)
        ctx["pos"] = pos.reshape(-1)
        return inner["prefill"](self, input_ids, max_len, pad_lens)

    def block_decode(self, l, h, ck, cv, t, pad_lens=None):
        B, k = h.shape[:2]
        t0 = torch.as_tensor(t, device=h.device).long().reshape(-1)
        pos = t0.expand(B)[:, None] + torch.arange(k, device=h.device)
        if pad_lens is not None:
            pos = pos - pad_lens.long().reshape(-1, 1)
        if ctx["active"] is not None:
            pos = torch.where(ctx["active"].reshape(-1, 1), pos, -1)
        ctx["pos"] = pos.reshape(-1)
        return inner["_block_decode"](self, l, h, ck, cv, t, pad_lens)

    def block_ragged(self, l, h, pck, pcv, table, row_seq, row_pos,
                     pad_lens, plan):
        pos = row_pos.long() - pad_lens.long()[row_seq.long()]
        ctx["pos"] = torch.where(row_pos >= 0, pos, -1)
        return inner["_block_decode_ragged"](self, l, h, pck, pcv, table,
                                             row_seq, row_pos, pad_lens, plan)

    def post_attn(self, l, h, att):
        ctx["layer"] = l
        return inner["_block_post_attn"](self, l, h, att)

    def decode_tick(self, caches, tok, t, pads, active, emitted):
        ctx["active"] = active
        try:
            return inner["_decode_tick"](self, caches, tok, t, pads, active,
                                         emitted)
        finally:
            ctx["active"] = None

    def record(x, gate_w, *w, k=2, **kw):
        logits = x.float() @ gate_w.float()
        e = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                       descending=True, stable=True).indices
        ranked = logits.gather(1, e[:, k - 1:k + 1])
        pos = ctx["pos"].cpu().numpy()
        gaps = (ranked[:, 0] - ranked[:, 1]).abs().cpu().numpy()
        experts = e[:, :k].sort(-1).values.cpu().numpy()
        logits = logits.cpu().numpy()
        for r in np.flatnonzero(pos >= 0):
            key = (int(pos[r]), ctx["layer"])
            got = tuple(int(v) for v in experts[r])
            if key in rec:
                clashes[0] += rec[key][0] != got
            else:
                rec[key] = (got, float(gaps[r]), logits[r])
        return gather(x, gate_w, *w, k=k, **kw)

    for (o, n, _, _), f in zip(saved, (prefill, block_decode, block_ragged,
                                       post_attn, decode_tick)):
        setattr(o, n, f)
    EM.moe_ffn_gather = record
    try:
        with disable_graphs():
            yield rec, clashes
    finally:
        EM.moe_ffn_gather = gather
        for o, n, own, _ in saved:
            if own is None:
                delattr(o, n)
            else:
                setattr(o, n, own)


class ErnieReplays:
    """One request served again alone, eagerly, with its routing recorded
    (``routes_by_position``), through the path a stream under test took:
    "ragged" (phase 3's engine settings), "bucketed" (phase 19's paged
    engine) or "generate".  Each (path, request) runs once; returns
    (stream, routes)."""

    def __init__(self, model, reqs):
        self.model, self.reqs, self.done = model, reqs, {}

    def __call__(self, path, i):
        from paddle_tpu_torch.serving_paged import (
            PagedContinuousBatchingEngine,
            RaggedPagedContinuousBatchingEngine)

        if (path, i) not in self.done:
            prompt, n = self.reqs[i]
            kw = dict(max_slots=8, max_len=512, block_size=16,
                      prompt_buckets=[64, 128], device="cuda")
            with routes_by_position() as (rec, clashes):
                if path == "generate":
                    stream = self.model.generate([prompt], n)[0].tolist()
                else:
                    eng = (RaggedPagedContinuousBatchingEngine(
                        self.model, token_budget=256, **kw)
                        if path == "ragged" else
                        PagedContinuousBatchingEngine(
                            self.model, ticks_per_sync=8, **kw))
                    rid = eng.add_request(prompt, n)
                    stream = eng.run_to_completion(max_ticks=5000)[rid]
            check(clashes[0] == 0, f"phase19 {path} replay of request {i}: "
                                   f"{clashes[0]} rows routed one position "
                                   f"and layer apart")
            self.done[path, i] = (stream, rec)
        return self.done[path, i]


def same_or_route_flip(label, got, want, i, paths, replays):
    """``got`` (request ``i``'s stream through ``paths[0]``) equals
    ``want`` (through ``paths[1]``), or first diverges at token j where
    the flip that explains it is found.  Both paths are replayed alone
    and eagerly with routing recorded (``ErnieReplays``); each replay
    must reproduce its stream through token j.  Over the shared context
    (the prompt and want[:j], every layer) the expert choices of the two
    replays are compared.  A root flip (one no earlier flip can have
    caused: none at a position <= its own in a lower layer) has only
    rounding behind it, so the router's choice there is held to the
    head's bf16 near-tie rule: its gate-logit gap (the k-th chosen less
    the next) under BF16_TIE on both paths.  The rounding itself is
    printed: the largest gate-logit difference of the rows no flip can
    reach.  With no flip, the divergence is held to the logit rule
    (top-2 gap under BF16_TIE).  Returns "equal", "flip" or "logit"."""
    n = min(len(got), len(want))
    j = next((t for t in range(n) if got[t] != want[t]), None)
    if j is None:
        check(len(got) == len(want), f"{label}: lengths {len(got)} vs "
                                     f"{len(want)} with no differing token")
        return "equal"
    prompt = replays.reqs[i][0]
    (sa, ra), (sb, rb) = replays(paths[0], i), replays(paths[1], i)
    for path, s, ref in ((paths[0], sa, got), (paths[1], sb, want)):
        check(s[:j + 1] == ref[:j + 1],
              f"{label}: the eager replay through {path} does not "
              f"reproduce the served stream through token {j}")
    L = replays.model.config.num_layers
    keys = [(p, l) for p in range(len(prompt) + j) for l in range(L)]
    missing = [key for key in keys if key not in ra or key not in rb]
    check(not missing, f"{label}: the replays routed no row at "
                       f"(position, layer) {missing[:4]}")
    flips = [key for key in keys if ra[key][0] != rb[key][0]]
    roots = [(p, l) for p, l in flips
             if not any(q <= p and m < l for q, m in flips)]
    if not roots:
        lgap = tie_gap(replays.model, prompt, [64, 128], want[:j])
        say(f"{label}: diverges at token {j}: {got[j]} vs {want[j]} with "
            f"no routing flip in the context, top-2 logit gap {lgap:.3e}")
        check(lgap < BF16_TIE, f"{label}: diverged with no routing flip "
                               f"where the top-2 gap is {lgap} (>= "
                               f"{BF16_TIE})")
        return "logit"
    gaps = [max(ra[key][1], rb[key][1]) for key in roots]
    noise = max((float(np.abs(ra[q, m][2] - rb[q, m][2]).max())
                 for q, m in keys
                 if not any(f <= q and n <= m for f, n in flips)),
                default=0.0)
    p, l = roots[0]
    say(f"{label}: diverges at token {j}: {got[j]} vs {want[j]}; "
        f"{len(flips)} routing flips in the context, {len(roots)} roots, "
        f"the first at position {p} layer {l} (experts {ra[p, l][0]} vs "
        f"{rb[p, l][0]}), largest root gate-logit gap {max(gaps):.3e}; "
        f"gate logits of the rows no flip reaches differ by up to "
        f"{noise:.3e}")
    check(max(gaps) < BF16_TIE,
          f"{label}: a root routing flip at gate-logit gap {max(gaps)} (>= "
          f"{BF16_TIE}): the two paths disagree beyond rounding")
    return "flip"


def ernie_train_losses(model, batches, dev):
    from paddle_tpu_torch.models.ernie_moe import make_ernie_moe_train_step
    from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer.lr import (CosineAnnealingDecay,
                                               LinearWarmup)

    sched = LinearWarmup(CosineAnnealingDecay(3e-4, T_max=5),
                         warmup_steps=2, start_lr=3e-5, end_lr=3e-4)
    opt = AdamW(sched, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    step, state = make_ernie_moe_train_step(model, opt, remat=False)
    losses = []
    for x, y in batches:
        state, loss = step(state, opt.get_lr(), torch.from_numpy(x).to(dev),
                           torch.from_numpy(y).to(dev))
        sched.step()
        losses.append(loss.item())
    return losses


def phase19_card_vs_cpu():
    """(1) ERNIE-MoE at hidden 768, 8 experts, top-2, expert hidden 3072,
    2 layers, fp32: 3 steps of AdamW under LinearWarmup(Cosine) with
    ClipGradByGlobalNorm(1.0) at B 2, L 256 from the same weights on the
    card and on the CPU."""
    from paddle_tpu_torch.models.ernie_moe import params_from_numpy

    cpu_model = ernie_model("cpu", num_layers=2, compute_dtype="float32")
    cfg = cpu_model.config
    state = {n: p.detach().numpy().copy()
             for n, p in cpu_model.named_parameters()}
    p0 = {n: torch.from_numpy(v) for n, v in state.items()}
    gpu_model = params_from_numpy(state, cfg, device="cuda")
    rng = np.random.RandomState(1)
    batches = [(rng.randint(0, cfg.vocab_size, (2, 256)),
                rng.randint(0, cfg.vocab_size, (2, 256)))
               for _ in range(ERNIE_CPU_STEPS)]
    first = torch.from_numpy(batches[0][0])
    flips0, gap0 = routing_flips(gpu_model, cpu_model, first, cfg.top_k)
    gl = ernie_train_losses(gpu_model, batches, "cuda")
    cl = ernie_train_losses(cpu_model, batches, "cpu")
    flips1, gap1 = routing_flips(gpu_model, cpu_model,
                                 torch.from_numpy(batches[-1][0]), cfg.top_k)
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    cpu_params = dict(cpu_model.named_parameters())
    perr = max((p.detach().cpu() - cpu_params[n].detach()).abs().max().item()
               for n, p in gpu_model.named_parameters())
    # the update itself: (p_card - p0) against (p_cpu - p0), per tensor
    # relative to the CPU change's largest element (all of them moved)
    moved = {n: cpu_params[n].detach() - p0[n] for n in p0}
    check(all(d.abs().max().item() > 0 for d in moved.values()),
          "phase19: a parameter did not move on the CPU")
    derr = max(((p.detach().cpu() - p0[n]) - moved[n]).abs().max().item()
               / moved[n].abs().max().item()
               for n, p in gpu_model.named_parameters())
    say(f"phase19 card vs CPU ERNIE-MoE train (hidden 768, 8 experts, "
        f"top-2, 2 layers, fp32, B 2, L 256, {ERNIE_CPU_STEPS} steps of "
        f"AdamW under "
        f"LinearWarmup(CosineAnnealingDecay) with ClipGradByGlobalNorm(1.0)):"
        f" losses cuda {[round(x, 6) for x in gl]} cpu "
        f"{[round(x, 6) for x in cl]}, max rel diff {rel:.3e} (tol "
        f"{ERNIE_LOSS_TOL}), final params max abs diff {perr:.3e} (tol "
        f"{ERNIE_PARAM_TOL}), the update's max diff {derr:.3e} of its "
        f"largest element (tol {ERNIE_DELTA_TOL}); routing flips {flips0} "
        f"before training "
        f"(smallest k-th/next gate gap {gap0:.3e}) and {flips1} after "
        f"(gap {gap1:.3e}) of {2 * 256 * cfg.num_layers} token-layers each")
    check(all(np.isfinite(gl)), "phase19: non-finite card loss")
    check(rel <= ERNIE_LOSS_TOL, f"phase19: losses differ by {rel}")
    check(perr <= ERNIE_PARAM_TOL, f"phase19: parameters differ by {perr}")
    check(derr <= ERNIE_DELTA_TOL, f"phase19: the updates differ by {derr} "
                                   f"of their largest element")
    for flips, gap in ((flips0, gap0), (flips1, gap1)):
        check(flips == 0 or gap < ROUTE_TIE,
              f"phase19: {flips} routing flips with the smallest gate gap "
              f"{gap} (>= {ROUTE_TIE})")


def phase19_train(card):
    """(2) the full-width train at ``bench_ernie_moe``'s config: B 8, L
    512, AdamW(1e-4, wd 0.01), remat off; 3 warm-up steps, 3 profiled, 10
    timed.  Returns the three flash kernels' launches in the timed 10."""
    from paddle_tpu_torch.models.ernie_moe import make_ernie_moe_train_step
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.optimizer import AdamW

    model = ernie_model("cuda")
    cfg = model.config
    Lyr, B, L = cfg.num_layers, 8, 512
    n_params = sum(p.numel() for p in model.parameters())
    step, state = make_ernie_moe_train_step(
        model, AdamW(1e-4, weight_decay=0.01), remat=False)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    losses = []

    def run(n):
        nonlocal state
        for _ in range(n):
            state, loss = step(state, 1e-4, x, y)
            losses.append(loss)

    run(3)
    prof = start_profile()
    run(3)
    report_profile(prof, 3)
    prof_last = dict(report_profile.last)
    kernels = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    run(10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    vals = [v.item() for v in losses]
    check(all(np.isfinite(vals)), f"phase19 train: non-finite loss {vals}")
    check(vals[-1] < vals[0], f"phase19 train: loss did not fall: {vals}")
    check(launches == [Lyr * 10] * 3,
          f"phase19 train: flash launches {launches} != {Lyr} x 10 each")
    say(f"phase19 ERNIE-MoE train at bench_ernie_moe's config ({n_params} "
        f"parameters: vocab 30528, hidden 768, 6 layers, 12 heads, 8 "
        f"experts, top-2, expert hidden 3072, bf16, B {B}, L {L}, remat "
        f"off, AdamW(1e-4, wd 0.01)) on {card}: losses "
        f"{[round(v, 4) for v in vals]}; {1e3 * wall / 10:.3f} ms/step, "
        f"{B * L * 10 / wall:.1f} tokens/s over 10 steps, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, profiled "
        f"device busy {prof_last['busy_ms']:.3f} ms/step "
        f"({100 * prof_last['busy_share']:.1f}%), flash launches "
        f"fwd/dq/dkv {launches} = {Lyr} x 10")
    return launches


def phase19_ragged(model, reqs, card):
    """(3) phase 3's traffic at the ERNIE width (``serve``: 8 slots,
    max_len 512, block 16, budget 256, buckets [64, 128], 2 arrivals a
    step, bf16, graphs), plain and with a 1-layer GPT draft at K 2.
    Returns (the plain streams, B1 launches, B5 launches)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTModel
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    c = model.config
    Lyr = c.num_layers
    serve(model, reqs[:8])                                  # warm-up
    eng, wall, got, budgets = serve(model, reqs)
    _, pool_bytes, grown = serve.last_warm
    b1 = check_serve("phase19 ragged", eng, got, budgets, Lyr)
    streams = [got[r] for r in sorted(got)]
    tokens = sum(len(v) for v in got.values())
    say(f"phase19 ERNIE-MoE ragged serve (phase 3's traffic, 24 requests, "
        f"{tokens} tokens, bf16, graphs) on {card}: {eng.ragged_steps} "
        f"ragged steps, {tokens / wall:.1f} tokens/s, "
        f"{1e3 * wall / eng.ragged_steps:.3f} ms/step, graph pool "
        f"{pool_bytes / 2**20:.1f} MiB (reserved memory grew "
        f"{grown / 2**20:.1f} MiB over the warmup), B1 launches {b1} = "
        f"{Lyr} x {eng.ragged_steps}")
    replays = ErnieReplays(model, reqs)
    kinds = [same_or_route_flip(
        f"phase19 request {i} vs generate()", streams[i],
        model.generate([reqs[i][0]], reqs[i][1])[0].tolist(), i,
        ("ragged", "generate"), replays) for i in range(4)]
    draft = GPTModel(GPTConfig(vocab_size=c.vocab_size, hidden_size=768,
                               num_layers=1, num_attention_heads=12,
                               max_position_embeddings=512,
                               compute_dtype="bfloat16"),
                     device="cuda",
                     generator=torch.Generator("cuda").manual_seed(1))
    serve(model, reqs[:8], draft_model=draft, draft_k=2)    # warm-up
    seng, swall, sgot, sbudgets = serve(model, reqs, draft_model=draft,
                                        draft_k=2)
    _, spool, _ = serve.last_warm
    sb1 = rpa.ragged_attention_cuda.launches
    sb5 = pa.paged_decode_attention_cuda.launches
    check(sorted(sgot) == sorted(sbudgets)
          and all(len(sgot[r]) == n for r, n in sbudgets.items()),
          "phase19 spec: budgets not held")
    check(seng.blocks_in_use == 0, "phase19 spec: blocks still in use")
    check(sb1 == (Lyr + 1) * seng.ragged_steps > 0,
          f"phase19 spec: B1 launches {sb1} != ({Lyr} + 1) x "
          f"{seng.ragged_steps}")
    check(sb5 == 2 * 1 * seng.ragged_steps,
          f"phase19 spec: B5 launches {sb5} != K 2 x 1 x "
          f"{seng.ragged_steps}")
    sstreams = [sgot[r] for r in sorted(sgot)]
    sties = sum(not same_or_tie(f"phase19 spec request {i}", sstreams[i],
                                streams[i], reqs[i][0], [64, 128], model)
                for i in range(len(reqs)))
    stokens = sum(len(v) for v in sgot.values())
    say(f"phase19 the same serve with a 1-layer GPT draft at K 2: "
        f"{seng.ragged_steps} steps, acceptance "
        f"{seng.acceptance_rate:.3f}, {stokens / swall:.1f} tokens/s, "
        f"{1e3 * swall / seng.ragged_steps:.3f} ms/step, graph pool "
        f"{spool / 2**20:.1f} MiB, B1 {sb1} = 7 x {seng.ragged_steps}, B5 "
        f"{sb5} = 2 x {seng.ragged_steps}; streams equal to the plain "
        f"arm's but {sties} logit near-ties of 24; 4 requests vs "
        f"generate(): {kinds.count('equal')} equal, {kinds.count('flip')} "
        f"diverging at a found routing flip, {kinds.count('logit')} at a "
        f"logit near-tie")
    return streams, b1 + sb1, sb5, replays


def phase19_bucketed(model, reqs, streams, replays, card):
    """(4) the first 8 requests through the bucketed paged engine
    (8 slots, max_len 512, block 16, buckets [64, 128], ticks_per_sync
    8): B5 6 launches a tick, B2 6 an admission at bucket 128, streams
    equal to the ragged arm's.  Returns (B5, B2) launches."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving_paged import PagedContinuousBatchingEngine

    Lyr, k = model.config.num_layers, 8
    sub = reqs[:ERNIE_BUCKETED_REQS]

    def paged():
        return PagedContinuousBatchingEngine(
            model, max_slots=8, max_len=512, block_size=16,
            prompt_buckets=[64, 128], ticks_per_sync=k, device="cuda")

    serve_upfront(paged(), [(p, 16) for p, _ in sub[:8]])   # warm-up
    eng = paged()
    wall, got, budgets = serve_upfront(eng, sub)
    b5 = pa.paged_decode_attention_cuda.launches
    b2 = A.flash_fwd_cuda.launches
    ticks = eng.decode_syncs * k
    check(sorted(got) == sorted(budgets)
          and all(len(got[r]) == n for r, n in budgets.items()),
          "phase19 bucketed: budgets not held")
    check(eng.blocks_in_use == 0, "phase19 bucketed: blocks in use")
    check(b5 == Lyr * ticks > 0, f"phase19 bucketed: B5 launches {b5} != "
                                 f"{Lyr} x {ticks} ticks")
    # a 64-token bucket's prefill takes the dense path (flash_attention
    # tiles L by 128), a 128-token one flash_fwd
    n128 = sum(len(p) > 64 for p, _ in sub)
    check(b2 == Lyr * n128, f"phase19 bucketed: flash_fwd launches {b2} "
                            f"!= {Lyr} x {n128} admissions at bucket 128")
    kinds = [same_or_route_flip(f"phase19 bucketed request {i}", got[r],
                                streams[i], i, ("bucketed", "ragged"),
                                replays)
             for i, r in enumerate(sorted(got))]
    tokens = sum(n for _, n in sub)
    say(f"phase19 ERNIE-MoE bucketed paged serve (the first {len(sub)} "
        f"requests, "
        f"{tokens} tokens, ticks_per_sync {k}) on {card}: "
        f"{eng.decode_syncs} syncs = {ticks} ticks, {tokens / wall:.1f} "
        f"tokens/s, {1e3 * wall / eng.decode_syncs:.3f} ms/sync, B5 "
        f"launches {b5} = {Lyr} x {ticks}, flash_fwd {b2} = {Lyr} x "
        f"{n128} (the admissions at bucket 128); streams against the "
        f"ragged arm's: {kinds.count('equal')} equal, "
        f"{kinds.count('flip')} diverging at a found routing flip, "
        f"{kinds.count('logit')} at a logit near-tie")
    return b5, b2


def moe_gather_literal(x, gate_w, w1, b1, w2, b2, k):
    """The reference's ``moe_ffn_gather`` written literally: k expert
    weight slices gathered a token (timed against the port's form)."""
    import torch.nn.functional as F

    probs = torch.softmax(x.float() @ gate_w.float(), -1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    h1 = F.gelu(torch.einsum("th,tkhi->tki", x, w1[top_e]) + b1[top_e],
                approximate="tanh")
    out = torch.einsum("tki,tkih->tkh", h1, w2[top_e]) + b2[top_e]
    return (out.float() * gates[..., None]).sum(1).to(x.dtype)


def phase19_gather_cost(model, card):
    """The decode FFN's two formulations at the serving shapes (bf16,
    layer 0's weights): the port's every-expert form against the
    literal per-token gather, T 1, 8 and 256 rows."""
    from paddle_tpu_torch.ops.moe import moe_ffn_gather

    with torch.no_grad():
        w = model._experts(0)
        g = torch.Generator("cuda").manual_seed(3)
        for T in (1, 8, 256):
            x = torch.randn(T, model.config.hidden_size, generator=g,
                            device="cuda").to(
                torch.bfloat16)
            ours = moe_ffn_gather(x, *w, k=2)
            lit = moe_gather_literal(x, *w, k=2)
            err = (ours.float() - lit.float()).abs().max().item()
            scale = lit.float().abs().max().item()
            t_ours = time_cold_ms(lambda: moe_ffn_gather(x, *w, k=2),
                                  iters=10)
            t_lit = time_cold_ms(lambda: moe_gather_literal(x, *w, k=2),
                                 iters=10)
            say(f"phase19 MoE decode FFN at T {T} (bf16, hidden 768, 8 "
                f"experts, top-2) on {card}: every-expert form {t_ours:.4f} "
                f"ms, literal gather {t_lit:.4f} ms, max abs diff "
                f"{err:.3e} of max {scale:.3e}")
            check(err <= 4 * 2.0 ** -8 * scale,
                  f"phase19: the two forms differ by {err} at T {T} (> 4 "
                  f"bf16 ulps of {scale})")


def phase19_optimizers(card):
    """(5) each of the ten optimizers for 3 eager ``step()`` calls on card
    tensors with fixed gradients, with no clip and each clip, against the
    same run on the CPU (fp32)."""
    import paddle_tpu_torch.nn.clip as C
    import paddle_tpu_torch.optimizer as O

    opts = {
        "SGD": lambda ps, cl: O.SGD(0.05, parameters=ps, grad_clip=cl),
        "Momentum": lambda ps, cl: O.Momentum(0.05, parameters=ps,
                                              use_nesterov=True,
                                              grad_clip=cl),
        "Adam": lambda ps, cl: O.Adam(0.01, parameters=ps, grad_clip=cl),
        "AdamW": lambda ps, cl: O.AdamW(0.01, parameters=ps, grad_clip=cl),
        "Adamax": lambda ps, cl: O.Adamax(0.01, parameters=ps, grad_clip=cl),
        "Adagrad": lambda ps, cl: O.Adagrad(0.05, parameters=ps,
                                            grad_clip=cl),
        "Adadelta": lambda ps, cl: O.Adadelta(1.0, parameters=ps,
                                              grad_clip=cl),
        "RMSProp": lambda ps, cl: O.RMSProp(0.01, momentum=0.5,
                                            centered=True, parameters=ps,
                                            grad_clip=cl),
        "Lamb": lambda ps, cl: O.Lamb(0.01, parameters=ps, grad_clip=cl),
        "Lars": lambda ps, cl: O.Lars(0.1, lars_coeff=0.01, parameters=ps,
                                      grad_clip=cl,
                                      exclude_from_weight_decay=["b"]),
    }
    clips = {None: lambda: None, "value": lambda: C.ClipGradByValue(0.05),
             "norm": lambda: C.ClipGradByNorm(0.5),
             "global": lambda: C.ClipGradByGlobalNorm(0.5)}
    rng = np.random.RandomState(5)
    shapes = {"w": (256, 768), "b": (768,), "e": (8, 64, 32)}
    p0 = {n: rng.standard_normal(s).astype(np.float32)
          for n, s in shapes.items()}
    grads = [{n: (0.1 * rng.standard_normal(s)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3)]
    worst = 0.0
    for name, make in opts.items():
        for clip, mk in clips.items():
            out = {}
            for dev in ("cuda", "cpu"):
                ps = {n: torch.nn.Parameter(torch.from_numpy(v.copy())
                                            .to(dev))
                      for n, v in p0.items()}
                opt = make(list(ps.items()), mk())
                for g in grads:
                    for n, p in ps.items():
                        p.grad = torch.from_numpy(g[n]).to(dev)
                    opt.step()
                out[dev] = {n: p.detach().cpu() for n, p in ps.items()}
            for n in shapes:
                a, b = out["cuda"][n], out["cpu"][n]
                err = (a - b).abs().max().item()
                worst = max(worst, err)
                check(torch.allclose(a, b, rtol=OPT_RTOL, atol=OPT_ATOL),
                      f"phase19 optimizers: {name} clip {clip} {n} differs "
                      f"by {err}")
    say(f"phase19 eager optimizers on {card}: 10 optimizers x 4 clip "
        f"settings x 3 steps over {sum(np.prod(s) for s in shapes.values())}"
        f" fp32 parameters, card vs CPU worst abs diff {worst:.3e} (tol "
        f"{OPT_ATOL} + {OPT_RTOL} of the value)")


def phase19(card):
    """ERNIE-MoE training and serving, and the eager optimizers.  Returns
    the launches of (B1, B2, B3, B4, B5) in the main-path runs: the timed
    train, both ragged serves and the bucketed serve."""
    from paddle_tpu_torch.ops import paged_attention as pa

    t0 = time.perf_counter()
    phase19_card_vs_cpu()
    gc.collect()
    flash = phase19_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    model = ernie_model("cuda")
    reqs = serving_traffic(model.config.vocab_size)
    streams, b1, b5_spec, replays = phase19_ragged(model, reqs, card)
    b5, b2 = phase19_bucketed(model, reqs, streams, replays, card)
    del replays
    phase19_gather_cost(model, card)
    del model
    gc.collect()
    phase19_optimizers(card)
    pa.paged_decode_attention_cuda.launches = 0
    say(f"phase19 took {time.perf_counter() - t0:.1f} s")
    return b1, flash[0] + b2, flash[1], flash[2], b5 + b5_spec


# ------------------------------------------------------------ phase 20 --

GATEWAY_CELL = dict(max_slots=4, max_len=256, block_size=16,
                    prompt_buckets=[64], token_budget=128)
GATEWAY_DEPTH = 4                  # bench_gpt_gateway's bounded arm


def gateway_requests(vocab):
    """``bench.py bench_gpt_gateway``'s accelerator traffic: 48 requests,
    32-64 prompt tokens and 24-48 new tokens from RandomState(0)."""
    rng = np.random.RandomState(0)
    return [([int(t) for t in rng.randint(1, vocab, rng.randint(32, 65))],
             int(rng.randint(24, 49))) for _ in range(48)]


def kernel_counts():
    """(B1, B2, B5) launch counts, read together."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops import ragged_paged_attention as rpa

    return (rpa.ragged_attention_cuda.launches, A.flash_fwd_cuda.launches,
            pa.paged_decode_attention_cuda.launches)


def ragged_steps_of(engines):
    return sum(getattr(e, "ragged_steps", 0) for e in engines)


def phase20_gateway(model, card):
    """20a: bench_gpt_gateway's accelerator cell: two ragged replicas
    behind a ``ServingGateway``, a warm run, an unbounded arm and a
    bounded arm (depth 4) that carries an ``SLOMonitor`` and an unstarted
    ``OpsServer`` scraped by a ``FleetCollector``.  Returns (the bounded
    arm's gateway, its SLO monitor, the arms' TTFT samples, B1 launches
    of the two timed arms)."""
    from paddle_tpu_torch.gateway import ServingGateway
    from paddle_tpu_torch.ops_server import OpsServer
    from paddle_tpu_torch.serving_paged import \
        RaggedPagedContinuousBatchingEngine
    from paddle_tpu_torch.telemetry import Tracer
    from paddle_tpu_torch.telemetry_fleet import FleetCollector
    from paddle_tpu_torch.telemetry_slo import SLOMonitor

    L = model.config.num_layers
    reqs = gateway_requests(model.config.vocab_size)
    engines = []
    for i in range(2):
        eng = RaggedPagedContinuousBatchingEngine(
            model, tracer=Tracer(), device="cuda", **GATEWAY_CELL)
        warm(eng)
        engines.append(eng)
    launched, out = 0, {}

    def run(name, depth, fleet=False):
        nonlocal launched
        gw = ServingGateway(max_queue_depth=depth,
                            tracer=Tracer(capacity=16384))
        for i, eng in enumerate(engines):
            gw.add_replica(eng, f"r{i}")
        collector = slo = None
        if fleet:
            slo = SLOMonitor(resolution_s=0.5)
            gw.set_slo(slo)
            srv = OpsServer()
            srv.attach(gw, "gateway")
            srv.attach(slo, "slo")
            collector = FleetCollector(interval_s=0.5)
            collector.add_target("gateway", server=srv)
            collector.scrape_once()       # baseline for counter deltas
        misses = [e._compile_misses for e in engines]
        steps0 = ragged_steps_of(engines)
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        handles = []
        for p, n in reqs:
            handles.append(gw.submit(p, n))
            if len(handles) % 2 == 0:
                gw.step()
        gw.run_to_completion(max_ticks=100000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b1 = kernel_counts()[0]
        steps = ragged_steps_of(engines) - steps0
        check(b1 == L * steps > 0, f"phase20a {name}: ragged launches {b1} "
                                   f"!= {L} x {steps} ragged steps")
        check([e._compile_misses for e in engines] == misses,
              f"phase20a {name}: programs built while serving")
        admitted = [r for r in handles if r.status == "finished"]
        shed = [r for r in handles if r.status == "shed"]
        check(len(admitted) + len(shed) == len(handles),
              f"phase20a {name}: silent drops "
              f"{sorted({r.status for r in handles})}")
        check(all(r.error is not None for r in shed),
              f"phase20a {name}: a shed request carries no error")
        check(all(len(r.tokens) == n for r, (p, n) in zip(handles, reqs)
                  if r.status == "finished"),
              f"phase20a {name}: a finished request is short")
        for eng in engines:
            check(eng.blocks_in_use == 0,
                  f"phase20a {name}: {eng.blocks_in_use} blocks in use at "
                  f"quiescence")
        ttfts = [r.first_token_at - r.submitted_at for r in admitted]
        tokens = sum(len(r.tokens) for r in admitted)
        rollup = collector.scrape_once()["rollup"] if fleet else None
        out[name] = dict(admitted=len(admitted), shed=len(shed), wall=wall,
                         p50=float(np.percentile(ttfts, 50)) * 1e3,
                         p99=float(np.percentile(ttfts, 99)) * 1e3,
                         tokens=tokens, ttfts=ttfts, launches=b1)
        say(f"phase20a {name} arm (depth {depth}) on {card}: admitted "
            f"{len(admitted)}, shed {len(shed)}, wall {wall:.3f} s, TTFT "
            f"p50 {out[name]['p50']:.3f} ms p99 {out[name]['p99']:.3f} ms, "
            f"{tokens} tokens = {tokens / wall:.1f} tokens/s, ragged "
            f"launches {b1} = {L} x {steps}")
        if fleet:
            say(f"phase20a bounded arm fleet rollup: {json.dumps(rollup)}")
        if name != "warm":
            launched += b1
        return gw, slo

    run("warm", 10 ** 9)
    run("unbounded", 10 ** 9)
    gw, slo = run("bounded", GATEWAY_DEPTH, fleet=True)
    b, u = out["bounded"], out["unbounded"]
    check(b["shed"] > 0, "phase20a: the bounded arm shed nothing")
    check(u["shed"] == 0, "phase20a: the unbounded arm shed")
    check(b["p99"] < u["p99"], f"phase20a: bounded TTFT p99 {b['p99']} ms "
                               f"is not below unbounded {u['p99']} ms")
    say(f"phase20a gpt2-small bf16 gateway cell (2 ragged replicas of 4 "
        f"slots, 48 requests, 2 arrivals a step) on {card}: TTFT p99 "
        f"unbounded {u['p99']:.3f} ms vs bounded {b['p99']:.3f} ms "
        f"({u['p99'] / b['p99']:.3f}x)")
    return gw, slo, b["ttfts"], launched


def phase20_disagg(model, card):
    """20b: a prefill-role and a decode-role ragged replica (the decode one
    with a ``TieredKVStore``) serve bench_gpt_kv_tier's 240-token prompt
    through the gateway: the pages migrate, the decode replica's stream
    equals a ragged engine's after an HBM prefix hit of the prompt, and
    the cold unified stream within the near-tie rule.  Returns the B1
    launches of the disaggregated serves."""
    from paddle_tpu_torch.gateway import ServingGateway
    from paddle_tpu_torch.kv_store import TieredKVStore
    from paddle_tpu_torch.serving_paged import \
        RaggedPagedContinuousBatchingEngine
    from paddle_tpu_torch.telemetry import Tracer

    L = model.config.num_layers
    buckets, n_new, reps = [64, 256], 16, 3
    prompt = [int(t) for t in np.random.RandomState(0).randint(
        1, model.config.vocab_size, 240)]
    settings = dict(max_slots=4, max_len=512, block_size=16,
                    prompt_buckets=buckets, token_budget=64, device="cuda")
    page = 2 * L * 16 * model.config.hidden_size * model.compute_dtype.itemsize

    def ragged(prefix, **kw):
        eng = RaggedPagedContinuousBatchingEngine(
            model, enable_prefix_cache=prefix, **settings, **kw)
        warm(eng)
        return eng

    cold = ragged(False)
    cold_runs = [ttft_serve(cold, prompt, n_new) for _ in range(reps + 1)]
    hit = ragged(True)
    ttft_serve(hit, prompt, n_new)                 # publishes 15 blocks
    hit_runs = [ttft_serve(hit, prompt, n_new) for _ in range(reps)]
    check(hit.prefix_hits == reps, f"phase20b: the HBM arm hit "
                                   f"{hit.prefix_hits} times, not {reps}")
    want_hit = hit_runs[0][1]
    check(all(s == want_hit for _, s in hit_runs),
          "phase20b: the HBM-hit repeats differ")
    del cold, hit

    prefill = ragged(True, tracer=Tracer())
    decode = ragged(True, tracer=Tracer(), kv_store=TieredKVStore())
    launched, ttft, streams = 0, [], []
    for rep in range(reps):
        gw = ServingGateway(tracer=Tracer())     # 8 MiB a tick of pages
        gw.add_replica(prefill, "pf", role="prefill")
        gw.add_replica(decode, "dc", role="decode")
        misses = (prefill._compile_misses, decode._compile_misses)
        restored0 = decode.metrics()["kvstore_restored_blocks"]
        steps0 = ragged_steps_of((prefill, decode))
        reset_launches()
        torch.cuda.synchronize()
        req = gw.submit(prompt, n_new)
        while gw.pending():
            gw.step()
        torch.cuda.synchronize()
        b1 = kernel_counts()[0]
        steps = ragged_steps_of((prefill, decode)) - steps0
        check(b1 == L * steps > 0, f"phase20b: ragged launches {b1} != "
                                   f"{L} x {steps}")
        launched += b1
        kv = gw.kvstore_snapshot()["counters"]
        check(req.status == "finished" and req.replica == "dc"
              and len(req.tokens) == n_new,
              f"phase20b: {req.status} on {req.replica}")
        check(kv.get("migrations_completed") == 1
              and kv.get("migrated_bytes") == 15 * page,
              f"phase20b: migration counters {kv} (want 1 migration of 15 "
              f"pages of {page} bytes)")
        check(decode.metrics()["kvstore_restored_blocks"] - restored0 >= 1,
              "phase20b: the decode replica restored no block")
        check((prefill._compile_misses, decode._compile_misses) == misses,
              "phase20b: programs built while serving")
        ttft.append((req.first_token_at - req.submitted_at) * 1e3)
        streams.append(req.tokens)
        # the next repeat starts cold: no page of the prompt anywhere
        prefill.flush_prefix()
        decode.flush_prefix()
        decode.attach_kv_store(TieredKVStore())
        check(prefill.blocks_in_use == decode.blocks_in_use == 0,
              "phase20b: blocks in use after the flushes")
    for i, s in enumerate(streams):
        check(s == want_hit, f"phase20b: disaggregated stream {i} differs "
                             f"from the HBM-hit stream")
    same = same_or_tie("phase20b disaggregated vs the cold unified stream",
                       streams[0], cold_runs[1][1], prompt, buckets, model)
    say(f"phase20b disaggregated prefill -> decode (240-token prompt, "
        f"bucket 256, 16 new tokens, 15 pages of {page} bytes migrated at "
        f"8 MiB a tick, {reps} repeats) on {card}: TTFT p50 "
        f"disaggregated {float(np.median(ttft)):.3f} ms, unified cold "
        f"{float(np.median([t for t, _ in cold_runs[1:]])):.3f} ms, unified "
        f"HBM hit {float(np.median([t for t, _ in hit_runs])):.3f} ms "
        f"(disaggregated {[round(t, 3) for t in ttft]}); streams equal to "
        f"the HBM hit's, to the cold one's {same}; ragged launches "
        f"{launched}")
    return launched


CHAOS_POLICY = dict(retry_budget=3, retry_backoff_s=0.25,
                    retry_backoff_max_s=2.0, retry_jitter=0.5, seed=0,
                    breaker_failures=3, breaker_open_s=2.5,
                    hedge=True, hedge_ttft_frac=0.05, max_hedges=8,
                    brownout=True, brownout_high=3.0, brownout_low=1.0,
                    brownout_down_dwell_s=5.0, brownout_clamp=6,
                    brownout_use_slo=False)


def phase20_chaos(model, card):
    """20c: phase 3's 24 requests through a mixed fleet (two ragged
    replicas, one bucketed paged) of ``FaultyEngine``s on the real clock
    under a ``ResiliencePolicy`` (bench_gpt_chaos's settings): a crash of
    ragged r0 mid-burst and a dispatch-error window on ragged r1.  Every
    request ends terminal, retries stay in budget, every finished stream
    is a prefix of the unfaulted fleet's stream for its request (under
    the near-tie rule).  Returns the (B1, B2, B5) launches of the
    faulted serve."""
    from paddle_tpu_torch.faults import Fault, FaultPlan, FaultyEngine
    from paddle_tpu_torch.gateway import ResiliencePolicy, ServingGateway
    from paddle_tpu_torch.serving_paged import (
        PagedContinuousBatchingEngine, RaggedPagedContinuousBatchingEngine)
    from paddle_tpu_torch.telemetry import Tracer

    reqs = serving_traffic(model.config.vocab_size)
    buckets = [64, 128]
    common = dict(max_slots=8, max_len=512, block_size=16,
                  prompt_buckets=buckets, device="cuda")

    def fleet():
        engs = [RaggedPagedContinuousBatchingEngine(
                    model, token_budget=256, tracer=Tracer(), **common)
                for _ in range(2)]
        engs.append(PagedContinuousBatchingEngine(model, tracer=Tracer(),
                                                  **common))
        for e in engs:
            warm(e)
        return engs

    def serve(engs, plan):
        t_start = []
        clock = lambda: (time.monotonic() - t_start[0]  # noqa: E731
                         if t_start else 0.0)
        pol = ResiliencePolicy(**CHAOS_POLICY)
        gw = ServingGateway(clock=clock, tracer=Tracer(capacity=16384),
                            stall_threshold_s=1.0, resilience=pol)
        wrappers = []
        for name, e in zip(("r0", "r1", "p0"), engs):
            w = FaultyEngine(e, plan, clock, replica=name)
            wrappers.append(w)
            gw.add_replica(w, name)
        reset_launches()
        torch.cuda.synchronize()
        t_start.append(time.monotonic())
        handles, added = [], 0
        while added < len(reqs) or gw.pending():
            for p, n in reqs[added:added + 2]:
                handles.append(gw.submit(p, n, ttft_deadline_s=60.0))
            added += 2
            gw.step()
            check(clock() < 300, "phase20c: the fleet did not drain")
        torch.cuda.synchronize()
        return gw, handles, wrappers, clock(), kernel_counts()

    engs = fleet()
    _, clean, _, clean_wall, _ = serve(engs, FaultPlan([]))
    check(all(h.status == "finished" for h in clean),
          "phase20c: the unfaulted fleet did not finish everything")
    plan = FaultPlan([Fault("crash", at_s=0.2, replica="r0"),
                      Fault("dispatch_error", at_s=0.0, duration_s=0.4,
                            replica="r1")], seed=7)
    misses = [e._compile_misses for e in engs]
    gw, handles, wrappers, wall, launches = serve(engs, plan)
    check([e._compile_misses for e in engs] == misses,
          "phase20c: programs built while serving")
    statuses = [h.status for h in handles]
    check(all(h.done for h in handles),
          f"phase20c: non-terminal requests {sorted(set(statuses))}")
    check(all(h.retries <= CHAOS_POLICY["retry_budget"] for h in handles),
          "phase20c: retries over budget")
    injected = [ev for w in wrappers for ev in w.injected()]
    kinds = {ev["kind"] for ev in injected}
    check(kinds == {"crash", "dispatch_error"},
          f"phase20c: injected {sorted(kinds)}")
    snap = gw.resilience_snapshot()
    counters = gw.gateway_snapshot()["counters"]
    check(snap["counters"].get("retries", 0) >= 1
          and counters.get("quarantines", 0) >= 1,
          f"phase20c: the faults left no trace: resilience "
          f"{snap['counters']}, gateway {counters}")
    check(gw.replica("r0").state == "quarantined",
          f"phase20c: r0 is {gw.replica('r0').state} after its crash")
    check(launches[0] > 0 and launches[1] > 0 and launches[2] > 0,
          f"phase20c: launches (B1, B2, B5) {launches}")
    finished = equal = 0
    by_status = {}
    for i, (h, c) in enumerate(zip(handles, clean)):
        by_status[h.status] = by_status.get(h.status, 0) + 1
        if h.status != "finished":
            continue
        finished += 1
        check(0 < len(h.tokens) <= len(c.tokens),
              f"phase20c: request {i} has {len(h.tokens)} tokens")
        equal += same_or_tie(f"phase20c request {i} vs the unfaulted fleet",
                             h.tokens, c.tokens[:len(h.tokens)],
                             reqs[i][0], buckets, model)
    check(finished > 0, "phase20c: nothing finished")
    say(f"phase20c mixed fleet (2 ragged + 1 bucketed paged, gpt2-small "
        f"bf16, 24 requests) under a crash of r0 at 0.2 s and dispatch "
        f"errors on r1 for 0.4 s on {card}: outcomes {by_status}, wall "
        f"{wall:.3f} s (unfaulted {clean_wall:.3f} s), injected "
        f"{len(injected)} faults, resilience counters {snap['counters']}, "
        f"gateway quarantines {counters.get('quarantines')}, rerouted "
        f"{counters.get('rerouted', 0)}; {equal}/{finished} finished "
        f"streams equal to the unfaulted fleet's (the rest at a near-tie); "
        f"launches B1 {launches[0]}, B2 {launches[1]}, B5 {launches[2]}")
    return launches


def phase20_ops(gw, slo, ttfts, card):
    """20d: an ``OpsServer`` on 127.0.0.1 port 0 over 20a's bounded
    gateway: ``/healthz?probe=1`` runs ``compute_probe()`` on the card,
    and a ``FleetCollector`` scraping it over HTTP rolls up a TTFT p99
    within the sketch's relative error of the gateway's own p99."""
    from paddle_tpu_torch.ops_server import OpsServer
    from paddle_tpu_torch.telemetry_fleet import FleetCollector
    from paddle_tpu_torch.telemetry_slo import PercentileSketch

    srv = OpsServer(host="127.0.0.1", port=0, stall_threshold_s=1e9,
                    probe_timeout_s=60.0)
    srv.attach(gw, "gateway")
    srv.attach(slo, "slo")
    url = srv.start()
    try:
        srv.heartbeat()
        with urllib.request.urlopen(url + "/healthz?probe=1",
                                    timeout=120) as r:
            status, health = r.status, json.loads(r.read())
        probe = health["probe"]
        check(status == 200 and health["ok"] and probe["ok"]
              and probe["devices"] == 1
              and probe["device"] == torch.cuda.get_device_name(0),
              f"phase20d: /healthz {status} {health}")
        col = FleetCollector(interval_s=0.5)
        col.add_target("gateway", url=url)
        rollup = col.scrape_once()["rollup"]
    finally:
        srv.stop()
    alpha = PercentileSketch().alpha
    exact = float(np.percentile(ttfts, 99, method="lower"))
    got = rollup["fleet_ttft_p99"]
    check(got is not None and abs(got - exact) <= alpha * exact,
          f"phase20d: fleet TTFT p99 {got} s vs the gateway's {exact} s "
          f"(relative error {alpha})")
    say(f"phase20d ops server on {url}: /healthz probe ok on "
        f"{probe['device']} (devices {probe['devices']}, {probe['wall_s']} "
        f"s); fleet TTFT p99 over HTTP {got * 1e3:.3f} ms vs the gateway's "
        f"{exact * 1e3:.3f} ms (within {alpha:.0%}); targets ok "
        f"{rollup['targets_ok']}")


def phase20_sim():
    """20e: bench_gpt_autoscale's and bench_gpt_chaos's simulated A/Bs on
    the port's modules (host only), with their contracts."""
    from paddle_tpu_torch import (autoscaler, faults, gateway, simulation,
                                  telemetry_slo)

    def autoscale(autoscaled):
        clock = simulation.SimClock()
        tracer = simulation.SimTracer(clock, capacity=16384)
        gw = gateway.ServingGateway(clock=clock, max_queue_depth=64,
                                    tracer=tracer, stall_threshold_s=30.0)

        def factory():
            return simulation.SimEngine(
                max_slots=4, tracer=simulation.SimTracer(clock))

        gw.add_replica(factory(), "r0")
        asc = None
        if autoscaled:
            Objective = telemetry_slo.Objective
            slo = telemetry_slo.SLOMonitor([
                Objective.latency("ttft_p99", "ttft_s", 2.0,
                                  compliance=0.9, windows=(30.0, 10.0),
                                  burn_threshold=1.0, for_s=2.0,
                                  clear_s=10.0),
                Objective.ratio("shed_rate", "shed", "submitted", 0.05,
                                windows=(30.0, 10.0), burn_threshold=1.0,
                                for_s=2.0, clear_s=10.0),
            ], clock=clock, resolution_s=1.0, tracer=tracer)
            gw.set_slo(slo)
            asc = autoscaler.ElasticAutoscaler(
                gw, factory, slo=slo, min_replicas=1, max_replicas=4,
                scale_up_cooldown_s=5.0, scale_down_cooldown_s=20.0,
                idle_utilization=0.2, idle_dwell_s=30.0, tracer=tracer,
                clock=clock)
        sim = simulation.TrafficSim(
            gw, clock, simulation.flash_crowd(1.0, 8.0, 20.0, 40.0),
            dt=0.25, seed=0, autoscaler=asc)
        rep = sim.run(180.0)
        check(not rep["dropped"], f"phase20e autoscale: dropped "
                                  f"{rep['dropped']}")
        return rep

    def chaos(resilient):
        plan = faults.FaultPlan([
            faults.Fault("slow", at_s=20.0, duration_s=40.0, factor=40,
                         replica="r0"),
            faults.Fault("crash", at_s=30.0, replica="r1"),
            faults.Fault("dispatch_error", at_s=45.0, duration_s=6.0,
                         replica="r2"),
            faults.Fault("stall", at_s=70.0, duration_s=12.0, replica="r2"),
        ], seed=7)
        clock = simulation.SimClock()
        tracer = simulation.SimTracer(clock, capacity=32768)
        pol = gateway.ResiliencePolicy(**CHAOS_POLICY) if resilient else None
        gw = gateway.ServingGateway(clock=clock, tracer=tracer,
                                    stall_threshold_s=4.0,
                                    max_queue_depth=256, resilience=pol)
        for i in range(3):
            eng = simulation.SimEngine(max_slots=8,
                                       tracer=simulation.SimTracer(clock))
            gw.add_replica(faults.FaultyEngine(eng, plan, clock,
                                               replica=f"r{i}"), f"r{i}")
        sim = simulation.TrafficSim(gw, clock, simulation.steady(2.0),
                                    dt=0.25, seed=0, ttft_deadline_s=60.0)
        rep = sim.run(120.0)
        check(not rep["dropped"], f"phase20e chaos: dropped "
                                  f"{rep['dropped']}")
        for h in sim.handles:
            check(h.status != "finished" or h.tokens == simulation.sim_tokens(
                h.prompt, len(h.tokens)), f"phase20e chaos: stream {h.gid}")
            check(not resilient or h.retries <= pol.retry_budget,
                  "phase20e chaos: retries over budget")
        return rep

    t0 = time.perf_counter()
    fixed, auto = autoscale(False), autoscale(True)
    check(fixed["offered"] == auto["offered"] and fixed["shed_rate"] > 0.0
          and auto["ttft_s"]["p99"] < fixed["ttft_s"]["p99"]
          and auto["shed_rate"] < fixed["shed_rate"],
          f"phase20e: the autoscale A/B contract failed: fixed "
          f"{fixed['ttft_s']} {fixed['shed_rate']}, autoscaled "
          f"{auto['ttft_s']} {auto['shed_rate']}")
    off, on = chaos(False), chaos(True)
    check(off["offered"] == on["offered"]
          and on["ttft_s"]["p99"] < off["ttft_s"]["p99"]
          and on["outcomes"].get("finished", 0)
          >= off["outcomes"].get("finished", 0),
          f"phase20e: the chaos A/B contract failed: off {off['ttft_s']} "
          f"{off['outcomes']}, on {on['ttft_s']} {on['outcomes']}")
    say(f"phase20e simulated A/Bs on the port (host only, simulated "
        f"seconds, {time.perf_counter() - t0:.2f} s of wall): autoscale "
        f"p99 TTFT {fixed['ttft_s']['p99']} -> {auto['ttft_s']['p99']} s "
        f"({fixed['ttft_s']['p99'] / auto['ttft_s']['p99']:.3f}x), shed "
        f"rate {fixed['shed_rate']:.4f} -> {auto['shed_rate']:.4f}; chaos "
        f"p99 TTFT {off['ttft_s']['p99']} -> {on['ttft_s']['p99']} s "
        f"({off['ttft_s']['p99'] / on['ttft_s']['p99']:.3f}x), finished "
        f"{off['outcomes'].get('finished', 0)} -> "
        f"{on['outcomes'].get('finished', 0)} of {on['offered']}")


def phase20(card):
    """The serving fleet over the port's engines at gpt2-small width
    (bf16, weights from seed 0, graphs on, every engine warmed).  Returns
    the (B1, B2, B5) launches of its main-path runs: 20a's two timed arms,
    20b's disaggregated serves and 20c's faulted serve."""
    t0 = time.perf_counter()
    model = full_width_model()
    gw, slo, ttfts, b1_gw = phase20_gateway(model, card)
    b1_disagg = phase20_disagg(model, card)
    gc.collect()
    chaos = phase20_chaos(model, card)
    phase20_ops(gw, slo, ttfts, card)
    del gw
    gc.collect()
    torch.cuda.empty_cache()
    phase20_sim()
    say(f"phase20 took {time.perf_counter() - t0:.1f} s on {card}")
    return b1_gw + b1_disagg + chaos[0], chaos[1], chaos[2]


# ------------------------------------------------------------ phase 21 --

DP_WIDTH = dict(vocab_size=50304, max_position_embeddings=1024,
                compute_dtype="bfloat16")
GRAD_COMM_TOL = 0.02     # int8_ef against fp32 curves (test_grad_comm.py)
BF16_RTOL = 1e-3         # a bf16 loss on R row blocks against one rank's
# the fp32 weights' move over 3 AdamW steps against one rank's, as the norm
# of the difference over the norm of the move: bf16 roundings of a 4-row
# against an 8-row gradient flip the sign of Adam's step only where the
# gradient is near zero, while a rank that trained on its own rows alone
# moves most weights otherwise (21c measures that step beside the limit)
DELTA_TOL = 0.25


def flash_counts():
    """(flash_fwd, dq, dkv, ln_fwd, ln_bwd) launch counts, read together."""
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import fused as TF

    return [A.flash_fwd_cuda.launches, A.flash_bwd_dq_cuda.launches,
            A.flash_bwd_dkv_cuda.launches, TF.fused_ln_fwd_cuda.launches,
            TF.fused_ln_bwd_cuda.launches]


def zero_counts():
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import fused as TF

    for k in (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda,
              TF.fused_ln_fwd_cuda, TF.fused_ln_bwd_cuda):
        k.launches = 0


def fleet_hcg(**degrees):
    """``bench.py``'s ``_fleet_hcg`` on the port."""
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    cfg = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1}
    cfg.update(degrees)
    strategy.hybrid_configs = cfg
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


def phase21a(card):
    """``bench_gpt_grad_comm``'s accelerator cell over NCCL at world size
    1: the sharded-init gpt2s step (12 layers, B 16, L 1024) under each
    policy, 2 warm-up and 10 timed steps.  Returns the flash launches."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.grad_comm import wire_bytes
    from paddle_tpu_torch.models.gpt import (gpt_preset,
                                             make_sharded_gpt_train_step)
    from paddle_tpu_torch.optimizer import AdamW

    dist.init_parallel_env()                 # nccl on this card, world 1
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"phase21a: backend {dist.get_backend()} world "
          f"{dist.get_world_size()}")
    cfg = gpt_preset("gpt2-small", **DP_WIDTH)
    B, L, iters = 16, 1024, 10
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    zero_counts()
    rows, curves = {}, {}
    for pol in ("fp32", "bf16", "int8_ef"):
        step, state = make_sharded_gpt_train_step(
            cfg, AdamW(3e-4, weight_decay=0.01), fleet_hcg(), remat=False,
            grad_comm=pol)
        wb = wire_bytes(state["params"], pol)
        losses = []
        for i in range(2):
            state, loss = step(state, 3e-4, i, x, y)
            losses.append(loss)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(iters):
            state, loss = step(state, 3e-4, i, x, y)
            losses.append(loss)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        curves[pol] = [v.item() for v in losses]
        rows[pol] = dict(ms=1e3 * dt / iters, tps=B * L * iters / dt,
                         pre=wb["pre_bytes"], post=wb["post_bytes"],
                         comm_e="comm_e" in state)
        del step, state, loss, losses
        gc.collect()
        torch.cuda.empty_cache()
    launches = flash_counts()[:3]
    for pol, r in rows.items():
        say(f"phase21a bench_gpt_grad_comm cell (gpt2s 12 layers, B {B}, "
            f"L {L}, bf16, sharded init under fleet, NCCL world 1) on {card}:"
            f" {pol} {r['ms']:.3f} ms/step, {r['tps']:.1f} tokens/s, loss "
            f"{curves[pol][-1]:.4f}, wire_bytes {r['post']} of fp32's "
            f"{r['pre']} (saving {r['pre'] / r['post']:.3f}x)")
    n = rows["fp32"]["pre"] // 8
    want = 8 * n / (2 * (n + 4 * -(-n // 256)))
    got = rows["int8_ef"]["pre"] / rows["int8_ef"]["post"]
    check(got == want and got > 3.9,
          f"phase21a: int8_ef saving {got} != the formula's {want}")
    check(rows["bf16"]["pre"] / rows["bf16"]["post"] == 2.0,
          "phase21a: bf16 saving is not 2x")
    check(rows["int8_ef"]["comm_e"] and not rows["fp32"]["comm_e"],
          "phase21a: comm_e only under int8_ef")
    check(all(np.isfinite(c).all() for c in curves.values()),
          f"phase21a: non-finite losses {curves}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves["int8_ef"],
                                                 curves["fp32"]))
    check(rel <= GRAD_COMM_TOL,
          f"phase21a: int8_ef curve {rel} from fp32's (tol {GRAD_COMM_TOL})")
    say(f"phase21a losses over 12 steps: fp32 "
        f"{[round(v, 4) for v in curves['fp32']]}; int8_ef within "
        f"{rel:.3e} relative of it (tol {GRAD_COMM_TOL}); bf16 within "
        f"{max(abs(a - b) / abs(b) for a, b in zip(curves['bf16'], curves['fp32'])):.3e}; "
        f"int8_ef/fp32 step time {rows['int8_ef']['ms'] / rows['fp32']['ms']:.3f} "
        f"(the policy's compute on this card: local mode, no int8 on a wire); "
        f"flash launches fwd/dq/dkv {launches} = 12 x 12 x 3")
    check(launches == [12 * 12 * 3] * 3,
          f"phase21a: flash launches {launches}")
    dist.destroy_process_group()
    return launches, rows


def gpt_loss(model):
    def loss_of(params, key, x, labels):
        h = model.scan_blocks(model.embed_fn(x, key), key, remat=False)
        return model.head_loss_fn(h, labels)
    return loss_of


def rank21b(rank, card):
    """``bench_gpt_weight_update_sharding`` at R 2: the replicated and the
    update-sharded arm, 1 warm-up and 3 timed steps each, under a
    ``TrainMonitor`` + ``RunLedger`` (21d) and a ``MemoryLedger``."""
    from paddle_tpu_torch.distributed.grad_comm import wire_bytes
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import TrainMonitor
    from paddle_tpu_torch.telemetry_ledger import RunLedger
    from paddle_tpu_torch.telemetry_memory import MemoryLedger

    cfg = gpt_preset("gpt2-small", **DP_WIDTH)
    B, L, iters = 16, 1024, 3
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    out = {}
    for arm in ("replicated", "sharded"):
        model = GPTModel(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
        mon, led, mem = TrainMonitor(), RunLedger(), MemoryLedger()
        mon.set_ledger(led)
        with mem:
            step, state = make_gpt_train_step(
                model, AdamW(3e-4, weight_decay=0.01), fleet_hcg(dp_degree=2),
                remat=False, monitor=mon, update_sharding=arm == "sharded")
            opt_bytes = per_device_state_bytes(state)
            state, loss = step(state, 0, 3e-4, x, y)
            loss.item()
            t0 = time.perf_counter()
            for i in range(iters):
                state, loss = step(state, i + 1, 3e-4, x, y)
            final = loss.item()
            dt = time.perf_counter() - t0
            mem.register_train_state(state, name="final_state")
            walk = mem.census()
        led.close()
        out[arm] = dict(opt_bytes=opt_bytes,
                        measured=int(walk["pools"]["optimizer_state"]),
                        ms=1e3 * dt / iters, loss=final,
                        wire=wire_bytes(state["params"], "fp32")["post_bytes"])
        if arm == "sharded":
            out["monitor"] = mon.aggregate()
            out["ledger"] = led.aggregate()
            out["local_tokens"] = sum(e["tokens"]
                                      for e in mon.events("train_step"))
        del model, step, state, loss
        gc.collect()
        torch.cuda.empty_cache()
    return out


def weights(state):
    """The fp32 weights a ZeRO state updates: its parameters, or their
    fp32 masters where it keeps them."""
    return {**state["params"], **state.get("master", {})}


def delta_errors(got, p0, solo, cut):
    """How far this rank's weights ``got`` moved from the one-rank step's
    move, on the same blocks: (norm of the difference over the norm of
    the one-rank move, largest difference over the one-rank move's
    largest element).  ``cut(name, full)`` is the rank's block."""
    d2 = e2 = dmax = emax = 0.0
    for n, m in got.items():
        want = cut(n, solo[n] - p0[n])
        err = m.detach().to(want.device, torch.float32) - cut(n, p0[n]) \
            - want
        d2 += float(want.square().sum())
        e2 += float(err.square().sum())
        dmax = max(dmax, float(want.abs().max()))
        emax = max(emax, float(err.abs().max()))
    return (e2 / d2) ** 0.5, emax / dmax


def rank21c(rank):
    """ZeRO at R 2 (gpt2s width, 2 layers, B 8, L 1024): stages 1-3 and
    offload against the one-rank step on the whole batch (losses, and the
    move of the fp32 weights on this rank's blocks) and against a
    one-rank step on this rank's rows alone (what a step that left out
    the gradient reduction would make), each stage's state by
    ``MemoryLedger`` census, a found_inf step, and BERT-base DP (2
    layers, fused LN on)."""
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.distributed.sharding_rules import (local_shard,
                                                             spec_shards)
    from paddle_tpu_torch.distributed.zero import (make_zero_train_step,
                                                   per_device_state_bytes,
                                                   zero_state_specs)
    from paddle_tpu_torch.models.bert import (BertModel, bert_preset,
                                              make_bert_train_step)
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry_memory import MemoryLedger

    cfg = gpt_preset("gpt2-small", num_layers=2, **DP_WIDTH)
    B, L = 8, 1024
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    y = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, L))).cuda()
    own = slice(rank * B // 2, (rank + 1) * B // 2)

    def model():
        return GPTModel(cfg, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))

    def curve(step, state, a=x, b=y, n=3):
        losses, t0 = [], None
        for i in range(n):
            if i == 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            state, loss = step(state, i, 3e-4, a, b)
            losses.append(loss.item())
        return losses, 1e3 * (time.perf_counter() - t0) / (n - 1), state

    def one_rank(a=x, b=y):
        """The one-rank step: (its curve, its weights after it)."""
        c, _, st = curve(*make_gpt_train_step(
            model(), AdamW(3e-4, weight_decay=0.01), None, remat=False),
            a=a, b=b)
        return c, {n: t.detach().clone() for n, t in st["params"].items()}

    p0 = {n: p.detach().float() for n, p in model().named_parameters()}
    out = {"curves": {}, "ms": {}, "bytes": {}, "census": {}, "delta": {}}
    solo, solo_m = one_rank()
    out["curves"]["one rank"] = solo
    _, fault_m = one_rank(x[own], y[own])
    out["delta"]["own rows only"] = delta_errors(fault_m, p0, solo_m,
                                                 lambda n, t: t)
    del fault_m
    hcg = fleet_hcg(sharding_degree=2)
    zero_counts()
    for stage in (1, 2, 3):
        m = model()
        step, state = make_gpt_train_step(
            m, AdamW(3e-4, weight_decay=0.01), hcg, remat=False,
            zero_stage=stage)
        key = f"stage {stage}"
        out["bytes"][key] = per_device_state_bytes(state)
        mem = MemoryLedger()
        mem.register_tree("optimizer_state", {"slots": state["opt"]["slots"],
                                              "master": state["master"]},
                          name="zero")
        out["census"][key] = int(mem.census()["pools"]["optimizer_state"])
        p_specs, s_specs = zero_state_specs(dict(m.named_parameters()),
                                            hcg.mesh, m, stage)
        specs = {**p_specs, **{n: s_specs[n] for n in state["master"]}}
        c, ms, state = curve(step, state)
        out["curves"][key], out["ms"][key] = c, ms
        out["delta"][key] = delta_errors(
            weights(state), p0, solo_m,
            lambda n, t: (local_shard(t, specs[n], hcg.mesh)
                          if spec_shards(specs[n], hcg.mesh) else t))
        del step, state, m, mem
    m = model()
    step, state = make_zero_train_step(gpt_loss(m), dict(m.named_parameters()),
                                       AdamW(3e-4, weight_decay=0.01),
                                       hcg.mesh, layer=m, offload=True)
    slots = [v for s in state["opt"]["slots"].values() for v in s.values()]
    out["offload_host"] = all(v.device.type == "cpu" and v.is_pinned()
                              for v in slots + list(state["master"].values()))
    out["bytes"]["offload"] = per_device_state_bytes(state)
    c, ms, state = curve(lambda st, k, lr, a, b: step(st, lr, k, a, b), state)
    out["curves"]["offload"], out["ms"]["offload"] = c, ms
    out["offload_host_after"] = all(v.is_pinned() for s in state["opt"][
        "slots"].values() for v in s.values())
    out["delta"]["offload"] = delta_errors(weights(state), p0, solo_m,
                                           lambda n, t: t)
    del step, state, m, solo_m, p0
    out["gpt_launches"] = flash_counts()

    # found_inf: an inf reaches one element of blocks_fc1_w's gradient on
    # rank 0 only, which stage 2's reduce-scatter leaves in rank 0's block:
    # rank 1's own shards stay finite, and only found_inf's MAX over the
    # ranks makes it skip
    m = model()
    base = gpt_loss(m)

    def poisoned(params, key, a, b, poison):
        w = params["blocks_fc1_w"]
        return base(params, key, a, b) + poison.sum() * w[(0,) * w.dim()]

    step, state = make_zero_train_step(
        poisoned, dict(m.named_parameters()), AdamW(3e-4), hcg.mesh, layer=m,
        zero_stage=2, dynamic_loss_scale=True, init_loss_scale=1024.0)
    before = m.blocks_fc1_w.detach().clone()
    bad = torch.zeros(B, device="cuda")
    bad[0] = float("inf")
    state, _ = step(state, 3e-4, 0, x, y, bad)
    sc = state["scaler"]
    out["found_inf"] = dict(found=bool(sc["found_inf"]),
                            scale=float(sc["scale"]),
                            step=int(state["opt"]["step"]),
                            unchanged=bool(torch.equal(m.blocks_fc1_w,
                                                       before)))
    state, _ = step(state, 3e-4, 1, x, y, torch.zeros(B, device="cuda"))
    out["found_inf"]["then"] = (bool(state["scaler"]["found_inf"]),
                                int(state["opt"]["step"]),
                                not torch.equal(m.blocks_fc1_w, before))
    del step, state, m
    gc.collect()
    torch.cuda.empty_cache()

    # BERT-base DP, 2 layers, fused LN on: B 8 (4 a rank), L 512
    set_flags({"FLAGS_use_fused_ln": True})
    bcfg = bert_preset("bert-base", num_hidden_layers=2, vocab_size=30528,
                       compute_dtype="bfloat16")
    brng = np.random.RandomState(2)
    mlm = brng.randint(0, bcfg.vocab_size, (8, 512))
    mlm[brng.rand(8, 512) < 0.85] = -100
    batch = [torch.from_numpy(a).cuda() for a in (
        brng.randint(0, bcfg.vocab_size, (8, 512)), mlm,
        brng.randint(0, 2, (8,)))]
    bert = {}
    for name, h in (("one rank", None), ("dp 2", fleet_hcg(dp_degree=2))):
        bm = BertModel(bcfg, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(0))
        step, state = make_bert_train_step(
            bm, AdamW(1e-4, weight_decay=0.01), h, remat=False)
        if h is not None:
            zero_counts()
        losses = []
        for _ in range(3):
            state, loss = step(state, 1e-4, *batch)
            losses.append(loss.item())
        bert[name] = losses
        del bm, step, state
    out["bert"] = bert
    out["bert_launches"] = flash_counts()
    set_flags({"FLAGS_use_fused_ln": False})
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase21_rank(rank, tmp, card):
    """One of phase 21's two ranks (a spawned process): 21b, 21c and the
    21d readings over gloo, results pickled for the parent."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=2,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase21: a rank imported jax")
    t0 = time.perf_counter()
    out = {"b": rank21b(rank, card)}
    out["b_s"] = time.perf_counter() - t0
    out["c"] = rank21c(rank)
    out["staging"] = dict(collective.HOST_STAGING)
    out["s"] = time.perf_counter() - t0
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase21(card):
    """Data parallelism on the card: 21a in this process over NCCL at world
    size 1, then 21b-21d in one spawn of two ranks that share the card over
    gloo.  Returns the launches of (flash_fwd, dq, dkv, ln_fwd, ln_bwd)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    a_launches, _ = phase21a(card)
    gc.collect()
    torch.cuda.empty_cache()
    say("phase21b-d: two ranks share this one card over gloo (NCCL refuses "
        "two ranks on one device); gloo's hops go through the host, so the "
        "times below are not NCCL's")
    tmp = tempfile.mkdtemp(prefix="phase21_")
    mp.start_processes(phase21_rank, args=(tmp, card), nprocs=2, join=True,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    # 21b: the weight-update sharding A/B
    b = [rk["b"] for rk in ranks]
    rep, sh = b[0]["replicated"], b[0]["sharded"]
    red = rep["opt_bytes"] / sh["opt_bytes"]
    mred = rep["measured"] / max(sh["measured"], 1)
    say(f"phase21b bench_gpt_weight_update_sharding at R 2 (gpt2s 12 layers, "
        f"B 16 as 8 a rank, L 1024, bf16, gloo) on {card}: replicated "
        f"{rep['ms']:.3f} ms/step, update-sharded {sh['ms']:.3f} ms/step "
        f"(rank 0; rank 1 {b[1]['replicated']['ms']:.3f} / "
        f"{b[1]['sharded']['ms']:.3f}); opt-state bytes a replica "
        f"{rep['opt_bytes']} -> {sh['opt_bytes']} ({red:.3f}x analytic), "
        f"MemoryLedger census {rep['measured']} -> {sh['measured']} "
        f"({mred:.3f}x measured); final losses {rep['loss']:.6f} / "
        f"{sh['loss']:.6f}; wire_bytes (fp32) {sh['wire']}")
    for r, br in enumerate(b):
        check(br["replicated"]["opt_bytes"] / br["sharded"]["opt_bytes"]
              >= 1.8 and br["replicated"]["measured"]
              / max(br["sharded"]["measured"], 1) >= 1.8,
              f"phase21b rank {r}: opt-state cut under 1.8x: {br}")
        check(np.isclose(br["sharded"]["loss"], br["replicated"]["loss"],
                         rtol=1e-4, atol=1e-6),
              f"phase21b rank {r}: loss parity {br['replicated']['loss']} vs "
              f"{br['sharded']['loss']}")

    # 21c: ZeRO stages, offload, found_inf, BERT DP
    c = [rk["c"] for rk in ranks]
    solo = c[0]["curves"]["one rank"]
    arms = ("stage 1", "stage 2", "stage 3", "offload")
    for r, cr in enumerate(c):
        for name, cv in cr["curves"].items():
            rel = max(abs(p - q) / abs(q) for p, q in zip(cv, solo))
            check(np.isfinite(cv).all() and rel <= BF16_RTOL,
                  f"phase21c rank {r} {name}: {cv} vs one rank {solo}")
        for name in arms:
            check(cr["delta"][name][0] <= DELTA_TOL,
                  f"phase21c rank {r} {name}: the weights' move "
                  f"{cr['delta'][name]} from one rank's (tol {DELTA_TOL})")
        check(cr["delta"]["own rows only"][0] > DELTA_TOL,
              f"phase21c rank {r}: a step on the rank's own rows reads "
              f"{cr['delta']['own rows only']}, inside the limit "
              f"{DELTA_TOL}: the check cannot see a missing reduction")
        for name in arms[:3]:
            check(cr["census"][name] == cr["bytes"][name],
                  f"phase21c rank {r} {name}: MemoryLedger census "
                  f"{cr['census'][name]} != per_device_state_bytes "
                  f"{cr['bytes'][name]}")
        check(cr["offload_host"] and cr["offload_host_after"],
              f"phase21c rank {r}: offload state not on pinned host memory")
        fi = cr["found_inf"]
        check(fi["found"] and fi["scale"] == 512.0 and fi["step"] == 0
              and fi["unchanged"] and fi["then"] == (False, 1, True),
              f"phase21c rank {r}: found_inf step {fi}")
        brel = max(abs(p - q) / abs(q) for p, q in
                   zip(cr["bert"]["dp 2"], cr["bert"]["one rank"]))
        check(brel <= BF16_RTOL, f"phase21c rank {r}: BERT dp 2 "
                                 f"{cr['bert']} ({brel})")
    say(f"phase21c ZeRO at R 2 (gpt2s width, 2 layers, B 8 as 4 a rank, L "
        f"1024, bf16, gloo) on {card}: one-rank losses "
        f"{[round(v, 4) for v in solo]}; " + "; ".join(
            f"{k} {[round(v, 4) for v in c[0]['curves'][k]]} "
            f"{c[0]['ms'][k]:.3f} ms/step, {c[0]['bytes'][k]} state bytes a "
            f"rank" + (f" (MemoryLedger census {c[0]['census'][k]})"
                       if k in c[0]["census"] else " (host)")
            for k in arms)
        + f" (losses within {BF16_RTOL} relative); the fp32 weights' move "
        f"on each rank's blocks against one rank's, by norm / by largest "
        f"element: " + ", ".join(
            f"{k} " + " and ".join(f"{cr['delta'][k][0]:.3e} / "
                                   f"{cr['delta'][k][1]:.3e}" for cr in c)
            for k in arms + ("own rows only",))
        + f" (limit {DELTA_TOL} by norm; 'own rows only' is a one-rank step "
        f"on the rank's 4 rows, the move a step without the gradient "
        f"reduction makes); offload slots and masters on pinned "
        f"host memory; found_inf: an inf in rank 0's block of one "
        f"reduce-scattered gradient skipped the step on both ranks through "
        f"the MAX over the ranks (scale 1024 -> "
        f"{c[0]['found_inf']['scale']}, step counter "
        f"{c[0]['found_inf']['step']}, parameters unchanged), the next step "
        f"applied; BERT-base 2 layers fused LN dp 2 losses "
        f"{[round(v, 4) for v in c[0]['bert']['dp 2']]} vs one rank "
        f"{[round(v, 4) for v in c[0]['bert']['one rank']]}")

    # 21d: multi-rank telemetry over 21b's sharded arm
    mon, led = ranks[0]["b"]["monitor"], ranks[0]["b"]["ledger"]
    tokens = sum(rk["b"]["local_tokens"] for rk in ranks)
    check(mon["world"] == 2 and mon["steps"] == 6
          and mon["tokens"] == tokens == 3 * 16 * 1024
          and mon["straggler_skew"] >= 1.0,
          f"phase21d: monitor aggregate {mon} (tokens {tokens})")
    check(led["world"] == 2 and abs(led["straggler_skew"]["host_dispatch"]
                                    - mon["straggler_skew"]) < 1e-9,
          f"phase21d: ledger aggregate {led} vs {mon}")
    say(f"phase21d TrainMonitor.aggregate over 21b's sharded arm on {card}: "
        f"world {mon['world']}, steps {mon['steps']:.0f}, tokens "
        f"{mon['tokens']:.0f}, global {mon['global_tokens_per_sec']:.1f} "
        f"tokens/s (host dispatch), straggler skew "
        f"{mon['straggler_skew']:.4f}; RunLedger.aggregate world "
        f"{led['world']}, host_dispatch skew "
        f"{led['straggler_skew']['host_dispatch']:.4f}, goodput "
        f"{led['goodput']:.4f}")

    launches = [a + sum(rk["c"]["gpt_launches"][i] + rk["c"]["bert_launches"]
                        [i] for rk in ranks)
                for i, a in enumerate(a_launches + [0, 0])]
    # the 21c GPT arms (stages 1-3 and offload: 3 steps each) and BERT dp 2
    # (3 steps), 2 layers, per rank
    want_flash = 12 * 12 * 3 + 2 * (4 * 3 * 2 + 3 * 2)
    check(launches[:3] == [want_flash] * 3 and launches[3:] == [2 * 3 * 4] * 2,
          f"phase21: launches {launches}")
    staged = ranks[0]["staging"]
    say(f"phase21 took {time.perf_counter() - t0:.1f} s on {card} (the ranks "
        f"{ranks[0]['s']:.1f} s, 21b {ranks[0]['b_s']:.1f} s of it); gloo's "
        f"pinned host copies on rank 0: {staged['copies']} "
        f"({staged['bytes'] / 2**30:.3f} GiB); launches flash fwd/dq/dkv "
        f"{launches[:3]}, fused LN fwd/bwd {launches[3:]}")
    return launches


# ------------------------------------------------------------ phase 22 --

# bench_gpt_train_resilience's accelerator branch (bench.py:1448-1456),
# its 12 layers cut to 2 to make room for phase 25 (the whole cell ran
# ~105 s of phase 22's 215.9 s on an H100)
RESIL_CFG = dict(vocab_size=50304, max_position_embeddings=1024,
                 compute_dtype="bfloat16", num_layers=2)
RESIL_B, RESIL_L = 16, 1024
NUM_STEPS, SAVE_EVERY, FAIL_AT, PREEMPT_AT = 24, 6, 9, 15
RESIL_KEY = np.array([0, 0], np.uint32)        # jax.random.PRNGKey(0)'s data
RESCALE_LAYERS, RESCALE_B, RESCALE_L = 2, 8, 1024    # 21c's depth cut
LAUNCH_LAYERS, LAUNCH_B, LAUNCH_L = 2, 4, 256
LAUNCH_TIMEOUT = 300                   # each of 22c's launches, seconds


def counted_step(step, calls):
    """``step`` counting its calls in ``calls[0]``."""
    def run(*args):
        calls[0] += 1
        return step(*args)
    return run


def phase22a(card, root):
    """``bench_gpt_train_resilience`` at full width: the oracle, the
    supervisor-off run, the chaos run preempted at step 15 and its resume.
    Returns (flash launches, the record)."""
    import shutil

    from paddle_tpu_torch.faults import (Fault, FaultInjectionError,
                                         FaultPlan)
    from paddle_tpu_torch.jit.functional import fold_in_step_key
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.telemetry import Tracer
    from paddle_tpu_torch.train_resilience import (CheckpointManager,
                                                   PreemptionGuard,
                                                   ResumableIterator,
                                                   TrainSupervisor)

    cfg = gpt_preset("gpt2-small", **RESIL_CFG)
    B, L = RESIL_B, RESIL_L
    rng = np.random.RandomState(0)
    batches = [(torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                             (B, L))).cuda(),
                torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                             (B, L))).cuda())
               for _ in range(8)]
    lr = 3e-4
    calls = [0]

    def build():
        model = GPTModel(cfg, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
        step, state = make_gpt_train_step(model, AdamW(3e-4), remat=False)
        return model, counted_step(step, calls), state

    def supervised(path, plan=None, preempt_at=None):
        model, step, state = build()
        guard = PreemptionGuard() if preempt_at is not None else None
        boundary = (lambda t, sup: sup.guard.request()
                    if t == preempt_at else None) if preempt_at else None
        sup = TrainSupervisor(
            step, state, CheckpointManager(path, tracer=Tracer(),
                                           fault_plan=plan),
            base_key=RESIL_KEY, lr=lr, data=ResumableIterator(batches),
            save_every=SAVE_EVERY, backoff_s=0.0, guard=guard,
            fault_plan=plan, on_boundary=boundary)
        return model, sup, sup.run(NUM_STEPS)

    say(f"phase22a free disk under {root}: "
        f"{shutil.disk_usage(root).free / 2**30:.1f} GiB")
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, sup, oracle = supervised(f"{root}/oracle")
    torch.cuda.synchronize()
    oracle_wall = time.perf_counter() - t0
    check(oracle["completed"] and len(oracle["losses"]) == NUM_STEPS,
          f"phase22a: the oracle did not complete: {oracle}")
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    parts = dict(sup.manager.last_save)
    state_bytes = sum(int(t.numel()) * t.element_size() for t in
                      [*sup.state["params"].values()]
                      + [v for s in sup.state["opt"]["slots"].values()
                         for v in s.values()])
    del model, sup
    shutil.rmtree(f"{root}/oracle")
    gc.collect()
    torch.cuda.empty_cache()

    # supervisor OFF: the crash plan is fatal at its first fault
    plan_off = FaultPlan([Fault("alloc_fail", at_s=FAIL_AT, count=1)], seed=7)
    model, step, state = build()
    data = ResumableIterator(batches)
    off_steps, off_died = 0, None
    try:
        for t in range(NUM_STEPS):
            for f in plan_off.faults:
                if f.active(float(t)) and f.kind == "alloc_fail":
                    raise MemoryError(f"injected alloc_fail (step {t})")
            state, _loss = step(state, fold_in_step_key(RESIL_KEY, t), lr,
                                *data.next_batch())
            off_steps = t + 1
    except (MemoryError, FaultInjectionError) as e:
        off_died = type(e).__name__
    check(off_died == "MemoryError" and off_steps == FAIL_AT,
          f"phase22a: supervisor off died {off_died} after {off_steps}")
    del model, step, state
    gc.collect()
    torch.cuda.empty_cache()

    # supervisor ON: the crash plan + a torn write + a preemption
    plan = FaultPlan([Fault("alloc_fail", at_s=FAIL_AT, count=1),
                      Fault("torn_write", at_s=1, count=1)], seed=7)
    chaos = f"{root}/chaos"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sup1, phase1 = supervised(chaos, plan=plan, preempt_at=PREEMPT_AT)
    check(phase1["preempted"] and phase1["final_step"] == PREEMPT_AT,
          f"phase22a: the chaos run was not preempted at {PREEMPT_AT}: "
          f"{phase1}")
    events1 = sup1.tracer.events("train_resilience")
    skips = dict(sup1.manager.skips)
    snap1 = sup1.train_snapshot()
    del sup1
    gc.collect()
    model, sup2, phase2 = supervised(chaos)
    torch.cuda.synchronize()
    chaos_wall = time.perf_counter() - t0
    launches = flash_counts()[:3]
    check(phase2["completed"] and phase2["first_step"] == PREEMPT_AT,
          f"phase22a: the resume did not complete from {PREEMPT_AT}: "
          f"{phase2}")
    resumed = phase1["losses"] + phase2["losses"]
    check(resumed == oracle["losses"],
          f"phase22a: the resumed trajectory is not the oracle's: "
          f"{resumed} vs {oracle['losses']}")
    torn = [e["step"] for e in events1 if e["what"] == "fault_inject"
            and e.get("fault") == "torn_write"]
    restored = [e["step"] for e in events1 + sup2.tracer.events(
        "train_resilience") if e["what"] == "restore"]
    check(skips.get("uncommitted", 0) >= 1 and len(torn) == 1
          and torn[0] not in restored,
          f"phase22a: torn step {torn}, skips {skips}, restores {restored}")
    same = [n for n, p in model.named_parameters()
            if not torch.equal(p.detach(), want[n])]
    check(not same, f"phase22a: parameters differ from the oracle's: {same}")
    check(launches == [cfg.num_layers * calls[0]] * 3,
          f"phase22a: flash launches {launches} != {cfg.num_layers} x "
          f"{calls[0]} steps")
    replayed = phase1["steps_replayed"] + phase2["steps_replayed"]
    record = {
        "supervisor_off": {"completed": False, "died": off_died,
                           "steps_done": off_steps},
        "supervisor_on": {
            "completed": True,
            "restarts": phase1["restarts"] + phase2["restarts"],
            "steps_replayed": replayed,
            "recovery_time_s": phase1["recovery_time_s"]
            + phase2["recovery_time_s"],
            "corrupt_skips": skips,
            "saves_committed": snap1["saves_committed"],
            "saves_abandoned": snap1["saves_abandoned"],
            "final_loss_delta": abs(phase2["final_loss"]
                                    - oracle["final_loss"]),
            "goodput": NUM_STEPS / (NUM_STEPS + replayed),
            "wall_overhead_x": chaos_wall / oracle_wall},
        "tokens_per_sec": B * L * NUM_STEPS / chaos_wall,
        "oracle_wall_s": oracle_wall, "chaos_wall_s": chaos_wall,
        "save": parts, "state_bytes": state_bytes, "steps": calls[0]}
    say(f"phase22a bench_gpt_train_resilience (gpt2s {cfg.num_layers} "
        f"layers, B {B}, L "
        f"{L}, bf16, fp32 params, AdamW; {NUM_STEPS} steps, save every "
        f"{SAVE_EVERY}, alloc_fail at {FAIL_AT}, torn write of save 1, "
        f"preempted at {PREEMPT_AT}) on {card}: resumed losses equal the "
        f"oracle's bit for bit ({[round(v, 4) for v in resumed]}), the "
        f"parameters too; record {json.dumps(record)}")
    say(f"phase22a one save of the {state_bytes} bytes of state "
        f"({parts['bytes']} on disk) on {card}: snapshot "
        f"{parts['snapshot_s']:.3f} s, write {parts['write_s']:.3f} s, fsync "
        f"{parts['fsync_s']:.3f} s, digest {parts['digest_s']:.3f} s, commit "
        f"{parts['commit_s']:.3f} s; {calls[0]} steps ran in all, flash "
        f"launches fwd/dq/dkv {launches}")
    del model, sup2
    shutil.rmtree(chaos)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, record


def rescale_gpt(hcg):
    """The 2-layer ZeRO-2 GPT step of 22b, its state and checkpoint
    layout (one rank with ``hcg`` None)."""
    from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                             make_gpt_train_step)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = gpt_preset("gpt2-small", num_layers=RESCALE_LAYERS, **DP_WIDTH)
    model = GPTModel(cfg, device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))
    step, state = make_gpt_train_step(model, AdamW(3e-4, weight_decay=0.01),
                                      hcg, remat=False, zero_stage=2)
    return step, state, step.layout


def rank22b(rank, tmp):
    """One of 22b's two ranks: the 2-rank and 1-rank ZeRO-2 runs, each
    saved after 2 steps and continued 3, and the four resumes."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.distributed.collective import barrier

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=2,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase22b: a rank imported jax")
    hcg = fleet_hcg(sharding_degree=2)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randint(0, 50304, (RESCALE_B,
                                                RESCALE_L))).cuda()
    y = torch.from_numpy(rng.randint(0, 50304, (RESCALE_B,
                                                RESCALE_L))).cuda()

    def steps(step, state, n):
        out = []
        for i in range(n):
            state, loss = step(state, 0, 3e-4, x, y)
            out.append(loss.item())
        return state, out

    def resumed(src, group):
        step, state, layout = rescale_gpt(group)
        state = ckpt.load(f"{tmp}/{src}", target=state, shardings=layout)
        return steps(step, state, 3)[1]

    zero_counts()
    out, t0 = {}, time.perf_counter()
    step, state, layout = rescale_gpt(hcg)
    state, _ = steps(step, state, 2)
    ts = time.perf_counter()
    ckpt.save(state, f"{tmp}/two", shardings=layout)
    out["save_s"] = time.perf_counter() - ts
    barrier()
    flat = ckpt._flatten(layout.specs, spec_leaves=True)
    out["sharded"] = {k for k, s in flat.items()
                      if any(e is not None for e in s)}
    out["files"] = {k: [c["file"].rsplit(".", 2)[1] for c in e["chunks"]]
                    for k, e in ckpt._merged_manifest(
                        f"{tmp}/two")["leaves"].items()
                    if e["kind"] == "array"}
    _, out["two"] = steps(step, state, 3)
    del step, state
    out["two_two"] = resumed("two", hcg)
    if rank == 0:
        step, state, layout = rescale_gpt(None)
        state, _ = steps(step, state, 2)
        ckpt.save(state, f"{tmp}/one", shardings=layout, process_index=0)
        _, out["one"] = steps(step, state, 3)
        del step, state
        out["one_one"] = resumed("one", None)
        out["two_one"] = resumed("two", None)
    barrier()
    out["one_two"] = resumed("one", hcg)
    out["bytes"] = ckpt.rank_bytes(f"{tmp}/two")
    out["launches"] = flash_counts()[:3]
    out["s"] = time.perf_counter() - t0
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase22b(card, root):
    """The elastic rescale on two gloo ranks sharing the card.  Returns
    both ranks' flash launches, summed."""
    import pickle

    import torch.multiprocessing as mp

    tmp = f"{root}/rescale"
    Path(tmp).mkdir()
    mp.start_processes(rank22b, args=(tmp,), nprocs=2, join=True,
                       start_method="spawn")
    ranks = []
    for r in range(2):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    r0, r1 = ranks
    check(r0["two_two"] == r0["two"] and r1["two_two"] == r1["two"]
          and r0["two"] == r1["two"] and r0["one_one"] == r0["one"],
          f"phase22b: a same-layout resume differs: {ranks}")
    rel = [max(abs(p - q) / abs(q) for p, q in zip(got, ref))
           for got, ref in ((r0["two_one"], r0["two"]),
                            (r0["one_two"], r0["one"]),
                            (r1["one_two"], r0["one"]))]
    check(max(rel) <= BF16_RTOL,
          f"phase22b: a rescaled resume {rel} from its run (tol {BF16_RTOL})")
    files = r0["files"]
    once = [k for k, v in files.items() if k not in r0["sharded"]
            and v != ["p0"]]
    split = [k for k, v in files.items() if k in r0["sharded"]
             and sorted(v) != ["p0", "p1"]]
    check(not once and not split and r0["bytes"] == r1["bytes"]
          and r0["bytes"][1] < r0["bytes"][0],
          f"phase22b: chunk files {files} (replicated twice {once}, "
          f"sharded not split {split}), bytes {r0['bytes']}")
    launches = [a + b for a, b in zip(r0["launches"], r1["launches"])]
    # steps: rank 0 the 2-rank run (5), 2 -> 2 (3), the 1-rank run (5),
    # 1 -> 1, 2 -> 1 and 1 -> 2 (3 each); rank 1 the 2-rank ones (11)
    want = (RESCALE_LAYERS * 22, RESCALE_LAYERS * 11)
    check(r0["launches"] == [want[0]] * 3 and r1["launches"] == [want[1]] * 3,
          f"phase22b: flash launches rank 0 {r0['launches']}, rank 1 "
          f"{r1['launches']} (want {want[0]} and {want[1]} each)")
    say(f"phase22b elastic rescale (gpt2s width, {RESCALE_LAYERS} layers, "
        f"ZeRO-2, B {RESCALE_B}, L {RESCALE_L}, bf16, two gloo ranks on one "
        f"card) on {card}: saved on 2 ranks after 2 steps, the next 3 "
        f"losses {[round(v, 5) for v in r0['two']]}; resumed on 2 ranks "
        f"equal, on 1 rank {[round(v, 5) for v in r0['two_one']]}; saved "
        f"on 1 rank {[round(v, 5) for v in r0['one']]}, resumed on 1 equal, "
        f"on 2 {[round(v, 5) for v in r0['one_two']]} (within "
        f"{max(rel):.3e} relative, tol {BF16_RTOL}); bytes each rank wrote "
        f"{r0['bytes']} (replicated leaves once, on rank 0; the AdamW "
        f"moments split); the 2-rank save {r0['save_s']:.3f} s on rank 0; "
        f"22b took {r0['s']:.1f} s on rank 0")
    return launches


LAUNCH_TRAINER = '''
import json, os, signal, sys, time
import numpy as np
import torch
from paddle_tpu_torch.distributed import env, fleet
from paddle_tpu_torch.distributed.collective import destroy_process_group
from paddle_tpu_torch.distributed.fleet.elastic import ElasticManager
from paddle_tpu_torch.models.gpt import (GPTModel, gpt_preset,
                                         make_gpt_train_step)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.train_resilience import (CheckpointManager,
                                               ResumableIterator,
                                               TrainSupervisor)

OUT, FLAG = os.environ["REHEARSAL_OUT"], os.environ.get("REHEARSAL_FLAG")
LAYERS, B, L = (int(v) for v in os.environ["REHEARSAL_SHAPE"].split(","))
STEPS, KILL_AT = 6, 5          # save_every 2: the step-4 save has committed
torch.backends.cuda.matmul.allow_tf32 = False
env.init_parallel_env()        # gloo: the launcher's PADDLE_DISTRI_BACKEND
rank = env.get_rank()
assert "jax" not in sys.modules
member = ElasticManager(os.environ["PADDLE_ELASTIC_STORE"], rank=rank,
                        heartbeat_interval=0.2, lease_ttl=30.0).register()
for _ in range(150):           # both ranks' leases through the TCP store
    alive = member.alive_ranks()
    if alive == [0, 1]:
        break
    time.sleep(0.2)
st = fleet.DistributedStrategy()
st.hybrid_configs = {"dp_degree": 1, "sharding_degree": 2}
fleet.init(is_collective=True, strategy=st)
hcg = fleet.get_hybrid_communicate_group()
cfg = gpt_preset("gpt2-small", num_layers=LAYERS, vocab_size=50304,
                 max_position_embeddings=1024, compute_dtype="bfloat16")
model = GPTModel(cfg, device="cuda",
                 generator=torch.Generator("cuda").manual_seed(0))
step, state = make_gpt_train_step(model, AdamW(3e-4), hcg, remat=False,
                                  zero_stage=2)
layout = step.layout
r = np.random.RandomState(0)
data = ResumableIterator([
    (torch.from_numpy(r.randint(0, 50304, (B, L))).cuda(),
     torch.from_numpy(r.randint(0, 50304, (B, L))).cuda())
    for _ in range(4)])


def boundary(t, sup):
    if FLAG and rank == 1 and t == KILL_AT and not os.path.exists(FLAG):
        open(FLAG, "w").close()           # flag first: kill exactly once
        os.kill(os.getpid(), signal.SIGKILL)


sup = TrainSupervisor(step, state, CheckpointManager(OUT + "/ck"),
                      base_key=np.array([0, 0], np.uint32), lr=3e-4,
                      data=data, save_every=2, shardings=layout,
                      on_boundary=boundary)
res = sup.run(STEPS)
member.stop()
with open(f"{OUT}/rank{rank}.jsonl", "a") as f:
    f.write(json.dumps({"first": res["first_step"], "losses": res["losses"],
                        "committed": sup.manager.latest(),
                        "alive": alive}) + "\\n")
destroy_process_group()
'''


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch22c(root, name, kill):
    """Start one launch of 22c's trainer through the port's launcher;
    ``finish22c`` waits for it."""
    import os

    out = Path(root) / name
    out.mkdir()
    (out / "train.py").write_text(LAUNCH_TRAINER)
    env = dict(os.environ, REHEARSAL_OUT=str(out), REHEARSAL_SHAPE=",".join(
        str(v) for v in (LAUNCH_LAYERS, LAUNCH_B, LAUNCH_L)),
        PYTHONPATH=str(Path(__file__).resolve().parent))
    if kill:
        env["REHEARSAL_FLAG"] = str(out / "fault_fired")
    log = open(out / "launcher.err", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc_per_node", "2", "--devices", "0,0", "--backend",
         "gloo", "--master", f"127.0.0.1:{free_port()}",
         "--elastic_level", "1", "--max_restarts", "2",
         "--elastic_store", f"tcp://127.0.0.1:{free_port()}",
         "--log_dir", str(out / "log"), str(out / "train.py")],
        stdout=subprocess.DEVNULL, stderr=log, env=env)
    return name, out, proc, log, time.perf_counter()


def wait22c(started):
    """Wait for ``start22c``'s launches: each one's wall s, by name."""
    walls = {}
    while len(walls) < len(started):
        for name, _, proc, _, t0 in started:
            if name not in walls and proc.poll() is not None:
                walls[name] = time.perf_counter() - t0
        late = [name for name, *_, t0 in started if name not in walls
                and time.perf_counter() - t0 > LAUNCH_TIMEOUT]
        if late:
            fail(f"phase22c: the {late} launch ran past {LAUNCH_TIMEOUT} s")
        time.sleep(0.1)
    return walls


def finish22c(launch, wall):
    """(wall s, the launcher's stderr, each rank's results a run) of a
    launch ``launch22c`` started, ended after ``wall`` s."""
    name, out, proc, log, _ = launch
    log.close()
    err = (out / "launcher.err").read_text()
    if proc.returncode != 0:
        logs = "".join((out / "log" / f"workerlog.{i}").read_text()[-1500:]
                       for i in (1,) if (out / "log" / "workerlog.1").exists())
        fail(f"phase22c: the {name} launch exited {proc.returncode}: "
             f"{err[-3000:]} {logs}")
    runs = []
    for rank in range(2):
        p = out / f"rank{rank}.jsonl"
        runs.append([json.loads(line) for line in p.read_text().splitlines()]
                    if p.exists() else [])
    return wall, err, runs


def start22c(root):
    """Start 22c's two launches side by side (four ranks share the card,
    beside 22b's two): the killed one and the unkilled one."""
    return [launch22c(root, "killed", kill=True),
            launch22c(root, "clean", kill=False)]


def stop22c(started):
    """Kill what is left of 22c's launches (after a failure)."""
    for _, _, proc, log, _ in started:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


def phase22c(card, started):
    """``python -m paddle_tpu_torch.distributed.launch`` over two gloo ranks
    on the card: rank 1 SIGKILLs itself after a committed save, the
    launcher restarts the pod, both ranks resume; against an unkilled
    launch (``start22c``'s two)."""
    walls = wait22c(started)
    (wall_k, err, killed), (wall_c, _, clean) = [
        finish22c(s, walls[s[0]]) for s in started]
    check((started[0][1] / "fault_fired").exists()
          and "elastic restart 1/" in err,
          f"phase22c: no restart after the kill: {err[-2000:]}")
    for rank in range(2):
        check(len(killed[rank]) == 1 and len(clean[rank]) == 1,
              f"phase22c rank {rank}: results {killed[rank]} {clean[rank]}")
        got, whole = killed[rank][0], clean[rank][0]
        check(got["first"] == 4 and whole["first"] == 0
              and got["losses"] == whole["losses"][4:]
              and got["committed"] == whole["committed"] == 6
              and got["alive"] == [0, 1],
              f"phase22c rank {rank}: resumed {got} vs unkilled {whole}")
    say(f"phase22c launcher (--nproc_per_node 2 --devices 0,0 --backend gloo "
        f"--elastic_level 1, the TCP store hosted by the launcher; gpt2s "
        f"width, {LAUNCH_LAYERS} layers, ZeRO-2, B {LAUNCH_B}, L {LAUNCH_L}) "
        f"on {card}: rank 1 SIGKILLed itself after the step-4 commit, the "
        f"pod restarted and resumed at step 4, losses "
        f"{[round(v, 5) for v in killed[0][0]['losses']]} equal to the "
        f"unkilled launch's steps 4-5; killed launch {wall_k:.1f} s, "
        f"unkilled {wall_c:.1f} s, side by side and beside 22b")


def phase22(card):
    """Crash-consistent training on the card (22a-c); the roots are
    removed after.  Returns 22a's and 22b's flash launches."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="phase22_")
    try:
        a_launches, _ = phase22a(card, root)
        gc.collect()
        torch.cuda.empty_cache()
        started = start22c(root)
        try:
            b_launches = phase22b(card, root)
            phase22c(card, started)
        finally:
            stop22c(started)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = [a + b for a, b in zip(a_launches, b_launches)]
    say(f"phase22 took {time.perf_counter() - t0:.1f} s on {card}; flash "
        f"launches fwd/dq/dkv {launches} (22a {a_launches}, 22b's two ranks "
        f"{b_launches})")
    return launches


# ------------------------------------------------------------ phase 23 --

VISION_TOL64 = 1e-8      # card vs CPU in float64 (the CPU tests' tolerance)
LENET_RTOL = 1e-4        # card vs CPU LeNet losses in fp32


def vision_step(model, lr, B, shape, n_classes, dtype, dev):
    """``bench.py``'s ``_vision_step`` on the port: the port's
    ``make_train_step`` with ``F.cross_entropy`` and ``Momentum(lr,
    momentum=0.9, weight_decay=1e-4)``, one batch from seed 0."""
    from paddle_tpu_torch.jit.functional import make_train_step
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    step, state = make_train_step(
        model, lambda out, y: F.cross_entropy(out, y),
        Momentum(learning_rate=lr, momentum=0.9, weight_decay=1e-4))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.standard_normal((B,) + shape)
                         .astype(np.float32)).to(dev, dtype)
    y = torch.from_numpy(rng.randint(0, n_classes, (B,))).to(dev)
    return step, state, x, y


CUDNN_KEYS = ("cudnn", "xmma", "implicit_convolve", "dgrad", "wgrad",
              "gemm", "Nhwc", "Nchw")


def say_library_share(prof, busy_ms, n_steps):
    """The device ms a step in cuDNN's and cuBLAS's kernels (convolutions,
    their layout transposes, the GEMMs) and in the rest (PyTorch's
    elementwise and reduction kernels: BatchNorm, ReLU, the residual
    adds, the loss and the update) of a finished profile."""
    from torch.autograd import DeviceType

    lib = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and any(k in e.key for k in CUDNN_KEYS)) / 1e3 / n_steps
    say(f"  cuDNN/cuBLAS kernels {lib:.3f} ms/step, the rest "
        f"{busy_ms - lib:.3f} ms/step")


# the base of the vision cells' step keys: step t takes fold_in_step_key(
# VISION_KEY, t), so that phase 24's dropouts draw
VISION_KEY = np.array([0, 24], np.uint32)


def vision_cell(label, model, lr, B, shape, n_classes, dtype, warm, iters,
                card, phase="phase23"):
    """One accelerator cell of ``bench_resnet50``/``bench_mnist_lenet``:
    ``warm`` warm-up steps (the first records each conv's output dtype
    and forward FLOPs, for conv1's dtype and the step's bound), a
    2-step device profile, then ``iters`` steps with CUDA events around
    each and one pair around them all: ms/step and imgs/s come from the
    whole window, the p50 and the range from the single steps.  Every
    loss must be finite and every running statistic must have moved from
    its initial value.  Step ``t`` takes the key ``fold_in_step_key(
    VISION_KEY, t)``."""
    from paddle_tpu_torch.jit.functional import fold_in_step_key

    step, state, x, y = vision_step(model, lr, B, shape, n_classes, dtype,
                                    "cuda")
    convs = [m for m in model.modules()
             if type(m).__name__ in ("Conv1D", "Conv2D", "Conv3D")]
    init = {n: b.clone() for n, b in model.named_buffers()}
    dtypes, flops, losses, lr_ = [], {}, [], float(lr)

    def count(mod, inp, out):
        """A conv's dtype and forward FLOPs (2 a multiply-add)."""
        dtypes.append(out.dtype)
        flops[out.dtype] = flops.get(out.dtype, 0) + 2 * out.numel() * \
            mod.weight[0].numel()

    hooks = [m.register_forward_hook(count) for m in convs]
    keys = (fold_in_step_key(VISION_KEY, t)
            for t in range(warm + 2 + iters))
    try:
        state, (loss, out) = step(state, next(keys), lr_, [x], [y])
    finally:
        for h in hooks:
            h.remove()
    # forward, input gradient and weight gradient: 3x the forward's
    bound = sum(3 * f / PEAK_FLOPS[dt] for dt, f in flops.items()) * 1e3
    losses.append(loss)
    for _ in range(warm - 1):
        state, (loss, out) = step(state, next(keys), lr_, [x], [y])
        losses.append(loss)
    prof = start_profile(cpu=False)
    for _ in range(2):
        state, (loss, out) = step(state, next(keys), lr_, [x], [y])
        losses.append(loss)
    busy = report_profile(prof, 2)
    say_library_share(prof, busy, 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = []
    w0, w1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    w0.record()
    for _ in range(iters):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, (loss, out) = step(state, next(keys), lr_, [x], [y])
        e1.record()
        events.append((e0, e1))
        losses.append(loss)
    w1.record()
    torch.cuda.synchronize()
    window = w0.elapsed_time(w1)
    mean, imgs_s = window / iters, 1e3 * B * iters / window
    ms = sorted(a.elapsed_time(b) for a, b in events)
    p50 = float(np.median(ms))
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals = [v.item() for v in losses]
    check(all(np.isfinite(vals)), f"{phase} {label}: non-finite loss in "
          f"{vals}")
    still = [n for n, b in model.named_buffers() if torch.equal(b, init[n])]
    check(not still, f"{phase} {label}: {len(still)} of {len(init)} running "
          f"statistics never moved: {still[:4]}")
    say(f"{phase} {label}: {mean:.3f} ms/step and {imgs_s:.1f} imgs/s over "
        f"the {window:.3f} ms window of {iters} steps after {warm} warm-up "
        f"and 2 profiled (single steps p50 {p50:.3f} ms, range "
        f"{ms[0]:.3f}-{ms[-1]:.3f}), peak memory "
        f"{peak:.3f} GiB; first conv output {dtypes[0]}, logits "
        f"{out.dtype}; the convolutions' 3 x {sum(flops.values()) / 1e9:.3f}"
        f" GFLOP a step bound it at {bound:.3f} ms on the data sheet's dense "
        f"peaks ({mean / bound:.2f}x); {len(init)} running statistics all "
        f"moved; losses "
        f"{[round(v, 4) for v in vals]}; cudnn.allow_tf32 "
        f"{torch.backends.cudnn.allow_tf32}, cudnn.benchmark "
        f"{torch.backends.cudnn.benchmark}; {card}")
    return dict(ms=mean, imgs_s=imgs_s, peak_gib=peak, bound_ms=bound,
                first=dtypes[0], logits=out.dtype)


def vision_card_vs_cpu(build, B, shape, n_classes, dtype, steps, lr=0.1):
    """The same weights trained ``steps`` steps at ``lr`` on the card and
    on the CPU, step ``t`` under the key ``fold_in_step_key(VISION_KEY,
    t)``; returns (card losses, CPU losses, the
    largest ``|card - cpu| / (1 + |cpu|)`` over every parameter and
    running statistic, their count).  The card's build draws the weights;
    the CPU's is built on ``meta`` (no draw: the CPU's threefry over a
    vgg16 takes seconds) and takes the card's."""
    from paddle_tpu_torch.jit.functional import fold_in_step_key
    from paddle_tpu_torch.vision.models import params_from_numpy

    card = build("cuda").to(dtype)
    cpu = params_from_numpy(
        build("meta").to_empty(device="cpu").to(dtype),
        {n: p.detach().cpu().numpy() for n, p in card.named_parameters()},
        {n: b.cpu().numpy() for n, b in card.named_buffers()})
    out = []
    for model, dev in ((card, "cuda"), (cpu, "cpu")):
        step, state, x, y = vision_step(model, lr, B, shape, n_classes,
                                        dtype, dev)
        losses = []
        for t in range(steps):
            state, (loss, _) = step(state, fold_in_step_key(VISION_KEY, t),
                                    lr, [x], [y])
            losses.append(loss.item())
        out.append(losses)
    tensors = [(n, t, dict(cpu.named_parameters())[n])
               for n, t in card.named_parameters()]
    tensors += [(n, t, dict(cpu.named_buffers())[n])
                for n, t in card.named_buffers()]
    worst = max(((a.detach().cpu() - b.detach()).abs()
                 / (1 + b.detach().abs())).max().item()
                for _, a, b in tensors)
    return out[0], out[1], worst, len(tensors)


def phase23(card):
    """Vision training on the card: (a) ``bench_resnet50``'s and (b)
    ``bench_mnist_lenet``'s accelerator cells uncut, (c) card vs CPU."""
    from paddle_tpu_torch.vision.models import LeNet, resnet50

    t0 = time.perf_counter()
    seed_build(0)
    model = resnet50(data_format="NHWC", device="cuda")
    r = vision_cell("(a) resnet50 NHWC B 128 224x224x3 bf16 input, fp32 "
                    "parameters, Momentum 0.1", model, 0.1, 128,
                    (224, 224, 3), 1000, torch.bfloat16, 2, 10, card)
    check(r["first"] == torch.bfloat16 and r["logits"] == torch.float32,
          f"phase23 (a): conv1 {r['first']} and logits {r['logits']}, not "
          f"bf16 and fp32")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    lenet = LeNet(device="cuda")
    vision_cell("(b) LeNet B 512 1x28x28 fp32, Momentum 0.01", lenet, 0.01,
                512, (1, 28, 28), 10, torch.float32, 3, 30, card)
    del lenet
    gc.collect()
    torch.cuda.empty_cache()

    def resnet(dev):
        return resnet50(num_classes=10, data_format="NHWC", device=dev)

    gl, cl, worst, n = vision_card_vs_cpu(resnet, 8, (64, 64, 3), 10,
                                          torch.float64, 1)
    rel = abs(gl[0] - cl[0]) / abs(cl[0])
    say(f"phase23 (c) card vs CPU, resnet50 NHWC 10 classes B 8 64x64 "
        f"float64, 1 step: loss cuda {gl[0]!r} cpu {cl[0]!r} (rel diff "
        f"{rel:.3e}); over {n} parameters and running statistics the "
        f"largest |cuda - cpu| / (1 + |cpu|) is {worst:.3e} (tol "
        f"{VISION_TOL64:g})")
    check(rel <= VISION_TOL64 and worst <= VISION_TOL64,
          f"phase23 (c): resnet50 float64 card vs CPU differ: loss rel "
          f"{rel}, tensors {worst}")
    gl, cl, _, _ = vision_card_vs_cpu(
        lambda dev: LeNet(device=dev), 64, (1, 28, 28), 10, torch.float32, 3)
    rel = max(abs(a - b) / abs(b) for a, b in zip(gl, cl))
    say(f"phase23 (c) card vs CPU, LeNet B 64 fp32, 3 steps: losses cuda "
        f"{[round(v, 6) for v in gl]} cpu {[round(v, 6) for v in cl]}, max "
        f"rel diff {rel:.3e} (tol {LENET_RTOL:g})")
    check(rel <= LENET_RTOL, f"phase23 (c): LeNet losses differ by {rel}")
    say(f"phase23 took {time.perf_counter() - t0:.1f} s on {card}")


# ------------------------------------------------------------ phase 24 --

# (constructor, input side, lr): each family's default (published) widths;
# bench.py's rule for the rate: 0.1 with BatchNorm (its resnet50 cell),
# 0.01 without (its LeNet cell; AlexNet and VGG diverge at 0.1)
FAMILY_CELLS = [("alexnet", 224, 0.01), ("vgg16", 224, 0.01),
                ("squeezenet1_1", 224, 0.01), ("mobilenet_v2", 224, 0.1),
                ("googlenet", 224, 0.1), ("inception_v3", 299, 0.1),
                ("densenet121", 224, 0.1), ("shufflenet_v2_x1_0", 224, 0.1)]
FAMILY_B = 32
MASK_SHAPE, MASK_P, MASK_RATE_TOL = (4096, 4096), 0.5, 1e-3


def phase24_mask(card):
    """(c): one dropout's keep-mask on the card against the CPU's, its
    keep rate, and its time."""
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.nn import functional as F

    key = np.array([0xDEADBEEF, 0x12345678], np.uint32)
    masks = []
    for dev in ("cuda", "cpu"):
        x = torch.ones(MASK_SHAPE, device=dev)
        with rng.rng_scope(key):
            masks.append((F.dropout(x, MASK_P) != 0).cpu())
    same = torch.equal(*masks)
    rate = masks[0].float().mean().item()
    x = torch.ones(MASK_SHAPE, device="cuda")
    with rng.rng_scope(key):
        for _ in range(3):
            F.dropout(x, MASK_P)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(10):
            F.dropout(x, MASK_P)
        e1.record()
        torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / 10
    bound = 2 * 4 * x.numel() / HBM_BYTES_PER_S * 1e3
    verdict = "equals" if same else "DIFFERS FROM"
    say(f"phase24 (c) F.dropout of a {MASK_SHAPE} fp32 tensor at p "
        f"{MASK_P}: the card's keep-mask {verdict} the CPU's bit for bit, "
        f"keep rate {rate:.6f} (1 - p {1 - MASK_P}, tol {MASK_RATE_TOL:g});"
        f" {ms:.3f} ms a call (10 calls, CUDA events; threefry2x32 as plain "
        f"int64 PyTorch ops), {ms / bound:.0f}x the {bound:.4f} ms that "
        f"reading and writing the tensor once would take; {card}")
    check(same, "phase24 (c): the card's dropout mask differs from the CPU's")
    check(abs(rate - (1 - MASK_P)) <= MASK_RATE_TOL,
          f"phase24 (c): keep rate {rate} is not within {MASK_RATE_TOL} of "
          f"{1 - MASK_P}")
    return ms


def phase24(card):
    """The other eight vision families: (a) each at its published width
    on the card, (b) card vs CPU in float64 with dropout drawn, (c) the
    dropout mask on the card."""
    from paddle_tpu_torch.vision import models as tm

    t0 = time.perf_counter()
    cells = {}
    for name, side, lr in FAMILY_CELLS:
        seed_build(0)
        model = getattr(tm, name)(device="cuda")
        cells[name] = vision_cell(
            f"(a) {name} B {FAMILY_B} {side}x{side}x3 fp32, 1000 classes, "
            f"Momentum {lr}, dropout keyed by fold_in_step_key", model, lr,
            FAMILY_B, (3, side, side), 1000, torch.float32, 2, 5, card,
            phase="phase24")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0
    for name, side, lr in FAMILY_CELLS:
        # InceptionV3 at 80x80 ends in 1x1 maps: its last BatchNorms would
        # normalise over the batch's 4 values and amplify the card's and
        # the CPU's float64 reduction orders past the bound; 112x112
        # leaves 2x2 maps (16 values)
        small = 112 if side == 299 else 64

        def build(dev, name=name):
            seed_build(0)
            return getattr(tm, name)(num_classes=10, device=dev)

        gl, cl, worst, n = vision_card_vs_cpu(
            build, 4, (3, small, small), 10, torch.float64, 2, lr=lr)
        rel = max(abs(a - b) / (1 + abs(b)) for a, b in zip(gl, cl))
        say(f"phase24 (b) card vs CPU, {name} 10 classes B 4 "
            f"{small}x{small} float64, lr {lr}, 2 steps, dropout keyed: "
            f"losses cuda "
            f"{gl!r} cpu {cl!r}; the largest |cuda - cpu| / (1 + |cpu|) is "
            f"{rel:.3e} over the losses and {worst:.3e} over {n} parameters "
            f"and running statistics (tol {VISION_TOL64:g})")
        check(rel <= VISION_TOL64 and worst <= VISION_TOL64,
              f"phase24 (b): {name} float64 card vs CPU differ: losses "
              f"{rel}, tensors {worst}")
        gc.collect()
        torch.cuda.empty_cache()
    mask_ms = phase24_mask(card)
    say("phase24 summary (a): " + "; ".join(
        f"{n} {r['ms']:.3f} ms/step {r['imgs_s']:.1f} imgs/s peak "
        f"{r['peak_gib']:.2f} GiB conv bound {r['bound_ms']:.3f} ms "
        f"({r['ms'] / r['bound_ms']:.2f}x)" for n, r in cells.items())
        + f"; dropout mask {mask_ms:.3f} ms; (a) took {t_a:.1f} s; {card}")
    say(f"phase24 took {time.perf_counter() - t0:.1f} s on {card}")


# ------------------------------------------------------------ phase 25 --

TP_ARMS = (("mp 2", {"mp_degree": 2}, None),
           ("sep 2 ring", {"sep_degree": 2}, "ring"),
           ("sep 2 Ulysses", {"sep_degree": 2}, "ulysses"))
TP_B, TP_L, TP_STEPS, TP_LR = 8, 1024, 4, 3e-4


def tp_model(mode=None):
    """gpt2s (12 layers, bf16, fp32 parameters) from seed 0 on the card."""
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset

    cfg = gpt_preset("gpt2-small", sequence_parallel=mode, **DP_WIDTH)
    return GPTModel(cfg, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))


def gpt_preset_layers():
    from paddle_tpu_torch.models.gpt import gpt_preset

    return gpt_preset("gpt2-small", **DP_WIDTH).num_layers


def tp_batch():
    rng = np.random.RandomState(25)
    return [torch.from_numpy(rng.randint(0, DP_WIDTH["vocab_size"],
                                         (TP_B, TP_L))).cuda()
            for _ in range(2)]


def rank25(rank, tmp):
    """One of phase 25's two ranks: each arm's 4 steps (the first a
    warm-up), the time in gloo's collectives apart from the rest, the
    flash launches of the three timed steps and of the warm-up, the bytes
    the state holds, and the weights' move against the one-rank step."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models.gpt import make_gpt_train_step
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=2,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase25: a rank imported jax")
    # gloo sums bf16 all-reduces of CUDA tensors (no cast on the way)
    t = torch.full((5,), 1.0 + 0.5 * rank, dtype=torch.bfloat16,
                   device="cuda")
    C.all_reduce(t)
    out = {"bf16_sum": t.tolist()}
    gloo = [0.0, 0]
    run = C._run

    def timed(name, group, inputs, outputs, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, group, inputs, outputs, fn)
        torch.cuda.synchronize()
        gloo[0] += time.perf_counter() - t0
        gloo[1] += 1

    C._run = timed
    x, y = tp_batch()
    out["layers"] = gpt_preset_layers()
    p0 = torch.load(f"{tmp}/p0.pt")
    solo = torch.load(f"{tmp}/solo.pt")
    for name, hc, mode in TP_ARMS:
        model = tp_model(mode)
        step, state = make_gpt_train_step(model, AdamW(TP_LR),
                                          fleet_hcg(**hc), remat=False)
        mesh = step.layout.mesh
        specs = step.layout.specs["params"]
        staged0 = dict(C.HOST_STAGING)
        zero_counts()
        gloo[:] = [0.0, 0]
        state, loss = step(state, 0, TP_LR, x, y)
        losses = [loss.item()]
        warm = flash_counts()[:3]
        zero_counts()
        gloo[:] = [0.0, 0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, TP_STEPS):
            state, loss = step(state, i, TP_LR, x, y)
            losses.append(loss.item())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = TP_STEPS - 1
        got = {k: v for k, v in state["params"].items()}
        move = delta_errors(got, p0, solo, lambda k, full: local_shard(
            full.cuda(), specs[k], mesh))
        out[name] = dict(
            losses=losses, ms=1e3 * wall / n, gloo_ms=1e3 * gloo[0] / n,
            calls=gloo[1] / n, launches=flash_counts()[:3], warm=warm,
            param_bytes=sum(v.numel() * v.element_size()
                            for v in state["params"].values()),
            slot_bytes=per_device_state_bytes(state), move=move,
            staged={k: C.HOST_STAGING[k] - staged0[k] for k in staged0},
            split=sorted(k for k, s in specs.items() if any(
                e is not None for e in s)))
        del model, step, state, got, loss
        gc.collect()
        torch.cuda.empty_cache()
    C._run = run
    with open(f"{tmp}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase25_flash(card):
    """B2-B4 at the arms' shape (nh/2 = 6 heads of a rank: mp's heads,
    and Ulysses' over the whole sequence) against their plain versions."""
    from paddle_tpu_torch.ops import attention as A

    dt, causal, D = torch.bfloat16, True, 64
    q, k, v, do, km = flash_inputs(TP_B, TP_L, 6, D, dt, False, seed=25)
    scale = 1.0 / D ** 0.5
    qk = [t.clone().requires_grad_() for t in (q, k, v)]
    out = A._FlashAttention.apply(*qk, km, FLASH_SEED, causal, scale, 0.0)
    grads = torch.autograd.grad(out, qk, do)
    qp = [t.clone().requires_grad_() for t in (q, k, v)]
    out_p, _ = A.flash_fwd_ref(*qp, km, FLASH_SEED, causal, scale, 0.0)
    grads_p = torch.autograd.grad(out_p, qp, do)
    torch.cuda.synchronize()
    err = (out.float() - out_p.float()).abs().max().item()
    gerr = [rel_err(a, b) for a, b in zip(grads, grads_p)]
    check(err <= TOL[dt] and max(gerr) <= GRAD_TOL[dt],
          f"phase25 flash at B {TP_B}, L {TP_L}, 6 heads: O err {err}, "
          f"grads {gerr}")
    say(f"phase25 flash kernels at a rank's shape (B {TP_B}, L {TP_L}, 6 "
        f"heads, hd 64, bf16, causal) on {card}: O max abs err {err:.3e} "
        f"(tol {TOL[dt]}), dq/dk/dv err / max|grad| "
        + "/".join(f"{e:.3e}" for e in gerr) + f" (tol {GRAD_TOL[dt]})")


def phase25(card):
    """Tensor and sequence parallelism at gpt2s width (12 layers, B 8, L
    1024, bf16): the one-rank step here, then mp 2, sep 2 ring and sep 2
    Ulysses on two gloo ranks sharing the card, 4 steps each, held
    against it.  Returns the ranks' flash launches (fwd, dq, dkv)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models.gpt import make_gpt_train_step
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    phase25_flash(card)
    tmp = tempfile.mkdtemp(prefix="phase25_")
    model = tp_model()
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               f"{tmp}/p0.pt")
    step, state = make_gpt_train_step(model, AdamW(TP_LR), remat=False)
    x, y = tp_batch()
    solo = []
    for i in range(TP_STEPS):
        state, loss = step(state, i, TP_LR, x, y)
        solo.append(loss.item())
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    solo_ms = 1e3 * (time.perf_counter() - t1) / (TP_STEPS - 1)
    solo_sizes = {n: p.numel() * p.element_size()
                  for n, p in state["params"].items()}
    solo_params = sum(solo_sizes.values())
    solo_slots = per_device_state_bytes(state)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               f"{tmp}/solo.pt")
    del model, step, state, loss
    gc.collect()
    torch.cuda.empty_cache()
    say("phase25: two ranks share this one card over gloo (NCCL refuses two "
        "ranks on one device, so NCCL's arm of the new collectives cannot "
        "run here); every hop goes through the host")
    t_ranks = time.perf_counter()
    mp.start_processes(rank25, args=(tmp,), nprocs=2, join=True,
                       start_method="spawn")
    t_ranks = time.perf_counter() - t_ranks
    ranks = []
    for r in range(2):
        with open(f"{tmp}/rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    for r, rk in enumerate(ranks):
        check(rk["bf16_sum"] == [2.5] * 5,
              f"phase25 rank {r}: gloo's bf16 all-reduce gave "
              f"{rk['bf16_sum']}, not 1.0 + 1.5")
    launches = [0, 0, 0]
    for name, hc, mode in TP_ARMS:
        flash = mode != "ring"          # ring's blocks are plain PyTorch
        for r, rk in enumerate(ranks):
            a = rk[name]
            rel = a["rel"] = max(abs(p - q) / abs(q)
                                 for p, q in zip(a["losses"], solo))
            check(np.isfinite(a["losses"]).all() and rel <= BF16_RTOL,
                  f"phase25 {name} rank {r}: losses {a['losses']} vs one "
                  f"rank {solo} ({rel:.3e} > {BF16_RTOL})")
            check(a["move"][0] <= DELTA_TOL,
                  f"phase25 {name} rank {r}: the weights' move {a['move']} "
                  f"from one rank's (tol {DELTA_TOL})")
            nl = rk["layers"]
            want = [nl * (TP_STEPS - 1) if flash else 0] * 3
            check(a["launches"] == want
                  and a["warm"] == [nl if flash else 0] * 3,
                  f"phase25 {name} rank {r}: flash launches {a['launches']} "
                  f"(warm-up {a['warm']}), want {want}")
            launches = [s + u + w for s, u, w in
                        zip(launches, a["launches"], a["warm"])]
        a = ranks[0][name]
        held = sum(b // 2 if n in a["split"] else b
                   for n, b in solo_sizes.items())
        check(a["param_bytes"] == held and a["slot_bytes"] == 2 * held
              and (a["split"] != []) == ("mp_degree" in hc),
              f"phase25 {name}: a rank holds {a['param_bytes']} bytes of "
              f"parameters and {a['slot_bytes']} of slots, want {held} and "
              f"{2 * held} (split {a['split']})")
        say(f"phase25 {name} (gpt2s {ranks[0]['layers']} layers, B {TP_B}, "
            f"L {TP_L}, bf16, AdamW, two gloo ranks) on {card}: losses "
            f"{[round(v, 5) for v in a['losses']]} vs one rank "
            f"{[round(v, 5) for v in solo]} (within {a['rel']:.3e} "
            f"relative, tol {BF16_RTOL}); ms/step rank 0 {a['ms']:.3f} = "
            f"gloo {a['gloo_ms']:.3f} ({a['calls']:.0f} collectives) + "
            f"compute {a['ms'] - a['gloo_ms']:.3f} (rank 1 "
            f"{ranks[1][name]['ms']:.3f} = {ranks[1][name]['gloo_ms']:.3f} "
            f"+ {ranks[1][name]['ms'] - ranks[1][name]['gloo_ms']:.3f}); one "
            f"rank {solo_ms:.3f} ms/step; flash fwd/dq/dkv a rank over 3 "
            f"steps {a['launches']} and {ranks[1][name]['launches']}; bytes a "
            f"rank holds: parameters {a['param_bytes']}, AdamW slots "
            f"{a['slot_bytes']} (one rank {solo_params} and {solo_slots}; "
            f"split {a['split'] or 'none'}); pinned host copies "
            f"{a['staged']['copies']} ({a['staged']['bytes'] / 2**30:.3f} "
            f"GiB); weights' move vs one rank's {a['move'][0]:.3e} by norm")
    say(f"phase25 took {time.perf_counter() - t0:.1f} s on {card} (the ranks "
        f"{t_ranks:.1f} s); flash launches fwd/dq/dkv on the two ranks "
        f"{launches}")
    return launches


# ------------------------------------------------------------ phase 26 --

EP_B, EP_L, EP_STEPS, EP_LR = 8, 512, 3, 1e-4
#: phase 26's arms: (name, world, degrees, kind); the fp32 and BERT arms
#: share the ep 2 arm's two ranks
EP_ARMS = (("ep 2", 2, {"dp_degree": 2}, "ernie"),
           ("ep 2 fp32", 2, {"dp_degree": 2}, "ernie_fp32"),
           ("dp 2 x mp 2", 4, {"dp_degree": 2, "mp_degree": 2}, "ernie"),
           ("bert mp 2", 2, {"mp_degree": 2}, "bert"))
#: the fp32 arm: ERNIE-MoE at bench width cut to 2 layers, held as phase
#: 19 holds card against CPU (ERNIE_LOSS_TOL, root flips under ROUTE_TIE)
EP_FP32 = dict(num_layers=2, compute_dtype="float32")
ERNIE_C = 1280      # ceil(2 x 4096 / 8 x 1.25), rounded up to a multiple of 4
BERT_TP = dict(vocab_size=30528, hidden_size=768, num_hidden_layers=12,
               num_attention_heads=12, max_position_embeddings=512,
               compute_dtype="bfloat16")


def ep_batch():
    """``bench_ernie_moe``'s batch shape (B 8, L 512) from RandomState(26)."""
    rng = np.random.RandomState(26)
    return [torch.from_numpy(rng.randint(0, ERNIE_BENCH["vocab_size"],
                                         (EP_B, EP_L))).cuda()
            for _ in range(2)]


def bert_tp_batch():
    """``bench_bert_base``'s shape (B 16, L 512) with 15% of the positions
    labelled for MLM and a padding mask (rows 1, 6 and 11 padded from
    position 300, 450 and 77 on): the padding key mask reaches B2-B4."""
    rng = np.random.RandomState(26)
    V = BERT_TP["vocab_size"]
    ids = rng.randint(0, V, (BERT_B, BERT_L))
    mlm = np.where(rng.rand(BERT_B, BERT_L) < 0.15,
                   rng.randint(0, V, (BERT_B, BERT_L)), -100)
    am = np.ones((BERT_B, BERT_L), np.int64)
    for row, start in ((1, 300), (6, 450), (11, 77)):
        am[row, start:] = 0
    return [torch.from_numpy(a).cuda() for a in (
        ids, mlm, rng.randint(0, 2, (BERT_B,)), am)]


def bert_tp_model():
    """``bench_bert_base``'s BERT (bf16) from seed 0 on the card."""
    from paddle_tpu_torch.models.bert import BertConfig, BertModel

    return BertModel(BertConfig(**BERT_TP), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(0))


@contextlib.contextmanager
def first_routes(n):
    """The gate probabilities, experts and slots of the first ``n``
    ``topk_gating_indices`` calls made inside the block (one forward's
    layers; a recompute's calls come after), and each call's C."""
    from paddle_tpu_torch.ops import moe

    calls, inner = [], moe.topk_gating_indices

    def record(logits, *a, **kw):
        out = inner(logits, *a, **kw)
        if len(calls) < n:
            calls.append((torch.softmax(logits.detach().float(), -1).cpu(),
                          out[0].cpu(), out[1].cpu(), out[4]))
        return out

    moe.topk_gating_indices = record
    try:
        yield calls
    finally:
        moe.topk_gating_indices = inner


def held_losses(got, want):
    """Each step's loss difference from the one-rank run's, and its bound:
    ``BF16_RTOL`` of the loss at the first step (the same weights: only
    the order of bf16 roundings differs), then the larger of that and
    ``DELTA_TOL`` of the one-rank run's drop over the step before.  After
    a step the arms' weights differ (AdamW's first steps move each weight
    by about lr whatever its gradient's size, so bf16 noise on a
    near-zero gradient flips a step's sign; phases 21 and 25 hold that
    move within ``DELTA_TOL`` by norm), and so, in that proportion, does
    what the next step's loss kept of the drop."""
    bounds = [BF16_RTOL * abs(want[0])] + [
        max(BF16_RTOL * abs(w), DELTA_TOL * abs(p - w))
        for p, w in zip(want, want[1:])]
    return [abs(g - w) for g, w in zip(got, want)], bounds


def route_flips(got, want, rows, L):
    """Routing differences between a rank's first forward ``got`` and the
    one-rank run's ``want`` (its ``rows`` of the global tokens, rows of
    ``L`` positions), layer by layer.  A token whose chosen experts differ
    is a *root* flip when nothing upstream of it differed: no token at or
    before its position in its row was routed or dropped otherwise at an
    earlier layer (causal attention carries such a difference forward).
    Capacity couples the tokens, so one root flip moves other tokens'
    slots, and a token kept in one run and dropped in the other reaches
    the next layer with another input: those flips follow from a root
    and need no near-tie.  Returns (flips, root flips, the largest
    one-rank gap between the k-th and the next probability among the
    roots, 0.0 without one, and each layer's (flips, roots))."""
    seen, flips, roots, worst, layers = None, 0, 0, 0.0, []
    for (_, eg, sg, C), (pw, ew, sw, _) in zip(got, want):
        pw, ew, sw = pw[rows], ew[rows], sw[rows]
        choice = (eg.sort(-1).values != ew.sort(-1).values).any(-1)
        kept = (torch.where(sg < C, eg, -1).sort(-1).values
                != torch.where(sw < C, ew, -1).sort(-1).values).any(-1)
        root = choice if seen is None else choice & ~seen.reshape(-1)
        flips += int(choice.sum())
        roots += int(root.sum())
        layers.append((int(choice.sum()), int(root.sum())))
        if root.any():
            k = ew.shape[-1]
            p = pw[root].sort(-1, descending=True).values
            worst = max(worst, float((p[:, k - 1] - p[:, k]).max()))
        ahead = (choice | kept).reshape(-1, L).cummax(1).values
        seen = ahead if seen is None else seen | ahead
    return flips, roots, worst, layers


def arm26(kind):
    """(model, the function that makes its step, batch, MoE layers to
    record) of an arm's kind, on the card from seed 0."""
    if kind == "bert":
        return bert_tp_model(), bert_tp_step, bert_tp_batch(), 0
    model = ernie_model("cuda", **(EP_FP32 if kind == "ernie_fp32" else {}))
    return model, ep_step, ep_batch(), model.config.num_layers


def ep_step(model, hcg=None):
    from paddle_tpu_torch.models.ernie_moe import make_ernie_moe_train_step
    from paddle_tpu_torch.optimizer import AdamW

    return make_ernie_moe_train_step(
        model, AdamW(EP_LR, weight_decay=0.01), hcg)


def bert_tp_step(model, hcg=None):
    from paddle_tpu_torch.models.bert import make_bert_train_step
    from paddle_tpu_torch.optimizer import AdamW

    return make_bert_train_step(model, AdamW(EP_LR, weight_decay=0.01), hcg)


def run26(step, state, batch, routes=0, warmed=None):
    """3 steps: the first (a warm-up, its routing recorded over ``routes``
    layers; ``warmed()`` called after it) and 2 timed; returns (losses,
    ms/step, warm-up launches, timed launches, routing, the state)."""
    zero_counts()
    with first_routes(routes) as calls:
        state, loss = step(state, EP_LR, *batch)
        losses = [loss.item()]
    warm = flash_counts()
    if warmed is not None:
        warmed()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1, EP_STEPS):
        state, loss = step(state, EP_LR, *batch)
        losses.append(loss.item())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (EP_STEPS - 1)
    return losses, ms, warm, flash_counts(), calls, state


def rank26(rank, world, tmp):
    """One rank of phase 26's world of ``world``: its arms' 3 steps (the
    first a warm-up), the time in gloo's collectives apart from the rest,
    the bytes and host stagings of each kind of collective, the flash and
    fused-LN launches, the bytes the state holds, and the first step's
    routing."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.core.flags import set_flags
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase26: a rank imported jax")
    gloo = {"s": 0.0, "calls": 0, "bytes": {}}
    run = C._run

    def timed(name, group, inputs, outputs, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, group, inputs, outputs, fn)
        torch.cuda.synchronize()
        gloo["s"] += time.perf_counter() - t0
        gloo["calls"] += 1
        gloo["bytes"][name] = gloo["bytes"].get(name, 0) + sum(
            t.numel() * t.element_size() for t in inputs if t is not None)

    C._run = timed
    out = {}
    for name, w, hc, kind in EP_ARMS:
        if w != world:
            continue
        set_flags({"FLAGS_use_fused_ln": kind == "bert"})
        model, build, batch, moe_layers = arm26(kind)
        step, state = build(model, fleet_hcg(**hc))
        mesh = step.layout.mesh
        staged0 = dict(C.HOST_STAGING)

        def warmed():
            gloo.update(s=0.0, calls=0, bytes={})
            staged0.update(C.HOST_STAGING)

        losses, ms, warm, launches, routes, state = run26(
            step, state, batch, moe_layers, warmed)
        n = EP_STEPS - 1
        out[name] = dict(
            losses=losses, ms=ms, gloo_ms=1e3 * gloo["s"] / n,
            calls=gloo["calls"] / n,
            bytes={k: v // n for k, v in gloo["bytes"].items()},
            staged={k: (C.HOST_STAGING[k] - staged0[k]) // n
                    for k in staged0},
            warm=warm, launches=launches, routes=routes,
            data=mesh.coord.get("data", 0), shape=dict(mesh.shape),
            param_bytes=sum(v.numel() * v.element_size()
                            for v in state["params"].values()),
            slot_bytes=per_device_state_bytes(state),
            split={k: [e for e in s] for k, s in
                   step.layout.specs["params"].items()})
        set_flags({"FLAGS_use_fused_ln": False})
        del model, step, state
        gc.collect()
        torch.cuda.empty_cache()
    C._run = run
    with open(f"{tmp}/rank{world}_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase26_flash(card):
    """B2-B4 at the shapes this phase gives them first: BERT's at mp 2
    (B 16, L 512, 6 heads, not causal, the padding key mask) and
    ERNIE-MoE's at ep 2 (a rank's B 4, L 512, all 12 heads, causal),
    against their plain versions."""
    from paddle_tpu_torch.ops import attention as A

    dt, D = torch.bfloat16, 64
    for label, B, nh, causal, masked in (
            ("BERT mp 2", BERT_B, 6, False, (300, 512)),
            ("ERNIE-MoE ep 2", EP_B // 2, 12, True, False)):
        q, k, v, do, km = flash_inputs(B, EP_L, nh, D, dt, masked, seed=26)
        scale = 1.0 / D ** 0.5
        qk = [t.clone().requires_grad_() for t in (q, k, v)]
        out = A._FlashAttention.apply(*qk, km, FLASH_SEED, causal, scale,
                                      0.0)
        grads = torch.autograd.grad(out, qk, do)
        qp = [t.clone().requires_grad_() for t in (q, k, v)]
        out_p, _ = A.flash_fwd_ref(*qp, km, FLASH_SEED, causal, scale, 0.0)
        grads_p = torch.autograd.grad(out_p, qp, do)
        torch.cuda.synchronize()
        err = (out.float() - out_p.float()).abs().max().item()
        gerr = [rel_err(a, b) for a, b in zip(grads, grads_p)]
        check(err <= TOL[dt] and max(gerr) <= GRAD_TOL[dt],
              f"phase26 flash at {label}'s shape: O err {err}, grads "
              f"{gerr}")
        say(f"phase26 flash kernels at {label}'s shape (B {B}, L {EP_L}, "
            f"{nh} heads, hd 64, bf16, {'causal' if causal else 'not causal, padding key mask'}) on {card}: O max abs err "
            f"{err:.3e} (tol {TOL[dt]}), dq/dk/dv err / max|grad| "
            + "/".join(f"{e:.3e}" for e in gerr) + f" (tol {GRAD_TOL[dt]})")


def solo26(kind):
    """The one-rank step of an arm's kind on the same weights and batch:
    losses, ms/step, launches, routing, the layers and the parameters'
    bytes a tensor."""
    from paddle_tpu_torch.core.flags import set_flags

    set_flags({"FLAGS_use_fused_ln": kind == "bert"})
    model, build, batch, moe_layers = arm26(kind)
    layers = getattr(model.config, "num_layers", None) or \
        model.config.num_hidden_layers
    step, state = build(model)
    losses, ms, warm, launches, routes, state = run26(step, state, batch,
                                                      moe_layers)
    sizes = {n: p.numel() * p.element_size()
             for n, p in state["params"].items()}
    set_flags({"FLAGS_use_fused_ln": False})
    del model, step, state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(losses=losses, ms=ms, warm=warm, launches=launches,
                routes=routes, sizes=sizes, layers=layers)


def phase26(card):
    """ERNIE-MoE over the expert and model axes and BERT over the model
    axis at their bench widths, on gloo ranks sharing the card: (a)
    ``bench_ernie_moe``'s widths (vocab 30528, H 768, 6 layers, 12 heads,
    8 experts, top-2, bf16, fp32 parameters, AdamW 1e-4, B 8, L 512, remat
    on) at ep 2 (dp 2, 4 experts a rank) and dp 2 x mp 2, and at ep 2 in
    fp32 cut to 2 layers; (b) ``bench_bert_base``'s widths (12 layers, B
    16, L 512, bf16, fused LN on, a padding mask) at mp 2.  Each arm takes
    3 steps from the one-rank step's weights and holds its losses to it.
    Returns the ranks' flash and fused-LN launches (fwd, dq, dkv, ln fwd,
    ln bwd)."""
    import tempfile

    import pickle
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    phase26_flash(card)
    solo = {kind: solo26(kind) for kind in ("ernie", "ernie_fp32", "bert")}
    tmp = tempfile.mkdtemp(prefix="phase26_")
    say("phase26: the ranks share this one card over gloo (NCCL refuses two "
        "ranks on one device, so NCCL's arm of the expert exchange cannot "
        "run here); every hop goes through the host")
    t_ranks = time.perf_counter()
    for world in (2, 4):
        mp.start_processes(rank26, args=(world, tmp), nprocs=world,
                           join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t_ranks
    ranks = {w: [] for w in (2, 4)}
    for w in (2, 4):
        for r in range(w):
            with open(f"{tmp}/rank{w}_{r}.pkl", "rb") as f:
                ranks[w].append(pickle.load(f))
    launches = [0] * 5
    for name, world, hc, kind in EP_ARMS:
        bert, fp32 = kind == "bert", kind == "ernie_fp32"
        one = solo[kind]
        dp, mp_ = hc.get("dp_degree", 1), hc.get("mp_degree", 1)
        nl = one["layers"]
        # remat on: each step's forward twice (the recompute), its
        # backward once; the fused LN twice a layer a forward
        want = [2 * nl, nl, nl] + ([4 * nl, 2 * nl] if bert else [0, 0])
        tie = ROUTE_TIE if fp32 else BF16_TIE
        for r, rk in enumerate(ranks[world]):
            a = rk[name]
            if fp32:    # as phase 19's card against the CPU, every step
                a["diffs"] = [abs(g - w) for g, w in
                              zip(a["losses"], one["losses"])]
                a["bounds"] = [ERNIE_LOSS_TOL * abs(w)
                               for w in one["losses"]]
            else:
                a["diffs"], a["bounds"] = held_losses(a["losses"],
                                                      one["losses"])
            diffs, bounds = a["diffs"], a["bounds"]
            check(np.isfinite(a["losses"]).all() and all(
                d <= b for d, b in zip(diffs, bounds)),
                  f"phase26 {name} rank {r}: losses {a['losses']} vs one "
                  f"rank {one['losses']}: differences {diffs}, bounds "
                  f"{bounds}")
            check(a["warm"] == want and
                  a["launches"] == [x * (EP_STEPS - 1) for x in want],
                  f"phase26 {name} rank {r}: flash/LN launches "
                  f"{a['launches']} (warm-up {a['warm']}), want "
                  f"{want} a step")
            launches = [s + u + w for s, u, w in
                        zip(launches, a["launches"], a["warm"])]
            if not bert:
                n = EP_B * EP_L // dp
                rows = slice(a["data"] * n, (a["data"] + 1) * n)
                flips, roots, worst, layers = route_flips(
                    a["routes"], one["routes"], rows, EP_L)
                a["flips"], a["roots"], a["worst"] = flips, roots, worst
                check(len(a["routes"]) == nl and all(
                    c == ERNIE_C for *_, c in a["routes"]),
                    f"phase26 {name} rank {r}: capacities "
                    f"{[c for *_, c in a['routes']]}, want {ERNIE_C}")
                check(worst < tie,
                      f"phase26 {name} rank {r}: {roots} root routing "
                      f"flips (of {flips}) against one rank, one with a "
                      f"top-2 gap of {worst} (>= {tie}); by layer "
                      f"(flips, roots) {layers}")
        a = ranks[world][0][name]
        split = {k for k, s in a["split"].items() if any(
            e is not None for e in s)}
        held = sum(b // (dp if "expert" in k else mp_) if k in split else b
                   for k, b in one["sizes"].items())
        total = sum(one["sizes"].values())
        check(a["param_bytes"] == held and a["slot_bytes"] == 2 * held,
              f"phase26 {name}: a rank holds {a['param_bytes']} bytes of "
              f"parameters and {a['slot_bytes']} of slots, want {held} and "
              f"{2 * held} (split {sorted(split)})")
        extra = ""
        if not bert:
            E, H = ERNIE_BENCH["num_experts"], ERNIE_BENCH["hidden_size"]
            extra = (f"; C {ERNIE_C}, the exchange "
                     f"{E * ERNIE_C * H * (4 if fp32 else 2)} "
                     f"bytes each way a layer (reduce-scatter in, "
                     f"all-gather out; remat repeats the forward's pair), "
                     f"routing flips vs one rank, root/all, "
                     + ", ".join(f"{rk[name]['roots']}/{rk[name]['flips']}"
                                 for rk in ranks[world])
                     + " of " + str(EP_B * EP_L // dp * nl)
                     + " token-layers a rank (largest one-rank top-2 gap "
                     f"among the roots "
                     f"{max(rk[name]['worst'] for rk in ranks[world]):.3e},"
                     f" bound {tie})")
        say(f"phase26 {name} ({'bench_bert_base' if bert else 'bench_ernie_moe'}"
            f"'s widths, {nl} layers, {world} gloo ranks) on {card}: losses "
            f"{[round(v, 5) for v in a['losses']]} vs one rank "
            f"{[round(v, 5) for v in one['losses']]} (differences a step, "
            f"largest over the ranks, "
            + "/".join(f"{max(rk[name]['diffs'][i] for rk in ranks[world]):.3e}"
                       for i in range(EP_STEPS))
            + ", bounds " + "/".join(f"{b:.3e}" for b in a["bounds"])
            + f"); ms/step rank 0 {a['ms']:.3f} = gloo "
            f"{a['gloo_ms']:.3f} ({a['calls']:.0f} collectives a step) + "
            f"the rest {a['ms'] - a['gloo_ms']:.3f} (ranks: "
            + ", ".join(f"{rk[name]['ms']:.3f} = {rk[name]['gloo_ms']:.3f} + "
                        f"{rk[name]['ms'] - rk[name]['gloo_ms']:.3f}"
                        for rk in ranks[world])
            + f"); one rank {one['ms']:.3f} ms/step; bytes a step into "
            f"gloo by collective {a['bytes']}; host-staged copies a step "
            f"{a['staged']['copies']} ({a['staged']['bytes'] / 2**20:.1f} "
            f"MiB); flash fwd/dq/dkv and LN fwd/bwd a rank a step "
            f"{want}; parameters a rank {a['param_bytes']} bytes "
            f"({a['param_bytes'] / total:.3f}x one rank's {total}), AdamW "
            f"slots {a['slot_bytes']}" + extra)
    say(f"phase26 took {time.perf_counter() - t0:.1f} s on {card} (the ranks "
        f"{t_ranks:.1f} s); flash fwd/dq/dkv and LN fwd/bwd on the ranks "
        f"{launches}")
    return launches


def bytes_ops_bound(nbytes, flops):
    """(ms, "bytes"|"operations") of the larger bound; fp32 flops."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_fused():
    """The fused kernels at BERT-base's shapes: the LN epilogue at N 8192,
    H 768, bf16 with a bias, no dropout (the backward with the rout
    cotangent read), AdamW at 110,111,042 fp32 parameters."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import fused as TF

    N, H, dt, eps = 8192, 768, torch.bfloat16, 1e-12
    x, res, w, b, bb, dout, drout = ln_inputs(N, H, dt, True, seed=11)
    fwd = (x, res, w, b, bb, 0, 0.0, eps)
    out, rout, mu, rstd = TF.fused_ln_fwd_cuda(*fwd)
    out_p = TF.ln_fwd_ref(*fwd)[0]
    bwd = (dout, drout, rout, mu, rstd, w, 0, 0.0, True)
    dx, dres = TF.fused_ln_bwd_cuda(*bwd)[:2]
    dx_p, dres_p = TF.ln_bwd_ref(*bwd)[:2]
    torch.cuda.synchronize()
    rows = {"fused_ln_fwd": dict(max_abs_err=(out.float() - out_p.float())
                                 .abs().max().item()),
            "fused_ln_bwd": dict(max_abs_err=max(
                (dx.float() - dx_p.float()).abs().max().item(),
                (dres.float() - dres_p.float()).abs().max().item()))}
    el = x.element_size()
    y = (res + x + bb.to(dt)).detach()              # LN alone, pre-added
    w16, b16 = w.to(dt), b.to(dt)
    rows["fused_ln_fwd"].update(
        ms=time_cold_ms(lambda: TF.fused_ln_fwd_cuda(*fwd)),
        plain_ms=time_cold_ms(lambda: TF.ln_fwd_ref(*fwd)),
        library_ms=time_cold_ms(lambda: F.layer_norm(y, (H,), w16, b16,
                                                     eps)))
    # x, residual read, out and rout written, w/b/bias read, mu/rstd
    # written; ~9 flops an element
    rows["fused_ln_fwd"].update(zip(("bound_ms", "bound_by"), bytes_ops_bound(
        4 * N * H * el + 3 * H * 4 + 2 * N * 4, 9 * N * H)))
    yl, wl, bl = (t.clone().requires_grad_() for t in (y, w16, b16))
    o = F.layer_norm(yl, (H,), wl, bl, eps)
    rows["fused_ln_bwd"].update(
        kernel_alone_ms=time_cold_ms(lambda: TF.ln_bwd_partials_cuda(
            *bwd[:-1])),
        ms=time_cold_ms(lambda: TF.fused_ln_bwd_cuda(*bwd)),
        plain_ms=time_cold_ms(lambda: TF.ln_bwd_ref(*bwd)),
        library_ms=time_cold_ms(lambda: torch.autograd.grad(
            o, (yl, wl, bl), dout, retain_graph=True)))
    # dout, drout, rout read, dx and dres written, mu/rstd and w read,
    # dw/db/dbias written; ~15 flops an element
    rows["fused_ln_bwd"].update(zip(("bound_ms", "bound_by"), bytes_ops_bound(
        5 * N * H * el + 2 * N * 4 + 4 * H * 4, 15 * N * H)))

    n = BERT_PARAMS
    p, m, v, g = adamw_state(n, torch.float32, seed=12)
    grad = torch.randn(n, generator=g, device="cuda")
    scal = TF._adamw_scalars(1, 1e-4, 0.9, 0.999, 1e-8, 0.01)
    po = TF.fused_adamw_flat_cuda(p, grad, m, v, scal)[0]
    po_p = TF.adamw_flat_ref(p, grad, m, v, scal)[0]
    torch.cuda.synchronize()
    lib = [t.clone() for t in (p, grad, m, v)]
    steps = [torch.ones((), device="cuda")]
    rows["fused_adamw_flat"] = dict(
        max_abs_err=(po - po_p).abs().max().item(),
        ms=time_cold_ms(lambda: TF.fused_adamw_flat_cuda(p, grad, m, v,
                                                         scal)),
        plain_ms=time_cold_ms(lambda: TF.adamw_flat_ref(p, grad, m, v, scal),
                              iters=10),
        library_ms=time_cold_ms(lambda: torch._fused_adamw_(
            [lib[0]], [lib[1]], [lib[2]], [lib[3]], [], steps, lr=1e-4,
            beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
            amsgrad=False, maximize=False)))
    # p, g, m, v read and p, m, v written once; ~17 flops an element
    rows["fused_adamw_flat"].update(zip(("bound_ms", "bound_by"),
                                        bytes_ops_bound(7 * 4 * n, 17 * n)))
    return rows


# ------------------------------------------------------------ phase 27 --

PP_M, PP_STEPS = 4, 3
#: phase 27's arms: (name, world, degrees, fp32); the fp32 arm is gpt2s
#: width cut to PP_FP32_LAYERS layers
PP_ARMS = (("pp 2", 2, {"pp_degree": 2}, False),
           ("pp 2 x V 2", 2, {"pp_degree": 2, "pp_configs": {
               "virtual_pipeline_degree": 2}}, False),
           ("pp 2 fp32", 2, {"pp_degree": 2}, True),
           ("pp 2 x mp 2", 4, {"pp_degree": 2, "mp_degree": 2}, False))
PP_FP32_LAYERS = 4
PP_FP32_RTOL = 1e-5


def pp_model(fp32):
    """gpt2s from seed 0 on the card: bf16 at 12 layers, or fp32 at
    ``PP_FP32_LAYERS``."""
    from paddle_tpu_torch.models.gpt import GPTModel, gpt_preset

    over = dict(DP_WIDTH, num_layers=PP_FP32_LAYERS,
                compute_dtype="float32") if fp32 else DP_WIDTH
    return GPTModel(gpt_preset("gpt2-small", **over), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))


def pp_cut(step, hc):
    """``cut(name, full)``: this rank's block of a whole tensor under the
    pipeline step's layout (stacked tensors chunk-interleaved first)."""
    from paddle_tpu_torch.distributed.pipeline_engine import \
        interleave_layers
    from paddle_tpu_torch.distributed.sharding_rules import local_shard

    mesh, specs = step.layout.mesh, step.layout.specs["params"]
    V = hc.get("pp_configs", {}).get("virtual_pipeline_degree", 1)

    def cut(name, full):
        full = full.cuda()
        if name.startswith("blocks_") and V > 1:
            full = interleave_layers(full, mesh.shape["pipe"], V)
        return local_shard(full, specs[name], mesh)
    return cut


def rank27(rank, world, tmp):
    """One rank of phase 27's world of ``world``: each arm's 3 steps (the
    first a warm-up), the time in gloo (the pipeline's p2p exchanges apart)
    and the rest, the flash launches, the bytes the state holds, and the
    weights against the one-rank step's."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import spmd
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models.gpt import make_gpt_train_step
    from paddle_tpu_torch.optimizer import AdamW

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase27: a rank imported jax")
    gloo = [0.0, 0]
    run = C._run

    def timed(name, group, inputs, outputs, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, group, inputs, outputs, fn)
        torch.cuda.synchronize()
        gloo[0] += time.perf_counter() - t0
        gloo[1] += 1

    C._run = timed
    x, y = tp_batch()
    out = {}
    for name, w, hc, fp32 in PP_ARMS:
        if w != world:
            continue
        kind = "fp32" if fp32 else "bf16"
        model = pp_model(fp32)
        hcg = fleet_hcg(**hc)
        step, state = make_gpt_train_step(model, AdamW(TP_LR), hcg,
                                          n_microbatches=PP_M, remat=False)
        zero_counts()
        state, loss = step(state, 0, TP_LR, x, y)
        losses = [loss.item()]
        warm = flash_counts()[:3]
        zero_counts()
        gloo[:] = [0.0, 0]
        staged0 = dict(C.HOST_STAGING)
        p2p0 = dict(spmd.PIPE_P2P)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, PP_STEPS):
            state, loss = step(state, i, TP_LR, x, y)
            losses.append(loss.item())
        torch.cuda.synchronize()
        n = PP_STEPS - 1
        wall = time.perf_counter() - t0
        p0 = torch.load(f"{tmp}/p0_{kind}.pt")
        solo = torch.load(f"{tmp}/solo_{kind}.pt")
        cut = pp_cut(step, hc)
        got = {k: v.detach() for k, v in state["params"].items()}
        move = delta_errors(got, p0, solo, cut)
        # this rank's blocks of every parameter against the one-rank
        # step's: over them all, and the largest tensor by tensor
        d2 = w2 = worst = 0.0
        for k, v in got.items():
            want = cut(k, solo[k])
            e = float((v.float() - want).square().sum())
            d2, w2 = d2 + e, w2 + float(want.square().sum())
            worst = max(worst, (e / float(want.square().sum())) ** 0.5)
        rel = (d2 / w2) ** 0.5
        out[name] = dict(
            losses=losses, ms=1e3 * wall / n, gloo_ms=1e3 * gloo[0] / n,
            calls=gloo[1] / n,
            p2p_ms=1e3 * (spmd.PIPE_P2P["seconds"] - p2p0["seconds"]) / n,
            p2p_msgs=(spmd.PIPE_P2P["messages"] - p2p0["messages"]) / n,
            p2p_bytes=(spmd.PIPE_P2P["bytes"] - p2p0["bytes"]) / n,
            launches=flash_counts()[:3], warm=warm, move=move, rel=rel,
            worst=worst,
            coord=dict(hcg.mesh.coord), layers=model.config.num_layers,
            param_bytes=sum(v.numel() * v.element_size()
                            for v in state["params"].values()),
            slot_bytes=per_device_state_bytes(state),
            staged={k: C.HOST_STAGING[k] - staged0[k] for k in staged0})
        del model, step, state, got, loss, p0, solo
        gc.collect()
        torch.cuda.empty_cache()
    C._run = run
    with open(f"{tmp}/rank{world}_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def solo27(fp32, tmp):
    """The one-rank step on the arms' weights and batch: its losses and
    ms/step, the parameters' bytes and slots; the initial and final
    weights saved for the ranks."""
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models.gpt import make_gpt_train_step
    from paddle_tpu_torch.optimizer import AdamW

    kind = "fp32" if fp32 else "bf16"
    model = pp_model(fp32)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               f"{tmp}/p0_{kind}.pt")
    step, state = make_gpt_train_step(model, AdamW(TP_LR), remat=False)
    x, y = tp_batch()
    losses = []
    for i in range(PP_STEPS):
        state, loss = step(state, i, TP_LR, x, y)
        losses.append(loss.item())
        if i == 0:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t1) / (PP_STEPS - 1)
    torch.save({n: p.detach().cpu() for n, p in model.named_parameters()},
               f"{tmp}/solo_{kind}.pt")
    out = dict(losses=losses, ms=ms, layers=model.config.num_layers,
               params=sum(p.numel() * p.element_size()
                          for p in state["params"].values()),
               slots=per_device_state_bytes(state))
    del model, step, state, loss
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase27_flash(card):
    """B2-B4 at a micro-batch's shapes (B 2 of 8 over M 4, L 1024, hd 64,
    causal): 12 heads in bf16 and fp32, an mp rank's 6 in bf16, against
    their plain versions."""
    from paddle_tpu_torch.ops import attention as A

    mb, D = TP_B // PP_M, 64
    for dt, H in ((torch.bfloat16, 12), (torch.bfloat16, 6),
                  (torch.float32, 12)):
        q, k, v, do, km = flash_inputs(mb, TP_L, H, D, dt, False, seed=27)
        scale = 1.0 / D ** 0.5
        qk = [t.clone().requires_grad_() for t in (q, k, v)]
        out = A._FlashAttention.apply(*qk, km, FLASH_SEED, True, scale, 0.0)
        grads = torch.autograd.grad(out, qk, do)
        qp = [t.clone().requires_grad_() for t in (q, k, v)]
        out_p, _ = A.flash_fwd_ref(*qp, km, FLASH_SEED, True, scale, 0.0)
        grads_p = torch.autograd.grad(out_p, qp, do)
        torch.cuda.synchronize()
        err = (out.float() - out_p.float()).abs().max().item()
        gerr = [rel_err(a, b) for a, b in zip(grads, grads_p)]
        check(err <= TOL[dt] and max(gerr) <= GRAD_TOL[dt],
              f"phase27 flash at B {mb}, L {TP_L}, {H} heads, {dt}: O err "
              f"{err}, grads {gerr}")
        say(f"phase27 flash kernels at a micro-batch's shape (B {mb}, L "
            f"{TP_L}, {H} heads, hd {D}, {str(dt)[6:]}, causal) on {card}: O "
            f"max abs err {err:.3e} (tol {TOL[dt]}), dq/dk/dv err / "
            f"max|grad| " + "/".join(f"{e:.3e}" for e in gerr)
            + f" (tol {GRAD_TOL[dt]})")


def phase27(card):
    """The pipe axis at gpt2s width (B 8, L 1024, M 4 micro-batches of 2
    rows, AdamW 3e-4, remat off), on gloo ranks sharing the card: (a) pp
    2 1F1B, (b) pp 2 x V 2 interleaved, (c) pp 2 x mp 2 on four ranks, at
    12 layers in bf16; (d) pp 2 in fp32 at ``PP_FP32_LAYERS`` layers.
    Each arm takes 3 steps from the one-rank step's weights: (a)-(c) hold
    their losses as phase 26's (``held_losses``) and the weights' move as
    phase 25's, (d) its losses and its blocks of every parameter within
    ``PP_FP32_RTOL`` of the one-rank step's.  Returns the ranks' flash
    launches (fwd, dq, dkv)."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    phase27_flash(card)
    tmp = tempfile.mkdtemp(prefix="phase27_")
    solo = {False: solo27(False, tmp), True: solo27(True, tmp)}
    say("phase27: the pipe ranks share this one card over gloo (NCCL refuses "
        "two ranks on one device); every activation and gradient hop goes "
        "through the host")
    t_ranks = time.perf_counter()
    for world in (2, 4):
        mp.start_processes(rank27, args=(world, tmp), nprocs=world,
                           join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t_ranks
    ranks = {w: [] for w in (2, 4)}
    for w in (2, 4):
        for r in range(w):
            with open(f"{tmp}/rank{w}_{r}.pkl", "rb") as f:
                ranks[w].append(pickle.load(f))
    launches = [0, 0, 0]
    for name, world, hc, fp32 in PP_ARMS:
        one = solo[fp32]
        S = hc["pp_degree"]
        mp_ = hc.get("mp_degree", 1)
        nl = one["layers"]
        # remat off: a rank's layers once a micro-batch, forward and back
        want = [nl // S * PP_M] * 3
        for r, rk in enumerate(ranks[world]):
            a = rk[name]
            if fp32:
                a["diffs"] = [abs(g - w) for g, w in
                              zip(a["losses"], one["losses"])]
                a["bounds"] = [PP_FP32_RTOL * abs(w) for w in one["losses"]]
            else:
                a["diffs"], a["bounds"] = held_losses(a["losses"],
                                                      one["losses"])
            check(np.isfinite(a["losses"]).all() and all(
                d <= b for d, b in zip(a["diffs"], a["bounds"])),
                  f"phase27 {name} rank {r}: losses {a['losses']} vs one "
                  f"rank {one['losses']}: differences {a['diffs']}, bounds "
                  f"{a['bounds']}")
            check(a["rel"] <= PP_FP32_RTOL if fp32
                  else a["move"][0] <= DELTA_TOL,
                  f"phase27 {name} rank {r}: parameters vs one rank's: "
                  f"relative {a['rel']:.3e}, move {a['move']}")
            check(a["warm"] == want and
                  a["launches"] == [n * (PP_STEPS - 1) for n in want],
                  f"phase27 {name} rank {r}: flash launches "
                  f"{a['launches']} (warm-up {a['warm']}), want {want} a "
                  f"step")
            launches = [s + u + w for s, u, w in
                        zip(launches, a["launches"], a["warm"])]
        a = ranks[world][0][name]
        share = a["param_bytes"] / one["params"]
        say(f"phase27 {name} (gpt2s width, {nl} layers, "
            f"{'fp32' if fp32 else 'bf16'}, B {TP_B}, L {TP_L}, M {PP_M}, "
            f"{world} gloo ranks) on {card}: losses "
            f"{[round(v, 6) for v in a['losses']]} vs one rank "
            f"{[round(v, 6) for v in one['losses']]} (differences a step, "
            f"largest over the ranks, "
            + "/".join(f"{max(rk[name]['diffs'][i] for rk in ranks[world]):.3e}"
                       for i in range(PP_STEPS))
            + ", bounds " + "/".join(f"{b:.3e}" for b in a["bounds"])
            + "); a rank's parameters vs one rank's, relative over them "
            "all (largest tensor by tensor) "
            + "/".join(f"{rk[name]['rel']:.3e} ({rk[name]['worst']:.3e})"
                       for rk in ranks[world])
            + ", move " + "/".join(f"{rk[name]['move'][0]:.3e}"
                                   for rk in ranks[world])
            + f"; ms/step (rank: total = gloo, of it p2p, + the rest) "
            + ", ".join(f"{rk[name]['coord']}: {rk[name]['ms']:.3f} = "
                        f"{rk[name]['gloo_ms']:.3f} (p2p "
                        f"{rk[name]['p2p_ms']:.3f}, "
                        f"{rk[name]['p2p_msgs']:.0f} sends of "
                        f"{rk[name]['p2p_bytes'] / 2**20:.1f} MiB) + "
                        f"{rk[name]['ms'] - rk[name]['gloo_ms']:.3f}"
                        for rk in ranks[world])
            + f"; {a['calls']:.0f} gloo calls a step; one rank "
            f"{one['ms']:.3f} ms/step; host-staged copies a step "
            f"{a['staged']['copies'] / (PP_STEPS - 1):.0f} "
            f"({a['staged']['bytes'] / (PP_STEPS - 1) / 2**20:.1f} MiB); "
            f"flash fwd/dq/dkv a rank a step {want}; bytes rank 0 holds: "
            f"parameters {a['param_bytes']} ({share:.3f}x one rank's "
            f"{one['params']}), AdamW slots {a['slot_bytes']} "
            f"({a['slot_bytes'] / one['slots']:.3f}x one rank's "
            f"{one['slots']}); rank shares "
            + "/".join(f"{rk[name]['param_bytes'] / one['params']:.3f}"
                       for rk in ranks[world]))
    say(f"phase27 took {time.perf_counter() - t0:.1f} s on {card} (the ranks "
        f"{t_ranks:.1f} s); flash fwd/dq/dkv on the ranks {launches}")
    return launches


# ------------------------------------------------------------ phase 28 --

# (a) resnet50 at phase 23's widths over two data ranks, at a tenth of
# phase 23's rate: at 0.1 a fresh resnet50's loss rises over the first
# steps (7.596, 9.098, 10.550 on one rank at B 64 on an H100).  Against
# the one-rank step on the same global batches: the first loss within
# DPV_LOSS_RTOL (the same weights: only the sums' order and conv1's bf16
# product over 32 rows, where one rank has 64, differ), the later ones
# within DPV_LATER_RTOL, the parameters' and the running statistics' move
# from the common start within DPV_PARAM_MOVE and DPV_STATS_MOVE of one
# rank's move by norm (phases 21 and 25's measure), the parameters and
# running statistics bit-equal across the ranks.  The later bounds are
# wide: a fresh resnet50's fp32 steps land far apart from a small change
# (on an H100 at this rate the later losses 2.1e-3 to 5.1e-3 apart, the
# parameters' move 0.80 and the statistics' 0.0075 of one rank's);
# (a2) holds the same step in float64 within VISION_TOL64.
DPV_B, DPV_SIDE, DPV_STEPS, DPV_LR = 64, 224, 3, 0.01
DPV_LOSS_RTOL, DPV_LATER_RTOL = 1e-5, 3e-2
DPV_PARAM_MOVE, DPV_STATS_MOVE = 1.5, 0.1
# (a2) resnet50 in float64 at 224x224 (B 16, 1000 classes, 2 steps): dp 2
# against one rank within VISION_TOL64, as the families in (b)
DPV64_B, DPV64_STEPS = 16, 2
# (b) the seven families that draw, at phase 24b's small shapes
DPF_NAMES = ("alexnet", "vgg16", "squeezenet1_1", "mobilenet_v2",
             "googlenet", "inception_v3", "densenet121")
DPF_B, DPF_STEPS = 4, 2
# (c) the normalization layers of this slice on the card against the CPU,
# |cuda - cpu| / (1 + |cpu|): a weight gradient sums 1,024 to 25,088 fp32
# products a channel, in another order on each device
NORM28_TOL = 1e-4


def dp28_hcg(world):
    import types

    from paddle_tpu_torch.distributed.topology import ProcessMesh

    if world == 1:
        return types.SimpleNamespace(mesh=ProcessMesh(["data"], [1]))
    return fleet_hcg(dp_degree=world)


def dp28_model(name, dev):
    """resnet50 (NHWC, 1000 classes, fp32; ``resnet50_f64`` in float64)
    or a family at 10 classes in float64, from seed 0."""
    from paddle_tpu_torch.vision import models as tm

    seed_build(0)
    if name == "resnet50":
        return tm.resnet50(data_format="NHWC", device=dev)
    if name == "resnet50_f64":
        return tm.resnet50(data_format="NHWC", device=dev).double()
    return getattr(tm, name)(num_classes=10, device=dev).double()


def dp28_cell(name):
    """(input shape, classes, input dtype, lr, steps) of a cell."""
    if name == "resnet50":
        return ((DPV_B, DPV_SIDE, DPV_SIDE, 3), 1000, torch.bfloat16,
                DPV_LR, DPV_STEPS)
    if name == "resnet50_f64":
        return ((DPV64_B, DPV_SIDE, DPV_SIDE, 3), 1000, torch.float64,
                DPV_LR, DPV64_STEPS)
    side = 112 if name == "inception_v3" else 64
    lr = dict((n, r) for n, _, r in FAMILY_CELLS)[name]
    return (DPF_B, 3, side, side), 10, torch.float64, lr, DPF_STEPS


def dp28_run(name, model, hcg, timed=None):
    """``make_spmd_train_step`` (``F.cross_entropy``, phase 23's Momentum)
    over ``hcg``'s mesh, step ``t`` on a global batch from seed 28 + t
    under ``fold_in_step_key(VISION_KEY, t)``: the losses, the final state
    and the ms a step after the first (``timed`` zeroes its counters
    before them)."""
    from paddle_tpu_torch.distributed import make_spmd_train_step
    from paddle_tpu_torch.jit.functional import fold_in_step_key
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import Momentum

    shape, classes, dtype, lr, steps = dp28_cell(name)
    batches = []
    for t in range(steps):
        rng = np.random.RandomState(28 + t)
        batches.append((
            torch.from_numpy(rng.standard_normal(shape)).to("cuda", dtype),
            torch.from_numpy(rng.randint(0, classes, shape[0])).cuda()))
    step, state, _ = make_spmd_train_step(
        model, lambda out, t: F.cross_entropy(out, t),
        Momentum(learning_rate=lr, momentum=0.9, weight_decay=1e-4), hcg)
    losses = []
    for t, (x, y) in enumerate(batches):
        if t == 1:
            torch.cuda.synchronize()
            if timed is not None:
                timed()
            t0 = time.perf_counter()
        state, loss = step(state, fold_in_step_key(VISION_KEY, t), lr, [x],
                           [y])
        losses.append(loss.item())
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / (steps - 1)
    return losses, state, ms


def dp28_host(state):
    return {part: {n: v.detach().to("cpu", copy=True)
                   for n, v in state[part].items()}
            for part in ("params", "buffers")}


def dp28_state(model):
    return dp28_host({"params": dict(model.named_parameters()),
                      "buffers": dict(model.named_buffers())})


def dp28_worst(got, want):
    """The largest ``|got - want| / (1 + |want|)`` over every parameter
    and running statistic."""
    return max(((got[p][n].double() - w.double()).abs()
                / (1 + w.double().abs())).max().item()
               for p in ("params", "buffers") for n, w in want[p].items())


def dp28_moves(got, want, start):
    """For the parameters and for the running statistics: the norm of
    ``got - want`` over the norm of ``want - start`` (how far a rank's
    move from the common start is from one rank's move; 0 for a model
    without running statistics); then the three parameters that add most
    to the first norm, each as (name, its norm of ``got - want``, its
    norm of ``want - start``)."""
    out, worst = [], []
    for p in ("params", "buffers"):
        err = move = 0.0
        for n, w in want[p].items():
            e = float((got[p][n].double() - w.double()).square().sum())
            m = float((w.double() - start[p][n].double()).square().sum())
            err, move = err + e, move + m
            if p == "params":
                worst.append((e, n, m))
        out.append((err / move) ** 0.5 if move else 0.0)
    worst.sort(reverse=True)
    return out + [[(n, e ** 0.5, m ** 0.5) for e, n, m in worst[:3]]]


def dp28_fingerprint(model):
    """The float64 sum of every parameter and buffer: the ranks rebuild
    each model from seed 0 on the card and check it against the one-rank
    step's build."""
    return sum(t.detach().double().sum().item()
               for t in list(model.parameters()) + list(model.buffers()))


def solo28(tmp):
    """The one-rank runs: each cell's losses, ms/step and initial
    fingerprint; its final state saved for the ranks."""
    out = {}
    for name in ("resnet50", "resnet50_f64") + DPF_NAMES:
        model = dp28_model(name, "cuda")
        fp = dp28_fingerprint(model)
        losses, state, ms = dp28_run(name, model, dp28_hcg(1))
        torch.save(dp28_host(state), f"{tmp}/solo_{name}.pt")
        out[name] = dict(losses=losses, ms=ms, fingerprint=fp)
        del model, state
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank28(rank, tmp, fingerprints):
    """One of phase 28's two data ranks: resnet50 with BatchNorm and with
    SyncBatchNorm (losses, ms/step, the gloo share, the batch-statistics
    all-reduces a step, the worst difference from the one-rank state, the
    running statistics), then each family's 2 steps."""
    import datetime
    import pickle

    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.nn.functional import norm as N

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=2,
                           timeout=datetime.timedelta(seconds=600))
    check("jax" not in sys.modules, "phase28: a rank imported jax")
    hcg = dp28_hcg(2)
    gloo = [0.0, 0]
    run = C._run

    def timed_run(name, group, inputs, outputs, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, group, inputs, outputs, fn)
        torch.cuda.synchronize()
        gloo[0] += time.perf_counter() - t0
        gloo[1] += 1

    marks = {}

    def timed():
        gloo[:] = [0.0, 0]
        marks.update(N.BATCH_STATS)

    C._run = timed_run
    zero_counts()
    out, plain = {}, None
    for name, sync in [("resnet50", False), ("resnet50", True)] + [
            (n, False) for n in ("resnet50_f64",) + DPF_NAMES]:
        model = dp28_model(name, "cuda")
        check(dp28_fingerprint(model) == fingerprints[name],
              f"phase28 {name}: rank {rank}'s build from seed 0 differs "
              f"from the one-rank step's")
        start = dp28_state(model)
        if sync:
            nn.SyncBatchNorm.convert_sync_batchnorm(model)
            check(sum(type(m).__name__ == "SyncBatchNorm"
                      for m in model.modules()) == 53,
                  "phase28: resnet50 converts to 53 SyncBatchNorm layers")
        losses, state, ms = dp28_run(name, model, hcg, timed)
        n = dp28_cell(name)[4] - 1
        host = dp28_host(state)
        solo = torch.load(f"{tmp}/solo_{name}.pt")
        arm = dict(losses=losses, ms=ms, gloo_ms=1e3 * gloo[0] / n,
                   calls=gloo[1] / n,
                   bn_reduces=(N.BATCH_STATS["all_reduces"]
                               - marks["all_reduces"]) / n,
                   bn_bytes=(N.BATCH_STATS["bytes"] - marks["bytes"]) / n,
                   worst=dp28_worst(host, solo),
                   moves=dp28_moves(host, solo, start),
                   state=host if name == "resnet50" else
                   {"buffers": host["buffers"]})
        if name == "resnet50" and not sync:
            plain = host
        elif sync:
            arm["same_as_plain"] = losses == out["resnet50"]["losses"] and \
                all(torch.equal(host[p][k], plain[p][k])
                    for p in ("params", "buffers") for k in plain[p])
        out[name + (" sync" if sync else "")] = arm
        del model, state, host, solo, start
        gc.collect()
        torch.cuda.empty_cache()
    C._run = run
    out["launches"] = flash_counts()
    with open(f"{tmp}/rank28_{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


def phase28_norms(card):
    """(c) LayerNorm, GroupNorm, InstanceNorm2D, LocalResponseNorm,
    SpectralNorm and F.normalize on the card against the CPU from one set
    of weights: the output and the gradients of ``sum(out * g)``, and
    SpectralNorm's advanced u and v, in fp32."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    cases = [("LayerNorm", (768,), (8, 128, 768)),
             ("GroupNorm", (32, 256), (8, 256, 28, 28)),
             ("InstanceNorm2D", (64,), (8, 64, 56, 56)),
             ("LocalResponseNorm", (5,), (8, 96, 55, 55)),
             ("SpectralNorm", ((768, 3072), 0, 1), (768, 3072)),
             ("normalize", (), (64, 4096))]
    worst = {}
    for name, args, shape in cases:
        rng = np.random.RandomState(28)
        x = rng.standard_normal(shape).astype(np.float32)
        g = rng.standard_normal(shape).astype(np.float32)
        res = []
        for dev in ("cpu", "cuda"):
            seed_build(28)
            with nn.building("cpu"):
                layer = (None if name == "normalize"
                         else getattr(nn, name)(*args))
            if layer is not None:
                with torch.no_grad():
                    for p in layer.parameters():
                        p.add_(0.1 * torch.randn(p.shape))
                layer = layer.to(dev)
            xt = torch.from_numpy(x).to(dev).requires_grad_()
            out = F.normalize(xt) if layer is None else layer(xt)
            (out * torch.from_numpy(g).to(dev)).sum().backward()
            res.append([out.detach().cpu(), xt.grad.cpu()] + (
                [] if layer is None else
                [p.grad.cpu() for p in layer.parameters()]
                + [b.detach().cpu() for b in layer.buffers()]))
        worst[name] = max(((a - b).abs() / (1 + b.abs())).max().item()
                          for b, a in zip(*res))
    say(f"phase28 (c) the normalization layers on the card vs the CPU in "
        f"fp32 (output, input and weight gradients, SpectralNorm's u and "
        f"v), largest |cuda - cpu| / (1 + |cpu|): "
        + ", ".join(f"{n} {w:.3e}" for n, w in worst.items())
        + f" (tol {NORM28_TOL:g}); {card}")
    for name, w in worst.items():
        check(w <= NORM28_TOL,
              f"phase28 (c) {name}: card vs CPU differ by {w}")


def phase28(card):
    """Data-parallel vision on two gloo ranks sharing the card, each
    against the one-rank step on the same global batch: (a) resnet50 at
    phase 23's widths (B 64, 224x224x3 bf16 input, fp32 parameters,
    Momentum 0.01, 3 steps) with BatchNorm and with SyncBatchNorm, whose
    batch statistics cover both ranks' rows, and (a2) in float64 (B 16,
    2 steps); (b) the seven families that draw, at phase
    24b's shapes in float64 for 2 steps, the masks each rank's rows of
    the global draw; (c) the normalization layers on the card."""
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase28_")
    zero_counts()
    # cuDNN's default backward algorithms add in a varying order: one
    # order a run lets SyncBatchNorm's run repeat BatchNorm's bit for bit
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    solo = solo28(tmp)
    say("phase28: the data ranks share this one card over gloo (NCCL "
        "refuses two ranks on one device)")
    t_ranks = time.perf_counter()
    mp.start_processes(rank28, args=(tmp, {n: r["fingerprint"] for n, r in
                                           solo.items()}),
                       nprocs=2, join=True, start_method="spawn")
    t_ranks = time.perf_counter() - t_ranks
    ranks = []
    for r in range(2):
        with open(f"{tmp}/rank28_{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    launches = [rk["launches"] for rk in ranks] + [flash_counts()]
    check(all(sum(c) == 0 for c in launches),
          f"phase28: a kernel of B2-B4/B6-B7 launched on a vision path "
          f"that has none: {launches}")
    for name in ("resnet50", "resnet50 sync", "resnet50_f64") + DPF_NAMES:
        one = solo[name.split()[0]]
        f64 = name not in ("resnet50", "resnet50 sync")
        for rk in ranks:
            a = rk[name]
            if f64:
                a["diffs"] = [abs(g - w) / (1 + abs(w))
                              for g, w in zip(a["losses"], one["losses"])]
                a["bounds"] = [VISION_TOL64] * len(a["diffs"])
            else:
                a["diffs"] = [abs(g - w) / abs(w)
                              for g, w in zip(a["losses"], one["losses"])]
                a["bounds"] = [DPV_LOSS_RTOL] + [DPV_LATER_RTOL] * (
                    len(a["diffs"]) - 1)
        a = ranks[0][name]
        tol = (f"tol {VISION_TOL64:g}" if f64 else
               f"the first within {DPV_LOSS_RTOL:g}, the rest within "
               f"{DPV_LATER_RTOL:g}")
        say(f"phase28 {name} dp 2 vs one rank on {card}: losses "
            f"{[round(v, 6) for v in a['losses']]} vs "
            f"{[round(v, 6) for v in one['losses']]} (differences a step, "
            f"largest over the ranks, " + "/".join(
                f"{max(rk[name]['diffs'][i] for rk in ranks):.3e}"
                for i in range(len(a["diffs"])))
            + f"{' relative to 1 + |one|' if f64 else ' relative'}, {tol}); "
            f"state vs "
            f"one rank's, largest |dp - one| / (1 + |one|) "
            + "/".join(f"{rk[name]['worst']:.3e}" for rk in ranks)
            + ", move from the start vs one rank's move (parameters, "
            "running statistics) " + "/".join(
                f"{rk[name]['moves'][0]:.3e}, {rk[name]['moves'][1]:.3e}"
                for rk in ranks)
            + " (rank 0's largest parameter terms, |dp - one| against "
            "|one - start|: " + ", ".join(
                f"{n} {e:.3e} of {m:.3e}" for n, e, m in a["moves"][2])
            + f"){'' if f64 else f' (tol {DPV_PARAM_MOVE:g}, {DPV_STATS_MOVE:g})'}"
            f"; ms/step "
            + "/".join(f"{rk[name]['ms']:.3f} (gloo {rk[name]['gloo_ms']:.3f}"
                       f", {rk[name]['calls']:.0f} calls)" for rk in ranks)
            + f" vs one rank {one['ms']:.3f}; batch-statistics all-reduces "
            f"a step {a['bn_reduces']:.0f} forward + as many backward, "
            f"{a['bn_bytes'] / 2**10:.1f} KiB each way")
        for r, rk in enumerate(ranks):
            a = rk[name]
            check(np.isfinite(a["losses"]).all() and all(
                d <= b for d, b in zip(a["diffs"], a["bounds"])),
                f"phase28 {name} rank {r}: losses {a['losses']} vs one "
                f"rank {one['losses']}: differences {a['diffs']}, bounds "
                f"{a['bounds']}")
            check(a["worst"] <= VISION_TOL64 if f64
                  else a["moves"][0] <= DPV_PARAM_MOVE
                  and a["moves"][1] <= DPV_STATS_MOVE,
                  f"phase28 {name} rank {r}: state vs one rank's: largest "
                  f"{a['worst']:.3e}, moves {a['moves'][:2]}")
        for part in ranks[1][name]["state"]:
            check(all(torch.equal(ranks[0][name]["state"][part][k], v)
                      for k, v in ranks[1][name]["state"][part].items()),
                  f"phase28 {name}: the ranks' {part} differ")
    say("phase28: every arm's running statistics, and resnet50's "
        "parameters, bit-equal across the two ranks")
    check(all(rk["resnet50 sync"]["same_as_plain"] for rk in ranks),
          "phase28 (a): the SyncBatchNorm run is not bit-equal to the "
          "BatchNorm run")
    say("phase28 (a) SyncBatchNorm.convert_sync_batchnorm: losses, "
        "parameters and running statistics bit-equal to the BatchNorm run "
        "on both ranks")
    torch.backends.cudnn.deterministic = was
    phase28_norms(card)
    say(f"phase28 took {time.perf_counter() - t0:.1f} s on {card} (the ranks "
        f"{t_ranks:.1f} s); flash fwd/dq/dkv and fused LN fwd/bwd launches "
        f"(rank 0, rank 1, this process): {launches}")


# ---------------------------------------------------------------- main --

# ------------------------------------------------------------ phase 29 --

# bench_bert_base's widths (bench.py:309-312) through the eager layers
P29 = dict(vocab=30528, d=768, heads=12, ff=3072, layers=12, positions=512)
P29_B, P29_L, P29_PAD = 16, 512, 64
P29_CMP_B, P29_CMP_L, P29_CMP_LAYERS = 2, 128, 2
P29_FP32_TOL, P29_BF16_TOL = 1e-4, 2e-2     # (b): the whole model
P29_TABLE_TOL = 1e-5                        # (c): one function, fp32


def p29_model(layers, dropout, device):
    """A user's own encoder on the eager surface: token and position
    ``Embedding``s, ``layers`` post-LN ``TransformerEncoderLayer``s (gelu)
    and a ``Linear`` head over the vocabulary, built on ``device`` from
    torch's generator."""
    from paddle_tpu_torch import nn

    class EagerEncoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.tok = nn.Embedding(P29["vocab"], P29["d"])
            self.pos = nn.Embedding(P29["positions"], P29["d"])
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                P29["d"], P29["heads"], P29["ff"], dropout=dropout,
                activation="gelu", attn_dropout=dropout), layers)
            self.head = nn.Linear(P29["d"], P29["vocab"])

        def forward(self, ids, mask):
            pos = torch.arange(ids.shape[1], device=ids.device)
            return self.head(self.encoder(self.tok(ids) + self.pos(pos),
                                          mask))

    with nn.building(device):
        return EagerEncoder()


def p29_batch(B, L, device, seed=29):
    """Token ids, labels and a (B, 1, 1, L) bool key-padding mask whose
    odd rows drop their last ``P29_PAD`` keys."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, P29["vocab"], (B, L), generator=g)
    labels = torch.randint(0, P29["vocab"], (B, L), generator=g)
    keep = torch.ones(B, 1, 1, L, dtype=torch.bool)
    keep[1::2, ..., L - P29_PAD:] = False
    return ids.to(device), labels.to(device), keep.to(device)


def p29_loss(model, batch):
    from paddle_tpu_torch import nn
    ids, labels, keep = batch
    logits = model(ids, keep)
    return nn.CrossEntropyLoss()(logits.float().reshape(-1, P29["vocab"]),
                                 labels.reshape(-1))


def p29_worst(got, want):
    """max |got - want| over max(|want|), the tensor's own scale."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def phase29_train(card):
    """(a) the full-width eager train, (a') ``grad`` against ``.grad``
    and (d) ``save``/``load``: returns the flash launches of the 5 timed
    steps and the trained model."""
    import tempfile

    import paddle_tpu_torch as P
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.optimizer import AdamW

    seed_build(29)
    model = p29_model(P29["layers"], 0.1, "cuda").bfloat16()
    n_params = sum(p.numel() for p in model.parameters())
    batch = p29_batch(P29_B, P29_L, "cuda")
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                multi_precision=True)
    rng.seed(29)
    losses = []

    def step():
        loss = p29_loss(model, batch)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())

    flash = (A.flash_fwd_cuda, A.flash_bwd_dq_cuda, A.flash_bwd_dkv_cuda)
    for _ in range(2):
        step()
    for k in flash:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tuple(k.launches for k in flash)
    peak = torch.cuda.max_memory_allocated() / 2**30
    vals = [v.item() for v in losses]
    timed = vals[2:]
    Lyr = P29["layers"]
    check(all(np.isfinite(vals)), f"phase29 (a): non-finite loss in {vals}")
    check(timed[4] < timed[0], f"phase29 (a): the fifth timed loss is not "
                               f"below the first: {timed}")
    check(launches == (Lyr * 5,) * 3,
          f"phase29 (a): flash launches fwd/dq/dkv {launches} != {Lyr} x 5 "
          f"steps each")
    # what the step's 36 residual and activation dropouts cost alone
    from paddle_tpu_torch.nn import functional as F
    shapes = [(P29_B, P29_L, P29["d"])] * 2 + [(P29_B, P29_L, P29["ff"])]
    xs = [torch.zeros(sh, dtype=torch.bfloat16, device="cuda")
          for sh in shapes]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(Lyr):
        for x in xs:
            F.dropout(x, 0.1)
    torch.cuda.synchronize()
    drop_ms = 1e3 * (time.perf_counter() - t0)
    n_drawn = Lyr * sum(x.numel() for x in xs)
    del xs
    say(f"phase29 (a) eager bench_bert_base-width encoder (vocab "
        f"{P29['vocab']}, d {P29['d']}, {P29['heads']} heads, ff "
        f"{P29['ff']}, {Lyr} post-LN TransformerEncoderLayers, "
        f"{n_params} parameters, bf16, B {P29_B}, L {P29_L}, key-padding "
        f"mask, dropout 0.1 and attention dropout 0.1, CrossEntropyLoss, "
        f"eager AdamW multi_precision): losses "
        f"{[round(v, 4) for v in vals]} (2 warm, 5 timed); "
        f"{1e3 * wall / 5:.3f} ms/step, {P29_B * P29_L * 5 / wall:.1f} "
        f"tokens/s, peak memory {peak:.3f} GiB, flash launches fwd/dq/dkv "
        f"a step {[n // 5 for n in launches]}; the step's {3 * Lyr} "
        f"residual and activation dropouts ({n_drawn} threefry draws) "
        f"{drop_ms:.3f} ms alone; {card}")

    # (a') grad of the loss in the token embedding vs its .grad
    w = model.tok.weight
    rng.seed(290)
    p29_loss(model, batch).backward()
    ref = w.grad.clone()
    ptr = w.grad.data_ptr()
    rng.seed(290)
    (got,) = P.grad(p29_loss(model, batch), w)
    check(w.grad.data_ptr() == ptr and torch.equal(w.grad, ref),
          "phase29 (a'): paddle_tpu_torch.grad touched .grad")
    err = p29_worst(got, ref)
    check(err <= P29_BF16_TOL, f"phase29 (a'): grad vs .grad differ by "
                               f"{err:.3e}")
    say(f"phase29 (a') paddle_tpu_torch.grad of the loss in the token "
        f"embedding vs its .grad from a separate backward: largest |diff| "
        f"/ max|.grad| {err:.3e} (tol {P29_BF16_TOL:g}), .grad untouched")
    opt.clear_grad()

    # (d) save, then load into a fresh model on the card: logits bit-equal
    model.eval()
    tmp = tempfile.mkdtemp(prefix="phase29_")
    path = str(Path(tmp) / "eager.pdparams")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    P.save(model.state_dict(), path)
    t_save = time.perf_counter() - t0
    size = Path(path).stat().st_size
    fresh = p29_model(P29["layers"], 0.1, "cuda").bfloat16().eval()
    t0 = time.perf_counter()
    fresh.load_state_dict(P.load(path, device="cuda"))
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    Path(path).unlink()
    Path(tmp).rmdir()
    with torch.no_grad():
        same = torch.equal(model(*batch[::2]), fresh(*batch[::2]))
    check(same, "phase29 (d): the loaded model's logits differ")
    say(f"phase29 (d) save of (a)'s trained state_dict: {size} bytes in "
        f"{t_save:.3f} s, load into a fresh model on the card "
        f"{t_load:.3f} s; logits bit-equal")
    del model, fresh, opt
    return launches


def phase29_cmp(card):
    """(b) the same layers at 2 layers and full width on the card against
    the CPU (plain versions) from one set of weights and one seed, fp32
    (TF32 off) then bf16: the loss and every parameter's gradient."""
    import copy

    from paddle_tpu_torch.core import rng

    seed_build(291)
    cpu = p29_model(P29_CMP_LAYERS, 0.1, "cpu")
    for dt, tol in ((torch.float32, P29_FP32_TOL),
                    (torch.bfloat16, P29_BF16_TOL)):
        res = []
        for dev in ("cpu", "cuda"):
            m = copy.deepcopy(cpu).to(dev, dt)
            rng.seed(291)
            loss = p29_loss(m, p29_batch(P29_CMP_B, P29_CMP_L, dev, 291))
            loss.backward()
            res.append((loss.detach(), {n: p.grad for n, p in
                                        m.named_parameters()}))
        (lc, gc_), (lg, gg) = res
        loss_err = abs(lg.item() - lc.item()) / abs(lc.item())
        # a key bias's gradient is zero in exact arithmetic (a row's
        # softmax ignores a shift of all its scores): both devices give
        # roundoff, held against the largest gradient instead
        big = max(g.abs().max().item() for g in gc_.values())
        kb = [n for n in gc_ if n.endswith("k_proj.bias")]
        kb_err = max((gg[n].float().cpu() - gc_[n].float()).abs().max()
                     .item() for n in kb) / big
        worst = sorted(((p29_worst(gg[n], gc_[n]), n) for n in gc_
                        if n not in kb), reverse=True)[:3]
        say(f"phase29 (b) card vs CPU, {P29_CMP_LAYERS} layers at full width, "
            f"B {P29_CMP_B}, L {P29_CMP_L}, {str(dt)[6:]}, both dropouts on, "
            f"one seed: loss {lg.item():.6f} vs {lc.item():.6f} (rel "
            f"{loss_err:.3e}), largest gradient |diff| / max|cpu| "
            + ", ".join(f"{w:.3e} ({n})" for w, n in worst)
            + f"; the key biases (zero in exact arithmetic) |diff| / the "
            f"largest gradient {kb_err:.3e}; tol {tol:g}; {card}")
        check(loss_err <= tol and worst[0][0] <= tol and kb_err <= tol,
              f"phase29 (b) {dt}: card vs CPU differ: loss {loss_err}, "
              f"{worst[0]}, key biases {kb_err}")


def p29_table():
    """(c)'s rows: (name, call(P, F, *tensors), numpy inputs, layer
    constructor over ``nn`` or None)."""
    r = np.random.RandomState(29)

    def f(*shape, scale=1.0):
        return (r.standard_normal(shape) * scale).astype(np.float32)

    def u(*shape, lo=0.05, hi=0.95):
        return r.uniform(lo, hi, shape).astype(np.float32)

    def i(*shape, hi=5):
        return r.randint(0, hi, shape).astype(np.int64)

    x, m, m2 = f(4, 6, 5, scale=2.0), f(3, 4), f(3, 4)
    img, nhwc = f(2, 4, 6, 8), f(2, 6, 8, 4)
    p2, y2, lbl = f(8, 5), f(8, 5), i(8)
    logp, pm = np.log(u(8, 5)), np.sign(f(8)).astype(np.float32)
    ties = np.array([[3., 1., 3., 2., 1., 3.], [0., 0., 5., 5., 2., 0.]],
                    np.float32)
    ctc = [f(12, 3, 6), np.array([[1, 2, 2, 0], [3, 3, 3, 4], [5, 1, 0, 0]]),
           np.array([12, 10, 9]), np.array([3, 4, 2])]
    acts = ["relu", "relu6", "elu", "selu", "celu", "gelu", "sigmoid",
            "hardsigmoid", "hardswish", "hardtanh", "hardshrink",
            "softshrink", "tanhshrink", "leaky_relu", "rrelu", "log_sigmoid",
            "silu", "swish", "mish", "softplus", "softsign", "tanh",
            "thresholded_relu", "softmax", "log_softmax"]
    rows = [(f"F.{a}", lambda P, F, t, a=a: getattr(F, a)(t), [x], None)
            for a in acts]
    rows += [
        ("F.gelu tanh", lambda P, F, t: F.gelu(t, True), [x], None),
        ("F.glu", lambda P, F, t: F.glu(t, 1), [x], None),
        ("F.maxout", lambda P, F, t: F.maxout(t, 2), [x], None),
        ("F.prelu", lambda P, F, t, w: F.prelu(t, w), [x, u(6)], None),
        ("losses a", lambda P, F, a, b: [
            F.mse_loss(a, b), F.l1_loss(a, b, "sum"),
            F.smooth_l1_loss(a, b, delta=0.5),
            F.cosine_embedding_loss(a, b, P.sign(a[:, 0])),
            F.triplet_margin_loss(a, b, a * 0.5, swap=True),
            F.square_error_cost(a, b), F.npair_loss(a, b, P.arange(8) % 3),
            F.binary_cross_entropy_with_logits(a, P.sigmoid(b)),
            F.sigmoid_focal_loss(a, P.round(P.sigmoid(b))),
            F.softmax_with_cross_entropy(a, P.argmax(b, 1, True)),
            F.kl_div(F.log_softmax(a, 1), F.softmax(b, 1), "batchmean")],
         [p2, y2], None),
        ("losses b", lambda P, F, lp, y, q: [
            F.nll_loss(lp, y), F.nll_loss(lp, y, reduction="none"),
            F.binary_cross_entropy(q, q * 0.5), F.log_loss(q[:, :1], q[:, 1:2]),
            F.margin_ranking_loss(lp[:, 0], lp[:, 1], P.sign(lp[:, 2] + 1)),
            F.hinge_embedding_loss(lp[:, 0], P.sign(lp[:, 2] + 1)),
            F.dice_loss(q[None], y[None, :, None] % 5)],
         [logp, lbl, u(8, 5)], None),
        ("F.ctc_loss", lambda P, F, a, b, c, d: [
            F.ctc_loss(a, b, c, d), F.ctc_loss(a, b, c, d, 0, "none")], ctc,
         None),
        ("common", lambda P, F, im, th, g: [
            F.interpolate(im, [9, 13], mode="bilinear"),
            F.interpolate(im, [3, 5], mode="bicubic"),
            F.interpolate(im, [9, 13], mode="bilinear", align_corners=True),
            F.interpolate(im, scale_factor=2), F.pixel_shuffle(im, 2),
            F.pixel_unshuffle(im, 2), F.channel_shuffle(im, 2),
            F.pad(im, [1, 2, 2, 1], "reflect"), F.pad(im, [2, 1, 0, 3]),
            F.affine_grid(th, [2, 3, 5, 7]), F.grid_sample(im, g),
            F.grid_sample(im, g, mode="nearest"), F.unfold(im, [2, 3]),
            F.temporal_shift(im, 2), F.diag_embed(im[0, 0], 1),
            F.zeropad2d(im, [1, 0, 2, 1])],
         [img, f(2, 2, 3, scale=0.5), u(2, 5, 7, 2, lo=-1.2, hi=1.2)], None),
        ("common nhwc", lambda P, F, t: [
            F.interpolate(t, scale_factor=1.5, mode="bilinear",
                          data_format="NHWC"),
            F.pixel_shuffle(t, 2, "NHWC"),
            F.pad(t, [2, 1, 3, 0], "replicate", data_format="NHWC")],
         [nhwc], None),
        ("embedding etc", lambda P, F, ids, w, a, b: [
            F.embedding(ids, w, 2), F.one_hot(ids, 7),
            F.label_smooth(F.one_hot(ids, 7), epsilon=0.2),
            F.cosine_similarity(a, b), F.sequence_mask(ids[0], 7),
            F.bilinear(a[:, :3], b, w[:2, :3, None].expand(2, 3, 5))],
         [i(3, 5, hi=7), f(7, 4), p2, y2], None),
        ("tensor math", lambda P, F, a, b: [
            P.exp(a), P.log(P.abs(a) + 1), P.sqrt(P.abs(a)), P.erf(a),
            P.erfinv(P.clip(a, -0.9, 0.9) * 0.9), P.lgamma(P.abs(a) + 1),
            P.digamma(P.abs(a) + 1), P.atan2(a, b), P.logaddexp(a, b),
            P.hypot(a, b), P.pow(P.abs(a), b), P.fmax(a, b),
            P.remainder(a, b), P.floor_divide(a, b), P.scale(a, 2.0, 0.5),
            P.sum(a, [0, 1], True), P.mean(a, -1), P.prod(a, 1),
            P.logsumexp(a, 1), P.amax(a, 0), P.nanmean(a),
            P.cumsum(a, 1), P.cumprod(a), P.diff(a), P.trace(a),
            P.matmul(a, b, transpose_y=True), P.dist(a, b, 1),
            P.einsum("ij,kj->ik", a, b), P.lerp(a, b, 0.3),
            P.take(a, P.to_tensor([[0, 11], [5, 13]]), mode="wrap")],
         [m, m2], None),
        ("tensor order", lambda P, F, a, t: [
            P.argmax(a, 1), P.argsort(t), P.argsort(t, descending=True),
            *P.topk(t, 3), *P.topk(t, 4, largest=False), *P.kthvalue(t, 3),
            *P.mode(t), *P.cummax(t, 1), P.sort(t, 1, True),
            P.searchsorted(P.sort(a.reshape([-1])), a),
            P.median(a, 1), P.quantile(a, [0.25, 0.75], 1), P.var(a, 0),
            P.std(a), P.nanmedian(a), *P.unique(t, True, True, True),
            P.nonzero(a > 0), P.masked_select(a, a > 0)],
         [m, ties], None),
        ("tensor layout", lambda P, F, a: [
            P.gather(a, P.to_tensor([2, 0])), P.gather_nd(
                a, P.to_tensor([[0, 1], [2, 3]])),
            P.scatter(a, P.to_tensor([2, 0]), a[:2] * 2),
            P.scatter_nd_add(a, P.to_tensor([[0, 1], [2, 2]]), a[0, :2]),
            P.put_along_axis(a, P.to_tensor([[0], [3], [2]]), 2.0, 1, "add"),
            P.index_add(a, P.to_tensor([0, 2]), 0, a[:2]),
            P.index_put(a, (P.to_tensor([0, 2]), P.to_tensor([1, 3])),
                        P.to_tensor(5.0)),
            P.repeat_interleave(a, 2, 1), P.roll(a, [1, -1], [0, 1]),
            P.flip(a, [0, 1]), P.rot90(a), P.tile(a, [2, 1]),
            P.strided_slice(a, [1], [3], [0], [-2]), *P.split(a, [1, -1], 1),
            P.stack([a, a], 1), P.unsqueeze(a, [0, 3]),
            P.pad(a, [1, 0, 0, 2], "replicate"), P.masked_fill(a, a > 0, 0.),
            P.tensordot(a, a, [[1], [1]]), P.where(a > 0, a, -a),
            P.as_real(P.as_complex(P.reshape(a, [3, 2, 2]))),
            P.zeros([2, 3]), P.arange(1, 7, 2), P.linspace(0, 1, 5),
            P.eye(2, 4), P.full([2], 3), P.diag(a[0], 1)]
            + [getattr(P, n)(a > 0, a < 0.5) for n in (
                "logical_and", "logical_or", "logical_xor", "equal")],
         [m], None),
    ]
    layers = [
        ("nn.PReLU", lambda nn: nn.PReLU(6, 0.1), [x]),
        ("nn.GELU", lambda nn: nn.GELU(True), [x]),
        ("nn.Maxout", lambda nn: nn.Maxout(3), [x]),
        ("nn.Embedding", lambda nn: nn.Embedding(7, 4, padding_idx=1),
         [i(3, 5, hi=7)]),
        ("nn.Bilinear", lambda nn: nn.Bilinear(5, 5, 2), [p2, y2]),
        ("nn.Upsample", lambda nn: nn.UpsamplingBilinear2D([7, 9]), [img]),
        ("nn.Pad2D", lambda nn: nn.Pad2D([1, 2, 2, 1], "circular"), [img]),
        ("nn.PairwiseDistance", lambda nn: nn.PairwiseDistance(3.0),
         [p2, y2]),
        ("nn.Fold", lambda nn: nn.Fold([4, 5], [2, 2]), [f(2, 8, 12)]),
        ("nn.Unflatten", lambda nn: nn.Unflatten(1, [2, 3]), [x]),
        ("nn.CrossEntropyLoss", lambda nn: nn.CrossEntropyLoss(), [p2, lbl]),
        ("nn.CTCLoss", lambda nn: nn.CTCLoss(), ctc),
        ("nn.MultiHeadAttention L 128 (flash)",
         lambda nn: nn.MultiHeadAttention(128, 2, dropout=0.1),
         [f(2, 128, 128)]),
        ("nn.MultiHeadAttention L 96 need_weights",
         lambda nn: nn.MultiHeadAttention(128, 2, dropout=0.1,
                                          need_weights=True),
         [f(2, 96, 128)]),
        ("nn.TransformerEncoder L 128 (flash)",
         lambda nn: nn.TransformerEncoder(nn.TransformerEncoderLayer(
             128, 2, 256, 0.1, "gelu"), 2), [f(2, 128, 128)]),
        ("nn.Transformer L 128/96 (flash encoder)",
         lambda nn: nn.Transformer(128, 2, 1, 1, 256, 0.1),
         [f(2, 128, 128), f(2, 96, 128)]),
    ]
    rows += [(n, None, ins, ctor) for n, ctor, ins in layers]
    return rows


def p29_outputs(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in p29_outputs(o)]
    return [out]


def p29_run(call, ctor, layer, arrays, dev):
    """One device's run of a (c) row: every output, then the gradients of
    ``sum(out * g)`` over the first output's float inputs and
    parameters."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.core import rng
    from paddle_tpu_torch.nn import functional as F

    ts = [torch.from_numpy(a.copy()).to(dev) for a in arrays]
    for t in ts:
        if t.is_floating_point():
            t.requires_grad_()
    rng.seed(29)
    with nn.building(dev):
        out = layer(*ts) if ctor is not None else call(P, F, *ts)
    outs = p29_outputs(out)
    grads = []
    first = outs[0]
    if first.is_floating_point() and first.requires_grad:
        g = torch.from_numpy(np.random.RandomState(7).standard_normal(
            tuple(first.shape)).astype(np.float32)).to(dev, first.dtype)
        (first * g).sum().backward()
        grads = [t.grad for t in ts if t.grad is not None] + (
            [p.grad for p in layer.parameters()] if ctor is not None else [])
    return [o.detach().cpu() for o in outs], [g.cpu() for g in grads]


def phase29_table(card):
    """(c) every function and layer of this slice, card against CPU from
    one set of inputs and weights: outputs (integer, bool and index ones
    exactly) and gradients."""
    import copy

    from paddle_tpu_torch import nn

    worst, exact = {}, 0
    for name, call, arrays, ctor in p29_table():
        layer = {}
        if ctor is not None:
            seed_build(29)
            with nn.building("cpu"):
                layer["cpu"] = ctor(nn)
            layer["cuda"] = copy.deepcopy(layer["cpu"]).to("cuda")
        (oc, gc_), (og, gg) = (p29_run(call, ctor, layer.get(d), arrays, d)
                               for d in ("cpu", "cuda"))
        check(len(oc) == len(og) and len(gc_) == len(gg),
              f"phase29 (c) {name}: output counts differ")
        w_o = w_g = 0.0
        for a, b in zip(og, oc):
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"phase29 (c) {name}: {a.dtype} {tuple(a.shape)} vs "
                  f"{b.dtype} {tuple(b.shape)}")
            if not (b.is_floating_point() or b.is_complex()):
                check(torch.equal(a, b), f"phase29 (c) {name}: an integer "
                                         f"or bool output differs")
                exact += 1
            elif b.numel():
                w_o = max(w_o, ((a - b).abs().max()
                                / b.abs().max().clamp_min(1.0)).item())
        for a, b in zip(gg, gc_):
            w_g = max(w_g, ((a - b).abs().max()
                            / b.abs().max().clamp_min(1.0)).item())
        worst[name] = (w_o, w_g)
        check(w_o <= P29_TABLE_TOL and w_g <= P29_TABLE_TOL,
              f"phase29 (c) {name}: card vs CPU differ by {w_o:.3e} "
              f"(outputs), {w_g:.3e} (gradients)")
    say(f"phase29 (c) {len(worst)} rows of the slice's functions and layers "
        f"on the card vs the CPU in fp32 ({exact} integer, bool or index "
        f"outputs bit-equal), largest |cuda - cpu| / max(1, max|cpu|) "
        f"(outputs, gradients): "
        + ", ".join(f"{n} {o:.1e}/{g:.1e}" for n, (o, g) in worst.items())
        + f" (tol {P29_TABLE_TOL:g}); {card}")


def phase29(card):
    """The eager surface a user's own model touches: (a) a full-width
    eager train through ``nn.Embedding``/``nn.TransformerEncoderLayer``/
    ``nn.Linear``/``nn.CrossEntropyLoss`` and the eager AdamW, its
    attention on the flash kernels, (a') ``grad``, (b) the same layers
    card vs CPU at 2 layers, (c) every function and layer of the slice
    card vs CPU, (d) ``save``/``load``.  Returns (a)'s flash launches."""
    t0 = time.perf_counter()
    launches = phase29_train(card)
    gc.collect()
    torch.cuda.empty_cache()
    phase29_cmp(card)
    phase29_table(card)
    say(f"phase29 took {time.perf_counter() - t0:.1f} s on {card}")
    return launches


# ------------------------------------------------------------ phase 30 --

P30_N = 1 << 20                 # draws a law
P30_ULPS = 4                    # the normal laws, card vs CPU (fp32)
P30_FLIPS = 1e-4                # the discrete laws' share of flipped draws
P30_TIE = 1e-4                  # a beam step's top candidates this close
# the PTB "medium" LSTM language model of Zaremba, Sutskever & Vinyals
# (arXiv:1409.2329): its widths, unrolling, batch, dropout and optimizer;
# the layers' default initializers (its +-0.05 needs ParamAttr)
PTB = {"vocab": 10000, "hidden": 650, "layers": 2, "steps": 35,
       "batch": 20, "dropout": 0.5, "lr": 1.0, "clip": 5.0}
P30_BEAM = 4
P30_KERNELS = ("ragged_paged_attention.ragged_attention_cuda",
               "attention.flash_fwd_cuda", "attention.flash_bwd_dq_cuda",
               "attention.flash_bwd_dkv_cuda", "fused.fused_ln_fwd_cuda",
               "fused.fused_ln_bwd_cuda", "fused.fused_adamw_flat_cuda",
               "paged_attention.paged_decode_attention_cuda")


def p30_launches():
    """Every kernel wrapper's launch count, by name."""
    import importlib
    out = {}
    for path in P30_KERNELS:
        mod, fn = path.split(".")
        out[fn] = getattr(importlib.import_module(
            f"paddle_tpu_torch.ops.{mod}"), fn).launches
    return out


def p30_ulps(got, want, at_scale=False):
    """The largest fp32 ulp distance of ``got`` from ``want`` (of
    max(1, |want|) with ``at_scale``)."""
    g = got.detach().float().cpu().numpy()
    w = want.detach().float().cpu().numpy()
    if at_scale:
        ulp = np.spacing(np.maximum(1.0, np.abs(w)).astype(np.float32))
        return float((np.abs(g.astype(np.float64) - w) / ulp).max())
    return int(np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64)).max())


def phase30_laws(card):
    """(a) every law of ``core.rng`` at 2^20 draws on the card against the
    same draw on the CPU; one 4096^2 uniform, normal and randint draw
    timed against its bytes bound."""
    from paddle_tpu_torch.core import rng

    key, n = rng.make_key(30), P30_N
    r = np.random.RandomState(30)
    lam = torch.from_numpy(r.uniform(0, 30, n).astype(np.float32))
    count = torch.from_numpy(r.randint(0, 200, n).astype(np.float32))
    prob = torch.from_numpy(r.uniform(0, 1, n).astype(np.float32))
    logits = torch.from_numpy(r.randn(n, 8).astype(np.float32))
    f32, f64 = torch.float32, torch.float64
    exact = {
        "bits8": lambda d: rng.random_bits(key, 8, (n,), d),
        "bits16": lambda d: rng.random_bits(key, 16, (n,), d),
        "bits32": lambda d: rng.random_bits(key, 32, (n,), d),
        "bits64": lambda d: rng.random_bits(key, 64, (n,), d),
        "uniform_f32": lambda d: rng.uniform(key, (n,), f32, -0.3, 2.7, d),
        "uniform_bf16": lambda d: rng.uniform(key, (n,), torch.bfloat16,
                                              -1e-2, 1e-2, d),
        "uniform_fp16": lambda d: rng.uniform(key, (n,), torch.float16,
                                              -0.3, 2.7, d),
        "uniform_f64_unit": lambda d: rng.uniform(key, (n,), f64, device=d),
        "bernoulli": lambda d: rng.bernoulli(key, 0.3, (n,), f32, d),
        "randint": lambda d: rng.randint(key, (n,), -5, 1000003, device=d),
        "randint_int8": lambda d: rng.randint(key, (n,), -3, 300,
                                              torch.int8, d),
        "permutation": lambda d: rng.permutation(key, n, device=d),
    }
    close = {
        "normal": (lambda d: rng.normal(key, (n,), f32, d), False),
        "truncated_normal": (lambda d: rng.truncated_normal(
            key, -2.0, 2.0, (n,), f32, d), False),
        "exponential": (lambda d: rng.exponential(key, (n,), f32, d), False),
        "gumbel": (lambda d: rng.gumbel(key, (n,), f32, d), True),
    }
    discrete = {
        "categorical": lambda d: rng.categorical(key, logits.to(d)),
        "poisson": lambda d: rng.poisson(key, lam.to(d)),
        "binomial": lambda d: rng.binomial(key, count.to(d), prob.to(d)),
    }
    rows = []
    for name, draw in exact.items():
        t0 = time.perf_counter()
        got = draw("cuda")
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        want = draw("cpu")
        same = torch.equal(got.cpu(), want)
        check(same, f"phase30 (a): {name} on the card is not the CPU's draw")
        rows.append(f"{name} equal ({t_card * 1e3:.1f} ms cold)")
    got = rng.uniform(key, (n,), f64, -0.3, 2.7, "cuda").cpu()
    want = rng.uniform(key, (n,), f64, -0.3, 2.7, "cpu")
    u64 = int((got.view(torch.int64) - want.view(torch.int64)).abs().max())
    check(u64 <= 1, f"phase30 (a): uniform_f64 [-0.3, 2.7) is {u64} ulp "
                    f"from the CPU's (tol 1)")
    rows.append(f"uniform_f64 {u64} ulp")
    for name, (draw, at_scale) in close.items():
        u = p30_ulps(draw("cuda"), draw("cpu"), at_scale)
        check(u <= P30_ULPS, f"phase30 (a): {name} is {u} ulp from the "
                             f"CPU's (tol {P30_ULPS})")
        rows.append(f"{name} {u:g} ulp" + (" of max(1,|x|)" if at_scale
                                           else ""))
    for name, draw in discrete.items():
        got, want = draw("cuda").cpu(), draw("cpu")
        flips = int((got != want).sum()) if got.dtype != f32 else int(
            ((got != want) & ~(got.isnan() & want.isnan())).sum())
        check(flips <= P30_FLIPS * n, f"phase30 (a): {name} flips {flips} "
              f"of {n} draws (tol {P30_FLIPS:g})")
        rows.append(f"{name} {flips} flips")
    say(f"phase30 (a): every law at {n} draws, card vs CPU: "
        + "; ".join(rows) + f"; {card}")
    side = 4096
    nbytes = side * side * 4
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    for name, draw in (
            ("uniform", lambda: rng.uniform(key, (side, side), f32,
                                            device="cuda")),
            ("normal", lambda: rng.normal(key, (side, side), f32, "cuda")),
            ("randint", lambda: rng.randint(key, (side, side), 0, 1000,
                                            device="cuda"))):
        ms = time_cold_ms(draw, iters=5, warmup=1)
        say(f"phase30 (a): one {side}x{side} {name} draw (f32/int32) "
            f"{ms:.3f} ms, its bytes bound {bound:.4f} ms ({ms / bound:.0f}x;"
            f" {nbytes} bytes written) on {card}")


def p30_model(cfg, device, seed=0):
    """A user's PTB LSTM language model (embedding, dropout, ``nn.LSTM``
    with dropout between layers, dropout, linear head) built on
    ``device`` after ``seed(seed)``."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F

    class PTBModel(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embedding = nn.Embedding(cfg["vocab"], cfg["hidden"])
            self.lstm = nn.LSTM(cfg["hidden"], cfg["hidden"],
                                num_layers=cfg["layers"],
                                dropout=cfg["dropout"])
            self.head = nn.Linear(cfg["hidden"], cfg["vocab"])

        def forward(self, ids, states):
            p = cfg["dropout"]
            x = F.dropout(self.embedding(ids), p, training=self.training)
            out, states = self.lstm(x, states)
            out = F.dropout(out, p, training=self.training)
            return self.head(out), states

    P.seed(seed)
    with nn.building(device):
        return PTBModel()


def p30_data(cfg, n_steps, device):
    """A token stream cut into ``n_steps`` windows of (batch, steps)
    inputs and their next tokens: Zipf-distributed ids (p(k) ~ 1/(k+1),
    RandomState(30)), as word frequencies are, so a few steps lower the
    loss below log(vocab)."""
    r = np.random.RandomState(30)
    p = 1.0 / np.arange(1, cfg["vocab"] + 1)
    toks = torch.from_numpy(r.choice(cfg["vocab"], (
        cfg["batch"], n_steps * cfg["steps"] + 1), p=p / p.sum())).to(device)
    S = cfg["steps"]
    return [(toks[:, i * S:(i + 1) * S], toks[:, i * S + 1:(i + 1) * S + 1])
            for i in range(n_steps)]


def p30_trainer(model, cfg, device):
    """One truncated-BPTT step (the states carried, detached): the loss,
    after SGD with the global-norm clip."""
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import SGD

    opt = SGD(learning_rate=cfg["lr"], parameters=model.parameters(),
              grad_clip=nn.ClipGradByGlobalNorm(cfg["clip"]))
    shape = (cfg["layers"], cfg["batch"], cfg["hidden"])
    state = [(torch.zeros(shape, device=device),
              torch.zeros(shape, device=device))]

    def step(ids, labels, grads=None):
        logits, (h, c) = model(ids, state[0])
        loss = F.cross_entropy(logits.reshape(-1, cfg["vocab"]),
                               labels.reshape(-1))
        loss.backward()
        if grads is not None:
            grads.append({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        state[0] = (h.detach(), c.detach())
        return loss.detach()
    return step


def phase30_ptb(card):
    """(b) the PTB medium LSTM LM: built on the card after ``seed(0)``
    bit-equal to the CPU build, 2 warm and 5 timed eager steps, 2 more
    under the profiler (the device's idle share); card vs
    CPU at 2 layers of 64.  Returns the trained card model and the CPU
    build."""
    model = p30_model(PTB, "cuda")
    cpu = p30_model(PTB, "cpu")
    for (n, p), (_, q) in zip(model.named_parameters(),
                              cpu.named_parameters()):
        check(torch.equal(p.detach().cpu(), q.detach()),
              f"phase30 (b): {n} built on the card is not the CPU build")
    n_params = sum(p.numel() for p in model.parameters())
    data = p30_data(PTB, 7, "cuda")
    model.train()
    step = p30_trainer(model, PTB, "cuda")
    losses = [step(*data[i]) for i in range(2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses += [step(*data[i]) for i in range(2, 7)]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    # two more steps under the profiler: the device's busy share of a step
    prof = start_profile(cpu=False)
    for i in (5, 6):
        step(*data[i])
    report_profile(prof, 2)
    busy = report_profile.last
    vals = [float(v) for v in losses]
    check(all(np.isfinite(vals)), f"phase30 (b): non-finite loss {vals}")
    check(vals[-1] < vals[0], f"phase30 (b): the last loss is not below "
                              f"the first: {vals}")
    tokens = PTB["batch"] * PTB["steps"]
    say(f"phase30 (b): PTB medium LSTM LM ({n_params} parameters, vocab "
        f"{PTB['vocab']}, {PTB['layers']}x{PTB['hidden']}, {PTB['steps']} "
        f"steps, batch {PTB['batch']}, dropout {PTB['dropout']}, SGD lr "
        f"{PTB['lr']}, global-norm clip {PTB['clip']}) built bit-equal to "
        f"the CPU build; {ms:.2f} ms/step, {tokens / ms * 1e3:.0f} tokens/s,"
        f" peak {peak:.2f} GiB over 5 timed eager steps; 2 profiled steps: "
        f"device busy {busy['busy_ms']:.3f} of {busy['wall_ms']:.3f} ms a "
        f"step ({100 * (1 - busy['busy_share']):.1f}% idle), "
        f"{busy['kernels']:.0f} device kernels a step; losses "
        + " ".join(f"{v:.4f}" for v in vals) + f"; {card}")
    small = dict(PTB, hidden=64)
    worst = {}
    runs = []
    for dev in ("cuda", "cpu"):
        m = p30_model(small, dev)
        m.train()
        st = p30_trainer(m, small, dev)
        grads = []
        losses = [float(st(ids, lab, grads))
                  for ids, lab in p30_data(small, 2, dev)]
        runs.append((losses, grads))
    (l_card, g_card), (l_cpu, g_cpu) = runs
    for a, b in zip(l_card, l_cpu):
        worst["loss"] = max(worst.get("loss", 0.0), abs(a - b) / max(1.0,
                                                                     abs(b)))
    for ga, gb in zip(g_card, g_cpu):
        for name in gb:
            scale = max(1.0, float(gb[name].abs().max()))
            err = float((ga[name] - gb[name]).abs().max()) / scale
            worst[name] = max(worst.get(name, 0.0), err)
    bad = {k: v for k, v in worst.items() if v > 1e-5}
    check(not bad, f"phase30 (b): card vs CPU at 2x64 past 1e-5: {bad}")
    say(f"phase30 (b): card vs CPU at 2 layers of 64, 2 steps with the "
        f"reference's dropout masks: worst loss {worst.pop('loss'):.2e}, "
        f"worst gradient {max(worst.values()):.2e} of the tensor's scale "
        f"(tol 1e-5); {card}")
    return model, cpu


def phase30_decode(card, model, cpu):
    """(c) ``dynamic_decode`` of a ``BeamSearchDecoder`` over
    ``LSTMCell(650, 650)`` with (b)'s trained embedding and head, beam 4,
    batch 20, 35 steps: card vs CPU and ms a call."""
    import paddle_tpu_torch as P
    from paddle_tpu_torch import nn

    with torch.no_grad():
        cpu.embedding.weight.copy_(model.embedding.weight.cpu())
        cpu.head.weight.copy_(model.head.weight.cpu())
        cpu.head.bias.copy_(model.head.bias.cpu())
    model.eval()
    cpu.eval()

    class Recording(nn.BeamSearchDecoder):
        """Keeps each step's top K + 1 totals (the candidates a tie could
        swap)."""
        tops = None

        def _top(self, flat):
            if self.tops is not None:
                self.tops.append(torch.sort(flat, dim=-1, descending=True
                                            ).values[:, :self.beam_size + 1]
                                 .cpu())
            return super()._top(flat)

    out = {}
    H, B, S = PTB["hidden"], PTB["batch"], PTB["steps"]
    for dev, m in (("cuda", model), ("cpu", cpu)):
        P.seed(1)
        with nn.building(dev):
            cell = nn.LSTMCell(H, H)
        dec = Recording(cell, 0, 1, P30_BEAM, embedding_fn=m.embedding,
                        output_fn=m.head)
        dec.tops = [] if dev == "cpu" else None
        init = (torch.zeros(B, H, device=dev), torch.zeros(B, H, device=dev))
        with torch.no_grad():
            ids, lp = nn.dynamic_decode(dec, init, max_step_num=S)
            if dev == "cuda":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    nn.dynamic_decode(dec, init, max_step_num=S)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 3 * 1e3
        out[dev] = (ids.cpu(), lp.cpu(), dec.tops)
    (ids_c, lp_c, _), (ids_h, lp_h, tops) = out["cuda"], out["cpu"]
    check(ids_c.shape == ids_h.shape, f"phase30 (c): ids {tuple(ids_c.shape)}"
                                      f" vs {tuple(ids_h.shape)}")
    ties, worst = [], 0.0
    for b in range(B):
        diff = (ids_c[b] != ids_h[b]).any(dim=0).nonzero()
        if len(diff):
            t = int(diff[0])
            gap = float((tops[t][b][:-1] - tops[t][b][1:]).min())
            check(gap < P30_TIE, f"phase30 (c): row {b} leaves the CPU's "
                  f"ids at step {t}, whose top candidates are {gap:.2e} "
                  f"apart (a tie is under {P30_TIE:g})")
            ties.append(f"row {b} step {t} (gap {gap:.1e})")
        else:
            worst = max(worst, float((lp_c[b] - lp_h[b]).abs().max()))
    check(worst <= 1e-4, f"phase30 (c): log-probs {worst:.2e} from the "
                         f"CPU's (tol 1e-4)")
    say(f"phase30 (c): dynamic_decode, BeamSearchDecoder over LSTMCell({H},"
        f" {H}) with (b)'s embedding and head, beam {P30_BEAM}, batch {B}, "
        f"{ids_c.shape[-1]} steps: {ms:.1f} ms a call; ids equal the CPU's "
        f"in {B - len(ties)} of {B} rows"
        + (f", the rest leaving at a tie: {', '.join(ties)}" if ties else "")
        + f"; log-probs within {worst:.2e}; {card}")


def phase30(card):
    """The random surface on ``core.rng``, the RNNs and beam decoding:
    (a) every law card vs CPU, (b) the PTB medium LSTM LM, (c) beam
    search.  No kernel of the port lies on this path: the phase checks
    that it launched none."""
    t0 = time.perf_counter()
    before = p30_launches()
    phase30_laws(card)
    model, cpu = phase30_ptb(card)
    phase30_decode(card, model, cpu)
    after = p30_launches()
    check(after == before, f"phase30: kernels launched on a path with "
                           f"none: {before} -> {after}")
    say(f"phase30 took {time.perf_counter() - t0:.1f} s on {card}")


def kernel_row(name, source, replaces, launches, r):
    """One entry of the kernels JSON from a timing dict."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")}}


def demangle(symbol):
    """A kernel's C++ name from its mangled one, through the toolkit's
    ``cu++filt`` (the mangled name where that fails)."""
    from paddle_tpu_torch.ops import _build

    tool = Path(_build.nvcc_path()).parent / "cu++filt"
    try:
        out = subprocess.run([str(tool), symbol], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return symbol
    name = out.stdout.strip() if out.returncode == 0 else ""
    return name.replace("(anonymous namespace)::", "") or symbol


def say_shared_memory():
    """The dynamic shared memory a block of each 16-bit flash kernel, of
    the ragged tile kernel, of the paged decode tile kernel and of the LN
    backward takes (ptxas reports static memory only)."""
    import ctypes

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import paged_attention as pa

    fa = _build.load_library("flash_attention")
    ra = _build.load_library("ragged_paged_attention")
    for hd in (64, 128):
        flash = ", ".join(f"{name} {fa.flash_smem_bytes(i, hd)}" for i, name
                          in enumerate(("flash_fwd_wgmma",
                                        "flash_bwd_dq_wgmma",
                                        "flash_bwd_dkv_wgmma")))
        say(f"  shared memory at hd {hd} (bytes a block): {flash}; "
            f"ragged_tiles 16-bit q {ra.ragged_smem_bytes(2, hd)}, fp32 q "
            f"{ra.ragged_smem_bytes(0, hd)}")
    pd = _build.load_library("paged_attention")
    for label, dtype, nh, hd, el in (
            ("bf16 nh 12 hd 64 (the serve)", 2, 12, 64, 2),
            ("fp32 nh 12 hd 128", 0, 12, 128, 4)):
        tile = pa.decode_tile_positions(nh, hd, el)
        say(f"  paged_decode_attention_kernel at {label}: {tile}-position "
            f"tiles, {pd.paged_decode_smem_bytes(dtype, hd, nh, tile)} bytes "
            f"a block")
    fu = _build.load_library("fused")
    for label, dtype, H, vec in (("bf16 H 768 (BERT)", 2, 768, 1),
                                 ("fp32 H 768", 0, 768, 1),
                                 ("fp32 H 1024", 0, 1024, 1),
                                 ("bf16 H 768 scalar", 2, 768, 0),
                                 ("bf16 H 2000", 2, 2000, 1)):
        shape = (ctypes.c_int * 3)()
        check(fu.fused_ln_bwd_shape(dtype, H, vec, shape) == 0,
              "fused_ln_bwd_shape failed")
        sums = (f"{shape[2]} chunks a lane in registers" if shape[2] else
                "sums in shared memory")
        say(f"  ln_bwd_kernel at {label}: {shape[0]} warps, {shape[1]} bytes "
            f"a block, {sums}")


def phase0():
    """Build every kernel library (one nvcc a source, all at once) and
    print ptxas's registers, spills and static shared memory a kernel, then
    the dynamic shared memory of the kernels that size it at launch."""
    from paddle_tpu_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all(verbose=True)
    say(f"phase0 build: {sorted(logs) or 'cached'} in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry function" in line:
                say(f"  ptxas {name}: {demangle(line.split(chr(39))[1])}")
            elif "registers" in line or "spill" in line:
                say(f"  ptxas {name}:   {line.strip()}")
    say_shared_memory()


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


T_START = time.perf_counter()
_LAP = [T_START]


def lap(name):
    """Print the time since the last lap: one phase's wall time."""
    now = time.perf_counter()
    say(f"lap {name}: {now - _LAP[0]:.1f} s ({now - T_START:.1f} s since "
        f"the start)")
    _LAP[0] = now


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    try:
        from paddle_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the paddle_tpu_torch package is missing ({e}); run from the "
             f"repository root")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    phase0()
    lap("phase0")

    main_pack, err, int8_pack, decode_pack = phase1()
    lap("phase1")
    phase2()
    lap("phase2")
    launches, plain_streams, plain_streams8 = phase3()
    lap("phase3")
    phase4()
    lap("phase4")
    phase5()
    lap("phase5")
    flash_launches = phase6()
    lap("phase6")
    adamw_launches = phase7()
    lap("phase7")
    phase8()
    lap("phase8")
    ln_launches = phase9()
    lap("phase9")
    decode_err = phase10()
    lap("phase10")
    phase11()
    lap("phase11")
    decode_launches = phase12()
    lap("phase12")
    phase13()
    lap("phase13")
    phase14(plain_streams, plain_streams8)
    lap("phase14")
    phase15()
    lap("phase15")
    gc.collect()
    phase16()
    lap("phase16")
    gc.collect()
    gen_launches = phase17(card)
    lap("phase17")
    gc.collect()
    tel_launches = phase18(card)
    lap("phase18")
    gc.collect()
    moe_launches = phase19(card)
    lap("phase19")
    gc.collect()
    torch.cuda.empty_cache()
    fleet_launches = phase20(card)
    lap("phase20")
    gc.collect()
    torch.cuda.empty_cache()
    dp_launches = phase21(card)
    lap("phase21")
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_launches = phase22(card)
    lap("phase22")
    gc.collect()
    torch.cuda.empty_cache()
    phase23(card)
    lap("phase23")
    gc.collect()
    torch.cuda.empty_cache()
    phase24(card)
    lap("phase24")
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = phase25(card)
    lap("phase25")
    gc.collect()
    torch.cuda.empty_cache()
    ep_launches = phase26(card)
    lap("phase26")
    gc.collect()
    torch.cuda.empty_cache()
    pp_launches = phase27(card)
    lap("phase27")
    gc.collect()
    torch.cuda.empty_cache()
    phase28(card)
    lap("phase28")
    gc.collect()
    torch.cuda.empty_cache()
    eager_launches = phase29(card)
    lap("phase29")
    gc.collect()
    torch.cuda.empty_cache()
    phase30(card)
    lap("phase30")

    ms, plain_ms, library_ms, bound_ms, bound_by, _ = t = time_pack(main_pack)
    say_pack_time("bf16 pools at the phase-3 shapes", t, card)
    say_pack_time("int8 pools at the phase-3 shapes", time_pack(int8_pack),
                  card)
    say_pack_time("a decode-only bf16 pack (8 rows, 3 at C*bs - 1)",
                  time_pack(decode_pack), card)
    d = time_decode(serve_decode_case())
    say(f"timing paged_decode_attention at the phase-12 decode shape (S 8, "
        f"nh 12, hd 64, bs 32, C 20, clocks 128-639, bf16) on {card}: kernel "
        f"{d[0]:.4f} ms, plain {d[1]:.4f} ms, sdpa over the pre-gathered "
        f"dense view {d[2]:.4f} ms ({d[3]:.4f} ms with the gather), bound "
        f"{d[4]:.4f} ms ({d[5]})")
    flash = time_flash()
    say_flash(flash, "the phase-6 shapes (B 16, L 1024, H 12, D 64, bf16, "
              "causal)", card)
    say_flash(time_flash(16, 512, False), "the phase-9 shapes (B 16, L 512, "
              "H 12, D 64, bf16, not causal)", card)
    say_flash(time_flash(1, 128, True), "the admission-prefill shape (B 1, "
              "L 128, H 12, D 64, bf16, causal)", card, only=("flash_fwd",))
    fused = time_fused()
    library = {"fused_ln_fwd": "F.layer_norm on the pre-added rows (LN alone)",
               "fused_ln_bwd": "F.layer_norm autograd backward",
               "fused_adamw_flat": "torch._fused_adamw_ on one flat tensor"}
    shapes = {"fused_ln_fwd": "N 8192, H 768, bf16, bias",
              "fused_ln_bwd": "N 8192, H 768, bf16, bias, rout cotangent",
              "fused_adamw_flat": f"n {BERT_PARAMS}, fp32"}
    for name, r in fused.items():
        alone = ("" if "kernel_alone_ms" not in r else
                 f" (the kernel alone {r['kernel_alone_ms']:.4f} ms, the "
                 f"rest the PyTorch sum of its partials)")
        say(f"timing {name} at the phase-9 shapes ({shapes[name]}) on "
            f"{card}: kernel {r['ms']:.4f} ms{alone}, plain "
            f"{r['plain_ms']:.4f} ms, "
            f"{library[name]} {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3e}")
    say(f"fused_adamw_flat is on no train path (the reference wires it into "
        f"no trainer): its launches are phase 7's, {adamw_launches}")

    say(f"kernel launches: ragged {launches} (phase 3) + {gen_launches[0]} "
        f"(phase 17's store serves) + {tel_launches[0]} (phase 18's "
        f"serves); flash_fwd {flash_launches[0]} (phase 6) + "
        f"{gen_launches[2]} (phase 17's generation prefills) + "
        f"{tel_launches[2][0]} (phase 18's admissions and train steps) + "
        f"{moe_launches[1]} (phase 19's ERNIE-MoE train and admissions); "
        f"flash dq/dkv {flash_launches[1:]} (phase 6) + "
        f"{tel_launches[2][1:]} (phase 18) + {moe_launches[2:4]} (phase "
        f"19); paged decode {decode_launches} (phase 12) + "
        f"{gen_launches[1]} (phase 17's store serves) + {tel_launches[1]} "
        f"(phase 18) + {moe_launches[4]} (phase 19's serves); ragged also "
        f"+ {moe_launches[0]} (phase 19's ERNIE-MoE serves); phase 20's "
        f"fleet: ragged {fleet_launches[0]}, flash_fwd {fleet_launches[1]}, "
        f"paged decode {fleet_launches[2]}; phase 21's data parallelism: "
        f"flash fwd/dq/dkv {dp_launches[:3]}, fused LN fwd/bwd "
        f"{dp_launches[3:]}; phase 22's crash-consistent training: flash "
        f"fwd/dq/dkv {ckpt_launches}; phase 25's tensor and sequence "
        f"parallelism: flash fwd/dq/dkv {tp_launches}; phase 26's expert "
        f"and model axes: flash fwd/dq/dkv {ep_launches[:3]}, fused LN "
        f"fwd/bwd {ep_launches[3:]}; phase 27's pipeline: flash "
        f"fwd/dq/dkv {pp_launches}; phase 29's eager encoder: flash "
        f"fwd/dq/dkv {eager_launches}")
    say(card)                        # the nvidia-smi name,power.limit line
    pack = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
    rows = [kernel_row("ragged_paged_attention", KERNEL_SOURCE,
                       KERNEL_REPLACES,
                       launches + gen_launches[0] + tel_launches[0]
                       + moe_launches[0] + fleet_launches[0], pack)]
    flash_launches = tuple(
        sum(parts) for parts in zip(
            (flash_launches[0] + gen_launches[2] + fleet_launches[1],
             *flash_launches[1:]), tel_launches[2], moe_launches[1:4],
            dp_launches[:3], ckpt_launches, tp_launches, ep_launches[:3],
            pp_launches, eager_launches))
    ln_launches = tuple(a + b + c for a, b, c in zip(
        ln_launches, dp_launches[3:], ep_launches[3:]))
    rows += [kernel_row(name, FLASH_SOURCE, FLASH_REPLACES[name], n, r)
             for (name, r), n in zip(flash.items(), flash_launches)]
    rows += [kernel_row(name, FUSED_SOURCE, FUSED_REPLACES[name], n, r)
             for (name, r), n in zip(fused.items(),
                                     (*ln_launches, adamw_launches))]
    rows.append(kernel_row(
        "paged_decode_attention", PAGED_SOURCE, PAGED_REPLACES,
        decode_launches + gen_launches[1] + tel_launches[1]
        + moe_launches[4] + fleet_launches[2],
        dict(max_abs_err=decode_err, ms=d[0], plain_ms=d[1], library_ms=d[2],
             bound_ms=d[4], bound_by=d[5])))
    say(f"chip_smoke took {time.perf_counter() - T_START:.1f} s on {card}")
    say(json.dumps({"kernels": rows}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
