#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mxnet_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and this checkout; never
JAX. Phases, each printing one JSON line, and any failure raises (the
script then exits non-zero without the final `ok` line); after each
phase the garbage collector runs and the card's cache is emptied, so
no engine outlives its phase:

  1. device   the card's name and power limit (nvidia-smi), torch, CUDA.
  2. build    every CUDA kernel of the port built from csrc/ (one nvcc
              per source, in parallel) and the ptxas resource report.
  3. span     ragged_span_attention's kernels against their plain
              PyTorch version: float32 q on the CUDA-core kernel (tol
              1e-5 absolute), bfloat16 q on the tensor-core kernel (tol
              1.2e-2 of the largest plain value). Two timed cells at GPT-2
              774M serving shapes (B=8, Sq=64, H=20, D=64, page 64, 16
              pages per slot, 128 pages, permuted table): the kernel cell
              (long contexts, mixed q_counts) and serve_decode, phase
              gpt2's decode dispatch (q_counts 1, lengths its prompts +
              16); a third, serve_verify, phase gpt2_spec's verify
              dispatch (q_counts 1 + drafts, 1 to 8, at lengths its
              prompts + 32, rows ending mid-page); then edge cases (SPAN_EDGES: split boundaries, splits
              with no live page, both routes in bfloat16, misaligned
              pools). Every call: the family span_route names launches
              (counted under its key alone), two runs give the same
              bits, dead rows and idle slots are exactly 0. Times of
              kernel, plain version and the F.scaled_dot_product_attention
              yardstick (and their ratio), and the bound; the kernel's
              time with the pools warm in L2 and under the split plan's
              other targets (SPLIT_TARGETS, each checked too). Float
              pools also take a poisoned key page (NaN, as
              serving.FaultPlan writes one) through both span routes and
              the decode kernel: the NaN elements equal the plain
              version's, inside their slot.
  3b. span_int8  the same for int8 pools with per-(page, head) float32
              scales, bfloat16 q held to INT8_BF16_REL_TOL (2e-3 of the
              largest plain value; the int8 kernels keep P in float32),
              and the smallest input that showed the tensor-core
              kernel's former single rounding of P (INT8_ROUNDING_CASE);
              the yardstick is SDPA on the dequantized gathered view.
  4. decode   ragged_decode_attention at the decode cell (B=8, H=20, D=64,
              page 64, 16 pages, lengths up to 1024 and a length-0
              slot) and DECODE_EDGES (the split plan's boundaries, D =
              40, 12 and 128, misaligned pools), against the plain
              version of its split (float32 1e-5 absolute, bfloat16 1.2e-2
              of the largest plain value) and the unsplit one; one launch
              a call, the same bits twice, length-0 slots exactly 0; times
              of kernel, plain, SDPA and the span kernel at Sq=1 on the
              same inputs, the bound, the kernel under DEC_SPLIT_TARGETS,
              and whether it agrees bit for bit with the span kernel at
              Sq=1.
  5. gpt2     GPT-2 774M at full width (1280 units, 20 heads, vocab
              50257, 1024 positions; seeded random weights) cut to its
              first 12 of 36 layers (SERVE_LAYERS, as in every serving
              phase 5-5l) served by ServingEngine(num_slots=8,
              max_length=1024, page_size=64): 8 greedy requests, prompts
              U[16, 128], 32 new tokens each, float32, once through the
              kernels and once through the plain versions (attn_impl=
              "torch"). Streams must agree (a divergence is allowed only
              where the plain path's top-2 logit gap is below 1e-4); the
              CUDA-core span kernel must have run 12 times per dispatch
              (the tensor-core one never). One ragged
              single-token forward on the served cache drives the decode
              kernel (logits within 1e-4 of the plain path). Then the
              kernel path serves the same traffic in bfloat16, timed (the
              tensor-core span kernel 12 times a dispatch, the CUDA-core
              one never), and the bfloat16 plain path once: with d the
              largest |kernel - plain| first-token logit, first tokens
              agree wherever the plain top-2 gap exceeds 2*d.
              The float32 and bfloat16 kernel paths each serve once more
              with dispatches 10-17 under torch.profiler (SERVE_TRACE):
              device busy share, top kernels and the span kernel's
              device ms over those 8 dispatches.
  5b. gpt2_int8  the same model and traffic on int8 KV pages
              (kv_dtype="int8", chunk_tokens 64): float32 through the
              kernels (the int8 span kernel exactly 12 times a dispatch,
              the float ragged kernels never) and through the plain
              versions (streams agree under the 1e-4 top-2 rule, the gap
              read on the int8 path's own write schedule); against phase
              5's float32 streams: d = the largest |int8 - float32|
              first-token logit of each prompt is measured, and the first
              tokens must agree wherever float32's top-2 gap exceeds 2*d,
              the engine's token must be the int8 path's argmax wherever
              that path's gap exceeds 1e-2; the cache quantizer writes
              the CPU's bytes on the card; one single-token forward on
              the served cache through the span kernel (logits within
              1e-4 of the plain path); then bfloat16 on int8 pages, timed
              (the int8 tensor-core span kernel 12 times a dispatch) and
              profiled (dispatches 10-17), and KV bytes per token of each
              page dtype.
  5c. prefix  the 774M model in float32 on the kernel path, float and
              int8 pages, the prefix cache off and on: every prompt is a
              256-token shared prefix (4 pages) and a unique tail
              U[16, 128]; request 0 alone, then requests 1-7 together,
              then the bare prefix (the copy-on-write split), 32 greedy
              tokens each. Streams equal with the cache on and off,
              7*256 + 255 prompt tokens saved, prefill(on) + saved =
              prefill(off), the page audit clean, the tree's pages
              untouched by the split; ms per serve.
  5d. gpt2_spec  the 774M model with ServingEngine(num_slots=8,
              max_length=1024, page_size=64, chunk_tokens=64,
              speculative=True, spec_tokens=8): 8 greedy requests, each a
              random head of U[2, 6] tokens and a 4-token pattern repeated
              U[4, 8] times (numpy seed 2), 64 new tokens. float32 and
              bfloat16 on float pages, float32 on int8 pages. The kernel
              path with speculation on (the span kernel of the dtype
              exactly 12 times a dispatch, its plain version never) against
              the same with speculation off (streams equal, float pages)
              and against the plain path with speculation on (float32 and
              int8: a divergence only where the plain path's own top-2 gap
              at that token, read by a forward hook, is below 1e-4;
              bfloat16: phase gpt2's first-token rule); drafts accepted;
              acceptance rate, tokens and ms per dispatch on and off, and
              20 dispatches of the float32 serve under the profiler
              (dispatches 10-29, every prompt landed).
  5e. gpt2_w8  the 774M model with weight_dtype="int8" (float32
              activations), phase gpt2's traffic: the kernel path against
              the plain path (top-2 rule, as 5d) and against a float engine
              over the dequantized weights (its own top-2 gaps, 1e-4); int8
              and float32 weight bytes; ms per dispatch of the w8 and the
              dequantized float engine; the pages
              each engine admits under one hbm_budget_bytes that float32
              weights bind, with hbm_budget_includes_weights=True.
  5f. gpt2_lora  the 774M model in float32 with AdapterPool(slots=4,
              max_rank=8): four adapters (random_lora seeds 1-4, ranks
              4/8/8/8) over its three usable slots, phase gpt2's traffic
              wearing adapters 1, 2, 3, 4, none, 1, 2, none (eviction,
              page-in and slab backpressure run). Each adapter's streams
              against a plain-path engine over merged_weights (top-2
              rule, as 5d), the null-adapter streams equal to an engine
              without a pool; then the same with an int8 slab against its
              effective_weights; ms per dispatch with and without the
              pool, page-ins and evictions.
  5g. gpt2_tier  one 774M model (float32 weights, seeded) shared with
              5h; ServingEngine(num_slots=8, max_length=1024,
              page_size=64, chunk_tokens=64, prefix_cache=True,
              prefix_cache_pages=8) with the host KV tier (host_kv_bytes
              = 16 pages of its dtype): four 256-token system prompts
              (numpy seed 3) with tails U[16, 128], 32 greedy tokens;
              round A one request per prefix, round B two per prefix in
              the order 4, 3, 2, 1. float32, int8 and bfloat16 pages
              (bfloat16 weights, then the float32 weights restored). Every
              stream equals the never-evicted engine's
              (prefix_cache_pages=64, no tier); at least 8 pages spilled
              and 8 paged in; both audits clean after every step; the
              dtype's span family 12 times a dispatch, its plain version
              never. ms per dispatch and per serve against the tier off
              at 8 cache pages (it recomputes what was evicted); prompt
              tokens paged in, attached and recomputed; ms and GB/s of
              the tier's gather and scatter of 16 pages against a pinned
              copy_ of the same bytes each way, and one pinned
              allocation's cost.
  5h. gpt2_robust  the same model, float32 pages: a chaos soak (32
              sampled requests, prompts U[16, 128] seed 4, 16 tokens,
              Poisson arrivals at 3 a step, seed 13) under FaultPlan(seed
              3; dispatch exceptions, NaN pages, pool exhaustion and
              allocation failures at 0.05 each, poison c5 both phases and
              c17 decode, 40 faults at most) with max_retries 4: every
              innocent stream equals the fault-free run's, both poison
              requests fail and only they, every fault the supervisor
              caught is one the plan injected and dispatch_errors counts
              exactly them and the dispatches the finite guard flagged
              (one at least), audits clean. Preemption under
              SheddingPolicy(queue_low=1, queue_high=2, preempt=True) on
              a tick clock: eight priority-2 requests (phase 5's prompts,
              32 tokens) then two priority-0 ones; with 64 pages of tier
              the victims resume, with 8 bytes they restart (float32, and
              int8 pages replaying their write schedule); every stream
              equals its request served alone; dispatches to the urgent
              first tokens with and without the policy. Deadlines: one
              expires queued (shed, no tokens), one running (its partial
              stream a prefix of its unbounded one).
  5i. gpt2_http  the same model behind ServingFrontend (127.0.0.1, port
              0) with an IntrospectionServer beside it;
              ServingEngine(num_slots=8, max_length=1024, page_size=64,
              chunk_tokens=64), float32 then bfloat16. The engine first
              serves phase 5's traffic by engine.serve (the oracle, and
              the warmup), then mark_warm(). Over HTTP, all at once: the
              same 8 requests from 8 SSE clients (each stream must equal
              the oracle's, token for token, and echo its traceparent's
              trace id), a client that hangs up after 4 tokens (cancelled,
              pages returned), a reader with a 1-token stream buffer whose
              take() lags 0.3 s (an overflow error event, then
              cancelled(stream_overflow)); once every request is in and
              first tokens are out, begin_drain(): a new POST gets 503
              with Retry-After and the frontend's /readyz flips to 503,
              in-flight streams finish. The dtype's span family runs 12
              times a dispatch, its plain version never. Then /metrics
              and /statusz (8 finished), /requests (every phase sum <=
              its TTFT), /trace, /compilez (the kernel libraries loaded,
              no build or load after mark_warm(), cost_mfu of the
              dispatch in (0, 1]), /memz (accounted <= allocated; the
              remainder printed; the phase's engine the only engine
              listed: nothing of an earlier phase alive) and /sloz. One FaultPlan dispatch
              exception latches exactly one flight dump (events.jsonl,
              metrics.json, state.json). Last, the telemetry's host cost:
              phase 5's traffic served with the request log and the cost
              accounting on and off, switched every dispatch over four
              serves (a warmup serve first): the medians and quartiles
              of ms per dispatch on each side, and their ratio.
  5j. gpt2_router  ServingRouter over replicas of the same model (phase
              5's engine geometry each, at most three alive at once),
              the float32 weights re-seeded first: phase 5's first 4
              greedy prompts and 4 sampled requests (phase 5h's first 4
              prompts, temperature 0.8, seeds 100-103; ROUTER_TRAFFIC,
              one engine's 8 slots), 32 tokens each. Every case
              holds every stream to one engine's serve of the same
              requests, all finished: (a) two replicas, the one owning
              the first request with 3 tokens (read from the router's
              owner map) killed by a ReplicaFaultPlan, in float32,
              bfloat16 and int8 pages (float32 weights, a chunk budget no
              dispatch reaches): replica_down {"kill": 1}, a request
              migrated, exactly one replica_down flight dump; (b) a
              rolling restart: drain(0, migrate=True) once a request has
              3 tokens, mark_warm, rejoin(0), 4 new requests, some placed
              on replica 0; (c) three replicas hedging after ten
              dispatches' time: hedges = won + wasted; (d)
              ServingFrontend over two replicas, 4 SSE clients, the
              owner of a request with 3 tokens killed mid-stream. In
              every case: the dtype's span family 12 times a dispatch
              summed over the replicas and nothing else, its plain
              version never, clean page audits, and /memz listing only
              the case's engines. Dispatches a replica, requests
              migrated and tokens re-prefilled, routed ms a dispatch
              against the single engine's, the phase's seconds.
  5k. gpt2_fleet  the cross-process fleet (serving/fleet) over the same
              model at phase 5j's geometry and traffic, the float32
              weights re-seeded first, every stream held to one engine's
              serve of the same requests. FleetWorkers in this process
              over loopback HTTP (their engines declared warm: the
              script's kernel libraries are loaded by then): a mixed
              fleet of two; a prefill + decode pair in float32, bfloat16
              and int8 pages (a chunk budget no dispatch reaches) that
              ships each request's KV pages at its first token (handoffs
              = requests, every payload landed, no handoff_fallback, no
              prefill on the decode worker); the float32 pair again with
              ship_payload off (the decode worker replays). Each: the
              dtype's span family 12 times a dispatch summed over the
              workers and nothing else, its plain version never,
              steady_state_compiles 0, clean audits; handoff ms (median,
              max), exact wire bytes a blob, routed ms a dispatch
              against the single engine's. Then six worker processes
              (`python -m mxnet_tpu_torch.serving.fleet.worker` on the
              card, started together; they load the kernel libraries
              main() built): two mixed float32 workers and two on int8
              pages, in each pair the worker streaming the first request
              with 3 tokens SIGKILLed (the victim down, requests adopted
              by the survivor, their count and re-prefilled tokens); a
              prefill + decode pair with a FleetCollector and this
              process's IntrospectionServer: /fleetz 200 with both
              worker pids, the merged serving_tokens_emitted_total equal
              to the workers' own and to the streams' tokens, each
              request one trace across both pids in
              fleet_chrome_trace(). Seconds to READY, every worker
              process reaped.
  5l. gpt2_tp  tensor-parallel serving: a fresh 774M model at phase 5's
              geometry and traffic (chunk 64) under ServingEngine(tp=2
              and tp=4, tp_devices=[DEV] * tp), the shards running in
              lockstep on the one card. float32 streams equal tp=1's
              except where tp=1's own top-2 gap is below 1e-4; w8 at
              tp=2 against w8 at tp=1 under the same rule. int8 pages at
              tp=2: a stream may leave tp=1's only where tp=1's gap is
              below twice the measured tp=2 / tp=1 logit distance there
              (both replaying the request's write schedule on one slot:
              a code one step off moves the logits by about 5e-3), and
              layer-0 codes and scales of one prefill chunk written at
              both shard counts are the same bytes.
              bfloat16 at tp=2: first tokens agree where tp=1's gap
              exceeds twice the measured tp=2 / tp=1 logit distance. Each tp serve launches its span family 12 x
              dispatches x tp times and nothing else, its plain version
              never. One single-token lockstep forward at tp=2 on the
              served cache drives the decode kernel (24 launches,
              logits within 1e-4 of the plain versions'); one float32
              handoff from the tp=2 engine lands in a tp=1 engine and
              finishes with no re-prefill; ServingEngine(tp=2) with the
              default device list raises on one card. ms a dispatch at
              tp=1 / 2 / 4, a profiled tp=2 window, per-chip weight and
              page bytes, the phase's seconds.
  6. fused    fused_attention's CUDA forward and backward against its
              plain PyTorch version (forward output, dq, dk, dv) at
              BERT-base shapes (B=32, T=512, H=12, D=64, key padding from
              valid lengths U[384, 512], dropout 0.1) in BTHD and in
              BHTD, at GPT-2 774M causal shapes (B=8, T=1024, H=20, D=64,
              dropout 0.1, BTHD), float32 through the "cuda_core" route
              (csrc/fused_attention.cu: split TF32 by mma.sync; forward
              1e-5 absolute, gradients 1e-4 relative to the largest) and
              bfloat16 through the tensor-core kernels
              (forward and gradients 1.2e-2 relative to the largest), plus
              edge cases (a fully padded batch row, causal Tq < Tk, D = 40
              and 128, T off the 64 grid, T = 1100 past the reference's
              whole-row limit, D = 12, which the route rule sends to the
              CUDA-core kernels in bfloat16); every call must pass
              fused_attention.supported(), launch the family
              fused_attention.kernel_route() names (and count under its
              keys alone), and give bit-identical gradients in two
              backward runs (float32 and bfloat16); forward and backward
              times of kernel, plain version and the
              F.scaled_dot_product_attention yardstick (and their ratio),
              and the bound (float32 also against the split-TF32 rate,
              TF32X3_FLOPS); the CUDA-core kernels in bfloat16 at the
              BERT-base cell on padded rows, and timed at that cell with
              D = 40 on rows 44 elements apart (SDPA beside).
  7. bert     BERT-base MLM training at full width (12 layers, 768 units,
              12 heads, 3072 hidden, vocab 30522, 512 positions; seeded
              random weights) through parallel.TrainStep with AdamW(1e-4,
              wd 0.01), dropout and attention dropout 0.1, on bench.py's
              bench_bert traffic (B=32, T=512, 76 masked positions per
              row below its valid length, valid lengths U[384, 512],
              random labels): 5 float32 steps through the kernels (the
              main path in float32: the CUDA-core fused forward and
              backward 12 times a step, the tensor-core pair never) and
              5 through the plain versions from the same weights and
              seed (losses agree within 1e-5 relative at every step);
              before them, one float32 forward and backward of each path
              with the same dropout stream: every parameter's gradient
              within 1e-4 of the largest gradient magnitude of the
              layer that owns it (this pins the backward through all
              12 layers); then 20 timed bfloat16 steps (float32 masters)
              on the kernel path (the main path in bfloat16: the
              tensor-core pair 12 times a step, the CUDA-core pair
              never) — the loss must fall — with ms per step, tokens/s,
              peak memory and bert_base_mlm_mfu; then one more bfloat16
              step under torch.profiler (the fused kernels' share of
              device time).
  7b. gpt2_train  GPT-2 774M at full width, its first 12 of 36 layers
              (GPT2_TRAIN_LAYERS; seeded random weights) on
              the cache=None training path: one forward and backward of
              the next-token loss, B=2, T=1024, dropout and attention
              dropout 0.1, float32 and bfloat16, kernel path against the
              plain path from the same weights and dropout generator
              (losses within 1e-5 relative in float32, 1e-4 in
              bfloat16); each kernel pass launches its family's fused
              forward and backward exactly 12 times (float32 the
              "cuda_core" pair, bfloat16 the tensor-core pair) and
              nothing else; the kernel path's ms a pass (median of 3)
              and one profiled pass (busy share, time by kernel class).
  7c. resnet50  ResNet-50 v1b training through parallel.TrainStep with
              SGD; the path reaches no Pallas kernel in the reference
              (convolutions by cuDNN through F.conv2d, BatchNorm and
              pooling as plain torch ops). (a) float32 parity, card
              against CPU, at bench.py bench_resnet50's CPU smoke
              configuration (resnet50_v1b(classes=100), B = 8, 64x64,
              TF32 off): Xavier weights drawn once on the CPU, one
              eval-mode forward, two steps of SGD(0.01, 0.9, 1e-4); every
              logit, loss, parameter and running statistic within the
              larger of its fixed tolerance (1e-5 relative / 1e-4 of the
              tensor's largest) and RESNET_SPREAD_FACTOR times the CPU's
              own spread (its run on the images one ulp up). (b) one
              training forward of resnet50_v1b(classes=1000) at B = 32,
              224x224, bfloat16 against float32 from the same weights:
              the losses (float32 from the logits) within
              RESNET_BF16_LOSS_TOL. (c) bench_resnet50's configuration:
              bfloat16 (net.cast's counterpart, model.to), B = 256,
              224x224, Xavier, SGD(0.1, 0.9, 1e-4), seeded images and
              labels: warm-up steps, then run_steps timed with a device
              sync (ms a step, img/s, 3 x 2 x the multiply-adds of every
              convolution and the Dense, MFU against 989 TFLOP/s, peak
              memory), one step under the profiler (busy share, CUDA
              launches, device ms by class: conv, batch_norm, pooling,
              optimizer, other); then the float32 step at
              RESNET_F32_BATCH. Every loss and running statistic finite.
  7c2. ssd512  SSD-512 (ssd_512_resnet50_v1_voc: ResNet-50 v1b stages
              1-4, three extra blocks, 20 classes; Xavier, seed 0)
              through the port's multibox ops, TrainStep + SGD and
              SSD.detect, whose NMS runs on the hand-written kernel
              (csrc/nms.cu: the valid rows compacted, their mask in a
              thread-block cluster's shared memory, a one-warp walk;
              beyond 1,216 valid rows an image, a global-memory path in
              the same launch). (a)
              float32 parity, card against CPU (TF32 off), on
              examples/train_ssd.py's two images and labels at 128x128
              (356 anchors), weights drawn once on the CPU: anchors
              byte-equal; multibox_target's class targets and masks
              equal, box targets within 2 ulps (log-size columns);
              eval predictions within 1e-5 of their largest and the loss
              within 1e-5; detect's rows, class ids equal, scores and
              boxes within 1e-5; three steps of SGD(5e-4, 0.9), every
              loss, parameter and running statistic within the larger of
              its fixed tolerance and RESNET_SPREAD_FACTOR times the CPU's
              own spread (runs on the images one ulp up and half an ulp
              down), at most SSD_FLIPPED_TENSORS within
              SSD_FLIP_FACTOR / RESNET_SPREAD_FACTOR times their gate
              instead, the median ratio at most 2. (b) 512x512
              (5,624 anchors), B = 32, seeded images and 1-8 boxes an
              image over the 20 classes (targets by multibox_target on
              the card), GluonCV train_ssd.py's SGD(1e-3, 0.9, wd 5e-4),
              float32 (TF32 off) and then bfloat16 from the same
              weights: 3 warm-up and 5 timed steps each (ms a step,
              img/s, MFU by resnet_step_flops' count, peak memory,
              finite losses and statistics); the first step's bfloat16
              loss within RESNET_BF16_LOSS_TOL of float32's; one
              bfloat16 step profiled as phase resnet50's. (c)
              SSD.detect at B = 32 (nms 0.45, threshold 0.01, topk 400)
              with the NMS kernel called exactly once, detect's peak
              device memory, the arguments
              it passes to multibox_detection and nms_keep captured:
              multibox_detection's plain version on them gives rows
              identical to detect's; nms_keep's keep masks identical;
              the kernel's and the plain version's ms, the bound
              (nms_work: flags read and keep written for every row, box
              and id read for each valid row; NMS_ROW_FLOPS for each
              valid row, NMS_ID_FLOPS for each pair of valid rows,
              NMS_PAIR_FLOPS for each such pair of one class id), no
              library NMS (torchvision is absent: the bound is the
              yardstick); the mAP on the synthetic labels (no gate); and
              NMS_EDGES (N = 1, 63, 64, 65, 200, 5,624, NaN boxes and
              ids, every row invalid, an IoU exactly at the threshold,
              force_suppress, images at and one row over the on-chip
              limit in one call, every row valid, valid rows only at the
              end, B = 128, 80 class ids with and without force, a
              negative threshold) with identical keep masks and one
              launch each, each timed beside its bound.
  7d. nmt_train  Transformer-base NMT (nmt_base_config: 6 + 6 layers,
              512 units, 8 heads, 2048 hidden, vocab 32000 / 32000,
              dropout 0.1; seeded random weights), teacher forcing through
              TrainStep + Adam(2e-4), n_net_inputs=3, on NMT_TRAIN's batch
              (64 pairs, source and target lengths U[32, 64] padded to 64,
              source valid lengths, the target's token mask as the loss's
              sample weight): the fused pair alone at the model's three
              call shapes (encoder and cross under the sources' key
              padding, decoder causal; B 64, H 8, T 64, D 64, BTHD),
              float32 and bfloat16, output and gradients against the
              plain version (fused_case); the model's kernel path against
              its plain path from the same weights and dropout stream:
              losses (each pass on its own ReLUs) float32 1e-5 and
              bfloat16 1e-4 relative; gradients with the plain pass on
              the kernel pass's ReLU masks (relu_replay, flips at most
              NMT_RELU_FLIP_FRAC / NMT_RELU_FLIP_FRAC_BF16 of its
              elements), float32 1e-4 of each layer's largest, bfloat16
              phase 7's rule (BF16_MODEL_GRAD_TOL of the layer's largest
              float32 gradient, or the plain path's own bfloat16 error
              where larger); then timed steps, float32 and bfloat16
              (float32 masters): ms a step, target tokens/s, MFU (3 x 2 x
              the multiply-adds of every Dense and attention product at
              the batch's shapes over 989 TFLOP/s), peak memory, the fused
              pair of the dtype's family 18 times a step each (6 encoder,
              6 decoder causal, 6 cross; BTHD) and nothing else; one
              bfloat16 step profiled (busy share, CUDA launches).
  7e. nmt_translate  the same model translating 16 sources (lengths
              U[16, 64] padded to 64) by beam search (beam 5, 128 steps,
              alpha 0.6), float32 and bfloat16, kernels against plain
              (beam_gate: the same candidates every step and the same
              beams, or a first difference at a near tie of the plain
              path's totals, twice the measured drift in bfloat16 with
              the drift at most NMT_BF16_DRIFT_CAP and the first step's
              totals within BF16_REL_TOL; scores 1e-4 relative in
              float32, NMT_BF16_SCORE_TOL in bfloat16); the fused forward
              6 times for the encoder (BTHD) and 12 a step (6 BHTD: the cached
              self-attention, one query row over the cache's 128 keys;
              6 BTHD: the cross-attention, one row over the source) and
              nothing else; ms a translate, decode steps a second. Kernel
              cells (lockstep_cell: kernel against plain, kernel, plain
              and SDPA ms on the same views, the bound): the decode
              self-attention at B * beam = 80, H 8, 128 keys of the
              contiguous cache, and the cross-attention over 64 source
              keys padded from the sources' valid lengths.
  7f. gpt2_generate  GPT-2 774M (seeded random weights, the first 6 of
              its 36 layers: GENERATE_LAYERS) through
              GPT2ForCausalLM.generate on bench.py bench_gpt2_decode's
              traffic (B 8, prompt 128, 128 greedy tokens), float32 and
              bfloat16: kernels over a lockstep paged cache (pages of 64)
              and over the contiguous cache, plain versions over pages;
              the prompt's forward takes the plain softmax attention (its
              (1, 1, 128, 256) mask is not key padding), each
              single-token forward the family's fused forward once a layer
              in BHTD (6 x 128 a generate) and nothing else. Streams
              (stream_gate): kernel against plain and paged against
              contiguous equal, except at a first differing token where
              the other path's top-2 gap is below 1e-4 (float32) or twice
              the measured logit difference there (bfloat16; that
              difference, and that of the first single-token logits, at
              most GPT2_BF16_LOGIT_CAP). Tokens/s
              and ms a token of a warm paged generate (bench_gpt2_decode's
              reading); the decode cell: B 8, H 20, one query row
              over the paged cache's 256 keys.
  7g. bert_gluon  BERT-base MLM (bert_base_config, seeded weights from
              mx.random.seed(0) and net.initialize(mx.init.Normal(0.02))
              on the default device) at bench_bert's traffic driven only
              through the eager gluon surface: gluon.Trainer with LAMB
              and a PolyScheduler with warmup (BERT_GLUON),
              autograd.record, loss.backward, Trainer.step. (a) float32,
              dropout 0: 3 eager steps against parallel.TrainStep(net,
              loss, LAMB) from the same weights, batch and schedule
              (losses within 1e-5 relative each step, the largest
              parameter difference within 1e-4); (b) those steps launch
              the CUDA-core fused pair 12 times a step each and nothing
              else, and one eager step through the plain versions
              (attention_impl "torch") is held to the kernel's: float32
              loss 1e-5 and gradients 1e-4 of their layer's largest,
              bfloat16 loss BF16_REL_TOL and gradients as phase 7's; (c)
              bfloat16 weights (net.cast) with float32 masters
              (multi_precision), dropout 0.1, clip_global_norm(1.0): 2
              warm-up and 10 timed steps (the tensor-core pair 12 times
              a step), ms a step, tokens/s and peak memory beside phase
              7's TrainStep ms a step, and each stage's ms (forward,
              backward, clip, Trainer.step, the card synchronised after
              each); the first loss within 1e-2 of a float32 forward's
              on the same dropout stream.
  7g2. bert_resume  BERT-base MLM (init_params seed 0, bfloat16, float32
              masters, dropout 0.1) at bench_bert's traffic under
              TrainStep(loss_scale="dynamic", scale_window=2), BERT_RESUME:
              (a) 6 steps twice from the same weights (losses, scales,
              final parameters, their spread; the tensor-core pair 12
              times a step); (b) 3 steps, an asynchronous
              checkpoint.TrainCheckpoint save, one step while it writes,
              a restore into a new net from other weights and a new step,
              3 more steps: losses, scales and parameters equal (a)'s
              within its spread; save blocking / durable ms, GB, restore
              seconds; (c) the scale state at 2^127, one step as it is
              (recorded) and one whose forward overflows: that step keeps
              every parameter and state bitwise, the scale 2^126;
              (d) no host sync added by the scaling (torch's sync debug
              mode); (e) ms a step with and without scaling; (f) the
              eager gluon flow under amp (convert_model, LAMB Trainer,
              init_trainer, scale_loss, dropout 0): 2 steps,
              save_parameters / save_states, a new net loaded, 2 steps
              equal 4 uninterrupted; its route (CUDA-core: q is float32).
  7g3. np_control  the CPU tests' cases of control flow, mx.np, a
              register_op with a custom gradient and functional.grad on
              the card, each held to its CPU result.
  7g4. bert_mesh  the parallel slice on the card, every mesh a repeated
              device list (["cuda:0"] * N: shards run one after another):
              (a) dryrun_multichip's step at BERT-base width on bench_bert's
              traffic: megatron_dense_rules, TrainStep over a dp 2 x sp 2
              x tp 2 mesh, attention routed by impl='auto' to Ulysses;
              3 float32 steps (TF32 off) against 3 single-device steps
              from the same weights (losses 1e-4 relative, every
              parameter within 3 x lr, largest and median apart), every
              Ulysses shard attention one fused forward and backward;
              one Ulysses shard's attention as the step called it (B 16,
              H 6, T 512, D 64, key padding), the kernels against the
              plain version, forward and gradients, in float32 and
              bfloat16 at phase 6's tolerances; one SGD step (lr 1) from
              the same weights, mesh against single, the update within
              1e-3 relative for the tp-sharded and for the replicated
              parameters; 3
              bfloat16 steps (masters) within 1e-2 of the float32 mesh
              run, ms a step mesh and single with a trace's host share,
              peak memory, comm_report's bytes by collective; (b)
              compression='2bit' on a dp 2 mesh, 8 steps beside the
              uncompressed run (it trains; the uncompressed loss at most
              1e-3 above it; the wire 1/16 of float32's); (c)
              kvstore.create('nccl') and a one-rank NCCL dist_sync group
              from init_distributed's env: pushpull keeps the value, a
              gluon Trainer(kvstore='dist_sync') step equals a 'device'
              step to the bit; (d) PPTrainStep at GPT-2 774M width (12
              layers, 2 stages, 4 microbatches), both schedules, an
              SGD step (lr 1): its loss against the model's own, and its
              parameters after the step against the model's own SGD
              update (1e-3 relative, by embeddings, each stage's blocks
              and the final LayerNorm); (e) MoEFFN (768 -> 3072,
              8 experts, top-2) on a dp 2 x ep 2 mesh against the
              unsharded step, and equal to the dense FFN with identical
              experts.
  7h. flash   dot_product_attention(impl="flash") at bench_longcontext's
              cell (B 1, H 12, T 8192, D 64, causal, bfloat16, BHTD):
              the tensor-core fused forward and backward once each, the
              same bits as the fused call; fused_case's checks against
              the plain version and its kernel / plain / SDPA times and
              bound, forward and backward.
  8. kernels  one line listing every ported kernel with its launches on
              its main path (phase 5's float32 serve for the CUDA-core
              span and the decode kernel, its bfloat16 serve for the
              tensor-core span kernel, phase 5b's serves for the int8
              ones, phase 7's float32 steps for the CUDA-core fused
              pair, its bfloat16 steps for the tensor-core pair; each
              fused entry also with its launches in phase 7b; each span
              entry with its serve_verify cell and its launches in phases
              5d, 5g, 5h, 5i, 5j, 5k and 5l, the decode entry with its
              launches in 5l; each fused entry with its launches in
              phases 7d-7f, the forward entries with the lockstep cells of
              7e and 7f; each fused entry with its launches in phase
              7g's eager steps, the tensor-core pair with phase 7h's
              flash cell and 7g2's dynamic-scale steps, the CUDA-core
              pair with 7g2's eager amp steps, each with 7g4's mesh
              steps; the NMS kernel with its launches in phase 7c2's
              detect), errors, times, bound and library times.
  9. total    the whole script's seconds, and each phase's.
Then the last line: {"ok": true, "device": {...}}.
"""
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"float32": 67e12,    # H100 SXM, outside the tensor cores
              "bfloat16": 989e12}  # H100 SXM, dense tensor cores
# the float32 fused kernels' products as split TF32, three tensor-core
# products each: dense TF32 of the H100 SXM over three
TF32X3_FLOPS = 494.7e12 / 3
# bfloat16 kernel-against-plain tolerance, relative to the largest
# magnitude of the plain result: 1.5 units in the last place of it (bf16
# spacing is at most 2**-7 of a value); both round once from float32
BF16_REL_TOL = 1.2e-2
# bfloat16 q over int8 pages, kernel against plain: both keep P in
# float32 (the tensor-core kernel as three bfloat16 terms), and both
# round the output to bfloat16 once, so they differ only where their
# float32 results straddle a bfloat16 rounding point (a flip costs one
# spacing, 2**-8 to 2**-7 of that element), rare on the largest
# elements; 2e-3 of the largest plain value (a single bfloat16 rounding
# of P read 4.6e-3 and 7.4e-3, PERF.md section 6)
INT8_BF16_REL_TOL = 2e-3
# the smallest input on which the int8 tensor-core kernel's single
# bfloat16 rounding of P exceeded INT8_BF16_REL_TOL (found by
# mxnet_tpu_torch/tools/compare_kernels.py on the kernel that rounded P
# once, before it was split into bfloat16 terms:
# one slot, one head, D = 64, page 16, one query row, make_pool seed):
# (keys, seed)
INT8_ROUNDING_CASE = (1, 0)
# bfloat16 BERT-base (phase 7) and Transformer-base NMT (phase 7d), kernel
# path against plain path, one forward and backward from the same
# weights and dropout stream (readings in PERF.md section 6): each
# gradient's difference over its layer's largest float32 gradient may
# reach this, or the plain path's own bfloat16
# error against float32 where that is larger (a gradient summed over
# every token, such as the token-type embedding's, cancels and keeps few
# bits in bfloat16); the loss, taken in float32 from the logits, agrees
# to this relative difference
BF16_MODEL_GRAD_TOL = 5e-2
BF16_MODEL_LOSS_TOL = 1e-4
SOURCE = "mxnet_tpu_torch/csrc/ragged_attention.cu"
SPAN_TC_SOURCE = "mxnet_tpu_torch/csrc/ragged_attention_tc.cu"
SPAN, SPAN_TC = "ragged_span_attention", "ragged_span_attention_tc"
INT8, INT8_TC = "ragged_span_attention_int8", "ragged_span_attention_int8_tc"
FUSED_SOURCE = "mxnet_tpu_torch/csrc/fused_attention.cu"
FUSED_TC_SOURCE = "mxnet_tpu_torch/csrc/fused_attention_tc.cu"
REPLACES = {
    "ragged_span_attention":
        "mxnet_tpu/ops/pallas_attention.py:576 _ragged_span_kernel",
    "ragged_decode_attention":
        "mxnet_tpu/ops/pallas_attention.py:402 _ragged_decode_kernel",
    INT8:
        "mxnet_tpu/ops/pallas_attention.py:633 _ragged_span_quant_kernel",
    "fused_attention_fwd":
        "mxnet_tpu/ops/pallas_attention.py:201 _fwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:104 _fwd_kernel (BHTD)",
    "fused_attention_bwd":
        "mxnet_tpu/ops/pallas_attention.py:224 _bwd_kernel_packed (BTHD); "
        "mxnet_tpu/ops/pallas_attention.py:120 _bwd_kernel (BHTD)",
}
# the tensor-core kernels replace the same Pallas bodies, for bfloat16
REPLACES[SPAN_TC] = REPLACES[SPAN]
REPLACES[INT8_TC] = REPLACES[INT8]
REPLACES["fused_attention_fwd_tc"] = REPLACES["fused_attention_fwd"]
REPLACES["fused_attention_bwd_tc"] = REPLACES["fused_attention_bwd"]
GPT2_LAYERS = 36       # the 774M config's depth
# gpt2_train (7b) and gpt2_generate (7f) run the 774M model at full width
# cut to its first layers, as the serving phases: a pass is ~0.3 s a
# layer-set and the decode host-bound (~1.7 ms a layer a token), and
# the cuts pay for phase 7g4's seconds
GPT2_TRAIN_LAYERS = 12
GENERATE_LAYERS = 6
# the serving phases (5-5l) run the 774M model at full width cut to its
# first 12 layers: their dispatches are host-bound, about 1.4 ms a layer,
# and the whole script has to stay well inside its time limit
SERVE_LAYERS = 12
SERVE_CONFIG = f"gpt2_774m_config(num_layers={SERVE_LAYERS})"
BERT_LAYERS = 12
# phase 6 cells: (B, H, T, D, layout, causal, dropout); the BERT cells
# take key padding from valid lengths U[3T/4, T] (numpy seed 0)
FUSED_CELLS = {"bert_bthd": (32, 12, 512, 64, "BTHD", False, 0.1),
               "bert_bhtd": (32, 12, 512, 64, "BHTD", False, 0.1),
               "gpt2_774m_causal": (8, 20, 1024, 64, "BTHD", True, 0.1)}
# edge cases (B, H, Tq, Tk, D, layout, causal, dropout, valid lengths): a
# fully padded batch row, causal Tq < Tk, head dims 40 and 128, T off
# the 64 grid, T past the reference's whole-row limit (MAX_FUSED_T), and
# head dim 12, whose 24-byte rows send bfloat16 to the CUDA-core kernels
# (padded keys BTHD, and causal Tq < Tk BHTD)
FUSED_EDGES = [(3, 2, 200, 200, 64, "BTHD", False, 0.1, [0, 150, 200]),
               (2, 3, 100, 200, 64, "BHTD", True, 0.1, None),
               (2, 3, 130, 130, 40, "BTHD", False, 0.1, [77, 130]),
               (2, 2, 130, 130, 128, "BTHD", True, 0.1, None),
               (2, 2, 70, 70, 128, "BHTD", False, 0.0, [70, 1]),
               (1, 2, 1100, 1100, 64, "BTHD", False, 0.1, [700]),
               (2, 3, 90, 90, 12, "BTHD", False, 0.1, [0, 90]),
               (2, 3, 70, 150, 12, "BHTD", True, 0.1, None)]
# launch-count keys of each kernel family, forward and backward
FAMILY_KEYS = {"tensor_core": ("fused_attention_fwd_tc",
                               "fused_attention_bwd_tc"),
               "cuda_core": ("fused_attention_fwd", "fused_attention_bwd")}
# span cells: the split plan's other targets timed beside its own
# (ops/ragged_attention.py _BLOCKS_PER_SM), in blocks an SM
SPLIT_TARGETS = (1, 2, 8)
# phase 7 traffic (bench.py bench_bert): batch, sequence, masked per row
BERT_TRAFFIC = dict(B=32, T=512, M=76)
# phase 7g: BERT-base MLM through the eager gluon surface: LAMB with a
# PolyScheduler warmup; float32 steps against TrainStep, bfloat16 timed
BERT_GLUON = dict(lr=1e-4, wd=0.01, max_update=1000, warmup_steps=10,
                  warmup_begin_lr=1e-6, f32_steps=3, bf16_warmup=2,
                  bf16_steps=10, clip=1.0)
# phase 7g2: BERT-base MLM under dynamic loss scaling, checkpointed after
# save_at of `steps` steps and resumed; the window of 2 moves the scale
# during the run, so the checkpoint has to carry it
BERT_RESUME = dict(steps=6, save_at=3, scale_window=2, timed_steps=5,
                   gluon_steps=2)
# phase 7g4: the parallel slice. (a) dryrun_multichip's mesh at BERT-base
# width on bench_bert's traffic (hidden dropout 0.1, attention dropout 0,
# as the dryrun; the hidden masks are drawn for the global batch, so the
# mesh draws the single device's); (b) the 2-bit dp step (dropout 0; a
# threshold below BERT-base's typical gradient, so codes fire from the
# first step); (d) PPTrainStep at GPT-2 774M width; (e) MoEFFN at
# BERT-base width (dense_B rows for the identical-experts check)
MESH_BERT_CFG = dict(dropout=0.1, attention_dropout=0.0)
MESH_MAIN = dict(axes={"dp": 2, "sp": 2, "tp": 2}, steps=3, lr=1e-4)
# (a)'s and (d)'s SGD update against the single device's: relative to
# the update, over each group of parameters (float32 sums in another
# order move it by ~1e-6; a reduction off by a factor, by >= 1e-1)
MESH_SGD_LR = 1.0
MESH_SGD_TOL = 1e-3
MESH_COMP = dict(steps=8, threshold=1e-4)
MESH_PP = dict(layers=12, stages=2, micro=4, B=4, T=1024)
MESH_MOE = dict(units=768, hidden=3072, experts=8, top_k=2, B=8, T=512,
                dense_B=2)
# the 'flash' route's cell: bench.py bench_longcontext's shape (B, H, T,
# D; causal, bfloat16, BHTD)
FLASH_CELL = dict(B=1, H=12, T=8192, D=64)
# phase 7b: GPT-2 774M's training forward and backward, batch and sequence
GPT2_TRAIN = dict(B=2, T=1024)
# phase 7c: ResNet-50 v1b training. (a) the float32 card-against-CPU
# parity cell (bench.py bench_resnet50's CPU smoke configuration); (b)
# bfloat16 against float32 at full size; (c) bench_resnet50's own
# configuration (bfloat16, SGD(0.1, 0.9, 1e-4)) and the float32 step at
# RESNET_F32_BATCH
RESNET_PARITY = dict(B=8, S=64, classes=100, steps=2)
RESNET_BF16 = dict(B=32, S=224, classes=1000)
RESNET_BENCH = dict(B=256, S=224, classes=1000, warmup=3, steps=10)
# B = 256 fits in float32 too: 34.1 GB peak (PERF.md section 6)
RESNET_F32_BATCH = 256
# (a)'s gates: a quantity computed in train() mode through the whole net
# is determined in float32 only as far as the CPU's own spread, the
# distance between its runs on x and on x * (1 + 2**-23) (a ReLU input
# that rounding moves across zero routes a gradient term elsewhere; 53
# layers of batch statistics amplify each rounding: PERF.md section 6).
# The card may sit RESNET_SPREAD_FACTOR times that spread from the CPU,
# or within the fixed tolerance (losses and logits 1e-5 relative,
# parameters and statistics 1e-4 of their largest), whichever is larger
RESNET_SPREAD_FACTOR = 8
# (b): one training forward's loss (float32 from the logits), bfloat16
# weights and images against float32, relative; it read 2.4e-3 on an
# H100 (PERF.md section 6)
RESNET_BF16_LOSS_TOL = 1e-2
# phase 7c2: SSD-512 (ssd_512_resnet50_v1_voc, 20 classes). (a) card
# against CPU in float32 (TF32 off) on examples/train_ssd.py's two images
# and labels at 128x128 (356 anchors) and its SGD(5e-4, momentum 0.9);
# (b) the full configuration: bfloat16, 512x512 (5,624 anchors), B = 32,
# seeded images and 1-8 boxes an image over the 20 classes (padded to 8
# rows with -1), GluonCV scripts/detection/ssd/train_ssd.py's SGD(1e-3,
# momentum 0.9, wd 5e-4); (c) SSD.detect at B = 32 with
# train_ssd.py's validation settings (nms 0.45, threshold 0.01, topk 400)
SSD_PARITY = dict(B=2, S=128, steps=3, lr=5e-4)
SSD_BENCH = dict(B=32, S=512, max_boxes=8, classes=20, warmup=3, steps=5)
SSD_DETECT = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
# (a)'s train()-mode gates, as tests/test_torch_ssd.py's: the CPU's own
# spread is its largest distance over runs on the images one ulp up and
# half an ulp down; each loss, parameter and running statistic within the
# larger of its fixed tolerance and RESNET_SPREAD_FACTOR times that
# spread, except at most SSD_FLIPPED_TENSORS (a ReLU input that rounding
# moves across zero routes a gradient term of the layers before it),
# which stay within SSD_FLIP_FACTOR / RESNET_SPREAD_FACTOR times their
# gate; the median ratio of distance to spread at most 2.
# At B = 2 the extra blocks' BatchNorms normalise two values a channel on
# 1x1 maps, so after three steps the CPU's own spread is large (CPU
# readings in tests/test_torch_ssd.py)
SSD_ULPS = (1 + 2 ** -23, 1 - 2 ** -24)
SSD_FLIPPED_TENSORS = 2
SSD_FLIP_FACTOR = 64
NMS_SOURCE = "mxnet_tpu_torch/csrc/nms.cu"
REPLACES["nms"] = ("mxnet_tpu/ops/detection.py:59 _nms_single (XLA "
                   "fori_loop; no Pallas body)")
# the NMS bound's operation count: for each pair of valid rows of one
# class id (every pair with force_suppress), 4 max/min, 2 differences and
# 2 max(., 0) for the intersection's sides, its product, a sum and a
# difference for the union, its test against 0, a quotient and the test
# against the threshold; for each pair of valid rows without
# force_suppress, the class-id test; for each valid row, its area once
# (2 differences, 2 max(., 0), a product)
NMS_PAIR_FLOPS = 14
NMS_ID_FLOPS = 1
NMS_ROW_FLOPS = 5
# phases 7d-7f: nmt_base_config's layers (encoder and decoder each)
NMT_LAYERS = 6
# 7d: 64 sentence pairs, source and target lengths U[32, 64] padded to 64
# (about 4,096 target tokens: Sockeye 3's default word-based batch); the
# timed TrainStep steps of each dtype
NMT_TRAIN = dict(B=64, T=64, lo=32, steps=dict(float32=3, bfloat16=10))
# 7e: 16 sources, lengths U[16, 64] padded to 64, beam 5, 128 steps
NMT_TRANSLATE = dict(B=16, T=64, lo=16, beam=5, max_length=128, alpha=0.6)
# 7e, bfloat16 beams that agree at every step: their final scores (sums of
# 128 float32 log-probabilities of bfloat16 logits, over the length
# penalty), kernel against plain, relative. The two paths' logits differ
# by about one bfloat16 spacing (2**-8 of a logit near 1), which moves a
# log-probability by up to ~4e-3 a step; over 128 steps that is at most
# ~0.5 on totals of ~1,300 (random weights spread a step's log-probability
# around -ln 32000), 4e-4 relative: 1e-3 leaves that margin
NMT_BF16_SCORE_TOL = 1e-3
# 7d: relu_replay's flipped elements over the ReLU elements of the pass,
# at most: a pre-activation within rounding of zero flips now and then
# (7 of 100,663,296 read on an H100, PERF.md section 6); more says that
# the replay is hiding a forward that differs by more than rounding
NMT_RELU_FLIP_FRAC = 1e-6
# the same in bfloat16, where the two passes' pre-activations differ by a
# few bfloat16 spacings and a ReLU flips wherever one lies that close to
# zero: about 2.5 times the reading on an H100 (80,840 of 100,663,296,
# 8.0e-4, PERF.md section 6); a forward that differs broadly flips a
# large share of them
NMT_RELU_FLIP_FRAC_BF16 = 2e-3
# 7e, bfloat16: the drift that sets beam_gate's near-tie limit (the
# largest |kernel - plain| total of a candidate both paths rank among
# their best beam + 1, up to a row's first differing step) may reach this
# at most, in log-probability: about 2.7 times the largest reading of a
# sound run on an H100 (0.0934, PERF.md section 6)
NMT_BF16_DRIFT_CAP = 0.25
# 7f, bfloat16: the largest |kernel - plain| logit of a row, at its first
# single-token forward and at its first differing token (where twice it
# is stream_gate's near-tie limit), may reach this at most: about twice
# the largest reading of a sound run on an H100 (0.0615 at the first
# single-token logits, 2.0e-2 of the largest: 36 layers of bfloat16
# rounding; 0.0469-0.0547 at the first differing tokens; PERF.md
# section 6)
GPT2_BF16_LOGIT_CAP = 0.125
# 7f: bench.py bench_gpt2_decode's traffic: B = 8, prompt 128, 128 new
# greedy tokens, pages of 64 (and the contiguous cache)
GPT2_GENERATE = dict(B=8, prompt=128, new=128, page_size=64)
# phase 5d: the speculative engine options (BENCH_SERVING_SPEC.json's shape)
SPEC = dict(speculative=True, spec_tokens=8)
# the serve_verify cell: live rows of the verify dispatch of each slot (1 +
# its drafts); its lengths are phase 5d's prompts + 32
VERIFY_Q_COUNTS = [8, 1, 8, 5, 8, 2, 3, 8]
# phase 5f: adapter ids the 8 requests wear (None = the null adapter)
LORA_WEAR = [1, 2, 3, 4, None, 1, 2, None]
DEV = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters=25, warmup=3, cold=True):
    """Median device time of fn() over `iters` launches, CUDA events
    around each. Before each launch a 64 MB buffer is rewritten (the
    caller meets these pages cold in L2, as on the serving path: 36
    layers of pools do not fit in it; `cold=False` skips it) and the
    stream is held by a short device sleep so that host-side wrapper
    work is not timed."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if cold:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def attention_work(lengths, q_counts, S, P, H, D, itemsize, out_rows,
                   kv_itemsize=None, scale_bytes=0):
    """Bytes the function must move and the operations it must do for
    these inputs: live q rows, the live K/V pages of each slot (each read
    once, at kv_itemsize bytes an element, plus `scale_bytes` per live
    (page, head) for int8 pages), the whole output written once; 4*D
    flops per (live row, visible key) pair and head."""
    kv_itemsize = itemsize if kv_itemsize is None else kv_itemsize
    kv_bytes = q_bytes = pairs = 0
    for length, qc in zip(lengths, q_counts):
        if qc <= 0:
            continue
        pages = min(-(-(length + qc - 1) // S), P)
        kv_bytes += 2 * pages * S * H * D * kv_itemsize \
            + pages * H * scale_bytes
        q_bytes += qc * H * D * itemsize
        pairs += sum(min(max(length + j, 0), P * S) for j in range(qc))
    nbytes = kv_bytes + q_bytes + out_rows * H * D * itemsize
    return nbytes, 4 * D * H * pairs


def bound(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phases 3 and 4: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pool(torch, B, Sq, H, D, S, P, N, dtype, seed, quant=False):
    """q (B, Sq, H, D) in `dtype`, k/v pools (N, S, H, D), a permuted
    (B, P) table and the (N, H) k/v scales: None for float pools; with
    `quant` the pools are int8 codes of the same gaussian slabs with
    per-(page, head) absmax/127 float32 scales (tests/test_quant_kv.py's
    construction)."""
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, Sq, H, D)), dtype=dtype,
                     device=DEV)
    k = rng.standard_normal((N, S, H, D))
    v = rng.standard_normal((N, S, H, D))
    table = torch.tensor(rng.permutation(N)[:B * P].reshape(B, P),
                         dtype=torch.int32, device=DEV)
    if not quant:
        return (q, torch.tensor(k, dtype=dtype, device=DEV),
                torch.tensor(v, dtype=dtype, device=DEV), table, None, None)
    codes, scales = [], []
    for x in (k, v):
        s = (np.abs(x).max(axis=(1, 3)) / 127.0).astype(np.float32)
        c = np.clip(np.round(x / s[:, None, :, None]), -127, 127)
        codes.append(torch.tensor(c.astype(np.int8), device=DEV))
        scales.append(torch.tensor(s, device=DEV))
    return (q, *codes, table, *scales)


def dense_yardstick(torch, kp, vp, table, lengths, Sq, ks=None, vs=None,
                    dtype=None):
    """The inputs of the library yardstick: the gathered dense (B, H, T,
    D) view (int8 pools dequantized, in q's dtype) and the same
    causal-offset mask. Built outside the timing."""
    B, P = table.shape
    S, H, D = kp.shape[1:]
    tbl = table.long()
    k, v = kp[tbl], vp[tbl]
    if ks is not None:
        k = (k.float() * ks[tbl][:, :, None, :, None]).to(dtype)
        v = (v.float() * vs[tbl][:, :, None, :, None]).to(dtype)
    k = k.reshape(B, P * S, H, D).transpose(1, 2)
    v = v.reshape(B, P * S, H, D).transpose(1, 2)
    pos = torch.arange(P * S, device=DEV)
    limit = lengths.long()[:, None] + torch.arange(Sq, device=DEV)
    mask = (pos[None, None, :] < limit[:, :, None])[:, None]
    return k.contiguous(), v.contiguous(), mask


def check_close(got, ref, f32, name, tol=BF16_REL_TOL):
    """Kernel against plain: float32 within 1e-5 absolute, bfloat16
    within `tol` of the largest plain magnitude; finite. Returns (max abs
    error, that error over the largest plain magnitude)."""
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    rel = err / top if top else err
    require((err <= 1e-5) if f32 else (rel <= tol),
            f"{name}: max abs err {err} (relative {rel}, tol {tol})")
    require(bool(got.float().isfinite().all()), f"{name}: non-finite")
    return err, rel


def misaligned(torch, t):
    """A contiguous copy of `t` whose base lies 8 bytes past a 16-byte
    boundary (4 bytes for int8): the span route rule refuses it."""
    shift = 4 if t.element_size() <= 2 else 2
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=DEV)
    out = buf[shift:shift + t.numel()].view(t.shape)
    out.copy_(t)
    require(out.data_ptr() % 16 != 0, "misaligned copy is aligned")
    return out


def span_call(torch, ra, args, kw, label):
    """One checked kernel call of ragged_span_attention: it launches the
    family that span_route names (one launch, counted under that family's
    key alone), a second run gives the same bits, and dead rows are
    exact zeros. Returns (output, route)."""
    q, kp, vp = args[:3]
    route = ra.span_route(q, kp, vp)
    key = ra.span_launch_key(route, kp.dtype == torch.int8)
    before = dict(ra.LAUNCHES)
    got = ra.ragged_span_attention(*args, impl="auto", **kw)
    again = ra.ragged_span_attention(*args, impl="auto", **kw)
    torch.cuda.synchronize()
    moved = {k: ra.LAUNCHES[k] - before[k] for k in before
             if ra.LAUNCHES[k] != before[k]}
    require(moved == {key: 2}, f"{label}: route {route} but launches "
            f"moved {moved}")
    require(torch.equal(got, again), f"{label}: two runs differ")
    qc = kw["q_counts"]
    dead = torch.arange(q.shape[1], device=DEV)[None, :] >= qc[:, None]
    require(bool((got[dead] == 0).all()),
            f"{label}: dead rows / idle slots are not exactly 0")
    return got, route


def span_cell(torch, F, ra, quant, label, lengths, q_counts, seed,
              B=8, Sq=64, H=20, D=64, S=64, P=16, N=128):
    """A timed cell of the span kernel, float32 and bfloat16 q: kernel
    against plain (and the checks of span_call), times of kernel, plain
    version and the SDPA yardstick on the gathered view, the bound; the
    kernel's time with the pools warm in L2 and under SPLIT_TARGETS."""
    out = {"shape": dict(B=B, Sq=Sq, H=H, D=D, S=S, P=P, N=N),
           "lengths": lengths, "q_counts": q_counts,
           "splits": ra.span_split_plan(
               B, H, Sq, P,
               torch.cuda.get_device_properties(0).multi_processor_count)}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    qc = torch.tensor(q_counts, dtype=torch.int32, device=DEV)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        q, kp, vp, table, ks, vs = make_pool(torch, B, Sq, H, D, S, P, N,
                                             dtype, seed, quant)
        kw = dict(q_counts=qc, k_scale=ks, v_scale=vs)
        args = (q, kp, vp, table, L)

        def kernel():
            return ra.ragged_span_attention(*args, impl="auto", **kw)

        def plain():
            return ra.ragged_span_attention(*args, impl="torch", **kw)
        got, route = span_call(torch, ra, args, kw, f"{label} {name}")
        ref = plain()
        f32 = dtype == torch.float32
        tol = INT8_BF16_REL_TOL if quant else BF16_REL_TOL
        err, rel = check_close(got, ref, f32, f"{label} {name}", tol)
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, Sq, ks, vs,
                                     dtype)
        qt = q.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(
            lengths, q_counts, S, P, H, D, q.element_size(), B * Sq,
            kv_itemsize=kp.element_size(), scale_bytes=8 if quant else 0)
        bms, by = bound(nbytes, flops, name)
        ms = time_ms(torch, kernel)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask))
        # what holds the kernel: the same launch with the pools warm in
        # L2, and under the split plan's other targets (each checked
        # against the plain version too)
        targets, keep = {}, ra._BLOCKS_PER_SM
        try:
            for k in SPLIT_TARGETS:
                ra._BLOCKS_PER_SM = k
                check_close(kernel(), ref, f32, f"{label} {name} target {k}",
                            tol)
                targets[k] = time_ms(torch, kernel)
        finally:
            ra._BLOCKS_PER_SM = keep
        out[name] = {
            "route": route, "max_abs_err": err, "rel_err": rel,
            "tol": 1e-5 if f32 else tol,
            "tol_kind": "absolute" if f32 else "relative",
            "ms": ms, "plain_ms": time_ms(torch, plain), "library_ms": lib,
            "ms_over_library": ms / lib, "bound_ms": bms, "bound_by": by,
            "ms_over_bound": ms / bms, "ms_warm_l2":
                time_ms(torch, kernel, cold=False),
            "ms_by_split_target": targets, "bytes": nbytes,
            "flops": flops}
        del k, v, mask, q, kp, vp
    return out


# span edge cases (B, Sq, H, D, S, P, lengths, q_counts, misaligned):
# all idle, all decode, ragged tails, lengths 0 and page size 8 (the
# CUDA-core route in bfloat16: S % 16 != 0); D = 40 / S = 12 (the
# CUDA-core route); D = 128 at S = 64 (the tensor cores in bfloat16);
# then, where the split plan cuts a slot's pages over several blocks: a
# slot whose live pages end exactly on a split boundary with splits past
# them that hold no live page, a length of P*S - q_count + 1 (every
# split live), q_count 64 at length 1, and an idle slot, at S = 16 (a
# key tile spans four pages); D = 64 at S = 64 over three live splits;
# D = 128 at S = 128 (a page spans two key tiles) with a second query
# tile; and pools 8 bytes off a 16-byte boundary (the CUDA-core route
# in bfloat16)
SPAN_EDGES = [(5, 8, 2, 16, 8, 4, [5, 1, 24, 13, 8], qcs, False)
              for qcs in ([0] * 5, [1] * 5, [8] * 5, [3, 7, 2, 6, 1])]
SPAN_EDGES += [(3, 20, 3, 40, 12, 3, [0, 20, 36], [20, 17, 3], False),
               (2, 33, 1, 128, 64, 2, [60, 100], [33, 29], False),
               (4, 64, 2, 64, 16, 8, [60, 124, 1, 10], [5, 5, 64, 0],
                False),
               (3, 64, 2, 64, 64, 6, [300, 1, 130], [17, 64, 1], False),
               (2, 70, 2, 128, 128, 4, [400, 5], [70, 3], False),
               (2, 16, 2, 64, 64, 2, [70, 5], [16, 16], True)]


def phase_span(torch, F, ra, quant=False):
    """Phase 3 (float pools) or, with `quant`, 3b (int8 pools): the
    kernel cell (long contexts, mixed q_counts), the serve's decode cell
    (phase gpt2's dispatch shape: one live row a slot, contexts of its
    prompts + 16) and the edge cases."""
    label = "span_int8" if quant else "span"
    out = {"phase": label}
    out.update(span_cell(torch, F, ra, quant, label,
                         [1, 1000, 3, 960, 500, 1, 1023, 64],
                         [1, 4, 64, 17, 0, 64, 1, 33], 0))
    out["serve_decode"] = span_cell(
        torch, F, ra, quant, f"{label} serve_decode",
        [128, 103, 89, 62, 66, 36, 40, 33], [1] * 8, 2)
    out["serve_verify"] = span_cell(
        torch, F, ra, quant, f"{label} serve_verify",
        [len(p) + 32 for p in spec_traffic(50257)], VERIFY_Q_COUNTS, 3)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    routes = {"float32": set(), "bfloat16": set()}
    for i, (b, sq, h, d, s, p, lens, qcs, off) in enumerate(SPAN_EDGES):
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, table, ks, vs = make_pool(
                torch, b, sq, h, d, s, p, b * p + 1, dtype, 10 + i, quant)
            if off:
                kp, vp = misaligned(torch, kp), misaligned(torch, vp)
            Le = torch.tensor(lens, dtype=torch.int32, device=DEV)
            qce = torch.tensor(qcs, dtype=torch.int32, device=DEV)
            kw = dict(q_counts=qce, k_scale=ks, v_scale=vs)
            args = (q, kp, vp, table, Le)
            key = "float32" if dtype == torch.float32 else "bfloat16"
            got, route = span_call(torch, ra, args, kw,
                                   f"{label} edge {i} {key}")
            ref = ra.ragged_span_attention(*args, impl="torch", **kw)
            f32 = dtype == torch.float32
            err, rel = check_close(
                got, ref, f32, f"{label} edge {i} {dtype}",
                INT8_BF16_REL_TOL if quant else BF16_REL_TOL)
            worst[key] = max(worst[key], err if f32 else rel)
            routes[key].add(route)
    # both branches of the route rule are held in bfloat16; float32
    # always takes the CUDA cores
    require(routes["bfloat16"] == {"tensor_core", "cuda_core"}
            and routes["float32"] == {"cuda_core"},
            f"{label}: edge routes {routes}")
    out["edge_cases"] = len(SPAN_EDGES)
    out["edge_routes"] = {k: sorted(v) for k, v in routes.items()}
    out["edge_max_abs_err_f32"] = worst["float32"]
    out["edge_max_rel_err_bf16"] = worst["bfloat16"]
    out["bf16_tol"] = INT8_BF16_REL_TOL if quant else BF16_REL_TOL
    if quant:
        out["rounding_case"] = int8_rounding_case(torch, ra)
    else:
        out["nan_pages"] = nan_page_cases(torch, ra)
    emit(out)
    return out


def nan_page_cases(torch, ra):
    """A poisoned key page (every position and head NaN, as
    serving.FaultPlan writes one) stays inside its slot: slot 0's first
    page (the first a split reads) and slot 2's second page (rows 0-2 see
    page 0 only); span kernels of both routes and the decode kernel
    against their plain versions: the same NaN elements, the rest within
    the usual tolerance. Returns the NaN elements of each call."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, table, _, _ = make_pool(torch, 3, 4, 2, 64, 16, 4, 12,
                                           dtype, 21)
        kp[int(table[0, 0])] = float("nan")
        kp[int(table[2, 1])] = float("nan")
        key = "float32" if dtype == torch.float32 else "bfloat16"
        for kind in ("span", "decode"):
            if kind == "span":
                args = (q, kp, vp, table,
                        torch.tensor([20, 5, 14], dtype=torch.int32,
                                     device=DEV))
                kw = dict(q_counts=torch.tensor([4, 1, 4], dtype=torch.int32,
                                                device=DEV))
                fn = ra.ragged_span_attention
            else:
                args = (q[:, 0].contiguous(), kp, vp, table,
                        torch.tensor([20, 5, 17], dtype=torch.int32,
                                     device=DEV))
                kw = {}
                fn = ra.ragged_decode_attention
            before = sum(ra.LAUNCHES.values())
            got = fn(*args, impl="auto", **kw)
            require(sum(ra.LAUNCHES.values()) == before + 1,
                    f"nan page {kind} {key}: no kernel launch")
            ref = fn(*args, impl="torch", **kw)
            nan = torch.isnan(ref)
            require(torch.equal(torch.isnan(got), nan),
                    f"nan page {kind} {key}: NaN at {int(torch.isnan(got).sum())}"
                    f" elements, the plain version at {int(nan.sum())}")
            require(bool(nan[0].all()) and not bool(nan[1].any()),
                    f"nan page {kind} {key}: the NaN left its slot")
            check_close(torch.where(nan, 0, got.float()),
                        torch.where(nan, 0, ref.float()),
                        dtype == torch.float32, f"nan page {kind} {key}")
            out[f"{kind}_{key}"] = int(nan.sum())
    return out


def int8_rounding_case(torch, ra):
    """The smallest input that showed the int8 tensor-core kernel's
    single bfloat16 rounding of P (INT8_ROUNDING_CASE), held to
    INT8_BF16_REL_TOL."""
    keys, seed = INT8_ROUNDING_CASE
    P = -(-keys // 16)
    q, kp, vp, table, ks, vs = make_pool(torch, 1, 1, 1, 64, 16, P, P + 1,
                                         torch.bfloat16, seed, quant=True)
    args = (q, kp, vp, table,
            torch.tensor([keys], dtype=torch.int32, device=DEV))
    kw = dict(q_counts=torch.ones(1, dtype=torch.int32, device=DEV),
              k_scale=ks, v_scale=vs)
    got, route = span_call(torch, ra, args, kw, "span_int8 rounding case")
    require(route == "tensor_core", f"rounding case routed to {route}")
    ref = ra.ragged_span_attention(*args, impl="torch", **kw)
    err, rel = check_close(got, ref, False, "span_int8 rounding case",
                           INT8_BF16_REL_TOL)
    return {"keys": keys, "seed": seed, "shape": dict(B=1, Sq=1, H=1, D=64,
                                                      S=16, P=P),
            "max_abs_err": err, "rel_err": rel, "tol": INT8_BF16_REL_TOL}


# decode edge cases (B, H, D, S, P, lengths, misaligned): lengths 0, 1,
# a whole page, a page and one key, every page, and those around the
# split plan's boundaries (filled in from the plan: "pps" stands for its
# pages a split times S); D = 40 at S = 16, D = 12 at S = 8 (one column a
# lane, 24-byte rows), D = 128 at S = 32, and pools 8 bytes off a 16-byte
# boundary (narrower copies)
DECODE_EDGES = [(8, 2, 64, 64, 16, [0, 1, "pps", "pps+1", "P*S", 64, 65,
                                    "2pps-1"], False),
                (3, 3, 40, 16, 8, [0, 17, 128], False),
                (3, 2, 12, 8, 5, [40, 9, 1], False),
                (2, 4, 128, 32, 6, [192, 33], False),
                (3, 2, 64, 64, 4, [256, 1, 65], True)]
# the decode plan's other targets timed beside its own
# (ops/ragged_attention.py _DEC_BLOCKS_PER_SM), in blocks an SM
DEC_SPLIT_TARGETS = (1, 4, 8, 32)


def decode_call(torch, ra, args, label):
    """One checked kernel call of ragged_decode_attention: it launches
    the decode kernel once (counted under its key alone), a second run
    gives the same bits, and length-0 slots are exact zeros. Returns the
    output and the split plain version at the kernel's plan."""
    q, kp, vp, table, L = args
    before = dict(ra.LAUNCHES)
    got = ra.ragged_decode_attention(*args, impl="auto")
    again = ra.ragged_decode_attention(*args, impl="auto")
    torch.cuda.synchronize()
    moved = {k: ra.LAUNCHES[k] - before[k] for k in before
             if ra.LAUNCHES[k] != before[k]}
    require(moved == {"ragged_decode_attention": 2},
            f"{label}: launches moved {moved}")
    require(torch.equal(got, again), f"{label}: two runs differ")
    require(bool((got[L == 0] == 0).all()), f"{label}: length 0 != 0")
    B, H, D = q.shape
    n = ra.decode_split_plan(B, H, table.shape[1],
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    ref = ra._ragged_decode_split_reference(q, kp, vp, table, L,
                                            1.0 / D ** 0.5, n)
    return got, ref, n


def phase_decode(torch, F, ra):
    """Phase 4: the decode kernel at the decode cell (one query row a
    slot, long and short contexts and a length-0 slot) and the edge
    cases, against the split plain version at the kernel's plan (and the
    unsplit one), float32 at 1e-5 absolute and bfloat16 at BF16_REL_TOL;
    times of kernel, plain version, SDPA and the span kernel at Sq = 1 on
    the same inputs, the bound, and the kernel under DEC_SPLIT_TARGETS."""
    B, H, D, S, P, N = 8, 20, 64, 64, 16, 128
    lengths = [1, 1000, 3, 960, 0, 2, 1024, 64]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {"phase": "decode", "shape": dict(B=B, H=H, D=D, S=S, P=P, N=N),
           "lengths": lengths, "splits": ra.decode_split_plan(B, H, P, sms)}
    L = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    ones = torch.ones(B, dtype=torch.int32, device=DEV)
    for dtype, name in ((torch.float32, "float32"),
                        (torch.bfloat16, "bfloat16")):
        q4, kp, vp, table, _, _ = make_pool(torch, B, 1, H, D, S, P, N,
                                            dtype, 1)
        q = q4[:, 0].contiguous()
        args = (q, kp, vp, table, L)

        def kernel():
            return ra.ragged_decode_attention(*args, impl="auto")

        def plain():
            return ra.ragged_decode_attention(*args, impl="torch")

        def span():
            return ra.ragged_span_attention(q4, kp, vp, table, L,
                                            q_counts=ones, impl="auto")
        got, ref, _ = decode_call(torch, ra, args, f"decode {name}")
        f32 = dtype == torch.float32
        err, rel = check_close(got, ref, f32, f"decode {name}")
        err_unsplit, _ = check_close(got, plain(), f32,
                                     f"decode {name} (unsplit plain)")
        span1 = span()[:, 0]
        k, v, mask = dense_yardstick(torch, kp, vp, table, L, 1)
        qt = q4.transpose(1, 2).contiguous()
        nbytes, flops = attention_work(lengths, [1] * B, S, P, H, D,
                                       q.element_size(), B)
        bms, by = bound(nbytes, flops, name)
        ms = time_ms(torch, kernel)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, k, v, attn_mask=mask))
        targets, keep = {}, ra._DEC_BLOCKS_PER_SM
        try:
            for t in DEC_SPLIT_TARGETS:
                ra._DEC_BLOCKS_PER_SM = t
                n = ra.decode_split_plan(B, H, P, sms)
                check_close(kernel(), ra._ragged_decode_split_reference(
                    *args, 1.0 / D ** 0.5, n), f32,
                    f"decode {name} target {t}")
                targets[t] = {"splits": n, "ms": time_ms(torch, kernel)}
        finally:
            ra._DEC_BLOCKS_PER_SM = keep
        out[name] = {
            "max_abs_err": err, "rel_err": rel,
            "max_abs_err_unsplit_plain": err_unsplit,
            "tol": 1e-5 if f32 else BF16_REL_TOL,
            "tol_kind": "absolute" if f32 else "relative",
            "span_sq1_bit_identical": bool(torch.equal(span1, got)),
            "span_sq1_max_abs_diff":
                (span1.float() - got.float()).abs().max().item(),
            "ms": ms, "plain_ms": time_ms(torch, plain), "library_ms": lib,
            "ms_over_library": ms / lib, "span_sq1_ms": time_ms(torch, span),
            "bound_ms": bms, "bound_by": by, "ms_over_bound": ms / bms,
            "ms_warm_l2": time_ms(torch, kernel, cold=False),
            "ms_by_split_target": targets, "bytes": nbytes, "flops": flops}
    worst = {"float32": 0.0, "bfloat16": 0.0}
    for i, (b, h, d, s, p, lens, off) in enumerate(DECODE_EDGES):
        n = ra.decode_split_plan(b, h, p, sms)
        pps = -(-p // n) * s
        lens = [{"pps": pps, "pps+1": pps + 1, "P*S": p * s,
                 "2pps-1": 2 * pps - 1}.get(x, x) for x in lens]
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            q4, kp, vp, table, _, _ = make_pool(torch, b, 1, h, d, s, p,
                                                b * p + 1, dtype, 30 + i)
            if off:
                kp, vp = misaligned(torch, kp), misaligned(torch, vp)
            args = (q4[:, 0].contiguous(), kp, vp, table,
                    torch.tensor(lens, dtype=torch.int32, device=DEV))
            label = f"decode edge {i} {name}"
            got, ref, _ = decode_call(torch, ra, args, label)
            f32 = dtype == torch.float32
            err, rel = check_close(got, ref, f32, label)
            worst[name] = max(worst[name], err if f32 else rel)
    out["edge_cases"] = len(DECODE_EDGES)
    out["edge_max_abs_err_f32"] = worst["float32"]
    out["edge_max_rel_err_bf16"] = worst["bfloat16"]
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 6: the fused training attention against its plain version
# ---------------------------------------------------------------------------

def fused_work(B, H, Tq, Tk, D, itemsize, causal, lens):
    """(forward, backward) x (bytes, flops) of fused attention on these
    inputs, counting only what the function needs: a (query, key) pair
    only where the key is live (below the batch row's valid length in
    `lens`, all Tk when None) and, when causal, at or below the query's
    diagonal (key <= query + Tk - Tq); the K and V rows of live keys and
    the q and dO rows with at least one live pair read once, the bias
    read once, o forward and dq, dk, dv backward written whole; 4·D flops
    a pair forward and 10·D backward."""
    off = Tk - Tq
    pairs = live_q = live_kv = 0
    for b in range(B):
        n = Tk if lens is None else lens[b]
        seen = [min(max(i + off + 1, 0), n) if causal else n
                for i in range(Tq)]
        pairs += sum(seen)
        live_q += sum(1 for x in seen if x > 0)
        live_kv += max(seen, default=0)
    row = H * D * itemsize
    q_in, kv_in = live_q * row, live_kv * row
    q_out, kv_out = B * Tq * row, B * Tk * row
    pairs *= H
    bias = B * Tk * 4
    return ((q_in + 2 * kv_in + bias + q_out, 4 * D * pairs),
            (2 * q_in + 2 * kv_in + bias + q_out + 2 * kv_out,
             10 * D * pairs))


def fused_case(torch, F, fa, B, H, Tq, Tk, D, layout, causal, p, lens,
               dtype, seed, timed, pad=0):
    """Kernel against plain version on one set of inputs: forward output
    and the three gradients, the kernel family that ran (each launch
    counted under its key, the other family's keys untouched), and for
    bfloat16 whether two backward runs agree bit for bit; with `timed`,
    forward and backward times of the kernel, the plain version and
    F.scaled_dot_product_attention. `pad` > 0 lays q, k, v out as
    slices of rows D + pad elements apart."""
    rng = np.random.default_rng(seed)

    def shape(t, d=D):
        return (B, t, H, d) if layout == "BTHD" else (B, H, t, d)

    def leaf(t):
        x = torch.tensor(rng.standard_normal(shape(t, D + pad)), dtype=dtype,
                         device=DEV)[..., :D]
        return x.detach().requires_grad_(True)
    q, k, v = leaf(Tq), leaf(Tk), leaf(Tk)
    do = torch.tensor(rng.standard_normal(shape(Tq)), dtype=dtype,
                      device=DEV)
    mask = None if lens is None else (
        torch.arange(Tk, device=DEV)[None, :]
        < torch.tensor(lens, device=DEV)[:, None])
    words = torch.tensor([int(x) for x in rng.integers(-2 ** 31, 2 ** 31, 2)],
                         dtype=torch.int32, device=DEV)
    name = f"fused {layout} B={B} H={H} Tq={Tq} Tk={Tk} D={D} {dtype}"
    # the gate dot_product_attention routes by must take every call here
    require(fa.supported(q, k, mask, layout=layout),
            f"{name}: supported() refuses a call the kernel takes")
    route = fa.kernel_route(q, k, v, layout)
    require(route == "cuda_core" or dtype == torch.bfloat16,
            f"{name}: float32 routed to {route}")

    def run(impl):
        return fa.fused_attention(q, k, v, mask=mask, causal=causal,
                                  dropout_p=p, seed=words, layout=layout,
                                  impl=impl)
    res = {}
    for impl in ("auto", "torch"):
        fa.reset_launches()
        o = run(impl)
        res[impl] = (o, torch.autograd.grad(o, (q, k, v), do))
        launches = dict(fa.LAUNCHES)
        want = dict.fromkeys(launches, 0)
        if impl == "auto":
            want.update(dict.fromkeys(FAMILY_KEYS[route], 1))
        require(launches == want, f"{name} impl={impl}: launches {launches}")
    torch.cuda.synchronize()
    (o, g), (o_ref, g_ref) = res["auto"], res["torch"]
    err = (o.float() - o_ref.float()).abs().max().item()
    gabs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(g, g_ref)]
    grel = [e / b.float().abs().max().item() for e, b in zip(gabs, g_ref)]
    rel = err / o_ref.float().abs().max().item()
    f32 = dtype == torch.float32
    # float32 forward: absolute; bfloat16: relative to the largest output
    tol = 1e-5 if f32 else BF16_REL_TOL
    gtol = 1e-4 if f32 else BF16_REL_TOL
    require((err if f32 else rel) <= tol,
            f"{name}: forward err {err} (relative {rel}) > {tol}")
    require(max(grel) <= gtol, f"{name}: gradient rel errs {grel} > {gtol}")
    require(bool(torch.isfinite(o).all()) and all(
        bool(torch.isfinite(x).all()) for x in g), f"{name}: non-finite")
    if lens is not None and 0 in lens:
        b = lens.index(0)
        require(bool((o[b] == 0).all()),
                f"{name}: the fully padded batch row is not exactly 0")
    out = {"route": route, "max_abs_err": err, "rel_err": rel, "tol": tol,
           "tol_kind": "absolute" if f32 else "relative",
           "grad_max_abs_err": gabs, "grad_rel_err": grel, "grad_tol": gtol}
    # the backward is deterministic: no atomics, a fixed sum order
    g2 = torch.autograd.grad(run("auto"), (q, k, v), do)
    out["bwd_bit_identical"] = all(bool(torch.equal(a, b))
                                   for a, b in zip(g, g2))
    require(out["bwd_bit_identical"], f"{name}: two backward runs differ")
    del g2
    if not timed:
        return out
    del res
    name_t = "float32" if dtype == torch.float32 else "bfloat16"
    (fb, ff), (bb, bf) = fused_work(B, H, Tq, Tk, D, q.element_size(),
                                    causal, lens)
    out["bound_ms"], out["bound_by"] = bound(fb, ff, name_t)
    out["bwd_bound_ms"], out["bwd_bound_by"] = bound(bb, bf, name_t)
    if name_t == "float32":
        # the same work with every product as three TF32 products
        out["bound_tf32x3_ms"] = max(fb / HBM_BYTES_PER_S,
                                     ff / TF32X3_FLOPS) * 1e3
        out["bwd_bound_tf32x3_ms"] = max(bb / HBM_BYTES_PER_S,
                                         bf / TF32X3_FLOPS) * 1e3
    out.update(bytes=fb, flops=ff, bwd_bytes=bb, bwd_flops=bf)
    for impl, key in (("auto", ""), ("torch", "plain_")):
        with torch.no_grad():
            out[key + "ms"] = time_ms(torch, lambda: run(impl))
        o = run(impl)
        out[key + "bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
            o, (q, k, v), do, retain_graph=True))
        del o
    # the library yardstick: SDPA on (B, H, T, D) copies, the same mask
    # and dropout rate (its dropout bits differ; time only)
    bhtd = [(x if layout == "BHTD" else x.transpose(1, 2)).detach()
            .contiguous().requires_grad_(True) for x in (q, k, v)]
    dob = (do if layout == "BHTD" else do.transpose(1, 2)).contiguous()
    am = None if mask is None else mask[:, None, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(*bhtd, attn_mask=am,
                                              dropout_p=p, is_causal=causal)
    with torch.no_grad():
        out["library_ms"] = time_ms(torch, sdpa)
    o = sdpa()
    out["library_bwd_ms"] = time_ms(torch, lambda: torch.autograd.grad(
        o, bhtd, dob, retain_graph=True))
    out["ms_over_library"] = out["ms"] / out["library_ms"]
    out["bwd_ms_over_library"] = out["bwd_ms"] / out["library_bwd_ms"]
    del o, bhtd
    torch.cuda.empty_cache()
    return out


def phase_fused(torch, F, fa):
    B, _, T = FUSED_CELLS["bert_bthd"][:3]
    lens = [int(n) for n in np.random.default_rng(0).integers(
        T * 3 // 4, T + 1, B)]
    out = {"phase": "fused", "bert_valid_lengths": lens}
    for i, (label, (B, H, T, D, layout, causal, p)) in enumerate(
            FUSED_CELLS.items()):
        out[label] = {"shape": dict(B=B, H=H, Tq=T, Tk=T, D=D, layout=layout,
                                    causal=causal, dropout=p)}
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            r = fused_case(torch, F, fa, B, H, T, T, D, layout, causal, p,
                           None if causal else lens, dtype, seed=20 + i,
                           timed=True)
            require(r["route"] == ("cuda_core" if name == "float32"
                                   else "tensor_core"),
                    f"fused {label} {name}: routed to {r['route']}")
            out[label][name] = r
    # the CUDA-core kernels in bfloat16 at the BERT-base cell, untimed:
    # rows 68 elements apart are off the 16-byte grid, so the route rule
    # sends them there
    B, H, T, D, layout, causal, p = FUSED_CELLS["bert_bthd"]
    r = fused_case(torch, F, fa, B, H, T, T, D, layout, causal, p, lens,
                   torch.bfloat16, seed=20, timed=False, pad=4)
    require(r["route"] == "cuda_core", "padded rows took the tensor cores")
    out["bert_bthd"]["bfloat16_cuda_core"] = r
    # the CUDA-core kernels in bfloat16, timed, at the BERT-base cell with
    # D = 40 on rows 44 elements apart (off the 16-byte grid)
    r = fused_case(torch, F, fa, B, H, T, T, 40, layout, causal, p, lens,
                   torch.bfloat16, seed=21, timed=True, pad=4)
    require(r["route"] == "cuda_core", "padded rows took the tensor cores")
    out["bert_bthd_d40_unaligned"] = {"bfloat16": r}
    # (route, layout, causal) of every bfloat16 call held to the plain
    # version: each family must cover both layouts, causal and not
    covered = {(out[c]["bfloat16"]["route"], cell[4], cell[5])
               for c, cell in FUSED_CELLS.items()}
    covered.add(("cuda_core", layout, causal))
    worst = {"float32": 0.0, "bfloat16": 0.0}
    routes = []
    for i, args in enumerate(FUSED_EDGES):
        for dtype, name in ((torch.float32, "float32"),
                            (torch.bfloat16, "bfloat16")):
            r = fused_case(torch, F, fa, *args, dtype, seed=40 + i,
                           timed=False)
            worst[name] = max(worst[name], r["max_abs_err"] if name ==
                              "float32" else r["rel_err"],
                              max(r["grad_rel_err"]))
            if name == "bfloat16":
                routes.append(r["route"])
                covered.add((r["route"], args[5], args[6]))
    for family in FAMILY_KEYS:
        mine = sorted((lay, c) for f, lay, c in covered if f == family)
        require({lay for lay, _ in mine} == {"BTHD", "BHTD"}
                and {c for _, c in mine} == {False, True},
                f"bfloat16 calls on the {family} kernels cover only {mine}: "
                "both layouts, causal and not, are required")
        out[f"bf16_{family}_covers"] = mine
    out["edge_cases"] = len(FUSED_EDGES)
    out["edge_worst_err"] = worst
    out["edge_routes_bf16"] = routes
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5: GPT-2 774M served end to end
# ---------------------------------------------------------------------------

def serve(torch, eng, prompts, n_new, Request, reqs_out=None):
    """Serve greedy requests for `prompts`; their token streams and the
    wall seconds (ending in a device sync). The Request objects are
    appended to `reqs_out` when given."""
    reqs = [Request(p, n_new, request_id=i) for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if reqs_out is not None:
        reqs_out.extend(reqs)
    return [r.output_tokens for r in reqs], wall


def release_device(torch):
    """Collect what was dropped and return its device memory to the card.
    An engine with a host tier is a reference cycle (it installs bound
    methods of itself into its host pool and prefix cache), so `del`
    alone frees neither it nor its pages: only the collector does."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


KERNEL_CLASSES = (("fused_attention", ("fused_fwd", "fused_bwd")),
                  ("ragged_attention", ("ragged_",)),
                  ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("embedding_and_gather_backward", ("indexing_backward",
                                                     "scatter_gather")))


def kernel_class(name):
    for label, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def profiled(torch, run, top):
    """Call run() (which returns its own wall seconds, ending in a device
    sync) under torch.profiler (CPU and CUDA activities): the device's
    busy share of the window (sum of kernel times over wall time; the
    profiler's own host cost makes it a lower bound), device time by
    kernel class, and the `top` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.key_averages()
    # kernel launches issued by the host in the window
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    rows = sorted(((e.self_device_time_total, e.key, e.count)
                   for e in events
                   if e.device_type == cuda and e.self_device_time_total),
                  reverse=True)
    if not rows:
        return {"wall_s": wall, "device_busy_share": "not measured",
                "cuda_launches": launches}
    dev_ms = sum(r[0] for r in rows) / 1e3
    classes = {}
    for d, k, _ in rows:
        label = kernel_class(k)
        classes[label] = classes.get(label, 0.0) + d / 1e3
    span = [(d, c) for d, k, c in rows if "ragged_span" in k]
    return {"wall_s": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / (wall * 1e3),
            "span_device_ms": sum(d for d, _ in span) / 1e3,
            "span_launches": sum(c for _, c in span),
            "cuda_launches": launches,
            "device_ms_by_class": classes,
            "top_kernels": [{"name": k[:90], "ms": d / 1e3, "count": c}
                            for d, k, c in rows[:top]]}


# the serve profiles of phases 5 and 5b: dispatches 10-17 of the 38 a
# serve (every prompt has landed by then); a whole serve's trace cost
# 40-80 s of the profiler's post-processing each, so the window is kept
# short
SERVE_TRACE = (10, 8)


def trace_window(torch, eng, prompts, n_new, Request, skip, steps):
    """Serve `prompts` with dispatches skip .. skip + steps - 1 under the
    profiler (a steady window once every prompt has landed; the
    profiler's cost grows with the events it keeps), the rest outside
    it."""
    for i, p in enumerate(prompts):
        eng.submit(Request(p, n_new, request_id=i))
    for _ in range(skip):
        eng.step()
    require(all(x is None for x in eng._pending), "trace window: prompts "
            "still prefilling")

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    out = profiled(torch, run, 8)
    while eng.has_work:
        eng.step()
    out["dispatches"] = steps
    return out


def float_logits(torch, model, tokens, impl="torch"):
    """The float path's next-token logits after `tokens` (one slot, the
    whole prefix as one span), in float32: plain (impl "torch") or
    through the kernels ("auto")."""
    cache = model.make_cache(1, 1024, paged=True, page_size=64,
                             lengths=[0], attn_impl=impl)
    with torch.no_grad():
        logits, _ = model(torch.tensor([tokens], device=DEV), cache)
    return logits[0, -1].float()


def gap2(logits):
    """The gap between the two largest logits."""
    top = logits.topk(2).values
    return (top[0] - top[1]).item()


def first_token_rule(torch, model, prompts, got, want, label):
    """bfloat16 kernel path against bfloat16 plain path: with d the
    largest |kernel - plain| first-token logit (each prompt as one span),
    the first tokens must agree wherever the plain path's top-2 gap
    exceeds 2*d. Returns the readings and the streams' agreement."""
    first = []
    for i, p in enumerate(prompts):
        lk = float_logits(torch, model, p, "auto")
        lp = float_logits(torch, model, p)
        first.append({"request": i, "max_abs_logit_diff":
                      (lk - lp).abs().max().item(), "plain_top2_gap":
                      gap2(lp), "equal": got[i][0] == want[i][0]})
    d = max(r["max_abs_logit_diff"] for r in first)
    for r in first:
        if r["plain_top2_gap"] > 2 * d:
            require(r["equal"], f"{label} first token of request "
                    f"{r['request']} differs from the plain path where its "
                    f"gap {r['plain_top2_gap']} exceeds 2 x {d}")
    return {"max_abs_logit_diff": d, "first_tokens": first,
            "tokens_equal": sum(x == y for a, b in zip(got, want)
                                for x, y in zip(a, b)),
            "tokens": sum(map(len, want)),
            "streams_equal": sum(a == b for a, b in zip(got, want))}


def phase_gpt2(torch, ra, card):
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, PagedKVCache,
                                        init_params)
    from mxnet_tpu_torch.serving import Request, ServingEngine

    cfg = serve_config()
    t0 = time.perf_counter()
    model = GPT2ForCausalLM(cfg, device=DEV)
    init_params(model, seed=0, std=0.02)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in plens]
    n_new = 32
    out = {"phase": "gpt2", "card": card, "config": SERVE_CONFIG,
           "layers": cfg.num_layers, "units": cfg.units,
           "heads": cfg.num_heads, "vocab": cfg.vocab_size,
           "prompt_lens": [int(n) for n in plens], "new_tokens": n_new,
           "init_s": init_s}
    ekw = dict(num_slots=8, max_length=1024, page_size=64)

    # the main path: float32 through the kernels; launches counted here
    eng = ServingEngine(model, device=DEV, **ekw)
    ra.reset_launches()
    got, wall = serve(torch, eng, prompts, n_new, Request)
    dispatches = eng.stats["decode_dispatches"]
    span_launches = ra.LAUNCHES[SPAN]
    require(span_launches == SERVE_LAYERS * dispatches,
            f"span launches {span_launches} != {SERVE_LAYERS} x "
            f"{dispatches} dispatches")
    require(ra.LAUNCHES[SPAN_TC] == 0, "float32 launched the tensor cores")
    require(all(len(t) == n_new for t in got), "short streams")
    require(all(0 <= t < cfg.vocab_size for s in got for t in s),
            "token out of range")
    # one ragged single-token forward on the served cache drives the
    # decode kernel: each slot holds its request's prompt + 31 written
    # tokens (slot i served request i) and feeds its last token
    lengths = [int(n) + n_new - 1 for n in plens]
    table = eng._dstate["table"]
    last = torch.tensor([[s[-1]] for s in got], device=DEV)
    logits = {}
    for impl in ("auto", "torch"):
        cache = PagedKVCache(eng._kp, eng._vp, table,
                             torch.tensor(lengths, dtype=torch.int32,
                                          device=DEV), attn_impl=impl)
        with torch.no_grad():
            logits[impl] = model(last, cache)[0].float()
    launches = dict(ra.LAUNCHES)
    require(launches["ragged_decode_attention"] == SERVE_LAYERS,
            f"decode launches {launches['ragged_decode_attention']}")
    dlog = (logits["auto"] - logits["torch"]).abs().max().item()
    require(dlog <= 1e-4, f"decode forward logits differ by {dlog}")
    require(bool(torch.isfinite(logits["auto"]).all()), "non-finite logits")
    out["page_bytes"] = {"float32": eng.page_pool.page_bytes}
    out["streams_float32"] = got
    out["float32_kernel"] = {"card": card, "wall_s": wall,
                             "dispatches": dispatches,
                             "tokens": sum(map(len, got)),
                             "tokens_per_s": sum(map(len, got)) / wall,
                             "ms_per_dispatch": wall / dispatches * 1e3}
    out["launches"] = launches
    out["decode_forward_logits_max_abs_diff"] = dlog
    out["float32_kernel_trace"] = trace_window(
        torch, eng, prompts, n_new, Request, skip=SERVE_TRACE[0],
        steps=SERVE_TRACE[1])
    del eng, cache, logits
    release_device(torch)

    # the same traffic through the plain versions
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    want, wall = serve(torch, eng, prompts, n_new, Request)
    out["float32_plain"] = {"card": card, "wall_s": wall,
                            "dispatches": eng.stats["decode_dispatches"],
                            "ms_per_dispatch": wall
                            / eng.stats["decode_dispatches"] * 1e3}
    del eng
    release_device(torch)
    divergences = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(k for k in range(n_new) if a[k] != b[k])
            gap = gap2(float_logits(torch, model, prompts[i] + b[:j]))
            divergences.append({"request": i, "token": j, "top2_gap": gap})
            require(gap < 1e-4, f"request {i} diverges at token {j} where "
                    f"the plain top-2 gap is {gap}")
    out["streams_identical"] = not divergences
    out["divergences"] = divergences

    # the kernel path in bfloat16 (the same weights, rounded), timed: the
    # main path of the tensor-core span kernel, counts read here
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.reset_stats()
    ra.reset_launches()
    got16, wall = serve(torch, eng, prompts, n_new, Request)
    d16 = eng.stats["decode_dispatches"]
    launches16 = dict(ra.LAUNCHES)
    require(launches16[SPAN_TC] == SERVE_LAYERS * d16 and launches16[SPAN]
            == 0, f"bf16 span launches {launches16} for {d16} dispatches")
    out["launches_bf16"] = launches16
    out["page_bytes"]["bfloat16"] = eng.page_pool.page_bytes
    require(all(len(t) == n_new for t in got16), "short bf16 streams")
    out["bfloat16_kernel"] = {
        "card": card, "wall_s": wall, "dispatches": d16,
        "tokens_per_s": sum(map(len, got16)) / wall,
        "ms_per_dispatch": wall / d16 * 1e3,
        "greedy_tokens_equal_to_float32":
            sum(x == y for a, b in zip(got16, got) for x, y in zip(a, b)),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["bfloat16_kernel_trace"] = trace_window(
        torch, eng, prompts, n_new, Request, skip=SERVE_TRACE[0],
        steps=SERVE_TRACE[1])
    del eng
    release_device(torch)

    # bfloat16 kernel path against the bfloat16 plain path: with d the
    # largest |kernel - plain| first-token logit (each prompt as one
    # span), the first tokens must agree wherever the plain path's top-2
    # gap exceeds 2*d
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    before = dict(ra.LAUNCHES)
    want16, _ = serve(torch, eng, prompts, n_new, Request)
    require(ra.LAUNCHES == before, "the bf16 plain path launched a kernel")
    del eng
    release_device(torch)
    out["bfloat16_vs_plain"] = first_token_rule(torch, model, prompts,
                                                got16, want16, "bf16")
    del model
    release_device(torch)
    emit(out)
    return out


def serve_config():
    """GPT-2 774M's config at full width, cut to SERVE_LAYERS layers."""
    from mxnet_tpu_torch.models import gpt2_774m_config
    require(gpt2_774m_config().num_layers == GPT2_LAYERS,
            "774M config changed")
    return gpt2_774m_config(dropout=0.0, attention_dropout=0.0,
                            num_layers=SERVE_LAYERS)


def gpt2_774m(torch):
    """GPT-2 774M at full width, SERVE_LAYERS deep, with seeded random
    weights, float32."""
    from mxnet_tpu_torch.models import GPT2ForCausalLM, init_params
    cfg = serve_config()
    model = GPT2ForCausalLM(cfg, device=DEV)
    init_params(model, seed=0, std=0.02)
    return model, cfg


def int8_logits(torch, model, prompt, emitted, history):
    """The plain int8 path's next-token logits after `prompt + emitted`,
    on one slot replaying the engine's write schedule: the prompt in its
    recorded chunks (`history`, Request.kv_history), then each emitted
    token as a one-row write (int8 numerics depend on the chunking)."""
    cache = model.make_cache(1, 1024, paged=True, page_size=64,
                             lengths=[0], attn_impl="torch", kv_dtype="int8")
    cuts = np.cumsum([0] + list(history))
    feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    feeds += [[t] for t in emitted]
    with torch.no_grad():
        for toks in feeds:
            logits, cache = model(torch.tensor([toks], device=DEV), cache)
    return logits[0, -1].float()


def quantizer_bytes_match(torch):
    """The cache quantizer on the card writes the CPU's bytes: the same
    random write schedule (chunks of 1, 3 and 5 rows over pages of 4,
    dead span rows, locked pages, writes past capacity, growing
    magnitudes) into an int8 PagedKVCache on each device; codes and
    scales compared byte for byte (the CPU side is held to the JAX
    reference by tests/test_torch_quant_kv.py)."""
    from mxnet_tpu_torch.models import PagedKVCache
    rng = np.random.default_rng(7)
    L, B, H, D, S, P = 2, 4, 20, 64, 4, 3
    N = B * P + 2
    table = rng.permutation(N)[:B * P].reshape(B, P).astype(np.int32)
    caches = {dev: PagedKVCache.create(L, B, H, P * S, D, page_size=S,
                                       num_pages=N, page_table=table,
                                       lengths=np.zeros(B), kv_dtype="int8",
                                       device=dev) for dev in ("cpu", DEV)}
    for step in range(12):
        t = (1, 3, 5)[step % 3]
        lengths = rng.integers(0, P * S + 3, B).astype(np.int32)
        spans = rng.integers(0, t + 1, B).astype(np.int32)
        lock = rng.random(N) < 0.25
        k = ((1.0 + step) * rng.standard_normal((B, H, t, D))).astype(
            np.float32)
        v = ((1.0 + step) * rng.standard_normal((B, H, t, D))).astype(
            np.float32)
        for dev, c in caches.items():
            w = PagedKVCache(c.k_pages, c.v_pages, c.page_table,
                             torch.tensor(lengths, device=dev),
                             page_lock=torch.tensor(lock, device=dev),
                             spans=torch.tensor(spans, device=dev),
                             k_scale=c.k_scale, v_scale=c.v_scale)
            w.write_decode(step % L, torch.tensor(k, device=dev),
                           torch.tensor(v, device=dev))
    a, b = caches["cpu"], caches[DEV]
    return all(bool(torch.equal(x[:, :N], y[:, :N].cpu()))
               for x, y in ((a.k_pages, b.k_pages), (a.v_pages, b.v_pages),
                            (a.k_scale, b.k_scale), (a.v_scale, b.v_scale)))


def phase_gpt2_int8(torch, ra, card, gpt2):
    """Phase 5b: the 774M serve on int8 KV pages."""
    from mxnet_tpu_torch.models import PagedKVCache
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, cfg = gpt2_774m(torch)
    rng = np.random.default_rng(0)
    plens = rng.integers(16, 129, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in plens]
    require([int(n) for n in plens] == gpt2["prompt_lens"],
            "phase gpt2 and gpt2_int8 traffic differ")
    n_new = 32
    out = {"phase": "gpt2_int8", "card": card, "config": SERVE_CONFIG,
           "kv_dtype": "int8", "prompt_lens": gpt2["prompt_lens"],
           "new_tokens": n_new}
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64,
               kv_dtype="int8")

    # the int8 main path: float32 through the kernels; counts read here
    eng = ServingEngine(model, device=DEV, **ekw)
    ra.reset_launches()
    got, wall = serve(torch, eng, prompts, n_new, Request)
    launches = dict(ra.LAUNCHES)
    dispatches = eng.stats["decode_dispatches"]
    require(launches[INT8] == SERVE_LAYERS * dispatches,
            f"int8 span launches {launches[INT8]} != {SERVE_LAYERS} x "
            f"{dispatches}")
    require(launches[SPAN] == 0 and launches[SPAN_TC] == 0
            and launches[INT8_TC] == 0
            and launches["ragged_decode_attention"] == 0,
            f"other ragged kernels ran on float32 int8 pages: {launches}")
    require(all(len(t) == n_new for t in got), "short int8 streams")
    require(eng.audit_pages() == [], "int8 page audit failed")
    # one ragged single-token forward on the served int8 cache: every
    # t == 1 call takes the span kernel. Each path starts from the same
    # pools and scales (a forward writes, and scales never go down)
    lengths = torch.tensor([int(n) + n_new - 1 for n in plens],
                           dtype=torch.int32, device=DEV)
    last = torch.tensor([[s[-1]] for s in got], device=DEV)
    saved = [x.clone() for x in (eng._kp, eng._vp, eng._ks, eng._vs)]
    logits = {}
    for impl in ("auto", "torch"):
        for x, y in zip((eng._kp, eng._vp, eng._ks, eng._vs), saved):
            x.copy_(y)
        cache = PagedKVCache(eng._kp, eng._vp, eng._dstate["table"],
                             lengths, k_scale=eng._ks, v_scale=eng._vs,
                             attn_impl=impl)
        with torch.no_grad():
            logits[impl] = model(last, cache)[0].float()
        if impl == "auto":
            require(ra.LAUNCHES[INT8] - launches[INT8] == SERVE_LAYERS,
                    "the single-token int8 forward missed the span kernel")
    del saved, cache
    dlog = (logits["auto"] - logits["torch"]).abs().max().item()
    require(dlog <= 1e-4, f"int8 single-token logits differ by {dlog}")
    require(bool(torch.isfinite(logits["auto"]).all()), "non-finite logits")
    out["float32_kernel"] = {"card": card, "wall_s": wall,
                             "dispatches": dispatches,
                             "ms_per_dispatch": wall / dispatches * 1e3}
    out["launches"] = launches
    out["single_token_logits_max_abs_diff"] = dlog
    out["page_bytes"] = dict(gpt2["page_bytes"],
                             int8=eng.page_pool.page_bytes)
    out["kv_bytes_per_token"] = {k: v / 64
                                 for k, v in out["page_bytes"].items()}
    del eng, logits
    release_device(torch)

    # the same traffic through the plain versions
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    plain_reqs = []
    want, wall = serve(torch, eng, prompts, n_new, Request, plain_reqs)
    out["float32_plain"] = {"wall_s": wall, "ms_per_dispatch": wall
                            / eng.stats["decode_dispatches"] * 1e3}
    require(ra.LAUNCHES[INT8] == launches[INT8] + SERVE_LAYERS,
            "the plain path launched a kernel")
    del eng
    release_device(torch)
    divergences = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a != b:
            j = next(k for k in range(n_new) if a[k] != b[k])
            gap = gap2(int8_logits(torch, model, prompts[i], b[:j],
                                   plain_reqs[i].kv_history))
            divergences.append({"request": i, "token": j, "top2_gap": gap})
            require(gap < 1e-4, f"int8 request {i} diverges at token {j} "
                    f"where the plain top-2 gap is {gap}")
    out["streams_identical"] = not divergences
    out["divergences"] = divergences

    # int8 against phase gpt2's float32 streams, first tokens. With d the
    # largest |int8 - float32| logit of the prompt (plain paths, the
    # engine's write schedule), a float32 top-2 gap above 2*d leaves no
    # room for a flip: there the tokens must agree. Wherever the int8
    # path's own gap exceeds 1e-2 the engine's token must be its argmax.
    # (The reference's tiny-model rule, agreement wherever float32's gap
    # exceeds 1e-2, assumes d < 5e-3; at 774M d is measured instead.)
    f32 = gpt2["streams_float32"]
    first = []
    for i, p in enumerate(prompts):
        lf = float_logits(torch, model, p)
        l8 = int8_logits(torch, model, p, [], plain_reqs[i].kv_history)
        gap, gap8 = gap2(lf), gap2(l8)
        d = (l8 - lf).abs().max().item()
        row = {"request": i, "float32_top2_gap": gap, "int8_top2_gap": gap8,
               "max_abs_logit_diff": d, "max_abs_logit": lf.abs().max().item(),
               "equal": got[i][0] == f32[i][0],
               "int8_argmax_equal": int(l8.argmax()) == got[i][0]}
        first.append(row)
        if gap > 2 * d:
            require(row["equal"], f"int8 first token of request {i} differs "
                    f"from float32 where its gap {gap} exceeds 2 x {d}")
        if gap8 > 1e-2:
            require(row["int8_argmax_equal"], f"int8 first token of request "
                    f"{i} is not the int8 path's argmax (gap {gap8})")
    # the cache quantizer on the card against the CPU's bytes
    require(quantizer_bytes_match(torch),
            "the int8 cache quantizer writes other bytes on the card")
    out["vs_float32"] = {
        "tokens_equal": sum(x == y for a, b in zip(got, f32)
                            for x, y in zip(a, b)),
        "tokens": sum(map(len, f32)),
        "streams_equal": sum(a == b for a, b in zip(got, f32)),
        "first_tokens": first}

    # bfloat16 weights on int8 pages, timed and profiled: the main path
    # of the int8 tensor-core span kernel, counts read here
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.reset_stats()
    ra.reset_launches()
    got16, wall = serve(torch, eng, prompts, n_new, Request)
    d16 = eng.stats["decode_dispatches"]
    launches16 = dict(ra.LAUNCHES)
    require(launches16[INT8_TC] == SERVE_LAYERS * d16 and launches16[INT8]
            == 0, f"bf16 int8 span launches {launches16} for {d16}")
    out["launches_bf16"] = launches16
    require(all(len(t) == n_new for t in got16), "short bf16 int8 streams")
    out["bfloat16_kernel"] = {
        "card": card, "wall_s": wall, "dispatches": d16,
        "tokens_per_s": sum(map(len, got16)) / wall,
        "ms_per_dispatch": wall / d16 * 1e3,
        "greedy_tokens_equal_to_float32_int8":
            sum(x == y for a, b in zip(got16, got) for x, y in zip(a, b))}
    out["bfloat16_kernel_trace"] = trace_window(
        torch, eng, prompts, n_new, Request, skip=SERVE_TRACE[0],
        steps=SERVE_TRACE[1])
    del eng, model
    release_device(torch)
    emit(out)
    return out


def phase_prefix(torch, ra, card):
    """Phase 5c: shared-prefix traffic with the prefix cache off and on,
    float32 and int8 pages, the kernel path."""
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, cfg = gpt2_774m(torch)
    rng = np.random.default_rng(1)
    S, n_pre, n_new = 64, 256, 32
    prefix = rng.integers(0, cfg.vocab_size, n_pre).tolist()
    tails = [rng.integers(0, cfg.vocab_size, int(n)).tolist()
             for n in rng.integers(16, 129, 8)]
    prompts = [prefix + t for t in tails]
    # a non-binding prefill budget keeps each prompt on the chunk_tokens
    # grid whoever shares the dispatch: int8 numerics depend on where
    # chunks end, and a page-aligned prefix hit starts on that grid
    ekw = dict(num_slots=8, max_length=1024, page_size=S, chunk_tokens=S,
               prefill_chunk_budget=8 * S)
    out = {"phase": "prefix", "card": card, "config": SERVE_CONFIG,
           "prefix_tokens": n_pre, "tail_lens": [len(t) for t in tails],
           "new_tokens": n_new}
    f32_pool_bytes = None
    for kv in ("float32", "int8"):
        runs = {}
        for on in (False, True):
            kw = dict(ekw, kv_dtype="int8" if kv == "int8" else None,
                      prefix_cache=on)
            if kv == "int8" and on:
                # the float32 cache-on pool's bytes as the int8 budget
                kw["hbm_budget_bytes"] = f32_pool_bytes
            eng = ServingEngine(model, device=DEV, **kw)
            if kv == "float32" and on:
                f32_pool_bytes = eng.page_pool.num_pages \
                    * eng.page_pool.page_bytes
            ra.reset_launches()
            walls, streams = [], []
            for group in ([prompts[0]], prompts[1:]):
                toks, wall = serve(torch, eng, group, n_new, Request)
                streams += toks
                walls.append(wall)
            tree = before = None
            if on:
                pc = eng.prefix_cache
                tree = sorted(pc._by_page)
                leaves = [eng._kp, eng._vp] + (
                    [eng._ks, eng._vs] if kv == "int8" else [])
                before = [x[:, tree].clone() for x in leaves]
            toks, wall = serve(torch, eng, [prefix], n_new, Request)
            streams += toks
            walls.append(wall)
            if on:
                same = all(bool(torch.equal(b, x[:, tree]))
                           for b, x in zip(before, leaves))
                require(same, f"prefix {kv}: the CoW request wrote into "
                        "the tree's pages")
                del before
            audit = eng.audit_pages()
            require(audit == [], f"prefix {kv} on={on}: audit {audit}")
            key = INT8 if kv == "int8" else SPAN
            require(ra.LAUNCHES[key] == SERVE_LAYERS
                    * eng.stats["decode_dispatches"]
                    and ra.LAUNCHES[SPAN_TC] == ra.LAUNCHES[INT8_TC] == 0,
                    f"prefix {kv}: the span kernel missed dispatches")
            st = eng.stats
            runs[on] = {"streams": streams, "wall_s": walls,
                        "ms_per_serve": [w * 1e3 for w in walls],
                        "dispatches": st["decode_dispatches"],
                        "prefill_tokens": st["prefill_tokens"],
                        "prefix_hits": st["prefix_hits"],
                        "prefix_misses": st["prefix_misses"],
                        "prefix_tokens_saved": st["prefix_tokens_saved"],
                        "pool_pages": eng.page_pool.num_pages,
                        "page_bytes": eng.page_pool.page_bytes,
                        "hbm_budget_bytes": kw.get("hbm_budget_bytes")}
            del eng
            release_device(torch)
        off, on = runs[False], runs[True]
        require(on["streams"] == off["streams"],
                f"prefix {kv}: streams differ with the cache on and off")
        saved = 7 * n_pre + (n_pre - 1)
        require(on["prefix_tokens_saved"] == saved,
                f"prefix {kv}: saved {on['prefix_tokens_saved']} != {saved}")
        require(on["prefill_tokens"] + on["prefix_tokens_saved"]
                == off["prefill_tokens"], f"prefix {kv}: prefill identity")
        for r in (off, on):
            del r["streams"]
        out[kv] = {"off": off, "on": on, "streams_identical": True}
    del model
    release_device(torch)
    emit(out)
    return out


def spec_traffic(vocab):
    """Phase 5d's prompts: a random head of U[2, 6] tokens, then a 4-token
    pattern repeated U[4, 8] times (numpy seed 2), 8 of them."""
    rng = np.random.default_rng(2)
    prompts = []
    for _ in range(8):
        head = rng.integers(0, vocab, int(rng.integers(2, 7))).tolist()
        pat = rng.integers(0, vocab, 4).tolist()
        prompts.append(head + pat * int(rng.integers(4, 9)))
    return prompts


def gpt2_traffic(vocab):
    """Phase 5's prompts: lengths U[16, 128] (numpy seed 0)."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, int(n)).tolist()
            for n in rng.integers(16, 129, 8)]


class counting:
    """Count the calls of module attribute `name` while in the block (the
    plain version of a kernel must not run on a kernel path)."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        self.fn = getattr(self.module, self.name)

        def wrapped(*args, **kwargs):
            self.calls += 1
            return self.fn(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def serve_gaps(torch, eng, prompts, n_new, Request, wear=None):
    """Serve greedy requests as serve() does, stepping the engine by hand
    under a forward hook on its model that reads the top-2 logit gap of
    every row of every dispatch. Returns (streams, gaps, wall): gaps[i][k]
    is the gap of the logits token k of request i was the argmax of (the
    final prompt chunk's last row for the first token, the verify or
    decode row that emitted it for later ones)."""
    wear = wear or [None] * len(prompts)
    reqs = [Request(p, n_new, request_id=i, adapter_id=wear[i])
            for i, p in enumerate(prompts)]
    gaps = [[] for _ in reqs]
    rows = []

    def hook(module, args, output):
        top = output[0].float().topk(2, dim=-1).values
        g = (top[..., 0] - top[..., 1]).cpu()
        for s in eng.scheduler.active_slots:
            r = eng.scheduler.request_at(s)
            pend = eng._pending[s]
            rows.append((r, len(r.output_tokens),
                         0 if pend is None else int(pend.size), g[s]))
    handle = eng.model.register_forward_hook(hook)
    try:
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while eng.has_work:
            eng.step()
            for r, k0, pend, g in rows:
                new = len(r.output_tokens) - k0
                if new and pend:     # the final chunk held `pend` tokens
                    gaps[r.id].append(float(g[pend - 1]))
                elif new:
                    gaps[r.id] += g[:new].tolist()
            rows.clear()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        handle.remove()
    return [r.output_tokens for r in reqs], gaps, wall


def held_to(got, want, gaps, label, tol=1e-4):
    """Streams equal, except where the other path's own top-2 gap at the
    first differing token is below `tol`. Returns the divergences."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next((k for k in range(min(len(a), len(b))) if a[k] != b[k]),
                 min(len(a), len(b)))
        g = gaps[i][j] if j < len(gaps[i]) else None
        out.append({"request": i, "token": j, "top2_gap": g})
        require(g is not None and g < tol, f"{label}: request {i} diverges "
                f"at token {j} where the other path's top-2 gap is {g}")
    return out


def serve_stats(eng, wall, streams):
    st = eng.stats
    d = st["decode_dispatches"]
    return {"wall_s": wall, "dispatches": d,
            "tokens": sum(map(len, streams)),
            "tokens_per_dispatch": sum(map(len, streams)) / d,
            "ms_per_dispatch": wall / d * 1e3}


def phase_gpt2_spec(torch, ra, card):
    """Phase 5d: speculative decoding on the 774M model."""
    from mxnet_tpu_torch.serving import Request, ServingEngine

    model, cfg = gpt2_774m(torch)
    prompts = spec_traffic(cfg.vocab_size)
    n_new = 64
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    out = {"phase": "gpt2_spec", "card": card, "config": SERVE_CONFIG,
           "engine": dict(ekw, **SPEC), "prompt_lens": list(map(len, prompts)),
           "new_tokens": n_new}
    for label, dtype, kv in (("float32", torch.float32, None),
                             ("int8_pages", torch.float32, "int8"),
                             ("bfloat16", torch.bfloat16, None)):
        model.to(dtype)
        kw = dict(ekw, kv_dtype=kv)
        key = INT8 if kv else (SPAN if dtype == torch.float32 else SPAN_TC)
        res = {"card": card}
        if kv is None:
            # speculation off first (it warms the path up)
            eng = ServingEngine(model, device=DEV, **kw)
            off, wall = serve(torch, eng, prompts, n_new, Request)
            res["off"] = serve_stats(eng, wall, off)
            del eng
        # the main path of this family with speculation: counts read here
        eng = ServingEngine(model, device=DEV, **kw, **SPEC)
        with counting(ra, "_ragged_span_reference") as plain_calls:
            ra.reset_launches()
            got, wall = serve(torch, eng, prompts, n_new, Request)
            launches = dict(ra.LAUNCHES)
        st = eng.stats
        d = st["decode_dispatches"]
        require(launches[key] == SERVE_LAYERS * d and sum(launches.values())
                == launches[key], f"spec {label}: launches {launches} for "
                f"{d} dispatches")
        require(plain_calls.calls == 0, f"spec {label}: the plain span "
                f"version ran {plain_calls.calls} times on the kernel path")
        require(all(len(t) == n_new for t in got), f"spec {label}: short")
        require(st["spec_accepted_tokens"] > 0, f"spec {label}: no draft "
                "was accepted")
        require(eng.audit_pages() == [], f"spec {label}: page audit")
        res["on"] = serve_stats(eng, wall, got)
        res["launches"] = launches
        res["spec"] = {k: st[k] for k in ("spec_draft_tokens",
                                          "spec_accepted_tokens",
                                          "spec_rollbacks")}
        res["acceptance_rate"] = st["spec_accepted_tokens"] \
            / st["spec_draft_tokens"]
        del eng
        if kv is None:
            require(got == off, f"spec {label}: streams differ with "
                    "speculation on and off")
            res["streams_equal_on_off"] = True
            res["on_over_off_ms_per_token"] = (
                res["on"]["wall_s"] / res["on"]["tokens"]) / (
                res["off"]["wall_s"] / res["off"]["tokens"])
            if dtype == torch.float32:
                eng = ServingEngine(model, device=DEV, **kw, **SPEC)
                res["trace"] = trace_window(torch, eng, prompts, n_new,
                                            Request, skip=10, steps=20)
                del eng
        # the plain path with speculation on
        eng = ServingEngine(model, attn_impl="torch", device=DEV, **kw,
                            **SPEC)
        before = dict(ra.LAUNCHES)
        want, gaps, _ = serve_gaps(torch, eng, prompts, n_new, Request)
        require(ra.LAUNCHES == before, f"spec {label}: the plain path "
                "launched a kernel")
        if dtype == torch.float32:
            res["divergences"] = held_to(got, want, gaps, f"spec {label}")
        else:
            res["vs_plain"] = first_token_rule(torch, model, prompts, got,
                                               want, f"spec {label}")
        res["streams_equal_kernel_plain"] = got == want
        del eng
        release_device(torch)
        out[label] = res
    out["launches_by_family"] = {
        "float32": out["float32"]["launches"][SPAN],
        "bfloat16": out["bfloat16"]["launches"][SPAN_TC],
        "int8": out["int8_pages"]["launches"][INT8]}
    del model
    release_device(torch)
    emit(out)
    return out


def phase_gpt2_w8(torch, ra, card, gpt2):
    """Phase 5e: w8 weights on the 774M model."""
    from mxnet_tpu_torch.serving import Request, ServingEngine, dequantize

    model, cfg = gpt2_774m(torch)
    prompts = gpt2_traffic(cfg.vocab_size)
    require(list(map(len, prompts)) == gpt2["prompt_lens"],
            "phase gpt2 and gpt2_w8 traffic differ")
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64)
    out = {"phase": "gpt2_w8", "card": card, "config": SERVE_CONFIG,
           "weight_dtype": "int8", "prompt_lens": gpt2["prompt_lens"],
           "new_tokens": n_new}
    # the w8 main path: the kernels; counts read here. The engine
    # quantizes the model's dense weights in place
    eng = ServingEngine(model, device=DEV, weight_dtype="int8", **ekw)
    plan = eng._w8_plan
    ra.reset_launches()
    got, wall = serve(torch, eng, prompts, n_new, Request)
    d = eng.stats["decode_dispatches"]
    require(ra.LAUNCHES[SPAN] == SERVE_LAYERS * d, f"w8 span launches "
            f"{ra.LAUNCHES[SPAN]} for {d} dispatches")
    require(all(len(t) == n_new for t in got), "w8: short streams")
    out["launches"] = dict(ra.LAUNCHES)
    out["w8_kernel"] = serve_stats(eng, wall, got)
    out["weight_bytes"] = {"w8": dict(eng.weight_bytes)}
    out["quantized_weights"] = len(plan)
    del eng
    # the plain path (the model now serves its codes in any engine)
    eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
    require(eng.weight_dtype == "int8", "the quantized model serves float")
    want, gaps, wall = serve_gaps(torch, eng, prompts, n_new, Request)
    out["w8_plain"] = serve_stats(eng, wall, want)
    out["divergences_plain"] = held_to(got, want, gaps, "w8 kernel/plain")
    del eng
    # the float engine over the dequantized weights, kernel path
    ref, _ = gpt2_774m(torch)
    with torch.no_grad():
        for q in plan:
            ref.get_parameter(q.name).copy_(dequantize(q))
    eng = ServingEngine(ref, device=DEV, **ekw)
    deq, wall = serve(torch, eng, prompts, n_new, Request)
    out["float32_kernel"] = serve_stats(eng, wall, deq)
    out["weight_bytes"]["float32"] = dict(eng.weight_bytes)
    out["w8_over_float32_ms_per_dispatch"] = \
        out["w8_kernel"]["ms_per_dispatch"] \
        / out["float32_kernel"]["ms_per_dispatch"]
    page_bytes = eng.page_pool.page_bytes
    del eng
    out["streams_equal_dequantized"] = got == deq
    gaps = None
    if got != deq:
        # the float engine's own gaps, read again only where needed
        eng = ServingEngine(ref, device=DEV, **ekw)
        deq, gaps, _ = serve_gaps(torch, eng, prompts, n_new, Request)
        del eng
    out["divergences_dequantized"] = held_to(got, deq, gaps,
                                             "w8 / dequantized float")
    release_device(torch)
    # one budget the float32 weights bind: their bytes + 48 pages (the
    # slots want 128)
    budget = sum(out["weight_bytes"]["float32"].values()) + 48 * page_bytes
    pages = {}
    for name, m in (("float32", ref), ("w8", model)):
        eng = ServingEngine(m, device=DEV, hbm_budget_bytes=budget,
                            hbm_budget_includes_weights=True, **ekw)
        pages[name] = eng.page_pool.num_pages
        del eng
        release_device(torch)
    require(pages["float32"] == 48 and pages["w8"] > pages["float32"],
            f"w8 admitted pages {pages}")
    out["budget"] = {"hbm_budget_bytes": budget, "page_bytes": page_bytes,
                     "pages": pages}
    out["gpt2_float32_kernel_ms_per_dispatch"] = \
        gpt2["float32_kernel"]["ms_per_dispatch"]
    del model, ref
    release_device(torch)
    emit(out)
    return out


def phase_gpt2_lora(torch, ra, card, gpt2):
    """Phase 5f: LoRA adapters on the 774M model."""
    from mxnet_tpu_torch.serving import (AdapterPool, Request, ServingEngine,
                                         merged_weights, random_lora)

    model, cfg = gpt2_774m(torch)
    prompts = gpt2_traffic(cfg.vocab_size)
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64,
               prefill_chunk_budget=8 * 64, retry_backoff_s=0.0)
    out = {"phase": "gpt2_lora", "card": card, "config": SERVE_CONFIG,
           "pool": dict(slots=4, max_rank=8), "wear": LORA_WEAR,
           "prompt_lens": gpt2["prompt_lens"], "new_tokens": n_new}
    adapters = {i: random_lora(cfg, rank=r, seed=i)
                for i, r in zip((1, 2, 3, 4), (4, 8, 8, 8))}
    # without a pool: the null-adapter streams' oracle, and the time
    eng = ServingEngine(model, device=DEV, **ekw)
    bare, wall = serve(torch, eng, prompts, n_new, Request)
    out["no_pool"] = serve_stats(eng, wall, bare)
    del eng
    # the attention weights as they are, to merge each adapter into
    attn = {(li, p): model.get_parameter(
        f"backbone.layer{li}.attn.{p}.weight")
        for li in range(cfg.num_layers)
        for p in ("query", "key", "value", "proj")}
    base = {k: w.detach().cpu().numpy().copy() for k, w in attn.items()}
    for slab in (None, "int8"):
        pool = AdapterPool(cfg, slots=4, max_rank=8, dtype=slab, device=DEV)
        for i, w in adapters.items():
            pool.register(i, w)
        eng = ServingEngine(model, device=DEV, adapter_pool=pool, **ekw)
        reqs = [Request(p, n_new, request_id=i, adapter_id=LORA_WEAR[i])
                for i, p in enumerate(prompts)]
        ra.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [r.output_tokens for r in reqs]
        st = eng.stats
        d = st["decode_dispatches"]
        require(ra.LAUNCHES[SPAN] == SERVE_LAYERS * d, f"lora span launches "
                f"{ra.LAUNCHES[SPAN]} for {d} dispatches")
        require(all(len(t) == n_new for t in got), "lora: short streams")
        require(eng.audit_pages() == [], "lora: page or adapter audit")
        require(st["adapter_evictions"] > 0 and st["dispatch_retries"] > 0,
                f"lora: the slab never evicted or pushed back: {st}")
        res = {"pool": serve_stats(eng, wall, got),
               "adapter_page_ins": st["adapter_page_ins"],
               "adapter_evictions": st["adapter_evictions"],
               "dispatch_retries": st["dispatch_retries"],
               "slab_bytes": pool.slab_bytes()}
        del eng
        for i, aid in enumerate(LORA_WEAR):
            if aid is None:
                require(got[i] == bare[i], f"lora {slab}: null-adapter "
                        f"request {i} differs from the engine without pool")
        res["divergences"] = {}
        for aid, w in adapters.items():
            eff = pool.effective_weights(aid)
            with torch.no_grad():
                for (li, p), t in attn.items():
                    t.copy_(torch.from_numpy(merged_weights(
                        base[(li, p)], eff, p, li)))
            idx = [i for i, a in enumerate(LORA_WEAR) if a == aid]
            eng = ServingEngine(model, attn_impl="torch", device=DEV, **ekw)
            want, gaps, _ = serve_gaps(torch, eng, [prompts[i] for i in idx],
                                       n_new, Request)
            del eng
            res["divergences"][aid] = held_to(
                [got[i] for i in idx], want, gaps,
                f"lora {slab} adapter {aid} / merged")
        with torch.no_grad():
            for k, t in attn.items():
                t.copy_(torch.from_numpy(base[k]))
        del pool
        release_device(torch)
        out["float_slab" if slab is None else "int8_slab"] = res
    out["pool_over_no_pool_ms_per_dispatch"] = \
        out["float_slab"]["pool"]["ms_per_dispatch"] \
        / out["no_pool"]["ms_per_dispatch"]
    del model
    release_device(torch)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 5g and 5h: the host KV tier and the robustness layer
# ---------------------------------------------------------------------------

# phase 5g: 16 pages of host tier (of the engine's page dtype) and 8 of
# prefix cache beyond the slots' own pages
TIER = dict(prefix_cache_pages=8, host_pages=16)


def page_bytes(model, kw):
    """The device bytes of one KV page of an engine with options kw."""
    from mxnet_tpu_torch.serving import ServingEngine
    eng = ServingEngine(model, device=DEV, **kw)
    return eng.page_pool.page_bytes


def tier_traffic(vocab):
    """Phase 5g's prompts: four 256-token system prompts (numpy seed 3),
    each with a tail U[16, 128]; round A one request per prefix, round B
    two per prefix in the order 4, 3, 2, 1."""
    rng = np.random.default_rng(3)
    systems = [rng.integers(0, vocab, 256).tolist() for _ in range(4)]

    def tail():
        return rng.integers(0, vocab, int(rng.integers(16, 129))).tolist()
    round_a = [systems[i] + tail() for i in range(4)]
    round_b = [systems[i] + tail() for i in (3, 3, 2, 2, 1, 1, 0, 0)]
    return round_a, round_b


def serve_rounds(torch, eng, rounds, n_new, Request, audit=False):
    """Serve each round of greedy requests to its end, one round after
    the other; the streams, the wall seconds (ending in a device sync)
    and, with `audit`, every page and host-tier violation seen after a
    step."""
    streams, bad = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k, prompts in enumerate(rounds):
        reqs = [Request(p, n_new, request_id=f"{k}.{i}")
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        while eng.has_work:
            eng.step()
            if audit:
                bad += eng.audit_pages()
                if eng.host_pool is not None:
                    bad += eng.host_pool.audit()
        streams += [r.output_tokens for r in reqs]
    torch.cuda.synchronize()
    return streams, time.perf_counter() - t0, bad


def tier_copy_rates(torch, eng, n):
    """ms and GB/s of the tier's page gather (device -> pinned staging ->
    numpy payloads) and page scatter (payloads -> pinned staging ->
    device pages) of n pages, median of 5, against a plain pinned copy_
    of the same bytes each way (the yardstick), and the cost of one
    pinned allocation of that size."""
    pages = list(range(n))
    nbytes = n * eng.page_pool.page_bytes

    def timed(fn, reps=5):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(np.median(times)) * 1e3
    eng._tier_gather(pages)                      # grows the staging block
    payloads = eng._tier_gather(pages)
    fresh = eng.page_pool.alloc(n)
    out = {"pages": n, "bytes": nbytes,
           "gather_ms": timed(lambda: eng._tier_gather(pages)),
           "scatter_ms": timed(lambda: eng._tier_scatter(
               list(zip(fresh, payloads))))}
    eng.page_pool.free(eng.page_pool.decref(fresh))
    dev = torch.empty(nbytes, dtype=torch.uint8, device=DEV)
    t0 = time.perf_counter()
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out["pinned_alloc_ms"] = (time.perf_counter() - t0) * 1e3
    out["pinned_d2h_ms"] = timed(lambda: host.copy_(dev, non_blocking=True))
    out["pinned_h2d_ms"] = timed(lambda: dev.copy_(host, non_blocking=True))
    for key in ("gather", "scatter", "pinned_d2h", "pinned_h2d"):
        out[key + "_gb_s"] = nbytes / out[key + "_ms"] / 1e6
    return out


def phase_gpt2_tier(torch, ra, card, model, cfg):
    """Phase 5g: the host KV tier on the 774M model."""
    from mxnet_tpu_torch.serving import Request, ServingEngine

    rounds = tier_traffic(cfg.vocab_size)
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64,
               prefix_cache=True)
    out = {"phase": "gpt2_tier", "card": card, "config": SERVE_CONFIG,
           "engine": dict(ekw, prefix_cache_pages=TIER["prefix_cache_pages"],
                          host_kv_bytes=f"{TIER['host_pages']} pages"),
           "prompt_lens": [list(map(len, r)) for r in rounds],
           "new_tokens": n_new}
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    for label, dtype, kv, key in (("float32", torch.float32, None, SPAN),
                                  ("int8_pages", torch.float32, "int8",
                                   INT8),
                                  ("bfloat16", torch.bfloat16, None,
                                   SPAN_TC)):
        model.to(dtype)
        kw = dict(ekw, kv_dtype=kv)
        pb = page_bytes(model, kw)
        host = TIER["host_pages"] * pb
        res = {"card": card, "page_bytes": pb, "host_kv_bytes": host}
        # never evicted: the streams' oracle
        eng = ServingEngine(model, device=DEV, prefix_cache_pages=64, **kw)
        want, wall, _ = serve_rounds(torch, eng, rounds, n_new, Request)
        res["never_evicted"] = serve_stats(eng, wall, want)
        del eng
        # the main path of the tier in this dtype: counts read here
        eng = ServingEngine(model, device=DEV, host_kv_bytes=host,
                            prefix_cache_pages=TIER["prefix_cache_pages"],
                            **kw)
        with counting(ra, "_ragged_span_reference") as plain_calls:
            ra.reset_launches()
            got, wall, bad = serve_rounds(torch, eng, rounds, n_new, Request,
                                          audit=True)
            launches = dict(ra.LAUNCHES)
        st = eng.stats
        d = st["decode_dispatches"]
        require(launches[key] == SERVE_LAYERS * d and sum(launches.values())
                == launches[key], f"tier {label}: launches {launches} for "
                f"{d} dispatches")
        require(plain_calls.calls == 0, f"tier {label}: the plain span "
                f"version ran {plain_calls.calls} times on the kernel path")
        require(bad == [], f"tier {label}: audits {bad[:3]}")
        require(got == want, f"tier {label}: streams differ from the "
                "never-evicted engine's")
        require(st["kv_spill_pages"] >= 8 and st["kv_pagein_pages"] >= 8,
                f"tier {label}: spilled {st['kv_spill_pages']}, paged in "
                f"{st['kv_pagein_pages']} pages")
        res["tier"] = serve_stats(eng, wall, got)
        res["launches"] = launches
        res["counters"] = {k: st[k] for k in (
            "kv_spill_pages", "kv_spill_bytes", "kv_pagein_pages",
            "kv_pagein_bytes", "kv_host_evictions", "prefix_hits",
            "prefix_tokens_saved", "prefill_tokens")}
        res["prompt_tokens"] = {
            "paged_in": st["kv_pagein_pages"] * 64,
            "attached": st["prefix_tokens_saved"],
            "recomputed": st["prefill_tokens"]}
        res["copies"] = tier_copy_rates(torch, eng, 16)
        del eng
        # the tier off at the same cache size: what was evicted is
        # recomputed
        eng = ServingEngine(model, device=DEV,
                            prefix_cache_pages=TIER["prefix_cache_pages"],
                            **kw)
        off, wall, _ = serve_rounds(torch, eng, rounds, n_new, Request)
        res["tier_off"] = serve_stats(eng, wall, off)
        res["tier_off"]["recomputed"] = eng.stats["prefill_tokens"]
        del eng
        res["streams_equal_tier_off"] = off == want
        res["tier_over_off_ms_per_serve"] = \
            res["tier"]["wall_s"] / res["tier_off"]["wall_s"]
        res["tier_over_off_ms_per_dispatch"] = \
            res["tier"]["ms_per_dispatch"] / res["tier_off"]["ms_per_dispatch"]
        release_device(torch)
        out[label] = res
    model.to(torch.float32)
    model.load_state_dict(saved)
    del saved
    release_device(torch)
    out["launches_by_family"] = {
        "float32": out["float32"]["launches"][SPAN],
        "bfloat16": out["bfloat16"]["launches"][SPAN_TC],
        "int8": out["int8_pages"]["launches"][INT8]}
    emit(out)
    return out


class Tick:
    """An injected engine clock: deadlines and backoff advance only when
    the phase says so."""

    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def robust_traffic(vocab, n=32):
    """Phase 5h's chaos prompts: lengths U[16, 128] (numpy seed 4)."""
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, int(rng.integers(16, 129))).tolist()
            for _ in range(n)]


def chaos(torch, eng, prompts, n_new, Request, plan=None):
    """Phase 5h's chaos soak: sampled requests c0.. arriving Poisson at
    mean 3 a step (numpy seed 13), `plan` installed. Returns the
    requests by id, the wall seconds and the engine's audits after the
    run."""
    reqs = [Request(p, n_new, request_id=f"c{i}", do_sample=True,
                    temperature=0.8, seed=1000 + i)
            for i, p in enumerate(prompts)]
    if plan is not None:
        plan.install(eng)
    arrivals = np.random.default_rng(13)
    pending = reqs[::-1]
    steps = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        while (pending or eng.has_work) and steps < 5000:
            for _ in range(int(arrivals.poisson(3.0))):
                if pending:
                    eng.submit(pending.pop())
            eng.step()
            steps += 1
    finally:
        if plan is not None:
            plan.uninstall()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(steps < 5000, "chaos: the soak did not converge")
    return {r.id: r for r in reqs}, wall, eng.audit_pages()


class caught:
    """Record what the engine's supervisor catches: the exception of
    every admission and dispatch fault, and each dispatch whose finite
    guard flagged slots."""

    def __init__(self, eng):
        self.errors, self.nan_dispatches = [], 0
        for name in ("_on_admit_fault", "_on_decode_fault", "_on_bad_slots"):
            setattr(eng, name, self._wrap(name, getattr(eng, name)))

    def _wrap(self, name, fn):
        def wrapped(*args):
            if name == "_on_bad_slots":
                self.nan_dispatches += 1
            else:
                self.errors.append(args[-1])
            return fn(*args)
        return wrapped


def preempt_run(torch, model, prompts, n_new, Request, ServingEngine, ekw,
                policy=None, host_kv_bytes=None):
    """Phase 5h's preemption traffic: eight priority-2 requests fill the
    slots (one submitted a step); once each has emitted 2 tokens two
    priority-0 requests arrive.
    Returns the streams by id, the dispatches from their arrival to the
    urgent requests' first tokens, the engine, and the audits seen after
    each step."""
    eng = ServingEngine(model, device=DEV, clock=Tick(), policy=policy,
                        host_kv_bytes=host_kv_bytes, **ekw)
    low = [Request(p, n_new, request_id=f"low{i}", priority=2)
           for i, p in enumerate(prompts[:8])]
    urgent = [Request(p, n_new, request_id=f"urgent{i}", priority=0)
              for i, p in enumerate(prompts[8:10])]
    for r in low:                   # one a step: the queue stays short
        eng.submit(r)
        eng.step()
    bad = []
    while any(len(r.output_tokens) < 2 for r in low):
        eng.step()
    for r in urgent:
        eng.submit(r)
    d0, wait = eng.stats["decode_dispatches"], None
    while eng.has_work:
        eng.step()
        bad += eng.audit_pages()
        if eng.host_pool is not None:
            bad += eng.host_pool.audit()
        if wait is None and all(r.output_tokens for r in urgent):
            wait = eng.stats["decode_dispatches"] - d0
    require(all(r.status == "finished" for r in low + urgent),
            "preempt: a request did not finish")
    return ({r.id: r.output_tokens for r in low + urgent}, wait, eng, bad)


def phase_gpt2_robust(torch, ra, card, model, cfg):
    """Phase 5h: the supervisor, the finite guard, deadlines, the
    shedding policy and preemption on the 774M model."""
    from mxnet_tpu_torch.serving import (FaultError, FaultPlan,
                                         PagePoolExhausted, Request,
                                         ServingEngine, SheddingPolicy)

    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    out = {"phase": "gpt2_robust", "card": card,
           "config": SERVE_CONFIG, "engine": ekw}

    # chaos: every fault kind, poison in both phases, float32 pages
    prompts = robust_traffic(cfg.vocab_size)
    n_new = 16
    poison = {"c5": "both", "c17": "decode"}
    eng = ServingEngine(model, device=DEV, **ekw)
    clean, wall0, _ = chaos(torch, eng, prompts, n_new, Request)
    d0 = eng.stats["decode_dispatches"]
    del eng
    eng = ServingEngine(model, device=DEV, max_retries=4,
                        retry_backoff_s=0.0, **ekw)
    seen = caught(eng)
    plan = FaultPlan(seed=3, dispatch_exception=0.05, nan_logits=0.05,
                     pool_exhaustion=0.05, exhaust_steps=2,
                     alloc_failure=0.05, poison=poison, max_faults=40)
    with counting(ra, "_ragged_span_reference") as plain_calls:
        ra.reset_launches()
        got, wall, audit = chaos(torch, eng, prompts, n_new, Request, plan)
        launches = dict(ra.LAUNCHES)
    st = eng.stats
    d = st["decode_dispatches"]
    counts = dict(plan.counts)
    require(launches[SPAN] == SERVE_LAYERS * d and sum(launches.values())
            == launches[SPAN], f"chaos: launches {launches} for {d} "
            "dispatches")
    require(plain_calls.calls == 0, "chaos: the plain span version ran")
    for rid, r in got.items():
        if rid in poison:
            require(r.status == "failed", f"chaos: poison {rid} ended "
                    f"{r.status}")
        else:
            require(r.status == "finished" and r.output_tokens
                    == clean[rid].output_tokens, f"chaos: innocent {rid} "
                    f"ended {r.status} with a stream other than the "
                    "fault-free run's")
    require(st["requests_failed"] == 2, f"chaos: {st['requests_failed']} "
            "requests failed")
    # every fault the supervisor caught is one the plan injected: its
    # raises (FaultError) and the admissions its held pages pushed back
    # (PagePoolExhausted); plus the dispatches the finite guard flagged
    injected = [e for e in seen.errors if isinstance(e, FaultError)]
    pushed = [e for e in seen.errors if isinstance(e, PagePoolExhausted)]
    other = [repr(e) for e in seen.errors
             if not isinstance(e, (FaultError, PagePoolExhausted))]
    raised = sum(counts.get(k, 0) for k in ("dispatch_exception", "poison",
                                            "alloc_failure"))
    require(not other, f"chaos: the supervisor caught real errors {other}")
    require(len(injected) == raised, f"chaos: {len(injected)} injected "
            f"raises caught, the plan counts {raised}")
    require(not pushed or counts.get("pool_exhaustion", 0),
            "chaos: backpressure without an injected exhaustion")
    require(st["dispatch_errors"] == raised + len(pushed)
            + seen.nan_dispatches, f"chaos: dispatch_errors "
            f"{st['dispatch_errors']} != {raised} raised + {len(pushed)} "
            f"pushed back + {seen.nan_dispatches} non-finite dispatches")
    require(seen.nan_dispatches >= 1 and counts.get("nan_logits", 0) >= 1,
            f"chaos: no NaN page was caught by the guard ({counts})")
    require(audit == [] and eng.host_pool is None, f"chaos: audit {audit}")
    out["chaos"] = {
        "requests": len(prompts), "new_tokens": n_new, "poison": poison,
        "faults": counts, "dispatch_errors": st["dispatch_errors"],
        "dispatch_retries": st["dispatch_retries"],
        "requests_failed": st["requests_failed"],
        "nan_dispatches": seen.nan_dispatches,
        "backpressured_admissions": len(pushed), "launches": launches,
        "fault_free": {"dispatches": d0, "wall_s": wall0,
                       "ms_per_dispatch": wall0 / d0 * 1e3},
        "faulted": {"dispatches": d, "wall_s": wall,
                    "ms_per_dispatch": wall / d * 1e3}}
    del eng
    release_device(torch)

    # preemption: phase gpt2's prompts for the low requests, two of this
    # phase's for the urgent ones; a non-binding chunk budget keeps every
    # request's chunk grid its own (int8 codes depend on it)
    prompts = gpt2_traffic(cfg.vocab_size) + robust_traffic(
        cfg.vocab_size)[:2]
    n_new = 32
    pkw = dict(ekw, prefix_cache=True, prefill_chunk_budget=8 * 64,
               retry_backoff_s=0.0)
    res = {}
    solo = {}
    for kv in (None, "int8"):
        streams = []
        for p in prompts:
            eng = ServingEngine(model, device=DEV, kv_dtype=kv, **pkw)
            r = Request(p, n_new)
            eng.serve([r])
            streams.append(r.output_tokens)
            del eng
        solo[kv] = dict(zip([f"low{i}" for i in range(8)]
                            + ["urgent0", "urgent1"], streams))
    for label, kv, host in (("resume_float32", None, 64),
                            ("restart_float32", None, None),
                            ("restart_int8", "int8", None)):
        pol = SheddingPolicy(queue_low=1, queue_high=2, preempt=True)
        hb = host * page_bytes(model, dict(pkw, kv_dtype=kv)) if host else 8
        ra.reset_launches()
        got, wait, eng, bad = preempt_run(
            torch, model, prompts, n_new, Request, ServingEngine,
            dict(pkw, kv_dtype=kv), policy=pol, host_kv_bytes=hb)
        launches = dict(ra.LAUNCHES)
        st = eng.stats
        key = INT8 if kv else SPAN
        require(launches[key] == SERVE_LAYERS * st["decode_dispatches"]
                and sum(launches.values()) == launches[key],
                f"preempt {label}: launches {launches}")
        require(bad == [], f"preempt {label}: audits {bad[:3]}")
        require(got == solo[kv], f"preempt {label}: streams differ from "
                "the requests served alone")
        require(st["preempts"] >= 1, f"preempt {label}: nothing preempted")
        if host:
            require(st["preempt_resumed"] >= 1, f"preempt {label}: no "
                    "resume")
        else:
            require(st["preempt_restarted"] >= 1, f"preempt {label}: no "
                    "restart")
        res[label] = {"host_kv_bytes": hb, "launches": launches,
                      "dispatches_to_urgent_first_tokens": wait,
                      **{k: st[k] for k in (
                          "preempts", "preempt_resumed",
                          "preempt_restarted", "kv_spill_pages",
                          "kv_pagein_pages", "decode_dispatches")}}
        del eng
    got, wait, eng, _ = preempt_run(torch, model, prompts, n_new, Request,
                                    ServingEngine, pkw)
    require(got == solo[None], "preempt: streams without the policy differ")
    res["no_policy"] = {"dispatches_to_urgent_first_tokens": wait,
                        "decode_dispatches": eng.stats["decode_dispatches"]}
    del eng
    out["preempt"] = res

    # deadlines on the tick clock: one expires queued behind eight
    # running requests, one while it runs
    clk = Tick()
    eng = ServingEngine(model, device=DEV, clock=clk, **pkw)
    for i, p in enumerate(prompts[:8]):
        eng.submit(Request(p, n_new, request_id=f"low{i}"))
    late = Request(prompts[8], n_new, request_id="late", deadline_ms=50.0)
    eng.submit(late)
    eng.step()
    clk.t += 0.2
    eng.step()
    require(late.status == "shed" and late.output_tokens == [],
            f"deadline: the queued request ended {late.status}")
    run = Request(prompts[9], n_new, request_id="run", deadline_ms=100.0)
    eng2 = ServingEngine(model, device=DEV, clock=clk, **pkw)
    eng2.submit(run)
    for _ in range(6):
        eng2.step()
    clk.t += 1.0
    eng2.step()
    require(run.status == "deadline" and 1 <= len(run.output_tokens) < n_new
            and run.output_tokens == solo[None]["urgent1"][
                :len(run.output_tokens)],
            f"deadline: the running request ended {run.status} with "
            f"{len(run.output_tokens)} tokens")
    require(eng2.audit_pages() == [] and not eng2.has_work,
            "deadline: the cancelled slot was not released")
    out["deadlines"] = {"queued": late.status, "running": run.status,
                        "partial_tokens": len(run.output_tokens),
                        "shed": eng.stats["shed"] + eng2.stats["shed"]}
    del eng, eng2
    release_device(torch)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5i: the HTTP frontend and the telemetry plane
# ---------------------------------------------------------------------------

# phase 5i: the client that hangs up after DISCONNECT_AFTER tokens, the
# lagging reader's take() delay (it stands for a blocked socket write)
DISCONNECT_AFTER = 4
LAG_S = 0.3
HTTP_TIMEOUT = 300
# the device bytes /memz may leave unaccounted: the engine's scratch
# between dispatches (one dispatch's float32 logits, 8 x 64 x 50257 x 4
# = 103 MB, and smaller buffers) and the allocator's rounding. A third
# of the smallest ledger row at 774M (1.52 GB of bfloat16 pages), so a
# row left out or counted twice fails the gate.
MEMZ_SLACK = 512 << 20


def http_post(host, port, body, headers=None):
    """POST /v1/generate; (status, headers, body text)."""
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=HTTP_TIMEOUT)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body),
                     dict({"Content-Type": "application/json"},
                          **(headers or {})))
        r = conn.getresponse()
        return r.status, dict(r.getheaders()), r.read().decode()
    finally:
        conn.close()


def http_get(url):
    """GET `url`; (status, body text) (an HTTP error status is read)."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=HTTP_TIMEOUT) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def sse_events(text):
    """[(event, payload)] of a close-delimited SSE body."""
    out = []
    for block in text.split("\n\n"):
        block = block.strip()
        if not block or block.startswith(":"):
            continue
        ev = payload = None
        for line in block.splitlines():
            if line.startswith("event: "):
                ev = line[len("event: "):]
            elif line.startswith("data: "):
                payload = json.loads(line[len("data: "):])
        if ev is not None:
            out.append((ev, payload))
    return out


def sse_tokens(events):
    toks = []
    for ev, p in events:
        if ev == "tokens":
            require(p["index"] == len(toks), "http: a tokens event out of "
                    "order")
            toks.extend(p["tokens"])
    return toks


def hang_up_after(host, port, body, n_tokens):
    """POST over a raw socket and close it once `n_tokens` tokens came
    back; returns the tokens read."""
    import socket
    data = json.dumps(body).encode()
    sock = socket.create_connection((host, port), timeout=HTTP_TIMEOUT)
    try:
        sock.sendall(b"POST /v1/generate HTTP/1.0\r\nContent-Type: "
                     b"application/json\r\nContent-Length: "
                     + str(len(data)).encode() + b"\r\n\r\n" + data)
        buf = b""
        while True:
            chunk = sock.recv(65536)
            require(chunk, "http: the server closed before the hang-up")
            buf += chunk
            text = buf.decode(errors="replace").split("\r\n\r\n", 1)
            if len(text) == 2:
                toks = [t for ev, p in sse_events(text[1].rsplit(
                    "\n\n", 1)[0] + "\n\n") if ev == "tokens"
                    for t in p["tokens"]]
                if len(toks) >= n_tokens:
                    return toks
    finally:
        sock.close()


def run_threads(fns):
    """Run each fn on its own thread; their results in order."""
    import threading
    out, errors = [None] * len(fns), []

    def call(i, fn):
        try:
            out[i] = fn()
        except Exception as e:            # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=call, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT)
    require(not any(t.is_alive() for t in threads), "http: a client hung")
    if errors:
        raise errors[0]
    return out


def telemetry_ab(torch, eng, prompts, n_new, Request, telemetry):
    """ms per dispatch with the request log and the cost accounting on
    and with both off, switched every dispatch (host time drifts by tens
    of percent between serves; neighbouring dispatches share the drift):
    one warmup serve, then four serves of `prompts` stepped by hand, the
    first dispatch of serve k on when k is even. Every request is
    submitted with the log on, so an `on` dispatch records its events.
    Medians and quartiles of each side."""
    from mxnet_tpu_torch.telemetry import cost
    times = {"on": [], "off": []}
    serve(torch, eng, prompts, n_new, Request)
    try:
        for k in range(4):
            telemetry.request_log.enabled = True
            for i, p in enumerate(prompts):
                eng.submit(Request(p, n_new, request_id=f"ab{k}-{i}"))
            j = k
            while eng.has_work:
                mode = "on" if j % 2 == 0 else "off"
                telemetry.request_log.enabled = mode == "on"
                cost.set_enabled(mode == "on")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                times[mode].append((time.perf_counter() - t0) * 1e3)
                j += 1
    finally:
        telemetry.request_log.enabled = True
        cost.set_enabled(True)
    out = {"dispatches": {m: len(v) for m, v in times.items()}}
    for m, v in times.items():
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        out[f"median_{m}_ms"] = float(med)
        out[f"quartiles_{m}_ms"] = [float(q1), float(q3)]
    out["on_over_off"] = out["median_on_ms"] / out["median_off_ms"]
    return out


def http_serve(torch, fe, srv, eng, prompts, n_new, fr, extra, telemetry):
    """Phase 5i's traffic over HTTP: 8 SSE clients at once, a client that
    hangs up after DISCONNECT_AFTER tokens, a lagging reader with a
    1-token stream buffer, and begin_drain() once the first tokens are
    out (a POST then must get 503, /readyz flip, in-flight streams
    finish). Returns what each client saw."""
    host, port = fe.host, fe.port
    orig_take = fr.TokenStream.take

    def laggy_take(self, timeout=None):
        if self.capacity == 1:
            time.sleep(LAG_S)
        return orig_take(self, timeout)

    def client(i, p):
        tp = f"00-{i + 1:032x}-{'b' * 16}-01"
        status, hdrs, text = http_post(
            host, port, {"prompt": p, "max_new_tokens": n_new,
                         "request_id": f"h{i}"}, {"traceparent": tp})
        return status, hdrs.get("traceparent"), sse_events(text), tp

    gone_prompt, lag_prompt = extra
    fr.TokenStream.take = laggy_take
    try:
        probe = fe._probe_name
        ready_before = http_get(f"{srv.url}/readyz?component={probe}")[0]
        fns = [lambda i=i, p=p: client(i, p) for i, p in enumerate(prompts)]
        fns.append(lambda: hang_up_after(
            host, port, {"prompt": gone_prompt, "max_new_tokens": 256,
                         "request_id": "gone"}, DISCONNECT_AFTER))
        fns.append(lambda: http_post(
            host, port, {"prompt": lag_prompt, "max_new_tokens": 64,
                         "stream_buffer": 1, "request_id": "laggard"}))

        ids = {f"h{i}" for i in range(len(prompts))} | {"gone", "laggard"}

        def drain():
            # mid-serve: every client's request is in, first tokens out
            deadline = time.time() + HTTP_TIMEOUT / 2
            while not ids <= {t["request_id"] for t in
                              telemetry.request_log.recent(64)
                              if t["engine"] == eng._eid} \
                    or eng.stats["tokens_emitted"] < len(prompts):
                require(time.time() < deadline, "http: the requests never "
                        "all arrived")
                time.sleep(0.005)
            fe.begin_drain()
            status, hdrs, text = http_post(
                host, port, {"prompt": prompts[0], "max_new_tokens": 4,
                             "request_id": "late"})
            return (status, hdrs.get("Retry-After"),
                    json.loads(text)["error"],
                    http_get(f"{srv.url}/readyz?component={probe}")[0])
        fns.append(drain)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_threads(fns)
        deadline = time.time() + HTTP_TIMEOUT

        def busy():
            # a cancel is counted after its slot is released: wait until
            # every disconnect's cancel has returned on the serving thread
            st = fe.stats
            return (eng.has_work or st["active_streams"]
                    or not fe._cmd_q.empty() or st["cancels_issued"]
                    + st["cancels_noop"] < st["disconnects"])
        while busy() and time.time() < deadline:
            time.sleep(0.005)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fr.TokenStream.take = orig_take
    return res[:len(prompts)], res[-3], res[-2], res[-1], ready_before, wall


def http_checks(torch, label, res, eng, fe, srv, want, n_new, telemetry):
    """Phase 5i's gates on one engine's HTTP run; returns the readings."""
    streams, gone, lag, drain, ready_before, wall = res
    got = {}
    for i, (status, tp_back, evs, tp_sent) in enumerate(streams):
        done = [p for ev, p in evs if ev == "done"]
        require(status == 200 and len(done) == 1
                and done[0]["status"] == "finished",
                f"http {label}: stream h{i} ended {status} {done}")
        require(tp_back is not None
                and tp_back.split("-")[1] == tp_sent.split("-")[1],
                f"http {label}: traceparent {tp_sent} came back as "
                f"{tp_back}")
        got[i] = sse_tokens(evs)
    require([got[i] for i in range(len(want))] == want,
            f"http {label}: SSE streams differ from engine.serve's")
    lag_status, _, lag_text = lag
    lag_evs = sse_events(lag_text)
    lag_err = [p["error"] for ev, p in lag_evs if ev == "error"]
    lag_done = [p for ev, p in lag_evs if ev == "done"]
    require(lag_status == 200 and lag_err == ["overflow"]
            and lag_done[0]["status"] == "cancelled",
            f"http {label}: the lagging reader saw {lag_err} {lag_done}")
    d_status, retry, d_err, ready_after = drain
    require(d_status == 503 and retry is not None
            and d_err["reason"] == "draining"
            and (ready_before, ready_after) == (200, 503),
            f"http {label}: drain gave {d_status} retry {retry} "
            f"{d_err.get('reason')}, readyz {ready_before} -> {ready_after}")
    st = eng.stats
    traces = {t["request_id"]: t for t in json.loads(http_get(
        f"{srv.url}/requests?n=64")[1])["requests"]
        if t["engine"] == eng._eid}
    require(st["requests_finished"] == len(want)
            and st["requests_cancelled"] == 2 and st["shed"] == 0,
            f"http {label}: finished {st['requests_finished']}, cancelled "
            f"{st['requests_cancelled']}, frontend {fe.stats}, gone "
            f"{traces.get('gone', {}).get('events', [])[-3:]}, laggard "
            f"{traces.get('laggard', {}).get('events', [])[-3:]}")
    require(eng.audit_pages() == [] and not eng.has_work,
            f"http {label}: pages not returned: {eng.audit_pages()[:3]}")
    require(traces["gone"]["status"] == "cancelled"
            and traces["laggard"]["status"] == "cancelled"
            and traces["laggard"]["events"][-1].get("reason")
            == "stream_overflow", f"http {label}: terminal events "
            f"{traces['gone']['status']} {traces['laggard']['events'][-1]}")
    phase_over = []
    for rid, t in traces.items():
        first = [e for e in t["events"] if e["event"] == "first_token"]
        if first:
            slack = first[0]["ttft"] - sum(t["phases"].values())
            require(slack >= -1e-9, f"http {label}: request {rid}'s phases "
                    f"exceed its TTFT by {-slack} s")
            phase_over.append(slack)
    metrics = http_get(f"{srv.url}/metrics")[1]
    fin = [ln for ln in metrics.splitlines() if ln.startswith(
        f'serving_requests_finished_total{{engine="{eng._eid}"}}')]
    require(fin and float(fin[0].split()[-1]) == len(want),
            f"http {label}: /metrics says {fin}")
    statusz = json.loads(http_get(f"{srv.url}/statusz")[1])
    comp = statusz["components"][f"engine/{eng._eid}"]
    require(comp["stats"]["requests_finished"] == len(want)
            and comp["config"]["steady_state"] is True,
            f"http {label}: /statusz engine {comp['stats']}")
    trace = json.loads(http_get(f"{srv.url}/trace")[1])
    tracks = {e["tid"] for e in trace["traceEvents"]
              if e.get("name") == "request"
              and e.get("pid") == int(eng._eid) + 1}
    compilez = json.loads(http_get(f"{srv.url}/compilez")[1])
    libs = {k: v["compiles"] for k, v in compilez["programs"].items()
            if k.startswith("kernels/")}
    prog = compilez["programs"][eng._cost_program]
    require(not compilez["unknown_device"], f"http {label}: no peaks for "
            f"{compilez['device_kind']}")
    require(libs and compilez["steady_compiles"] == 0,
            f"http {label}: /compilez kernel libraries {libs}, steady "
            f"builds {compilez['steady_compiles']}")
    require(0.0 < prog["mfu"] <= 1.0, f"http {label}: cost_mfu "
            f"{prog['mfu']}")
    memz = json.loads(http_get(f"{srv.url}/memz")[1])
    listed = sorted(k for k in memz["components"] if k.startswith("engine/"))
    require(listed == [f"engine/{eng._eid}"], f"http {label}: /memz lists "
            f"engines {listed}; only engine/{eng._eid} is alive")
    allocated = torch.cuda.memory_allocated()
    remainder = allocated - memz["accounted_bytes"]
    require(0 <= remainder <= MEMZ_SLACK,
            f"http {label}: /memz accounts {memz['accounted_bytes']} B "
            f"against {allocated} B allocated (remainder {remainder} B, "
            f"bound 0..{MEMZ_SLACK})")
    sloz = json.loads(http_get(f"{srv.url}/sloz")[1])
    return {
        "wall_s": wall, "dispatches": st["decode_dispatches"],
        "ms_per_dispatch": wall / st["decode_dispatches"] * 1e3,
        "requests_finished": st["requests_finished"],
        "requests_cancelled": st["requests_cancelled"],
        "disconnect_tokens": len(gone), "frontend": fe.stats,
        "drain_retry_after": retry, "tracks": len(tracks),
        "phase_slack_min_s": min(phase_over),
        "kernel_libraries": libs, "steady_builds":
            compilez["steady_compiles"],
        "cost_mfu": prog["mfu"], "cost_dispatch_ms":
            prog["dispatch_seconds"] / prog["dispatches"] * 1e3,
        "cost_flops_last": prog["flops"], "cost_bound": prog.get("bound"),
        "device_kind": compilez["device_kind"],
        "peak_flops": compilez["peak_flops"],
        "memz_accounted_bytes": memz["accounted_bytes"],
        "memory_allocated_bytes": allocated,
        "memz_remainder_bytes": remainder,
        "memz_components": {k: v["bytes"] for k, v in memz["components"][
            f"engine/{eng._eid}"].items()},
        "memz_by_provider": {c: sum(v["bytes"] for v in cats.values()
                                    if isinstance(v, dict)
                                    and not v.get("detail"))
                             for c, cats in memz["components"].items()},
        "sloz_objectives": [o["name"] for o in sloz["objectives"]],
        "sloz_fast_burning": sloz["fast_burning"]}


def one_fault_dump(torch, eng, prompts, Request, FaultPlan, telemetry,
                   out_dir):
    """A FaultPlan dispatch exception on `eng`: exactly one flight dump,
    with the reference's file set."""
    rec = telemetry.flight.install(out_dir=out_dir, stall_timeout=120.0)
    try:
        plan = FaultPlan(seed=0, dispatch_exception=1.0, max_faults=1)
        plan.install(eng)
        try:
            serve(torch, eng, prompts[:2], 4, Request)
        finally:
            plan.uninstall()
        dumps = rec.dumps
    finally:
        telemetry.flight.uninstall()
    require(len(dumps) == 1 and os.path.basename(dumps[0]).startswith(
        f"dispatch_error-engine{eng._eid}-"), f"fault: dumps {dumps}")
    files = sorted(os.listdir(dumps[0]))
    require(files == ["events.jsonl", "metrics.json", "state.json"],
            f"fault: dump files {files}")
    return {"dumps": len(dumps), "files": files,
            "dispatch_errors": eng.stats["dispatch_errors"]}


def phase_gpt2_http(torch, ra, card, model, cfg):
    """Phase 5i: the 774M engine behind ServingFrontend, with the
    telemetry plane read over HTTP."""
    import shutil
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.serving import (FaultPlan, Request, ServingEngine,
                                         ServingFrontend)
    from mxnet_tpu_torch.serving import frontend as fr

    prompts = gpt2_traffic(cfg.vocab_size)
    rng = np.random.default_rng(5)
    extra = [rng.integers(0, cfg.vocab_size, 64).tolist() for _ in range(2)]
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    out = {"phase": "gpt2_http", "card": card, "config": SERVE_CONFIG,
           "engine": ekw, "prompt_lens": list(map(len, prompts)),
           "new_tokens": n_new}
    dump_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "flight_dumps")
    shutil.rmtree(dump_root, ignore_errors=True)
    telemetry.slo.configure([telemetry.SLO("ttft_p99_10s",
                                           ttft_p99_ms=10000.0)])
    try:
        for label, dtype, key in (("float32", torch.float32, SPAN),
                                  ("bfloat16", torch.bfloat16, SPAN_TC)):
            model.to(dtype)
            eng = ServingEngine(model, device=DEV, **ekw)
            # the oracle (and the warmup: every kernel library the engine
            # runs is loaded once it has served)
            want, _ = serve(torch, eng, prompts, n_new, Request)
            eng.mark_warm()
            eng.reset_stats()
            fe = ServingFrontend(eng, keepalive_s=0.05, step_idle_s=0.001)
            srv = telemetry.IntrospectionServer(0)
            try:
                with counting(ra, "_ragged_span_reference") as plain_calls:
                    ra.reset_launches()
                    res = http_serve(torch, fe, srv, eng, prompts, n_new, fr,
                                     extra, telemetry)
                    launches = dict(ra.LAUNCHES)
                d = eng.stats["decode_dispatches"]
                require(launches[key] == SERVE_LAYERS * d
                        and sum(launches.values()) == launches[key],
                        f"http {label}: launches {launches} for {d} "
                        "dispatches")
                require(plain_calls.calls == 0, f"http {label}: the plain "
                        f"span version ran {plain_calls.calls} times")
                r = http_checks(torch, label, res, eng, fe, srv, want, n_new,
                                telemetry)
            finally:
                fe.close()
                srv.close()
            r["launches"] = launches
            r["fault"] = one_fault_dump(torch, eng, prompts, Request,
                                        FaultPlan, telemetry,
                                        os.path.join(dump_root, label))
            r["telemetry_cost"] = telemetry_ab(torch, eng, prompts, n_new,
                                               Request, telemetry)
            out[label] = r
            del eng, fe, srv
            release_device(torch)
    finally:
        telemetry.slo.configure([])
    from mxnet_tpu_torch.telemetry import cost
    require(not cost.steady_state(), "http: a warm engine outlived the "
            "phase (later kernel loads would count as steady)")
    out["launches_by_family"] = {
        "float32": out["float32"]["launches"][SPAN],
        "bfloat16": out["bfloat16"]["launches"][SPAN_TC]}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5j: the in-process router over several 774M replicas
# ---------------------------------------------------------------------------

ROUTER_SAMPLED = dict(temperature=0.8, seed0=100)
# phases 5j / 5k's traffic: the first 4 greedy and 4 sampled prompts, one
# engine's 8 slots at once (16 took two waves of dispatches)
ROUTER_TRAFFIC = dict(greedy=4, sampled=4)


def router_requests(Request, greedy, sampled, n_new, tag=""):
    """Phase 5j's traffic: a greedy request g<i> per prompt of `greedy`
    and a sampled one s<i> (temperature 0.8, seed 100 + i) per prompt of
    `sampled`, `n_new` tokens each."""
    return ([Request(p, n_new, request_id=f"{tag}g{i}")
             for i, p in enumerate(greedy)]
            + [Request(p, n_new, request_id=f"{tag}s{i}", do_sample=True,
                       temperature=ROUTER_SAMPLED["temperature"],
                       seed=ROUTER_SAMPLED["seed0"] + i)
               for i, p in enumerate(sampled)])


def memz_engines(srv):
    """The engine providers /memz lists."""
    memz = json.loads(http_get(f"{srv.url}/memz")[1])
    return sorted(k for k in memz["components"] if k.startswith("engine/"))


def require_alone(srv, engines, label):
    """/memz lists exactly `engines`: no engine of an earlier case or
    phase is alive."""
    listed = memz_engines(srv)
    want = sorted(f"engine/{e._eid}" for e in engines)
    require(listed == want, f"router {label}: /memz lists {listed}, alive "
            f"should be {want} only")


def router_drive(torch, router, reqs, kill_after=None, ReplicaFaultPlan=None):
    """Submit `reqs` to `router` and step it until it is idle. With
    `kill_after`, once a request has emitted that many tokens the replica
    that owns it (read from the router's owner map) is killed by a
    ReplicaFaultPlan on the next step. Returns the terminal requests by
    id, the wall seconds, the victim's index (or None) and the plan's
    counts."""
    for r in reqs:
        router.submit(r)
    plan, victim, done, steps = None, None, [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        while router.has_work and steps < 20000:
            if kill_after is not None and plan is None:
                owned = [(idx, r) for idx, r in router._owner.values()
                         if len(r.output_tokens) >= kill_after]
                if owned:
                    victim = owned[0][0]
                    plan = ReplicaFaultPlan(kill={1: victim}).install(router)
            done.extend(router.step())
            steps += 1
    finally:
        if plan is not None:
            plan.uninstall()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    require(steps < 20000, "router: the fleet did not drain")
    return ({r.id: r for r in done}, wall, victim,
            dict(plan.counts) if plan is not None else {})


def router_gates(label, router, engines, done, want, launches, key,
                 plain_calls):
    """Every case's gates: each stream equals the single engine's, every
    request finished, the dtype's span family ran once a layer a dispatch
    summed over the replicas (nothing else), its plain version never,
    the page audits are clean. Returns the case's readings."""
    require(sorted(done) == sorted(want),
            f"router {label}: terminal {sorted(done)} against "
            f"{sorted(want)}")
    bad = [rid for rid, r in done.items()
           if r.status != "finished" or r.output_tokens != want[rid]]
    require(not bad, f"router {label}: streams differ from the single "
            f"engine's for {bad[:4]} (statuses "
            f"{[done[b].status for b in bad[:4]]})")
    per = [e.stats["decode_dispatches"] for e in engines]
    require(launches.get(key, 0) == SERVE_LAYERS * sum(per)
            and sum(launches.values()) == launches.get(key, 0),
            f"router {label}: launches {launches} for {per} dispatches")
    require(plain_calls.calls == 0, f"router {label}: the plain span "
            f"version ran {plain_calls.calls} times")
    audits = [e.audit_pages() for e in engines]
    require(audits == [[]] * len(engines), f"router {label}: audits "
            f"{[a[:2] for a in audits]}")
    return {"dispatches_per_replica": per, "launches": launches,
            "stats": router.stats}


def router_migrations(telemetry, engines):
    """Requests the replicas adopted, and the prompt + emitted tokens
    they re-prefilled, read from the request log."""
    eids = {e._eid for e in engines}
    adopted = [t for t in telemetry.request_log.recent(512)
               if t.get("migrated_from") and t["engine"] in eids]
    return {"adopted": len(adopted),
            "reprefilled_tokens": sum(t["prompt_len"] + t["resumed_tokens"]
                                      for t in adopted)}


def router_http(torch, fe, router, prompts, n_new, ReplicaFaultPlan):
    """An SSE client a prompt, all at once, against a frontend over
    `router`; once a request has 3 tokens, a ReplicaFaultPlan kills the
    replica that owns it. Returns each client's (status, events), the
    victim, the plan's counts and the wall seconds."""
    host, port = fe.host, fe.port
    killed = {}

    def client(i, p):
        status, _, text = http_post(host, port, {
            "prompt": p, "max_new_tokens": n_new, "request_id": f"h{i}"})
        return status, sse_events(text)

    def killer():
        deadline = time.time() + HTTP_TIMEOUT / 2
        while time.time() < deadline:
            owned = [idx for idx, r in list(router._owner.values())
                     if len(r.output_tokens) >= 3]
            if owned:
                killed["victim"] = owned[0]
                killed["plan"] = ReplicaFaultPlan(
                    kill={1: owned[0]}).install(router)
                return
            time.sleep(0.002)
        require(False, "router http: no request reached 3 tokens")

    fns = [lambda i=i, p=p: client(i, p) for i, p in enumerate(prompts)]
    fns.append(killer)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        res = run_threads(fns)
        deadline = time.time() + HTTP_TIMEOUT
        while (router.has_work or fe.stats["active_streams"]) \
                and time.time() < deadline:
            time.sleep(0.005)
    finally:
        if "plan" in killed:
            killed["plan"].uninstall()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res[:len(prompts)], killed.get("victim"),
            dict(killed["plan"].counts) if "plan" in killed else {}, wall)


def phase_gpt2_router(torch, ra, card, model, cfg):
    """Phase 5j: ServingRouter over several replicas of the one 774M model:
    a replica killed mid-decode (float32, bfloat16 and int8 pages), a
    rolling restart, hedging and the frontend over a router, each held to
    one engine's serve of the same traffic."""
    import shutil
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import init_params
    from mxnet_tpu_torch.serving import (ReplicaFaultPlan, Request,
                                         ServingEngine, ServingFrontend,
                                         ServingRouter)
    from mxnet_tpu_torch.telemetry import cost

    t_phase = time.perf_counter()
    greedy = gpt2_traffic(cfg.vocab_size)[:ROUTER_TRAFFIC["greedy"]]
    sampled = robust_traffic(cfg.vocab_size)[:ROUTER_TRAFFIC["sampled"]]
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    out = {"phase": "gpt2_router", "card": card,
           "config": SERVE_CONFIG, "engine": ekw,
           "prompt_lens": {"greedy": list(map(len, greedy)),
                           "sampled": list(map(len, sampled))},
           "new_tokens": n_new, "sampled": ROUTER_SAMPLED}
    dump_root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "flight_dumps", "router")
    shutil.rmtree(dump_root, ignore_errors=True)
    # the seeded float32 weights (phase 5i left the model in bfloat16)
    model.to(torch.float32)
    init_params(model, seed=0, std=0.02)
    srv = telemetry.IntrospectionServer(0)

    def oracle(label, kw, tag=""):
        """One engine's serve of the traffic: the streams every case of
        `label` is held to, and its ms per dispatch."""
        release_device(torch)
        eng = ServingEngine(model, device=DEV, **kw)
        require_alone(srv, [eng], f"{label} oracle")
        reqs = router_requests(Request, greedy, sampled, n_new, tag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        d = eng.stats["decode_dispatches"]
        require(all(r.status == "finished" for r in reqs),
                f"router {label}: the single engine did not finish")
        return ({r.id: list(r.output_tokens) for r in reqs},
                {"dispatches": d, "ms_per_dispatch": wall / d * 1e3,
                 "prefill_tokens": eng.stats["prefill_tokens"]})

    def fleet(label, n, kw, **rkw):
        release_device(torch)
        engines = [ServingEngine(model, device=DEV, **kw) for _ in range(n)]
        require_alone(srv, engines, label)
        return engines, ServingRouter(engines, **rkw)

    def measured(label, run, key, want):
        """Run `run()` with the launch counts reset and the plain span
        version counted; the common gates and readings."""
        with counting(ra, "_ragged_span_reference") as plain_calls:
            ra.reset_launches()
            router, engines, done, wall = run()
            launches = dict(ra.LAUNCHES)
        r = router_gates(label, router, engines, done, want, launches, key,
                         plain_calls)
        r["wall_s"] = wall
        r["ms_per_dispatch"] = wall / sum(r["dispatches_per_replica"]) * 1e3
        r.update(router_migrations(telemetry, engines))
        return r

    try:
        # 1. a replica killed mid-decode, in each page dtype
        for label, dtype, kv, key in (("float32", torch.float32, None, SPAN),
                                      ("int8_pages", torch.float32, "int8",
                                       INT8),
                                      ("bfloat16", torch.bfloat16, None,
                                       SPAN_TC)):
            model.to(dtype)
            kw = dict(ekw, kv_dtype=kv)
            if kv is not None:
                # int8 codes depend on where chunks end: a budget no
                # dispatch reaches keeps each request's chunk grid its own
                kw["prefill_chunk_budget"] = 8 * 64
            want, alone = oracle(label, kw)
            res = {"single_engine": alone}
            case = f"kill {label}"
            rec = telemetry.flight.install(
                out_dir=os.path.join(dump_root, label), stall_timeout=1e9,
                queue_full_threshold=10 ** 6)
            try:
                def run():
                    engines, router = fleet(case, 2, kw,
                                            hedge_min_samples=10 ** 9)
                    done, wall, victim, counts = router_drive(
                        torch, router,
                        router_requests(Request, greedy, sampled, n_new),
                        kill_after=3, ReplicaFaultPlan=ReplicaFaultPlan)
                    res["victim"], res["faults"] = victim, counts
                    return router, engines, done, wall
                r = measured(case, run, key, want)
                latched = [x for x in rec.latched
                           if x.startswith("replica_down:")]
            finally:
                telemetry.flight.uninstall()
            st = r["stats"]
            require(res["faults"] == {"kill": 1}
                    and st["replica_down"] == {"kill": 1}
                    and st["migrated"] >= 1 and r["adopted"] >= 1,
                    f"router {case}: faults {res['faults']}, stats {st}")
            require(len(latched) == 1, f"router {case}: replica_down dumps "
                    f"{latched}")
            res.update(r, dumps=latched,
                       routed_over_single_ms_per_dispatch=(
                           r["ms_per_dispatch"] / alone["ms_per_dispatch"]))
            out[label] = res
        model.to(torch.float32)
        init_params(model, seed=0, std=0.02)
        want, alone = oracle("float32", ekw)
        late = router_requests(Request, greedy[:4], [], n_new, "late")
        late_want = {f"late{k}": v for k, v in want.items()
                     if k in {"g0", "g1", "g2", "g3"}}

        # 2. rolling restart: replica 0 drained with migration mid-serve,
        # warmed, rejoined, and given new work
        rolling = {}

        def run():
            engines, router = fleet("rolling", 2, ekw,
                                    hedge_min_samples=10 ** 9)
            reqs = router_requests(Request, greedy, sampled, n_new)
            for r in reqs:
                router.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = []
            while not any(len(r.output_tokens) >= 3 for r in reqs):
                done.extend(router.step())
            rolling["before_drain"] = engines[0].scheduler.num_active
            router.drain(0, migrate=True)
            require(not engines[0].scheduler.has_work,
                    "router rolling: replica 0 kept work after the drain")
            engines[0].mark_warm()
            router.rejoin(0)
            for r in late:
                router.submit(r)
            rolling["late_owners"] = [router._owner[r.id][0] for r in late]
            while router.has_work:
                done.extend(router.step())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return router, engines, {r.id: r for r in done}, wall
        r = measured("rolling", run, SPAN, dict(want, **late_want))
        require(r["stats"]["migrated"] >= 1 and r["stats"]["drains"] == 1
                and rolling["before_drain"] >= 1
                and 0 in rolling["late_owners"],
                f"router rolling: {rolling}, stats {r['stats']}")
        out["rolling"] = dict(r, **rolling)
        require(not cost.steady_state(), "router rolling: a warm replica "
                "outlived its case")

        # 3. hedging over three replicas: a request still running after
        # about ten dispatches is duplicated to the least-loaded replica
        hedge_s = 10 * alone["ms_per_dispatch"] / 1e3

        def run():
            engines, router = fleet("hedge", 3, ekw, hedge_after_s=hedge_s)
            done, wall, _, _ = router_drive(
                torch, router,
                router_requests(Request, greedy, sampled, n_new))
            return router, engines, done, wall
        r = measured("hedge", run, SPAN, want)
        st = r["stats"]
        require(st["hedges"] >= 1
                and st["hedges"] == st["hedges_won"] + st["hedges_wasted"],
                f"router hedge: {st}")
        out["hedge"] = dict(r, hedge_after_s=hedge_s)

        # 4. the frontend over a two-replica router, a kill mid-stream
        http = {}

        def run():
            engines, router = fleet("http", 2, ekw,
                                    hedge_min_samples=10 ** 9)
            fe = ServingFrontend(router, keepalive_s=0.05,
                                 step_idle_s=0.001)
            try:
                streams, victim, counts, wall = router_http(
                    torch, fe, router, greedy, n_new, ReplicaFaultPlan)
            finally:
                fe.close()
            http.update(victim=victim, faults=counts)
            done = {}
            for i, (status, evs) in enumerate(streams):
                fin = [p for ev, p in evs if ev == "done"]
                require(status == 200 and len(fin) == 1,
                        f"router http: stream h{i} ended {status} {fin}")
                done[f"g{i}"] = SimpleNamespace(status=fin[0]["status"],
                                                output_tokens=sse_tokens(evs))
            return router, engines, done, wall
        r = measured("http", run, SPAN,
                     {k: v for k, v in want.items() if k.startswith("g")})
        require(http["faults"] == {"kill": 1}
                and r["stats"]["replica_down"] == {"kill": 1}
                and r["stats"]["migrated"] >= 1,
                f"router http: {http}, stats {r['stats']}")
        out["http"] = dict(r, **http)
        release_device(torch)
        require(memz_engines(srv) == [], "router: an engine outlived the "
                f"phase: {memz_engines(srv)}")
    finally:
        srv.close()
        model.to(torch.float32)
    require(not cost.steady_state(), "router: a warm engine outlived the "
            "phase")
    out["single_engine_float32"] = alone
    out["launches_by_family"] = {
        "float32": sum(out[c]["launches"][SPAN]
                       for c in ("float32", "rolling", "hedge", "http")),
        "bfloat16": out["bfloat16"]["launches"][SPAN_TC],
        "int8": out["int8_pages"]["launches"][INT8]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 5k: the cross-process fleet over 774M workers
# ---------------------------------------------------------------------------

FLEET_READY_S = 300      # a 774M worker's start to READY, at most
FLEET_KILL_AFTER = 3     # tokens a request has when its worker is killed


def fleet_spec(cfg, ekw):
    """The worker spec of phase 5k: the model's whole config, the seeded
    weights every phase shares (seed 0, std 0.02), the engine kwargs and
    the phase's device."""
    import inspect
    from mxnet_tpu_torch.models import GPT2Config
    names = inspect.signature(GPT2Config).parameters
    return {"config": {n: getattr(cfg, n) for n in names}, "seed": 0,
            "init_std": 0.02, "engine": dict(ekw), "device": DEV}


def blob_bytes(blob):
    """Exact `wire.dumps(blob)` length without building the string: the
    base64 page data is ASCII, so it adds its length to the JSON of the
    blob with every data field emptied."""
    from mxnet_tpu_torch.serving.fleet import wire
    kvp = blob.get("kv_payload")
    if kvp is None:
        return len(wire.dumps(blob)), 0
    data, pages = 0, []
    for page in kvp["pages"]:
        out = {}
        for name, leaf in page.items():
            nd = leaf["__nd__"]
            data += len(nd["data"])
            out[name] = {"__nd__": dict(nd, data="")}
        pages.append(out)
    rest = dict(blob, kv_payload=dict(kvp, pages=pages))
    return len(wire.dumps(rest)) + data, data


def record_blobs(router, sizes):
    """Wrap the prefill RPC of the router's prefill-capable workers so
    that each handoff blob's exact wire bytes (and payload bytes) land in
    `sizes`."""
    for rep in router.workers:
        if rep.role in ("prefill", "mixed"):
            rpc = rep.client.prefill

            def prefill(*a, _rpc=rpc, **kw):
                blob = _rpc(*a, **kw)
                sizes.append(blob_bytes(blob))
                return blob
            rep.client.prefill = prefill


def fleet_drive(torch, router, reqs, procs=None):
    """Submit `reqs` to a FleetRouter and wait for every one (each wait
    bounded). With `procs`, once a request has FLEET_KILL_AFTER tokens
    the worker process streaming it is SIGKILLed. Returns the requests by
    id, the wall seconds and the victim's index (or None)."""
    from mxnet_tpu_torch.serving import TokenStream
    for r in reqs:
        r.stream = TokenStream(capacity=64)
        router.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    victim = None
    if procs is not None:
        deadline = time.monotonic() + HTTP_TIMEOUT / 2
        while victim is None and time.monotonic() < deadline:
            for tr in list(router._live.values()):
                if tr.rep is not None \
                        and len(tr.req.output_tokens) >= FLEET_KILL_AFTER:
                    victim = tr.rep.index
                    break
            else:
                time.sleep(0.002)
        require(victim is not None, "fleet: no request reached "
                f"{FLEET_KILL_AFTER} tokens")
        procs.workers[victim].kill()
    for r in reqs:
        router.result(r, timeout=HTTP_TIMEOUT)
    torch.cuda.synchronize()
    return {r.id: r for r in reqs}, time.perf_counter() - t0, victim


def fleet_streams(label, done, want):
    require(sorted(done) == sorted(want), f"fleet {label}: requests "
            f"{sorted(done)} against {sorted(want)}")
    bad = [rid for rid, r in done.items()
           if r.status != "finished" or list(r.output_tokens) != want[rid]]
    require(not bad, f"fleet {label}: streams differ from the single "
            f"engine's for {bad[:4]} (statuses "
            f"{[done[b].status for b in bad[:4]]})")


def fleet_events(telemetry, eid, name, prefix):
    """How many of engine `eid`'s timelines of requests whose id starts
    with `prefix` hold event `name` (the warmup's are left out)."""
    return sum(any(e.get("event") == name for e in t.get("events") or ())
               for t in telemetry.request_log.recent(512)
               if str(t["engine"]) == str(eid)
               and str(t["request_id"]).startswith(prefix))


def wire_hops(router):
    """The router's export -> adoption-ack seconds (the wire alone; the
    engine's handoff phase also holds the wait for a decode slot): count,
    mean, median (to a histogram bucket) and max, in ms."""
    h = router._m["handoff_s"]
    if not h.count:
        return {"n": 0}
    return {"n": h.count, "mean_ms": h.sum / h.count * 1e3,
            "median_ms_bucket": h.percentile(50) * 1e3,
            "max_ms": h._max * 1e3}


def ms_stats(xs):
    xs = sorted(xs)
    return {"median_ms": float(np.median(xs)) * 1e3 if xs else None,
            "max_ms": xs[-1] * 1e3 if xs else None, "n": len(xs)}


def spawn_workers(jobs):
    """Start one worker process per (spec, role, kw) of `jobs`, all at
    once, each bounded by FLEET_READY_S; returns [(WorkerProc, seconds
    to READY)]. On any failure every worker that came up is killed and
    the first error raised."""
    import threading
    from mxnet_tpu_torch.serving.fleet import spawn_worker
    out, errors = [None] * len(jobs), []

    def start(i, spec, role, kw):
        t0 = time.perf_counter()
        try:
            w = spawn_worker(spec, role=role, ready_timeout_s=FLEET_READY_S,
                             **kw)
            out[i] = (w, time.perf_counter() - t0)
        except Exception as e:            # noqa: BLE001 — re-raised below
            errors.append(e)
    threads = [threading.Thread(target=start, args=(i,) + job, daemon=True)
               for i, job in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_READY_S + 60)
    if errors or any(t.is_alive() for t in threads) or None in out:
        for got in out:
            if got is not None:
                got[0].kill()
        if errors:
            raise errors[0]
        require(False, "fleet: a worker neither came up nor failed")
    return out


def phase_gpt2_fleet(torch, ra, card, model, cfg):
    """Phase 5k: the cross-process fleet of the same 774M model. Workers
    in this process over loopback HTTP (where the launch counters can be
    read): a mixed fleet of two, a disaggregated prefill + decode pair in
    float32, bfloat16 and int8 pages shipping the KV payload, the float32
    pair again without it; then worker processes on the card: two mixed
    float32 workers and two on int8 pages, one SIGKILLed mid-decode, and
    a prefill + decode pair with a FleetCollector on this process's
    introspection server. Every stream is held to one engine's serve."""
    from mxnet_tpu_torch import telemetry
    from mxnet_tpu_torch.models import init_params
    from mxnet_tpu_torch.serving import Request, ServingEngine
    from mxnet_tpu_torch.serving.fleet import (FleetProcs, FleetRouter,
                                               FleetWorker, WorkerClient)
    from mxnet_tpu_torch.serving.fleet.observe import parse_prometheus
    from mxnet_tpu_torch.telemetry import cost

    t_phase = time.perf_counter()
    greedy = gpt2_traffic(cfg.vocab_size)[:ROUTER_TRAFFIC["greedy"]]
    sampled = robust_traffic(cfg.vocab_size)[:ROUTER_TRAFFIC["sampled"]]
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    # int8 codes depend on where chunks end: a budget no dispatch reaches
    # keeps every request on its natural chunk grid (the grid a failover
    # replays on)
    ekw8 = dict(ekw, kv_dtype="int8", prefill_chunk_budget=8 * 64)
    out = {"phase": "gpt2_fleet", "card": card,
           "config": SERVE_CONFIG, "engine": ekw,
           "prompt_lens": {"greedy": list(map(len, greedy)),
                           "sampled": list(map(len, sampled))},
           "new_tokens": n_new, "sampled": ROUTER_SAMPLED}
    model.to(torch.float32)
    init_params(model, seed=0, std=0.02)

    def traffic(tag=""):
        return router_requests(Request, greedy, sampled, n_new, tag)

    def oracle(label, kw, tag):
        release_device(torch)
        eng = ServingEngine(model, device=DEV, **kw)
        reqs = traffic(tag)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        require(all(r.status == "finished" for r in reqs),
                f"fleet {label}: the single engine did not finish")
        d = eng.stats["decode_dispatches"]
        return ({r.id: list(r.output_tokens) for r in reqs},
                {"dispatches": d, "ms_per_dispatch": wall / d * 1e3})

    def warmed(kw):
        """Two engines declared warm. Every kernel library is loaded in
        this process by now, so warmup traffic (warm_engine, which each
        worker process runs) would load nothing here; after mark_warm()
        a load would count as a steady compile."""
        release_device(torch)
        engines = [ServingEngine(model, device=DEV, **kw) for _ in range(2)]
        for eng in engines:
            eng.mark_warm()
        return engines

    def in_process(label, roles, engines, key, want, alone, ship=True):
        """One in-process case on `engines` (their counters reset first);
        its gates and readings."""
        for eng in engines:
            eng.reset_stats()
        ws = [FleetWorker(eng, role=role, worker_id=f"{role}{i}",
                          ship_payload=ship)
              for i, (role, eng) in enumerate(zip(roles, engines))]
        router = None
        sizes = []
        try:
            router = FleetRouter([w.url for w in ws])
            record_blobs(router, sizes)
            with counting(ra, "_ragged_span_reference") as plain_calls:
                ra.reset_launches()
                done, wall, _ = fleet_drive(torch, router, traffic(label))
                launches = dict(ra.LAUNCHES)
            fleet_streams(label, {k[len(label):]: v
                                  for k, v in done.items()}, want)
            per = [w.engine.stats["decode_dispatches"] for w in ws]
            require(launches.get(key, 0) == SERVE_LAYERS * sum(per)
                    and sum(launches.values()) == launches.get(key, 0),
                    f"fleet {label}: launches {launches} for {per} "
                    "dispatches")
            require(plain_calls.calls == 0, f"fleet {label}: the plain "
                    f"span version ran {plain_calls.calls} times")
            st = [w.fleet_stats() for w in ws]
            steady = [s["stats"]["steady_state_compiles"] for s in st]
            require(steady == [0] * len(ws), f"fleet {label}: steady "
                    f"compiles {steady}")
            audits = [w.engine.audit_pages() for w in ws]
            require(audits == [[]] * len(ws), f"fleet {label}: audits "
                    f"{[a[:2] for a in audits]}")
            r = {"roles": list(roles), "wall_s": wall,
                 "dispatches_per_worker": per, "launches": launches,
                 "ms_per_dispatch": wall / sum(per) * 1e3,
                 "routed_over_single_ms_per_dispatch":
                     wall / sum(per) * 1e3 / alone["ms_per_dispatch"]}
            if router.disaggregated:
                pre, dec = st[0], st[1]
                n = len(done)
                fallback = fleet_events(telemetry, ws[1].engine._eid,
                                        "handoff_fallback", label)
                landed = fleet_events(telemetry, ws[1].engine._eid,
                                      "adopted_payload", label)
                hops = [d.phases.get("handoff") for d in done.values()]
                require(pre["handoffs"] == n and pre["handoffs_final"] == 0,
                        f"fleet {label}: handoffs {pre['handoffs']} of {n}")
                if ship:
                    require(fallback == 0 and landed == n
                            and None not in hops, f"fleet {label}: "
                            f"{landed} payloads landed, {fallback} fell "
                            f"back, hops {hops}")
                    require(dec["stats"]["prefill_tokens"] == 0,
                            f"fleet {label}: the decode worker "
                            "re-prefilled")
                else:
                    require(landed == 0 and hops == [None] * n,
                            f"fleet {label}: a payload landed with "
                            "ship_payload off")
                r.update(handoffs=pre["handoffs"], payloads_landed=landed,
                         handoff_fallbacks=fallback,
                         decode_prefill_tokens=dec["stats"]
                         ["prefill_tokens"],
                         handoff=ms_stats([h for h in hops
                                           if h is not None]),
                         wire_hop=wire_hops(router),
                         blob_bytes=[b for b, _ in sizes],
                         payload_b64_bytes=[p for _, p in sizes],
                         blob_bytes_per_request=(
                             float(np.mean([b for b, _ in sizes]))
                             if sizes else None))
            return r
        finally:
            if router is not None:
                router.close()
            for w in ws:
                w.close()

    procs_all = []
    srv = None
    try:
        # A. workers in this process, over loopback HTTP: one warmed pair
        # of engines a page dtype, behind the case's FleetWorkers
        pair = ("prefill", "decode")
        want, alone = oracle("float32", ekw, "")
        out["single_engine_float32"] = alone
        engines = warmed(ekw)
        out["mixed"] = in_process("mixed", ("mixed", "mixed"), engines,
                                  SPAN, want, alone)
        out["disagg_float32"] = in_process("disagg_float32", pair, engines,
                                           SPAN, want, alone)
        out["disagg_no_payload"] = in_process(
            "disagg_no_payload", pair, engines, SPAN, want, alone,
            ship=False)
        engines = None
        want8, alone8 = oracle("int8", ekw8, "")
        out["single_engine_int8"] = alone8
        engines = warmed(ekw8)
        out["disagg_int8"] = in_process("disagg_int8", pair, engines, INT8,
                                        want8, alone8)
        engines = None
        model.to(torch.bfloat16)
        want16, alone16 = oracle("bfloat16", ekw, "")
        out["single_engine_bfloat16"] = alone16
        engines = warmed(ekw)
        out["disagg_bfloat16"] = in_process("disagg_bfloat16", pair,
                                            engines, SPAN_TC, want16, alone16)
        del engines
        model.to(torch.float32)
        init_params(model, seed=0, std=0.02)
        release_device(torch)
        require(not cost.steady_state(), "fleet: a warm in-process worker "
                "outlived its case")

        # B. worker processes on the card, all started at once (the
        # kernel libraries were built before any spawn: they only load)
        spec, spec8 = fleet_spec(cfg, ekw), fleet_spec(cfg, ekw8)
        started = spawn_workers(
            [(spec, "mixed", {}), (spec, "mixed", {}),
             (spec8, "mixed", {}), (spec8, "mixed", {}),
             (spec, "prefill", {}), (spec, "decode", {})])
        procs_all = [w for w, _ in started]
        out["ready_s"] = [s for _, s in started]
        pids = [w.pid for w in procs_all]
        require(len(set(pids)) == 6 and os.getpid() not in pids,
                f"fleet: worker pids {pids}")
        for w in procs_all:
            info = WorkerClient(w.url).stats()
            require(info["engine"]["device"].split(":")[0] == DEV
                    and info["pid"] == w.pid
                    and info["stats"]["steady_state_compiles"] == 0,
                    f"fleet: worker {w.pid} reports {info['engine']}, "
                    f"steady {info['stats']['steady_state_compiles']}")
        for label, pair, key_want in (
                ("kill_float32", FleetProcs(procs_all[0:2]), want),
                ("kill_int8", FleetProcs(procs_all[2:4]), want8)):
            router = FleetRouter(pair.urls)
            try:
                done, wall, victim = fleet_drive(
                    torch, router, traffic(label), procs=pair)
                survivor = pair.workers[1 - victim]
                view = {w["index"]: w
                        for w in router.fleet_stats()["workers"]}
                moved = [t for t in WorkerClient(survivor.url).requests(512)
                         if t.get("migrated_from") == "wire"]
            finally:
                router.close()
            fleet_streams(label, {k[len(label):]: v
                                  for k, v in done.items()}, key_want)
            require(view[victim]["state"] == "down"
                    and view[1 - victim]["state"] == "up"
                    and not pair.workers[victim].alive
                    and pair.workers[1 - victim].alive and moved,
                    f"fleet {label}: victim {victim}, states "
                    f"{[v['state'] for v in view.values()]}, "
                    f"{len(moved)} adopted")
            out[label] = {
                "victim_pid": pair.workers[victim].pid, "wall_s": wall,
                "migrated": len(moved),
                "reprefilled_tokens": sum(t["prompt_len"]
                                          + t["resumed_tokens"]
                                          for t in moved),
                "survivor_stats": {k: view[1 - victim]["stats"]["stats"][k]
                                   for k in ("decode_dispatches",
                                             "prefill_tokens",
                                             "steady_state_compiles")}}
            pair.close()

        # the disaggregated pair of processes, observed by a collector
        pair = FleetProcs(procs_all[4:6])
        srv = telemetry.IntrospectionServer(0)
        router = FleetRouter(pair.urls)
        sizes = []
        try:
            record_blobs(router, sizes)
            coll = router.observe(interval_s=0.5)
            done, wall, _ = fleet_drive(torch, router, traffic("procs"))
            fleet_streams("disagg processes",
                          {k[len("procs"):]: v for k, v in done.items()},
                          want)
            merged = coll.scrape()
            code, body = http_get(f"{srv.url}/fleetz")
            fz = json.loads(body)
            own = [sum(v for _l, v in parse_prometheus(
                WorkerClient(u).metrics_text())
                ["serving_tokens_emitted_total"]["samples"])
                for u in pair.urls]
            got = sum(ch.value for _v, ch in merged.get(
                "serving_tokens_emitted_total")._samples())
            emitted = sum(len(r.output_tokens) for r in done.values())
            trace = coll.fleet_chrome_trace()
            by_trace = {}
            for e in trace["traceEvents"]:
                if e.get("ph") == "X" and e.get("cat") == "request":
                    by_trace.setdefault(e["args"].get("trace_id"),
                                        set()).add(e["pid"])
            spans = [by_trace.get(r.trace["trace_id"], set())
                     for r in done.values()]
            hops = [r.phases.get("handoff") for r in done.values()]
            stats = [WorkerClient(u).stats() for u in pair.urls]
        finally:
            router.close()
        wpids = sorted(w.pid for w in pair.workers)
        require(code == 200 and sorted(row["pid"] for row in fz["workers"])
                == wpids and all(row["state"] == "ok"
                                 for row in fz["workers"]),
                f"fleet: /fleetz {code} {fz.get('workers')}")
        require(got == sum(own) == emitted, f"fleet: merged tokens {got}, "
                f"the workers' own {own}, streams {emitted}")
        require(all(s == set(wpids) for s in spans), "fleet: a request "
                f"is not one trace across both workers: {spans[:4]}")
        require(None not in hops and stats[0]["handoffs"] == len(done)
                and [s["stats"]["steady_state_compiles"] for s in stats]
                == [0, 0], f"fleet: hops {hops}, stats "
                f"{[s['handoffs'] for s in stats]}")
        out["disagg_processes"] = {
            "wall_s": wall, "handoff": ms_stats(hops),
            "wire_hop": wire_hops(router),
            "blob_bytes_per_request": float(np.mean([b for b, _ in sizes])),
            "blob_bytes": [b for b, _ in sizes],
            "fleetz_pids": wpids, "merged_tokens": got,
            "tokens_per_worker": own,
            "collector_cycles": fz["cycles"],
            "dispatches_per_worker": [s["stats"]["decode_dispatches"]
                                      for s in stats]}
        pair.close()
    finally:
        for w in procs_all:
            w.kill()
        if srv is not None:
            srv.close()
        model.to(torch.float32)
        release_device(torch)
    require(not any(w.alive for w in procs_all), "fleet: a worker "
            "process outlived the phase")
    require(not cost.steady_state(), "fleet: a warm engine outlived the "
            "phase")
    out["launches_by_family"] = {
        "float32": sum(out[c]["launches"][SPAN]
                       for c in ("mixed", "disagg_float32",
                                 "disagg_no_payload")),
        "bfloat16": out["disagg_bfloat16"]["launches"][SPAN_TC],
        "int8": out["disagg_int8"]["launches"][INT8]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    for label in ("disagg_float32", "disagg_bfloat16", "disagg_int8"):
        print(json.dumps({"fleet": label, "card": card,
                          "handoff": out[label]["handoff"],
                          "wire_hop": out[label]["wire_hop"],
                          "blob_bytes_per_request":
                              out[label]["blob_bytes_per_request"]}),
              flush=True)
    print(json.dumps({"fleet": "summary", "card": card,
                      "handoff_processes": out["disagg_processes"]["handoff"],
                      "wire_hop_processes":
                          out["disagg_processes"]["wire_hop"],
                      "ms_per_dispatch_routed_over_single": {
                          c: out[c]["routed_over_single_ms_per_dispatch"]
                          for c in ("mixed", "disagg_float32",
                                    "disagg_no_payload", "disagg_int8",
                                    "disagg_bfloat16")},
                      "ready_s": out["ready_s"],
                      "seconds": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 5l: tensor-parallel serving on one card
# ---------------------------------------------------------------------------

TP_SIZES = (2, 4)
# profiled window of the tp=2 float32 serve: (dispatches skipped, traced)
TP_TRACE = (10, 10)


def tp_logits(torch, eng, tokens, impl="auto"):
    """The next-token logits after `tokens` (one slot, the whole prefix
    as one span) through a tp engine's shard modules in lockstep, in
    float32: through the kernels (impl "auto") or the plain versions."""
    from mxnet_tpu_torch.models.gpt2 import tp_forward
    ids = torch.tensor([tokens], device=DEV)
    return tp_forward(eng._shards, eng._tp_group, ids,
                      tp_caches(torch, eng, 1, impl=impl))[0, -1].float()


def column_slice_bits(torch):
    """A reading, not a gate: whether a bias-free float32 product over a
    column slice of a 774M projection's weight gives the bits of that
    slice of the whole product (M rows of 1280 units, tp-way slices)."""
    import torch.nn.functional as F
    g = torch.Generator(device=DEV).manual_seed(0)
    out = {}
    for M in (8, 64, 512):
        x = torch.randn(M, 1280, device=DEV, generator=g)
        w = torch.randn(1280, 1280, device=DEV, generator=g) * 0.02
        full = F.linear(x, w)
        for tp in TP_SIZES:
            n = 1280 // tp
            out[f"M{M}_tp{tp}"] = bool(torch.equal(
                full[:, :n], F.linear(x, w[:n].contiguous())))
    return out


def tp_serve(torch, ra, eng, prompts, n_new, Request, key, label):
    """Serve through a tp engine with the span family `key` counted: it
    must launch SERVE_LAYERS x dispatches x tp times and nothing else,
    its plain version never. Returns (streams, serve_stats, launches)."""
    with counting(ra, "_ragged_span_reference") as plain:
        ra.reset_launches()
        got, wall = serve(torch, eng, prompts, n_new, Request)
        launches = dict(ra.LAUNCHES)
    st = serve_stats(eng, wall, got)
    want = SERVE_LAYERS * st["dispatches"] * eng._tp
    require(launches[key] == want and sum(launches.values()) == want,
            f"{label}: launches {launches}, want {key} {want}")
    require(plain.calls == 0, f"{label}: the plain span version ran "
            f"{plain.calls} times on the kernel path")
    require(all(len(t) == n_new for t in got), f"{label}: short streams")
    require(eng.audit_pages() == [], f"{label}: page audit")
    return got, st, launches


def tp_caches(torch, eng, B, kv_dtype=None, impl="torch"):
    """One fresh ragged cache per shard of a tp engine: B slots at length
    0, 1024 positions, page 64, the shard's H / tp heads."""
    from mxnet_tpu_torch.models import PagedKVCache
    cfg, tp = eng.model.config, eng._tp
    return [PagedKVCache.create(
        cfg.num_layers, B, cfg.num_heads // tp, 1024,
        cfg.units // cfg.num_heads, dtype=eng.model.dtype, page_size=64,
        lengths=np.zeros(B), attn_impl=impl, kv_dtype=kv_dtype, device=dev)
        for dev in eng._tp_group.devices]


def int8_pair_logits(torch, model, eng, prompt, emitted, history):
    """The plain int8 path's next-token logits after `prompt + emitted`
    at tp=1 (the model) and at the tp engine's shard count (its shards in
    lockstep), each on one slot replaying the engine's write schedule
    (int8_logits' feeds). Returns (tp=1, tp) float32 logits."""
    from mxnet_tpu_torch.models.gpt2 import tp_forward
    c1 = model.make_cache(1, 1024, paged=True, page_size=64, lengths=[0],
                          attn_impl="torch", kv_dtype="int8")
    cs = tp_caches(torch, eng, 1, kv_dtype="int8")
    cuts = np.cumsum([0] + list(history))
    feeds = [prompt[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    feeds += [[t] for t in emitted]
    with torch.no_grad():
        for toks in feeds:
            ids = torch.tensor([toks], device=DEV)
            l1, c1 = model(ids, c1)
            l2 = tp_forward(eng._shards, eng._tp_group, ids, cs)
            cs = [c.advance(len(toks)) for c in cs]
    return l1[0, -1].float(), l2[0, -1].float()


def int8_layer0_check(torch, model, eng, prompts):
    """Layer 0's int8 codes and scales after one prefill chunk of every
    prompt (its first 64 tokens, one slot each, fresh pools) written at
    tp=1 and at the tp engine's shard count, in the global head layout:
    they must be the same bytes (layer 0 reads the replicated embeddings
    through column slices of query/key/value; the quantizer is
    head-local). A serve's pools cannot be compared so: a stream that
    leaves tp=1's writes other tokens."""
    from mxnet_tpu_torch.models.gpt2 import tp_forward
    B, W = len(prompts), 64
    ids = torch.zeros((B, W), dtype=torch.long, device=DEV)
    spans = torch.tensor([min(len(p), W) for p in prompts],
                         dtype=torch.int32, device=DEV)
    for i, p in enumerate(prompts):
        ids[i, :len(p[:W])] = torch.tensor(p[:W], device=DEV)
    c1 = model.make_cache(B, 1024, paged=True, page_size=64,
                          lengths=np.zeros(B), attn_impl="torch",
                          kv_dtype="int8")
    cs = tp_caches(torch, eng, B, kv_dtype="int8")
    for c in [c1] + cs:
        c.spans = spans
    with torch.no_grad():
        model(ids, c1)
        tp_forward(eng._shards, eng._tp_group, ids, cs)
    N = c1.num_pages
    out = {}
    for name, axis in (("k_pages", 2), ("v_pages", 2), ("k_scale", 1),
                       ("v_scale", 1)):
        a = getattr(c1, name)[0, :N].cpu()
        b = torch.cat([getattr(c, name)[0, :N] for c in cs], axis).cpu()
        diff = (a.float() - b.float()).abs()
        out[name] = {"bytes_equal": bool(torch.equal(a, b)),
                     "elements_differing": int((diff > 0).sum()),
                     "elements": a.numel(),
                     "max_abs_diff": diff.max().item()}
        require(out[name]["bytes_equal"], f"int8 tp layer-0 {name} "
                f"differs from tp=1's: {out[name]}")
    return out


def phase_gpt2_tp(torch, ra, card, gpt2):
    """Phase 5l: tensor-parallel serving of the 774M model on the one
    card, tp=2 and tp=4 over [DEV] * tp."""
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.models import PagedKVCache
    from mxnet_tpu_torch.models.gpt2 import tp_forward
    from mxnet_tpu_torch.serving import Request, ServingEngine

    t_phase = time.perf_counter()
    model, cfg = gpt2_774m(torch)
    prompts = gpt2_traffic(cfg.vocab_size)
    require(list(map(len, prompts)) == gpt2["prompt_lens"],
            "phase gpt2 and gpt2_tp traffic differ")
    n_new = 32
    ekw = dict(num_slots=8, max_length=1024, page_size=64, chunk_tokens=64)
    out = {"phase": "gpt2_tp", "card": card, "config": SERVE_CONFIG,
           "engine": ekw, "tp_devices": f"[{DEV!r}] * tp",
           "prompt_lens": gpt2["prompt_lens"], "new_tokens": n_new}

    def tp_engine(m, tp, **kw):
        return ServingEngine(m, device=DEV, tp=tp, tp_devices=[DEV] * tp,
                             **ekw, **kw)

    out["column_slice_bits_equal"] = column_slice_bits(torch)
    # the default device list takes the first tp cards: one is too few
    require(torch.cuda.device_count() == 1, "gpt2_tp expects one card")
    try:
        ServingEngine(model, device=DEV, tp=2, **ekw)
        raise AssertionError("ServingEngine(tp=2) built on one card")
    except MXNetError as e:
        require("needs 2 devices, have 1" in str(e), f"tp=2 error: {e}")
        out["default_devices_error"] = str(e)

    # float32: tp=1 with its own top-2 gaps, then timed
    eng = ServingEngine(model, device=DEV, **ekw)
    want, gaps, _ = serve_gaps(torch, eng, prompts, n_new, Request)
    eng.reset_stats()
    again, wall = serve(torch, eng, prompts, n_new, Request)
    require(again == want, "tp=1 float32 serves differ")
    f32 = {"tp1": serve_stats(eng, wall, want)}
    del eng
    release_device(torch)
    launches_f32 = 0
    for tp in TP_SIZES:
        eng = tp_engine(model, tp)
        got, st, launches = tp_serve(torch, ra, eng, prompts, n_new,
                                     Request, SPAN, f"float32 tp={tp}")
        launches_f32 += launches[SPAN]
        z = eng._statusz()["sharding"]
        st.update(launches=launches,
                  divergences=held_to(got, want, gaps, f"float32 tp={tp}"),
                  streams_equal_tp1=got == want,
                  weight_bytes_per_chip=eng.stats["weight_bytes_per_chip"],
                  weight_bytes_total=eng.stats["weight_bytes_total"],
                  kv_page_bytes=eng.stats["kv_page_bytes"],
                  kv_page_bytes_per_chip=z["kv_page_bytes_per_chip"],
                  heads_per_shard=z["heads_per_shard"],
                  ms_over_tp1=st["ms_per_dispatch"]
                  / f32["tp1"]["ms_per_dispatch"])
        require(z["kv_page_bytes_per_chip"] * tp == st["kv_page_bytes"],
                f"tp={tp}: per-chip page bytes {z}")
        if tp == 2:
            # the decode kernel at H / tp heads: one single-token lockstep
            # forward on the served cache (slot i holds request i's
            # prompt + 31 tokens), kernels against plain versions
            lengths = torch.tensor([len(p) + n_new - 1 for p in prompts],
                                   dtype=torch.int32, device=DEV)
            last = torch.tensor([[s[-1]] for s in got], device=DEV)
            logits = {}
            ra.reset_launches()
            for impl in ("auto", "torch"):
                caches = [PagedKVCache(kp, vp, eng._dstate["table"],
                                       lengths, attn_impl=impl)
                          for kp, vp, _, _ in eng._pools]
                logits[impl] = tp_forward(eng._shards, eng._tp_group, last,
                                          caches).float()
            dec = ra.LAUNCHES["ragged_decode_attention"]
            require(dec == SERVE_LAYERS * tp and sum(ra.LAUNCHES.values())
                    == dec, f"tp decode launches {dict(ra.LAUNCHES)}")
            dlog = (logits["auto"] - logits["torch"]).abs().max().item()
            require(dlog <= 1e-4, f"tp decode forward logits differ by "
                    f"{dlog}")
            st["decode_launches"] = dec
            st["decode_forward_logits_max_abs_diff"] = dlog
            st["trace"] = trace_window(torch, eng, prompts, n_new, Request,
                                       skip=TP_TRACE[0], steps=TP_TRACE[1])
            # one float32 handoff from this tp=2 engine into a tp=1
            # engine: the payload's global head layout lands there
            r = Request(prompts[0], n_new, request_id="handoff")
            eng.submit(r)
            while not r.output_tokens:
                eng.step()
            exp = eng.export_handoff(r.id)
            require(exp is not None, "tp=2 export_handoff gave nothing")
            pages = len(exp.kv_payload["pages"])
            dst = ServingEngine(model, device=DEV, **ekw)
            dst.adopt(exp, migrated_from="tp2")
            while dst.has_work:
                dst.step()
            require(exp.status == "finished" and dst.stats[
                "prefill_tokens"] == 0, "the tp=2 payload did not land")
            f32["handoff_tp2_to_tp1"] = {
                "pages": pages,
                "divergences": held_to([exp.output_tokens], [want[0]],
                                       [gaps[0]], "tp=2 -> tp=1 handoff"),
                "tokens_equal_tp1": exp.output_tokens == want[0]}
            del dst, caches, logits
        f32[f"tp{tp}"] = st
        del eng
        release_device(torch)
    out["float32"] = f32

    # int8 pages at tp=2 against tp=1. The reductions reassociate float32
    # sums from layer 1 on, and the int8 quantizer turns such a
    # difference into a code one step off now and then, which moves the
    # 774M logits by about 5e-3 (PERF.md section 6): the rule
    # reads the distance d between the two shard counts' logits where a
    # stream differs, in place of float32's fixed 1e-4
    eng = ServingEngine(model, device=DEV, kv_dtype="int8", **ekw)
    reqs1 = []
    want8, wall = serve(torch, eng, prompts, n_new, Request, reqs1)
    i8 = {"tp1": serve_stats(eng, wall, want8)}
    del eng
    release_device(torch)
    eng = tp_engine(model, 2, kv_dtype="int8")
    got8, st, launches = tp_serve(torch, ra, eng, prompts, n_new, Request,
                                  INT8, "int8 tp=2")
    divs = []
    for i, (a, b) in enumerate(zip(got8, want8)):
        if a == b:
            continue
        j = next(k for k in range(n_new) if a[k] != b[k])
        l1, l2 = int8_pair_logits(torch, model, eng, prompts[i], b[:j],
                                  reqs1[i].kv_history)
        row = {"request": i, "token": j, "tp1_top2_gap": gap2(l1),
               "max_abs_logit_diff": (l2 - l1).abs().max().item()}
        divs.append(row)
        require(row["tp1_top2_gap"] < 2 * row["max_abs_logit_diff"],
                f"int8 tp=2: request {i} diverges at token {j} where "
                f"tp=1's gap {row['tp1_top2_gap']} exceeds 2 x "
                f"{row['max_abs_logit_diff']}")
    st.update(launches=launches, divergences=divs,
              streams_equal_tp1=sum(a == b for a, b in zip(got8, want8)),
              layer0=int8_layer0_check(torch, model, eng, prompts))
    i8["tp2"] = st
    out["int8_pages"] = i8
    del eng
    release_device(torch)

    # bfloat16 at tp=2 against tp=1: first tokens where the gap exceeds
    # twice the measured tp=2 / tp=1 logit distance
    model.to(torch.bfloat16)
    eng = ServingEngine(model, device=DEV, **ekw)
    serve(torch, eng, prompts, n_new, Request)          # warm-up
    eng.reset_stats()
    want16, wall = serve(torch, eng, prompts, n_new, Request)
    b16 = {"tp1": serve_stats(eng, wall, want16)}
    del eng
    eng = tp_engine(model, 2)
    got16, st, launches = tp_serve(torch, ra, eng, prompts, n_new, Request,
                                   SPAN_TC, "bfloat16 tp=2")
    first = []
    for i, p in enumerate(prompts):
        l2 = tp_logits(torch, eng, p)
        l1 = float_logits(torch, model, p, "auto")
        first.append({"request": i, "max_abs_logit_diff":
                      (l2 - l1).abs().max().item(), "tp1_top2_gap":
                      gap2(l1), "equal": got16[i][0] == want16[i][0]})
    d = max(r["max_abs_logit_diff"] for r in first)
    for r in first:
        if r["tp1_top2_gap"] > 2 * d:
            require(r["equal"], f"bf16 tp=2 first token of request "
                    f"{r['request']} differs where the gap "
                    f"{r['tp1_top2_gap']} exceeds 2 x {d}")
    st.update(launches=launches, max_abs_logit_diff=d, first_tokens=first,
              streams_equal_tp1=sum(a == b for a, b in zip(got16, want16)),
              ms_over_tp1=st["ms_per_dispatch"]
              / b16["tp1"]["ms_per_dispatch"])
    b16["tp2"] = st
    out["bfloat16"] = b16
    del eng, model
    release_device(torch)

    # w8 at tp=2 against w8 at tp=1 (each w8 engine quantizes its model
    # in place: one fresh model, quantized by the tp=1 engine)
    model, _ = gpt2_774m(torch)
    eng = ServingEngine(model, device=DEV, weight_dtype="int8", **ekw)
    want_w8, gaps_w8, wall = serve_gaps(torch, eng, prompts, n_new, Request)
    w8 = {"tp1": serve_stats(eng, wall, want_w8)}
    del eng
    eng = tp_engine(model, 2)
    require(eng.weight_dtype == "int8", "the w8 model serves float at tp=2")
    got_w8, st, launches = tp_serve(torch, ra, eng, prompts, n_new, Request,
                                    SPAN, "w8 tp=2")
    st.update(launches=launches,
              divergences=held_to(got_w8, want_w8, gaps_w8, "w8 tp=2"),
              streams_equal_tp1=got_w8 == want_w8,
              weight_bytes_per_chip=eng.stats["weight_bytes_per_chip"])
    w8["tp2"] = st
    out["w8"] = w8
    del eng, model
    release_device(torch)

    out["launches_by_family"] = {
        "float32": launches_f32,
        "bfloat16": out["bfloat16"]["tp2"]["launches"][SPAN_TC],
        "int8": out["int8_pages"]["tp2"]["launches"][INT8],
        "w8_float32": out["w8"]["tp2"]["launches"][SPAN],
        "decode": out["float32"]["tp2"]["decode_launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    print(json.dumps({"gpt2_tp": "summary", "card": card,
                      "ms_per_dispatch": {
                          f"tp{t}": f32[f"tp{t}"]["ms_per_dispatch"]
                          for t in (1,) + TP_SIZES},
                      "weight_bytes_per_chip": {
                          f"tp{t}": f32[f"tp{t}"]["weight_bytes_per_chip"]
                          for t in TP_SIZES},
                      "kv_page_bytes_per_chip": {
                          f"tp{t}": f32[f"tp{t}"]["kv_page_bytes_per_chip"]
                          for t in TP_SIZES},
                      "seconds": out["seconds"]}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7: BERT-base MLM training steps
# ---------------------------------------------------------------------------

def bert_batch(torch, cfg, B, T, M):
    """bench_bert's traffic: random ids, token types 0, valid lengths
    U[3T/4, T] (U[384, 512] at T = 512), M masked positions per row drawn
    without replacement below its valid length, random labels (numpy
    seed 0)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (B, T))
    vl = rng.integers(T * 3 // 4, T + 1, B)
    pos = np.stack([np.sort(rng.choice(int(n), M, replace=False))
                    for n in vl])
    labels = rng.integers(0, cfg.vocab_size, (B, M))
    arrays = (ids, np.zeros((B, T)), vl, pos, labels)
    return tuple(torch.tensor(a, dtype=torch.int32, device=DEV)
                 for a in arrays), [int(n) for n in vl]


def trace_step(torch, step, batch):
    """One training step under the profiler."""
    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    return profiled(torch, run, 10)


def phase_bert(torch, fa, card):
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (BertForMaskedLM, bert_base_config,
                                        init_params)
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    def make(**kw):
        cfg = bert_base_config(dropout=0.1, attention_dropout=0.1, **kw)
        require(cfg.num_layers == BERT_LAYERS, "base config changed")
        return init_params(BertForMaskedLM(cfg, device=DEV), seed=0,
                           std=0.02), cfg

    def grads(model):
        """One forward and backward of the training loss (from float32
        logits) in train() mode, dropout drawn from a fixed generator: the
        loss and every parameter's gradient (then cleared)."""
        model.train()
        with rng.generator_scope(rng.step_generator(0, 1, DEV)):
            loss = SoftmaxCrossEntropyLoss()(model(*batch[:4]).float(),
                                             batch[4]).mean()
            loss.backward()
        g = {n: p.grad for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    def train(model, steps):
        rng.seed(0)        # the same dropout stream on every path
        step = TrainStep(model, SoftmaxCrossEntropyLoss(),
                         AdamW(learning_rate=1e-4, wd=0.01), n_net_inputs=4)
        return step, [float(step(*batch)) for _ in range(steps)]

    t0 = time.perf_counter()
    model, cfg = make()
    torch.cuda.synchronize()
    out = {"phase": "bert", "card": card, "config": "bert_base_config",
           "layers": cfg.num_layers, "units": cfg.units,
           "heads": cfg.num_heads, "hidden": cfg.hidden_size,
           "vocab": cfg.vocab_size, "max_length": cfg.max_length,
           "params": cfg.num_params(),
           "init_s": time.perf_counter() - t0}
    batch, lens = bert_batch(torch, cfg, **BERT_TRAFFIC)
    B, T = batch[0].shape
    out["traffic"] = {"batch": B, "seq_len": T,
                      "masked_per_row": batch[3].shape[1],
                      "valid_lengths": lens}

    # the main path: float32 through the kernels; launches counted here
    steps = 5
    _, g_kernel = grads(model)
    fa.reset_launches()
    t0 = time.perf_counter()
    _, losses = train(model, steps)
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * steps if k in FAMILY_KEYS["cuda_core"] else 0)
            for k in launches}
    require(launches == want, f"float32 steps launched {launches}, not "
            f"{BERT_LAYERS} x {steps} of the CUDA-core pair alone")
    out["launches"] = launches
    out["float32_kernel"] = {"losses": losses, "wall_s": wall,
                             "ms_per_step": wall / steps * 1e3}
    del model
    torch.cuda.empty_cache()

    # the same steps through the plain versions, from the same weights
    model, _ = make(attention_impl="torch")
    _, g32 = grads(model)          # kept for the bfloat16 check below
    top32 = layer_top(g32)
    rel = grad_rel(g_kernel, g32, top32)
    del g_kernel
    worst = max(rel, key=rel.get)
    require(rel[worst] <= 1e-4, f"float32 gradient of {worst} differs by "
            f"{rel[worst]} of its layer's largest gradient")
    out["float32_grad_rel_err"] = {"worst": rel[worst], "worst_param": worst,
                                   "params": len(rel), "tol": 1e-4}
    t0 = time.perf_counter()
    _, plain = train(model, steps)
    wall = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    require(fa.LAUNCHES == launches, "the plain path launched a kernel")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, plain)]
    require(all(np.isfinite(losses)), f"non-finite losses {losses}")
    require(max(rel) <= 1e-5, f"losses differ by {rel} relative")
    out["float32_plain"] = {"losses": plain, "wall_s": wall,
                            "ms_per_step": wall / steps * 1e3}
    out["float32_loss_rel_diff"] = rel

    # bfloat16 weights with float32 masters on the kernel path, timed
    model, _ = make()
    model.to(torch.bfloat16)
    fa.reset_launches()
    loss16, g16_kernel = grads(model)
    once = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS if k in FAMILY_KEYS["tensor_core"] else 0)
            for k in once}
    require(once == want, f"a bfloat16 forward and backward launched "
            f"{once}, not {BERT_LAYERS} of the tensor-core pair alone")
    torch.cuda.reset_peak_memory_stats()
    step, _ = train(model, 1)                       # warm-up
    n = 20
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bl = [step(*batch) for _ in range(n)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    bl = [float(x) for x in bl]
    launches16 = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * n if k in FAMILY_KEYS["tensor_core"] else 0)
            for k in launches16}
    require(launches16 == want, f"bfloat16 steps launched {launches16}, "
            f"not {BERT_LAYERS} x {n} of the tensor-core pair alone")
    out["launches_bf16"] = launches16
    require(all(np.isfinite(bl)), f"non-finite bfloat16 losses {bl}")
    require(bl[-1] < bl[0], f"the bfloat16 loss did not fall: {bl}")
    flops_per_token = 6 * cfg.num_params() \
        + 12 * cfg.num_layers * cfg.units * T
    out["bfloat16_kernel"] = {
        "card": card, "steps": n, "losses": bl, "ms_per_step": dt * 1e3,
        "tokens_per_s": B * T / dt,
        "bert_base_mlm_mfu": flops_per_token * B * T / dt
        / PEAK_FLOPS["bfloat16"],
        "achieved_tflops": flops_per_token * B * T / dt / 1e12,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    trace = trace_step(torch, step, batch)
    by_class = trace.get("device_ms_by_class", {})
    if by_class:
        trace["fused_attention_share"] = \
            by_class.get("fused_attention", 0.0) / trace["device_ms"]
    out["bfloat16_kernel_trace"] = trace
    del step, model
    torch.cuda.empty_cache()

    # one bfloat16 forward and backward of the model on the plain path,
    # from the same weights and dropout stream: the kernels' calls inside
    # the model (their strides, dtypes and seeds) against the plain ones
    model, _ = make(attention_impl="torch")
    model.to(torch.bfloat16)
    fa.reset_launches()
    plain16, g16_plain = grads(model)
    require(not any(fa.LAUNCHES.values()), "the plain path launched a kernel")
    del model
    diff = grad_rel(g16_kernel, g16_plain, top32)
    own = grad_rel(g16_plain, g32, top32)      # the plain path's bf16 error
    del g16_kernel, g16_plain, g32
    torch.cuda.empty_cache()
    limit = {n: max(BF16_MODEL_GRAD_TOL, own[n]) for n in diff}
    worst = max(diff, key=lambda n: diff[n] / limit[n])
    loss_rel = abs(loss16 - plain16) / abs(plain16)
    out["bfloat16_grad_rel_err"] = {
        "worst": diff[worst], "worst_param": worst,
        "worst_limit": limit[worst], "largest": max(diff.values()),
        "largest_param": max(diff, key=diff.get),
        "over_tol_by_own_error": sorted(n for n in diff
                                        if own[n] > BF16_MODEL_GRAD_TOL),
        "plain_own_error_largest": max(own.values()), "params": len(diff),
        "tol": BF16_MODEL_GRAD_TOL, "loss_kernel": loss16,
        "loss_plain": plain16, "loss_rel_diff": loss_rel,
        "loss_tol": BF16_MODEL_LOSS_TOL}
    require(diff[worst] <= limit[worst], f"bfloat16 gradient of {worst} "
            f"differs by {diff[worst]} of its layer's largest float32 "
            f"gradient, over {limit[worst]}")
    require(loss_rel <= BF16_MODEL_LOSS_TOL, f"bfloat16 losses {loss16} and "
            f"{plain16} differ by {loss_rel} relative")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7g: BERT-base MLM through the eager gluon surface
# ---------------------------------------------------------------------------

def gluon_bert(mx, **kw):
    """BertForMaskedLM(cfg) on the default device (the card), initialised
    by the gluon surface from mx.random.seed(0): the same weights every
    call."""
    from mxnet_tpu_torch.models import BertForMaskedLM, bert_base_config
    cfg = bert_base_config(**kw)
    require(cfg.num_layers == BERT_LAYERS, "base config changed")
    net = BertForMaskedLM(cfg)
    mx.random.seed(0)
    net.initialize(mx.init.Normal(0.02))
    return net, cfg


def gluon_steps(mx, net, trainer, lfn, batch, steps, clip=None):
    """The eager loop: record, backward, clip_global_norm (when given),
    Trainer.step(1); returns the losses as floats."""
    from mxnet_tpu_torch import autograd, gluon
    nd = [mx.nd.NDArray(t) for t in batch]
    params = list(net.collect_params().values())
    losses = []
    for _ in range(steps):
        with autograd.record():
            loss = lfn(net(*nd[:4]), nd[4]).mean()
        loss.backward()
        if clip is not None:
            gluon.utils.clip_global_norm(
                [p.grad() for p in params if p.grad_req != "null"], clip)
        trainer.step(1)
        losses.append(float(loss.asscalar()))
    return losses


def gluon_grads(mx, net, lfn, batch):
    """One eager forward and backward: (loss, {name: gradient})."""
    from mxnet_tpu_torch import autograd
    nd = [mx.nd.NDArray(t) for t in batch]
    with autograd.record():
        loss = lfn(net(*nd[:4]), nd[4]).mean()
    loss.backward()
    g = {n: p.grad()._data.detach().clone()
         for n, p in net.collect_params().items() if p.grad_req != "null"}
    net.zero_grad()
    return float(loss.asscalar()), g


def gluon_breakdown(torch, mx, net, trainer, lfn, batch, clip, steps=3):
    """Host wall ms of each stage of the eager step, the card synchronised
    after each (so each stage holds its own device time): forward under
    record(), backward, clip_global_norm, Trainer.step; medians over
    `steps` steps."""
    from mxnet_tpu_torch import autograd, gluon
    nd = [mx.nd.NDArray(t) for t in batch]
    params = [p for p in net.collect_params().values()
              if p.grad_req != "null"]
    rows = []
    for _ in range(steps):
        t = [time.perf_counter()]
        with autograd.record():
            loss = lfn(net(*nd[:4]), nd[4]).mean()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        loss.backward()
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        gluon.utils.clip_global_norm([p.grad() for p in params], clip)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        trainer.step(1)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        rows.append([(b - a) * 1e3 for a, b in zip(t, t[1:])])
    med = np.median(np.asarray(rows), axis=0)
    return dict(zip(("forward", "backward", "clip_global_norm",
                     "trainer_step"), (float(x) for x in med)))


def phase_bert_gluon(torch, fa, card, bert):
    """BERT-base MLM at bench_bert's traffic driven only through the gluon
    surface (BertForMaskedLM(cfg), net.initialize, gluon.Trainer with
    LAMB and a PolyScheduler with warmup, autograd.record, backward,
    clip_global_norm, Trainer.step): (a) float32, dropout 0, TF32 off:
    BERT_GLUON f32_steps eager steps against parallel.TrainStep(net, loss,
    LAMB) from the same weights and batch (the step's scheduler shifted
    by one: TrainStep reads the rate before it counts the step, the
    Trainer after; no global-norm clip on either side, TrainStep has
    none): losses within 1e-5 relative each step, the largest parameter
    difference after the last step within 1e-4; (b) the fused kernels ran
    12 forward and 12 backward launches a step (CUDA-core family) in
    those eager steps, and one eager step on the plain path
    (attention_impl "torch") against the kernel's, float32 and bfloat16,
    within phase 7's gates; (c) bfloat16 (net.cast, multi_precision),
    dropout 0.1, the loop with clip_global_norm(1.0): bf16_warmup steps,
    then bf16_steps timed (ms a step, tokens/s, peak memory) beside phase
    7's TrainStep ms at the same traffic; the tensor-core pair 12 times a
    step; the first loss within 1e-2 of a float32 forward's on the same
    dropout stream; every loss finite."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon, rng
    from mxnet_tpu_torch.lr_scheduler import PolyScheduler
    from mxnet_tpu_torch.optimizer import LAMB
    from mxnet_tpu_torch.parallel import TrainStep

    G = BERT_GLUON

    def sched():
        return PolyScheduler(G["max_update"], base_lr=G["lr"], pwr=1,
                             warmup_steps=G["warmup_steps"],
                             warmup_begin_lr=G["warmup_begin_lr"])

    def trainer(net, **kw):
        return gluon.Trainer(net.collect_params(), "lamb",
                             dict(learning_rate=G["lr"], wd=G["wd"],
                                  lr_scheduler=sched(), **kw))

    lfn = gluon.loss.SoftmaxCrossEntropyLoss()
    out = {"phase": "bert_gluon", "card": card, "optimizer": "lamb",
           "schedule": {k: G[k] for k in ("lr", "wd", "max_update",
                                          "warmup_steps",
                                          "warmup_begin_lr")}}
    t0 = time.perf_counter()
    net, cfg = gluon_bert(mx, dropout=0.0, attention_dropout=0.0)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    require(net.device.type == "cuda", "the default device is not the card")
    batch, lens = bert_batch(torch, cfg, **BERT_TRAFFIC)
    B, T = batch[0].shape
    out["traffic"] = {"batch": B, "seq_len": T,
                      "masked_per_row": batch[3].shape[1]}
    w0 = {n: p.detach().clone() for n, p in net.named_parameters()}

    # (a) + (b): the main path, float32 through the kernels
    n = G["f32_steps"]
    tr = trainer(net)
    fa.reset_launches()
    t0 = time.perf_counter()
    eager = gluon_steps(mx, net, tr, lfn, batch, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * n if k in FAMILY_KEYS["cuda_core"] else 0)
            for k in launches}
    require(launches == want, f"eager float32 steps launched {launches}, "
            f"not {BERT_LAYERS} x {n} of the CUDA-core pair alone")
    out["launches"] = launches
    w_eager = {k: p.detach().clone() for k, p in net.named_parameters()}
    del tr
    net2, _ = gluon_bert(mx, dropout=0.0, attention_dropout=0.0)
    with torch.no_grad():
        for k, p in net2.named_parameters():
            p.copy_(w0[k])
    s2 = sched()
    rng.seed(0)
    step = TrainStep(net2, lfn, LAMB(learning_rate=G["lr"], wd=G["wd"],
                                     lr_scheduler=lambda t: s2(t + 1)),
                     n_net_inputs=4)
    fused = [float(step(*batch)) for _ in range(n)]
    rel = [abs(a - b) / abs(b) for a, b in zip(eager, fused)]
    diff = max((p.detach() - w_eager[k]).abs().max().item()
               for k, p in net2.named_parameters())
    out["float32"] = {"eager_losses": eager, "trainstep_losses": fused,
                      "loss_rel_diff": rel, "max_param_abs_diff": diff,
                      "eager_ms_per_step": wall / n * 1e3,
                      "lr_steps": [sched()(t) for t in range(1, n + 1)]}
    require(all(np.isfinite(eager)), f"non-finite eager losses {eager}")
    require(max(rel) <= 1e-5, f"eager and TrainStep losses differ by {rel}")
    require(diff <= 1e-4, f"eager and TrainStep parameters differ by {diff}")
    del step, net2, w_eager
    torch.cuda.empty_cache()

    # (b): kernel against plain, one eager step from the same weights
    def reload(m):
        with torch.no_grad():
            for k, p in m.named_parameters():
                p.copy_(w0[k].to(p.dtype))
        return m

    reload(net)
    fa.reset_launches()
    l32, g32k = gluon_grads(mx, net, lfn, batch)
    require(dict(fa.LAUNCHES) == {k: (BERT_LAYERS if k in
                                      FAMILY_KEYS["cuda_core"] else 0)
                                  for k in fa.LAUNCHES},
            f"one float32 eager step launched {dict(fa.LAUNCHES)}")
    plain, _ = gluon_bert(mx, dropout=0.0, attention_dropout=0.0,
                          attention_impl="torch")
    reload(plain)
    fa.reset_launches()
    p32, g32 = gluon_grads(mx, plain, lfn, batch)
    require(not any(fa.LAUNCHES.values()), "the plain path launched")
    top32 = layer_top(g32)
    r32 = grad_rel(g32k, g32, top32)
    worst = max(r32, key=r32.get)
    loss_rel = abs(l32 - p32) / abs(p32)
    out["float32_kernel_vs_plain"] = {
        "loss_kernel": l32, "loss_plain": p32, "loss_rel_diff": loss_rel,
        "grad_rel_worst": r32[worst], "worst_param": worst, "tol": 1e-4,
        "loss_tol": 1e-5}
    require(loss_rel <= 1e-5, f"eager kernel and plain losses {l32}, {p32}")
    require(r32[worst] <= 1e-4, f"eager float32 gradient of {worst} "
            f"differs by {r32[worst]} of its layer's largest")
    del g32k
    for m in (net, plain):
        m.cast("bfloat16")
    fa.reset_launches()
    l16, g16k = gluon_grads(mx, net, lfn, batch)
    require(dict(fa.LAUNCHES) == {k: (BERT_LAYERS if k in
                                      FAMILY_KEYS["tensor_core"] else 0)
                                  for k in fa.LAUNCHES},
            f"one bfloat16 eager step launched {dict(fa.LAUNCHES)}")
    p16, g16 = gluon_grads(mx, plain, lfn, batch)
    diff16 = grad_rel(g16k, g16, top32)
    own = grad_rel(g16, g32, top32)
    limit = {k: max(BF16_MODEL_GRAD_TOL, own[k]) for k in diff16}
    worst = max(diff16, key=lambda k: diff16[k] / limit[k])
    rel16 = abs(l16 - p16) / abs(p16)
    out["bfloat16_kernel_vs_plain"] = {
        "loss_kernel": l16, "loss_plain": p16, "loss_rel_diff": rel16,
        "loss_tol": BF16_REL_TOL, "grad_rel_worst": diff16[worst],
        "worst_param": worst, "worst_limit": limit[worst],
        "tol": BF16_MODEL_GRAD_TOL}
    require(rel16 <= BF16_REL_TOL, f"bfloat16 eager losses {l16}, {p16}")
    require(diff16[worst] <= limit[worst], f"bfloat16 eager gradient of "
            f"{worst} differs by {diff16[worst]}, over {limit[worst]}")
    del net, plain, g16k, g16, g32
    torch.cuda.empty_cache()

    # (c): bfloat16 with masters, dropout 0.1, timed
    net, _ = gluon_bert(mx, dropout=0.1, attention_dropout=0.1)
    rng.seed(1)
    nd = [mx.nd.NDArray(t) for t in batch]
    with torch.no_grad(), autograd.train_mode():
        first32 = float(lfn(net(*nd[:4]), nd[4]).mean().asscalar())
    net.cast("bfloat16")
    tr = trainer(net, multi_precision=True)
    torch.cuda.reset_peak_memory_stats()
    rng.seed(1)
    warm = gluon_steps(mx, net, tr, lfn, batch, G["bf16_warmup"],
                       clip=G["clip"])
    n = G["bf16_steps"]
    fa.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed_losses = gluon_steps(mx, net, tr, lfn, batch, n, clip=G["clip"])
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / n
    launches16 = dict(fa.LAUNCHES)
    want = {k: (BERT_LAYERS * n if k in FAMILY_KEYS["tensor_core"] else 0)
            for k in launches16}
    require(launches16 == want, f"eager bfloat16 steps launched "
            f"{launches16}, not {BERT_LAYERS} x {n} of the tensor-core "
            "pair alone")
    out["launches_bf16"] = launches16
    losses = warm + timed_losses
    out["bfloat16_breakdown_ms"] = gluon_breakdown(torch, mx, net, tr, lfn,
                                                   batch, G["clip"])
    first_rel = abs(losses[0] - first32) / abs(first32)
    ts_ms = bert["bfloat16_kernel"]["ms_per_step"]
    out["bfloat16"] = {
        "card": card, "steps": n, "losses": losses,
        "first_loss_float32": first32, "first_loss_rel_diff": first_rel,
        "ms_per_step": dt * 1e3, "tokens_per_s": B * T / dt,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "trainstep_adamw_ms_per_step": ts_ms,
        "eager_over_trainstep": dt * 1e3 / ts_ms,
        "note": "TrainStep (phase 7) runs AdamW without a global-norm "
                "clip; the eager loop LAMB with clip_global_norm"}
    require(all(np.isfinite(losses)), f"non-finite bfloat16 losses {losses}")
    require(first_rel <= 1e-2, f"the first bfloat16 loss {losses[0]} is "
            f"{first_rel} from float32's {first32}")
    del tr, net
    torch.cuda.empty_cache()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7g2: BERT-base MLM with dynamic loss scaling, checkpointed and
# resumed
# ---------------------------------------------------------------------------

def resume_run(torch, step, batch, steps):
    """`steps` steps: each loss and the scale after it, read from the card
    once at the end (no host sync between steps)."""
    losses, scales = [], []
    for _ in range(steps):
        losses.append(step(*batch))
        scales.append(step._scale_state[0].clone())
    return [float(x) for x in losses], [float(x) for x in scales]


def within_spread(got, ref, spread):
    """Equal to `ref` bit for bit where the uninterrupted runs agreed, and
    within their spread where they did not."""
    return all(abs(a - b) <= s for a, b, s in zip(got, ref, spread))


def count_syncs(torch, fn):
    """The synchronising calls fn() makes, as torch's sync debug mode
    reports them (one warning each)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "synchroniz" in str(w.message)]


def phase_bert_resume(torch, fa, card):
    """BERT-base MLM at bench_bert's traffic in bfloat16 (init_params seed
    0, std 0.02; AdamW(1e-4, wd 0.01) with float32 masters; dropout and
    attention dropout 0.1) under TrainStep(loss_scale="dynamic",
    scale_window=2), so the scale moves during the run. (a) 6 steps from
    the same weights, twice: each run's losses, scales and final
    parameters, and their spread; the tensor-core fused pair 12 times a
    step. (b) 3 steps, an asynchronous TrainCheckpoint save (its blocking
    ms, the ms until the write is durable, the GB), one more step while
    the write is in flight, then a new net from other seeded weights and
    a new step (another dropout seed) restored from it (seconds): step
    count 3, the cursor back, and 3 more steps whose losses, scales and
    final parameters equal (a)'s within (a)'s spread. (c) the scale state
    set to 2^127: one step as it is (recorded: the scaled loss is inf but
    the gradients stay finite, so it is not an overflow), then one whose
    forward overflows (an inf added after the embedding LayerNorm): that
    step is skipped with every parameter, master and optimizer state
    bitwise kept, the scale 2^126, the step count one up, and the next
    loss finite. (d) the synchronising
    calls of one step with loss_scale None and "dynamic" (torch's sync
    debug mode): scaling adds none. (e) ms a step of both, 5 timed steps
    each, recorded. (f) the eager gluon flow: amp.init("bfloat16"),
    amp.convert_model, gluon.Trainer + LAMB, amp.init_trainer and
    amp.scale_loss, dropout 0: 4 uninterrupted steps, twice, for their
    spread; 2 steps, save_parameters + save_states, a new net and
    Trainer, load_parameters + load_states, 2 steps equal to the 4
    uninterrupted ones within that spread; the route those steps
    launched (the kept
    float32 LayerNorm makes the activations, so q, float32: the CUDA-core
    pair)."""
    import shutil
    import tempfile
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import amp, autograd, gluon, rng
    from mxnet_tpu_torch.checkpoint import TrainCheckpoint
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (BertForMaskedLM, bert_base_config,
                                        init_params)
    from mxnet_tpu_torch.optimizer import AdamW
    from mxnet_tpu_torch.parallel import TrainStep

    R = BERT_RESUME
    n, k = R["steps"], R["save_at"]
    tc = FAMILY_KEYS["tensor_core"]

    def model_of(seed):
        cfg = bert_base_config(dropout=0.1, attention_dropout=0.1)
        require(cfg.num_layers == BERT_LAYERS, "base config changed")
        model = init_params(BertForMaskedLM(cfg, device=DEV), seed=seed,
                            std=0.02)
        return model.to(torch.bfloat16), cfg

    def step_of(model, loss_scale="dynamic", seed=0):
        rng.seed(seed)     # the base of the per-step dropout seeds
        return TrainStep(model, SoftmaxCrossEntropyLoss(),
                         AdamW(learning_rate=1e-4, wd=0.01), n_net_inputs=4,
                         loss_scale=loss_scale,
                         scale_window=R["scale_window"])

    def tc_launches(launches, steps):
        return launches == {key: (BERT_LAYERS * steps if key in tc else 0)
                            for key in launches}

    out = {"phase": "bert_resume", "card": card, "loss_scale": "dynamic",
           "scale_window": R["scale_window"], "steps": n, "save_at": k}
    model, cfg = model_of(0)
    batch, _ = bert_batch(torch, cfg, **BERT_TRAFFIC)

    # (a) the uninterrupted run, twice
    runs = []
    for i in range(2):
        if i:
            model, _ = model_of(0)
        step = step_of(model)
        fa.reset_launches()
        losses, scales = resume_run(torch, step, batch, n)
        launches = dict(fa.LAUNCHES)
        require(tc_launches(launches, n), f"the dynamic steps launched "
                f"{launches}, not {BERT_LAYERS} x {n} of the tensor-core "
                "pair alone")
        runs.append((losses, scales, {name: p.detach().clone()
                                      for name, p in model.named_parameters()}))
        del step, model
        torch.cuda.empty_cache()
    (ref, ref_scales, ref_params), (again, again_scales, again_params) = runs
    loss_spread = [abs(a - b) for a, b in zip(ref, again)]
    param_spread = {name: float((p.float() - again_params[name].float())
                                .abs().max()) for name, p in ref_params.items()}
    del again_params
    require(ref_scales == again_scales, f"the scale sequences differ: "
            f"{ref_scales}, {again_scales}")
    require(all(np.isfinite(ref)), f"non-finite losses {ref}")
    out["uninterrupted"] = {
        "losses": ref, "losses_again": again, "scales": ref_scales,
        "launches": launches, "loss_spread": loss_spread,
        "params_differing": sorted(nm for nm, v in param_spread.items() if v),
        "param_spread_max": max(param_spread.values()),
        "bitwise_deterministic": not any(loss_spread)
        and not any(param_spread.values())}

    # (b) interrupted: save at step k, one step while it writes, restore
    # into a new net and step, resume
    tmp = tempfile.mkdtemp(prefix="bert_resume_")
    try:
        model, _ = model_of(0)
        step = step_of(model)
        fa.reset_launches()
        first, first_scales = resume_run(torch, step, batch, k)
        ck = TrainCheckpoint(tmp, max_to_keep=2)
        ck.save(k, step, data_cursor={"step": k})
        blocking = ck.last_save["blocking_s"]
        t0 = time.perf_counter()
        inflight, _ = resume_run(torch, step, batch, 1)
        inflight_s = time.perf_counter() - t0
        ck.wait_until_finished()
        saved = dict(ck.last_save)
        del step, model
        torch.cuda.empty_cache()
        model, _ = model_of(1)          # other weights, another seed
        step = step_of(model, seed=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cursor = ck.restore(step)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        require(step.step_count == k, f"restored step count "
                f"{step.step_count}, not {k}")
        require(cursor == {"step": k}, f"restored cursor {cursor}")
        resumed, resumed_scales = resume_run(torch, step, batch, n - k)
        launches = dict(fa.LAUNCHES)
        require(tc_launches(launches, n + 1), f"the interrupted run "
                f"launched {launches}, not {BERT_LAYERS} x {n + 1} of the "
                "tensor-core pair alone")
        param_diff = {name: float((p.detach().float() - ref_params[name].float())
                                  .abs().max())
                      for name, p in model.named_parameters()}
        over = sorted(nm for nm, v in param_diff.items()
                      if v > param_spread[nm])
        got = first + resumed
        out["interrupted"] = {
            "losses": got, "inflight_loss": inflight[0],
            "scales": first_scales + resumed_scales, "launches": launches,
            "save_blocking_ms": blocking * 1e3,
            "save_durable_ms": saved["durable_s"] * 1e3,
            "save_gb": saved["bytes"] / 1e9,
            "inflight_step_ms": inflight_s * 1e3,
            "write_outlived_the_step": saved["durable_s"]
            > blocking + inflight_s,
            "restore_s": restore_s, "cursor": cursor,
            "param_diff_max": max(param_diff.values()),
            "params_over_spread": over}
        require(within_spread(got, ref, loss_spread),
                f"resumed losses {got} against {ref}, spread {loss_spread}")
        require(within_spread(inflight, ref[k:k + 1], loss_spread[k:]),
                f"the step during the write lost {inflight[0]}, not "
                f"{ref[k]}")
        require(first_scales + resumed_scales == ref_scales,
                f"resumed scales {first_scales + resumed_scales}, not "
                f"{ref_scales}")
        require(not over, f"parameters {over[:4]} differ from the "
                "uninterrupted run's beyond its spread")
        del ref_params

        # (c) an overflowing step on the card. The scale alone does not
        # overflow: the scaled loss is inf, but its gradients are
        # 2^127 x dL/dw, finite while |dL/dw| < 2; so first one step at
        # 2^127 as it is (recorded), then one whose forward overflows (an
        # inf after the embedding LayerNorm, as a float16 activation
        # overflows), again from 2^127
        step._scale_state = (torch.tensor(2.0 ** 127, device=DEV),
                             step._scale_state[1])
        plain_loss = float(step(*batch))
        plain = {"loss": plain_loss, "scale_after": step.loss_scale}
        before = ([p.detach().clone() for p in model.parameters()],
                  [[s.clone() for s in st] for st in step._states])
        t_before = step.step_count
        step._scale_state = (torch.tensor(2.0 ** 127, device=DEV),
                             step._scale_state[1])
        hook = model.backbone.embed_ln.register_forward_hook(
            lambda mod, args, y: y + float("inf"))
        try:
            skipped = float(step(*batch))
        finally:
            hook.remove()
        scale_after = step.loss_scale
        kept = all(torch.equal(a.detach(), b)
                   for a, b in zip(model.parameters(), before[0])) and all(
            torch.equal(a, b) for st, old in zip(step._states, before[1])
            for a, b in zip(st, old))
        del before
        count_after = step.step_count
        nxt = float(step(*batch))
        out["overflow"] = {"scale_2e127_alone": plain,
                           "loss": skipped, "kept_bitwise": kept,
                           "scale_after": scale_after,
                           "step_count_before": t_before,
                           "step_count_after": count_after,
                           "next_loss": nxt, "next_scale": step.loss_scale}
        require(kept, "the overflow step changed a parameter or state")
        require(scale_after == 2.0 ** 126, f"scale {scale_after} after the "
                "overflow, not 2^126")
        require(count_after == t_before + 1, "the overflow step did not "
                "count")
        require(np.isfinite(nxt), f"the step after the overflow lost {nxt}")
        ck.close()
        del step
        torch.cuda.empty_cache()

        # (d) host syncs and (e) the cost of scaling, on the same net
        cost = {}
        for mode in (None, "dynamic"):
            step = step_of(model, loss_scale=mode)
            step(*batch)                          # warm-up
            syncs = count_syncs(torch, lambda: step(*batch))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(R["timed_steps"]):
                step(*batch)
            torch.cuda.synchronize()
            cost[str(mode)] = {"ms_per_step": (time.perf_counter() - t0)
                               / R["timed_steps"] * 1e3,
                               "syncs": len(syncs), "sync_calls": syncs}
            del step
            torch.cuda.empty_cache()
        out["cost"] = dict(cost, card=card, dynamic_over_none=cost[
            "dynamic"]["ms_per_step"] / cost["None"]["ms_per_step"])
        require(cost["dynamic"]["syncs"] == cost["None"]["syncs"],
                f"loss scaling added host syncs: {cost}")
        del model
        torch.cuda.empty_cache()

        # (f) the eager gluon flow under amp, saved and loaded mid-run
        amp.init("bfloat16")
        lfn = gluon.loss.SoftmaxCrossEntropyLoss()
        nd = [mx.nd.NDArray(t) for t in batch]

        def amp_net():
            net, _ = gluon_bert(mx, dropout=0.0, attention_dropout=0.0)
            amp.convert_model(net)
            tr = gluon.Trainer(net.collect_params(), "lamb",
                               dict(learning_rate=BERT_GLUON["lr"],
                                    wd=BERT_GLUON["wd"]))
            amp.init_trainer(tr)
            return net, tr

        def amp_steps(net, tr, steps):
            losses = []
            for _ in range(steps):
                with autograd.record():
                    loss = lfn(net(*nd[:4]), nd[4]).mean()
                    with amp.scale_loss(loss, tr) as scaled:
                        autograd.backward(scaled)
                tr.step(1)
                losses.append(loss)
            return [float(x.asscalar()) for x in losses]

        # two uninterrupted runs: their spread gates the reloaded one
        m = R["gluon_steps"]
        net, tr = amp_net()
        fa.reset_launches()
        whole = amp_steps(net, tr, 2 * m)
        amp_launches = dict(fa.LAUNCHES)
        del net, tr
        net, tr = amp_net()
        whole_again = amp_steps(net, tr, 2 * m)
        amp_spread = [abs(a - b) for a, b in zip(whole, whole_again)]
        del net, tr
        net, tr = amp_net()
        part = amp_steps(net, tr, m)
        fp, fs = os.path.join(tmp, "bert.params"), os.path.join(tmp, "states")
        net.save_parameters(fp)
        tr.save_states(fs)
        del net, tr
        net, tr = amp_net()
        net.load_parameters(fp)
        tr.load_states(fs)
        part += amp_steps(net, tr, m)
        route = [fam for fam, keys in FAMILY_KEYS.items()
                 if any(amp_launches[key] for key in keys)]
        out["gluon_amp"] = {"losses_whole": whole,
                            "losses_whole_again": whole_again,
                            "loss_spread": amp_spread,
                            "losses_resumed": part,
                            "launches": amp_launches, "route": route,
                            "params_bytes": os.path.getsize(fp),
                            "states_bytes": os.path.getsize(fs)}
        require(all(np.isfinite(whole)), f"non-finite amp losses {whole}")
        require(within_spread(part, whole, amp_spread),
                f"the reloaded eager run lost {part}, not {whole}")
        require(amp_launches == {
            key: (BERT_LAYERS * 2 * m if key in FAMILY_KEYS["cuda_core"]
                  else 0) for key in amp_launches},
            f"the amp eager steps launched {amp_launches}, not the "
            "CUDA-core pair 12 times a step")
        out["amp_launches"] = amp_launches
        out["launches"] = out["uninterrupted"]["launches"]
        del net, tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7g3: control flow, mx.np, a custom op and functional on the card
# ---------------------------------------------------------------------------

def np_control_cases(torch, mx):
    """The CPU tests' cases of control flow, mx.np, register_op with a
    custom gradient and functional.grad, on the default device: {case:
    numpy result}."""
    from mxnet_tpu_torch import functional, operator
    r = np.random.default_rng(0)
    A = r.standard_normal((3, 4)).astype(np.float32)
    M = (A.T @ A + 3 * np.eye(4)).astype(np.float32)
    out = {"device": mx.nd.array(A).context.device_type}
    data = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
    ys, final = mx.nd.contrib.foreach(lambda x, s: (s + x, s + x), data,
                                      mx.nd.zeros((3,)))
    out["foreach"], out["foreach_final"] = ys.asnumpy(), final.asnumpy()
    ys, (_, s) = mx.nd.contrib.while_loop(
        lambda i, s: i < 5, lambda i, s: (s + i, [i + 1, s + i]),
        [mx.nd.zeros(()), mx.nd.zeros(())], max_iterations=10)
    out["while_loop"], out["while_loop_final"] = ys.asnumpy(), s.asnumpy()
    a = mx.nd.array(A)
    out["cond"] = mx.nd.contrib.cond(a.sum() > 100.0, lambda: a * 10.0,
                                     lambda: a - 1.0).asnumpy()
    x = mx.nd.array(A)
    x.attach_grad()
    with mx.autograd.record():
        _, s = mx.nd.contrib.foreach(lambda xt, s: (s, s * xt + xt), x,
                                     mx.nd.ones((4,)))
        s.sum().backward()
    out["foreach_grad"] = x.grad.asnumpy()
    np_ = mx.np
    for name in ("sin", "exp", "tanh", "cumsum", "sort", "argsort",
                 "nanmean", "median", "amax", "ptp"):
        out[f"np.{name}"] = getattr(np_, name)(a).asnumpy()
    out["np.sum_axis"] = np_.sum(a, axis=1, keepdims=True).asnumpy()
    out["np.einsum"] = np_.einsum("ij,kj->ik", a, a).asnumpy()
    out["np.linalg.inv"] = np_.linalg.inv(mx.nd.array(M)).asnumpy()
    out["np.fmax"] = np_.fmax(a, 0.0).asnumpy()
    out["np.unique"] = np_.unique(mx.nd.array(np.asarray([3, 1, 3, 2],
                                                         np.int32)),
                                  size=3).asnumpy()
    clip = operator.register_op(
        "chip_smoke_st_clip", lambda t: torch.clamp(t, -0.5, 0.5),
        grad=(lambda t: (torch.clamp(t, -0.5, 0.5), None),
              lambda res, g: (3.0 * g,)), register_global=False)
    x = mx.nd.array(A)
    x.attach_grad()
    with mx.autograd.record():
        y = clip(x)
        y.sum().backward()
    out["custom_op"], out["custom_op_grad"] = y.asnumpy(), x.grad.asnumpy()
    out["functional.grad"] = functional.grad(
        lambda t: (mx.nd.sin(t) * t * t).sum())(mx.nd.array(A)).asnumpy()
    return out


def phase_np_control(torch):
    """np_control_cases on the card, each held to its CPU result: shapes
    and dtypes equal, values within 1e-5 relative (1e-4 for the
    inverse; sorts, indices and integer results exactly)."""
    import mxnet_tpu_torch as mx
    t0 = time.perf_counter()
    card = np_control_cases(torch, mx)
    with mx.cpu():
        cpu = np_control_cases(torch, mx)
    where = (card.pop("device"), cpu.pop("device"))
    require(where == ("gpu", "cpu"), f"the cases ran on {where}, not on "
            "the card and the CPU")
    worst = {}
    for name, want in cpu.items():
        got = card[name]
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name}: {got.shape} {got.dtype} on the card, "
                f"{want.shape} {want.dtype} on the CPU")
        if want.dtype.kind in "iub" or name in ("np.sort", "np.argsort"):
            require(np.array_equal(got, want), f"{name} differs")
            worst[name] = 0.0
            continue
        tol = 1e-4 if "inv" in name else 1e-5
        err = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                           1e-3)))
        require(err <= tol, f"{name}: {err} relative, over {tol}")
        worst[name] = err
    out = {"phase": "np_control", "cases": len(worst),
           "rel_err": worst, "seconds": time.perf_counter() - t0}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7g4: the parallel slice — BERT-base MLM on a dp x sp x tp mesh
# ---------------------------------------------------------------------------

def mesh_devices(n):
    """A mesh of n shards on the one card (a repeated device list)."""
    return [f"{DEV}:0" if DEV == "cuda" else DEV] * n


def param_spread(torch, a, b):
    """Largest and median |a - b| over every parameter element of two
    nets of one structure (float32)."""
    diffs = [(p.detach().float() - q.detach().float()).abs().reshape(-1)
             for p, q in zip(a.parameters(), b.parameters())]
    flat = torch.cat(diffs)
    return float(flat.max()), float(flat.median())


def mesh_bert(torch, dtype=None, **kw):
    from mxnet_tpu_torch.models import (BertForMaskedLM, bert_base_config,
                                        init_params)
    cfg = bert_base_config(**dict(MESH_BERT_CFG, **kw))
    require(cfg.num_layers == BERT_LAYERS, "base config changed")
    model = init_params(BertForMaskedLM(cfg, device=DEV), seed=0, std=0.02)
    if dtype is not None:
        model.to(dtype)
    return model, cfg


def timed_steps(torch, step, batch, n):
    """n more steps after the caller's: ms a step (host wall, the card
    synchronised at both ends) and the losses."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(*batch) for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, [float(x) for x in losses]


def shard_attention_check(torch, fa, attention, call):
    """One Ulysses shard's attention as the mesh step called it (`call`:
    its q, k, v, key-padding mask and keywords, detached): `attention`
    (ops.nn.local_attention, so the kernels) against the plain version
    on the same inputs, forward and the three gradients, at phase 6's
    tolerances; the family must launch once each way."""
    (q, k, v, mask), kw = call
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    do = torch.tensor(np.random.default_rng(7).standard_normal(
        tuple(q.shape)), dtype=q.dtype, device=q.device)
    f32 = q.dtype == torch.float32
    name = f"ulysses shard attention {tuple(q.shape)} {q.dtype}"
    family = FAMILY_KEYS["cuda_core" if f32 else "tensor_core"]
    fa.reset_launches()
    o = attention(*leaves, mask, **kw)
    g = torch.autograd.grad(o, leaves, do)
    launches = dict(fa.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want.update(dict.fromkeys(family, 1))
    require(launches == want, f"{name}: launches {launches}")
    o_ref = fa.fused_attention(*leaves, mask=mask, scale=kw.get("scale"),
                               causal=kw.get("causal", False),
                               layout="BHTD", impl="torch")
    g_ref = torch.autograd.grad(o_ref, leaves, do)
    err = (o.float() - o_ref.float()).abs().max().item()
    rel = err / o_ref.float().abs().max().item()
    gabs = [(a.float() - b.float()).abs().max().item()
            for a, b in zip(g, g_ref)]
    grel = [e / b.float().abs().max().item() for e, b in zip(gabs, g_ref)]
    tol = 1e-5 if f32 else BF16_REL_TOL
    gtol = 1e-4 if f32 else BF16_REL_TOL
    out = {"shape": {"B": q.shape[0], "H": q.shape[1], "T": q.shape[2],
                     "D": q.shape[3], "layout": "BHTD",
                     "key_padding": mask is not None, "dropout": 0.0},
           "dtype": str(q.dtype).replace("torch.", ""),
           "max_abs_err": err, "rel_err": rel, "tol": tol,
           "tol_kind": "absolute" if f32 else "relative",
           "grad_max_abs_err": gabs, "grad_rel_err": grel, "grad_tol": gtol}
    require((err if f32 else rel) <= tol,
            f"{name}: forward err {err} (relative {rel}) > {tol}")
    require(max(grel) <= gtol, f"{name}: gradient rel errs {grel} > {gtol}")
    require(bool(torch.isfinite(o).all()) and all(
        bool(torch.isfinite(x).all()) for x in g), f"{name}: non-finite")
    return out


def update_spread(torch, groups):
    """Each group's |new - want| / |want - old| over all its elements
    (norms in float64): `groups` maps a name to a list of (old, new,
    want) tensors, `want` the reference's parameters after the same
    update from `old`."""
    out = {}
    for name, trios in groups.items():
        num = den = 0.0
        for old, new, want in trios:
            num += float((new.double() - want.double()).square().sum())
            den += float((want.double() - old.double()).square().sum())
        out[name] = math.sqrt(num / den) if den else (0.0 if not num
                                                       else math.inf)
    return out


def phase_bert_mesh(torch, fa, card):
    """(a) dryrun_multichip's step at BERT-base width: megatron tp rules,
    TrainStep over a dp 2 x sp 2 x tp 2 mesh of 8 shards on the card,
    attention routed by impl='auto' to Ulysses; (b) compression='2bit'
    on a dp 2 mesh; (c) the kvstore over a one-rank NCCL group; (d)
    PPTrainStep at GPT-2 774M width; (e) MoEFFN on a dp 2 x ep 2 mesh."""
    import threading

    from mxnet_tpu_torch import parallel as par
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.ops import nn as opnn
    from mxnet_tpu_torch.optimizer import SGD, AdamW
    from mxnet_tpu_torch.parallel import PartitionSpec as P
    from mxnet_tpu_torch.parallel import TrainStep
    t_phase = time.perf_counter()
    lr, steps = MESH_MAIN["lr"], MESH_MAIN["steps"]
    mesh = par.make_mesh(MESH_MAIN["axes"], devices=mesh_devices(8))
    n_sp = mesh.shape["sp"]
    specs = (P("dp", "sp"), P("dp", "sp"), P("dp"), P("dp"), P("dp"))

    def make_step(model, on_mesh, optimizer=None):
        if on_mesh:
            par.apply_sharding_rules(model,
                                     par.megatron_dense_rules(tp_axis="tp"))
        rng.seed(0)          # the same dropout stream on both paths
        return TrainStep(model, SoftmaxCrossEntropyLoss(),
                         optimizer or AdamW(learning_rate=lr, wd=0.01),
                         n_net_inputs=4, mesh=mesh if on_mesh else None,
                         batch_specs=specs if on_mesh else None)

    # Ulysses' per-shard attention calls, by sp shard: each Ulysses call
    # runs its shards' attentions in order on one thread; the first call
    # of each dtype is kept (detached) for the kernel-against-plain check
    per_shard = [0] * n_sp
    calls = threading.local()
    lock = threading.Lock()
    local_attention = opnn.local_attention
    first_call = {}

    def counted(*a, **k):
        i = getattr(calls, "i", 0)
        calls.i = i + 1
        with lock:
            per_shard[i % n_sp] += 1
            if a[0].dtype not in first_call:
                first_call[a[0].dtype] = (tuple(
                    None if x is None else x.detach() for x in a), dict(k))
        return local_attention(*a, **k)

    model, cfg = mesh_bert(torch)
    batch, lens = bert_batch(torch, cfg, **BERT_TRAFFIC)
    B, T = batch[0].shape
    out = {"phase": "bert_mesh", "card": card, "mesh": mesh.shape,
           "devices": str(mesh.device_list[0]) + " x 8",
           "config": "bert_base_config", "layers": cfg.num_layers,
           "units": cfg.units, "heads": cfg.num_heads,
           "dropout": cfg.dropout,
           "attention_dropout": cfg.attention_dropout,
           "traffic": {"batch": B, "seq_len": T,
                       "masked_per_row": batch[3].shape[1]}}

    # (a) float32, TF32 off: the mesh step against the single device
    single = make_step(model, False)
    t0 = time.perf_counter()
    want = [float(single(*batch)) for _ in range(steps)]
    single_s = time.perf_counter() - t0
    mmodel, _ = mesh_bert(torch)
    mstep = make_step(mmodel, True)
    fa.reset_launches()
    opnn.local_attention = counted
    try:
        t0 = time.perf_counter()
        got = [float(mstep(*batch)) for _ in range(steps)]
        mesh_s = time.perf_counter() - t0
    finally:
        opnn.local_attention = local_attention
    launches = dict(fa.LAUNCHES)
    calls_f32 = list(per_shard)
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    mstep.sync_params()
    largest, median = param_spread(torch, model, mmodel)
    out["float32"] = {
        "single_losses": want, "mesh_losses": got, "loss_rel_diff": rel,
        "loss_tol": 1e-4, "param_diff_largest": largest,
        "param_diff_median": median, "param_tol": 3 * lr,
        "single_ms_per_step": single_s / steps * 1e3,
        "mesh_ms_per_step": mesh_s / steps * 1e3,
        "launches": launches, "ulysses_calls_by_sp_shard": calls_f32}
    emit({"phase": "bert_mesh_a_float32", **out["float32"]})
    require(all(np.isfinite(got)), f"non-finite mesh losses {got}")
    require(max(rel) <= 1e-4, f"mesh losses {got} differ from the single "
            f"device's {want} by {rel} relative")
    require(largest <= 3 * lr, f"a parameter moved {largest} away from the "
            f"single device's after {steps} steps (over 3 x lr)")
    fwd_key, bwd_key = FAMILY_KEYS["cuda_core"]
    require(min(calls_f32) > 0 and launches[fwd_key] == sum(calls_f32)
            and launches[bwd_key] == sum(calls_f32),
            f"the mesh steps launched {launches} for Ulysses calls "
            f"{calls_f32} by sp shard: not one fused forward and backward "
            "each")
    require(sum(calls_f32) == BERT_LAYERS * mesh.shape["dp"] * n_sp
            * steps, f"Ulysses ran {calls_f32} shard attentions, not "
            f"{BERT_LAYERS} layers x dp x sp x {steps} steps")
    out["launches"] = launches
    del single, mstep, model, mmodel
    release_device(torch)
    out["shard_check"] = {"float32": shard_attention_check(
        torch, fa, local_attention, first_call.pop(torch.float32))}
    emit({"phase": "bert_mesh_a_shard_float32",
          **out["shard_check"]["float32"]})

    # (a) one SGD step (lr 1, wd 0) from the same weights, mesh against
    # single: the update is -lr x the reduced gradient, so a dp or tp
    # reduction off by a constant factor shows here, where AdamW's
    # normalised first steps hide it. Held by group: the parameters the
    # tp rules shard (reduce-scattered) and the replicated ones (psum'd)
    sgd = {}
    for on_mesh in (False, True):
        m, _ = mesh_bert(torch)
        if not on_mesh:
            old = [p.detach().clone() for p in m.parameters()]
        st = make_step(m, on_mesh, SGD(learning_rate=MESH_SGD_LR))
        st(*batch)
        st.sync_params()
        sgd[on_mesh] = m
        del st
    sharded = [getattr(p, "sharding", None) is not None
               and any(a is not None for a in p.sharding)
               for p in sgd[True].parameters()]
    groups = {"tp_sharded": [], "replicated": []}
    for w0, new, want, sh in zip(old, sgd[True].parameters(),
                                 sgd[False].parameters(), sharded):
        groups["tp_sharded" if sh else "replicated"].append(
            (w0, new.detach(), want.detach()))
    spread = update_spread(torch, groups)
    out["float32"]["sgd_update_rel_diff"] = spread
    out["float32"]["sgd_update_tol"] = MESH_SGD_TOL
    emit({"phase": "bert_mesh_a_sgd", "lr": MESH_SGD_LR,
          "groups": {k: len(v) for k, v in groups.items()},
          "update_rel_diff": spread, "tol": MESH_SGD_TOL})
    require(all(groups.values()), f"an empty group: "
            f"{ {k: len(v) for k, v in groups.items()} }")
    require(max(spread.values()) <= MESH_SGD_TOL, f"the mesh SGD update "
            f"differs from the single device's by {spread} (relative)")
    del sgd, old, groups
    release_device(torch)

    # (a) bfloat16 with float32 masters, for time: mesh against single
    per_shard[:] = [0] * n_sp
    m16, _ = mesh_bert(torch, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    mstep = make_step(m16, True)
    fa.reset_launches()
    opnn.local_attention = counted
    try:
        first = float(mstep(*batch))
        mesh_ms, rest = timed_steps(torch, mstep, batch, steps - 1)
    finally:
        opnn.local_attention = local_attention
    launches16 = dict(fa.LAUNCHES)
    calls16 = list(per_shard)
    mesh_peak = torch.cuda.max_memory_allocated() / 1e9
    out["shard_check"]["bfloat16"] = shard_attention_check(
        torch, fa, local_attention, first_call.pop(torch.bfloat16))
    emit({"phase": "bert_mesh_a_shard_bfloat16",
          **out["shard_check"]["bfloat16"]})
    losses16 = [first] + rest
    comm = par.comm.bytes_by_kind(mstep)
    report = par.comm_report(mstep)
    mesh_trace = trace_step(torch, mstep, batch)
    del mstep, m16
    release_device(torch)
    s16, _ = mesh_bert(torch, torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    sstep = make_step(s16, False)
    sstep(*batch)
    single_ms, _ = timed_steps(torch, sstep, batch, steps - 1)
    single_peak = torch.cuda.max_memory_allocated() / 1e9
    single_trace = trace_step(torch, sstep, batch)
    del sstep, s16
    release_device(torch)
    rel16 = [abs(a - b) / abs(b) for a, b in zip(losses16, got)]

    def host_share(tr):
        dev = tr.get("device_ms")
        return "not measured" if dev is None else \
            1.0 - dev / (tr["wall_s"] * 1e3)

    out["bfloat16"] = {
        "losses": losses16, "rel_to_float32_mesh": rel16, "tol": 1e-2,
        "mesh_ms_per_step": mesh_ms, "single_ms_per_step": single_ms,
        "mesh_over_single": mesh_ms / single_ms,
        "mesh_peak_memory_gb": mesh_peak,
        "single_peak_memory_gb": single_peak,
        "mesh_trace": {k: mesh_trace.get(k) for k in (
            "wall_s", "device_ms", "device_busy_share", "cuda_launches",
            "device_ms_by_class")},
        "single_trace": {k: single_trace.get(k) for k in (
            "wall_s", "device_ms", "device_busy_share", "cuda_launches",
            "device_ms_by_class")},
        "mesh_host_share": host_share(mesh_trace),
        "single_host_share": host_share(single_trace),
        "launches": launches16, "ulysses_calls_by_sp_shard": calls16,
        "comm_bytes_by_kind": {k: {"payload": p, "ring_wire": w}
                               for k, (p, w) in comm.items()},
        "comm_report": report.splitlines()}
    emit({"phase": "bert_mesh_a_bfloat16", **out["bfloat16"]})
    require(all(np.isfinite(losses16)), f"non-finite losses {losses16}")
    require(max(rel16) <= 1e-2, f"bfloat16 mesh losses {losses16} differ "
            f"from the float32 mesh run's {got} by {rel16}")
    fwd16, bwd16 = FAMILY_KEYS["tensor_core"]
    require(min(calls16) > 0 and launches16[fwd16] == sum(calls16)
            and launches16[bwd16] == sum(calls16),
            f"bfloat16 mesh steps launched {launches16} for Ulysses calls "
            f"{calls16} by sp shard")
    for kind in ("all_to_all", "all_reduce", "reduce_scatter",
                 "all_gather"):
        require(comm.get(kind, (0, 0))[0] > 0,
                f"no {kind} bytes in the mesh step: {comm}")
    out["launches_bf16"] = launches16

    out["compression"] = mesh_compression(torch, par, TrainStep, AdamW,
                                          SoftmaxCrossEntropyLoss, fa)
    out["kvstore"] = mesh_kvstore(torch)
    out["pipeline"] = mesh_pipeline(torch, par, fa)
    out["moe"] = mesh_moe(torch, par)
    out["seconds"] = time.perf_counter() - t_phase
    emit({"phase": "bert_mesh", **{k: v for k, v in out.items()
                                   if k not in ("float32", "bfloat16")}})
    return out


def mesh_compression(torch, par, TrainStep, AdamW, Loss, fa):
    """(b) BERT-base (bfloat16, masters, dropout 0) on a dp 2 mesh,
    MESH_COMP["steps"] steps with compression='2bit' and without, from
    the same weights on the same batch."""
    from mxnet_tpu_torch import rng
    cfg = MESH_COMP
    mesh = par.make_mesh(dp=2, devices=mesh_devices(2))
    runs = {}
    for comp in ("2bit", None):
        model, bcfg = mesh_bert(torch, torch.bfloat16, dropout=0.0)
        batch, _ = bert_batch(torch, bcfg, **BERT_TRAFFIC)
        rng.seed(0)
        step = TrainStep(model, Loss(), AdamW(learning_rate=MESH_MAIN["lr"],
                                              wd=0.01),
                         mesh=mesh, n_net_inputs=4, compression=comp,
                         compression_threshold=cfg["threshold"])
        t0 = time.perf_counter()
        losses = [float(step(*batch)) for _ in range(cfg["steps"])]
        dt = (time.perf_counter() - t0) / cfg["steps"] * 1e3
        n_params = sum(p.numel() for p in step._params)
        rows = step.last_collectives
        if comp:
            wire = sum(r["bytes"] // r["group"] for r in rows
                       if r["kind"] == "all_gather")
            residual = float(sum(r.abs().sum() for r in step._residuals))
        else:
            wire = sum(r["bytes"] for r in rows if r["kind"] == "all_reduce"
                       and r["bytes"] > 4)
            residual = None
        runs[comp or "none"] = {"losses": losses, "ms_per_step": dt,
                                "wire_bytes_per_shard": wire,
                                "float32_grad_bytes": n_params * 4,
                                "residual_abs_sum": residual}
        del step, model
        release_device(torch)
    c, u = runs["2bit"], runs["none"]
    ratio = c["wire_bytes_per_shard"] / c["float32_grad_bytes"]
    res = {"threshold": cfg["threshold"], "steps": cfg["steps"],
           "compressed": c, "uncompressed": u, "wire_ratio": ratio}
    emit({"phase": "bert_mesh_b_2bit", **res})
    require(all(np.isfinite(c["losses"])), f"non-finite {c['losses']}")
    require(c["losses"][-1] < c["losses"][0],
            f"the 2-bit run did not train: {c['losses']}")
    require(u["losses"][-1] < c["losses"][-1] + 1e-3,
            f"the uncompressed run ended at {u['losses'][-1]}, above the "
            f"2-bit run's {c['losses'][-1]} + 1e-3")
    require(1 / 16 <= ratio <= 1 / 16 * 1.001, f"the 2-bit wire moves "
            f"{ratio} of float32's gradient bytes, not 1/16")
    require(c["residual_abs_sum"] > 0, "no error-feedback residual")
    return res


def mesh_kvstore(torch):
    """(c) create("nccl"), and a one-rank NCCL dist_sync group formed
    from init_distributed's env: pushpull keeps the value; a gluon
    Trainer(kvstore="dist_sync") step on BERT-base (float32, dropout 0)
    equals a kvstore="device" step to the bit."""
    import socket

    import torch.distributed as dist

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import gluon
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"DMLC_PS_ROOT_URI": "127.0.0.1", "DMLC_PS_ROOT_PORT": str(port),
           "DMLC_NUM_WORKER": "1", "DMLC_WORKER_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        r = np.random.default_rng(0)
        v = mx.nd.array(r.standard_normal((4, 1024)).astype(np.float32))
        local = mx.kv.create("nccl")
        local.init("w", mx.nd.zeros((4, 1024)))
        o = mx.nd.zeros((4, 1024))
        local.pushpull("w", v, out=o)
        require(np.array_equal(o.asnumpy(), v.asnumpy()),
                "create('nccl') pushpull changed the value")
        store = mx.kv.create("dist_sync")
        backend = str(dist.get_backend())
        require(store._group and store.num_workers == 1,
                "the dist_sync group did not form")
        store.init("w", mx.nd.zeros((4, 1024)))
        o2 = mx.nd.zeros((4, 1024))
        store.pushpull("w", v, out=o2)
        require(np.array_equal(o2.asnumpy(), v.asnumpy()),
                "the one-rank NCCL pushpull changed the value")
        lfn = gluon.loss.SoftmaxCrossEntropyLoss()
        result = {}
        for kind in ("dist_sync", "device"):
            net, cfg = gluon_bert(mx, dropout=0.0, attention_dropout=0.0)
            batch, _ = bert_batch(torch, cfg, **BERT_TRAFFIC)
            tr = gluon.Trainer(net.collect_params(), "adamw",
                               {"learning_rate": MESH_MAIN["lr"],
                                "wd": 0.01}, kvstore=kind)
            t0 = time.perf_counter()
            loss = gluon_steps(mx, net, tr, lfn, batch, 1)
            dt = time.perf_counter() - t0
            result[kind] = (loss, [p.data()._data.detach().clone()
                                   for p in net.collect_params().values()],
                            dt, tr._kvstore is not None)
            del net, tr
            release_device(torch)
        (ls, ps, dts, on_kv), (ld, pd, dtd, _) = result["dist_sync"], \
            result["device"]
        equal = all(torch.equal(a, b) for a, b in zip(ps, pd))
        res = {"backend": backend, "nccl_pushpull_equal": True,
               "trainer_loss": ls, "device_loss": ld,
               "trainer_step_s": dts, "device_step_s": dtd,
               "trainer_used_kvstore": on_kv, "params_equal": equal,
               "params": len(ps)}
        emit({"phase": "bert_mesh_c_kvstore", **res})
        require(on_kv, "Trainer(kvstore='dist_sync') kept no store")
        require(equal and ls == ld, "the dist_sync Trainer step differs "
                "from the kvstore='device' step")
        return res
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


def mesh_pipeline(torch, par, fa):
    """(d) GPT-2 774M width cut to MESH_PP["layers"] layers, split by
    gpt2_pp_functions into 2 stages on a pp 2 mesh, 4 microbatches:
    one PPTrainStep SGD step under each schedule against the model's
    own forward and backward on the same weights (float32, TF32 off):
    the loss, and the parameters after the step against the single
    device's SGD update, by group (embeddings with the tied wte, each
    stage's blocks, the final LayerNorm)."""
    from mxnet_tpu_torch.models import GPT2ForCausalLM, gpt2_774m_config
    from mxnet_tpu_torch.models.gpt2 import gpt2_pp_functions
    from mxnet_tpu_torch.optimizer import SGD
    cell = MESH_PP
    cfg = gpt2_774m_config(num_layers=cell["layers"], dropout=0.0,
                           attention_dropout=0.0)
    model = GPT2ForCausalLM(cfg, device=DEV)
    r = np.random.default_rng(0)
    x = torch.tensor(r.integers(0, cfg.vocab_size, (cell["B"], cell["T"])),
                     dtype=torch.int32, device=DEV)
    y = torch.tensor(r.integers(0, cfg.vocab_size, (cell["B"], cell["T"])),
                     dtype=torch.int32, device=DEV)
    logp = torch.log_softmax(model(x).float(), -1)
    loss = -logp.gather(-1, y.long()[..., None]).mean()
    want = float(loss.detach())
    params = dict(model.named_parameters())
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    del logp, loss
    bb = model.backbone
    names = {id(p): n for n, p in params.items()}
    blocks = bb.blocks()
    k = len(blocks) // cell["stages"]
    fns = gpt2_pp_functions(model, cell["stages"])
    lr = MESH_SGD_LR

    def sgd(t):
        """The single device's SGD update of parameter tensor t."""
        return t.detach() - lr * grads[names[id(t)]]

    def trios(e, b, h):
        """(old, PP's new, single device's new) by group."""
        groups = {"embed": [(bb.word_embed.weight, e["wte"]),
                            (bb.position_embed.weight, e["wpe"])],
                  "head": [(bb.ln_f.gamma, h["g"]), (bb.ln_f.beta, h["b"])]}
        for s in range(cell["stages"]):
            groups[f"stage{s}"] = [
                (p, b[i][n][s]) for i in range(k)
                for n, p in blocks[s * k + i].named_parameters()]
        return {g: [(p.detach(), new, sgd(p)) for p, new in pairs]
                for g, pairs in groups.items()}
    mesh = par.make_mesh(pp=cell["stages"],
                         devices=mesh_devices(cell["stages"]))
    res = {"config": f"gpt2_774m_config(num_layers={cell['layers']})",
           "stages": cell["stages"], "microbatches": cell["micro"],
           "batch": cell["B"], "seq_len": cell["T"],
           "single_device_loss": want, "sgd_lr": lr,
           "update_tol": MESH_SGD_TOL}
    for schedule in ("1f1b", "gpipe"):
        step = par.PPTrainStep(*fns[:6], SGD(learning_rate=lr),
                               cell["micro"], mesh=mesh, schedule=schedule,
                               tied=fns[6])
        fa.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = float(step(x, y))
        dt = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        e, b, h = step.params
        res[schedule] = {"loss": got, "rel_diff": abs(got - want) / want,
                         "step_s": dt, "launches": launches,
                         "collectives": len(step.last_collectives),
                         "update_rel_diff": update_spread(torch,
                                                          trios(e, b, h)),
                         "tied_head_mirrors_embed": bool(torch.equal(
                             h["wte"], e["wte"]))}
        del step, e, b, h
        release_device(torch)
    del model, fns, grads, params
    release_device(torch)
    emit({"phase": "bert_mesh_d_pipeline", **res})
    for schedule in ("1f1b", "gpipe"):
        got = res[schedule]
        require(got["rel_diff"] <= 1e-4, f"PPTrainStep({schedule}) loss "
                f"{got['loss']} against the single device's {want}")
        require(max(got["update_rel_diff"].values()) <= MESH_SGD_TOL,
                f"PPTrainStep({schedule}) parameters after the step differ "
                f"from the single device's SGD update by "
                f"{got['update_rel_diff']} (relative)")
        require(got["tied_head_mirrors_embed"],
                f"PPTrainStep({schedule}): the head's wte is not the "
                "embed's after the step")
        require(got["launches"]["fused_attention_fwd"] > 0
                and got["launches"]["fused_attention_bwd"] > 0,
                f"the {schedule} pipeline launched no fused attention")
    return res


def mesh_moe(torch, par):
    """(e) MoEFFN at BERT-base width (768 -> 3072, 8 experts, top-2),
    float32: 2 TrainStep steps on a dp 2 x ep 2 mesh (ep_rules) against
    the unsharded step from the same weights; with identical experts and
    ample capacity, the dense FFN."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.optimizer import Adam
    cell = MESH_MOE

    def make(**kw):
        net = nn.MoEFFN(cell["units"], cell["hidden"], cell["experts"],
                        top_k=cell["top_k"], **kw)
        mx.random.seed(0)
        net.initialize(mx.init.Normal(0.02), ctx=mx.gpu(0)
                       if DEV == "cuda" else mx.cpu())
        return net

    r = np.random.default_rng(0)
    shape = (cell["B"], cell["T"], cell["units"])
    x = torch.tensor(r.standard_normal(shape), dtype=torch.float32,
                     device=DEV)
    y = torch.tensor(r.standard_normal(shape) * 0.02, dtype=torch.float32,
                     device=DEV)
    single, sharded = make(), make()
    par.apply_sharding_rules(sharded, par.ep_rules())
    mesh = par.make_mesh(dp=2, ep=2, devices=mesh_devices(4))
    s1 = par.TrainStep(single, gloss.L2Loss(), Adam(learning_rate=1e-3))
    s2 = par.TrainStep(sharded, gloss.L2Loss(), Adam(learning_rate=1e-3),
                       mesh=mesh, batch_specs=(par.PartitionSpec("dp"),
                                               par.PartitionSpec("dp")))
    want = [float(s1(x, y)) for _ in range(2)]
    got = [float(s2(x, y)) for _ in range(2)]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    largest, median = param_spread(torch, single, sharded)
    blocks = len(next(mp for mp in s2.mesh_params
                      if mp.name == "expert_w1").devices)
    del s1, s2, single, sharded
    # identical experts, capacity for every token: the dense FFN
    dense_net = make(capacity_factor=cell["experts"] / cell["top_k"])
    params = dense_net.collect_params()
    with torch.no_grad():
        for name in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
            t = params[name].data()._data
            if "_b" in name:
                t.normal_(0.0, 0.02)
            t[1:].copy_(t[:1].expand_as(t[1:]))
        xs = x[:cell["dense_B"]]
        out = dense_net(xs)
        w = {n: params[n].data()._data for n in params}
        h = torch.nn.functional.gelu(xs @ w["expert_w1"][0]
                                     + w["expert_b1"][0], approximate="tanh")
        dense = h @ w["expert_w2"][0] + w["expert_b2"][0]
        dense_err = float((out - dense).abs().max() / dense.abs().max())
    del dense_net
    release_device(torch)
    res = {"units": cell["units"], "hidden": cell["hidden"],
           "experts": cell["experts"], "top_k": cell["top_k"],
           "tokens": cell["B"] * cell["T"], "mesh": {"dp": 2, "ep": 2},
           "single_losses": want, "mesh_losses": got, "loss_rel_diff": rel,
           "param_diff_largest": largest, "param_diff_median": median,
           "expert_w1_positions": blocks, "dense_rel_err": dense_err}
    emit({"phase": "bert_mesh_e_moe", **res})
    require(max(rel) <= 1e-5, f"ep-sharded MoE losses {got} against {want}")
    require(largest <= 3e-3, f"ep-sharded MoE weights {largest} apart")
    require(blocks == 4, "expert_w1 is not stored over the 4 positions")
    require(dense_err <= 1e-5, f"identical experts {dense_err} from the "
            "dense FFN")
    return res


# ---------------------------------------------------------------------------
# phase 7h: the 'flash' route at bench_longcontext's shape
# ---------------------------------------------------------------------------

def phase_flash(torch, F, fa):
    """dot_product_attention(impl="flash") at bench_longcontext's cell
    (FLASH_CELL: causal, B 1, H 12, T 8192, D 64, bfloat16, BHTD): the
    route launches the tensor-core fused forward and backward once each
    and gives the same bits as the fused call; fused_case holds the
    kernel to its plain version there (forward and gradients within
    BF16_REL_TOL) and times kernel, plain and SDPA, forward and
    backward, beside the bound."""
    from mxnet_tpu_torch.ops import nn as ops
    c = FLASH_CELL
    B, H, T, D = c["B"], c["H"], c["T"], c["D"]
    out = {"phase": "flash", "shape": dict(c, causal=True,
                                           dtype="bfloat16", layout="BHTD")}
    g = torch.Generator(device=DEV).manual_seed(5)
    q, k, v, do = (torch.randn(B, H, T, D, device=DEV, generator=g,
                               dtype=torch.bfloat16) for _ in range(4))
    q, k, v = (x.requires_grad_(True) for x in (q, k, v))
    fa.reset_launches()
    o = ops.dot_product_attention(q, k, v, causal=True, impl="flash")
    grads = torch.autograd.grad(o, (q, k, v), do)
    launches = dict(fa.LAUNCHES)
    want = {k_: (1 if k_ in FAMILY_KEYS["tensor_core"] else 0)
            for k_ in launches}
    require(launches == want, f"impl='flash' launched {launches}")
    o2 = fa.fused_attention(q, k, v, causal=True)
    grads2 = torch.autograd.grad(o2, (q, k, v), do)
    require(torch.equal(o, o2) and all(torch.equal(a, b) for a, b in
                                       zip(grads, grads2)),
            "impl='flash' differs from the fused call")
    out["launches"] = launches
    del o, o2, grads, grads2, q, k, v, do
    torch.cuda.empty_cache()
    r = fused_case(torch, F, fa, B, H, T, T, D, "BHTD", True, 0.0, None,
                   torch.bfloat16, seed=60, timed=True)
    require(r["route"] == "tensor_core", f"flash cell routed {r['route']}")
    out["bfloat16"] = r
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7b: GPT-2 774M's training forward (cache=None) and backward
# ---------------------------------------------------------------------------

def phase_gpt2_train(torch, fa, card):
    """One forward and backward of GPT-2 774M's causal LM loss at full
    width (GPT2_TRAIN_LAYERS of its 36 layers) on the cache=None path,
    B = 2, T = 1024, dropout and attention dropout 0.1 (train() mode),
    float32 and bfloat16: the kernel path
    (attention_impl "auto") against the plain path ("torch") from the
    same weights and the same dropout generator. Each kernel pass must
    launch its family's fused forward and backward once a layer and
    nothing else; then the kernel path's forward and backward timed, and
    once more under the profiler."""
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, gpt2_774m_config,
                                        init_params)
    B, T = GPT2_TRAIN["B"], GPT2_TRAIN["T"]
    out = {"phase": "gpt2_train", "card": card,
           "config": f"gpt2_774m_config(num_layers={GPT2_TRAIN_LAYERS})",
           "batch": B, "seq_len": T, "dropout": 0.1}

    def make(dtype, impl):
        require(gpt2_774m_config().num_layers == GPT2_LAYERS,
                "774M config changed")
        cfg = gpt2_774m_config(num_layers=GPT2_TRAIN_LAYERS, dropout=0.1,
                               attention_dropout=0.1, attention_impl=impl,
                               dtype=dtype)
        model = init_params(GPT2ForCausalLM(cfg, device=DEV), seed=0,
                            std=0.02)
        model.train()
        return model, cfg

    def fwd_bwd(model, ids):
        """The next-token loss (float32 logits) and its backward, dropout
        drawn from a fixed generator; wall ms, ending in a device sync."""
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with rng.generator_scope(rng.step_generator(0, 1, DEV)):
            logits = model(ids)
            loss = SoftmaxCrossEntropyLoss()(logits[:, :-1].float(),
                                             ids[:, 1:]).mean()
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), (time.perf_counter() - t0) * 1e3

    ids = None
    for dtype, family, tol in (("float32", "cuda_core", 1e-5),
                               ("bfloat16", "tensor_core",
                                BF16_MODEL_LOSS_TOL)):
        res = {}
        for impl in ("auto", "torch"):
            model, cfg = make(dtype, impl)
            if ids is None:
                ids = torch.tensor(np.random.default_rng(0).integers(
                    0, cfg.vocab_size, (B, T)), dtype=torch.int64,
                    device=DEV)
            fa.reset_launches()
            loss, ms = fwd_bwd(model, ids)
            launches = dict(fa.LAUNCHES)
            want = {k: (GPT2_TRAIN_LAYERS if impl == "auto"
                        and k in FAMILY_KEYS[family] else 0)
                    for k in launches}
            require(launches == want, f"gpt2_train {dtype} impl={impl}: "
                    f"launches {launches}, not {want}")
            grads_ok = all(p.grad is not None
                           and bool(torch.isfinite(p.grad).all())
                           for p in model.parameters())
            require(np.isfinite(loss) and grads_ok,
                    f"gpt2_train {dtype} impl={impl}: non-finite loss "
                    f"{loss} or gradients")
            r = {"loss": loss, "first_ms": ms, "launches": launches}
            if impl == "auto":
                r["ms"] = [fwd_bwd(model, ids)[1] for _ in range(3)]
                r["median_ms"] = float(np.median(r["ms"]))
                r["trace"] = profiled(
                    torch, lambda: fwd_bwd(model, ids)[1] / 1e3, 10)
            res[impl] = r
            del model
            torch.cuda.empty_cache()
        rel = abs(res["auto"]["loss"] - res["torch"]["loss"]) \
            / abs(res["torch"]["loss"])
        require(rel <= tol, f"gpt2_train {dtype}: losses "
                f"{res['auto']['loss']} and {res['torch']['loss']} differ "
                f"by {rel} relative, over {tol}")
        out[dtype] = {"kernel": res["auto"], "plain": res["torch"],
                      "loss_rel_diff": rel, "loss_tol": tol}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7c: ResNet-50 v1b training through TrainStep
# ---------------------------------------------------------------------------

def resnet_step_flops(torch, net, S):
    """3 x 2 x the multiply-adds of every convolution and Dense at an
    S x S input, read from the modules' shapes by one forward of one
    image (forward, and a backward of twice the forward's work). Any
    convolutional net of the zoo (ResNet, SSD)."""
    from mxnet_tpu_torch.nn import Conv2D, Dense
    macs = []

    def hook(mod, inp, out):
        w = mod.weight
        if isinstance(mod, Conv2D):          # each output element: I/g*kH*kW
            macs.append(out[0].numel() * w[0].numel())
        else:
            macs.append(out[0].numel() * w.shape[1])
    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, (Conv2D, Dense))]
    was = net.training
    net.eval()
    w = next(net.parameters())
    with torch.no_grad():
        net(torch.zeros(1, 3, S, S, device=w.device, dtype=w.dtype))
    net.train(was)
    for h in hooks:
        h.remove()
    return 6 * sum(macs), len(macs)


RESNET_CLASSES = ("conv", "batch_norm", "pooling", "optimizer")


def resnet_profile(torch, step, batch, kernels_of=None):
    """One training step, step(*batch), under torch.profiler. Every
    kernel's device time goes to a class: the forward ops of the port's
    convolution, batch_norm and pooling run inside profiler ranges of
    those names
    (ops.nn wrapped for the window), their backward ops are matched to
    the forward op by autograd sequence number, the optimizer's update
    runs in a range of its own; the rest (ReLU, residual adds, the
    Dense, the loss, casts) is "other". Returns the busy share, CUDA
    launches, device ms and kernel count by class, and the top
    kernels. `kernels_of(event)` lists an event's (name, us) kernels
    (default: its CUDA kernels)."""
    if kernels_of is None:
        def kernels_of(e):
            return [(k.name, k.duration) for k in e.kernels]
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.ops import nn as ops
    saved = {name: getattr(ops, name) for name in
             ("convolution", "batch_norm", "pooling")}

    def ranged(label, fn):
        def wrapped(*a, **k):
            with record_function("resnet/" + label):
                return fn(*a, **k)
        return wrapped
    for name, fn in saved.items():
        setattr(ops, name, ranged({"convolution": "conv"}.get(name, name),
                                  fn))
    update = step._update
    step._update = ranged("optimizer", update)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            loss = step(*batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
        del step._update
    events = prof.events()

    def range_of(e):
        while e is not None:
            if e.name.startswith("resnet/"):
                return e.name[len("resnet/"):]
            e = e.cpu_parent
        return None

    def backward_root(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function"):
                return e
            e = e.cpu_parent
        return None
    by_seq = {}
    for e in events:
        if e.sequence_nr >= 0 and backward_root(e) is None:
            label = range_of(e)
            if label is not None:
                by_seq.setdefault(e.sequence_nr, label)
    ms = {c: 0.0 for c in RESNET_CLASSES + ("other",)}
    count = {c: 0 for c in ms}
    top = {}
    launches = 0
    for e in events:
        if e.name.startswith(("cudaLaunch", "cuLaunch")):
            launches += 1
        kernels = kernels_of(e)
        if not kernels:
            continue
        label = range_of(e)
        if label is None:
            root = backward_root(e)
            label = by_seq.get(root.sequence_nr) if root is not None \
                else None
        label = label or "other"
        for name, us in kernels:
            ms[label] += us / 1e3
            count[label] += 1
            top[name] = top.get(name, 0.0) + us / 1e3
    dev_ms = sum(ms.values())
    if not dev_ms:
        return {"wall_s": wall, "device_busy_share": "not measured",
                "cuda_launches": launches, "loss": float(loss)}
    return {"wall_s": wall, "device_ms": dev_ms,
            "device_busy_share": dev_ms / (wall * 1e3),
            "cuda_launches": launches, "loss": float(loss),
            "device_ms_by_class": ms, "kernels_by_class": count,
            "top_kernels": [{"name": k[:90], "ms": t} for k, t in
                            sorted(top.items(), key=lambda kv: -kv[1])[:10]]}


def resnet_gate(got, want, want_ulps, fixed):
    """(distance, spread, gate): |got - want| and the spread, the largest
    |want_ulp - want| over the perturbed runs `want_ulps`, each over
    |want|'s largest element; the gate is the larger of `fixed` and
    RESNET_SPREAD_FACTOR times the spread."""
    top = max(float(np.abs(want).max()), 1e-30)
    d = float(np.abs(got - want).max()) / top
    spread = max(float(np.abs(w - want).max()) for w in want_ulps) / top
    return d, spread, max(fixed, RESNET_SPREAD_FACTOR * spread)


def resnet_parity(torch, vision, TrainStep, SGD, Loss):
    """(a) resnet50_v1b(classes=100), B = 8, 64x64, float32: Xavier
    weights drawn once on the CPU (seed 0) and copied to the card; one
    eval-mode forward, then two TrainStep steps of SGD(0.01, 0.9, 1e-4)
    on the same batch, on the card and twice on the CPU (x, and x one
    ulp up: the spread). Every logit, loss, parameter and running
    statistic gated by resnet_gate."""
    c = RESNET_PARITY
    rng = np.random.default_rng(0)
    x = rng.standard_normal((c["B"], 3, c["S"], c["S"])).astype(np.float32)
    y = rng.integers(0, c["classes"], (c["B"],)).astype(np.int32)
    weights = {n: p.detach().clone() for n, p in vision.resnet50_v1b(
        classes=c["classes"], device="cpu").named_parameters()}

    def run(device, images):
        net = vision.resnet50_v1b(classes=c["classes"], device=device)
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(weights[n])
        xb = torch.from_numpy(images).to(device)
        yb = torch.from_numpy(y).to(device)
        with torch.no_grad():
            logits = net(xb).cpu().numpy()
        step = TrainStep(net, Loss(), SGD(learning_rate=0.01, momentum=0.9,
                                          wd=1e-4))
        losses = step.run_steps(xb, yb, steps=c["steps"]).cpu().numpy()
        state = {n: p.detach().cpu().numpy()
                 for n, p in net.named_parameters()}
        return logits, losses, state
    t0 = time.perf_counter()
    cpu = run("cpu", x)
    cpu_ulp = run("cpu", x * np.float32(1 + 2 ** -23))
    cpu_s = time.perf_counter() - t0
    card = run(DEV, x)
    rows = {"eval_logits": resnet_gate(card[0], cpu[0], [cpu_ulp[0]],
                                       1e-5)}
    for i in range(c["steps"]):
        rows[f"loss_{i}"] = resnet_gate(card[1][i:i + 1], cpu[1][i:i + 1],
                                        [cpu_ulp[1][i:i + 1]], 1e-5)
    for n, w in cpu[2].items():
        rows[n] = resnet_gate(card[2][n], w, [cpu_ulp[2][n]], 1e-4)
    over = sorted(n for n, (d, _, g) in rows.items() if d > g)
    finite = all(np.isfinite(v).all() for v in card[2].values())
    ratio = [d / max(s, 1e-30) for d, s, _ in rows.values()]
    worst = max(rows, key=lambda n: rows[n][0] / rows[n][2])
    out = {"config": dict(c, model="resnet50_v1b", optimizer="SGD(0.01, "
                          "momentum 0.9, wd 1e-4)", tf32=False),
           "losses_card": card[1].tolist(), "losses_cpu": cpu[1].tolist(),
           "losses_cpu_ulp": cpu_ulp[1].tolist(),
           "eval_logits": rows["eval_logits"],
           "losses": {k: v for k, v in rows.items()
                      if k.startswith("loss_")},
           "tensors": len(cpu[2]), "worst": worst,
           "worst_dist_spread_gate": rows[worst],
           "largest_dist": max(d for d, _, _ in rows.values()),
           "median_dist_over_spread": float(np.median(ratio)),
           "spread_factor": RESNET_SPREAD_FACTOR, "over_gate": over,
           "cpu_seconds_two_runs": cpu_s}
    require(finite, "resnet50 parity: non-finite parameters on the card")
    require(not over, f"resnet50 parity: card against CPU over the gate "
            f"for {over[:8]} ({len(over)}): worst {worst} {rows[worst]}")
    return out


def phase_resnet50(torch, card):
    """ResNet-50 v1b training through the port's TrainStep: (a) float32
    parity of the card against the CPU; (b) a bfloat16 training
    forward's loss against float32 at full size; (c) bench_resnet50's
    configuration timed, profiled and counted, and the float32 step."""
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss as Loss
    from mxnet_tpu_torch.models import vision
    from mxnet_tpu_torch.optimizer import SGD
    from mxnet_tpu_torch.parallel import TrainStep
    out = {"phase": "resnet50", "card": card,
           "cudnn_benchmark": bool(torch.backends.cudnn.benchmark),
           "layout": "NCHW"}
    out["parity_f32"] = resnet_parity(torch, vision, TrainStep, SGD, Loss)
    release_device(torch)

    # (b) one training forward in bfloat16 and in float32, same weights
    c = RESNET_BF16
    gen = torch.Generator(device=DEV).manual_seed(1)
    x = torch.randn(c["B"], 3, c["S"], c["S"], device=DEV, generator=gen)
    y = torch.randint(0, c["classes"], (c["B"],), device=DEV, generator=gen,
                      dtype=torch.int32)
    losses = {}
    for dtype in (torch.float32, torch.bfloat16):
        net = vision.resnet50_v1b(classes=c["classes"], device=DEV).to(dtype)
        net.train()
        with torch.no_grad():
            logits = net(x.to(dtype))
            losses[str(dtype)[6:]] = float(Loss()(logits.float(), y).mean())
        del net, logits
    rel = abs(losses["bfloat16"] - losses["float32"]) \
        / abs(losses["float32"])
    out["bf16_vs_f32"] = dict(c, losses=losses, loss_rel_diff=rel,
                              tol=RESNET_BF16_LOSS_TOL)
    require(rel <= RESNET_BF16_LOSS_TOL, f"resnet50 bfloat16 loss "
            f"{losses['bfloat16']} against float32 {losses['float32']}: "
            f"{rel} relative, over {RESNET_BF16_LOSS_TOL}")
    del x, y
    release_device(torch)

    # (c) bench_resnet50: bfloat16, SGD(0.1, 0.9, 1e-4), B = 256
    c = RESNET_BENCH
    out["bench"] = {"card": card, "config": dict(
        c, model="resnet50_v1b", dtype="bfloat16", init="Xavier(seed 0)",
        optimizer="SGD(0.1, momentum 0.9, wd 1e-4)")}
    for dtype, B in ((torch.bfloat16, c["B"]),
                     (torch.float32, RESNET_F32_BATCH)):
        res = {"batch": B}
        net = vision.resnet50_v1b(classes=c["classes"], device=DEV).to(dtype)
        flops, layers = resnet_step_flops(torch, net, c["S"])
        gen = torch.Generator(device=DEV).manual_seed(0)
        x = torch.randn(B, 3, c["S"], c["S"], device=DEV,
                        generator=gen).to(dtype)
        y = torch.randint(0, c["classes"], (B,), device=DEV, generator=gen,
                          dtype=torch.int32)
        step = TrainStep(net, Loss(), SGD(learning_rate=0.1, momentum=0.9,
                                          wd=1e-4))
        torch.cuda.reset_peak_memory_stats()
        warm = step.run_steps(x, y, steps=c["warmup"])
        steps = c["steps"] if dtype == torch.bfloat16 else 3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.run_steps(x, y, steps=steps)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        losses = warm.tolist() + losses.tolist()
        stats = [p for n, p in net.named_parameters()
                 if n.endswith(("running_mean", "running_var"))]
        require(len(stats) == 106, "resnet50: running statistics missing")
        res.update({
            "losses": losses, "ms_per_step": dt * 1e3,
            "img_per_s": B / dt, "step_flops": flops * B,
            "flops_note": f"3 x 2 x multiply-adds of the {layers - 1} "
                          f"convolutions and the Dense at {c['S']}x{c['S']}; "
                          "bench.py's analytic fallback 3 x 3.8e9 x B "
                          "counts each multiply-add once",
            "bench_fallback_flops": 3 * 3.8e9 * B, "mac_layers": layers,
            "achieved_tflops": flops * B / dt / 1e12,
            "mfu": flops * B / dt / PEAK_FLOPS["bfloat16"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        require(all(np.isfinite(losses)), f"resnet50 {dtype}: non-finite "
                f"losses {losses}")
        require(all(bool(torch.isfinite(p).all()) for p in stats),
                f"resnet50 {dtype}: non-finite running statistics")
        if dtype == torch.bfloat16:
            res["trace"] = resnet_profile(torch, step, (x, y))
            require(np.isfinite(res["trace"]["loss"]), "resnet50: non-finite "
                    f"loss {res['trace']['loss']} in the profiled step")
            out["bench"]["bfloat16"] = res
        else:
            out["bench"]["float32"] = res
        del step, net, x, y
        release_device(torch)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phase 7c2: SSD-512 training and detection
# ---------------------------------------------------------------------------

def ssd_example_labels():
    """examples/train_ssd.py's labels: two images, up to two boxes."""
    labels = np.full((2, 2, 5), -1.0, np.float32)
    labels[0, 0] = [5, 0.2, 0.3, 0.6, 0.8]
    labels[1, 0] = [2, 0.5, 0.5, 0.9, 0.85]
    labels[1, 1] = [7, 0.05, 0.05, 0.3, 0.3]
    return labels


def ssd_synthetic_labels(B, max_boxes, classes, seed=0):
    """(B, max_boxes, 5) rows [class, x1, y1, x2, y2] in [0, 1]: 1 to
    max_boxes boxes an image (sides 0.1-0.5), the rest -1."""
    r = np.random.default_rng(seed)
    labels = np.full((B, max_boxes, 5), -1.0, np.float32)
    for b in range(B):
        n = int(r.integers(1, max_boxes + 1))
        wh = r.uniform(0.1, 0.5, (n, 2))
        xy = r.uniform(0.0, 1.0 - wh)
        labels[b, :n, 0] = r.integers(0, classes, n)
        labels[b, :n, 1:3] = xy
        labels[b, :n, 3:5] = xy + wh
    return labels


def ssd_loss_class(SSDMultiBoxLoss):
    """The loss TrainStep calls with the net's three outputs (anchors
    unused) and the targets, as examples/train_ssd.py's _Loss."""
    class Loss(SSDMultiBoxLoss):
        def forward(self, cls_p, box_p, anchors, ct, bt, bm):
            return super().forward(cls_p, box_p, ct, bt, bm)
    return Loss


def ssd_parity(torch, vision, det, TrainStep, SGD, Loss):
    """(a) ssd_512_resnet50_v1_voc, float32, examples/train_ssd.py's two
    images and labels at SSD_PARITY's size: Xavier weights drawn once on
    the CPU and copied to the card. Eval mode: anchors byte-equal;
    targets (multibox_target on each device): class targets and masks
    equal, box targets within 2 ulps (the log-size columns: CUDA's logf
    and the CPU's log differ in the last place); predictions within 1e-5
    of their largest; the loss within 1e-5 relative; detect (the card's
    NMS kernel, the CPU's plain version) keeps the same rows with the
    same class ids, scores and boxes within 1e-5. Then three TrainStep
    steps on each device (the CPU also on the perturbed images) under
    the spread gate."""
    c = SSD_PARITY
    rng = np.random.default_rng(0)
    x = rng.standard_normal((c["B"], 3, c["S"], c["S"])).astype(np.float32)
    labels = ssd_example_labels()
    weights = {n: p.detach().clone() for n, p in
               vision.ssd_512_resnet50_v1_voc(device="cpu").named_parameters()}

    def run(device, images, full=True):
        net = vision.ssd_512_resnet50_v1_voc(device=device)
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(weights[n])
        xb = torch.from_numpy(images).to(device)
        res = {}
        with torch.no_grad():
            cls, box, anchors = net(xb)
        bt, bm, ct = det.multibox_target(
            anchors, torch.from_numpy(labels).to(device), cls.transpose(1, 2))
        if full:
            with torch.no_grad():
                loss = Loss()(cls, box, anchors, ct, bt, bm)
            dets = net.detect(xb, **SSD_DETECT)
            res.update({k: v.cpu().numpy() for k, v in dict(
                cls=cls, box=box, anchors=anchors, bt=bt, bm=bm, ct=ct,
                loss=loss, dets=dets).items()})
        step = TrainStep(net, Loss(), SGD(learning_rate=c["lr"],
                                          momentum=0.9))
        res["losses"] = step.run_steps(xb, ct, bt, bm,
                                       steps=c["steps"]).cpu().numpy()
        res["state"] = {n: p.detach().cpu().numpy()
                        for n, p in net.named_parameters()}
        return res
    t0 = time.perf_counter()
    cpu = run("cpu", x)
    cpu_ulps = [run("cpu", x * np.float32(u), full=False) for u in SSD_ULPS]
    cpu_s = time.perf_counter() - t0
    card = run(DEV, x)
    out = {"config": dict(c, model="ssd_512_resnet50_v1_voc",
                          optimizer=f"SGD({c['lr']}, momentum 0.9)",
                          tf32=False, anchors=int(cpu["anchors"].shape[1]),
                          labels="examples/train_ssd.py"),
           "cpu_seconds_three_runs": cpu_s}
    require(card["anchors"].tobytes() == cpu["anchors"].tobytes(),
            "ssd512 parity: anchors differ between the card and the CPU")
    for k in ("ct", "bm"):
        require(np.array_equal(card[k], cpu[k]),
                f"ssd512 parity: {k} differs between the card and the CPU")
    g = card["bt"].reshape(*card["ct"].shape, 4)
    w = cpu["bt"].reshape(*cpu["ct"].shape, 4)
    ulps = np.abs(g.view(np.int32).astype(np.int64)
                  - w.view(np.int32).astype(np.int64))
    out["targets"] = {"positives": int((cpu["ct"] > 0).sum()),
                      "box_target_max_ulps": int(ulps.max()),
                      "box_target_elements_apart": int((ulps > 0).sum()),
                      "center_columns_equal": bool(
                          (ulps[..., :2] == 0).all())}
    require(ulps[..., :2].max() == 0 and ulps.max() <= 2,
            f"ssd512 parity: box targets apart {out['targets']}")
    rows = {}
    for k in ("cls", "box"):
        top = max(float(np.abs(cpu[k]).max()), 1e-30)
        rows[k] = float(np.abs(card[k] - cpu[k]).max()) / top
    rows["loss"] = float(np.abs(card["loss"] - cpu["loss"]).max()
                         / np.abs(cpu["loss"]).max())
    out["eval"] = rows
    require(max(rows.values()) <= 1e-5, f"ssd512 parity: eval forward or "
            f"loss over 1e-5: {rows}")
    kd, kc = card["dets"], cpu["dets"]
    out["detect"] = {"rows_kept": int((kc[..., 0] >= 0).sum()),
                     "same_rows": bool(np.array_equal(kd[..., 0] >= 0,
                                                      kc[..., 0] >= 0)),
                     "class_ids_equal": bool(np.array_equal(kd[..., 0],
                                                            kc[..., 0])),
                     "max_abs_diff": float(np.abs(kd - kc).max())}
    require(out["detect"]["same_rows"] and out["detect"]["class_ids_equal"]
            and out["detect"]["max_abs_diff"] <= 1e-5,
            f"ssd512 parity: detections differ {out['detect']}")
    ulp_losses = [u["losses"] for u in cpu_ulps]
    gates = {f"loss_{i}": resnet_gate(
        card["losses"][i:i + 1], cpu["losses"][i:i + 1],
        [u[i:i + 1] for u in ulp_losses], 1e-5) for i in range(c["steps"])}
    for n, wv in cpu["state"].items():
        gates[n] = resnet_gate(card["state"][n], wv,
                               [u["state"][n] for u in cpu_ulps], 1e-4)
    over = sorted(n for n, (d, _, gt) in gates.items() if d > gt)
    ratio = {n: d / max(sp, 1e-30) for n, (d, sp, _) in gates.items()}
    worst = max(gates, key=lambda n: gates[n][0] / gates[n][2])
    out["train"] = {"losses_card": card["losses"].tolist(),
                    "losses_cpu": cpu["losses"].tolist(),
                    "losses_cpu_perturbed": [u.tolist() for u in ulp_losses],
                    "tensors": len(cpu["state"]), "over_gate": over,
                    "worst": worst, "worst_dist_spread_gate": gates[worst],
                    "median_dist_over_spread": float(np.median(
                        list(ratio.values())))}
    require(all(np.isfinite(v).all() for v in card["state"].values()),
            "ssd512 parity: non-finite parameters on the card")
    require(len(over) <= SSD_FLIPPED_TENSORS and all(
        gates[n][0] <= SSD_FLIP_FACTOR / RESNET_SPREAD_FACTOR * gates[n][2]
        for n in over) and not any(n.startswith("loss_") for n in over),
        f"ssd512 parity: card against CPU over the gate for {over}: worst "
        f"{worst} {gates[worst]}")
    require(out["train"]["median_dist_over_spread"] <= 2.0,
            f"ssd512 parity: median distance over spread "
            f"{out['train']['median_dist_over_spread']}")
    return out


# NMS edge cases, kernel against plain on the card: (B, N, overlap
# threshold, force_suppress, what is special); the boxes are clustered
# (many pairs near the threshold), ids in 0-2, a third of the rows
# invalid and spread over the order. The kernel keeps an image's valid
# rows on chip up to NMS_ON_CHIP_ROWS and takes a global-memory path
# beyond: "limit" puts an image at that many valid rows and one a row
# over it in the same call; N = 5,624 (2/3 valid) and "all_valid" take
# the global path; "tail" has its valid rows only at the end of the
# order; B = 128 at N = 400 gives more clusters than the card has SMs;
# "ids80" draws 80 class ids; a negative threshold suppresses pairs
# that do not overlap (IoU exactly 0)
NMS_ON_CHIP_ROWS = 1216
NMS_EDGES = [(2, 1, 0.5, False, ""), (1, 63, 0.5, False, ""),
             (1, 64, 0.3, False, ""), (1, 65, 0.7, True, ""),
             (3, 200, 0.45, False, ""), (2, 5624, 0.45, False, ""),
             (2, 130, 0.5, False, "nan"), (2, 64, 0.5, False, "dead"),
             (1, 3, 0.5, False, "at_threshold"),
             (2, NMS_ON_CHIP_ROWS + 64, 0.45, False, "limit"),
             (2, 5624, 0.45, False, "all_valid"),
             (2, 5624, 0.45, False, "tail"), (128, 400, 0.45, False, ""),
             (4, 1000, 0.5, False, "ids80"), (4, 1000, 0.5, True, "ids80"),
             (2, 300, -0.1, False, "")]


def nms_edge_inputs(torch, B, N, special, seed):
    """nms_keep's inputs (boxes, ids, valid) on the card for an edge
    case of NMS_EDGES."""
    r = np.random.default_rng(seed)
    centers = r.uniform(0.2, 0.8, (B, max(N // 6, 1), 2))
    c = np.stack([centers[b][r.integers(0, centers.shape[1], N)]
                  for b in range(B)]) + r.normal(0, 0.03, (B, N, 2))
    wh = r.uniform(0.1, 0.3, (B, N, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    ids = r.integers(0, 80 if special == "ids80" else 3,
                     (B, N)).astype(np.float32)
    valid = r.random((B, N)) > 0.33
    if special == "limit":          # NMS_ON_CHIP_ROWS valid rows, and one more
        valid[:] = False
        for b, m in enumerate((NMS_ON_CHIP_ROWS, NMS_ON_CHIP_ROWS + 1)):
            valid[b, r.choice(N, m, replace=False)] = True
    elif special == "all_valid":
        valid[:] = True
    elif special == "tail":
        valid[:, :N - 600] = False
    elif special == "nan":
        boxes[0, 1, 2] = np.nan
        boxes[0, 5] = np.nan
        ids[1, 3] = np.nan
    elif special == "dead":
        valid[:] = False
    elif special == "at_threshold":
        boxes[0] = [[0, 0, 1, 1], [0, 0, 1, 0.5], [0, 0, 1, 0.51]]
        ids[0] = 0
        valid[0] = True
    return tuple(torch.from_numpy(a).to(DEV) for a in (boxes, ids, valid))


def nms_edges(torch, det):
    """Every NMS_EDGES case: the kernel's keep mask equals the plain
    version's, one launch a call; the IoU-at-threshold case keeps the
    pair at exactly 0.5 and drops the one above it. Each case's kernel
    time is time_ms's median."""
    require(getattr(det, "_NMS_ON_CHIP_ROWS", None) == NMS_ON_CHIP_ROWS,
            "nms edges: the kernel's on-chip row limit moved; NMS_EDGES' "
            "limit case must follow it")
    rows = []
    for i, (B, N, thr, force, special) in enumerate(NMS_EDGES):
        args = nms_edge_inputs(torch, B, N, special, seed=i)
        before = det.LAUNCHES["nms"]
        got = det.nms_keep(*args, thr, force)
        want = det.nms_keep(*args, thr, force, impl="torch")
        require(det.LAUNCHES["nms"] == before + 1,
                f"nms edge {i}: {det.LAUNCHES['nms'] - before} launches")
        require(torch.equal(got, want), f"nms edge {i} ({B}, {N}, {thr}, "
                f"{force}, {special!r}): the kernel's keep mask differs in "
                f"{int((got != want).sum())} rows")
        if special == "at_threshold":
            require(got[0].tolist() == [True, True, False],
                    f"nms edge {i}: {got[0].tolist()}")
        valid = args[2].sum(dim=1)
        nbytes, ops, _, _ = nms_work(args[2], args[1], force)
        b_ms, b_by = bound(nbytes, ops, "float32")
        rows.append({"B": B, "N": N, "thresh": thr, "force": force,
                     "special": special, "kept": int(got.sum()),
                     "valid": int(valid.sum()),
                     "valid_per_image": [int(valid.min()), int(valid.max())],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "ms": time_ms(torch, lambda: det.nms_keep(*args, thr,
                                                              force))})
    return rows


def nms_work(valid, ids, force):
    """Bytes and operations the NMS walk needs for these inputs: every
    row's valid flag read (1 byte) and keep written (1); a valid row's
    box (16) and id (4) read once and its area computed once
    (NMS_ROW_FLOPS); for each pair of valid rows of an image, the id
    test (NMS_ID_FLOPS; none with force_suppress) and, where the ids are
    equal (every pair with force_suppress), one IoU and its test
    (NMS_PAIR_FLOPS). A row that is not valid is never kept and never
    suppresses, and a NaN id equals no id, so nothing else is needed.
    Returns (bytes, operations, valid pairs, pairs that need the IoU)."""
    v = valid.sum(dim=1).double()
    rows = float(v.sum())
    pairs = float((v * (v - 1) / 2).sum())
    if force:
        same = pairs
    else:
        same = 0.0
        for b in range(valid.shape[0]):
            c = ids[b][valid[b]]
            n = c[~c.isnan()].unique(return_counts=True)[1].double()
            same += float((n * (n - 1) / 2).sum())
    nbytes = 2 * valid.numel() + 20 * rows
    ops = (NMS_PAIR_FLOPS * same + NMS_ROW_FLOPS * rows
           + (0 if force else NMS_ID_FLOPS * pairs))
    return nbytes, ops, pairs, same


def phase_ssd512(torch, card):
    """SSD-512 through the port: (a) float32 parity of the card against
    the CPU (ssd_parity); (b) the full configuration trained in float32
    and in bfloat16, timed, the first losses held to each other, the
    bfloat16 step profiled; (c) SSD.detect at B = 32 with the NMS
    kernel counted, held to the plain version on the same inputs
    (identical keep masks and rows), timed beside it and its bound, and
    the mAP on the synthetic labels."""
    from mxnet_tpu_torch.metric import VOCMApMetric
    from mxnet_tpu_torch.models import vision
    from mxnet_tpu_torch.models.vision.ssd import SSDMultiBoxLoss
    from mxnet_tpu_torch.ops import detection as det
    from mxnet_tpu_torch.optimizer import SGD
    from mxnet_tpu_torch.parallel import TrainStep
    Loss = ssd_loss_class(SSDMultiBoxLoss)
    out = {"phase": "ssd512", "card": card, "layout": "NCHW"}
    out["parity_f32"] = ssd_parity(torch, vision, det, TrainStep, SGD, Loss)
    release_device(torch)

    # (b) the full configuration, in float32 (TF32 off) and then in
    # bfloat16, from the same Xavier weights, images and targets
    c = SSD_BENCH
    B, S = c["B"], c["S"]
    gen = torch.Generator(device=DEV).manual_seed(0)
    x32 = torch.randn(B, 3, S, S, device=DEV, generator=gen)
    labels = ssd_synthetic_labels(B, c["max_boxes"], c["classes"])
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        net = vision.ssd_512_resnet50_v1_voc(device=DEV).to(dtype)
        flops, layers = resnet_step_flops(torch, net, S)
        x = x32.to(dtype)
        with torch.no_grad():
            anchors = net(x[:1])[2]
        N = anchors.shape[1]
        bt, bm, ct = det.multibox_target(
            anchors, torch.from_numpy(labels).to(DEV),
            torch.zeros(B, c["classes"] + 1, N, device=DEV))
        step = TrainStep(net, Loss(), SGD(learning_rate=1e-3, momentum=0.9,
                                          wd=5e-4))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warm = step.run_steps(x, ct, bt, bm, steps=c["warmup"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = step.run_steps(x, ct, bt, bm, steps=c["steps"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / c["steps"]
        losses = warm.tolist() + losses.tolist()
        stats = [p for n, p in net.named_parameters()
                 if n.endswith(("running_mean", "running_var"))]
        out[f"train_{'bf16' if name == 'bfloat16' else 'f32'}"] = res = {
            "config": dict(c, model="ssd_512_resnet50_v1_voc", dtype=name,
                           init="Xavier(seed 0)", anchors=N, tf32=False,
                           optimizer="SGD(1e-3, momentum 0.9, wd 5e-4)",
                           positives=int((ct > 0).sum())),
            "losses": losses, "ms_per_step": dt * 1e3, "img_per_s": B / dt,
            "step_flops": flops * B, "mac_layers": layers,
            "achieved_tflops": flops * B / dt / 1e12,
            "mfu": flops * B / dt / PEAK_FLOPS[name],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        require(len(stats) == 118, "ssd512: running statistics missing")
        require(all(np.isfinite(losses)), f"ssd512 {name}: non-finite "
                f"losses {losses}")
        require(all(bool(torch.isfinite(p).all()) for p in stats),
                f"ssd512 {name}: non-finite running statistics")
        if dtype == torch.bfloat16:
            trace = resnet_profile(torch, step, (x, ct, bt, bm))
            res["trace"] = trace
            require(np.isfinite(trace["loss"]), "ssd512: non-finite loss "
                    f"{trace['loss']} in the profiled step")
        del step, bt, bm, ct
        if dtype == torch.float32:
            del net, x
        release_device(torch)
    # the first step's loss is the training forward on the same weights
    # and batch: bfloat16 against float32, as phase resnet50's (b)
    first = {k: out[k]["losses"][0] for k in ("train_f32", "train_bf16")}
    rel = abs(first["train_bf16"] - first["train_f32"]) \
        / abs(first["train_f32"])
    out["bf16_vs_f32"] = {"first_loss": first, "loss_rel_diff": rel,
                          "tol": RESNET_BF16_LOSS_TOL}
    require(rel <= RESNET_BF16_LOSS_TOL, f"ssd512 bfloat16 first loss "
            f"{first['train_bf16']} against float32 {first['train_f32']}: "
            f"{rel} relative, over {RESNET_BF16_LOSS_TOL}")

    # (c) detect, the path through the NMS kernel: multibox_detection's
    # and nms_keep's arguments are captured as detect passes them
    net.eval()
    seen = {}

    def capture(name, fn):
        def call(*args, **kw):
            seen.setdefault(name, (args, kw))
            return fn(*args, **kw)
        return call
    detection, keep = det.multibox_detection, det.nms_keep
    det.multibox_detection = capture("detection", detection)
    det.nms_keep = capture("nms", keep)
    try:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        det.reset_launches()
        t0 = time.perf_counter()
        dets = net.detect(x, **SSD_DETECT)
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    finally:
        det.multibox_detection, det.nms_keep = detection, keep
    launches = det.LAUNCHES["nms"]
    require(launches == 1, f"ssd512: detect called the NMS kernel "
            f"{launches} times, not once")
    args, kw = seen["detection"]
    rows_p = detection(*args, **dict(kw, impl="torch"))
    require(torch.equal(dets, rows_p), "ssd512: detect rows through the "
            "NMS kernel differ from the plain version's")
    args, kw = seen["nms"]
    require(len(args) == 6 and args[5] == "auto" and not kw,
            f"ssd512: box_nms called nms_keep with {len(args)} arguments "
            f"and {sorted(kw)}")
    args = args[:5]
    keep_k = keep(*args)
    keep_p = keep(*args, impl="torch")
    require(torch.equal(keep_k, keep_p), "ssd512: the NMS kernel's keep "
            "mask differs from the plain version's at B = 32")
    nbytes, ops, pairs, same = nms_work(args[2], args[1], args[4])
    b_ms, b_by = bound(nbytes, ops, "float32")
    k_ms = time_ms(torch, lambda: keep(*args))
    p_ms = time_ms(torch, lambda: keep(*args, impl="torch"), iters=1,
                   warmup=1)
    metric = VOCMApMetric(iou_thresh=0.5)
    metric.update(labels, dets)
    out["nms_edges"] = nms_edges(torch, det)
    valid = args[2].sum(dim=1)
    out["detect"] = {
        "config": dict(SSD_DETECT, B=B, S=S, anchors=N),
        "launches": launches, "detect_s": detect_s,
        "detect_peak_memory_gb": peak / 1e9, "resident_gb": resident / 1e9,
        "rows_equal": True, "keep_equal": True,
        "max_abs_err": float((keep_k.float() - keep_p.float()).abs().max()),
        "valid_rows_per_image": [int(valid.min()), int(valid.max())],
        "kept_rows": int(keep_k.sum()), "valid_pairs": pairs,
        "same_id_pairs": same,
        "nms_kernel_ms": k_ms, "nms_plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "bytes": nbytes, "flops": ops,
        "library_ms": None,
        "library_note": "no library NMS is installed (torchvision is "
                        "absent); the bound, not the plain version (a "
                        "step-by-step repeat of the walk), is the "
                        "yardstick",
        "map_synthetic": metric.get()[1]}
    require(np.isfinite(dets.cpu().numpy()).all()
            and tuple(dets.shape) == (B, N, 6), "ssd512: detect output")
    emit(out)
    return out


# ---------------------------------------------------------------------------
# phases 7d-7f: Transformer NMT training and beam search, GPT-2 generate
# ---------------------------------------------------------------------------

def set_attention_impl(model, impl):
    """Every attention module of `model` on `impl` ("auto": the kernels,
    "torch": their plain versions); the weights are untouched."""
    for m in model.modules():
        if hasattr(m, "_impl"):
            m._impl = impl


class fused_calls:
    """Count fused_attention's kernel calls (impl "auto" on DEV) by
    layout and query rows while in the block, e.g. "BHTD_tq1",
    "BTHD_tq64"; the launch counters stay the wrappers' own."""

    def __init__(self, fa):
        self.fa, self.calls = fa, {}

    def __enter__(self):
        self.fn = self.fa.fused_attention

        def wrapped(q, k, v, *args, layout="BHTD", impl="auto", **kw):
            if impl == "auto" and str(q.device).startswith(DEV):
                key = f"{layout}_tq{q.shape[2 if layout == 'BHTD' else 1]}"
                self.calls[key] = self.calls.get(key, 0) + 1
            return self.fn(q, k, v, *args, layout=layout, impl=impl, **kw)
        self.fa.fused_attention = wrapped
        return self

    def __exit__(self, *exc):
        self.fa.fused_attention = self.fn


class beam_steps:
    """While in the block, every torch.sort over (rows, `width`)
    candidate totals (a beam search step's sort over beam x vocabulary)
    keeps its best `keep` totals and their flat indices (parent * V +
    token) in `steps`, one pair a step."""

    def __init__(self, torch, width, keep):
        self.torch, self.width, self.keep = torch, width, keep

    def __enter__(self):
        self.fn, self.steps = self.torch.sort, []

        def wrapped(x, *args, **kw):
            res = self.fn(x, *args, **kw)
            if x.dim() == 2 and x.shape[1] == self.width:
                self.steps.append((res[0][:, :self.keep],
                                   res[1][:, :self.keep]))
            return res
        self.torch.sort = wrapped
        return self

    def __exit__(self, *exc):
        self.torch.sort = self.fn


def lockstep_cell(torch, F, fa, q, k, v, mask, layout, lens, label):
    """One forward call of the decode path's shape, kernel against plain
    (float32 1e-5 absolute, bfloat16 BF16_REL_TOL of the largest plain
    value), one launch of the family kernel_route names, the same bits
    twice; then kernel, plain and F.scaled_dot_product_attention times on
    the same views (the cache's, with its mask), and the bound of the
    live keys' work."""
    f32 = q.dtype == torch.float32
    route = fa.kernel_route(q, k, v, layout)
    require(fa.supported(q, k, mask, layout=layout),
            f"{label}: supported() refuses the decode call")

    def run(impl):
        return fa.fused_attention(q, k, v, mask=mask, layout=layout,
                                  impl=impl)
    fa.reset_launches()
    got = run("auto")
    launches = dict(fa.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    want[FAMILY_KEYS[route][0]] = 1
    require(launches == want, f"{label}: launches {launches}")
    require(torch.equal(got, run("auto")), f"{label}: two runs differ")
    err, rel = check_close(got, run("torch"), f32, label)
    B, H, Tq, Tk, D = fa._geometry(q, k, layout)
    nbytes, flops = fused_work(B, H, Tq, Tk, D, q.element_size(), False,
                               lens)[0]
    b_ms, b_by = bound(nbytes, flops, "float32" if f32 else "bfloat16")
    # SDPA takes (B, H, T, D): the same tensors, BTHD ones transposed
    bhtd = [x.transpose(1, 2) if layout == "BTHD" else x for x in (q, k, v)]
    am = mask if mask.dim() == 4 else mask[:, None, None, :]
    out = {"shape": dict(B=B, H=H, Tq=Tq, Tk=Tk, D=D, layout=layout),
           "route": route, "max_abs_err": err, "rel_err": rel,
           "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
           "flops": flops}
    with torch.no_grad():
        out["ms"] = time_ms(torch, lambda: run("auto"))
        out["plain_ms"] = time_ms(torch, lambda: run("torch"))
        out["library_ms"] = time_ms(
            torch, lambda: F.scaled_dot_product_attention(*bhtd,
                                                          attn_mask=am))
    out["ms_over_library"] = out["ms"] / out["library_ms"]
    return out


def decode_views(torch, B, H, T, D, dtype, paged, seed):
    """The lockstep decode call's operands at its last step: a cache
    (contiguous, or paged over a permuted table of 64-key pages) holding
    T - 1 gaussian rows, the step's row written at T - 1; q the (B, H, 1,
    D) head split of a (B, 1, C) projection, K/V the layer's whole (B, H,
    T, D) views and the (1, 1, 1, T) key mask, as the models build
    them."""
    from mxnet_tpu_torch.models import KVCache, PagedKVCache
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)
    if paged:
        S = GPT2_GENERATE["page_size"]
        table = torch.randperm(B * T // S, generator=gen, device=DEV)
        cache = PagedKVCache.create(1, B, H, T, D, dtype=dtype, page_size=S,
                                    page_table=table.reshape(B, T // S),
                                    device=DEV)
    else:
        cache = KVCache.create(1, B, H, T, D, dtype=dtype, device=DEV)
    cache.write_prompt(0, randn(B, H, T - 1, D), randn(B, H, T - 1, D))
    cache = cache.advance(T - 1)
    k, v, cache = cache.write(0, randn(B, H, 1, D), randn(B, H, 1, D))
    q = randn(B, 1, H * D).view(B, 1, H, D).transpose(1, 2)
    mask = cache.key_mask(extra=1)[None, None, None, :]
    return q, k, v, mask


def layer_top(g):
    """The largest gradient magnitude of each layer (a Dense's weight and
    bias together): the attention key biases' true gradient is 0 (a key
    bias shifts every score of a query alike), so on their own both paths
    hold only noise."""
    top = {}
    for n, x in g.items():
        owner = n.rsplit(".", 1)[0]
        top[owner] = max(top.get(owner, 0.0), x.abs().max().item())
    return top


def grad_rel(g_a, g_b, top):
    """Each parameter's largest |g_a - g_b| over its layer's `top`."""
    return {n: (g_a[n].float() - g.float()).abs().max().item()
            / (top[n.rsplit(".", 1)[0]] or 1.0) for n, g in g_b.items()}


class relu_replay:
    """While in the block, the first pass through ops.nn.activation's
    ReLUs records each call's mask (input > 0) and the second applies
    those masks instead of its own (x * mask: the same forward but at a
    pre-activation within rounding of zero, the same derivative), and
    counts the elements whose own sign differs (`flips`). A ReLU is
    discontinuous in its derivative: a pre-activation that the kernel's
    and the plain path's roundings put on two sides of zero moves one
    token's whole contribution to its layer's weight gradients (about
    1.4% of the layer's largest at nmt_train's batch), which says nothing
    of the attention kernels under test."""

    def __enter__(self):
        from mxnet_tpu_torch.ops import nn as ops
        self.ops, self.fn = ops, ops.activation
        self.masks, self.flips, self.elements = [], 0, 0
        self.replay = None

        def wrapped(x, act_type):
            if act_type != "relu":
                return self.fn(x, act_type)
            if self.replay is None:
                self.masks.append(x.detach() > 0)
                return self.fn(x, act_type)
            m = self.masks[self.replay]
            self.replay += 1
            self.flips += int((m != (x.detach() > 0)).sum())
            self.elements += m.numel()
            return x * m.to(x.dtype)
        ops.activation = wrapped
        return self

    def __exit__(self, *exc):
        self.ops.activation = self.fn


def nmt_batch(torch, cfg, B, T, lo, seed=0):
    """Sentence pairs with source and target lengths U[lo, T] (numpy
    `seed`), padded to T with pad_id: (src, target input = bos + body,
    src valid lengths, target output = body + eos, the target's (B, T)
    float32 token mask as the loss's sample weight), and the live target
    tokens."""
    rng = np.random.default_rng(seed)
    sl, tl = rng.integers(lo, T + 1, B), rng.integers(lo, T + 1, B)
    src = np.full((B, T), cfg.pad_id)
    tgt = np.full((B, T + 1), cfg.pad_id)
    for b in range(B):
        src[b, :sl[b]] = rng.integers(4, cfg.src_vocab_size, sl[b])
        tgt[b, 0] = cfg.bos_id
        tgt[b, 1:tl[b]] = rng.integers(4, cfg.tgt_vocab_size, tl[b] - 1)
        tgt[b, tl[b]] = cfg.eos_id
    weight = np.arange(T)[None, :] < tl[:, None]

    def dev(a, dt=torch.int32):
        return torch.tensor(a, dtype=dt, device=DEV)
    return (dev(src), dev(tgt[:, :T]), dev(sl), dev(tgt[:, 1:]),
            dev(weight, torch.float32)), int(tl.sum())


def nmt_step_flops(cfg, B, Ts, Tt):
    """3 x 2 x the multiply-adds of every Dense and attention product of
    a training step at these (padded) shapes: per encoder layer the four
    projections, the FFN and Q·Kᵀ, P·V over Ts x Ts; per decoder layer
    the same over Tt x Tt (causal counted whole), the cross-attention's
    q / proj over Tt rows, k / v over Ts rows and its Tt x Ts products;
    the tied output layer over the vocabulary."""
    U, Hd, V = cfg.units, cfg.hidden_size, cfg.tgt_vocab_size
    enc = 4 * Ts * U * U + 2 * Ts * U * Hd + 2 * Ts * Ts * U
    dec = (4 * Tt * U * U + 2 * Tt * Tt * U + 2 * Tt * U * U
           + 2 * Ts * U * U + 2 * Tt * Ts * U + 2 * Tt * U * Hd)
    macs = B * (cfg.enc_layers * enc + cfg.dec_layers * dec + Tt * U * V)
    return 6 * macs


def phase_nmt_train(torch, F, fa, card):
    """Transformer-base NMT (nmt_base_config: 6 + 6 layers, 512 units, 8
    heads, 2048 hidden, vocab 32000 / 32000, dropout 0.1; seeded random
    weights) trained with teacher forcing through TrainStep + Adam(2e-4)
    on NMT_TRAIN's batch. First the fused pair alone at the three calls'
    shapes (fused_case, float32 and bfloat16: output and the three
    gradients against the plain version): encoder self-attention and
    cross-attention under the sources' key padding, decoder
    self-attention causal, B 64, H 8, T 64, D 64, BTHD. Then the model's
    kernel path against its plain path, from the same weights and
    dropout stream: the loss on one forward of each path, each on its
    own ReLUs (float32 1e-5 relative, bfloat16 BF16_MODEL_LOSS_TOL); the
    gradients on one forward and backward of each, the plain pass on the
    kernel pass's ReLU masks (relu_replay, whose flips may reach
    NMT_RELU_FLIP_FRAC of its elements in float32 and
    NMT_RELU_FLIP_FRAC_BF16 in bfloat16): float32 1e-4 of the layer's
    largest gradient, bfloat16 phase bert's rule (BF16_MODEL_GRAD_TOL of
    the layer's largest float32 gradient, or the plain path's own
    bfloat16 error where larger). Then timed TrainStep
    steps in each dtype (float32 weights; bfloat16 weights with float32
    masters), each launching its family's fused pair 18 times a step
    (6 encoder, 6 decoder causal, 6 cross) and nothing else; one
    bfloat16 step profiled."""
    from mxnet_tpu_torch import rng
    from mxnet_tpu_torch.loss import SoftmaxCrossEntropyLoss as Loss
    from mxnet_tpu_torch.models import TransformerNMT, nmt_base_config
    from mxnet_tpu_torch.optimizer import Adam
    from mxnet_tpu_torch.parallel import TrainStep
    c = NMT_TRAIN
    cfg = nmt_base_config()
    require((cfg.enc_layers, cfg.dec_layers, cfg.units, cfg.num_heads,
             cfg.hidden_size, cfg.tgt_vocab_size, cfg.dropout)
            == (NMT_LAYERS, NMT_LAYERS, 512, 8, 2048, 32000, 0.1),
            "nmt base config changed")
    batch, tgt_tokens = nmt_batch(torch, cfg, c["B"], c["T"], c["lo"])
    B, T = batch[0].shape
    flops = nmt_step_flops(cfg, B, T, T)
    per_step = 3 * NMT_LAYERS
    out = {"phase": "nmt_train", "card": card, "config": "nmt_base_config",
           "layers": [cfg.enc_layers, cfg.dec_layers], "units": cfg.units,
           "heads": cfg.num_heads, "hidden": cfg.hidden_size,
           "vocab": [cfg.src_vocab_size, cfg.tgt_vocab_size],
           "dropout": cfg.dropout, "batch": B, "padded_to": T,
           "target_tokens": tgt_tokens,
           "source_tokens": int(batch[2].sum()), "step_flops": flops,
           "optimizer": "Adam(2e-4)"}

    def loss_of(model, grad):
        """The masked teacher-forcing loss (float32 from the logits) in
        train() mode, dropout from a fixed generator; with `grad` its
        backward and every parameter's gradient (then cleared)."""
        model.train()
        try:
            with rng.generator_scope(rng.step_generator(0, 1, DEV)), \
                    torch.set_grad_enabled(grad):
                loss = Loss()(model(*batch[:3]).float(), batch[3],
                              batch[4]).mean()
                if grad:
                    loss.backward()
        finally:
            model.eval()
        g = {n: p.grad for n, p in model.named_parameters()} if grad \
            else None
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), g

    def paths(model, family, grad, relu=None):
        """loss_of through the kernels (each fused forward, and backward
        with `grad`, launched per_step times, nothing else) and through
        the plain versions (nothing launched); with a relu_replay, the
        plain pass takes the kernel pass's ReLU masks."""
        res = {}
        for impl in ("auto", "torch"):
            set_attention_impl(model, impl)
            fa.reset_launches()
            if relu is not None and impl == "torch":
                relu.replay = 0
            res[impl] = loss_of(model, grad)
            launches = dict(fa.LAUNCHES)
            fwd, bwd = FAMILY_KEYS[family]
            want = dict.fromkeys(launches, 0)
            if impl == "auto":
                want[fwd] = per_step
                want[bwd] = per_step if grad else 0
            require(launches == want, f"nmt_train {family} impl={impl}: "
                    f"launches {launches}, not {want}")
        set_attention_impl(model, "auto")
        return res["auto"], res["torch"]

    def steps_timed(model, dtype, family, steps):
        rng.seed(0)
        step = TrainStep(model, Loss(), Adam(learning_rate=2e-4),
                         n_net_inputs=3)
        torch.cuda.reset_peak_memory_stats()
        step(*batch)                                     # warm-up
        fa.reset_launches()
        with fused_calls(fa) as calls:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(*batch) for _ in range(steps)]
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / steps
        launches = dict(fa.LAUNCHES)
        want = {k: (per_step * steps if k in FAMILY_KEYS[family] else 0)
                for k in launches}
        require(launches == want, f"nmt_train {dtype} steps launched "
                f"{launches}, not {per_step} x {steps} of the {family} pair")
        losses = [float(x) for x in losses]
        require(all(np.isfinite(losses)), f"nmt_train {dtype}: non-finite "
                f"losses {losses}")
        return step, {
            "card": card, "steps": steps, "losses": losses,
            "ms_per_step": dt * 1e3, "target_tokens_per_s": tgt_tokens / dt,
            "padded_tokens_per_s": B * T / dt,
            "achieved_tflops": flops / dt / 1e12,
            "mfu": flops / dt / PEAK_FLOPS["bfloat16"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": launches,
            "launches_per_step": {k: n / steps for k, n in launches.items()
                                  if n},
            "fused_calls_per_step": {k: n / steps
                                     for k, n in calls.calls.items()}}

    # the fused pair alone at the model's three call shapes, each dtype
    H, D = cfg.num_heads, cfg.units // cfg.num_heads
    src_lens = [int(n) for n in batch[2].cpu()]
    out["kernel_cells"] = cells = {}
    for i, (label, causal, lens) in enumerate((
            ("encoder", False, src_lens), ("decoder_causal", True, None),
            ("cross", False, src_lens))):
        cells[label] = {"shape": dict(B=B, H=H, Tq=T, Tk=T, D=D,
                                      layout="BTHD", causal=causal,
                                      key_padding=lens is not None)}
        for dtype, family in ((torch.float32, "cuda_core"),
                              (torch.bfloat16, "tensor_core")):
            r = fused_case(torch, F, fa, B, H, T, T, D, "BTHD", causal,
                           cfg.attention_dropout, lens, dtype, seed=60 + i,
                           timed=False)
            require(r["route"] == family, f"nmt_train {label} {dtype}: "
                    f"routed to {r['route']}")
            cells[label][str(dtype)[6:]] = r

    # float32: the loss on one forward of each path (each on its own
    # ReLUs); the gradients on a forward and backward of each, the plain
    # pass on the kernel pass's ReLU masks; then timed steps
    model = TransformerNMT(cfg, device=DEV)        # init_params seed 0
    (lk, _), (lp, _) = paths(model, "cuda_core", False)
    with relu_replay() as relu:
        (_, gk), (lp_replay, g32) = paths(model, "cuda_core", True, relu)
    top32 = layer_top(g32)
    rel = grad_rel(gk, g32, top32)
    del gk
    worst = max(rel, key=rel.get)
    loss_rel = abs(lk - lp) / abs(lp)
    flip_limit = NMT_RELU_FLIP_FRAC * relu.elements
    out["float32_parity"] = {
        "loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
        "loss_tol": 1e-5, "loss_plain_replayed": lp_replay,
        "grad_worst": rel[worst], "grad_worst_param": worst,
        "grad_tol": 1e-4, "params": len(rel), "relu_flips": relu.flips,
        "relu_elements": relu.elements, "relu_flip_limit": flip_limit}
    require(np.isfinite(lk) and loss_rel <= 1e-5, f"nmt_train float32 "
            f"losses {lk} and {lp} differ by {loss_rel} relative")
    require(relu.flips <= flip_limit, f"nmt_train float32: {relu.flips} "
            f"of {relu.elements} ReLU elements flipped, over {flip_limit}")
    require(rel[worst] <= 1e-4, f"nmt_train float32 gradient of {worst} "
            f"differs by {rel[worst]} of its layer's largest gradient")
    out["float32"] = steps_timed(model, "float32", "cuda_core",
                                 c["steps"]["float32"])[1]
    del model
    release_device(torch)

    # bfloat16 weights (the float32 init rounded) with float32 masters:
    # the loss as in float32; one forward and backward of each path, the
    # plain pass on the kernel pass's ReLU masks, phase bert's rule
    model = TransformerNMT(cfg, device=DEV).to(torch.bfloat16)
    (lk, _), (lp, _) = paths(model, "tensor_core", False)
    with relu_replay() as relu:
        (_, g16k), (_, g16p) = paths(model, "tensor_core", True, relu)
    flip_limit = NMT_RELU_FLIP_FRAC_BF16 * relu.elements
    diff = grad_rel(g16k, g16p, top32)
    own = grad_rel(g16p, g32, top32)      # the plain path's bf16 error
    del g16k, g16p, g32
    limit = {n: max(BF16_MODEL_GRAD_TOL, own[n]) for n in diff}
    worst = max(diff, key=lambda n: diff[n] / limit[n])
    loss_rel = abs(lk - lp) / abs(lp)
    out["bfloat16_parity"] = {
        "loss_kernel": lk, "loss_plain": lp, "loss_rel_diff": loss_rel,
        "loss_tol": BF16_MODEL_LOSS_TOL, "grad_worst": diff[worst],
        "grad_worst_param": worst, "grad_worst_limit": limit[worst],
        "grad_largest": max(diff.values()),
        "grad_largest_param": max(diff, key=diff.get),
        "plain_own_error_largest": max(own.values()),
        "over_tol_by_own_error": sorted(n for n in diff
                                        if own[n] > BF16_MODEL_GRAD_TOL),
        "grad_tol": BF16_MODEL_GRAD_TOL, "params": len(diff),
        "relu_flips": relu.flips, "relu_elements": relu.elements,
        "relu_flip_limit": flip_limit}
    require(np.isfinite(lk) and loss_rel <= BF16_MODEL_LOSS_TOL,
            f"nmt_train bfloat16 losses {lk} and {lp} differ by {loss_rel}")
    require(relu.flips <= flip_limit, f"nmt_train bfloat16: {relu.flips} "
            f"of {relu.elements} ReLU elements flipped, over {flip_limit}")
    require(diff[worst] <= limit[worst], f"nmt_train bfloat16 gradient of "
            f"{worst} differs by {diff[worst]} of its layer's largest "
            f"float32 gradient, over {limit[worst]}")
    step, res = steps_timed(model, "bfloat16", "tensor_core",
                            c["steps"]["bfloat16"])
    require(res["losses"][-1] < res["losses"][0], f"nmt_train bfloat16: "
            f"the loss did not fall: {res['losses']}")
    res["trace"] = trace_step(torch, step, batch)
    out["bfloat16"] = res
    emit(out)
    return out


def beam_gate(torch, runs, K, f32, label):
    """The kernel path's beams against the plain path's. Per source
    sentence: the first step whose chosen candidates (parent, token)
    differ; none, and the final beams must be equal token for token
    (scores within 1e-4 relative in float32, NMT_BF16_SCORE_TOL in
    bfloat16), unless a near tie of the plain path's final scores
    reorders them. At a first differing step the plain path's best K + 1
    totals must hold two neighbours within the near-tie limit: 1e-4 in
    float32; in bfloat16 twice the drift, the largest |kernel - plain|
    total over the candidates both paths rank among their best K + 1 at
    that step or before, where the drift may reach NMT_BF16_DRIFT_CAP at
    most. In bfloat16 the first step's totals (the same bos and memory
    in both runs) hold first to BF16_REL_TOL of the row's largest plain
    one. `runs[impl]["steps"]` are beam_steps' (totals, indices) pairs.
    Returns the readings."""
    def host(run):
        return ([(a.float().cpu().numpy(), i.cpu().numpy())
                 for a, i in run["steps"]],
                run["toks"].cpu().numpy(), run["scores"].cpu().numpy())
    rec_k, tk, sk = host(runs["auto"])
    rec_p, tp, sp = host(runs["torch"])
    score_tol = 1e-4 if f32 else NMT_BF16_SCORE_TOL
    rows, score_rel = [], []
    first_rel = drift_max = 0.0
    for b in range(tk.shape[0]):
        drift = 0.0
        first = None
        for t, ((ak, ik), (ap, ip)) in enumerate(zip(rec_k, rec_p)):
            common = {int(x): y for x, y in zip(ip[b], ap[b])}
            d = max((abs(float(y) - float(common[int(x)]))
                     for x, y in zip(ik[b], ak[b]) if int(x) in common),
                    default=0.0)
            drift = max(drift, d)
            if t == 0:
                first_rel = max(first_rel, d / float(np.abs(ap[b]).max()))
            if not np.array_equal(ik[b, :K], ip[b, :K]):
                first = t
                break
        drift_max = max(drift_max, drift)
        if not f32:
            require(drift <= NMT_BF16_DRIFT_CAP, f"{label}: row {b} drifts "
                    f"{drift} in its totals, over {NMT_BF16_DRIFT_CAP}")
        limit = 1e-4 if f32 else 2 * drift
        if first is None:
            if np.array_equal(tk[b], tp[b]):
                score_rel.append(float(np.max(np.abs(sk[b] - sp[b])
                                              / np.abs(sp[b]))))
                continue
            gap = float(np.min(np.abs(np.diff(sp[b]))))
            rows.append({"row": b, "step": None, "final_reorder": True,
                         "plain_gap": gap, "limit": limit})
        else:
            tot = rec_p[first][0][b]
            gap = float(np.min(tot[:-1] - tot[1:]))
            rows.append({"row": b, "step": first, "plain_gap": gap,
                         "drift": drift, "limit": limit})
        require(gap <= limit, f"{label}: row {b} diverges at step "
                f"{first} where the plain path's nearest candidates are "
                f"{gap} apart, over the near-tie limit {limit}")
    if not f32:
        require(first_rel <= BF16_REL_TOL, f"{label}: the first step's "
                f"totals differ by {first_rel} of the largest, over "
                f"{BF16_REL_TOL}")
    if score_rel:
        require(max(score_rel) <= score_tol, f"{label}: scores differ by "
                f"{max(score_rel)} relative, over {score_tol}")
    return {"rows_equal": len(score_rel), "rows": tk.shape[0],
            "divergences": rows,
            "score_rel_diff": max(score_rel) if score_rel else None,
            "score_tol": score_tol, "first_step_rel_diff": first_rel,
            "first_step_tol": None if f32 else BF16_REL_TOL,
            "drift_max": drift_max,
            "drift_cap": None if f32 else NMT_BF16_DRIFT_CAP}


def phase_nmt_translate(torch, F, fa, card):
    """nmt_base_config's model (seeded random weights) translating
    NMT_TRANSLATE's 16 sources (lengths U[16, 64], padded to 64, with
    valid lengths) by beam search (beam 5, 128 steps, alpha 0.6), float32
    then bfloat16, through the kernels and through the plain versions
    (beam_gate). The kernel path launches its family's fused forward 6
    times for the encoder (BTHD) and 12 a step: the decoder's cached
    self-attention (BHTD, one query row over the cache's 128 keys) and
    its cross-attention (BTHD, one row over the source); nothing else.
    ms a translate and decode steps a second. Kernel cells of the decode
    calls: the self-attention at B * beam = 80, H 8, over 128 keys of the
    contiguous cache, and the cross-attention over 64 padded source keys
    (lockstep_cell)."""
    from mxnet_tpu_torch.models import TransformerNMT, nmt_base_config
    c = NMT_TRANSLATE
    cfg = nmt_base_config()
    B, T, K, L = c["B"], c["T"], c["beam"], c["max_length"]
    gen = np.random.default_rng(1)
    vl = gen.integers(c["lo"], T + 1, B)
    src = np.full((B, T), cfg.pad_id)
    for b in range(B):
        src[b, :vl[b]] = gen.integers(4, cfg.src_vocab_size, vl[b])
    src = torch.tensor(src, dtype=torch.int32, device=DEV)
    vl_t = torch.tensor(vl, dtype=torch.int32, device=DEV)
    out = {"phase": "nmt_translate", "card": card,
           "config": "nmt_base_config", "sources": B, "padded_to": T,
           "valid_lengths": [int(n) for n in vl], "beam": K,
           "max_length": L, "alpha": c["alpha"]}
    model = TransformerNMT(cfg, device=DEV)
    per_step = {"BHTD_tq1": NMT_LAYERS * L, "BTHD_tq1": NMT_LAYERS * L,
                f"BTHD_tq{T}": NMT_LAYERS}

    def translate():
        return model.translate(src, vl_t, beam_size=K, max_length=L,
                               alpha=c["alpha"])
    for dtype, family in (("float32", "cuda_core"),
                          ("bfloat16", "tensor_core")):
        if dtype == "bfloat16":
            model.to(torch.bfloat16)
        runs = {}
        # the plain run first warms the dtype's kernels, so that the
        # kernel run is the timed one
        for impl in ("torch", "auto"):
            set_attention_impl(model, impl)
            fa.reset_launches()
            with fused_calls(fa) as calls, beam_steps(
                    torch, K * cfg.tgt_vocab_size, K + 1) as steps:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                toks, scores = translate()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = dict(fa.LAUNCHES)
            want = dict.fromkeys(launches, 0)
            if impl == "auto":
                want[FAMILY_KEYS[family][0]] = sum(per_step.values())
            require(launches == want and calls.calls == (
                per_step if impl == "auto" else {}),
                f"nmt_translate {dtype} impl={impl}: launches {launches}, "
                f"calls {calls.calls}")
            require(tuple(toks.shape) == (B, K, L)
                    and bool(torch.isfinite(scores).all())
                    and bool((scores[:, :-1] >= scores[:, 1:]).all()),
                    f"nmt_translate {dtype} impl={impl}: bad output")
            require(len(steps.steps) == L, f"nmt_translate {dtype} "
                    f"impl={impl}: {len(steps.steps)} beam steps, not {L}")
            runs[impl] = {"toks": toks, "scores": scores,
                          "steps": steps.steps,
                          "wall_s": wall, "launches": launches,
                          "calls": dict(calls.calls)}
        ms = runs["auto"]["wall_s"] * 1e3
        res = {"gate": beam_gate(torch, runs, K, dtype == "float32",
                                 f"nmt_translate {dtype}"),
               "launches": runs["auto"]["launches"],
               "calls": runs["auto"]["calls"],
               "plain_ms_per_translate": runs["torch"]["wall_s"] * 1e3}
        res.update(card=card, ms_per_translate=ms,
                   decode_steps_per_s=L / ms * 1e3,
                   sentences_per_s=B / ms * 1e3)
        out[dtype] = res
        del runs
        release_device(torch)
    # the decode calls' kernel cells, each dtype
    del model
    release_device(torch)
    H, D = cfg.num_heads, cfg.units // cfg.num_heads
    lens = [int(n) for n in np.repeat(vl, K)]
    cells = {"nmt_self": {}, "nmt_cross": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v, mask = decode_views(torch, B * K, H, L, D, dtype, False, 7)
        cells["nmt_self"][name] = lockstep_cell(
            torch, F, fa, q, k, v, mask, "BHTD", [L] * (B * K),
            f"nmt_self {name}")
        g = torch.Generator(device=DEV).manual_seed(8)
        q = torch.randn(B * K, 1, H, D, generator=g, device=DEV).to(dtype)
        k, v = (torch.randn(B * K, T, H * D, generator=g, device=DEV)
                .to(dtype).view(B * K, T, H, D) for _ in range(2))
        mask = torch.arange(T, device=DEV)[None, :] < torch.tensor(
            lens, device=DEV)[:, None]
        cells["nmt_cross"][name] = lockstep_cell(
            torch, F, fa, q, k, v, mask, "BTHD", lens, f"nmt_cross {name}")
        del q, k, v, mask
    out["cells"] = cells
    emit(out)
    return out


def stream_gate(got, want, logits_got, logits_want, f32, label):
    """Greedy streams (B, n) equal, except where a row first differs at a
    token whose `want` logits' top-2 gap is below the limit: 1e-4 in
    float32 (phase gpt2's rule); in bfloat16 twice d, the largest
    |got - want| logit of that row at that token, where d may reach
    GPT2_BF16_LOGIT_CAP at most. In bfloat16 the first logits of the
    single-token forwards (logits_*[1]: the same prompt and first token
    in both runs) hold first to GPT2_BF16_LOGIT_CAP too. logits_*[i] are
    the (B, V) float32 logits token i was chosen from. Returns the
    readings."""
    rows, first_abs, first_rel, d_max = [], 0.0, 0.0, 0.0
    for b in range(got.shape[0]):
        if got[b, 0] == want[b, 0]:
            lw = logits_want[1][b]
            e = float((logits_got[1][b] - lw).abs().max())
            first_abs = max(first_abs, e)
            first_rel = max(first_rel, e / float(lw.abs().max()))
        diff = np.nonzero(got[b] != want[b])[0]
        if not diff.size:
            continue
        j = int(diff[0])
        lw, lg = logits_want[j][b], logits_got[j][b]
        top = lw.topk(2).values
        gap = float(top[0] - top[1])
        d = float((lg - lw).abs().max())
        d_max = max(d_max, d)
        limit = 1e-4 if f32 else 2 * d
        rows.append({"row": b, "token": j, "top2_gap": gap,
                     "max_abs_logit_diff": d, "limit": limit})
        if not f32:
            require(d <= GPT2_BF16_LOGIT_CAP, f"{label}: row {b}'s logits "
                    f"differ by {d} at token {j}, over "
                    f"{GPT2_BF16_LOGIT_CAP}")
        require(gap < limit, f"{label}: row {b} diverges at token {j} "
                f"where the other path's top-2 gap is {gap}, over {limit}")
    if not f32:
        require(first_abs <= GPT2_BF16_LOGIT_CAP, f"{label}: the first "
                f"single-token logits differ by {first_abs}, over "
                f"{GPT2_BF16_LOGIT_CAP}")
    return {"divergences": rows, "first_logits_max_abs_diff": first_abs,
            "first_logits_rel_diff": first_rel, "logit_diff_max": d_max,
            "logit_diff_cap": None if f32 else GPT2_BF16_LOGIT_CAP}


def phase_gpt2_generate(torch, F, fa, card):
    """GPT-2 774M (seeded random weights; GENERATE_LAYERS of its 36
    layers) generating bench.py
    bench_gpt2_decode's traffic (GPT2_GENERATE: B = 8, prompt 128, 128
    greedy tokens) with GPT2ForCausalLM.generate, float32 then bfloat16:
    through the kernels over a lockstep paged cache (pages of 64: the
    bench's route) and over the contiguous cache, and through the plain
    versions over pages. The prompt's forward takes the plain softmax
    attention ((1, 1, 128, 256) mask, no kernel, as in the reference);
    each single-token forward launches the family's fused forward once a
    layer in BHTD, 6 x 128 a generate, and nothing else. Gates
    (stream_gate): kernel against plain, paged against contiguous.
    Tokens/s and ms a token (bench_gpt2_decode's: the whole generate over
    the new tokens), and the decode call's kernel cell: B 8, H 20, one
    query row over the paged cache's 256 keys."""
    from mxnet_tpu_torch.models import (GPT2ForCausalLM, gpt2_774m_config,
                                        init_params)
    c = GPT2_GENERATE
    require(gpt2_774m_config().num_layers == GPT2_LAYERS,
            "774M config changed")
    cfg = gpt2_774m_config(num_layers=GENERATE_LAYERS, dropout=0.0,
                           attention_dropout=0.0)
    model = init_params(GPT2ForCausalLM(cfg, device=DEV), seed=0, std=0.02)
    B, T0, n, S = c["B"], c["prompt"], c["new"], c["page_size"]
    ids = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, T0)), dtype=torch.int32, device=DEV)
    out = {"phase": "gpt2_generate", "card": card,
           "config": f"gpt2_774m_config(num_layers={GENERATE_LAYERS})",
           "batch": B, "prompt": T0,
           "new_tokens": n, "page_size": S, "decoding": "greedy"}
    want_calls = {"BHTD_tq1": GENERATE_LAYERS * n}
    for dtype, family in (("float32", "cuda_core"),
                          ("bfloat16", "tensor_core")):
        if dtype == "bfloat16":
            model.to(torch.bfloat16)
        runs = {}
        # the plain run first warms the dtype's GEMMs, so that the
        # kernel path's paged run (the bench's route) is the timed one
        for label, impl, paged in (("plain_paged", "torch", True),
                                   ("kernel_paged", "auto", True),
                                   ("kernel_contiguous", "auto", False)):
            set_attention_impl(model, impl)
            logits = []
            handle = model.register_forward_hook(
                lambda m, a, o: logits.append(o[0][:, -1].float()))
            fa.reset_launches()
            try:
                with fused_calls(fa) as calls:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    toks = model.generate(ids, n, paged=paged, page_size=S)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            finally:
                handle.remove()
            launches = dict(fa.LAUNCHES)
            want = dict.fromkeys(launches, 0)
            if impl == "auto":
                want[FAMILY_KEYS[family][0]] = GENERATE_LAYERS * n
            require(launches == want and calls.calls == (
                want_calls if impl == "auto" else {}),
                f"gpt2_generate {dtype} {label}: launches {launches}, calls "
                f"{calls.calls}")
            require(tuple(toks.shape) == (B, n) and len(logits) == n + 1
                    and all(bool(torch.isfinite(x).all()) for x in logits),
                    f"gpt2_generate {dtype} {label}: bad output")
            runs[label] = {"toks": toks.cpu().numpy(), "logits": logits,
                           "wall_s": wall, "launches": launches,
                           "calls": dict(calls.calls)}
        f32 = dtype == "float32"
        k, p = runs["kernel_paged"], runs["plain_paged"]
        res = {"kernel_vs_plain": stream_gate(
                   k["toks"], p["toks"], k["logits"], p["logits"], f32,
                   f"gpt2_generate {dtype} kernel against plain"),
               "paged_vs_contiguous": stream_gate(
                   k["toks"], runs["kernel_contiguous"]["toks"], k["logits"],
                   runs["kernel_contiguous"]["logits"], f32,
                   f"gpt2_generate {dtype} paged against contiguous"),
               "tokens_equal": {lbl: int((r["toks"] == k["toks"]).sum())
                                for lbl, r in runs.items()},
               "tokens": B * n, "launches": k["launches"],
               "calls": k["calls"],
               "wall_s_by_run": {lbl: r["wall_s"]
                                 for lbl, r in runs.items()}}
        # bench_gpt2_decode's reading: the warm paged generate, whole
        dt = k["wall_s"]
        res.update(card=card, wall_s=dt, tokens_per_s=B * n / dt,
                   ms_per_token=dt / n * 1e3)
        del runs, k, p
        out[dtype] = res
        release_device(torch)
    del model
    release_device(torch)
    H, D = cfg.num_heads, cfg.units // cfg.num_heads
    out["cells"] = {"gpt2_774m": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        q, k, v, mask = decode_views(torch, B, H, T0 + n, D, dtype, True, 9)
        out["cells"]["gpt2_774m"][name] = lockstep_cell(
            torch, F, fa, q, k, v, mask, "BHTD", [T0 + n] * B,
            f"gpt2_774m decode {name}")
        del q, k, v, mask
    emit(out)
    return out


def kernel_entry(name, source, launches, f32, b16, card, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": f32["max_abs_err"],
            "max_abs_err_bf16": b16["max_abs_err"],
            "rel_err_bf16": b16.get("rel_err"),
            "ms": f32["ms"], "kernel_ms": f32["ms"],
            "plain_ms": f32["plain_ms"],
            "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
            "library_ms": f32["library_ms"],
            "ms_bf16": b16.get("ms"), "plain_ms_bf16": b16.get("plain_ms"),
            "bound_ms_bf16": b16.get("bound_ms"),
            "library_ms_bf16": b16.get("library_ms"), "card": card, **extra}


def nms_entry(ssd, card):
    """The NMS kernel (one launch a call) on its main path, phase
    ssd512's SSD.detect at B = 32."""
    d = ssd["detect"]
    return {"name": "nms", "route": "cuda", "source": NMS_SOURCE,
            "replaces": REPLACES["nms"], "launches": d["launches"],
            "max_abs_err": d["max_abs_err"], "ms": d["nms_kernel_ms"],
            "plain_ms": d["nms_plain_ms"], "bound_ms": d["bound_ms"],
            "bound_by": d["bound_by"], "library_ms": None,
            "library_note": d["library_note"], "cell": d["config"],
            "keep_equal": d["keep_equal"], "card": card}


def span_entries(span, span8, gpt2, gpt2_int8, spec, tier, robust, http,
                 router, fleet, tp, card):
    """The four span kernels' kernels-line entries: the CUDA-core kernel
    at float32 q (launches from the float32 serves, phases 5 and 5b) and
    the tensor-core kernel at bfloat16 q (launches from the bfloat16
    serves), float and int8 pages, each at the kernel cell with the
    serve's decode and verify cells beside, and its launches on the
    speculative serve of phase 5d (none: bfloat16 q on int8 pages is not
    served with speculation there), on the host-tier serves of phase 5g,
    on phase 5h's chaos soak (float32) and int8 restart (none: phase 5h
    serves no bfloat16), on phase 5i's HTTP serves (float pages) and on
    phase 5j's routed serves (none for bfloat16 q on int8 pages) and on
    phase 5k's in-process fleet workers (none for bfloat16 q on int8
    pages) and on phase 5l's tensor-parallel serves (float32 q: the
    float32 and w8 serves; none for bfloat16 q on int8 pages)."""
    fam = tier["launches_by_family"]
    rob = {SPAN: robust["chaos"]["launches"][SPAN],
           INT8: robust["preempt"]["restart_int8"]["launches"][INT8]}

    def entry(name, source, res, dtype, launches, spec_launches):
        cell, dec = res[dtype], res["serve_decode"][dtype]
        ver = res["serve_verify"][dtype]
        require(cell["route"] == dec["route"] == ver["route"] == (
            "tensor_core" if name.endswith("_tc") else "cuda_core"),
            f"{name}: the cells ran on another route")
        keys = ("ms", "plain_ms", "library_ms", "ms_over_library",
                "bound_ms", "bound_by", "max_abs_err", "rel_err")
        return {"name": name, "route": "cuda", "family": cell["route"],
                "source": source, "replaces": REPLACES[name],
                "launches": launches, "dtype": dtype,
                "max_abs_err": cell["max_abs_err"],
                "rel_err": cell["rel_err"], "ms": cell["ms"],
                "kernel_ms": cell["ms"], "plain_ms": cell["plain_ms"],
                "bound_ms": cell["bound_ms"], "bound_by": cell["bound_by"],
                "library_ms": cell["library_ms"],
                "ms_over_library": cell["ms_over_library"],
                "serve_decode": {k: dec[k] for k in keys},
                "serve_verify": {k: ver[k] for k in keys},
                "gpt2_spec_launches": spec_launches,
                "gpt2_tier_launches": fam.get(
                    {SPAN: "float32", SPAN_TC: "bfloat16",
                     INT8: "int8"}.get(name)),
                "gpt2_robust_launches": rob.get(name),
                "gpt2_http_launches": http["launches_by_family"].get(
                    {SPAN: "float32", SPAN_TC: "bfloat16"}.get(name)),
                "gpt2_router_launches": router["launches_by_family"].get(
                    {SPAN: "float32", SPAN_TC: "bfloat16",
                     INT8: "int8"}.get(name)),
                "gpt2_fleet_launches": fleet["launches_by_family"].get(
                    {SPAN: "float32", SPAN_TC: "bfloat16",
                     INT8: "int8"}.get(name)),
                "gpt2_tp_launches": tp_fam.get(name),
                "card": card}
    tf = tp["launches_by_family"]
    tp_fam = {SPAN: tf["float32"] + tf["w8_float32"], SPAN_TC: tf["bfloat16"],
              INT8: tf["int8"]}
    sfam = spec["launches_by_family"]
    return [entry(SPAN, SOURCE, span, "float32", gpt2["launches"][SPAN],
                  sfam["float32"]),
            entry(SPAN_TC, SPAN_TC_SOURCE, span, "bfloat16",
                  gpt2["launches_bf16"][SPAN_TC], sfam["bfloat16"]),
            entry(INT8, SOURCE, span8, "float32",
                  gpt2_int8["launches"][INT8], sfam["int8"]),
            entry(INT8_TC, SPAN_TC_SOURCE, span8, "bfloat16",
                  gpt2_int8["launches_bf16"][INT8_TC], None)]


def fused_entries(fused, launches, launches16, gpt2_train, nmt_train,
                  nmt_translate, generate, card, bert_gluon, flash,
                  bert_resume, bert_mesh):
    """The fused kernels' four kernels-line entries at the BERT-base BTHD
    cell (the main path's shape), the BHTD and GPT-2 cells beside: the
    CUDA-core pair (float32, with the split-TF32 bound beside; bfloat16
    times at the unaligned D = 40 cell; launches from phase 7's float32
    kernel steps) and the tensor-core pair (bfloat16; launches from phase
    7's bfloat16 steps); each with its launches in phase 7b's GPT-2
    774M training pass of its dtype, phase 7d's timed NMT steps, and (the
    forwards) phase 7e's translate and phase 7f's paged generate through
    the kernels, and the forwards' lockstep cells of the dtype: NMT's
    decode self-attention (BHTD, one query row over 128 keys), its
    cross-attention (BTHD, one row over 64 padded source keys) and GPT-2
    774M's decode (BHTD, one row over 256 paged keys); each with its
    launches in phase 7g's eager gluon steps of its dtype, and the
    tensor-core pair with phase 7h's 'flash' cell (BHTD, causal, T 8192:
    its launches, times, errors and bound); the tensor-core pair with its
    launches in phase 7g2's uninterrupted dynamic-scale steps, the
    CUDA-core pair with those of 7g2's eager amp steps; each with its
    launches in phase 7g4's mesh steps of its dtype (Ulysses' per-shard
    attention, BHTD) and the errors of one such shard's attention
    against the plain version."""
    main = fused["bert_bthd"]
    f32, b16 = main["float32"], main["bfloat16"]
    cells = ("bert_bhtd", "gpt2_774m_causal")

    def bwd_view(r):
        return {"max_abs_err": max(r["grad_max_abs_err"]),
                "rel_err": max(r["grad_rel_err"]),
                "ms": r.get("bwd_ms"), "plain_ms": r.get("plain_bwd_ms"),
                "bound_ms": r.get("bwd_bound_ms"),
                "bound_by": r.get("bwd_bound_by"),
                "bound_tf32x3_ms": r.get("bwd_bound_tf32x3_ms"),
                "library_ms": r.get("library_bwd_ms")}

    def other(dtype, key, lib_key, bound_key):
        return {c: {"ms": fused[c][dtype][key],
                    "library_ms": fused[c][dtype][lib_key],
                    "bound_ms": fused[c][dtype][bound_key],
                    "bound_tf32x3_ms": fused[c][dtype].get(
                        bound_key.replace("bound", "bound_tf32x3"))}
                for c in cells}

    def train(dtype, key):
        return gpt2_train[dtype]["kernel"]["launches"][key]

    def gluon(key):
        """Launches in phase 7g's eager steps, and the flash cell."""
        src = bert_gluon["launches_bf16" if key.endswith("_tc")
                         else "launches"]
        extra = {"bert_gluon_launches": src[key],
                 "bert_mesh_launches": bert_mesh[
                     "launches_bf16" if key.endswith("_tc")
                     else "launches"][key]}
        # one Ulysses shard's attention of phase 7g4 against the plain
        # version (its forward errors in a forward's entry, its worst
        # gradient's in a backward's)
        sc = bert_mesh["shard_check"][
            "bfloat16" if key.endswith("_tc") else "float32"]
        is_fwd = "fwd" in key
        extra["bert_mesh_shard_check"] = {
            "shape": sc["shape"], "dtype": sc["dtype"],
            "max_abs_err": sc["max_abs_err"] if is_fwd
            else max(sc["grad_max_abs_err"]),
            "rel_err": sc["rel_err"] if is_fwd else max(sc["grad_rel_err"]),
            "tol": sc["tol"] if is_fwd else sc["grad_tol"],
            "tol_kind": sc["tol_kind"] if is_fwd else "relative"}
        if key.endswith("_tc"):
            extra["bert_resume_launches"] = bert_resume["launches"][key]
        else:
            extra["bert_resume_amp_launches"] = \
                bert_resume["amp_launches"][key]
        if key.endswith("_tc"):
            r = flash["bfloat16"]
            fwd = "fwd" in key
            keys = (("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")
                    if fwd else ("bwd_ms", "plain_bwd_ms", "library_bwd_ms",
                                 "bwd_bound_ms", "bwd_bound_by"))
            extra["flash_cell"] = dict(
                {k.replace("bwd_", "").replace("_bwd", ""): r[k]
                 for k in keys},
                launches=flash["launches"][key],
                max_abs_err=r["max_abs_err"] if fwd
                else max(r["grad_max_abs_err"]),
                rel_err=r["rel_err"] if fwd else max(r["grad_rel_err"]),
                shape=flash["shape"])
        return extra

    def lockstep(dtype, key):
        """Launches and cells of phases 7d-7f for one entry."""
        out = {"nmt_train_launches": nmt_train[dtype]["launches"][key]}
        if "fwd" not in key:
            return out
        keys = ("ms", "plain_ms", "library_ms", "ms_over_library",
                "bound_ms", "bound_by", "max_abs_err", "rel_err", "route")
        cells = {**nmt_translate["cells"], **generate["cells"]}
        out.update(
            nmt_translate_launches=nmt_translate[dtype]["launches"][key],
            gpt2_generate_launches=generate[dtype]["launches"][key],
            lockstep_cells={c: {k: v[dtype][k] for k in keys}
                            for c, v in cells.items()})
        for c in cells.values():
            require(c[dtype]["route"] == ("cuda_core" if dtype == "float32"
                                          else "tensor_core"),
                    f"{key}: a lockstep cell ran on another route")
        return out

    def tc_entry(name, r, n, cells_):
        return {"name": name, "route": "cuda", "source": FUSED_TC_SOURCE,
                "replaces": REPLACES[name], "launches": n,
                "dtype": "bfloat16", "max_abs_err": r["max_abs_err"],
                "rel_err": r["rel_err"], "ms": r["ms"], "kernel_ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "ms_over_library": r["ms"] / r["library_ms"],
                "card": card, "other_cells": cells_}
    # the CUDA-core pair in bfloat16: timed at the unaligned D = 40 cell,
    # its errors at the BERT-base cell on padded rows beside
    cc16 = main["bfloat16_cuda_core"]
    d40 = fused["bert_bthd_d40_unaligned"]["bfloat16"]
    cell16 = "bert_bthd at D = 40, rows 44 elements apart"
    return [
        kernel_entry("fused_attention_fwd", FUSED_SOURCE,
                     launches["fused_attention_fwd"], f32, d40, card,
                     bound_tf32x3_ms=f32["bound_tf32x3_ms"],
                     bf16_cell=cell16, bert_cell_rel_err_bf16=cc16["rel_err"],
                     gpt2_train_launches=train("float32",
                                               "fused_attention_fwd"),
                     other_cells=other("float32", "ms", "library_ms",
                                       "bound_ms"),
                     **lockstep("float32", "fused_attention_fwd"),
                     **gluon("fused_attention_fwd")),
        kernel_entry("fused_attention_bwd", FUSED_SOURCE,
                     launches["fused_attention_bwd"], bwd_view(f32),
                     bwd_view(d40), card,
                     bound_tf32x3_ms=f32["bwd_bound_tf32x3_ms"],
                     grad_rel_err=max(f32["grad_rel_err"]),
                     grad_rel_err_bf16=max(d40["grad_rel_err"]),
                     bf16_cell=cell16,
                     bert_cell_grad_rel_err_bf16=max(cc16["grad_rel_err"]),
                     gpt2_train_launches=train("float32",
                                               "fused_attention_bwd"),
                     other_cells=other("float32", "bwd_ms",
                                       "library_bwd_ms", "bwd_bound_ms"),
                     **lockstep("float32", "fused_attention_bwd"),
                     **gluon("fused_attention_bwd")),
        dict(tc_entry("fused_attention_fwd_tc", b16,
                      launches16["fused_attention_fwd_tc"],
                      other("bfloat16", "ms", "library_ms", "bound_ms")),
             gpt2_train_launches=train("bfloat16",
                                       "fused_attention_fwd_tc"),
             **lockstep("bfloat16", "fused_attention_fwd_tc"),
             **gluon("fused_attention_fwd_tc")),
        dict(tc_entry("fused_attention_bwd_tc", bwd_view(b16),
                      launches16["fused_attention_bwd_tc"],
                      other("bfloat16", "bwd_ms", "library_bwd_ms",
                            "bwd_bound_ms")),
             gpt2_train_launches=train("bfloat16",
                                       "fused_attention_bwd_tc"),
             **lockstep("bfloat16", "fused_attention_bwd_tc"),
             **gluon("fused_attention_bwd_tc"))]


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_attention as fa
    from mxnet_tpu_torch.ops import ragged_attention as ra

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compiled": sorted(logs),
          "ptxas": [ln.strip() for log in logs.values()
                    for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    seconds = {}                  # each phase's wall seconds

    def timed(name, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        seconds[name] = time.perf_counter() - t
        # a phase's locals die at its return: engines among them that sit
        # in a reference cycle wait for the collector
        release_device(torch)
        return out
    span = timed("span", phase_span, torch, F, ra)
    span8 = timed("span_int8", phase_span, torch, F, ra, quant=True)
    decode = timed("decode", phase_decode, torch, F, ra)
    gpt2 = timed("gpt2", phase_gpt2, torch, ra, card)
    gpt2_int8 = timed("gpt2_int8", phase_gpt2_int8, torch, ra, card, gpt2)
    timed("prefix", phase_prefix, torch, ra, card)
    spec = timed("gpt2_spec", phase_gpt2_spec, torch, ra, card)
    timed("gpt2_w8", phase_gpt2_w8, torch, ra, card, gpt2)
    timed("gpt2_lora", phase_gpt2_lora, torch, ra, card, gpt2)
    model, cfg = gpt2_774m(torch)
    tier = timed("gpt2_tier", phase_gpt2_tier, torch, ra, card, model, cfg)
    robust = timed("gpt2_robust", phase_gpt2_robust, torch, ra, card, model,
                   cfg)
    http = timed("gpt2_http", phase_gpt2_http, torch, ra, card, model, cfg)
    router = timed("gpt2_router", phase_gpt2_router, torch, ra, card, model,
                   cfg)
    fleet = timed("gpt2_fleet", phase_gpt2_fleet, torch, ra, card, model,
                  cfg)
    del model
    release_device(torch)
    tp = timed("gpt2_tp", phase_gpt2_tp, torch, ra, card, gpt2)
    fused = timed("fused", phase_fused, torch, F, fa)
    bert = timed("bert", phase_bert, torch, fa, card)
    bert_gluon = timed("bert_gluon", phase_bert_gluon, torch, fa, card,
                       bert)
    bert_resume = timed("bert_resume", phase_bert_resume, torch, fa, card)
    timed("np_control", phase_np_control, torch)
    bert_mesh = timed("bert_mesh", phase_bert_mesh, torch, fa, card)
    flash = timed("flash", phase_flash, torch, F, fa)
    gpt2_train = timed("gpt2_train", phase_gpt2_train, torch, fa, card)
    timed("resnet50", phase_resnet50, torch, card)
    ssd = timed("ssd512", phase_ssd512, torch, card)
    nmt_train = timed("nmt_train", phase_nmt_train, torch, F, fa, card)
    nmt_translate = timed("nmt_translate", phase_nmt_translate, torch, F,
                          fa, card)
    generate = timed("gpt2_generate", phase_gpt2_generate, torch, F, fa,
                     card)

    kernels = span_entries(span, span8, gpt2, gpt2_int8, spec, tier, robust,
                           http, router, fleet, tp, card)
    kernels.append(kernel_entry(
        "ragged_decode_attention", SOURCE,
        gpt2["launches"]["ragged_decode_attention"], decode["float32"],
        decode["bfloat16"], card, splits=decode["splits"],
        gpt2_tp_launches=tp["launches_by_family"]["decode"],
        span_sq1_ms=decode["float32"]["span_sq1_ms"],
        span_sq1_ms_bf16=decode["bfloat16"]["span_sq1_ms"]))
    kernels += fused_entries(fused, bert["launches"], bert["launches_bf16"],
                             gpt2_train, nmt_train, nmt_translate, generate,
                             card, bert_gluon, flash, bert_resume, bert_mesh)
    kernels.append(nms_entry(ssd, card))
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds, "card": card})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
