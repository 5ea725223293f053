"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, each printed as one JSON line and
each fatal on failure (exit code not 0, no result line):

1. build   -- nvcc builds every kernel source under midgpt_tpu_torch/csrc
              (one process per source, all started together), then g++
              the data feed's gather (midgpt_tpu_torch/native), with the
              card's name and power limit; per kernel, ptxas's registers,
              shared memory and spills, and the HGMMA (wgmma) instructions
              cuobjdump finds in its machine code; the dynamic shared
              memory each wgmma kernel launches with, and the paged
              split kernel's at the serve shapes;
2. kernel  -- each kernel against its plain PyTorch version on the card:
              bf16 and f32 pools, the openwebtext geometry and a GQA one,
              ragged resident lengths, first and last recent row, held
              element by element (see ``hold``); a faulted output (each
              slot's last resident row dropped) must fail the same check;
3. serve   -- the serving main path at the full width of ``openwebtext``
              (124M, random init from a seed, bf16 weights and pool):
              ServingEngine(slots=8, window=4, page_size=16) on 16 greedy
              requests; every kernel's launch count is read around that
              run alone, and one decode window's logits through the
              kernel are held to the plain path on the same state (bf16:
              within twice the plain bf16 path's distance from the f32
              path; f32: 1e-4 of the largest logit); the first 8
              prompts served greedy and sampled (T=0.8, top-k 50, noise
              drawn on the card), timed. Before the clock the engine's
              ``warm_prefill`` captures every prefill bucket and class
              (capture ms per program, graph pool bytes before and
              after), and the measured run captures nothing more than
              its decode window; ``serve_run``, which the serve-style
              phases share, warms the same way;
   graphs  -- the engine's one-dispatch programs (each decode window
              and verify dispatch one CUDA graph replay): serve's engine
              and every fourth of its 16 requests (4: lengths 16 ..
              412; with speculation 4 repetitive), greedy and sampled
              (T=0.8, top-k 50),
              bf16 and int8 (weights and pool), spec-off and
              speculate=4: every stream and every kernel's launch count
              equal to the same run's with every program run eagerly
              (``Program.run_eager``); one dispatch replayed and run
              eagerly from the same state (logits, pages and results bit
              for bit); no aten op dispatched between the static copies
              and the harvest's read; each program's capture ms and the
              graph pool's bytes; one dispatch's host ms (copies, replay,
              read) beside its device ms (the replay between CUDA
              events) and the eager body's host ms, and the idle share
              (``openwebtext_moe`` in serve_moe, greedy both ways);
   prefill_graphs -- the prefill chunk programs (one CUDA graph a bucket
              and class) on serve's model, bf16 and int8 (weights and
              pool); ``openwebtext_moe`` in serve_moe, bf16 and int8
              pools: ``warm_prefill`` over the whole block writes no
              page and no logit and captures 2 x buckets programs; every
              bucket (16 .. 1024) at start 0, mid-page (13) and
              page-aligned (32), from one random state, replayed and run
              eagerly: every page, scale plane and the logits bit for
              bit; 0 aten ops a replay; at bucket 256 a chunk's host ms
              (copy in, replay) beside its replay's device ms and the
              eager body's host ms;
4. timing  -- the paged kernel at the serve shapes (a CUDA graph of
              launches replayed between CUDA events, median of repeats)
              beside its plain version and its bound, and the sampler's
              noise and draw at [8, vocab];
   verify_kernel -- the paged verify kernel against its plain version:
              both geometries, T in (2, 5, 8), bf16 and f32, held as in
              phase 2; the same rule must refuse the output against a
              plain run with each slot's last resident column dropped
              and one whose self mask lets row t see row t + 1; each
              verify row t must equal the decode kernel's step t (the
              candidate rows as recent rows) bit for bit;
   long_table -- both paged kernels over a 32,768-token table (Pmax =
              2,048 pages of 16) at both geometries, bf16, held as in
              phase 2, then timed there from CUDA graphs beside their
              plain versions and bounds (the splits' merge runs inside
              the kernel: the f32 split states it reads are given);
   serve_spec -- the speculative serving main path at the full width of
              ``openwebtext`` (bf16): ServingEngine(slots=8,
              page_size=16, speculate=4) on 16 greedy requests of 64 new
              tokens (eight serve prompts, eight repetitive), verify
              launches = n_layer x verify dispatches, decode launches 0;
              the same requests spec-off, timed; one verify dispatch's
              logits held to the plain path; sampled runs; a profile;
   timing  -- the verify kernel at the serve_spec shapes, as phase 4;
   kernel_int8 -- the int8 branch of both paged kernels against their
              plain versions: int8 pages (each page on its own po2 grid)
              with bf16 self rows, both geometries, decode r in (0, R-1)
              and verify T in (2, 5, 8), q bf16 and f32, held as in phase
              2; the same rule must refuse the plain version with each
              slot's first page's scale doubled and with the codes read
              without their scales;
   serve_int8 -- the int8 serving main path at the full width of
              ``openwebtext`` (bf16): quant="int8", kv_quant="int8" on the
              16 serve requests, spec-off (window 4: decode launches =
              n_layer x decode steps, verify 0) and speculate=4 (verify
              launches = n_layer x verify dispatches, decode 0), the bf16
              engine beside it in turns; one window's and one verify
              dispatch's logits held to the plain path (bf16, f32); the
              eager int8 projections' bytes and device time a decode step
              against bf16's;
   timing  -- both int8 branches at the serve shapes, as phase 4, their
              bounds counting int8 pages, page scales and bf16 self rows;
   int8_matmul_kernel -- the int8 weight product's kernel against its
              plain version at every projection of ``openwebtext``
              (wqkv, wo, w_up, w_down, the head) and every row count the
              engine gives it (``HOLD_MS``: every instance of the plan),
              x bf16 and f32, codes
              with -127 and 127 and po2 scales from 2^-30 to 2^6, held
              element by element (``hold_matmul``); a doubled scale and a
              dropped row of codes must be refused;
   timing  -- the int8 matmul kernel at the decode (M=8), verify (40)
              and prefill (512) rows on the quantized model's own layers:
              per projection and for one forward's 49, beside its plain
              version (codes to bf16, cuBLAS, scale), cuBLAS on the bf16
              copy (and the kernel / cuBLAS ratio) and the bound;
   serve_prefix -- the prefix cache on the serving main path: 16 greedy
              requests sharing a 256-token system prompt (tails of
              16..128 tokens, 64 new tokens each) at the full width of
              ``openwebtext`` (bf16, slots=8, page_size=16, window=4),
              in turns: cache off, cache on, cache on with
              prefill_chunk=64, cache on with int8 weights and pool;
              launch counts around each run alone; the hit rate above 0.5
              and fewer prefill tokens than the cache-off run; each hit's
              first-token logits held to the cache-off run's (bf16 by the
              triangle rule, f32 within 1e-4 of the largest logit);
   serve_pressure -- the serving main path under load (bf16, full
              width): serve's 16 requests on ServingEngine(slots=8,
              window=4, page_size=16, num_pages=96) under the fault plan
              ``6:exhaust@0:all:3``, with one running and one queued
              request cancelled after step 4 and one submitted with its
              deadline passed; the page invariants after every step;
              evictions >= 1, and the longest prompt alone under
              ``2:exhaust@0:all:16`` parks (overload parks >= 1); every
              served request 64 tokens, pages home, none quarantined or
              parked, launch counts around each run alone; the same with
              speculate=4; at f32 (every other request, slots=4,
              num_pages=48) every stream equal to the uncontended run's;
              tokens/s and TTFT beside the uncontended runs;
   serve_spill -- cold-page host spill on the serving main path (bf16,
              full width, tracing on): ServingEngine(slots=8, window=4,
              page_size=16, prefill_chunk=128) on 12 tenants' 512-token
              system prompts with a 32-token user turn, 64 new tokens,
              then the same tenants with new turns; 320 pages (the cold
              prompts do not fit) against a 1,024-page twin: spill off,
              spill on with and without prefetch, on with an int8 pool,
              on with speculate=4; the page invariants with the spill
              store after every step; the streams of every spill run
              equal their ample twin's, spill off's counted in bf16 and
              held at f32; round 2 faults pages back, prefetch makes
              fewer ``import_pages`` calls; round 2's prefill tokens,
              reclaims, spills, fault-backs, TTFT and TBT
              (``request_metrics``); one page's spill and fault-back timed
              alone, and a bit-exact round trip on the card;
   serve_telemetry -- serve's 16 requests with tracing off and on in
              turns: the same streams, decode launches and synchronizing
              calls in every step (CUDA sync debug mode "warn"); host ms
              a step each way; TTFT, TBT and queue delay from
              ``request_metrics``; the Chrome trace
              (build/serve_trace.json) and a flight dump
              (build/serve_flight.json);
   frontdoor -- the same requests through ``AsyncFrontDoor``'s
              background task, consumed by ``async for``: the streams
              equal ``run()``'s; then with max_queue=4 (submitters wait),
              two requests cancelled after their first window and one
              with a passed deadline shed; the time from submit to the
              first streamed token;
   cluster -- ``ServingCluster(replicas=2)`` of serve's engines on the
              card (bf16, full width and depth) on serve's 16 requests:
              every stream equals one engine's, ``stats()`` has the
              ``CLUSTER_STATS_KEYS`` and sums its replicas, decode
              launches = n_layer x the replicas' decode steps, pages
              home on both; tokens/s and TTFT in turns beside one
              ``slots=16`` engine and the cluster under a watchdog
              that never trips (replicas on worker threads);
   disagg  -- disaggregated pools: 1+1 (prefix cache on), then 2+1 at
              ``speculate=4``; streams equal the monolithic engine's,
              16 handoffs, no decode or verify dispatch on a prefill
              replica and no prefill dispatch on the decode replica;
              one request's handoff (export + import) timed on the
              card at 64, 256 and 512 prompt tokens, device and host
              ms beside its bytes, byte-exact;
   cluster_chaos -- the 2+1 cluster under a crash, a failed export and
              a transient, then replicas=3 with a replica wedged past
              the watchdog: streams equal the fault-free run's, one
              flight dump per dead replica; the re-served requests'
              prefill chunks recorded beside a fault-free run's;
   affinity -- serve_spill's 12 tenants on replicas=2, round 2 in
              reverse order, affinity off and on: equal streams, a
              strictly higher hit rate with affinity;
   frontdoor_cluster -- ``AsyncFrontDoor`` over ``replicas=2``: streams
              equal ``run()``'s; a cancel reaches the replica that
              holds the request;
   serve_moe -- the serving main path on ``openwebtext_moe`` (6 of its 12
              layers, cut to make room for serve_tensor; 8 Switch
              experts, D=768, F=3072, random init from a seed, bf16): serve's engine and 16 requests, dense
              ``openwebtext`` served just before it; decode launches =
              n_layer x decode steps; a second run's streams equal the
              first's; speculate=4 on serve_spec's requests (verify
              launches = n_layer x dispatches, decode 0); one window's
              logits held to the plain path (bf16, f32); the claims
              dropped per MoE call shape (prefill, verify);
   sample  -- the fixed-batch sampler (``sampling.generate``) at the full
              width of ``openwebtext`` (bf16, 8 rows): launches read
              around each run alone (P=256, 64 new: flash forward =
              n_layer, fused 0; P=960, 96 new, exact sliding: flash =
              n_layer, fused = n_layer x 32 re-forwards; the same in kv
              sliding: fused 0; P=250: flash 0, naive asked for by the
              shape rule; under ``quantize_model`` the int8 product 4
              n_layer + 1 times a forward); the flash prefill's logits and
              cache against the naive prefill's and one decode step over
              the recent rows against ``decode_step`` and the full forward
              (bf16 by the triangle rule, f32 within 1e-4 of the largest
              value; a ring with K shifted by one slot refused); at f32
              the greedy streams at P=250 equal ``generate_served``'s and
              sampled streams equal at chunk_len 1 and 64; the sampler and
              ``generate_served`` on the same prompts in turns, a decode
              step's device and host ms, an exact-window re-forward's ms;
              every run (and the int8 one) again with every program's
              body eager: the same tokens bit for bit and launches, each
              program's capture ms and the shape's graph pool bytes; at
              P=256 a warm call's aten ops between its copy in and its
              read (0), its host and device ms, and a replayed step's
              host and device ms (``sampler_replay_timing``);
              ``python -m midgpt_tpu_torch.sample`` as its own process on
              a checkpoint of the model: fixed-batch, ``--serve`` and
              ``--quant int8``, three processes run together, each exit
              0 with every sample's length;
5. train_kernel -- the fused attention kernels (forward, combined
              backward) against their plain versions on the card: the
              openwebtext geometry (B=2, T=1024, H=12, C=64) and a GQA one
              (H=8, Hkv=2, C=128, T=512), f32 and bf16 (see
              ``fused_readings``); the same rule must refuse the kernels'
              outputs with the RoPE tables shifted by one position;
6. train   -- the training main path, ``midgpt_tpu_torch.train.train``,
              on ``openwebtext`` at full width and depth (124M, random
              init from a seed, f32 masters, bf16 compute, attn_impl
              "auto") for 20 steps of 16 x 1024 tokens in 2 microbatches,
              on Zipf-distributed tokens written from a seed; the fused
              kernels' launches are counted around the run alone and must
              equal the shapes' count; the loss must fall by 1 nat.
              Batches come through the prefetch thread and the native
              gather, saves are asynchronous: every train phase records
              the save enqueues (``ckpt_s``) and the waits for a write
              (``ckpt_wait_s``), ``max_memory_allocated`` over the run
              (``peak_bytes``) beside the port's estimate
              (``card_peak_bytes``, and its ratio to the peak) and the JAX
              package's (``estimate_hbm_fill``), and the remat "auto"
              resolved to (its profile, two more steps under
              torch.profiler, is ``chip_turns.py --phases
              train_profile``);
7. parity  -- one microbatch (B=8) of the same model through the kernels
              and through the naive path: f32 loss and gradient norm
              within 1e-5 and 1e-4 relative; bf16 held by the triangle
              rule against the naive f32 path;
8. timing  -- the fused kernels at one training microbatch's shapes, as
              in phase 4, and the forward also at one train_long
              microbatch (B=4, T=2048); yardsticks from CUDA graphs on the
              already normed and roped q/k/v: SDPA forward plus the
              forward pre-pass for the forward (the same function), SDPA
              forward + backward for the backward (attention alone); the
              forward's two launches and the combined backward's three
              timed apart under torch.profiler;
   remat_dots -- the train phase's configuration at remat "dots" and
              "full" through ``train()``: fused forward launches = n_layer
              x (2 x train microbatches + eval microbatches), backward =
              n_layer x train microbatches; the first loss within the
              parity phase's bf16 loss limit of the "none" run's; step
              medians and peaks; one microbatch (B=8) at each remat
              through the kernels: loss and gradient norm held to
              "none"'s by the parity phase's bf16 limits, its peak bytes
              in the order full < dots < none;
   train_remat -- the first-step OOM ladder at full width:
              ``openwebtext_moe`` at its experiment's microbatch (128 x
              1024 tokens, doubled while remat "none" fits, up to 512),
              3 steps: each rung run directly (peak, step ms, estimate,
              or the OOM), then ``train()`` with remat "auto" started at
              "none" (this script patches the pick) so that a real OOM
              steps it down: it must end on the first rung that fits,
              with that rung's losses (the parity phase's bf16 limit);
              the port's own pick must be a rung that fits;
   train_moe -- ``train()`` on ``openwebtext_moe`` (~558M parameters)
              over the train phase's data and batch, 10 steps: fused
              launches against the shapes' count, the loss falls by 1
              nat, ``moe/aux`` and ``moe/dropped_frac`` logged at each
              eval; step median, tokens/s and MFU beside the train
              phase's; peak memory beside both estimates; one
              step's device time split into the MoE layer's stages
              (route, slots, dispatch, experts, combine) and the rest;
   parity_moe -- one MoE microbatch (B=8, T=1024, f32) through the fused
              kernels and the naive path (the parity phase's limits),
              and the MoE layer on the card against the CPU;
9. flash_kernel -- the flash kernels (forward, dq, dk/dv) against their
              plain versions on the card: the shakespeare_char geometry
              (B=4, T=256, H=6, C=64), GQA at C=64 (H=8, Hkv=2, T=512) and
              C=128 (H=4, T=1024), each with dropout 0.2 and 0, f32 and
              bf16; and the train_char microbatch itself (B=64, bf16,
              dropout 0.2) on contiguous inputs and on the strided views
              the model passes (see ``flash_inputs``, ``flash_readings``);
              the same rule must refuse the kernels' outputs against the
              plain version run at seed + 1 (dropout) or with k and v one
              row off (no dropout); the delta that the dq kernel forms
              and writes is held to the plain delta (f32 rule);
10. train_char -- the training main path on ``shakespeare_char`` at full
              width and depth (6 layers, 6 heads of 64, width 384, T=256,
              vocab 65; dropout 0.2, remat "full", its 64 x 256 batch,
              bf16 compute) for 100 steps on the corpus of
              ``data/shakespeare_char/prepare.py --synthetic``; the flash,
              fused and keyed dropout launches are counted around the run
              alone and must equal the shapes' count; the loss must fall
              by 1 nat (its profile: ``chip_turns.py --phases
              char_profile``);
11. parity_char -- one microbatch of the char model, dropout drawn, f32,
              through the flash kernels and through the naive path (same
              attention masks from the counter hash, same residual masks
              from the same keys): loss within 1e-5 and gradient norm
              within 1e-4 relative;
12. timing -- the flash kernels at one char microbatch (B=64, H=6, T=256,
              C=64, bf16, rate 0.2) beside their plain versions, bounds
              and SDPA with dropout 0.2 as a yardstick (all as device
              time from CUDA graphs): dq given delta and forming it, and
              the whole backward, whose profile must show the dq and
              dk/dv kernels alone;
   flash_seed -- the flash kernels read the dropout seed from device
              memory: the forward's keep-mask read off its output (q = 0,
              v = the identity, non-causal) equals the counter hash of the
              seed at several heads and anchors (bf16, f32), seed + 1
              refused; an int seed and the seed as a tensor give the same
              bits; a CUDA graph of the three kernels replayed after the
              seed tensor is rewritten equals eager launches at the new
              seed;
   dropout_kernel -- the keyed residual dropout against its plain
              version bit for bit (bf16 and f32 residuals, an odd count,
              a misaligned view), forward and backward, key + 1 refused,
              a graph replay reading a rewritten key, the element
              offsets of a mesh rank's rows (one wrapping 2^32); then
              timed at the char residual, inputs rotated past the L2,
              beside its plain version, its byte bound and the generator
              draw it replaced;
   train_window -- the trainer's dispatch programs at full width:
              ``openwebtext`` (16 x 1024 tokens a step, 3 of its 12
              layers, 12 steps), ``shakespeare_char`` (dropout 0.2, 40
              steps) and ``openwebtext_moe`` (full width, 3 of its 12
              layers, 8 steps) through ``train()`` at
              steps_per_dispatch 1 and 4: every logged loss, grad norm and
              lr bit for bit, the same val loss, ceil(steps / K)
              dispatches, equal launches; per configuration and K one
              program driven by hand: capture ms, graph pool bytes, a
              replay against the eager body from one state bit for bit,
              no aten op between the copies and the read, host ms a step
              beside the eager body's (in turns), a replay's device ms
              (CUDA events), idle shares, the peak beside
              ``card_peak_bytes``; a char run stopped at step 6 and
              resumed to 12 equals the uninterrupted run; remat "dots"
              graphed at K=1 and 4, its program beside its eager body;
   train_mesh -- the data-parallel / FSDP trainer on this card:
              ``openwebtext`` at full width and a quarter of its depth (3
              of its 12 layers of 768, 6 before serve_tensor's cut, T = 1024, 16 x 1024 tokens a step, remat
              "none", 10 steps) through
              ``python -m torch.distributed.run --standalone
              --nproc_per_node=1 -m midgpt_tpu_torch.launch --multihost``
              (a world of one NCCL rank, ``mesh.fsdp=-1``): a first
              launch to step 5 (its save), a second resuming to 10;
              every logged number (losses, grad norms, lr, evals) bit
              for bit against ``train()`` on one card without a process
              group on the same batches; the step's graph replay holds
              its collectives (all-gather, reduce-scatter, all-reduce),
              counted a replay; step medians and tokens/s beside the
              single-card run's; ``max_memory_allocated`` beside the
              mesh-aware ``card_peak_bytes``. With two cards or more,
              ``--nproc_per_node=2`` of a step-level runner
              (``chip_smoke.py --mesh-steps``) against its world of one
              on the same global batches (losses and grad norms within
              ``MESH_TWO_CARD_RTOL``); with one card it records why
              that run was not made;
   ring   -- ring attention (standard and zigzag schedules) and Ulysses
              on one card through the loopback exchange (every virtual
              rank of the sequence axis in this process, the trainer's
              hop code): q/k/v [8, 12, 1024, 64] bf16 at S = 2, 4, 8
              (Ulysses 2, 4), dropout 0.1 on standard ring and Ulysses
              at S = 2, and a GQA [2, 16/4, 2048, 128] ring at S = 4;
              out, dq, dk, dv held to the plain f32 version of one
              attention over the whole T by the flash phases' bf16 rule
              (the triangle rule; the plain bf16 version is the ring
              through the kernels' plain versions, ``plain=True``, and
              for Ulysses one plain call), and each distance also to
              ``RING_ONE_CALL_LIMIT`` times that rule's limit for one
              plain bf16 call over the whole T (which holds the code the
              ring and its plain version share); the same work on the
              f32 inputs by the flash phases' f32 rule against the
              plain f32 call (which sees a fault in that shared code
              far below bf16's rounding); the bf16 rule refuses a
              fault (k and v one row off; with dropout the plain call of
              seed + 1: the mask is the single call's); each virtual
              rank's work alone (its flash launches, its device ms
              forward and backward from a CUDA graph), the max/min ratio
              over the virtual ranks, the loopback's total beside one
              flash call over the whole T;
   train_sequence -- ``train()`` on the one-rank mesh (train_mesh's
              configuration, 10 steps) with attn_impl "ring" and
              "ulysses" against "flash": every logged number bit for
              bit (at S = 1 both reduce to one flash call), the same
              kernel launches, each replay's launch counts; with two
              cards or more, a world of two at ``sequence=2`` with ring
              attention (``chip_smoke.py --mesh-steps OUT cuda CONFIG
              sequence``) against its world of one; with one card why
              that run was not made;
   tensor -- the trainer's tensor-parallel modules on one card over the
              loopback tensor exchange (every virtual tensor rank's shard
              in one process), forward and backward, against the same
              module unsharded: one ``openwebtext_xl`` block (B=8,
              T=1024) and one ``llama_7b`` block (B=2, T=2048) at tensor
              2 and 4, one ``openwebtext_moe`` MoE layer at tensor 4 (2
              experts a rank), the vocab-parallel embedding and chunked
              loss at V=50304 at tensor 2 and 4; bf16 by the triangle
              rule against the unsharded f32 run (``tensor_bf16_factor``:
              2, the loss's dh max(2, 1 + tensor / 2), a pure sum of
              bf16 partials), f32 by the flash phases' f32 rule (its
              1e-5 in units of the output's largest magnitude above 1),
              every parameter gradient in the full layout; one fused
              launch each way a virtual rank and block at H / tensor
              heads; two planted faults refused: JAX's contiguous cut of
              packed wqkv (blocks), and the tensor sums' values rounded
              to ``TENSOR_FAULT_BITS`` significant bits (the bf16 rule on
              blocks and both ends; the f32 rule on the f32 modules of
              blocks, both ends and the MoE layer, whose bf16 reading is
              recorded only); each virtual rank's device ms alone
              beside the
              unsharded module's; the fused kernels timed at a rank's
              shapes (xl at 8 and 4 heads, llama at 8 / 2 heads of
              C=128) beside their plain versions, bounds and SDPA;
   train_tensor -- ``train()`` on ``openwebtext_xl`` at full width and
              a sixth of its depth (4 of 24 layers, 0.41B parameters,
              12 before serve_tensor's cut; two full-depth checkpoints
              would overrun the machine's disk writes; remat "auto", 8 x 1024 tokens a step in 8
              microbatches of one row, 10 steps, Zipf data) through the
              launcher
              under torch.distributed.run at a world of one with
              ``--set mesh.tensor=1`` (the config's own tensor=4 needs
              four ranks; at tensor=1 the model's tensor sums run as
              one-rank all-reduces, captured in the replay) against the
              single-card trainer: every logged number bit for bit, the
              same fused launches; step medians,
              tokens/s, MFU from xl's FLOPs a token, peaks against
              ``card_peak_bytes``; with two cards or more, a world of two
              at ``tensor=2`` (``chip_smoke.py --mesh-steps OUT cuda
              CONFIG tensor``) against its world of one; with one card
              why that run was not made;
   pipeline -- the GPipe schedule and the model's stages on one card
              over the loopback pipeline (every stage in one process):
              ``openwebtext_xl`` at full width, 8 of its 24 layers, one
              microstep of 8 x 1024 tokens, at 2 and 4 stages (JAX's
              auto M: 4 and 8 microbatches), against the same model
              unpipelined over the same microbatches (each one's loss
              backward in turn, the single-card trainer's path): the
              last stage's ln_f output, the summed loss and every
              parameter gradient, bf16 by the triangle rule against the
              unpipelined f32 run and f32 by the flash phases' f32 rule
              (``PIPE_RULE``); each virtual stage's fused launches a
              microbatch (2 L / S forward, the forward and its
              recompute, and L / S backward; the last stage's forward
              feeds only the loss, so L / S); two planted faults
              refused: a boundary that rounds the f32 activations to
              bf16 while claiming float32, and one microbatch's backward
              skipped on a middle stage; each virtual stage's device ms
              (its forward, recompute and backward of one microbatch)
              and GPipe's bubble (S - 1) / (M + S - 1), computed;
   train_pipeline -- ``train()`` on ``openwebtext_xl`` (train_tensor's
              4 layers, data and 10 steps of 8 x 1024 tokens) with
              ``mesh.pipeline=4`` on one card (the loopback: every stage
              in this process, M = 8 microbatches of one row, activations
              across stages in f32) against train_tensor's single-card
              run at ``g_accum_iters=8``: every logged number bit for
              bit; the fused launches of one replay (M (2 L - L / S)
              forward, M L backward); step median, MFU, the peak against
              ``card_peak_bytes`` (0.8-1.25); with two cards or more, a
              world of two at ``pipeline=2`` (``chip_smoke.py
              --mesh-steps OUT cuda CONFIG pipeline``) against its world
              of one; with one card why that run was not made;
13. split_kernel -- the split route's kernels (T above the combined
              kernel's cap: the bf16 pre-pass, the dq and dk/dv kernels)
              and the fused forward at T=2048 against their plain
              versions: the openwebtext geometry (B=2, T=2048, H=12, C=64)
              and a GQA one (B=1, H=8, Hkv=2, C=128), f32 and bf16, by
              ``fused_readings``' rule (the pre-pass's q^ and k^ by
              ``hold``), shifted RoPE tables refused; at T=1024 the split
              route held against the combined kernel;
14. norm_kernel -- the fused RMSNorm forward and backward against their
              plain versions: [8192, 768] bf16 and f32, with and without
              a weight, eps 1e-6 and 1e-5, and 4099 rows, held by
              ``hold``; rows shifted by one refused;
15. train_long -- ``train()`` on ``openwebtext`` at block_size 2048 with
              norm_impl "fused" (8 x 2048 tokens a step in 2
              microbatches, 10 steps, the Zipf data): the split kernels,
              never the combined one, and the norm kernels, launches
              counted around the run alone against their formulas
              (pre-pass = dq = dk/dv = n_layer x train microbatches);
              remat resolves to "none"; the loss falls (its profile, the
              split route and the norm kernels grouped apart:
              ``chip_turns.py --phases long_profile``);
16. parity_long -- one microbatch (B=4, T=2048) of that model through the
              fused attention and norm and through the naive attention
              and plain norm: the parity phase's limits;
17. serve_norm -- the serve cell with norm_impl "fused": norm launches =
              (2 n_layer + 1) x model forwards; one decode window's
              logits held to the plain-norm model's;
    serve_tensor -- serving under the tensor axis: ``openwebtext_xl`` at
              full width and depth (24 layers, D 2048, 16 heads of 128,
              V 50304, bf16, norm_impl "fused"; random weights drawn on
              the card from the seed) at tensor 4 on one card's loopback
              mesh (``serving_meshes(4, loopback=True)``), serve's engine
              geometry: the main path, counted (every counter zeroed just
              before, read just after), is 8 requests spec-off, the other
              8 at speculate=4, int8 weights with an int8 pool on 2 + 2
              of them, and the fixed-batch sampler on the mesh (B 2,
              prompt 64, 16 tokens); launches = tp x n_layer x decode
              steps (verify dispatches; int8: tp x (4 n_layer + 1) x
              forwards; flash: tp x n_layer), the same share a virtual
              rank. (a) the paged decode and verify kernels (bf16 and
              int8 pools) at xl's rank shape (Hkv 4, C 128) and llama_7b's
              (Hkv 2, groups of 4), the int8 product at a rank's (N / tp,
              K) and (N, K / tp) for M = 8 and 40, the flash forward at
              H / tp = 4 heads, each held to its plain version, each
              refusing a planted fault, each timed beside its plain
              version, its bound and (int8, flash) the library call; (b)
              each program (decode window, verify, int8 decode, every
              prefill bucket and class) replayed and run eagerly from one
              state, bit for bit, and tp = 1's decode window beside
              tp = 4's; (c) the margin rule (``TP_MARGIN``): every served
              token, the stream re-forwarded through the unsharded model
              in f32 (the int8 engines' through the dequantized weights),
              within the margin of the f32 argmax's logit, for the served
              streams, the sampler's, a tp = 1 control and prefill_sp
              "off"; one rank's ``wo`` shard zeroed and two ranks' KV
              heads swapped must each break it; (d) one prefill chunk of
              512 with prefill_sp "on" against "off", bit for bit or not,
              recorded; (e) a world of one over NCCL (a
              ``GroupTensorExchange`` at tensor 1, in this process)
              against the plain engine on openwebtext: streams, logits
              and pages bit for bit;
18. timing -- the split route at B=4, T=2048 and, beside the combined
              kernel, at B=8, T=1024: the pre-pass, the dq and dk/dv
              kernels alone (given q^ and k^) and the route whole, the
              route's kernels apart under the profiler; the norm kernels at
              [8192, 768] bf16; each beside its plain version, bound and
              library call (SDPA forward + backward, alone and with the
              pre-pass added; F.rms_norm);
19. kernels -- one JSON object listing every kernel of the port.

The last line is ``{"ok": true, "device": {...}}``. The script imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import typing as tp

import numpy as np
import torch

# published peaks of one H100 SXM (dense): HBM bytes/s, and FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}

DEVICE = "cuda"
SEED = 0
SERVE = dict(slots=8, window=4, page_size=16)
N_REQUESTS, MAX_NEW = 16, 64
# kernel-phase geometries: (name, Hkv, G, C); S=8, PS=16, Pmax=64, R=4
GEOMS = [("openwebtext", 12, 1, 64), ("gqa", 8, 4, 128)]
S, PS, PMAX, R = 8, 16, 64, 4
# empty, mid-page, page-aligned, ..., full table
LENS = [0, 7, 16, 200, 512, 777, 1000, PMAX * PS]
# train_kernel geometries: (name, B, T, H, Hkv, C)
FUSED_GEOMS = [("openwebtext", 2, 1024, 12, 12, 64), ("gqa", 2, 512, 8, 2, 128)]
FUSED_OUTS = ("out", "lse", "dqkv", "dwq", "dwk")
# the train phase: overrides of the openwebtext experiment, and its data
TRAIN_SET = dict(batch_size=16, g_accum_iters=2, max_steps=20,
                 warmup_steps=5, lr_decay_steps=20, eval_interval=10,
                 eval_batches=2, ckpt_interval=10, log_interval=1)
DATA_TOKENS = 4 << 20  # per split, uint16
ZIPF_IDS, ZIPF_EXP = 4096, 1.1
TRAIN_TIMING = dict(b=8, t=1024, h=12, hkv=12, c=64)  # one microbatch
# flash_kernel geometries: (name, B, T, H, Hkv, C); each at these rates
FLASH_GEOMS = [("shakespeare_char", 4, 256, 6, 6, 64),
               ("gqa", 2, 512, 8, 2, 64), ("c128", 2, 1024, 4, 4, 128)]
FLASH_RATES = (0.2, 0.0)
FLASH_OUTS = ("out", "lse", "dq", "dk", "dv", "delta")
FLASH_SEED = -12345
# the train_char phase: overrides of the shakespeare_char experiment (its
# batch, accumulation, dropout and remat stay); warmup and decay cut to
# the run, one save at the end
CHAR_SET = dict(max_steps=100, warmup_steps=10, lr_decay_steps=100,
                eval_interval=50, eval_batches=20, ckpt_interval=1000,
                log_interval=1)
CHAR_TIMING = dict(b=64, t=256, h=6, hkv=6, c=64, rate=0.2)  # one microbatch
# split_kernel geometries: (name, B, T, H, Hkv, C), T above the combined cap
SPLIT_GEOMS = [("openwebtext", 2, 2048, 12, 12, 64),
               ("gqa", 1, 2048, 8, 2, 128)]
SPLIT_OUTS = ("dq", "dwq", "dk_h", "dv_h", "dwk")
SPLIT_VS_COMBINED_T = 1024  # a T both backward routes take
# the train_long phase: openwebtext at a 2048-token context with the fused
# norm; its model overrides, then the experiment's
LONG_MODEL = dict(block_size=2048, norm_impl="fused")
LONG_SET = dict(batch_size=8, g_accum_iters=2, max_steps=10, warmup_steps=3,
                lr_decay_steps=10, eval_interval=5, eval_batches=1,
                ckpt_interval=1000, log_interval=1)
LONG_TIMING = dict(b=4, t=2048, h=12, hkv=12, c=64)  # one microbatch
NORM_SHAPES = [(8192, 768), (4099, 768)]  # rows: a train microbatch; ragged
NORM_EPS = (1e-6, 1e-5)  # the block norms, ln_f
NORM_BUFS = 8  # norm timing rotates over this many inputs (past the L2)
# the train_mesh phase: openwebtext (full width, 3 of 12 layers, remat "none",
# MESH_MODEL) through the
# multi-process launcher, a first launch of MESH_PART steps and a resume
# to max_steps, against the single-card trainer
MESH_CONFIG = "openwebtext"
MESH_SET = dict(TRAIN_SET, max_steps=10, eval_interval=5, eval_batches=1,
                ckpt_interval=1000)
# its model overrides (also train_sequence's): a quarter of its depth (3
# of 12 layers; full width; 6 before the cut that made room for
# serve_tensor) keeps the phases within 1000 s with the tensor phases
# (the two took 135 s at 12 layers on a slow host)
MESH_MODEL = dict(remat="none", n_layer=3)
MESH_PART = 5
MESH_KEYS = ("loss/optimized", "grad_norm", "lr", "loss/train", "loss/val")
# the two-card step-level check: steps on one global batch each, and the
# tolerance of world 2 against world 1 (bf16 gradients accumulate over
# other rows on each rank before the f32 reduction)
MESH_STEPS = 4
MESH_TWO_CARD_RTOL = 1e-2
# the ring phase: (geometry, B, H, Hkv, T, C, impl, schedule, S, dropout),
# every case forward and backward on one card through the loopback
# exchange; timed per virtual rank over RING_REPS calls a graph
RING_CASES = (
    [("openwebtext", 8, 12, 12, 1024, 64, "ring", sched, s, 0.0)
     for sched in ("standard", "zigzag") for s in (2, 4, 8)]
    + [("openwebtext", 8, 12, 12, 1024, 64, "ulysses", None, s, 0.0)
       for s in (2, 4)]
    + [("openwebtext", 8, 12, 12, 1024, 64, "ring", "standard", 2, 0.1),
       ("openwebtext", 8, 12, 12, 1024, 64, "ulysses", None, 2, 0.1),
       ("gqa", 2, 16, 4, 2048, 128, "ring", "standard", 4, 0.0),
       ("gqa", 2, 16, 4, 2048, 128, "ring", "zigzag", 4, 0.0)])
RING_SEED = 4242
RING_REPS = 3
# the ring phase's second limit: a case's distance from the plain f32
# whole-T call over the flash phases' limit for ONE plain bf16 call (2x
# its distance). The ring rounds each pair's partial dK and dV to bf16
# before its f32 sums, so it may lie a little past one call: the sound
# ring read up to 1.04 (standard S = 2, dK), k and v one row off 61x
RING_ONE_CALL_LIMIT = 1.3
# the train_sequence phase: train_mesh's configuration on the one-rank
# mesh, each attention in turn (flash first: the others are held to it)
SEQ_IMPLS = ("flash", "ring", "ulysses")
# the tensor phase: (config, module, B, T, tensor sizes), each module of
# the trainer (an attention + MLP block, an MoE layer, the vocab-parallel
# embedding and chunked loss) at the config's full width, forward and
# backward through the loopback tensor exchange against itself unsharded
TENSOR_CASES = (
    ("openwebtext_xl", "block", 8, 1024, (2, 4)),
    ("llama_7b", "block", 2, 2048, (2, 4)),
    ("openwebtext_moe", "moe", 8, 1024, (4,)),
    ("openwebtext_xl", "embed_loss", 8, 1024, (2, 4)),
)
TENSOR_LOSS_CHUNK = 512  # openwebtext_xl's loss_chunk
TENSOR_RULE = ("bf16: max |sharded bf16 - unsharded f32| <= "
               "tensor_bf16_factor(tensor, output) x max |unsharded bf16 - "
               "unsharded f32| per output (parameter gradients in the full "
               "layout): 2, the loss's dh max(2, 1 + tensor / 2); f32: "
               "|sharded f32 - unsharded f32| <= 1e-5 u + rel x |unsharded "
               "f32| per element, u = max(1, max |unsharded f32|), rel 1e-5 "
               "outputs, 1e-4 gradients")
# the planted precision fault: the tensor sums' values rounded to this
# many significant bits (bf16 keeps 8); on an H100 80GB HBM3 at 700 W the
# rule refuses 4 in every block and at both ends, and passes 5 (PERF.md)
TENSOR_FAULT_BITS = 4
# the fused kernels at a tensor rank's shapes: (name, B, T, H, Hkv, C)
TENSOR_FUSED_SHAPES = (("xl_tensor2", 8, 1024, 8, 8, 128),
                       ("xl_tensor4", 8, 1024, 4, 4, 128),
                       ("llama_tensor4", 2, 2048, 8, 2, 128))
# the train_tensor phase: openwebtext_xl at full width and a sixth of its
# depth (4 of 24 layers, 0.41B parameters, remat "auto"; 12 layers before
# the cut that made room for serve_tensor), one card's batch, 10
# steps; every run writes a checkpoint of 12 bytes a parameter, and two
# full-depth ones (17 GB each) overrun the card machine's 45 GiB of disk
# writes together with the other phases. Its 8 rows a step run as 8
# microbatches of one row: the train_pipeline phase's 8 pipeline
# microbatches hold to that same single-card run, bit for bit
XL_NAME = "openwebtext_xl"
XL_LAYERS = 4
XL_SET = dict(batch_size=8, g_accum_iters=8, max_steps=10, warmup_steps=3,
              lr_decay_steps=10, eval_interval=10, eval_batches=1,
              ckpt_interval=1000, log_interval=1)


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON record on a line; a phase's record carries ``t_s``, the
    seconds since the script started (a phase's time is the difference
    from the record before it)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


ABS_TOL = 1e-5


def hold(got: torch.Tensor, ref32: torch.Tensor):
    """Hold a kernel output element by element against the plain version
    run in f32 on the same inputs upcast (the plain version upcasts them
    itself, so this is its value before the one final cast). Each element
    may be off by 1e-5 (the two sum in different orders) plus, for a bf16
    output, the final rounding: half a bf16 ulp, at most 2^-8 of the
    rounded value. Returns ``(max_abs_err, max err/tolerance)``; the check
    passes when the second is at most 1."""
    err = (got.float() - ref32).abs()
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + ABS_TOL
    return err.max().item(), (err / tol).max().item()


def plain32(pa, q, pk, pv, bt, pl, rk, rv, r, layer):
    """The plain version on the same inputs upcast to f32."""
    return pa.paged_decode_attention_reference(
        q.float(), pk.float(), pv.float(), bt, pl, rk.float(), rv.float(),
        r, layer)


def paged_inputs(hkv, g, c, dtype, lens, layers=2, seed=0, pmax=PMAX):
    """Random pools, queries and recent rows on the card; every slot owns
    distinct live pages and its table pads hold the sentinel page id."""
    gen = torch.Generator().manual_seed(seed)
    live = [-(-n // PS) for n in lens]
    num_pages = sum(live) + 1
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    q = f(len(lens), hkv, g, c)
    pk = f(layers, num_pages, hkv, c, PS)
    pv = f(layers, num_pages, hkv, c, PS)
    rk, rv = f(len(lens), hkv, R, c), f(len(lens), hkv, R, c)
    bt = torch.full((len(lens), pmax), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    dev = torch.device(DEVICE)
    out = [a.to(dev, dtype) for a in (q, pk, pv)]
    out += [bt.to(dev), torch.tensor(lens, dtype=torch.int32, device=dev)]
    out += [a.to(dev, dtype) for a in (rk, rv)]
    return out


def phase_kernel(pa) -> float:
    """Each case is held to the plain version (:func:`hold`), and the same
    check is shown to refuse a faulted output: the kernel run with each
    slot's last resident row dropped must fail it in every slot that had
    a row to drop."""
    worst = 0.0
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = paged_inputs(hkv, g, c, dtype, LENS)
            pl = args[4]
            for r in (0, R - 1):
                got = pa.paged_decode_attention(*args, r, 1)
                torch.cuda.synchronize()
                ref = pa.paged_decode_attention_reference(*args, r, 1)
                ref32 = plain32(pa, *args, r, 1)
                err, ratio = hold(got, ref32)
                fault = pa.paged_decode_attention(
                    *args[:4], (pl - 1).clamp_min(0), *args[5:], r, 1)
                # the least err/tol among the slots that lost a row
                fault_ratio = min(hold(fault[i], ref32[i])[1]
                                  for i, n in enumerate(LENS) if n > 0)
                emit({"phase": "kernel", "kernel": "paged_decode_attention",
                      "geometry": name, "hkv": hkv, "g": g, "c": c,
                      "dtype": str(dtype).split(".")[-1], "r": r,
                      "lens": LENS, "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      "max_abs_err_vs_plain_same_dtype":
                          (got.float() - ref.float()).abs().max().item(),
                      "dropped_row_min_slot_err_over_tol": fault_ratio})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"kernel disagrees with its plain version: {name} "
                        f"{dtype} r={r}: {ratio} x the tolerance")
                if not fault_ratio > 1.0:
                    raise AssertionError(
                        f"the check passes a dropped resident row: {name} "
                        f"{dtype} r={r}: {fault_ratio}")
                worst = max(worst, err)
    return worst


def prompts(vocab: int):
    rng = np.random.default_rng(SEED)
    lens = np.linspace(16, 512, N_REQUESTS).astype(int)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def pool_copy(serving, pool, dtype):
    """A copy of ``pool`` in ``dtype`` (an int8 pool stays int8, with
    copies of its scale planes)."""
    if pool.quantized:
        return serving.PagedKVPool(pool.k.clone(), pool.v.clone(),
                                   pool.page_size, pool.scale_k.clone(),
                                   pool.scale_v.clone())
    return serving.PagedKVPool(pool.k.to(dtype, copy=True),
                               pool.v.to(dtype, copy=True), pool.page_size)


def pages_home(eng) -> None:
    """After a drain: no page held, and the allocator and the prefix index
    consistent (cold cached pages stay allocated, still matchable)."""
    if eng.alloc.held_pages != 0:
        raise AssertionError(
            f"{eng.alloc.held_pages} pages still held after the run")
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc)


def window_agreement(model, serving, tol_frac=None, plain_model=None,
                     **engine_kw):
    """One decode window through the kernel and through the plain path,
    from the same engine state (8 prefilled requests). With ``tol_frac``
    the logits agree within that fraction of the largest logit. Without
    it (a bf16 model) the plain path also runs in f32 on the same weights
    and pages upcast, and the limit is twice the plain bf16 path's
    distance from it: were the kernel path no further from the f32 path
    than the plain bf16 path is, the two bf16 paths could differ by at
    most that (the triangle inequality). ``engine_kw`` (``quant``,
    ``kv_quant``) goes to the engine; its model serves all runs, and an
    int8 pool stays int8 in the f32 run. With ``plain_model`` (the same
    weights, another model path: plain norms) the plain runs take that
    model through the paged kernel, so the check holds the model path
    alone."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE, **engine_kw)
    model = eng.model
    for p in prompts(model.config.vocab_size)[: SERVE["slots"]]:
        eng.submit(p, MAX_NEW)
    eng.step()  # admission, prefill, one window: the pages hold real rows
    eng._ensure_growth()  # the page top-up step() makes before a window
    dev = eng.device
    state = [torch.from_numpy(a).to(dev) for a in (
        eng.bt, eng.pooled_len, eng.done, eng.emitted, eng.budget, eng.eos)]
    seeds = torch.from_numpy(eng.seeds).to(dev)
    ref_kind, ref_model = (("reference", model) if plain_model is None
                           else ("kernel", plain_model))
    runs = [("kernel", model, eng.pool.dtype),
            (ref_kind, ref_model, eng.pool.dtype)]
    if tol_frac is None:
        runs.append((ref_kind, copy.deepcopy(ref_model).float(),
                     torch.float32))
    outs, window_ms = [], []
    for kind, m, pool_dtype in runs:
        pool = pool_copy(serving, eng.pool, pool_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(serving.decode_window(
            m, pool, eng.logits.clone(), *state, seeds, window=eng.window,
            rope_len=eng.block, paged_kernel=kind,
        )[0])
        torch.cuda.synchronize()
        window_ms.append(1e3 * (time.perf_counter() - t0))
    return {**hold_logits(outs, tol_frac, "window"),
            "window_ms_kernel": window_ms[0],
            "window_ms_plain": window_ms[1]}


def hold_logits(outs, tol_frac, what: str):
    """Logits through the kernel (``outs[0]``) against the plain path
    (``outs[1]``): within ``tol_frac`` of the largest logit, or, without
    it, within twice the plain path's distance from the plain path in
    f32 (``outs[2]``)."""
    a, b = outs[0], outs[1]
    if not all(torch.isfinite(o).all() for o in outs):
        raise AssertionError(f"non-finite logits in the {what} check")
    err = (a - b).abs().max().item()
    extra = {}
    if tol_frac is None:
        plain_to_f32 = (b - outs[2]).abs().max().item()
        extra = {"max_abs_plain_bf16_to_f32": plain_to_f32,
                 "max_abs_kernel_bf16_to_f32":
                     (a - outs[2]).abs().max().item()}
        tol = 2.0 * plain_to_f32
        rule = "2 x max |plain bf16 - plain f32| on the same weights, pages"
    else:
        tol = tol_frac * b.abs().max().item()
        rule = f"{tol_frac} x max |logit|"
    if not err <= tol:
        raise AssertionError(f"{what} logits disagree: {err} > {tol}")
    return {"max_abs_err": err, "tol": tol, "tol_rule": rule, **extra,
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean()
            .item(), "max_abs_logit": b.abs().max().item()}


def sampled_vs_greedy(serving, model, ps, new_tokens: int = 32):
    """The same requests served greedy and sampled (T=0.8, top-k 50, the
    Gumbel noise drawn on the card), each run timed on the host clock;
    the sampled run twice, to show its streams repeat."""
    out = {}
    for name, kw in [("greedy", {}),
                     ("sampled", dict(temperature=0.8, top_k=50, seed=3)),
                     ("sampled_again", dict(temperature=0.8, top_k=50,
                                            seed=3))]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serving.generate_served(model, ps, new_tokens, device=DEVICE,
                                       **SERVE, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not all(len(x) == new_tokens for x in toks):
            raise AssertionError(f"{name}: lengths {[len(x) for x in toks]}")
        out[name] = (toks, len(ps) * new_tokens / wall)
    if not all(np.array_equal(a, b) for a, b in zip(out["sampled"][0],
                                                    out["sampled_again"][0])):
        raise AssertionError("sampled streams differ between two runs")
    if all(np.array_equal(a, b) for a, b in zip(out["sampled"][0],
                                                out["greedy"][0])):
        raise AssertionError("sampled streams equal the greedy ones")
    return {"requests": len(ps), "max_new_tokens": new_tokens,
            "temperature": 0.8, "top_k": 50,
            "tokens_per_s_greedy": out["greedy"][1],
            "tokens_per_s_sampled": out["sampled"][1],
            "tokens_per_s_sampled_again": out["sampled_again"][1]}


def phase_serve(pa, serving, GPT, cfg):
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator): a short run, not counted
    serving.generate_served(model, ps[:2], 4, device=DEVICE, **SERVE)
    torch.cuda.synchronize()

    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    warm = warm_prefill(eng, ps)
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in ps]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    if eng.graph_captures != warm["captures"] + 1:  # the decode window
        raise AssertionError(f"captures inside the measured run: "
                             f"{eng.graph_captures} after {warm}")

    steps = eng.windows * eng.window
    tokens = [finished[r].tokens for r in rids]
    if not all(len(x) == MAX_NEW for x in tokens):
        raise AssertionError(f"lengths {[len(x) for x in tokens]}")
    if not all(0 <= t < cfg.vocab_size for x in tokens for t in x):
        raise AssertionError("token id outside the vocabulary")
    if launches != cfg.n_layer * steps or launches == 0:
        raise AssertionError(
            f"kernel launches {launches} != n_layer x decode steps "
            f"{cfg.n_layer} x {steps}")
    pages_home(eng)
    ttft = sorted(1e3 * (finished[r].first_token_time
                         - finished[r].submit_time) for r in rids)
    sampled = sampled_vs_greedy(serving, model, ps[: SERVE["slots"]])
    bf16 = window_agreement(model, serving)
    model32 = seeded_model(GPT, cfg)
    f32 = window_agreement(model32, serving, 1e-4)
    del model32
    rec = {
        "phase": "serve", "config": "openwebtext", "dtype": "bfloat16",
        **SERVE, "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
        "prompt_lens": [int(p.size) for p in ps],
        "tokens": int(sum(len(x) for x in tokens)), "wall_s": wall,
        "tokens_per_s": sum(len(x) for x in tokens) / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99)),
        "windows": eng.windows, "decode_steps": steps,
        "kernel_launches": launches, "stats": eng.stats(),
        "distinct_streams": len({tuple(x) for x in tokens}),
        "warm_prefill": warm,
        "window_check_bf16": bf16, "window_check_f32": f32,
        "sampled_vs_greedy": sampled,
    }
    emit(rec)
    return model, launches


GRAPH_TIMING_REPS = 20


class eager_programs:
    """Inside the block every engine runs each program's body eagerly
    (``Program.run_eager``), never its graph: the twin a replay is held
    to."""

    def __enter__(self):
        from midgpt_tpu_torch.serving.programs import Program

        self.cls, self.run = Program, Program.run
        Program.run = Program.run_eager
        return self

    def __exit__(self, *exc):
        self.cls.run = self.run


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a float compared through its integer view)."""
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}
    if a.dtype.is_floating_point:
        a, b = a.view(view[a.element_size()]), b.view(view[b.element_size()])
    return a.shape == b.shape and torch.equal(a, b)


def engine_tensors(eng) -> tp.List[torch.Tensor]:
    """What a dispatch writes: the carried logits and the pool's pages
    (and scale planes), every shard's under a tensor axis."""
    out = [eng.logits]
    for p in eng.pool.shards:
        out += [t for t in (p.k, p.v, p.scale_k, p.scale_v) if t is not None]
    return out


def dispatch_check(serving, model, ps, reps: int = GRAPH_TIMING_REPS,
                   **kw):
    """One dispatch of a warm program (an engine on ``ps[:8]``, two steps
    in: the program captured, the pages holding real rows) replayed and
    then run eagerly from the same state: the packed results, the
    carried logits and every page bit for bit. Then, on the same state
    again and again: the aten ops a replay dispatches, one dispatch's
    host ms (copies in, replay, read) beside the replay's device ms
    between CUDA events and the eager body's host ms, medians of
    ``reps``."""
    from midgpt_tpu_torch.ops import launches

    eng = serving.ServingEngine(model, slots=SPEC["slots"],
                                page_size=SPEC["page_size"], device=DEVICE,
                                **kw)
    for i, p in enumerate(ps[: SPEC["slots"]]):
        eng.submit(p, MAX_NEW, seed=i)
    eng.step()
    eng.step()
    eng._ensure_growth()
    decoding = eng._decoding_slots()
    kind = "verify" if eng.speculate else "decode_window"
    body = eng._verify_body if eng.speculate else eng._decode_body
    prog = eng._program(kind)
    extra = {}
    if eng.speculate:
        drafts, n_draft, probs = eng._draft(decoding)
        extra = dict(drafts=drafts, n_draft=n_draft, probs=probs)

    def load():
        eng._load(prog, **extra)

    start = [t.clone() for t in engine_tensors(eng)]
    load()
    prog.run(body)
    out_graph = prog.read()
    after_graph = [t.clone() for t in engine_tensors(eng)]
    for t, s in zip(engine_tensors(eng), start):
        t.copy_(s)
    load()
    prog.run_eager(body)
    out_eager = prog.read()
    same = {"results": bool(np.array_equal(out_graph, out_eager)),
            "logits": bits_equal(after_graph[0], eng.logits),
            "pages": all(bits_equal(a, b) for a, b in
                         zip(after_graph[1:], engine_tensors(eng)[1:]))}
    if not all(same.values()):
        diff = (after_graph[0] - eng.logits).abs().max().item()
        raise AssertionError(f"{kind}: a replay differs from the eager body "
                             f"{same}, max |logits diff| {diff}")
    load()
    torch.cuda.synchronize()
    ops = aten_ops(lambda: prog.run(body))
    if ops:
        raise AssertionError(f"{kind}: {ops} aten ops between the copies "
                             f"and the read")

    def host_ms(run) -> float:
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            load()
            run(body)
            prog.read()
            times.append(1e3 * (time.perf_counter() - t0))
        return statistics.median(times)

    graph_host = host_ms(prog.run)
    eager_host = host_ms(prog.run_eager)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        prog.graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    device = statistics.median(times)
    name = lambda d: {f.__name__: n for f, n in d.items()}  # noqa: E731
    return {"kind": kind, "bit_equal": same, "aten_ops_replay": ops,
            "capture_ms": prog.capture_ms,
            "graph_pool_bytes": eng.graph_pool_bytes,
            "replay_launches": name(prog.replay_launches),
            "warmup_launches": name(prog.warmup_launches),
            "host_ms": graph_host, "device_ms": device,
            "idle_share": 1.0 - device / graph_host,
            "eager_host_ms": eager_host,
            "eager_over_graph_host": eager_host / graph_host}


def graphs_case(pa, im, serving, model, ps, **kw):
    """Serve ``ps`` on serve's engine twice, the programs replayed and
    then run eagerly: equal streams and launch counts kernel by kernel;
    then :func:`dispatch_check`."""
    kernels = {"paged_decode_attention": pa.paged_decode_attention,
               "paged_verify_attention": pa.paged_verify_attention,
               "int8_matmul": im.int8_matmul}
    runs = {}
    for mode in ("graph", "eager"):
        with eager_programs() if mode == "eager" else contextlib.nullcontext():
            (eng, reqs, wall), _, counts = counted(
                kernels, lambda: serve_run(serving, model, ps, **kw))
        runs[mode] = (eng, [r.tokens for r in reqs],
                      {**run_record(eng, reqs, wall), "launches": counts})
    (geng, gstreams, grec), (_, estreams, erec) = runs["graph"], runs["eager"]
    if gstreams != estreams:
        raise AssertionError(f"{kw}: graphed streams differ from the eager "
                             f"body's")
    if grec["launches"] != erec["launches"]:
        raise AssertionError(f"{kw}: launches {grec['launches']} (graphs) "
                             f"!= {erec['launches']} (eager)")
    want = geng.model.config.n_layer * (
        geng.verify_dispatches if geng.speculate
        else geng.window * geng.windows)
    got = grec["launches"]["paged_verify_attention" if geng.speculate
                           else "paged_decode_attention"]
    expect_launches(f"{kw} paged", got, want)
    return {"graph": grec, "eager": erec, "streams_equal": True,
            "graph_captures": geng.graph_captures,
            "dispatch": dispatch_check(serving, model, ps, **kw)}


# the graphs phase serves every fourth of serve's 16 requests (every other
# before the cut that made room for serve_tensor): a quarter of the eager
# twins' host-bound windows
GRAPHS_EVERY = 4


def phase_graphs(pa, im, serving, model, cfg, gpu):
    """The graphs phase on serve's model (see the module docstring)."""
    out = {}
    cases = {"greedy": {}, "sampled": SAMPLED, "int8": INT8,
             "int8_sampled": {**INT8, **SAMPLED}}
    for name, kw in cases.items():
        for spec in (0, SPEC["speculate"]):
            ps = (spec_prompts(cfg.vocab_size) if spec else prompts(
                cfg.vocab_size))[::GRAPHS_EVERY]
            out[f"{name}_spec{spec}"] = graphs_case(
                pa, im, serving, model, ps, speculate=spec, **kw)
            gc.collect()
    rec = {"phase": "graphs", "config": "openwebtext", "dtype": "bfloat16",
           **SERVE, "speculate_on": SPEC["speculate"], "cases": out,
           "gpu": gpu}
    emit(rec)
    return rec


def warm_prefill(eng, ps) -> tp.Dict[str, tp.Any]:
    """``eng.warm_prefill`` for the longest of ``ps``: every bucket and
    class captured before a measured run. The buckets, the captures, each
    program's capture ms, the seconds and the engine's graph pool bytes
    before and after."""
    before = eng.graph_pool_bytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buckets = eng.warm_prefill(max(int(p.size) for p in ps))
    torch.cuda.synchronize()
    progs = {k: p for k, p in eng._programs.items()
             if k[0] == "prefill_chunk"}
    return {"buckets": buckets, "captures": eng.graph_captures,
            "seconds": time.perf_counter() - t0,
            "capture_ms": {f"{k[1]}{'_resumed' if k[2] else ''}":
                           p.capture_ms for k, p in progs.items()},
            "graph_pool_bytes_before": before,
            "graph_pool_bytes_after": eng.graph_pool_bytes}


PREFILL_STARTS = (0, 13, 32)  # a chunk at 0, mid-page, page-aligned
PREFILL_TIMING_BUCKET = 256  # serve's median prompt's bucket


def randomize_engine(eng, seed: int) -> None:
    """Random pages (int8 codes and po2 scales for an int8 pool) and
    logits, so a chunk reads and writes values that show a difference."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    for p in eng.pool.shards:
        if p.quantized:
            for plane in (p.k, p.v):
                plane.copy_(torch.randint(-127, 128, plane.shape,
                                          generator=gen, device=DEVICE,
                                          dtype=torch.int8))
            for plane in (p.scale_k, p.scale_v):
                plane.copy_(torch.exp2(torch.randint(
                    -9, -5, plane.shape, generator=gen,
                    device=DEVICE).float()))
        else:
            for plane in (p.k, p.v):
                plane.copy_(torch.randn(plane.shape, generator=gen,
                                        device=DEVICE))
    eng.logits.copy_(torch.randn(eng.logits.shape, generator=gen,
                                 device=DEVICE))


def chunk_inputs(eng, bucket: int, start: int, seed: int):
    """A chunk of ``bucket`` tokens for slot 1 at ``start``: its real
    length (3 short of the bucket, within the block), tokens and a block
    table of random pages."""
    rng = np.random.default_rng(seed)
    cfg = eng.model.config
    real_n = min(bucket - 3, cfg.block_size - start)
    bt = np.full((eng.pmax,), eng._sentinel, np.int32)
    n = -(-(start + real_n) // eng.page_size)
    bt[:n] = rng.permutation(eng.alloc.num_pages)[:n]
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :real_n] = rng.integers(0, cfg.vocab_size, real_n)
    return dict(slot=1, start=start, real_n=real_n, tokens=toks, bt=bt)


def prefill_replay_check(serving, model, starts=PREFILL_STARTS,
                         max_tokens: tp.Optional[int] = None,
                         timing: bool = True,
                         **kw) -> tp.Dict[str, tp.Any]:
    """The prefill programs of serve's engine on ``model`` (``kw``: the
    pool's and weights' quantization, a mesh): ``warm_prefill`` over the
    whole block, or ``max_tokens`` (every bucket, both classes; pool
    bytes before and after, capture ms per program), then every bucket at
    every start of ``starts`` from one state, replayed and then run eagerly:
    every page, scale plane and the logits bit for bit, the slot's row
    written and the other's not; a replay's aten ops (0); at
    ``PREFILL_TIMING_BUCKET`` a chunk's host ms (load and replay queued,
    beside the eager body's) and its replay's device ms (``timing``)."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE, **kw)
    randomize_engine(eng, SEED)
    state = [t.clone() for t in engine_tensors(eng)]
    block = np.zeros((1, max_tokens or model.config.block_size), np.int32)
    warm = warm_prefill(eng, block)
    for t, s in zip(engine_tensors(eng), state):
        if not bits_equal(t, s):
            raise AssertionError("warm_prefill wrote to the pool or logits")
    if warm["captures"] != 2 * len(warm["buckets"]):
        raise AssertionError(f"warm_prefill captured {warm['captures']} for "
                             f"{warm['buckets']}")
    checked = 0
    for bucket in warm["buckets"]:
        for start in starts:
            x = chunk_inputs(eng, bucket, start, bucket + start)
            prog = eng._prefill_program(bucket, start > 0)
            body = eng._prefill_body(start > 0)
            before = [t.clone() for t in engine_tensors(eng)]
            prog.load(**x)
            prog.run(body)
            replayed = [t.clone() for t in engine_tensors(eng)]
            for t, s in zip(engine_tensors(eng), before):
                t.copy_(s)
            prog.load(**x)
            prog.run_eager(body)
            same = [bits_equal(a, b) for a, b in
                    zip(engine_tensors(eng), replayed)]
            if not all(same) or bits_equal(replayed[0][1], before[0][1]) \
                    or not bits_equal(replayed[0][0], before[0][0]):
                raise AssertionError(f"prefill {bucket} at {start}: a replay "
                                     f"differs from the eager body {same}")
            checked += 1
    if not timing:
        return {"warm_prefill": warm, "checked_bit_equal": checked}
    timing = {}
    for start in (0, starts[-1]):
        x = chunk_inputs(eng, PREFILL_TIMING_BUCKET, start, 1)
        prog = eng._prefill_program(PREFILL_TIMING_BUCKET, start > 0)
        body = eng._prefill_body(start > 0)
        prog.load(**x)
        torch.cuda.synchronize()
        ops = aten_ops(lambda: prog.run(body))
        if ops:
            raise AssertionError(f"prefill: {ops} aten ops in a replay")

        def host_ms(run) -> float:
            times = []
            for _ in range(GRAPH_TIMING_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                prog.load(**x)
                run(body)
                times.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            return statistics.median(times)

        graph_host, eager_host = host_ms(prog.run), host_ms(prog.run_eager)
        times = []
        for _ in range(GRAPH_TIMING_REPS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            prog.graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        timing["resumed" if start else "start0"] = {
            "bucket": PREFILL_TIMING_BUCKET, "start": start,
            "real_n": x["real_n"], "aten_ops_replay": ops,
            "host_ms": graph_host, "device_ms": statistics.median(times),
            "eager_host_ms": eager_host,
            "replay_launches": {f.__name__: n for f, n in
                                prog.replay_launches.items()}}
    return {"warm_prefill": warm, "checked_bit_equal": checked,
            "timing": timing}


def phase_prefill_graphs(serving, model, gpu):
    """Serve's model's prefill programs, bf16 and int8 (weights and pool)
    (``prefill_replay_check``)."""
    rec = {"phase": "prefill_graphs", "config": "openwebtext",
           "dtype": "bfloat16", **SERVE, "starts": list(PREFILL_STARTS),
           "bf16": prefill_replay_check(serving, model),
           "int8": prefill_replay_check(serving, model, **INT8), "gpu": gpu}
    emit(rec)
    return rec


def eager_ms(fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    eager calls, CUDA events around each round. Where the host dispatches
    a call more slowly than the card runs it, this is the host's rate."""
    fn(0)
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(reps):
            fn(i)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``rounds`` times between CUDA events; the median per call.
    The replay takes the host's per-call dispatch out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def decode_bound(q, pk, lens, r, rr_bytes_row, extra_bytes=0):
    """Least time for one launch: bytes moved (q read, out written, the
    live K and V rows, the valid recent rows, the live table entries and
    the lengths, plus ``extra_bytes``: an int8 pool's live page scales)
    over HBM bandwidth, against the QK and PV multiply-adds over the peak
    rate of the pool's type."""
    s, hkv, g, c = q.shape
    esz = pk.element_size()
    live = int(lens.sum().item())
    ps = pk.shape[-1]
    pages = sum(-(-int(n) // ps) for n in lens.tolist())
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * live * hkv * c * esz
              + 2 * s * hkv * (r + 1) * rr_bytes_row
              + 4 * pages + 4 * s + extra_bytes)
    flops = 4 * (live + s * (r + 1)) * hkv * g * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[pk.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing(pa, cfg, gpu):
    """The kernel at the serve shapes: bf16 pool, 8 slots with resident
    lengths from the serve's prompt spread plus 32 generated tokens,
    r = R-1. The pool holds 4 x n_layer layers and launches rotate over
    them, so each launch finds its live rows (about 4 MB a layer) out of
    the 50 MB L2, as a decode step does after the other layers' weights
    have passed through it."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    lens = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    args = paged_inputs(hkv, g, c, torch.bfloat16, lens, layers=nl, seed=1)
    q, pk, pv, bt, pl, rk, rv = args
    r = R - 1

    def kernel(i):
        return pa.paged_decode_attention(q, pk, pv, bt, pl, rk, rv, r, i % nl)

    def plain(i):
        return pa.paged_decode_attention_reference(q, pk, pv, bt, pl, rk, rv,
                                                   r, i % nl)

    from midgpt_tpu_torch import sampling

    keys = torch.arange(S, dtype=torch.int64, device=DEVICE) * 977 + 5
    logits = torch.randn(S, cfg.vocab_size, device=DEVICE)

    def sample(i):
        return sampling.sample_token(
            logits, 0.8, 50, sampling.gumbel_noise(keys + i, cfg.vocab_size))

    sample_ms = device_ms(sample, reps=16)
    ms = device_ms(kernel, reps=2 * nl)
    plain_ms = device_ms(plain, reps=nl // 2)
    kernel_eager_ms = eager_ms(kernel, reps=2 * nl)
    got = pa.paged_decode_attention(q, pk, pv, bt, pl, rk, rv, r, 0)
    err, ratio = hold(got, plain32(pa, q, pk, pv, bt, pl, rk, rv, r, 0))
    if not ratio <= 1.0:
        raise AssertionError(f"serve-shape kernel error {err}: {ratio} x tol")
    bound_ms, bound_by = decode_bound(q, pk, pl, r, c * pk.element_size())
    rec = {"phase": "timing", "kernel": "paged_decode_attention",
           "shape": {"S": S, "Hkv": hkv, "G": g, "C": c, "PS": PS,
                     "Pmax": PMAX, "R": R, "r": r, "lens": lens,
                     "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms, "eager_ms": kernel_eager_ms,
           "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None,
           "frac_of_bound": bound_ms / ms, "max_abs_err": err,
           "err_over_tol": ratio,
           "sample_ms": sample_ms, "sample_shape": [S, cfg.vocab_size],
           "gpu": gpu}
    emit(rec)
    return rec


# -- serving with speculation: the paged verify kernel ---------------------

SPEC = dict(slots=8, page_size=16, speculate=4)
VERIFY_TS = (2, 5, 8)  # candidate rows per slot in the verify_kernel phase
MOTIF = 8  # the repetitive half's motif length
SAMPLED = dict(temperature=0.8, top_k=50, seed=3)


def verify_inputs(hkv, g, c, tt, dtype, starts, layers=2, seed=0,
                  pmax=PMAX):
    """Random pools, queries and candidate rows on the card; every slot
    owns distinct pages for its resident tokens and the dispatch's rows,
    and its table pads hold the sentinel page id."""
    gen = torch.Generator().manual_seed(seed)
    live = [-(-(n + tt) // PS) for n in starts]
    num_pages = sum(live) + 1
    f = lambda *sh: torch.randn(*sh, generator=gen)  # noqa: E731
    s = len(starts)
    q = f(s, hkv, g, tt, c)
    kc, vc = f(s, hkv, tt, c), f(s, hkv, tt, c)
    pk = f(layers, num_pages, hkv, c, PS)
    pv = f(layers, num_pages, hkv, c, PS)
    bt = torch.full((s, pmax), num_pages, dtype=torch.int32)
    perm = torch.randperm(num_pages, generator=gen).tolist()
    at = 0
    for i, n in enumerate(live):
        bt[i, :n] = torch.tensor(perm[at : at + n], dtype=torch.int32)
        at += n
    dev = torch.device(DEVICE)
    out = [a.to(dev, dtype) for a in (q, kc, vc, pk, pv)]
    return out + [bt.to(dev), torch.tensor(starts, dtype=torch.int32,
                                            device=dev)]


def plain32_verify(pa, q, kc, vc, pk, pv, bt, st, layer):
    """The plain verify version on the same inputs upcast to f32."""
    return pa.paged_verify_attention_reference(
        q.float(), kc.float(), vc.float(), pk.float(), pv.float(), bt, st,
        layer)


def verify_peek(q, kc, vc, pk, pv, bt, st, layer):
    """A faulted plain verify in f32: row t also sees candidate row t + 1
    (the self mask one row too wide)."""
    s, hkv, g, t, c = q.shape
    num_pages, ps = pk.shape[1], pk.shape[-1]
    w = bt.shape[1] * ps
    idx = bt.long().clamp(0, num_pages - 1)
    ck, cv = (pool[layer][idx].permute(0, 2, 3, 1, 4).reshape(s, hkv, c, w)
              .float() for pool in (pk, pv))
    cols = torch.arange(w, device=q.device)
    mask_pool = torch.where(cols[None] < st[:, None].long(), 0.0,
                            -float("inf"))[:, None, None, None, :]
    ii = torch.arange(t, device=q.device)
    mask_self = torch.where(ii[None, :] <= ii[:, None] + 1, 0.0,
                            -float("inf"))
    qf = q.float()
    scores = torch.cat([
        torch.einsum("shgtc,shcw->shgtw", qf, ck) + mask_pool,
        torch.einsum("shgtc,shjc->shgtj", qf, kc.float()) + mask_self,
    ], dim=-1)
    probs = torch.softmax(scores / c ** 0.5, dim=-1)
    return (torch.einsum("shgtw,shcw->shgtc", probs[..., :w], cv)
            + torch.einsum("shgtj,shjc->shgtc", probs[..., w:], vc.float()))


def phase_verify_kernel(pa) -> float:
    """The verify kernel against its plain version (:func:`hold`) at both
    geometries, bf16 and f32, T in VERIFY_TS, resident lengths ``LENS``
    capped at W - T. The same check must refuse the kernel's output
    against (a) a plain run with each slot's last resident column
    dropped and (b) a plain run whose self mask lets row t see row t + 1;
    the least err/tol over the slots is printed for each."""
    worst = 0.0
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            for tt in VERIFY_TS:
                starts = [min(n, PMAX * PS - tt) for n in LENS]
                args = verify_inputs(hkv, g, c, tt, dtype, starts)
                got = pa.paged_verify_attention(*args, 1)
                torch.cuda.synchronize()
                ref = pa.paged_verify_attention_reference(*args, 1)
                ref32 = plain32_verify(pa, *args, 1)
                err, ratio = hold(got, ref32)
                dropped = plain32_verify(pa, *args[:6],
                                         (args[6] - 1).clamp_min(0), 1)
                drop_ratio = min(hold(got[i], dropped[i])[1]
                                 for i, n in enumerate(starts) if n > 0)
                peek = verify_peek(*args, 1)
                peek_ratio = min(hold(got[i], peek[i])[1]
                                 for i in range(len(starts)))
                # row t is the decode kernel's step t with the candidate
                # rows as recent rows: the same columns, split and summed
                # alike, so the same bits
                q, kc, vc, pk, pv, bt, st = args
                steps_equal = all(torch.equal(
                    got[:, :, :, t], pa.paged_decode_attention(
                        q[:, :, :, t].contiguous(), pk, pv, bt, st, kc, vc,
                        t, 1)) for t in range(tt))
                emit({"phase": "verify_kernel",
                      "kernel": "paged_verify_attention", "geometry": name,
                      "hkv": hkv, "g": g, "c": c, "t": tt,
                      "dtype": str(dtype).split(".")[-1], "starts": starts,
                      "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      "max_abs_err_vs_plain_same_dtype":
                          (got.float() - ref.float()).abs().max().item(),
                      "dropped_column_min_slot_err_over_tol": drop_ratio,
                      "self_peek_min_slot_err_over_tol": peek_ratio,
                      "rows_equal_decode_steps": steps_equal})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"verify kernel disagrees with its plain version: "
                        f"{name} {dtype} T={tt}: {ratio} x the tolerance")
                if not (drop_ratio > 1.0 and peek_ratio > 1.0):
                    raise AssertionError(
                        f"the check passes a fault: {name} {dtype} T={tt}: "
                        f"dropped column {drop_ratio}, self peek "
                        f"{peek_ratio}")
                if not steps_equal:
                    raise AssertionError(
                        f"verify rows differ from decode steps: {name} "
                        f"{dtype} T={tt}")
                worst = max(worst, err)
    return worst


LONG_PMAX = 2048  # pages of PS in the long_table phase: 32,768 tokens
LONG_LENS = [LONG_PMAX * PS, 9001, 5]


def merge_bytes(lens, hkv, rows, c, split_tokens=64):
    """The f32 split states the merge reads: per slot and KV head, each
    live split's ``rows`` partial outputs of ``c`` and their ``(m, l)``
    pairs (splits of 64 tokens at PS = 16)."""
    splits = sum(-(-int(n) // split_tokens) for n in lens)
    return 4 * splits * hkv * rows * (c + 2)


def phase_long_table(pa, gpu):
    """Both paged kernels over a 32,768-token table (Pmax = 2,048 pages of
    16; slots at the full table, mid-table and a few tokens) at both
    geometries, bf16, held to the plain version (:func:`hold`): decode at
    r = R - 1, verify at T = speculate + 1. The split block's shared
    memory does not grow with the table, so this is the serve cells'
    kernel, not a long-context variant. Each kernel is then timed there
    from a CUDA graph (:func:`device_ms`), beside its plain version and
    its bound (:func:`decode_bound`, :func:`verify_bound`; the table's
    live K and V rows, 128 MB at openwebtext's geometry, pass the 50 MB
    L2). The splits' merge runs inside the kernel (the last block of each
    slot and KV head), so its share is not timed apart; the record gives
    the f32 scratch it reads. Returns the worst error and the timings by
    geometry."""
    worst, times = 0.0, {}
    tt = SPEC["speculate"] + 1
    for name, hkv, g, c in GEOMS:
        args = paged_inputs(hkv, g, c, torch.bfloat16, LONG_LENS,
                            pmax=LONG_PMAX)
        got = pa.paged_decode_attention(*args, R - 1, 1)
        torch.cuda.synchronize()
        derr, dratio = hold(got, plain32(pa, *args, R - 1, 1))
        starts = [min(n, LONG_PMAX * PS - tt) for n in LONG_LENS]
        vargs = verify_inputs(hkv, g, c, tt, torch.bfloat16, starts,
                              pmax=LONG_PMAX)
        vgot = pa.paged_verify_attention(*vargs, 1)
        torch.cuda.synchronize()
        verr, vratio = hold(vgot, plain32_verify(pa, *vargs, 1))
        plan = pa.kernel_plan(g * tt, c, PS, LONG_PMAX, torch.bfloat16, tt)
        dplan = pa.kernel_plan(g, c, PS, LONG_PMAX, torch.bfloat16, R)
        if not (dratio <= 1.0 and vratio <= 1.0):
            raise AssertionError(
                f"long table: {name}: decode {dratio}, verify {vratio} x tol")
        q, pk, pv, bt, pl, rk, rv = args
        dbound, dby = decode_bound(q, pk, pl, R - 1, c * pk.element_size())
        vbound, vby = verify_bound(vargs[0], vargs[3], starts)
        t = {
            "decode": {
                "ms": device_ms(lambda i: pa.paged_decode_attention(
                    *args, R - 1, i % 2), reps=10),
                "plain_ms": device_ms(
                    lambda i: pa.paged_decode_attention_reference(
                        *args, R - 1, i % 2), reps=2, rounds=3),
                "bound_ms": dbound, "bound_by": dby,
                "merge_scratch_bytes": merge_bytes(LONG_LENS, hkv, g, c)},
            "verify": {
                "ms": device_ms(lambda i: pa.paged_verify_attention(
                    *vargs, i % 2), reps=10),
                "plain_ms": device_ms(
                    lambda i: pa.paged_verify_attention_reference(
                        *vargs, i % 2), reps=2, rounds=3),
                "bound_ms": vbound, "bound_by": vby,
                "merge_scratch_bytes": merge_bytes(starts, hkv, g * tt, c)},
        }
        for k in t.values():
            k["frac_of_bound"] = k["bound_ms"] / k["ms"]
        times[name] = t
        emit({"phase": "long_table", "geometry": name, "hkv": hkv, "g": g,
              "c": c, "pmax": LONG_PMAX, "ps": PS, "lens": LONG_LENS,
              "verify_starts": starts, "t": tt, "r": R - 1,
              "dtype": "bfloat16", "plan_verify": plan, "plan_decode": dplan,
              "decode_max_abs_err": derr, "decode_err_over_tol": dratio,
              "verify_max_abs_err": verr, "verify_err_over_tol": vratio,
              "timing": t, "merge_share": "not timed apart: the merge runs "
              "in the last block of each (slot, KV head)", "gpu": gpu})
        worst = max(worst, derr, verr)
        del args, vargs, got, vgot, q, pk, pv, bt, pl, rk, rv
        gc.collect()
        torch.cuda.empty_cache()
    return worst, times


def spec_prompts(vocab: int):
    """The serve_spec traffic: the first eight serve prompts, then eight
    repetitive ones, a seeded 8-token motif tiled to 64, 128, ..., 512."""
    motif = np.random.default_rng(SEED + 1).integers(0, vocab, size=MOTIF)
    rep = [np.tile(motif, n // MOTIF).astype(np.int32)
           for n in range(64, 513, 64)]
    return prompts(vocab)[:8] + rep


def serve_run(serving, model, ps, **kw):
    """Serve ``ps`` (request seed = index), ``MAX_NEW`` tokens each, on
    one engine, its prefill programs warmed first; host clock around
    submit and drain."""
    eng = serving.ServingEngine(model, slots=SPEC["slots"],
                                page_size=SPEC["page_size"], device=DEVICE,
                                **kw)
    eng.warm_prefill(max(p.size for p in ps))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [finished[r] for r in rids]
    if not all(len(r.tokens) == MAX_NEW for r in reqs):
        raise AssertionError(f"lengths {[len(r.tokens) for r in reqs]}")
    pages_home(eng)
    return eng, reqs, wall


def run_record(eng, reqs, wall):
    ttft = sorted(1e3 * (r.first_token_time - r.submit_time) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99)),
            "dispatches": eng.decode_dispatches,
            "tokens_per_dispatch": tokens / eng.decode_dispatches}


def spec_half(reqs):
    """A half's drafts and acceptance. Without EOS, and with drafts cut
    to the budget, each dispatch a request takes part in emits 1 + its
    accepted drafts, so its dispatches are tokens - accepted."""
    tokens = sum(len(r.tokens) for r in reqs)
    drafted = sum(r.spec_drafted for r in reqs)
    accepted = sum(r.spec_accepted for r in reqs)
    return {"tokens": tokens, "drafted": drafted, "accepted": accepted,
            "acceptance": accepted / max(1, drafted),
            "tokens_per_dispatch_per_slot": tokens / (tokens - accepted)}


def verify_agreement(model, serving, tol_frac=None, **engine_kw):
    """One verify dispatch's logits ``[S, T, V]`` through the kernel and
    through the plain path, from the same engine state: the repetitive
    half prefilled and served until the proposer drafts (at most four
    dispatches), then the next dispatch's rows (:func:`hold_logits`).
    ``engine_kw`` as in :func:`window_agreement`."""
    from midgpt_tpu_torch.models.gpt import verify_tokens_paged

    eng = serving.ServingEngine(model, **SPEC, device=DEVICE, **engine_kw)
    model = eng.model
    for p in spec_prompts(model.config.vocab_size)[SPEC["slots"]:]:
        eng.submit(p, MAX_NEW)
    for _ in range(4):
        eng.step()  # (admission, prefill,) one verify dispatch
        eng._ensure_growth()  # the page top-up step() makes first
        drafts, n_draft, _ = eng._draft(eng._active_slots())
        if n_draft.sum():
            break
    dev = eng.device
    cand = torch.cat([eng.logits.argmax(-1).to(torch.int32)[:, None],
                      torch.from_numpy(drafts).to(dev)], dim=1)
    bt = torch.from_numpy(eng.bt).to(dev)
    start = torch.from_numpy(eng.pooled_len).to(dev)
    runs = [("kernel", model, eng.pool.dtype),
            ("reference", model, eng.pool.dtype)]
    if tol_frac is None:
        runs.append(("reference", copy.deepcopy(model).float(), torch.float32))
    outs, ms = [], []
    for kind, m, pool_dtype in runs:
        pool = pool_copy(serving, eng.pool, pool_dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(verify_tokens_paged(
            m, cand, start, pool.k, pool.v, bt, eng.block, paged_kernel=kind,
            pool_sk=pool.scale_k, pool_sv=pool.scale_v)[0].float())
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return {**hold_logits(outs, tol_frac, "verify"),
            "rows": list(cand.shape), "drafted": int(n_draft.sum()),
            "verify_ms_kernel": ms[0], "verify_ms_plain": ms[1]}


def spec_profile(serving, model, ps, gpu, dispatches: int = 8):
    """Where a verify dispatch's time goes: an engine on the serve_spec
    traffic, admitted and past its first dispatch, then ``dispatches``
    steps under ``torch.profiler`` with the host clock around them."""
    import re

    from torch.profiler import ProfilerActivity, profile

    eng = serving.ServingEngine(model, **SPEC, device=DEVICE)
    for i, p in enumerate(ps[SPEC["slots"]:]):
        eng.submit(p, MAX_NEW, seed=i)
    eng.step()
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(dispatches):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels, host_calls = {}, 0
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / dispatches)
        elif e.key.startswith("aten::"):
            host_calls += e.count
    groups = {"paged verify kernel": r"paged_attn_kernel",
              "matmul (cuBLAS)": r"nvjet|gemm|xmma|cutlass|cublas",
              "elementwise and reductions": r"at::native"}
    by_group = {k: 0.0 for k in groups}
    by_group["other"] = 0.0
    for kname, ms in kernels.items():
        hit = next((k for k, pat in groups.items()
                    if re.search(pat, kname, re.IGNORECASE)), "other")
        by_group[hit] += ms
    busy = sum(kernels.values())
    dispatch_ms = wall_ms / dispatches
    return {"dispatches": dispatches, "dispatch_ms_host": dispatch_ms,
            "device_busy_ms_per_dispatch": busy,
            "idle_share": (1 - busy / dispatch_ms) if busy else None,
            "device_ms_per_dispatch_by_group": by_group,
            "host_aten_calls_per_dispatch": host_calls / dispatches,
            "gpu": gpu}


def phase_serve_spec(pa, serving, GPT, cfg, gpu):
    """The speculative serving main path at the full width of
    ``openwebtext`` (bf16 weights and pool): ServingEngine(slots=8,
    page_size=16, speculate=4) on 16 greedy requests of 64 new tokens,
    eight of the serve prompts and eight repetitive ones. Launch counts
    are read around that run alone: verify kernel launches must equal
    n_layer x verify dispatches, decode kernel launches 0. Beside it:
    the same requests spec-off (window=4), timed; the share of requests
    whose spec-on stream equals spec-off (printed, not asserted: cuBLAS
    may sum an [S*T, D] row otherwise than an [S, D] one); one verify
    dispatch's logits through the kernel against the plain path (bf16
    and f32); sampled spec-on twice, whose streams must repeat and begin
    with the spec-off sampled run's first tokens; a profile."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = spec_prompts(cfg.vocab_size)
    # warm-up (the verify shapes' cuBLAS handles): a short run, not counted
    serving.generate_served(model, ps[:2], 4, device=DEVICE, speculate=4,
                            page_size=SPEC["page_size"])
    torch.cuda.synchronize()

    pa.paged_verify_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    eng, reqs, wall = serve_run(serving, model, ps,
                                speculate=SPEC["speculate"])
    launches = pa.paged_verify_attention.launches
    decode_launches = pa.paged_decode_attention.launches
    if not all(0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        raise AssertionError("token id outside the vocabulary")
    if (launches != cfg.n_layer * eng.verify_dispatches or launches == 0
            or decode_launches != 0):
        raise AssertionError(
            f"verify launches {launches} != n_layer x verify dispatches "
            f"{cfg.n_layer} x {eng.verify_dispatches}, or decode launches "
            f"{decode_launches} != 0")
    halves = {"random": spec_half(reqs[:8]), "repetitive": spec_half(reqs[8:])}
    rep = halves["repetitive"]
    if not (rep["accepted"] > 0 and rep["tokens_per_dispatch_per_slot"] > 1):
        raise AssertionError(f"no draft accepted on repetitive text: {rep}")
    on = run_record(eng, reqs, wall)

    eng_off, reqs_off, wall_off = serve_run(serving, model, ps, window=4)
    off = run_record(eng_off, reqs_off, wall_off)
    diverge = []
    for i, (a, b) in enumerate(zip(reqs, reqs_off)):
        if a.tokens != b.tokens:
            diverge.append([i, next(j for j, (x, y) in enumerate(
                zip(a.tokens, b.tokens)) if x != y)])

    check_bf16 = verify_agreement(model, serving)
    model32 = seeded_model(GPT, cfg)
    check_f32 = verify_agreement(model32, serving, 1e-4)
    del model32

    sampled = [serve_run(serving, model, ps, speculate=SPEC["speculate"],
                         **SAMPLED) for _ in range(2)]
    sampled_off = serve_run(serving, model, ps, window=4, **SAMPLED)
    streams = [[r.tokens for r in run[1]] for run in sampled]
    if streams[0] != streams[1]:
        raise AssertionError("sampled spec-on streams differ between runs")
    firsts = [r.tokens[0] for r in sampled_off[1]]
    if [x[0] for x in streams[0]] != firsts:
        raise AssertionError("sampled spec-on first tokens != spec-off's")
    if streams[0] == [r.tokens for r in reqs]:
        raise AssertionError("sampled streams equal the greedy ones")
    prof = spec_profile(serving, model, ps, gpu)
    rec = {
        "phase": "serve_spec", "config": "openwebtext", "dtype": "bfloat16",
        **SPEC, "requests": len(ps), "max_new_tokens": MAX_NEW,
        "prompt_lens": [int(p.size) for p in ps],
        "spec_on": on, "spec_off_window_4": off,
        "verify_dispatches": eng.verify_dispatches,
        "verify_kernel_launches": launches,
        "decode_kernel_launches": decode_launches,
        "stats": eng.stats(), "halves": halves,
        "greedy_equal_share": 1 - len(diverge) / len(ps),
        "greedy_first_divergence": diverge,
        "verify_check_bf16": check_bf16, "verify_check_f32": check_f32,
        "sampled": {**SAMPLED, "repeat": True, "first_tokens_equal": True,
                    "tokens_per_s": [run_record(*run)["tokens_per_s"]
                                     for run in sampled],
                    "tokens_per_s_spec_off":
                        run_record(*sampled_off)["tokens_per_s"],
                    "acceptance": sampled[0][0].stats()[
                        "spec_acceptance_rate"]},
        "profile": prof, "gpu": gpu,
    }
    emit(rec)
    del model
    return rec


def verify_bound(q, pk, starts, row_esz=None, extra_bytes=0):
    """Least time for one verify launch: bytes moved (q read, out written,
    the candidate rows' K and V at ``row_esz`` bytes an element, the pool's
    by default, the live K and V rows of the pool, the live table entries
    and the lengths, plus ``extra_bytes``) over HBM bandwidth, against the
    QK and PV multiply-adds (row t of a slot over its resident columns
    and self rows 0..t) over the peak rate of the pool's type."""
    s, hkv, g, tt, c = q.shape
    esz = pk.element_size()
    row_esz = esz if row_esz is None else row_esz
    ps = pk.shape[-1]
    live = sum(starts)
    pages = sum(-(-n // ps) for n in starts)
    nbytes = (2 * q.numel() * q.element_size()
              + 2 * s * hkv * tt * c * row_esz
              + 2 * live * hkv * c * esz + 4 * pages + 4 * s + extra_bytes)
    flops = 4 * c * hkv * g * (tt * live + s * tt * (tt + 1) // 2)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[pk.dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing_verify(pa, cfg, gpu):
    """The verify kernel at the serve_spec shapes: bf16 pool, 8 slots with
    resident lengths from the serve prompts' spread plus 32 generated
    tokens, T = speculate + 1 rows. As in :func:`phase_timing`, the pool
    holds 4 x n_layer layers and launches rotate over them."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    tt = SPEC["speculate"] + 1
    starts = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    args = verify_inputs(hkv, g, c, tt, torch.bfloat16, starts, layers=nl,
                         seed=1)

    def kernel(i):
        return pa.paged_verify_attention(*args, i % nl)

    def plain(i):
        return pa.paged_verify_attention_reference(*args, i % nl)

    ms = device_ms(kernel, reps=2 * nl)
    plain_ms = device_ms(plain, reps=nl // 2)
    eager = eager_ms(kernel, reps=2 * nl)
    got = pa.paged_verify_attention(*args, 0)
    err, ratio = hold(got, plain32_verify(pa, *args, 0))
    if not ratio <= 1.0:
        raise AssertionError(f"serve-shape verify error {err}: {ratio} x tol")
    bound_ms, bound_by = verify_bound(args[0], args[3], starts)
    rec = {"phase": "timing", "kernel": "paged_verify_attention",
           "shape": {"S": S, "Hkv": hkv, "G": g, "T": tt, "C": c, "PS": PS,
                     "Pmax": PMAX, "starts": starts, "dtype": "bfloat16"},
           "ms": ms, "plain_ms": plain_ms, "eager_ms": eager,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "library": "none: no PyTorch call walks a block table",
           "launches_per_dispatch": cfg.n_layer,
           "frac_of_bound": bound_ms / ms, "max_abs_err": err,
           "err_over_tol": ratio, "gpu": gpu}
    emit(rec)
    return rec


# -- int8 serving: the int8 branch of the paged kernels ---------------------

INT8 = dict(quant="int8", kv_quant="int8")


def quantize_pages(pa_args, pool_idx):
    """The float pools at ``pool_idx`` of a kernel's argument list as an
    int8 pool: each (layer, page, KV head) on its own po2 grid
    (``po2_ceil(absmax / 127)``), as the engine's page-birth scales put
    real rows. Returns the new argument list (pools int8, self rows bf16)
    and the scale planes ``[L, NP, Hkv]``."""
    from midgpt_tpu_torch.quant import po2_ceil_exact

    args = list(pa_args)
    planes = []
    for i in pool_idx:
        x = args[i].float()
        plane = po2_ceil_exact(x.abs().amax((-1, -2)) / 127.0)
        args[i] = torch.round(x / plane[..., None, None]).to(torch.int8)
        planes.append(plane)
    return args, planes


def gathered(planes, bt, layer):
    """Each slot's page scales ``[S, Pmax, Hkv]`` (pads clipped)."""
    return [p[layer][bt.long().clamp(0, p.shape[1] - 1)] for p in planes]


def int8_case(kind, hkv, g, c, dtype, lens, tt=None, layers=2, seed=0):
    """An int8-pool case for one kernel branch: ``(args, planes)`` where
    ``args`` are the wrapper's positional inputs before the layer (q in
    ``dtype``, pools int8, self rows bf16) and ``planes`` the pools'
    scale planes."""
    if kind == "decode":
        base = paged_inputs(hkv, g, c, torch.float32, lens, layers, seed)
        args, planes = quantize_pages(base, (1, 2))
        rows = (5, 6)
    else:
        base = verify_inputs(hkv, g, c, tt, torch.float32, lens, layers, seed)
        args, planes = quantize_pages(base, (3, 4))
        rows = (1, 2)
    args[0] = args[0].to(dtype)
    for i in rows:
        args[i] = args[i].to(torch.bfloat16)
    return args, planes


def int8_run(pa, kind, args, planes, layer, r=None, plain=False):
    """The int8 branch (or its plain version, in f32 on the upcast q and
    self rows) on ``args`` with the scales gathered from ``planes``."""
    bt = args[3] if kind == "decode" else args[5]
    scales = gathered(planes, bt, layer)
    if kind == "decode":
        if plain:
            q, pk, pv, bt, pl, rk, rv = args
            return pa.paged_decode_attention_reference(
                q.float(), pk, pv, bt, pl, rk.float(), rv.float(), r, layer,
                *scales)
        return pa.paged_decode_attention(*args, r, layer, *scales)
    if plain:
        q, kc, vc, pk, pv, bt, st = args
        return pa.paged_verify_attention_reference(
            q.float(), kc.float(), vc.float(), pk, pv, bt, st, layer, *scales)
    return pa.paged_verify_attention(*args, layer, *scales)


def phase_kernel_int8(pa) -> float:
    """Both int8 branches against their plain versions (:func:`hold`):
    both geometries, ragged lengths, decode r in (0, R-1) and verify T in
    VERIFY_TS, q bf16 and f32. The same check must refuse the kernel's
    output against the plain version (a) with each live slot's first
    page's scale doubled and (b) with the codes read without their
    scales; the least err/tol over the live slots is printed for each."""
    worst, layer = 0.0, 1
    cases = [("decode", {"r": r}) for r in (0, R - 1)]
    cases += [("verify", {"t": tt}) for tt in VERIFY_TS]
    for name, hkv, g, c in GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            for kind, at in cases:
                tt = at.get("t")
                lens = LENS if tt is None else [min(n, PMAX * PS - tt)
                                                for n in LENS]
                args, planes = int8_case(kind, hkv, g, c, dtype, lens, tt)
                bt = args[3] if kind == "decode" else args[5]
                r = at.get("r")
                got = int8_run(pa, kind, args, planes, layer, r)
                torch.cuda.synchronize()
                err, ratio = hold(got, int8_run(pa, kind, args, planes,
                                                layer, r, plain=True))
                live = [i for i, n in enumerate(lens) if n > 0]
                doubled = [p.clone() for p in planes]
                for p in doubled:
                    p[layer, bt[live, 0].long()] *= 2.0
                ones = [torch.ones_like(p) for p in planes]
                faults = {}
                for fname, fp in (("scale_doubled", doubled),
                                  ("codes_unscaled", ones)):
                    ref = int8_run(pa, kind, args, fp, layer, r, plain=True)
                    faults[fname] = min(hold(got[i], ref[i])[1] for i in live)
                emit({"phase": "kernel_int8",
                      "kernel": f"paged_{kind}_attention[int8]",
                      "geometry": name, "hkv": hkv, "g": g, "c": c, **at,
                      "q_dtype": str(dtype).split(".")[-1], "lens": lens,
                      "max_abs_err": err, "err_over_tol": ratio,
                      "tol": f"{ABS_TOL} + "
                             f"{2.0 ** -8 if dtype == torch.bfloat16 else 0}"
                             " * |kernel output| per element",
                      **{f"{k}_min_slot_err_over_tol": v
                         for k, v in faults.items()}})
                if not ratio <= 1.0:
                    raise AssertionError(
                        f"int8 {kind} kernel disagrees with its plain "
                        f"version: {name} {dtype} {at}: {ratio} x tol")
                if not min(faults.values()) > 1.0:
                    raise AssertionError(
                        f"the check passes a fault: int8 {kind} {name} "
                        f"{dtype} {at}: {faults}")
                worst = max(worst, err)
    return worst


def projection_bytes_and_ms(model, cfg):
    """One decode step's projections (12 blocks' wqkv, wo, w_up, w_down and
    the head) at 8 rows in bf16, each through its own layer's weights (so
    a step's 127 MB of codes, like the model's, pass the 50 MB L2): device
    ms of the bf16 Linears, of the int8 QuantLinears (the int8 matmul
    kernel, which reads the codes) and of their plain version (``w_int8.
    to(bf16)`` writes a bf16 copy of each weight, which cuBLAS then
    reads), and the bytes each must move: bf16 2 B a weight; the kernel 1
    B; the plain version 1 + 2 + 2 B (read the codes, write the copy, read
    it); activations and scales beside."""
    from midgpt_tpu_torch.ops.int8_matmul import int8_matmul_reference
    from midgpt_tpu_torch.quant import quantize_model

    qm = quantize_model(model)
    out = {"bf16_ms": 0.0, "int8_kernel_ms": 0.0, "int8_plain_ms": 0.0,
           "bf16_bytes": 0, "int8_plain_bytes": 0, "int8_kernel_bytes": 0}
    with torch.no_grad():
        for lins, qlins in projection_layers(model, qm):
            d_in, d_out = lins[0].weight.shape
            n = len(lins)
            x = torch.randn(S, d_in, device=DEVICE, dtype=torch.bfloat16)
            act = 2 * S * (d_in + d_out)
            out["bf16_ms"] += n * device_ms(lambda i: lins[i % n](x),
                                            reps=2 * n)
            out["int8_kernel_ms"] += n * device_ms(lambda i: qlins[i % n](x),
                                                   reps=2 * n)
            out["int8_plain_ms"] += n * device_ms(
                lambda i: int8_matmul_reference(x, qlins[i % n].weight,
                                                qlins[i % n].scale),
                reps=2 * n)
            out["bf16_bytes"] += n * (2 * d_in * d_out + act)
            out["int8_plain_bytes"] += n * (5 * d_in * d_out + act
                                            + 4 * d_out)
            out["int8_kernel_bytes"] += n * (d_in * d_out + act + 4 * d_out)
    del qm
    return out


def projection_layers(model, qm):
    """Per projection of the model (wqkv, wo, w_up, w_down, the head): its
    Linears and QuantLinears over the layers, as ``(lins, qlins)``."""
    out = []
    for get in (lambda b: b.attn.wqkv, lambda b: b.attn.wo,
                lambda b: b.mlp.w_up, lambda b: b.mlp.w_down):
        out.append(([get(b) for b in model.blocks],
                    [get(b) for b in qm.blocks]))
    out.append(([model.lm_head], [qm.lm_head]))
    return out


def phase_serve_int8(pa, im, serving, GPT, cfg, gpu):
    """The int8 serving main path at the full width and depth of
    ``openwebtext`` (random init from the seed, bf16): ``quant="int8",
    kv_quant="int8"`` on the 16 serve prompts, 64 new tokens each,
    spec-off (window 4) and ``speculate=4``, beside the bf16 engine on the
    same requests in turns (bf16, int8, int8, bf16). Launch counts are
    read around each int8 run alone: spec-off decode launches = n_layer x
    decode steps and no verify launch; spec-on verify launches = n_layer
    x verify dispatches and no decode launch. One window's and one
    verify dispatch's logits through the int8 kernels are held to the
    plain path on the same state (bf16 by the triangle rule, f32 within
    1e-4 of the largest logit)."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    # warm-up (the int8 shapes' cuBLAS handles): short runs, not counted
    for spec in (0, SPEC["speculate"]):
        serving.generate_served(model, ps[:2], 4, device=DEVICE,
                                speculate=spec, page_size=PS, **INT8)
    torch.cuda.synchronize()

    runs, mm = {}, {}
    for name, kw in (("bf16_off", dict(window=4)),
                     ("int8_off", dict(window=4, **INT8)),
                     ("int8_on", dict(speculate=SPEC["speculate"], **INT8)),
                     ("bf16_on", dict(speculate=SPEC["speculate"]))):
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        im.int8_matmul.launches = 0
        eng, reqs, wall = serve_run(serving, model, ps, **kw)
        runs[name] = (eng, reqs, wall, pa.paged_decode_attention.launches,
                      pa.paged_verify_attention.launches)
        mm[name] = im.int8_matmul.launches
    for name in runs:
        e = runs[name][0]
        forwards = (e.verify_dispatches if e.speculate
                    else e.windows * e.window) + e.prefill_dispatches
        want = projections(e.model) * forwards if "int8" in name else 0
        if mm[name] != want:
            raise AssertionError(
                f"{name}: int8 matmul launches {mm[name]} != projections x "
                f"model forwards = {want}")
    eng, reqs, _, dec, ver = runs["int8_off"]
    if not eng.pool.quantized or eng.pool.k.dtype != torch.int8:
        raise AssertionError("the int8 engine's pool is not int8")
    steps = eng.windows * eng.window
    if dec != cfg.n_layer * steps or dec == 0 or ver != 0:
        raise AssertionError(
            f"int8 spec-off: decode launches {dec} != n_layer x decode "
            f"steps {cfg.n_layer} x {steps}, or verify launches {ver} != 0")
    eng_on, reqs_on, _, dec_on, ver_on = runs["int8_on"]
    if (ver_on != cfg.n_layer * eng_on.verify_dispatches or ver_on == 0
            or dec_on != 0):
        raise AssertionError(
            f"int8 spec-on: verify launches {ver_on} != n_layer x verify "
            f"dispatches {cfg.n_layer} x {eng_on.verify_dispatches}, or "
            f"decode launches {dec_on} != 0")
    for name in ("int8_off", "int8_on"):
        if not all(0 <= t < cfg.vocab_size for r in runs[name][1]
                   for t in r.tokens):
            raise AssertionError(f"{name}: token id outside the vocabulary")
    same = sum(a.tokens == b.tokens for a, b in zip(reqs, reqs_on))
    bf16_same = sum(a.tokens == b.tokens for a, b in
                    zip(reqs, runs["bf16_off"][1]))

    window_bf16 = window_agreement(model, serving, **INT8)
    verify_bf16 = verify_agreement(model, serving, **INT8)
    model32 = seeded_model(GPT, cfg)
    window_f32 = window_agreement(model32, serving, 1e-4, **INT8)
    verify_f32 = verify_agreement(model32, serving, 1e-4, **INT8)
    del model32
    proj = projection_bytes_and_ms(model, cfg)
    rec = {
        "phase": "serve_int8", "config": "openwebtext", "dtype": "bfloat16",
        **INT8, "slots": SPEC["slots"], "page_size": PS, "window": 4,
        "speculate": SPEC["speculate"], "requests": len(ps),
        "max_new_tokens": MAX_NEW,
        "runs_in_order": list(runs),
        **{name: {**run_record(e, r, w), "decode_launches": d,
                  "verify_launches": v, "int8_matmul_launches": mm[name],
                  "stats": e.stats()}
           for name, (e, r, w, d, v) in runs.items()},
        "decode_steps": steps, "verify_dispatches": eng_on.verify_dispatches,
        "spec_on_equal_spec_off_streams": same,
        "int8_equal_bf16_streams": bf16_same,
        "pool_bytes_int8": int(eng.pool.k.numel() * 2
                               + eng.pool.scale_k.numel() * 8),
        "pool_bytes_bf16": int(runs["bf16_off"][0].pool.k.numel() * 4),
        "window_check_bf16": window_bf16, "window_check_f32": window_f32,
        "verify_check_bf16": verify_bf16, "verify_check_f32": verify_f32,
        "projections_one_decode_step": proj, "gpu": gpu,
    }
    emit(rec)
    del model
    return rec


def projections(model) -> int:
    """The int8 projections one model forward calls (each one launch of
    the int8 matmul kernel on the card)."""
    from midgpt_tpu_torch.quant import QuantLinear

    return sum(isinstance(m, QuantLinear) for m in model.modules())


def phase_timing_int8(pa, cfg, gpu):
    """The int8 branches at the serve shapes, as :func:`phase_timing` and
    :func:`phase_timing_verify` time the float ones: 8 slots, resident
    lengths from the serve prompts plus 32 tokens, decode r = R - 1 and
    verify T = speculate + 1, q bf16, int8 pages with bf16 self rows;
    launches rotate over 4 x n_layer layers. Bounds count int8 pages,
    each live page's two f32 scales and the bf16 self rows."""
    hkv, c = cfg.kv_heads, cfg.head_dim
    g = cfg.n_head // hkv
    lens = [int(p.size) + 32 for p in prompts(cfg.vocab_size)[:S]]
    nl = 4 * cfg.n_layer
    tt = SPEC["speculate"] + 1
    out = {}
    for kind, r in (("decode", R - 1), ("verify", None)):
        args, planes = int8_case(kind, hkv, g, c, torch.bfloat16, lens,
                                 None if kind == "decode" else tt,
                                 layers=nl, seed=1)
        bt = args[3] if kind == "decode" else args[5]
        per_layer = [gathered(planes, bt, i) for i in range(nl)]

        def kernel(i, kind=kind, args=args, r=r):
            sc = per_layer[i % nl]
            if kind == "decode":
                return pa.paged_decode_attention(*args, r, i % nl, *sc)
            return pa.paged_verify_attention(*args, i % nl, *sc)

        def plain(i, kind=kind, args=args, r=r):
            sc = per_layer[i % nl]
            if kind == "decode":
                return pa.paged_decode_attention_reference(*args, r, i % nl,
                                                           *sc)
            return pa.paged_verify_attention_reference(*args, i % nl, *sc)

        ms = device_ms(kernel, reps=2 * nl)
        plain_ms = device_ms(plain, reps=nl // 2)
        eager = eager_ms(kernel, reps=2 * nl)
        got = int8_run(pa, kind, args, planes, 0, r)
        err, ratio = hold(got, int8_run(pa, kind, args, planes, 0, r,
                                        plain=True))
        if not ratio <= 1.0:
            raise AssertionError(f"serve-shape int8 {kind} error {err}: "
                                 f"{ratio} x tol")
        pages = sum(-(-n // PS) for n in lens)
        scale_bytes = 2 * 4 * pages * hkv
        if kind == "decode":
            bound_ms, bound_by = decode_bound(args[0], args[1], args[4], r,
                                              c * 2, scale_bytes)
        else:
            bound_ms, bound_by = verify_bound(args[0], args[3], lens,
                                              row_esz=2,
                                              extra_bytes=scale_bytes)
        rec = {"phase": "timing", "kernel": f"paged_{kind}_attention[int8]",
               "shape": {"S": S, "Hkv": hkv, "G": g, "C": c, "PS": PS,
                         "Pmax": PMAX, "lens": lens, "q_dtype": "bfloat16",
                         "pool": "int8", "rows": "bfloat16",
                         **({"r": r, "R": R} if kind == "decode"
                            else {"T": tt})},
               "ms": ms, "plain_ms": plain_ms, "eager_ms": eager,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None,
               "library": "none: no PyTorch call walks a block table",
               "frac_of_bound": bound_ms / ms, "max_abs_err": err,
               "err_over_tol": ratio, "gpu": gpu}
        emit(rec)
        out[kind] = rec
    return out


# -- training: the fused attention kernels and the train main path --------


# -- the int8 weight product: csrc/int8_matmul.cu --------------------------

# rows of the serving path's products: decode (slots), verify (slots x
# (speculate + 1)), and a prefill chunk's largest bucket at openwebtext's
# prompt spread
MATMUL_MS = {"decode": 8, "verify": 40, "prefill": 512}
# every row count the engine gives the product at openwebtext: a prefill's
# head row (1), decode (8), verify (40) and the prefill buckets (pages
# rounded up to a power of two, 16 .. 1024 rows); every instance of the
# kernel's plan (mt 1, 2, 3, 4) and the K splits at each
HOLD_MS = (1, 8, 16, 32, 40, 64, 128, 256, 512, 1024)
MATMUL_BUFS = 12  # timing rotates over this many weights (a model's layers)


def int8_weights(k, n, seed):
    """Random codes ``[k, n]`` with both ends of the int8 range (-127 and
    127) in them, and po2 scales from 2^-30 to 2^6 (the first column's
    the smallest, the last's the largest)."""
    gen = torch.Generator().manual_seed(seed)
    codes = torch.randint(-127, 128, (k, n), generator=gen,
                          dtype=torch.int8)
    codes[0, 0], codes[1, -1] = -127, 127
    exps = torch.randint(-14, -4, (n,), generator=gen)
    exps[0], exps[-1] = -30, 6
    return codes.to(DEVICE), torch.pow(2.0, exps.float()).to(DEVICE)


def hold_matmul(got, x, codes, scale):
    """Hold the kernel's ``y`` against the plain product in f32 on the
    same inputs (x upcast, the codes dequantized; TF32 off), element by
    element: off by at most 2^-14 of ``(|x| @ |codes|) * scale`` (the two
    sum in different orders, the tensor cores with their own rounding)
    plus, for a bf16 output, the final rounding, half a bf16 ulp, at
    most 2^-8 of the rounded value. Returns ``(max_abs_err, max
    err/tolerance)``; the check passes when the second is at most 1."""
    ref32 = (x.float() @ codes.float()) * scale
    size = (x.float().abs() @ codes.float().abs()) * scale
    rel = 2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0
    tol = rel * got.float().abs() + 2.0 ** -14 * size + 1e-37
    err = (got.float() - ref32).abs()
    return err.max().item(), (err / tol).max().item()


def phase_int8_matmul_kernel(im, cfg) -> float:
    """The int8 matmul kernel against its plain version (:func:`hold_matmul`)
    at every projection shape of ``openwebtext`` (wqkv, wo, w_up, w_down,
    the head) and every row count of ``HOLD_MS``, x bf16 and f32; at each
    bf16 row count the same rule must refuse the product with the first
    column's scale doubled and with the first row of codes left out. Then
    the rounding: with integer x every sum is exact in f32 whatever its
    order, so under absmax scales (not powers of two) the kernel must
    equal the plain version bit for bit."""
    d, f = cfg.n_embd, 4 * cfg.n_embd
    shapes = {"wqkv": (d, 3 * d), "wo": (d, d), "w_up": (d, f),
              "w_down": (f, d), "head": (d, cfg.vocab_size)}
    worst, cases, exact = 0.0, [], []
    mmb = torch.backends.cuda.matmul
    reduced = mmb.allow_bf16_reduced_precision_reduction
    mmb.allow_bf16_reduced_precision_reduction = False  # cuBLAS sums in f32
    try:
        worst = _hold_int8_matmul(im, shapes, cases, exact)
    finally:
        mmb.allow_bf16_reduced_precision_reduction = reduced
    emit({"phase": "int8_matmul_kernel", "case_keys": [
        "proj", "M", "dtype", "mt", "max_abs_err", "err_over_tol",
        "max_abs_vs_plain"], "cases": cases, "max_err_over_tol": worst,
          "tol_rule": "2^-14 (|x| @ |codes|) scale + 2^-8 |y| (bf16)",
          "absmax_exact": f"{sum(exact)} of {len(exact)}"})
    return worst


def _hold_int8_matmul(im, shapes, cases, exact) -> float:
    worst = 0.0
    for si, (name, (k, n)) in enumerate(shapes.items()):
        codes, scale = int8_weights(k, n, si)
        for m in HOLD_MS:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn(m, k, generator=torch.Generator()
                                .manual_seed(100 + si), dtype=torch.float32)
                x = x.to(DEVICE, dtype)
                got = im.int8_matmul(x, codes, scale)
                torch.cuda.synchronize()
                if got.shape != (m, n) or got.dtype != dtype:
                    raise AssertionError(f"{name} M={m}: {tuple(got.shape)}")
                err, ratio = hold_matmul(got, x, codes, scale)
                plain = im.int8_matmul_reference(x, codes, scale)
                cases.append([name, m, str(dtype)[6:], im.plan(m, n, k)[
                    "mt"], err, ratio, (got.float() - plain.float()).abs()
                    .max().item()])
                if not ratio <= 1.0:
                    raise AssertionError(f"int8 matmul {name} M={m} "
                                         f"{dtype}: {ratio} x tol")
                worst = max(worst, ratio)
                if dtype == torch.bfloat16:
                    for fault, (xx, cc, ss) in (
                            ("scale", (x, codes, scale * torch.where(
                                torch.arange(n, device=DEVICE) == 0, 2.0,
                                1.0))),
                            ("row", (x[:, 1:], codes[1:], scale))):
                        if hold_matmul(got, xx, cc, ss)[1] <= 1.0:
                            raise AssertionError(
                                f"the rule took a faulted product ({fault}, "
                                f"{name} M={m})")
                # integer x in [-4, 4]: |sum| <= 4 127 K < 2^24
                xi = torch.randint(-4, 5, (m, k), generator=torch.Generator()
                                   .manual_seed(200 + si)).to(DEVICE, dtype)
                sa = (scale * (1.0 + torch.rand(n, generator=torch.Generator()
                                                .manual_seed(300 + si))
                               .to(DEVICE)))  # absmax-like: no power of two
                yi = im.int8_matmul(xi, codes, sa)
                pi = im.int8_matmul_reference(xi, codes, sa)
                same = bool(torch.equal(yi, pi))
                exact.append(same)
                if not same:
                    raise AssertionError(
                        f"int8 matmul {name} M={m} {dtype}: absmax scales "
                        f"off the plain version by "
                        f"{(yi.float() - pi.float()).abs().max().item()}")
    return worst


def matmul_bound(m, k, n, esz):
    """Least time of one call: the codes, x, y and the scales moved once
    over HBM bandwidth, against 2 M K N operations at the bf16 tensor
    rate (the products the kernel runs)."""
    nbytes = k * n + m * k * esz + m * n * esz + 4 * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / PEAK_FLOPS[torch.bfloat16]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_timing_int8_matmul(im, GPT, cfg, gpu):
    """The int8 matmul kernel at the serving path's three row counts on
    ``openwebtext``'s quantized projections (each of 12 layers' own
    weights, so a step's codes pass the L2 as the model's do), bf16: per
    projection and for one model forward's 49 (12 x 4 + the head), the
    kernel, its plain version (the codes converted to bf16, cuBLAS, the
    scale), the library call (cuBLAS on the bf16 copy, made outside the
    time), the kernel / library ratio and the bound, as device time from
    CUDA graphs. The kernel's launches do not overlap one another, so
    the per-projection graphs time them as the model runs them."""
    from midgpt_tpu_torch.quant import quantize_model

    model = seeded_model(GPT, cfg, torch.bfloat16)
    qm = quantize_model(model)
    out = {"phase": "timing_int8_matmul", "gpu": gpu, "forms": {}}
    with torch.no_grad():
        for form, m in MATMUL_MS.items():
            rec = {"M": m, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "bound_ms": 0.0, "bytes": 0, "max_abs_err": 0.0,
                   "per_projection": {}}
            for (lins, qlins), name in zip(projection_layers(model, qm), (
                    "wqkv", "wo", "w_up", "w_down", "head")):
                k, n = qlins[0].weight.shape
                nq = len(qlins)
                x = torch.randn(m, k, device=DEVICE, dtype=torch.bfloat16)
                copies = [q.weight.to(torch.bfloat16) for q in qlins]
                ms = device_ms(lambda i: qlins[i % nq](x), reps=2 * nq)
                plain = device_ms(lambda i: im.int8_matmul_reference(
                    x, qlins[i % nq].weight, qlins[i % nq].scale),
                    reps=2 * nq)
                lib = device_ms(lambda i: x @ copies[i % nq], reps=2 * nq)
                bound, by = matmul_bound(m, k, n, 2)
                del copies
                err, ratio = hold_matmul(qlins[0](x), x, qlins[0].weight,
                                         qlins[0].scale)
                if not ratio <= 1.0:
                    raise AssertionError(f"int8 matmul {name} M={m}: "
                                         f"{ratio} x tol")
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
                rec["per_projection"][name] = {
                    "K": k, "N": n, "calls": nq, "ms": ms, "plain_ms": plain,
                    "library_ms": lib, "kernel_over_library": ms / lib,
                    "bound_ms": bound, "bound_by": by,
                    "max_abs_err": err, "err_over_tol": ratio,
                    "plan": dict(im.plan(m, n, k))}
                for key, v in (("ms", ms), ("plain_ms", plain),
                               ("library_ms", lib), ("bound_ms", bound)):
                    rec[key] += nq * v
                rec["bytes"] += nq * (k * n + 2 * m * (k + n) + 4 * n)
            rec["kernel_over_library"] = rec["ms"] / rec["library_ms"]
            out["forms"][form] = rec
    emit(out)
    del qm, model
    return out


# -- serving with the prefix cache ------------------------------------------

PREFIX = dict(slots=8, page_size=16, window=4)
PREFIX_SYS = 256  # tokens of the shared system prompt
PREFIX_TAILS = (16, 128)  # each request's own tail, evenly spread
# the engine counters a serve_prefix run reports, as differences over it
COUNTED = ("tokens_generated", "windows", "prefill_dispatches",
           "copy_dispatches", "cold_reclaims", "prompt_tokens_total",
           "prefill_tokens_saved", "prefill_tokens_computed")


def prefix_prompts(vocab: int):
    """The serve_prefix traffic: one seeded 256-token system prompt, then
    each of 16 requests' own tail of 16..128 tokens."""
    rng = np.random.default_rng(SEED + 2)
    sys_prompt = rng.integers(0, vocab, size=PREFIX_SYS)
    tails = np.linspace(*PREFIX_TAILS, N_REQUESTS).astype(int)
    return [np.concatenate([sys_prompt, rng.integers(0, vocab, size=n)])
            .astype(np.int32) for n in tails]


def first_logits(serving, model, ps, **kw):
    """Each request's first-token logits, requests admitted one at a time
    into one engine: admission and prefill alone (no decode window), then
    the slot is released, so with the cache on its pages retire cold for
    the next request to hit. Returns the logits ``[N, V]`` f32 and each
    request's matched prompt tokens."""
    eng = serving.ServingEngine(model, **PREFIX, device=DEVICE, **kw)
    rows, hits = [], []
    for i, p in enumerate(ps):
        eng.submit(p, MAX_NEW, seed=i)
        eng._admit()
        eng._run_prefills()
        s = eng._decoding_slots()[0]
        rows.append(eng.logits[s].clone())
        hits.append(eng.slot_req[s].cached_tokens)
        eng._release_slot(s)
    return torch.stack(rows), hits


def phase_serve_prefix(pa, im, serving, GPT, cfg, gpu):
    """The prefix cache, copy-on-write and chunked prefill on the serving
    main path at the full width and depth of ``openwebtext`` (random init
    from the seed, bf16): ServingEngine(slots=8, page_size=16, window=4)
    on 16 greedy requests sharing one 256-token system prompt, each with
    its own tail of 16..128 tokens, 64 new tokens each. Each engine first
    serves one request of the system prompt (a deployment's cache holds
    it from earlier traffic), outside the measured run and its counts.
    Runs in turns in
    one process: cache off, cache on, cache on with ``prefill_chunk=64``,
    cache on with ``quant="int8", kv_quant="int8"``. Launch counts are
    read around each run alone: decode launches = n_layer x decode
    steps; int8 matmul launches = projections x model forwards (int8 run)
    or 0. The cache-on runs must hit above half the prompt tokens and
    compute fewer prefill tokens than the cache-off run. Each cache hit's
    first-token logits are held to the same request's with the cache off
    (bf16 by the triangle rule against the f32 model, f32 within 1e-4 of
    the largest logit); streams equal to the cache-off run's are counted,
    not required (bf16 near-ties may flip)."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = prefix_prompts(cfg.vocab_size)
    warm = np.concatenate([ps[0][:PREFIX_SYS], np.random.default_rng(
        SEED + 3).integers(0, cfg.vocab_size, size=16)]).astype(np.int32)
    # warm-up (the prefill buckets' cuBLAS shapes): short runs, not counted
    for kw in ({}, INT8):
        serving.generate_served(model, ps[:2], 4, device=DEVICE, **PREFIX,
                                **kw)
    torch.cuda.synchronize()
    runs = {}
    for name, kw in (("cache_off", dict(prefix_cache=False)),
                     ("cache_on", {}),
                     ("cache_on_chunk64", dict(prefill_chunk=64)),
                     ("cache_on_int8", INT8)):
        eng = serving.ServingEngine(model, **PREFIX, device=DEVICE, **kw)
        eng.warm_prefill(int(max(p.size for p in ps)))
        # the system prompt resident from earlier traffic, as a deployment
        # finds it: one request before the measured run, not counted
        eng.submit(warm, 1, seed=N_REQUESTS)
        eng.run()
        before = eng.stats()
        pa.paged_decode_attention.launches = 0
        im.int8_matmul.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
        fin = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        dec, mm = pa.paged_decode_attention.launches, im.int8_matmul.launches
        st = {k: v - before[k] for k, v in eng.stats().items()
              if k in COUNTED}
        reqs = [fin[r] for r in rids]
        if not all(len(r.tokens) == MAX_NEW for r in reqs):
            raise AssertionError(f"{name}: lengths "
                                 f"{[len(r.tokens) for r in reqs]}")
        if not all(0 <= x < cfg.vocab_size for r in reqs for x in r.tokens):
            raise AssertionError(f"{name}: token id outside the vocabulary")
        pages_home(eng)
        steps = st["windows"] * eng.window
        if dec != cfg.n_layer * steps or dec == 0:
            raise AssertionError(f"{name}: decode launches {dec} != n_layer "
                                 f"x decode steps {cfg.n_layer} x {steps}")
        want = (projections(eng.model) * (steps + st["prefill_dispatches"])
                if "int8" in name else 0)
        if mm != want:
            raise AssertionError(f"{name}: int8 matmul launches {mm} != "
                                 f"{want}")
        ttft = sorted(1e3 * (r.first_token_time - r.submit_time)
                      for r in reqs)
        runs[name] = {"tokens": st["tokens_generated"], "wall_s": wall,
                      "tokens_per_s": st["tokens_generated"] / wall,
                      "ttft_ms_p50": float(np.percentile(ttft, 50)),
                      "ttft_ms_p99": float(np.percentile(ttft, 99)),
                      **st, "decode_steps": steps, "decode_launches": dec,
                      "int8_matmul_launches": mm,
                      "prefix_hit_rate": st["prefill_tokens_saved"]
                      / st["prompt_tokens_total"],
                      "cached_pages_after": eng.alloc.cached_pages,
                      "streams": [r.tokens for r in reqs]}
    off = runs["cache_off"]
    for name in ("cache_on", "cache_on_chunk64", "cache_on_int8"):
        if not runs[name]["prefix_hit_rate"] > 0.5:
            raise AssertionError(f"{name}: hit rate "
                                 f"{runs[name]['prefix_hit_rate']} <= 0.5")
        if not (runs[name]["prefill_tokens_computed"]
                < off["prefill_tokens_computed"]):
            raise AssertionError(f"{name}: computed no fewer prefill tokens "
                                 f"than the cache-off run")
    same = {name: sum(a == b for a, b in zip(r.pop("streams"),
                                             off["streams"]))
            for name, r in runs.items() if name != "cache_off"}
    off.pop("streams")
    # each cache hit's first logits against the cache-off run's
    model32 = copy.deepcopy(model).float()
    hit, hits = first_logits(serving, model, ps)
    cold, _ = first_logits(serving, model, ps, prefix_cache=False)
    cold32, _ = first_logits(serving, model32, ps, prefix_cache=False)
    hit32, hits32 = first_logits(serving, model32, ps)
    sel = [i for i, h in enumerate(hits) if h > 0]
    if len(sel) < N_REQUESTS - 1 or hits != hits32:
        raise AssertionError(f"cache hits {hits} / {hits32}")
    check_bf16 = hold_logits([hit[sel], cold[sel], cold32[sel]], None,
                             "first-token (bf16)")
    check_f32 = hold_logits([hit32[sel], cold32[sel]], 1e-4,
                            "first-token (f32)")
    del model32
    rec = {"phase": "serve_prefix", "config": "openwebtext",
           "dtype": "bfloat16", **PREFIX, "requests": N_REQUESTS,
           "max_new_tokens": MAX_NEW, "system_prompt": PREFIX_SYS,
           "prompt_lens": [int(p.size) for p in ps],
           "runs_in_order": list(runs), **runs,
           "streams_equal_to_cache_off": same,
           "first_token_hits": len(sel), "matched_tokens": hits,
           "first_token_check_bf16": check_bf16,
           "first_token_check_f32": check_f32, "gpu": gpu}
    emit(rec)
    del model
    return rec


PRESSURE = dict(slots=8, window=4, page_size=16, num_pages=96)
# f32: every other request, half the slots and pages (the same ratios)
PRESSURE_F32 = dict(slots=4, window=4, page_size=16, num_pages=48)
PRESSURE_PLAN = "6:exhaust@0:all:3"  # every free page held out 3 steps
# the lone request's: held out from step 2 to 17, across at least one of
# its page crossings (a page is 16 tokens, a step emits at least one)
LONE_PLAN = "2:exhaust@0:all:16"
PRESSURE_CANCEL_STEP = 4  # after it: slot 5's request and the last queued
PRESSURE_COUNTED = ("evictions", "livelock_parks", "overload_parks",
                    "cold_reclaims", "faults_injected", "cancelled_requests",
                    "deadline_shed_requests", "windows", "verify_dispatches",
                    "prefill_dispatches", "prefill_tokens_saved",
                    "prefill_tokens_computed", "tokens_generated")


def pressure_run(pa, serving, model, ps, *, cancel: bool, pressure=PRESSURE,
                 plan=PRESSURE_PLAN, **kw):
    """Serve ``ps`` (request seed = index, ``MAX_NEW`` tokens each) on a
    fresh engine with ``pressure``'s pool and ``plan``'s fault hook,
    stepping by hand: after every step the allocator's and the
    prefix index's invariants must hold. With ``cancel``, one more request
    is submitted with a deadline already passed, and after step
    ``PRESSURE_CANCEL_STEP`` the request in slot 5 and the last queued one
    are cancelled. Launch counts are read around the run alone: decode =
    n_layer x decode steps and verify 0, or under ``speculate`` verify =
    n_layer x verify dispatches and decode 0. Every request not cancelled
    or shed must have ``MAX_NEW`` tokens, no page may stay held or
    quarantined and nothing parked. Returns the engine, the streams by
    request index, and a record."""
    n_layer = model.config.n_layer
    eng = serving.ServingEngine(
        model, **pressure, device=DEVICE,
        fault_hook=serving.FaultPlan.parse(plan).hook(0), **kw)
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    late = (eng.submit(ps[1], MAX_NEW, seed=len(ps), deadline_s=-1.0)
            if cancel else None)
    cancelled, steps = [], 0
    while eng.has_work:
        eng.step()
        steps += 1
        eng.alloc.check()
        eng.index.check(eng.alloc)
        if cancel and steps == PRESSURE_CANCEL_STEP:
            cancelled = [eng.slot_req[5].rid, eng.queue[-1].rid]
            if not all(eng.cancel(r) for r in cancelled):
                raise AssertionError(f"cancel of {cancelled} refused")
        if steps > 4000:
            raise AssertionError("the pressure run did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec = pa.paged_decode_attention.launches
    ver = pa.paged_verify_attention.launches
    if kw.get("speculate"):
        if ver != n_layer * eng.verify_dispatches or ver == 0 or dec != 0:
            raise AssertionError(
                f"verify launches {ver} != n_layer x verify dispatches "
                f"{n_layer} x {eng.verify_dispatches}, or decode {dec} != 0")
    elif dec != n_layer * eng.window * eng.windows or dec == 0 or ver != 0:
        raise AssertionError(
            f"decode launches {dec} != n_layer x decode steps {n_layer} x "
            f"{eng.window * eng.windows}, or verify {ver} != 0")
    st = eng.stats()
    if (eng.alloc.quarantined_pages or st["parked_requests"]
            or st["faults_injected"] != 1):
        raise AssertionError(f"quarantined {eng.alloc.quarantined_pages}, "
                             f"parked {st['parked_requests']}, faults "
                             f"{st['faults_injected']}")
    pages_home(eng)
    served = {i: eng.lookup(r) for i, r in enumerate(rids)
              if r not in cancelled}
    if not all(len(r.tokens) == MAX_NEW and r.outcome == "finished"
               for r in served.values()):
        raise AssertionError(
            f"lengths {[len(r.tokens) for r in served.values()]}")
    if not all(0 <= t < model.config.vocab_size for r in served.values()
               for t in r.tokens):
        raise AssertionError("token id outside the vocabulary")
    if cancel:
        outcomes = [eng.lookup(r).outcome for r in cancelled + [late]]
        if (outcomes != ["cancelled", "cancelled", "expired"]
                or st["cancelled_requests"] != 2
                or st["deadline_shed_requests"] != 1):
            raise AssertionError(f"cancel / deadline outcomes {outcomes}")
    ttft = sorted(1e3 * (r.first_token_time - r.submit_time)
                  for r in served.values())
    tokens = sum(len(r.tokens) for r in served.values())
    rec = {"requests": len(ps), "served": len(served), "steps": steps,
           "cancelled_rids": cancelled, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "ttft_ms_p50": float(np.percentile(ttft, 50)),
           "ttft_ms_p99": float(np.percentile(ttft, 99)),
           "decode_launches": dec, "verify_launches": ver,
           **{k: st[k] for k in PRESSURE_COUNTED}}
    return eng, {i: r.tokens for i, r in served.items()}, rec


def uncontended_run(serving, model, ps, slots: int, **kw):
    """``ps`` on the default pool (every slot at block_size: nothing is
    ever evicted), timed; streams by request index."""
    eng = serving.ServingEngine(model, slots=slots, window=4, page_size=16,
                                device=DEVICE, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    fin = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.evictions:
        raise AssertionError("the uncontended run evicted")
    reqs = [fin[r] for r in rids]
    ttft = sorted(1e3 * (r.first_token_time - r.submit_time) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    return [r.tokens for r in reqs], {
        "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
        "ttft_ms_p50": float(np.percentile(ttft, 50)),
        "ttft_ms_p99": float(np.percentile(ttft, 99))}


def phase_serve_pressure(pa, serving, GPT, cfg, gpu):
    """The serving main path under load at the full width and depth of
    ``openwebtext`` (random init from the seed, bf16): serve's 16 greedy
    requests (16..512 prompt tokens, 64 new each) through
    ServingEngine(slots=8, window=4, page_size=16, num_pages=96), the
    prefix cache on: 96 pages hold 1,536 tokens against the up to 36
    pages of one request's lifetime, so growth evicts. Faults: the plan
    ``6:exhaust@0:all:3``, a cancel of one running and one queued request
    after step 4, and a request submitted with its deadline passed
    (``pressure_run``). Each configuration also serves its longest prompt
    alone on the same pool under ``LONE_PLAN``: a lone slot that cannot
    grow parks, and resumes when the pages come back.
    Held: evictions >= 1 in the trace, overload parks >= 1 alone, every
    served request 64 tokens, pages home, none quarantined or parked, the
    launch counts, and at f32 (the same weights cast; every other request
    on 4 slots and 48 pages, the same ratios) every stream equal to the
    uncontended f32 run's. Counted, not held: the bf16 streams equal to
    the uncontended run's (bf16 near-ties may flip). Beside: speculate=4
    under the same pressure and holds; tokens/s and TTFT against the
    uncontended runs (no gain is claimed)."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    # warm-up (cuBLAS handles, the verify shapes): short runs, not counted
    for kw in ({}, dict(speculate=4)):
        serving.generate_served(model, ps[:2], 4, device=DEVICE, **SERVE,
                                **kw)
    torch.cuda.synchronize()
    runs = {}

    def trace_and_lone(name, m, trace_ps, base, pressure, cancel, **kw):
        eng, got, rec = pressure_run(pa, serving, m, trace_ps, cancel=cancel,
                                     pressure=pressure, **kw)
        lone_eng, lone, lone_rec = pressure_run(
            pa, serving, m, trace_ps[-1:], cancel=False, pressure=pressure,
            plan=LONE_PLAN, **kw)
        if eng.evictions < 1:
            raise AssertionError(f"{name}: nothing was evicted")
        if lone_eng.overload_parks < 1:
            raise AssertionError(f"{name}: the lone request never parked")
        same = sum(got[i] == base[i] for i in got)
        runs[name] = {**rec, "streams_equal_uncontended": same,
                      "lone": {**lone_rec, "stream_equal_uncontended":
                               lone[0] == base[len(trace_ps) - 1]}}
        return same == len(got) and lone[0] == base[len(trace_ps) - 1]

    base, base_rec = uncontended_run(serving, model, ps, PRESSURE["slots"])
    trace_and_lone("bf16", model, ps, base, PRESSURE, True)
    base_spec, base_spec_rec = uncontended_run(
        serving, model, ps, PRESSURE["slots"], speculate=4)
    trace_and_lone("bf16_spec4", model, ps, base_spec, PRESSURE, True,
                   speculate=4)
    model32 = copy.deepcopy(model).float()
    del model
    ps32 = ps[::2]
    base32, base32_rec = uncontended_run(serving, model32, ps32,
                                         PRESSURE_F32["slots"])
    if not trace_and_lone("f32", model32, ps32, base32, PRESSURE_F32, False):
        raise AssertionError(f"f32 streams under pressure differ from the "
                             f"uncontended run's: {runs['f32']}")
    del model32
    rec = {"phase": "serve_pressure", "config": "openwebtext",
           "dtype": "bfloat16", **PRESSURE, "plan": PRESSURE_PLAN,
           "lone_plan": LONE_PLAN,
           "cancel_after_step": PRESSURE_CANCEL_STEP,
           "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
           "prompt_lens": [int(p.size) for p in ps], "f32": PRESSURE_F32,
           "uncontended": {"bf16": base_rec, "bf16_spec4": base_spec_rec,
                           "f32": base32_rec},
           **runs, "gpu": gpu}
    emit(rec)
    return rec


# -- cold-page spill, telemetry and the front door on the serving path ------

SPILL = dict(slots=8, window=4, page_size=16, prefill_chunk=128)
SPILL_TENANTS, SPILL_SYS, SPILL_TURN = 12, 512, 32
SPILL_PAGES, SPILL_AMPLE = 320, 1024
# the counters a serve_spill round reports, as differences over it
SPILL_COUNTED = ("prefill_tokens_computed", "prefill_dispatches",
                 "cold_reclaims", "spilled_pages", "spill_faultback_pages",
                 "spill_prefetch_pages", "spill_readmissions",
                 "spill_discards", "tokens_generated", "windows",
                 "verify_dispatches")
SPILL_TIMING_REPS = 20


def spill_prompts(vocab: int):
    """The serve_spill traffic, multi-tenant chat: 12 tenants, each with
    its own seeded 512-token system prompt; round 1 is each tenant's
    system prompt and a 32-token user turn, round 2 the same prompt and a
    new 32-token turn."""
    rng = np.random.default_rng(SEED + 4)
    sys_prompts = [rng.integers(0, vocab, size=SPILL_SYS)
                   for _ in range(SPILL_TENANTS)]
    return [[np.concatenate([sp, rng.integers(0, vocab, size=SPILL_TURN)])
             .astype(np.int32) for sp in sys_prompts] for _ in range(2)]


class ImportCalls:
    """Counts ``import_pages`` calls the engine makes (the fault-backs'
    dispatches), by wrapping the engine module's reference."""

    def __init__(self, engine_mod):
        self.mod, self.real, self.n = engine_mod, engine_mod.import_pages, 0

    def __enter__(self):
        def counting(*a, **k):
            self.n += 1
            return self.real(*a, **k)

        self.mod.import_pages = counting
        return self

    def __exit__(self, *exc):
        self.mod.import_pages = self.real


def spill_run(pa, serving, model, rounds, *, speculate=0, **kw):
    """Both rounds of the serve_spill traffic on one engine (tracing on),
    each round submitted after the last drained; after every step the
    allocator's and the prefix index's invariants (with the spill store)
    must hold. Launch counts are read around the two rounds alone: decode
    = n_layer x decode steps and verify 0, or under ``speculate`` verify
    = n_layer x verify dispatches and decode 0. Returns the streams by
    round and a record of round 2 (counter differences, TTFT and TBT from
    ``request_metrics``, the import calls, resident spill bytes)."""
    from midgpt_tpu_torch.serving import engine as engine_mod

    n_layer = model.config.n_layer
    eng = serving.ServingEngine(model, **SPILL, device=DEVICE, telemetry=True,
                                speculate=speculate, **kw)
    eng.warm_prefill(SPILL_SYS + SPILL_TURN)
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    streams, rec = [], {}
    with ImportCalls(engine_mod) as imports:
        for rnd, ps in enumerate(rounds):
            before, calls0 = eng.stats(), imports.n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
            steps = 0
            while eng.has_work:
                eng.step()
                steps += 1
                eng.alloc.check()
                eng.index.check(eng.alloc, eng._spill_store)
                if steps > 4000:
                    raise AssertionError("the spill run did not drain")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reqs = [eng.lookup(r) for r in rids]
            if not all(r.outcome == "finished" and len(r.tokens) == MAX_NEW
                       for r in reqs):
                raise AssertionError(f"round {rnd + 1}: lengths "
                                     f"{[len(r.tokens) for r in reqs]}")
            streams.append([r.tokens for r in reqs])
            if rnd == 1:
                st = eng.stats()
                m = [eng.telemetry.request_metrics(r) for r in rids]
                ttft = sorted(1e3 * x["ttft_s"] for x in m)
                tbt = sorted(1e3 * g for x in m for g in x["tbt_s"])
                rec = {"steps": steps, "wall_s": wall,
                       "tokens_per_s": MAX_NEW * len(ps) / wall,
                       **{k: st[k] - before[k] for k in SPILL_COUNTED},
                       "import_pages_calls": imports.n - calls0,
                       "spill_resident_pages": st["spill_resident_pages"],
                       "spill_resident_bytes": eng.metrics_snapshot()[
                           "gauges"]["spill_resident_bytes"],
                       "ttft_ms_p50": float(np.percentile(ttft, 50)),
                       "ttft_ms_p99": float(np.percentile(ttft, 99)),
                       "tbt_ms_p50": float(np.percentile(tbt, 50)),
                       "tbt_ms_p99": float(np.percentile(tbt, 99))}
    dec = pa.paged_decode_attention.launches
    ver = pa.paged_verify_attention.launches
    if speculate:
        if ver != n_layer * eng.verify_dispatches or ver == 0 or dec != 0:
            raise AssertionError(
                f"verify launches {ver} != n_layer x verify dispatches "
                f"{n_layer} x {eng.verify_dispatches}, or decode {dec} != 0")
    elif dec != n_layer * eng.window * eng.windows or dec == 0 or ver != 0:
        raise AssertionError(
            f"decode launches {dec} != n_layer x decode steps {n_layer} x "
            f"{eng.window * eng.windows}, or verify {ver} != 0")
    rec.update(decode_launches=dec, verify_launches=ver)
    if eng.alloc.held_pages:
        raise AssertionError(f"{eng.alloc.held_pages} pages still held")
    return eng, streams, rec


def page_copy_timing(serving, eng, reps: int = SPILL_TIMING_REPS):
    """One page's spill (``export_pages``: the gather and the copy to
    pinned host memory) and fault-back (``import_pages``), each timed
    alone: device ms between CUDA events around the queued copies, host
    ms around the call and a synchronize, the median of ``reps``; then a
    byte-exact round trip: export a page, scribble over it on the card,
    import it, compare the bits."""
    pool = eng.pool
    page = eng.alloc.alloc(1)[0]
    dev_d2h, host_d2h, dev_h2d, host_h2d = [], [], [], []
    payload = None
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        payload = serving.export_pages(pool, [page])
        b.record()
        b.synchronize()
        host_d2h.append(1e3 * (time.perf_counter() - t0))
        dev_d2h.append(a.elapsed_time(b))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        serving.import_pages(pool, [page], *payload)
        b.record()
        b.synchronize()
        host_h2d.append(1e3 * (time.perf_counter() - t0))
        dev_h2d.append(a.elapsed_time(b))
    nbytes = sum(x.nbytes for x in payload if x is not None)
    if not all(x.is_pinned() for x in payload if x is not None):
        raise AssertionError("the spill payload is not in pinned memory")
    # the round trip, bit for bit
    planes = [x for x in (pool.k, pool.v, pool.scale_k, pool.scale_v)
              if x is not None]
    want = [x[:, page].clone() for x in planes]
    payload = serving.export_pages(pool, [page])
    for x in planes:
        x[:, page] = 0
    serving.import_pages(pool, [page], *payload)
    torch.cuda.synchronize()
    for x, w in zip(planes, want):
        got = x[:, page]
        if got.dtype == torch.bfloat16:
            got, w = got.view(torch.int16), w.view(torch.int16)
        if not torch.equal(got, w):
            raise AssertionError("a spilled page came back with other bits")
    eng.alloc.free([page])
    med = statistics.median
    return {"page_bytes": nbytes, "reps": reps,
            "spill_device_ms": med(dev_d2h), "spill_host_ms": med(host_d2h),
            "faultback_device_ms": med(dev_h2d),
            "faultback_host_ms": med(host_h2d),
            "spill_gb_per_s": nbytes / med(dev_d2h) / 1e6,
            "faultback_gb_per_s": nbytes / med(dev_h2d) / 1e6,
            "round_trip_bit_exact": True}


def phase_serve_spill(pa, serving, GPT, cfg, gpu):
    """Cold-page host spill on the serving main path at the full width and
    depth of ``openwebtext`` (random init from the seed, bf16 weights and
    pool): ServingEngine(slots=8, window=4, page_size=16,
    prefill_chunk=128), greedy, the prefix cache on, tracing on, serving
    ``spill_prompts``: 12 tenants' 512-token system prompts (32 pages
    each) with a 32-token user turn, 64 new tokens, round 2 after round 1
    drains. 320 pages: eight slots at decode hold 8 x 38 = 304, so the
    384 cold system-prompt pages do not fit. Runs, in one process:
    (a) an ample pool (1,024 pages), the reference; (b) ``spill="off"``;
    (c) ``spill="on"``, prefetch on; (d) prefetch off; (e) (c) with
    ``kv_quant="int8"``; (f) (c) with ``speculate=4``; (e) and (f) each
    beside its own ample twin. Held: the streams of (c)-(f), whose
    fault-backs are byte for byte, equal their twins' (the same
    computation); (b) recomputes evicted prefixes in other chunks, so its
    bf16 streams are counted, and held at f32 (the model cast, the pool
    f32) against an f32 ample run, as serve_pressure holds its streams;
    round 2 faults back pages in (c)-(f), and prefetch makes fewer
    ``import_pages`` calls than fault on match ((c) < (d)). Also one
    page's spill and fault-back timed alone, and a byte-exact round trip
    on the card. No gain is claimed."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    rounds = spill_prompts(cfg.vocab_size)
    # warm-up (cuBLAS handles, the verify shapes): short runs, not counted
    for kw in ({}, dict(speculate=4), dict(kv_quant="int8")):
        serving.generate_served(model, rounds[0][:2], 4, device=DEVICE,
                                **SERVE, **kw)
    torch.cuda.synchronize()
    variants = [
        ("a_ample", None, dict(num_pages=SPILL_AMPLE)),
        ("b_spill_off", "a_ample", dict(num_pages=SPILL_PAGES)),
        ("c_spill_prefetch", "a_ample",
         dict(num_pages=SPILL_PAGES, spill="on")),
        ("d_spill_no_prefetch", "a_ample",
         dict(num_pages=SPILL_PAGES, spill="on", spill_prefetch="off")),
        ("a_ample_int8", None, dict(num_pages=SPILL_AMPLE, kv_quant="int8")),
        ("e_spill_int8", "a_ample_int8",
         dict(num_pages=SPILL_PAGES, spill="on", kv_quant="int8")),
        ("a_ample_spec4", None, dict(num_pages=SPILL_AMPLE, speculate=4)),
        ("f_spill_spec4", "a_ample_spec4",
         dict(num_pages=SPILL_PAGES, spill="on", speculate=4)),
    ]
    runs, streams, timing = {}, {}, None
    for name, twin, kw in variants:
        eng, got, rec = spill_run(pa, serving, model, rounds, **kw)
        streams[name] = got
        if twin is not None:
            same = sum(a == b for r in range(2)
                       for a, b in zip(got[r], streams[twin][r]))
            rec["streams_equal_twin"] = same
            if name != "b_spill_off" and same != 2 * SPILL_TENANTS:
                raise AssertionError(f"{name}: {same} of "
                                     f"{2 * SPILL_TENANTS} streams equal "
                                     f"the ample pool's")
        if kw.get("spill") == "on":
            if not rec["spill_faultback_pages"] > 0:
                raise AssertionError(f"{name}: round 2 faulted nothing back")
            if timing is None:
                timing = page_copy_timing(serving, eng)
        runs[name] = rec
        del eng
        gc.collect()
    if not (runs["c_spill_prefetch"]["import_pages_calls"]
            < runs["d_spill_no_prefetch"]["import_pages_calls"]):
        raise AssertionError("prefetch did not lower the import calls")
    # (b) at f32: recomputation in other chunks, held as serve_pressure
    # holds its streams (bf16 near-ties may flip)
    model32 = copy.deepcopy(model).float()
    del model
    f32 = {}
    for name, kw in (("a_ample", dict(num_pages=SPILL_AMPLE)),
                     ("b_spill_off", dict(num_pages=SPILL_PAGES))):
        _, got, rec = spill_run(pa, serving, model32, rounds, **kw)
        f32[name] = (got, rec)
    same32 = sum(a == b for r in range(2) for a, b in
                 zip(f32["b_spill_off"][0][r], f32["a_ample"][0][r]))
    if same32 != 2 * SPILL_TENANTS:
        raise AssertionError(f"f32 spill-off streams: {same32} of "
                             f"{2 * SPILL_TENANTS} equal the ample pool's")
    del model32
    b, c = runs["b_spill_off"], runs["c_spill_prefetch"]
    rec = {"phase": "serve_spill", "config": "openwebtext",
           "dtype": "bfloat16", **SPILL, "num_pages": SPILL_PAGES,
           "ample_pages": SPILL_AMPLE, "tenants": SPILL_TENANTS,
           "system_prompt": SPILL_SYS, "user_turn": SPILL_TURN,
           "max_new_tokens": MAX_NEW, "runs_in_order": list(runs), **runs,
           "f32": {"streams_equal_ample": same32,
                   "b_spill_off": f32["b_spill_off"][1],
                   "a_ample": f32["a_ample"][1]},
           "page_copy": timing,
           "round2_ttft_p50_ms_spill_off_over_on":
               b["ttft_ms_p50"] / c["ttft_ms_p50"],
           "gpu": gpu}
    emit(rec)
    return rec


def step_syncs(eng) -> tp.List[int]:
    """Step ``eng`` until it drains with the CUDA sync debug mode at
    "warn", counting the synchronizing calls each step makes (the
    warnings it raises, every one recorded)."""
    import warnings

    counts = []
    torch.cuda.set_sync_debug_mode("warn")
    try:
        while eng.has_work:
            with warnings.catch_warnings(record=True) as got:
                warnings.simplefilter("always")
                eng.step()
            counts.append(sum("synchroniz" in str(w.message) for w in got))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return counts


def phase_serve_telemetry(pa, serving, GPT, cfg, gpu):
    """Tracing on the serving main path: serve's 16 requests (bf16, full
    width and depth) with ``telemetry=None`` and ``telemetry=True`` in
    turns (off, on, on, off). Held: the streams, the decode kernel's
    launches and the synchronizing calls of every step are the same on
    and off (a third pair of runs steps under the CUDA sync debug mode,
    off the clock). Recorded: host ms a step each way; from the traced
    run the per-request TTFT, TBT and queue delay (``request_metrics``),
    the Chrome trace (written to build/serve_trace.json) and a flight
    dump (build/serve_flight.json)."""
    model = seeded_model(GPT, cfg, torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    serving.generate_served(model, ps[:2], 4, device=DEVICE, **SERVE)
    torch.cuda.synchronize()
    runs, streams, launches, traced = {}, {}, {}, None
    for turn, telemetry in enumerate((None, True, True, None)):
        eng = serving.ServingEngine(model, **SERVE, device=DEVICE,
                                    telemetry=telemetry)
        pa.paged_decode_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(p, MAX_NEW) for p in ps]
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        mode = "on" if telemetry else "off"
        got = [eng.lookup(r).tokens for r in rids]
        if not all(len(x) == MAX_NEW for x in got):
            raise AssertionError(f"lengths {[len(x) for x in got]}")
        streams.setdefault(mode, got)
        launches.setdefault(mode, set()).add(
            pa.paged_decode_attention.launches)
        if pa.paged_decode_attention.launches != (
                cfg.n_layer * eng.window * eng.windows):
            raise AssertionError("decode launches != n_layer x steps")
        runs[f"turn{turn}_{mode}"] = {"steps": steps, "wall_s": wall,
                                      "host_ms_per_step": 1e3 * wall / steps}
        pages_home(eng)
        if telemetry:
            traced = eng
    if streams["on"] != streams["off"]:
        raise AssertionError("streams differ with tracing on")
    if len(launches["on"] | launches["off"]) != 1:
        raise AssertionError(f"decode launches differ: {launches}")
    syncs = {}
    for telemetry in (None, True):
        eng = serving.ServingEngine(model, **SERVE, device=DEVICE,
                                    telemetry=telemetry)
        for p in ps:
            eng.submit(p, MAX_NEW)
        syncs["on" if telemetry else "off"] = step_syncs(eng)
    if syncs["on"] != syncs["off"] or not sum(syncs["off"]):
        raise AssertionError(f"synchronizing calls a step differ: {syncs}")
    tele = traced.telemetry
    m = tele.finished_request_metrics()
    pct = lambda xs, q: float(np.percentile(sorted(xs), q))  # noqa: E731
    ttft = [1e3 * x["ttft_s"] for x in m]
    tbt = [1e3 * g for x in m for g in x["tbt_s"]]
    qd = [1e3 * x["queue_delay_s"] for x in m]
    trace = serving.chrome_trace(tele)
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "serve_trace.json"), "w") as f:
        json.dump(trace, f)
    flight = traced.flight_dump("chip_smoke serve_telemetry",
                                path=os.path.join("build",
                                                  "serve_flight.json"))
    prom = serving.telemetry.prometheus_text(traced.metrics_snapshot())
    per = lambda mode: [r["host_ms_per_step"] for k, r in runs.items()  # noqa
                        if k.endswith(mode)]
    rec = {"phase": "serve_telemetry", "config": "openwebtext",
           "dtype": "bfloat16", **SERVE, "requests": N_REQUESTS,
           "max_new_tokens": MAX_NEW, "runs_in_order": list(runs), **runs,
           "host_ms_per_step_off": per("off"),
           "host_ms_per_step_on": per("on"),
           "decode_launches": sorted(launches["on"])[0],
           "sync_calls_per_step": syncs["off"],
           "sync_calls_total": sum(syncs["off"]),
           "requests_traced": len(m),
           "ttft_ms_p50": pct(ttft, 50), "ttft_ms_p99": pct(ttft, 99),
           "tbt_ms_p50": pct(tbt, 50), "tbt_ms_p99": pct(tbt, 99),
           "queue_delay_ms_p50": pct(qd, 50),
           "queue_delay_ms_p99": pct(qd, 99),
           "trace_events": len(trace["traceEvents"]),
           "trace_path": "build/serve_trace.json",
           "flight_path": "build/serve_flight.json",
           "flight_events": len(flight["telemetry"]["events"]),
           "prometheus_lines": len(prom.splitlines()), "gpu": gpu}
    emit(rec)
    return model, streams["off"], rec


FRONTDOOR_CANCEL = (2, 5)  # requests cancelled after their first window
FRONTDOOR_QUEUE = 4


def phase_frontdoor(pa, serving, model, cfg, ref, gpu):
    """The async front door on the serving main path: serve's 16 requests
    (bf16, full width and depth, ``model`` from serve_telemetry) through
    ``AsyncFrontDoor`` with its background task (``async with``), each
    stream consumed by ``async for``. Run 1: every stream equals
    ``run()``'s (``ref``), decode launches = n_layer x decode steps; the
    time from each submit to its first streamed token. Run 2,
    ``max_queue=4`` with ``backpressure="wait"``, the invariants checked
    every round: every submitter completes; requests 2 and 5 are
    cancelled after their first window (their tokens a prefix of
    ``ref``, their pages home); a 17th request with a passed deadline is
    shed before dispatch; every other stream equals ``ref``."""
    import asyncio

    ps = prompts(cfg.vocab_size)

    async def serve(eng, check, cancel=(), late=False):
        fd = serving.AsyncFrontDoor(eng, check_invariants=check)
        firsts = {}

        async def one(i, p, deadline_s=None):
            t0 = time.perf_counter()
            st = await fd.submit(p, MAX_NEW, deadline_s=deadline_s)
            async for _ in st:
                if i not in firsts:
                    firsts[i] = time.perf_counter() - t0
                    if i in cancel:
                        st.cancel()  # after its first window's tokens
            return st

        async with fd:
            jobs = [one(i, p) for i, p in enumerate(ps)]
            if late:
                jobs.append(one(len(ps), ps[0], deadline_s=-1.0))
            out = await asyncio.gather(*jobs)
            await fd.drain()
        return out, firsts, fd.stats()

    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    pa.paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, firsts, _ = asyncio.run(serve(eng, check=False))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    if [st.tokens for st in out] != ref or any(
            st.outcome != "finished" for st in out):
        raise AssertionError("front-door streams differ from run()'s")
    if launches != cfg.n_layer * eng.window * eng.windows or not launches:
        raise AssertionError("decode launches != n_layer x decode steps")
    pages_home(eng)
    first_ms = sorted(1e3 * v for v in firsts.values())

    eng2 = serving.ServingEngine(model, **SERVE, device=DEVICE,
                                 max_queue=FRONTDOOR_QUEUE)
    out2, _, st2 = asyncio.run(serve(eng2, check=True,
                                     cancel=FRONTDOOR_CANCEL, late=True))
    for i, st in enumerate(out2[: len(ps)]):
        if i in FRONTDOOR_CANCEL:
            if not (st.outcome == "cancelled" and st.tokens
                    and st.tokens == ref[i][: len(st.tokens)]
                    and len(st.tokens) < MAX_NEW):
                raise AssertionError(f"cancelled stream {i}: {st.outcome}")
        elif st.outcome != "finished" or st.tokens != ref[i]:
            raise AssertionError(f"stream {i}: {st.outcome}")
    if out2[-1].outcome != "expired" or out2[-1].tokens:
        raise AssertionError(f"the late request: {out2[-1].outcome}")
    if not (st2["deferred_submits"] > 0 and st2["cancelled_requests"] == 2
            and st2["deadline_shed_requests"] == 1):
        raise AssertionError(f"front-door counts {st2}")
    pages_home(eng2)
    rec = {"phase": "frontdoor", "config": "openwebtext", "dtype": "bfloat16",
           **SERVE, "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
           "wall_s": wall, "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
           "streams_equal_run": True, "decode_launches": launches,
           "submit_to_first_token_ms_p50": float(np.percentile(first_ms, 50)),
           "submit_to_first_token_ms_p99": float(np.percentile(first_ms, 99)),
           "pressure": {"max_queue": FRONTDOOR_QUEUE,
                        "cancelled": list(FRONTDOOR_CANCEL),
                        "cancelled_tokens": [len(out2[i].tokens)
                                             for i in FRONTDOOR_CANCEL],
                        "outcomes": [st.outcome for st in out2],
                        **{k: st2[k] for k in (
                            "deferred_submits", "cancelled_requests",
                            "deadline_shed_requests", "frontdoor_steps",
                            "cached_pages")}},
           "gpu": gpu}
    emit(rec)
    return rec


# -- the serving cluster on one card ------------------------------------------

# one slots=16 engine, the cluster (replicas in turn on this thread), the
# cluster under a watchdog that never trips (on worker threads)
CLUSTER_TURNS = ("engine", "cluster", "threaded", "threaded", "cluster",
                 "engine")
NO_TRIP_S = 600.0
HANDOFF_LENS = (64, 256, 512)  # prompt tokens of the timed handoffs
HANDOFF_REPS = 5
# the disaggregated 2+1 cluster: replica 0 (prefill) crashes at its first
# step with its 8 requests queued (a warm failover to replica 1), replica
# 1's (prefill) first export fails (served again cold), replica 2
# (decode) has one transient at its 2nd step (retried)
DISAGG_CHAOS = "1:crash@0;1:handoff@1;2:transient@2"
# replicas=3: replica 1 stalls past the watchdog at its 4th step (the
# deadline leaves a full-width admission round room)
WEDGE_PLAN, WEDGE_TIMEOUT_S = "4:wedge@1:9", 8.0


def cluster_launches(pa, cl, n_layer: int) -> tp.Dict[str, tp.Any]:
    """The paged kernels' launches of a run, read off their counters and
    held to the replicas' dispatches: decode = n_layer x the decode steps
    summed over replicas, verify = n_layer x the verify dispatches; a
    prefill replica made no decode or verify dispatch, a decode replica
    no prefill dispatch while nothing was evicted."""
    dec = pa.paged_decode_attention.launches
    ver = pa.paged_verify_attention.launches
    steps = sum(e.window * (e.windows - e.verify_dispatches)
                for e in cl.engines)
    if dec != n_layer * steps:
        raise AssertionError(f"decode launches {dec} != n_layer x decode "
                             f"steps {n_layer} x {steps}")
    vd = sum(e.verify_dispatches for e in cl.engines)
    if ver != n_layer * vd:
        raise AssertionError(f"verify launches {ver} != n_layer x verify "
                             f"dispatches {n_layer} x {vd}")
    roles = [e.role for e in cl.engines]
    for e in cl.engines:
        if e.role == "prefill" and (e.decode_dispatches or
                                    e.verify_dispatches):
            raise AssertionError("a prefill replica decoded")
        if e.role == "decode" and e.prefill_dispatches and not e.evictions:
            raise AssertionError("a decode replica prefilled")
    return {"decode_launches": dec, "verify_launches": ver, "roles": roles,
            "per_replica": [{"decode_dispatches": e.decode_dispatches,
                             "verify_dispatches": e.verify_dispatches,
                             "prefill_dispatches": e.prefill_dispatches,
                             "tokens_generated": e.tokens_generated}
                            for e in cl.engines]}


def cluster_serve(pa, serving, model, ps, **kw):
    """Serve ``ps`` (request seed = index, ``MAX_NEW`` tokens) on a
    ``ServingCluster`` of ``SERVE`` engines, the page invariants on every
    live replica after every step; returns the cluster, its streams and
    a run record. The launch counters are zeroed just before."""
    cl = serving.ServingCluster(model, device=DEVICE, **{**SERVE, **kw})
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [cl.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    steps = 0
    while cl.has_work:
        cl.step()
        steps += 1
        for i in cl._alive():
            pages_home_live(cl.engines[i])
        if steps > 2000:
            raise AssertionError("the cluster did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [cl.finished[r] for r in rids]
    if not all(len(r.tokens) == MAX_NEW for r in reqs):
        raise AssertionError(f"lengths {[len(r.tokens) for r in reqs]}")
    for i in cl._alive():
        pages_home(cl.engines[i])
    rec = run_record_cluster(reqs, wall)
    rec["steps"] = steps
    return cl, [r.tokens for r in reqs], rec


def pages_home_live(eng) -> None:
    """The page invariants of a live engine (the spill store's too)."""
    eng.alloc.check()
    if eng.index is not None:
        eng.index.check(eng.alloc, eng._spill_store)


def run_record_cluster(reqs, wall):
    """Tokens/s and TTFT of a run's requests."""
    ttft = sorted(1e3 * (r.first_token_time - r.submit_time) for r in reqs)
    tokens = sum(len(r.tokens) for r in reqs)
    return {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)),
            "ttft_ms_p99": float(np.percentile(ttft, 99))}


def phase_cluster(pa, serving, model, cfg, ref, gpu):
    """``ServingCluster(replicas=2)`` of serve's engines on one card
    (bf16, full width and depth, ``model`` from serve_telemetry) on
    serve's 16 greedy requests: every stream equals the one engine's
    (``ref``, request for request); ``stats()`` has every
    ``CLUSTER_STATS_KEYS`` key and its counters are the replicas' sums;
    decode launches = n_layer x the replicas' decode steps; both replicas
    served and their pages are home. In turns (``CLUSTER_TURNS``) beside
    one ``slots=16`` engine and the same cluster under a watchdog that
    never trips, whose replicas step on worker threads: tokens/s, TTFT
    and host ms a step."""
    ps = prompts(cfg.vocab_size)
    runs, launches, clus = {}, None, None
    for turn, kind in enumerate(CLUSTER_TURNS):
        if kind == "engine":
            eng = serving.ServingEngine(model, **{**SERVE, "slots": 16},
                                        device=DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
            fin = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            reqs = [fin[r] for r in rids]
            pages_home(eng)
            rec = run_record_cluster(reqs, wall)
            rec["streams_equal_slots8"] = sum(
                r.tokens == x for r, x in zip(reqs, ref))
        else:
            cl, got, rec = cluster_serve(
                pa, serving, model, ps, replicas=2,
                dispatch_timeout_s=NO_TRIP_S if kind == "threaded" else None)
            if (cl._pool is None) != (kind == "cluster"):
                raise AssertionError(f"{kind}: stepping mode")
            if got != ref:
                raise AssertionError(f"{kind}: streams differ from one "
                                     f"engine's")
            launches = cluster_launches(pa, cl, cfg.n_layer)
            if launches["verify_launches"] or not all(
                    e.tokens_generated for e in cl.engines):
                raise AssertionError(f"cluster launches {launches}")
            rec["host_ms_per_step"] = 1e3 * rec["wall_s"] / rec["steps"]
            if kind == "cluster":
                clus = cl
        runs[f"turn{turn}_{kind}"] = rec
    st = clus.stats()
    if tuple(st) != serving.CLUSTER_STATS_KEYS:
        raise AssertionError("cluster stats keys differ from "
                             "CLUSTER_STATS_KEYS")
    per = st["per_replica"]
    for k in ("tokens_generated", "windows", "decode_dispatches",
              "prefill_dispatches", "prompt_tokens_total",
              "prefill_tokens_computed"):
        if st[k] != sum(p[k] for p in per):
            raise AssertionError(f"cluster {k} {st[k]} != replicas' sum")
    if st["tokens_generated"] != N_REQUESTS * MAX_NEW:
        raise AssertionError(f"tokens {st['tokens_generated']}")
    by = lambda kind, key: [r[key] for k, r in runs.items()  # noqa: E731
                            if k.endswith(kind)]
    rec = {"phase": "cluster", "config": "openwebtext", "dtype": "bfloat16",
           **SERVE, "replicas": 2, "requests": N_REQUESTS,
           "max_new_tokens": MAX_NEW, "runs_in_order": list(runs), **runs,
           "cluster_tokens_per_s": by("cluster", "tokens_per_s"),
           "threaded_tokens_per_s": by("threaded", "tokens_per_s"),
           "engine16_tokens_per_s": by("engine", "tokens_per_s"),
           "cluster_ttft_ms_p50": by("cluster", "ttft_ms_p50"),
           "threaded_ttft_ms_p50": by("threaded", "ttft_ms_p50"),
           "engine16_ttft_ms_p50": by("engine", "ttft_ms_p50"),
           "cluster_host_ms_per_step": by("cluster", "host_ms_per_step"),
           "threaded_host_ms_per_step": by("threaded", "host_ms_per_step"),
           "streams_equal_one_engine": True, **launches,
           "placement": [clus.engines[0].tokens_generated // MAX_NEW,
                         clus.engines[1].tokens_generated // MAX_NEW],
           "stats": {k: st[k] for k in st if k != "per_replica"},
           "gpu": gpu}
    emit(rec)
    return rec


def handoff_timing(serving, model, gpu):
    """One request's handoff on the card, prompts of ``HANDOFF_LENS``
    tokens: a prefill-role engine prefills it, then ``export_request``
    and ``import_request`` into a decode-role engine (prefix cache off
    on both, so every page moves) between CUDA events on the stream
    (device ms) and the host clock (host ms: queueing the copies), the
    stream idle before; median of ``HANDOFF_REPS``. The first handoff of
    each length is held byte for byte: the destination's pages and
    logits row against the source's before the export."""
    kw = dict(SERVE, device=DEVICE, prefix_cache=False)
    src = serving.ServingEngine(model, role="prefill", **kw)
    dst = serving.ServingEngine(model, role="decode", **kw)
    rng = np.random.default_rng(SEED + 7)
    out = {}
    for n in HANDOFF_LENS:
        dev_ms, host_ms, rec = [], [], None
        for rep in range(HANDOFF_REPS + 1):
            src.submit(rng.integers(0, model.config.vocab_size, size=n)
                       .astype(np.int32), MAX_NEW)
            while not src.handoff_ready_slots():
                src.step()
            (s,) = src.handoff_ready_slots()
            pages = [int(x) for x in src.bt[s, :-(-n // src.page_size)]]
            want = [src.pool.k[:, pages].clone(),
                    src.pool.v[:, pages].clone(), src.logits[s].clone()]
            torch.cuda.synchronize()
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            t0 = time.perf_counter()
            rec = src.export_request(s)
            rid = dst.import_request(rec)
            host = time.perf_counter() - t0
            e1.record()
            torch.cuda.synchronize()
            if rid is None:
                raise AssertionError("the import found no slot")
            (t,) = dst._active_slots()
            got_pages = [int(x) for x in dst.bt[t, : len(pages)]]
            got = [dst.pool.k[:, got_pages], dst.pool.v[:, got_pages],
                   dst.logits[t]]
            bits = lambda a: (a.view(torch.int16)  # noqa: E731
                              if a.dtype == torch.bfloat16 else a)
            if not all(torch.equal(bits(a), bits(b))
                       for a, b in zip(got, want)):
                raise AssertionError(f"the {n}-token handoff is not "
                                     f"byte-exact")
            dst.cancel(rid)
            if rep:  # the first is a warm-up (pinned allocations)
                dev_ms.append(e0.elapsed_time(e1))
                host_ms.append(1e3 * host)
        out[str(n)] = {"pages": rec.n_pages, "nbytes": rec.nbytes,
                       "logits_row_bytes": rec.logits_row.nbytes,
                       "device_ms": statistics.median(dev_ms),
                       "host_ms": statistics.median(host_ms),
                       "device_ms_all": dev_ms, "host_ms_all": host_ms,
                       "gb_per_s": rec.nbytes / statistics.median(dev_ms)
                       / 1e6, "gpu": gpu}
    pages_home(src)
    pages_home(dst)
    return out


def phase_disagg(pa, serving, model, cfg, ref, gpu):
    """Disaggregated pools on one card (bf16, full width and depth):
    ``prefill_replicas=1, decode_replicas=1`` (prefix cache on), then
    ``2+1`` at ``speculate=4``, on serve's 16 requests. Streams equal the
    monolithic engine's (``ref``; spec-on: a monolithic ``speculate=4``
    engine's, run here): the handoff is byte for byte and a decode
    replica decodes at M = slots as the monolithic engine does.
    ``handoffs`` = 16; the prefill replicas make no decode or verify
    dispatch, the decode replica no prefill dispatch; launches = n_layer x
    the decode steps (verify dispatches). The pump's host time a run, and
    one handoff timed alone (``handoff_timing``)."""
    ps = prompts(cfg.vocab_size)
    rec = {"phase": "disagg", "config": "openwebtext", "dtype": "bfloat16",
           **SERVE, "requests": N_REQUESTS, "max_new_tokens": MAX_NEW}
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE, speculate=4)
    rids = [eng.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
    fin = eng.run()
    ref_spec = [fin[r].tokens for r in rids]
    for name, kw, want in (
            ("p1_d1", dict(prefill_replicas=1, decode_replicas=1), ref),
            ("p2_d1_spec4", dict(prefill_replicas=2, decode_replicas=1,
                                 speculate=4), ref_spec)):
        cl = serving.ServingCluster(model, device=DEVICE, **SERVE, **kw)
        pump, real_pump = {"s": 0.0}, cl._pump_handoffs

        def timed_pump():
            t0 = time.perf_counter()
            real_pump()
            pump["s"] += time.perf_counter() - t0

        cl._pump_handoffs = timed_pump
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        crids = [cl.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
        while cl.has_work:
            cl.step()
            for e in cl.engines:
                pages_home_live(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = [cl.finished[r].tokens for r in crids]
        if got != want:
            diff = sum(a != b for a, b in zip(got, want))
            raise AssertionError(f"{name}: {diff} streams differ from the "
                                 f"monolithic engine's")
        st = cl.stats()
        if st["handoffs"] != N_REQUESTS or st["handoff_failures"]:
            raise AssertionError(f"{name}: handoffs {st['handoffs']}")
        launches = cluster_launches(pa, cl, cfg.n_layer)
        if kw.get("speculate"):
            if launches["decode_launches"] or not launches["verify_launches"]:
                raise AssertionError(f"{name}: launches {launches}")
        elif launches["verify_launches"] or not launches["decode_launches"]:
            raise AssertionError(f"{name}: launches {launches}")
        for e in cl.engines:
            pages_home(e)
        reqs = [cl.finished[r] for r in crids]
        rec[name] = {**run_record_cluster(reqs, wall), **launches,
                     "streams_equal_monolithic": True,
                     **{k: st[k] for k in (
                         "handoffs", "handoff_pages_moved", "handoff_bytes",
                         "prefix_hit_rate", "prefill_tokens_computed")},
                     "pump_host_s": pump["s"]}
    rec["handoff"] = handoff_timing(serving, model, gpu)
    rec["gpu"] = gpu
    emit(rec)
    return rec


@contextlib.contextmanager
def prefill_chunk_log(serving, log: tp.List[tp.Tuple]):
    """Append every prefill chunk an engine runs to ``log`` as (engine id,
    prompt length, start, length, bucket)."""
    real = serving.ServingEngine._prefill_one_chunk

    def logged(self, s):
        p = int(self.slot_req[s].prompt.size)
        start = int(self.pooled_len[s])
        clen = p - start if self.prefill_chunk is None else min(
            self.prefill_chunk, p - start)
        log.append((id(self), p, start, clen, self._prefill_bucket(clen)))
        return real(self, s)

    serving.ServingEngine._prefill_one_chunk = logged
    try:
        yield log
    finally:
        serving.ServingEngine._prefill_one_chunk = real


def reserved_prefills(cl, log, free_log) -> tp.Dict[str, tp.Any]:
    """The prefill chunks (start, length, bucket) that the requests a dead
    replica had begun to prefill took when re-served on a live one,
    beside the same requests' chunks in a fault-free run (``free_log``;
    requests named by prompt length, which the prompts do not share)."""
    dead = {id(cl.engines[i]) for i, h in enumerate(cl.health)
            if h == "dead"}
    begun = {p for e, p, *_ in log if e in dead}
    live: tp.Dict[int, tp.List] = {}
    free: tp.Dict[int, tp.List] = {}
    for entries, out, keep in ((log, live, lambda e: e not in dead),
                               (free_log, free, lambda e: True)):
        for e, p, *chunk in entries:
            if p in begun and keep(e):
                out.setdefault(p, []).append(chunk)
    return {"reserved_prompt_lens": sorted(begun),
            "reserved_chunks": {str(p): live.get(p, []) for p in begun},
            "fault_free_chunks": {str(p): free.get(p, []) for p in begun},
            "reserved_chunks_equal_fault_free": all(
                live.get(p) == free.get(p) for p in begun)}


def first_differences(ps, got, ref) -> tp.List[tp.Dict[str, int]]:
    """Each request whose stream differs from ``ref``'s: its index, prompt
    length and first differing token."""
    return [{"request": i, "prompt_len": int(ps[i].size),
             "token": next(k for k, (x, y) in enumerate(zip(a, b))
                           if x != y)}
            for i, (a, b) in enumerate(zip(got, ref)) if a != b]


def phase_cluster_chaos(pa, serving, model, cfg, ref, gpu):
    """Faults on one card (bf16, full width and depth, serve's 16
    requests): the disaggregated 2+1 cluster under ``DISAGG_CHAOS`` (a
    prefill replica crashes, the other's export fails once, the decode
    replica has a transient), then ``replicas=3`` with a replica wedged
    past the watchdog (``WEDGE_PLAN``, ``dispatch_timeout_s``); each with
    ``flight_dir``. Every stream equals the fault-free one's (``ref``),
    the page invariants hold on the live replicas after every step, and
    ``flight_dir`` holds one dump per dead replica. The abandoned
    engine's pool stays allocated: its bytes are recorded. The wedge
    case records the prefill chunks its re-served requests took beside a
    fault-free ``replicas=3`` run's, and any differing stream's request
    and first differing token, before it fails."""
    ps = prompts(cfg.vocab_size)
    rec = {"phase": "cluster_chaos", "config": "openwebtext",
           "dtype": "bfloat16", **SERVE, "requests": N_REQUESTS}
    with prefill_chunk_log(serving, []) as free_log:
        cluster_serve(pa, serving, model, ps, replicas=3)
    for name, kw in (
            ("disagg", dict(prefill_replicas=2, decode_replicas=1,
                            fault_plan=serving.FaultPlan.parse(DISAGG_CHAOS),
                            backoff_s=0.0)),
            ("wedge", dict(replicas=3,
                           fault_plan=serving.FaultPlan.parse(WEDGE_PLAN),
                           dispatch_timeout_s=WEDGE_TIMEOUT_S))):
        d = os.path.join("build", f"cluster_flight_{name}")
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        with prefill_chunk_log(serving, []) as log:
            cl, got, run = cluster_serve(pa, serving, model, ps,
                                         flight_dir=d, **kw)
        if name == "wedge":
            run.update(reserved_prefills(cl, log, free_log))
        if got != ref:
            run["differ"] = first_differences(ps, got, ref)
            rec[name] = run
            emit(rec)
            raise AssertionError(f"{name}: streams differ from the "
                                 f"fault-free run's: {run['differ']}")
        dead = [i for i, h in enumerate(cl.health) if h == "dead"]
        if not dead or len(os.listdir(d)) != len(dead) or len(
                cl.flight_dumps) != len(dead):
            raise AssertionError(f"{name}: {len(os.listdir(d))} dumps for "
                                 f"dead replicas {dead}")
        st = cl.stats()
        run.update({k: st[k] for k in (
            "failovers", "requeued_requests", "retries", "watchdog_trips",
            "handoffs", "handoff_failures", "faults_injected")},
            health=list(cl.health), health_reason=list(cl.health_reason),
            flight_dumps=[os.path.basename(p) for p in cl.flight_dumps])
        if name == "disagg":
            if st["handoff_failures"] != 1 or st["retries"] != 1 or (
                    cl.health_reason[0] != "crashed"):
                raise AssertionError(f"disagg chaos: {run}")
        else:
            if st["watchdog_trips"] != 1 or cl.health_reason[1] != "wedged":
                raise AssertionError(f"wedge: {run}")
            abandoned = cl.engines[1]
            run["abandoned_pool_bytes"] = int(
                abandoned.pool.k.nbytes + abandoned.pool.v.nbytes)
            run["abandoned_slots_frozen"] = len(abandoned._active_slots())
        rec[name] = run
    rec["gpu"] = gpu
    emit(rec)
    return rec


def phase_affinity(pa, serving, model, cfg, gpu):
    """Prefix-affinity routing and the handoff of a shared prefix on one
    card (bf16, full width and depth): serve_spill's 12 tenants
    (512-token system prompts, 32-token turns, ``SPILL``'s engines with
    their ample pools), round 1 then round 2 in reverse tenant order,
    served by one engine (the monolithic streams), by ``replicas=2`` with
    ``affinity=False`` (least-loaded admission then sends each tenant to
    the other replica) and ``affinity=True``, and by the disaggregated
    ``1+1`` pools. Every stream equals the monolithic engine's; the hit
    rate is strictly higher with affinity. In ``1+1`` round 2's imports
    find the tenant's system prompt in the decode replica's index: the
    ``handoff`` import events must report aliased pages (only the rest
    come from the payload), and the launches are held to the roles."""
    rounds = spill_prompts(cfg.vocab_size)
    rounds = [rounds[0], rounds[1][::-1]]
    out, streams = {}, {}
    for name, kw in (("mono", None),
                     ("off", dict(replicas=2, affinity=False)),
                     ("on", dict(replicas=2, affinity=True)),
                     ("p1_d1", dict(prefill_replicas=1, decode_replicas=1,
                                    telemetry=True))):
        if kw is None:
            srv = serving.ServingEngine(model, device=DEVICE, **SPILL)
            engines = [srv]
        else:
            srv = serving.ServingCluster(model, device=DEVICE, **kw, **SPILL)
            engines = srv.engines
        pa.paged_decode_attention.launches = 0
        pa.paged_verify_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = []
        for ps in rounds:
            rids = [srv.submit(p, MAX_NEW, seed=i) for i, p in enumerate(ps)]
            while srv.has_work:
                srv.step()
                for e in engines:
                    pages_home_live(e)
            got.append([srv.finished[r].tokens for r in rids])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        streams[name] = got
        out[name] = {
            "wall_s": wall, "hit_rate": st["prefill_tokens_saved"]
            / st["prompt_tokens_total"],
            **{k: st[k] for k in ("prefill_tokens_saved",
                                  "prefill_tokens_computed",
                                  "prompt_tokens_total", "tokens_generated")},
            **{k: st[k] for k in ("prefix_affinity_hits", "routed_fallback",
                                  "handoffs", "handoff_pages_moved",
                                  "handoff_bytes") if kw is not None}}
        for e in engines:
            pages_home(e)
        if name == "p1_d1":
            if st["handoffs"] != 2 * SPILL_TENANTS or st["handoff_failures"]:
                raise AssertionError(f"p1_d1: handoffs {st['handoffs']}")
            out[name].update(cluster_launches(pa, srv, cfg.n_layer))
            imports = [e.data for log in srv.engines[1].telemetry
                       .request_log.values() for e in log
                       if e.kind == "handoff"
                       and e.data["direction"] == "import"]
            aliased = [d["aliased"] for d in imports]
            if len(imports) != 2 * SPILL_TENANTS or not any(aliased[
                    SPILL_TENANTS:]) or any(d["aliased"] + d["imported"]
                                            != d["pages"] for d in imports):
                raise AssertionError(f"p1_d1: import events {imports}")
            out[name]["import_aliased_pages"] = aliased
            out[name]["import_fresh_pages"] = [d["imported"]
                                               for d in imports]
    for name in ("off", "on", "p1_d1"):
        if streams[name] != streams["mono"]:
            diff = sum(a != b for r, m in zip(streams[name], streams["mono"])
                       for a, b in zip(r, m))
            raise AssertionError(f"{name}: {diff} streams differ from the "
                                 f"monolithic engine's")
    if not out["on"]["hit_rate"] > out["off"]["hit_rate"]:
        raise AssertionError(f"hit rate with affinity {out['on']} not above "
                             f"{out['off']}")
    rec = {"phase": "affinity", "config": "openwebtext", "dtype": "bfloat16",
           **SPILL, "replicas": 2, "tenants": SPILL_TENANTS,
           "round2_order": "reversed", **out,
           "streams_equal_monolithic": True, "gpu": gpu}
    emit(rec)
    return rec


def phase_frontdoor_cluster(pa, serving, model, cfg, ref, gpu):
    """``AsyncFrontDoor`` over ``ServingCluster(replicas=2)`` (bf16, full
    width and depth), its background task, streams consumed by ``async
    for``: every stream equals ``run()``'s (``ref``), decode launches =
    n_layer x the replicas' decode steps; then request 2 cancelled after
    its first window: the cancel reaches the replica that holds it
    (``cancelled`` there, the route dropped), every other stream equals
    ``ref``, pages home on both replicas."""
    import asyncio

    ps = prompts(cfg.vocab_size)

    async def serve(cl, cancel=None):
        fd = serving.AsyncFrontDoor(cl, check_invariants=True)
        owner = {}

        async def one(i, p):
            st = await fd.submit(p, MAX_NEW, seed=i)
            async for _ in st:
                if i == cancel and i not in owner:
                    owner[i] = cl._route[st.rid][0]
                    st.cancel()
            return st

        async with fd:
            out = await asyncio.gather(*(one(i, p) for i, p in
                                         enumerate(ps)))
            await fd.drain()
        return out, owner

    cl = serving.ServingCluster(model, device=DEVICE, replicas=2, **SERVE)
    pa.paged_decode_attention.launches = 0
    pa.paged_verify_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = asyncio.run(serve(cl))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if [st.tokens for st in out] != ref or any(
            st.outcome != "finished" for st in out):
        raise AssertionError("front-door cluster streams differ from run()'s")
    launches = cluster_launches(pa, cl, cfg.n_layer)
    for e in cl.engines:
        pages_home(e)
    cl2 = serving.ServingCluster(model, device=DEVICE, replicas=2, **SERVE)
    out2, owner = asyncio.run(serve(cl2, cancel=2))
    (o,) = owner.values()
    st2 = out2[2]
    if not (st2.outcome == "cancelled" and st2.tokens
            and st2.tokens == ref[2][: len(st2.tokens)]
            and st2.rid in cl2.cancelled and st2.rid not in cl2._route
            and cl2.engines[o].cancelled_requests == 1
            and cl2.engines[1 - o].cancelled_requests == 0):
        raise AssertionError(f"the cancel did not reach replica {o}")
    for i, st in enumerate(out2):
        if i != 2 and (st.outcome != "finished" or st.tokens != ref[i]):
            raise AssertionError(f"stream {i}: {st.outcome}")
    for e in cl2.engines:
        pages_home(e)
    rec = {"phase": "frontdoor_cluster", "config": "openwebtext",
           "dtype": "bfloat16", **SERVE, "replicas": 2,
           "requests": N_REQUESTS, "max_new_tokens": MAX_NEW, "wall_s": wall,
           "tokens_per_s": N_REQUESTS * MAX_NEW / wall,
           "streams_equal_run": True, **launches,
           "cancel": {"request": 2, "owner": o,
                      "tokens": len(st2.tokens)}, "gpu": gpu}
    emit(rec)
    return rec


MOE_NAME = "openwebtext_moe"
# serve_moe's depth: half of openwebtext_moe's 12 layers (full width;
# all 12 before the cut that made room for serve_tensor)
SERVE_MOE_LAYERS = 6
# the train_moe phase: overrides of the openwebtext_moe experiment (train's
# 16 x 1024 tokens a step in 2 microbatches), 10 steps, one eval midway
MOE_SET = dict(batch_size=16, g_accum_iters=2, max_steps=10, warmup_steps=3,
               lr_decay_steps=10, eval_interval=5, eval_batches=1,
               ckpt_interval=1000, log_interval=1)
MOE_STAGES = ("route", "slots", "dispatch", "experts", "combine")


class MoECalls:
    """Records every MoE layer call inside a ``with`` block: its T and its
    dropped-claim fraction (a device scalar, read after the block). A
    call captured into a program's CUDA graph is recorded once, its
    scalar the last replay's; a program's warm-up call is not."""

    def __enter__(self):
        from midgpt_tpu_torch.models.gpt import MoEMLP
        from midgpt_tpu_torch.serving.programs import warming_up

        self.cls, self.forward, self.calls = MoEMLP, MoEMLP.forward, []
        forward, calls = self.forward, self.calls

        def recording(mlp, x, key=None, return_dropped=False,
                      need_aux=True):
            y, aux, dropped = forward(mlp, x, key, True, need_aux)
            if not warming_up():
                calls.append((x.shape[0], x.shape[1], dropped))
            return (y, aux, dropped) if return_dropped else (y, aux)

        MoEMLP.forward = recording
        return self

    def __exit__(self, *exc):
        self.cls.forward = self.forward

    def by_shape(self) -> tp.Dict[str, dict]:
        """Per call shape ``B x T``: the calls and their dropped fractions'
        mean and maximum."""
        out = {}
        for b, t, d in self.calls:
            out.setdefault(f"{b}x{t}", []).append(float(d))
        return {k: {"calls": len(v), "dropped_mean": float(np.mean(v)),
                    "dropped_max": max(v)} for k, v in out.items()}


def serve_once(pa, serving, model, ps):
    """Serve's engine and traffic on ``model``: the decode kernel's
    launches counted around this run alone, and the run's record."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    pa.paged_decode_attention.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in ps]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pa.paged_decode_attention.launches
    reqs = [finished[r] for r in rids]
    n_layer, vocab = model.config.n_layer, model.config.vocab_size
    steps = eng.windows * eng.window
    if not all(len(r.tokens) == MAX_NEW for r in reqs):
        raise AssertionError(f"lengths {[len(r.tokens) for r in reqs]}")
    if not all(0 <= t < vocab for r in reqs for t in r.tokens):
        raise AssertionError("token id outside the vocabulary")
    if launches != n_layer * steps or launches == 0:
        raise AssertionError(
            f"decode launches {launches} != n_layer x decode steps "
            f"{n_layer} x {steps}")
    pages_home(eng)
    rec = {**run_record(eng, reqs, wall), "windows": eng.windows,
           "decode_steps": steps, "decode_kernel_launches": launches,
           "distinct_streams": len({tuple(r.tokens) for r in reqs})}
    return rec, [r.tokens for r in reqs]


MLP_SHAPES = {"decode": (SERVE["slots"], 1), "verify": (SPEC["slots"], 5),
              "prefill": (1, 512)}


def mlp_timing(dense, moe, d: int) -> tp.Dict[str, dict]:
    """One layer's MLP, dense and MoE (bf16), at the serving paths' call
    shapes: device ms from a CUDA graph (its capture fails on a host
    sync, so the MoE layer's is the check that its forward has none) and
    the eager host-dispatch rate (``eager_ms``)."""
    out = {}
    for name, (b, t) in MLP_SHAPES.items():
        x = torch.randn(b, t, d, generator=torch.Generator().manual_seed(
            SEED)).to(DEVICE, torch.bfloat16)
        row = {"B": b, "T": t}
        for kind, mlp in (("dense", dense), ("moe", moe)):
            def fn(i, mlp=mlp):
                with torch.no_grad():
                    return mlp(x)
            row[f"{kind}_device_ms"] = device_ms(fn, reps=20)
            row[f"{kind}_eager_ms"] = eager_ms(fn, reps=50)
        out[name] = row
    return out


def phase_serve_moe(pa, serving, GPT, gpu):
    """The serving main path on ``openwebtext_moe`` at full width
    (``SERVE_MOE_LAYERS`` of its 12 layers of 8 experts, D=768, F=3072;
    random init from SEED, bf16):
    serve's engine (slots=8, window=4, page_size=16, prefix cache on) and
    its 16 requests, dense ``openwebtext`` served just before it in the
    same process; decode launches = n_layer x decode steps; a second run
    of the same requests must give the same streams; serve_spec's
    requests at speculate=4 (verify launches = n_layer x dispatches,
    decode 0); one decode window's logits through the kernel against the
    plain path (bf16 by the triangle rule, f32 within 1e-4 of the
    largest logit); the fraction of claims dropped per MoE call shape
    over one engine step of prefill and verify; one layer's MLP, dense
    and MoE, timed at the decode, verify and prefill shapes
    (``mlp_timing``)."""
    import dataclasses

    from midgpt_tpu_torch.config import get_model_config

    cfg = dataclasses.replace(get_model_config(MOE_NAME),
                              n_layer=SERVE_MOE_LAYERS)
    ps = prompts(cfg.vocab_size)
    runs, models = {}, {}
    for name in ("openwebtext", MOE_NAME):
        c = cfg if name == MOE_NAME else get_model_config(name)
        model = seeded_model(GPT, c, torch.bfloat16)
        # warm-up (cuBLAS handles, allocator): a short run, not counted
        serving.generate_served(model, ps[:2], 4, device=DEVICE, **SERVE)
        runs[name], streams = serve_once(pa, serving, model, ps)
        models[name] = model if name == MOE_NAME else model.blocks[0].mlp
        del model
    layer = mlp_timing(models["openwebtext"], models[MOE_NAME].blocks[0].mlp,
                       cfg.n_embd)
    model = models.pop(MOE_NAME)
    again, again_streams = serve_once(pa, serving, model, ps)
    if again_streams != streams:
        raise AssertionError("MoE greedy streams differ between two runs")

    sps = spec_prompts(cfg.vocab_size)
    pa.paged_verify_attention.launches = 0
    pa.paged_decode_attention.launches = 0
    eng, reqs, wall = serve_run(serving, model, sps,
                                speculate=SPEC["speculate"])
    verify_launches = pa.paged_verify_attention.launches
    decode_launches = pa.paged_decode_attention.launches
    if (verify_launches != cfg.n_layer * eng.verify_dispatches
            or verify_launches == 0 or decode_launches != 0):
        raise AssertionError(
            f"verify launches {verify_launches} != n_layer x dispatches "
            f"{cfg.n_layer} x {eng.verify_dispatches}, or decode launches "
            f"{decode_launches} != 0")
    spec = {**run_record(eng, reqs, wall),
            "verify_dispatches": eng.verify_dispatches,
            "verify_kernel_launches": verify_launches,
            "decode_kernel_launches": decode_launches,
            "halves": {"random": spec_half(reqs[:8]),
                       "repetitive": spec_half(reqs[8:])}}
    from midgpt_tpu_torch.ops import int8_matmul as im

    graphs = {f"greedy_spec{k}": graphs_case(
        pa, im, serving, model, sps if k else ps, speculate=k)
        for k in (0, SPEC["speculate"])}
    prefill_graphs = {"bf16": prefill_replay_check(serving, model),
                      "int8_pool": prefill_replay_check(
                          serving, model, kv_quant="int8")}

    # claims dropped: one step of a speculate=4 engine (admission, every
    # prefill, one verify dispatch) with each MoE call recorded
    eng = serving.ServingEngine(model, **SPEC, device=DEVICE)
    for p in sps:
        eng.submit(p, MAX_NEW)
    with MoECalls() as rec_calls:
        eng.step()
        eng.step()
    drops = rec_calls.by_shape()
    verify_t = f"{SPEC['slots']}x{SPEC['speculate'] + 1}"
    if verify_t not in drops or not any(
            k != verify_t for k in drops):
        raise AssertionError(f"no prefill or verify MoE call seen: {drops}")

    bf16 = window_agreement(model, serving)
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    model32 = seeded_model(GPT, cfg)
    f32 = window_agreement(model32, serving, 1e-4)
    del model32
    moe, dense = runs[MOE_NAME], runs["openwebtext"]
    rec = {
        "phase": "serve_moe", "config": MOE_NAME, "dtype": "bfloat16",
        **SERVE, "requests": N_REQUESTS, "max_new_tokens": MAX_NEW,
        "model": {k: getattr(cfg, k) for k in (
            "n_layer", "n_embd", "moe_experts", "moe_top_k",
            "moe_capacity")},
        "moe": moe, "moe_again": again, "streams_repeat": True,
        "dense_same_process": dense,
        "moe_over_dense_tokens_per_s": moe["tokens_per_s"]
        / dense["tokens_per_s"],
        "spec_on": spec, "graphs": graphs, "prefill_graphs": prefill_graphs,
        "dropped_by_call_shape": drops,
        "mlp_layer_ms": layer,
        "window_check_bf16": bf16, "window_check_f32": f32,
        "gpu": gpu,
    }
    emit(rec)
    return rec


SAMPLE_B = 8  # rows of the fixed-batch sampler
# the sample phase's counted runs: (prompt length, new tokens, sliding)
SAMPLE_RUNS = {
    "aligned": (256, 64, "exact"),  # flash prefill, no slide
    "slide_exact": (960, 96, "exact"),  # total 1056: 32 re-forwards
    "slide_kv": (960, 96, "kv"),  # the ring slides instead
    "unaligned": (250, 64, "exact"),  # flash prefill padded to its tile
}
SAMPLE_INT8 = (256, 16)  # prompt, new tokens under quantize_model
SAMPLE_STREAM = (250, 32)  # the f32 stream checks
SAMPLE_CLI = dict(num_samples=4, prompt=250, new=48)


def sample_prompt(vocab: int, p: int) -> np.ndarray:
    return np.random.default_rng(SEED + p).integers(
        0, vocab, (SAMPLE_B, p)).astype(np.int32)


def counted(kernels, fn):
    """``(fn(), wall s, {kernel: launches})`` with every counter set to 0
    just before and read just after."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, {n: k.launches for n, k in kernels.items()}


def expect_launches(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: launches {got} != {want}")


def aten_ops(fn) -> int:
    """The aten operations one call of ``fn`` dispatches (views included):
    what the host pays for, op by op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def naive_view(model):
    """The same model (shared weights) with ``attn_impl="naive"``: its
    prefill runs the plain attention whatever the length."""
    import dataclasses

    view = copy.copy(model)
    view.config = dataclasses.replace(model.config, attn_impl="naive")
    return view


def refused(outs, what: str) -> float:
    """The bf16 rule of :func:`hold_logits` must refuse ``outs[0]``;
    returns how far over its limit it lands."""
    try:
        hold_logits(outs, None, what)
    except AssertionError:
        err = (outs[0] - outs[1]).abs().max().item()
        return err / (2.0 * (outs[1] - outs[2]).abs().max().item())
    raise AssertionError(f"{what}: the faulted logits passed the check")


def sample_logit_checks(G, model, model32, cfg):
    """The prefill through flash against the naive prefill, at an aligned
    P and at one the flash tile does not divide (padded), and one
    ``decode_step_recent`` against ``decode_step`` and the full forward's
    last row: bf16 by the triangle rule (``hold_logits`` without
    ``tol_frac``, the f32 model as the third run), f32 within 1e-4 of the
    largest value; a ring whose K is shifted by one slot must be refused
    by the same bf16 rule."""
    toks = torch.from_numpy(sample_prompt(cfg.vocab_size, 257)).to(DEVICE)
    prompt, nxt, p = toks[:, :-1], toks[:, -1], 256
    w = p + 64  # a ring of 64-token chunks past the prompt

    def pre(m, dtype, n=p):
        return G.prefill(m, prompt[:, :n], G.KVCache.init(
            m.config, SAMPLE_B, w, dtype=dtype, device=DEVICE))

    def f(x):
        return x.float()

    out = {}
    (kl, kc), (nl, nc), (fl_, fc) = (pre(model, torch.bfloat16),
                                    pre(naive_view(model), torch.bfloat16),
                                    pre(naive_view(model32), torch.float32))
    out["prefill_bf16"] = {
        "logits": hold_logits([f(kl), f(nl), fl_], None, "prefill"),
        "cache_k": hold_logits([f(kc.k), f(nc.k), fc.k], None, "prefill k"),
        "cache_v": hold_logits([f(kc.v), f(nc.v), fc.v], None, "prefill v")}
    (kl32, kc32), (nl32, nc32) = (pre(model32, torch.float32), (fl_, fc))
    out["prefill_f32"] = {
        "logits": hold_logits([kl32, nl32], 1e-4, "prefill f32"),
        "cache_k": hold_logits([kc32.k, nc32.k], 1e-4, "prefill k f32"),
        "cache_v": hold_logits([kc32.v, nc32.v], 1e-4, "prefill v f32")}
    n = SAMPLE_RUNS["unaligned"][0]
    (ul, uc), (vl, vc), (ul32, uc32), (vl32, vc32) = (
        pre(model, torch.bfloat16, n), pre(naive_view(model), torch.bfloat16,
                                           n),
        pre(model32, torch.float32, n), pre(naive_view(model32),
                                            torch.float32, n))
    out["prefill_unaligned_bf16"] = {
        "prompt": n,
        "logits": hold_logits([f(ul), f(vl), vl32], None, "prefill 250"),
        "cache_k": hold_logits([f(uc.k), f(vc.k), vc32.k], None,
                               "prefill 250 k"),
        "cache_v": hold_logits([f(uc.v), f(vc.v), vc32.v], None,
                               "prefill 250 v")}
    out["prefill_unaligned_f32"] = {
        "logits": hold_logits([ul32, vl32], 1e-4, "prefill 250 f32"),
        "cache_k": hold_logits([uc32.k, vc32.k], 1e-4, "prefill 250 k f32"),
        "cache_v": hold_logits([uc32.v, vc32.v], 1e-4, "prefill 250 v f32")}
    del uc, vc, uc32, vc32

    def step(m, cache, recent: bool):
        cache = G.KVCache(cache.k.clone(), cache.v.clone())
        if not recent:
            return G.decode_step(m, nxt, p, cache, rope_len=w)[0].float()
        rk = torch.zeros((cfg.n_layer, SAMPLE_B, cfg.kv_heads, 64,
                          cfg.head_dim), dtype=cache.k.dtype, device=DEVICE)
        return G.decode_step_recent(m, nxt, p, cache, rk, rk.clone(), 0, p,
                                    w, w)[0].float()

    def full(m):
        return m.project(m.hidden(toks, attn_impl=G.full_forward_impl(
            cfg))[:, -1]).float()

    rec, ring = step(model, kc, True), step(model, kc, False)
    ring32 = step(model32, kc32, False)
    out["decode_bf16"] = {
        "vs_decode_step": hold_logits([rec, ring, ring32], None,
                                      "decode_step_recent vs decode_step"),
        "vs_full_forward": hold_logits([rec, full(model), full(model32)],
                                       None, "decode_step_recent vs full")}
    rec32 = step(model32, kc32, True)
    out["decode_f32"] = {
        "vs_decode_step": hold_logits([rec32, ring32], 1e-4,
                                      "decode_step_recent vs decode_step"),
        "vs_full_forward": hold_logits([rec32, full(model32)], 1e-4,
                                       "decode_step_recent vs full f32")}
    shifted = G.KVCache(kc.k.roll(1, dims=-1), kc.v)
    out["shifted_k_refused_x_over_limit"] = refused(
        [step(model, shifted, True), ring, ring32], "shifted ring K")
    return out


def run_cli(run: str, start: str, *extra) -> tp.List[tp.List[int]]:
    """``python -m midgpt_tpu_torch.sample`` on the checkpoint in ``run``
    as a process of its own: exit 0, ``num_samples`` samples of the
    prompt and ``new`` tokens each; returns the generated ids."""
    env = dict(os.environ, TIKTOKEN_CACHE_DIR=os.path.join(run, "no_bpe"))
    cmd = [sys.executable, "-m", "midgpt_tpu_torch.sample", "--ckpt_dir",
           run, "--start", start, "--num_samples",
           str(SAMPLE_CLI["num_samples"]), "--max_new_tokens",
           str(SAMPLE_CLI["new"]), "--temperature", "0", *extra]
    if DEVICE != "cuda":
        cmd += ["--device", DEVICE]
    res = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                         env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"sample CLI {extra} exit {res.returncode}: "
                             f"{res.stderr[-2000:]}")
    lines = res.stdout.splitlines()
    rows = [lines[i + 1].split() for i, ln in enumerate(lines[:-1])
            if ln == "-" * 40]
    want = len(start.split())
    if (len(rows) != SAMPLE_CLI["num_samples"] or any(
            len(r) != want + SAMPLE_CLI["new"] or r[:want] != start.split()
            for r in rows)):
        raise AssertionError(f"sample CLI {extra}: {res.stdout[-2000:]}")
    return [[int(x) for x in r[want:]] for r in rows]


def sample_cli(model32, cfg, prompt) -> tp.Dict[str, tp.Any]:
    """The CLI on a port checkpoint of ``model32``'s weights (f32 masters
    and zero Adam moments, as ``train`` saves) in a temporary directory:
    fixed-batch, ``--serve`` and ``--quant int8``, three processes run
    together, each timed."""
    from midgpt_tpu_torch.checkpoint import Checkpointer
    from midgpt_tpu_torch.config import ExperimentConfig, to_dict

    run = tempfile.mkdtemp(prefix="sample_cli_")
    try:
        with open(os.path.join(run, "config.json"), "w") as fh:
            json.dump(to_dict(ExperimentConfig(model=cfg, rundir=run)), fh)
        params = {k: v.detach().cpu() for k, v in
                  model32.state_dict().items()}
        zeros = {k: torch.zeros_like(v) for k, v in params.items()}
        Checkpointer(run, async_save=False).save(
            0, {"params": params, "mu": zeros, "nu": zeros, "step": 0},
            {"step": 0}, force=True)
        del params, zeros
        start = " ".join(str(int(x)) for x in prompt) + " "

        def one(extra):
            t0 = time.perf_counter()
            return {"tokens": run_cli(run, start, *extra),
                    "process_s": time.perf_counter() - t0}

        # the three processes at once (each its own start-up, model and
        # kernels on the card), each timed from its start to its exit
        runs = (("fixed", ()), ("serve", ("--serve",)),
                ("int8", ("--quant", "int8")))
        with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
            futures = {name: pool.submit(one, extra) for name, extra in runs}
            return {name: f.result() for name, f in futures.items()}
    finally:
        shutil.rmtree(run, ignore_errors=True)


@torch.no_grad()
def sampler_replay_timing(progs, prompt) -> tp.Dict[str, tp.Any]:
    """A warm ``generate`` of ``progs``' shape: the aten ops between its
    copy in and its read (0), its host ms (copy in, replays, read) beside
    its device ms, and one full chunk's replays (its ``r_len`` step
    replays and its merge): host ms (the replays' launches) and device
    ms, each over the chunk's steps."""
    progs.load(prompt, 0)
    torch.cuda.synchronize()
    ops = aten_ops(progs.run)
    if ops:
        raise AssertionError(f"sampler: {ops} aten ops between the copy in "
                             f"and the read")
    host, device = [], []
    for _ in range(5):
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        progs(prompt, 0)
        b.record()
        b.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
        device.append(a.elapsed_time(b))
    steps = progs.r_len
    merge, body = progs.merges[steps], progs.merge_body(steps)
    chunk_host, chunk_device = [], []
    for _ in range(GRAPH_TIMING_REPS):
        progs.load(prompt, 0)  # the base back at P: every write in range
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(steps):
            progs.step.run(progs.step_body)
        merge.run(body)
        chunk_host.append(1e3 * (time.perf_counter() - t0))
        b.record()
        b.synchronize()
        chunk_device.append(a.elapsed_time(b))
    return {"aten_ops_between_copy_and_read": ops,
            "call_host_ms": statistics.median(host),
            "call_device_ms": statistics.median(device),
            "chunk_steps": steps,
            "step_host_ms": statistics.median(chunk_host) / steps,
            "step_device_ms": statistics.median(chunk_device) / steps}


def phase_sample(fl, fa, im, serving, GPT, cfg, gpu):
    """The fixed-batch sampler (``sampling.generate``) at the full width of
    ``openwebtext`` (124M, random init from SEED, bf16, 8 rows). Launches
    read around each run alone: an aligned prefill (P=256) runs the flash
    forward n_layer times and no fused forward; P=960 with 96 new tokens
    (past block_size) in exact sliding adds n_layer fused forwards per
    re-forward, in kv sliding none; P=250 runs the flash forward n_layer
    times too (padded to its tile); under ``quantize_model`` the int8 product runs
    4 n_layer + 1 times a forward. Logit holds (``sample_logit_checks``),
    f32 streams (greedy at P=250 equal to ``generate_served``'s, sampled
    streams equal at chunk_len 1 and 64), the sampler against
    ``generate_served`` on the same prompts in turns, one decode step's
    device and host ms, one re-forward's ms, and the CLI
    (``sample_cli``)."""
    from midgpt_tpu_torch.models import gpt as G
    from midgpt_tpu_torch.quant import quantize_model
    from midgpt_tpu_torch.sampling import generate

    def twin(name, toks, got, fn):
        """The run again with every program's body eager: the same tokens
        bit for bit and the same launches; the run's programs' record."""
        progs = list(sampling._SAMPLERS.values())[-1]
        with eager_programs():
            eager, _, eager_got = counted(kernels, fn)
        if not torch.equal(eager, toks) or eager_got != got:
            raise AssertionError(f"{name}: graphed tokens or launches "
                                 f"{got} differ from the eager bodies' "
                                 f"{eager_got}")
        return {"tokens_equal_eager_bodies": True,
                "programs": {"/".join(map(str, p.key[len(progs.key):])):
                             {"capture_ms": p.capture_ms,
                              "replay_launches": {f.__name__: n for f, n in
                                                  p.replay_launches.items()}}
                             for p in progs.programs()},
                "plan": progs.plan, "reforwards": progs.n_reforward,
                "graph_pool_bytes": pool_bytes(progs.prefill.pool)}

    from midgpt_tpu_torch import sampling
    from midgpt_tpu_torch.serving.programs import pool_bytes

    kernels = {"flash_fwd": fl.flash_fwd,
               "fused_attention_fwd": fa.fused_attention_fwd,
               "int8_matmul": im.int8_matmul}
    L, V = cfg.n_layer, cfg.vocab_size
    model = seeded_model(GPT, cfg, torch.bfloat16)
    generate(model, sample_prompt(V, 256), 4, temperature=0.0,
             device=DEVICE)  # warm-up, not counted
    runs = {}
    for name, (p, n, sliding) in SAMPLE_RUNS.items():
        run = lambda: generate(  # noqa: E731
            model, sample_prompt(V, p), n, temperature=0.0, sliding=sliding,
            device=DEVICE)
        toks, wall, got = counted(kernels, run)
        graphs = twin(name, toks, got, run)
        slides = max(0, p + n - cfg.block_size) if sliding == "exact" else 0
        want = {"flash_fwd": L,
                "fused_attention_fwd": L * slides, "int8_matmul": 0}
        expect_launches(name, got, want)
        if toks.shape != (SAMPLE_B, n) or not (
                (toks >= 0) & (toks < V)).all():
            raise AssertionError(f"{name}: tokens {tuple(toks.shape)}")
        runs[name] = {"prompt": p, "new_tokens": n, "sliding": sliding,
                      "re_forwards": slides, "launches": got, "wall_s": wall,
                      "tokens_per_s": SAMPLE_B * n / wall, "graphs": graphs}
        if name == "aligned":
            runs[name]["replays"] = sampler_replay_timing(
                list(sampling._SAMPLERS.values())[-1], sample_prompt(V, p))
    qm = quantize_model(model)
    p, n = SAMPLE_INT8
    run = lambda: generate(  # noqa: E731
        qm, sample_prompt(V, p), n, temperature=0.0, device=DEVICE)
    toks, wall, got = counted(kernels, run)
    per_forward = 4 * L + 1
    expect_launches("int8", got, {"flash_fwd": L, "fused_attention_fwd": 0,
                                  "int8_matmul": per_forward * (1 + n)})
    runs["int8"] = {"prompt": p, "new_tokens": n, "launches": got,
                    "int8_per_forward": per_forward, "wall_s": wall,
                    "tokens_per_s": SAMPLE_B * n / wall,
                    "graphs": twin("int8", toks, got, run)}
    del qm

    # speed: the sampler and the engine on the same prompts, in turns,
    # after a call that captures the sampler's programs again where the
    # cache let them go
    ps = sample_prompt(V, 256)
    n = SAMPLE_RUNS["aligned"][1]
    generate(model, ps, n, temperature=0.0, device=DEVICE)
    turns = []
    for kind in ("sampler", "served", "served", "sampler"):
        _, wall, _ = counted(kernels, (lambda: generate(
            model, ps, n, temperature=0.0, device=DEVICE)) if kind ==
            "sampler" else (lambda: serving.generate_served(
                model, list(ps), n, device=DEVICE, **SERVE)))
        turns.append({"kind": kind, "wall_s": wall,
                      "tokens_per_s": SAMPLE_B * n / wall,
                      "ms_per_token_step": 1e3 * wall / n})
    # one decode step (B=8, position 256 of a 320-slot ring) and one
    # exact-window re-forward (8 x 1024)
    cache = G.prefill(model, torch.from_numpy(ps).to(DEVICE), G.KVCache.init(
        cfg, SAMPLE_B, 320, device=DEVICE))[1]
    rk = torch.zeros((L, SAMPLE_B, cfg.kv_heads, 64, cfg.head_dim),
                     dtype=torch.bfloat16, device=DEVICE)
    rv = torch.zeros_like(rk)
    tok = torch.zeros(SAMPLE_B, dtype=torch.int32, device=DEVICE)

    def one_step(i):
        G.decode_step_recent(model, tok, 256, cache, rk, rv, 0, 256, 320, 320)

    window = torch.from_numpy(sample_prompt(V, cfg.block_size)).to(DEVICE)

    def reforward(i):
        model.project(model.hidden(window, attn_impl=G.full_forward_impl(
            cfg))[:, -1])

    timing = {"decode_step_device_ms": device_ms(one_step, 10),
              "decode_step_host_ms": eager_ms(one_step, 20),
              "decode_step_aten_ops": aten_ops(lambda: one_step(0)),
              "reforward_ms": eager_ms(reforward, 5),
              "reforward_aten_ops": aten_ops(lambda: reforward(0))}
    timing["tokens_per_s_past_window"] = (
        SAMPLE_B / (timing["reforward_ms"] / 1e3))
    timing["tokens_per_s_decode_step"] = (
        SAMPLE_B / (timing["decode_step_host_ms"] / 1e3))
    del cache, rk, rv

    model32 = seeded_model(GPT, cfg)
    checks = sample_logit_checks(G, model, model32, cfg)
    p, n = SAMPLE_STREAM
    ps = sample_prompt(V, p)
    ring = generate(model32, ps, n, temperature=0.0,
                    cache_dtype=torch.float32, device=DEVICE).cpu().numpy()
    served = serving.generate_served(model32, list(ps), n, device=DEVICE,
                                     **SERVE)
    equal_rows = sum(np.array_equal(a, b) for a, b in zip(ring, served))
    if equal_rows != SAMPLE_B:
        raise AssertionError(f"f32 greedy streams: {equal_rows} of "
                             f"{SAMPLE_B} equal generate_served's")
    sampled = [generate(model32, ps, n, seed=SAMPLED["seed"],
                        temperature=SAMPLED["temperature"],
                        top_k=SAMPLED["top_k"], cache_dtype=torch.float32,
                        chunk_len=c, device=DEVICE).cpu().numpy()
               for c in (1, 64)]
    if not np.array_equal(*sampled) or np.array_equal(sampled[0], ring):
        raise AssertionError("f32 sampled streams differ across chunk_len "
                             "or equal the greedy ones")
    cli_prompt = sample_prompt(V, SAMPLE_CLI["prompt"])[0]
    cli = sample_cli(model32, cfg, cli_prompt)
    del model32
    gc.collect()
    torch.cuda.empty_cache()
    direct = generate(model, np.tile(cli_prompt, (SAMPLE_CLI["num_samples"],
                                                  1)), SAMPLE_CLI["new"],
                      temperature=0.0, device=DEVICE).cpu().tolist()
    cli_rec = {k: {"process_s": v["process_s"]} for k, v in cli.items()}
    cli_rec["fixed"]["equals_in_process"] = cli["fixed"]["tokens"] == direct
    totals = {k: sum(r["launches"][k] for r in runs.values())
              for k in kernels}
    rec = {"phase": "sample", "config": "openwebtext", "dtype": "bfloat16",
           "batch": SAMPLE_B, "runs": runs, "launches": totals,
           "turns": turns,
           "timing": timing, "checks": checks,
           "f32_streams": {"prompt": p, "new_tokens": n,
                           "greedy_rows_equal_served": equal_rows,
                           "sampled_chunk1_equals_chunk64": True},
           "cli": cli_rec, "gpu": gpu}
    emit(rec)
    return rec


def fused_inputs(b, t, h, hkv, c, dtype, seed=0):
    """Packed qkv, LN weights, [T, C] rope tables and an output gradient,
    drawn on the CPU from ``seed`` and moved to the card."""
    from midgpt_tpu_torch.models.layers import rope_tables
    from midgpt_tpu_torch.ops.fused_attn import rope_full_tables

    gen = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, t, (h + 2 * hkv) * c, generator=gen)
    wq = 1.0 + 0.1 * torch.randn(c, generator=gen)
    wk = 1.0 + 0.1 * torch.randn(c, generator=gen)
    dout = torch.randn(b, t, h * c, generator=gen)
    sin, cos = rope_full_tables(*(torch.from_numpy(a)
                                  for a in rope_tables(c, t)))
    return [qkv.to(DEVICE, dtype), wq.to(DEVICE), wk.to(DEVICE),
            sin.to(DEVICE), cos.to(DEVICE), dout.to(DEVICE, dtype)]


def fused_run(fa, args, h, hkv, kernel):
    """``(out, lse, dqkv, dwq, dwk)`` through the kernels or the plain
    versions, on the same inputs."""
    qkv, wq, wk, sin, cos, dout = args
    if kernel:
        out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        grads = fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout,
                                       h, hkv)
    else:
        out, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos,
                                                        h, hkv)
        grads = fa.fused_attention_backward_reference(
            qkv, wq, wk, sin, cos, out, lse, dout, h, hkv)
    return (out, lse, *grads)


def fused_readings(got, plain, ref32, names=FUSED_OUTS):
    """Per output, its distance from the plain version over the limit (the
    check passes when every reading is at most 1).

    f32 (``ref32 is None``): each element within ``1e-5 + rel * |plain|``,
    rel 1e-5 for the forward's out and lse and 1e-4 for the backward's
    outputs: the forward's two f32 sums only run in another order, while
    the backward chains three sums over T and the LN backward's mean
    subtraction, whose cancellation magnifies rounding differences.

    bf16: the kernels round inside (q, k, P and ds are cast), so each
    output is held by the triangle rule: its largest distance from the
    plain version run in f32 on the upcast inputs (``ref32``) may be at
    most twice the plain bf16 version's own largest distance from it."""
    out = {}
    for name, g, p, r in zip(names, got, plain,
                             ref32 if ref32 is not None else plain):
        if ref32 is None:
            rel = 1e-5 if name in ("out", "lse") else 1e-4
            out[name] = ((g - p).abs() / (1e-5 + rel * p.abs())).max().item()
        else:
            own = (p.float() - r).abs().max().item()
            out[name] = (g.float() - r).abs().max().item() / (2 * own)
    return out


def phase_train_kernel(fa) -> float:
    """Each case is held by :func:`fused_readings`, and the same rule must
    refuse every output of the kernels run with the RoPE tables shifted
    by one position (row t holds position t - 1's angles). Returns the
    largest bf16-kernel-to-bf16-plain distance seen."""
    worst = 0.0
    for name, b, t, h, hkv, c in FUSED_GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = fused_inputs(b, t, h, hkv, c, dtype)
            got = fused_run(fa, args, h, hkv, kernel=True)
            torch.cuda.synchronize()
            plain = fused_run(fa, args, h, hkv, kernel=False)
            ref32 = None
            if dtype == torch.bfloat16:
                ref32 = fused_run(fa, [a.float() for a in args], h, hkv,
                                  kernel=False)
            sound = fused_readings(got, plain, ref32)
            shifted = list(args)
            shifted[3], shifted[4] = (torch.roll(a, 1, 0) for a in args[3:5])
            fault = fused_run(fa, shifted, h, hkv, kernel=True)
            faulted = fused_readings(fault, plain, ref32)
            errs = {n: (g.float() - p.float()).abs().max().item()
                    for n, g, p in zip(FUSED_OUTS, got, plain)}
            emit({"phase": "train_kernel", "geometry": name, "B": b, "T": t,
                  "H": h, "Hkv": hkv, "C": c,
                  "dtype": str(dtype).split(".")[-1],
                  "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                           "(out, lse) / 1e-4 (grads)" if ref32 is None else
                           "max |kernel - plain f32| <= 2 x max |plain bf16 "
                           "- plain f32|"),
                  "sound_err_over_limit": sound,
                  "shifted_rope_err_over_limit": faulted,
                  "max_abs_err_vs_plain_same_dtype": errs})
            bad = [n for n, v in sound.items() if not v <= 1.0]
            if bad:
                raise AssertionError(f"fused kernels disagree with their "
                                     f"plain versions: {name} {dtype} {bad}")
            missed = [n for n, v in faulted.items() if not v > 1.0]
            if missed:
                raise AssertionError(f"the check passes shifted RoPE tables: "
                                     f"{name} {dtype} {missed}")
            if dtype == torch.bfloat16:
                worst = max(worst, *errs.values())
    return worst


def zipf_tokens(n: int, seed: int) -> np.ndarray:
    """``n`` token ids below ZIPF_IDS, P(id k) proportional to
    (k + 1)^-ZIPF_EXP: a stream whose loss has something to learn."""
    p = np.arange(1, ZIPF_IDS + 1, dtype=np.float64) ** -ZIPF_EXP
    rng = np.random.default_rng(seed)
    return rng.choice(ZIPF_IDS, size=n, p=p / p.sum()).astype(np.uint16)


def expected_launches(cfg) -> tp.Tuple[int, int]:
    """Fused forward and backward launches of ``train(cfg)`` from step 0:
    one of each per layer and training microbatch; one forward per layer
    and eval microbatch (two splits at every eval interval, the
    validation split once more at the end; every microbatch of
    ``eval_batches`` batches). remat "none": no recomputed forwards."""
    g = cfg.g_accum_iters
    train_mb = cfg.max_steps * g
    evals = len(range(0, cfg.max_steps, cfg.eval_interval))
    eval_mb = (2 * evals + 1) * cfg.eval_batches * g
    nl = cfg.model.n_layer
    return nl * (train_mb + eval_mb), nl * train_mb


def held_bytes() -> int:
    """Bytes this process holds on the card before a measured run (what
    earlier phases left allocated), after a collection."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def train_measured(cfg):
    """``train(cfg)``: ``(final, wall_s, peak_bytes, held)``, the peak
    being ``torch.cuda.max_memory_allocated`` over the run less ``held``,
    the bytes the process held before it (the run's own peak)."""
    from midgpt_tpu_torch.train import train

    held = held_bytes()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    final = train(cfg)
    torch.cuda.synchronize()
    return (final, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - held, held)


C4_BAND = (0.8, 1.25)  # the port's estimate over the measured peak


def memory_fields(cfg, remat: str, peak_bytes: int,
                  held: int) -> tp.Dict[str, tp.Any]:
    """The measured peak (above what the process held before the run)
    beside the port's estimate (``card_peak_bytes``, with its terms) and
    the JAX package's (``estimate_hbm_fill`` times the card's memory) for
    ``cfg`` at ``remat``."""
    import dataclasses

    from midgpt_tpu_torch.train import card_peak_bytes, estimate_hbm_fill

    hbm = torch.cuda.get_device_properties(0).total_memory
    at = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=remat))
    est = card_peak_bytes(at)
    ratio = est["peak"] / peak_bytes if peak_bytes else None
    return {"peak_bytes": peak_bytes, "port_estimate_bytes": est["peak"],
            "port_estimate_terms": est,
            "port_estimate_before_headroom_over_peak": (
                (est["peak"] - est["headroom"]) / peak_bytes
                if peak_bytes else None),
            "jax_estimate_bytes": estimate_hbm_fill(at, hbm) * hbm,
            "port_estimate_over_peak": ratio, "c4_band": list(C4_BAND),
            "held_before_bytes": held,
            "in_c4_band": (ratio is not None
                           and C4_BAND[0] <= ratio <= C4_BAND[1]),
            "card_memory_bytes": hbm}


def phase_train(fa, gpu):
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        rundir = os.path.join(tmp, "run")
        cfg = get_config("openwebtext", rundir=rundir, data_dir=data,
                         seed=SEED, **TRAIN_SET)
        fa.fused_attention_fwd.launches = 0
        fa.fused_attention_bwd.launches = 0
        final, wall, peak_bytes, held = train_measured(cfg)
        launches = (fa.fused_attention_fwd.launches,
                    fa.fused_attention_bwd.launches)
        rows = read_metrics(rundir)
        ckpts = sorted(os.listdir(os.path.join(rundir, "checkpoints")))
    losses = final["losses"]
    want = expected_launches(cfg)
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    tps_median = statistics.median(tps)
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = (final["loop_s"] - final["eval_s"] - final["ckpt_s"]
               - final["ckpt_wait_s"])
    rec = {
        "phase": "train", "config": "openwebtext", "overrides": TRAIN_SET,
        "model": {k: getattr(cfg.model, k) for k in (
            "block_size", "vocab_size", "n_layer", "n_head", "n_embd",
            "attn_impl")},
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "loss_chunk": cfg.loss_chunk, "remat": final["remat"],
        "data": {"tokens_per_split": DATA_TOKENS, "zipf_ids": ZIPF_IDS,
                 "zipf_exponent": ZIPF_EXP, "seed": SEED},
        "losses": losses, "val_loss": final["val_loss"],
        "fused_fwd_launches": launches[0], "fused_bwd_launches": launches[1],
        "launch_formula": "fwd = n_layer x (train microbatches + eval "
                          "microbatches), bwd = n_layer x train microbatches",
        "expected_launches": list(want), "checkpoints": ckpts,
        "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "ckpt_wait_s": final["ckpt_wait_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "step_ms": 1e3 * final["loop_s"] / cfg.max_steps,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / tps_median,
        "tokens_per_s_per_step": tps,
        "timing_note": "tokens_per_s, mfu, step_ms: every trained token "
                       "over train()'s loop on the host clock, evals and "
                       "saves included; *_steps_only: the loop less the "
                       "evals, the save enqueues (ckpt_s) and the waits "
                       "for a write (ckpt_wait_s); step_ms_median: "
                       "per-step host clock between loss reads "
                       "(log_interval=1)",
        "flops_per_token": fpt, "peak_flops": peak,
        **memory_fields(cfg, final["remat"], peak_bytes, held),
        "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-5:]) <= losses[0] - 1.0:
        raise AssertionError(f"the loss did not fall by 1 nat: {losses}")
    if final["remat"] != "none":
        raise AssertionError(f"remat resolved to {final['remat']}")
    if launches != want or min(launches) == 0:
        raise AssertionError(f"fused launches {launches} != {want}")
    if ckpts != [f"step_{cfg.max_steps - 1:08d}.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    return rec


def microbatch_grads(fa, cfg, remat: str, x, y, chunk):
    """One microbatch's loss and gradients through the kernels at
    ``remat``, from a bf16 copy of ``cfg``'s seeded init, with the peak
    bytes of that forward and backward alone and the launches it made;
    then the same forward and backward again, timed on the host clock to
    the return of ``backward()`` (the enqueue) and to a synced card."""
    import dataclasses

    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import loss_fn, make_shadow

    held = held_bytes()
    model = make_shadow(seeded_model(
        GPT, dataclasses.replace(cfg.model, remat=remat)), torch.bfloat16)
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    before = (fa.fused_attention_fwd.launches,
              fa.fused_attention_bwd.launches)
    loss = loss_fn(model, x, y, chunk)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    launches = (fa.fused_attention_fwd.launches - before[0],
                fa.fused_attention_bwd.launches - before[1])
    grads = [p.grad.float() for p in model.parameters()]
    model.zero_grad(set_to_none=True)
    t0 = time.perf_counter()
    loss_fn(model, x, y, chunk).backward()
    enqueued = time.perf_counter()
    torch.cuda.synchronize()
    times = {"enqueue_ms": 1e3 * (enqueued - t0),
             "wall_ms": 1e3 * (time.perf_counter() - t0)}
    return loss.item(), grads, peak, launches, times


def phase_remat_dots(fa, gpu, train_rec, parity_rec):
    """The train phase's configuration at remat "dots", then "full", each
    through ``train()`` beside the train phase's "none" run: fused
    forward launches = n_layer x (2 x train microbatches + eval
    microbatches) (a checkpointed block runs its forward again in the
    backward), backward launches = n_layer x train microbatches; the
    first step's loss within the parity phase's bf16 loss limit of
    "none"'s; step medians, peak bytes and the estimates. Then one
    microbatch (B=8) of the same model through the kernels at each remat:
    loss and gradient norm held to "none"'s by the parity phase's bf16
    limits, and the microbatch's peak bytes in the order full < dots <
    none."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.train import effective_loss_chunk, global_norm
    from midgpt_tpu_torch.utils.metrics import read_metrics

    limit_loss = 2 * parity_rec["bf16"]["loss_naive_to_f32"]
    limit_norm = 2 * parity_rec["bf16"]["grad_norm_naive_to_f32"]
    runs = {"none": {k: train_rec[k] for k in (
        "fused_fwd_launches", "fused_bwd_launches", "step_ms_median",
        "peak_bytes", "port_estimate_bytes", "jax_estimate_bytes",
        "port_estimate_over_peak", "in_c4_band", "ckpt_s",
        "ckpt_wait_s")}}
    runs["none"]["first_loss"] = train_rec["losses"][0]
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        for remat in ("dots", "full"):
            rundir = os.path.join(tmp, remat)
            cfg = get_config("openwebtext", rundir=rundir, data_dir=data,
                             seed=SEED, **TRAIN_SET)
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, remat=remat))
            fa.fused_attention_fwd.launches = 0
            fa.fused_attention_bwd.launches = 0
            final, wall, peak_bytes, held = train_measured(cfg)
            tps = [r["tokens_per_sec"] for r in read_metrics(rundir)
                   if "tokens_per_sec" in r]
            runs[remat] = {
                "fused_fwd_launches": fa.fused_attention_fwd.launches,
                "fused_bwd_launches": fa.fused_attention_bwd.launches,
                "losses": final["losses"], "first_loss": final["losses"][0],
                "step_ms_median": 1e3 * cfg.batch_size
                * cfg.model.block_size / statistics.median(tps),
                "wall_s": wall, "ckpt_s": final["ckpt_s"],
                "ckpt_wait_s": final["ckpt_wait_s"],
                **memory_fields(cfg, remat, peak_bytes, held)}
    g, nl = cfg.g_accum_iters, cfg.model.n_layer
    train_mb = cfg.max_steps * g
    evals = len(range(0, cfg.max_steps, cfg.eval_interval))
    eval_mb = (2 * evals + 1) * cfg.eval_batches * g
    want = (nl * (2 * train_mb + eval_mb), nl * train_mb)
    # one microbatch through the kernels at each remat
    chunk = effective_loss_chunk(cfg)
    b, t = 8, cfg.model.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 2).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    mb = {}
    ref = None
    for remat in ("none", "dots", "full"):
        loss, grads, peak, launches, times = microbatch_grads(
            fa, cfg, remat, toks[:, :-1], toks[:, 1:], chunk)
        norm = global_norm(grads).item()
        if ref is None:
            ref = (loss, norm, grads)
        mb[remat] = {
            "loss": loss, "grad_norm": norm, "peak_bytes": peak,
            "fused_launches": list(launches), **times,
            "loss_diff_to_none": abs(loss - ref[0]),
            "grad_norm_diff_to_none": abs(norm - ref[1]),
            "max_abs_grad_diff_to_none": max(
                (a - r).abs().max().item() for a, r in zip(grads, ref[2]))}
        del grads
    del ref
    rec = {"phase": "remat_dots", "config": "openwebtext",
           "overrides": TRAIN_SET, "runs": runs,
           "expected_launches_dots_full": list(want),
           "launch_formula": "fwd = n_layer x (2 x train microbatches + "
                             "eval microbatches), bwd = n_layer x train "
                             "microbatches",
           "microbatch": {"B": b, "T": t, "by_remat": mb},
           "limits": {"loss": limit_loss, "grad_norm": limit_norm,
                      "rule": "the parity phase's bf16 rule: 2 x the "
                              "naive bf16 path's distance from naive f32"},
           "gpu": gpu}
    emit(rec)
    for remat in ("dots", "full"):
        got = (runs[remat]["fused_fwd_launches"],
               runs[remat]["fused_bwd_launches"])
        if got != want:
            raise AssertionError(f"{remat}: fused launches {got} != {want}")
        if abs(runs[remat]["first_loss"] - runs["none"]["first_loss"]) \
                > limit_loss:
            raise AssertionError(f"{remat}: first loss off none's")
        if (mb[remat]["loss_diff_to_none"] > limit_loss
                or mb[remat]["grad_norm_diff_to_none"] > limit_norm):
            raise AssertionError(f"{remat}: microbatch off none's: "
                                 f"{mb[remat]}")
    if not (mb["full"]["peak_bytes"] < mb["dots"]["peak_bytes"]
            < mb["none"]["peak_bytes"]):
        raise AssertionError("microbatch peaks not full < dots < none")
    return rec


# the train_remat phase: openwebtext_moe at its experiment's own microbatch
# (2048 sequences in 16 microbatches: 128 x 1024 tokens), one microbatch a
# step, 3 steps; doubled up to REMAT_MAX_MICRO while remat "none" still fits
REMAT_SET = dict(batch_size=128, g_accum_iters=1, max_steps=3,
                 warmup_steps=1, lr_decay_steps=3, eval_interval=1000,
                 eval_batches=1, ckpt_interval=1000, log_interval=1)
REMAT_MAX_MICRO = 512


def rung_run(state, init, cfg, remat: str, batches,
             held: int) -> tp.Dict[str, tp.Any]:
    """``train_step`` over ``batches`` at ``remat`` from the masters
    ``init`` (zero moments): each step's loss and host ms, and the peak
    bytes of the steps less ``held``, what the process held before the
    state was made; ``{"oom": ...}`` if the card runs out of memory."""
    import dataclasses

    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, make_lr_schedule, make_shadow, train_step)

    mcfg = dataclasses.replace(cfg.model, remat=remat)
    with torch.no_grad():
        state.model.load_state_dict(init)
        for m in state.mu + state.nu:
            m.zero_()
    state.step = 0
    state.model.config = mcfg
    shadow = make_shadow(state.model, torch.bfloat16)
    lr, chunk = make_lr_schedule(cfg), effective_loss_chunk(cfg)
    losses, step_ms, oom = [], [], None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        for i, (x, y) in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = train_step(state, shadow, x, y, cfg, lr(i), chunk,
                                 fold_in(cfg.seed, i))
            losses.append(loss.item())
            step_ms.append(1e3 * (time.perf_counter() - t0))
    except torch.OutOfMemoryError as exc:
        oom = str(exc).splitlines()[0][:200]
    peak = torch.cuda.max_memory_allocated() - held
    for p in shadow.parameters():
        p.grad = None
    del shadow
    gc.collect()
    torch.cuda.empty_cache()
    out = {"remat": remat, "oom": oom, "losses": losses, "step_ms": step_ms,
           "step_ms_after_first": (statistics.median(step_ms[1:])
                                   if len(step_ms) > 1 else None)}
    if oom is None:
        out.update(memory_fields(cfg, remat, peak, held))
    else:
        out["peak_bytes_before_oom"] = peak
        out["port_estimate_bytes"] = memory_fields(cfg, remat, peak, held)[
            "port_estimate_bytes"]
    return out


def phase_train_remat(gpu, parity_rec):
    """The first-step out-of-memory ladder at full width: ``train()`` on
    ``openwebtext_moe`` at its experiment's microbatch (128 x 1024
    tokens, one microbatch a step, 3 steps, one eval batch). First each
    rung (none, dots, full) runs explicitly (``train_step`` from the same
    seeded init on the same batches): peak bytes, step ms and the port's
    estimate, or the OOM; while "none" fits the microbatch doubles, up to
    REMAT_MAX_MICRO. Then ``train()`` with remat "auto", its pick
    replaced by "none" inside this script (``resolve_auto_knobs`` patched
    here, not a knob of the program) so that a real first-step OOM drives
    the ladder: it must end on the first rung that fit, its losses within
    the parity phase's bf16 loss limit of that rung's direct run. The
    port's own pick for the configuration must be a rung that fit."""
    import contextlib
    import dataclasses
    import io

    import midgpt_tpu_torch.train as tr
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import Loader, load_shard, write_tokens

    limit = 2 * parity_rec["bf16"]["loss_naive_to_f32"]
    hbm = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        micro, rungs = REMAT_SET["batch_size"], {}
        while True:
            cfg = get_config(MOE_NAME, rundir=os.path.join(tmp, "run"),
                             data_dir=data, seed=SEED,
                             **dict(REMAT_SET, batch_size=micro))
            loader = Loader(load_shard(os.path.join(data, "train.bin")),
                            cfg.model.block_size, (1, micro), cfg.data_seed)
            held = held_bytes()
            batches = [tuple(torch.from_numpy(a).to(DEVICE).long()
                             for a in loader.peek(i))
                       for i in range(cfg.max_steps)]
            state = tr.init_state(cfg, DEVICE)
            init = {k: v.detach().cpu().clone()
                    for k, v in state.model.state_dict().items()}
            rungs = {}
            for remat in tr.REMAT_LADDER:
                rungs[remat] = rung_run(state, init, cfg, remat, batches,
                                        held)
                print(f"train_remat: micro {micro}, remat={remat}: "
                      + ("OOM" if rungs[remat]["oom"] else
                         f"peak {rungs[remat]['peak_bytes'] / 1e9:.2f} GB"),
                      flush=True)
                if remat == "none" and rungs[remat]["oom"] is None:
                    break
            del state, init, batches
            gc.collect()
            torch.cuda.empty_cache()
            if rungs["none"]["oom"] is not None:
                break
            if 2 * micro > REMAT_MAX_MICRO:
                raise AssertionError(
                    f"remat none fits up to {micro} x 1024 tokens")
            micro *= 2
        fitting = [r for r in tr.REMAT_LADDER if rungs.get(r) is not None
                   and rungs[r]["oom"] is None]
        if not fitting:
            raise AssertionError(f"no rung fits at {micro} x 1024 tokens")
        port_pick = tr.resolve_auto_knobs(
            dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, remat="auto")), hbm, card=True).model.remat
        # the ladder: "auto" forced to start at "none"
        real = tr.resolve_auto_knobs

        def start_at_none(c, hbm_bytes, card=False, mesh=None):
            return dataclasses.replace(c, model=dataclasses.replace(
                c.model, remat="none"))

        auto = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat="auto"))
        out = io.StringIO()
        tr.resolve_auto_knobs = start_at_none
        try:
            with contextlib.redirect_stdout(out):
                final, wall, peak_bytes, held = train_measured(auto)
        finally:
            tr.resolve_auto_knobs = real
    taken = [line for line in out.getvalue().splitlines()
             if line.startswith("first-step OOM")]
    for line in taken:
        print(f"train_remat ladder: {line}", flush=True)
    direct = rungs[final["remat"]]
    diffs = [abs(a - b) for a, b in zip(final["losses"], direct["losses"])]
    rec = {"phase": "train_remat", "config": MOE_NAME,
           "overrides": dict(REMAT_SET, batch_size=micro),
           "microbatch_tokens": micro * cfg.model.block_size,
           "rungs": rungs, "port_pick": port_pick,
           "ladder": {"rungs_taken": taken, "ended_at": final["remat"],
                      "losses": final["losses"], "wall_s": wall,
                      "loop_s": final["loop_s"], "ckpt_s": final["ckpt_s"],
                      "ckpt_wait_s": final["ckpt_wait_s"],
                      # the failed rungs' attempts are part of this run
                      "peak_bytes_with_failed_rungs": peak_bytes},
           "loss_diffs_to_direct": diffs, "loss_limit": limit,
           "gpu": gpu}
    emit(rec)
    if not taken or final["remat"] != fitting[0]:
        raise AssertionError(f"ladder ended at {final['remat']}, took "
                             f"{taken}; first rung that fits {fitting[0]}")
    if len(final["losses"]) != cfg.max_steps or max(diffs) > limit:
        raise AssertionError(f"ladder losses {final['losses']} vs direct "
                             f"{direct['losses']}")
    if port_pick not in fitting:
        raise AssertionError(f"the port picks {port_pick}, which does not "
                             f"fit")
    return rec


def phase_train_profile(gpu, name: str = "openwebtext",
                        overrides: tp.Optional[dict] = None,
                        steps: int = 2, long: bool = False):
    """Where a training step's time goes: a train phase's configuration
    (fresh init, one batch of the Zipf stream folded into the
    vocabulary), one warm-up step, then ``steps`` steps under
    ``torch.profiler`` with the host clock around them. Device time is
    summed by kernel and by group; the idle share is 1 - (summed kernel
    time / wall time). ``long``: the train_long configuration
    (``long_config``: block 2048, the fused norm), whose backward takes
    the split route, grouped apart with the norm kernels."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, init_state, make_lr_schedule, make_shadow,
        resolve_auto_knobs, train_step)

    overrides = TRAIN_SET if overrides is None else overrides
    cfg = (long_config(**overrides) if long
           else get_config(name, seed=SEED, **overrides))
    cfg = resolve_auto_knobs(
        cfg, torch.cuda.get_device_properties(0).total_memory, card=True)
    g, b, t = cfg.g_accum_iters, cfg.microbatch_size, cfg.model.block_size
    toks = zipf_tokens(g * b * (t + 1), SEED + 3).astype(np.int64)
    toks = toks % cfg.model.vocab_size
    toks = torch.from_numpy(toks.reshape(g, b, t + 1)).to(DEVICE)
    x, y = toks[..., :-1], toks[..., 1:]
    state = init_state(cfg, DEVICE)
    shadow = make_shadow(state.model, torch.bfloat16)
    lr, chunk = make_lr_schedule(cfg), effective_loss_chunk(cfg)
    train_step(state, shadow, x, y, cfg, lr(0), chunk, fold_in(SEED, 0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            train_step(state, shadow, x, y, cfg, lr(i + 1), chunk,
                       fold_in(SEED, i + 1))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = {}  # the device's own events only (CPU ops carry theirs too)
    host_ops, host_calls = {}, 0  # the host's aten ops: self time, calls
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total:
            kernels[e.key] = (kernels.get(e.key, 0.0)
                              + e.self_device_time_total / 1e3 / steps)
        elif e.key.startswith("aten::"):
            host_ops[e.key] = e.self_cpu_time_total / 1e3 / steps
            host_calls += e.count
    # the split route's kernels (its pre-pass is the combined route's
    # too) are a group of their own where the backward takes that route
    split = ({"split backward (pre-pass, dq, dk/dv)":
              r"fused_bwd_prep|fused_bwd_tile|fused_dq|fused_dkv",
              "rms norm": r"rms_norm"} if long else {})
    groups = {**split, "fused attention forward": r"fused_fwd",
              "fused attention backward": r"fused_bwd",
              "flash forward": r"flash_fwd",
              "flash backward (dq, dk/dv)": r"flash_dq|flash_dkv",
              "matmul (cuBLAS)": r"nvjet|gemm|xmma|cutlass|cublas",
              "optimizer (foreach)": r"multi_tensor_apply",
              "elementwise and reductions": r"at::native"}
    by_group = {k: 0.0 for k in groups}
    by_group["other"] = 0.0
    for kname, ms in kernels.items():
        hit = next((k for k, pat in groups.items()
                    if re.search(pat, kname, re.IGNORECASE)), "other")
        by_group[hit] += ms
    busy = sum(kernels.values())
    step_ms = wall_ms / steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    rec = {"phase": ("train_long_profile" if long else "train_profile"
                     if name == "openwebtext" else "train_char_profile"),
           "config": name, "overrides": overrides,
           "model_overrides": LONG_MODEL if long else None, "steps": steps,
           "step_ms_host": step_ms, "device_busy_ms_per_step": busy,
           "idle_share": (1 - busy / step_ms) if busy else None,
           "device_ms_per_step_by_group": by_group,
           "top_kernels_ms_per_step": [[n[:120], ms] for n, ms in top],
           "host_aten_calls_per_step": host_calls / steps,
           "host_aten_self_ms_per_step": sum(host_ops.values()),
           "top_host_ops_self_ms_per_step": sorted(
               host_ops.items(), key=lambda kv: -kv[1])[:10],
           "note": "step under the profiler; device times from its trace, "
                   "host times (aten ops' self CPU time, nested calls "
                   "counted apart) from the same trace",
           "gpu": gpu}
    emit(rec)
    del state, shadow
    return rec


def phase_parity(fa, gpu):
    """One microbatch (B=8) of the full-width model through the fused
    kernels and through the naive path: loss and global gradient norm."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, global_norm, loss_fn, make_shadow)

    exp = get_config("openwebtext")
    cfg, chunk = exp.model, effective_loss_chunk(exp)
    b, t = 8, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 2).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = seeded_model(GPT, cfg)

    def run(m, impl):
        m.zero_grad(set_to_none=True)
        before = fa.fused_attention_bwd.launches
        loss = loss_fn(m, x, y, chunk, attn_impl=impl)
        loss.backward()
        norm = global_norm([p.grad.float() for p in m.parameters()]).item()
        used = fa.fused_attention_bwd.launches - before
        if used != (cfg.n_layer if impl == "fused" else 0):
            raise AssertionError(f"{impl}: {used} fused backward launches")
        return loss.item(), norm

    f32 = {impl: run(model, impl) for impl in ("fused", "naive")}
    model16 = make_shadow(model, torch.bfloat16)
    bf16 = {impl: run(model16, impl) for impl in ("fused", "naive")}
    del model, model16
    (lf, nf), (ln, nn) = f32["fused"], f32["naive"]
    (lfb, nfb), (lnb, nnb) = bf16["fused"], bf16["naive"]
    rec = {"phase": "parity", "config": "openwebtext", "B": b, "T": t,
           "f32": {"loss_fused": lf, "loss_naive": ln,
                   "loss_rel_diff": abs(lf - ln) / abs(ln),
                   "grad_norm_fused": nf, "grad_norm_naive": nn,
                   "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
                   "limits": {"loss": 1e-5, "grad_norm": 1e-4}},
           "bf16": {"loss_fused": lfb, "loss_naive": lnb,
                    "loss_fused_to_f32": abs(lfb - ln),
                    "loss_naive_to_f32": abs(lnb - ln),
                    "grad_norm_fused": nfb, "grad_norm_naive": nnb,
                    "grad_norm_fused_to_f32": abs(nfb - nn),
                    "grad_norm_naive_to_f32": abs(nnb - nn),
                    "rule": "fused bf16 within 2 x naive bf16's distance "
                            "from naive f32"},
           "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 fused and naive paths disagree")
    if not (abs(lfb - ln) <= 2 * abs(lnb - ln)
            and abs(nfb - nn) <= 2 * abs(nnb - nn)):
        raise AssertionError("bf16 fused path too far from the f32 path")
    return rec


def fused_bounds(b, t, h, hkv, c, esz):
    """Least times of one forward and one backward launch, each the larger
    of bytes (inputs read once, outputs written once) over HBM bandwidth
    and bf16 operations over the peak rate. The causal triangle with its
    diagonal holds T (T + 1) / 2 score entries; the forward does two
    products over it (QK^T, PV), the backward five (QK^T, dO V^T, P^T dO,
    dS K, dS^T Q), 2 C operations per entry each."""
    f = (h + 2 * hkv) * c
    tables = 2 * t * c * 4 + 2 * c * 4  # sin, cos; wq, wk
    act = b * t * h * c * esz  # one [B, T, H C] activation
    fwd_bytes = b * t * f * esz + act + b * h * t * 4 + tables
    bwd_bytes = (b * t * f * esz + 2 * act + b * h * t * 4 + tables
                 + b * t * f * esz + 2 * c * 4)
    entries = b * h * t * (t + 1) // 2
    out = {}
    for name, nbytes, products in (("fwd", fwd_bytes, 2),
                                   ("bwd", bwd_bytes, 5)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * 2 * c * entries / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, products * 2 * c * entries)
    return out


def route_kernels_ms(call, reps: int = 5) -> tp.Dict[str, float]:
    """Device ms per call of each kernel that ``call`` launches (a route's
    kernels, such as the combined backward's pre-pass, tile kernel and
    post-pass, and the wrapper's PyTorch ops), from torch.profiler over
    ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.self_device_time_total}


def device_kernels(call, expect: tp.Sequence[str],
                   tries: int = 3) -> tp.List[str]:
    """The names of the device kernels a ``call`` runs (template
    arguments and parameters cut; other device work by its profiler
    name), from torch.profiler over five calls (a profile of one call
    after the train phases' profiles has come back empty). The profiler
    now and then drops a kernel's records, so while a kernel of
    ``expect`` is missing the call is profiled again, up to ``tries``
    profiles; the names are those seen in any of them, so device work
    outside ``expect`` in any profile still shows."""
    import re

    names: tp.Set[str] = set()
    for _ in range(tries):
        for key in route_kernels_ms(call, reps=5):
            m = re.search(r"(\w+_kernel)\b", key)
            names.add(m.group(1) if m else key)
        if names >= set(expect):
            break
    return sorted(names)


def fwd_yardstick_ms(fa, args, h, hkv, reps):
    """The fused forward's library time, the same function: SDPA forward
    on the already normed and roped q^/k^ (and v) plus the forward
    pre-pass (the pre-pass kernel without delta, which norms and ropes
    them), each device time from a CUDA graph. Returns ``(sum, sdpa,
    prep)``."""
    import torch.nn.functional as F

    qkv, wq, wk, sin, cos, _ = args
    q, k, v = fa._split(qkv, h, hkv)
    qh, kh = (fa._ln_rope(a, w, sin, cos, fa.EPS)[0].to(qkv.dtype)
              .contiguous() for a, w in ((q, wq), (k, wk)))
    vh = v.contiguous()
    sdpa = device_ms(lambda i: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True, enable_gqa=h != hkv), reps=reps)
    prep = device_ms(lambda i: fa.fused_attention_bwd_prep(
        qkv, wq, wk, sin, cos, h, hkv), reps=reps)
    return sdpa + prep, sdpa, prep


def phase_timing_train(fa, gpu):
    """Both kernels at one training microbatch's shapes, bf16, beside
    their plain versions and bounds, and the forward also at one
    train_long microbatch (B=4, T=2048); SDPA on the already normed and
    roped [B, H, T, C] q/k/v as a yardstick: forward + the forward
    pre-pass for the forward (the same function), forward + backward for
    the backward (attention alone); the port never calls SDPA. All device
    time from CUDA graphs; each route's kernels apart under the
    profiler."""
    b, t, h, hkv, c = (TRAIN_TIMING[k] for k in ("b", "t", "h", "hkv", "c"))
    args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=3)
    qkv, wq, wk, sin, cos, dout = args
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)

    def fwd(i):
        return fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)

    def bwd(i):
        return fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout,
                                      h, hkv)

    def plain_fwd(i):
        return fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                    hkv)

    def plain_bwd(i):
        return fa.fused_attention_backward_reference(
            qkv, wq, wk, sin, cos, out, lse, dout, h, hkv)

    ms = {"fwd": device_ms(fwd, reps=20), "bwd": device_ms(bwd, reps=10)}
    plain_ms = {"fwd": device_ms(plain_fwd, reps=4),
                "bwd": device_ms(plain_bwd, reps=2)}
    got = fused_run(fa, args, h, hkv, kernel=True)
    ref32 = fused_run(fa, [a.float() for a in args], h, hkv, kernel=False)
    err = {n: (g.float() - r).abs().max().item()
           for n, g, r in zip(FUSED_OUTS, got, ref32)}
    del got, ref32
    fwd_lib, sdpa_fwd, prep_fwd = fwd_yardstick_ms(fa, args, h, hkv, reps=20)
    sdpa_fb_ms = sdpa_fwd_bwd_ms(fa, args, h, hkv, reps=10)
    route = route_kernels_ms(lambda: bwd(0))
    fwd_route = route_kernels_ms(lambda: fwd(0))
    bounds = fused_bounds(b, t, h, hkv, c, qkv.element_size())
    from midgpt_tpu_torch.config import get_model_config

    # one launch of each per layer and microbatch of an optimizer step
    per_step = (get_model_config("openwebtext").n_layer
                * TRAIN_SET["g_accum_iters"])
    rec = {"phase": "timing", "kernels": "fused_attention_fwd/bwd",
           "shape": dict(TRAIN_TIMING, dtype="bfloat16"),
           "ms": ms, "plain_ms": plain_ms,
           "launches_per_optimizer_step": {"fwd": per_step, "bwd": per_step},
           "bound_ms": {k: v[0] for k, v in bounds.items()},
           "bound_by": {k: v[1] for k, v in bounds.items()},
           "bytes": {k: v[2] for k, v in bounds.items()},
           "flops": {k: v[3] for k, v in bounds.items()},
           "frac_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
           "library_ms": {"fwd": fwd_lib, "bwd": sdpa_fb_ms},
           "library_note": "fwd: SDPA forward on the normed, roped q/k/v + "
                           "the forward pre-pass (pre-pass kernel, no "
                           "delta), the same function; bwd: SDPA forward + "
                           "backward on them (attention alone); CUDA graphs",
           "sdpa_attention_alone_ms": {"fwd_graph": sdpa_fwd,
                                       "fwd_bwd_graph": sdpa_fb_ms},
           "fwd_prepass_ms": prep_fwd,
           "fwd_route_device_ms_by_kernel": fwd_route,
           "bwd_route_device_ms_by_kernel": route,
           "max_abs_err_vs_plain_f32": err, "gpu": gpu}
    del args, qkv, out, lse, dout
    gc.collect()
    torch.cuda.empty_cache()

    # the forward at one train_long microbatch
    b, t, h, hkv, c = (LONG_TIMING[k] for k in ("b", "t", "h", "hkv", "c"))
    args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=4)
    qkv, wq, wk, sin, cos, _ = args
    long_ms = device_ms(lambda i: fa.fused_attention_fwd(
        qkv, wq, wk, sin, cos, h, hkv), reps=20)
    long_plain = device_ms(lambda i: fa.fused_attention_forward_reference(
        qkv, wq, wk, sin, cos, h, hkv), reps=2)
    got = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    ref32 = fa.fused_attention_forward_reference(
        *(a.float() for a in args[:5]), h, hkv)
    long_err = {n: (g.float() - r).abs().max().item()
                for n, g, r in zip(("out", "lse"), got, ref32)}
    del got, ref32
    long_lib, long_sdpa, long_prep = fwd_yardstick_ms(fa, args, h, hkv,
                                                      reps=20)
    long_bound = fused_bounds(b, t, h, hkv, c, qkv.element_size())["fwd"]
    long_route = route_kernels_ms(lambda: fa.fused_attention_fwd(
        qkv, wq, wk, sin, cos, h, hkv))
    rec["fwd_t2048"] = {
        "shape": dict(LONG_TIMING, dtype="bfloat16"), "ms": long_ms,
        "plain_ms": long_plain, "bound_ms": long_bound[0],
        "bound_by": long_bound[1], "bytes": long_bound[2],
        "flops": long_bound[3], "frac_of_bound": long_bound[0] / long_ms,
        "library_ms": long_lib, "sdpa_fwd_ms": long_sdpa,
        "fwd_prepass_ms": long_prep,
        "route_device_ms_by_kernel": long_route,
        "max_abs_err_vs_plain_f32": long_err}
    del args, qkv
    gc.collect()
    torch.cuda.empty_cache()
    emit(rec)
    return rec


# -- the flash kernels and the shakespeare_char training path -------------


def moe_step_profile(cfg, gpu, steps: int = 1):
    """Where an MoE training step's device time goes: ``cfg``'s model
    (fresh init), one warm-up step, then ``steps`` steps under
    torch.profiler with each MoE stage method (``MoEMLP.route``,
    ``slots``, ``dispatch``, ``experts``, ``combine``) wrapped in a
    ``record_function`` range. A stage's forward time is its range's
    device time; its backward time is that of the autograd nodes whose
    sequence numbers belong to forward ops inside its range. The rest of
    the step is everything else the device ran."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from midgpt_tpu_torch.models.gpt import MoEMLP
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, init_state, make_lr_schedule, make_shadow,
        train_step)

    g, b, t = cfg.g_accum_iters, cfg.microbatch_size, cfg.model.block_size
    toks = zipf_tokens(g * b * (t + 1), SEED + 3).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(g, b, t + 1)).to(DEVICE)
    x, y = toks[..., :-1], toks[..., 1:]
    state = init_state(cfg, DEVICE)
    shadow = make_shadow(state.model, torch.bfloat16)
    lr, chunk = make_lr_schedule(cfg), effective_loss_chunk(cfg)
    train_step(state, shadow, x, y, cfg, lr(0), chunk, fold_in(SEED, 0))
    torch.cuda.synchronize()
    originals = {n: getattr(MoEMLP, n) for n in MOE_STAGES}

    def labelled(name, fn):
        def run(*a, **kw):
            with record_function(f"moe.{name}"):
                return fn(*a, **kw)
        return run

    for n, fn in originals.items():
        setattr(MoEMLP, n, labelled(n, fn))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                train_step(state, shadow, x, y, cfg, lr(i + 1), chunk,
                           fold_in(SEED, i + 1))
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for n, fn in originals.items():
            setattr(MoEMLP, n, fn)
    del state, shadow
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")) / 1e3 / steps
    events = prof.events()
    stage_of_seq = {}
    for e in events:
        p = e.cpu_parent
        while p is not None and not p.name.startswith("moe."):
            p = p.cpu_parent
        if p is not None and e.sequence_nr >= 0:
            # a backward node names its forward op's thread in fwd_thread
            stage_of_seq[(e.thread, e.sequence_nr)] = p.name[4:]
    # every kernel to the op that launched it, that op to its stage: a
    # moe.* range above it (forward), or an autograd node whose forward
    # op ran inside one (backward)
    by = {(n, d): {} for n in MOE_STAGES for d in ("forward", "backward")}
    rest, matched = {}, 0
    for e in events:
        if not e.kernels:
            continue
        p, label = e, None
        while p is not None:
            if p.name.startswith("moe."):
                label = (p.name[4:], "forward")
                break
            if p.name.startswith("autograd::engine::evaluate_function:"):
                stage = stage_of_seq.get((p.fwd_thread, p.sequence_nr))
                label = None if stage is None else (stage, "backward")
                break
            p = p.cpu_parent
        into = rest if label is None else by[label]
        matched += label is not None and label[1] == "backward"
        for k in e.kernels:
            into[k.name] = into.get(k.name, 0.0) + k.duration / 1e3 / steps
    ms = {d: {n: sum(by[(n, d)].values()) for n in MOE_STAGES}
          for d in ("forward", "backward")}
    moe_ms = sum(sum(v.values()) for v in ms.values())
    if not (busy > 0 and sum(ms["forward"].values()) > 0 and matched > 0):
        raise AssertionError(f"the MoE profile split found no time: busy "
                             f"{busy}, stages {ms}, {matched} backward ops")
    step_ms = wall_ms / steps
    top = {f"{n}.{d}": [[k[:90], v] for k, v in sorted(
        by[(n, d)].items(), key=lambda kv: -kv[1])[:3]]
        for (n, d) in by if by[(n, d)]}
    return {"steps": steps, "step_ms_host": step_ms,
            "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / step_ms,
            "moe_layer_ms_per_step": moe_ms,
            "moe_layer_share_of_busy": moe_ms / busy,
            "rest_ms_per_step": busy - moe_ms,
            "moe_forward_ms_by_stage": ms["forward"],
            "moe_backward_ms_by_stage": ms["backward"],
            "top_kernels_by_stage": top,
            "top_rest_kernels": [[k[:90], v] for k, v in sorted(
                rest.items(), key=lambda kv: -kv[1])[:10]],
            "backward_ops_matched": matched,
            "note": "record_function ranges around MoEMLP's stage methods; "
                    "backward by autograd sequence number; 'slots' is the "
                    "routing's capacity bookkeeping, 'experts' the two bmm "
                    "and the GELU",
            "gpu": gpu}


def phase_train_moe(fa, gpu, dense):
    """``train()`` on ``openwebtext_moe`` at full width and depth (12
    layers of 8 experts, ~558M parameters; f32 masters, bf16 compute,
    remat as ``resolve_auto_knobs`` picks it on the card) over the train
    phase's Zipf data and batch (16 x 1024 tokens a step in 2
    microbatches), 10 steps with an eval at steps 0 and 5. Checked: the
    fused kernels' launches against the shapes' count, the loss falls by
    1 nat, the router telemetry (``moe/aux``, ``moe/dropped_frac``) at
    every eval. Beside the dense train phase's step median, tokens/s and
    MFU (active FLOPs, as the JAX package counts them): the MoE run's,
    the run's peak memory against the port's estimate and the JAX
    package's for the same microbatch (``memory_fields``), and a profile
    of one step split into the MoE layer's stages and the rest."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.train import resolve_auto_knobs
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    hbm = torch.cuda.get_device_properties(0).total_memory
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        rundir = os.path.join(tmp, "run")
        cfg = get_config(MOE_NAME, rundir=rundir, data_dir=data, seed=SEED,
                         **MOE_SET)
        fa.fused_attention_fwd.launches = 0
        fa.fused_attention_bwd.launches = 0
        final, wall, peak_bytes, held = train_measured(cfg)
        launches = (fa.fused_attention_fwd.launches,
                    fa.fused_attention_bwd.launches)
        rows = read_metrics(rundir)
        disk_free = shutil.disk_usage(tmp).free
    losses = final["losses"]
    # the train phase's count, plus one forward a layer for the router
    # telemetry's microbatch at every eval interval
    evals = list(range(0, cfg.max_steps, cfg.eval_interval))
    want = expected_launches(cfg)
    want = (want[0] + cfg.model.n_layer * len(evals), want[1])
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    router = [{k: r[k] for k in ("step", "moe/aux", "moe/dropped_frac")}
              for r in rows if "moe/aux" in r]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    resolved = resolve_auto_knobs(cfg, hbm, card=True)
    prof = moe_step_profile(resolved, gpu)
    step_ms_median = 1e3 * tokens_per_step / statistics.median(tps)
    rec = {
        "phase": "train_moe", "config": MOE_NAME, "overrides": MOE_SET,
        "model": {k: getattr(cfg.model, k) for k in (
            "n_layer", "n_embd", "moe_experts", "moe_top_k", "moe_capacity",
            "moe_aux_weight")},
        "remat": final["remat"], "losses": losses,
        "val_loss": final["val_loss"], "router_telemetry": router,
        "fused_fwd_launches": launches[0], "fused_bwd_launches": launches[1],
        "expected_launches": list(want),
        "launch_formula": "fwd = n_layer x (train microbatches + eval "
                          "microbatches + one router-telemetry microbatch "
                          "an eval), bwd = n_layer x train microbatches",
        "wall_s": wall, "loop_s": final["loop_s"], "eval_s": final["eval_s"],
        "ckpt_s": final["ckpt_s"], "ckpt_wait_s": final["ckpt_wait_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu_active": final["tokens_per_sec"] * fpt / peak,
        "step_ms_median": step_ms_median,
        "dense_step_ms_median": dense["step_ms_median"],
        "dense_tokens_per_s": dense["tokens_per_s"], "dense_mfu": dense["mfu"],
        "moe_over_dense_step_median": step_ms_median
        / dense["step_ms_median"],
        **memory_fields(cfg, final["remat"], peak_bytes, held),
        "tmp_disk_free_gb": disk_free / 1e9,
        "flops_per_token_active": fpt, "profile": prof,
        "timing_note": "as the train phase: tokens_per_s and mfu over "
                       "train()'s loop, evals and saves included; "
                       "step_ms_median between loss reads",
        "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-3:]) <= losses[0] - 1.0:
        raise AssertionError(f"the loss did not fall by 1 nat: {losses}")
    if launches != want or min(launches) == 0:
        raise AssertionError(f"fused launches {launches} != {want}")
    if [r["step"] for r in router] != evals or not all(
            np.isfinite(r["moe/aux"]) and 0 <= r["moe/dropped_frac"] < 1
            for r in router):
        raise AssertionError(f"router telemetry {router}")
    return rec


def phase_parity_moe(fa, gpu):
    """One microbatch (B=8, T=1024) of the full-width ``openwebtext_moe``
    model at f32 through the fused kernels and through the naive path:
    the loss (aux included) within 1e-5 and the global gradient norm
    within 1e-4 relative, as the parity phase holds the dense model.
    Then layer 0's MoE MLP on the card and a copy on the CPU, f32, on one
    seeded input [8, 1024, 768]: y within 1e-4 of its largest element,
    aux within 1e-5 relative, the dropped fraction equal."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, global_norm, loss_fn)

    exp = get_config(MOE_NAME)
    cfg, chunk = exp.model, effective_loss_chunk(exp)
    b, t = 8, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 2).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = seeded_model(GPT, cfg)

    def run(impl):
        model.zero_grad(set_to_none=True)
        before = fa.fused_attention_bwd.launches
        loss = loss_fn(model, x, y, chunk, attn_impl=impl)
        loss.backward()
        norm = global_norm([p.grad for p in model.parameters()]).item()
        used = fa.fused_attention_bwd.launches - before
        if used != (cfg.n_layer if impl == "fused" else 0):
            raise AssertionError(f"{impl}: {used} fused backward launches")
        return loss.item(), norm

    (lf, nf), (ln, nn) = run("fused"), run("naive")
    with torch.no_grad():
        stats = model.moe_stats(x)
    model.zero_grad(set_to_none=True)
    mlp = model.blocks[0].mlp
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(SEED + 5)
    xin = torch.randn(b, t, cfg.n_embd, generator=gen)
    with torch.no_grad():
        card = mlp(xin.to(DEVICE), return_dropped=True)
        host = copy.deepcopy(mlp).cpu()(xin, return_dropped=True)
    y_err = (card[0].cpu() - host[0]).abs().max().item()
    y_tol = 1e-4 * host[0].abs().max().item()
    aux_rel = abs(card[1].item() - host[1].item()) / abs(host[1].item())
    rec = {"phase": "parity_moe", "config": MOE_NAME, "B": b, "T": t,
           "f32": {"loss_fused": lf, "loss_naive": ln,
                   "loss_rel_diff": abs(lf - ln) / abs(ln),
                   "grad_norm_fused": nf, "grad_norm_naive": nn,
                   "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
                   "limits": {"loss": 1e-5, "grad_norm": 1e-4}},
           "moe_stats": {k: v.item() for k, v in stats.items()},
           "layer_card_vs_cpu": {
               "y_max_abs_err": y_err, "y_tol": y_tol,
               "aux_card": card[1].item(), "aux_cpu": host[1].item(),
               "aux_rel_diff": aux_rel,
               "dropped_card": card[2].item(), "dropped_cpu": host[2].item(),
               "rule": "y within 1e-4 x max |y|, aux 1e-5 relative, "
                       "dropped equal"},
           "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 fused and naive MoE paths disagree")
    if not (y_err <= y_tol and aux_rel <= 1e-5
            and card[2].item() == host[2].item()):
        raise AssertionError("the MoE layer on the card disagrees with the "
                             "CPU")
    return rec


def flash_inputs(b, t, h, hkv, c, dtype, seed=0, layout="contiguous"):
    """q, k, v and an output gradient ``[B, H|Hkv, T, C]``, drawn on the CPU
    from ``seed`` and moved to the card. ``layout="model"`` gives the
    strided views the model passes, which the kernels read in place: q, k
    (RoPE's outputs) and dO ``[B, T, H, C]`` transposed, v a transposed
    view into a packed ``[B, T, (H + 2 Hkv) C]`` projection."""
    gen = torch.Generator().manual_seed(seed)
    if layout == "contiguous":
        q = torch.randn(b, h, t, c, generator=gen)
        k = torch.randn(b, hkv, t, c, generator=gen)
        v = torch.randn(b, hkv, t, c, generator=gen)
        dout = torch.randn(b, h, t, c, generator=gen)
        return [a.to(DEVICE, dtype) for a in (q, k, v, dout)]
    q, k, dout = (torch.randn(b, t, n, c, generator=gen).to(DEVICE, dtype)
                  .transpose(1, 2) for n in (h, hkv, h))
    qkv = torch.randn(b, t, (h + 2 * hkv) * c, generator=gen).to(DEVICE, dtype)
    v = qkv[..., (h + hkv) * c:].reshape(b, t, hkv, c).transpose(1, 2)
    return [q, k, v, dout]


def flash_run(fl, args, drop, kernel):
    """``(out, lse, dq, dk, dv, delta)`` (dk, dv per q head) through the
    kernels or the plain versions. Both backward passes read the plain
    forward's lse, and the dq kernel its out, from which it forms delta
    itself (the main path's entry, ``flash_bwd_dq_delta``); dk/dv reads
    the plain delta, so every kernel sees its plain version's inputs."""
    q, k, v, dout = args
    out, lse = fl.flash_forward_reference(q, k, v, True, drop)
    delta = fl.delta_reference(dout, out)
    if kernel:
        fwd = fl.flash_fwd(q, k, v, True, drop)
        dq, written = fl.flash_bwd_dq_delta(q, k, v, dout, lse, out, None,
                                            True, drop)
        return (*fwd, dq, *fl.flash_bwd_dkv(q, k, v, dout, lse, delta, True,
                                            drop), written)
    dq = fl.flash_backward_dq_reference(q, k, v, dout, lse, delta, True, drop)
    return (out, lse, dq, *fl.flash_backward_dkv_reference(
        q, k, v, dout, lse, delta, True, drop), delta)


def flash_readings(got, plain, ref32):
    """Per output, its distance from the plain version over the limit (the
    check passes when every reading is at most 1).

    f32 (``ref32 is None``): each element within ``1e-5 + rel * |plain|``,
    rel 1e-5 for out and lse, 1e-4 for dq, dk, dv (their sums run over T
    twice). bf16: the kernels round P and dS where the plain version
    does, but after sums in another order, so out, dq, dk and dv are held
    by the triangle rule: at most twice as far from the plain version run
    in f32 on the upcast inputs (``ref32``) as the plain bf16 version is.
    lse is computed in f32 from the same upcast q and k by both plain
    versions, so in bf16 too it is held by the f32 rule against
    ``ref32``. delta is formed in f32 by the dq kernel and by the plain
    version from the same O (the plain forward's, in the call's dtype)
    and dO, so it is held by the f32 rule against the plain version of
    the same dtype: within ``1e-5 + 1e-5 |plain|``."""
    out = {}
    for i, name in enumerate(FLASH_OUTS):
        g, p = got[i].float(), plain[i].float()
        if ref32 is None or name in ("lse", "delta"):
            r = p if ref32 is None or name == "delta" else ref32[i]
            rel = 1e-5 if name in ("out", "lse", "delta") else 1e-4
            out[name] = ((g - r).abs() / (1e-5 + rel * r.abs())).max().item()
        else:
            own = (p - ref32[i]).abs().max().item()
            out[name] = (g - ref32[i]).abs().max().item() / (2 * own)
    return out


def flash_cases():
    """``(name, B, T, H, Hkv, C, rate, dtype, layout)`` of each
    flash_kernel case: every geometry of ``FLASH_GEOMS`` at each rate and
    type, then train_char's own microbatch (``CHAR_TIMING``, bf16) on
    contiguous inputs and on the model's strided views."""
    for name, b, t, h, hkv, c in FLASH_GEOMS:
        for rate in FLASH_RATES:
            for dtype in (torch.bfloat16, torch.float32):
                yield name, b, t, h, hkv, c, rate, dtype, "contiguous"
    ch = CHAR_TIMING
    for layout in ("contiguous", "model"):
        yield ("char_microbatch", ch["b"], ch["t"], ch["h"], ch["hkv"],
               ch["c"], ch["rate"], torch.bfloat16, layout)


def phase_flash_kernel(fl) -> float:
    """Each case is held by :func:`flash_readings`; the same rule must
    refuse the kernels' outputs against the plain version of a fault: the
    mask of seed + 1 (with dropout: out, dq, dk, dv, since lse does not
    see the mask) or k and v shifted one row (without: every output).
    Returns the largest bf16-kernel-to-bf16-plain distance seen."""
    worst = 0.0
    up = lambda a: [x.float() for x in a]  # noqa: E731
    for name, b, t, h, hkv, c, rate, dtype, layout in flash_cases():
        drop = fl.Dropout(rate, FLASH_SEED) if rate else None
        args = flash_inputs(b, t, h, hkv, c, dtype, layout=layout)
        got = flash_run(fl, args, drop, kernel=True)
        torch.cuda.synchronize()
        plain = flash_run(fl, args, drop, kernel=False)
        ref32 = (up(flash_run(fl, up(args), drop, kernel=False))
                 if dtype == torch.bfloat16 else None)
        sound = flash_readings(got, plain, ref32)
        if drop is not None:
            fault = "seed + 1"
            fargs, fdrop = args, drop._replace(seed=FLASH_SEED + 1)
            checked = ["out", "dq", "dk", "dv"]
        else:
            fault = "k, v shifted one row"
            fargs = [args[0], *(torch.roll(a, 1, 2)
                                for a in args[1:3]), args[3]]
            fdrop, checked = None, [n for n in FLASH_OUTS if n != "delta"]
        fplain = flash_run(fl, fargs, fdrop, kernel=False)
        fref = (up(flash_run(fl, up(fargs), fdrop, kernel=False))
                if ref32 is not None else None)
        faulted = flash_readings(got, fplain, fref)
        errs = {n: (g.float() - p.float()).abs().max().item()
                for n, g, p in zip(FLASH_OUTS, got, plain)}
        if not all(torch.isfinite(g).all() for g in got):
            raise AssertionError(f"non-finite flash output: {name}")
        emit({"phase": "flash_kernel", "geometry": name, "B": b,
              "T": t, "H": h, "Hkv": hkv, "C": c, "rate": rate,
              "layout": layout,
              "seed": FLASH_SEED if rate else None,
              "dtype": str(dtype).split(".")[-1],
              "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                       "(out, lse, delta) / 1e-4 (dq, dk, dv)"
                       if ref32 is None else
                       "max |kernel - plain f32| <= 2 x max |plain "
                       "bf16 - plain f32| (lse, delta: the f32 rule)"),
              "sound_err_over_limit": sound, "fault": fault,
              "fault_err_over_limit": faulted,
              "max_abs_err_vs_plain_same_dtype": errs})
        bad = [n for n, x in sound.items() if not x <= 1.0]
        if bad:
            raise AssertionError(
                f"flash kernels disagree with their plain versions: "
                f"{name} {layout} rate={rate} {dtype} {bad}")
        missed = [n for n in checked if not faulted[n] > 1.0]
        if missed:
            raise AssertionError(f"the check passes a fault ({fault})"
                                 f": {name} {layout} {dtype} {missed}")
        if dtype == torch.bfloat16:
            worst = max(worst, *errs.values())
    return worst


def char_expected_launches(cfg) -> tp.Dict[str, int]:
    """Launches of ``train(cfg)`` from step 0 for a config with dropout
    and remat "full": the training steps take the flash kernels, each
    layer's forward twice a microbatch (the checkpointed block is
    recomputed in the backward), dq and dk/dv once; the evals are
    deterministic and take the fused forward, once per layer and eval
    microbatch (two splits at every eval interval, the validation split
    once more at the end)."""
    g, nl = cfg.g_accum_iters, cfg.model.n_layer
    train_mb = cfg.max_steps * g
    evals = len(range(0, cfg.max_steps, cfg.eval_interval))
    eval_mb = (2 * evals + 1) * cfg.eval_batches * g
    return {"flash_fwd": 2 * nl * train_mb, "flash_bwd_dq": nl * train_mb,
            "flash_bwd_dkv": nl * train_mb, "fused_fwd": nl * eval_mb,
            "fused_bwd": 0,
            # residual and embedding dropout: 1 + 2 nl sites forward, 1 + 2
            # nl backward, and each block's attention-output site again in
            # the recompute (which stops at the last tensor the backward
            # needs, before the MLP output's site)
            "keyed_dropout": (2 + 5 * nl) * train_mb}


def phase_train_char(fl, fa, gpu):
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        prep = subprocess.run(
            [sys.executable,
             os.path.join(repo, "data", "shakespeare_char", "prepare.py"),
             "--synthetic", "--out_dir", data],
            check=True, capture_output=True, text=True, timeout=300)
        rundir = os.path.join(tmp, "run")
        cfg = get_config("shakespeare_char", rundir=rundir, data_dir=data,
                         seed=SEED, **CHAR_SET)
        from midgpt_tpu_torch.ops import dropout as kd

        fl.flash_fwd.launches = fl.flash_bwd_dq.launches = 0
        fl.flash_bwd_dkv.launches = kd.keyed_dropout.launches = 0
        fa.fused_attention_fwd.launches = fa.fused_attention_bwd.launches = 0
        final, wall, peak_bytes, held = train_measured(cfg)
        launches = {"flash_fwd": fl.flash_fwd.launches,
                    "flash_bwd_dq": fl.flash_bwd_dq.launches,
                    "flash_bwd_dkv": fl.flash_bwd_dkv.launches,
                    "fused_fwd": fa.fused_attention_fwd.launches,
                    "fused_bwd": fa.fused_attention_bwd.launches,
                    "keyed_dropout": kd.keyed_dropout.launches}
        rows = read_metrics(rundir)
        ckpts = sorted(os.listdir(os.path.join(rundir, "checkpoints")))
    losses = final["losses"]
    want = char_expected_launches(cfg)
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = (final["loop_s"] - final["eval_s"] - final["ckpt_s"]
               - final["ckpt_wait_s"])
    rec = {
        "phase": "train_char", "config": "shakespeare_char",
        "overrides": CHAR_SET,
        "model": {k: getattr(cfg.model, k) for k in (
            "block_size", "vocab_size", "n_layer", "n_head", "n_embd",
            "dropout", "attn_impl", "remat")},
        "batch_size": cfg.batch_size, "g_accum_iters": cfg.g_accum_iters,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "data": "data/shakespeare_char/prepare.py --synthetic: "
                + prep.stdout.strip().replace("\n", "; "),
        "losses": losses, "val_loss": final["val_loss"],
        "launches": launches, "expected_launches": want,
        "launch_formula": "flash fwd = 2 x n_layer x train microbatches "
                          "(remat recompute), dq = dkv = n_layer x train "
                          "microbatches; fused fwd = n_layer x eval "
                          "microbatches, fused bwd = 0; keyed dropout = "
                          "(2 + 5 n_layer) x train microbatches",
        "checkpoints": ckpts, "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "ckpt_wait_s": final["ckpt_wait_s"], "remat": final["remat"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / statistics.median(tps),
        "timing_note": "tokens_per_s, mfu: every trained token over "
                       "train()'s loop on the host clock, evals and the "
                       "save included; *_steps_only: the loop less the "
                       "evals and the save; step_ms_median: per-step host "
                       "clock between loss reads (log_interval=1)",
        "flops_per_token": fpt, "peak_flops": peak,
        **memory_fields(cfg, final["remat"], peak_bytes, held), "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-5:]) <= losses[0] - 1.0:
        raise AssertionError(f"the loss did not fall by 1 nat: {losses}")
    if cfg.model.remat != "full" or cfg.model.dropout != 0.2:
        raise AssertionError("the char phase must run remat full, dropout")
    if launches != want or min(v for k, v in launches.items()
                               if k != "fused_bwd") == 0:
        raise AssertionError(f"launches {launches} != {want}")
    if ckpts != [f"step_{cfg.max_steps - 1:08d}.pt"]:
        raise AssertionError(f"checkpoints {ckpts}")
    return rec


def phase_parity_char(fl, gpu):
    """One microbatch (B=16) of the full-width char model in f32 with
    dropout drawn from one key, through the flash kernels and through the
    naive path: both draw the same attention masks (the counter hash) and
    the same residual masks (the keyed dropout's hash of the same keys), so
    the loss and gradient norm agree to f32 rounding."""
    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.models.layers import fold_in
    from midgpt_tpu_torch.train import global_norm, loss_fn

    cfg = get_config("shakespeare_char").model
    b, t = 16, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 4).astype(np.int64) % cfg.vocab_size
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = seeded_model(GPT, cfg)
    key = fold_in(SEED, 7)

    def run(impl, k):
        model.zero_grad(set_to_none=True)
        before = fl.flash_bwd_dq.launches
        loss = loss_fn(model, x, y, attn_impl=impl, key=k)
        loss.backward()
        norm = global_norm([p.grad.float() for p in model.parameters()])
        used = fl.flash_bwd_dq.launches - before
        if used != (cfg.n_layer if impl == "flash" else 0):
            raise AssertionError(f"{impl}: {used} flash dq launches")
        return loss.item(), norm.item()

    (lf, nf), (ln, nn) = run("flash", key), run("naive", key)
    lo, _ = run("flash", fold_in(SEED, 8))
    ld, _ = run("flash", None)
    del model
    rec = {"phase": "parity_char", "config": "shakespeare_char", "B": b,
           "T": t, "dtype": "float32", "dropout": cfg.dropout,
           "loss_flash": lf, "loss_naive": ln,
           "loss_rel_diff": abs(lf - ln) / abs(ln),
           "grad_norm_flash": nf, "grad_norm_naive": nn,
           "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
           "limits": {"loss": 1e-5, "grad_norm": 1e-4},
           "loss_other_key": lo, "loss_deterministic": ld, "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 flash and naive dropout paths disagree")
    if lo == lf or ld == lf:
        raise AssertionError("the dropout masks do not depend on the key")
    return rec


def flash_bounds(b, t, h, hkv, c, esz):
    """Least times of one call of each kernel, and of the whole backward,
    each the larger of bytes (inputs read once, outputs written once)
    over HBM bandwidth and bf16 operations over the peak rate. The causal
    triangle with its diagonal holds T (T + 1) / 2 score entries a head;
    the forward does two products over it (QK^T, PV), dq three (QK^T,
    dO V^T, dS K), dk/dv four (QK^T, dO V^T, P^T dO, dS^T Q) and the whole
    backward five (dq's and dk/dv's shared ones counted once), 2 C
    operations per entry each. Forward: q, k, v in, out and lse out. dq:
    q, k, v, dO, lse, delta in, dq out; dq_delta (the main path's dq,
    which forms delta): q, k, v, dO, out, lse in, dq and delta out.
    dk/dv: q, k, v, dO, lse, delta in, dk, dv out. The whole backward
    reads q, k, v, out (for delta), dO and lse and writes dq, dk, dv."""
    qa = b * h * t * c * esz  # a [B, H, T, C] activation
    kva = b * hkv * t * c * esz
    rows = b * h * t * 4  # an f32 [B, H, T] row vector
    entries = b * h * t * (t + 1) // 2
    work = {"fwd": (qa + 2 * kva + qa + rows, 2),
            "dq": (2 * qa + 2 * kva + 2 * rows + qa, 3),
            "dq_delta": (3 * qa + 2 * kva + rows + qa + rows, 3),
            "dkv": (2 * qa + 2 * kva + 2 * rows + 2 * kva, 4),
            "bwd": (3 * qa + 2 * kva + rows + qa + 2 * kva, 5)}
    out = {}
    for name, (nbytes, products) in work.items():
        flops = products * 2 * c * entries
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, flops)
    return out


def phase_timing_flash(fl, gpu):
    """The flash kernels at one shakespeare_char microbatch, bf16, rate
    0.2: the forward, dq (given delta, and forming delta as the main path
    runs it) and dk/dv alone and the whole backward (dq forming delta,
    dk/dv), each beside its plain version and bound; one whole backward
    under torch.profiler, whose device kernels must be the dq and dk/dv
    kernels alone (no PyTorch operation forms delta); SDPA with
    ``dropout_p=0.2`` (its own mask, not this one) forward and forward +
    backward as the library's time for the same work. Every time is
    device time from a CUDA graph (:func:`device_ms`); SDPA's dropout
    draws its Philox offsets from the default generator, which graph
    capture supports."""
    import torch.nn.functional as F

    b, t, h, hkv, c, rate = (CHAR_TIMING[k]
                             for k in ("b", "t", "h", "hkv", "c", "rate"))
    q, k, v, dout = flash_inputs(b, t, h, hkv, c, torch.bfloat16, seed=5)
    drop = fl.Dropout(rate, FLASH_SEED)
    out, lse = fl.flash_fwd(q, k, v, True, drop)
    delta = fl.delta_reference(dout, out)

    def bwd(i):
        return fl.flash_bwd(q, k, v, out, lse, dout, None, True, drop)

    def plain_dq_delta(i):
        d = fl.delta_reference(dout, out)
        return fl.flash_backward_dq_reference(q, k, v, dout, lse, d, True,
                                              drop), d

    def plain_bwd(i):
        dq, d = plain_dq_delta(i)
        return dq, fl.flash_backward_dkv_reference(q, k, v, dout, lse, d,
                                                   True, drop)

    ms = {"fwd": device_ms(lambda i: fl.flash_fwd(q, k, v, True, drop),
                           reps=20),
          "dq": device_ms(lambda i: fl.flash_bwd_dq(
              q, k, v, dout, lse, delta, True, drop), reps=20),
          "dq_delta": device_ms(lambda i: fl.flash_bwd_dq_delta(
              q, k, v, dout, lse, out, None, True, drop), reps=20),
          "dkv": device_ms(lambda i: fl.flash_bwd_dkv(
              q, k, v, dout, lse, delta, True, drop), reps=20),
          "bwd": device_ms(bwd, reps=10)}
    plain_ms = {
        "fwd": device_ms(lambda i: fl.flash_forward_reference(
            q, k, v, True, drop), reps=2),
        "dq": device_ms(lambda i: fl.flash_backward_dq_reference(
            q, k, v, dout, lse, delta, True, drop), reps=2),
        "dq_delta": device_ms(plain_dq_delta, reps=2),
        "dkv": device_ms(lambda i: fl.flash_backward_dkv_reference(
            q, k, v, dout, lse, delta, True, drop), reps=2),
        "bwd": device_ms(plain_bwd, reps=1)}
    want = ["flash_dkv_tile_kernel", "flash_dq_tile_kernel"]
    before = (fl.flash_bwd_dq.launches, fl.flash_bwd_dkv.launches)
    bwd(0)
    after = (fl.flash_bwd_dq.launches, fl.flash_bwd_dkv.launches)
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        raise AssertionError(f"flash_bwd launches (dq, dkv): {before} -> "
                             f"{after}, not one of each")
    bwd_kernels = device_kernels(lambda: bwd(0), want)
    if bwd_kernels != want:
        raise AssertionError(f"flash_bwd ran other device work: {bwd_kernels}")
    got = flash_run(fl, [q, k, v, dout], drop, kernel=True)
    ref32 = flash_run(fl, [a.float() for a in (q, k, v, dout)], drop,
                      kernel=False)
    err = {n: (g.float() - r).abs().max().item()
           for n, g, r in zip(FLASH_OUTS, got, ref32)}
    # delta against the plain delta of the same (bf16) forward's out
    err["delta"] = (got[5] - flash_run(fl, [q, k, v, dout], drop,
                                       kernel=False)[5]).abs().max().item()
    sdpa_fwd = device_ms(lambda i: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, dropout_p=rate), reps=20)
    leaves = [a.detach().requires_grad_() for a in (q, k, v)]

    def sdpa_fb(i):
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           dropout_p=rate)
        return torch.autograd.grad(o, leaves, dout)

    sdpa_fb_ms = device_ms(sdpa_fb, reps=10)
    bounds = flash_bounds(b, t, h, hkv, c, q.element_size())
    rec = {"phase": "timing", "kernels": "flash fwd / dq / dkv",
           "shape": dict(CHAR_TIMING, dtype="bfloat16"),
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": {n: x[0] for n, x in bounds.items()},
           "bound_by": {n: x[1] for n, x in bounds.items()},
           "bytes": {n: x[2] for n, x in bounds.items()},
           "flops": {n: x[3] for n, x in bounds.items()},
           "frac_of_bound": {n: bounds[n][0] / ms[n] for n in ms},
           "library_ms": {"sdpa_fwd_dropout": sdpa_fwd,
                          "sdpa_fwd_bwd_dropout": sdpa_fb_ms},
           "bwd_note": "bwd = the dq kernel (forming delta) + dk/dv kernel",
           "bwd_profile_kernels": bwd_kernels,
           "max_abs_err_vs_plain_f32": err, "gpu": gpu}
    emit(rec)
    return rec


# -- the trainer's dispatch programs: the keyed dropout kernel, the flash
# seed by pointer, and the step program and the K-step window -------------

# dropout_kernel shapes: shakespeare_char's and openwebtext's residual
# microbatch (bf16 and f32), an odd element count, a misaligned view
DROPOUT_SHAPES = [((64, 256, 384), torch.bfloat16),
                  ((8, 1024, 768), torch.bfloat16),
                  ((64, 256, 384), torch.float32),
                  ((1000003,), torch.bfloat16)]
DROPOUT_RATE = 0.2
DROPOUT_KEY = 0x0123456789ABCDE  # both 32-bit words in play
# ([B, T, D] of the whole rows, S, the slice's sequence index, dtype): a
# slice of 512 x 768 elements a row takes the vector loop, one of 3 x 7 a
# row (not a multiple of the 16-byte vector) the one-element loop
DROPOUT_SLICES = [((8, 1024, 768), 2, 1, torch.bfloat16),
                  ((8, 1024, 768), 4, 2, torch.float32),
                  ((5, 12, 7), 4, 3, torch.bfloat16)]


def phase_dropout_kernel(kd) -> int:
    """The keyed dropout kernel against its plain version at the residual
    shapes (bf16, f32, an odd count, a view one element into a buffer
    that takes the unvectorized loop): equal bit for bit, forward and
    backward (the autograd entry on the card against the plain masks);
    a plain run under key + 1 must differ; inside a CUDA graph the kernel
    reads its key from device memory: a replay after the key tensor is
    rewritten draws the new key's mask; at the element offsets of a mesh
    rank's first row (row 8 of openwebtext's residual, and one that
    wraps the 32-bit index) the kernel equals its plain version there
    and differs from offset 0; a sequence rank's slice of every row
    (``DROPOUT_SLICES``: rows of ``inner`` elements ``inner_stride``
    apart, the vector loop and the one-element one) equals its plain
    version and the whole row's mask at its columns. Returns the
    elements that differ (0)."""
    key = torch.tensor(DROPOUT_KEY, dtype=torch.int64, device=DEVICE)
    other = torch.tensor(DROPOUT_KEY + 1, dtype=torch.int64, device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    bad = 0
    cases = [(s, d, False) for s, d in DROPOUT_SHAPES] + [
        ((64, 256, 384), torch.bfloat16, True)]
    for shape, dtype, misaligned in cases:
        n = int(np.prod(shape))
        buf = torch.randn(n + 1, generator=gen, device=DEVICE).to(dtype)
        x = (buf[1:] if misaligned else buf[:n]).view(shape)
        before = kd.keyed_dropout.launches
        got = kd.keyed_dropout(x, key, DROPOUT_RATE)
        if kd.keyed_dropout.launches != before + 1:
            raise AssertionError("keyed_dropout did not count its launch")
        plain = kd.keyed_dropout_reference(x, key, DROPOUT_RATE)
        bad += int((got.view(torch.int16 if dtype == torch.bfloat16
                             else torch.int32)
                    != plain.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32)).sum())
        if torch.equal(got, kd.keyed_dropout_reference(x, other,
                                                       DROPOUT_RATE)):
            raise AssertionError("key + 1 drew the same mask")
        kept = (plain != 0).float().mean().item()
        if abs(kept - (1 - DROPOUT_RATE)) > 0.01:
            raise AssertionError(f"keep fraction {kept}")
        leaf = x.detach().requires_grad_()
        dy = torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
        kd.dropout(leaf, key, DROPOUT_RATE).backward(dy)
        bad += int((leaf.grad != kd.keyed_dropout_reference(
            dy, key, DROPOUT_RATE)).sum())
    # the key read from device memory at every replay
    x = torch.randn(64, 256, 384, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    k_static = key.clone()
    kd.keyed_dropout(x, k_static, DROPOUT_RATE)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = kd.keyed_dropout(x, k_static, DROPOUT_RATE)
    for k in (DROPOUT_KEY, DROPOUT_KEY + 1, 7):
        k_static.fill_(k)
        graph.replay()
        want = kd.keyed_dropout_reference(x, k_static, DROPOUT_RATE)
        bad += int((y != want).sum())
    # a mesh rank's rows: the global batch's masks at its first element
    x = torch.randn(8, 1024, 768, generator=gen, device=DEVICE).to(
        torch.bfloat16)
    offsets = (8 * 1024 * 768, (1 << 32) - 1000)
    for off in offsets:
        got = kd.keyed_dropout(x, key, DROPOUT_RATE, off)
        bad += int((got != kd.keyed_dropout_reference(
            x, key, DROPOUT_RATE, off)).sum())
        if torch.equal(got, kd.keyed_dropout(x, key, DROPOUT_RATE)):
            raise AssertionError(f"offset {off} drew offset 0's mask")
    # a sequence rank's columns of every row: [B, T/S, D] of [B, T, D]
    for (b, t, d), s_seq, i_seq, dtype in DROPOUT_SLICES:
        whole = torch.randn(b, t, d, generator=gen, device=DEVICE).to(dtype)
        tl = t // s_seq
        x = whole[:, i_seq * tl:(i_seq + 1) * tl].contiguous()
        off = 3 * t * d + i_seq * tl * d
        got = kd.keyed_dropout(x, key, DROPOUT_RATE, off, tl * d, t * d)
        bad += int((got != kd.keyed_dropout_reference(
            x, key, DROPOUT_RATE, off, tl * d, t * d)).sum())
        full = kd.keyed_dropout_reference(whole, key, DROPOUT_RATE, 3 * t * d)
        bad += int((got != full[:, i_seq * tl:(i_seq + 1) * tl]).sum())
    emit({"phase": "dropout_kernel", "rate": DROPOUT_RATE,
          "shapes": [[list(s), str(d), m] for s, d, m in cases],
          "offsets": list(offsets),
          "slices": [[list(sh), s_, i_, str(d)]
                     for sh, s_, i_, d in DROPOUT_SLICES],
          "elements_differing": bad, "graph_keys": 3})
    if bad:
        raise AssertionError(f"keyed dropout: {bad} elements differ from "
                             f"the plain version")
    return bad


def phase_timing_dropout(kd, gpu):
    """The keyed dropout kernel at shakespeare_char's residual ([64, 256,
    384] bf16; 13 sites a microbatch, each once forward and once
    backward, 6 once more in remat "full"'s recompute) beside its plain
    version (the hash in int64 PyTorch ops), its byte bound and the generator
    draw it replaced (``torch.rand`` under a seeded generator, then a
    ``where``: another mask, so not the library time of this function);
    device times from CUDA graphs. No PyTorch call computes this mask:
    library_ms is null."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    shape = (CHAR_TIMING["b"], CHAR_TIMING["t"], 384)
    # launches rotate over inputs past the L2 (a residual written by its
    # product is not all resident when its dropout reads it)
    xs = [torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)
          for _ in range(NORM_BUFS)]
    x = xs[0]
    key = torch.tensor(DROPOUT_KEY, dtype=torch.int64, device=DEVICE)
    keep = 1 - DROPOUT_RATE
    ms = device_ms(lambda i: kd.keyed_dropout(xs[i % NORM_BUFS], key,
                                              DROPOUT_RATE), reps=48)
    plain_ms = device_ms(lambda i: kd.keyed_dropout_reference(
        xs[i % NORM_BUFS], key, DROPOUT_RATE), reps=4)
    g2 = torch.Generator(device=DEVICE)

    def generator_draw(i):
        g2.manual_seed(SEED + i)
        m = torch.rand(shape, generator=g2, device=DEVICE) < keep
        return torch.where(m, x / keep, torch.zeros_like(x))

    gen_ms = eager_ms(generator_draw, reps=20)
    err = (kd.keyed_dropout(x, key, DROPOUT_RATE).float()
           - kd.keyed_dropout_reference(x, key, DROPOUT_RATE).float()
           ).abs().max().item()
    nbytes = 2 * x.numel() * x.element_size() + 8
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    rec = {"phase": "timing", "kernels": "keyed_dropout",
           "shape": list(shape), "dtype": "bfloat16", "rate": DROPOUT_RATE,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes", "bytes": nbytes, "frac_of_bound": bound / ms,
           "library_ms": None, "max_abs_err_vs_plain": err,
           "generator_draw_ms_eager": gen_ms,
           "sites_per_microbatch": 13,
           "per_microbatch_ms": {"launches": 32, "ms": 32 * ms,
                                 "plain_ms": 32 * plain_ms},
           "note": "per microbatch: 13 sites forward, 13 backward, the 6 "
                   "attention-output sites again in remat full's "
                   "recompute = 32 launches; inputs rotate over "
                   f"{NORM_BUFS} buffers",
           "gpu": gpu}
    emit(rec)
    return rec


def phase_flash_seed(fl) -> tp.Dict[str, tp.Any]:
    """The flash kernels read the dropout seed from device memory. (1) The
    forward's keep-mask, read off its output (q = 0, so every probability
    of a row is 1/T; non-causal; v = the identity, T = C = 64: out[i, j]
    is p M[i, j] / keep), at several heads and global anchors, equals
    the counter hash of the same seed (the masks the kernels drew with
    the seed by value: ``dropout_mask_reference`` was held to them bit
    for bit), in bf16 and f32; the hash of seed + 1 must differ. (2) The
    forward, dq and dk/dv with the seed as a tensor equal those with the
    seed as an int, bit for bit. (3) Captured into a CUDA graph, a replay
    after the seed tensor is rewritten draws the new seed's masks: the
    three kernels equal their eager launches at that seed."""
    t = c = 64
    b, h = 2, 3
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        q = torch.zeros(b, h, t, c, device=DEVICE, dtype=dtype)
        v = torch.eye(t, c, device=DEVICE, dtype=dtype).expand(
            b, h, t, c).contiguous()
        worst = 0
        for row_off, col_off, bh_off in ((0, 0, 0), (4096, 192, 7),
                                         (123457, 99991, 1 << 20)):
            seed = torch.tensor(FLASH_SEED & 0xFFFFFFFF, dtype=torch.int64,
                                device=DEVICE)
            drop = fl.Dropout(DROPOUT_RATE, seed, row_off, col_off, bh_off,
                              h)
            o, _ = fl.flash_fwd(q, q, v, False, drop)
            got = o != 0
            heads = (bh_off + torch.arange(b, device=DEVICE)[:, None] * h
                     + torch.arange(h, device=DEVICE)[None, :])
            ar = torch.arange(t, device=DEVICE)
            want = fl._keep_mask(FLASH_SEED, heads, row_off + ar,
                                 col_off + ar, 1 - DROPOUT_RATE)
            worst += int((got != want).sum())
            if torch.equal(got, fl._keep_mask(FLASH_SEED + 1, heads,
                                              row_off + ar, col_off + ar,
                                              1 - DROPOUT_RATE)):
                raise AssertionError("seed + 1 drew the same mask")
        out[f"mask_elements_differing_{str(dtype)[6:]}"] = worst
    # the seed as an int or as a tensor: the same bits
    b, t, h, hkv, c = 4, 256, 6, 6, 64
    q, k, v, dout = flash_inputs(b, t, h, hkv, c, torch.bfloat16, seed=7)
    s_t = torch.tensor(FLASH_SEED & 0xFFFFFFFF, dtype=torch.int64,
                       device=DEVICE)
    by_int = flash_run(fl, [q, k, v, dout], fl.Dropout(DROPOUT_RATE,
                                                       FLASH_SEED), True)
    by_tensor = flash_run(fl, [q, k, v, dout], fl.Dropout(DROPOUT_RATE, s_t),
                          True)
    out["int_vs_tensor_equal"] = all(bits_equal(a, b_)
                                     for a, b_ in zip(by_int, by_tensor))
    # a captured graph reads the current seed at each replay
    drop = fl.Dropout(DROPOUT_RATE, s_t)

    def three():
        o, lse = fl.flash_fwd(q, k, v, True, drop)
        dq, delta = fl.flash_bwd_dq_delta(q, k, v, dout, lse, o, None, True,
                                          drop)
        dk, dv = fl.flash_bwd_dkv(q, k, v, dout, lse, delta, True, drop)
        return o, dq, dk, dv

    three()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = three()
    replays_equal = []
    for seed in (FLASH_SEED, 5, 1 << 31):
        s_t.fill_(seed & 0xFFFFFFFF)
        graph.replay()
        eager = three()
        replays_equal.append(all(bits_equal(a, b_)
                                 for a, b_ in zip(static, eager)))
    out["graph_replays_equal_eager"] = replays_equal
    emit({"phase": "flash_seed", **out})
    if (any(v for k_, v in out.items() if k_.startswith("mask_"))
            or not out["int_vs_tensor_equal"] or not all(replays_equal)):
        raise AssertionError(f"flash seed by pointer: {out}")
    return out


# the train_window phase: each configuration through train() at K=1 and at
# K=4 over the same steps (every step logged: each window reads its
# stacked results once), one eval at the start, the save at the end
WINDOW_K = 4
WINDOW_RUNS = {
    "openwebtext": dict(TRAIN_SET, max_steps=12, eval_interval=12,
                        eval_batches=1, ckpt_interval=1000),
    "shakespeare_char": dict(CHAR_SET, max_steps=40, eval_interval=40,
                             eval_batches=2, ckpt_interval=1000),
    MOE_NAME: dict(MOE_SET, max_steps=8, eval_interval=8,
                   ckpt_interval=1000),
}
# model overrides of a train_window configuration: openwebtext (also the
# remat dots run) at a quarter of its depth (3 of 12 layers; full width),
# the MoE run at one of 12 (3 before the cut that made room for
# serve_tensor), which keeps chip_smoke's phases within 1000 s
# with the tensor phases (the window phases took 151 s at 6 layers on a
# slow host; the MoE's final save and program check at 12 layers 98 s)
WINDOW_MODEL = {"openwebtext": dict(n_layer=3), MOE_NAME: dict(n_layer=1)}
WINDOW_TIMING_STEPS = 8  # steps a timing turn (whole windows)


def window_data(tmp: str, name: str) -> str:
    """The data directory a train_window run reads: the char corpus of
    prepare.py --synthetic, or the Zipf stream."""
    from midgpt_tpu_torch.data import write_tokens

    data = os.path.join(tmp, "data_" + name)
    if os.path.exists(os.path.join(data, "val.bin")):
        return data
    if name == "shakespeare_char":
        repo = os.path.dirname(os.path.abspath(__file__))
        subprocess.run(
            [sys.executable,
             os.path.join(repo, "data", "shakespeare_char", "prepare.py"),
             "--synthetic", "--out_dir", data],
            check=True, capture_output=True, text=True, timeout=300)
    else:
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
    return data


def train_kernels():
    """Every counted kernel a train step may launch."""
    from midgpt_tpu_torch.ops import dropout as kd
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa
    from midgpt_tpu_torch.ops import fused_norm as fn

    return {"flash_fwd": fl.flash_fwd, "flash_bwd_dq": fl.flash_bwd_dq,
            "flash_bwd_dkv": fl.flash_bwd_dkv,
            "fused_fwd": fa.fused_attention_fwd,
            "fused_bwd": fa.fused_attention_bwd,
            "fused_bwd_prep": fa.fused_attention_bwd_prep,
            "fused_bwd_dq": fa.fused_attention_bwd_dq,
            "fused_bwd_dkv": fa.fused_attention_bwd_dkv,
            "rms_norm_fwd": fn.fused_rms_norm_fwd,
            "rms_norm_bwd": fn.fused_rms_norm_bwd,
            "keyed_dropout": kd.keyed_dropout}


def window_train(tmp: str, name: str, k: int, run: str = "",
                 remat: tp.Optional[str] = None, **extra):
    """``train()`` of a train_window configuration at K = ``k`` in the run
    directory ``run`` (default: one of its own), ``remat`` in place of
    the configuration's: the config and a record of the final metrics,
    every logged step's (loss, grad norm, lr), the launches, the run's
    peak bytes and its rates."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.utils.metrics import read_metrics

    over = dict(WINDOW_RUNS[name], **extra)
    rundir = os.path.join(tmp, run or f"{name}_k{k}_{remat}")
    cfg = get_config(name, rundir=rundir, data_dir=window_data(tmp, name),
                     seed=SEED, steps_per_dispatch=k, **over)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **WINDOW_MODEL.get(name, {}),
        **({} if remat is None else {"remat": remat})))
    (final, wall, peak, held), _, launches = counted(
        train_kernels(), lambda: train_measured(cfg))
    rows = read_metrics(rundir)
    logged = {r["step"]: (r["loss/optimized"], r["grad_norm"], r["lr"])
              for r in rows if "loss/optimized" in r}
    rates = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r
             and r["step"] >= final["first_step"]]
    tokens = cfg.batch_size * cfg.model.block_size
    steps = cfg.max_steps - final["first_step"]
    steps_s = (final["loop_s"] - final["eval_s"] - final["ckpt_s"]
               - final["ckpt_wait_s"])
    # the first window holds the warm-up step and the capture (the first
    # two at K=1)
    steady = rates[1:] if k > 1 else rates[2:]
    return cfg, {
        "k": k, "remat": final["remat"], "dispatches":
        final["train_dispatches"], "first_step": final["first_step"],
        "losses": final["losses"], "val_loss": final["val_loss"],
        "logged": logged, "launches": launches, "wall_s": wall,
        "loop_s": final["loop_s"], "eval_s": final["eval_s"],
        "ckpt_s": final["ckpt_s"], "ckpt_wait_s": final["ckpt_wait_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "tokens_per_s_steps_only": tokens * steps / steps_s,
        "tokens_per_s_median_after_capture": (statistics.median(steady)
                                              if steady else None),
        "step_ms_median_after_capture": (1e3 * tokens
                                         / statistics.median(steady)
                                         if steady else None),
        **memory_fields(cfg, final["remat"], peak, held)}


def program_check(cfg, k: int) -> tp.Dict[str, tp.Any]:
    """One program of depth ``k`` for ``cfg`` driven by hand, the way
    ``train()`` drives it, on a Zipf batch window: the warm-up and the
    capture (capture ms, graph pool bytes, launches a replay); one step
    replayed and then run eagerly from the same state (masters, moments,
    loss, grad norm and lr bit for bit); the aten ops between the copies
    and the read (none: the replays) and those of the copies; then in
    turns (graph, eager, eager, graph) ``WINDOW_TIMING_STEPS`` steps in
    windows of ``k`` (copies, ``k`` runs, the read): host ms a step, beside
    the device ms of one replay between CUDA events and the eager body's
    device busy ms (torch.profiler), and the idle shares; the peak bytes
    (warm-up, capture and replays) beside ``card_peak_bytes``."""
    from torch.profiler import ProfilerActivity, profile

    from midgpt_tpu_torch.serving.programs import pool_bytes
    from midgpt_tpu_torch.train import (
        card_peak_bytes, effective_loss_chunk, init_state, make_lr_schedule,
        make_shadow, step_body, step_keys, step_scalars)
    from midgpt_tpu_torch.train_programs import StepProgram

    held = held_bytes()
    torch.cuda.reset_peak_memory_stats()
    g, b, t = cfg.g_accum_iters, cfg.microbatch_size, cfg.model.block_size
    toks = zipf_tokens(k * g * b * (t + 1), SEED + 6).astype(np.int64)
    toks = torch.from_numpy(toks % cfg.model.vocab_size).to(DEVICE)
    toks = toks.view(k, g, b, t + 1)
    xs, ys = toks[..., :-1].contiguous(), toks[..., 1:].contiguous()
    state = init_state(cfg, DEVICE)
    shadow = make_shadow(state.model, torch.bfloat16)
    prog = StepProgram(cfg, DEVICE, k)
    prog.bind(state)
    sched, chunk = make_lr_schedule(cfg), effective_loss_chunk(cfg)
    step = [0]

    def body():
        step_body(prog, state, shadow, cfg, chunk)

    def free():
        for p in shadow.parameters():
            p.grad = None
        gc.collect()
        torch.cuda.empty_cache()

    def load(start=0):
        prog.load(step_scalars(cfg, sched, step[0], state.step, k),
                  step_keys(cfg, step[0], k), xs, ys, start)

    def window(run):
        load()
        for _ in range(k):
            run()
        rows = prog.read(k)
        state.step += k
        step[0] += k
        return rows

    graphed = lambda: prog.run(body, free)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = window(graphed)  # the warm-up step, the capture, replays
    first_ms = 1e3 * (time.perf_counter() - t0)
    if k == 1:
        window(graphed)  # the capture at K=1
    peak = torch.cuda.max_memory_allocated() - held
    pool = pool_bytes(prog.pool)
    # a replay against the eager body from one state
    tensors = list(state.model.parameters()) + state.mu + state.nu
    start = [x.clone() for x in tensors]
    load()
    prog.run(body, free)
    out_graph = prog.out[0].clone()
    after = [x.clone() for x in tensors]
    with torch.no_grad():
        for x, s in zip(tensors, start):
            x.copy_(s)
    load()
    body()  # the eager twin: the same body on the same static inputs
    same = {"out": bits_equal(out_graph, prog.out[0]),
            "masters_and_moments": all(bits_equal(a, x_)
                                       for a, x_ in zip(after, tensors))}
    del start, after
    if not all(same.values()):
        raise AssertionError(f"{cfg.model}: a replay differs from the eager "
                             f"body: {same}")
    # aten ops of a window's copies, and between them and the read
    torch.cuda.synchronize()
    load_ops = aten_ops(load)
    run_ops = aten_ops(lambda: [graphed() for _ in range(k)])
    prog.read(k)
    if run_ops:
        raise AssertionError(f"{run_ops} aten ops between the copies and the "
                             f"read")
    # host ms a step, in turns
    host = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        run = graphed if mode == "graph" else body
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(WINDOW_TIMING_STEPS // k):
            window(run)
        host[mode].append(1e3 * (time.perf_counter() - t0)
                          / (WINDOW_TIMING_STEPS // k * k))
    # device ms of one replay between CUDA events
    times = []
    for _ in range(5):
        load()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        prog.graph.replay()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    replay_ms = statistics.median(times)

    def busy(run) -> float:
        load()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(k):
                run()
            torch.cuda.synchronize()
        return sum(e_.self_device_time_total for e_ in prof.key_averages()
                   if str(e_.device_type).endswith("CUDA")) / 1e3 / k

    eager_busy = busy(body)
    graph_busy = busy(graphed)
    g_host = statistics.median(host["graph"])
    e_host = statistics.median(host["eager"])
    name = lambda d: {f.__name__: n for f, n in d.items()}  # noqa: E731
    est = card_peak_bytes(cfg)["peak"]
    rec = {"k": k, "remat": cfg.model.remat, "bit_equal": same,
           "first_window_ms": first_ms, "first_window_losses": first[:, 0]
           .tolist(), "capture_ms": prog.capture_ms,
           "graph_pool_bytes": pool,
           "replay_launches": name(prog.replay_launches),
           "aten_ops_copies": load_ops, "aten_ops_between_copies_and_read":
           run_ops, "host_ms_per_step": g_host,
           "host_ms_each": host["graph"], "eager_host_ms_per_step": e_host,
           "eager_host_ms_each": host["eager"],
           "device_ms_replay_events": replay_ms,
           "device_busy_ms_profiler": graph_busy,
           "eager_device_busy_ms_profiler": eager_busy,
           "idle_share": 1.0 - replay_ms / g_host,
           "eager_idle_share": 1.0 - eager_busy / e_host,
           "eager_over_graph_host": e_host / g_host,
           "peak_bytes": peak, "card_peak_bytes": est,
           "estimate_over_peak": est / peak, "c4_band": list(C4_BAND),
           "in_c4_band": C4_BAND[0] <= est / peak <= C4_BAND[1]}
    prog.release()
    del state, shadow, prog
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def phase_train_window(gpu):
    """The trainer's dispatch programs at full width (see the module
    docstring). Returns the launches of the char runs."""
    import dataclasses

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in WINDOW_RUNS:
            runs = {}
            for k in (1, WINDOW_K):
                cfg, runs[k] = window_train(tmp, name, k)
                gc.collect()
                torch.cuda.empty_cache()
            a, b = runs[1], runs[WINDOW_K]
            n = cfg.max_steps
            if a["logged"] != b["logged"] or sorted(a["logged"]) != list(
                    range(1, n)):
                raise AssertionError(f"{name}: K=1 and K={WINDOW_K} logged "
                                     f"other steps or other numbers")
            if a["losses"] != b["losses"] or a["val_loss"] != b["val_loss"]:
                raise AssertionError(f"{name}: K=1 and K={WINDOW_K} losses "
                                     f"differ")
            if (a["dispatches"], b["dispatches"]) != (n, -(-n // WINDOW_K)):
                raise AssertionError(f"{name}: dispatches "
                                     f"{a['dispatches']}, {b['dispatches']}")
            if a["launches"] != b["launches"] or not any(
                    a["launches"].values()):
                raise AssertionError(f"{name}: launches {a['launches']} vs "
                                     f"{b['launches']}")
            if not all(np.isfinite(a["losses"])):
                raise AssertionError(f"{name}: losses {a['losses']}")
            resolved = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, remat=a["remat"]))
            progs = {k: program_check(resolved, k)
                     for k in (1, WINDOW_K)}
            out[name] = {"train": runs, "programs": progs,
                         "k4_over_k1_device_ms": (
                             progs[WINDOW_K]["device_ms_replay_events"]
                             / progs[1]["device_ms_replay_events"])}
            emit({"phase": "train_window", "config": name,
                  "overrides": WINDOW_RUNS[name],
                  "model_overrides": WINDOW_MODEL.get(name, {}),
                  **{k_: v for k_, v in out[name].items() if k_ != "train"},
                  "train": {k: {k_: v for k_, v in r.items()
                                if k_ != "logged"} for k, r in runs.items()},
                  "gpu": gpu})
        # a resume mid-window: K=4 to step 6 (windows of 4 and 2), then on
        # to 12 from a short first window (2, then 4), against the
        # uninterrupted K=1 run's first 12 steps
        name = "shakespeare_char"
        ref = out[name]["train"][1]
        _, part = window_train(tmp, name, WINDOW_K, run="resume",
                               max_steps=6)
        _, rest = window_train(tmp, name, WINDOW_K, run="resume",
                               max_steps=12)
        resume = {"part_dispatches": part["dispatches"],
                  "rest_dispatches": rest["dispatches"],
                  "rest_first_step": rest["first_step"],
                  "losses_equal": part["losses"] + rest["losses"]
                  == ref["losses"][:12],
                  "logged_equal": rest["logged"] == {
                      s: v for s, v in ref["logged"].items() if s < 12}}
        emit({"phase": "train_window_resume", "config": name, **resume,
              "gpu": gpu})
        if not (resume["losses_equal"] and resume["logged_equal"]
                and (part["dispatches"], rest["dispatches"],
                     rest["first_step"]) == (2, 2, 6)):
            raise AssertionError(f"resume mid-window: {resume}")
        # remat "dots", graphed: train's configuration at K=1 and K=4,
        # and its program beside the eager body
        name = "openwebtext"
        dots = {}
        for k in (1, WINDOW_K):
            cfg, dots[k] = window_train(tmp, name, k, remat="dots")
            gc.collect()
            torch.cuda.empty_cache()
        if dots[1]["logged"] != dots[WINDOW_K]["logged"]:
            raise AssertionError("dots: K=1 and K=4 logged other numbers")
        prog = program_check(cfg, 1)
        for r in dots.values():
            del r["logged"]
        out["dots"] = {"train": dots, "program": prog}
        emit({"phase": "train_window_dots", "config": name,
              "overrides": WINDOW_RUNS[name], **out["dots"], "gpu": gpu})
    return out


# -- the data-parallel / FSDP trainer (parallel/, launch --multihost) ------


def torchrun(nproc: int, args: tp.Sequence[str], timeout: float,
             module: bool = True) -> tp.Tuple[str, float]:
    """``python -m torch.distributed.run --standalone
    --nproc_per_node=nproc`` of the launcher module (or of this script
    with ``args``) from the checkout's root: its stdout and wall
    seconds; a failed run raises with the tail of both streams."""
    repo = os.path.dirname(os.path.abspath(__file__))
    target = (["-m", "midgpt_tpu_torch.launch"] if module
              else [os.path.abspath(__file__)])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", *target, *args]
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                          env=env, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)}: rc {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout, wall


def launched_final(stdout: str) -> tp.Dict[str, tp.Any]:
    """The launcher's ``final:`` line (rank 0's)."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("final:")]
    if len(lines) != 1:
        raise AssertionError(f"{len(lines)} final lines: {stdout[-2000:]}")
    return json.loads(lines[0][len("final:"):])


def logged_numbers(rundir: str) -> tp.Dict[tp.Tuple[int, str], float]:
    """Every ``MESH_KEYS`` number a run logged, by (step, key); a number
    logged twice (a resume's first eval repeats the last launch's final
    one) must agree."""
    from midgpt_tpu_torch.utils.metrics import read_metrics

    out: tp.Dict[tp.Tuple[int, str], float] = {}
    for r in read_metrics(rundir):
        for k in MESH_KEYS:
            if k in r:
                if out.setdefault((r["step"], k), r[k]) != r[k]:
                    raise AssertionError(f"step {r['step']} {k} logged as "
                                         f"{out[(r['step'], k)]} and {r[k]}")
    return out


def step_rates(rundir: str, skip_from: tp.Sequence[int]) -> tp.List[float]:
    """Per-step tokens/s logged by a run, less the first two steps of each
    launch starting at a step in ``skip_from`` (the warm-up and the
    capture)."""
    from midgpt_tpu_torch.utils.metrics import read_metrics

    skip = {s + i for s in skip_from for i in (0, 1)}
    return [r["tokens_per_sec"] for r in read_metrics(rundir)
            if "tokens_per_sec" in r and r["step"] not in skip]


def mesh_cfg(**kw):
    import dataclasses

    from midgpt_tpu_torch.config import get_config

    cfg = get_config(MESH_CONFIG, seed=SEED, **dict(MESH_SET, **kw))
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, **MESH_MODEL))


def mesh_steps_worker(out_path: str, device: str, name: str,
                      axis: str = "fsdp") -> int:
    """The two-card checks' runner, one rank of ``torch.distributed.run``
    (``chip_smoke.py --mesh-steps OUT DEVICE CONFIG [AXIS]``):
    ``MESH_STEPS`` steps of ``name`` (full width, remat "none", seeded
    init) on Zipf global batches under a mesh of every rank on ``axis``:
    ``fsdp`` (``fsdp=-1``: this rank's rows of each batch),
    ``sequence`` (``fsdp=1, sequence=-1``, attn_impl "ring": this rank's
    columns of every row) or ``tensor`` (``fsdp=1, tensor=-1``: every
    rank the whole batch and its tensor shard of the model) or
    ``pipeline`` (``fsdp=1, pipeline=-1``: every rank the whole batch
    and its stage of the model); rank 0 writes the losses and grad norms
    to ``out_path``."""
    import dataclasses

    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig, get_config
    from midgpt_tpu_torch.launch import init_multihost
    from midgpt_tpu_torch.parallel import batch_rows, create_mesh, seq_cols
    from midgpt_tpu_torch.train import (
        bind_mesh, effective_loss_chunk, init_sharded_state,
        make_lr_schedule, train_step)
    from midgpt_tpu_torch.utils.platform import local_rank, resolve_device

    if device == "cuda" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    rank = init_multihost(device)
    try:
        cfg = get_config(name, seed=SEED, device=device,
                         **{k: MESH_SET[k] for k in ("batch_size",
                                                     "g_accum_iters")})
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, remat="none",
            attn_impl="ring" if axis == "sequence" else cfg.model.attn_impl))
        if axis in ("sequence", "tensor", "pipeline"):
            cfg = dataclasses.replace(cfg, mesh=MeshConfig(
                fsdp=1, **{axis: -1}))
        mesh = create_mesh(cfg.mesh)
        dev = resolve_device(device, local_rank())
        state = init_sharded_state(cfg, mesh, dev)
        g, b, t = (cfg.g_accum_iters, cfg.microbatch_size,
                   cfg.model.block_size)
        toks = zipf_tokens(MESH_STEPS * g * b * (t + 1), SEED + 7)
        toks = torch.from_numpy(toks.astype(np.int64)
                                % cfg.model.vocab_size)
        toks = toks.view(MESH_STEPS, g, b, t + 1)
        rows, cols = batch_rows(b, mesh), seq_cols(t, mesh)
        bind_mesh(state.shadow, mesh, rows.start)
        sched = make_lr_schedule(cfg)
        chunk = effective_loss_chunk(cfg, mesh)
        out = {"world": mesh.world, "sizes": list(mesh.sizes), "loss": [],
               "grad_norm": []}
        for s in range(MESH_STEPS):
            x = toks[s, :, rows, :-1][..., cols].contiguous().to(dev)
            y = toks[s, :, rows, 1:][..., cols].contiguous().to(dev)
            loss, norm = train_step(state, state.shadow, x, y, cfg,
                                    sched(s), chunk)
            out["loss"].append(float(loss))
            out["grad_norm"].append(float(norm))
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()
    return 0


def two_card_check(axis: str, device: str = "cuda",
                   name: str = MESH_CONFIG) -> tp.Dict[str, tp.Any]:
    """Where two cards are, ``torch.distributed.run`` of
    ``--mesh-steps`` at worlds 1 and 2 on ``axis`` (``fsdp``,
    ``sequence`` with ring attention, ``tensor`` or ``pipeline``) on the
    same global batches: both
    runs and the largest relative difference of their losses and grad
    norms; with one card, why it was not made. ``device="cpu"``
    rehearses it on the CPU."""
    if device == "cuda" and torch.cuda.device_count() < 2:
        return {"made": False, "axis": axis, "why": (
            f"torch.cuda.device_count() = {torch.cuda.device_count()}: "
            f"NCCL runs one rank a card, so a world of two needs two "
            f"cards")}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, 2):
            out = os.path.join(tmp, f"w{n}.json")
            torchrun(n, ["--mesh-steps", out, device, name, axis],
                     timeout=300, module=False)
            with open(out) as f:
                runs[n] = json.load(f)
    rel = max(abs(a - b) / abs(b) for k in ("loss", "grad_norm")
              for a, b in zip(runs[2][k], runs[1][k]))
    return {"made": True, "axis": axis, "runs": runs, "max_rel_diff": rel,
            "rtol": MESH_TWO_CARD_RTOL}


def tensor_all_reduces(cfg) -> int:
    """All-reduces one step of ``cfg`` makes on a one-rank mesh, where
    the model's tensor sums run as one-rank all-reduces: per microbatch
    the embedding's sum, each layer's two row-parallel sums and its
    column-parallel gradient sums (attention's input, the MLP's, an MoE's
    gates too), a checkpointed block's attention sum again in the
    backward (the recompute stops at the block's last saved tensor,
    before the MLP's sum), and a loss chunk's head input gradient sum and
    three (max, exp sum, target logit), again in a chunk's recompute; per
    step the QK-norms' gradient sum, the grad norm and the mean loss."""
    from midgpt_tpu_torch.train import effective_loss_chunk

    m = cfg.model
    chunk = effective_loss_chunk(cfg)
    chunks = m.block_size // chunk if chunk else 1
    layer = 4 + (m.mlp == "moe") + (m.remat in ("dots", "full"))
    micro = (1 + m.n_layer * layer
             + chunks * (1 + 3 * (2 if chunk else 1)))
    return cfg.g_accum_iters * micro + int(m.qk_norm) + 2


def phase_train_mesh(gpu):
    """The data-parallel / FSDP trainer at world 1 on this card, through
    the launcher under torch.distributed.run (see the module docstring)."""
    from midgpt_tpu_torch.parallel.mesh import Mesh
    from midgpt_tpu_torch.train import card_peak_bytes

    rec: tp.Dict[str, tp.Any] = {"phase": "train_mesh", "config":
                                 MESH_CONFIG, "overrides": MESH_SET,
                                 "model_overrides": MESH_MODEL}
    with tempfile.TemporaryDirectory() as tmp:
        data = window_data(tmp, MESH_CONFIG)
        # the single-card trainer (no process group) on the same batches
        one = os.path.join(tmp, "one")
        cfg = mesh_cfg(rundir=one, data_dir=data)
        (final1, wall1, peak1, held1), _, launches1 = counted(
            train_kernels(), lambda: train_measured(cfg))
        ref = logged_numbers(one)
        # world 1 over NCCL: MESH_PART steps, then a resume to max_steps
        run = os.path.join(tmp, "mesh")
        sets = [f"{k}={json.dumps(v)}" for k, v in MESH_SET.items()
                if k != "max_steps"]
        sets += [f"data_dir={data}", f"seed={SEED}", "mesh.fsdp=-1"]
        sets += [f"model.{k}={json.dumps(v)}" for k, v in MESH_MODEL.items()]
        parts = []
        for max_steps in (MESH_PART, MESH_SET["max_steps"]):
            stdout, wall = torchrun(1, ["--multihost", "--config",
                                        MESH_CONFIG, "--rundir",
                                        run, "--set", *sets,
                                        f"max_steps={max_steps}"],
                                    timeout=300)
            parts.append((launched_final(stdout), wall))
        got = logged_numbers(run)
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        rates1 = step_rates(one, (0,))
        rates_m = step_rates(run, (0, MESH_PART))
    (f_a, wall_a), (f_b, wall_b) = parts
    collectives = {k: v for k, v in f_b["replay_launches"].items()
                   if k.startswith("sharding.")}
    kernels = {k: v for k, v in f_b["replay_launches"].items()
               if not k.startswith("sharding.")}
    mesh1 = Mesh(rank=0, world=1, sizes=(1, 1, 1, 1, 1), distributed=True)
    est = card_peak_bytes(cfg, "none", mesh1)
    peaks = [f.get("max_memory_allocated", 0) for f in (f_a, f_b)]
    fwd = "fused_attn.fused_attention_fwd"
    bwd = "fused_attn.fused_attention_bwd"
    mesh_launches = {k: f_a["launches"].get(k, 0) + f_b["launches"].get(k, 0)
                     for k in (fwd, bwd)}
    # the first launch's final eval (one batch of G microbatches) is the
    # only work the single-card run does not do
    nl, g = cfg.model.n_layer, cfg.g_accum_iters
    want = {fwd: launches1["fused_fwd"] + nl * g * MESH_SET["eval_batches"],
            bwd: launches1["fused_bwd"]}
    tokens = cfg.batch_size * cfg.model.block_size
    med1, med_m = statistics.median(rates1), statistics.median(rates_m)
    rec.update({
        "launch": "python -m torch.distributed.run --standalone "
                  "--nproc_per_node=1 -m midgpt_tpu_torch.launch "
                  f"--multihost --config {MESH_CONFIG} --set mesh.fsdp=-1 ...",
        "backend": "nccl", "world": 1,
        "parts": [{"max_steps": m, "first_step": f["first_step"],
                   "wall_s": w, "loop_s": f["loop_s"],
                   "tokens_per_s": f["tokens_per_sec"],
                   "train_dispatches": f["train_dispatches"]}
                  for m, (f, w) in zip((MESH_PART, MESH_SET["max_steps"]),
                                       parts)],
        "checkpoints": ckpts,
        "logged_equal_bit_for_bit": got == ref,
        "logged_numbers": len(ref),
        "first_differing": sorted(k for k in ref if got.get(k) != ref[k])[:4],
        "collective_launches_a_step": collectives,
        "kernel_launches_a_step": kernels,
        "fused_launches": mesh_launches, "fused_launches_expected": want,
        "step_ms_median": 1e3 * tokens / med_m,
        "tokens_per_s_median": med_m,
        "single_card": {"step_ms_median": 1e3 * tokens / med1,
                        "tokens_per_s_median": med1, "wall_s": wall1,
                        "loop_s": final1["loop_s"],
                        "peak_bytes": peak1, "held_before_bytes": held1},
        "step_ms_over_single_card": med1 / med_m,
        "max_memory_allocated": peaks,
        "card_peak_bytes_mesh": est["peak"], "card_peak_terms": est,
        "estimate_over_peak": est["peak"] / max(max(peaks), 1),
        "gpu": gpu})
    rec["two_card"] = two = two_card_check("fsdp")
    emit(rec)
    if not rec["logged_equal_bit_for_bit"]:
        raise AssertionError(f"train_mesh: logged numbers differ from the "
                             f"single-card run at {rec['first_differing']}")
    if (parts[1][0]["first_step"], ckpts) != (
            MESH_PART, [f"step_{MESH_SET['max_steps'] - 1:08d}.pt"]):
        raise AssertionError(f"train_mesh: resume {parts[1][0]['first_step']}"
                             f", checkpoints {ckpts}")
    if (collectives.get("sharding.all_gather") != 1
            or collectives.get("sharding.reduce_scatter") != 1
            or collectives.get("sharding.all_reduce")
            != tensor_all_reduces(cfg) or not kernels):
        raise AssertionError(f"train_mesh: a replay launched {collectives} "
                             f"and {kernels}")
    if mesh_launches != want:
        raise AssertionError(f"train_mesh: fused launches {mesh_launches} "
                             f"!= {want}")
    if two["made"] and two["max_rel_diff"] > MESH_TWO_CARD_RTOL:
        raise AssertionError(f"train_mesh: two cards vs one {two}")
    return rec


# -- sequence parallelism: ring attention and Ulysses -------------------------


def ring_call(impl: str, schedule: str, s: int, rate: float, args,
              active=None, plain: bool = False):
    """``(out, dq, dk, dv)`` of one attention over the whole T of ``args``
    (q, k, v, dO) through ring attention (``schedule``) or Ulysses on a
    loopback exchange of ``s`` virtual ranks (``active``: the ones that
    compute; default all), forward and backward, every pair through the
    flash kernels (``plain``: the ring through their plain versions)."""
    from midgpt_tpu_torch.parallel import (
        LoopbackExchange, ring_attention, sequence_chunks, ulysses_attention)

    q, k, v, dout = args
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    ex = LoopbackExchange(s, active)
    chunks = [sequence_chunks(x, s) for x in leaves]
    kw = dict(dropout_rate=rate, dropout_seed=RING_SEED if rate else None)
    if impl == "ulysses":
        outs = ulysses_attention(*chunks, ex, **kw)
    else:
        outs = ring_attention(*chunks, ex, schedule=schedule, plain=plain,
                              **kw)
    out = torch.cat(outs, 2)
    return (out, *torch.autograd.grad(out, leaves, dout))


def plain_whole(fl, args, rate: float, seed: int):
    """``(out, dq, dk, dv)`` of the plain flash versions over the whole T
    (one call, its dropout mask at ``seed``), in the inputs' dtype; dk and
    dv summed over each kv group."""
    q, k, v, dout = args
    drop = fl.Dropout(rate, seed) if rate else None
    out, lse = fl.flash_forward_reference(q, k, v, True, drop)
    delta = fl.delta_reference(dout, out)
    dq = fl.flash_backward_dq_reference(q, k, v, dout, lse, delta, True, drop)
    dk, dv = fl.flash_backward_dkv_reference(q, k, v, dout, lse, delta, True,
                                             drop)
    b, h, t, c = q.shape
    hkv = k.shape[1]
    if hkv != h:
        dk, dv = (x.float().reshape(b, hkv, h // hkv, t, c).sum(2).to(x.dtype)
                  for x in (dk, dv))
    return out, dq, dk, dv


def graph_ms(fn, reps: int = RING_REPS, rounds: int = 3) -> float:
    """Device ms of one ``fn()`` (a forward and its backward): ``reps``
    calls captured in one CUDA graph (thread-local capture: autograd
    launches the backward from its own thread), replayed ``rounds``
    times between CUDA events; the median per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def flash_counts(fl) -> tp.Dict[str, int]:
    return {n: getattr(fl, n).launches
            for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}


def phase_ring(fl, gpu):
    """Ring attention (standard and zigzag) and Ulysses on one card over
    the loopback exchange (see the module docstring); returns the flash
    kernels' launches summed over the cases' checked bf16 runs."""
    up = lambda a: [x.float() for x in a]  # noqa: E731
    totals = {n: 0 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    for (name, b, h, hkv, t, c, impl, schedule, s, rate) in RING_CASES:
        args = flash_inputs(b, t, h, hkv, c, torch.bfloat16, seed=SEED + s)
        before = flash_counts(fl)
        got = ring_call(impl, schedule, s, rate, args)
        torch.cuda.synchronize()
        after = flash_counts(fl)
        for n in totals:
            totals[n] += after[n] - before[n]
        ref32 = plain_whole(fl, up(args), rate, RING_SEED)
        # the plain bf16 version of the same work: the ring through the
        # kernels' plain versions (Ulysses: one plain call, since its
        # all-to-alls only move data)
        plain = (plain_whole(fl, args, rate, RING_SEED) if impl == "ulysses"
                 else ring_call(impl, schedule, s, rate, args, plain=True))
        whole = plain_whole(fl, args, rate, RING_SEED)
        names = ("out", "dq", "dk", "dv")
        own = [(p.float() - r).abs().max().item()
               for p, r in zip(plain, ref32)]
        one = [(p.float() - r).abs().max().item()
               for p, r in zip(whole, ref32)]
        dist_ = [(g.float() - r).abs().max().item()
                 for g, r in zip(got, ref32)]
        sound = {n: d / (2 * o) for n, d, o in zip(names, dist_, own)}
        rec = {"phase": "ring", "geometry": name, "B": b, "H": h, "Hkv": hkv,
               "T": t, "C": c, "impl": impl, "schedule": schedule, "S": s,
               "rate": rate, "seed": RING_SEED if rate else None,
               "dtype": "bfloat16",
               "rule": "max |loopback - plain f32 whole T| <= 2 x max "
                       "|plain bf16 of the same work - plain f32 whole T| "
                       "(ring: the loopback through the plain versions; "
                       "Ulysses: one plain call), and <= "
                       f"{RING_ONE_CALL_LIMIT} x 2 x max |one plain bf16 "
                       "call over the whole T - plain f32 whole T|; the "
                       "loopback on the f32 inputs within 1e-5 + rel x "
                       "|plain f32 whole T| per element, rel 1e-5 (out) / "
                       "1e-4 (dq, dk, dv)",
               "sound_err_over_limit": sound,
               "max_abs_err_vs_plain_f32": dict(zip(names, dist_)),
               "plain_bf16_vs_plain_f32": dict(zip(names, own)),
               "err_over_one_plain_bf16_call": {
                   n: d / (2 * o) for n, d, o in zip(names, dist_, one)},
               "one_call_limit": RING_ONE_CALL_LIMIT,
               "flash_launches": {n: after[n] - before[n] for n in totals}}
        # the same work in f32 through the kernels, held by the flash
        # phases' f32 rule to the plain f32 call: it sees a fault in the
        # code the ring shares with its plain version far below bf16's
        # rounding
        got32 = ring_call(impl, schedule, s, rate, up(args))
        rec["f32_err_over_limit"] = f32 = {
            n: ((g - r).abs() / (1e-5 + rel * r.abs())).max().item()
            for n, g, r, rel in zip(names, got32, ref32,
                                    (1e-5, 1e-4, 1e-4, 1e-4))}
        if not all(torch.isfinite(x).all() for x in got):
            raise AssertionError(f"ring: non-finite output {rec}")
        bad = [n for n, x in sound.items() if not x <= 1.0]
        bad += [f"{n} (one call)"
                for n, x in rec["err_over_one_plain_bf16_call"].items()
                if not x <= RING_ONE_CALL_LIMIT]
        bad += [f"{n} (f32)" for n, x in f32.items() if not x <= 1.0]
        if bad:
            emit(rec)
            raise AssertionError(f"ring: {name} {impl} {schedule} S={s} "
                                 f"rate={rate} disagrees with one plain "
                                 f"call over the whole T: {bad}")
        # the rule refuses a fault: with dropout the plain f32 call of seed
        # + 1 (the mask is the single call's), else k and v one row off
        if rate:
            fault = "seed + 1"
            fref = plain_whole(fl, up(args), rate, RING_SEED + 1)
            one = fl.flash_attention_dropout(*args[:3], RING_SEED, rate)
            rec["max_abs_diff_vs_single_flash_call"] = (
                one.float() - got[0].float()).abs().max().item()
        else:
            fault = "k, v shifted one row"
            fref = plain_whole(fl, up([args[0], *(torch.roll(a, 1, 2)
                                                  for a in args[1:3]),
                                       args[3]]), rate, RING_SEED)
        faulted = {n: (g.float() - r).abs().max().item() / (2 * o)
                   for n, g, r, o in zip(names, got, fref, own)}
        rec.update({"fault": fault, "fault_err_over_limit": faulted})
        missed = [n for n, x in faulted.items() if not x > 1.0]
        if missed:
            emit(rec)
            raise AssertionError(f"ring: the check passes a fault ({fault}, "
                                 f"{name} {impl} S={s}): {missed}")
        # each virtual rank's work alone: its flash launches and device ms
        per_rank = []
        for d in range(s):
            before = flash_counts(fl)
            ring_call(impl, schedule, s, rate, args, active=(d,))
            torch.cuda.synchronize()
            after = flash_counts(fl)
            ms = graph_ms(lambda: ring_call(impl, schedule, s, rate, args,
                                            active=(d,)))
            per_rank.append({"rank": d, "ms": ms, "flash_launches": {
                n: after[n] - before[n] for n in totals}})
        rank_ms = [r["ms"] for r in per_rank]
        total_ms = graph_ms(lambda: ring_call(impl, schedule, s, rate, args))

        def one_call():
            leaves = [x.detach().requires_grad_() for x in args[:3]]
            out = (fl.flash_attention_dropout(*leaves, RING_SEED, rate)
                   if rate else fl.flash_attention(*leaves))
            torch.autograd.grad(out, leaves, args[3])

        flash_ms = graph_ms(one_call)
        rec.update({"per_virtual_rank": per_rank,
                    "max_over_min_rank_ms": max(rank_ms) / min(rank_ms),
                    "loopback_total_ms": total_ms,
                    "one_flash_call_ms": flash_ms,
                    "loopback_over_one_call": total_ms / flash_ms,
                    "ms_is": "device ms of a forward and its backward "
                             "(CUDA graph replay between CUDA events)",
                    "gpu": gpu})
        emit(rec)
        gc.collect()
        torch.cuda.empty_cache()
    return totals


def seq_cfg(impl: str, **kw):
    """train_mesh's configuration (openwebtext, ``MESH_MODEL``) with
    ``attn_impl=impl``."""
    import dataclasses

    cfg = mesh_cfg(**kw)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, attn_impl=impl))


def phase_train_sequence(gpu):
    """``train()`` on the one-rank mesh with attn_impl ring and ulysses
    against flash (see the module docstring)."""
    rec: tp.Dict[str, tp.Any] = {"phase": "train_sequence",
                                 "config": MESH_CONFIG,
                                 "overrides": MESH_SET,
                                 "model_overrides": MESH_MODEL,
                                 "gpu": gpu}
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = window_data(tmp, MESH_CONFIG)
        for impl in SEQ_IMPLS:
            run = os.path.join(tmp, impl)
            cfg = seq_cfg(impl, rundir=run, data_dir=data)
            (final, wall, peak, held), _, launches = counted(
                train_kernels(), lambda: train_measured(cfg))
            tokens = cfg.batch_size * cfg.model.block_size
            rates = step_rates(run, (0,))
            runs[impl] = {
                "logged": logged_numbers(run), "wall_s": wall,
                "loop_s": final["loop_s"],
                "launches": {k: v for k, v in launches.items() if v},
                "replay_launches": final.get("replay_launches", {}),
                "step_ms_median": 1e3 * tokens / statistics.median(rates),
                "peak_bytes": peak}
    ref = runs["flash"]["logged"]
    for impl in SEQ_IMPLS:
        r = runs[impl]
        r["logged_numbers"] = len(r["logged"])
        r["logged_equal_flash_bit_for_bit"] = r["logged"] == ref
        r["first_differing"] = [list(k) for k in sorted(
            k for k in ref if r["logged"].get(k) != ref[k])[:4]]
        rec[impl] = {k: v for k, v in r.items() if k != "logged"}
    rec["two_card"] = two = two_card_check("sequence")
    emit(rec)
    if two["made"] and two["max_rel_diff"] > MESH_TWO_CARD_RTOL:
        raise AssertionError(f"train_sequence: two cards vs one {two}")
    for impl in SEQ_IMPLS:
        r = runs[impl]
        if not r["logged_equal_flash_bit_for_bit"] or not ref:
            raise AssertionError(f"train_sequence: {impl}'s logged numbers "
                                 f"differ from flash's at "
                                 f"{r['first_differing']}")
        if (r["launches"] != runs["flash"]["launches"]
                or not r["launches"].get("flash_fwd")):
            raise AssertionError(f"train_sequence: {impl} launched "
                                 f"{r['launches']}, flash "
                                 f"{runs['flash']['launches']}")
    return rec


# -- the tensor axis: Megatron tensor parallelism and expert parallelism ----


class EmbedLoss(torch.nn.Module):
    """The vocab-parallel ends of a model: the embedding lookup of
    ``tokens`` and the chunked loss of hidden states ``h`` against ``y``
    through the head (the trainer's own ``Embedding`` and ``ops.loss``)."""

    def __init__(self, wte, lm_head):
        super().__init__()
        self.wte, self.lm_head = wte, lm_head

    def forward(self, tokens, h, y):
        from midgpt_tpu_torch.ops.loss import chunked_softmax_xent

        return self.wte(tokens), chunked_softmax_xent(
            h, self.lm_head.weight.to(h.dtype), y, chunk_t=TENSOR_LOSS_CHUNK,
            tensor=self.wte.tensor)


def tensor_module(kind: str, cfg):
    """A tensor case's unsharded module (f32, on the CPU, drawn from SEED)
    and its parameters' prefix in the model."""
    from midgpt_tpu_torch.models.gpt import Block, MoEMLP
    from midgpt_tpu_torch.models.layers import Embedding, Linear

    gen = torch.Generator().manual_seed(SEED)
    if kind == "block":
        return Block.init(cfg, gen), "blocks.0."
    if kind == "moe":
        return MoEMLP.init(cfg, gen), "blocks.0.mlp."
    wte = Embedding.init(cfg.vocab_size, cfg.n_embd, cfg.n_embd ** -0.5, gen)
    return EmbedLoss(wte, Linear(wte.weight.detach().t().contiguous())), ""


def tensor_inputs(kind: str, cfg, b: int, t: int):
    """A case's inputs, drawn on the CPU from SEED (f32; ids int64)."""
    gen = torch.Generator().manual_seed(SEED + 1)
    d = cfg.n_embd
    if kind != "embed_loss":
        return {"x": torch.randn(b, t, d, generator=gen),
                "dout": torch.randn(b, t, d, generator=gen)}
    ids = lambda: torch.randint(0, cfg.vocab_size, (b, t),  # noqa: E731
                                generator=gen)
    return {"tokens": ids(), "h": torch.randn(b, t, d, generator=gen),
            "y": ids(), "dout": torch.randn(b, t, d, generator=gen)}


def tensor_run(kind: str, module, inp, rope=None, unused: bool = False):
    """One forward and backward of a case's module: its outputs and the
    gradients of the inputs and of every parameter (``unused``: a
    parameter no active shard reads gets None), detached."""
    names = [n for n, _ in module.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    if kind == "embed_loss":
        h = inp["h"].detach().requires_grad_()
        emb, loss = module(inp["tokens"], h, inp["y"])
        grads = torch.autograd.grad([emb, loss], [h, *params],
                                    [inp["dout"], torch.ones_like(loss)],
                                    allow_unused=unused)
        outs = {"embed": emb, "loss": loss, "dh": grads[0]}
    else:
        x = inp["x"].detach().requires_grad_()
        if kind == "block":
            out, aux = module(x, rope, "auto"), None
        else:
            out, aux = module(x)
        roots, seeds = [out], [inp["dout"]]
        if aux is not None:  # the router's load-balance loss
            roots.append(aux)
            seeds.append(torch.ones_like(aux))
        grads = torch.autograd.grad(roots, [x, *params], seeds,
                                    allow_unused=unused)
        outs = {"out": out, "dx": grads[0]}
    outs.update({f"d {n}": g for n, g in zip(names, grads[1:])})
    # nothing keeps the autograd graph: a parameter's gradient node must
    # not outlive its run (a CUDA graph captures the next one's on its
    # own stream)
    return {k: v if v is None else v.detach() for k, v in outs.items()}


def tensor_full(outs, ex, cfg, prefix: str):
    """A sharded run's outputs with every parameter gradient put back
    together in the full (JAX) layout."""
    from midgpt_tpu_torch.parallel.sharding import tensor_dim, tensor_unshard
    from midgpt_tpu_torch.parallel.tensor import held_shard

    full = {}
    for k, g in outs.items():
        name = prefix + k[2:]
        dim = tensor_dim(name) if k.startswith("d ") else None
        if dim is None:
            full[k] = g
        else:
            full[k] = tensor_unshard(name, [held_shard(g, j, ex, dim)
                                            for j in range(len(ex.held))],
                                     cfg)
    return full


def tensor_bf16_factor(tp: int, output: str) -> float:
    """The bf16 limit of a tensor-parallel module's ``output`` at ``tp``
    shards, in units of the unsharded bf16 run's own distance from the
    unsharded f32 run: 2, the fused and flash phases' rule, for every
    output but the vocab-parallel loss's ``dh``, which is the sum of the
    ``tp`` shards' bf16 products alone (no residual, no single-shard
    term): each partial is rounded to bf16 before the sum, against the
    unsharded product's one rounding, so each partial past the second
    may add half the unsharded distance: max(2, 1 + tp / 2). On an H100
    80GB HBM3 at 700 W the sound runs read at most 1.15 of the unsharded
    distance on every other output at tp 2 and 4, dh 1.46 at tp 2 and
    2.27 at tp 4; the planted faults 2.5 and above (PERF.md)."""
    return max(2.0, 1.0 + tp / 2) if output == "dh" else 2.0


def bf16_readings(got, w16, w32, tp: int) -> tp.Dict[str, float]:
    """Each output's largest distance from the unsharded f32 run over its
    bf16 limit (``tensor_bf16_factor``): pass at 1 or below."""
    out = {}
    for k, r in w32.items():
        own = (w16[k].float() - r).abs().max().item()
        out[k] = ((got[k].float() - r).abs().max().item()
                  / (tensor_bf16_factor(tp, k) * own))
    return out


def f32_readings(got, w32) -> tp.Dict[str, float]:
    """Each output's largest ``|got - unsharded f32|`` over ``1e-5 u +
    rel x |unsharded f32|``, rel 1e-5 for the forward's outputs and 1e-4
    for the gradients: the flash phases' f32 rule, its absolute term in
    units ``u`` of the output's largest magnitude where that exceeds 1
    (the flash outputs are O(1); a parameter gradient here sums 8192
    tokens' products and reaches hundreds, and another order of its f32
    sums moves an element by about 1e-6 of that, wherever the sum cancels
    to near 0)."""
    out = {}
    for k, r in w32.items():
        rel = 1e-4 if k.startswith("d") else 1e-5
        u = max(1.0, r.abs().max().item())
        out[k] = ((got[k].float() - r).abs()
                  / (1e-5 * u + rel * r.abs())).max().item()
    return out


def round_bits(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to nearest at ``bits`` significant bits."""
    m, e = torch.frexp(x.float())
    return torch.ldexp(torch.round(m * 2.0 ** bits) / 2.0 ** bits,
                       e).to(x.dtype)


class _CoarseGrad(torch.autograd.Function):
    """The identity, its gradient rounded to ``bits`` significant bits."""

    @staticmethod
    def forward(ctx, x, bits):
        ctx.bits = bits
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return round_bits(g, ctx.bits), None


@contextlib.contextmanager
def coarse_sums(bits: int):
    """The precision fault, as a lossy all-reduce would send its values:
    every partial result entering a forward tensor sum
    (``reduce_from_tensor``: the row-parallel products, the experts'
    combine, the embedding's rows) and the lm head input's summed
    gradient (the loss's ``copy_to_tensor``) rounded to ``bits``
    significant bits."""
    from midgpt_tpu_torch.models import gpt as gpt_mod
    from midgpt_tpu_torch.ops import loss as loss_mod
    from midgpt_tpu_torch.parallel import tensor as tensor_mod

    real_reduce, real_copy = (tensor_mod.reduce_from_tensor,
                              loss_mod.copy_to_tensor)

    def reduce(parts, ex):
        return real_reduce([x + (round_bits(x, bits) - x).detach()
                            for x in parts], ex)

    def copy(x, ex):
        return _CoarseGrad.apply(real_copy(x, ex), bits)

    gpt_mod.reduce_from_tensor = tensor_mod.reduce_from_tensor = reduce
    loss_mod.copy_to_tensor = copy
    try:
        yield
    finally:
        gpt_mod.reduce_from_tensor = tensor_mod.reduce_from_tensor = \
            real_reduce
        loss_mod.copy_to_tensor = real_copy


def fused_counts(fa) -> tp.Dict[str, int]:
    return {n: getattr(fa, n).launches
            for n in ("fused_attention_fwd", "fused_attention_bwd")}


def phase_tensor(fa, gpu):
    """The tensor axis on one card (see the module docstring): the
    trainer's own tensor-parallel modules on a loopback exchange against
    the same modules unsharded; returns the fused launches summed over
    the checked bf16 runs."""
    import dataclasses

    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models import gpt as gpt_mod
    from midgpt_tpu_torch.parallel.tensor import LoopbackTensorExchange

    totals = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    heads_seen: tp.List[tp.Tuple[int, int]] = []
    real_fused = gpt_mod.fused_attention_qkv

    def recording(qkv, wq, wk, sin, cos, h, hkv, eps):
        heads_seen.append((h, hkv))
        return real_fused(qkv, wq, wk, sin, cos, h, hkv, eps)

    recs = []
    emit({"phase": "tensor_rule", "rule": TENSOR_RULE,
          "dh_factor_by_tensor": {tpn: tensor_bf16_factor(tpn, "dh")
                                  for tpn in (2, 4)},
          "precision_fault_bits": TENSOR_FAULT_BITS, "gpu": gpu})
    for name, kind, b, t, tps in TENSOR_CASES:
        cfg = dataclasses.replace(get_model_config(name), remat="none",
                                  dropout=0.0)
        base, prefix = tensor_module(kind, cfg)
        inp = tensor_inputs(kind, cfg, b, t)
        cast = {dt: {k: (v.to(DEVICE) if v.dtype == torch.int64
                         else v.to(DEVICE, dt)) for k, v in inp.items()}
                for dt in (torch.float32, torch.bfloat16)}
        rope = gpt_mod._rope_tables_full(cfg.head_dim, t, cfg.rope_base,
                                         DEVICE)
        whole = {dt: copy.deepcopy(base).to(DEVICE, dt)
                 for dt in (torch.float32, torch.bfloat16)}
        w32 = {k: v.float() for k, v in tensor_run(
            kind, whole[torch.float32], cast[torch.float32], rope).items()}
        w16 = tensor_run(kind, whole[torch.bfloat16], cast[torch.bfloat16],
                         rope)
        whole_ms = graph_ms(lambda: tensor_run(
            kind, whole[torch.bfloat16], cast[torch.bfloat16], rope))
        for tpn in tps:
            rec = {"phase": "tensor", "config": name, "module": kind,
                   "B": b, "T": t, "tensor": tpn, "D": cfg.n_embd,
                   "H": cfg.n_head, "Hkv": cfg.kv_heads, "C": cfg.head_dim,
                   "mlp": cfg.mlp, "experts": cfg.moe_experts
                   if cfg.mlp == "moe" else None,
                   "F": gpt_mod.mlp_hidden_dim(cfg), "V": cfg.vocab_size,
                   "gpu": gpu}
            ex = LoopbackTensorExchange(tpn)
            mods = {dt: gpt_mod.shard_tensor(copy.deepcopy(base), ex, cfg,
                                             prefix).to(DEVICE, dt)
                    for dt in (torch.float32, torch.bfloat16)}
            before = fused_counts(fa)
            gpt_mod.fused_attention_qkv = recording
            heads_seen.clear()
            try:
                got = tensor_full(tensor_run(
                    kind, mods[torch.bfloat16], cast[torch.bfloat16], rope),
                    ex, cfg, prefix)
                torch.cuda.synchronize()
            finally:
                gpt_mod.fused_attention_qkv = real_fused
            after = fused_counts(fa)
            rec["fused_launches"] = {n: after[n] - before[n] for n in totals}
            rec["fused_heads_per_launch"] = sorted(set(heads_seen))
            for n in totals:
                totals[n] += after[n] - before[n]
            rec["bf16_err_over_limit"] = bf = bf16_readings(got, w16, w32,
                                                            tpn)
            got32 = tensor_full(tensor_run(
                kind, mods[torch.float32], cast[torch.float32], rope),
                ex, cfg, prefix)
            rec["f32_err_over_limit"] = f32 = f32_readings(got32, w32)
            del got32
            bad = [f"{k} (bf16)" for k, x in bf.items() if not x <= 1.0]
            bad += [f"{k} (f32)" for k, x in f32.items() if not x <= 1.0]
            if not all(torch.isfinite(v).all() for v in got.values()):
                bad.append("non-finite")
            want_heads = [(cfg.n_head // tpn, cfg.kv_heads // tpn)]
            if kind == "block" and (rec["fused_heads_per_launch"] != want_heads
                                    or rec["fused_launches"] != {
                                        n: tpn for n in totals}):
                bad.append(f"fused launches {rec['fused_launches']} at "
                           f"{rec['fused_heads_per_launch']} heads")
            if kind == "block":
                # the rule refuses JAX's contiguous cut of packed wqkv
                # (which does not fall on head boundaries) read as the
                # port's per-shard layout
                trap = copy.deepcopy(mods[torch.bfloat16])
                trap.attn.wqkv.weight.data = whole[
                    torch.bfloat16].attn.wqkv.weight.data.clone()
                faulted = bf16_readings(tensor_full(tensor_run(
                    kind, trap, cast[torch.bfloat16], rope), ex, cfg,
                    prefix), w16, w32, tpn)
                rec["fault"] = "wqkv cut contiguously (JAX's layout)"
                rec["fault_err_over_limit"] = {k: faulted[k]
                                               for k in ("out", "dx")}
                if not all(x > 1.0 for x in rec["fault_err_over_limit"]
                           .values()):
                    bad.append("the rule passes the contiguous wqkv cut")
                del trap
            # the precision fault: the tensor sums' values rounded
            # coarser than bf16, held by the f32 rule on the f32 modules
            # (the bf16 rule passes sums rounded to 5 bits, and any bit
            # count on the MoE layer, where a routing flip between its
            # bf16 and f32 runs sets every output's largest distance:
            # its bf16 reading is recorded, not gated)
            with coarse_sums(TENSOR_FAULT_BITS):
                faulted = bf16_readings(tensor_full(tensor_run(
                    kind, mods[torch.bfloat16], cast[torch.bfloat16],
                    rope), ex, cfg, prefix), w16, w32, tpn)
                faulted32 = f32_readings(tensor_full(tensor_run(
                    kind, mods[torch.float32], cast[torch.float32], rope),
                    ex, cfg, prefix), w32)
            rec["precision_fault_err_over_limit"] = faulted
            rec["precision_fault_f32_err_over_limit"] = faulted32
            must = {"block": ["out"], "embed_loss": ["embed", "dh"],
                    "moe": []}[kind]
            # the forward sums only: the MoE's dx takes no rounded sum
            # (its combine's gradient is the identity's), and in f32 the
            # loss's dh moves by about 0.05 of the limit under its
            # rounded copy (the bf16 rule refuses it, above)
            must32 = {"block": ["out", "dx"], "embed_loss": ["embed"],
                      "moe": ["out"]}[kind]
            if not (all(faulted[k] > 1.0 for k in must)
                    and all(faulted32[k] > 1.0 for k in must32)):
                bad.append(f"the rule passes the tensor sums at "
                           f"{TENSOR_FAULT_BITS} bits")
            if bad:
                emit(rec)
                raise AssertionError(f"tensor: {name} {kind} tensor={tpn} "
                                     f"disagrees with the unsharded "
                                     f"module: {bad}")
            # each virtual rank's work alone: its launches and device ms
            per_rank = []
            for d in range(tpn):
                gpt_mod.set_tensor(mods[torch.bfloat16],
                                   LoopbackTensorExchange(tpn, active=(d,)))
                before = fused_counts(fa)
                tensor_run(kind, mods[torch.bfloat16], cast[torch.bfloat16],
                           rope, unused=True)
                torch.cuda.synchronize()
                after = fused_counts(fa)
                ms = graph_ms(lambda: tensor_run(
                    kind, mods[torch.bfloat16], cast[torch.bfloat16], rope,
                    unused=True))
                per_rank.append({"rank": d, "ms": ms, "fused_launches": {
                    n: after[n] - before[n] for n in totals}})
            rank_ms = [r["ms"] for r in per_rank]
            rec.update({"per_virtual_rank": per_rank,
                        "max_over_min_rank_ms": max(rank_ms) / min(rank_ms),
                        "unsharded_ms": whole_ms,
                        "rank_ms_over_unsharded": [m / whole_ms
                                                   for m in rank_ms],
                        "ms_is": "device ms of a forward and its backward "
                                 "(CUDA graph replay between CUDA events)"})
            emit(rec)
            recs.append(rec)
            del mods, got
            gc.collect()
            torch.cuda.empty_cache()
        del whole, w16, w32, cast
        gc.collect()
        torch.cuda.empty_cache()
    return {"launches": totals, "cases": recs,
            "timing": tensor_fused_timing(fa, gpu)}


def tensor_fused_timing(fa, gpu):
    """The fused kernels at a tensor rank's shapes (bf16): each launch's
    device ms from CUDA graphs beside its plain version, its bound and
    SDPA (the forward with the forward pre-pass, the same function; the
    backward as SDPA forward + backward), and its distance from the plain
    f32 version."""
    out = {}
    for name, b, t, h, hkv, c in TENSOR_FUSED_SHAPES:
        args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=5)
        qkv, wq, wk, sin, cos, dout = args
        fo, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        ms = {"fwd": device_ms(lambda i: fa.fused_attention_fwd(
                  qkv, wq, wk, sin, cos, h, hkv), reps=10),
              "bwd": device_ms(lambda i: fa.fused_attention_bwd(
                  qkv, wq, wk, sin, cos, fo, lse, dout, h, hkv), reps=5)}
        plain_ms = {"fwd": device_ms(
            lambda i: fa.fused_attention_forward_reference(
                qkv, wq, wk, sin, cos, h, hkv), reps=2),
            "bwd": device_ms(lambda i: fa.fused_attention_backward_reference(
                qkv, wq, wk, sin, cos, fo, lse, dout, h, hkv), reps=1)}
        got = fused_run(fa, args, h, hkv, kernel=True)
        ref32 = fused_run(fa, [a.float() for a in args], h, hkv,
                          kernel=False)
        err = {n: (g.float() - r).abs().max().item()
               for n, g, r in zip(FUSED_OUTS, got, ref32)}
        del got, ref32
        fwd_lib = fwd_yardstick_ms(fa, args, h, hkv, reps=10)[0]
        bounds = fused_bounds(b, t, h, hkv, c, qkv.element_size())
        out[name] = {
            "shape": dict(b=b, t=t, h=h, hkv=hkv, c=c, dtype="bfloat16"),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": {k: v[0] for k, v in bounds.items()},
            "bound_by": {k: v[1] for k, v in bounds.items()},
            "frac_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
            "library_ms": {"fwd": fwd_lib,
                           "bwd": sdpa_fwd_bwd_ms(fa, args, h, hkv, reps=5)},
            "max_abs_err_vs_plain_f32": err}
        del args, qkv, fo, lse, dout
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "tensor_timing", "kernels": "fused_attention_fwd/bwd",
          "library_note": "fwd: SDPA forward on the normed, roped q/k/v + "
                          "the forward pre-pass; bwd: SDPA forward + "
                          "backward; CUDA graphs", "shapes": out, "gpu": gpu})
    return out


def phase_train_tensor(gpu):
    """``openwebtext_xl`` at full width (``XL_LAYERS`` of its layers) on
    this card: the launcher under torch.distributed.run at a world of one
    with ``mesh.tensor=1`` against the single-card trainer on the same
    batches (see the module docstring). Returns the record and the
    single-card run's logged numbers (train_pipeline's reference)."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.parallel.mesh import Mesh
    from midgpt_tpu_torch.train import card_peak_bytes
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token)

    rec: tp.Dict[str, tp.Any] = {"phase": "train_tensor", "config": XL_NAME,
                                 "overrides": XL_SET,
                                 "model_overrides": {"n_layer": XL_LAYERS},
                                 "gpu": gpu}
    with tempfile.TemporaryDirectory() as tmp:
        data = window_data(tmp, XL_NAME)
        one = os.path.join(tmp, "one")
        cfg = get_config(XL_NAME, seed=SEED, rundir=one, data_dir=data,
                         **XL_SET)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, n_layer=XL_LAYERS))
        (final1, wall1, peak1, held1), _, launches1 = counted(
            train_kernels(), lambda: train_measured(cfg))
        ref = logged_numbers(one)
        rates1 = step_rates(one, (0,))
        gc.collect()
        torch.cuda.empty_cache()
        run = os.path.join(tmp, "mesh")
        sets = [f"{k}={json.dumps(v)}" for k, v in XL_SET.items()]
        sets += [f"data_dir={data}", f"seed={SEED}", "mesh.fsdp=-1",
                 "mesh.tensor=1", f"model.n_layer={XL_LAYERS}"]
        stdout, wall = torchrun(1, ["--multihost", "--config", XL_NAME,
                                    "--rundir", run, "--set", *sets],
                                timeout=600)
        fin = launched_final(stdout)
        got = logged_numbers(run)
        rates_m = step_rates(run, (0,))
    tokens = cfg.batch_size * cfg.model.block_size
    med1, med_m = statistics.median(rates1), statistics.median(rates_m)
    peak_flops = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    mesh1 = Mesh(rank=0, world=1, sizes=(1, 1, 1, 1, 1), distributed=True)
    remat = final1["remat"]
    est1, est_m = card_peak_bytes(cfg, remat), card_peak_bytes(cfg, remat,
                                                               mesh1)
    fwd = "fused_attn.fused_attention_fwd"
    bwd = "fused_attn.fused_attention_bwd"
    rec.update({
        "launch": "python -m torch.distributed.run --standalone "
                  "--nproc_per_node=1 -m midgpt_tpu_torch.launch "
                  f"--multihost --config {XL_NAME} --set mesh.fsdp=-1 "
                  f"mesh.tensor=1 model.n_layer={XL_LAYERS} ...",
        "world": 1, "remat": remat, "mesh_remat": fin["remat"],
        "parameters": est1["params"],
        "logged_equal_bit_for_bit": got == ref and bool(ref),
        "logged_numbers": len(ref),
        "first_differing": [list(k) for k in sorted(
            k for k in ref if got.get(k) != ref[k])[:4]],
        "single_card": {
            "step_ms_median": 1e3 * tokens / med1,
            "tokens_per_s_median": med1,
            "mfu": med1 * fpt / peak_flops,
            "wall_s": wall1, "loop_s": final1["loop_s"],
            "launches": {k: v for k, v in launches1.items() if v},
            "peak_bytes": peak1, "held_before_bytes": held1,
            "card_peak_bytes": est1["peak"],
            "estimate_over_peak": est1["peak"] / max(peak1, 1)},
        "launcher": {
            "step_ms_median": 1e3 * tokens / med_m,
            "tokens_per_s_median": med_m,
            "mfu": med_m * fpt / peak_flops,
            "wall_s": wall, "loop_s": fin["loop_s"],
            "fused_launches": {k: fin["launches"].get(k, 0)
                               for k in (fwd, bwd)},
            "replay_launches": fin.get("replay_launches", {}),
            "max_memory_allocated": fin.get("max_memory_allocated"),
            "card_peak_bytes": est_m["peak"],
            "estimate_over_peak": est_m["peak"] / max(
                fin.get("max_memory_allocated") or 1, 1)},
        "flops_per_token": fpt, "device_peak_flops": peak_flops})
    rec["two_card"] = two = two_card_check("tensor")
    emit(rec)
    if not rec["logged_equal_bit_for_bit"]:
        raise AssertionError(f"train_tensor: logged numbers differ from the "
                             f"single-card run at {rec['first_differing']}")
    # at tensor=1 the model's tensor sums run as one-rank all-reduces,
    # captured in the replay beside the mean loss's and the grad norm's
    reduces = tensor_all_reduces(dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, remat=fin["remat"])))
    if rec["launcher"]["replay_launches"].get("sharding.all_reduce"
                                              ) != reduces:
        raise AssertionError(f"train_tensor: the replay's all-reduces "
                             f"{rec['launcher']['replay_launches']}, "
                             f"{reduces} expected")
    if (rec["launcher"]["fused_launches"][bwd]
            != launches1["fused_bwd"] or not launches1["fused_bwd"]):
        raise AssertionError(f"train_tensor: fused launches "
                             f"{rec['launcher']['fused_launches']} against "
                             f"{launches1}")
    if two["made"] and two["max_rel_diff"] > MESH_TWO_CARD_RTOL:
        raise AssertionError(f"train_tensor: two cards vs one {two}")
    return rec, ref


# -- the pipeline axis: GPipe stages on the loopback, and train() over it -----

# the pipeline phase: openwebtext_xl's blocks at full width, one train
# microstep's rows (B x T), through the loopback pipeline at these stage
# counts against the same model unpipelined over the same microbatches
PIPE_LAYERS = 8  # of openwebtext_xl's 24
PIPE_B = 8
PIPE_STAGES = (2, 4)
PIPE_RULE = ("bf16: max |pipelined bf16 - unpipelined f32| <= 2 x max "
             "|unpipelined bf16 - unpipelined f32| per output (the last "
             "stage's ln_f output h, the summed loss, every parameter "
             "gradient); f32: |pipelined f32 - unpipelined f32| <= 1e-5 u "
             "+ rel x |unpipelined f32| per element, u = max(1, max "
             "|unpipelined f32|), rel 1e-5 outputs, 1e-4 gradients; the "
             "unpipelined runs take the microbatches one by one, each "
             "loss's backward in turn (the single-card trainer's path)")
PIPE_FAULTS = ("boundary: f32 activations rounded to bf16 on their way to "
               "the next stage, still float32",
               "skip: one microbatch's backward skipped on stage 1 (its "
               "recompute's output multiplied by 0)")


def pipe_run(model, tokens, targets, stages: int, n_micro: int,
             boundary=torch.float32):
    """One microstep of ``model`` on ``tokens -> targets [B, T]`` in
    ``n_micro`` microbatches: through the loopback pipeline of ``stages``
    stages (``models.gpt.pipeline_loss``), or at 1 unpipelined (each
    microbatch's ``hidden`` and loss, then its backward, in turn). The
    last stage's ln_f output ``h`` by microbatch, the summed ``loss`` and
    every parameter's gradient, detached."""
    from midgpt_tpu_torch.models.gpt import pipeline_loss
    from midgpt_tpu_torch.parallel.pipeline import LoopbackPipe
    from midgpt_tpu_torch.train import head_loss

    model.zero_grad(set_to_none=True)
    tail = head_loss(model, TENSOR_LOSS_CHUNK)
    hs = []

    def head(h, y):
        hs.append(h.detach())
        return tail(h, y)

    if stages == 1:
        bm = tokens.shape[0] // n_micro
        loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for m in range(n_micro):
            rows = slice(m * bm, (m + 1) * bm)
            lm = head(model.hidden(tokens[rows]), targets[rows])
            lm.backward()
            loss = loss + lm.detach()
    else:
        model.pipeline = LoopbackPipe(stages)
        try:
            loss = pipeline_loss(model, tokens, targets, head, n_micro,
                                 boundary_dtype=boundary)
        finally:
            model.pipeline = None
    out = {"loss": loss, "h": torch.cat(hs)}
    out.update({f"d {n}": p.grad.detach().clone()
                for n, p in model.named_parameters()})
    model.zero_grad(set_to_none=True)
    return out


class StageLaunches:
    """Fused launches by virtual stage, through ``model.stage_forward``: a
    stage's forward launches fall inside its call, its backward's between
    the call's return and the next stage's call (the loopback runs the
    stages one after another); the delta since the last call is the
    previous stage's."""

    def __init__(self, fa, model):
        self.fa, self.model = fa, model
        self.real = model.stage_forward
        self.rows: tp.Dict[int, tp.Dict[str, int]] = {}
        self.prev: tp.Optional[int] = None
        self.mark = fused_counts(fa)

    def settle(self) -> None:
        now = fused_counts(self.fa)
        if self.prev is not None:
            row = self.rows.setdefault(self.prev, {"fwd": 0, "bwd": 0})
            row["fwd"] += (now["fused_attention_fwd"]
                           - self.mark["fused_attention_fwd"])
            row["bwd"] += (now["fused_attention_bwd"]
                           - self.mark["fused_attention_bwd"])
        self.mark = now

    def __call__(self, index, *a, **kw):
        self.settle()
        self.prev = index
        return self.real(index, *a, **kw)

    def __enter__(self):
        self.model.stage_forward = self
        return self

    def __exit__(self, *exc):
        self.settle()
        del self.model.stage_forward


@contextlib.contextmanager
def pipe_fault(model, kind: str, n_micro: int):
    """A planted fault in the pipelined runs: ``boundary`` rounds every
    forward hand-off to bf16 and back (the dtype still float32); ``skip``
    multiplies stage 1's recomputed output of microbatch 1 by 0, so that
    microbatch's backward adds nothing on stages 0 and 1."""
    from midgpt_tpu_torch.parallel import pipeline as pp

    real_send, real_stage = pp.LoopbackPipe.send, model.stage_forward
    rows = PIPE_B // n_micro

    def send(self, x, src, dst):
        if dst > src:
            x = x.to(torch.bfloat16).to(x.dtype)
        return real_send(self, x, src, dst)

    def stage(index, *a, **kw):
        out = real_stage(index, *a, **kw)
        if (index == 1 and torch.is_grad_enabled()
                and model.batch_offset == rows):
            out = out * 0.0
        return out

    if kind == "boundary":
        pp.LoopbackPipe.send = send
    else:
        model.stage_forward = stage
    try:
        yield
    finally:
        pp.LoopbackPipe.send = real_send
        if kind != "boundary":
            del model.stage_forward


def pipe_stage_ms(model, tokens, targets, stages: int, n_micro: int):
    """Each virtual stage's device ms on microbatch 0 (bf16): a stage
    before the last its forward without gradients, then the recompute
    and its backward from a fixed output gradient; the last stage the
    recompute, the loss and its backward. The stages' inputs come from
    one forward through the stages before."""
    from midgpt_tpu_torch.models.gpt import _rope_tables_full
    from midgpt_tpu_torch.parallel.pipeline import stage_layers
    from midgpt_tpu_torch.train import head_loss

    cfg = model.config
    bm = tokens.shape[0] // n_micro
    x, y = tokens[:bm], targets[:bm]
    rope = _rope_tables_full(cfg.head_dim, x.shape[1], cfg.rope_base,
                             x.device)
    tail = head_loss(model, TENSOR_LOSS_CHUNK)
    impl = cfg.attn_impl
    f32 = torch.float32
    inputs = [x]
    with torch.no_grad():
        for s in range(stages - 1):
            inputs.append(model.stage_forward(s, stages, inputs[-1], rope,
                                              impl, None, f32))
    gen = torch.Generator(device=x.device).manual_seed(SEED + 9)
    gout = torch.randn(inputs[1].shape, generator=gen, device=x.device)
    out = []
    for s in range(stages):
        layers = stage_layers(cfg.n_layer, stages, s)
        params = [p for n, p in model.named_parameters()
                  if (n.startswith("blocks.")
                      and int(n.split(".")[1]) in layers)
                  or (n.startswith("wte.") and s == 0)
                  or (n.startswith("lm_head.") and s == stages - 1)]
        last = s == stages - 1

        def work(s=s, params=params, last=last):
            inp = inputs[s]
            if s:
                inp = inp.detach().requires_grad_(True)
            if not last:
                with torch.no_grad():
                    model.stage_forward(s, stages, inputs[s], rope, impl,
                                        None, f32)
            res = model.stage_forward(s, stages, inp, rope, impl, None, f32)
            if last:
                res = tail(res, y)
            torch.autograd.grad(res, params + ([inp] if s else []),
                                None if last else gout)

        out.append({"stage": s, "layers": [layers.start, layers.stop],
                    "ms": graph_ms(work)})
    return out


def phase_pipeline(fa, gpu):
    """The pipeline axis on one card (see the module docstring): the
    model's GPipe stages on the loopback pipeline against the same model
    unpipelined; returns the fused launches summed over the checked
    pipelined bf16 runs."""
    import dataclasses

    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.parallel.pipeline import bubble, microbatches

    cfg = dataclasses.replace(get_model_config(XL_NAME), n_layer=PIPE_LAYERS,
                              remat="none", dropout=0.0)
    base = GPT.init(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (PIPE_B, cfg.block_size + 1),
                         generator=gen).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    models = {dt: copy.deepcopy(base).to(DEVICE, dt)
              for dt in (torch.float32, torch.bfloat16)}
    del base
    totals = {"fused_attention_fwd": 0, "fused_attention_bwd": 0}
    recs = []
    for stages in PIPE_STAGES:
        n_micro = microbatches(PIPE_B, stages)
        per = cfg.n_layer // stages
        rec = {"phase": "pipeline", "config": XL_NAME, "B": PIPE_B,
               "T": cfg.block_size, "L": cfg.n_layer, "D": cfg.n_embd,
               "H": cfg.n_head, "C": cfg.head_dim, "V": cfg.vocab_size,
               "stages": stages, "microbatches": n_micro,
               "boundary_dtype": "float32", "rule": PIPE_RULE,
               "bubble": bubble(stages, n_micro),
               "bubble_is": "(S - 1) / (M + S - 1), computed", "gpu": gpu}
        w32 = {k: v.float() for k, v in pipe_run(
            models[torch.float32], x, y, 1, n_micro).items()}
        w16 = pipe_run(models[torch.bfloat16], x, y, 1, n_micro)
        torch.cuda.synchronize()
        before = fused_counts(fa)
        with StageLaunches(fa, models[torch.bfloat16]) as counter:
            got = pipe_run(models[torch.bfloat16], x, y, stages, n_micro)
            torch.cuda.synchronize()
        after = fused_counts(fa)
        rec["fused_launches"] = {n: after[n] - before[n] for n in totals}
        for n in totals:
            totals[n] += after[n] - before[n]
        rec["fused_launches_per_stage_and_microbatch"] = {
            s: {k: v / n_micro for k, v in row.items()}
            for s, row in sorted(counter.rows.items())}
        want = {s: {"fwd": per * (1 if s == stages - 1 else 2), "bwd": per}
                for s in range(stages)}
        rec["expected_per_stage_and_microbatch"] = want
        rec["bf16_err_over_limit"] = bf = bf16_readings(got, w16, w32, 1)
        rec["bf16_equals_unpipelined_bits"] = all(
            torch.equal(got[k], w16[k]) for k in w16)
        got32 = pipe_run(models[torch.float32], x, y, stages, n_micro)
        rec["f32_err_over_limit"] = f32 = f32_readings(got32, w32)
        rec["f32_equals_unpipelined_bits"] = all(
            torch.equal(got32[k], w32[k]) for k in w32)
        del got32
        bad = [f"{k} (bf16)" for k, v in bf.items() if not v <= 1.0]
        bad += [f"{k} (f32)" for k, v in f32.items() if not v <= 1.0]
        if not all(torch.isfinite(v).all() for v in got.values()):
            bad.append("non-finite")
        seen = {s: {k: v / n_micro for k, v in row.items()}
                for s, row in counter.rows.items()}
        if seen != want:
            bad.append(f"fused launches by stage {seen}, {want} expected")
        faults = {}
        for kind, what in zip(("boundary", "skip"), PIPE_FAULTS):
            with pipe_fault(models[torch.float32], kind, n_micro):
                faulted = f32_readings(pipe_run(
                    models[torch.float32], x, y, stages, n_micro), w32)
            worst = max(faulted, key=faulted.get)
            faults[kind] = {"fault": what, "worst": worst,
                            "err_over_limit": faulted[worst],
                            "outputs_refused": sum(v > 1.0 for v in
                                                   faulted.values())}
            if not faulted[worst] > 1.0:
                bad.append(f"the f32 rule passes the {kind} fault")
        rec["faults"] = faults
        if bad:
            emit(rec)
            raise AssertionError(f"pipeline: {stages} stages disagree with "
                                 f"the unpipelined model: {bad}")
        rec["per_virtual_stage"] = per_stage = pipe_stage_ms(
            models[torch.bfloat16], x, y, stages, n_micro)
        rec["unpipelined_microbatch_ms"] = whole = graph_ms(
            lambda: pipe_microbatch(models[torch.bfloat16], x, y, n_micro))
        ms = [r["ms"] for r in per_stage]
        rec.update({"max_over_min_stage_ms": max(ms) / min(ms),
                    "stages_sum_over_unpipelined": sum(ms) / whole,
                    "ms_is": "device ms (CUDA graph replay between CUDA "
                             "events) of one microbatch: a stage's "
                             "forward, recompute and backward; "
                             "unpipelined: the whole model's forward and "
                             "backward"})
        emit(rec)
        recs.append(rec)
        del w16, w32, got
        gc.collect()
        torch.cuda.empty_cache()
    del models
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": totals, "cases": recs}


def pipe_microbatch(model, tokens, targets, n_micro: int) -> None:
    """One microbatch (the first of ``n_micro``) of ``model``
    unpipelined: its forward, loss and backward into fresh gradients."""
    from midgpt_tpu_torch.train import head_loss

    bm = tokens.shape[0] // n_micro
    loss = head_loss(model, TENSOR_LOSS_CHUNK)(model.hidden(tokens[:bm]),
                                               targets[:bm])
    torch.autograd.grad(loss, list(model.parameters()))


def phase_train_pipeline(gpu, ref, one):
    """``openwebtext_xl`` (``XL_LAYERS`` of its layers) through
    ``train()`` on this card at ``mesh.pipeline=4``, every stage on the
    loopback, against train_tensor's single-card run at
    ``g_accum_iters=8`` (``ref``: its logged numbers, ``one``: its
    record) on the same batches (see the module docstring)."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config
    from midgpt_tpu_torch.parallel.pipeline import bubble, microbatches
    from midgpt_tpu_torch.train import card_peak_bytes
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token)

    stages = 4
    over = dict(XL_SET, g_accum_iters=1)
    rec: tp.Dict[str, tp.Any] = {
        "phase": "train_pipeline", "config": XL_NAME, "overrides": over,
        "model_overrides": {"n_layer": XL_LAYERS},
        "mesh": {"pipeline": stages}, "gpu": gpu}
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "pipe")
        cfg = get_config(XL_NAME, seed=SEED, rundir=run,
                         data_dir=window_data(tmp, XL_NAME), **over)
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, n_layer=XL_LAYERS),
            mesh=dataclasses.replace(cfg.mesh, pipeline=stages))
        (final, wall, peak, held), _, launches = counted(
            train_kernels(), lambda: train_measured(cfg))
        got = logged_numbers(run)
        rates = step_rates(run, (0,))
    n_micro = microbatches(cfg.batch_size, stages)
    tokens = cfg.batch_size * cfg.model.block_size
    med = statistics.median(rates)
    fpt = flops_per_token(cfg.model)
    peak_flops = device_peak_flops(torch.cuda.get_device_name(0))
    est = card_peak_bytes(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, remat=final["remat"])))
    layers = cfg.model.n_layer
    fwd = "fused_attn.fused_attention_fwd"
    bwd = "fused_attn.fused_attention_bwd"
    replay = final.get("replay_launches", {})
    want = {fwd: n_micro * (2 * layers - layers // stages),
            bwd: n_micro * layers}
    rec.update({
        "stages": stages, "microbatches": n_micro,
        "bubble": bubble(stages, n_micro), "remat": final["remat"],
        "logged_equal_bit_for_bit": got == ref and bool(ref),
        "logged_numbers": len(ref),
        "first_differing": [list(k) for k in sorted(
            k for k in ref if got.get(k) != ref[k])[:4]],
        "step_ms_median": 1e3 * tokens / med,
        "tokens_per_s_median": med, "mfu": med * fpt / peak_flops,
        "single_card_step_ms_median": one["single_card"]["step_ms_median"],
        "single_card_mfu": one["single_card"]["mfu"],
        "wall_s": wall, "loop_s": final["loop_s"],
        "ckpt_s": final["ckpt_s"], "ckpt_wait_s": final["ckpt_wait_s"],
        "launches": {k: v for k, v in launches.items() if v},
        "replay_fused_launches": {k: replay.get(k, 0) for k in want},
        "expected_replay_fused_launches": want,
        "peak_bytes": peak, "held_before_bytes": held,
        "card_peak_bytes": est["peak"], "card_peak_terms": est,
        "estimate_over_peak": est["peak"] / max(peak, 1),
        "c4_band": list(C4_BAND),
        "flops_per_token": fpt, "device_peak_flops": peak_flops})
    rec["two_card"] = two = two_card_check("pipeline")
    emit(rec)
    if not rec["logged_equal_bit_for_bit"]:
        raise AssertionError(f"train_pipeline: logged numbers differ from "
                             f"the single-card run at "
                             f"{rec['first_differing']}")
    if rec["replay_fused_launches"] != want:
        raise AssertionError(f"train_pipeline: a replay's fused launches "
                             f"{rec['replay_fused_launches']}, {want} "
                             f"expected")
    if not C4_BAND[0] <= rec["estimate_over_peak"] <= C4_BAND[1]:
        raise AssertionError(f"train_pipeline: card_peak_bytes "
                             f"{est['peak']} against the peak {peak}")
    if two["made"] and two["max_rel_diff"] > MESH_TWO_CARD_RTOL:
        raise AssertionError(f"train_pipeline: two cards vs one {two}")
    return rec


# -- the long-context slice: the split backward and the fused RMSNorm ------


def split_run(fa, args, h, hkv, kernel):
    """``(out, lse, dq, dwq, dk_h, dv_h, dwk)``: the forward and the split
    backward through the kernels or the plain versions. Both backward
    passes read the plain forward's lse and its delta = rowsum(dO * O), so
    each split kernel sees the same inputs as its plain version."""
    qkv, wq, wk, sin, cos, dout = args
    o, lse = fa.fused_attention_forward_reference(qkv, wq, wk, sin, cos, h,
                                                  hkv)
    delta = fa.attention_delta(o, dout, h)
    tail = (lse, delta, dout, h, hkv)
    if kernel:
        fwd = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        return (*fwd, *fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail),
                *fa.fused_attention_bwd_dkv(qkv, wq, wk, sin, cos, *tail))
    return (o, lse,
            *fa.fused_attention_bwd_dq_reference(qkv, wq, wk, sin, cos, *tail),
            *fa.fused_attention_bwd_dkv_reference(qkv, wq, wk, sin, cos,
                                                  *tail))


def prep_readings(fa, args, h, hkv, shifted=None):
    """The bf16 pre-pass kernel against its plain version run in f32 on
    the upcast inputs: q^ and k^ held by :func:`hold` (each element within
    1e-5 plus half a bf16 ulp), delta (an f32 sum over C in another
    order) within 1e-5 + 1e-5 |plain|. Returns each output's (max abs
    err, err / limit), and q^'s err / limit with the kernel run on the
    RoPE tables in ``shifted`` (must exceed 1; None without them)."""
    qkv, wq, wk, sin, cos, dout = args
    out, _ = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    got = fa.fused_attention_bwd_prep(qkv, wq, wk, sin, cos, h, hkv,
                                      out=out, dout=dout)
    ref = fa.fused_attention_bwd_prep_reference(
        qkv.float(), wq, wk, sin, cos, h, hkv, out=out.float(),
        dout=dout.float())
    d_err = (got[2] - ref[2]).abs()
    readings = {"qhat": hold(got[0], ref[0]), "khat": hold(got[1], ref[1]),
                "delta": (d_err.max().item(), (d_err / (
                    1e-5 + 1e-5 * ref[2].abs())).max().item())}
    if shifted is None:
        return readings, None
    fault = fa.fused_attention_bwd_prep(qkv, wq, wk, *shifted, h, hkv)[0]
    return readings, hold(fault, ref[0])[1]


def phase_split_kernel(fa) -> tp.Dict[str, float]:
    """The split route's kernels (the bf16 pre-pass, dq and dk/dv), and the
    fused forward at T=2048 (which had not run there before), against
    their plain versions: each output held by :func:`fused_readings`'
    rule (the pre-pass by :func:`prep_readings`); the same rule must
    refuse every output of the kernels run with the RoPE tables shifted
    by one position. At T=1024 (below the cap) the split route's dqkv,
    dwq and dwk are held against the combined kernel's: in f32 each
    element within 1e-5 + 1e-4 |combined| (the same sums in another
    order); in bf16 their largest distance within twice the plain bf16
    version's largest distance from the plain f32 one (the split kernels
    sum S = Q^ K^T and the combined one S^T = K^ Q^T, each in its own
    order, so ds may round to another bf16 value: the two routes are held
    no further apart than fused_readings lets each be from the f32
    path). Returns the largest bf16-kernel-to-bf16-plain distance of the
    dq and dk/dv kernels' outputs (``"split"``) and of the pre-pass's
    (``"prep"``)."""
    names = ("out", "lse") + SPLIT_OUTS
    worst = {"split": 0.0, "prep": 0.0}
    for name, b, t, h, hkv, c in SPLIT_GEOMS:
        for dtype in (torch.bfloat16, torch.float32):
            args = fused_inputs(b, t, h, hkv, c, dtype)
            got = split_run(fa, args, h, hkv, kernel=True)
            torch.cuda.synchronize()
            plain = split_run(fa, args, h, hkv, kernel=False)
            ref32 = None
            if dtype == torch.bfloat16:
                ref32 = split_run(fa, [a.float() for a in args], h, hkv,
                                  kernel=False)
            sound = fused_readings(got, plain, ref32, names)
            shifted = list(args)
            shifted[3], shifted[4] = (torch.roll(a, 1, 0) for a in args[3:5])
            fault = split_run(fa, shifted, h, hkv, kernel=True)
            faulted = fused_readings(fault, plain, ref32, names)
            errs = {n: (g.float() - p.float()).abs().max().item()
                    for n, g, p in zip(names, got, plain)}
            if dtype == torch.bfloat16:
                prep, prep_fault = prep_readings(fa, args, h, hkv,
                                                 shifted[3:5])
                bad_prep = [n for n, v in prep.items() if not v[1] <= 1.0]
                if bad_prep or not prep_fault > 1.0:
                    raise AssertionError(
                        f"pre-pass kernel: {name} {prep} shifted RoPE "
                        f"{prep_fault}")
            rec = {"phase": "split_kernel", "geometry": name, "B": b, "T": t,
                   "H": h, "Hkv": hkv, "C": c,
                   "dtype": str(dtype).split(".")[-1],
                   "rule": ("1e-5 + rel x |plain| per element, rel 1e-5 "
                            "(out, lse) / 1e-4 (grads)" if ref32 is None else
                            "max |kernel - plain f32| <= 2 x max |plain "
                            "bf16 - plain f32|"),
                   "sound_err_over_limit": sound,
                   "shifted_rope_err_over_limit": faulted,
                   "max_abs_err_vs_plain_same_dtype": errs}
            if dtype == torch.bfloat16:
                rec["prep"] = {"rule": "qhat, khat: 1e-5 + 2^-8 |kernel|; "
                                       "delta: 1e-5 + 1e-5 |plain f32|",
                               "max_abs_err": {k: v[0] for k, v in
                                               prep.items()},
                               "err_over_limit": {k: v[1] for k, v in
                                                  prep.items()},
                               "shifted_rope_qhat_err_over_limit":
                                   prep_fault}
            del got, plain, ref32, fault
            bad = [n for n, v in sound.items() if not v <= 1.0]
            missed = [n for n, v in faulted.items() if not v > 1.0]
            if not bad and not missed:
                rec["vs_combined"] = split_vs_combined(
                    fa, b, SPLIT_VS_COMBINED_T, h, hkv, c, dtype)
            emit(rec)
            if bad:
                raise AssertionError(f"split kernels disagree with their "
                                     f"plain versions: {name} {dtype} {bad}")
            if missed:
                raise AssertionError(f"the check passes shifted RoPE tables: "
                                     f"{name} {dtype} {missed}")
            if dtype == torch.bfloat16:
                worst["split"] = max(worst["split"], *(
                    v for n, v in errs.items() if n in SPLIT_OUTS))
                worst["prep"] = max(worst["prep"],
                                    *(v[0] for v in prep.values()))
            gc.collect()
            torch.cuda.empty_cache()
    return worst


def split_vs_combined(fa, b, t, h, hkv, c, dtype):
    """The split route (pre-pass, dq, dk/dv kernels, the GQA sum) against the
    combined kernel at a T both take; raises past the rule of
    :func:`phase_split_kernel`."""
    args = fused_inputs(b, t, h, hkv, c, dtype, seed=1)
    qkv, wq, wk, sin, cos, dout = args
    out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
    comb = fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out, lse, dout, h,
                                  hkv)
    split = fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out, lse, dout,
                                         h, hkv)
    names = ("dqkv", "dwq", "dwk")
    diff = {n: (a.float() - m.float()).abs().max().item()
            for n, a, m in zip(names, split, comb)}
    if dtype == torch.float32:
        over = {n: ((a - m).abs() / (1e-5 + 1e-4 * m.abs())).max().item()
                for n, a, m in zip(names, split, comb)}
    else:
        plain = fused_run(fa, args, h, hkv, kernel=False)[2:]
        ref32 = fused_run(fa, [a.float() for a in args], h, hkv,
                          kernel=False)[2:]
        over = {n: diff[n] / (2 * (p.float() - r).abs().max().item())
                for n, p, r in zip(names, plain, ref32)}
    if not all(v <= 1.0 for v in over.values()):
        raise AssertionError(f"split and combined kernels disagree at T={t}: "
                             f"{over}")
    return {"T": t, "err_over_limit": over, "max_abs_diff": diff}


def phase_norm_kernel(fn) -> float:
    """The fused RMSNorm kernels against their plain versions: y and dx
    held by :func:`hold` against the plain versions in f32 on the upcast
    inputs (each computes in f32 and rounds once), rstd by the f32 rule;
    [8192, 768] in bf16 and f32, with and without a weight, eps 1e-6 and
    1e-5, and 4099 rows (not a multiple of 32, nor of the kernel's 8 rows
    a block). The same rule must refuse the plain output with its rows
    shifted by one. Returns the largest bf16 y/dx distance."""
    worst = 0.0
    for (n, d) in NORM_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for use_weight in ((False, True) if n == NORM_SHAPES[0][0]
                               else (True,)):
                for eps in (NORM_EPS if n == NORM_SHAPES[0][0]
                            else NORM_EPS[:1]):
                    gen = torch.Generator().manual_seed(SEED)
                    x = torch.randn(n, d, generator=gen).to(DEVICE, dtype)
                    w = (1.0 + 0.2 * torch.randn(d, generator=gen)).to(DEVICE)
                    dy = torch.randn(n, d, generator=gen).to(DEVICE, dtype)
                    w = w if use_weight else None
                    y, rstd = fn.fused_rms_norm_fwd(x, w, eps)
                    dx = fn.fused_rms_norm_bwd(x, w, rstd, dy)
                    torch.cuda.synchronize()
                    y32, r32 = fn.fused_rms_norm_forward_reference(
                        x.float(), w, eps)
                    dx32 = fn.fused_rms_norm_backward_reference(
                        x.float(), w, r32, dy.float())
                    readings = {"y": hold(y, y32), "dx": hold(dx, dx32),
                                "rstd": hold(rstd, r32)}
                    fault = hold(y, torch.roll(y32, 1, 0))[1]
                    emit({"phase": "norm_kernel", "N": n, "D": d,
                          "dtype": str(dtype).split(".")[-1],
                          "weight": use_weight, "eps": eps,
                          "rule": "|kernel - plain f32| <= 1e-5 + (bf16: "
                                  "2^-8 |kernel|) per element",
                          "max_abs_err": {k: v[0]
                                          for k, v in readings.items()},
                          "err_over_limit": {k: v[1]
                                             for k, v in readings.items()},
                          "shifted_rows_err_over_limit": fault})
                    bad = [k for k, v in readings.items() if not v[1] <= 1.0]
                    if bad:
                        raise AssertionError(
                            f"norm kernels disagree with their plain "
                            f"versions: {n}x{d} {dtype} w={use_weight} "
                            f"eps={eps} {bad}")
                    if not fault > 1.0:
                        raise AssertionError("the check passes shifted rows")
                    if dtype == torch.bfloat16:
                        worst = max(worst, readings["y"][0],
                                    readings["dx"][0])
    return worst


def long_counters(fa, fn):
    """The launch counters of the long-context path's kernels."""
    return {"fused_fwd": fa.fused_attention_fwd,
            "fused_bwd_combined": fa.fused_attention_bwd,
            "fused_bwd_prep": fa.fused_attention_bwd_prep,
            "fused_bwd_dq": fa.fused_attention_bwd_dq,
            "fused_bwd_dkv": fa.fused_attention_bwd_dkv,
            "rms_norm_fwd": fn.fused_rms_norm_fwd,
            "rms_norm_bwd": fn.fused_rms_norm_bwd}


def long_config(**overrides):
    """``openwebtext`` at a 2048-token context with the fused norm."""
    import dataclasses

    from midgpt_tpu_torch.config import get_config

    cfg = get_config("openwebtext", seed=SEED, **overrides)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **LONG_MODEL))


def phase_train_long(fa, fn, gpu):
    """``train()`` on openwebtext at block_size 2048 with the fused norm:
    the attention backward takes the split kernels (T above the combined
    cap), every RMSNorm the norm kernels; launches counted around the run
    alone."""
    from midgpt_tpu_torch.data import write_tokens
    from midgpt_tpu_torch.utils.metrics import (
        device_peak_flops, flops_per_token, read_metrics)

    counters = long_counters(fa, fn)
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        write_tokens(os.path.join(data, "train.bin"),
                     zipf_tokens(DATA_TOKENS, SEED))
        write_tokens(os.path.join(data, "val.bin"),
                     zipf_tokens(DATA_TOKENS, SEED + 1))
        rundir = os.path.join(tmp, "run")
        cfg = long_config(rundir=rundir, data_dir=data, **LONG_SET)
        for f in counters.values():
            f.launches = 0
        final, wall, peak_bytes, held = train_measured(cfg)
        launches = {k: f.launches for k, f in counters.items()}
        rows = read_metrics(rundir)
    losses = final["losses"]
    nl, g = cfg.model.n_layer, cfg.g_accum_iters
    fwd_want, _ = expected_launches(cfg)
    train_mb = cfg.max_steps * g
    all_mb = fwd_want // nl
    norms = 2 * nl + 1
    want = {"fused_fwd": fwd_want, "fused_bwd_combined": 0,
            "fused_bwd_prep": nl * train_mb,
            "fused_bwd_dq": nl * train_mb, "fused_bwd_dkv": nl * train_mb,
            "rms_norm_fwd": norms * all_mb, "rms_norm_bwd": norms * train_mb}
    tokens_per_step = cfg.batch_size * cfg.model.block_size
    tps = [r["tokens_per_sec"] for r in rows if "tokens_per_sec" in r]
    peak = device_peak_flops(torch.cuda.get_device_name(0))
    fpt = flops_per_token(cfg.model)
    trained = tokens_per_step * cfg.max_steps
    steps_s = (final["loop_s"] - final["eval_s"] - final["ckpt_s"]
               - final["ckpt_wait_s"])
    rec = {
        "phase": "train_long", "config": "openwebtext",
        "model_overrides": LONG_MODEL, "overrides": LONG_SET,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
        "loss_chunk": cfg.loss_chunk, "remat": final["remat"],
        "losses": losses, "val_loss": final["val_loss"],
        "launches": launches, "expected_launches": want,
        "launch_formula": "fwd = n_layer x (train + eval microbatches); "
                          "pre-pass = dq = dkv = n_layer x train "
                          "microbatches (bf16); combined 0; norm fwd = "
                          "(2 n_layer + 1) x (train "
                          "+ eval microbatches); norm bwd = (2 n_layer + 1) "
                          "x train microbatches",
        "wall_s": wall, "loop_s": final["loop_s"],
        "eval_s": final["eval_s"], "ckpt_s": final["ckpt_s"],
        "ckpt_wait_s": final["ckpt_wait_s"],
        "tokens_per_s": final["tokens_per_sec"],
        "mfu": final["tokens_per_sec"] * fpt / peak,
        "tokens_per_s_steps_only": trained / steps_s,
        "mfu_steps_only": trained / steps_s * fpt / peak,
        "step_ms_median": 1e3 * tokens_per_step / statistics.median(tps),
        "tokens_per_s_per_step": tps,
        "timing_note": "as the train phase: tokens_per_s over train()'s "
                       "loop, evals and saves included; *_steps_only "
                       "without them; step_ms_median between loss reads",
        "flops_per_token": fpt,
        **memory_fields(cfg, final["remat"], peak_bytes, held), "gpu": gpu,
    }
    emit(rec)
    if not all(np.isfinite(losses)) or len(losses) != cfg.max_steps:
        raise AssertionError(f"losses {losses}")
    if not np.mean(losses[-3:]) <= losses[0] - 0.5:
        raise AssertionError(f"the loss did not fall by 0.5 nat: {losses}")
    if final["remat"] != "none":
        raise AssertionError(f"remat resolved to {final['remat']}")
    if launches != want or min(v for k, v in launches.items()
                               if k != "fused_bwd_combined") == 0:
        raise AssertionError(f"launches {launches} != {want}")
    return rec


def set_norm_impl(model, impl: str) -> None:
    """Every RMSNorm of ``model`` to ``impl`` (the weights are untouched)."""
    from midgpt_tpu_torch.models.layers import RMSNorm

    for m in model.modules():
        if isinstance(m, RMSNorm):
            m.impl = impl


def phase_parity_long(fa, fn, gpu):
    """One microbatch (B=4, T=2048) of the full-width model through the
    fused attention (split backward) and the fused norm, and through the
    naive attention and the plain norm: loss and global gradient norm,
    with the limits of the parity phase."""
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.train import (
        effective_loss_chunk, global_norm, loss_fn, make_shadow)

    exp = long_config()
    cfg, chunk = exp.model, effective_loss_chunk(exp)
    b, t = 4, cfg.block_size
    toks = zipf_tokens(b * (t + 1), SEED + 4).astype(np.int64)
    toks = torch.from_numpy(toks.reshape(b, t + 1)).to(DEVICE)
    x, y = toks[:, :-1], toks[:, 1:]
    model = seeded_model(GPT, cfg)
    counters = long_counters(fa, fn)

    def run(m, impl, bf16=False):
        set_norm_impl(m, "fused" if impl == "fused" else "auto")
        m.zero_grad(set_to_none=True)
        before = {k: f.launches for k, f in counters.items()}
        loss = loss_fn(m, x, y, chunk, attn_impl=impl)
        loss.backward()
        norm = global_norm([p.grad.float() for p in m.parameters()]).item()
        used = {k: f.launches - before[k] for k, f in counters.items()}
        n = cfg.n_layer
        # the f32 split kernels normalise in their walks: no pre-pass
        want = ({"fused_fwd": n, "fused_bwd_combined": 0,
                 "fused_bwd_prep": n if bf16 else 0, "fused_bwd_dq": n,
                 "fused_bwd_dkv": n, "rms_norm_fwd": 2 * n + 1,
                 "rms_norm_bwd": 2 * n + 1} if impl == "fused"
                else {k: 0 for k in counters})
        if used != want:
            raise AssertionError(f"{impl}: launches {used} != {want}")
        m.zero_grad(set_to_none=True)
        return loss.item(), norm

    f32 = {impl: run(model, impl) for impl in ("fused", "naive")}
    gc.collect()
    torch.cuda.empty_cache()
    model16 = make_shadow(model, torch.bfloat16)
    bf16 = {impl: run(model16, impl, bf16=True)
            for impl in ("fused", "naive")}
    del model, model16
    (lf, nf), (ln, nn) = f32["fused"], f32["naive"]
    (lfb, nfb), (lnb, nnb) = bf16["fused"], bf16["naive"]
    rec = {"phase": "parity_long", "config": "openwebtext",
           "model_overrides": LONG_MODEL, "B": b, "T": t,
           "paths": "fused attention (split backward) + fused norm vs naive "
                    "attention + plain norm",
           "f32": {"loss_fused": lf, "loss_naive": ln,
                   "loss_rel_diff": abs(lf - ln) / abs(ln),
                   "grad_norm_fused": nf, "grad_norm_naive": nn,
                   "grad_norm_rel_diff": abs(nf - nn) / abs(nn),
                   "limits": {"loss": 1e-5, "grad_norm": 1e-4}},
           "bf16": {"loss_fused": lfb, "loss_naive": lnb,
                    "loss_fused_to_f32": abs(lfb - ln),
                    "loss_naive_to_f32": abs(lnb - ln),
                    "grad_norm_fused": nfb, "grad_norm_naive": nnb,
                    "grad_norm_fused_to_f32": abs(nfb - nn),
                    "grad_norm_naive_to_f32": abs(nnb - nn),
                    "rule": "fused bf16 within 2 x naive bf16's distance "
                            "from naive f32"},
           "gpu": gpu}
    emit(rec)
    if not (abs(lf - ln) <= 1e-5 * abs(ln) and abs(nf - nn) <= 1e-4 * abs(nn)):
        raise AssertionError("f32 fused and naive paths disagree")
    if not (abs(lfb - ln) <= 2 * abs(lnb - ln)
            and abs(nfb - nn) <= 2 * abs(nnb - nn)):
        raise AssertionError("bf16 fused path too far from the f32 path")
    return rec


def phase_serve_norm(fn, pa, serving, GPT, cfg, gpu):
    """The serve cell's model (openwebtext, block 1024, bf16) with
    norm_impl "fused" on the 16 serve requests: the norm kernel launches
    2 n_layer + 1 times a model forward (each decode step and each
    prefill), the backward never; one decode window's logits held to the
    plain-norm model's by window_agreement's rule."""
    import dataclasses

    mcfg = dataclasses.replace(cfg, norm_impl="fused")
    model = seeded_model(GPT, mcfg, torch.bfloat16)
    ps = prompts(cfg.vocab_size)
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE)
    fn.fused_rms_norm_fwd.launches = fn.fused_rms_norm_bwd.launches = 0
    pa.paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(p, MAX_NEW) for p in ps]
    finished = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"rms_norm_fwd": fn.fused_rms_norm_fwd.launches,
                "rms_norm_bwd": fn.fused_rms_norm_bwd.launches,
                "paged_decode": pa.paged_decode_attention.launches}
    steps = eng.windows * eng.window
    forwards = steps + eng.prefill_dispatches
    want = {"rms_norm_fwd": (2 * cfg.n_layer + 1) * forwards,
            "rms_norm_bwd": 0, "paged_decode": cfg.n_layer * steps}
    tokens = [finished[r].tokens for r in rids]
    plain = copy.deepcopy(model)
    set_norm_impl(plain, "auto")
    check = window_agreement(model, serving, plain_model=plain)
    del plain
    rec = {"phase": "serve_norm", "config": "openwebtext", "dtype": "bfloat16",
           "norm_impl": "fused", **SERVE, "requests": N_REQUESTS,
           "max_new_tokens": MAX_NEW,
           "tokens": int(sum(len(x) for x in tokens)), "wall_s": wall,
           "tokens_per_s": sum(len(x) for x in tokens) / wall,
           "decode_steps": steps, "prefill_dispatches": eng.prefill_dispatches,
           "model_forwards": forwards, "launches": launches,
           "expected_launches": want,
           "launch_formula": "norm fwd = (2 n_layer + 1) x (decode steps + "
                             "prefills); norm bwd 0; paged decode = n_layer "
                             "x decode steps",
           "window_check_vs_plain_norm_bf16": check, "gpu": gpu}
    emit(rec)
    if not all(len(x) == MAX_NEW for x in tokens):
        raise AssertionError(f"lengths {[len(x) for x in tokens]}")
    if launches != want or launches["rms_norm_fwd"] == 0:
        raise AssertionError(f"launches {launches} != {want}")
    del model, eng
    return rec


def split_bounds(b, t, h, hkv, c, esz):
    """Least times of one dq and one dk/dv launch: the larger of bytes
    (qkv, dO, lse, delta, the tables and LN weights read once; dq, or dk
    and dv per q head, and the [B, H, T/64, C] f32 LN-weight partials
    written once) over HBM bandwidth and bf16 operations over the causal
    triangle (T (T + 1) / 2 entries a head) over the peak rate: three
    products for dq (S, dP, dS K), four for dk/dv (S, dP, P^T dO, dS^T Q),
    2 C operations per entry each."""
    f = (h + 2 * hkv) * c
    act = b * t * h * c * esz
    reads = b * t * f * esz + act + 2 * b * h * t * 4 + 2 * t * c * 4 + 2 * c * 4
    parts = b * h * (t // 64) * c * 4
    entries = b * h * t * (t + 1) // 2
    out = {}
    for name, nbytes, products in (("dq", reads + act + parts, 3),
                                   ("dkv", reads + 2 * act + parts, 4)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = products * 2 * c * entries / PEAK_FLOPS[torch.bfloat16]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations",
                     nbytes, products * 2 * c * entries)
    return out


def norm_bounds(n, d, esz, use_weight):
    """Least times of one norm forward and backward: bytes (x read, y
    written, rstd written, w read; x, dy, rstd read, dx written) over HBM
    bandwidth; a few f32 operations an element are far below it."""
    w = 4 * d if use_weight else 0
    out = {}
    for name, nbytes, ops in (("fwd", 2 * n * d * esz + 4 * n + w, 3 * n * d),
                              ("bwd", 3 * n * d * esz + 4 * n + w, 6 * n * d)):
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = ops / PEAK_FLOPS[torch.float32]
        out[name] = (1e3 * max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations", nbytes,
                     ops)
    return out


def sdpa_fwd_bwd_ms(fa, args, h, hkv, reps):
    """SDPA forward + backward (CUDA graph) on the already normed and
    roped q/k/v of ``args``: attention alone, the yardstick the fused
    kernels' rows use."""
    import torch.nn.functional as F

    qkv, wq, wk, sin, cos, dout = args
    b, t, _ = qkv.shape
    c = dout.shape[-1] // h
    q, k, v = fa._split(qkv, h, hkv)
    leaves = [a.detach().contiguous().requires_grad_() for a in (
        fa._ln_rope(q, wq, sin, cos, fa.EPS)[0].to(qkv.dtype),
        fa._ln_rope(k, wk, sin, cos, fa.EPS)[0].to(qkv.dtype), v)]
    dout_h = dout.reshape(b, t, h, c).transpose(1, 2).contiguous()

    def fb(i):
        o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                           enable_gqa=h != hkv)
        return torch.autograd.grad(o, leaves, dout_h)

    return device_ms(fb, reps=reps)


def prep_bound(b, t, h, hkv, c, esz):
    """Least time of one pre-pass launch: bytes (the raw q and k columns
    of qkv, O and dO read once; q^, k^ and delta written; the tables and
    LN weights read) over HBM bandwidth; its LayerNorm, RoPE and the
    delta sum, ~12 f32 operations an element, are far below it."""
    rows = b * t * (h + hkv) * c * esz
    act = b * t * h * c * esz
    nbytes = 2 * rows + 2 * act + b * h * t * 4 + 2 * t * c * 4 + 2 * c * 4
    ops = 12 * b * t * (h + hkv) * c + 2 * b * t * h * c
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_FLOPS[torch.float32]
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def route_stages(by_kernel: tp.Dict[str, float]) -> tp.Dict[str, float]:
    """:func:`route_kernels_ms`' kernels summed by the split route's stage:
    the pre-pass, the dq kernel, the dk/dv kernel and PyTorch's ops (the
    LN-weight partial sums, the GQA sum)."""
    import re

    pats = {"prep": r"fused_bwd_prep", "dq": r"fused_dq",
            "dkv": r"fused_bwd_tile|fused_dkv"}
    out = dict.fromkeys([*pats, "torch_ops"], 0.0)
    for name, ms in by_kernel.items():
        out[next((k for k, pat in pats.items() if re.search(pat, name)),
                 "torch_ops")] += ms
    return out


def phase_timing_long(fa, fn, gpu):
    """The split route at one train_long microbatch (B=4, T=2048, H=12,
    C=64, bf16) and at the train cell's (B=8, T=1024) beside the combined
    kernel there, and the norm kernels at [8192, 768] bf16 (the rows of
    one train_long microbatch), each beside its plain version, its bound
    and the library's time for the same work (SDPA forward + backward for
    the split kernels, attention alone, and with the pre-pass added;
    F.rms_norm for the norms). Device time from CUDA graphs
    (:func:`device_ms`): the pre-pass, the dq and dk/dv kernels alone
    (given the pre-pass's q^ and k^), and the route whole; the route's
    kernels apart under the profiler."""
    import torch.nn.functional as F

    rec = {"phase": "timing", "kernels": "split route (pre-pass, dq, dkv), "
           "rms norm fwd / bwd", "gpu": gpu}
    split = {}
    for label, shape in (("t2048", LONG_TIMING),
                         ("t1024", TRAIN_TIMING)):
        b, t, h, hkv, c = (shape[k] for k in ("b", "t", "h", "hkv", "c"))
        args = fused_inputs(b, t, h, hkv, c, torch.bfloat16, seed=6)
        qkv, wq, wk, sin, cos, dout = args
        out, lse = fa.fused_attention_fwd(qkv, wq, wk, sin, cos, h, hkv)
        qhat, khat, delta = fa.fused_attention_bwd_prep(
            qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout)
        tail = (lse, delta, dout, h, hkv)
        hats = dict(qhat=qhat, khat=khat)

        def dq(i):
            return fa.fused_attention_bwd_dq(qkv, wq, wk, sin, cos, *tail,
                                             **hats)

        def route(i):
            return fa.fused_attention_bwd_split(qkv, wq, wk, sin, cos, out,
                                                lse, dout, h, hkv)

        ms = {"prep": device_ms(lambda i: fa.fused_attention_bwd_prep(
                  qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout),
                  reps=20),
              "dq": device_ms(dq, reps=10),
              "dkv": device_ms(lambda i: fa.fused_attention_bwd_dkv(
                  qkv, wq, wk, sin, cos, *tail, **hats), reps=10)}
        by_kernel = route_kernels_ms(lambda: route(0))
        row = {"shape": dict(shape, dtype="bfloat16"), "ms": ms,
               "route_ms": device_ms(route, reps=10),
               "ms_note": "dq, dkv: the kernels alone, given the pre-pass's "
                          "q^ and k^ (the pre-pass not included); prep: the "
                          "pre-pass with delta; route_ms: "
                          "fused_attention_bwd_split whole (pre-pass, dq, "
                          "dk/dv, the LN-weight partial sums)",
               "route_device_ms_by_kernel": by_kernel,
               "route_device_ms_by_stage": route_stages(by_kernel)}
        if label == "t2048":
            row["plain_ms"] = {
                "prep": device_ms(
                    lambda i: fa.fused_attention_bwd_prep_reference(
                        qkv, wq, wk, sin, cos, h, hkv, out=out, dout=dout),
                    reps=2),
                "dq": device_ms(lambda i: fa.fused_attention_bwd_dq_reference(
                    qkv, wq, wk, sin, cos, *tail, **hats), reps=1),
                "dkv": device_ms(
                    lambda i: fa.fused_attention_bwd_dkv_reference(
                        qkv, wq, wk, sin, cos, *tail, **hats), reps=1)}
            got = split_run(fa, args, h, hkv, kernel=True)
            ref32 = split_run(fa, [a.float() for a in args], h, hkv,
                              kernel=False)
            row["max_abs_err_vs_plain_f32"] = {
                n: (g.float() - r).abs().max().item()
                for n, g, r in zip(("out", "lse") + SPLIT_OUTS, got, ref32)}
            del got, ref32
            prep = prep_readings(fa, args, h, hkv)[0]
            row["max_abs_err_vs_plain_f32"].update(
                {k: v[0] for k, v in prep.items()})
            sdpa = sdpa_fwd_bwd_ms(fa, args, h, hkv, reps=5)
            row["library_ms"] = {"sdpa_fwd_bwd": sdpa,
                                 "sdpa_fwd_bwd_plus_prep": sdpa + ms["prep"]}
        else:
            row["combined_bwd_ms"] = device_ms(
                lambda i: fa.fused_attention_bwd(qkv, wq, wk, sin, cos, out,
                                                 lse, dout, h, hkv), reps=10)
            row["split_bwd_ms"] = row["route_ms"]
        bounds = split_bounds(b, t, h, hkv, c, qkv.element_size())
        bounds["prep"] = prep_bound(b, t, h, hkv, c, qkv.element_size())
        # the route's function is the whole backward: five products at
        # least (the combined kernel's count), bytes of its inputs/outputs
        bounds["route"] = fused_bounds(b, t, h, hkv, c,
                                       qkv.element_size())["bwd"]
        times = dict(ms, route=row["route_ms"])
        row.update({"bound_ms": {k: v[0] for k, v in bounds.items()},
                    "bound_by": {k: v[1] for k, v in bounds.items()},
                    "bytes": {k: v[2] for k, v in bounds.items()},
                    "flops": {k: v[3] for k, v in bounds.items()},
                    "frac_of_bound": {k: bounds[k][0] / times[k]
                                      for k in times}})
        split[label] = row
        del args, qkv, out, lse, delta, dout, qhat, khat, hats
        gc.collect()
        torch.cuda.empty_cache()
    rec["split"] = split

    # launches rotate over NORM_BUFS inputs (8 x 25 MB forward, 38 MB
    # backward), more than the 50 MB L2 holds: each launch reads device
    # memory, as in a training step
    n, d = NORM_SHAPES[0]
    eps = NORM_EPS[0]
    gen = torch.Generator().manual_seed(SEED + 7)
    bufs = [tuple(torch.randn(n, d, generator=gen).to(DEVICE, torch.bfloat16)
                  for _ in range(2)) for _ in range(NORM_BUFS)]
    rstds = [fn.fused_rms_norm_fwd(x, None, eps)[1] for x, _ in bufs]
    leaves = [x.detach().requires_grad_() for x, _ in bufs]

    def pick(i):
        j = i % NORM_BUFS
        return bufs[j][0], bufs[j][1], rstds[j], leaves[j]

    ms = {"fwd": device_ms(lambda i: fn.fused_rms_norm_fwd(
              pick(i)[0], None, eps), reps=48),
          "bwd": device_ms(lambda i: fn.fused_rms_norm_bwd(
              pick(i)[0], None, pick(i)[2], pick(i)[1]), reps=48)}
    plain_ms = {"fwd": device_ms(lambda i: fn.fused_rms_norm_forward_reference(
                    pick(i)[0], None, eps), reps=8),
                "bwd": device_ms(
                    lambda i: fn.fused_rms_norm_backward_reference(
                        pick(i)[0], None, pick(i)[2], pick(i)[1]), reps=8)}

    def lib_fwd_bwd(i):
        x, dy, _, xl = pick(i)
        return torch.autograd.grad(F.rms_norm(xl, (d,), eps=eps), xl, dy)

    lib = {"fwd": device_ms(lambda i: F.rms_norm(pick(i)[0], (d,), eps=eps),
                            reps=48),
           "fwd_bwd": device_ms(lib_fwd_bwd, reps=48)}
    lib["bwd"] = lib["fwd_bwd"] - lib["fwd"]
    x, dy = bufs[0]
    y, rstd = fn.fused_rms_norm_fwd(x, None, eps)
    y32, r32 = fn.fused_rms_norm_forward_reference(x.float(), None, eps)
    dx = fn.fused_rms_norm_bwd(x, None, rstd, dy)
    dx32 = fn.fused_rms_norm_backward_reference(x.float(), None, r32,
                                                dy.float())
    bounds = norm_bounds(n, d, x.element_size(), False)
    rec["norm"] = {
        "shape": {"N": n, "D": d, "dtype": "bfloat16", "weight": False},
        "ms": ms, "plain_ms": plain_ms,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "bytes": {k: v[2] for k, v in bounds.items()},
        "frac_of_bound": {k: bounds[k][0] / ms[k] for k in ms},
        "library_ms": lib,
        "library_note": "F.rms_norm forward, and forward + autograd "
                        "backward, each a CUDA graph over the same rotating "
                        "inputs; bwd = their difference",
        "max_abs_err_vs_plain_f32": {
            "y": (y.float() - y32).abs().max().item(),
            "dx": (dx.float() - dx32).abs().max().item()}}
    emit(rec)
    return rec


def compiled_kernels(build, name: str, log: str) -> tp.Dict[str, dict]:
    """Per kernel of one library (``name<C>``): ptxas's registers, shared
    memory and spill bytes from the build log, and the HGMMA (``wgmma``)
    instructions in its SASS (cuobjdump; None where the toolkit lacks
    it)."""
    import re
    import shutil

    types = {"f": "float", "a": "int8_t", "13__nv_bfloat16": "bf16"}
    arg = r"L[ib]\d+E|13__nv_bfloat16|f|a|S\d*_"

    def short(mangled: str) -> str:
        # integer, bool and type template arguments (Li64E, Lb1E, f) kept
        # in order, so that instances of one template stay apart; bools
        # and types spelt as in the source (a substitution, S1_, repeats
        # the type before it)
        m = re.search(r"_cu_[0-9a-f]{8}\d+([A-Za-z_]\w*?_kernel)"
                      rf"I((?:{arg})+)E", mangled)
        if not m:
            return mangled
        args = []
        for a in re.findall(arg, m.group(2)):
            if a.startswith("Lb"):
                args.append("true" if a[2:-1] == "1" else "false")
            elif a.startswith("Li"):
                args.append(a[2:-1])
            else:
                args.append(args[-1] if a.startswith("S") else types[a])
        return f"{m.group(1)}<{', '.join(args)}>"

    out: tp.Dict[str, dict] = {}
    cur = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            cur = out.setdefault(short(m.group(1)), {})
        elif cur is not None and "Used" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem_bytes"] = int(smem.group(1)) if smem else 0
        elif cur is not None and "spill" in ln:
            st, ld = re.findall(r"(\d+) bytes spill", ln)
            cur["spill_store_bytes"], cur["spill_load_bytes"] = int(st), int(ld)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(tool):
        sass = subprocess.run([tool, "-sass", build.library_path(name)],
                              capture_output=True, text=True,
                              check=True).stdout
        cur = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = out.setdefault(short(ln.split("Function :")[1].strip()),
                                     {})
                cur["hgmma"] = 0
            elif cur is not None and "HGMMA" in ln:
                cur["hgmma"] += 1
    return out


def dynamic_smem(build, pa) -> tp.Dict[str, int]:
    """The dynamic shared memory each bf16 wgmma kernel launches with, as
    its launcher computes it (ptxas reports static shared memory only),
    and the paged split kernel's at the serve cells' shapes (openwebtext,
    bf16 pool, PS=16: decode G=1 with R recent rows, verify G T = T =
    speculate + 1)."""
    import ctypes

    fused = build.load("fused_attn").fused_attn_smem_bytes
    flash = build.load("flash").flash_smem_bytes
    for fn in (fused, flash):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 2
    out = {}
    for c in (64, 128):
        out[f"fused_fwd_wgmma_kernel<{c}>"] = fused(c, 0)
        out[f"fused_dq_tile_kernel<{c}>"] = fused(c, 1)
        out[f"fused_bwd_tile_kernel<{c}, false>"] = fused(c, 2)
        out[f"fused_bwd_tile_kernel<{c}, true>"] = fused(c, 3)
        out[f"flash_fwd_wgmma_kernel<{c}>"] = flash(c, 0)
        for drop in ("false", "true"):
            out[f"flash_dkv_tile_kernel<{c}, {drop}>"] = flash(c, 2)
            for own in ("false", "true"):
                out[f"flash_dq_tile_kernel<{c}, {drop}, {own}>"] = flash(c, 1)
    tt = SPEC["speculate"] + 1
    for kind, rows, rr in (("decode", 1, R), ("verify", tt, tt)):
        out[f"paged_split_kernel<bf16, bf16, 64> ({kind}, rows {rows})"] = (
            pa.smem_bytes(rows, 64, PS, 2, rr, 2))
    return out


# -- serving under the tensor axis ------------------------------------------

# serve_tensor: openwebtext_xl at full width and depth (24 layers, D 2048,
# 16 heads of 128, V 50304, bf16, norm_impl "fused" so the norm kernel runs
# on a prefill's T / tp rows) served at tensor 4 on one card's loopback
SERVE_TP = 4
SERVE_TP_NEW = 32  # new tokens a request on the counted main path
SERVE_TP_FAULT_NEW = 16  # and a planted fault's or a control's request
# the fixed-batch sampler on the mesh: (rows, prompt, new tokens)
SERVE_TP_SAMPLE = (2, 64, 16)
# the paged kernels at a tensor rank's shapes: (name, Hkv / tp, G, C)
TP_PAGED_GEOMS = (("xl_tensor4", 4, 1, 128), ("llama_tensor4", 2, 4, 128))
TP_VERIFY_T = 5  # speculate=4's candidate rows
TP_MATMUL_MS = (8, 40)  # a decode step's rows, a verify dispatch's
# the flash forward at the sampler's prefill on a rank: (B, T, H, Hkv, C)
TP_FLASH = (2, 64, 4, 4, 128)
# host and device ms of a dispatch: medians of this many (the eager twin
# of an xl tensor-4 window is 11,000 launches)
TP_TIMING_REPS = 5
# the margin rule: each served token's logit, from the served stream
# re-forwarded through the unsharded model in f32, within this many
# logit units of the largest (the f32 argmax); see PERF.md for the gaps
# a sound run and the planted faults read on the card
TP_MARGIN = 0.5


# GPT.init's CPU draws by config: each phase's model is a copy
_SEEDED: tp.Dict[tp.Any, tp.Any] = {}


def seeded_model(GPT, cfg, dtype: torch.dtype = torch.float32):
    """``GPT.init(cfg, torch.Generator().manual_seed(SEED),
    device=DEVICE, dtype=dtype)``, the same weights bit for bit: drawn on
    the CPU once a config (5.4 s at 124M, where most phases take the
    same one) and copied to the card after."""
    base = _SEEDED.get(cfg)
    if base is None:
        base = _SEEDED[cfg] = GPT.init(
            cfg, torch.Generator().manual_seed(SEED), device="cpu")
    return copy.deepcopy(base).to(device=DEVICE, dtype=dtype)


def card_model(GPT, cfg, seed: int):
    """A random f32 model of ``cfg`` drawn on the card from ``seed`` (a
    CUDA generator; ``GPT.init``'s CPU draw takes 5.4 s at 124M and about
    a minute at 1.4B): every weight ``[..., in, out]`` (the projections,
    the head, the router, the experts) ``N(0, 1 / in)``, the embedding
    ``N(0, 1 / D)``, the QK-norm weights one, and an untied head the
    embedding's transpose (as ``GPT.init`` starts it)."""
    with torch.device("meta"):
        model = GPT.init(cfg, device="meta")
    model = model.to_empty(device=DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.fill_(1.0)
            else:
                fan_in = p.shape[-1] if name.startswith("wte") else (
                    p.shape[-2])
                p.normal_(0.0, fan_in ** -0.5, generator=gen)
        if model.lm_head is not None:
            model.lm_head.weight.copy_(model.wte.weight.t())
    return model


def stream_gaps(model32, prompts_, streams) -> tp.List[float]:
    """For each served token, the largest f32 logit less the token's, the
    stream re-forwarded whole through ``model32`` (plain attention, f32):
    0 where the token is the f32 argmax."""
    gaps = []
    with torch.no_grad():
        for p, toks in zip(prompts_, streams):
            seq = np.concatenate([np.asarray(p), np.asarray(toks[:-1])])
            x = torch.from_numpy(seq.astype(np.int64))[None].to(DEVICE)
            h = model32.hidden(x, attn_impl="naive")[0, len(p) - 1:]
            logits = model32.project(h)
            chosen = logits.gather(-1, torch.as_tensor(
                np.asarray(toks), device=DEVICE)[:, None].long())[:, 0]
            gaps += (logits.max(-1).values - chosen).tolist()
    return gaps


def margin_reading(gaps) -> float:
    """The largest gap over ``TP_MARGIN``: the rule passes at 1 or below."""
    return max(gaps) / TP_MARGIN


def tp_serve(serving, model, ps, new: int, **kw):
    """Serve ``ps`` (request seed = index) on one engine of serve's
    geometry (each program captured at its first dispatch); the engine
    and the streams."""
    eng = serving.ServingEngine(model, **SERVE, device=DEVICE, **kw)
    rids = [eng.submit(p, new, seed=i) for i, p in enumerate(ps)]
    fin = eng.run()
    streams = [fin[r].tokens for r in rids]
    if not all(len(s) == new for s in streams):
        raise AssertionError(f"lengths {[len(s) for s in streams]}")
    pages_home(eng)
    return eng, streams


def swap_kv_heads(model, tpn: int, a: int, b: int):
    """A copy of a loopback tensor model (every rank held) with ranks
    ``a`` and ``b``'s K and V heads swapped in every layer's packed
    ``wqkv``: each rank's queries then attend over the other's keys."""
    bad = copy.deepcopy(model)
    cfg = model.config
    qw = cfg.n_head // tpn * cfg.head_dim
    kw = cfg.kv_heads // tpn * cfg.head_dim
    width = qw + 2 * kw
    with torch.no_grad():
        for blk in bad.blocks:
            w = blk.attn.wqkv.weight
            for off in (qw, qw + kw):  # the rank's k, then its v columns
                sa = slice(a * width + off, a * width + off + kw)
                sb = slice(b * width + off, b * width + off + kw)
                tmp = w[:, sa].clone()
                w[:, sa] = w[:, sb]
                w[:, sb] = tmp
    return bad


def zero_wo_shard(model, tpn: int, r: int):
    """A copy of a loopback tensor model with rank ``r``'s ``wo`` rows
    zeroed in every layer (its heads' share of the attention output
    lost)."""
    bad = copy.deepcopy(model)
    with torch.no_grad():
        for blk in bad.blocks:
            blk.attn.wo.weight.chunk(tpn, 0)[r].zero_()
    return bad


def tp_paged_checks(pa, gpu):
    """Gate (a) for the paged kernels: decode and verify, float (bf16)
    and int8 pools, at each rank shape of ``TP_PAGED_GEOMS``, held to the
    plain version (:func:`hold`), each refusing a planted fault (decode:
    each slot's last resident row dropped; verify: the self mask one row
    too wide; int8: each live slot's first page's scale doubled), and
    timed (device ms beside the plain version and the bound)."""
    out, worst = {}, {}
    lens = [0, 7, 16, 200, 512, 777, 1000, 1024]
    for name, hkv, g, c in TP_PAGED_GEOMS:
        rows = {}
        # bf16 decode
        args = paged_inputs(hkv, g, c, torch.bfloat16, lens)
        pl = args[4]
        got = pa.paged_decode_attention(*args, R - 1, 1)
        err, ratio = hold(got, plain32(pa, *args, R - 1, 1))
        fault = pa.paged_decode_attention(*args[:4], (pl - 1).clamp_min(0),
                                          *args[5:], R - 1, 1)
        ref32 = plain32(pa, *args, R - 1, 1)
        fault_ratio = min(hold(fault[i], ref32[i])[1]
                          for i, n in enumerate(lens) if n > 0)
        ms = device_ms(lambda i: pa.paged_decode_attention(*args, R - 1, 1),
                       reps=20)
        plain_ms = device_ms(lambda i: pa.paged_decode_attention_reference(
            *args, R - 1, 1), reps=5)
        bound, by = decode_bound(args[0], args[1], pl, R - 1,
                                 args[5].shape[-1] * args[5].element_size())
        rows["decode"] = {"err_over_tol": ratio, "max_abs_err": err,
                          "fault_dropped_row_min_err_over_tol": fault_ratio,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None}
        # bf16 verify
        vlens = [min(n, PMAX * PS - TP_VERIFY_T) for n in lens]
        vargs = verify_inputs(hkv, g, c, TP_VERIFY_T, torch.bfloat16, vlens)
        got = pa.paged_verify_attention(*vargs, 1)
        ref32 = plain32_verify(pa, *vargs, 1)
        err, ratio = hold(got, ref32)
        peek = verify_peek(*vargs, 1)
        fault_ratio = hold(got, peek)[1]
        ms = device_ms(lambda i: pa.paged_verify_attention(*vargs, 1),
                       reps=20)
        plain_ms = device_ms(lambda i: pa.paged_verify_attention_reference(
            *vargs, 1), reps=5)
        bound, by = verify_bound(vargs[0], vargs[3], vlens)
        rows["verify"] = {"err_over_tol": ratio, "max_abs_err": err,
                          "fault_self_mask_wide_err_over_tol": fault_ratio,
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None}
        # the int8 branches
        for kind in ("decode", "verify"):
            tt = None if kind == "decode" else TP_VERIFY_T
            kl = lens if tt is None else vlens
            iargs, planes = int8_case(kind, hkv, g, c, torch.bfloat16, kl, tt)
            bt = iargs[3] if kind == "decode" else iargs[5]
            r = R - 1 if kind == "decode" else None
            got = int8_run(pa, kind, iargs, planes, 1, r)
            err, ratio = hold(got, int8_run(pa, kind, iargs, planes, 1, r,
                                            plain=True))
            live = [i for i, n in enumerate(kl) if n > 0]
            doubled = [p.clone() for p in planes]
            for p in doubled:
                p[1, bt[live, 0].long()] *= 2.0
            fref = int8_run(pa, kind, iargs, doubled, 1, r, plain=True)
            fault_ratio = min(hold(got[i], fref[i])[1] for i in live)
            ms = device_ms(lambda i: int8_run(pa, kind, iargs, planes, 1, r),
                           reps=20)
            plain_ms = device_ms(lambda i: int8_run(
                pa, kind, iargs, planes, 1, r, plain=True), reps=5)
            scale_bytes = 2 * 4 * sum(-(-n // PS) for n in kl) * hkv
            if kind == "decode":
                bound, by = decode_bound(
                    iargs[0], iargs[1], iargs[4], r,
                    iargs[5].shape[-1] * iargs[5].element_size(), scale_bytes)
            else:
                bound, by = verify_bound(iargs[0], iargs[3], kl, 2,
                                         scale_bytes)
            rows[f"{kind}_int8"] = {
                "err_over_tol": ratio, "max_abs_err": err,
                "fault_scale_doubled_min_err_over_tol": fault_ratio,
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": by, "library_ms": None}
        for k, row in rows.items():
            faults = [v for n, v in row.items() if n.startswith("fault")]
            if not row["err_over_tol"] <= 1.0 or not all(
                    f > 1.0 for f in faults):
                raise AssertionError(f"serve_tensor: paged {k} at {name}: "
                                     f"{row}")
            worst[k] = max(worst.get(k, 0.0), row["max_abs_err"])
        out[name] = {"hkv": hkv, "g": g, "c": c, "lens": lens, **rows}
        del args, vargs
        gc.collect()
    return out, worst


def tp_matmul_checks(im, cfg, tpn: int):
    """Gate (a) for the int8 product at a rank's shapes of ``cfg``'s
    projections (column-parallel ``(N / tp, K)``: wqkv, w_up, the head;
    row-parallel ``(N, K / tp)``: wo, w_down) at ``TP_MATMUL_MS`` rows:
    held to the plain product (:func:`hold_matmul`), the rule refusing
    the product with the first column's scale doubled, and the kernel's
    device ms beside the plain version, cuBLAS on a bf16 copy and the
    bound."""
    d, c = cfg.n_embd, cfg.head_dim
    f = 4 * d
    shapes = {"wqkv": (d, (cfg.n_head + 2 * cfg.kv_heads) * c // tpn),
              "wo": (cfg.n_head * c // tpn, d), "w_up": (d, f // tpn),
              "w_down": (f // tpn, d), "head": (d, cfg.vocab_size // tpn)}
    out, worst = {}, 0.0
    for m in TP_MATMUL_MS:
        for name, (k, n) in shapes.items():
            codes, scale = int8_weights(k, n, seed=k + n + m)
            x = torch.randn(m, k, device=DEVICE, dtype=torch.bfloat16)
            got = im.int8_matmul(x, codes, scale)
            err, ratio = hold_matmul(got, x, codes, scale)
            bad = scale.clone()
            bad[0] *= 2.0
            fault = hold_matmul(got[:, :1], x, codes[:, :1], bad[:1])[1]
            copy16 = (codes.float() * scale).to(torch.bfloat16)
            ms = device_ms(lambda i: im.int8_matmul(x, codes, scale), reps=20)
            plain = device_ms(lambda i: im.int8_matmul_reference(
                x, codes, scale), reps=20)
            lib = device_ms(lambda i: x @ copy16, reps=20)
            bound, by = matmul_bound(m, k, n, 2)
            row = {"M": m, "K": k, "N": n, "max_abs_err": err,
                   "err_over_tol": ratio,
                   "fault_scale_doubled_err_over_tol": fault, "ms": ms,
                   "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
                   "bound_by": by, "kernel_over_library": ms / lib,
                   "plan": dict(im.plan(m, n, k))}
            if not ratio <= 1.0 or not fault > 1.0:
                raise AssertionError(f"serve_tensor: int8 {name} M={m}: "
                                     f"{row}")
            out[f"{name}_M{m}"] = row
            worst = max(worst, err)
            del copy16
    return out, worst


def tp_flash_check(fl):
    """Gate (a) for the flash forward at the sampler's prefill on a rank
    (``TP_FLASH``, bf16, causal, no dropout): out held by the flash
    phases' triangle rule (at most twice as far from the plain version
    in f32 as the plain bf16 version), lse by the f32 rule; the same rule
    refusing the plain version of a fault (two heads' keys swapped); its
    device ms beside the plain version, SDPA and the bound."""
    b, t, h, hkv, c = TP_FLASH
    q, k, v, _ = flash_inputs(b, t, h, hkv, c, torch.bfloat16, seed=11)
    out, lse = fl.flash_fwd(q, k, v, True)
    ref16 = fl.flash_forward_reference(q, k, v, True)
    ref32 = fl.flash_forward_reference(q.float(), k.float(), v.float(), True)
    own = (ref16[0].float() - ref32[0]).abs().max().item()
    reading = (out.float() - ref32[0]).abs().max().item() / (2 * own)
    lse_reading = ((lse - ref32[1]).abs() / (1e-5 + 1e-5 * ref32[1].abs())
                   ).max().item()
    ks = k.clone()
    ks[:, [0, 1]] = ks[:, [1, 0]]
    faulted = fl.flash_forward_reference(q.float(), ks.float(), v.float(),
                                         True)[0]
    fault = (out.float() - faulted).abs().max().item() / (2 * own)
    ms = device_ms(lambda i: fl.flash_fwd(q, k, v, True), reps=20)
    plain = device_ms(lambda i: fl.flash_forward_reference(q, k, v, True),
                      reps=5)
    kk = k.repeat_interleave(h // hkv, 1)
    vv = v.repeat_interleave(h // hkv, 1)
    lib = device_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        q, kk, vv, is_causal=True), reps=20)
    bound, by, _, _ = flash_bounds(b, t, h, hkv, c, 2)["fwd"]
    row = {"B": b, "T": t, "H": h, "Hkv": hkv, "C": c,
           "out_err_over_limit": reading, "lse_err_over_limit": lse_reading,
           "max_abs_err": (out.float() - ref32[0]).abs().max().item(),
           "fault_keys_swapped_err_over_limit": fault, "ms": ms,
           "plain_ms": plain, "library_ms": lib, "bound_ms": bound,
           "bound_by": by}
    if not (reading <= 1.0 and lse_reading <= 1.0 and fault > 1.0):
        raise AssertionError(f"serve_tensor: flash at a rank: {row}")
    return row


def world_of_one(serving, GPT, gpu):
    """Gate (e): a ``GroupTensorExchange`` at tensor 1 (a world of one over
    NCCL, in this process, torn down after) serves openwebtext's 8 first
    requests exactly as the plain engine does: every stream, and the
    carried logits and every page after the run, bit for bit."""
    import tempfile

    import torch.distributed as dist

    from midgpt_tpu_torch.config import MeshConfig, get_model_config
    from midgpt_tpu_torch.parallel.mesh import create_mesh, group_mesh

    cfg = get_model_config("openwebtext")
    model = card_model(GPT, cfg, SEED).to(torch.bfloat16)
    ps = prompts(cfg.vocab_size)[:8]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            sm = group_mesh(create_mesh(MeshConfig(fsdp=1, tensor=-1)),
                            DEVICE)
            runs = []
            for mesh in (None, sm):
                eng, streams = tp_serve(serving, model, ps, SERVE_TP_NEW,
                                        mesh=mesh)
                torch.cuda.synchronize()
                runs.append((eng, streams))
            (e0, s0), (e1, s1) = runs
            same = {"streams": s0 == s1,
                    "logits": bits_equal(e0.logits, e1.logits),
                    "pages": all(bits_equal(a, b) for a, b in zip(
                        engine_tensors(e0)[1:], engine_tensors(e1)[1:]))}
            grouped = e1.tensor is not None and e1.tensor.grouped
        finally:
            dist.destroy_process_group()
    if not all(same.values()) or not grouped:
        raise AssertionError(f"serve_tensor: a world of one differs from "
                             f"the plain engine {same}")
    return {"config": "openwebtext", "requests": len(ps),
            "max_new_tokens": SERVE_TP_NEW, "bit_equal": same}


def phase_serve_tensor(pa, im, fl, fn, serving, GPT, gpu):
    """Serving under the tensor axis (see the module docstring): returns
    the record, whose ``launches`` are the main path's."""
    import dataclasses

    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models.gpt import prefill_chunk_paged, tensor_copy
    from midgpt_tpu_torch.parallel.mesh import loopback_mesh
    from midgpt_tpu_torch.quant import dequantize_model, quantize_model
    from midgpt_tpu_torch.sampling import make_sampler
    from midgpt_tpu_torch.serving.paged import ShardedKVPool

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_model_config(XL_NAME), norm_impl="fused")
    tpn, n_layer = SERVE_TP, cfg.n_layer
    model32 = card_model(GPT, cfg, SEED)
    model = copy.deepcopy(model32).to(torch.bfloat16)
    mesh = loopback_mesh(tpn, DEVICE)
    m4 = tensor_copy(model, mesh.tensor)
    q4 = tensor_copy(quantize_model(model), mesh.tensor)
    ps = prompts(cfg.vocab_size)
    even, odd = ps[0::2], ps[1::2]
    rec = {"phase": "serve_tensor", "config": XL_NAME, "dtype": "bfloat16",
           "tensor": tpn, "n_layer": n_layer, "D": cfg.n_embd,
           "H": cfg.n_head, "C": cfg.head_dim, "V": cfg.vocab_size,
           "norm_impl": "fused", **SERVE, "max_new_tokens": SERVE_TP_NEW,
           "margin_rule": f"each served token's f32 logit (the stream "
                          f"re-forwarded through the unsharded model in "
                          f"f32) within {TP_MARGIN} of the largest",
           "gpu": gpu}
    kernels = {"paged_decode_attention": pa.paged_decode_attention,
               "paged_verify_attention": pa.paged_verify_attention,
               "int8_matmul": im.int8_matmul, "flash_fwd": fl.flash_fwd,
               "fused_rms_norm_fwd": fn.fused_rms_norm_fwd}
    b, p_len, s_new = SERVE_TP_SAMPLE
    sprompt = sample_prompt(cfg.vocab_size, p_len)[:b]

    def main_path():
        out = {}
        for name, mdl, sub, kw in (
                ("bf16", m4, even, {}),
                ("bf16_spec4", m4, odd, {"speculate": 4}),
                ("int8", q4, even[:2], {"kv_quant": "int8"}),
                ("int8_spec4", q4, odd[:2], {"kv_quant": "int8",
                                             "speculate": 4})):
            t0 = time.perf_counter()
            eng, streams = tp_serve(serving, mdl, sub, SERVE_TP_NEW,
                                    mesh=mesh, **kw)
            out[name] = (eng, streams, time.perf_counter() - t0, sub)
        out["sample"] = make_sampler(s_new, mesh=mesh, temperature=0.0,
                                     device=DEVICE)(m4, sprompt, 0)
        return out

    parts = {"setup": time.perf_counter() - t_phase}

    def part(name: str) -> None:
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    runs, wall, counts = counted(kernels, main_path)
    part("main_path")
    engines = {k: v for k, v in runs.items() if k != "sample"}
    steps = {k: e.window * (e.windows - e.verify_dispatches)
             for k, (e, _, _, _) in engines.items()}
    verifies = {k: e.verify_dispatches for k, (e, _, _, _) in engines.items()}
    fwd_int8 = sum(steps[k] + verifies[k] + engines[k][0].prefill_dispatches
                   for k in ("int8", "int8_spec4"))
    want = {"paged_decode_attention": tpn * n_layer * sum(steps.values()),
            "paged_verify_attention": tpn * n_layer * sum(verifies.values()),
            "int8_matmul": tpn * (4 * n_layer + 1) * fwd_int8,
            "flash_fwd": tpn * n_layer,
            # two norms a block and ln_f a forward; the sampler's prefill
            # and its s_new - 1 steps (each step's ln1/ln2/ln_f)
            "fused_rms_norm_fwd": None}
    rec["launches"] = counts
    rec["launches_per_virtual_rank"] = {
        k: v / tpn for k, v in counts.items() if k != "fused_rms_norm_fwd"}
    rec["launch_formula"] = ("paged decode = tp x n_layer x decode steps; "
                             "verify = tp x n_layer x verify dispatches; "
                             "int8 = tp x (4 n_layer + 1) x the int8 "
                             "engines' forwards; flash = tp x n_layer (the "
                             "sampler's prefill); every virtual rank the "
                             "same share")
    # every gate's failure, raised after the record is printed
    failed = [f"{k} launches {counts[k]} != {w}" for k, w in want.items()
              if w is not None and counts[k] != w]
    if not counts["fused_rms_norm_fwd"]:
        failed.append("the norm kernel never ran")
    rec["main_path"] = {
        k: {"requests": len(s), "wall_s": w, "decode_steps": steps[k],
            "verify_dispatches": verifies[k],
            "prefill_dispatches": e.prefill_dispatches,
            "graph_captures": e.graph_captures, "tp": e.tp,
            "prefill_sp": e.prefill_sp,
            "tokens_per_s": sum(len(x) for x in s) / w}
        for k, (e, s, w, _) in engines.items()}
    rec["main_path_wall_s"] = wall
    sample_out = runs["sample"]
    if sample_out.shape != (b, s_new):
        raise AssertionError(f"sampler shape {tuple(sample_out.shape)}")
    # (c) the margin rule: the served streams, the sampler's, a tp = 1
    # control and two planted faults
    # a copy of its own: the quantized model shares the embedding with
    # ``model``, which a cast in place would change
    dq32 = copy.deepcopy(dequantize_model(quantize_model(model))).float()
    gaps = {}
    for k, (_, s, _, sub) in engines.items():
        gaps[k] = stream_gaps(dq32 if k.startswith("int8") else model32,
                              sub, s)
    gaps["sample"] = stream_gaps(model32, list(sprompt),
                                 sample_out.cpu().tolist())
    ctrl_eng, ctrl = tp_serve(serving, model, even[:2], SERVE_TP_FAULT_NEW)
    gaps["control_tp1_bf16"] = stream_gaps(model32, even[:2], ctrl)
    off_eng, off = tp_serve(serving, m4, even[:2], SERVE_TP_FAULT_NEW,
                            mesh=mesh, prefill_sp="off")
    gaps["prefill_sp_off"] = stream_gaps(model32, even[:2], off)
    del ctrl_eng, off_eng
    faults = {}
    for fname, bad in (("wo_shard_zeroed", zero_wo_shard(m4, tpn, 2)),
                       ("kv_heads_swapped", swap_kv_heads(m4, tpn, 0, 1))):
        _, s = tp_serve(serving, bad, even[:2], SERVE_TP_FAULT_NEW,
                        mesh=mesh)
        faults[fname] = margin_reading(stream_gaps(model32, even[:2], s))
        del bad
        gc.collect()
    rec["margin"] = {k: {"max_gap": max(g), "mean_gap": float(np.mean(g)),
                         "not_argmax": int(sum(x > 0 for x in g)),
                         "tokens": len(g), "reading": margin_reading(g)}
                     for k, g in gaps.items()}
    rec["margin_faults_reading"] = faults
    part("margin_rule")
    del dq32
    bad = [k for k, g in gaps.items() if not margin_reading(g) <= 1.0]
    if bad:
        failed.append(f"the margin rule refuses {bad}")
    if not all(v > 1.0 for v in faults.values()):
        failed.append(f"the margin rule passes a planted fault {faults}")
    # (d) prefill_sp on against off, one chunk of 512, bit for bit
    pool = ShardedKVPool.init(cfg, 40, PS, torch.bfloat16,
                              torch.device(DEVICE), mesh.tensor)
    tok = torch.from_numpy(ps[-1][:512].astype(np.int64))[None].to(DEVICE)
    bt = torch.arange(PMAX, dtype=torch.int32, device=DEVICE)[None] % 40
    start = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    sp = [prefill_chunk_paged(m4, tok, start, pool.k, pool.v, bt,
                              cfg.block_size, resumed=False, sp=on)
          for on in (False, True)]
    rec["prefill_sp_on_equals_off"] = {
        "h": bits_equal(sp[0][0], sp[1][0]),
        "kv": all(bits_equal(a, c) for a, c in zip(
            sp[0][1] + sp[0][2], sp[1][1] + sp[1][2])),
        "max_abs_h_diff": (sp[0][0].float() - sp[1][0].float()).abs().max()
        .item()}
    del sp, pool
    part("prefill_sp")
    # (b) every replay against its eager body
    rep = TP_TIMING_REPS
    short = even[:4]  # lengths 16 .. 214: three prefill buckets
    rec["replay_vs_eager"] = {
        "decode_tp4": dispatch_check(serving, m4, short, rep, mesh=mesh),
        "verify_tp4": dispatch_check(serving, m4, spec_prompts(
            cfg.vocab_size)[::2][:4], rep, mesh=mesh, speculate=4),
        "int8_tp4": dispatch_check(serving, q4, short, rep, mesh=mesh,
                                   kv_quant="int8"),
        "decode_tp1": dispatch_check(serving, model, short, rep),
        "prefill_tp4": prefill_replay_check(serving, m4, starts=(0, 32),
                                            max_tokens=256, timing=False,
                                            mesh=mesh)}
    dec = rec["replay_vs_eager"]
    rec["decode_window_ms"] = {"tp4": dec["decode_tp4"]["device_ms"],
                               "tp1": dec["decode_tp1"]["device_ms"]}
    part("replay_vs_eager")
    del q4
    gc.collect()
    torch.cuda.empty_cache()
    # (a) the kernels at their rank shapes
    paged, paged_worst = tp_paged_checks(pa, gpu)
    mm, mm_worst = tp_matmul_checks(im, cfg, tpn)
    rec["kernels_at_rank_shapes"] = {"paged": paged, "int8_matmul": mm,
                                     "flash_fwd": tp_flash_check(fl)}
    rec["max_abs_err"] = {**paged_worst, "int8_matmul": mm_worst}
    part("kernels")
    # (e) a world of one
    del model, m4, model32
    gc.collect()
    torch.cuda.empty_cache()
    rec["world_of_one"] = world_of_one(serving, GPT, gpu)
    part("world_of_one")
    rec["seconds"] = time.perf_counter() - t_phase
    rec["seconds_by_part"] = parts
    emit(rec)
    if failed:
        raise AssertionError(f"serve_tensor: {failed}")
    return rec


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--mesh-steps":
        return mesh_steps_worker(*sys.argv[2:6])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from midgpt_tpu_torch import serving
    from midgpt_tpu_torch.config import get_model_config
    from midgpt_tpu_torch.models.gpt import GPT
    from midgpt_tpu_torch.ops import build
    from midgpt_tpu_torch.ops import paged_attn as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    gpu = gpu_line()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    # the data feed's gather library (g++), before any train phase
    from midgpt_tpu_torch import native

    t0 = time.perf_counter()
    native.load_library()
    emit({"phase": "build", "seconds": seconds,
          "native_gather": {"library": native.library_path(),
                            "seconds": time.perf_counter() - t0},
          "sources": build.SOURCES, "gpu": gpu,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "kernels": {k: compiled_kernels(build, k, v)
                      for k, v in logs.items()},
          "dynamic_smem_bytes": dynamic_smem(build, pa)})

    kernel_err = phase_kernel(pa)
    cfg = get_model_config("openwebtext")
    model, launches = phase_serve(pa, serving, GPT, cfg)
    from midgpt_tpu_torch.ops import int8_matmul as im

    phase_graphs(pa, im, serving, model, cfg, gpu)
    phase_prefill_graphs(serving, model, gpu)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    timing = phase_timing(pa, cfg, gpu)
    verify_err = phase_verify_kernel(pa)
    long_err, long_times = phase_long_table(pa, gpu)
    spec = phase_serve_spec(pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tverify = phase_timing_verify(pa, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    int8_err = phase_kernel_int8(pa)
    serve8 = phase_serve_int8(pa, im, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    t8 = phase_timing_int8(pa, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    mm_err = phase_int8_matmul_kernel(im, cfg)
    tmm = phase_timing_int8_matmul(im, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    prefix = phase_serve_prefix(pa, im, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_serve_pressure(pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    spill = phase_serve_spill(pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    model, ref, _ = phase_serve_telemetry(pa, serving, GPT, cfg, gpu)
    phase_frontdoor(pa, serving, model, cfg, ref, gpu)
    clus = phase_cluster(pa, serving, model, cfg, ref, gpu)
    disagg = phase_disagg(pa, serving, model, cfg, ref, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_cluster_chaos(pa, serving, model, cfg, ref, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_affinity(pa, serving, model, cfg, gpu)
    fdc = phase_frontdoor_cluster(pa, serving, model, cfg, ref, gpu)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    serve_moe = phase_serve_moe(pa, serving, GPT, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    from midgpt_tpu_torch.ops import flash as fl
    from midgpt_tpu_torch.ops import fused_attn as fa

    samp = phase_sample(fl, fa, im, serving, GPT, cfg, gpu)["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    train_kernel_err = phase_train_kernel(fa)
    train = phase_train(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    parity = phase_parity(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    ttrain = phase_timing_train(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    dots = phase_remat_dots(fa, gpu, train, parity)
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_remat(gpu, parity)
    gc.collect()
    torch.cuda.empty_cache()
    train_moe = phase_train_moe(fa, gpu, train)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_moe(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()

    flash_err = phase_flash_kernel(fl)
    char = phase_train_char(fl, fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_char(fl, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tflash = phase_timing_flash(fl, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    from midgpt_tpu_torch.ops import dropout as kd

    seed_check = phase_flash_seed(fl)
    dropout_err = phase_dropout_kernel(kd)
    tdrop = phase_timing_dropout(kd, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    window = phase_train_window(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tmesh = phase_train_mesh(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    ring = phase_ring(fl, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tseq = phase_train_sequence(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tensor = phase_tensor(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    ttensor, xl_ref = phase_train_tensor(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    pipe = phase_pipeline(fa, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tpipe = phase_train_pipeline(gpu, xl_ref, ttensor)
    gc.collect()
    torch.cuda.empty_cache()

    from midgpt_tpu_torch.ops import fused_norm as fn

    split_err = phase_split_kernel(fa)
    norm_err = phase_norm_kernel(fn)
    long = phase_train_long(fa, fn, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    phase_parity_long(fa, fn, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    serve_norm = phase_serve_norm(fn, pa, serving, GPT, cfg, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    stp = phase_serve_tensor(pa, im, fl, fn, serving, GPT, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    tlong = phase_timing_long(fa, fn, gpu)

    def rank_shapes(kind):
        """serve_tensor's timings of a paged kernel at each rank shape."""
        return {g: {k: r[kind][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms",
                                             "max_abs_err")}
                for g, r in stp["kernels_at_rank_shapes"]["paged"].items()}

    paged_kernels = ("paged_split_kernel<bf16, {}, 64> (splits; each "
                     "(slot, KV head)'s last block merges)")
    kernels = [{
        "name": "paged_decode_attention",
        "kernel": paged_kernels.format("bf16"),
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
        "replaces": "midgpt_tpu/ops/paged_attn.py:302",
        "launches": launches,
        "serve_moe_launches": serve_moe["moe"]["decode_kernel_launches"],
        "cluster_launches": clus["decode_launches"],
        "disagg_launches": disagg["p1_d1"]["decode_launches"],
        "frontdoor_cluster_launches": fdc["decode_launches"],
        "serve_spill_launches": {k: r["decode_launches"]
                                 for k, r in spill.items()
                                 if isinstance(r, dict) and "int8" not in k
                                 and r.get("decode_launches")},
        "max_abs_err": timing["max_abs_err"],
        "kernel_phase_max_abs_err": kernel_err,
        "long_table_phase_max_abs_err": long_err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None,
        "long_table_32768": {g: t["decode"] for g, t in long_times.items()},
        "serve_tensor_launches": stp["launches"]["paged_decode_attention"],
        "tensor_rank_shapes": rank_shapes("decode"),
    }, {
        "name": "paged_verify_attention",
        "kernel": paged_kernels.format("bf16"),
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
        "replaces": "midgpt_tpu/ops/paged_attn.py:531",
        "launches": spec["verify_kernel_launches"],
        "serve_moe_launches": serve_moe["spec_on"]["verify_kernel_launches"],
        "disagg_spec_launches": disagg["p2_d1_spec4"]["verify_launches"],
        "serve_spill_launches": {k: r["verify_launches"]
                                 for k, r in spill.items()
                                 if isinstance(r, dict)
                                 and r.get("verify_launches")},
        "max_abs_err": tverify["max_abs_err"],
        "verify_kernel_phase_max_abs_err": verify_err,
        "ms": tverify["ms"], "plain_ms": tverify["plain_ms"],
        "bound_ms": tverify["bound_ms"], "bound_by": tverify["bound_by"],
        "library_ms": None,
        "long_table_32768": {g: t["verify"] for g, t in long_times.items()},
        "serve_tensor_launches": stp["launches"]["paged_verify_attention"],
        "tensor_rank_shapes": rank_shapes("verify"),
    }]
    for kind, line, run, counter in (
            ("decode", 302, "int8_off", "decode_launches"),
            ("verify", 531, "int8_on", "verify_launches")):
        kernels.append({
            "name": f"paged_{kind}_attention[int8]",
            "kernel": paged_kernels.format("int8_t"),
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/paged_decode.cu",
            "replaces": f"midgpt_tpu/ops/paged_attn.py:{line}",
            "launches": serve8[run][counter],
            **({"serve_spill_launches": {
                k: spill[k]["decode_launches"]
                for k in ("a_ample_int8", "e_spill_int8")}}
               if kind == "decode" else {}),
            "max_abs_err": t8[kind]["max_abs_err"],
            "kernel_int8_phase_max_abs_err": int8_err,
            "ms": t8[kind]["ms"], "plain_ms": t8[kind]["plain_ms"],
            "bound_ms": t8[kind]["bound_ms"],
            "bound_by": t8[kind]["bound_by"], "library_ms": None,
            "tensor_rank_shapes": rank_shapes(f"{kind}_int8"),
        })
    # the int8 weight product: one decode step's 49 launches (M = 8) summed,
    # the verify and prefill row counts beside; no Pallas kernel computes
    # it (XLA fuses the convert into the dot)
    step = tmm["forms"]["decode"]
    kernels.append({
        "name": "int8_matmul",
        "kernel": "int8_gemv_kernel<MT, true> (mma.sync, codes^T as A, "
                  "M <= 48) + int8_mm_wgmma_kernel<true> (codes^T as the "
                  "register operand, M > 48); codes converted in "
                  "registers; K split over a thread block cluster where "
                  "the tiles leave SMs idle, summed in its shared memory",
        "route": "cuda",
        "source": "midgpt_tpu_torch/csrc/int8_matmul.cu",
        "replaces": "midgpt_tpu/quant.py:100",
        "launches": serve8["int8_off"]["int8_matmul_launches"],
        "serve_prefix_launches": prefix["cache_on_int8"][
            "int8_matmul_launches"],
        "sample_launches": samp["int8_matmul"],
        "max_abs_err": step["max_abs_err"],
        "int8_matmul_kernel_phase_max_err_over_tol": mm_err,
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": "bytes",
        "library_ms": step["library_ms"],
        "ms_is": "one decode step's 49 launches at M = 8, summed",
        "serve_tensor_launches": stp["launches"]["int8_matmul"],
        "tensor_rank_shapes": {
            k: {f: r[f] for f in ("M", "K", "N", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms",
                                  "max_abs_err")}
            for k, r in stp["kernels_at_rank_shapes"]["int8_matmul"].items()},
        "kernel_over_library": step["kernel_over_library"],
        **{form: {k: tmm["forms"][form][k] for k in (
            "M", "ms", "plain_ms", "bound_ms", "library_ms",
            "kernel_over_library", "max_abs_err")}
           for form in ("verify", "prefill")},
    })
    for kind, name, line, out, kernel in (
            ("fwd", "fused_attention_fwd", 137, "out",
             "fused_fwd_prep_kernel<64> + fused_fwd_wgmma_kernel<64>"),
            ("bwd", "fused_attention_bwd", 444, "dqkv",
             "fused_bwd_prep_kernel<64> + fused_bwd_tile_kernel<64, true> "
             "+ fused_bwd_post_kernel<64>")):
        kernels.append({
            "name": name, "kernel": kernel, "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_attn.cu",
            "replaces": f"midgpt_tpu/ops/fused_attn.py:{line}",
            "launches": train[f"fused_{kind}_launches"],
            "train_moe_launches": train_moe[f"fused_{kind}_launches"],
            "remat_dots_launches": dots["runs"]["dots"][
                f"fused_{kind}_launches"],
            "train_mesh_launches": tmesh["fused_launches"][
                f"fused_attn.fused_attention_{kind}"],
            # the tensor axis: the loopback's checked bf16 runs (one launch
            # a virtual rank and block, H / tensor heads), openwebtext_xl
            # through the launcher, and each launch at a rank's shapes
            "tensor_launches": tensor["launches"][
                f"fused_attention_{kind}"],
            "train_tensor_launches": ttensor["launcher"]["fused_launches"][
                f"fused_attn.fused_attention_{kind}"],
            # the pipeline axis: the loopback's checked bf16 runs (2 L / S
            # forward a stage and microbatch before the last, L / S on
            # the last, L / S backward), and one replay of train() at
            # pipeline=4
            "pipeline_launches": pipe["launches"][
                f"fused_attention_{kind}"],
            "train_pipeline_replay_launches": tpipe[
                "replay_fused_launches"][f"fused_attn.fused_attention_{kind}"],
            "tensor_rank_shapes": {
                n: {k: r[k][kind] for k in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}
                for n, r in tensor["timing"].items()},
            **({"sample_launches": samp["fused_attention_fwd"]}
               if kind == "fwd" else {}),
            "max_abs_err": ttrain["max_abs_err_vs_plain_f32"][out],
            "train_kernel_phase_max_abs_err": train_kernel_err,
            "ms": ttrain["ms"][kind], "plain_ms": ttrain["plain_ms"][kind],
            "bound_ms": ttrain["bound_ms"][kind],
            "bound_by": ttrain["bound_by"][kind],
            "library_ms": ttrain["library_ms"][kind],
        })
    # the forward also at one train_long microbatch (B=4, T=2048)
    kernels[-2]["t2048"] = {k: ttrain["fwd_t2048"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
    for kind, line, outs, kernel in (
            ("fwd", 156, ("out",), "flash_fwd_wgmma_kernel<64>"),
            ("dq", 300, ("dq", "delta"),
             "flash_dq_tile_kernel<64, true, true> (forms delta)"),
            ("dkv", 367, ("dk", "dv"), "flash_dkv_tile_kernel<64, true>")):
        counter = "flash_fwd" if kind == "fwd" else f"flash_bwd_{kind}"
        # the main path's dq forms delta: its time and bound are those of
        # dq_delta; dq given delta stands beside it
        row = "dq_delta" if kind == "dq" else kind
        kernels.append({
            "name": counter, "kernel": kernel, "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/flash.cu",
            "replaces": f"midgpt_tpu/ops/flash.py:{line}",
            "launches": char["launches"][counter],
            **({"sample_launches": samp["flash_fwd"]} if kind == "fwd"
               else {}),
            "max_abs_err": max(tflash["max_abs_err_vs_plain_f32"][o]
                               for o in outs),
            "flash_kernel_phase_max_abs_err": flash_err,
            "ms": tflash["ms"][row], "plain_ms": tflash["plain_ms"][row],
            "bound_ms": tflash["bound_ms"][row],
            "bound_by": tflash["bound_by"][row],
            "library_ms": (tflash["library_ms"]["sdpa_fwd_dropout"]
                           if kind == "fwd" else None),
        })
        kernels[-1]["seed_by_pointer"] = seed_check
        if kind == "fwd":
            kernels[-1]["serve_tensor_launches"] = stp["launches"]["flash_fwd"]
            kernels[-1]["tensor_rank_shape"] = {
                k: stp["kernels_at_rank_shapes"]["flash_fwd"][k] for k in (
                    "B", "T", "H", "Hkv", "C", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err")}
        kernels[-1]["train_window_launches"] = window["shakespeare_char"][
            "train"][WINDOW_K]["launches"][counter]
        # sequence parallelism: every ring hop and Ulysses' local
        # attention (the ring phase's checked runs), and train() with
        # attn_impl ring / ulysses on the one-rank mesh
        kernels[-1]["ring_launches"] = ring[counter]
        kernels[-1]["train_sequence_launches"] = {
            impl: tseq[impl]["launches"].get(counter, 0)
            for impl in SEQ_IMPLS}
        if kind == "dq":
            kernels[-1]["given_delta"] = {
                k: tflash[k]["dq"] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")}
        # no library call does one kernel's share of the backward alone:
        # the three kernels summed beside SDPA forward + backward with
        # dropout_p at the same shape
        kernels[-1]["fwd_dq_dkv_vs_library"] = {
            "fwd_plus_dq_delta_plus_dkv_ms": (
                tflash["ms"]["fwd"] + tflash["ms"]["dq_delta"]
                + tflash["ms"]["dkv"]),
            "sdpa_fwd_bwd_dropout_ms": tflash["library_ms"][
                "sdpa_fwd_bwd_dropout"]}
    # the keyed residual dropout: no Pallas kernel computes it (JAX draws
    # jax.random.bernoulli inside the jitted step)
    kernels.append({
        "name": "keyed_dropout",
        "kernel": "keyed_dropout_kernel<bf16, true> (16 bytes a thread; "
                  "<T, false> for a misaligned pointer)",
        "route": "cuda", "source": "midgpt_tpu_torch/csrc/dropout.cu",
        "replaces": "midgpt_tpu/models/layers.py:218",
        "launches": char["launches"]["keyed_dropout"],
        "train_window_launches": window["shakespeare_char"]["train"][
            WINDOW_K]["launches"]["keyed_dropout"],
        "max_abs_err": tdrop["max_abs_err_vs_plain"],
        "dropout_kernel_phase_elements_differing": dropout_err,
        "ms": tdrop["ms"], "plain_ms": tdrop["plain_ms"],
        "bound_ms": tdrop["bound_ms"], "bound_by": tdrop["bound_by"],
        "library_ms": None,
    })
    t2048 = tlong["split"]["t2048"]
    # the split route: the pre-pass (the LN + RoPE, _ln_rope at :91, that
    # the Pallas split kernels run inside their walks), then the two
    # kernels; times exclude the pre-pass, which has its own entry
    for kind, line, kernel, outs in (
            ("prep", 91, "fused_bwd_prep_kernel<64>",
             ("qhat", "khat", "delta")),
            ("dq", 292, "fused_dq_tile_kernel<64>", ("dq",)),
            ("dkv", 365, "fused_bwd_tile_kernel<64, false>",
             ("dk_h", "dv_h"))):
        kernels.append({
            "name": f"fused_attention_bwd_{kind}", "kernel": kernel,
            "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_attn.cu",
            "replaces": f"midgpt_tpu/ops/fused_attn.py:{line}",
            "launches": long["launches"][f"fused_bwd_{kind}"],
            "max_abs_err": max(t2048["max_abs_err_vs_plain_f32"][n]
                               for n in outs),
            "max_abs_err_lnw_grad": (t2048["max_abs_err_vs_plain_f32"][
                "dwq" if kind == "dq" else "dwk"] if kind != "prep"
                else None),
            "split_kernel_phase_max_abs_err": split_err[
                "prep" if kind == "prep" else "split"],
            "ms": t2048["ms"][kind], "plain_ms": t2048["plain_ms"][kind],
            "bound_ms": t2048["bound_ms"][kind],
            "bound_by": t2048["bound_by"][kind],
            "library_ms": (None if kind == "prep"
                           else t2048["library_ms"]["sdpa_fwd_bwd"]),
        })
    tnorm = tlong["norm"]
    for kind, line in (("fwd", 35), ("bwd", 45)):
        kernels.append({
            "name": f"fused_rms_norm_{kind}", "route": "cuda",
            "source": "midgpt_tpu_torch/csrc/fused_norm.cu",
            "replaces": f"midgpt_tpu/ops/fused_norm.py:{line}",
            "launches": long["launches"][f"rms_norm_{kind}"],
            "serve_norm_launches": serve_norm["launches"][f"rms_norm_{kind}"],
            "serve_tensor_launches": (stp["launches"]["fused_rms_norm_fwd"]
                                      if kind == "fwd" else 0),
            "max_abs_err": tnorm["max_abs_err_vs_plain_f32"][
                "y" if kind == "fwd" else "dx"],
            "norm_kernel_phase_max_abs_err": norm_err,
            "ms": tnorm["ms"][kind], "plain_ms": tnorm["plain_ms"][kind],
            "bound_ms": tnorm["bound_ms"][kind],
            "bound_by": tnorm["bound_by"][kind],
            "library_ms": tnorm["library_ms"][kind],
        })
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(gpu, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
