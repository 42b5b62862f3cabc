#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases (any failed check raises, and the script exits non-zero):

1. device  — require CUDA; print the card's name and power limit, the
   TF32 switches (both off for the port's fp32 math) and cuDNN's
   ``deterministic`` (on) and ``benchmark`` (off) switches, which
   ``resolve_device`` sets so that two runs give the same bits.
2. build   — compile the hand-written kernels under
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a and load them.
3. kernels — hold each kernel against its plain PyTorch version at the
   shapes each path of phases 5 and 6 gives it (the coding kernels and
   encode_decode at the CNN's, the mamba, rwkv6, NanoGPT and moe families'
   sizes, ``PATHS``; the scan kernels at the mamba path's, the wkv kernels
   at the rwkv6 path's, at rwkv6-3b's full width and at the train path's
   client step (1, 4096, 40, 64; case ``train_rwkv6``), the window-attention
   kernels at the small local-attention model's and at gemma3-27b's full
   width) and at ragged small ones; the coding kernels also past their
   register tile and shared tables (cases ``s20*``: S = 20 shards of 2
   clients, calibrate at M = 2048, encode_decode at (S 20, C 40) and
   (S 50, C 100)), and at the shapes that pick each route of the redesigned
   calibrate (M' = 4 and M = 2048 at every P % 4, M = 63 unsplit and 64
   split) and encode_decode ((S 100, C 200): two passes of output rows;
   (S 130, C 140): w staged in chunks), and calibrate at FE's M' = 19 on
   the table1 path (``fe_round_m19``); both kernels' two launches must
   give the same bits.  encode_decode also at the reference benchmark's
   shape (C 100, S 4, P 500,000, ``bench_c100_s4``), with the kernel's
   time over ``torch.linalg.multi_dot``'s, ``torch.matmul(dec,
   torch.matmul(enc, w))`` (the kernel's order) and the operations bounds
   of fp32 FMAs and of 3xTF32 (useful and padded FLOPs).  Time kernel,
   plain version and one library call where one exists (device time from
   the CUPTI trace of torch.profiler, checked against CUDA events: a trace
   that records nothing, gives a kernel time under its bound or under 0.9
   of the kernel's
   back-to-back event time (where that is 0.2 ms or more), or a
   plain or library time under the bytes bound lost records, and the trace
   is taken again, up to 3 times, before an event time is used; a plain or
   library call of a millisecond or more is timed by events, back to back,
   and not traced, one of 100 ms or more by one call after a warm-up;
   each event time is printed beside its reading)
   beside the kernel's bound at the
   H100 SXM data-sheet peaks:
   3.35 TB/s, 67 TFLOP/s fp32 on the CUDA cores, 495 / 3 TFLOP/s for
   fp32-accurate matrix products on the tensor cores (3xTF32; attention's
   products), and for ``exp`` 16 per clock per SM on 132 SMs at 1.98 GHz.
   Tolerances: coded_matmul / rounds / calibrate / encode_decode fp32
   |k - r| <= 1e-5 + 1e-5|r|, bf16 within one bf16 ulp (calibrate at
   M >= 63 with eq. 3's coefficient scale, 1/M); encode_decode's round
   trip returns w within 1e-3 (all clients) and 2e-3 (S of them), as
   tests/test_round_engine.py holds the reference's; ssm_scan |k - r| <=
   2e-4 + 2e-4|r| (tests/test_kernels.py's tolerance for this kernel),
   also with tiny dt (softplus(-9): abar within 1e-3 of 1) and large dt
   (dt a down to -60: abar underflows inside a sub-chunk's product) at the
   path's shape (the time split) and at (2, 1024, 4096, 16);
   ssm_scan_bwd |k - r| <= 1e-3|r| + 1e-4 max|r| (fp32 sums over up to
   16,384 channels and 2,048 steps in another order than autograd's), also
   where D is not a multiple of its 64-channel blocks (n = 8 and 16) and at
   n = 4 (one lane a channel), always from the forward's checkpoints; wkv
   |k - r| <= 5e-4 + 5e-4|r| (tests/test_kernels.py's tolerance for this
   kernel), also on every 64-step chunk of the full-width call as a
   sequence of its own (``chunk_walk_proxy``); wkv_bwd as
   ssm_scan_bwd, also at head sizes padded to 32 (N = 27, two sweeps; N =
   20, one block) and at (2, 1024, 40, 64) with decays near 1 (lw =
   -exp(z - 6.5)) and at the clip (w = 1.9e-9 everywhere).  Both forwards
   are also timed at the path's shape as the paths launch them, in training
   mode with checkpoints (case ``fused_stage_train``); every forward case
   launches twice more with checkpoints, and y, h_last and the checkpoints
   must repeat bit for bit; both backwards' two launches bit-identical;
   the script fails if ptxas reports spills in any of the four recurrence
   kernels or in the window forward; window_attention |k - r| <= 1e-5 +
   1e-4|r|, also with window 1 (``window1``: every key tile but the
   diagonal masked) and at hd 27 (``ragged_hd27``: 4-byte cp.async);
   window_attention_bwd each gradient within 1e-4 of its largest entry
   (softmax sums over up to 1,024 keys and the G query heads of a kv head
   in another order; a gradient that is zero in exact arithmetic, window
   1's dq and dk, within 1e-4 of the case's largest gradient entry); both
   directions' two launches bit-identical.
3e. bf16   — the bf16 routes, as the TPU kernels take bf16 operands
   (``check_bf16_routes``): the coding kernels with bf16 coefficients and
   w (and fp32 coefficients with bf16 w) at the CNN path's shapes, past
   the register tile and ragged; ``ssm_scan`` with bf16 dt, b, c, x at the
   jamba serve's prefill, the mamba path's stage and ragged n and D;
   ``wkv`` with bf16 r, k, v, lw at rwkv6-3b's serve prefill (4, 512, 40
   heads of 64; the row in the ``kernels`` line) and train client step
   (1, 4,096, 40 of 64), the rwkv6 path's stage and N = 27; each against
   its plain version at the
   fp32 case's tolerance and bit for bit against the fp32 kernel on the
   widened operands (widening in the load is exact), one case's backward
   (the fp32 kernels on the widened saved operands, gradients cast);
   ``window_attention``'s two bf16 routes (P rounded to bf16): wgmma and
   TMA (``window_attn_tma.cu``) at gemma3-27b's layer, window 1 (hd 64),
   hd 128 with window >= S at H / KV 1 and ragged S, hd 64 at H / KV 4
   and ragged S, and q, k, v as strided views of one (B, S, (H + 2 KV) hd)
   projection; ``mma.sync.m16n8k16`` at the local model's hd 16 and at
   hd 27; each case against its plain version's bf16 arithmetic within
   2^-8 (max|v| + |r|), two launches bit-identical; each wgmma case's
   mma.sync route held the same way and timed against it in turns in the
   same call (``parent_ms``: the route every bf16 call took before); each
   timed beside its bound at the bf16 tensor-core rate (989 TFLOP/s) and
   F.scaled_dot_product_attention at bf16; ``sass`` counts the wgmma
   kernel's HGMMA and UTMALDG instructions in ``cuobjdump -sass`` of the
   built library (the script fails on none).  ``coded_matmul_rounds`` at
   the CNN stage's shape (P = 2 mod 4: the pair route), bf16 and fp32
   operands: bit for bit the 4-column route on the same data padded to P
   + 2, the single-column route and ``coded_matmul`` on each round copied
   contiguous, within 1e-5 of the plain version, and timed in turns with
   the single-column route every such call took before (``parent_ms``).
   These rows join the
   ``kernels`` line as ``<kernel>_bf16``.  Beside them: each recurrence
   case's bf16 and fp32 route (on the widened inputs) timed in turns in
   the same call (``bf16_over_fp32``; at jamba's shape the scan's two
   instantiations' registers), and ``torch.mm`` / ``torch.bmm`` with
   ``out_dtype=float32`` on the bf16 coding operands as the library call
   of the encode rows (or the error the card's PyTorch gives).
4. small   — tiny scenarios on the card and on the CPU (plain versions):
   classification (2 shards, on the fused and on the ``legacy`` engine,
   whose coded store encodes per-client trees a round at a time; and 20
   shards of 2 clients: the coding kernels past S = 16), and generation
   with the mamba, rwkv6, NanoGPT and moe families
   (tests/test_scenario_zoo.py's configuration; for moe every router
   call's experts equal on the card and the CPU, checked first), one SGD
   step of ``reduce_for_smoke(jamba-1.5-large-398b)`` (a global layer,
   then a mamba layer with an MoE FFN: ssm_scan and its backward beside
   the MoE router; routing equal, then loss and gradients at the rwkv6
   step's tolerances), and a local-attention model (NanoGPT cut to 2
   layers "local", "global", d_model 64, 4 heads of 16 over 2 kv heads,
   window 16 < 64 tokens) through the port's FLSimulator: StoreStats
   equal, models within rtol 1e-3 / atol 1e-4.  The rwkv6 stage amplifies
   fp32 rounding chaotically (a CPU run ends as far from itself with
   one-ulp-perturbed initial weights as from the card), so
   there the stage's models are held to twice that one-ulp spread; so is
   the 20-shard scenario's, whose decode operator (the reference's quorum
   at S = 20, C = 40) has entries near 7e4 and amplifies rounding.  For
   rwkv6, NanoGPT and the local-attention model one SGD step's loss and
   gradients are held at 1e-5 rel and 1e-4|r| + 5e-5 max|r|; so are the
   moe family's.
   table1_small — the port's verification suite (``run_verification``
   with SE, FE, FR, RR, the oracle and the no-unlearn baseline; two shadow
   federations, canaries, utility) at tests/test_verify.py's scenario (G
   6) and at the same cut to G 3, on the card and on the CPU: cost units
   equal, each candidate's models within rtol 1e-3 / atol 1e-4 or twice
   the one-ulp spread on the CPU, the attack's decisions differing in at
   most 2 % of the examples or twice as many as between the one-ulp CPU
   runs (at G 6 the stage is chaotic in fp32); then two card runs, the
   second with SE only: their metrics must be equal bit for bit.  The
   SE-only run is timed (wall and device-busy) as ``resolve_device`` sets
   cuDNN, then once more with ``cudnn.deterministic`` off: what the flag
   costs.
5. main    — five federated main paths through the port's entry points,
   each with its launch counts zeroed just before and read just after:
   (a) the paper CNN at full width (conv 16/32, fc 128, 28x28x1) in the
   paper's federation (100 clients, 20 per stage, S=4, L=10, 100 samples
   per client) with G cut from 30 to 10 rounds, (b) the generation task
   with the mamba family (``ScenarioConfig.paper_full(task="generation",
   model="mamba", global_rounds=2)``: the paper's federation with G cut
   from 30 to 2, 100 sequences of 64 tokens per client), (c) the same with
   the rwkv6 family (``model="rwkv6"``), (d) the same with the task's
   default family, the paper's NanoGPT (no ``model=``), whose global
   attention layers run the plain blockwise path and no kernel of their
   own, (f) the same with the moe family (``model="moe"``: 2 global
   layers with MoE FFNs of 4 experts, top-2, P = 63,904), whose router,
   dispatch and experts are plain torch ops.  The mamba and rwkv6 paths'
   G went from 10 to 5 when the NanoGPT path arrived, NanoGPT's from 10
   to 5 when the coding kernels' route checks arrived, and all four from
   5 to 2 when the mesh phase arrived (the script had reached 1,239 s of
   its 1,200 on a slow host), to keep the script inside its time
   limit.  On the
   NanoGPT path a diagnostic runs first: each op of one SGD step on the
   stage engine's stack of S*M models and on its first M (the fused
   engine's), their rows compared bit for bit.
   Each: one stage on the fused engine with the coded store, one SE
   request, one batched SE request over two shards, one stage on the stage
   engine; every kernel of the path must have launched.  The stage-engine
   stage runs under ``telemetry.configure(annotate_costs=True)``: a
   ``stage_cost`` line prints its program span's ``train_flops`` (every
   matrix product of every SGD step, forward and backward, and the
   recurrence kernels' arithmetic: ``roofline.analysis.train_step_flops``),
   ``train_bytes`` and ``encode_flops``, the stage's wall, the achieved
   TFLOP/s and its share of the 67 TFLOP/s fp32 peak, beside the card's
   name and power limit.  Then
   the checks: decoded round-0 locals average to the stored round-1
   global, a decode from another S-subset agrees, untouched shards are
   bit-identical, the two engines' coded slices are compared (logged; where
   they differ, beside round 0 retrained from initial weights moved by one
   ulp, the gap fp32 rounding alone opens), the ensemble is above chance (CNN test accuracy > 0.1;
   LM perplexity < 109, the uniform guess over the 109 symbols, on ten
   clients the stage did not sample: the task's test stream has a word
   inventory of its own).  Last, one fused shard round is profiled: wall
   time, then from one trace the kernels that take the time, their sum,
   their union (device-busy time) and the idle share, and each stream's
   records (cuDNN runs the grouped convolution's groups on streams of its
   own, so the CNN's sum exceeds its union);
   on the CNN path the round is measured again with
   ``cudnn.deterministic`` off (what the flag costs).
   (e) table1: the paper's Table 1 through ``run_verification`` in (a)'s
   federation at the paper CNN's width: FR, FE, RR and SE against the
   retrain oracle and the no-unlearn baseline, scored by the shadow attack
   (two shadow federations) and the utility probe; one line per candidate
   (MIA F1, wall, cost units, retain and test accuracy), the attack's
   training accuracy and the phase's seconds.  Fails when cost units miss
   G'·|retained|·epochs, a framework's F1 is not finite (RR's is left out
   where its models are not finite, and the line says so) or coded_matmul
   or calibrate did not launch; its counts join ``by_path`` as "table1".
   (s) service: the online unlearning service (``repro_torch.service``)
   on (a)'s trained session, right after (a); launch counts zeroed just
   before each serve of that session and read just after, their sum
   joining ``by_path`` as "service" (the tiny sessions and (e)'s training
   stage are not counted).  (a)
   ``sequenced_trace(even_requests(plan, 4), spacing=0.0, rounds=2)``
   served by FIFO on ``single_device_placement()`` and by ``window``
   (width 1.0) on four slots of the card (``DevicePlacement(devices=
   [cuda] * 4)``: a worker thread and a stream each): slots [0, 1, 2, 3]
   in one batch of 4 jobs on shards [0, 1, 2, 3], per-shard models bit
   for bit equal to the one-slot serve's, and equal ``coded_matmul`` and
   ``calibrate`` launches; both walls, and each serve's device-busy time
   (the union of its kernels' intervals) and idle share.  (b)
   ``poisson_trace(plan.clients, n=16, rate=4.0, seed=0, deadline=30.0,
   skew=1.0)`` under fifo, window (1.0) and sla (deadline 30.0) on four
   slots: p50, p95, p99, throughput, SLA hit rate.  (c) the chaotic plan
   of tests/test_faults.py (two corrupted slices a round, one transient
   failure a job) with slot 1 dead, on (a)'s trace and four slots: every
   request completes, models bit-identical to the fault-free serve,
   retries and recoveries > 0, no abort; on tests/test_faults.py's tiny
   session, trained once on the card and once on the CPU, the same plan
   and trace give equal ``FaultLedger.signature()``s.  (d) that serve's
   audit-chain head equal on the card and the CPU, and a resume from a
   journal with two of four requests committed re-dispatches only the
   other two.  (e) a traced serve of (a): its Chrome trace validates with
   a lane per slot; the disabled tracer's cost (tests/test_telemetry.py's
   arithmetic bound) against a fused CNN stage cut to G 2, traced and
   untraced.
   (t) durability, right after (s), launches zeroed before and read after
   (by_path "durability"): (a) (a)'s session, as the service left it, is
   captured and saved through ``CheckpointManager``, loaded onto the card
   and restored into a fresh session of the same configuration: every
   shard model, coded slice, round global and result model bit for bit,
   the reports equal with walls zeroed; one SE request on the original and
   on the restored session bit-identical; the same snapshot restored into
   a CPU session gives the same bytes; snapshot bytes and the save, load
   and restore seconds and MB/s.  (b) tests/_durability_crash_child.py's
   three-stage tiny session as ``chip_smoke.py durability-child
   baseline|crash|resume <dir>`` processes on the card: the crash exits
   137 after stage 1's requests, the resume's signature (every model,
   slice, result and the wall-free report) equals the baseline's.  (c) in
   process, a torn snapshot 1 and a crash after it: the resume falls back
   to snapshot 0 and ends on the baseline's signature.
   (u) tiering (by_path "tiering"): the snapshot of (t) restored again;
   one SE request on a ``TieredStore`` holding the stage's 10 rounds per
   budget: unlimited; hot at half the slice bytes under lru, stage_age and
   heat; warm only; cold only.  Unlimited equals the coded store bit for
   bit (models, every shared StoreStats field); every round read back
   through its tier within ``quant_error_bound`` of the exact slices; a
   lossy budget's SE models bit for bit those of SE on a plain coded store
   holding the same rounds through a plain torch int8 codec, their
   distance from the exact models printed beside tests/test_tiering.py's
   2e-2.  ``cold_corrupt`` (2 slices, scale 10) on tests/test_tiering.py's
   unit store on the card: recovered within 1e-4, 2 corrupted slices, 1
   recovered read; on the full-width cold store the read completes and
   flags the injected rows (what else it flags is printed).  The service's
   four-slot serve on the half-hot store: per-shard models bit-identical
   to a one-slot serve.
6. full    — one mamba mixer of jamba-1.5-large-398b at its published width
   (d_model 8192, d_inner 16384, state 16, conv 4, dt_rank 512; 420,331,520
   parameters) through ``mamba_block``, forward and backward on fp32
   inputs of shape (2, 4096, 8192): ``train_4k``'s sequence length, batch
   cut from 256 to 2, one mixer instead of 72 layers.  The scan kernels are
   timed alone at that shape, and the whole block.  Then one rwkv layer of
   rwkv6-3b at its published width (d_model 2560, 40 heads of 64, d_ff
   8960; 85,557,760 parameters) through ``apply_block_train`` (ln1,
   time-mix, ln2, channel-mix), forward and backward on fp32 input (8,
   4096, 2560): batch cut from 256 to 8, one layer of 32, no embedding.
   The wkv kernels are timed alone at that shape, and the whole layer.
   Then one local (sliding-window) layer of gemma3-27b at its published
   width (d_model 5376, 32 heads of 128 over 16 kv heads, window 1024,
   d_ff 21504; 412,887,552 parameters) through ``apply_block_train`` (ln1,
   q/k/v, RoPE, window attention, wo, ln2, gated MLP), forward and
   backward on fp32 input (2, 4096, 5376): batch cut from 256 to 2, one
   layer of 62, no embedding.  Its launch counts are zeroed before and
   read after; the window kernels are timed alone at that shape.  Last,
   one layer of granite-moe-3b-a800m at its published width (d_model 1536,
   24 heads of 64 over 8 kv heads, 40 experts of width 512, top-8,
   capacity factor 1.25; 100,727,808 parameters) through
   ``apply_block_train`` (ln1, global attention, ln2, MoE FFN), forward
   and backward on fp32 input (2, 4096, 1536): batch cut from 256 to 2,
   one layer of 32, no embedding; 16 groups of 512 tokens, capacity 128.
   It runs with each dispatch form (``moe_impl`` "einsum", then "gather"):
   each form's ms, peak memory and dropped share, and the gather form's
   output and gradients within 1e-4 of the einsum form's largest entry.
7. serve   — the LM serving path (``repro_torch.launch.serve``'s
   ``make_prefill_step`` / ``make_decode_step``) on the card in fp32 at the
   published widths of six configs, weights from ``init_params(cfg, 0,
   device="cuda")``: gemma3-27b cut from 62 layers to 6 (one 5:1
   superblock), batch 4, prompt 1536 > window 1024 (the rings wrap), 32
   greedy decode steps; rwkv6-3b cut from 32 to 4, batch 4, prompt 512, 32
   steps; jamba-1.5-large-398b cut from 72 to 2 (global, mamba) with the
   experts off (the dense FFN at d_ff 24576), batch 4, prompt 512, 32
   steps; granite-moe-3b-a800m cut to 2, batch 4, prompt 512, 32 steps;
   whisper-tiny whole, 1500 encoder frames, prompt 4, 60 steps;
   internvl2-2b whole, 256 patch tokens and a 64-token prompt, 32 steps.
   Launch counts zeroed just before each case's serve and read just after,
   their sum joining ``by_path`` as "serve"; window_attention, wkv and
   ssm_scan must have launched.  Each case: prefill ms, decode ms a token
   (the median step, by CUDA events: the loop never waits for the card),
   tokens/s, peak memory (and the case's own: less what earlier phases
   hold); every decode step's logits (and prefill's last)
   within 5e-3 + 5e-3|r| (the reference's bound) and 1e-3 + 1e-3|r|
   (near the measured spread) of ``forward_train`` at that position, a row
   at a time (granite with its capacity unbound, as tests/test_arch_smoke.py
   does: the drop depends on the group size).  gemma3 serves a second time
   (tokens and logits bit-identical), and one traced decode step gives its
   device-busy time and idle share.  gemma3, rwkv6-3b and jamba serve once
   more at their published numerics (``serve_bf16``: the weights cast to
   bf16, bf16 compute, fed the fp32 run's tokens; launches counted under
   their own path, "serve_bf16", jamba's mamba layer launching
   ``ssm_scan_bf16``): finite, and held against the port's CPU path at
   bf16 on the same weights and tokens at the case's first 2 rows, 32
   prompt tokens and 4 steps (``SERVE_BF16_HELD``): each token's logits
   row within twice its one-ulp spread (its largest L2 distance over
   three draws of every bf16 weight moved one ulp, on the card), as the
   CPU tests hold the port to the reference.  Reported beside: the gap to
   the fp32 run and the argmax share equal to its tokens, and a witness
   of that gap on the cut input (the fp32 run on the weights rounded to
   bf16: the weights' rounding alone).  Every
   ``reduce_for_smoke`` config of ``ASSIGNED_ARCHS`` and a gemma3 with
   window 16 < prompt 40 serve on the card and on the CPU, fed the same
   tokens: logits within 1e-4 + 1e-4|r| (tests/test_torch_serve.py's
   tolerance).  Phases 3b-3d hold the three kernels to their plain
   versions at the serve shapes (cases ``serve_*``, inference forwards).
8. train   — the production training steps (``repro_torch.launch.train``)
   at rwkv6-3b's published width (d_model 2560, 40 heads of 64, d_ff 8960,
   vocab 65,536) in fp32, depth cut from 32 to 8, weights from
   ``init_params(cfg, 0, device="cuda")``, the adamw server of the dry
   run's ``optimizer_for``: ``make_fedavg_step`` with 4 clients of one
   4,096-token sequence and one local step each (the reference dry run's
   ``FLConfig``; train_4k's global batch cut from 256 to 4), block remat;
   one warm-up step, then launches zeroed and 3 timed fedavg steps, one
   ``make_central_step`` (one client's sequence) and one
   ``make_calibration_step`` fed the last round's ``delta_norm`` as every
   client's stored norm, launches read.  Each step: wall (host clock to a
   sync), peak memory, tokens/s, ``mfu`` (``model_flops`` over the wall,
   as a share of the fp32 peak), loss and ``delta_norm`` (finite).  wkv
   and wkv_bwd must have launched (the training forward twice a layer a
   local step: forward and checkpoint recompute).  One traced fedavg step
   gives device-busy, idle share and the GEMMs' ms against the port's
   kernels'; the dry run's predicted bytes for the case are printed beside
   the measured peak.  ``make_central_step`` at remat "none" and "block"
   (one 2,048-token sequence, sgd at lr 1 and no clip, so each new leaf is
   p - g): loss and every leaf bit-identical, each one's peak memory.
   Then the bf16 case (``train_bf16``): the same steps' config at its
   published numerics (bf16 params and compute; ``TRAIN_BF16_CUT``:
   depth 8 only), 4 clients of 4,096 tokens, ``optimizer_for``'s choice;
   one warm-up and 2 timed fedavg steps, their launches counted under
   their own path, "train_bf16": step wall, tokens/s, peak memory against the dry run's bf16
   count, ``mfu`` against the bf16 peak (989 TFLOP/s), and one traced
   step's GEMM, port-kernel and other shares and its idle share.
   Then ``make_fedavg_step`` (sgd server) and ``make_calibration_step`` at
   ``reduce_for_smoke`` configs of rwkv6-3b, jamba-1.5-large-398b (global
   and mamba) and gemma3-27b (128 tokens past its window of 64) on the
   card and on the CPU from the same weights: metrics within 1e-4 rel,
   every new leaf within 1e-5 abs; ``wkv``, ``ssm_scan``,
   ``window_attention`` and their backwards must have launched there.
   The full-width steps' and the reduced card runs' launches join
   ``by_path`` as "train".
8b. mesh   — the training step sharded over a ``DeviceMesh``
   (``launch.mesh``, ``launch.shardings``, ``ShardCtx``): a world of one
   rank over NCCL (a ``FileStore``) with a (1, 1) mesh; rwkv6-3b at its
   published width in fp32, depth cut to 2, 2 clients of one 4,096-token
   sequence, the dry run's adamw server.  ``make_fedavg_step`` runs once
   through ``ShardCtx`` and DTensors (the published config's rules,
   ``launch.train.mesh_context``; the wkv kernels on each rank's shards
   through ``local_map``) and once unsharded, on the same weights and
   batch: the metrics within 1e-5 rel and the new params and moments by
   tests/test_torch_train.py's first-adamw-step rule; whether the two are
   bit-identical is printed.  After one warm-up step of each: both walls,
   one traced step of each (device-busy and idle share), the sharded
   step's launches (zeroed just
   before it, read just after; wkv and wkv_bwd must have launched: by_path
   "mesh"), and the dry run's per-card bytes of rwkv6-3b train_4k at full
   depth on 1x1, 1x4, 2x2 and 4x1.  Then, on the same world, the serve
   part (``mesh_serve_path``): (a) rwkv6-3b with the phase's own weights
   serves a batch of 4 with 512-token prompts and 8 greedy decode steps,
   (b) gemma3-27b at its published width in fp32, depth cut to one local
   and one global layer, 1,536-token prompts past its 1,024-token window
   (the local layer runs ``window_attention``, the ring wraps), and
   jamba-1.5-large-398b at its width, cut as phase 7 cuts it (global,
   mamba: ``ssm_scan``), 512-token prompts, a batch of 2 and 8 steps
   each; each twice, plainly and
   through ``launch.serve.MeshServer`` (prefill under the published
   config's serving strategy, the cache handed to decode's
   ``cache_shardings``, decode with slot-sharded caches: on a 1x1 mesh
   nothing is split), after a warm-up of each.  Logits and every cache
   leaf must be bit-identical; prefill ms, decode ms a token and one
   traced serve of each (busy ms, idle share) are printed, and the
   sharded serves' launches (zeroed just before each, read just after;
   window_attention, wkv and ssm_scan must have launched; each call's
   operand shapes and ms between CUDA events around it are printed) join
   ``by_path`` as "mesh_serve", with the part's seconds.
9. examples — each port example (``examples/<name>_torch.py``:
   quickstart, coded_storage, unlearn_generation, serve_unlearning,
   serve_batched) through its ``main`` on the card at the reference
   example's sizes and flags' defaults, launch counts zeroed just before
   each and read just after, their sum joining ``by_path`` as "examples":
   each example's printed lines, wall and launches.  Fails when a kernel
   the example runs did not launch (``EXAMPLES``), a printed metric is not
   finite, SE's impacted shards are not [0], or coded_storage's located
   clients are not [2, 11, 19] or a decode is more than 1e-3 off;
   serve_batched's sampled tokens are printed, not judged.
10. report — one JSON line listing the kernels (each row's numbers from
   the path it was ported for, every path's launches and times under
   ``by_path``), the card's name and power limit, and the final line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM, fp32 outside the tensor cores
# fp32-accurate products on the tensor cores: TF32 at 495 TFLOP/s dense
# (H100 SXM data sheet), three TF32 products per fp32 product (3xTF32)
TF32X3_FLOPS_PER_S = 495e12 / 3
# exp on the special-function units: 16 per clock per SM, 132 SMs, 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9


T_START = time.perf_counter()
TRACE_TRIES = 3       # CUPTI traces taken before falling back to events
TRAINED: dict = {}    # path -> (its trained FederatedSession, make_sim)


def log(tag: str, **kw) -> None:
    print(json.dumps({"phase": tag, "t_s": time.perf_counter() - T_START,
                      **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str) -> list:
    """[kernel (mangled, cut to 100 characters), registers and shared
    memory, spills] for each entry function in nvcc's ``-Xptxas -v``
    output."""
    rows, name, spill = [], None, ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1][:100]
        elif "spill" in ln:
            spill = ln.strip()
        elif "registers" in ln and name:
            rows.append([name, ln.split(":", 1)[1].strip(), spill])
            name = None
    return rows


def time_ms(fn, iters: int) -> float:
    """Median per-call time of ``fn`` between two CUDA events, after two
    warm-up calls.  For a call of a few microseconds this is the host's
    enqueue time (Python checks, the launch), not the device's."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# the device records that are work, by their category in the profiler's
# trace: the GPU side of ``record_function`` ranges
# (``gpu_user_annotation``) and the stream syncs span other work and are
# left out
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def device_records(fn):
    """(host seconds of ``fn`` under the profiler, its device records):
    one (name, stream, start us, end us) per kernel, copy and fill ``fn``
    launched, from torch.profiler's CUPTI trace as exported to Chrome's
    format (the one form that names each record's category in every
    torch version)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = Path(__file__).resolve().parent / "build" / "device_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    path.unlink()
    return wall, [(e["name"], e.get("args", {}).get("stream"), e["ts"],
                   e["ts"] + e["dur"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_WORK]


def device_busy(fn):
    """What the card did while ``fn`` ran, from one trace
    (``device_records``): ``wall_s`` (host seconds of ``fn`` under the
    profiler), ``by_name`` (summed ms of each kernel, copy and fill),
    ``sum_ms`` (their total), ``busy_ms`` (the union of their intervals:
    work that overlaps counts once), ``by_stream`` ({stream: [records,
    summed ms, union ms]}), ``stream_overlap_ms`` (each stream's summed ms
    less its union, added over the streams: 0 when a stream's records run
    one after another, so that the sum's excess over ``busy_ms`` is work
    that ran at once on several streams), ``records``, ``distinct`` and
    ``streams``."""
    wall, recs = device_records(fn)
    by_name: dict = {}
    for name, _st, a, b in recs:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3
    by_stream = {}
    for st in sorted({st for _n, st, _a, _b in recs}, key=str):
        mine = [r for r in recs if r[1] == st]
        by_stream[str(st)] = [len(mine), sum(b - a for _n, _st, a, b in mine)
                              / 1e3, _union_ms(mine)]
    total = sum(b - a for _n, _st, a, b in recs) / 1e3
    return {"wall_s": wall, "by_name": by_name, "by_stream": by_stream,
            "sum_ms": total, "busy_ms": _union_ms(recs),
            "stream_overlap_ms": sum(n - u for _r, n, u in
                                     by_stream.values()),
            "records": len(recs), "distinct": len(set(recs)),
            "streams": len(by_stream)}


def _union_ms(recs) -> float:
    """ms covered by the union of the records' [start, end) intervals
    (in us)."""
    spans = sorted((a, b) for _n, _st, a, b in recs)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return (busy + hi - lo) / 1e3


def device_ms(fn, iters: int):
    """Device time per call of ``fn``: the CUPTI durations of every kernel,
    copy and fill it launches over ``iters`` calls, divided by ``iters``;
    None when the profiler records no device work."""
    fn()

    def many():
        for _ in range(iters):
            fn()
    d = device_busy(many)
    return d["sum_ms"] / iters if d["records"] else None


def batch_ms(fn, iters: int) -> float:
    """Per-call time of ``iters`` back-to-back calls between two CUDA
    events.  Where a call keeps the card busy longer than its host takes to
    launch it, the launches queue up and this is the device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


BATCH_CHECK_MS = 0.2  # a kernel call this long back to back is device-bound
SLOW_CALL_MS = 100.0  # a plain or library call this long is timed once


def one_call_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events, synchronized."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def timed(fn, iters: int, floor_ms: float = 0.0,
          batch: bool = False) -> dict:
    """Device time per call: CUPTI, cross-checked against CUDA events.  A
    trace that records nothing, reads under ``floor_ms`` (the least time
    the work can take) or, with ``batch`` (a kernel whose launch costs the
    host less than the card's work), under 0.9 of the back-to-back time of
    ``batch_ms`` where that is ``BATCH_CHECK_MS`` or more, lost records:
    it is taken again, up to ``TRACE_TRIES`` times, before an event time
    (an upper bound: it holds host time too) is used, the back-to-back one
    where it applies.  A plain or library call (no ``batch``) of a
    millisecond or more is timed back to back and not traced: either the
    card is busy throughout, or the host is and the call's time is its
    elapsed time (a trace of a plain loop's thousands of launches is what
    CUPTI loses records of).  A plain or library call whose first (warm-up)
    call takes ``SLOW_CALL_MS`` or more is timed by one more call alone:
    the plain loops at full width take 0.1-3 s a call, and are no
    yardstick of speed."""
    if not batch:
        first = one_call_ms(fn)
        if first >= SLOW_CALL_MS:
            ms = one_call_ms(fn)
            return {"ms": ms, "timer": "events, one call after a warm-up",
                    "event_ms": ms}
    ev = time_ms(fn, iters)
    if not batch and ev >= 1.0:
        return {"ms": min(batch_ms(fn, iters), ev),
                "timer": "events back to back", "event_ms": ev}
    evb = batch_ms(fn, iters) if batch and ev >= BATCH_CHECK_MS else None
    if evb is not None and evb < BATCH_CHECK_MS:
        evb = None
    for _ in range(TRACE_TRIES):
        ms = device_ms(fn, iters)
        if ms is not None and ms >= floor_ms and (evb is None or
                                                   ms >= 0.9 * evb):
            return {"ms": ms, "timer": "cupti", "event_ms": ev}
    if evb is not None:
        return {"ms": min(evb, ev), "timer": "events back to back "
                "(no full trace)", "event_ms": ev}
    return {"ms": ev, "timer": "events (no trace at or over the bound)",
            "event_ms": ev}


def host_us(fn, calls: int = 200) -> float:
    """The host's time to issue one call of ``fn`` (the wrapper's checks,
    allocations, argument set-up and the launch), in microseconds: the
    wall-clock time of ``calls`` calls issued back to back with no
    synchronization between them, over ``calls``, after a warm-up; the
    card is synchronized before the first and after the last."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def timed_pair(a, b, iters: int, floor_ms: float) -> tuple:
    """Two routes of one kernel in one call: ``timed`` (batch) of ``a`` and
    of ``b`` in turns, a, b, b, a.  Returns each one's lesser reading and
    the timers of both readings; a reading that fell back to events holds
    host time, so the lesser of two is the one to compare."""
    got = {0: [], 1: []}
    for k in (0, 1, 1, 0):
        got[k].append(timed((a, b)[k], iters, floor_ms, batch=True))
    return tuple((min(r["ms"] for r in got[k]), [r["timer"] for r in got[k]])
                 for k in (0, 1))


def bound(nbytes: int, flops: int, exps: int = 0,
          flops_per_s: float = FP32_FLOPS_PER_S):
    """The least time for the work: bytes over the memory rate, or the
    operations over their peak rates (FLOPs at ``flops_per_s``: fp32 on the
    CUDA cores, or 3xTF32 for matrix products; exps), the larger.  Returns
    (ms, "bytes" or "operations", the bytes bound alone in ms)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / flops_per_s, exps / EXP_PER_S) * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes


def share(row: dict, bnd) -> dict:
    """Add the bound ``bnd`` (as ``bound`` returns it) and the roofline
    share to a timed row."""
    row.update(bound_ms=bnd[0], bound_by=bnd[1],
               roofline_share=bnd[0] / row["ms"])
    return row


def compare(got, ref, name: str, rtol: float = 1e-5,
            atol: float = 1e-5) -> dict:
    """Max abs/rel error and the pass test: fp32 |k-r| <= atol + rtol|r|,
    bf16 within one bf16 ulp of the larger magnitude."""
    import torch
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: kernel gives {got.dtype} "
                             f"{tuple(got.shape)}, plain version {ref.dtype} "
                             f"{tuple(ref.shape)}")
    k, r = got.float(), ref.float()
    diff = (k - r).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / r.abs().clamp_min(1e-30)).max())
    if got.dtype == torch.bfloat16:
        mag = torch.maximum(k.abs(), r.abs()).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        ok = bool((diff <= ulp).all())
        tol = "1 bf16 ulp"
    else:
        ok = bool((diff <= atol + rtol * r.abs()).all())
        tol = f"{atol:.3g} + {rtol:.3g}*|ref|"
    del diff, k, r
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs {max_abs}, max rel "
                             f"{max_rel}, tolerance {tol})")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel, "tol": tol}


def times(kernel, plain, library, iters: int, bnd) -> dict:
    """Device times of a kernel, its plain version and one library call
    (None where there is none), each by ``timed`` with each one's event
    time and timer beside it.  The kernel is held to its bound ``bnd`` (as
    ``bound`` returns it); the plain version and the library call read the
    same inputs and write the same output, so each is held to the bytes
    bound."""
    k = timed(kernel, iters, bnd[0], batch=True)
    row = {"ms": k["ms"], "timer": k["timer"], "event_ms": k["event_ms"]}
    for name, fn in (("plain", plain), ("library", library)):
        t = timed(fn, iters, bnd[2]) if fn else {}
        row.update({f"{name}_ms": t.get("ms"), f"{name}_timer": t.get("timer"),
                    f"{name}_event_ms": t.get("event_ms")})
    return row


# The coding kernels' shapes on each main path: parameters per client and
# the rounds G the path runs (M = 5 clients per shard, C = 20 coded slices
# of S = 4 shards).  Each path checks its own model's size against these.
PATHS = {"cnn": {"p_client": 206_922, "rounds": 10},
         "mamba": {"p_client": 61_984, "rounds": 2},
         "rwkv6": {"p_client": 62_304, "rounds": 2},
         "nanogpt": {"p_client": 32_912, "rounds": 2},
         "moe": {"p_client": 63_904, "rounds": 2}}
CODING = ("coded_matmul", "coded_matmul_rounds", "calibrate")
CLIENTS_PER_SHARD = 5
# the paper's Table 1 (benchmarks/table1_f1_time.py): MIA F1 and retraining
# time of each framework, in phase 5a's federation (20 clients a stage)
TABLE1_FRAMEWORKS = ("FR", "FE", "RR", "SE")
TABLE1_RETAINED = 19
# tests/test_verify.py's victim scenario (tests/test_torch_verify.py's CFG)
VERIFY_SMALL = dict(task="classification", num_clients=8,
                    clients_per_round=8, num_shards=2, samples_per_client=32,
                    image_size=10, local_epochs=8, global_rounds=6,
                    test_n=160, seed=3, lr=0.3, noise=0.35, store="coded",
                    engine="fused")


def check_kernels(torch, K, path: str, model_cfg, ragged: bool):
    """Phase 3: every coding kernel against its plain version at the shapes
    ``path`` gives it (and, with ``ragged``, at ragged small ones), timed.
    Returns {kernel: row} of the path's own shapes."""
    from repro_torch.core import coding, unlearning
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.calibrate.ops import (calibrate_splits,
                                                   calibrate_update)
    from repro_torch.kernels.calibrate.ref import calibrate_update_ref
    from repro_torch.kernels.coded_matmul.ops import (coded_encode_decode,
                                                      coded_matmul,
                                                      coded_matmul_rounds)
    from repro_torch.kernels.coded_matmul.ref import (coded_encode_decode_ref,
                                                      coded_matmul_ref,
                                                      coded_matmul_rounds_ref)
    from repro_torch.models import init_params

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p_client, g_rounds = PATHS[path]["p_client"], PATHS[path]["rounds"]
    p_shard = CLIENTS_PER_SHARD * p_client
    heads = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # coded_matmul: the stage encode (G rounds concatenated), fp32 and bf16;
    # the erasure decode (4,4)@(4, M*P); ragged shapes
    cm_cases = [("encode", 20, 4, g_rounds * p_shard, torch.float32, 20),
                ("encode_bf16", 20, 4, g_rounds * p_shard, torch.bfloat16,
                 20),
                ("decode", 4, 4, p_shard, torch.float32, 100)]
    if ragged:
        cm_cases += [("ragged_p", 20, 4, 1029, torch.float32, 50),
                     ("c1_s1", 1, 1, 7, torch.float32, 50),
                     ("c33_s16", 33, 16, 4099, torch.bfloat16, 50),
                     # S = 20 shards of 2 clients: past the register tile
                     ("s20_encode", 40, 20, 2 * p_client, torch.float32, 20),
                     ("s20_encode_bf16", 40, 20, 2 * p_client,
                      torch.bfloat16, 20),
                     ("s20_decode", 20, 20, 2 * p_client, torch.float32, 20)]
    for label, c, s, p, dt, iters in cm_cases:
        coeff, w = randn(c, s), randn(s, p)
        err = compare(coded_matmul(coeff, w, out_dtype=dt),
                      coded_matmul_ref(coeff, w, dt),
                      f"coded_matmul/{path}/{label}")
        ob = 2 if dt == torch.bfloat16 else 4
        bnd = bound(4 * (c * s + s * p) + ob * c * p, 2 * c * s * p)
        row = times(lambda: coded_matmul(coeff, w, out_dtype=dt),
                    lambda: coded_matmul_ref(coeff, w, dt),
                    (lambda: torch.matmul(coeff, w))
                    if dt == torch.float32 else None, iters, bnd)
        row.update(kernel="coded_matmul", path=path, case=label,
                   shape=[c, s, p], out_dtype=str(dt), **err)
        share(row, bnd)
        log("kernel", **row)
        if label == "encode":
            heads["coded_matmul"] = row
            # the non-kernel copy around it: encode_batched's concatenate
            mats = list(w.reshape(s, g_rounds, p_shard).unbind(1))
            mats = [m.contiguous() for m in mats]
            sch = coding.CodingScheme(4, 20)
            log("copy", path=path,
                what=f"encode_batched concatenate ({g_rounds} rounds)",
                concat=timed(lambda: torch.cat(mats, dim=1), iters),
                encode_batched=timed(
                    lambda: coding.encode_batched(sch, mats), iters))
            del mats
        del coeff, w

    # coded_matmul_rounds: the stage engine's encode of the (G,S,M*P) history
    cr_cases = [("stage_encode", 20, 4, g_rounds, p_shard, 20)]
    if ragged:
        cr_cases += [("ragged", 3, 2, 2, 5, 50),
                     ("s20", 40, 20, 2, 2 * p_client, 20)]
    for label, c, s, g, p, iters in cr_cases:
        coeff, w = randn(c, s), randn(g, s, p)
        err = compare(coded_matmul_rounds(coeff, w),
                      coded_matmul_rounds_ref(coeff, w),
                      f"coded_matmul_rounds/{path}/{label}")
        bnd = bound(4 * (c * s + g * s * p + g * c * p), 2 * g * c * s * p)
        row = times(lambda: coded_matmul_rounds(coeff, w),
                    lambda: coded_matmul_rounds_ref(coeff, w),
                    lambda: torch.matmul(coeff, w), iters, bnd)
        row.update(kernel="coded_matmul_rounds", path=path, case=label,
                   shape=[c, s, g, p], float4_branch=p % 4 == 0, **err)
        share(row, bnd)
        log("kernel", **row)
        if label == "stage_encode":
            heads["coded_matmul_rounds"] = row
        del coeff, w

    # calibrate: M' = 4 retained clients of the path's model; ragged shapes;
    # M' = 4 at P % 4 = 1, 3 (the CNN's P % 4 = 2); M at the split
    # threshold and one past it, and M = 2048 at the path's P and at
    # P % 4 = 0, 1, 3, these with eq. 3's coefficient scale,
    # ||w_m|| / (M ||w'_m||) drawn as U[0.5, 1.5) / M
    cal_cases = [("se_round", 4, p_client, 500)]
    if ragged:
        # FE's round on the table1 path: all 19 retained clients of a
        # 20-client stage
        cal_cases += [("fe_round_m19", TABLE1_RETAINED, p_client, 200),
                      ("m1_ragged", 1, 7, 200), ("m9", 9, 4097, 200),
                      ("se_round_p1", 4, p_client - 1, 500),
                      ("se_round_p3", 4, p_client + 1, 500),
                      ("m63", 63, p_client, 100), ("m64", 64, p_client, 100),
                      ("s20_m2048", 2048, p_client, 20),
                      ("m2048_p0", 2048, p_client - 2, 20),
                      ("m2048_p1", 2048, p_client - 1, 20),
                      ("m2048_p3", 2048, p_client + 1, 20)]
    for label, m, p, iters in cal_cases:
        w, d, cf = randn(p), randn(m, p), randn(m)
        if m >= 63:
            cf = (torch.rand(m, generator=gen, device=dev) + 0.5) / m
        got = calibrate_update(w, d, cf)
        err = compare(got, calibrate_update_ref(w, d, cf),
                      f"calibrate/{path}/{label}")
        if not torch.equal(got, calibrate_update(w, d, cf)):
            raise AssertionError(f"calibrate/{path}/{label}: two launches "
                                 f"differ")
        del got
        bnd = bound(4 * (p + m * p + m + p), 2 * m * p)
        row = times(lambda: calibrate_update(w, d, cf),
                    lambda: calibrate_update_ref(w, d, cf),
                    lambda: torch.addmv(w, d.t(), cf), iters, bnd)
        row.update(kernel="calibrate", path=path, case=label, shape=[m, p],
                   p_mod_4=p % 4, splits=calibrate_splits(m, p, sms),
                   bit_identical=True, **err)
        share(row, bnd)
        log("kernel", **row)
        if label == "se_round":
            heads["calibrate"] = row
            # calibrate_stacked around the kernel: norms, coefficients,
            # flatten copies of the model and the deltas, unflatten
            model = init_params(model_cfg, 0, dev)
            deltas = tree_map(lambda v: v.unsqueeze(0).expand(
                m, *v.shape).contiguous(), model)
            norms = torch.ones(m, device=dev)
            log("copy", path=path, what="calibrate_stacked (norms + flatten "
                f"+ kernel + unflatten) at M'={m}", **timed(
                    lambda: unlearning.calibrate_stacked(model, deltas,
                                                         norms), iters))
            del model, deltas
        del w, d, cf
        torch.cuda.empty_cache()

    # encode_decode: the round trip of one (S, P) shard matrix at the path's
    # client size, from all C clients and from S of them (the
    # slice-verification check; it runs on no path); with ``ragged``, past
    # the register tile (S > 16) and the shared tables (C*S > 4096): (S 20,
    # C 40) from an S-subset (the scheme's quorum operator at S = 20 has
    # entries near 7e4, so fp32 rounding alone moves its round trip by 0.06)
    # and, with random operators scaled as an encode/decode pair is
    # (entries ~ S^-1/2 and C^-1/2, so dec @ enc is of unit size), (S 50,
    # C 100), (S 100, C 200) (out rows past one register pass of 64) and
    # (S 130, C 140) at a ragged P of 4,099 (w past the kernel's staged rows)
    ed_cases = [("all_clients", 4, 20, None, p_client, 200),
                ("s_subset", 4, 20, [1, 6, 12, 19], p_client, 200)]
    if ragged:
        ed_cases += [("s20_c40", 20, 40, list(range(0, 40, 2)), p_client,
                      50),
                     ("s50_c100", 50, 100, "random", p_client, 50),
                     ("s100_c200", 100, 200, "random", p_client, 20),
                     ("s130_c140", 130, 140, "random", 4099, 20),
                     # benchmarks/kernels_bench.py's round trip (C 100, S
                     # 4, P 500,000; its round-trip error printed, not held:
                     # the tolerances above are for C <= 40)
                     ("bench_c100_s4", 4, 100, None, 500_000, 20)]
    for label, s, c, ids, p, iters in ed_cases:
        w = randn(s, p)
        if ids == "random":
            enc, dec = randn(c, s) * s ** -0.5, randn(s, c) * c ** -0.5
            got = coded_encode_decode(enc, dec, w)
        else:
            sch = coding.CodingScheme(s, c)
            enc, dec = (torch.tensor(m, dtype=torch.float32, device=dev)
                        for m in coding.encode_decode_operators(sch, ids))
            got = coding.encode_decode(sch, w, ids)
        if not torch.equal(got, coded_encode_decode(enc, dec, w)):
            raise AssertionError(f"encode_decode/{path}/{label}: two "
                                 f"launches differ")
        err = compare(got, coded_encode_decode_ref(enc, dec, w),
                      f"encode_decode/{path}/{label}")
        if label.startswith("bench"):
            err["round_trip_max_abs_err"] = float((got - w).abs().max())
        elif ids != "random":
            tol = 1e-3 if ids is None else 2e-3
            err["round_trip_max_abs_err"] = compare(
                got, w, f"encode_decode/{path}/{label}/round_trip", tol,
                tol)["max_abs_err"]
        bnd = bound(4 * (2 * c * s + 2 * s * p), 4 * c * s * p)
        row = times(lambda: coded_encode_decode(enc, dec, w),
                    lambda: coded_encode_decode_ref(enc, dec, w),
                    lambda: torch.linalg.multi_dot([dec, enc, w]), iters,
                    bnd)
        row.update(kernel="encode_decode", path=path, case=label,
                   shape=[c, s, p], bit_identical=True, **err,
                   kernel_over_multi_dot=row["ms"] / row["library_ms"])
        if label.startswith("bench"):
            # the kernel's own order, dec @ (enc @ w), by two library calls;
            # and the operations bounds of both product routes: fp32 FMAs
            # (the route built) and 3xTF32 on the tensor cores, at the
            # useful FLOPs and at the MMA's padding (S to 8 or 16 in k and
            # n, C to a multiple of 8)
            row["matmul_same_order_ms"] = timed(
                lambda: torch.matmul(dec, torch.matmul(enc, w)), iters,
                bnd[2])["ms"]
            kn = 8 if s <= 8 else 16
            padded = 2 * p * 2 * (-(-c // 8) * 8) * kn
            row.update(
                bound_fp32_ops_ms=4 * c * s * p / FP32_FLOPS_PER_S * 1e3,
                bound_tf32x3_ops_ms=4 * c * s * p / TF32X3_FLOPS_PER_S * 1e3,
                bound_tf32x3_padded_ms=padded / TF32X3_FLOPS_PER_S * 1e3)
        share(row, bnd)
        log("kernel", **row)
        if label == "all_clients":
            heads["encode_decode"] = row
        del w, enc, dec, got
    torch.cuda.empty_cache()
    return heads


def ssm_inputs(torch, gen, bsz, s, d, n, g, regime="model"):
    """The scan's inputs at one shape, as the model gives them: softplus-
    sized dt, unit-normal b, c, x, a = -exp(U[0, 1.5)) per group.
    ``regime="tiny"``: dt = softplus(-9 + 0.1 z), abar within 1e-3 of 1;
    "large": dt = U[0, 60 / e^1.5), dt a down to -60, abar underflowing
    inside a sub-chunk's product."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    z = randn(bsz, s, d)
    dt = {"model": lambda: torch.nn.functional.softplus(z * 0.5 - 2.0),
          "tiny": lambda: torch.nn.functional.softplus(z * 0.1 - 9.0),
          "large": lambda: torch.rand_like(z) * (60.0 / 4.4816890703380645),
          }[regime]()
    a = -torch.exp(torch.rand(g, d, n, generator=gen, device=dev) * 1.5)
    return [dt, randn(bsz, s, n), randn(bsz, s, n), randn(bsz, s, d),
            a if g > 1 else a[0].contiguous(), randn(bsz, d, n) * 0.1]


def check_forward(torch, ops, ref, args, name: str, label: str, tol: float,
                  iters: int, shape: list, work, train_row: bool) -> dict:
    """A recurrence forward against its plain loop (no checkpoints, as a
    ``torch.no_grad`` caller launches it), timed; then two launches in
    training mode, with checkpoints, which must give the same bits as each
    other and as the first launch (y, h_last and the checkpoints).  With
    ``train_row`` the training-mode launch, the one the paths make, is timed
    too and logged as case ``<label>_train``.  ``work(train)`` gives the
    call's (bytes, flops, exps).  Returns the no-grad row."""
    fwd = getattr(ops, name)                  # ops.ssm_scan or ops.wkv
    with torch.no_grad():
        yk, hk = fwd(*args)
        yr, hr = ref(*args)
        err = compare(yk, yr, f"{name}/{label}/y", tol, tol)
        compare(hk, hr, f"{name}/{label}/h_last", tol, tol)
        del yr, hr
        gg = ops._check(*args)
        y1, h1, c1 = ops._fwd(*args, gg, keep=True)
        y2, h2, c2 = ops._fwd(*args, gg, keep=True)
        same = all(torch.equal(a_, b_) for a_, b_ in
                   ((y1, y2), (h1, h2), (c1, c2), (y1, yk), (h1, hk)))
        if not same:
            raise AssertionError(f"{name}/{label}: two launches differ")
        del yk, hk, y1, h1, c1, y2, h2, c2
        bnd = bound(*work(False))
        row = times(lambda: fwd(*args), lambda: ref(*args), None, iters, bnd)
        row.update(kernel=name, case=label, shape=shape, **err)
        share(row, bnd)
        log("kernel", **row)
        if train_row:
            tb = bound(*work(True))
            t = share(dict(timed(lambda: ops._fwd(*args, gg, keep=True),
                                 iters, tb[0], batch=True),
                           kernel=name, case=label + "_train", shape=shape,
                           checkpoints=True), tb)
            log("kernel", **t)
            row.update(train_ms=t["ms"], train_bound_ms=t["bound_ms"])
    return row


def check_ssm(torch, K):
    """Phase 3b: the scan's forward and backward kernels against the plain
    loop and autograd through it, at the mamba main path's shapes (and the
    path's training-mode forward, with checkpoints), at ragged small ones,
    with tiny and large dt at the path's shape and at (2, 1024, 4096, 16),
    and at jamba's full width with S = 2048 (where the plain loop's
    autograd graph fits in memory)."""
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    from repro_torch.roofline.analysis import ssm_work

    gen = torch.Generator(device="cuda").manual_seed(1)
    heads = {}
    cases = [("fused_stage", 50, 64, 64, 8, 5, 50, "model"),  # 5 clients x 10
             ("stage_engine", 200, 64, 64, 8, 20, 20, "model"),  # 20 x 10
             ("ragged_n8_g3", 3, 37, 70, 8, 3, 20, "model"),
             ("ragged_n16_g2", 4, 19, 33, 16, 2, 20, "model"),
             ("ragged_n5", 2, 9, 300, 5, 1, 20, "model"),
             ("ragged_n4", 2, 50, 100, 4, 1, 20, "model"),  # 1 lane a channel
             # D past the backward's 64-channel blocks, S past its tiles
             ("ragged_d200_n8", 2, 100, 200, 8, 2, 20, "model"),
             ("ragged_d130_n16", 3, 75, 130, 16, 1, 20, "model"),
             # abar within 1e-3 of 1, and underflowing inside a sub-chunk:
             # at the path's shape (the time split) and at S = 1024
             ("tiny_dt_stage", 50, 64, 64, 8, 5, 20, "tiny"),
             ("large_dt_stage", 50, 64, 64, 8, 5, 20, "large"),
             ("tiny_dt_s1024", 2, 1024, 4096, 16, 1, 3, "tiny"),
             ("large_dt_s1024", 2, 1024, 4096, 16, 1, 3, "large"),
             ("full_width_s2048", 2, 2048, 16384, 16, 1, 3, "model"),
             # the serve path's prefill: jamba's mixer, batch 4, prompt 512
             ("serve_jamba", 4, 512, 16384, 16, 1, 3, "model")]
    for label, bsz, s, d, n, g, iters, regime in cases:
        args = ssm_inputs(torch, gen, bsz, s, d, n, g, regime)
        row = check_forward(
            torch, ops, ssm_scan_ref, args, "ssm_scan", label, 2e-4, iters,
            [bsz, s, d, n, g],
            lambda train: ssm_work(bsz, s, d, n, g, False, train),
            train_row=label == "fused_stage")
        if label == "fused_stage":
            heads["ssm_scan"] = row
        if label.startswith("serve"):   # inference forward only
            heads["serve"] = row
            del args
            torch.cuda.empty_cache()
            continue
        # backward: the kernel from the forward's checkpoints against
        # autograd through the plain loop, on the same cotangents
        gg = ops._check(*args)
        _, _, ckpt = ops._fwd(*args, gg, keep=True)
        gy = torch.randn(bsz, s, d, generator=gen, device="cuda")
        ghl = torch.randn(bsz, d, n, generator=gen, device="cuda")

        def kernel_bwd():
            return ops._bwd(*args[:5], ckpt, gy, ghl, gg)
        got = kernel_bwd()
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        yr, hr = ssm_scan_ref(*leaves)

        def plain_bwd():
            return torch.autograd.grad((yr, hr), leaves, (gy, ghl),
                                       retain_graph=True)
        want = plain_bwd()
        errs = {}
        for nm, k_, r_ in zip(("ddt", "db", "dc", "dx", "da", "dh0"), got,
                              want):
            atol = 1e-4 * float(r_.abs().max())
            errs[nm] = compare(k_.reshape(r_.shape), r_,
                               f"ssm_scan_bwd/{label}/{nm}", 1e-3, atol)
        again = kernel_bwd()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"ssm_scan_bwd/{label}: two runs differ")
        del got, want, again
        bnd = bound(*ssm_work(bsz, s, d, n, g, backward=True))
        row = times(kernel_bwd, plain_bwd, None, iters, bnd)
        del yr, hr, leaves
        worst = max(errs.values(), key=lambda e: e["max_abs_err"])
        row.update(kernel="ssm_scan_bwd", case=label,
                   shape=[bsz, s, d, n, g],
                   max_abs_err=worst["max_abs_err"],
                   per_grad={k: [v["max_abs_err"], v["tol"]]
                             for k, v in errs.items()})
        share(row, bnd)
        log("kernel", **row)
        if label == "fused_stage":
            heads["ssm_scan_bwd"] = row
        del args, ckpt, gy, ghl
        torch.cuda.empty_cache()
    return heads


def wkv_inputs(torch, gen, bsz, s, h, n, g, decay="model"):
    """The recurrence's inputs at one shape, as the model gives them:
    unit-normal r and v, k scaled by N^-0.5, lw = -exp(clip(z, -10, 3))
    (``decay="model"``; "near1": lw = -exp(z - 6.5), decays within 1e-2 of
    1; "clip": lw = -exp(3) everywhere, w = 1.9e-9, the model's clip),
    u = U[0, 0.5) per group, h0 small."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    z = randn(bsz, s, h, n)
    lw = -torch.exp({"model": torch.clamp(z - 0.5, -10.0, 3.0),
                     "near1": z - 6.5,
                     "clip": torch.full_like(z, 3.0)}[decay])
    u = torch.rand(g, h, n, generator=gen, device=dev) * 0.5
    return [randn(bsz, s, h, n), randn(bsz, s, h, n) * n ** -0.5,
            randn(bsz, s, h, n), lw, u if g > 1 else u[0].contiguous(),
            randn(bsz, h, n, n) * 0.1]


def check_wkv(torch, K):
    """Phase 3c: the WKV forward and backward kernels against the plain loop
    and autograd through it, at the rwkv6 main path's shapes (and the
    path's training-mode forward, with checkpoints), at ragged small ones,
    and at rwkv6-3b's full width (8, 4096, 40, 64): the forward there at
    S = 4096, the backward compared at S = 1024 (where the plain loop's
    autograd graph fits in memory) and timed alone at S = 4096.  Case
    ``chunk_walk_proxy`` runs the forward on every 64-step chunk of the
    full-width call as a sequence of its own, (512, 64, 40, 64): the walk a
    chunk-parallel forward would add to its chunk-state pass and combine.
    Cases ``serve_rwkv6`` and ``train_rwkv6`` are the serve path's prefill
    (4, 512, 40, 64) and the train path's client step (1, 4096, 40, 64;
    both directions compared, the training forward timed too)."""
    from repro_torch.kernels.wkv import ops
    from repro_torch.kernels.wkv.ref import wkv_ref
    from repro_torch.roofline.analysis import wkv_work

    gen = torch.Generator(device="cuda").manual_seed(4)
    heads = {}
    # label, B, S, H, N, G, iters, backward (compared / timed alone / none),
    # decays
    cases = [("fused_stage", 50, 64, 2, 16, 5, 20, "compare", "model"),
             ("stage_engine", 200, 64, 2, 16, 20, 10, "compare", "model"),
             ("ragged_n5_g3", 3, 37, 3, 5, 3, 3, "compare", "model"),
             ("ragged_n33", 2, 70, 1, 33, 1, 3, "compare", "model"),
             ("ragged_n64_g2", 2, 130, 2, 64, 2, 3, "compare", "model"),
             ("ragged_n48_g4", 4, 200, 3, 48, 4, 3, "compare", "model"),
             # head sizes padded to 32: the two sweeps, and one block
             ("ragged_n27", 2, 90, 2, 27, 1, 3, "compare", "model"),
             ("ragged_n20_g3", 3, 30, 1, 20, 3, 3, "compare", "model"),
             ("full_width", 8, 4096, 40, 64, 1, 3, "alone", "model"),
             ("full_width_s1024", 8, 1024, 40, 64, 1, 3, "compare", "model"),
             ("near1_s1024", 2, 1024, 40, 64, 1, 3, "compare", "near1"),
             ("clip_s1024", 2, 1024, 40, 64, 1, 3, "compare", "clip"),
             ("chunk_walk_proxy", 512, 64, 40, 64, 1, 3, "none", "model"),
             # the serve path's prefill: rwkv6-3b, batch 4, prompt 512
             ("serve_rwkv6", 4, 512, 40, 64, 1, 3, "none", "model"),
             # the train path's client step: rwkv6-3b, one sequence of 4096
             ("train_rwkv6", 1, 4096, 40, 64, 1, 3, "compare", "model")]
    for label, bsz, s, h, n, g, iters, bwd_mode, decay in cases:
        args = wkv_inputs(torch, gen, bsz, s, h, n, g, decay)
        row = check_forward(
            torch, ops, wkv_ref, args, "wkv", label, 5e-4, iters,
            [bsz, s, h, n, g],
            lambda train: wkv_work(bsz, s, h, n, g, False, train),
            train_row=label in ("fused_stage", "train_rwkv6"))
        if label == "fused_stage":
            heads["wkv"] = row
        if label.startswith("serve"):
            heads["serve"] = row
        if label.startswith("train"):
            heads["train"] = row
        if bwd_mode == "none":
            del args
            torch.cuda.empty_cache()
            continue
        gg = ops._check(*args)
        _, _, ckpt = ops._fwd(*args, gg, keep=True)
        gy = torch.randn(bsz, s, h, n, generator=gen, device="cuda")
        ghl = torch.randn(bsz, h, n, n, generator=gen, device="cuda")

        def kernel_bwd():
            return ops._bwd(*args[:5], ckpt, gy, ghl, gg)
        bnd = bound(*wkv_work(bsz, s, h, n, g, backward=True))
        if bwd_mode == "alone":        # the kernel alone, timed
            row = share(dict(timed(kernel_bwd, iters, bnd[0], batch=True),
                             kernel="wkv_bwd", case=label,
                             shape=[bsz, s, h, n, g],
                             ckpt_bytes=ckpt.numel() * 4), bnd)
            log("kernel", **row)
            del args, ckpt, gy, ghl
            torch.cuda.empty_cache()
            continue
        got = kernel_bwd()
        leaves = [t.detach().clone().requires_grad_(True) for t in args]
        yr, hr = wkv_ref(*leaves)

        def plain_bwd():
            return torch.autograd.grad((yr, hr), leaves, (gy, ghl),
                                       retain_graph=True)
        want = plain_bwd()
        errs = {}
        for nm, k_, r_ in zip(("dr", "dk", "dv", "dlw", "du", "dh0"), got,
                              want):
            atol = 1e-4 * float(r_.abs().max())
            errs[nm] = compare(k_.reshape(r_.shape), r_,
                               f"wkv_bwd/{label}/{nm}", 1e-3, atol)
        again = kernel_bwd()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"wkv_bwd/{label}: two runs differ")
        del got, want, again
        row = times(kernel_bwd, plain_bwd, None, iters, bnd)
        del yr, hr, leaves
        worst = max(errs.values(), key=lambda e: e["max_abs_err"])
        row.update(kernel="wkv_bwd", case=label, shape=[bsz, s, h, n, g],
                   max_abs_err=worst["max_abs_err"],
                   per_grad={k: [v["max_abs_err"], v["tol"]]
                             for k, v in errs.items()})
        share(row, bnd)
        log("kernel", **row)
        if label == "fused_stage":
            heads["wkv_bwd"] = row
        if label.startswith("train"):
            heads["train_bwd"] = row
        del args, ckpt, gy, ghl
        torch.cuda.empty_cache()
    return heads


# the small local-attention model's shape: 2 clients of a shard x batch 2
LOCAL_SMALL = dict(name="nanogpt-local", num_layers=2,
                   layer_pattern=("local", "global"), d_model=64,
                   num_heads=4, num_kv_heads=2, head_dim=16,
                   sliding_window=16)


def check_window(torch, K):
    """Phase 3d: the window-attention forward and backward kernels against
    the dense masked softmax and autograd through it, at ragged shapes, at
    the small local-attention model's stage shape and at gemma3-27b's full
    width (B 2, S 4096, 32 heads of 128 over 16 kv heads, window 1024),
    timed beside F.scaled_dot_product_attention with the boolean window
    mask (fp32; the kv heads expanded before the timed call)."""
    import torch.nn.functional as F
    from repro_torch.kernels.window_attn import ops
    from repro_torch.kernels.window_attn.ref import window_attention_ref
    from repro_torch.roofline.analysis import window_work

    gen = torch.Generator(device="cuda").manual_seed(6)
    heads = {}
    cases = [("ragged", 2, 200, 4, 2, 64, 50, 20),
             ("hd128_window_ge_s", 1, 300, 4, 4, 128, 512, 20),
             ("window1", 2, 100, 4, 2, 64, 1, 20),
             ("ragged_hd27", 1, 130, 6, 3, 27, 70, 20),
             ("local_small", 4, 64, 4, 2, 16, 16, 50),
             ("gemma3_full_width", 2, 4096, 32, 16, 128, 1024, 3),
             # the serve path's prefill (forward only): batch 4, prompt 1536
             ("serve_gemma3", 4, 1536, 32, 16, 128, 1024, 3)]
    for label, b, s, h, kv, hd, window, iters in cases:
        q, k, v = (torch.randn(b, s, n, hd, generator=gen, device="cuda")
                   for n in (h, kv, kv))
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] >
                                                 pos[:, None] - window)
        lq, lk, lv = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], 1)
                      for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        with torch.no_grad():
            want = window_attention_ref(q, k, v, window)
            got, again = ops._fwd(q, k, v, window), ops._fwd(q, k, v, window)
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"window_attention/{label}: two runs "
                                     f"differ")
            err = compare(got[0], want, f"window_attention/{label}", 1e-4,
                          1e-5)
            del got, again
            # the library call's own distance from the plain version (not a
            # check: it may run at another precision)
            lib_err = float((library().transpose(1, 2) - want).abs().max())
            del want
            bnd = bound(*window_work(b, s, h, kv, hd, window, False),
                        flops_per_s=TF32X3_FLOPS_PER_S)
            row = times(lambda: ops._fwd(q, k, v, window),
                        lambda: window_attention_ref(q, k, v, window),
                        library, iters, bnd)
        row.update(kernel="window_attention", case=label,
                   shape=[b, s, h, kv, hd, window], bit_identical=True,
                   library_max_abs_err=lib_err, **err)
        share(row, bnd)
        log("kernel", **row)
        heads[label] = {"window_attention": row}
        if label.startswith("serve"):   # inference forward only
            del q, k, v, lq, lk, lv, mask
            torch.cuda.empty_cache()
            continue
        # backward: the kernels from the forward's O and log-sum-exp against
        # autograd through the dense softmax, on the same cotangent
        o, lse = ops._fwd(q, k, v, window)
        do = torch.randn(b, s, h, hd, generator=gen, device="cuda")

        def kernel_bwd():
            return ops._bwd(q, k, v, o, lse, do, window)
        got, again = kernel_bwd(), kernel_bwd()
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"window_attention_bwd/{label}: two runs "
                                 f"differ")
        del again
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = window_attention_ref(*leaves, window)

        def plain_bwd():
            return torch.autograd.grad(out, leaves, do, retain_graph=True)
        errs = {}
        want = plain_bwd()
        # a gradient that is zero in exact arithmetic (window 1: one key a
        # row, so the softmax's Jacobian vanishes and dq = dk = 0) is held
        # to 1e-4 of the case's largest gradient entry instead of its own
        scale = max(float(r_.abs().max()) for r_ in want)
        for nm, k_, r_ in zip(("dq", "dk", "dv"), got, want):
            top = float(r_.abs().max()) or scale
            errs[nm] = compare(k_, r_, f"window_attention_bwd/{label}/{nm}",
                               0.0, 1e-4 * top)
        del want, got
        bnd = bound(*window_work(b, s, h, kv, hd, window, True),
                    flops_per_s=TF32X3_FLOPS_PER_S)
        row = timed(kernel_bwd, iters, bnd[0], batch=True)
        pl = timed(plain_bwd, iters, bnd[2])
        row.update(plain_ms=pl["ms"], plain_timer=pl["timer"],
                   plain_event_ms=pl["event_ms"])
        del out, leaves
        torch.cuda.empty_cache()
        ll = [t.detach().clone().requires_grad_(True) for t in (lq, lk, lv)]
        lout = F.scaled_dot_product_attention(*ll, attn_mask=mask)
        ldo = do.transpose(1, 2)
        lib = timed(lambda: torch.autograd.grad(lout, ll, ldo,
                                                retain_graph=True), iters,
                    bnd[2])
        row.update(library_ms=lib["ms"], library_timer=lib["timer"],
                   library_event_ms=lib["event_ms"])
        del ll, lout
        worst = max(errs.values(), key=lambda e: e["max_abs_err"])
        row.update(kernel="window_attention_bwd", case=label,
                   shape=[b, s, h, kv, hd, window],
                   max_abs_err=worst["max_abs_err"], bit_identical=True,
                   per_grad={nm: [e["max_abs_err"], e["tol"]]
                             for nm, e in errs.items()})
        share(row, bnd)
        log("kernel", **row)
        heads[label]["window_attention_bwd"] = row
        del q, k, v, lq, lk, lv, o, lse, do, mask
        torch.cuda.empty_cache()
    return heads


# phase 3e: the bf16 routes (the TPU kernels take bf16 operands)
BF16_FLOPS_PER_S = 989e12      # H100 SXM, bf16 on the tensor cores, dense


def _widened(torch, args):
    return [a.float() if a.dtype == torch.bfloat16 else a for a in args]


def _same(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def bf16_coding(torch, K) -> dict:
    """Phase 3a's bf16 cases, at the CNN path's shapes: the coding kernels
    with bf16 coefficients and w (and fp32 coefficients with bf16 w),
    against their plain versions (fp32 outputs: 1e-5 + 1e-5|r|; bf16: one
    ulp) and bit for bit against the fp32 kernels on the widened operands
    (widening is exact, and the kernels widen as they load); calibrate
    with bf16 operands (widened in its wrapper) too.  Times beside the
    bytes bound at 2 bytes a bf16 element.  The rounds at the CNN stage's
    shape, bf16 and fp32 operands, also by route (``rounds_routes``).
    Returns the routes' rows."""
    from repro_torch.kernels.calibrate.ops import calibrate_update
    from repro_torch.kernels.calibrate.ref import calibrate_update_ref
    from repro_torch.kernels.coded_matmul.ops import (coded_encode_decode,
                                                      coded_matmul,
                                                      coded_matmul_rounds)
    from repro_torch.kernels.coded_matmul.ref import (coded_encode_decode_ref,
                                                      coded_matmul_ref,
                                                      coded_matmul_rounds_ref)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    p_client, g_rounds = PATHS["cnn"]["p_client"], PATHS["cnn"]["rounds"]
    p_shard = CLIENTS_PER_SHARD * p_client
    heads = {}

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def nb(t):
        return t.numel() * t.element_size()

    # label, fn, plain, operands, kwargs, flops, iters, head key; the
    # library call (``LIBRARY``) where one PyTorch call gives fp32 out of
    # the bf16 operands: ``torch.mm`` / ``torch.bmm`` with ``out_dtype``
    f32 = torch.float32
    cases = []
    c, s, p = 20, 4, g_rounds * p_shard
    cases.append(("encode_bf16_in", coded_matmul, coded_matmul_ref,
                  [randn(c, s), randn(s, p)], {}, 2 * c * s * p, 20,
                  "coded_matmul_bf16"))
    cases.append(("encode_w_bf16_out_bf16", coded_matmul, coded_matmul_ref,
                  [randn(c, s, dtype=f32), randn(s, p)],
                  {"out_dtype": bf}, 2 * c * s * p, 20, None))
    cases.append(("s20_encode_bf16_in", coded_matmul, coded_matmul_ref,
                  [randn(40, 20), randn(20, 2 * p_client)], {},
                  2 * 40 * 20 * 2 * p_client, 20, None))
    cases.append(("ragged_c33_s16_bf16_in", coded_matmul, coded_matmul_ref,
                  [randn(33, 16), randn(16, 4099)], {}, 2 * 33 * 16 * 4099,
                  20, None))
    cases.append(("stage_encode_bf16_in", coded_matmul_rounds,
                  coded_matmul_rounds_ref,
                  [randn(c, s), randn(g_rounds, s, p_shard)], {},
                  2 * g_rounds * c * s * p_shard, 20,
                  "coded_matmul_rounds_bf16"))
    cases.append(("stage_encode_fp32", coded_matmul_rounds,
                  coded_matmul_rounds_ref,
                  [randn(c, s, dtype=f32), randn(g_rounds, s, p_shard,
                                                 dtype=f32)], {},
                  2 * g_rounds * c * s * p_shard, 20, None))
    cases.append(("ragged_bf16_in", coded_matmul_rounds,
                  coded_matmul_rounds_ref, [randn(3, 2), randn(2, 2, 5)], {},
                  2 * 2 * 3 * 2 * 5, 20, None))
    for label, s_, c_, p_, dt, head in (
            ("all_clients_w_bf16", 4, 20, p_client, f32,
             "encode_decode_bf16"),
            ("all_clients_bf16", 4, 20, p_client, bf, None),
            ("s50_c100_bf16", 50, 100, p_client, bf, None),
            ("s130_c140_bf16_ragged", 130, 140, 4099, bf, None)):
        cases.append((label, coded_encode_decode, coded_encode_decode_ref,
                      [randn(c_, s_, dtype=dt) * s_ ** -0.5,
                       randn(s_, c_, dtype=dt) * c_ ** -0.5,
                       randn(s_, p_)], {}, 4 * c_ * s_ * p_, 20, head))
    cases.append(("se_round_bf16", calibrate_update, calibrate_update_ref,
                  [randn(p_client), randn(4, p_client), randn(4)], {},
                  2 * 4 * p_client, 50, None))
    library_of = {
        "encode_bf16_in": lambda a: torch.mm(a[0], a[1], out_dtype=f32),
        "stage_encode_bf16_in": lambda a: torch.bmm(
            a[0].expand(a[1].shape[0], *a[0].shape), a[1], out_dtype=f32)}
    for label, fn, plain, args, kw, flops, iters, head in cases:
        name = fn.__name__.replace("coded_encode_decode", "encode_decode")
        name = name.replace("calibrate_update", "calibrate")
        got = fn(*args, **kw)
        err = compare(got, plain(*args, **kw), f"{name}/{label}")
        library, lib_note = None, {}
        if label in library_of:
            call = library_of[label]
            try:
                lib_note["library_vs_kernel_max_abs"] = float(
                    (call(args) - got).abs().max())
                library = lambda call=call, args=args: call(args)
            except Exception as exc:          # recorded: the row quotes it
                lib_note["library_error"] = f"{type(exc).__name__}: {exc}"
        wide = fn(*_widened(torch, args), **kw)
        if not torch.equal(got, wide) or not torch.equal(got,
                                                         fn(*args, **kw)):
            raise AssertionError(f"{name}/{label}: the bf16 route differs "
                                 f"from the fp32 kernel on the widened "
                                 f"operands, or two launches differ")
        bnd = bound(sum(nb(a) for a in args) + nb(got), flops)
        row = times(lambda: fn(*args, **kw), lambda: plain(*args, **kw),
                    library, iters, bnd)
        row.update(lib_note)
        if label.startswith("stage_encode"):
            row.update(rounds_routes(torch, *args, got, iters, bnd))
        bf16_in = any(a.dtype == bf for a in args)
        row.update(kernel=name + ("_bf16" if bf16_in and name != "calibrate"
                                  else ""),
                   case=label, shape=[list(a.shape) for a in args],
                   dtypes=[str(a.dtype) for a in args],
                   out_dtype=str(got.dtype),
                   bit_identical_to_widened_fp32=True, **err)
        share(row, bnd)
        log("kernel", **row)
        if head:
            heads[head] = row
        del got, wide
    del cases
    torch.cuda.empty_cache()
    return heads


def rounds_routes(torch, coeff, w, got, iters: int, bnd) -> dict:
    """``coded_matmul_rounds`` at the CNN stage's shape (P = 2 mod 4) by
    its route (``load_width``): bit for bit the 4-column route on the same
    data padded to a multiple of 4 columns, the single-column route, and
    ``coded_matmul`` on each round copied contiguous; timed in turns with
    the single-column route, which every such call took before
    (``parent_ms``)."""
    from repro_torch.kernels.coded_matmul import ops
    g, p = w.shape[0], w.shape[2]
    width = ops.load_width(p, w, got)
    pad = (-p) % 4
    padded = ops._launch(coeff, torch.nn.functional.pad(w, (0, pad)),
                         torch.float32)
    if ops.load_width(p + pad, w, padded) != 4 or not torch.equal(
            got, padded[..., :p]):
        raise AssertionError("coded_matmul_rounds: the route differs from "
                             "the 4-column route on the padded data")
    del padded
    if not torch.equal(got, ops._launch(coeff, w, torch.float32, width=1)):
        raise AssertionError("coded_matmul_rounds: the route differs from "
                             "the single-column route")
    for r in range(g):
        if not torch.equal(got[r], ops.coded_matmul(coeff,
                                                    w[r].contiguous())):
            raise AssertionError(f"coded_matmul_rounds: round {r} differs "
                                 f"from coded_matmul on the round")
    (new_ms, new_t), (old_ms, old_t) = timed_pair(
        lambda: ops._launch(coeff, w, torch.float32),
        lambda: ops._launch(coeff, w, torch.float32, width=1), iters, bnd[0])
    return {"load_width": width, "bit_identical_to_vector_route": True,
            "pair_ms": new_ms, "pair_timers": new_t, "parent_ms": old_ms,
            "parent_timers": old_t, "parent_route": "single columns",
            "parent_over_route": old_ms / new_ms}


def bf16_recurrence(torch, K, name: str) -> dict:
    """Phases 3b / 3c's bf16 cases: ``ssm_scan`` or ``wkv`` with bf16
    inputs (the scan's dt, b, c, x; the WKV's r, k, v, lw), at the path
    shapes and at ragged ones (scalar loads), against the plain loop
    (the fp32 cases' tolerance) and bit for bit against the fp32 kernel on
    the widened inputs, y, h_last and the training checkpoints; one
    case's backward through autograd (bf16 gradients: the fp32 backward
    kernel on the widened operands, cast).  Each case also times the bf16
    and the fp32 route (on the widened inputs) in turns in the same call
    (``timed_pair``: ``bf16_pair_ms``, ``fp32_route_ms``,
    ``bf16_over_fp32``); at jamba's serve shape the scan's two
    instantiations' registers and spills (``ptxas_bf16``, ``ptxas_fp32``).
    Returns the path row."""
    from repro_torch.roofline import analysis as rl
    if name == "ssm_scan":
        from repro_torch.kernels.ssm_scan import ops
        from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref as ref
        inputs, work, tol, seed = ssm_inputs, rl.ssm_work, 2e-4, 8
        # the jamba serve's prefill (the bf16 serve launches it there), the
        # mamba path's stage, ragged n and D
        cases = [("serve_jamba_bf16", 4, 512, 16384, 16, 1, 20),
                 ("fused_stage_bf16", 50, 64, 64, 8, 5, 20),
                 ("ragged_n5_bf16", 2, 9, 300, 5, 1, 20),
                 ("ragged_d130_n16_bf16", 3, 75, 130, 16, 1, 20)]
    else:
        from repro_torch.kernels.wkv import ops
        from repro_torch.kernels.wkv.ref import wkv_ref as ref
        inputs, work, tol, seed = wkv_inputs, rl.wkv_work, 5e-4, 9
        # rwkv6-3b's serve prefill and train client-step shapes (no model
        # path hands wkv bf16), the rwkv6 path's stage, ragged N
        cases = [("serve_rwkv6_bf16", 4, 512, 40, 64, 1, 3),
                 ("train_rwkv6_bf16", 1, 4096, 40, 64, 1, 3),
                 ("fused_stage_bf16", 50, 64, 2, 16, 5, 20),
                 ("ragged_n27_bf16", 2, 90, 2, 27, 1, 20)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    fwd, head = getattr(ops, name), None
    for label, bsz, s, d, n, g, iters in cases:
        args = inputs(torch, gen, bsz, s, d, n, g)
        args[:4] = [t.to(torch.bfloat16) for t in args[:4]]
        wide = _widened(torch, args)
        with torch.no_grad():
            yk, hk = fwd(*args)
            yr, hr = ref(*args)
            err = compare(yk, yr, f"{name}/{label}/y", tol, tol)
            compare(hk, hr, f"{name}/{label}/h_last", tol, tol)
            del yr, hr
            gg = ops._check(*args)
            got = ops._fwd(*args, gg, keep=True)
            if not (_same(torch, got, ops._fwd(*wide, gg, keep=True))
                    and _same(torch, (yk, hk), got[:2])):
                raise AssertionError(f"{name}/{label}: the bf16 route "
                                     f"differs from the fp32 kernel on the "
                                     f"widened inputs")
            del yk, hk, got
            bnd = bound(*work(bsz, s, d, n, g, False, in_bytes=2))
            row = times(lambda: fwd(*args), lambda: ref(*args), None, iters,
                        bnd)
            # the bf16 and the fp32 route (on the widened inputs) in the
            # same call, in turns
            (b16, b16_t), (f32, f32_t) = timed_pair(
                lambda: fwd(*args), lambda: fwd(*wide), iters, bnd[0])
        row.update(kernel=name + "_bf16", case=label,
                   shape=[bsz, s, d, n, g], bit_identical_to_widened_fp32=True,
                   bf16_pair_ms=b16, bf16_pair_timers=b16_t,
                   fp32_route_ms=f32, fp32_route_timers=f32_t,
                   bf16_over_fp32=b16 / f32, **err)
        if label == "serve_jamba_bf16":
            # jamba's (4, 512, 16384, 16) takes the walk with two lanes of
            # 8 states a channel: ssm_fwd_kernel<In, 2, 1, 8>
            regs = {r[0].split("ssm_fwd_kernelI")[1][:2]: r[1:]
                    for r in ptxas_summary(K.BUILD_INFO["log"])
                    if "ssm_fwd_kernelI" in r[0] and "Li2ELi1ELi8E" in r[0]}
            row.update(ptxas_bf16=regs.get("13"), ptxas_fp32=regs.get("fL"))
        share(row, bnd)
        if label == "fused_stage_bf16":
            # autograd through the bf16 route: each gradient is the fp32
            # backward kernel's on the widened operands, in its dtype
            leaves = [t.detach().clone().requires_grad_(True) for t in args]
            y, hl = fwd(*leaves)
            gy = torch.randn(y.shape, generator=gen, device="cuda")
            ghl = torch.randn(hl.shape, generator=gen, device="cuda")
            grads = torch.autograd.grad((y, hl), leaves, (gy, ghl))
            _, _, ckpt = ops._fwd(*wide, gg, keep=True)
            want = ops._bwd(*wide[:5], ckpt, gy, ghl, gg)
            want = [w.reshape(t.shape).to(t.dtype)
                    for w, t in zip(want, args)]
            if not _same(torch, grads, want):
                raise AssertionError(f"{name}/{label}: bf16 gradients are "
                                     f"not the fp32 backward's, cast")
            row.update(backward_dtypes=[str(t.dtype) for t in grads],
                       backward_bit_identical=True)
            del leaves, y, hl, grads, want, ckpt
        log("kernel", **row)
        if head is None:
            head = row
        del args, wide
        torch.cuda.empty_cache()
    return head


def wgmma_sass(torch, K) -> dict:
    """HGMMA and UTMALDG instructions in ``cuobjdump -sass`` of the built
    library's wgmma window forward, each of its two instantiations (hd 64
    and 128); fails on a missing one or on none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", K.BUILD_INFO["path"]],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"cuobjdump failed: {out.stderr[-2000:]}")
    counts = {}
    for part in out.stdout.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if "wattn_fwd_bf16_tma_kernel" in name:
            # keyed by the template arguments (ILi64E..., ILi128E...)
            counts[name.split("wattn_fwd_bf16_tma_kernel")[1][:10]] = {
                "HGMMA": part.count("HGMMA"), "UTMALDG": part.count("UTMALDG")}
    if len(counts) != 2 or not all(c["HGMMA"] and c["UTMALDG"]
                                   for c in counts.values()):
        raise AssertionError(f"the wgmma window forward's SASS lacks HGMMA "
                             f"or UTMALDG: {counts}")
    return counts


def bf16_window(torch, K) -> dict:
    """Phase 3d's bf16 cases: ``window_attention``'s bf16 routes (bf16
    products with fp32 accumulation, P rounded to bf16 before P V, output
    in bf16; wgmma and TMA where ``bf16_route`` allows, else
    ``mma.sync``) against the plain version's bf16 arithmetic (P rounded
    at the row's max, not the running max): |k - r| <= 2^-8 (max|v| +
    |r|), the bound of two roundings of P to bf16 (2^-9 each, relative)
    and of O (half an ulp each); two launches bit-identical.  The wgmma
    route at gemma3-27b's layer, window 1 (hd 64), hd 128 with window >= S
    (H / KV 1, ragged S), hd 64 at H / KV 4 (ragged S) and on strided
    views of one fused (B, S, (H + 2 KV) hd) projection; each of these
    also held and timed on the mma.sync route, the parent's, in turns in
    the same call (``parent_ms``).  The mma.sync route at the local model's
    hd 16 and at hd 27 (element loads).  Timed beside the bound at the
    bf16 tensor-core rate and F.scaled_dot_product_attention at bf16
    (boolean window mask, kv heads expanded); each wgmma case's host cost
    a call on both routes (``host_us``).  One case's backward (the
    fp32 kernels on the widened saved tensors, gradients cast).  Returns
    the gemma3 row."""
    import torch.nn.functional as F
    from repro_torch.kernels.window_attn import ops
    from repro_torch.kernels.window_attn.ref import window_attention_ref
    from repro_torch.roofline.analysis import window_work
    gen = torch.Generator(device="cuda").manual_seed(10)
    bf, head = torch.bfloat16, None
    log("wgmma_sass", kernels=wgmma_sass(torch, K))
    # label, B, S, H, KV, hd, window, iters, the route, fused q, k, v
    cases = [("gemma3_full_width_bf16", 2, 4096, 32, 16, 128, 1024, 5, "tma",
              False),
             ("local_small_bf16", 4, 64, 4, 2, 16, 16, 50, "mma_sync", False),
             ("window1_bf16", 2, 100, 4, 2, 64, 1, 20, "tma", False),
             ("ragged_hd27_bf16", 1, 130, 6, 3, 27, 70, 20, "mma_sync",
              False),
             ("hd128_window_ge_s_bf16", 1, 300, 4, 4, 128, 512, 20, "tma",
              False),
             ("hd64_gqa4_ragged_bf16", 2, 1000, 16, 4, 64, 256, 20, "tma",
              False),
             ("fused_qkv_views_bf16", 2, 2048, 8, 4, 128, 512, 10, "tma",
              True)]
    for label, b, s, h, kv, hd, window, iters, route, fused in cases:
        if fused:
            x = torch.randn(b, s, (h + 2 * kv) * hd, generator=gen,
                            device="cuda").to(bf)
            q = x[..., :h * hd].unflatten(-1, (h, hd))
            k = x[..., h * hd:(h + kv) * hd].unflatten(-1, (kv, hd))
            v = x[..., (h + kv) * hd:].unflatten(-1, (kv, hd))
        else:
            q, k, v = (torch.randn(b, s, n, hd, generator=gen,
                                   device="cuda").to(bf) for n in (h, kv, kv))
        if ops.bf16_route(q, k, v) != route:
            raise AssertionError(f"window_attention_bf16/{label}: route "
                                 f"{ops.bf16_route(q, k, v)}, not {route}")
        pos = torch.arange(s, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] >
                                                 pos[:, None] - window)
        lq, lk, lv = (t.transpose(1, 2).repeat_interleave(h // t.shape[2], 1)
                      for t in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(lq, lk, lv, attn_mask=mask)
        # the call's own route first, then (wgmma cases) the parent's
        routes = [route] + (["mma_sync"] if route == "tma" else [])
        with torch.no_grad():
            want = window_attention_ref(q, k, v, window)
            exact = window_attention_ref(q.float(), k.float(), v.float(),
                                         window)
            tol = 2.0 ** -8 * (float(v.float().abs().max())
                               + want.float().abs())
            err = {"tol": "2^-8 (max|v| + |r|)"}
            for rt in routes:
                got = ops._fwd(q, k, v, window, route=rt)
                again = ops._fwd(q, k, v, window, route=rt)
                if not _same(torch, got, again) or got[0].dtype != bf:
                    raise AssertionError(f"window_attention_bf16/{label}/"
                                         f"{rt}: two runs differ, or O is "
                                         f"not bf16")
                diff = (got[0].float() - want.float()).abs()
                if not bool((diff <= tol).all()):
                    raise AssertionError(
                        f"window_attention_bf16/{label}/{rt}: "
                        f"{float(diff.max())} from the plain version, past "
                        f"2^-8 (max|v| + |r|)")
                pre = "" if rt == route else "parent_"
                err[pre + "max_abs_err"] = float(diff.max())
                err[pre + "kernel_vs_fp32_max_abs"] = float(
                    (got[0].float() - exact).abs().max())
                del got, again, diff
            err.update(
                plain_vs_fp32_max_abs=float((want.float() - exact).abs()
                                            .max()),
                library_vs_fp32_max_abs=float(
                    (library().transpose(1, 2).float() - exact).abs().max()))
            del want, tol, exact
            bnd = bound(*window_work(b, s, h, kv, hd, window, False,
                                     in_bytes=2),
                        flops_per_s=BF16_FLOPS_PER_S)
            row = times(lambda: ops._fwd(q, k, v, window),
                        lambda: window_attention_ref(q, k, v, window),
                        library, iters, bnd)
            if route == "tma":
                (new_ms, new_t), (old_ms, old_t) = timed_pair(
                    lambda: ops._fwd(q, k, v, window),
                    lambda: ops._fwd(q, k, v, window, route="mma_sync"),
                    iters, bnd[0])
                row.update(pair_ms=new_ms, pair_timers=new_t,
                           parent_ms=old_ms, parent_timers=old_t,
                           parent_route="mma_sync",
                           parent_over_route=old_ms / new_ms,
                           parent_share=bnd[0] / old_ms)
                # the host's cost of a call on each route, in turns
                hosts = {0: [], 1: []}
                for r in (0, 1, 1, 0):
                    hosts[r].append(host_us(
                        lambda rt=("tma", "mma_sync")[r]:
                        ops._fwd(q, k, v, window, route=rt)))
                row.update(host_us=min(hosts[0]),
                           parent_host_us=min(hosts[1]))
        row.update(kernel="window_attention_bf16", case=label, route=route,
                   shape=[b, s, h, kv, hd, window], fused_views=fused,
                   bit_identical=True, **err)
        share(row, bnd)
        if label == "local_small_bf16":
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (q, k, v)]
            out = ops.window_attention(*leaves, window)
            do = torch.randn(out.shape, generator=gen, device="cuda").to(bf)
            grads = torch.autograd.grad(out, leaves, do)
            o, lse = ops._fwd(q, k, v, window)
            want = ops._bwd(q.float(), k.float(), v.float(), o.float(), lse,
                            do.float(), window)
            if not _same(torch, grads, [w.to(bf) for w in want]):
                raise AssertionError(f"window_attention_bf16/{label}: bf16 "
                                     f"gradients are not the fp32 "
                                     f"backward's, cast")
            row.update(backward_dtypes=[str(t.dtype) for t in grads],
                       backward_bit_identical=True)
            del leaves, out, do, grads, o, lse, want
        log("kernel", **row)
        if head is None:
            head = row
        del q, k, v, lq, lk, lv, mask
        if fused:
            del x
        torch.cuda.empty_cache()
    return head


def check_bf16_routes(torch, K) -> dict:
    """Phase 3e: every bf16 route against its plain version (phases 3a-3d's
    bf16 cases, ``bf16_coding``, ``bf16_recurrence``, ``bf16_window``).
    Returns {route: row}, the rows of the ``kernels`` line."""
    t0 = time.perf_counter()
    heads = bf16_coding(torch, K)
    heads["ssm_scan_bf16"] = bf16_recurrence(torch, K, "ssm_scan")
    heads["wkv_bf16"] = bf16_recurrence(torch, K, "wkv")
    heads["window_attention_bf16"] = bf16_window(torch, K)
    log("bf16_routes", seconds=time.perf_counter() - t0,
        routes=sorted(heads))
    return heads


@contextlib.contextmanager
def routing_log():
    """Records (expert_idx, keep) of every MoE router call made inside, on
    the host, in call order."""
    from repro_torch.models import moe
    real, seen = moe._route, []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((out[1].detach().cpu(), out[3].detach().cpu()))
        return out
    moe._route = spy
    try:
        yield seen
    finally:
        moe._route = real


def same_routing(name: str, card: list, cpu: list, moe: bool) -> int:
    """Fail unless the card's router calls chose the CPU's experts, call by
    call (ties in top-k are the trap), and, for an MoE model (``moe``),
    unless there was at least one call; returns the number of calls."""
    import torch
    if len(card) != len(cpu) or not all(
            torch.equal(a[0], b[0]) for a, b in zip(card, cpu)):
        raise AssertionError(f"{name}: the card's MoE routing differs from "
                             f"the CPU's ({len(card)} and {len(cpu)} router "
                             f"calls)")
    if moe and not card:
        raise AssertionError(f"{name}: an MoE model made no router call "
                             f"that the routing check could see")
    return len(card)


def _small_run(cfg, dev, init_fn=None):
    from repro_torch.core.tree import tree_map
    from repro_torch.fl.experiment import build_session
    session, _ = build_session(cfg, device=dev, init_fn=init_fn)
    rep = session.run(1, schedule=cfg.schedule)
    res = rep.stages[0].unlearn[0]
    return (rep.store_stats.to_dict(), res.cost_units,
            {s: tree_map(lambda v: v.cpu(), m)
             for s, m in res.models.items()})


def _ulp_perturbed(torch, model_cfg, seed: int):
    """An ``init_fn``: the default initial weights with each entry times
    (1 +- 2^-23), the signs drawn from a fixed generator."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import init_params
    gen = torch.Generator().manual_seed(9)

    def init_fn(salt):
        return tree_map(lambda v: v * (1 + 2.0 ** -23 * (
            torch.randint(0, 2, v.shape, generator=gen) * 2 - 1)),
            init_params(model_cfg, seed + salt, "cpu"))
    return init_fn


def check_first_step(torch, name: str, cfg, seq: int = 16) -> dict:
    """The loss and gradients of one SGD step of the model ``cfg`` (called
    ``name``) at its initial weights on (4, ``seq``) tokens, on the card
    and on the CPU: an MoE model's routing equal first, then the loss
    within 1e-5 rel, each gradient leaf within 1e-4|r| + 5e-5 max|r|
    (tests/test_torch_rwkv6.py's tolerance against the reference)."""
    import numpy as np
    from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
    from repro_torch.models import init_params, loss_fn

    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, seq))
                                 .astype(np.int32)) for k in ("tokens",
                                                              "labels")}
    out, routes = {}, {}
    for dev in ("cuda", "cpu"):
        p = tree_map(lambda v: v.requires_grad_(True),
                     init_params(cfg, 0, dev))
        with routing_log() as routes[dev]:
            loss, _ = loss_fn(cfg, remat="none")(p, {k: v.to(dev)
                                       for k, v in batch.items()})
        out[dev] = (float(loss.detach()), [g.cpu() for g in torch.autograd.grad(
            loss, tree_leaves(p))], [path for path, _ in leaves_with_paths(p)])
    n_routes = same_routing(f"first step {name}", routes["cuda"],
                            routes["cpu"], bool(cfg.num_experts))
    (lg, gg, paths), (lc, gc, _) = out["cuda"], out["cpu"]
    if abs(lg - lc) > 1e-5 * abs(lc):
        raise AssertionError(f"first step {name}: loss {lg} on the card, "
                             f"{lc} on the CPU")
    worst = 0.0
    for path, g, c in zip(paths, gg, gc):
        cmax = float(c.abs().max())
        torch.testing.assert_close(g, c, rtol=1e-4, atol=5e-5 * cmax,
                                   msg=f"first step {name} {path}")
        worst = max(worst, float((g - c).abs().max()) / max(cmax, 1e-30))
    return {"loss_card": lg, "loss_cpu": lc,
            "grad_max_abs_err_of_leaf_max": worst,
            "router_calls_equal": n_routes}


def _small_local_run(torch, K, dev):
    """One stage and one SE request of the local-attention model through
    the port's FLSimulator (tests/test_scenario_zoo.py's federation at 64
    tokens per sequence, so the local layers take the sliding-window
    path), with the launch counts around it."""
    from repro_torch.configs import OptimizerConfig, get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data.federated import get_partitioner
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import (FederatedSession, RequestSchedule,
                                           ScenarioConfig, UnlearnRequest)
    from repro_torch.fl.tasks import GenerationTask

    cfg = dataclasses.replace(get_config("nanogpt-paper"), **LOCAL_SMALL)
    scfg = ScenarioConfig(task="generation", num_clients=8,
                          clients_per_round=4, num_shards=2, local_epochs=1,
                          global_rounds=2, samples_per_client=6, seq_len=64,
                          test_n=20, local_batch=2)
    task = GenerationTask()
    clients, _ = task.build_data(scfg, cfg, get_partitioner("iid"))
    sim = FLSimulator(cfg, scfg.fl_config(), clients, task,
                      opt_cfg=OptimizerConfig(name="sgd", lr=0.3,
                                              grad_clip=0.0),
                      local_batch=2, seed=0, device=dev)
    session = FederatedSession(sim, store_kind="coded", engine="fused")
    K.reset_launches()
    rep = session.run(1, schedule=RequestSchedule([UnlearnRequest(
        lambda plan: [plan.shard_clients[0][0]])]))
    launches = dict(K.LAUNCHES)
    res = rep.stages[0].unlearn[0]
    return cfg, launches, (rep.store_stats.to_dict(), res.cost_units,
                           {s: tree_map(lambda v: v.cpu(), m)
                            for s, m in res.models.items()})


# small scenarios whose stage amplifies fp32 rounding far past 1e-4, held to
# twice the spread one-ulp-perturbed initial weights open on the CPU (their
# model family): rwkv6's SGD, and the decode at S = 20, C = 40, where the
# scheme's quorum operator has entries near 7e4
SPREAD_HELD = {"generation_rwkv6": "rwkv6", "classification_s20": "cnn"}


def check_small(torch, K):
    """Phase 4: tiny scenarios on the card against the same runs on the
    CPU through the kernels' plain versions: the paper CNN's
    classification (also on the ``legacy`` engine), generation with the
    mamba, rwkv6, NanoGPT and moe
    families (the scenario-zoo configuration of tests/test_scenario_zoo.py;
    every MoE router call's experts equal first), one SGD step of
    ``reduce_for_smoke(jamba-1.5-large)`` (the scan kernels beside an MoE
    FFN), and the local-attention model through the FLSimulator.  Returns
    the local run's launch counts.

    One stage of the rwkv6 scenario amplifies fp32 rounding chaotically:
    the CPU run itself ends as far from a CPU run whose initial weights
    differ by one ulp as from the card.  So for rwkv6 the card is held to
    its CPU run over one SGD step (``check_first_step``) and, after the
    stage, to within twice that one-ulp spread.  The 20-shard scenario is
    held the same way: the scheme's quorum at S = 20, C = 40 decodes through
    an operator with entries near 7e4, so rounding anywhere before the
    decode moves its unlearned models by about 2 % (``SPREAD_HELD``)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.tree import leaves_with_paths, tree_leaves
    from repro_torch.fl.experiment import (RequestSchedule, ScenarioConfig,
                                           UnlearnRequest)
    from repro_torch.fl.families import get_model_family

    def schedule():
        return RequestSchedule([UnlearnRequest(
            lambda plan: [plan.shard_clients[0][0]])])

    def gap(a, b):
        return max(float((x - y).abs().max()) for s in b
                   for x, y in zip(tree_leaves(a[s]), tree_leaves(b[s])))
    configs = {
        "classification": dict(num_clients=8, clients_per_round=4,
                               num_shards=2, local_epochs=2, global_rounds=2,
                               samples_per_client=20, image_size=8,
                               local_batch=10),
        "generation_mamba": dict(task="generation", model="mamba",
                                 partitioner="zipf",
                                 partitioner_kwargs={"exponent": 0.5},
                                 num_clients=8, clients_per_round=4,
                                 num_shards=2, local_epochs=1,
                                 global_rounds=2, samples_per_client=6,
                                 seq_len=16, test_n=20, local_batch=2)}
    # S = 20 shards of 2 clients: the coding kernels past their register
    # tile (S <= 16), C = 40 coded slices
    configs["classification_s20"] = dict(num_clients=40, clients_per_round=40,
                                         num_shards=20, local_epochs=1,
                                         global_rounds=1,
                                         samples_per_client=10, image_size=8,
                                         local_batch=10)
    configs["generation_rwkv6"] = dict(configs["generation_mamba"],
                                       model="rwkv6")
    configs["generation_nanogpt"] = {k: v for k, v in
                                     configs["generation_mamba"].items()
                                     if k != "model"}
    configs["generation_moe"] = dict(configs["generation_mamba"],
                                     model="moe")
    # the legacy engine: per-client tree payloads, encoded a round at a time
    configs["classification_legacy"] = dict(configs["classification"],
                                            engine="legacy")
    first = {}
    for name, kw in configs.items():
        cfg = ScenarioConfig(schedule=schedule(), **kw)
        K.reset_launches()
        out, routes = {}, {}
        for dev in ("cuda", "cpu"):
            with routing_log() as routes[dev]:
                out[dev] = _small_run(cfg, dev)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        n_routes = same_routing(f"small {name}", routes["cuda"],
                                routes["cpu"], cfg.model == "moe")
        (gs, gc, gm), (cs, cc, cm) = out["cuda"], out["cpu"]
        if gs != cs or gc != cc:
            raise AssertionError(f"small {name}: StoreStats/cost differ on "
                                 f"the card ({gs}, {gc}) and the CPU ({cs}, "
                                 f"{cc})")
        if not (launches.get("coded_matmul") and launches.get("calibrate")):
            raise AssertionError(f"small {name}: the encode/decode or the "
                                 f"calibrate kernel not launched on the "
                                 f"card: {launches}")
        worst = gap(gm, cm)
        if name in ("generation_rwkv6", "generation_nanogpt",
                    "generation_moe"):
            fam = get_model_family(cfg.model)
            first[name] = check_first_step(torch, cfg.model, fam.build(cfg))
        if name in SPREAD_HELD:
            init_fn = _ulp_perturbed(torch, get_model_family(
                SPREAD_HELD[name]).build(cfg), cfg.seed)
            spread = gap(_small_run(cfg, "cpu", init_fn)[2], cm)
            if not worst <= 2 * spread:
                raise AssertionError(f"small {name}: the card ends {worst} "
                                     f"from the CPU, more than twice the "
                                     f"one-ulp spread {spread}")
            log("small", scenario=name, num_shards=cfg.num_shards,
                launches=launches, store_stats_equal=True, cost_units=gc,
                max_abs_diff_vs_cpu=worst, cpu_one_ulp_spread=spread,
                tol="2 x one-ulp spread", first_step=first.get(name))
            continue
        for s in cm:
            for (path, g), c in zip(leaves_with_paths(gm[s]),
                                    tree_leaves(cm[s])):
                torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-4,
                                           msg=f"{name} {s}/{path}")
        log("small", scenario=name, num_shards=cfg.num_shards,
            launches=launches, store_stats_equal=True, cost_units=gc,
            max_abs_diff_vs_cpu=worst, tol="rtol 1e-3, atol 1e-4",
            router_calls_equal=n_routes, first_step=first.get(name))

    # reduce_for_smoke(jamba-1.5-large): a global layer, then a mamba layer
    # with an MoE FFN; one SGD step on the card against the CPU
    jcfg = reduce_for_smoke(get_config("jamba-1.5-large-398b"))
    K.reset_launches()
    step = check_first_step(torch, "jamba_smoke", jcfg, seq=32)
    jl = {k: v for k, v in K.LAUNCHES.items() if v}
    if not (jl.get("ssm_scan") and jl.get("ssm_scan_bwd")
            and step["router_calls_equal"]):
        raise AssertionError(f"small jamba_smoke: scan kernels or the MoE "
                             f"router not reached: {jl}, {step}")
    log("small", scenario="jamba_smoke_step", layer_kinds=jcfg.layer_kinds,
        moe_ffn=[jcfg.ffn_is_moe(i) for i in range(jcfg.num_layers)],
        d_model=jcfg.d_model, experts=jcfg.num_experts,
        top_k=jcfg.experts_per_token, launches=jl, first_step=step,
        tol="loss 1e-5 rel, gradients 1e-4|r| + 5e-5 max|r|")

    # the local-attention model: its local layers through the window kernels
    cfg, launches, (gs, gc, gm) = _small_local_run(torch, K, "cuda")
    _, _, (cs, cc, cm) = _small_local_run(torch, K, "cpu")
    missing = [k for k in ("window_attention", "window_attention_bwd")
               if launches[k] == 0]
    if missing or gs != cs or gc != cc:
        raise AssertionError(f"small local attention: kernels not launched "
                             f"{missing}, StoreStats/cost on the card ({gs}, "
                             f"{gc}) and the CPU ({cs}, {cc})")
    for s_ in cm:
        for (path, g), c in zip(leaves_with_paths(gm[s_]),
                                tree_leaves(cm[s_])):
            torch.testing.assert_close(g, c, rtol=1e-3, atol=1e-4,
                                       msg=f"local attention {s_}/{path}")
    log("small", scenario="local_attention", model=dataclasses.asdict(cfg),
        launches=launches, store_stats_equal=True, cost_units=gc,
        max_abs_diff_vs_cpu=gap(gm, cm), tol="rtol 1e-3, atol 1e-4",
        first_step=check_first_step(torch, "local_attention", cfg, seq=64))
    return launches


def rel_err(a, b) -> float:
    from repro_torch.core.tree import tree_leaves
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    num = max(float((x.float() - y.float()).abs().max()) for x, y in pairs)
    den = max(float(y.float().abs().max()) for _, y in pairs)
    return num / den


def main_path(torch, K, name, make_sim, test, need, metric_ok):
    """Phase 5: the paper's pipeline through the port's entry points:
    ``make_sim()`` builds a fresh simulator, ``test`` is the task's test
    set, ``need`` the kernels the path must launch and ``metric_ok(m)``
    the ensemble check on ``m = {"test": ..., "held_out": ...}``, where
    ``held_out`` is the data of ten clients the stage did not sample.
    Launch counts are read around the driving."""
    import numpy as np
    from repro_torch import telemetry
    from repro_torch.core import unlearning
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.fl.experiment import (FederatedSession, UnlearnRequest,
                                           train_stage)

    tx, ty = test
    fused_sim, staged_sim = make_sim(), make_sim()
    # the shapes phase 3 checked the coding kernels at are this path's
    n_params = sum(v.numel() for v in tree_leaves(fused_sim.init_model(0)))
    want = PATHS[name]
    if (n_params, fused_sim.fl.global_rounds,
            fused_sim.fl.clients_per_shard) != (
            want["p_client"], want["rounds"], CLIENTS_PER_SHARD):
        raise AssertionError(f"{name}: P={n_params}, G="
                             f"{fused_sim.fl.global_rounds}, M="
                             f"{fused_sim.fl.clients_per_shard}; phase 3 "
                             f"checked {want}, M={CLIENTS_PER_SHARD}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    walls = {}
    fused = FederatedSession(fused_sim, store_kind="coded", engine="fused")
    t0 = time.perf_counter()
    rec = fused.run_stage()
    torch.cuda.synchronize()
    walls["train_fused_s"] = time.perf_counter() - t0
    plan = rec.plan
    before = {s: tree_map(torch.clone, m)
              for s, m in rec.shard_models.items()}
    victim = plan.shard_clients[0][0]
    t0 = time.perf_counter()
    se = fused.unlearn(UnlearnRequest([victim], request_id="se-1"))[0]
    walls["unlearn_se_s"] = time.perf_counter() - t0
    pair = [plan.shard_clients[1][0], plan.shard_clients[2][0]]
    t0 = time.perf_counter()
    batched = fused.unlearn(UnlearnRequest(pair, request_id="se-2"))[0]
    walls["unlearn_batched_se_s"] = time.perf_counter() - t0
    staged = FederatedSession(staged_sim, store_kind="coded", engine="stage")
    # the stage program's span carries its analytic training FLOPs
    tracer = telemetry.configure(enabled=True, annotate_costs=True)
    t0 = time.perf_counter()
    srec = staged.run_stage()
    torch.cuda.synchronize()
    walls["train_stage_engine_s"] = time.perf_counter() - t0
    telemetry.configure(enabled=False)
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log("main", path=name, launches=launches, peak_mem_bytes=peak, **walls)
    stage_cost_line(torch, name, tracer, walls["train_stage_engine_s"])
    missing = [k for k in need if launches[k] == 0]
    if missing:
        raise AssertionError(f"{name}: kernels never launched on the main "
                             f"path: {missing}")

    # -- checks -----------------------------------------------------------
    sch = rec.store.scheme
    other = [i for i in range(sch.num_clients)
             if i not in set(sch.quorum().tolist())]
    for eng, r in (("fused", rec), ("stage", srec)):
        for s, cs in r.plan.shard_clients.items():
            stored0 = r.store.get_shard(0, s)
            stacked = tree_map(lambda *vs: torch.stack(vs),
                               *[stored0[c] for c in cs])
            fedavg = unlearning.stacked_mean(stacked)
            e = rel_err(fedavg, r.round_globals[s][1])
            alt = r.store.get_shard(0, s, available=other)
            e_alt = max(rel_err(alt[c], stored0[c]) for c in cs)
            log("check", path=name, engine=eng, shard=s,
                decoded_fedavg_vs_round1_rel_err=e,
                other_subset_decode_rel_err=e_alt)
            if not (e <= 1e-4 and e_alt <= 1e-4):
                raise AssertionError(f"{name} {eng} shard {s}: decode check "
                                     f"failed ({e}, {e_alt})")
    slice_diff = [
        float((srec.store._slices[g].float()
               - rec.store._slices[g].float()).abs().max())
        / float(rec.store._slices[g].float().abs().max())
        for g in (0, fused_sim.fl.global_rounds - 1)]
    # set the engines' gap beside the gap fp32 rounding alone opens: round
    # 0 again on the fused engine, from initial weights moved by one ulp
    spread = None
    if slice_diff[0] > 0:
        usim = make_sim()
        urec = train_stage(usim, engine="fused", rounds=1,
                           init_fn=_ulp_perturbed(torch, usim.cfg, usim.seed))
        spread = (float((urec.store._slices[0].float()
                         - rec.store._slices[0].float()).abs().max())
                  / float(rec.store._slices[0].float().abs().max()))
        del usim, urec
    log("check", path=name, stage_vs_fused_slices_rel_diff=max(slice_diff),
        first_and_last_round=slice_diff, one_ulp_round0_rel_spread=spread)

    for res, hit in ((se, [0]), (batched, [1, 2])):
        if res.impacted_shards != hit:
            raise AssertionError(f"impacted {res.impacted_shards} != {hit}")
        for s, m in res.models.items():
            if not all(bool(torch.isfinite(v).all())
                       for v in tree_leaves(m)):
                raise AssertionError(f"{name}: non-finite unlearned model "
                                     f"{s}")
            if s not in hit and not all(
                    torch.equal(a, b) for a, b in
                    zip(tree_leaves(m), tree_leaves(before[s]))):
                raise AssertionError(f"{name}: untouched shard {s} changed")
    sampled = set(plan.clients)
    held = [c for c in sorted(fused_sim.client_data) if c not in sampled][:10]
    hx = np.concatenate([fused_sim.client_data[c][0] for c in held])
    hy = np.concatenate([fused_sim.client_data[c][1] for c in held])

    def scores(sim, models):
        return {"test": sim.evaluate(models, tx, ty),
                "held_out": sim.evaluate(models, hx, hy)}
    metrics = {"trained": scores(fused.sim, rec.shard_models),
               "se": scores(fused.sim, se.models),
               "batched_se": scores(fused.sim, batched.models),
               "stage_engine": scores(staged.sim, srec.shard_models)}
    log("check", path=name, ensemble=metrics, held_out_clients=held,
        se_cost_units=se.cost_units,
        batched_se_cost_units=batched.cost_units,
        store_stats=rec.store.stats.to_dict())
    for which, m in metrics.items():
        if not metric_ok(m):
            raise AssertionError(f"{name}: {which} ensemble fails its "
                                 f"check: {m}")
    profile_round(torch, fused.sim, plan, name, flag_cost=name == "cnn")
    TRAINED[name] = (fused, make_sim)
    return launches


def stage_cost_line(torch, name, tracer, wall_s: float) -> None:
    """The stage-engine stage's ``device.stage_program`` span under
    ``annotate_costs``: its analytic training FLOPs (every matrix product
    of every SGD step, forward and backward, and the recurrence kernels'
    arithmetic), bytes and encode FLOPs beside the stage's wall (host
    clock to a synchronize; the encode's FLOPs are not in the rate), the
    achieved training rate and its share of the fp32 peak, with the card's
    name and power limit."""
    (span,) = [s for s in tracer.all_spans()
               if s.name == "device.stage_program"]
    lab = span.labels
    flops = lab["train_flops"]
    row = {"train_flops": flops, "train_bytes": lab["train_bytes"],
           "encode_flops": lab["encode_flops"], "stage_wall_s": wall_s,
           "program_span_s": span.t1 - span.t0,
           "achieved_tflops": flops / wall_s / 1e12,
           "fp32_peak_share": flops / wall_s / FP32_FLOPS_PER_S,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi()}
    if not (lab["train_flops"] > 0 and math.isfinite(row["achieved_tflops"])):
        raise AssertionError(f"{name}: stage cost {row}")
    log("stage_cost", path=name, **row)


def profile_round(torch, sim, plan, name, flag_cost: bool = False):
    """Where a stage's time goes: one fused ``shard_round`` (M clients, L
    epochs) timed on the host clock, then traced once: its kernels by name,
    their sum, their union (the device-busy time) and the idle share, all
    from that one traced run.  With ``flag_cost``, the same again with
    ``torch.backends.cudnn.deterministic`` off (``resolve_device`` sets
    it): what the flag costs."""
    from repro_torch.core.tree import tree_map
    clients = plan.shard_clients[sorted(plan.shard_clients)[0]]
    xs, ys = sim._stack_client_data(clients)
    w = tree_map(lambda v: v.unsqueeze(0), sim.init_model(0))

    def run():
        sim.shard_round(w, xs[None], ys[None], sim.fl.local_epochs, "flat")
        torch.cuda.synchronize()

    def measure():
        run()
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
        d = device_busy(run)
        traced = d["wall_s"] * 1e3
        return {"wall_ms": wall, "traced_wall_ms": traced,
                "device_busy_ms": d["busy_ms"],
                "device_idle_share": (1 - d["busy_ms"] / traced
                                      if d["records"] else None),
                "kernel_sum_ms": d["sum_ms"],
                "stream_overlap_ms": d["stream_overlap_ms"],
                "device_records": d["records"], "distinct": d["distinct"],
                "streams": d["streams"], "by_stream": d["by_stream"],
                "top_ms": [[n[:80], ms] for n, ms in sorted(
                    d["by_name"].items(), key=lambda kv: -kv[1])[:8]]}
    row = measure()
    steps = sim.fl.local_epochs * (xs.shape[1] // sim.local_batch)
    if flag_cost:
        torch.backends.cudnn.deterministic = False
        try:
            off = measure()
        finally:
            torch.backends.cudnn.deterministic = True
        off["top_ms"] = off["top_ms"][:4]
        row["cudnn_deterministic_off"] = off
    log("profile", path=name, what=f"one fused shard_round: {len(clients)} "
        f"clients, {steps} SGD steps",
        cudnn_deterministic=torch.backends.cudnn.deterministic, **row)


def cnn_federation():
    """Phase 5a's federation: ``(make_sim, test)``, a factory of fresh
    simulators of the paper CNN at full width (G cut from 30 to
    ``PATHS["cnn"]["rounds"]``) and the task's test set."""
    from repro_torch.configs import FLConfig, OptimizerConfig, get_config
    from repro_torch.data.federated import get_partitioner
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import ScenarioConfig
    from repro_torch.fl.tasks import ClassificationTask

    model_cfg = get_config("cnn-paper")
    fl = FLConfig(num_clients=100, clients_per_round=20, num_shards=4,
                  local_epochs=10,
                  global_rounds=PATHS["cnn"]["rounds"], retrain_ratio=2)
    task = ClassificationTask()
    clients, test = task.build_data(ScenarioConfig.paper_full(noise=0.25),
                                    model_cfg, get_partitioner("iid"))

    def make_sim(device=None):
        return FLSimulator(model_cfg, fl, clients, task,
                           opt_cfg=OptimizerConfig(name="sgd", lr=0.05,
                                                   grad_clip=0.0),
                           local_batch=20, seed=0, device=device)
    return make_sim, test


def cnn_path(torch, K):
    """Phase 5a: the paper CNN at full width, cut from G = 30 to
    ``PATHS["cnn"]["rounds"]`` rounds to keep the script's time."""
    make_sim, test = cnn_federation()
    return main_path(torch, K, "cnn", make_sim, test, CODING,
                     lambda m: m["test"]["acc"] > 0.1)


def _models_finite(torch, models) -> bool:
    from repro_torch.core.tree import tree_leaves
    return all(bool(torch.isfinite(v).all()) for m in models.values()
               for v in tree_leaves(m))


# tests/test_faults.py's tiny CNN session: 10 clients, 8 a stage, S = 2
SERVICE_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
                    local_epochs=2, global_rounds=3, retrain_ratio=2.0)
SERVICE_FAULT_SEED = 7      # tests/test_faults.py's FAULT_SEED


def _chaotic_plan():
    """tests/test_faults.py's chaotic plan, with slot 1 dead."""
    from repro_torch.faults import FaultPlan
    return (FaultPlan(SERVICE_FAULT_SEED)
            .add("slice_corruption", count=2, scale=10.0)
            .add("job_exception", rate=1.0, fail_attempts=1)
            .add("device_failure", device=1))


def _tiny_service_session(dev):
    from repro_torch.configs import FLConfig, OptimizerConfig, get_config
    from repro_torch.data import client_datasets_images, make_image_data
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import FederatedSession
    cfg = dataclasses.replace(get_config("cnn-paper"), image_size=8,
                              d_model=16, cnn_channels=(4, 4))
    data = make_image_data(300, image_size=8, seed=0)
    sim = FLSimulator(cfg, FLConfig(**SERVICE_TINY),
                      client_datasets_images(data, 10, iid=True),
                      task="image",
                      opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                              grad_clip=0.0),
                      local_batch=10, seed=0, device=dev)
    session = FederatedSession(sim, store_kind="coded")
    session.run_stage()
    return session


def _served(session, start: int) -> dict:
    """{shard: model} of the results a serve landed after index
    ``start`` of the session's report."""
    out = {}
    for r in [u for st in session.report.stages for u in st.unlearn][start:]:
        for s in r.impacted_shards:
            out[s] = r.models[s]
    return out


def _same_models(torch, a: dict, b: dict, what: str) -> None:
    from repro_torch.core.tree import tree_leaves
    if set(a) != set(b) or not all(
            torch.equal(x, y) for s in a
            for x, y in zip(tree_leaves(a[s]), tree_leaves(b[s]))):
        raise AssertionError(f"service: {what}: per-shard models are not "
                             f"bit-identical")


def service_path(torch, K, session):
    """Phase 5s: the online unlearning service on the paper CNN's trained
    session of phase 5a (full width, 100 clients, 20 a stage, S = 4, M =
    5, C = 20, L = 10, G = 10): (a) four requests on four shards served by
    FIFO on one slot and by a window on four slots of the card (one stream
    each), models bit-identical, the same launches; (b) a Poisson trace
    under fifo, window and sla on four slots; (c) the chaotic plan with
    slot 1 dead, bit-identical to the fault-free serve, and on the tiny
    session of tests/test_faults.py the card's ledger signature equal to
    the CPU's; (d) the audit chain's head on the card equal to the CPU's,
    and a resume from a journal with two requests committed; (e) a traced
    serve's Chrome trace valid with a lane per slot, and the disabled
    tracer's overhead against a CNN stage's walls.  Returns the path's
    launches: the sum over the full-width session's serves, each counted
    from zero just before it and read just after."""
    import math

    from repro_torch import telemetry as TT
    from repro_torch.core.sharding import even_requests
    from repro_torch.durability import Journal
    from repro_torch.fl.experiment import train_stage
    from repro_torch.service import (DevicePlacement, RetryPolicy,
                                     UnlearningService, poisson_trace,
                                     sequenced_trace, single_device_placement)

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    plan = session.records[0].plan
    trace = sequenced_trace(even_requests(plan, 4), spacing=0.0, rounds=2)
    # the path's launches: each serve of the full-width session counted
    # from zero just before it and read just after; the tiny sessions'
    # training and serves and (e)'s training stage stay out
    served = dict.fromkeys(K.LAUNCHES, 0)

    def serve(sess, placement, policy, trace, opts=None, faults=None,
              journal=None, resume=False):
        n0 = len([u for st in sess.report.stages for u in st.unlearn])
        torch.cuda.synchronize()
        K.reset_launches()
        svc = UnlearningService(sess, policy=policy, policy_opts=opts or {},
                                placement=placement, faults=faults,
                                retry=RetryPolicy(backoff=0.001),
                                journal=journal)
        t0 = time.perf_counter()
        try:
            rep = svc.serve(trace, resume=resume)
        finally:
            for r in sess.records:
                r.store.attach_faults(None)
        wall = time.perf_counter() - t0
        if sess is session:
            for k, v in K.LAUNCHES.items():
                served[k] += v
        counts = {k: K.LAUNCHES[k] for k in CODING}
        return rep, _served(sess, n0), counts, wall, svc

    one = single_device_placement()
    four = DevicePlacement(devices=[dev] * 4)
    # (a) concurrency: a first serve of each makes the workers, their
    # streams and their library handles; the second is the one measured
    serve(session, one, "fifo", trace)
    serve(session, four, "window", trace, {"width": 1.0})
    seq, seq_models, seq_counts, seq_wall, _ = serve(session, one, "fifo",
                                                     trace)
    par, par_models, par_counts, par_wall, _ = serve(
        session, four, "window", trace, {"width": 1.0})
    used = sorted({d for e in par.entries for d in e.devices})
    merged = [u for st in session.report.stages for u in st.unlearn][-1]
    if (used, par.num_batches, max(e.n_jobs for e in par.entries),
            sorted(merged.impacted_shards)) != ([0, 1, 2, 3], 1, 4,
                                                [0, 1, 2, 3]):
        raise AssertionError(f"service (a): devices {used}, batches "
                             f"{par.num_batches}, jobs "
                             f"{[e.n_jobs for e in par.entries]}, impacted "
                             f"{merged.impacted_shards}")
    _same_models(torch, seq_models, par_models, "four slots vs one slot")
    if seq_counts != par_counts or not all(seq_counts[k] for k in
                                           ("coded_matmul", "calibrate")):
        raise AssertionError(f"service (a): launches {par_counts} on four "
                             f"slots, {seq_counts} on one")
    traced = {}
    for label, args in (("one_slot", (one, "fifo", trace)),
                        ("four_slots", (four, "window", trace,
                                        {"width": 1.0}))):
        d = device_busy(lambda: serve(session, *args))
        traced[label] = {"wall_s": d["wall_s"],
                         "device_busy_ms": d["busy_ms"],
                         "kernel_sum_ms": d["sum_ms"],
                         "stream_overlap_ms": d["stream_overlap_ms"],
                         "device_records": d["records"],
                         "distinct": d["distinct"], "streams": d["streams"],
                         "idle_share": (1 - d["busy_ms"] / (d["wall_s"] * 1e3)
                                        if d["records"] else None)}
    log("service", part="a_concurrency", requests=len(trace),
        one_slot_serve_wall_s=seq_wall, four_slot_serve_wall_s=par_wall,
        one_slot_report_wall_s=seq.serve_wall,
        four_slot_report_wall_s=par.serve_wall,
        launches_one_slot=seq_counts, launches_four_slots=par_counts,
        traced=traced,
        models_bit_identical=True, devices_used=used)

    # (b) latency under each policy, four slots
    lat = {}
    ptrace = poisson_trace(plan.clients, n=16, rate=4.0, seed=0,
                           deadline=30.0, skew=1.0)
    for policy, opts in (("fifo", {}), ("window", {"width": 1.0}),
                         ("sla", {"default_deadline": 30.0})):
        rep, _m, counts, wall, _ = serve(session, four, policy, ptrace, opts)
        row = {"p50_s": rep.p50, "p95_s": rep.p95, "p99_s": rep.p99,
               "throughput_rps": rep.throughput,
               "sla_hit_rate": rep.sla_hit_rate,
               "batches": rep.num_batches, "serve_wall_s": rep.serve_wall,
               "launches": counts}
        if rep.num_aborted or len(rep.entries) != 16 or not all(
                math.isfinite(row[k]) for k in ("p50_s", "p99_s",
                                                "throughput_rps")):
            raise AssertionError(f"service (b) {policy}: {row}")
        lat[policy] = row
    log("service", part="b_latency", trace="poisson n 16 rate 4.0 seed 0 "
        "deadline 30.0 skew 1.0", slots=4, policies=lat)

    # (c) chaos at full width: the plan, slot 1 dead, four slots
    cplan = _chaotic_plan()
    crep, c_models, c_counts, c_wall, _ = serve(
        session, four, "window", trace, {"width": 1.0}, faults=cplan)
    _same_models(torch, par_models, c_models, "chaotic vs fault-free")
    f = crep.faults
    if (len(crep.entries) != len(trace) or crep.num_aborted
            or f["aborts"] or not f["retries"] or not f["recoveries"]
            or crep.placement["unhealthy"] != [1]):
        raise AssertionError(f"service (c): {f}, unhealthy "
                             f"{crep.placement['unhealthy']}")
    log("service", part="c_chaos", serve_wall_s=c_wall,
        fault_free_serve_wall_s=par_wall,
        fault_path_overhead_s=c_wall - par_wall,
        retries=f["retries"], recoveries=f["recoveries"],
        recovered_slices=f["recovered_slices"], ledger=f.get("ledger"),
        launches=c_counts, models_bit_identical=True)

    # (c, d) the tiny session on the card and on the CPU: the chaotic
    # serve's ledger signature and audit head; resume from a journal
    small = {}
    for where in ("cuda", "cpu"):
        sess = _tiny_service_session(where)
        slots = DevicePlacement(devices=[where] * 4)
        strace = sequenced_trace(even_requests(sess.records[0].plan, 4),
                                 spacing=0.0, rounds=2)
        p = _chaotic_plan()
        rep, _m, _c, _w, svc = serve(sess, slots, "window", strace,
                                     {"width": 1.0}, faults=p)
        small[where] = (p.ledger.signature(), svc.audit.head,
                        rep.num_aborted, sess, slots, strace)
    (sig_card, head_card, ab_card, tsess, tslots, strace), \
        (sig_cpu, head_cpu, ab_cpu, _s, cpu_slots, _t) = \
        small["cuda"], small["cpu"]
    cpu_slots.shutdown()
    if not sig_card or sig_card != sig_cpu or ab_card or ab_cpu:
        raise AssertionError("service (c): the tiny session's ledger "
                             "signature differs between the card and the "
                             "CPU")
    if head_card != head_cpu:
        raise AssertionError("service (d): audit heads differ between the "
                             "card and the CPU")
    jdir = Path(__file__).resolve().parent / "build" / "service_smoke"
    jdir.mkdir(parents=True, exist_ok=True)
    jpath = jdir / "svc.journal"
    if jpath.exists():
        jpath.unlink()
    serve(tsess, tslots, "fifo", strace[:2], journal=Journal(str(jpath)))
    n_before = len(Journal(str(jpath)).events())
    rrep, _m, _c, _w, rsvc = serve(tsess, tslots, "fifo", strace,
                                   journal=Journal(str(jpath)),
                                   resume=True)
    again = [e["request_id"] for e in Journal(str(jpath)).events()[n_before:]
             if e["ev"] == "svc_dispatch"]
    if again != ["svc-2", "svc-3"] or [e.rid for e in rrep.entries] != \
            [0, 1, 2, 3]:
        raise AssertionError(f"service (d): resume re-dispatched {again}")
    rsvc.audit.verify()
    tslots.shutdown()
    log("service", part="cd_small_card_vs_cpu",
        ledger_signature_equal=True, ledger_events=len(sig_card),
        audit_head=head_card, audit_head_equal=True,
        resume_redispatched=again)

    # (e) telemetry: a traced serve of (a), then the disabled tracer's cost
    tr = TT.configure(enabled=True)
    try:
        serve(session, four, "window", trace, {"width": 1.0})
        obj = TT.to_chrome_trace(tr)
    finally:
        TT.configure(enabled=False)
    problems = TT.validate_chrome_trace(obj)
    lanes = sorted({e["args"]["name"] for e in obj["traceEvents"]
                    if e["name"] == "thread_name"})
    slot_lanes = [f"device-{i}" for i in range(4)]
    if problems or not set(slot_lanes) <= set(lanes):
        raise AssertionError(f"service (e): trace problems {problems[:5]}, "
                             f"lanes {lanes}")
    with open(jdir / "trace.json", "w") as fh:
        json.dump(obj, fh)
    null = TT.get_tracer()
    n = 100_000
    t0 = time.perf_counter()
    for _ in range(n):
        with null.span("stage.train", engine="fused", shards=4) as sp:
            sp.annotate(stage=1)
    per_call = (time.perf_counter() - t0) / n
    sim = session.sim

    def stage():
        # the fused engine's stage at G cut from 10 to 2: a shorter wall
        # makes the overhead bound stricter
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train_stage(sim, store_kind="coded", engine="fused", rounds=2)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    untraced = stage()
    tr = TT.configure(enabled=True)
    try:
        traced = stage()
        n_sites = len(tr.all_spans())
    finally:
        TT.configure(enabled=False)
    overhead = per_call * 4 * max(n_sites, 1)
    if overhead >= 0.02 * untraced:
        raise AssertionError(f"service (e): disabled-tracer overhead "
                             f"{overhead} s against a stage of {untraced} s")
    log("service", part="e_telemetry", chrome_trace_events=len(
        obj["traceEvents"]), lanes=lanes, validate_problems=0,
        null_span_ns=per_call * 1e9, spans_per_stage=n_sites,
        null_tracer_overhead_s=overhead,
        stage_wall_untraced_s=untraced, stage_wall_traced_s=traced,
        null_overhead_share_of_stage=overhead / untraced,
        launches=served, phase_s=time.perf_counter() - t_phase)
    one.shutdown()
    four.shutdown()
    return served


# ---------------------------------------------------------------------------
# Durability and tiering (phases 5t and 5u) and the kill/resume child
# ---------------------------------------------------------------------------

# tests/_durability_crash_child.py's session: the tiny CNN (8x8, channels
# 4/4, fc 16), 10 clients, 8 a stage, S = 2, L = 2, G = 2, three stages
# with an SE request after each
DURABILITY_TINY = dict(num_clients=10, clients_per_round=8, num_shards=2,
                       local_epochs=2, global_rounds=2, retrain_ratio=2.0)
DURABILITY_STAGES = 3
WALL_FIELDS = ("train_wall_s", "wall_time_s", "total_train_wall_s",
               "total_unlearn_wall_s")
COLD_FAULT_SEED = 20240     # tests/test_tiering.py's FAULT_SEED
CARD = "cuda"               # the device phases 5t, 5u and 8 run on


def zero_walls(node):
    """A report's ``to_dict()`` with its wall-time fields set to 0."""
    if isinstance(node, dict):
        return {k: (0.0 if k in WALL_FIELDS else zero_walls(v))
                for k, v in node.items()}
    if isinstance(node, list):
        return [zero_walls(x) for x in node]
    return node


def leaf_bytes(leaf):
    """``(dtype name, shape, raw bytes)`` of a tensor or array, bit for
    bit (a device tensor is copied to the host first)."""
    import numpy as np
    import torch
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        return (str(t.dtype).rsplit(".", 1)[-1], tuple(t.shape),
                t.reshape(-1).view(torch.uint8).numpy().tobytes())
    a = np.ascontiguousarray(np.asarray(leaf))
    return a.dtype.name, tuple(a.shape), a.tobytes()


def _hash_tree(h, tree) -> None:
    from repro_torch.core.tree import tree_leaves
    for leaf in tree_leaves(tree):
        name, shape, raw = leaf_bytes(leaf)
        h.update(str((name, shape)).encode())
        h.update(raw)


def session_signature(session) -> str:
    """Content hash of everything the durability contract promises: shard
    models, coded slices, unlearn-result models, and the (wall-free)
    accounting report (tests/_durability_crash_child.py's)."""
    import hashlib
    h = hashlib.sha256()
    for rec in session.records:
        for s in sorted(rec.shard_models):
            _hash_tree(h, rec.shard_models[s])
        store = rec.store
        if hasattr(store, "flush"):
            store.flush()
        for key in sorted(getattr(store, "_slices", {}), key=repr):
            _hash_tree(h, store._slices[key])
    for st in session.report.stages:
        for u in st.unlearn:
            h.update(u.request_id.encode())
            for s in sorted(u.models):
                _hash_tree(h, u.models[s])
    h.update(json.dumps(zero_walls(session.report.to_dict()),
                        sort_keys=True).encode())
    return h.hexdigest()


def durability_schedule():
    """One SE request after each stage; callable clients resolve against
    the trained plan, so baseline, crashed and resumed runs target the same
    victims."""
    from repro_torch.fl.experiment import RequestSchedule, UnlearnRequest
    return RequestSchedule([
        UnlearnRequest(lambda p: [p.shard_clients[0][0]], framework="SE",
                       after_stage=0, rounds=1),
        UnlearnRequest(lambda p: [p.shard_clients[1][0]], framework="SE",
                       after_stage=1, rounds=1),
        UnlearnRequest(lambda p: [p.shard_clients[0][0]], framework="SE",
                       after_stage=2, rounds=1),
    ])


def durability_session(device, ckpt_dir=None, faults=None):
    """The kill/resume session on ``device``, checkpointing every stage
    into ``ckpt_dir`` when one is given."""
    from repro_torch.configs import FLConfig, OptimizerConfig, get_config
    from repro_torch.data import client_datasets_images, make_image_data
    from repro_torch.fl import FLSimulator
    from repro_torch.fl.experiment import FederatedSession
    cfg = dataclasses.replace(get_config("cnn-paper"), image_size=8,
                              d_model=16, cnn_channels=(4, 4))
    fl = FLConfig(**DURABILITY_TINY)
    data = make_image_data(fl.num_clients * 30, image_size=8, seed=0)
    sim = FLSimulator(cfg, fl,
                      client_datasets_images(data, fl.num_clients, iid=True),
                      task="image",
                      opt_cfg=OptimizerConfig(name="sgdm", lr=0.05,
                                              grad_clip=0.0),
                      local_batch=10, seed=0, device=device)
    return FederatedSession(sim, store_kind="coded", faults=faults,
                            checkpoint_every=1 if ckpt_dir else 0,
                            checkpoint_dir=ckpt_dir)


def durability_child(args) -> int:
    """``chip_smoke.py durability-child <mode> <dir> [--device cpu]``, the
    counterpart of tests/_durability_crash_child.py on the port: ``baseline``
    runs the three-stage session uninterrupted and prints its signature;
    ``crash`` runs it checkpointing into ``dir`` and dies by ``os._exit(137)``
    after stage 1's requests (before its snapshot); ``resume`` finishes the
    run from ``dir`` and prints its signature and resume accounting.  On
    the card unless ``--device cpu``."""
    if len(args) not in (2, 4) or (len(args) == 4
                                   and args[2:] != ["--device", "cpu"]):
        print("usage: chip_smoke.py durability-child baseline|crash|resume "
              "<dir> [--device cpu]", file=sys.stderr)
        return 2
    mode, ckpt = args[0], args[1]
    from repro_torch import kernels as K
    from repro_torch.faults import FaultPlan
    dev = K.resolve_device("cpu" if len(args) == 4 else "cuda")
    if mode == "baseline":
        session = durability_session(dev)
        session.run(DURABILITY_STAGES, schedule=durability_schedule())
        print(json.dumps({"sig": session_signature(session)}))
    elif mode == "crash":
        plan = FaultPlan(seed=7).add("process_kill", stage=1,
                                     phase="after_requests", mode="exit",
                                     exit_code=137)
        session = durability_session(dev, ckpt, faults=plan)
        session.run(DURABILITY_STAGES, schedule=durability_schedule())
        print(json.dumps({"error": "process_kill never fired"}))
        return 3
    elif mode == "resume":
        session = durability_session(dev, ckpt)
        session.run(DURABILITY_STAGES, schedule=durability_schedule(),
                    resume_from=ckpt)
        info = session.last_resume_info
        pairs = [(i, u.request_id)
                 for i, st in enumerate(session.report.stages)
                 for u in st.unlearn]
        print(json.dumps({"sig": session_signature(session),
                          "start_stage": info["start_stage"],
                          "resumed_step": info["step"],
                          "inflight": info["inflight"],
                          "request_ids": sorted({r for _, r in pairs}),
                          "once_per_stage": len(pairs) == len(set(pairs))}))
    else:
        print(f"chip_smoke.py durability-child: unknown mode {mode!r}",
              file=sys.stderr)
        return 2
    return 0


def model_tensors(models: dict, prefix: str = "") -> dict:
    """``{shard: tree}`` as ``{name: tensor}``."""
    from repro_torch.core.tree import leaves_with_paths
    return {f"{prefix}{s}/" + "/".join(map(str, path)): leaf
            for s in sorted(models)
            for path, leaf in leaves_with_paths(models[s])}


def session_tensors(session) -> dict:
    """Every tensor a durable session holds, by name: shard models, round
    globals, coded slices, unlearn-result models."""
    out = {}
    for i, rec in enumerate(session.records):
        out.update(model_tensors(rec.shard_models, f"r{i}/model"))
        for s in sorted(rec.round_globals):
            out.update(model_tensors(dict(enumerate(rec.round_globals[s])),
                                     f"r{i}/global{s}."))
        for g in sorted(rec.store._slices):
            out[f"r{i}/slices{g}"] = rec.store._slices[g]
    for st in session.report.stages:
        for j, u in enumerate(st.unlearn):
            out.update(model_tensors(u.models, f"stage{st.stage}/result{j}/"))
    return out


def _same_tensors(torch, a: dict, b: dict, what: str) -> int:
    """Hold two ``{name: tensor}`` maps equal bit for bit (dtype, shape and
    bytes, across devices); returns the bytes compared."""
    if sorted(a) != sorted(b):
        raise AssertionError(f"{what}: tensor sets differ: "
                             f"{sorted(set(a) ^ set(b))[:5]}")

    def bits(t):
        return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8)
    n = 0
    for k in a:
        x, y = a[k], b[k]
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(
                bits(x), bits(y)):
            raise AssertionError(f"{what}: {k} is not bit-identical")
        n += x.numel() * x.element_size()
    return n


def durability_path(torch, K, session, make_sim):
    """Phase 5t: durability on the card.  (a) phase 5a's trained full-width
    CNN session (after the service phase's serves) is captured and saved
    through ``CheckpointManager``, loaded back (``load_latest``) and
    restored into a freshly built session of the same configuration on the
    card: every shard model, coded slice, round global and result model
    bit-identical, the reports (walls zeroed) equal; one SE request on the
    original and on the restored session gives bit-identical models; the
    same snapshot restored into a CPU session gives the same bytes for
    every tensor.  (b) tests/_durability_crash_child.py's three-stage tiny
    session as baseline, crash (``process_kill``, exit 137 after stage 1's
    requests) and resume, each a subprocess on the card
    (``durability-child``): the resumed signature equals the baseline's.
    (c) in process, a ``torn_write`` on snapshot 1 and a crash right after
    it: the resume skips snapshot 1, restores snapshot 0 and ends
    bit-identical to the baseline.  Returns the path's launches (counted
    from zero before the phase and read after it) and the snapshot's
    directory, which the tiering phase restores from again and removes."""
    import os
    import shutil
    import tempfile

    from repro_torch.durability import (CheckpointManager, capture_session,
                                        restore_session)
    from repro_torch.faults import FaultPlan, InjectedCrash
    from repro_torch.fl.experiment import FederatedSession, UnlearnRequest

    t_phase = time.perf_counter()
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(parents=True, exist_ok=True)
    snap_dir = tempfile.mkdtemp(prefix="durability-", dir=build)
    torch.cuda.synchronize()
    K.reset_launches()

    # (a) the full-width session: save, load, restore on the card and the CPU
    mgr = CheckpointManager(snap_dir)
    t0 = time.perf_counter()
    mgr.save(capture_session(session), step=0)
    save_s = time.perf_counter() - t0
    nbytes = mgr.last_save_bytes
    t0 = time.perf_counter()
    state, step, _path = mgr.load_latest(device=CARD)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    restored = FederatedSession(make_sim(), store_kind=session.store_kind,
                                engine=session.engine)
    t0 = time.perf_counter()
    restore_session(restored, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del state
    card = session_tensors(restored)
    compared = _same_tensors(torch, session_tensors(session), card,
                             "durability (a): original vs card restore")
    if zero_walls(session.report.to_dict()) != \
            zero_walls(restored.report.to_dict()):
        raise AssertionError("durability (a): reports differ after restore")
    t0 = time.perf_counter()
    cpu_state = mgr.load_latest(device="cpu")[0]
    cpu_load_s = time.perf_counter() - t0
    on_cpu = FederatedSession(make_sim(device="cpu"),
                              store_kind=session.store_kind,
                              engine=session.engine)
    t0 = time.perf_counter()
    restore_session(on_cpu, cpu_state)
    cpu_restore_s = time.perf_counter() - t0
    del cpu_state
    _same_tensors(torch, card, session_tensors(on_cpu),
                  "durability (a): card restore vs CPU restore")
    del card, on_cpu
    victim = session.records[0].plan.shard_clients[1][0]
    t0 = time.perf_counter()
    orig = session.unlearn(UnlearnRequest([victim],
                                          request_id="durability-se"))[0]
    se_orig_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = restored.unlearn(UnlearnRequest([victim],
                                           request_id="durability-se"))[0]
    se_back_s = time.perf_counter() - t0
    _same_tensors(torch, model_tensors(orig.models),
                  model_tensors(back.models),
                  "durability (a): SE on the original vs the restored")
    del restored
    mb = nbytes / 1e6
    log("durability", part="a_full_width", snapshot_bytes=nbytes,
        tensor_bytes_compared=compared, step=step,
        save_s=save_s, save_mb_s=mb / save_s,
        load_s=load_s, load_mb_s=mb / load_s,
        restore_s=restore_s, cpu_load_s=cpu_load_s,
        cpu_load_mb_s=mb / cpu_load_s, cpu_restore_s=cpu_restore_s,
        se_original_s=se_orig_s, se_restored_s=se_back_s,
        bit_identical=True)

    # (b) kill and resume, each a process of its own on the card
    kill_dir = tempfile.mkdtemp(prefix="durability-kill-", dir=build)
    child = [sys.executable, str(Path(__file__).resolve()),
             "durability-child"]

    def finish(proc, what):
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise AssertionError(f"durability (b): {what} timed out")
        return proc.returncode, out, err

    t0 = time.perf_counter()
    procs = {m: subprocess.Popen(child + [m, kill_dir],
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in ("baseline", "crash")}
    try:
        done = {m: finish(p, m) for m, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    rc, out, err = done["baseline"]
    if rc != 0:
        raise AssertionError(f"durability (b): baseline exit {rc}: "
                             f"{err[-2000:]}")
    base_sig = json.loads(out.strip().splitlines()[-1])["sig"]
    rc, out, err = done["crash"]
    left = sorted(os.listdir(kill_dir))
    if rc != 137 or left != ["journal.wal", "snap-000000.ckpt"]:
        raise AssertionError(f"durability (b): crash exit {rc}, left "
                             f"{left}: {err[-2000:]}")
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rc, out, err = finish(subprocess.Popen(
        child + ["resume", kill_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), "resume")
    resume_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"durability (b): resume exit {rc}: "
                             f"{err[-2000:]}")
    got = json.loads(out.strip().splitlines()[-1])
    if (got["sig"] != base_sig or got["start_stage"] != 1
            or got["resumed_step"] != 0 or not got["once_per_stage"]
            or got["request_ids"] != ["req-s0-0", "req-s1-0", "req-s2-0"]):
        raise AssertionError(f"durability (b): resume {got}, baseline "
                             f"signature {base_sig}")
    shutil.rmtree(kill_dir, ignore_errors=True)
    log("durability", part="b_kill_resume", crash_exit=137,
        baseline_and_crash_processes_s=first_s, resume_process_s=resume_s,
        resumed=got, signature_equal=True)

    # (c) a torn snapshot 1, then a crash: resume falls back to snapshot 0
    torn_dir = tempfile.mkdtemp(prefix="durability-torn-", dir=build)
    plan = (FaultPlan(seed=7).add("torn_write", step=1, frac=0.4)
            .add("process_kill", stage=1, phase="after_snapshot",
                 mode="raise"))
    crashed = durability_session(CARD, torn_dir, faults=plan)
    try:
        crashed.run(DURABILITY_STAGES, schedule=durability_schedule())
        raise AssertionError("durability (c): process_kill never fired")
    except InjectedCrash:
        pass
    t0 = time.perf_counter()
    resumed = durability_session(CARD)
    resumed.run(DURABILITY_STAGES, schedule=durability_schedule(),
                resume_from=torn_dir)
    torn_resume_s = time.perf_counter() - t0
    info = resumed.last_resume_info
    sig = session_signature(resumed)
    if (plan.ledger.count("torn_write") != 1
            or len(info["skipped_snapshots"]) != 1 or info["step"] != 0
            or info["start_stage"] != 1 or sig != base_sig):
        raise AssertionError(f"durability (c): {info}, signature equal "
                             f"{sig == base_sig}")
    shutil.rmtree(torn_dir, ignore_errors=True)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    missing = [k for k in ("coded_matmul", "calibrate") if not launches[k]]
    if missing:
        raise AssertionError(f"durability: kernels never launched: "
                             f"{missing}")
    log("durability", part="c_torn_snapshot",
        skipped=[os.path.basename(p) for p in info["skipped_snapshots"]],
        resumed_step=info["step"], resume_run_s=torn_resume_s,
        signature_equal=True, launches=launches,
        phase_s=time.perf_counter() - t_phase)
    return launches, snap_dir


def unit_cold_store(torch, device, offload_dir):
    """tests/test_tiering.py's ``_unit_store(seed=7)``, every round demoted
    to the cold tier: 12 clients in 4 shards, one round of a 5-float
    parameter per client."""
    import numpy as np
    from repro_torch.stores import RoundPayload, make_store
    shard_clients = {i: list(range(i * 3, (i + 1) * 3)) for i in range(4)}
    store = make_store("tiered", shard_clients, num_shards=4, num_clients=12,
                       offload_dir=str(offload_dir))
    rng = np.random.default_rng(7)
    params = {cl: {"w": torch.as_tensor(rng.standard_normal(5),
                                        dtype=torch.float32, device=device)}
              for cl in range(12)}
    store.put_round(RoundPayload.from_clients(0, shard_clients, params))
    store.flush()
    store.demote_all("cold")
    return store


def cold_corruption(torch, st) -> dict:
    """A cold read of round 0, shard 0 under an empty fault plan (an honest
    read: it must flag nothing), then, from the cold tier again, under
    ``cold_corrupt`` (2 slices, scale 10): what the robust decode flagged
    and recovered."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.faults import FaultPlan
    before = st.stats.snapshot()
    st.attach_faults(FaultPlan(seed=COLD_FAULT_SEED))     # empty plan
    clean = st.get_shard(0, 0)
    honest = [st.stats.corrupted_slices - before.corrupted_slices,
              st.stats.recovered_reads - before.recovered_reads]
    st.demote_all("cold")       # an unlimited store promoted the round
    plan = FaultPlan(seed=COLD_FAULT_SEED).add("cold_corrupt", count=2,
                                               scale=10.0)
    st.attach_faults(plan)
    t0 = time.perf_counter()
    try:
        bad = st.get_shard(0, 0)
    finally:
        st.attach_faults(None)
    read_s = time.perf_counter() - t0
    diff = max(float((x - y).abs().max()) for c in clean
               for x, y in zip(tree_leaves(bad[c]), tree_leaves(clean[c])))
    events = plan.ledger.events
    injected = [r for e in events if e.kind == "cold_corrupt"
                for r in e.detail]
    flagged = [r for e in events if e.kind == "quorum_read"
               for r in e.detail[1]]
    return {"honest_flags": honest, "diff": diff, "within_1e-4": diff <= 1e-4,
            "counts": [st.stats.corrupted_slices - before.corrupted_slices,
                       st.stats.recovered_reads - before.recovered_reads,
                       plan.ledger.count("cold_corrupt"),
                       plan.ledger.count("quorum_read")],
            "injected_rows": injected, "flagged_rows": flagged,
            "injected_flagged": bool(injected) and set(injected) <= set(
                flagged),
            "corrupt_read_s": read_s}


def tiering_path(torch, K, snap_dir, make_sim):
    """Phase 5u: the tiered coded store on the card, on the full-width stage
    restored again from phase 5t's snapshot.  One SE request per budget
    (unlimited; hot at half the stage's slice bytes under lru, stage_age
    and heat; warm only; cold only) on a ``TieredStore`` holding the
    stage's rounds: unlimited equals the coded store bit for bit (models
    and every shared ``StoreStats`` field); every round read back through
    the tiers lies within ``quant_error_bound`` of the exact slices (0 for
    an exact round); a lossy budget's SE models equal bit for bit those of
    SE on a plain coded store holding the rounds the budget admitted below
    hot, quantized and dequantized by a plain torch codec, and their
    distance from the exact store's models is printed beside
    tests/test_tiering.py's 2e-2 (``TestConstrainedServing``, held at the
    reference's tiny size; at the CNN's width the int8 codec itself puts
    SE 8 % off, ROADMAP queue 3), with round 0's row amax over row rms,
    which sets the codec's relative error.  Cold only: an honest cold read
    flags nothing, and a ``cold_corrupt`` read (2 slices, scale 10)
    recovers to within 1e-4 of it with 2 corrupted slices, 1 recovered
    read and one ``cold_corrupt`` and one ``quorum_read`` ledger event.
    Last, the service phase's four-slot serve on the half-hot store gives
    per-shard models bit-identical to a one-slot serve.  Removes the
    snapshot's directory; returns the path's launches."""
    import shutil

    from repro_torch.core.sharding import even_requests
    from repro_torch.core.tree import tree_leaves
    from repro_torch.durability import CheckpointManager, restore_session
    from repro_torch.fl.experiment import FederatedSession, run_unlearn
    from repro_torch.service import (DevicePlacement, UnlearningService,
                                     sequenced_trace, single_device_placement)
    from repro_torch.stores import CodedStore
    from repro_torch.tiering import (MemoryBudget, TieredStore,
                                     quant_error_bound)

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    K.reset_launches()
    try:
        t0 = time.perf_counter()
        state = CheckpointManager(snap_dir).load_latest(device=CARD)[0]
        session = FederatedSession(make_sim(), store_kind="coded",
                                   engine="fused")
        restore_session(session, state)
        del state
        restore_s = time.perf_counter() - t0
        rec = session.records[0]
        exact = rec.store
        rounds = sorted(exact._slices)
        slice_bytes = sum(exact._slices[g].numel()
                          * exact._slices[g].element_size() for g in rounds)
        victim = rec.plan.shard_clients[0][0]
        stats0 = exact.stats.snapshot()

        def se(record):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_unlearn(session.sim, "SE", record, [victim])
            return res, time.perf_counter() - t0
        ex_res, ex_wall = se(rec)
        cold_root = Path(snap_dir) / "cold"

        def tiered(**opts):
            budget = MemoryBudget(hot_bytes=opts.pop("hot_bytes", None),
                                  warm_bytes=opts.pop("warm_bytes", None))
            st = TieredStore(exact.scheme, exact.shard_clients,
                             slice_dtype=exact.slice_dtype,
                             group_rounds=exact.group_rounds, budget=budget,
                             offload_dir=str(cold_root), **opts)
            st.stats = stats0.snapshot()
            st._specs, st._layouts = dict(exact._specs), dict(exact._layouts)
            with st._lock:
                for g in rounds:
                    st._slices[g] = exact._slices[g]
            return st

        def plain_lossy(lossy):
            """The coded store a lossy budget must serve as: the exact
            slices, the rounds in ``lossy`` quantized and dequantized by a
            plain torch version of the int8 codec (per-row amax / 127,
            rint, clip, q * scale).  Each division and product is taken in
            float64 and rounded once to float32, which is the correctly
            rounded float32 result the numpy codec computes (a CUDA
            division by a scalar multiplies by its reciprocal instead)."""
            st = CodedStore(exact.scheme, exact.shard_clients,
                            slice_dtype=exact.slice_dtype,
                            group_rounds=exact.group_rounds)
            st.stats = stats0.snapshot()
            st._specs, st._layouts = dict(exact._specs), dict(exact._layouts)
            for g in rounds:
                a = exact._slices[g]
                if g in lossy:
                    a64 = a.double()
                    amax = a64.abs().amax(dim=1)
                    scale = torch.where(amax > 0, amax / 127.0,
                                        torch.ones_like(amax)
                                        ).float().double()[:, None]
                    q = torch.clamp(torch.round((a64 / scale).float()),
                                    -127, 127)
                    a = (q.double() * scale).float().to(a.dtype)
                st._slices[g] = a
            return st

        def flat(models):
            return {s: torch.cat([v.detach().double().reshape(-1)
                                  for v in tree_leaves(m)])
                    for s, m in models.items()}
        ex_flat = flat(ex_res.models)
        plain_se = {}
        half = slice_bytes // 2
        budgets = (("unlimited", {}),
                   ("half_hot_lru", dict(hot_bytes=half)),
                   ("half_hot_stage_age", dict(hot_bytes=half,
                                               eviction="stage_age")),
                   ("half_hot_heat", dict(hot_bytes=half, eviction="heat")),
                   ("warm_only", dict(hot_bytes=0)),
                   ("cold_only", dict(hot_bytes=0, warm_bytes=0)))
        rows = {}
        cold_store = None
        for label, opts in budgets:
            t0 = time.perf_counter()
            st = tiered(**dict(opts))
            build_s = time.perf_counter() - t0
            admitted = {g: st.tier_of(g) for g in rounds}
            res, wall = se(dataclasses.replace(rec, store=st))
            if res.impacted_shards != ex_res.impacted_shards:
                raise AssertionError(f"tiering {label}: impacted "
                                     f"{res.impacted_shards}")
            stats = st.stats.to_dict()
            got = flat(res.models)
            if label == "unlimited":
                for s in ex_flat:
                    if not torch.equal(got[s], ex_flat[s]):
                        raise AssertionError("tiering unlimited: SE models "
                                             "differ from the coded store's")
                mine = exact.stats.to_dict()
                bad = [k for k in mine if not k.startswith("tier_")
                       and mine[k] != stats[k]]
                if bad or stats["tier_misses"]:
                    raise AssertionError(f"tiering unlimited: StoreStats "
                                         f"differ in {bad}")
                rel = max_abs = 0.0
            else:
                # a lossy budget serves the dequantized slices of the rounds
                # it admitted below hot: bit for bit the SE of a plain store
                # holding them
                lossy = frozenset(g for g, t in admitted.items()
                                  if t != "hot")
                if lossy not in plain_se:
                    plain_se[lossy] = flat(se(dataclasses.replace(
                        rec, store=plain_lossy(lossy)))[0].models)
                for s in ex_flat:
                    if not torch.equal(got[s], plain_se[lossy][s]):
                        raise AssertionError(
                            f"tiering {label}: SE models differ from the "
                            f"plain dequantized store's")
                # against the exact store: the codec's own error, held to
                # tests/test_tiering.py's 2e-2 only at the reference's tiny
                # size (ROADMAP queue 3: at the CNN's width a slice's scale
                # is set by conv1's weights, ~30x the fc weights')
                rel = max(float((got[s] - ex_flat[s]).norm()
                                / (ex_flat[s].norm() + 1e-12))
                          for s in ex_flat)
                max_abs = max(float((got[s] - ex_flat[s]).abs().max())
                              for s in ex_flat)
            # every round back through its tier against the exact slices
            err, bnd, ratio = 0.0, 0.0, 0.0
            for g in rounds:
                with st._lock:
                    back = st._slices[g]
                    e = st._slices.entry(g)
                    lossy, scales = e.lossy, e.scales
                d = float((back.float() - exact._slices[g].float())
                          .abs().max())
                b = quant_error_bound(scales) if lossy else 0.0
                if d > b:
                    raise AssertionError(f"tiering {label}: round {g} off "
                                         f"by {d} > bound {b}")
                err, bnd = max(err, d), max(bnd, b)
                ratio = max(ratio, d / b if b else 0.0)
            rows[label] = {"build_s": build_s, "se_wall_s": wall,
                           "admitted": admitted,
                           "tier_bytes": stats["tier_bytes"],
                           "tier_hits": stats["tier_hits"],
                           "tier_misses": stats["tier_misses"],
                           "tier_evictions": stats["tier_evictions"],
                           "tier_promotions": stats["tier_promotions"],
                           "se_rel_err": rel, "se_max_abs_err": max_abs,
                           "se_within_2e-2": rel < 2e-2 and max_abs < 2e-2,
                           "max_decode_err": err, "decode_bound": bnd,
                           "max_err_over_bound": ratio}
            if label == "cold_only":
                cold_store = st
            del st
        a0 = exact._slices[rounds[0]].float()
        spread = float((a0.abs().amax(1) / a0.pow(2).mean(1).sqrt()).median())
        log("tiering", part="budgets", stage_slice_bytes=slice_bytes,
            half_hot_bytes=half, rounds=len(rounds), restore_s=restore_s,
            round0_row_amax_over_rms=spread,
            exact_se_wall_s=ex_wall, budgets=rows)

        # cold-tier corruption: on the cold-only full-width store, then on
        # tests/test_tiering.py's unit store (12 clients, 4 shards, seed 7)
        cold = {"full_width": cold_store,
                "unit": unit_cold_store(torch, CARD, cold_root)}
        rows_cc = {}
        for label, st in cold.items():
            rows_cc[label] = cold_corruption(torch, st)
        del st, cold, cold_store
        got = rows_cc["unit"]
        if (got["honest_flags"] != [0, 0] or got["diff"] > 1e-4
                or got["counts"] != [2, 1, 1, 1]):
            raise AssertionError(f"tiering cold_corrupt (unit): {got}")
        got = rows_cc["full_width"]
        # the reference's lossy tolerance (3e-2) is below the codec's
        # residue at this width (ROADMAP queue 3): the read must still
        # complete and flag the injected rows, and the other numbers are
        # printed beside the unit store's
        if (got["honest_flags"] != [0, 0] or not got["injected_flagged"]
                or got["counts"][1:] != [1, 1, 1]):
            raise AssertionError(f"tiering cold_corrupt (full width): {got}")
        log("tiering", part="cold_corrupt", **rows_cc)

        # streams: the service's four-slot serve on the half-hot store
        st = tiered(hot_bytes=half)
        session.records[0] = dataclasses.replace(rec, store=st)
        plan = rec.plan
        trace = sequenced_trace(even_requests(plan, 4), spacing=0.0,
                                rounds=2)
        dev = torch.device(CARD)
        one = single_device_placement(dev)
        four = DevicePlacement(devices=[dev] * 4)
        served = {}
        for label, placement, policy, popts in (
                ("one_slot", one, "fifo", {}),
                ("four_slots", four, "window", {"width": 1.0})):
            n0 = len([u for s in session.report.stages for u in s.unlearn])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = UnlearningService(session, policy=policy,
                                    policy_opts=popts,
                                    placement=placement).serve(trace)
            served[label] = (_served(session, n0),
                             time.perf_counter() - t0,
                             sorted({d for e in rep.entries
                                     for d in e.devices}))
        one.shutdown()
        four.shutdown()
        _same_models(torch, served["one_slot"][0], served["four_slots"][0],
                     "tiered store, four slots vs one slot")
        if served["four_slots"][2] != [0, 1, 2, 3]:
            raise AssertionError(f"tiering streams: slots "
                                 f"{served['four_slots'][2]}")
        sstats = st.stats.to_dict()
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        missing = [k for k in ("coded_matmul", "calibrate")
                   if not launches[k]]
        if missing:
            raise AssertionError(f"tiering: kernels never launched: "
                                 f"{missing}")
        log("tiering", part="streams", budget="half_hot_lru",
            one_slot_serve_s=served["one_slot"][1],
            four_slot_serve_s=served["four_slots"][1],
            slots=served["four_slots"][2], models_bit_identical=True,
            tier_of={g: st.tier_of(g) for g in rounds},
            tier_hits=sstats["tier_hits"],
            tier_promotions=sstats["tier_promotions"],
            tier_evictions=sstats["tier_evictions"], launches=launches,
            phase_s=time.perf_counter() - t_phase)
        return launches
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)


def table1_path(torch, K):
    """Phase 5e: the paper's Table 1 through ``run_verification`` on the
    card: the paper CNN at full width in phase 5a's federation (G cut from
    30 to ``PATHS["cnn"]["rounds"]``), FR, FE, RR and SE against the retrain
    oracle and the no-unlearn baseline, scored by the shadow attack (two
    shadow federations) and the utility probe, on the coded store and the
    fused engine.  Launch counts are zeroed just before and read just
    after.  Fails when a candidate's cost units miss the formula, a
    framework's F1 is not finite, or ``coded_matmul`` or ``calibrate`` did
    not launch.  RR's models may end non-finite (it divides by a Fisher
    taken once at the restart, as the reference does): then its F1 is left
    out of the check and the log says so."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.experiment import ScenarioConfig
    from repro_torch.fl.families import (FAMILIES, ModelFamily,
                                         get_model_family,
                                         register_model_family)
    from repro_torch.models import init_params
    from repro_torch.verify import ShadowMIAVerifier, run_verification

    # the registered "cnn" family is the reference's scenario-scale CNN
    # (channels 8/16, fc 48); Table 1 runs the paper's width
    if "cnn-paper-width" not in FAMILIES:
        @register_model_family("cnn-paper-width")
        class PaperWidthCNN(ModelFamily):
            task = "classification"

            def build(self, cfg):
                return get_config("cnn-paper")
    g = PATHS["cnn"]["rounds"]
    cfg = ScenarioConfig.paper_full(model="cnn-paper-width", global_rounds=g,
                                    lr=0.05, local_batch=20, opt_name="sgd")
    model_cfg = get_model_family(cfg.model).build(cfg)
    n_params = sum(v.numel() for v in tree_leaves(
        init_params(model_cfg, 0, "cpu")))
    m = cfg.clients_per_round // cfg.num_shards
    retained = cfg.clients_per_round - 1
    if (n_params, m, retained) != (PATHS["cnn"]["p_client"],
                                   CLIENTS_PER_SHARD, TABLE1_RETAINED):
        raise AssertionError(f"table1: P={n_params}, M={m}, retained "
                             f"{retained}; phase 3 checked the CNN path's")
    ep, ep_r = cfg.local_epochs, max(int(cfg.local_epochs
                                         / cfg.retrain_ratio), 1)
    want = {"none": 0.0, "FR": g * retained * ep, "FE": g * retained * ep_r,
            "RR": g * retained * ep_r, "SE": g * (m - 1) * ep_r,
            "oracle": g * (m - 1) * ep}
    shadow = ShadowMIAVerifier()
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    rep = run_verification(cfg, frameworks=TABLE1_FRAMEWORKS,
                           verifiers=(shadow, "utility"), n_shadows=2,
                           keep_models=True)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    finite = {c.name: _models_finite(torch, rep.models[c.name])
              for c in rep.candidates}
    checked = [n for n in finite if finite[n] or n != "RR"]
    for c in rep.candidates:
        log("table1", candidate=c.name, mia_f1=c.metrics["mia_f1"],
            wall_s=c.wall_s, cost_units=c.cost_units,
            retain_acc=c.metrics["retain_acc"],
            test_acc=c.metrics["test_acc"],
            retain_loss=c.metrics["retain_loss"],
            models_finite=finite[c.name],
            f1_checked=c.name in checked)
    log("table1", victims=rep.victims, shadow_train_acc=shadow.attack.train_acc,
        n_shadows=shadow.attack.n_shadows, total_s=total_s,
        launches={k: v for k, v in launches.items() if v},
        f1_checked=checked, pareto_front=rep.pareto_front(),
        note=(None if finite["RR"] else "RR's models are not finite (as "
              "the reference's RR can be): its F1 is left out of the "
              "check"))
    bad = [c.name for c in rep.candidates if c.cost_units != want[c.name]]
    if bad:
        raise AssertionError(f"table1: cost units of {bad} miss the "
                             f"formula {want}")
    bad = [n for n in checked
           if not math.isfinite(rep.candidate(n).metrics["mia_f1"])]
    if bad or not all(finite[n] for n in checked):
        raise AssertionError(f"table1: F1 not finite for {bad}, or models "
                             f"not finite: {finite}")
    missing = [k for k in ("coded_matmul", "calibrate") if launches[k] == 0]
    if missing:
        raise AssertionError(f"table1: kernels never launched: {missing}")
    return launches


def _verify_small(torch, cfg, dev, frameworks=TABLE1_FRAMEWORKS,
                  init_for_seed=None):
    """The port's suite at a small scenario on ``dev``, with the models and
    the fitted shadow attack kept."""
    from repro_torch.verify import ShadowMIAVerifier, run_verification
    shadow = ShadowMIAVerifier()
    rep = run_verification(cfg, frameworks=frameworks,
                           verifiers=(shadow, "canary", "utility"),
                           n_shadows=2, n_canaries=12, device=dev,
                           init_for_seed=init_for_seed, keep_models=True)
    return rep, shadow.attack


def _decisions(rep, attack, name):
    """The attack's decisions under candidate ``name``'s models on the
    forgotten data and the non-members, as one array."""
    import numpy as np
    suite = rep.suite
    return np.concatenate([
        attack.member_flags(suite.iface, rep.models[name], *data)
        for data in (suite.forgotten_data, suite.nonmember_data)])


def check_table1_small(torch, K):
    """Phase 4b: the port's verification suite at tests/test_verify.py's
    scenario (``VERIFY_SMALL``, G 6) and at the same scenario cut to G 3,
    with SE, FE, FR and RR, on the card and on the CPU (the kernels' plain
    versions): cost units equal; each candidate's models within rtol 1e-3 /
    atol 1e-4 or within twice the spread one-ulp-moved initial weights open
    on the CPU; the attack's decisions on the forgotten data and the
    non-members differing in at most 2 % of them, or in at most twice as
    many as differ between the two CPU runs one ulp apart.  At G 6 the stage
    is chaotic in fp32 (a 1e-6 change of a round's model grows past 1e-3 in
    one round, and the one-ulp spread is the card's gap's size), so G 3 is
    held too, where it is not.  Then two card runs are compared
    (``check_card_repeat``)."""
    from repro_torch.core.tree import leaves_with_paths, tree_leaves
    from repro_torch.fl.experiment import ScenarioConfig
    from repro_torch.fl.families import get_model_family

    def gap(a, b):
        """Max |a - b| over the entries finite in both; inf where the two
        disagree on which entries are finite (RR may diverge)."""
        out = 0.0
        for s in b:
            for x, y in zip(tree_leaves(a[s]), tree_leaves(b[s])):
                x, y = x.cpu(), y.cpu()
                fin = torch.isfinite(x)
                if not torch.equal(fin, torch.isfinite(y)):
                    return float("inf")
                if bool(fin.any()):
                    out = max(out, float((x[fin] - y[fin]).abs().max()))
        return out

    for label, rounds in (("verify_cfg", 6), ("verify_g3", 3)):
        cfg = ScenarioConfig(**dict(VERIFY_SMALL, global_rounds=rounds))
        model_cfg = get_model_family(cfg.model).build(cfg)
        K.reset_launches()
        t0 = time.perf_counter()
        card, card_attack = _verify_small(torch, cfg, "cuda")
        card_s = time.perf_counter() - t0
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        t0 = time.perf_counter()
        cpu, cpu_attack = _verify_small(torch, cfg, "cpu")
        cpu_s = time.perf_counter() - t0
        moved, moved_attack = _verify_small(
            torch, cfg, "cpu", init_for_seed=lambda seed: _ulp_perturbed(
                torch, model_cfg, seed))
        if not (launches.get("coded_matmul") and launches.get("calibrate")):
            raise AssertionError(f"table1_small {label}: the coding kernels "
                                 f"not launched on the card: {launches}")
        rows, n_diff, n_ulp, n_all = {}, 0, 0, 0
        for c in cpu.candidates:
            g = card.candidate(c.name)
            if g.cost_units != c.cost_units:
                raise AssertionError(f"table1_small {label} {c.name}: cost "
                                     f"units {g.cost_units} on the card, "
                                     f"{c.cost_units} on the CPU")
            worst = gap(card.models[c.name], cpu.models[c.name])
            spread = gap(moved.models[c.name], cpu.models[c.name])
            close = all(torch.allclose(x.cpu(), y, rtol=1e-3, atol=1e-4,
                                       equal_nan=True)
                        for s in cpu.models[c.name] for (_, x), y in zip(
                            leaves_with_paths(card.models[c.name][s]),
                            tree_leaves(cpu.models[c.name][s])))
            dc = _decisions(cpu, cpu_attack, c.name)
            differ = int((_decisions(card, card_attack, c.name) != dc).sum())
            n_diff += differ
            n_ulp += int((_decisions(moved, moved_attack, c.name)
                          != dc).sum())
            n_all += len(dc)
            rows[c.name] = {
                "max_abs_diff_vs_cpu": worst, "cpu_one_ulp_spread": spread,
                "within": ("rtol 1e-3, atol 1e-4" if close
                           else "2 x one-ulp spread" if worst <= 2 * spread
                           else "neither"),
                "decisions_differing": differ,
                "mia_f1": [g.metrics["mia_f1"], c.metrics["mia_f1"]],
                "canary_acc": [g.metrics["canary_acc"],
                               c.metrics["canary_acc"]],
                "cost_units": c.cost_units}
        log("table1_small", scenario=label, global_rounds=rounds,
            launches=launches, card_s=card_s, cpu_s=cpu_s,
            shadow_train_acc=[card_attack.train_acc, cpu_attack.train_acc],
            decisions_differing=n_diff, decisions=n_all,
            decisions_differing_one_ulp_cpu=n_ulp, candidates=rows)
        far = [n for n, r in rows.items() if r["within"] == "neither"]
        if far:
            raise AssertionError(f"table1_small {label}: models of {far} "
                                 f"beyond both tolerances: {rows}")
        if n_diff > max(0.02 * n_all, 2 * n_ulp):
            raise AssertionError(f"table1_small {label}: {n_diff} of "
                                 f"{n_all} attack decisions differ (one-ulp "
                                 f"CPU runs: {n_ulp})")
        if label == "verify_cfg":
            check_card_repeat(torch, cfg, card)


def check_card_repeat(torch, cfg, card):
    """Two card runs of the suite give the same metrics, bit for bit:
    ``card`` (every framework) against a run with SE only, on the
    candidates both scored; any difference fails the phase.  The reference
    is bit-reproducible under a fixed seed, and ``resolve_device`` sets
    ``torch.backends.cudnn.deterministic`` so the port is too (ROADMAP
    queue 3 item 10: cuDNN's nondeterministic convolution algorithms made
    two runs differ).  Then what the flag costs: the SE-only run's wall and
    device-busy time as set, and once more with the flag off."""
    def apart(a, b):
        a, b = a.metrics_dict(), b.metrics_dict()
        return {n: {k: abs(a[n][k] - v) for k, v in b[n].items()
                    if a[n][k] != v} for n in b}

    def se_run():
        out = _verify_small(torch, cfg, "cuda", frameworks=("SE",))[0]
        torch.cuda.synchronize()
        return out
    t0 = time.perf_counter()
    second = se_run()
    walls = {"deterministic": time.perf_counter() - t0}
    gaps = apart(card, second)
    traces = {"deterministic": device_busy(se_run)}
    torch.backends.cudnn.deterministic = False
    try:
        t0 = time.perf_counter()
        loose = se_run()
        walls["not_deterministic"] = time.perf_counter() - t0
        traces["not_deterministic"] = device_busy(se_run)
    finally:
        torch.backends.cudnn.deterministic = True
    busy = {k: {"busy_ms": d["busy_ms"], "kernel_sum_ms": d["sum_ms"],
                "stream_overlap_ms": d["stream_overlap_ms"]}
            for k, d in traces.items()}
    same = not any(gaps.values())
    log("table1_small", what="two card runs, the second with SE only",
        same_metrics=same, apart=gaps,
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        flag_cost={"what": "one table1_small run with SE only (victim and "
                           "two shadow stages, SE, the verifiers)",
                   "wall_s": walls, "device_busy_ms": busy,
                   "flag_off_same_metrics": not any(
                       apart(second, loose).values())})
    if not same:
        raise AssertionError(f"table1_small: two card runs differ: {gaps}")


# each generation family's own kernels, launched in every SGD step; the
# NanoGPT family's global attention layers run the plain blockwise path, and
# the moe family's router, dispatch and experts are plain torch ops (as the
# reference's are plain jnp ops)
LM_KERNELS = {"mamba": ("ssm_scan", "ssm_scan_bwd"),
              "rwkv6": ("wkv", "wkv_bwd"),
              "nanogpt": (),
              "moe": ()}


def check_engine_gemms(torch, sim, seq: int) -> dict:
    """ROADMAP queue 3, item 2: the fused engine trains a shard's M models
    as one stack (attention's batch M*bs = 50 on the NanoGPT path), the
    stage engine all S*M (200).  Each op of one SGD step runs on the stage
    engine's stack and on its first M models, and the M models' rows are
    compared bit for bit: the first op listed whose rows differ is where
    the engines part.  Inputs: random activations at the path's shapes;
    for the step, the model's initial weights and 20 clients' tokens."""
    from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
    from repro_torch.models import attention as attn
    from repro_torch.models import layers, transformer
    from repro_torch.models.layers import matmul

    cfg, bs = sim.cfg, sim.local_batch
    m = sim.fl.clients_per_shard
    km = sim.fl.num_shards * m
    d, hh, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device="cuda").manual_seed(2)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    h = randn(km, bs, seq, d)
    p = {"wq": randn(km, d, hh, hd) * d ** -0.5,
         "wk": randn(km, d, kv, hd) * d ** -0.5,
         "wv": randn(km, d, kv, hd) * d ** -0.5,
         "wo": randn(km, hh, hd, d) * (hh * hd) ** -0.5}
    q, k, v = (randn(km * bs, seq, n, hd) for n in (hh, kv, kv))
    probs = torch.softmax(randn(km * bs, kv, hh // kv, seq, seq), -1)
    clients = sorted(sim.client_data)[:km]
    xs, ys = sim._stack_client_data(clients)
    w0 = tree_map(lambda t: t.unsqueeze(0).expand(km, *t.shape).contiguous(),
                  sim.init_model(0))

    def loss(n):
        batch = sim.task_spec.make_batch(xs[:n, :bs], ys[:n, :bs])
        return sim._loss(sliced(w0, n), batch)

    def grads(n):
        return tree_leaves(sim._grads(sliced(w0, n), xs[:n, :bs],
                                      ys[:n, :bs]))
    ffn = {"wi_gate": randn(km, d, cfg.d_ff) * d ** -0.5,
           "wi_up": randn(km, d, cfg.d_ff) * d ** -0.5,
           "wo": randn(km, cfg.d_ff, d) * cfg.d_ff ** -0.5}
    scale = {"scale": 1.0 + 0.1 * randn(km, d)}

    def sliced(tree, n):
        return tree_map(lambda t: t[:n], tree)
    ops = {
        "embedding (F.embedding)": lambda n: layers.apply_embed(
            sliced(w0["embed"], n), xs[:n, :bs], cfg),
        "norm (apply_norm)": lambda n: layers.apply_norm(
            sliced(scale, n), h[:n], cfg),
        "q projection (bmm)": lambda n: matmul(
            h[:n], p["wq"][:n].reshape(n, d, hh * hd)),
        "scores q.k (einsum)": lambda n: torch.einsum(
            "bqkgd,bskd->bkgqs",
            q[:n * bs].reshape(n * bs, seq, kv, hh // kv, hd), k[:n * bs]),
        "probs @ v (einsum)": lambda n: torch.einsum(
            "bkgqs,bskd->bkgqd", probs[:n * bs], v[:n * bs]),
        "blockwise_attention": lambda n: attn.blockwise_attention(
            q[:n * bs], k[:n * bs], v[:n * bs], causal=True,
            block_q=cfg.attn_block_q or seq),
        "attention block (projections, RoPE, attention, wo)": lambda n:
            attn.attention_block({a: b[:n] for a, b in p.items()}, h[:n],
                                 cfg),
        "gated MLP (apply_mlp: three bmm)": lambda n: layers.apply_mlp(
            sliced(ffn, n), h[:n], cfg),
        "unembedding (apply_unembed)": lambda n: layers.apply_unembed(
            sliced(w0["embed"], n), h[:n], cfg),
        "logits (forward_train)": lambda n: transformer.forward_train(
            sliced(w0, n), cfg, sim.task_spec.make_batch(
                xs[:n, :bs], ys[:n, :bs]))[0],
        "the models' losses (forward)": loss,
    }
    names = ["/".join(path) for path, _ in leaves_with_paths(w0)]
    out = {}
    with torch.no_grad():
        for name, fn in ops.items():
            small, big = fn(m), fn(km)
            rows = big[:small.shape[0]]
            out[name] = {"bit_equal": torch.equal(small, rows),
                         "max_abs_diff": float((small - rows).abs().max())}
        # the backward, leaf by leaf, and the same batch twice
        small, again, big = grads(m), grads(m), grads(km)
        for nm, a, b, c in zip(names, small, again, big):
            out[f"gradient {nm}"] = {
                "bit_equal": torch.equal(a, c[:m]),
                "max_abs_diff": float((a - c[:m]).abs().max()),
                "repeat_bit_equal": torch.equal(a, b)}
    first = next((n for n, r in out.items() if not r["bit_equal"]), None)
    log("diagnostic", path="nanogpt", what="the stack's rows at batch "
        f"{m * bs} vs inside batch {km * bs}", ops=out,
        first_op_that_differs=first)
    return out


def lm_path(torch, K, family: str):
    """Phase 5b-5d: the generation task with ``family`` in the paper's
    federation, built by the port's own entry point, with G cut from 30 to
    ``PATHS[family]["rounds"]``; NanoGPT is the task's default family, so
    its scenario names none."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.fl.experiment import ScenarioConfig, build_simulator

    rounds = PATHS[family]["rounds"]
    named = {} if family == "nanogpt" else {"model": family}
    cfg = ScenarioConfig.paper_full(task="generation", global_rounds=rounds,
                                    **named)
    sim, test = build_simulator(cfg)
    if family == "nanogpt":
        log("config", path=family, attention="global layers only: the "
            "plain blockwise path, no window kernel (as the reference's)")
        check_engine_gemms(torch, sim, cfg.seq_len)
    log("config", path=family, model=dataclasses.asdict(sim.cfg),
        params=sum(v.numel() for v in tree_leaves(sim.init_model(0))),
        lr=sim.opt.lr, local_batch=sim.local_batch,
        sequences_per_client=int(sim.client_data[0][0].shape[0]),
        seq_len=cfg.seq_len,
        reduced={"global_rounds": f"the paper's 30 cut to {rounds} to keep "
                                  f"the script's time"})
    built = [sim]

    def make_sim():
        return built.pop() if built else build_simulator(cfg)[0]
    vocab = sim.cfg.vocab_size
    # the task's test stream draws its own word inventory (seed + 999), so
    # its perplexity measures another vocabulary of words; the check reads
    # clients of the same stream that the stage did not train on
    return main_path(torch, K, family, make_sim, test,
                     CODING + LM_KERNELS[family],
                     lambda m: m["held_out"]["ppl"] < vocab)


def full_width(torch, K):
    """Phase 6: one jamba-1.5-large mamba mixer at its published width,
    forward and backward through ``mamba_block`` at train_4k's sequence
    length, batch 2, fp32."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.ssm_scan import ops
    from repro_torch.models.mamba import d_inner, dt_rank, init_mamba
    from repro_torch.models.mamba import mamba_block
    from repro_torch.models.params import RealInit
    from repro_torch.roofline.analysis import ssm_work

    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b"),
                              param_dtype="float32", compute_dtype="float32")
    bsz, s = 2, SHAPES["train_4k"].seq_len
    t0 = time.perf_counter()
    p = init_mamba(RealInit(torch.Generator().manual_seed(0)), cfg)
    p = tree_map(lambda v: v[None].to("cuda").requires_grad_(True), p)
    n_params = sum(v.numel() for v in tree_leaves(p))
    x = torch.randn(1, bsz, s, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    x.requires_grad_(True)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        y, (_, h_last) = mamba_block(p, x, cfg)
        loss = (y * y).mean()
        grads = torch.autograd.grad(loss, [x, *tree_leaves(p)])
        return y, h_last, grads
    y, h_last, grads = step()                 # warm-up, checked below
    torch.cuda.synchronize()
    K.reset_launches()
    iters = 3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        step()
    b.record()
    b.synchronize()
    block_ms = a.elapsed_time(b) / iters
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ok = (tuple(y.shape) == (1, bsz, s, cfg.d_model)
          and tuple(h_last.shape) == (1, bsz, d_inner(cfg),
                                      cfg.ssm_state_dim)
          and bool(torch.isfinite(y).all())
          and all(bool(torch.isfinite(g).all()) for g in grads))
    if not ok or launches["ssm_scan"] != iters or \
            launches["ssm_scan_bwd"] != iters:
        raise AssertionError(f"full-width mixer: shapes/finite {ok}, "
                             f"launches {launches}")
    del y, h_last, grads
    # the scan alone at the mixer's shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    n, di = cfg.ssm_state_dim, d_inner(cfg)
    args = ssm_inputs(torch, gen, bsz, s, di, n, 1)
    with torch.no_grad():
        fwd = timed(lambda: ops.ssm_scan(*args), 5, batch=True)
    g = ops._check(*args)
    _, _, ckpt = ops._fwd(*args, g, keep=True)
    gy = torch.randn(bsz, s, di, generator=gen, device="cuda")
    ghl = torch.randn(bsz, di, n, generator=gen, device="cuda")
    bwd = timed(lambda: ops._bwd(*args[:5], ckpt, gy, ghl, g), 5,
                batch=True)
    fb = bound(*ssm_work(bsz, s, di, n, 1, backward=False))
    bb = bound(*ssm_work(bsz, s, di, n, 1, backward=True))
    log("full", model="jamba-1.5-large-398b mamba mixer",
        d_model=cfg.d_model, d_inner=di, state=n, conv=cfg.ssm_conv_width,
        dt_rank=dt_rank(cfg), params=n_params, input=[bsz, s, cfg.d_model],
        reduced={"depth": "one mamba mixer of 72 layers (attention, MoE and "
                          "dense FFN layers left out)",
                 "batch": "train_4k's 256 cut to 2"},
        init_s=init_s, block_fwd_bwd_ms=block_ms, launches=launches,
        peak_mem_bytes=peak,
        ssm_scan=dict(fwd, bound_ms=fb[0], bound_by=fb[1]),
        ssm_scan_bwd=dict(bwd, bound_ms=bb[0], bound_by=bb[1]))
    del p, x, args, ckpt, gy, ghl
    torch.cuda.empty_cache()
    return launches


def full_width_rwkv(torch, K):
    """Phase 6b: one rwkv6-3b layer at its published width (ln1, time-mix,
    ln2, channel-mix), forward and backward through ``apply_block_train``
    at train_4k's sequence length, batch 8, fp32."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.wkv import ops
    from repro_torch.models.layers import init_norm
    from repro_torch.models.params import RealInit
    from repro_torch.models.rwkv6 import init_rwkv, rwkv_heads
    from repro_torch.models.transformer import apply_block_train
    from repro_torch.roofline.analysis import wkv_work

    cfg = dataclasses.replace(get_config("rwkv6-3b"), param_dtype="float32",
                              compute_dtype="float32")
    bsz, s = 8, SHAPES["train_4k"].seq_len
    hh, n = rwkv_heads(cfg)
    t0 = time.perf_counter()
    fac = RealInit(torch.Generator().manual_seed(0))
    p = {"ln1": init_norm(fac, cfg), "ln2": init_norm(fac, cfg),
         "rwkv": init_rwkv(fac, cfg)}
    p = tree_map(lambda v: v[None].to("cuda").requires_grad_(True), p)
    n_params = sum(v.numel() for v in tree_leaves(p))
    x = torch.randn(1, bsz, s, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    x.requires_grad_(True)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        y, _aux, _ = apply_block_train(p, x, cfg, "rwkv", 0)
        loss = (y * y).mean()
        grads = torch.autograd.grad(loss, [x, *tree_leaves(p)])
        return y, grads
    y, grads = step()                         # warm-up, checked below
    torch.cuda.synchronize()
    K.reset_launches()
    iters = 3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        step()
    b.record()
    b.synchronize()
    block_ms = a.elapsed_time(b) / iters
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ok = (n_params == 85_557_760
          and tuple(y.shape) == (1, bsz, s, cfg.d_model)
          and bool(torch.isfinite(y).all())
          and all(tuple(g.shape) == tuple(v.shape) and
                  bool(torch.isfinite(g).all())
                  for g, v in zip(grads, [x, *tree_leaves(p)])))
    if not ok or launches["wkv"] != iters or launches["wkv_bwd"] != iters:
        raise AssertionError(f"full-width rwkv layer: params {n_params}, "
                             f"shapes/finite {ok}, launches {launches}")
    del y, grads
    # the recurrence alone at the layer's shape
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = wkv_inputs(torch, gen, bsz, s, hh, n, 1)
    with torch.no_grad():
        fwd = timed(lambda: ops.wkv(*args), 5, batch=True)
    g = ops._check(*args)
    _, _, ckpt = ops._fwd(*args, g, keep=True)
    gy = torch.randn(bsz, s, hh, n, generator=gen, device="cuda")
    ghl = torch.randn(bsz, hh, n, n, generator=gen, device="cuda")
    bwd = timed(lambda: ops._bwd(*args[:5], ckpt, gy, ghl, g), 5,
                batch=True)
    fb = bound(*wkv_work(bsz, s, hh, n, 1, backward=False))
    bb = bound(*wkv_work(bsz, s, hh, n, 1, backward=True))
    log("full", model="rwkv6-3b rwkv layer", d_model=cfg.d_model, heads=hh,
        head_dim=n, d_ff=cfg.d_ff, params=n_params,
        input=[bsz, s, cfg.d_model],
        reduced={"depth": "one rwkv layer of 32 (embedding and unembedding "
                          "left out)",
                 "batch": "train_4k's 256 cut to 8"},
        init_s=init_s, block_fwd_bwd_ms=block_ms, launches=launches,
        peak_mem_bytes=peak, ckpt_bytes=ckpt.numel() * 4,
        wkv=dict(fwd, bound_ms=fb[0], bound_by=fb[1]),
        wkv_bwd=dict(bwd, bound_ms=bb[0], bound_by=bb[1]))
    del p, x, args, ckpt, gy, ghl
    torch.cuda.empty_cache()
    return launches


def full_width_gemma(torch, K):
    """Phase 6c: one gemma3-27b local (sliding-window) layer at its
    published width, forward and backward through ``apply_block_train`` at
    train_4k's sequence length, batch 2, fp32; its launch counts zeroed
    before and read after."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.kernels.window_attn import ops
    from repro_torch.models.attention import init_attention
    from repro_torch.models.layers import init_mlp, init_norm
    from repro_torch.models.params import RealInit
    from repro_torch.models.transformer import apply_block_train
    from repro_torch.roofline.analysis import window_work

    cfg = dataclasses.replace(get_config("gemma3-27b"), param_dtype="float32",
                              compute_dtype="float32")
    bsz, s = 2, SHAPES["train_4k"].seq_len
    h, kv, hd, window = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         cfg.sliding_window)
    t0 = time.perf_counter()
    fac = RealInit(torch.Generator().manual_seed(0))
    p = {"ln1": init_norm(fac, cfg), "attn": init_attention(fac, cfg),
         "ln2": init_norm(fac, cfg), "ffn": init_mlp(fac, cfg)}
    p = tree_map(lambda v: v[None].to("cuda").requires_grad_(True), p)
    n_params = sum(v.numel() for v in tree_leaves(p))
    x = torch.randn(1, bsz, s, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    x.requires_grad_(True)
    init_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def step():
        y, _aux, _ = apply_block_train(p, x, cfg, "local", 0)
        loss = (y * y).mean()
        grads = torch.autograd.grad(loss, [x, *tree_leaves(p)])
        return y, grads
    y, grads = step()                         # warm-up, checked below
    torch.cuda.synchronize()
    K.reset_launches()
    iters = 3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        step()
    b.record()
    b.synchronize()
    block_ms = a.elapsed_time(b) / iters
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ok = (n_params == 412_887_552
          and tuple(y.shape) == (1, bsz, s, cfg.d_model)
          and bool(torch.isfinite(y).all())
          and all(tuple(g.shape) == tuple(v.shape) and
                  bool(torch.isfinite(g).all())
                  for g, v in zip(grads, [x, *tree_leaves(p)])))
    if not ok or launches["window_attention"] != iters or \
            launches["window_attention_bwd"] != iters:
        raise AssertionError(f"full-width gemma3 layer: params {n_params}, "
                             f"shapes/finite {ok}, launches {launches}")
    del y, grads
    # the window kernels alone at the layer's shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn(bsz, s, n, hd, generator=gen, device="cuda")
               for n in (h, kv, kv))
    with torch.no_grad():
        fwd = timed(lambda: ops._fwd(q, k, v, window), 5, batch=True)
    o, lse = ops._fwd(q, k, v, window)
    do = torch.randn(bsz, s, h, hd, generator=gen, device="cuda")
    bwd = timed(lambda: ops._bwd(q, k, v, o, lse, do, window), 5,
                batch=True)
    fb = bound(*window_work(bsz, s, h, kv, hd, window, False),
               flops_per_s=TF32X3_FLOPS_PER_S)
    bb = bound(*window_work(bsz, s, h, kv, hd, window, True),
               flops_per_s=TF32X3_FLOPS_PER_S)
    log("full", model="gemma3-27b local attention layer",
        d_model=cfg.d_model, heads=h, kv_heads=kv, head_dim=hd,
        window=window, d_ff=cfg.d_ff, params=n_params,
        input=[bsz, s, cfg.d_model],
        reduced={"depth": "one local layer of 62 (embedding, unembedding "
                          "and the global layers left out)",
                 "batch": "train_4k's 256 cut to 2"},
        init_s=init_s, block_fwd_bwd_ms=block_ms, launches=launches,
        peak_mem_bytes=peak,
        window_kernels_share=(fwd["ms"] + bwd["ms"]) / block_ms,
        window_attention=dict(fwd, bound_ms=fb[0], bound_by=fb[1]),
        window_attention_bwd=dict(bwd, bound_ms=bb[0], bound_by=bb[1]))
    del p, x, q, k, v, o, lse, do
    torch.cuda.empty_cache()
    return launches


def full_width_granite(torch, K):
    """Phase 6d: one granite-moe-3b-a800m layer at its published width (ln1,
    global attention, ln2, MoE FFN of 40 experts, top-8), forward and
    backward through ``apply_block_train`` at train_4k's sequence length,
    batch 2, fp32, with each dispatch form (``moe_impl`` "einsum", then
    "gather"): each form's ms (the layer's, and the MoE FFN's alone), peak
    memory (and its rise over what was allocated before the step) and the
    share of (token, choice) pairs dropped past the experts' capacity; the
    gather form's output and
    gradients held to the einsum form's within 1e-4 of each one's largest
    entry (the window backward's tolerance: sums in another order; the
    gather form's backward adds by ``scatter_add``)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.tree import leaves_with_paths, tree_leaves, tree_map
    from repro_torch.models.attention import init_attention
    from repro_torch.models.layers import init_norm
    from repro_torch.models.moe import apply_moe, init_moe
    from repro_torch.models.params import RealInit
    from repro_torch.models.transformer import apply_block_train

    base = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                               param_dtype="float32", compute_dtype="float32")
    bsz, s = 2, SHAPES["train_4k"].seq_len
    t0 = time.perf_counter()
    fac = RealInit(torch.Generator().manual_seed(0))
    p = {"ln1": init_norm(fac, base), "attn": init_attention(fac, base),
         "ln2": init_norm(fac, base), "ffn": init_moe(fac, base)}
    p = tree_map(lambda v: v[None].to("cuda").requires_grad_(True), p)
    n_params = sum(v.numel() for v in tree_leaves(p))
    # one layer's share of the analytic count: less the tied embedding and
    # the final norm
    per_layer = (base.param_count() - base.vocab_size * base.d_model
                 - base.d_model) // base.num_layers
    x = torch.randn(1, bsz, s, base.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(2))
    x.requires_grad_(True)
    init_s = time.perf_counter() - t0
    leaves = [x, *tree_leaves(p)]
    # the MoE FFN alone, on the layer's ln2 input
    h = torch.randn(1, bsz, s, base.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3),
                    requires_grad=True)
    ffn_leaves = [h, *tree_leaves(p["ffn"])]
    out, rows = {}, {}
    for impl in ("einsum", "gather"):
        cfg = dataclasses.replace(base, moe_impl=impl)

        def step():
            y, aux, _ = apply_block_train(p, x, cfg, "global", 0)
            loss = (y * y).mean() + aux.sum()
            return y, aux, torch.autograd.grad(loss, leaves)

        def ffn_step():
            y, aux = apply_moe(p["ffn"], h, cfg)
            return torch.autograd.grad((y * y).mean() + aux.sum(),
                                       ffn_leaves)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        with routing_log() as routes:
            y, aux, grads = step()            # warm-up, checked below
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        K.reset_launches()
        layer_ms = batch_ms(step, 3)
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        (idx, keep), = routes
        # on the host, so that the next form's peak holds none of this one's
        out[impl] = (y.detach().cpu(), [g.detach().cpu() for g in grads],
                     idx)
        rows[impl] = {"fwd_bwd_ms": layer_ms,
                      "moe_ffn_fwd_bwd_ms": batch_ms(ffn_step, 3),
                      "peak_mem_bytes": peak,
                      "peak_over_start_bytes": peak - start,
                      "dropped_share": 1.0 - float(keep.float().mean()),
                      "aux": float(aux.detach()), "launches": launches}
        del y, aux, grads
    (ye, ge, ie), (yg, gg, ig) = out["einsum"], out["gather"]
    names = ["x"] + ["/".join(path) for path, _ in leaves_with_paths(p)]
    worst = {}
    for nm, g, r in zip(["y"] + names, [yg] + gg, [ye] + ge):
        rmax = float(r.abs().max())
        err = float((g - r).abs().max())
        worst[nm] = err / max(rmax, 1e-30)
        if not (err <= 1e-4 * rmax and bool(torch.isfinite(g).all())):
            raise AssertionError(f"granite layer: the gather form's {nm} "
                                 f"is {err} from the einsum form's (max "
                                 f"{rmax})")
    g, k, e = 512, base.experts_per_token, base.num_experts
    cap = max(int(g * k / e * base.moe_capacity_factor), 4)
    if not (torch.equal(ie, ig) and n_params == per_layer
            and tuple(ye.shape) == (1, bsz, s, base.d_model)):
        raise AssertionError(f"granite layer: routing equal "
                             f"{torch.equal(ie, ig)}, params {n_params} vs "
                             f"{per_layer}, shape {tuple(ye.shape)}")
    log("full", model="granite-moe-3b-a800m layer (global attention + MoE "
        "FFN)", d_model=base.d_model, heads=base.num_heads,
        kv_heads=base.num_kv_heads, head_dim=base.head_dim,
        experts=e, top_k=k, moe_d_ff=base.moe_d_ff,
        capacity_factor=base.moe_capacity_factor, group=g,
        groups=bsz * s // g, capacity=cap, params=n_params,
        input=[bsz, s, base.d_model],
        reduced={"depth": "one layer of 32 (embedding and unembedding left "
                          "out)",
                 "batch": "train_4k's 256 cut to 2"},
        init_s=init_s, forms=rows,
        gather_vs_einsum_max_err_of_max=max(worst.values()),
        tol="1e-4 of each tensor's largest entry")
    del p, x, h, out, ye, ge, yg, gg
    torch.cuda.empty_cache()
    return rows


# phase 7: (arch, changes to the published config, batch, prompt, decode
# steps, what was cut); every case runs in fp32
SERVE_CASES = (
    ("gemma3-27b", dict(num_layers=6), 4, 1536, 32,
     "depth 62 -> 6 (one 5:1 superblock of local and global layers)"),
    ("rwkv6-3b", dict(num_layers=4), 4, 512, 32, "depth 32 -> 4"),
    ("jamba-1.5-large-398b", dict(num_layers=2,
                                  layer_pattern=("global", "mamba"),
                                  num_experts=0, experts_per_token=0),
     4, 512, 32, "depth 72 -> 2 (global, mamba); experts off: the dense FFN "
     "at d_ff 24576 (16 experts of one MoE layer are 9.7 B parameters)"),
    ("granite-moe-3b-a800m", dict(num_layers=2), 4, 512, 32,
     "depth 32 -> 2"),
    ("whisper-tiny", {}, 4, 4, 60, "none (4 encoder and 4 decoder layers)"),
    ("internvl2-2b", {}, 4, 64, 32, "none (24 layers)"))
SERVE_KERNELS = ("window_attention", "wkv", "ssm_scan")
SERVE_TOL = 5e-3       # tests/test_arch_smoke.py's decode-vs-forward
# and the bound near the spread measured at the serve widths (worst 1.97e-4,
# rwkv6-3b, H100 80GB HBM3 at 700 W), which a cache or ring fault that
# shifts logits by a few 1e-3 breaks where the reference's bound does not
SERVE_SPREAD_TOL = 1e-3
# the archs that also serve at their published numerics (bf16 params and
# compute), fed the fp32 run's tokens (jamba's mamba layer hands ssm_scan
# bf16 dt, b, c, x: ``ssm_scan_bf16``).  Each is held against the port's
# CPU path at bf16 on the same weights and fed tokens, at an input the CPU
# affords (SERVE_BF16_HELD: the first rows, prompt and steps of the case),
# as tests/test_torch_bf16.py holds the port against the reference: each
# token's logits row (prefill's last, each step's) within twice its
# one-ulp spread, the largest L2 distance of the card's row over draws
# (SERVE_BF16_DRAWS) of every nonzero bf16 weight moved one ulp up or down.
SERVE_BF16 = ("gemma3-27b", "rwkv6-3b", "jamba-1.5-large-398b")
SERVE_BF16_HELD = dict(rows=2, prompt=32, steps=4)
SERVE_BF16_DRAWS = (9, 10, 11)


def serve_inputs(torch, cfg, bsz: int, prompt: int, seed: int,
                 frames: int = None):
    """A serve batch drawn on the CPU from ``seed`` (so the card and the
    CPU get the same one): tokens (bsz, prompt), plus vlm patches or audio
    frames (``frames`` of them, by default whisper's window,
    ``launch.inputs.AUDIO_ENC_FRAMES``)."""
    from repro_torch.launch.inputs import AUDIO_ENC_FRAMES
    frames = frames or AUDIO_ENC_FRAMES
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (bsz, prompt),
                                     generator=gen, dtype=torch.int32)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(bsz, cfg.vision_tokens, cfg.d_model,
                                       generator=gen)
    if cfg.family == "audio":
        batch["frames"] = torch.randn(bsz, frames, cfg.d_model,
                                      generator=gen)
    return batch


def serve_run(torch, cfg, params, batch, steps: int, feed=None) -> dict:
    """Prefill, then ``steps`` decode steps through ``make_prefill_step`` /
    ``make_decode_step``: greedy (each step fed the argmax of the last
    logits, on the device) unless ``feed`` (B, steps) gives the tokens.
    Returns the logits (steps + 1, B, V), prefill's last then each
    step's; the tokens fed (B, steps); prefill ms (host clock to a sync);
    each step's ms (CUDA events; the loop never waits for the card, so a
    step's time is its host's or its device's, the longer); the decode
    wall; the last cache and the decode step."""
    from repro_torch.launch.serve import make_decode_step, make_prefill_step
    cuda = batch["tokens"].is_cuda
    n_prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    prefill = make_prefill_step(
        cfg, max_len=n_prefix + batch["tokens"].shape[1] + steps)
    decode = make_decode_step(cfg)

    def sync():
        if cuda:
            torch.cuda.synchronize()
    sync()
    t0 = time.perf_counter()
    logits, cache = prefill(params, batch)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    out, fed = [logits[:, -1]], []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)] \
        if cuda else []
    t1 = time.perf_counter()
    if cuda:
        ev[0].record()
    for i in range(steps):
        tok = (feed[:, i:i + 1] if feed is not None
               else out[-1].argmax(-1, keepdim=True).to(torch.int32))
        fed.append(tok)
        logits, cache = decode(params, tok, cache)
        out.append(logits[:, -1])
        if cuda:
            ev[i + 1].record()
    sync()
    wall = time.perf_counter() - t1
    return {"logits": torch.stack(out), "fed": torch.cat(fed, 1),
            "prefill_ms": prefill_ms, "decode_wall_s": wall,
            "step_ms": [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]
            if cuda else [], "cache": cache, "decode": decode}


def serve_vs_forward(torch, cfg, params, batch, run) -> float:
    """Each decode step's logits (and prefill's last) against
    ``forward_train`` on the prompt and the tokens decode was fed, at
    their positions, a batch row at a time (gemma3's full logits would
    take 6.6 GB): |d| <= SERVE_TOL (1 + |r|), the reference's bound, and
    |d| <= SERVE_SPREAD_TOL (1 + |r|), near the measured spread.  Returns
    the max abs error."""
    from repro_torch.models import predict_fn
    prompt = batch["tokens"].shape[1]
    toks = torch.cat([batch["tokens"], run["fed"]], 1)
    predict, worst = predict_fn(cfg), 0.0
    for b in range(toks.shape[0]):
        row = {k: v[b:b + 1] for k, v in batch.items()}
        row["tokens"] = toks[b:b + 1]
        with torch.no_grad():
            want = predict(params, row)[0, prompt - 1:]     # (steps+1, V)
        diff = (run["logits"][:, b] - want).abs()
        worst = max(worst, float(diff.max()))
        for tol in (SERVE_TOL, SERVE_SPREAD_TOL):
            if not bool((diff <= tol * (1 + want.abs())).all()):
                raise AssertionError(
                    f"serve {cfg.name}: decode row {b} is "
                    f"{float(diff.max())} from the forward, past "
                    f"{tol} (1 + |r|)")
        del want, diff
    return worst


def serve_card_vs_cpu(torch) -> dict:
    """Every ``reduce_for_smoke`` config of ``ASSIGNED_ARCHS`` and a gemma3
    with window 16 < prompt 40, on the card and on the CPU with the same
    weights, batch and fed tokens (2 rows, prompt 24, 4 steps): logits
    within 1e-4 + 1e-4|r|.  Returns each config's max abs difference."""
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    from repro_torch.configs import reduce_for_smoke
    from repro_torch.core.tree import tree_map
    from repro_torch.models import init_params
    cases = [(a, {}, 24) for a in ASSIGNED_ARCHS] + \
        [("gemma3-27b", {"sliding_window": 16}, 40)]
    out = {}
    for arch, changes, prompt in cases:
        cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)),
                                  **changes)
        cpu_params = init_params(cfg, 0, device="cpu")
        batch = serve_inputs(torch, cfg, 2, prompt, 3, frames=20)
        feed = torch.randint(0, cfg.vocab_size, (2, 4), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(4))
        want = serve_run(torch, cfg, cpu_params, batch, 4, feed)["logits"]
        got = serve_run(torch, cfg, tree_map(lambda v: v.cuda(), cpu_params),
                        {k: v.cuda() for k, v in batch.items()}, 4,
                        feed.cuda())["logits"].cpu()
        diff = (got - want).abs()
        name = arch + ("-window16" if changes else "")
        out[name] = float(diff.max())
        if not bool((diff <= 1e-4 + 1e-4 * want.abs()).all()):
            raise AssertionError(f"serve {name}: card {out[name]} from the "
                                 f"CPU")
    return out


def serve_path(torch, K):
    """Phase 7: the serving path's six cases at published widths (see the
    module docstring), each with its launches counted, the checks after
    the counted serve; then the reduced configs on the card and the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import init_params
    t_phase = time.perf_counter()
    total = {k: 0 for k in K.LAUNCHES}
    total16 = dict(total)
    for arch, changes, bsz, prompt, steps, cut in SERVE_CASES:
        cfg = dataclasses.replace(get_config(arch), param_dtype="float32",
                                  compute_dtype="float32", **changes)
        base = torch.cuda.memory_allocated()    # what earlier phases hold
        t0 = time.perf_counter()
        params = init_params(cfg, 0, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = sum(v.numel() for v in tree_leaves(params))
        batch = {k: v.cuda() for k, v in
                 serve_inputs(torch, cfg, bsz, prompt, 1).items()}
        serve_run(torch, cfg, params, batch, 2)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        run = serve_run(torch, cfg, params, batch, steps)
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] += v
        if not bool(torch.isfinite(run["logits"]).all()):
            raise AssertionError(f"serve {arch}: logits not finite")
        check_cfg = (dataclasses.replace(cfg, moe_capacity_factor=16.0)
                     if cfg.num_experts else cfg)
        check = run if check_cfg is cfg else serve_run(
            torch, check_cfg, params, batch, steps)
        err = serve_vs_forward(torch, check_cfg, params, batch, check)
        step_ms = statistics.median(run["step_ms"])
        row = dict(case=arch, params=n_params, param_count=cfg.param_count(),
                   batch=bsz, prompt=prompt, decode_steps=steps,
                   reduced={"depth": cut}, init_s=init_s,
                   prefill_ms=run["prefill_ms"], decode_ms_per_token=step_ms,
                   decode_ms_min=min(run["step_ms"]),
                   decode_ms_max=max(run["step_ms"]),
                   decode_wall_s=run["decode_wall_s"],
                   tokens_per_s=bsz * steps / run["decode_wall_s"],
                   prefill_tokens_per_s=bsz * prompt / run["prefill_ms"] * 1e3,
                   peak_mem_bytes=peak, case_peak_bytes=peak - base,
                   launches={k: v for k, v in launches.items() if v},
                   decode_vs_forward_max_abs=err,
                   decode_vs_forward_tol=f"{SERVE_TOL} (1 + |r|) and "
                   f"{SERVE_SPREAD_TOL} (1 + |r|)" +
                   (", capacity unbound" if check_cfg is not cfg else ""))
        if cfg.family == "audio":
            row["encoder_frames"] = batch["frames"].shape[1]
        if cfg.family == "vlm":
            row["patch_tokens"] = cfg.vision_tokens
        if arch == "gemma3-27b":
            row.update(gemma3_extras(torch, K, cfg, params, batch, run))
        if arch in SERVE_BF16:
            row["bf16"], bf16_launches = serve_bf16(torch, K, cfg, params,
                                                    batch, run)
            for k, v in bf16_launches.items():
                total16[k] += v
        log("serve", **row)
        del params, batch, run, check
        torch.cuda.empty_cache()
    missing = [k for k in SERVE_KERNELS if not total[k]] + \
        [k for k in ("ssm_scan_bf16",) if not total16[k]]
    if missing:
        raise AssertionError(f"serve: {missing} never launched ({total}, "
                             f"bf16 {total16})")
    log("serve_card_vs_cpu", max_abs=serve_card_vs_cpu(torch),
        tol="1e-4 + 1e-4*|ref|")
    log("serve_phase", seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v},
        bf16_launches={k: v for k, v in total16.items() if v})
    return total, total16


def serve_bf16(torch, K, cfg, params, batch, run):
    """The case at its published numerics: the fp32 weights cast to bf16,
    bf16 compute, fed the fp32 run's greedy tokens (so every step's logits
    compare), after a warm-up; its launches counted (zeroed just before,
    read just after).  Held: finite, ``serve_bf16_held`` (the card against
    the CPU at bf16, within twice the one-ulp spread), and the bf16 route
    of ssm_scan launched on a mamba layer.  Reported beside: the gap to
    the fp32 run and the share of argmax equal to its tokens, and
    ``serve_bf16_witness``.  Returns (its row, its launches)."""
    from repro_torch.core.tree import tree_map
    steps = run["fed"].shape[1]
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                                compute_dtype="bfloat16")
    p16 = tree_map(lambda v: v.to(torch.bfloat16), params)
    serve_run(torch, cfg16, p16, batch, 2, run["fed"][:, :2])   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    r16 = serve_run(torch, cfg16, p16, batch, steps, run["fed"])
    launches = dict(K.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    lg16, lg32 = r16["logits"].float(), run["logits"]
    gap = (lg16 - lg32).abs()
    # the token each step's logits pick, against the fp32 run's
    agree = float((lg16[:-1].argmax(-1).t() == run["fed"]).float().mean())
    finite = bool(torch.isfinite(lg16).all())
    row = {"prefill_ms": r16["prefill_ms"],
           "decode_ms_per_token": statistics.median(r16["step_ms"]),
           "tokens_per_s": run["fed"].numel() / r16["decode_wall_s"],
           "peak_mem_bytes": peak,
           "logits_max_abs_gap_to_fp32": float(gap.max()),
           "gap_over_1_plus_r_max": float((gap / (1 + lg32.abs())).max()),
           "prefill_logits_max_abs_gap_to_fp32": float(gap[0].max()),
           "fp32_logit_max_abs": float(lg32.abs().max()),
           "greedy_tokens_equal_share": agree,
           "launches": {k: v for k, v in launches.items() if v}}
    del r16, lg16, gap
    held = serve_bf16_held(torch, cfg16, p16, batch, run["fed"])
    del p16
    torch.cuda.empty_cache()
    row["held"] = held
    row["witness"] = serve_bf16_witness(torch, cfg, params, batch,
                                        run["fed"], held.pop("card"))
    if (not finite or not held["ok"]
            or (cfg.family == "hybrid" and not launches["ssm_scan_bf16"])):
        raise AssertionError(f"serve {cfg.name} bf16: {row}")
    return row, launches


def ulp_moved(torch, tree, seed: int):
    """A copy of a bf16 tree with every nonzero entry moved one bf16 ulp,
    up or down by a generator seeded with ``seed`` (on the tree's
    device)."""
    from repro_torch.core.tree import tree_map
    gen = None

    def moved(v):
        nonlocal gen
        if gen is None:
            gen = torch.Generator(device=v.device).manual_seed(seed)
        bits = v.view(torch.int16)
        # +1 or -1 on the bits (the magnitude's), 0 at zeros; int16 all
        # through, so that a 1.4 G-entry embedding moves in a few GB
        step = torch.randint(0, 2, v.shape, generator=gen, device=v.device,
                             dtype=torch.int16).mul_(2).sub_(1)
        step.mul_((bits & 0x7fff) != 0)
        return (bits + step).view(torch.bfloat16)
    return tree_map(moved, tree)


def _held_input(batch, fed):
    """The bf16 hold's cut of a serve case: its first rows, prompt and
    steps (``SERVE_BF16_HELD``)."""
    n, prompt, steps = (SERVE_BF16_HELD[k] for k in ("rows", "prompt",
                                                     "steps"))
    small = {k: v[:n] for k, v in batch.items()}
    small["tokens"] = small["tokens"][:, :prompt]
    return small, fed[:n, :steps]


def serve_bf16_held(torch, cfg16, p16, batch, fed) -> dict:
    """The bf16 serve's hold, on ``_held_input``: the card's logits
    against the port's CPU path (the kernels' plain versions, the CPU's
    bf16 GEMMs) on the same bf16 weights and tokens, each token's row's
    L2 distance within twice its one-ulp spread, the largest distance of
    the card's row over ``SERVE_BF16_DRAWS`` draws of the weights moved
    one ulp (``ulp_moved``).  Returns its row, "ok" and the card's logits
    (under "card")."""
    from repro_torch.core.tree import tree_map
    small, feed = _held_input(batch, fed)
    steps = feed.shape[1]

    def logits(p, b, f):
        return serve_run(torch, cfg16, p, b, steps, f)["logits"].float()
    card = logits(p16, small, feed)
    t0 = time.perf_counter()
    cpu = logits(tree_map(lambda v: v.cpu(), p16),
                 {k: v.cpu() for k, v in small.items()}, feed.cpu()).cuda()
    cpu_s = time.perf_counter() - t0
    spread = torch.zeros_like(card[..., 0])
    spread_rel = 0.0
    for seed in SERVE_BF16_DRAWS:
        moved = logits(ulp_moved(torch, p16, seed), small, feed)
        spread = torch.maximum(spread, (moved - card).norm(dim=-1))
        spread_rel = max(spread_rel, float(((moved - card).abs()
                                            / (1 + card.abs())).max()))
        del moved
    gap = (card - cpu).norm(dim=-1)
    ratio = gap / spread
    return {"input": {"rows": small["tokens"].shape[0],
                      "prompt": small["tokens"].shape[1], "steps": steps},
            "cpu_s": cpu_s, "draws": list(SERVE_BF16_DRAWS),
            "row_spread_l2": [round(float(x), 5) for x in spread.flatten()],
            "row_gap_l2": [round(float(x), 5) for x in gap.flatten()],
            "gap_over_spread_max": float(ratio.max()),
            "card_vs_cpu_gap_over_1_plus_r_max": float(
                ((card - cpu).abs() / (1 + cpu.abs())).max()),
            "spread_over_1_plus_r_max": spread_rel,
            "tol": "each row's L2 distance <= 2 x its one-ulp spread",
            "ok": bool((gap <= 2 * spread).all()), "card": card}


def serve_bf16_witness(torch, cfg, params, batch, fed, card) -> dict:
    """Where the bf16 serve's gap to fp32 comes from, on ``_held_input``
    (max |d| / (1 + |r|) against the fp32 run): the bf16 run's; the fp32
    run's on the weights rounded to bf16 (fp32 compute: the weights'
    rounding alone)."""
    from repro_torch.core.tree import tree_map
    small, feed = _held_input(batch, fed)
    steps = feed.shape[1]
    f32 = serve_run(torch, cfg, params, small, steps, feed)["logits"]
    rounded = tree_map(lambda v: v.to(torch.bfloat16).float(), params)
    rw = serve_run(torch, cfg, rounded, small, steps, feed)["logits"]
    del rounded

    def rel(a):
        return float(((a - f32).abs() / (1 + f32.abs())).max())
    return {"bf16_gap_over_1_plus_r": rel(card),
            "bf16_weights_fp32_compute_gap_over_1_plus_r": rel(rw)}


def gemma3_extras(torch, K, cfg, params, batch, run) -> dict:
    """gemma3's second fp32 serve (bit for bit the first), then one traced
    decode step's device-busy time."""
    steps = run["fed"].shape[1]
    again = serve_run(torch, cfg, params, batch, steps)
    if not (torch.equal(again["logits"], run["logits"])
            and torch.equal(again["fed"], run["fed"])):
        raise AssertionError("serve gemma3: two runs differ")
    del again
    tok = run["logits"][-1].argmax(-1, keepdim=True).to(torch.int32)
    cache, decode = run["cache"], run["decode"]
    d = device_busy(lambda: decode(params, tok, cache))
    step_ms = statistics.median(run["step_ms"])
    # the profiler slows the host: the idle share against the traced wall
    # and against the untraced median step
    traced = {"wall_ms": d["wall_s"] * 1e3, "busy_ms": d["busy_ms"],
              "sum_ms": d["sum_ms"], "records": d["records"],
              "idle_share": 1.0 - d["busy_ms"] / (d["wall_s"] * 1e3),
              "untraced_step_ms": step_ms,
              "idle_share_of_untraced_step": 1.0 - d["busy_ms"] / step_ms,
              "top": sorted(d["by_name"].items(), key=lambda kv: -kv[1])[:6]}
    return {"repeat_bit_identical": True, "traced_decode_step": traced}


# phase 8: the production training steps (``launch/train.py``) at
# rwkv6-3b's published width, fp32, depth cut; the step's shape is the
# reference's dry run's (4 clients, 1 local step), one train_4k sequence a
# client
TRAIN_ARCH = "rwkv6-3b"
TRAIN_CUT = dict(num_layers=8, param_dtype="float32", compute_dtype="float32")
# the bf16 case: TRAIN_CUT without the dtype overrides (the published bf16
# params and compute)
TRAIN_BF16_CUT = dict(num_layers=8)
TRAIN_BF16_TIMED = 2
TRAIN_CLIENTS, TRAIN_SEQ = 4, 4096
TRAIN_TIMED = 3
TRAIN_REMAT_SEQ = 2048     # remat "none" against "block": both fit here
TRAIN_KERNELS = ("wkv", "wkv_bwd")
# the reduced card-vs-CPU check: reduce_for_smoke configs, 2 clients of 2
# sequences (gemma3: 128 tokens, past its reduced window of 64)
TRAIN_SMALL = (("rwkv6-3b", 32), ("jamba-1.5-large-398b", 32),
               ("gemma3-27b", 128))
TRAIN_SMALL_KERNELS = ("wkv", "wkv_bwd", "ssm_scan", "ssm_scan_bwd",
                       "window_attention", "window_attention_bwd")
# card vs CPU: the port's own fp32 rounding in another order (the CPU tests
# hold the CPU to the reference at 1e-5 rel, 1e-7 / 1e-6 abs)
TRAIN_SMALL_TOL = dict(metric_rtol=1e-4, param_atol=1e-5)


def train_batch(torch, cfg, n_clients: int, bpc: int, seq: int, seed: int,
                device):
    """A client-serial batch drawn on the CPU from ``seed`` (the card and
    the CPU get the same one): tokens (n_clients, bpc, seq) and the next
    token as each one's label (the last position's label is ignored)."""
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (n_clients, bpc, seq + 1),
                         generator=gen, dtype=torch.int32)
    labels = toks[..., 1:].clone()
    labels[..., -1] = -100
    return {"tokens": toks[..., :-1].contiguous().to(device),
            "labels": labels.to(device)}


def gemm_kernel_split(by_name: dict) -> dict:
    """A traced step's device ms by kind: the port's own kernels (wkv,
    ssm, window attention; each by name too), the GEMMs (cuBLAS / CUTLASS
    names, cuBLAS's ``nvjet`` kernels among them), the rest (elementwise,
    reductions, copies)."""
    out = {"port_kernels_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0,
           "port_kernels": {}}
    for name, ms in by_name.items():
        low = name.lower()
        if any(k in low for k in ("wkv", "ssm_", "wattn")):
            out["port_kernels_ms"] += ms
            out["port_kernels"][name[:80]] = ms
        elif any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet")):
            out["gemm_ms"] += ms
        else:
            out["other_ms"] += ms
    return out


def traced_step(fn, untraced_ms: float) -> dict:
    """One traced call of a training step ``fn``: device-busy against its
    traced wall and against ``untraced_ms`` (the idle shares), and the
    GEMMs', the port's kernels' and the other work's ms and shares of the
    device time (``gemm_kernel_split``)."""
    trace = device_busy(fn)
    split = gemm_kernel_split(trace["by_name"])
    busy, total = trace["busy_ms"], trace["sum_ms"]
    return {"wall_ms": trace["wall_s"] * 1e3, "busy_ms": busy,
            "sum_ms": total, "records": trace["records"],
            "idle_share": 1.0 - busy / (trace["wall_s"] * 1e3),
            "untraced_step_ms": untraced_ms,
            "idle_share_of_untraced_step": 1.0 - busy / untraced_ms,
            **{f"{k}_share": split[f"{k}_ms"] / total
               for k in ("gemm", "port_kernels", "other")}, **split,
            "top": sorted(trace["by_name"].items(),
                          key=lambda kv: -kv[1])[:8]}


def train_step_row(torch, step, state, batch, tokens: int, flops: float,
                   peak_flops: float):
    """Run one step on ``state`` (host clock to a sync, peak memory from a
    reset); returns (its new state, its metrics, the row)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, mets = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals = {k: float(v) for k, v in mets.items()}
    if not all(math.isfinite(v) for v in vals.values()):
        raise AssertionError(f"train: metrics not finite {vals}")
    return state, vals, {"wall_ms": wall * 1e3,
                         "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                         "tokens_per_s": tokens / wall,
                         "mfu": flops / wall / peak_flops, **vals}


def train_path(torch, K):
    """Phase 8 (see the module docstring): ``make_fedavg_step`` (one
    warm-up, ``TRAIN_TIMED`` timed), ``make_central_step`` and
    ``make_calibration_step`` at rwkv6-3b's width, their launches counted;
    one traced fedavg step; remat "none" against "block"; the reduced
    card-vs-CPU check.  Returns the launches of the full-width steps and
    of the reduced check's card runs, summed."""
    from repro_torch.configs import FLConfig, ShapeConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import (make_calibration_step,
                                          make_central_step,
                                          make_fedavg_step)
    from repro_torch.models import init_params
    from repro_torch.optim import init_optimizer
    from repro_torch.roofline import analysis as rl

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_CUT)
    fl = FLConfig(fl_clients_per_step=TRAIN_CLIENTS, fl_local_steps=1)
    opt = dryrun.optimizer_for(cfg)
    shape = ShapeConfig("train_case", TRAIN_SEQ, TRAIN_CLIENTS, "train")
    flops = rl.model_flops(cfg, shape)
    peak_flops = rl.peak_flops(cfg.compute_dtype)
    tokens = TRAIN_CLIENTS * TRAIN_SEQ
    predicted = dryrun.run_one(TRAIN_ARCH, "train_4k", save=False, fl=fl,
                               changes=TRAIN_CUT, global_batch=TRAIN_CLIENTS)
    base = torch.cuda.memory_allocated()        # what earlier phases hold
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=CARD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in tree_leaves(params))
    state = (params, init_optimizer(opt, params))
    del params
    batch = train_batch(torch, cfg, TRAIN_CLIENTS, 1, TRAIN_SEQ, 11, CARD)
    fedavg = make_fedavg_step(cfg, fl, opt)
    state, warm, _row = train_step_row(torch, fedavg, state, batch, tokens,
                                       flops, peak_flops)
    K.reset_launches()
    rows = []
    for _ in range(TRAIN_TIMED):
        state, mets, row = train_step_row(torch, fedavg, state, batch,
                                          tokens, flops, peak_flops)
        rows.append(row)
    fedavg_launches = dict(K.LAUNCHES)
    central = make_central_step(cfg, opt)
    state, _m, central_row = train_step_row(
        torch, central, state, {k: v[0] for k, v in batch.items()},
        TRAIN_SEQ, flops / TRAIN_CLIENTS, peak_flops)
    hist = torch.full((TRAIN_CLIENTS,), mets["delta_norm"], device=CARD)
    cal = make_calibration_step(cfg, fl)
    _p, cal_mets, cal_row = train_step_row(
        torch, lambda st, b: cal(st[0], b, hist), state, batch, tokens,
        flops, peak_flops)
    del _p
    launches = dict(K.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"train: {missing} never launched ({launches})")
    # one traced fedavg step: device-busy against idle, GEMMs against the
    # port's kernels
    median = statistics.median(r["wall_ms"] for r in rows)
    traced = traced_step(lambda: fedavg(state, batch), median)
    remat = train_remat(torch, cfg, state[0], opt)
    del state, batch
    torch.cuda.empty_cache()
    log("train", case=TRAIN_ARCH, params=n_params,
        param_count=cfg.param_count(), d_model=cfg.d_model,
        heads=cfg.num_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        layers=cfg.num_layers, dtype="float32", optimizer=opt.name,
        clients=TRAIN_CLIENTS, local_steps=fl.fl_local_steps,
        seq_len=TRAIN_SEQ, remat="block",
        reduced={"depth": f"{get_config(TRAIN_ARCH).num_layers} -> "
                          f"{cfg.num_layers}",
                 "global_batch": "train_4k's 256 cut to 4 (one sequence a "
                                 "client)",
                 "dtype": "bfloat16 -> float32 (the port's fp32 path)"},
        init_s=init_s, model_flops_per_step=flops,
        peak_flops=peak_flops, warmup=warm,
        fedavg=rows, fedavg_wall_ms_median=median,
        fedavg_mfu_median=flops / (median / 1e3) / peak_flops,
        central=central_row, calibration=cal_row,
        calibration_loss=cal_mets["loss"],
        case_peak_bytes=max(r["peak_mem_bytes"] for r in rows) - base,
        dryrun_predicted_bytes=predicted["total_bytes"],
        dryrun_parts={k: predicted[k] for k in (
            "param_bytes", "opt_state_bytes", "fedavg_buffer_bytes",
            "grad_bytes", "activation_bytes_estimate", "local_step_bytes",
            "server_update_bytes")},
        fedavg_launches_3_steps={k: v for k, v in fedavg_launches.items()
                                 if v},
        launches={k: v for k, v in launches.items() if v},
        launches_note="under block remat each rwkv layer's wkv training "
                      "forward launches twice a local step (forward and "
                      "recompute), wkv_bwd once",
        traced_fedavg_step=traced, remat_check=remat)
    bf16_launches = train_bf16(torch, K)
    small, small_launches = train_card_vs_cpu(torch, K)
    log("train_card_vs_cpu", cases=small, tol=TRAIN_SMALL_TOL,
        launches={k: v for k, v in small_launches.items() if v})
    total = {k: launches[k] + small_launches[k] for k in launches}
    log("train_phase", seconds=time.perf_counter() - t_phase,
        launches={k: v for k, v in total.items() if v},
        bf16_launches={k: v for k, v in bf16_launches.items() if v})
    return total, bf16_launches


def train_bf16(torch, K) -> dict:
    """Phase 8's bf16 case: rwkv6-3b at its published width and numerics
    (bf16 params and compute; the steps' local updates in fp32 arithmetic,
    cast back), depth 8, 4 clients of one 4,096-token sequence, the
    optimizer ``dryrun.optimizer_for`` picks: ``make_fedavg_step`` once to
    warm up, then launches zeroed, ``TRAIN_BF16_TIMED`` timed steps and
    launches read; step wall, tokens/s, peak memory against the dry run's
    bf16 count, ``mfu`` against the bf16 peak; one traced step's GEMM,
    port-kernel and other ms and its idle share.  Returns the launches."""
    from repro_torch.configs import FLConfig, ShapeConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.train import make_fedavg_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_optimizer
    from repro_torch.roofline import analysis as rl

    t_case = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), **TRAIN_BF16_CUT)
    fl = FLConfig(fl_clients_per_step=TRAIN_CLIENTS, fl_local_steps=1)
    opt = dryrun.optimizer_for(cfg)
    shape = ShapeConfig("train_case", TRAIN_SEQ, TRAIN_CLIENTS, "train")
    flops = rl.model_flops(cfg, shape)
    peak_flops = rl.peak_flops(cfg.compute_dtype)
    tokens = TRAIN_CLIENTS * TRAIN_SEQ
    predicted = dryrun.run_one(TRAIN_ARCH, "train_4k", save=False, fl=fl,
                               changes=TRAIN_BF16_CUT,
                               global_batch=TRAIN_CLIENTS)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = init_params(cfg, 0, device=CARD)
    dtypes = sorted({str(v.dtype) for v in tree_leaves(params)})
    state = (params, init_optimizer(opt, params))
    del params
    batch = train_batch(torch, cfg, TRAIN_CLIENTS, 1, TRAIN_SEQ, 11, CARD)
    fedavg = make_fedavg_step(cfg, fl, opt)
    state, _m, warm = train_step_row(torch, fedavg, state, batch, tokens,
                                     flops, peak_flops)
    K.reset_launches()
    rows = []
    for _ in range(TRAIN_BF16_TIMED):
        state, _m, row = train_step_row(torch, fedavg, state, batch, tokens,
                                        flops, peak_flops)
        rows.append(row)
    launches = dict(K.LAUNCHES)
    missing = [k for k in TRAIN_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"train bf16: {missing} never launched "
                             f"({launches})")
    median = statistics.median(r["wall_ms"] for r in rows)
    traced = traced_step(lambda: fedavg(state, batch), median)
    peak = max(r["peak_mem_bytes"] for r in rows)
    del state, batch
    torch.cuda.empty_cache()
    log("train_bf16", case=TRAIN_ARCH, param_dtype=cfg.param_dtype,
        compute_dtype=cfg.compute_dtype, param_leaf_dtypes=dtypes,
        layers=cfg.num_layers, optimizer=opt.name, clients=TRAIN_CLIENTS,
        seq_len=TRAIN_SEQ, remat="block",
        reduced={"depth": f"{get_config(TRAIN_ARCH).num_layers} -> "
                          f"{cfg.num_layers}",
                 "global_batch": "train_4k's 256 cut to 4 (one sequence a "
                                 "client)"},
        model_flops_per_step=flops, peak_flops=peak_flops, warmup=warm,
        fedavg=rows, fedavg_wall_ms_median=median,
        fedavg_tokens_per_s_median=tokens / (median / 1e3),
        fedavg_mfu_median=flops / (median / 1e3) / peak_flops,
        peak_mem_bytes=peak, case_peak_bytes=peak - base,
        dryrun_predicted_bytes=predicted["total_bytes"],
        dryrun_parts={k: predicted[k] for k in (
            "param_bytes", "opt_state_bytes", "fedavg_buffer_bytes",
            "grad_bytes", "activation_bytes_estimate", "local_step_bytes",
            "server_update_bytes")},
        launches={k: v for k, v in launches.items() if v},
        traced_fedavg_step=traced,
        seconds=time.perf_counter() - t_case)
    return launches


def train_remat(torch, cfg, params, opt) -> dict:
    """``make_central_step`` at remat "none" and "block" on one sequence of
    ``TRAIN_REMAT_SEQ`` tokens from the same params, with an sgd server at
    lr 1 and no clip, so each new leaf is p - g: the loss and every new
    leaf must be equal bit for bit.  Returns each one's wall and peak."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch.train import make_central_step
    from repro_torch.optim import init_optimizer
    sgd = dataclasses.replace(opt, name="sgd", lr=1.0, grad_clip=0.0)
    batch = {k: v[0] for k, v in train_batch(torch, cfg, 1, 1,
                                              TRAIN_REMAT_SEQ, 12,
                                              CARD).items()}
    out = {}
    for remat in ("none", "block"):
        step = make_central_step(cfg, sgd, remat=remat)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (new, _o), mets = step((params, init_optimizer(sgd, params)), batch)
        torch.cuda.synchronize()
        out[remat] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "step_peak_bytes":
                          torch.cuda.max_memory_allocated() - base,
                      "loss": float(mets["loss"]), "new": new}
    a, b = out["none"].pop("new"), out["block"].pop("new")
    same = out["none"]["loss"] == out["block"]["loss"] and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    if not same:
        worst = max(float((x - y).abs().max())
                    for x, y in zip(tree_leaves(a), tree_leaves(b)))
        raise AssertionError(f"train remat: block differs from none (loss "
                             f"{out['none']['loss']} / "
                             f"{out['block']['loss']}, params {worst})")
    del a, b
    return {"seq_len": TRAIN_REMAT_SEQ, "bit_identical": True, **out}


def train_card_vs_cpu(torch, K):
    """``make_fedavg_step`` (sgd server, lr 0.5) and
    ``make_calibration_step`` at ``reduce_for_smoke`` configs on the card
    and on the CPU from the same weights and batch (``TRAIN_SMALL``):
    loss and delta_norm within ``metric_rtol``, every new leaf within
    ``param_atol``.  Returns each case's largest gaps and the card runs'
    launches (zeroed before the first, read after the last)."""
    from repro_torch.configs import (FLConfig, OptimizerConfig, get_config,
                                     reduce_for_smoke)
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch.train import (make_calibration_step,
                                          make_fedavg_step)
    from repro_torch.models import init_params
    from repro_torch.optim import init_optimizer
    fl = FLConfig(fl_clients_per_step=2, fl_local_steps=2)
    opt = OptimizerConfig(name="sgd", lr=0.5)
    tol = TRAIN_SMALL_TOL
    cases, launches = {}, {k: 0 for k in K.LAUNCHES}
    for arch, seq in TRAIN_SMALL:
        cfg = reduce_for_smoke(get_config(arch))
        cpu_params = init_params(cfg, 0, device="cpu")
        cpu_batch = train_batch(torch, cfg, 2, 2, seq, 13, "cpu")
        hist = torch.tensor([0.5, 0.3])
        out = {}
        for dev in (CARD, "cpu"):
            p = tree_map(lambda v: v.to(dev), cpu_params)
            b = {k: v.to(dev) for k, v in cpu_batch.items()}
            if dev == CARD:
                K.reset_launches()
            (new, _o), mets = make_fedavg_step(cfg, fl, opt)(
                (p, init_optimizer(opt, p)), b)
            cal, cmets = make_calibration_step(cfg, fl)(p, b, hist.to(dev))
            if dev == CARD:
                for k, v in K.LAUNCHES.items():
                    launches[k] += v
            out[dev] = ({k: float(v) for k, v in {**mets, **{
                "calibration_loss": cmets["loss"]}}.items()},
                [t.cpu() for t in tree_leaves(new)],
                [t.cpu() for t in tree_leaves(cal)])
        (gm, gp, gc), (cm, cp, cc) = out[CARD], out["cpu"]
        metric_gap = max(abs(gm[k] - cm[k]) / abs(cm[k]) for k in cm)
        param_gap = max(float((x - y).abs().max())
                        for x, y in zip(gp + gc, cp + cc))
        cases[arch] = {"seq_len": seq, "card": gm, "cpu": cm,
                       "metric_max_rel_gap": metric_gap,
                       "param_max_abs_gap": param_gap}
        if metric_gap > tol["metric_rtol"] or param_gap > tol["param_atol"]:
            raise AssertionError(f"train {arch}: card vs CPU {cases[arch]}")
    missing = [k for k in TRAIN_SMALL_KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"train reduced check: {missing} never "
                             f"launched ({launches})")
    return cases, launches


# phase 8b: the training step sharded over a DeviceMesh of one card
MESH_ARCH = "rwkv6-3b"
MESH_CUT = dict(num_layers=2, param_dtype="float32", compute_dtype="float32")
MESH_CLIENTS, MESH_SEQ = 2, 4096
MESH_KERNELS = ("wkv", "wkv_bwd")
# the dry run's per-card bytes of MESH_ARCH train_4k at full depth
MESH_DRYRUN = ("1x1", "1x4", "2x2", "4x1")
# tests/test_torch_train.py's tolerances for the adamw fedavg step
MESH_RTOL, MESH_MU_SHARE, MESH_OFF_SHARE = 1e-5, 2e-3, 0.01


def _adamw_gaps(torch, new, ref, mu_new, mu_ref, lr) -> dict:
    """tests/test_torch_train.py's rule for a first adamw step: the moments
    within ``MESH_MU_SHARE`` of their largest entry; params within an fp32
    ulp (1e-7 + 1.2e-7|p|) where |m| is above 1 % of its largest, within
    2 lr + ulp everywhere, and under 1 % of entries past an ulp."""
    from repro_torch.core.tree import tree_leaves
    mus = [m.float() for m in tree_leaves(mu_ref)]
    mu_max = max(float(m.abs().max()) for m in mus)
    mu_gap = max(float((a.float() - b).abs().max())
                 for a, b in zip(tree_leaves(mu_new), mus))
    off = total = 0
    big_gap = all_gap = 0.0
    for t, r, m in zip(tree_leaves(new), tree_leaves(ref), mus):
        d = (t.float() - r.float()).abs()
        ulp = 1e-7 + 1.2e-7 * r.float().abs()
        big = m.abs() > 0.01 * mu_max
        if bool(big.any()):
            big_gap = max(big_gap, float((d[big] - ulp[big]).max()))
        all_gap = max(all_gap, float((d - 2 * lr - ulp).max()))
        off += int((d > ulp).sum())
        total += d.numel()
    ok = (mu_gap <= MESH_MU_SHARE * mu_max and big_gap <= 0
          and all_gap <= 0 and off < MESH_OFF_SHARE * total)
    return {"ok": ok, "mu_max_abs_gap": mu_gap, "mu_max": mu_max,
            "big_moment_excess_over_ulp": big_gap,
            "excess_over_2lr_ulp": all_gap, "entries_past_ulp": off,
            "entries": total}


def mesh_path(torch, K):
    """Phase 8b (see the module docstring): a world of one rank over NCCL
    with a (1, 1) mesh; ``make_fedavg_step`` at rwkv6-3b's width cut to
    ``MESH_CUT``, once through ``ShardCtx`` and DTensors (the published
    config's rules, ``launch.train.mesh_context``) and once unsharded, on
    the same weights and batch; then the dry run's per-card bytes on
    ``MESH_DRYRUN``; then the serve part (``mesh_serve_path``).  Returns
    (the sharded step's launches, the sharded serves' launches)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.configs import FLConfig, get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import init_world
    from repro_torch.launch.shardings import gather_tree
    from repro_torch.launch.train import make_fedavg_step, mesh_context
    from repro_torch.models import init_params
    from repro_torch.optim import init_optimizer

    t_phase = time.perf_counter()
    # the dry run first: its meta counts need no process group
    dry = {}
    for mesh in MESH_DRYRUN:
        rec = dryrun.run_one(MESH_ARCH, "train_4k", save=False, mesh=mesh,
                             collectives=False)
        dry[mesh] = {k: rec[k] for k in (
            "num_layers", "param_bytes", "opt_state_bytes",
            "fedavg_buffer_bytes", "batch_bytes",
            "activation_bytes_estimate", "local_step_bytes",
            "server_update_bytes", "total_bytes", "fits", "max_depth_fit")}
    cfg = dataclasses.replace(get_config(MESH_ARCH), **MESH_CUT)
    fl = FLConfig(fl_clients_per_step=MESH_CLIENTS, fl_local_steps=1)
    opt = dryrun.optimizer_for(cfg)
    params = init_params(cfg, 0, device=CARD)
    batch = train_batch(torch, cfg, MESH_CLIENTS, 1, MESH_SEQ, 17, CARD)
    with tempfile.TemporaryDirectory() as tmp:
        init_world("nccl", 0, 1, dist.FileStore(tmp + "/store", 1))
        try:
            ctx, place = mesh_context(get_config(MESH_ARCH), "1x1", CARD)
            plain = make_fedavg_step(cfg, fl, opt)
            sharded = make_fedavg_step(cfg, fl, opt, ctx)
            dstate = place((params, init_optimizer(opt, params)), cfg)
            dbatch = place(batch, cfg, batch=True)
            placements = sorted({str(tuple(t.placements))
                                 for t in tree_leaves(dstate[0])})
            walls = {}
            runs = (("plain", plain, (params, init_optimizer(opt, params)),
                     batch), ("sharded", sharded, dstate, dbatch))
            for _name, step, st, b in runs:        # warm-up, not timed
                step(st, b)
            for name, step, st, b in runs:
                if name == "sharded":
                    K.reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step(st, b)
                torch.cuda.synchronize()
                walls[name] = (time.perf_counter() - t0) * 1e3
                if name == "sharded":
                    launches = dict(K.LAUNCHES)
                    (new_s, opt_s), mets_s = out
                else:
                    (new_p, opt_p), mets_p = out
            missing = [k for k in MESH_KERNELS if not launches[k]]
            if missing:
                raise AssertionError(f"mesh: {missing} never launched "
                                     f"({launches})")
            traces = {name: device_busy(lambda: step(st, b))
                      for name, step, st, b in runs}
            new_s, mu_s = gather_tree(new_s), gather_tree(opt_s.mu)
            mets_s = {k: float(v.full_tensor()) for k, v in mets_s.items()}
            serve_launches = mesh_serve_path(torch, K, cfg, params,
                                             ctx.mesh)
        finally:
            dist.destroy_process_group()
    mets_p = {k: float(v) for k, v in mets_p.items()}
    metric_gap = max(abs(mets_s[k] - mets_p[k]) / abs(mets_p[k])
                     for k in mets_p)
    gaps = _adamw_gaps(torch, new_s, new_p, mu_s, opt_p.mu, opt.lr)
    identical = (mets_s == mets_p and all(
        torch.equal(a, b) for a, b in zip(
            tree_leaves(new_s) + tree_leaves(mu_s),
            tree_leaves(new_p) + tree_leaves(opt_p.mu))))
    busy = {name: {"wall_ms": tr["wall_s"] * 1e3, "busy_ms": tr["busy_ms"],
                   "idle_share": 1.0 - tr["busy_ms"] / (tr["wall_s"] * 1e3),
                   "records": tr["records"]}
            for name, tr in traces.items()}
    log("mesh", case=MESH_ARCH, world="1 rank, nccl", mesh="1x1",
        d_model=cfg.d_model, layers=cfg.num_layers, dtype="float32",
        clients=MESH_CLIENTS, seq_len=MESH_SEQ, optimizer=opt.name,
        reduced={"depth": f"{get_config(MESH_ARCH).num_layers} -> "
                          f"{cfg.num_layers}",
                 "global_batch": "train_4k's 256 cut to 2 (one sequence a "
                                 "client)",
                 "dtype": "bfloat16 -> float32 (the port's fp32 path)"},
        param_placements=placements, metrics_sharded=mets_s,
        metrics_plain=mets_p, metric_max_rel_gap=metric_gap,
        adamw_rule=gaps, bit_identical=identical, wall_ms=walls,
        traced=busy, launches={k: v for k, v in launches.items() if v},
        dryrun_train_4k_full_depth=dry)
    if metric_gap > MESH_RTOL or not gaps["ok"]:
        raise AssertionError(f"mesh: sharded step off the plain one "
                             f"(metrics {metric_gap}, {gaps})")
    log("mesh_phase", seconds=time.perf_counter() - t_phase)
    return launches, serve_launches


# phase 8b's serve part: (a) MESH_ARCH at MESH_CUT, the phase's own
# weights; (b) published widths cut in depth whose prefill runs the other
# two kernels: (arch, changes to the published config, batch, prompt,
# what was cut); every case runs in fp32
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_STEPS = 4, 512, 8
MESH_SERVE_WIDE = (
    ("gemma3-27b", dict(num_layers=2, layer_pattern=("local", "global")),
     2, 1536, "depth 62 -> 2 (one local and one global layer); the prompt "
     "longer than the 1,024-token window, so the ring wraps"),
    ("jamba-1.5-large-398b", dict(num_layers=2,
                                  layer_pattern=("global", "mamba"),
                                  num_experts=0, experts_per_token=0),
     2, 512, "depth 72 -> 2 (global, mamba); experts off: the dense FFN "
     "at d_ff 24576, as phase serve cuts it"))
MESH_SERVE_KERNELS = ("window_attention", "wkv", "ssm_scan")


def _greedy_serve(torch, prefill, decode, whole, batch, steps: int) -> dict:
    """Prefill, then ``steps`` greedy decode steps (each fed the argmax of
    the last logits, on the device): the logits (steps + 1, B, V), the
    last cache, prefill ms and decode ms a token (host clock to a
    sync).  ``whole`` gives a step's logits whole."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [whole(logits[:, -1:])[:, 0]]
    for _ in range(steps):
        tok = out[-1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = decode(tok, cache)
        out.append(whole(logits[:, -1:])[:, 0])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"logits": torch.stack(out), "cache": cache,
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_token": (t2 - t1) * 1e3 / steps}


@contextlib.contextmanager
def kernel_calls():
    """Records every ``window_attention``, ``ssm_scan`` and ``wkv`` call
    the models make inside (under ``local_map``: on each rank's local
    tensors), by kernel: the shapes of its first two operands and CUDA
    events around the call.  Read it with ``kernel_call_times`` after the
    card is synchronized."""
    import torch
    from repro_torch.models import attention, mamba, rwkv6
    sites = ((attention, "window_attention"), (mamba, "ssm_scan"),
             (rwkv6, "wkv"))
    reals = [getattr(mod, name) for mod, name in sites]
    seen = {}

    def spy(name, real):
        def call(*args, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = real(*args, **kw)
            ev[1].record()
            # the call's work (``call_bound``): the operands' shapes, the
            # window, the operand element size
            seen.setdefault(name, []).append(
                (tuple(tuple(a.shape) for a in args[:2]), ev,
                 (args[4].shape if name != "window_attention" else args[3],
                  args[0].element_size())))
            return out
        return call
    for (mod, name), real in zip(sites, reals):
        setattr(mod, name, spy(name, real))
    try:
        yield seen
    finally:
        for (mod, name), real in zip(sites, reals):
            setattr(mod, name, real)


def call_bound(name: str, shapes, extra):
    """The bound (as ``bound`` returns it) of one inference call that
    ``kernel_calls`` recorded, at its own (local) shapes: the scan and the
    WKV at fp32 rates, window attention at the 3xTF32 rate (fp32) or the
    bf16 tensor-core rate."""
    from repro_torch.roofline import analysis as rl
    (s0, s1), (ex, size) = shapes, extra
    if name == "ssm_scan":          # dt (B, S, D), b (B, S, n), a (G?, D, n)
        g = ex[0] if len(ex) == 3 else 1
        return bound(*rl.ssm_work(*s0, s1[2], g, False, in_bytes=size))
    if name == "wkv":               # r (B, S, H, N), u (G?, H, N)
        g = ex[0] if len(ex) == 3 else 1
        return bound(*rl.wkv_work(*s0, g, False, in_bytes=size))
    b, s, h, hd = s0                # q (B, S, H, hd), k (B, S, KV, hd)
    return bound(*rl.window_work(b, s, h, s1[2], hd, int(ex), False,
                                 in_bytes=size),
                 flops_per_s=BF16_FLOPS_PER_S if size == 2
                 else TF32X3_FLOPS_PER_S)


def kernel_call_times(seen: dict) -> dict:
    """``kernel_calls``' record as {kernel: {"shapes", "ms", "bound_ms",
    "bound_by"}}: each call's ms between its events (the wrapper's launch
    and its kernel) and its bound at its own shapes (``call_bound``)."""
    out = {}
    for k, calls in seen.items():
        bnds = [call_bound(k, shape, extra) for shape, _, extra in calls]
        out[k] = {"shapes": sorted({shape for shape, _, _ in calls}),
                  "ms": [ev[0].elapsed_time(ev[1]) for _, ev, _ in calls],
                  "bound_ms": [b[0] for b in bnds],
                  "bound_by": sorted({b[1] for b in bnds})}
    return out


def mesh_serve_case(torch, K, published, cfg, params, mesh, bsz: int,
                    prompt: int, steps: int, seed: int,
                    cut: str = "") -> dict:
    """``cfg`` served greedily twice on the card from the same weights and
    prompts: plainly (``make_prefill_step`` / ``make_decode_step``) and
    through ``launch.serve.MeshServer`` on ``mesh`` under ``published``'s
    serving rules (``serve_on_mesh``'s path).  After one warm-up serve of
    each, one timed serve of each (the sharded one's launches zeroed just
    before it and read just after, with each kernel call's operand shapes
    and ms, ``kernel_calls``) and
    one traced serve of each (``device_busy``).  Fails unless the logits
    and every cache leaf are bit-identical."""
    from repro_torch.core.tree import leaves_with_paths
    from repro_torch.launch.serve import (MeshServer, make_decode_step,
                                          make_prefill_step)
    from repro_torch.launch.shardings import gather_tree
    batch = {k: v.to(CARD) for k, v in serve_inputs(
        torch, cfg, bsz, prompt, seed).items()}
    max_len = prompt + steps
    prefill = make_prefill_step(cfg, max_len=max_len)
    decode = make_decode_step(cfg)
    server = MeshServer(published, cfg, mesh, CARD, max_len=max_len)
    pparams, dparams = server.place(params)
    sides = {
        "plain": (lambda b: prefill(params, b),
                  lambda t, c: decode(params, t, c), lambda x: x),
        "sharded": (lambda b: server.prefill(pparams, b),
                    lambda t, c: server.decode(dparams, t, c),
                    lambda x: x.full_tensor())}
    runs, traced = {}, {}
    for name, fns in sides.items():            # warm-up, not timed
        _greedy_serve(torch, *fns, batch, steps)
    for name, fns in sides.items():
        if name == "sharded":
            with kernel_calls() as calls:
                K.reset_launches()
                runs[name] = _greedy_serve(torch, *fns, batch, steps)
                launches = dict(K.LAUNCHES)
        else:
            runs[name] = _greedy_serve(torch, *fns, batch, steps)
    for name, fns in sides.items():
        tr = device_busy(lambda: _greedy_serve(torch, *fns, batch, steps))
        traced[name] = {"wall_ms": tr["wall_s"] * 1e3,
                        "busy_ms": tr["busy_ms"],
                        "idle_share": 1.0 - tr["busy_ms"]
                        / (tr["wall_s"] * 1e3), "records": tr["records"]}
    plain, sharded = runs["plain"], runs["sharded"]
    whole = dict(leaves_with_paths(gather_tree(sharded["cache"])))
    leaves = dict(leaves_with_paths(plain["cache"]))
    differ = sorted("/".join(p) for p, t in leaves.items()
                    if not torch.equal(t, whole[p]))
    same_logits = torch.equal(plain["logits"], sharded["logits"])
    row = {"arch": cfg.name, "d_model": cfg.d_model,
           "layers": cfg.num_layers, "batch": bsz, "prompt": prompt,
           "steps": steps, "cut": cut, "strategy": server.strategy,
           "logits_bit_identical": same_logits, "cache_leaves": len(leaves),
           "cache_leaves_differing": differ,
           "max_abs_logit_gap": float((plain["logits"]
                                       - sharded["logits"]).abs().max()),
           **{f"{k}_{name}": runs[name][k] for name in runs
              for k in ("prefill_ms", "decode_ms_per_token")},
           "traced": traced,
           "launches": {k: v for k, v in launches.items() if v},
           "kernel_calls": kernel_call_times(calls)}
    log("mesh_serve", **row)
    if not same_logits or differ:
        raise AssertionError(f"mesh serve {cfg.name}: sharded serving is "
                             f"not bit-identical to plain ({row})")
    return launches


class CardInit:
    """``models.params.RealInit``'s draws under ``draw``'s rules, made on
    the card from a CUDA generator seeded ``seed``: billions of values in
    well under a second, where the CPU's generator takes about ten
    seconds a billion (phase 7's ``init_s``)."""

    def __init__(self, torch, seed: int):
        self.torch = torch
        self.gen = torch.Generator(device=CARD).manual_seed(seed)

    def param(self, shape, init: str = "normal", scale: float = 1.0,
              in_dims: int = 1, fan_in=None):
        from repro_torch.models.params import draw
        torch, shape = self.torch, tuple(shape)
        if init == "normal":
            if fan_in is None:
                fan_in = (math.prod(shape[:in_dims]) if len(shape) > 1
                          else max(shape[-1], 1))
            return torch.randn(shape, generator=self.gen, device=CARD) \
                * (scale / math.sqrt(fan_in))
        if init == "uniform":
            return torch.rand(shape, generator=self.gen, device=CARD) * scale
        return draw(None, shape, init, scale).to(CARD)


def mesh_serve_path(torch, K, cfg, params, mesh) -> dict:
    """Phase 8b's serve part (see the module docstring), on the phase's
    1x1 world: (a) ``MESH_ARCH`` at ``MESH_CUT`` with the phase's own
    weights, (b) the ``MESH_SERVE_WIDE`` cases at their published widths
    (weights drawn on the card, ``CardInit``, freed after each); each
    through ``mesh_serve_case``.  Returns the sharded serves' launches summed;
    fails when a kernel of ``MESH_SERVE_KERNELS`` never launched."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    t_part = time.perf_counter()
    total = mesh_serve_case(torch, K, get_config(MESH_ARCH), cfg, params,
                            mesh, MESH_SERVE_BATCH, MESH_SERVE_PROMPT,
                            MESH_SERVE_STEPS, 23,
                            f"depth {get_config(MESH_ARCH).num_layers} -> "
                            f"{cfg.num_layers}")
    for arch, changes, bsz, prompt, cut in MESH_SERVE_WIDE:
        wide = dataclasses.replace(get_config(arch), param_dtype="float32",
                                   compute_dtype="float32", **changes)
        got = mesh_serve_case(torch, K, get_config(arch), wide,
                              init_lm(CardInit(torch, 0), wide), mesh, bsz,
                              prompt, MESH_SERVE_STEPS, 29, cut)
        total = {k: total[k] + got[k] for k in total}
        torch.cuda.empty_cache()
    missing = [k for k in MESH_SERVE_KERNELS if not total[k]]
    log("mesh_serve_part", seconds=time.perf_counter() - t_part,
        launches={k: v for k, v in total.items() if v})
    if missing:
        raise AssertionError(f"mesh serve: {missing} never launched on the "
                             f"sharded serve path ({total})")
    return total


# phase 9: each port example's main on the card at the reference's sizes,
# and the kernels each must launch
EXAMPLES = (("quickstart", ("coded_matmul", "calibrate")),
            ("coded_storage", ("coded_matmul",)),
            ("unlearn_generation", ("wkv", "wkv_bwd", "coded_matmul",
                                    "calibrate")),
            ("serve_unlearning", ("coded_matmul", "calibrate")),
            ("serve_batched", ("ssm_scan", "wkv")))
BYZANTINE = [2, 11, 19]   # the clients coded_storage corrupts


def _numbers(obj):
    """Every float and int of an example's result (dicts, lists, tensors,
    the results' and reports' fields)."""
    import numbers

    import numpy as np
    if isinstance(obj, bool):
        return []
    if isinstance(obj, numbers.Number):
        return [float(obj)]
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _numbers(v)]
    if isinstance(obj, (list, tuple)):
        return [x for v in obj for x in _numbers(v)]
    if isinstance(obj, np.ndarray):
        return obj.astype(np.float64).ravel().tolist()
    if hasattr(obj, "to_dict"):
        return _numbers(obj.to_dict())
    return []


def _example_checks(torch, name, out) -> None:
    """Every printed metric finite; SE's impacted shards [0]; the coded
    store's located clients and round-trip errors."""
    from repro_torch.core.tree import tree_leaves
    if name == "serve_batched":
        printed = [{k: o[k] for k in ("prefill_s", "decode_s_per_token")}
                   for o in out]
        if not all(bool(torch.isfinite(o["prefill_logits"]).all())
                   for o in out):
            raise AssertionError("serve_batched: non-finite logits")
    elif name == "coded_storage":
        printed = out["err"]
        if out["located"] != BYZANTINE or max(out["err"].values()) > 1e-3:
            raise AssertionError(f"coded_storage: located {out['located']}, "
                                 f"errors {out['err']}")
    elif name == "serve_unlearning":
        printed = [s["report"].to_dict() for s in out["serves"]]
        models = [m for s in out["serves"] for r in s["results"]
                  for m in r.models.values()]
        if not models or not all(bool(torch.isfinite(v).all())
                                 for m in models for v in tree_leaves(m)):
            raise AssertionError("serve_unlearning: non-finite models")
    else:
        se = (out["unlearn"]["SE"]["result"] if name == "quickstart"
              else out["se"])
        if list(se.impacted_shards) != [0]:
            raise AssertionError(f"{name}: SE impacted "
                                 f"{se.impacted_shards}")
        printed = {k: v for k, v in out.items() if k != "record"}
    bad = [x for x in _numbers(printed) if not math.isfinite(x)]
    if bad:
        raise AssertionError(f"{name}: non-finite printed metrics {bad}")


def examples_path(torch, K) -> dict:
    """Phase 9: each port example's ``main`` on the card at the reference
    example's sizes (no arguments: the card, the reference's flags'
    defaults), its launch counts zeroed just before and read just after:
    its lines, wall and launches, and its checks (``_example_checks``;
    serve_batched's sampled tokens are printed, not judged).  Returns the
    five examples' launches summed (``by_path`` "examples")."""
    import contextlib
    import importlib.util
    import io

    root = Path(__file__).resolve().parent / "examples"
    total = {k: 0 for k in K.LAUNCHES}
    t_phase = time.perf_counter()
    for name, need in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            f"{name}_torch", root / f"{name}_torch.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        buf = io.StringIO()
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main([])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        log("examples", example=name, wall_s=wall, launches=launches,
            lines=buf.getvalue().splitlines())
        missing = [k for k in need if launches[k] == 0]
        if missing:
            raise AssertionError(f"examples/{name}_torch.py: kernels never "
                                 f"launched: {missing}")
        _example_checks(torch, name, out)
        for k, v in launches.items():
            total[k] += v
    log("examples", phase_s=time.perf_counter() - t_phase, launches=total)
    return total


def main() -> int:
    root = Path(__file__).resolve().parent
    src = root / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found next to this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    if sys.argv[1:2] == ["durability-child"]:
        return durability_child(sys.argv[2:])
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import kernels as K

    smi = nvidia_smi()
    K.resolve_device("cuda")
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0],
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_deterministic=torch.backends.cudnn.deterministic,
        cudnn_benchmark=torch.backends.cudnn.benchmark)

    K.load_library()
    ptxas = ptxas_summary(K.BUILD_INFO["log"])
    log("build", build_s=K.BUILD_INFO["build_s"], ptxas=ptxas)
    # the kernels redesigned last (the recurrence backwards, then their
    # forwards, then the window forward, then encode_decode's register
    # tile and the scan forward's bf16 staging, then the wgmma window
    # forward and coded_matmul's pair route): registers and spills
    redesigned = [r for r in ptxas if any(
        k in r[0] for k in ("ssm_bwd_kernel", "wkv_bwd_a_kernel",
                            "wkv_bwd_b_kernel", "ssm_fwd_kernel",
                            "wkv_fwd_kernel", "wattn_fwd_kernel",
                            "encode_decode_kernel",
                            "wattn_fwd_bf16_tma_kernel",
                            "coded_matmul_kernel"))]
    log("ptxas_redesigned", kernels=redesigned)
    spilled = [r[0] for r in redesigned
               if not r[2].startswith("0 bytes stack frame")]
    if spilled:
        raise AssertionError(f"redesigned kernels spill: {spilled}")

    from repro_torch.configs import get_config
    from repro_torch.fl.families import get_model_family
    heads = {"cnn": check_kernels(torch, K, "cnn", get_config("cnn-paper"),
                                  ragged=True)}
    for fam in LM_KERNELS:
        heads[fam] = check_kernels(torch, K, fam,
                                   get_model_family(fam).build(None),
                                   ragged=False)
    ssm, wkv = check_ssm(torch, K), check_wkv(torch, K)
    window = check_window(torch, K)
    heads["bf16"] = check_bf16_routes(torch, K)
    # the serve path's rows: each kernel's inference forward at its shape
    heads["serve"] = {"ssm_scan": ssm.pop("serve"), "wkv": wkv.pop("serve"),
                      **window["serve_gemma3"]}
    # the train path's rows: wkv at its full-width client step
    heads["train"] = {"wkv": wkv.pop("train"),
                      "wkv_bwd": wkv.pop("train_bwd")}
    heads["mamba"].update(ssm)
    heads["rwkv6"].update(wkv)
    heads["local_small"] = window["local_small"]
    heads["gemma3"] = window["gemma3_full_width"]
    # each path's own counts, zeroed just before it and read just after
    launches = {"local_small": check_small(torch, K)}
    check_table1_small(torch, K)
    launches["cnn"] = cnn_path(torch, K)
    cnn_session, cnn_sims = TRAINED.pop("cnn")
    launches["service"] = service_path(torch, K, cnn_session)
    launches["durability"], snap_dir = durability_path(torch, K, cnn_session,
                                                       cnn_sims)
    del cnn_session
    launches["tiering"] = tiering_path(torch, K, snap_dir, cnn_sims)
    launches["table1"] = table1_path(torch, K)
    for fam in LM_KERNELS:
        launches[fam] = lm_path(torch, K, fam)
    full_width(torch, K)
    full_width_rwkv(torch, K)
    launches["gemma3"] = full_width_gemma(torch, K)
    full_width_granite(torch, K)
    launches["serve"], launches["serve_bf16"] = serve_path(torch, K)
    launches["train"], launches["train_bf16"] = train_path(torch, K)
    launches["mesh"], launches["mesh_serve"] = mesh_path(torch, K)
    launches["examples"] = examples_path(torch, K)

    # one row per kernel, its numbers from the path it was ported for; the
    # launches and times on every path under "by_path"
    cu = "src/repro_torch/kernels/csrc/"
    coded = "src/repro/kernels/coded_matmul/kernel.py"
    window_tpu = "src/repro/kernels/window_attn/kernel.py:66"
    # the bf16 routes: on no path but the jamba bf16 serve's ssm_scan; their
    # numbers from phase 3e.  The bf16 serves and training step count under
    # their own paths, "serve_bf16" and "train_bf16"
    bf16 = {"coded_matmul_bf16": (cu + "coded_matmul.cu", coded + ":47",
                                  None),
            "coded_matmul_rounds_bf16": (cu + "coded_matmul.cu",
                                         coded + ":82", None),
            "encode_decode_bf16": (cu + "coded_matmul.cu", coded + ":119",
                                   None),
            "ssm_scan_bf16": (cu + "ssm_scan.cu",
                              "src/repro/kernels/ssm_scan/kernel.py:59",
                              "serve_bf16"),
            "wkv_bf16": (cu + "wkv.cu", "src/repro/kernels/wkv/kernel.py:55",
                         None),
            "window_attention_bf16": (cu + "window_attn_tma.cu",
                                      window_tpu, None)}
    sources = {"coded_matmul": (cu + "coded_matmul.cu", coded + ":47", "cnn"),
               "coded_matmul_rounds": (cu + "coded_matmul.cu", coded + ":82",
                                       "cnn"),
               "calibrate": (cu + "calibrate.cu",
                             "src/repro/kernels/calibrate/kernel.py:28",
                             "cnn"),
               "ssm_scan": (cu + "ssm_scan.cu",
                            "src/repro/kernels/ssm_scan/kernel.py:59",
                            "mamba"),
               "ssm_scan_bwd": (cu + "ssm_scan.cu",
                                "src/repro/kernels/ssm_scan/ops.py:51",
                                "mamba"),
               "wkv": (cu + "wkv.cu", "src/repro/kernels/wkv/kernel.py:55",
                       "rwkv6"),
               "wkv_bwd": (cu + "wkv.cu", "src/repro/kernels/wkv/ops.py:51",
                           "rwkv6"),
               # slice verification: on no path of either package; its
               # numbers from its own check at the CNN's P
               "encode_decode": (cu + "coded_matmul.cu", coded + ":119",
                                 None),
               # the gemma3-27b local layer; the TPU kernel had no backward
               "window_attention": (cu + "window_attn.cu", window_tpu,
                                    "gemma3"),
               "window_attention_bwd": (cu + "window_attn.cu", window_tpu,
                                        "gemma3")}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "plain_event_ms", "library_event_ms")
    train_keys = ("train_ms", "train_bound_ms")      # the recurrence forwards
    rows = []
    for name, (source, replaces, path) in {**sources, **bf16}.items():
        by_path = {p: {"launches": launches[p][name],
                       **{k: heads[p][name][k] for k in keys + train_keys
                          if k in heads.get(p, {}).get(name, {})}}
                   for p in launches}
        head = heads["bf16" if name in bf16 else path or "cnn"][name]
        note = None
        if name in bf16 and path is None:
            note = ("bf16 operands; no model path hands it bf16 (phase 3e's "
                    "numbers)")
        elif path is None:
            note = "runs on no path in either package (slice verification " \
                   "only)"
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "path": path,
                     "launches": launches[path][name] if path else 0,
                     **{k: head[k] for k in keys},
                     **{k: head[k] for k in train_keys if k in head},
                     # the route every such call took before, in turns
                     **{k: head[k] for k in ("parent_ms", "parent_route")
                        if k in head},
                     "by_path": by_path, **({"note": note} if note else {})})
    log("done", total_s=time.perf_counter() - T_START)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
