#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``apex_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device  — the card, its capability, CUDA version and power limit;
   exits 1 before anything else when CUDA is not available.
2. build   — compiles ``apex_tpu_torch/csrc/*.cu`` with nvcc for sm_90a
   and reports ``ptxas``'s registers, spills and shared memory (static,
   and the dynamic bytes each launch asks for) of the tensor-core
   kernels (bf16 flash forward, dq and dk/dv, with and without
   dropout), and of B2's fast path, B3's and the decode kernels
   (``PTXAS_KERNELS``).
3. kernels — every ported kernel against its plain PyTorch version on
   the card at the shapes the serving and training paths give it, fp32
   and bf16 (scale-aware error max|a-b|/(max|b|+1) <= 2e-5 fp32,
   <= 2e-2 bf16, <= 1e-6 for FusedAdam, whose skipped step must keep
   every bit; the bf16 flash o, dq, dk and dv also row by row, see
   ``row_err``), each timed as the median device time of 6-15 launches
   between CUDA events beside its plain version, one PyTorch library
   call computing the same function (a yardstick the port never calls)
   and its bound (the larger of bytes over 3.35 TB/s and FLOPs over the
   peak for the operand type); the phase first reads the same timing
   for a launch that does nothing (``timing_floor_ms``, and with L2
   flushed ``timing_floor_cold_ms``), the floor under every time.  B2
   runs with weights in x's dtype (as
   O0 and O2 hold them), its library call on the same weights; at the
   bf16 training shapes both are also timed with the 50 MB L2 flushed
   before each launch (``cold_ms``, ``library_cold_ms``).  B2 and B3
   also run bf16 x with fp32 weights (O1 keeps norm layers' params
   fp32) at GPT-2 small's and BERT-large's training shapes
   (``LN_O1_SHAPES``), B3's dgamma and dbeta then fp32.  Each flash
   row names the body it timed
   (``design``: ``wgmma`` for bf16 B4/B5/B6 and their dropout branches,
   ``cuda_cores_fp32`` for fp32).  The dropout kernels (B4d,
   B5d, B6d, at rate 0.1, BERT-large's and GPT's training shapes) also
   read their keep-mask back from crafted inputs over Sq = Sk = 192
   (three tiles each way) and hold it bit for bit against
   ``keep_from_seed``.  B3 is the whole LayerNorm backward (dx, dgamma
   and dbeta, against ``native_layer_norm_backward`` asked for all
   three).  B7 and B8 (decode split across the context) run at the
   decode shapes of ``DECODE_SHAPES``: the serve path's 8 x 1025 x 12 x
   64 at three biases (``DECODE_BIASES``: the engine's, all keys live,
   NEG_INF tails whose keys the kernel does not read), serve_q8 (c)'s
   16 slots, and one context of 20,000 keys at B * H 12 (split, and
   the splits combined); each row has a live-key bound and the
   all-keys one, the split count the wrapper chose and, at the shape's
   first bias, the time of every split count (``split_ms``).  B3, B7
   and B8 are held bit for bit against a second launch.  B8 (int8 K/V
   from ``quantize_kv`` of random data, one head all zero) is also held bit
   for bit against B7 on the dequantized K/V; its library yardstick is
   SDPA on the dequantized K/V (no PyTorch call takes int8 K/V).  The
   threefry dropout kernel (BERT's hidden dropout; no TPU kernel) is
   held bit for bit against its plain version, forward and gradient, at
   BERT-large's activation and an odd size, beside ``F.dropout``; its
   bound counts the integer instructions of its loop in the built
   SASS (``threefry_int_ops``, also in the build line).  B1-multi (the
   multi-tensor form of B1) is held bit for bit against its plain
   version over GPT-2 small's 196 leaves in three groups, on a skipped
   step with inf/nan gradients, and on odd, misaligned and empty
   segments (``MULTI_EDGE_SEGMENTS``), and timed beside flat B1 and
   ``torch._fused_adam_``; the dropout rows at GPT-2 small's causal
   shape go into the JSON line as ``gpt_causal``.
4. serve   — ``InferenceServer`` on GPT-2 small at full width (seeded
   random weights), 8 decode slots, 16-token blocks, flash prefill,
   16 prompts of 4..255 tokens, 32 new tokens each, the pipelined
   (dispatch-ahead) loop by default; its first line is the prediction
   (``P_PREDICTION``):
   (a) fp32 cache, TF32 off: tokens against greedy full recompute on
       the card (the port's model with plain attention and plain
       LayerNorm: it launches none of the kernels); a mismatch is
       allowed only where the oracle's top-2 logit gap is < 1e-3, and
       ends that request's comparison; every decode launch runs under
       ``torch.cuda.set_sync_debug_mode("error")`` (a launch that waits
       on the card raises; the retire may wait); then the synchronous
       loop (``enable_pipeline=False``): the same tokens and launches;
   (f) disaggregated prefill/decode (``enable_disagg=True``: the
       prefill pool's engine on a CUDA stream of its own, B4 there, B7
       in the decode pool): (a)'s tokens exactly and (a)'s B4 launches,
       B7 L a decode step, every prompt handed off once; its decode
       launches, prefill slices and hand-off copies under sync-debug
       "error"; a consumer thread a request iterating ``stream()``
       receives exactly its tokens; the first hand-off copy torn (half
       its pairs, then ``torch.OutOfMemoryError``) and the second
       delayed: ``oom_events`` 2; then the tightest prefill pool (one
       full context), the same tokens;
   (b) the default bf16 cache, the pipelined loop timed: tokens/s
       (one timed pass), occupancy, preemptions, the window's
       ``host_stall_ms``/``host_plan_ms`` and the breaker's state; one
       synchronous pass with the same tokens and launches; then one
       pipelined pass under ``torch.profiler``: device time by kernel
       class and the device's idle share of the wall time;
   (c) ``torch.OutOfMemoryError`` injected at the pipelined server's
       second and third decode launches (``DECODE_OOM_AT``): the same
       tokens, ``oom_events`` 2, the breaker closed.
   Every pass checks that every kernel's launch count rose by exactly
   its per-prefill and per-decode-step count, that ``stats()`` reports
   the same counts, and that every launched window was retired.  All
   arms pin ``kv_quant="off"``.
5. serve_q8 — the same model and traffic from the int8 pool
   (``kv_quant="int8"``, decode through B8):
   (a) fp32 compute, TF32 off, 8 slots: tokens against the int8 greedy
       full recompute on the card (``model(ids, kv_quant=True)`` on the
       kernel-free oracle: K/V quantized at the source, plain attention
       over the dequantized values), the same near-tie rule; launches
       exact (B8 ``L`` per decode step, B7 none); ``stats()["memory"]``
       reads ``int8`` and 313,344 bytes per block;
   (f) the same from a disaggregated server (B8 in the decode pool):
       (a)'s tokens but where they part at an oracle near-tie, (a)'s B4
       launches, B8 L a decode step;
   (b) the same server timed (one pass): its tokens (a)'s, and one
       pass of its synchronous twin with the same tokens and launches;
   (c) equal pool bytes: the bytes of 129 bf16 blocks give the bf16
       arm 129 blocks and the int8 arm 242; both serve the 16 prompts
       with 16 slots (all at once need 158 blocks); the int8 arm's
       tokens agree with the bf16 arm's to a mean agreeing prefix
       >= 0.75 (``tests/L0/test_kv_quant.py``'s gate).
   serve and serve_q8 pin ``enable_chunked_prefill=False`` (the
   monolithic flash prefill); the four serve phases share one seed-0
   model, its oracle and the traffic (``_serve_model``).  serve,
   serve_q8 and serve_programs turn the default layers off
   (``LAYERS_OFF``: no prefix cache, speculation or overload control),
   so their launch and step checks read the paths they always did.
5b. serve_programs — the engine's remaining programs and stochastic
   sampling on the same model and traffic; its first line is the
   prediction (``S_PREDICTION``):
   (a) chunked prefill (``prefill_chunk=64``), fp32 pool, TF32 off:
       tokens against the greedy full recompute (serve (a)'s rule),
       launches exact (B2 (2L+1) a chunk and a decode step, B4 none, B7
       L a decode step), ``stats()["prefill_chunks"]`` = the sum of
       ceil(len / 64);
   (b) the same from the int8 pool against the int8 oracle (B8), once
       (serve_q8 (b) times the int8 pool);
   (c) on a bf16 and an int8 pool: ``verify`` of 8 slots x 4 tokens
       against 4 decode steps from the same pool (logits within
       ``VERIFY_TOL`` scale-aware, 1e-3 bf16 and 2e-4 int8, and a verify
       fed one position late outside it; argmax equal but where the
       decode's top-2 gap is under twice the row's difference; launches
       2L+1 B2 and nothing else), ``copy_blocks`` (a chained batch reads
       the old blocks),
       ``copy_blocks_from`` and ``export_blocks``/``import_blocks`` into
       a second engine bit for bit on every leaf, a flipped payload
       byte refused, an empty import writing nothing;
   (d) 8 requests of mixed classes (greedy, temperature, top-k, top-p,
       both; one seed each) on the bf16 pool: the pipelined loop (its
       decode launches under sync-debug "error") against the
       synchronous loop, the greedy rows against a greedy-only pass
       and a pool of ``STARVED_BLOCKS`` that preempts, each bit for
       bit; the card's keys and uniform bits the CPU's, its Gumbel
       noise within ``NOISE_ULPS`` epsilons of max(|x|, 1); the
       pipelined pass under the profiler;
   (e) 7 of serve's prompts decoding on the bf16 pool when a
       1000-token prompt arrives: the default server (chunks of 256),
       the monolithic prefill and the disaggregated server (chunks of
       256 in the prefill pool), one pass each
       (``PROGRAMS_TIMED_PASSES``), the decoders' median, p99 and
       largest inter-token gaps (a token counted when the step that
       applied it returns) and the long request's time to first token;
       launches and chunks exact.  The phase
       prints its seconds in its ``done`` line.
5c. serve_features — the reference server's default layers (prefix
   cache with copy-on-write, n-gram speculation, overload control,
   deadlines and the lifecycle) on the same model, 8 slots, 16-token
   blocks, the defaults on; its first line is the prediction
   (``F_PREDICTION``).  Every pass checks its launches exactly against
   the step accounting (B2 2L+1 a chunk, verify or decode step, B7/B8 L
   a decode step and none a verify step, B4 L a monolithic prefill),
   ``audit()`` and the pool (nothing live afterwards):
   (a) 16 requests sharing a 256-token system prompt with tails of
       8-64 tokens and 2 that are the system prompt alone, 32 new tokens
       each, fp32 pool: tokens against the greedy full recompute (serve
       (a)'s rule), ``prefix_hit_tokens`` >= 15 x 256,
       ``prefix_cow_blocks`` 2;
   (b) the same from the int8 pool: each COW copy equal to its source
       on every leaf (payload and scales) right after the copy, tokens
       equal to an int8 server without the cache but where they part at
       an oracle near-tie;
   (c) 8 prompts repeating an 8-32-token snippet, greedy on the fp32
       pool: tokens against the oracle, drafts drafted and accepted;
       then the four stochastic classes twice from a reset pool, bit
       for bit, the rejection counters read; every decode and verify
       launch, greedy and stochastic, under sync-debug "error"; then
       the greedy pass with ``torch.OutOfMemoryError`` injected at the
       first prefill chunk and the second verify launch (``OOM_AT``):
       the same tokens, ``oom_events`` 2, launches exact;
   (d) (a)'s traffic in 40 usable blocks: evictions and preemptions,
       tokens still the oracle's;
   (e) 48 submits at priorities 0 and 1 into ``max_waiting=16``: one
       terminal reason each, none shed at priority 0; a drain begun
       mid-generation gives the undisturbed tokens, a submit during it
       finishes ``draining``, ``close()`` runs once and refuses later
       submits;
   (f) the offload tier (``enable_kv_offload``) on session traffic: 8
       prompts of 25 full blocks and a 3-token tail, 16 new tokens, two
       passes of one request at a time, the monolithic prefill (B4),
       every pool audited after every step; each pass against a roomy
       offload-off server on the same pool dtype, tokens EXACT: fp32 in
       60 usable blocks with the host tier holding every demote (and the
       greedy full recompute's rule), every decode and verify launch
       under sync-debug "error" (steps with a promote counted), each
       demote export and promote import under "warn" with its syncs
       counted; the int8 pool (B8); bf16 through the disk tier (a host
       tier smaller than a block), session 0's first spilled leaf torn
       before pass 2 (``disk_torn``; it cold-prefills, its tokens its own
       pass-1 cold prefill's under the near-tie rule); disaggregated, the
       prefill pool of one context the cache home;
   (g) (f)'s fp32 pass with ``kv_transport=SocketTransport()`` on
       loopback: the in-process pass's tokens, one delivery a promote
       batch, no retry; then a third pass of the prompts on it with a
       reset and a stall injected through the transport's ``chaos`` seam
       (``TRANSPORT_FAULTS``): the reset retried and its promote exact,
       the stalled promote skipped (``transport_skips`` 1) and its
       session cold, against its own pass-1 cold prefill under the
       near-tie rule.
6. train   — ``apex_tpu_torch.examples.gpt_main_amp`` on GPT-2 small at
   full width, FusedAdam(lr=3e-4) flat, causal flash attention, against
   a kernel-free oracle on the card (the same model and step on plain
   LayerNorm, plain attention and plain Adam, checked to launch none of
   the port's kernels), both from seed 0 and the example's token
   batches:
   (a) O0, TF32 off, batch 2, 3 steps: losses <= 1e-4 relative, step-1
       gradients <= 1e-4 scale-aware, and each step's launches exactly
       25 LayerNorm forward and backward, 12 flash forward, dq and dk/dv,
       1 FusedAdam;
   (b) O2 through ``train()`` at batch 8, sequence 1024, 10 steps with
       every launch count at 0 just before and read just after (exactly
       10 times the per-step counts): losses within 2e-2 of the O2
       oracle at every step; median tokens/s over steps 1-9;
   (c) the overflow step: one gradient element set to inf, then
       ``AmpOptimizer.step`` under ``torch.cuda.set_sync_debug_mode
       ("error")``: master params, m, v and the step counter keep every
       bit, the loss scale halves, and no host sync is raised;
   (d) one more O2 step under ``torch.profiler``: device time by kernel
       class and the device's idle share;
   (e) the data-parallel step: ``train(ddp=True)``, 3 O2 steps through
       ``DistributedDataParallel`` over an NCCL group of one, counts read
       around it (path ``train_ddp``): losses bit for bit those of the
       same 3 steps without DDP.
7. train_bert — ``apex_tpu_torch.examples.bert_main_amp`` on BERT-large
   at full width (vocab 30522, hidden 1024, 24 layers, 16 heads),
   FusedLAMB as the example (lr 1e-4, max_grad_norm 1.0, no decay and
   no layer adaptation for bias/LayerNorm), ``make_flash_attention()``
   and ``deterministic=False`` (dropout 0.1: attention dropout inside
   the flash kernels, hidden dropout through the threefry dropout
   kernel, step i keyed ``fold_in(PRNGKey(0), i)`` as flax keys it),
   against a kernel-free oracle on the card (the same model, weights,
   step keys and batches on plain LayerNorm, the plain threefry dropout
   and the plain flash-with-dropout, checked to launch none of the
   port's kernels):
   (a) O0, TF32 off, batch 2, 3 steps: losses <= 1e-4 relative, step-1
       gradients <= 1e-4 scale-aware, each step exactly 50 LayerNorm
       forward and backward, 24 flash forward, dq and dk/dv with
       dropout, 98 threefry dropouts (49 forward, 49 backward), nothing
       else;
   (b) O2 through ``train()`` at batch 32, sequence 128, 10 steps,
       counts at 0 just before and read just after (10 times the
       per-step counts): losses within 2e-2 of the O2 oracle at every
       step; median tokens/s over steps 1-9; peak memory;
   (c) the overflow step under ``set_sync_debug_mode("error")``, its
       forward (keys and attention seeds made on the host, the seeds
       copied from pinned memory), backward and
       ``AmpOptimizer(FusedLAMB)`` step: params, m, v and the step
       counter keep every bit, the scale halves, no host sync;
   (d) one more O2 step under ``torch.profiler``;
   (e) ``--grad-accum``: one O2 step at 4 strided microbatches and one at
       1 from (a)'s weights on the same batch, each against the oracle's
       step within 2e-2, the 4-microbatch step's counts read around it
       (path ``train_bert_accum``: 4 times a step's); a second step of
       each timed (step ms, tokens/s, peak memory); an inf planted with
       ``fill_`` in microbatch 3's scaled grads under sync-debug
       "error": every bit kept, the scale halved once, no host sync; the
       4-microbatch step through ``DistributedDataParallel`` over an
       NCCL group of one equal to it bit for bit.

8. train_resnet — the flagship, run first of the paths:
   ``apex_tpu_torch.examples.imagenet_main_amp`` at its defaults with
   ``--sync_bn`` (ResNet-50, 224x224, 1000 classes, B 256, amp O2,
   ``chain(add_decayed_weights(1e-4), sgd(lr_schedule, 0.9))``), DDP and
   SyncBatchNorm over an NCCL group of one rank (NCCL takes one rank a
   GPU); no kernel of the port is on this path (convs are cuDNN's,
   SyncBatchNorm plain PyTorch, as the JAX step's are lax.conv and jnp):
   (a) 10 steps through ``train()`` on pre-made synthetic batches
       (``prefetch_to_device``: pinned memory, a side stream), every
       loss finite; images/s (median of steps 1-9, CUDA events between
       the steps' starts), peak memory; one more step under
       ``torch.profiler``: busy ms, launches, idle share;
   (b) O2 against O0 (TF32 off) from the same weights and batches, B 32,
       3 steps: losses within 2e-2 at every step;
   (c) the overflow step (an inf planted in the data with ``fill_``) on
       (b)'s O2 state under ``set_sync_debug_mode("error")``: forward,
       backward, DDP all-reduce and SGD step; params and the SGD state,
       the schedule's count included, keep every bit, the scale halves;
   (d) two processes on the one card over gloo (CUDA tensors), each half
       of a batch of 4 through the dry run's model in fp32: SyncBatchNorm's
       forward, its running statistics and the DDP-reduced gradients
       equal this process's full batch within 2e-5 scale-aware;
   (e) ``entry.dryrun(1)`` over the NCCL group, 3 steps, against the same
       step on plain Adam (no kernel): O0 losses <= 1e-4 relative, O2
       within 2e-2; its ZeRO-1 and ZeRO-2 runs on NCCL's own
       collectives end with its DDP run's params bit for bit (the dry
       run raises otherwise); B1 launched exactly three times a step,
       once a run (path ``dryrun``);
   (f) after (a), the whole train state saved with ``utils.checkpoint``
       (bytes, save and restore seconds on the host clock) and restored
       into a freshly built twin; one more step from each on the same
       batch with ``--deterministic``: params, momentum, running
       statistics, scaler state and loss bit for bit;
   (g) ``--torch-weights`` from a torchvision-format ``.pt`` this phase
       writes from that state: the loaded model's logits equal the
       source model's bit for bit;
   (h) when PIL is installed (``importlib.util.find_spec``; the line
       says which), two steps of the twin on an ImageFolder tree of 512
       JPEGs the phase writes and removes: images/s beside the synthetic
       rate, losses finite.

9. train_o1 — GPT-2 small under amp O1 at B 8, S 1024 on B1-B6 (the
   op-level cast policy installed on the torch namespaces; LayerNorm's
   params the fp32 masters, everything else bf16):
   (a) ``train()``, 10 steps, counts at 0 just before and read just
       after (10 times the per-step counts): losses finite and within
       2e-2 of the kernel-free oracle at O1 (``_oracle_steps(cfg,
       "O1", ...)``);
   (b) O1 and O2 (``O1_TURNS``: (a)'s O1 run, then one O2 run of 10
       steps): tokens/s (median of steps 1-9) and peak memory of each;
   (c) the compute layout: LayerNorm's params enter B2/B3 uncast and
       fp32, every gradient fp32;
   (d) the overflow step under ``set_sync_debug_mode("error")`` over
       forward, backward and FusedAdam: p, m, v and the step counter
       keep every bit, the scale halves, no host sync;
   (e) one O1 and one O2 step under ``torch.profiler``: busy ms,
       launches, idle share;
   (f) each level's host costs: ``compute_variables`` with the
       norm-output hooks (ms a step), the patched calls one step makes,
       and one wrapper's cost against its original (``F.cross_entropy``,
       microseconds a call).
10. train_simple — ``apex_tpu_torch.examples.simple_main_amp.train()``
   at its defaults (O1, the synthetic 8192 x 784 data, 5 epochs, B 256,
   ``sgd(0.05)``): finite losses that fall; the same run at O0 from the
   same data and weights, each epoch's mean loss within 2e-2; a dtype
   probe (the first Linear runs bf16, ``F.cross_entropy`` computes in
   fp32 on bf16 logits, ``F.binary_cross_entropy`` is refused);
   samples/s (median of epochs 1-4); one O1 step under the profiler.
11. train_dcgan — ``apex_tpu_torch.examples.dcgan_main_amp.train()`` at
   its defaults (O1, B 64, 64x64, nz 100, base 64, 20 iterations, two
   models, two Adam optimizers, three loss scalers; no kernel of the
   port, counts read around it): (a) losses finite, images/s (median of
   iterations 1-19), peak memory; (b) each iteration's O0 step from the
   O1 run's state on the same batch: D's and G's losses within 2e-2,
   relative where the loss exceeds 1 (``DCGAN_TOL``), and the
   free-running O0 run's distance recorded; (c) an inf in the real
   batch: D's step skipped and scaler 0 halved, scalers 1 and 2 kept, G
   stepped; (d) one iteration under ``torch.profiler``.
12. train_gpt_remat — ``gpt_main_amp.train(remat=True)`` on GPT-2 small
   (B 8, S 1024, O2, flash, 10 steps), counts read around it (B2 and B4
   twice a block): losses, params and scaler bit for bit those of the
   same run without remat; peak memory and tokens/s of both.
13. train_gpt_dropout — GPT-2 small O2 flash with its configuration's
   dropout (0.1 hidden, 0.1 attention), ``deterministic=False``, step i
   keyed ``step_key(0, i)``, 3 steps: losses within 2e-2 of the
   kernel-free oracle (plain attention with the kernels' hash dropout,
   the plain threefry dropout); the same under remat bit for bit; both
   runs' counts exact.
14. train_bert_remat — ``bert_main_amp.train(remat=True)`` at the
   example's defaults with flash and dropout, 3 steps: bit for bit the
   run without remat; counts, peak memory, tokens/s.
15. adam_rest — FusedAdam on GPT-2 small's parameters: the tree layout
   bit for bit the flat one (one B1-multi launch a step, path
   ``adam_rest``), the grouped flat layout (no decay on ``bias|_ln``,
   ``max_grad_norm=1.0``) within 1e-6 of the tree one, ``update`` equal
   to ``step``, an overflowed step on both layouts keeping every bit
   under sync-debug "error", and the cut-down ``FP16_Optimizer`` over
   bf16 params for 3 steps, the second overflowed, sync-free.
16. hf_bert — ``utils.load_hf_bert`` on a BERT-large HuggingFace-named
   state dict made from a seed: conversion seconds, every key consumed,
   the loaded model's MLM and NSP logits through B2/B4 (fp32) within
   1e-4 of its plain path.
17. train_tp_zero — Megatron tensor parallelism and ZeRO at full width,
   the ranks as processes over gloo on the one card (CUDA tensors):
   (a) GPT-2 small at ``--tp 2`` (B 8, S 1024, flash): O0 2 steps
       within 1e-4 of one process's dense run from the same weights
       (losses relative, step-1 params scale-aware), O2 3 steps within
       2e-2; replicated params equal on both ranks; B4-B6 12 each and
       B1-multi 1 a rank a step (path ``train_tp``);
   (b) an inf in rank 1's gradient only: both ranks skip, keep every
       bit and halve the scale;
   (c) DDP, ZeRO-1 and ZeRO-2 on GPT-2 small with flat FusedAdam, half
       of B 8 a rank, 3 steps: both ZeRO runs end with DDP's master
       buffer bit for bit; each run's memory a rank by part of the step
       (paths ``train_zero1``, ``train_zero2``);
   (d) a ZeRO-1 and a ZeRO-2 step of the dry run over NCCL at a world
       of one under sync-debug "error".

18. train_sp — sequence parallelism, the ranks as processes over gloo on
   the one card (CUDA tensors), against one process's dense runs from
   the same weights and batches (TF32 off):
   (a) GPT-2 small at ``--sp 2`` (B 8, S 1024), ring and Ulysses: O0 2
       steps (losses <= 1e-4 relative, the step-1 gradients the
       optimizer takes <= 1e-4 scale-aware), O2 3 steps within 2e-2;
       tokens/s for the pair, peak memory a rank, the collectives a
       step (calls of ``torch.distributed``), launches exact (B2/B3 25
       a step; B4-B6 12 a step for Ulysses, for the ring 12 on rank 0,
       whose second hop is skipped, and 24 on rank 1; B1 1; paths
       ``train_sp_ring``, ``train_sp_ulysses``);
   (b) long context: GPT-2 small at S 8192, B 1, ``--sp 2`` ring, O2 2
       steps within 2e-2 of one dense process; the peak a rank beside
       the dense process's (path ``train_sp_long``);
   (c) BERT-large at ``--ring-attention 2`` (B 8, S 512), ring and
       Ulysses: O0 1 step (loss <= 1e-4 relative, the gradients of the
       embeddings' LayerNorm, layers 0 and 23 and the heads <= 1e-4
       scale-aware), O2 2 steps within 2e-2; launches exact (B2/B3 50,
       B4-B6 48 ring and 24 Ulysses a step; paths
       ``train_sp_bert_ring``, ``train_sp_bert_ulysses``);
   (d) GPT-2 small at ``--tp 2`` and dp 2 (four processes, B 2 a data
       index, O2, 2 steps): ZeRO-1 over the tree moments
       (``like_params``) ends bit for bit with the moments whole; moment
       bytes a rank (half), peak memory (path ``train_sp_zero``).
   The kernels phase holds the call modes these paths give the flash
   kernels at a ring hop's 8 x 512 x 12 x 64 bf16 (``_sp_hop_rows``:
   B4 with the lse on the causal diagonal and an unmasked hop, the
   two-hop merge against one call, a fully masked row's lse, B5/B6
   with an lse cotangent, B4d-B6d at a hop's row offset), each against
   its plain version; the JSON line carries them as ``sp_hop``.

19. train_pp — pipeline parallelism, the ranks as processes over gloo
   on the one card (CUDA tensors), each rank one stage of
   ``models.PipelinedBert`` through ``bert_main_amp``: ``train(...,
   pp=2, pp_schedule=, pp_microbatches=)`` for the O2 runs, its
   ``build`` and ``train_step`` where a step's gradients or params are
   read, against one
   process's dense ``BertForPreTraining`` from the same seed (each
   rank's stage the dense layers ``r * 12 + i``), TF32 off; its first
   line is the prediction (``PP_PREDICTION``) written before any chip
   reading (its ``r2_*`` entries before the second round's):
   (a) BERT-large at ``--pp 2`` (B 32, S 128, M 4, flash attention),
       GPipe and 1F1B: O0 2 steps (losses <= 1e-4 relative, step-1
       gradients of the embeddings' LayerNorm, the first and last
       layer of each stage and the heads <= 1e-4 scale-aware), GPipe
       against 1F1B params after step 1 <= 1e-5, O2 3 steps within
       2e-2; step ms, tokens/s for the pair, peak a rank, collective
       calls a step, launches exact (``_pp_launches``: 1F1B runs the
       stage forward twice but on the last stage, and the heads on the
       last stage only; paths ``train_pp_gpipe``, ``train_pp_1f1b``);
   (b) O2 at M 4 (B 32; (a)'s O2 run) and M 8 (B 64, 2 steps), a
       microbatch of 8 rows: GPipe's
       peak a rank grows with M, 1F1B's by less than ``PP_MEM_1F1B_GB``;
       the schedule's own memory (``_PipeMemory``): GPipe's held at its
       return grows with M, 1F1B's peak inside it by less than
       ``PP_PIPE_1F1B_GB`` and a quarter of GPipe's growth;
   (c) dp 2 x pp 2, four processes, 16 rows a data index: one O0 step of
       each schedule (the gradients the data group's mean, the losses
       the data index's, their mean) against the dense process on the
       32 rows;
   (d) dropout 0.1 (hidden and attention, the flash kernels' dropout
       branches and threefry on the stage key chain): 1F1B's gradients
       within 1e-5 of GPipe autodiff's at the same key, launches exact
       (path ``train_pp_dropout``);
   (e) GPT-2 small's ``PipelinedGPT`` at pp 2 (B 8, S 1024, M 4), 1F1B
       with skewed padding (``PP_GPT_LENS``), O0: the loss within 1e-4
       of the dense masked ``lm_loss``, the tied ``wte`` gradient within
       1e-4 scale-aware, launches exact (path ``train_pp_gpt``).
   The kernels phase times B4, B5 and B6 at one microbatch of (a),
   8 x 128 x 16 x 64 bf16 (``_pp_mb_rows``), against their plain
   versions and SDPA; the JSON line carries them as ``pp_microbatch``.

20. train_sp_compose — sequence parallelism composed with the other
   axes, four processes over gloo on the one card (CUDA tensors), TF32
   off, against one process's dense runs from the same
   seed; its first line is the prediction (``C_PREDICTION``) written
   before any chip reading:
   (a) BERT-large ``--pp 2 --ring-attention 2`` (dp 1 x sp 2 x pp 2, B
       16, S 512, M 4): GPipe with ring and 1F1B with Ulysses, O0 2
       steps through ``build``/``train_step`` (losses <= 1e-4
       relative, step-1 gradients <= 1e-4 scale-aware, GPipe against
       1F1B params after step 1 <= 1e-5) and O2 2 steps through
       ``train(..., pp=2, sp=2)`` (within 2e-2); step ms, tokens/s for
       the four, peak a rank and the four's sum, collective calls a
       step, launches exact (``_compose_launches``: the ring's two
       flash calls an attention, Ulysses' one; paths
       ``train_pp_sp_gpipe_ring``, ``train_pp_sp_1f1b_ulysses``); 1F1B
       with ring exits with the JAX example's message;
   (b) dropout 0.1 through ``PipelinedBert`` with Ulysses: 1F1B's
       gradients within 1e-5 of GPipe autodiff's at one key (B4d-B6d
       and threefry on the sequence-folded key chain; path
       ``train_pp_sp_dropout``);
   (c) GPT-2 small's ``PipelinedGPT`` at sp 2 x pp 2 (B 8, S 1024, M 4):
       1F1B with causal Ulysses at O0, the loss within 1e-4 relative
       and the tied ``wte`` gradient within 1e-4 scale-aware of the
       dense model's; GPipe with causal ring, the logits within 2e-4
       scale-aware of the dense final hidden states' through the rank's
       ``wte``; launches exact (path ``train_pp_sp_gpt``);
   (d) GPT-2 small ``--sp 2 --tp 2`` (dp 1, B 8, S 1024), Ulysses and
       ring, in (a)-(c)'s world of four: O0 2 steps through
       ``gpt_main_amp``'s ``build``/
       ``train_step`` with DDP over the ``"data_sp"`` group (losses <=
       1e-4 relative, params after step 1 <= 1e-4 scale-aware of the
       dense step's, sliced as the rank's), O2 2 steps through
       ``gpt_main_amp.train(tp=2, sp=2)`` within 2e-2; tokens/s for the
       four, peak a rank, collectives a step, launches exact (paths
       ``train_gpt_sp_tp_ulysses``, ``train_gpt_sp_tp_ring``).
   The kernels phase times B4, B5 and B6 at the shapes these paths give
   them (``COMPOSE_SHAPES``): a pipelined ring hop 4 x 256 x 16 x 64
   with its keys' padding mask, the pipelined Ulysses attention 4 x 512
   x 8 x 64, and ``--sp --tp``'s Ulysses attention 8 x 1024 x 3 x 64
   causal, each against its plain version and SDPA; the JSON line
   carries them as ``compose_mode``.

21. train_tp_pp — tensor parallelism inside the pipeline and ZeRO over
   FusedLAMB, four processes over gloo on the one card (CUDA tensors),
   TF32 off; its first line is the prediction (``T_PREDICTION``)
   written before any chip reading:
   (a) BERT-large ``PipelinedBert(tp_axis="model")`` at dp 1 x tp 2 x pp
       2 (B 16, S 512, M 4; 8 heads a rank), GPipe and 1F1B through
       ``bert_main_amp.train_step`` with the recipe's FusedLAMB over the
       pipe and model groups (``with_model_parallel``,
       ``with_tensor_parallel``): O0 2 steps against one dense process
       (losses <= 1e-4 relative, step-1 gradients of ``PP_GRADS``'
       leaves, sliced as the rank's, <= 1e-4 scale-aware, GPipe against
       1F1B params after step 1 <= 1e-5), O2 2 steps within 2e-2 of the
       dense O2 run; step ms, tokens/s for the four, peak a rank,
       collectives a step, launches exact (train_pp's formula; paths
       ``train_tp_pp_gpipe``, ``train_tp_pp_1f1b``);
   (b) GPT-2 small's ``PipelinedGPT`` (vocabulary padded to 50432) at tp
       2 x pp 2 (B 8, S 1024, M 4), 1F1B at O0: the loss within 1e-4
       relative and the rank's vocab rows of the tied ``wte`` gradient
       within 1e-4 scale-aware of the dense model's; launches exact
       (path ``train_tp_pp_gpt``);
   (c) ZeRO over FusedLAMB on BERT-large at dp 2 x pp 2 (B 16 a data
       index, S 128, M 4), GPipe, O2, 3 steps: the losses within 2e-2
       of the replicated-state run's and the fp32 params after the last
       step (``T_ZERO_PARAMS``' leaves) within 1e-5 scale-aware, LAMB's
       state bytes a rank under 0.6 of the replicated run's, the peak a
       rank of each; launches exact (path ``train_zero_lamb``).
   The kernels phase times B4, B5 and B6 at the shapes these paths give
   them (``COMPOSE_SHAPES``' ``tp_pp_bert`` 4 x 512 x 8 x 64 and
   ``tp_pp_gpt`` 2 x 1024 x 6 x 64 causal) and B4d-B6d at the first with
   model rank 1's head offsets (0, 0, 8, 16), each against its plain
   version and SDPA.  To keep the whole script near 1000 s,
   ``train_sp_compose``'s O2 legs and ``train_sp`` (b) and (c)'s run 2
   steps, not 3, and ``train_pp`` (b)'s M 4 peaks are read from (a)'s
   O2 runs (the same call) instead of two runs of their own.  To make
   room for ``train_moe``, ``train_sp_compose`` (d) runs in (a)-(c)'s
   world of four (one spawn, not two), the dense references two phases
   share run once a run (``_shared``), every BERT-large build of the
   spawned ranks of ``train_sp``, ``train_pp``, ``train_sp_compose``,
   ``train_tp_pp`` and ``train_moe`` loads its seed-0 weights (drawn
   once a run, ``_seed0_bert_large``; ``train_moe``'s from (a)'s O0
   model) from the card over CUDA IPC (``_spawn_seed0``) instead of
   drawing them, and ``_profile`` traces the card's kernels alone (the
   host's ops were never read).

22. train_moe — Switch-MoE (``models.MoEMlp``) in BERT-large's layers,
   TF32 off; its first line is the prediction (``M_PREDICTION``):
   (a) one process, ``bert_main_amp``'s ``build`` and ``train_step``
       for ``--config large --moe 8 --moe-dispatch capacity`` (factor
       1.25) at B 32, S 128, O2 with the recipe's FusedLAMB, flash
       attention, 3 steps: finite losses, step ms, tokens/s, the peak,
       launches exact (``train_bert``'s formula without dropout: the MoE
       adds no launch of B2-B6), the router fp32 and the experts bf16 in
       the compute layout, one more step under ``torch.profiler``; at
       O0 and B 16 one forward of the seed-0 model in capacity dispatch
       at factor 8 (nothing drops) against dense dispatch: the logits
       within 1e-5 scale-aware, the aux within 1e-6 relative (the dense
       logits saved for (b));
   (b) two processes over gloo on the one card, ``--moe 8 --pp 2`` (M
       4, B 16, S 128, O0, 2 steps through ``build``/``train_step``,
       each pipe rank's seed-0 weights loaded from (a)'s O0 model over
       CUDA IPC; run before (a)'s O2 steps),
       both dispatches: 1F1B against GPipe, the losses within 1e-5
       relative, every step-1 gradient within rtol 3e-4 / atol 1e-5,
       every stage's router gradient nonzero, launches exact (paths
       ``train_moe_pp_gpipe``, ``train_moe_pp_1f1b``); GPipe's dense
       logits within 1e-4 of (a)'s;
   (c) in the same world, EP at ep 2: one MoE layer at BERT-large width
       (E 8, 4096 tokens), both dispatches, against the replicated layer
       on each rank: out and the gradients of x, the router and the
       rank's experts within 1e-5 scale-aware, aux within 1e-6, the
       expert bytes a rank half.

The dense references two phases share (GPT-2 small's ``--tp`` runs of
``train_tp_zero`` and ``train_sp_compose`` (d), BERT-large's B 16, S 512
runs of ``train_sp_compose`` and ``train_tp_pp``) are computed once a
run (``_shared``; a phase run alone computes its own), their files kept
under ``chiprun_out/chip_smoke/`` until the run ends; each call's
seconds are a ``dense_reference`` line.

The O1 phases run last, and each ends by removing the policy, resetting
amp's state and checking every patched function is its original again.
When every phase runs, every kernel of the JSON line must have been
launched by some path.  The ``done`` line gives the seconds of each
phase.

The line before the last is ``{"kernels": [...]}``; before it, the
card's name and power limit as nvidia-smi prints them; the last line is
``{"ok": true, "device": {...}}``.  Longer records go to
``chiprun_out/chip_smoke/``.
"""

import functools
import importlib
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT_DIR = REPO / "chiprun_out" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_FLOPS = {"float32": 67e12,    # fp32 on the CUDA cores
              "bfloat16": 989e12,  # dense bf16 tensor cores
              # 32-bit integer add, shift and logic: 64 results a clock
              # an SM (the CUDA programming guide's throughput table,
              # compute capability 9.0) x 132 SMs x the 1.98 GHz boost
              "int32": 64 * 132 * 1.98e9}
# 32-bit integer instructions in SASS (opcode before its first dot):
# adds, multiply-adds, shifts, logic, compares, selects, byte permutes
SASS_INT_OPCODES = frozenset((
    "IADD3", "IADD", "VIADD", "IMAD", "LEA", "SHF", "LOP3", "ISETP", "SEL",
    "PRMT", "IABS", "IMNMX", "POPC", "FLO", "BREV", "BMSK", "SGXT"))
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# per-row bound on the bf16 flash forward's o and on its dq
# (``row_err``): the scale-aware 2e-2 is relative to the tensor's largest
# value, which a causal row 0 (o = v[0]) sets well above a late row's,
# so alone it can pass a fault of ~20% on the late rows.  fp32 keeps
# its scale-aware 2e-5, which is already tighter than any row's
# rounding noise.
ROW_TOL = 1e-2
ROW_EPS = 1e-2
ADAM_TOL = 1e-6
NEAR_TIE_GAP = 1e-3
# launches a kernel timing takes the median of: each is timed alone
# between CUDA events behind a spin, so 15 give a stable median, and the
# kernels phase's ~500 timings stay a small part of the script
TIMED_LAUNCHES = 15
TIMED_LAUNCHES_LARGE = 6  # training-size shapes (ms each)
# timed passes a serve leg: one, so the offload and transport legs of
# serve_features fit in the script's time (the tokens and launches of a
# timed pass are checked on every pass, timed or not)
TIMED_SERVE_PASSES = 1
PROGRAMS_TIMED_PASSES = 1
# injected card OOMs, call numbers a method: serve (b)'s decode launches
# and serve_features (c)'s first chunk and second verify launch
DECODE_OOM_AT = {"decode_sampled": (2, 3)}
OOM_AT = {"chunk_prefill_sampled": (1,), "verify_sampled": (2,)}
# the server's default layers that serve, serve_q8 and serve_programs
# turn off, so their launch and step checks read the paths they did
LAYERS_OFF = dict(enable_prefix_cache=False, enable_speculation=False,
                  enable_overload=False)

# the int8 serving path: GPT-2 small's pool block at 16 tokens (int8 K/V
# and their fp32 scales), the equal-bytes arms and their agreement gate
Q8_BYTES_PER_BLOCK = 2 * 12 * 16 * 12 * 64 + 2 * 12 * 16 * 12 * 4
EQUAL_BYTES_BF16_BLOCKS = 129
EQUAL_BYTES_SLOTS = 16
Q8_AGREEMENT_MIN = 0.75
SPIN_CYCLES = 2_000_000   # ~1 ms at the H100's clock
L2_FLUSH_BYTES = 64 << 20  # more than the H100's 50 MB L2

# the training path: examples/gpt/main_amp.py --config small --flash
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 1024, 3e-4
TP, TP_HEADS = 2, 6       # --tp 2: each rank 6 of GPT-2 small's 12 heads
O0_BATCH, O0_STEPS, O2_STEPS = 2, 3, 10
O0_TOL = 1e-4             # loss relative, step-1 grads scale-aware
O2_LOSS_TOL = 2e-2        # absolute, every step

# the BERT path: examples/bert/main_amp.py --config large (B 32, S 128,
# FusedLAMB(lr=1e-4, max_grad_norm=1.0)) with flash attention and the
# default dropout 0.1, inside the kernels for attention
BERT_BATCH, BERT_SEQ, BERT_LR = 32, 128, 1e-4
BERT_HIDDEN, BERT_HEADS, BERT_LAYERS = 1024, 16, 24
DROPOUT = 0.1
BERT_O0_BATCH = 2


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def scale_aware_err(a, b):
    a = a.float()
    b = b.float()
    max_abs = (a - b).abs().max().item()
    return max_abs / (b.abs().max().item() + 1.0), max_abs


def row_err(a, b, eps=ROW_EPS):
    """Largest error of one row (the head dim) against that row's own
    size: max over rows of ||a_r - b_r|| / (||b_r|| + eps).  ``eps``
    keeps a row that is zero up to rounding in exact arithmetic (a fully
    masked row, the dq of a row with one live key) from dividing noise
    by noise; it is a twentieth of the smallest live row's norm (~0.2)
    that these unit-variance inputs give o and dq at S 1024."""
    a = a.float()
    b = b.float()
    return ((a - b).norm(dim=-1) / (b.norm(dim=-1) + eps)).max().item()


def median_ms(fn, iters=TIMED_LAUNCHES, warmup=5, flush=None):
    """Median device time of ``fn`` over ``iters`` launches, each between
    two CUDA events.  A ~1 ms spin kernel is queued before each start
    event, so the host has enqueued all of ``fn``'s work before the
    device reaches it: the events bracket device time, not the host's
    launch overhead.  ``flush`` (see ``l2_flush``), when given, runs
    before each spin, outside the events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def l2_flush():
    """A function that leaves the card's 50 MB L2 holding none of a timed
    kernel's inputs: it writes a 64 MB buffer (every line replaced),
    then reads another 64 MB (the written lines go back to memory there,
    not during the timed launch).  ``cold_ms`` readings use it; the
    warm ``ms`` relaunches on inputs the last launch left in L2."""
    import torch
    written = torch.empty(L2_FLUSH_BYTES // 4, device="cuda")
    read = torch.zeros_like(written)

    def flush():
        written.zero_()
        read.sum()
    return flush


def kineto_launch(fn, fragment):
    """What ``torch.profiler`` records of the launch of the kernel whose
    name holds ``fragment`` in one call of ``fn``: grid, block, registers,
    blocks and warps an SM, and Kineto's estimate of the achieved
    occupancy (worked out from the launch, not read from a counter)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / "kineto_launch.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    args = next((e["args"] for e in events if e.get("cat") == "kernel"
                 and fragment in e.get("name", "")), None)
    if args is None:
        # a diagnostic only: the profiler traced no kernel of this launch
        # (CUPTI gave no device events on this machine)
        return {"recorded": False}
    return {key: args.get(key) for key in (
        "grid", "block", "registers per thread", "blocks per SM",
        "warps per SM", "est. achieved occupancy %")}


def bound(nbytes, flops, dtype):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


# -- phases ------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    emit("device", name=name,
         capability=list(torch.cuda.get_device_capability(0)),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, nvidia_smi=smi_line)
    # fp32 matmuls in full fp32 wherever parity is checked
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name, smi_line


# the bf16 tensor-core kernels: the fragment of their mangled names and
# the C entry point that returns their dynamic shared memory
WGMMA_KERNELS = (("flash_fwd_kernel_wgmma", "apex_flash_fwd_wgmma_smem"),
                 ("flash_bwd_dq_kernel_wgmma",
                  "apex_flash_bwd_dq_wgmma_smem"),
                 ("flash_bwd_dkv_kernel_wgmma",
                  "apex_flash_bwd_dkv_wgmma_smem"))


# B2's fast path, B3's three kernels and the split decode body, by their
# name in the mangled symbol, and how many instantiations they have
# (B2 and B3: x and weight, fp32 or bf16; the column sums: the weight;
# decode: fp32/bf16 and its int8 flag)
PTXAS_KERNELS = ("layer_norm_fwd_kernel", "layer_norm_bwd_kernel",
                 "layer_norm_bwd_generic_kernel",
                 "layer_norm_bwd_colsum_kernel", "decode_attention_kernel")
PTXAS_INSTANTIATIONS = 4 + 4 + 4 + 2 + 4
# mangled template arguments: fp32, bf16, a bool flag, an int; a
# substitution (S_, S0_, ...) repeats an earlier class-type argument, and
# the kernels' only class-type argument is __nv_bfloat16
TEMPLATE_ARG = r"f|13__nv_bfloat16|S\d*_|Lb[01]E|Li\d+E"


def _template_arg(tok):
    if tok == "f":
        return "float"
    if tok.startswith(("13", "S")):
        return "bfloat16"
    if tok.startswith("Lb"):
        return "true" if tok == "Lb1E" else "false"
    return tok[2:-1]


def _ptxas(log, fragments):
    """``ptxas -v``'s registers, spills and static shared memory of each
    instantiation of the named kernels, as ``name<template args>``."""
    arg = re.compile(TEMPLATE_ARG)
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = None
            for frag in fragments:
                at = ln.find(f"{len(frag)}{frag}I")
                if at < 0:
                    continue
                rest, args = ln[at + len(f"{len(frag)}{frag}I"):], []
                while (m := arg.match(rest)) is not None:
                    args.append(_template_arg(m.group(0)))
                    rest = rest[m.end():]
                name = f"{frag}<{', '.join(args)}>"
                out[name] = {}
        elif name and "spill" in ln:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", ln)
            out[name].update(spill_stores=int(st), spill_loads=int(ld))
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem_bytes"] = int(smem.group(1)) if smem else 0
            name = None
    return out


def phase_build():
    from apex_tpu_torch._kernels import build_library, library
    t0 = time.perf_counter()
    lib = build_library()
    cdll = library()
    secs = time.perf_counter() - t0
    log = (lib.parent / "build.log").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "build.log").write_text(log)
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    import ctypes
    wgmma = _ptxas(log, [frag for frag, _ in WGMMA_KERNELS])
    if len(wgmma) != 2 * len(WGMMA_KERNELS):
        raise AssertionError(f"build: wgmma kernels missing from the ptxas "
                             f"report: {sorted(wgmma)}")
    for name, row in wgmma.items():  # the dynamic bytes a launch asks for
        fn = getattr(cdll, dict(WGMMA_KERNELS)[name.split("<")[0]])
        fn.restype = ctypes.c_int
        row["dynamic_smem_bytes"] = fn()
    redesigned = _ptxas(log, PTXAS_KERNELS)
    if len(redesigned) != PTXAS_INSTANTIATIONS:
        raise AssertionError(f"build: redesigned kernels missing from the "
                             f"ptxas report: {sorted(redesigned)}")
    emit("build", seconds=round(secs, 3), library=str(lib.relative_to(REPO)),
         wgmma_kernels=wgmma, redesigned_kernels=redesigned,
         threefry_sass_int_ops=threefry_int_ops(), ptxas=ptxas[:24])


_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                        r"([A-Z0-9_.]+)\s*(.*?);")


def _loop_int_ops(sass):
    """The integer instructions a thread issues for one trip round the
    last loop of one function's SASS: from the target of its backward
    branch to the branch, leaving out a block that a predicated forward
    branch jumps over when the block only calls a slow path (the IEEE
    division's).  A divergent warp issues both sides of every other
    branch, so they count."""
    ins = []
    for ln in sass.splitlines():
        m = _SASS_LINE.match(ln)
        if m:
            tgt = re.search(r"0x([0-9a-f]+)", m.group(4))
            ins.append((int(m.group(1), 16), m.group(3), bool(m.group(2)),
                        int(tgt.group(1), 16) if tgt else None))
    end, _, _, start = [i for i in ins if i[1].startswith("BRA")
                        and i[3] is not None and i[3] < i[0]][-1]
    body = [i for i in ins if start <= i[0] <= end]
    count, skip_to = 0, -1
    for at, op, pred, tgt in body:
        if at < skip_to:
            continue
        count += op.split(".")[0] in SASS_INT_OPCODES
        if op.startswith("BRA") and pred and tgt is not None and tgt > at:
            between = [o for a, o, _, _ in body if at < a < tgt]
            if any(o.startswith("CALL") for o in between) and not any(
                    o.startswith("BRA") for o in between):
                skip_to = tgt
    return count


@functools.lru_cache(maxsize=None)
def threefry_int_ops():
    """The threefry dropout kernel's integer instructions an element, by
    x's dtype, counted with ``cuobjdump -sass`` in the built library's
    machine code (its grid-stride loop takes one element a trip): the
    operation count of its bound."""
    from apex_tpu_torch._kernels import build
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run(
        [str(cuobjdump if cuobjdump.is_file() else "cuobjdump"), "-sass",
         str(build.build_library())], capture_output=True, text=True,
        check=True, timeout=300).stdout
    out = {}
    for sec in re.split(r"(?=\n\s*Function : )", sass):
        # the whole-stream loop (kWindow false), as the phase times it
        m = re.search(r"Function : (\S*threefry_dropout_kernelI(\w+?)"
                      r"Lb0E\S*)", sec)
        if m:
            dt = "float32" if m.group(2) == "f" else "bfloat16"
            out[dt] = _loop_int_ops(sec)
    if sorted(out) != ["bfloat16", "float32"]:
        raise AssertionError(f"build: threefry_dropout_kernel's SASS not "
                             f"found for both dtypes: {sorted(out)}")
    return out


def _check(name, dtype, got, want, tol=None):
    tol = TOL[dtype] if tol is None else tol
    rel, max_abs = scale_aware_err(got, want)
    if not rel <= tol:
        raise AssertionError(f"{name} [{dtype}]: scale-aware error {rel:.3g} "
                             f"> {tol}")
    return rel, max_abs


def _check_rows(name, dtype, got, want):
    """The per-row bound in bf16 (``row_err``); None in fp32."""
    if dtype != "bfloat16":
        return None
    err = row_err(got, want)
    if not err <= ROW_TOL:
        raise AssertionError(f"{name} [{dtype}]: row error {err:.3g} > "
                             f"{ROW_TOL} (scale-aware "
                             f"{scale_aware_err(got, want)[0]:.3g})")
    return err


def _dt(dtype):
    return str(dtype).split(".")[1]


def _design(dt):
    """Which body a flash row timed: bf16 B4, B5 and B6 (and their
    dropout branches) run on the tensor cores, fp32 on the CUDA cores."""
    return "wgmma" if dt == "bfloat16" else "cuda_cores_fp32"


def _check_rows_all(name, dtype, got, want):
    """``_check_rows`` over each output (dk and dv for B6): the largest
    row error, None in fp32."""
    errs = [_check_rows(name, dtype, a, b) for a, b in zip(got, want)]
    return None if errs[0] is None else max(errs)


def _ln_cases(torch, shapes, o1_shapes):
    """(x dtype, weight dtype, (n1, n2)): fp32 and bf16 at ``shapes`` with
    the weights in x's dtype (O0 and O2 hold LayerNorm's params so), then
    bf16 x with fp32 weights at ``o1_shapes`` (O1 keeps norm layers'
    params fp32)."""
    return ([(dt, dt, shape) for dt in (torch.float32, torch.bfloat16)
             for shape in shapes]
            + [(torch.bfloat16, torch.float32, shape)
               for shape in o1_shapes])


# the training shapes that run LayerNorm with bf16 x and fp32 weights
# under O1: GPT-2 small's (8 x 1024 tokens of 768) and a BERT-large one
LN_O1_SHAPES = ((TRAIN_BATCH * TRAIN_SEQ, 768),
                (BERT_BATCH * BERT_SEQ, BERT_HIDDEN))
# no PyTorch call takes that pairing on the card: F.layer_norm and
# native_layer_norm_backward raise "expected scalar type BFloat16 but
# found Float" (PyTorch 2.11, CUDA 12.8); the row of the same shape with
# bf16 weights times them
LN_NO_LIBRARY = ("none: F.layer_norm and native_layer_norm_backward "
                 "refuse bf16 x with fp32 weights on the card")


def _ln_variants(torch):
    """B2 at the paths' shapes: decode and a prefill bucket (fp32, as
    served), the GPT and BERT training steps in bf16 (O2) and fp32 (O0),
    the weights in x's dtype as O0 and O2 hold them, and the two
    training steps with bf16 x and fp32 weights as O1 holds them
    (``LN_O1_SHAPES``, with the kernel's launches in one O1 GPT step),
    against the plain version (y 2e-5 / 2e-2 scale-aware by x's dtype,
    mean and invvar 2e-5).  ``F.layer_norm`` gets the same weights, so
    no cast falls inside its timed window; it refuses the O1 pairing
    (``LN_NO_LIBRARY``).  At the bf16 training shapes
    with bf16 weights both are also timed with L2 flushed before each
    launch (``cold_ms``, ``library_cold_ms``: the bound share is read
    from those), beside the same bytes through one ``copy_`` of x into y
    with L2 flushed (``copy_cold_ms``: what the card's own streaming copy
    takes for them), the fast path's launch as ``torch.profiler`` records
    it (``launch``) and the rows its busiest warp walks
    (``rows_per_warp``)."""
    import torch.nn.functional as F
    from apex_tpu_torch.models import gpt_small
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    flush = l2_flush()
    out = []
    # decode, a prefill bucket, a GPT training step (8 x 1024 tokens of
    # 768), a BERT-large one (32 x 128 tokens of 1024)
    for dtype, wdtype, (n1, n2) in _ln_cases(
            torch, ((8, 768), (256, 768), (TRAIN_BATCH * TRAIN_SEQ, 768),
                    (BERT_BATCH * BERT_SEQ, BERT_HIDDEN)), LN_O1_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(n1)
        x = torch.randn(n1, n2, device="cuda", generator=g).to(dtype)
        w = (1 + 0.1 * torch.randn(n2, device="cuda", generator=g)) \
            .to(wdtype)
        b = (0.1 * torch.randn(n2, device="cuda", generator=g)).to(wdtype)

        def kernel():
            return ln.layer_norm_fwd(x, w, b, 1e-5)

        def plain():
            xhat, mean, invvar = ln._ln_forward_plain(x, 1e-5)
            return (xhat * w.float() + b.float()).to(dtype), mean, invvar

        def library():
            return F.layer_norm(x, (n2,), w, b, 1e-5)

        dt, wdt = _dt(dtype), _dt(wdtype)
        got = kernel()
        y, mean, invvar = got
        py, pmean, pinvvar = plain()
        rel, max_abs = _check("layer_norm_fwd", dt, y, py)
        for a, want in ((mean, pmean), (invvar, pinvvar)):
            r, m = _check("layer_norm_fwd stats", "float32", a, want)
            rel, max_abs = max(rel, r), max(max_abs, m)
        del py, pmean, pinvvar
        iters = TIMED_LAUNCHES if n1 <= 256 else TIMED_LAUNCHES_LARGE
        isz = x.element_size()
        # x read and y written; w, b read; mean, invvar written
        nbytes = 2 * n1 * n2 * isz + 2 * n2 * w.element_size() + 2 * n1 * 4
        bms, by = bound(nbytes, 8 * n1 * n2, "float32")
        row = {
            "shape": [n1, n2], "dtype": dt, "weight_dtype": wdt,
            "rel_err": rel, "max_abs_err": max_abs,
            "ms": median_ms(kernel, iters),
            "plain_ms": median_ms(plain, iters),
            "library_ms": None, "library": LN_NO_LIBRARY,
            "bound_ms": bms, "bound_by": by}
        if wdtype != dtype:
            row["launches_per_o1_gpt_step"] = _per_step_launches(
                gpt_small(), ("layer_norm_fwd",))["layer_norm_fwd"]
            out.append(row)
            continue
        row["library_ms"] = median_ms(library, iters)
        row["library"] = "F.layer_norm (the same x and weights)"
        if dtype == torch.bfloat16 and n1 > 256:
            row["cold_ms"] = median_ms(kernel, iters, flush=flush)
            row["library_cold_ms"] = median_ms(library, iters,
                                               flush=flush)
            row["cold_bound_share"] = bms / row["cold_ms"]
            y = torch.empty_like(x)
            row["copy_cold_ms"] = median_ms(lambda: y.copy_(x), iters,
                                            flush=flush)
            del y
            launch = row["launch"] = kineto_launch(kernel,
                                                   "layer_norm_fwd_kernel")
            # a diagnostic: absent where the profiler traced no launch
            if launch.get("grid") and launch.get("block"):
                warps = launch["grid"][0] * launch["block"][0] // 32
                row["rows_per_warp"] = -(-n1 // warps)
        out.append(row)
    return out


def _flash_variants(torch):
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    out = []
    d = 64
    for dtype in (torch.float32, torch.bfloat16):
        # serving prefills (B 1, a padding mask), then the training step
        # (B 8, no mask: the example's batches have no padding), then
        # one rank's 6 heads of it under --tp 2 (bf16, O2)
        for bsz, s, length, h in ((1, 16, 11, 12), (1, 100, 77, 12),
                                  (1, 256, 200, 12), (1, 1024, 1000, 12),
                                  (TRAIN_BATCH, TRAIN_SEQ, None, 12),
                                  (TRAIN_BATCH, TRAIN_SEQ, None, TP_HEADS)):
            if h == TP_HEADS and dtype != torch.bfloat16:
                continue
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v = (torch.randn(bsz, s, h, d, device="cuda", generator=g)
                       .to(dtype) for _ in range(3))
            mask = None if length is None else torch.where(
                torch.arange(s, device="cuda") < length, 0.0,
                -1e9)[None].float()
            scale = 1.0 / d ** 0.5

            def kernel():
                return fa.flash_attention(q, k, v, kv_mask=mask, causal=True,
                                          return_lse=True)

            def plain():
                return fa._reference(q, k, v, mask, True, scale,
                                     return_lse=True)

            dt = _dt(dtype)
            o, lse = kernel()
            po, plse = plain()
            rel, max_abs = _check("flash_fwd", dt, o, po)
            rows = _check_rows("flash_fwd", dt, o, po)
            r, m = _check("flash_fwd lse", "float32", lse, plse)
            rel, max_abs = max(rel, r), max(max_abs, m)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            if mask is None:
                def library():
                    return F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True)
            else:
                causal = torch.triu(torch.full((s, s), float("-inf"),
                                               device="cuda"), 1)
                sdpa_mask = (causal[None, None]
                             + mask[:, None, None, :]).to(dtype)

                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=sdpa_mask)
            isz = q.element_size()
            nbytes = bsz * (4 * s * h * d * isz + h * s * 4) + (
                0 if mask is None else s * 4)
            bms, by = bound(nbytes, 2 * bsz * h * s * s * d, dt)
            iters = TIMED_LAUNCHES if bsz == 1 else TIMED_LAUNCHES_LARGE
            out.append({
                "shape": [bsz, s, h, d], "dtype": dt,
                "design": _design(dt), "rel_err": rel,
                **({} if rows is None else {"row_err": rows}),
                "max_abs_err": max_abs,
                "ms": median_ms(kernel, iters),
                "plain_ms": median_ms(plain, iters),
                "library_ms": median_ms(library, iters),
                "bound_ms": bms, "bound_by": by})
    return out + _sp_hop_rows(torch, "fwd") + _pp_mb_rows(torch, "fwd")


# the bias patterns the decode rows are timed at: the engine's (random
# context lengths, -1e9 past them as the serving pool masks, an empty
# slot at position 0, the self slot live), every key live, and the same
# lengths masked at NEG_INF, whose masked keys the kernel does not read.
# A key is live when its bias is above NEG_INF / 2, the kernel's rule (a
# -1e9 key is read and weighted exactly 0).
DECODE_BIASES = ("engine", "all_live", "neg_inf_tail")


def _decode_bias(torch, pattern, lengths, t):
    if pattern == "all_live":
        return torch.zeros(lengths.numel(), t, device="cuda")
    masked = -1e9 if pattern == "engine" else -1e30
    pos = torch.arange(t, device="cuda")[None, :]
    bias = torch.where(pos < lengths[:, None], 0.0, masked).float()
    bias[:, -1] = 0.0
    return bias


# the decode shapes, (B, T, H, D), and the biases each is timed at: the
# serve path's 8 slots (serve, serve_q8 (a) and (b)) and serve_q8 (c)'s
# 16 (one split a (b, h) at both), and one long context at small B * H,
# whose splits the last block of a (b, h) combines, T above the limit the
# shared-memory score row once set
DECODE_SHAPES = (((8, 1025, 12, 64), DECODE_BIASES),
                 ((16, 1025, 12, 64), ("engine",)),
                 ((1, 20000, 12, 64), ("all_live",)))


def _split_sweep(da, kernel, check, t):
    """The kernel's time at every split count a 64-key tiling of ``t``
    keys allows (at most ``_MAX_SPLITS``), the wrapper's choice replaced
    for the call; each output is held against the plain version."""
    from unittest import mock
    n_tiles = -(-t // da._TILE)
    out = {}
    for splits in range(1, min(da._MAX_SPLITS, n_tiles) + 1):
        tiles = -(-n_tiles // splits)
        if -(-n_tiles // tiles) != splits:
            continue  # the same tiling as a smaller count
        with mock.patch.object(da, "_split", lambda *_: (tiles, splits)):
            check(kernel())
            out[str(splits)] = median_ms(kernel)
    return out


def _decode_rows(torch, quantized):
    """B7 (fp32/bf16 K/V) or B8 (int8 K/V from ``quantize_kv`` of random
    data, head 5 of K all zero: zero scales) at each of
    ``DECODE_SHAPES``, fp32 and bf16 compute, at the shape's biases:
    held against the plain version, B8 bit for bit against B7 on the
    dequantized K/V, and a second launch against the first.  Each row
    names the split count the wrapper chose; at a shape's first bias
    ``split_ms`` times every split count, each output held against the
    plain version.  ``bound_ms`` counts the K/V (and scale) bytes and
    operations of live keys and every bias, q and o byte;
    ``bound_all_keys_ms`` every key's."""
    import torch.nn.functional as F
    da = importlib.import_module("apex_tpu_torch.ops.decode_attention")
    kvq = importlib.import_module("apex_tpu_torch.ops.kv_quant")
    name = "decode_attention_q8" if quantized else "decode_attention"
    out = []
    for (b, t, h, d), patterns in DECODE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            out += _decode_shape_rows(torch, F, da, kvq, name, quantized,
                                      (b, t, h, d), patterns, dtype)
    return out


def _decode_shape_rows(torch, F, da, kvq, name, quantized, shape, patterns,
                       dtype):
    b, t, h, d = shape
    g = torch.Generator(device="cuda").manual_seed(8 if quantized else 7)
    q = torch.randn(b, 1, h, d, device="cuda", generator=g).to(dtype)
    if quantized:
        k, v = (torch.randn(b, t, h, d, device="cuda", generator=g)
                for _ in range(2))
        k[:, :, 5] = 0
        (kq, ks), (vq, vs) = kvq.quantize_kv(k), kvq.quantize_kv(v)
        del k, v
        kd, vd = (kvq.dequantize_kv(x, sc, dtype)
                  for x, sc in ((kq, ks), (vq, vs)))
        kv_args = (kq, vq)
        scales = {"k_scale": ks, "v_scale": vs}
    else:
        kd, vd = (torch.randn(b, t, h, d, device="cuda", generator=g)
                  .to(dtype) for _ in range(2))
        kv_args, scales = (kd, vd), {}
    lengths = torch.randint(1, t - 1, (b,), device="cuda", generator=g)
    lengths[0] = 0
    dt = _dt(dtype)
    isz = q.element_size()
    splits = da._split(q.device, b * h, t)[1]
    out = []
    for pattern in patterns:
        bias = _decode_bias(torch, pattern, lengths, t)
        scale = 1.0 / d ** 0.5
        label = f"{name} [{dt}, {b}x{t}, {pattern}]"

        def kernel():
            return da.cached_attention(q, *kv_args, kv_bias=bias, **scales)

        def plain():
            return da._reference(q, *kv_args, bias, scale, *scales.values())

        o = kernel()
        want = plain()
        rel, max_abs = _check(label, dt, o, want)
        if not torch.equal(o, kernel()):
            raise AssertionError(f"{label}: a second launch gave other "
                                 "bits")
        if quantized and not torch.equal(
                o, da.cached_attention(q, kd, vd, kv_bias=bias)):
            raise AssertionError(f"{label}: differs from B7 on the "
                                 "dequantized K/V")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, kd, vd))
        sdpa_mask = bias[:, None, None, :].to(dtype)
        live = int((bias > -5e29).sum())
        # per key pair: K and V rows (and two scales); two dot products
        # (and B8's widening multiply) per K/V element pair
        per_key = (2 * h * d + 2 * h * 4) if quantized else 2 * h * d * isz
        fixed = b * t * 4 + 2 * b * h * d * isz
        ops = (6 if quantized else 4) * h * d
        bms, by = bound(live * per_key + fixed, live * ops, dt)
        all_ms, _ = bound(b * t * per_key + fixed, b * t * ops, dt)
        sweep = {}
        if pattern == patterns[0]:
            sweep = {"split_ms": _split_sweep(
                da, kernel, lambda x: _check(label, dt, x, want), t)}
        out.append({
            "shape": [b, t, h, d], "dtype": dt, "bias": pattern,
            "splits": splits, **sweep,
            "live_key_share": live / (b * t), "rel_err": rel,
            "max_abs_err": max_abs, "repeat_bitwise": True,
            **({"b7_bitwise": True} if quantized else {}),
            "ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "library_ms": median_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=sdpa_mask)),
            **({"library": "SDPA on the dequantized K/V"}
               if quantized else {}),
            "bound_ms": bms, "bound_by": by,
            "bound_all_keys_ms": all_ms})
    return out


def _ln_bwd_variants(torch):
    """B3, the whole LayerNorm backward (dx, dgamma, dbeta in one call),
    at the GPT and BERT training shapes, fp32 and bf16, gamma in x's
    dtype as O0 and O2 hold it (O2 keeps LayerNorm's params in bf16, so
    dgamma and dbeta come back in bf16 there), and with bf16 x and fp32
    gamma as O1 holds it (dgamma and dbeta come back fp32; with the
    kernel's launches in one O1 GPT step), against the plain version (dx
    scale-aware 2e-5 / 2e-2 by x's dtype, dgamma and dbeta by gamma's)
    and bit for bit against a second launch.  Yardstick: PyTorch's
    ``native_layer_norm_backward`` asked for the same three outputs from
    the same gamma (it refuses the O1 pairing: ``LN_NO_LIBRARY``)."""
    from apex_tpu_torch.models import gpt_small
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    out = []
    train_shapes = ((TRAIN_BATCH * TRAIN_SEQ, 768),
                    (BERT_BATCH * BERT_SEQ, BERT_HIDDEN))
    for dtype, wdtype, (n1, n2) in _ln_cases(torch, train_shapes,
                                             LN_O1_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(11)
        x = (2 * torch.randn(n1, n2, device="cuda", generator=g) + 0.5) \
            .to(dtype)
        dy = torch.randn(n1, n2, device="cuda", generator=g).to(dtype)
        w = (1 + 0.1 * torch.randn(n2, device="cuda", generator=g)) \
            .to(wdtype)
        _, mean, invvar = ln._ln_forward_plain(x, 1e-5)

        def kernel():
            return ln.layer_norm_bwd(dy, x, mean, invvar, w)

        def plain():
            return ln._ln_backward_plain(dy, x, mean, invvar, w)

        b_lib = torch.zeros_like(w)   # dbias needs a bias tensor

        def library():
            # the same three outputs from the same saved statistics
            # (rstd = invvar)
            return torch.ops.aten.native_layer_norm_backward(
                dy, x, [n2], mean[:, None], invvar[:, None], w, b_lib,
                [True, True, True])

        dt, wdt = _dt(dtype), _dt(wdtype)
        got, want = kernel(), plain()
        rel, max_abs = _check("layer_norm_bwd dx", dt, got[0], want[0])
        wrel = 0.0
        for what, a, b in zip(("dgamma", "dbeta"), got[1:], want[1:]):
            if a.dtype != wdtype:
                raise AssertionError(f"layer_norm_bwd {what} [{dt}, {wdt}]: "
                                     f"{a.dtype}, not gamma's dtype")
            r, m = _check(f"layer_norm_bwd {what}", wdt, a, b)
            wrel, max_abs = max(wrel, r), max(max_abs, m)
        if not all(torch.equal(a, b) for a, b in zip(got, kernel())):
            raise AssertionError(f"layer_norm_bwd [{dt}, {wdt}]: a second "
                                 "launch gave other bits")
        del got, want
        isz, wsz = x.element_size(), w.element_size()
        # dy and x read, dx written; mean, invvar and gamma read; dgamma
        # and dbeta written (gamma, dgamma and dbeta in gamma's dtype)
        nbytes = 3 * n1 * n2 * isz + 2 * n1 * 4 + 3 * n2 * wsz
        bms, by = bound(nbytes, 15 * n1 * n2, "float32")
        row = {
            "shape": [n1, n2], "dtype": dt, "weight_dtype": wdt,
            "rel_err": rel,
            "weight_grad_rel_err": wrel, "max_abs_err": max_abs,
            "repeat_bitwise": True,
            "ms": median_ms(kernel, TIMED_LAUNCHES_LARGE),
            "plain_ms": median_ms(plain, TIMED_LAUNCHES_LARGE),
            "library_ms": None, "library": LN_NO_LIBRARY,
            "bound_ms": bms, "bound_by": by}
        if wdtype != dtype:
            row["launches_per_o1_gpt_step"] = _per_step_launches(
                gpt_small(), ("layer_norm_bwd",))["layer_norm_bwd"]
        else:
            row["library_ms"] = median_ms(library, TIMED_LAUNCHES_LARGE)
            row["library"] = "native_layer_norm_backward (dx, dgamma, dbeta)"
        out.append(row)
    return out


def _flash_bwd_variants(torch, which):
    """B5 (``which="dq"``) or B6 (``"dkv"``) at the training step's
    shape, and at a ragged padded one (fp32 and bf16).  The library
    yardstick is SDPA's backward, which computes dq, dk and dv together,
    so both kernels carry the same library time."""
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    kernel_fn = {"dq": fa.flash_attention_bwd_dq,
                 "dkv": fa.flash_attention_bwd_dkv}[which]
    plain_fn = {"dq": fa._bwd_dq_reference,
                "dkv": fa._bwd_dkv_reference}[which]
    out = []
    d = 64
    for dtype in (torch.float32, torch.bfloat16):
        for bsz, s, length, h in ((TRAIN_BATCH, TRAIN_SEQ, None, 12),
                                  (2, 100, 77, 12),
                                  (TRAIN_BATCH, TRAIN_SEQ, None, TP_HEADS)):
            if h == TP_HEADS and dtype != torch.bfloat16:
                continue
            g = torch.Generator(device="cuda").manual_seed(s + 1)
            q, k, v, do = (torch.randn(bsz, s, h, d, device="cuda",
                                       generator=g).to(dtype)
                           for _ in range(4))
            mask = None if length is None else torch.where(
                torch.arange(s, device="cuda") < length, 0.0,
                -1e9)[None].expand(bsz, s).float().contiguous()
            scale = 1.0 / d ** 0.5
            o, lse = fa._reference(q, k, v, mask, True, scale,
                                   return_lse=True)
            delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
                .contiguous()
            args = (q, k, v, do, lse, delta, mask, True, scale)

            def kernel():
                return kernel_fn(*args)

            def plain():
                return plain_fn(*args)

            dt = _dt(dtype)
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rel = max_abs = 0.0
            for a, b in zip(got, want):
                r, m = _check(f"flash_bwd_{which}", dt, a, b)
                rel, max_abs = max(rel, r), max(max_abs, m)
            rows = _check_rows_all(f"flash_bwd_{which}", dt, got, want)
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            dot = do.transpose(1, 2)
            if mask is None:
                so = F.scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=True)
            else:
                causal = torch.triu(torch.full((s, s), float("-inf"),
                                               device="cuda"), 1)
                so = F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=(causal[None, None]
                                           + mask[:, None, None, :]).to(dtype))

            def library():
                return torch.autograd.grad(so, (qt, kt, vt), dot,
                                           retain_graph=True)

            # causal pairs this input needs (all rows live: no row is
            # fully masked here)
            pairs = bsz * h * s * (s + 1) // 2
            isz = q.element_size()
            n_in = 4 * bsz * s * h * d * isz + 2 * bsz * h * s * 4
            n_out = (1 if which == "dq" else 2) * bsz * s * h * d * isz
            flops = (6 if which == "dq" else 8) * pairs * d
            bms, by = bound(n_in + n_out, flops, dt)
            iters = TIMED_LAUNCHES if bsz * s < 1024 else TIMED_LAUNCHES_LARGE
            out.append({
                "shape": [bsz, s, h, d], "dtype": dt,
                "design": _design(dt), "rel_err": rel,
                **({} if rows is None else {"row_err": rows}),
                "max_abs_err": max_abs,
                "ms": median_ms(kernel, iters),
                "plain_ms": median_ms(plain, iters),
                "library_ms": median_ms(library, iters),
                "bound_ms": bms, "bound_by": by})
    return out + _sp_hop_rows(torch, which) + _pp_mb_rows(torch, which)


# a ring hop at GPT-2 small's --sp 2 training step: each rank's 512 of
# the 1024 tokens, bf16 (O2)
SP = 2
SP_HOP = (TRAIN_BATCH, TRAIN_SEQ // SP, 12, 64)


def _sp_hop_rows(torch, which):
    """The call modes the sequence-parallel paths give the flash kernels,
    at a ring hop's shape (``SP_HOP``, bf16), each against its plain
    version on the card, timed beside it, SDPA at the same shape and
    the bound (``sp_mode`` names the mode):

    - ``fwd``: B4 with ``return_lse`` on the causal diagonal hop and on
      an unmasked hop (o and lse checked); the two-hop merge (two
      unmasked B4 calls over 512 keys each, merged by the log-sum-exp
      rule) against one call over the 1024 joined keys (``merge_err``);
      a batch row whose keys are all masked returns lse <= NEG_INF / 2
      and zeros (``dead_row_lse``);
    - ``dq``, ``dkv``: B5 and B6 on an unmasked hop with ``delta -
      dlse`` for a nonzero ``dlse`` (the merge's lse cotangent);
    - ``*_dropout``: B4d, B5d and B6d at rate 0.1 on the hop that rank 1
      takes from rank 0, offsets ``(512, 0, 0, 12)`` (the mask
      read-back at offsets (70001, 65540) runs in the same phase, bit
      for bit)."""
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bsz, s, h, d = SP_HOP
    dtype, dt = torch.bfloat16, "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(4242)
    q, k, v, do, k2, v2 = (torch.randn(bsz, s, h, d, device="cuda",
                                       generator=g).to(dtype)
                           for _ in range(6))
    scale = 1.0 / d ** 0.5
    isz = q.element_size()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    rate = DROPOUT if which.endswith("_dropout") else 0.0
    seed = fa.seed_array(777, (s, 0, 0, h), num_heads=h, device="cuda") \
        if rate else None
    base = which.replace("_dropout", "")
    rows = []

    def row(mode, causal, got, want, kernel, plain, library, nbytes, flops,
            **extra):
        rel = max_abs = 0.0
        for a, b in zip(got, want):
            r, m = _check(f"flash {which} {mode}",
                          dt if a.dtype == dtype else "float32", a, b)
            rel, max_abs = max(rel, r), max(max_abs, m)
        bms, by = bound(nbytes, flops, dt)
        rows.append({
            "shape": list(SP_HOP), "dtype": dt, "design": _design(dt),
            "sp_mode": mode, "causal": causal, "rel_err": rel,
            "max_abs_err": max_abs,
            "ms": median_ms(kernel, TIMED_LAUNCHES_LARGE),
            "plain_ms": median_ms(plain, TIMED_LAUNCHES_LARGE),
            "library_ms": median_ms(library, TIMED_LAUNCHES_LARGE),
            "bound_ms": bms, "bound_by": by, **extra})

    fwd_bytes = 4 * bsz * s * h * d * isz + bsz * h * s * 4
    if base == "fwd":
        modes = (("hop_unmasked", False),) if rate else \
            (("hop_causal_diagonal", True), ("hop_unmasked", False))
        for mode, causal in modes:
            pairs = bsz * h * (s * (s + 1) // 2 if causal else s * s)

            def kernel(causal=causal):
                return fa.flash_attention_fwd(q, k, v, None, causal, scale,
                                              rate, seed)

            def plain(causal=causal):
                return fa._reference(q, k, v, None, causal, scale,
                                     return_lse=True, dropout_rate=rate,
                                     seed=seed)

            def library(causal=causal):
                return F.scaled_dot_product_attention(
                    qt, kt, vt, dropout_p=rate, is_causal=causal)
            extra = {"offsets": [s, 0, 0, h]} if rate else {}
            row(mode, causal, kernel(), plain(), kernel, plain, library,
                fwd_bytes, 4 * pairs * d, **extra)
        if rate:
            return rows
        # the two-hop merge against one call over the joined keys
        o1, l1 = fa.flash_attention_fwd(q, k, v, None, False, scale)
        o2, l2 = fa.flash_attention_fwd(q, k2, v2, None, False, scale)
        lse = torch.logaddexp(l1, l2)
        merged = (o1.float() * torch.exp(l1 - lse).permute(0, 2, 1)[..., None]
                  + o2.float() * torch.exp(l2 - lse).permute(0, 2, 1)[
                      ..., None])
        joined = fa.flash_attention_fwd(q, torch.cat([k, k2], 1),
                                        torch.cat([v, v2], 1), None, False,
                                        scale)
        plain_joined = fa._reference(q, torch.cat([k, k2], 1),
                                     torch.cat([v, v2], 1), None, False,
                                     scale, return_lse=True)
        merge_err = max(_check("two-hop merge", dt, merged, joined[0])[0],
                        _check("two-hop merge lse", "float32", lse,
                               joined[1])[0],
                        _check("two-hop merge plain", dt, merged,
                               plain_joined[0])[0])
        # a batch row whose every key is masked in this hop
        dead = torch.zeros(bsz, s, device="cuda")
        dead[0] = fa.NEG_INF
        od, ld = fa.flash_attention_fwd(q, k, v, dead, False, scale)
        dead_lse = ld[0].max().item()
        if not (dead_lse <= fa.NEG_INF / 2 and bool((od[0] == 0).all())):
            raise AssertionError(f"flash fwd: a fully masked row gave lse "
                                 f"{dead_lse:.3g} or a nonzero output")
        rows[-1].update(merge_err=merge_err, dead_row_lse=dead_lse)
        return rows
    # B5 / B6 (and their dropout branches) on an unmasked hop with a
    # nonzero lse cotangent
    po, plse = fa._reference(q, k, v, None, False, scale, return_lse=True,
                             dropout_rate=rate, seed=seed)
    dlse = torch.randn(bsz, h, s, device="cuda", generator=g)
    delta = ((do.float() * po.float()).sum(-1).permute(0, 2, 1)
             - dlse).contiguous()
    bargs = (q, k, v, do, plse, delta, None, False, scale, rate, seed)
    kfn = {"dq": fa.flash_attention_bwd_dq,
           "dkv": fa.flash_attention_bwd_dkv}[base]
    pfn = {"dq": fa._bwd_dq_reference, "dkv": fa._bwd_dkv_reference}[base]
    got, want = kfn(*bargs), pfn(*bargs)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    so = F.scaled_dot_product_attention(qt, kt, vt, dropout_p=rate)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(so, (qt, kt, vt), dot, retain_graph=True)
    pairs = bsz * h * s * s
    n_out = (1 if base == "dq" else 2) * bsz * s * h * d * isz
    nbytes = 4 * bsz * s * h * d * isz + 2 * bsz * h * s * 4 + n_out
    extra = {"offsets": [s, 0, 0, h]} if rate else {}
    row("hop_dlse", False, got, want, lambda: kfn(*bargs),
        lambda: pfn(*bargs), library, nbytes,
        (6 if base == "dq" else 8) * pairs * d,
        dlse_max=float(dlse.abs().max()), **extra)
    return rows


# one microbatch of BERT-large's --pp 2 step (B 32, M 4), bf16 (O2)
PP_MB = (8, 128, 16, 64)
# the launch shapes the composed axes give the flash kernels, bf16 (O2):
# a ring hop of BERT-large's --pp 2 --ring-attention 2 microbatch (B 16,
# M 4, S 512 over two ranks) with its keys' padding mask, the same
# microbatch's Ulysses attention (16 heads over two ranks, the whole
# sequence), and GPT-2 small's --sp 2 --tp 2 Ulysses attention (12 heads
# over two model ranks, then two sequence ranks), causal
COMPOSE_SHAPES = (("pp_sp_ring_hop", (4, 256, 16, 64), False, True),
                  ("pp_sp_ulysses", (4, 512, 8, 64), False, False),
                  ("sp_tp_ulysses", (8, 1024, 3, 64), True, False),
                  # TP inside the pipeline: BERT-large's microbatch (B 16,
                  # M 4, S 512) with 8 of its 16 heads a rank, and GPT-2
                  # small's (B 8, M 4, S 1024) with 6 of 12, causal
                  ("tp_pp_bert", (4, 512, 8, 64), False, False),
                  ("tp_pp_gpt", (2, 1024, 6, 64), True, False))
COMPOSE_MASKED_KEYS = 32   # the hop's last keys a row, masked


def _pp_mb_rows(torch, which):
    """B4 (``which="fwd"``), B5 (``"dq"``) or B6 (``"dkv"``) at the launch
    size pipelining gives them on one card: one microbatch of BERT-large
    (``PP_MB``, non-causal, no mask, bf16), against its plain version,
    SDPA at the same shape and the bound (``pp_mode`` names the row); and
    at the composed axes' shapes (``COMPOSE_SHAPES``, ``compose_mode``
    names the row)."""
    rows = _shape_rows(torch, which, PP_MB, "pp_mode", "microbatch", False,
                       False, 808)
    for mode, shape, causal, masked in COMPOSE_SHAPES:
        rows += _shape_rows(torch, which, shape, "compose_mode", mode,
                            causal, masked, 909)
    return rows


def _shape_rows(torch, which, shape, key, mode, causal, masked, seed):
    """One row of B4, B5 or B6 (``which``) at ``shape`` (bf16), its key
    padding mask (the last ``COMPOSE_MASKED_KEYS`` keys of every row at
    ``NEG_INF``) when ``masked``: against its plain version, timed beside
    it and SDPA (its boolean mask the same keys), the bound counting the
    (query, key) pairs the mask and the causal order leave."""
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    bsz, s, h, d = shape
    dtype, dt = torch.bfloat16, "bfloat16"
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(bsz, s, h, d, device="cuda",
                               generator=g).to(dtype) for _ in range(4))
    scale = 1.0 / d ** 0.5
    isz = q.element_size()
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    mask = sdpa_mask = None
    live = s
    if masked:
        live = s - COMPOSE_MASKED_KEYS
        mask = torch.zeros(bsz, s, device="cuda")
        mask[:, live:] = fa.NEG_INF
        sdpa_mask = (mask > fa.NEG_INF / 2)[:, None, None, :]
    pairs = bsz * h * (s * (s + 1) // 2 if causal else s * live)
    lib_kw = dict(attn_mask=sdpa_mask, is_causal=causal)
    if which == "fwd":
        def kernel():
            return fa.flash_attention_fwd(q, k, v, mask, causal, scale)

        def plain():
            return fa._reference(q, k, v, mask, causal, scale,
                                 return_lse=True)

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        nbytes = 4 * bsz * s * h * d * isz + bsz * h * s * 4 \
            + (bsz * s * 4 if masked else 0)
        flops = 4 * pairs * d
    else:
        po, plse = fa._reference(q, k, v, mask, causal, scale,
                                 return_lse=True)
        delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()
        args = (q, k, v, do, plse, delta, mask, causal, scale)
        kfn = {"dq": fa.flash_attention_bwd_dq,
               "dkv": fa.flash_attention_bwd_dkv}[which]
        pfn = {"dq": fa._bwd_dq_reference,
               "dkv": fa._bwd_dkv_reference}[which]
        so = F.scaled_dot_product_attention(qt, kt, vt, **lib_kw)
        dot = do.transpose(1, 2)

        def kernel():
            return kfn(*args)

        def plain():
            return pfn(*args)

        def library():
            return torch.autograd.grad(so, (qt, kt, vt), dot,
                                       retain_graph=True)
        n_out = (1 if which == "dq" else 2) * bsz * s * h * d * isz
        nbytes = 4 * bsz * s * h * d * isz + 2 * bsz * h * s * 4 + n_out \
            + (bsz * s * 4 if masked else 0)
        flops = (6 if which == "dq" else 8) * pairs * d
    got, want = kernel(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rel = max_abs = 0.0
    for a, b in zip(got, want):
        r, m = _check(f"flash {which} {mode}",
                      dt if a.dtype == dtype else "float32", a, b)
        rel, max_abs = max(rel, r), max(max_abs, m)
    bms, by = bound(nbytes, flops, dt)
    return [{"shape": list(shape), "dtype": dt, "design": _design(dt),
             key: mode, "causal": causal, "masked_keys":
             COMPOSE_MASKED_KEYS if masked else 0, "rel_err": rel,
             "max_abs_err": max_abs,
             "ms": median_ms(kernel, TIMED_LAUNCHES_LARGE),
             "plain_ms": median_ms(plain, TIMED_LAUNCHES_LARGE),
             "library_ms": median_ms(library, TIMED_LAUNCHES_LARGE),
             "bound_ms": bms, "bound_by": by}]


def _mask_readback(torch, fa, which, dtype):
    """The keep-mask a dropout kernel drew, read back from its output
    and held bit for bit against ``keep_from_seed`` over Sq = Sk = 192
    (three tiles in q and in k).  With q = 0 every p is 1/192, and a
    one-hot operand selects the 64-wide window w: v[64 w + d, d] = 1
    makes ``o > 0`` the forward's mask over keys 64 w.. (B4d); k the
    same, with v and do all-ones in column 0 and delta = 0, makes
    ``dq > 0`` it (B5d); do over the q window makes ``dv > 0`` the mask
    of queries 64 w.. (B6d).  Offsets past 2**16 and a seed near 2**31
    exercise the global coordinates."""
    b, h, n, d = 2, 3, 192, 64
    zeros = torch.zeros(b, n, h, d, device="cuda", dtype=dtype)
    col0 = zeros.clone()
    col0[..., 0] = 1
    cols = torch.arange(d, device="cuda")
    seed = fa.seed_array(2 ** 31 - 2, (70001, 65540, 4, 2 * h),
                         num_heads=h, device="cuda")
    keep = fa.keep_from_seed(seed, b, h, torch.arange(n, device="cuda"),
                             torch.arange(n, device="cuda"), DROPOUT)
    lse = torch.full((b, h, n), float(np.log(n)), device="cuda")
    delta = torch.zeros(b, h, n, device="cuda")
    for w in range(n // d):
        onehot = zeros.clone()
        onehot[:, w * d + cols, :, cols] = 1
        win = slice(w * d, (w + 1) * d)
        if which == "fwd":
            o, _ = fa.flash_attention_fwd(zeros, zeros, onehot, None, False,
                                          0.125, DROPOUT, seed)
            got, want = o.permute(0, 2, 1, 3), keep[..., win]
        elif which == "dq":
            got = fa.flash_attention_bwd_dq(zeros, onehot, col0, col0, lse,
                                            delta, None, False, 0.125,
                                            DROPOUT, seed)
            got, want = got.permute(0, 2, 1, 3), keep[..., win]
        else:
            _, dv = fa.flash_attention_bwd_dkv(zeros, zeros, zeros, onehot,
                                               lse, delta, None, False,
                                               0.125, DROPOUT, seed)
            got, want = dv.permute(0, 2, 3, 1), keep[:, :, win]
        if not torch.equal(got.float() > 0, want):
            raise AssertionError(f"flash {which} dropout [{dtype}]: the "
                                 f"kernel's keep-mask differs from "
                                 f"keep_from_seed in window {w}")
    return True


def _flash_dropout_variants(torch, which):
    """B4d (``which="fwd"``), B5d (``"dq"``) or B6d (``"dkv"``) at rate
    0.1: BERT-large's training shape (B 32, S 128, 16 heads,
    non-causal, no padding: the example's batches have none) and GPT's
    causal one, fp32 and bf16, each with the bitwise mask read-back.
    The library yardstick is SDPA with ``dropout_p=0.1`` (its own Philox
    mask, so a time only): the forward for B4d, the backward (dq, dk and
    dv in one call) for B5d and B6d.  The bound counts the matmul FLOPs
    over the operand type's peak; the hash's ~12 integer operations per
    score are not in it."""
    import torch.nn.functional as F
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    out = []
    d = 64
    # TP inside the pipeline (bf16): model rank 1's 8 heads of BERT-large's
    # microbatch, hashed at their global index (offsets (0, 0, 8, 16))
    tp_case = ((CB_BATCH // T_M, CB_SEQ, BERT_HEADS // T_TP, False,
                (0, 0, BERT_HEADS // T_TP, BERT_HEADS)),)
    for dtype in (torch.float32, torch.bfloat16):
        readback = _mask_readback(torch, fa, which, dtype)
        for bsz, s, h, causal, offsets in (
                (BERT_BATCH, BERT_SEQ, BERT_HEADS, False, None),
                (TRAIN_BATCH, TRAIN_SEQ, 12, True, None)) + (
                tp_case if dtype == torch.bfloat16 else ()):
            g = torch.Generator(device="cuda").manual_seed(s + 7)
            q, k, v, do = (torch.randn(bsz, s, h, d, device="cuda",
                                       generator=g).to(dtype)
                           for _ in range(4))
            seed = fa.seed_array(12345 + s, offsets, num_heads=h,
                                 device="cuda")
            scale = 1.0 / d ** 0.5
            po, plse = fa._reference(q, k, v, None, causal, scale,
                                     return_lse=True, dropout_rate=DROPOUT,
                                     seed=seed)
            delta = (do.float() * po.float()).sum(-1).permute(0, 2, 1) \
                .contiguous()
            bargs = (q, k, v, do, plse, delta, None, causal, scale, DROPOUT,
                     seed)
            if which == "fwd":
                def kernel():
                    return fa.flash_attention_fwd(q, k, v, None, causal,
                                                  scale, DROPOUT, seed)

                def plain():
                    return fa._reference(q, k, v, None, causal, scale,
                                         return_lse=True,
                                         dropout_rate=DROPOUT, seed=seed)
            else:
                kfn = {"dq": fa.flash_attention_bwd_dq,
                       "dkv": fa.flash_attention_bwd_dkv}[which]
                pfn = {"dq": fa._bwd_dq_reference,
                       "dkv": fa._bwd_dkv_reference}[which]

                def kernel():
                    return kfn(*bargs)

                def plain():
                    return pfn(*bargs)
            dt = _dt(dtype)
            got, want = kernel(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            rel = max_abs = 0.0
            for a, b in zip(got, want):
                r, m = _check(f"flash_{which}_dropout", dt if a.dtype == dtype
                              else "float32", a, b)
                rel, max_abs = max(rel, r), max(max_abs, m)
            # o (B4d), dq (B5d), dk and dv (B6d); not the forward's lse
            rows = _check_rows_all(f"flash_{which}_dropout", dt,
                                   got[:1] if which == "fwd" else got,
                                   want[:1] if which == "fwd" else want)
            del got, want, po
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            so = None
            if which == "fwd":
                def library():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, dropout_p=DROPOUT, is_causal=causal)
            else:
                so = F.scaled_dot_product_attention(
                    qt, kt, vt, dropout_p=DROPOUT, is_causal=causal)
                dot = do.transpose(1, 2)

                def library():
                    return torch.autograd.grad(so, (qt, kt, vt), dot,
                                               retain_graph=True)
            pairs = bsz * h * (s * (s + 1) // 2 if causal else s * s)
            isz = q.element_size()
            if which == "fwd":
                nbytes = 4 * bsz * s * h * d * isz + bsz * h * s * 4
                flops = 4 * pairs * d
            else:
                n_out = (1 if which == "dq" else 2) * bsz * s * h * d * isz
                nbytes = 4 * bsz * s * h * d * isz + 2 * bsz * h * s * 4 \
                    + n_out
                flops = (6 if which == "dq" else 8) * pairs * d
            bms, by = bound(nbytes, flops, dt)
            iters = TIMED_LAUNCHES if bsz * s <= 4096 else \
                TIMED_LAUNCHES_LARGE
            out.append({
                "shape": [bsz, s, h, d], "dtype": dt,
                "design": _design(dt), "causal": causal,
                **({} if offsets is None else {"offsets": list(offsets),
                                               "tp_pp_mode": "tp_pp_bert"}),
                "rate": DROPOUT, "rel_err": rel,
                **({} if rows is None else {"row_err": rows}),
                "max_abs_err": max_abs,
                "mask_bitwise": readback,
                "ms": median_ms(kernel, iters),
                "plain_ms": median_ms(plain, TIMED_LAUNCHES_LARGE),
                "library_ms": median_ms(library, iters),
                "bound_ms": bms, "bound_by": by})
            del so
    return out + _sp_hop_rows(torch, which + "_dropout")


def _dropout_variants(torch):
    """The threefry dropout kernel at BERT-large's hidden activation (B 32
    x S 128 x 1024: O2's bf16, O0's fp32) and at an odd size, rate 0.1:
    forward and gradient (the same launch on dy) bit for bit against the
    plain version on the same key.  Yardstick: ``F.dropout`` (PyTorch's
    own Philox stream, so a time only).  The bound is the larger of the
    bytes and the kernel's integer instructions an element in its SASS
    (``threefry_int_ops``) at the card's int32 rate."""
    import torch.nn.functional as F
    tf = importlib.import_module("apex_tpu_torch.ops.threefry")
    out = []
    key = tf.fold_in(tf.PRNGKey(0), 3)
    for dtype, shape in itertools.product(
            (torch.float32, torch.bfloat16),
            ((BERT_BATCH, BERT_SEQ, BERT_HIDDEN), (3, 1001, 7))):
        g = torch.Generator(device="cuda").manual_seed(13)
        x = torch.randn(shape, device="cuda", generator=g).to(dtype)
        dy = torch.randn(shape, device="cuda", generator=g).to(dtype)
        xg = x.clone().requires_grad_()
        y = tf.dropout(xg, DROPOUT, key)
        y.backward(dy)
        dt = _dt(dtype)
        for what, got, want in (
                ("forward", y, tf.dropout_plain(x, DROPOUT, key)),
                ("gradient", xg.grad, tf.dropout_plain(dy, DROPOUT, key))):
            if not torch.equal(got, want):
                raise AssertionError(f"threefry_dropout {what} [{dt}]: "
                                     "differs from the plain version")
        kept = float((y != 0).float().mean())
        del y, xg
        n = x.numel()
        int_ops = threefry_int_ops()[dt]
        bms, by = bound(2 * n * x.element_size(), int_ops * n, "int32")
        iters = TIMED_LAUNCHES if n < 1e6 else TIMED_LAUNCHES_LARGE
        out.append({
            "shape": list(shape), "dtype": dt, "rate": DROPOUT,
            "bitwise": True, "kept_share": kept, "int_ops": int_ops,
            "rel_err": 0.0,
            "max_abs_err": 0.0,
            "ms": median_ms(lambda: tf.dropout(x, DROPOUT, key), iters),
            "plain_ms": median_ms(lambda: tf.dropout_plain(x, DROPOUT, key),
                                  TIMED_LAUNCHES_LARGE),
            "library_ms": median_ms(lambda: F.dropout(x, DROPOUT), iters),
            "library": "F.dropout (Philox)",
            "bound_ms": bms, "bound_by": by})
    return out


def _gpt_small_param_count():
    from apex_tpu_torch.models import gpt_small
    cfg = gpt_small()
    h, f, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    block = 4 * h + 4 * (h * h + h) + (h * f + f) + (f * h + h)
    return (cfg.vocab_size * h + cfg.max_position_embeddings * h
            + n * block + 2 * h)


def _adam_variants(torch):
    """B1 over GPT-2 small's flat fp32 buffer (124.4M elements, a
    multiple of 128), with inf/nan in g; the skipped step keeps every
    bit.  Yardstick: ``torch._fused_adam_`` (weight decay 0)."""
    adam = importlib.import_module("apex_tpu_torch.optimizers.fused_adam")
    n = _gpt_small_param_count()
    n += -n % adam.PAD_TO
    g_ = torch.Generator(device="cuda").manual_seed(3)
    p = torch.randn(n, device="cuda", generator=g_)
    m = 0.01 * torch.randn(n, device="cuda", generator=g_)
    v = 1e-4 * torch.rand(n, device="cuda", generator=g_)
    g = torch.randn(n, device="cuda", generator=g_)
    lr, b1, b2, eps = TRAIN_LR, 0.9, 0.999, 1e-8
    step_size = lr * (1 - b2 ** 3) ** 0.5 / (1 - b1 ** 3)
    scalars = torch.tensor([step_size, b1, b2, eps, 1.0, 0.0, 1.0],
                           device="cuda")
    skip = scalars.clone()
    skip[6] = 0.0
    ref = adam._adam_plain(p, m, v, g, scalars, False)
    p1, m1, v1 = p.clone(), m.clone(), v.clone()
    adam.adam_flat(p1, m1, v1, g, scalars, False)
    rel = max_abs = 0.0
    for a, b in zip((p1, m1, v1), ref):
        r, mx = _check("fused_adam", "float32", a, b, tol=ADAM_TOL)
        rel, max_abs = max(rel, r), max(max_abs, mx)
    del ref
    # an overflowed step: inf and nan in g, keep = 0 -> every bit stays,
    # in the kernel and in its plain version
    g_bad = g.clone()
    g_bad[7], g_bad[n // 2] = float("inf"), float("nan")
    old = (p1.clone(), m1.clone(), v1.clone())
    adam.adam_flat(p1, m1, v1, g_bad, skip, False)
    plain_skip = adam._adam_plain(*old, g_bad, skip, False)
    if not all(torch.equal(a, b) and torch.equal(c, b)
               for a, b, c in zip((p1, m1, v1), old, plain_skip)):
        raise AssertionError("fused_adam: a skipped step changed a bit")
    del g_bad, old, plain_skip, p1, m1, v1

    def kernel():
        adam.adam_flat(p, m, v, g, scalars, False)

    def plain():
        return adam._adam_plain(p, m, v, g, scalars, False)

    steps = [torch.tensor(3.0, device="cuda")]

    def library():
        torch._fused_adam_([p], [g], [m], [v], [], steps, lr=lr, beta1=b1,
                           beta2=b2, weight_decay=0.0, eps=eps,
                           amsgrad=False, maximize=False)

    bms, by = bound(28 * n, 15 * n, "float32")
    rows = [{"shape": [n], "dtype": "float32", "rel_err": rel,
             "max_abs_err": max_abs, "skip_bitwise": True,
             "ms": median_ms(kernel, TIMED_LAUNCHES_LARGE),
             "plain_ms": median_ms(plain, TIMED_LAUNCHES_LARGE),
             "library_ms": median_ms(library, TIMED_LAUNCHES_LARGE),
             "bound_ms": bms, "bound_by": by}]
    # ZeRO's launch: rank 1's half of the buffer over 2 ranks, views at
    # an offset of the full p, m, v and g (with_zero's and
    # zero2_update's slices), against its plain version bit for bit
    k = n // 2
    sl = slice(k, n)
    want = adam._adam_plain(p[sl], m[sl], v[sl], g[sl], scalars, False)
    ps, ms_, vs = p[sl].clone(), m[sl].clone(), v[sl].clone()
    adam.adam_flat(ps, ms_, vs, g[sl], scalars, False)
    if not all(torch.equal(a, b) for a, b in zip((ps, ms_, vs), want)):
        raise AssertionError("fused_adam: the ZeRO shard is not bit for "
                             "bit its plain version")
    del want, ps, ms_, vs

    def shard():
        adam.adam_flat(p[sl], m[sl], v[sl], g[sl], scalars, False)

    def shard_plain():
        return adam._adam_plain(p[sl], m[sl], v[sl], g[sl], scalars, False)

    def shard_library():
        torch._fused_adam_([p[sl]], [g[sl]], [m[sl]], [v[sl]], [], steps,
                           lr=lr, beta1=b1, beta2=b2, weight_decay=0.0,
                           eps=eps, amsgrad=False, maximize=False)

    bms, by = bound(28 * k, 15 * k, "float32")
    rows.append({"shape": [k], "dtype": "float32", "zero_shard": "rank 1 "
                 "of 2 (offset k of the flat buffer)", "rel_err": 0.0,
                 "max_abs_err": 0.0, "bitwise": True,
                 "ms": median_ms(shard, TIMED_LAUNCHES_LARGE),
                 "plain_ms": median_ms(shard_plain, TIMED_LAUNCHES_LARGE),
                 "library_ms": median_ms(shard_library,
                                         TIMED_LAUNCHES_LARGE),
                 "bound_ms": bms, "bound_by": by})
    return rows


def _gpt_small_leaves(seed=None):
    """GPT-2 small's parameters as a ``{name: fp32 tensor}`` dict on the
    card (196 leaves, the tied wte once): seeded weights, or PyTorch's
    default init with ``seed=None``."""
    from apex_tpu_torch.models import GPTLMHeadModel, gpt_small
    model = GPTLMHeadModel(gpt_small(), device="cuda", seed=seed)
    return {n: p.detach() for n, p in model.named_parameters()}


# B1-multi's edge case: segment lengths and the offsets of p, m, v and g
# from a 16-byte line (in elements): alike (head, float4 body, tail),
# unlike (all scalar), one longer than a chunk, one empty
MULTI_EDGE_SEGMENTS = ((1, (0, 0, 0, 0)), (3, (1, 1, 1, 1)),
                       (4097, (2, 2, 2, 2)), (70001, (3, 3, 3, 3)),
                       (129, (1, 2, 3, 0)), (0, (0, 0, 0, 0)),
                       (6, (3, 0, 0, 0)), (1000, (0, 0, 0, 0)))


def _adam_multi_edge(torch, adam):
    """B1-multi against its plain version bit for bit on
    ``MULTI_EDGE_SEGMENTS`` carved from four buffers, in three groups
    whose last is skipped and holds inf/nan gradients; bytes outside the
    kept groups' segments keep every bit."""
    total = sum(n + 4 for n, _ in MULTI_EDGE_SEGMENTS) + 64
    g_ = torch.Generator(device="cuda").manual_seed(5)
    bufs = [torch.randn(total, device="cuda", generator=g_)
            for _ in range(4)]
    bufs[1].mul_(0.1)
    bufs[2].abs_().mul_(0.01)

    def carve(tensors):
        segments, cursor = [], 0
        for i, (n, offs) in enumerate(MULTI_EDGE_SEGMENTS):
            cursor += -cursor % 4
            segments.append((*(t[cursor + o:cursor + o + n]
                               for t, o in zip(tensors, offs)), i % 3))
            cursor += n + 4
        return segments

    for p, m, v, g, gid in carve(bufs):
        if gid == 2 and g.numel() > 5:
            g[0], g[5] = float("inf"), float("nan")
    scalars = torch.tensor([[1e-3, 0.9, 0.999, 1e-8, 2.0, 0.01, 1.0],
                            [3e-4, 0.8, 0.99, 1e-6, 8.0, 0.0, 1.0],
                            [1e-2, 0.9, 0.999, 1e-8, 1.0, 0.1, 0.0]],
                           device="cuda")
    twins = [b.clone() for b in bufs]
    old = [b.clone() for b in bufs]
    adam.adam_multi(carve(bufs), scalars, False)
    adam.adam_multi_plain(carve(twins), scalars, False)
    index = torch.arange(total, device="cuda")
    for j, (got, want, o) in enumerate(zip(bufs[:3], twins[:3], old)):
        untouched = torch.ones(total, dtype=torch.bool, device="cuda")
        for seg in carve([index] * 4):
            if seg[4] != 2:
                untouched[seg[j]] = False
        if not (torch.equal(got.view(torch.int32), want.view(torch.int32))
                and torch.equal(got[untouched].view(torch.int32),
                                o[untouched].view(torch.int32))):
            raise AssertionError("fused_adam_multi: the edge case differs "
                                 "from the plain version or wrote outside "
                                 "the kept segments")
    return len(MULTI_EDGE_SEGMENTS)


def _adam_multi_variants(torch):
    """B1-multi over GPT-2 small's 196 leaves (the tree layout's
    segments), bit for bit against its plain version in three groups
    (the recipe's no-decay ``bias|_ln``, ``wte`` at another lr, the
    rest) and on a skipped step with inf/nan gradients, and on the edge
    case (``_adam_multi_edge``).  Timed in one group beside flat B1 over
    a flat buffer of the same elements (``flat_ms``) and the host time
    of a call (``host_ms``: the checks, the chunk table, its pinned copy,
    the launch);
    yardstick ``torch._fused_adam_`` over the same leaves."""
    adam = importlib.import_module("apex_tpu_torch.optimizers.fused_adam")
    edge = _adam_multi_edge(torch, adam)
    g_ = torch.Generator(device="cuda").manual_seed(4)
    leaves = _gpt_small_leaves()
    names = list(leaves)
    p = [torch.randn_like(t) for t in leaves.values()]
    m = [0.01 * torch.randn(t.shape, device="cuda", generator=g_) for t in p]
    v = [1e-4 * torch.rand(t.shape, device="cuda", generator=g_) for t in p]
    g = [torch.randn(t.shape, device="cuda", generator=g_) for t in p]
    n = sum(t.numel() for t in p)
    lr, b1, b2, eps = TRAIN_LR, 0.9, 0.999, 1e-8
    ss = lr * (1 - b2 ** 3) ** 0.5 / (1 - b1 ** 3)
    gids = [1 if re.search(r"(bias|_ln)", k) else 2 if "wte" in k else 0
            for k in names]
    scalars = torch.tensor([[ss, b1, b2, eps, 1.0, 0.01, 1.0],
                            [ss, b1, b2, eps, 1.0, 0.0, 1.0],
                            [0.5 * ss, b1, b2, eps, 2.0, 0.01, 1.0]],
                           device="cuda")

    def segs(tensors, ids):
        return [(*(t.view(-1) for t in ts), i)
                for ts, i in zip(zip(*tensors), ids)]

    work = [[t.clone() for t in ts] for ts in (p, m, v)]
    twin = [[t.clone() for t in ts] for ts in (p, m, v)]
    adam.adam_multi(segs((*work, g), gids), scalars, False)
    adam.adam_multi_plain(segs((*twin, g), gids), scalars, False)
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for ws, ts in zip(work, twin) for a, b in zip(ws, ts))
    # a skipped step: every group keep = 0, inf and nan in the grads
    bad = [t.clone() for t in g]
    bad[0].view(-1)[7] = float("inf")
    bad[-1].view(-1)[0] = float("nan")
    skip = scalars.clone()
    skip[:, 6] = 0.0
    snap = [[t.clone() for t in ts] for ts in work]
    adam.adam_multi(segs((*work, bad), gids), skip, False)
    kept = all(torch.equal(a, b) for ws, ss_ in zip(work, snap)
               for a, b in zip(ws, ss_))
    if not (bitwise and kept):
        raise AssertionError(f"fused_adam_multi at GPT-2 small: bitwise "
                             f"{bitwise}, skipped step kept {kept}")
    del work, twin, snap, bad
    one = scalars[:1]
    one_segs = segs((p, m, v, g), [0] * len(p))
    n_chunks = len(adam._chunk_table(adam._segment_rows(one_segs, 0)))
    flat = [torch.randn(n + -n % 4, device="cuda", generator=g_)
            for _ in range(4)]

    def kernel():
        adam.adam_multi(one_segs, one, False)

    def plain():
        adam.adam_multi_plain(one_segs, one, False)

    def flat_b1():
        adam.adam_flat(*flat, one[0], False)

    steps = [torch.tensor(3.0, device="cuda") for _ in p]

    def library():
        torch._fused_adam_(p, g, m, v, [], steps, lr=lr, beta1=b1, beta2=b2,
                           weight_decay=0.01, eps=eps, amsgrad=False,
                           maximize=False)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        kernel()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    bms, by = bound(28 * n + 48 * n_chunks, 15 * n, "float32")
    return [{"shape": [n], "dtype": "float32", "segments": len(p),
             "chunks": n_chunks, "groups_checked": 3,
             "edge_segments": edge, "rel_err": 0.0, "max_abs_err": 0.0,
             "bitwise": True, "skip_bitwise": True,
             "ms": median_ms(kernel, TIMED_LAUNCHES_LARGE),
             "flat_ms": median_ms(flat_b1, TIMED_LAUNCHES_LARGE),
             "host_ms": host_ms,
             "plain_ms": median_ms(plain, 5),
             "library_ms": median_ms(library, TIMED_LAUNCHES_LARGE),
             "library": "torch._fused_adam_ over the 196 leaves",
             "bound_ms": bms, "bound_by": by}]


# (name, source, TPU kernel it replaces, variant builder, summary variant:
# the shape and dtype of the training step, the path that launches the
# kernel last, and for B7 and B8 the serving step's, with the engine's
# bias)
KERNELS = (
    ("layer_norm_fwd", "apex_tpu_torch/csrc/layer_norm.cu",
     "apex_tpu/normalization/fused_layer_norm.py:63", _ln_variants,
     ([BERT_BATCH * BERT_SEQ, BERT_HIDDEN], "bfloat16")),
    ("flash_fwd", "apex_tpu_torch/csrc/flash_fwd.cu",
     "apex_tpu/ops/flash_attention.py:161", _flash_variants,
     ([TRAIN_BATCH, TRAIN_SEQ, 12, 64], "bfloat16")),
    ("decode_attention", "apex_tpu_torch/csrc/decode_attention.cu",
     "apex_tpu/ops/decode_attention.py:125",
     functools.partial(_decode_rows, quantized=False),
     ([8, 1025, 12, 64], "float32", "engine")),
    ("decode_attention_q8", "apex_tpu_torch/csrc/decode_attention.cu",
     "apex_tpu/ops/decode_attention.py:131",
     functools.partial(_decode_rows, quantized=True),
     ([8, 1025, 12, 64], "float32", "engine")),
    ("fused_adam", "apex_tpu_torch/csrc/fused_adam.cu",
     "apex_tpu/optimizers/fused_adam.py:95", _adam_variants,
     (None, "float32")),
    # the multi-tensor form of B1 (FusedAdam's tree and grouped layouts)
    ("fused_adam_multi", "apex_tpu_torch/csrc/fused_adam.cu",
     "apex_tpu/optimizers/fused_adam.py:95", _adam_multi_variants,
     (None, "float32")),
    ("layer_norm_bwd", "apex_tpu_torch/csrc/layer_norm.cu",
     "apex_tpu/normalization/fused_layer_norm.py:78", _ln_bwd_variants,
     ([BERT_BATCH * BERT_SEQ, BERT_HIDDEN], "bfloat16")),
    ("flash_bwd_dq", "apex_tpu_torch/csrc/flash_bwd.cu",
     "apex_tpu/ops/flash_attention.py:252",
     functools.partial(_flash_bwd_variants, which="dq"),
     ([TRAIN_BATCH, TRAIN_SEQ, 12, 64], "bfloat16")),
    ("flash_bwd_dkv", "apex_tpu_torch/csrc/flash_bwd.cu",
     "apex_tpu/ops/flash_attention.py:291",
     functools.partial(_flash_bwd_variants, which="dkv"),
     ([TRAIN_BATCH, TRAIN_SEQ, 12, 64], "bfloat16")),
    ("flash_fwd_dropout", "apex_tpu_torch/csrc/flash_fwd.cu",
     "apex_tpu/ops/flash_attention.py:161",
     functools.partial(_flash_dropout_variants, which="fwd"),
     ([BERT_BATCH, BERT_SEQ, BERT_HEADS, 64], "bfloat16")),
    ("flash_bwd_dq_dropout", "apex_tpu_torch/csrc/flash_bwd.cu",
     "apex_tpu/ops/flash_attention.py:252",
     functools.partial(_flash_dropout_variants, which="dq"),
     ([BERT_BATCH, BERT_SEQ, BERT_HEADS, 64], "bfloat16")),
    ("flash_bwd_dkv_dropout", "apex_tpu_torch/csrc/flash_bwd.cu",
     "apex_tpu/ops/flash_attention.py:291",
     functools.partial(_flash_dropout_variants, which="dkv"),
     ([BERT_BATCH, BERT_SEQ, BERT_HEADS, 64], "bfloat16")),
    # no TPU kernel: the reference's hidden dropout is flax's nn.Dropout,
    # plain jnp that XLA fuses
    ("threefry_dropout", "apex_tpu_torch/csrc/threefry_dropout.cu",
     "none (apex_tpu/models/bert.py:98 nn.Dropout, plain jnp)",
     _dropout_variants,
     ([BERT_BATCH, BERT_SEQ, BERT_HIDDEN], "bfloat16")),
)


def phase_kernels():
    import torch
    # what ``median_ms`` reads for a launch that does nothing, and with
    # L2 flushed first: the floors under the ``ms`` and ``cold_ms`` below
    emit("kernels", timing_floor_ms=median_ms(lambda: torch.cuda._sleep(0)),
         timing_floor_cold_ms=median_ms(lambda: torch.cuda._sleep(0),
                                        flush=l2_flush()))
    results = {}
    for name, source, replaces, variants, summary in KERNELS:
        rows = variants(torch)
        for row in rows:
            emit("kernels", kernel=name, **row)
        main = next(r for r in rows
                    if summary[0] in (None, r["shape"])
                    and r["dtype"] == summary[1]
                    and summary[2:] in ((), (r.get("bias"),)))
        results[name] = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "launches_by_path": {},
            "max_abs_err": main["max_abs_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            **{key: main[key] for key in ("library", "design", "row_err",
                                          "bitwise", "bias",
                                          "bound_all_keys_ms", "cold_ms",
                                          "library_cold_ms",
                                          "copy_cold_ms")
               if key in main},
            "shape": main["shape"], "dtype": main["dtype"],
            "variants": rows}
        gpt = next((r for r in rows if name.endswith("_dropout")
                    and r["shape"] == [TRAIN_BATCH, TRAIN_SEQ, 12, 64]
                    and r["dtype"] == "bfloat16"), None)
        if gpt is not None:
            # the dropout branches at GPT-2 small's causal training shape
            results[name]["gpt_causal"] = {
                key: gpt[key] for key in ("shape", "ms", "plain_ms",
                                          "library_ms", "bound_ms",
                                          "bound_by", "max_abs_err",
                                          "row_err")}
        # the shapes the tensor-parallel and ZeRO paths give them: one
        # rank's 6 heads at --tp 2, B1 on one rank's half of the buffer
        extra = next((r for r in rows if r.get("zero_shard") or (
            r["shape"] == [TRAIN_BATCH, TRAIN_SEQ, TP_HEADS, 64]
            and r["dtype"] == "bfloat16")), None)
        if extra is not None:
            results[name]["tp_zero_shape"] = {
                key: extra[key] for key in ("shape", "ms", "plain_ms",
                                            "library_ms", "bound_ms",
                                            "bound_by", "max_abs_err")}
        # the ring hop's call modes (--sp 2's 512-token shards)
        hops = {r["sp_mode"]: {key: r[key] for key in (
            "shape", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err", "merge_err", "dead_row_lse", "offsets")
            if key in r} for r in rows if "sp_mode" in r}
        if hops:
            results[name]["sp_hop"] = hops
        # one microbatch of BERT-large's --pp 2 step
        mb = next((r for r in rows if r.get("pp_mode") == "microbatch"),
                  None)
        if mb is not None:
            results[name]["pp_microbatch"] = {key: mb[key] for key in (
                "shape", "ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_abs_err")}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "kernels.json").write_text(json.dumps(results, indent=1))
    return results


def _make_prompts(cfg, n=16, seed=0):
    # examples/serving/serve_gpt.py's traffic at --config small
    rng = np.random.RandomState(seed)
    max_ctx = cfg.max_position_embeddings
    return [list(rng.randint(0, cfg.vocab_size,
                             size=int(rng.randint(4, max(8, max_ctx // 4)))))
            for _ in range(n)]


def _serve_once(server, prompts, max_new, sampling=None, streamed=False):
    """Drive the main path once with every launch count at 0 just
    before and read just after; checks the counts against the model's
    2L+1 LayerNorms per forward (a monolithic prefill, a chunk or a
    decode step), L flash attentions per monolithic prefill (none when
    the server chunks: a chunk's attention is plain PyTorch, as the
    reference's) and L decode attentions per decode step (B8 from an
    int8 pool, B7 otherwise), and every pool (both under
    disaggregation) audit-clean and free afterwards.  ``streamed``: a
    consumer thread a request iterates ``server.stream(uid)`` while the
    pass runs and must receive exactly the request's tokens."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    server.reset_meters()
    t0 = time.perf_counter()
    if streamed:
        outs = _generate_streamed(server, prompts, max_new)
    else:
        outs = server.generate(prompts, max_new_tokens=max_new,
                               sampling=sampling)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = server.stats()
    layers = server.engine.cfg.num_hidden_layers
    decode = ("decode_attention_q8" if server.engine.quantized
              else "decode_attention")
    serve = {"layer_norm_fwd": (2 * layers + 1)
             * (st["prefills"] + st["prefill_chunks"] + st["decode_steps"]),
             "flash_fwd": layers * st["prefills"],
             decode: layers * st["decode_steps"]}
    chunked = server.prefill_chunk is not None
    required = [name for name in serve if not (chunked
                                               and name == "flash_fwd")]
    # the training kernels (backward, optimizer) run no time here
    want = {name: serve.get(name, 0) for name in counts}
    if counts != want or not all(serve[name] for name in required) \
            or (st["prefill_chunks"] > 0) != chunked \
            or st["kernel_launches"] != counts:
        raise AssertionError(f"kernel launches {counts} (stats() "
                             f"{st['kernel_launches']}) != expected {want} "
                             f"({st['prefills']} prefills, "
                             f"{st['prefill_chunks']} chunks, "
                             f"{st['decode_steps']} decode steps)")
    pipe = st["pipeline"]
    if pipe["pending"] or pipe["retired_behind"] != pipe["launches"] \
            or pipe["launches"] != (st["decode_steps"] + st["verify_steps"]
                                    if server.pipelining else 0):
        raise AssertionError(f"pipeline {pipe} against "
                             f"{st['decode_steps']} decode and "
                             f"{st['verify_steps']} verify steps")
    server.audit()
    for engine in (server.engine, server.prefill_engine):
        if engine is not None and engine.allocator.num_free != \
                engine.cache_cfg.num_blocks - 1:
            raise AssertionError("blocks leaked after generate")
    vocab = server.engine.cfg.vocab_size
    for o in outs:
        if len(o) != max_new or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"malformed completion: {o}")
    return outs, wall, counts, st


def _generate_streamed(server, prompts, max_new):
    """``server.generate`` with a consumer thread a request iterating
    its ``server.stream(uid)`` while the serve thread steps; each must
    receive exactly its request's tokens and finish reason."""
    import threading
    reqs = [server.submit(p, max_new) for p in prompts]
    got = [[] for _ in reqs]
    streams = [server.stream(r.uid) for r in reqs]

    def consume(stream, out):
        for tok in stream:
            out.append(tok)

    threads = [threading.Thread(target=consume, args=(s, g), daemon=True)
               for s, g in zip(streams, got)]
    for t in threads:
        t.start()
    while server.has_work:
        server.step()
    for t in threads:
        t.join(timeout=60)
    if any(t.is_alive() for t in threads) \
            or got != [r.generated for r in reqs] \
            or [s.finish_reason for s in streams] != \
            [r.finish_reason for r in reqs]:
        raise AssertionError(f"streams: {sum(map(len, got))} tokens "
                             f"delivered of "
                             f"{sum(len(r.generated) for r in reqs)}")
    return [list(r.generated) for r in reqs]


def _pipeline_fields(st):
    """The dispatch-ahead window's and the breaker's readings of one
    pass's ``stats()``."""
    pipe = st["pipeline"]
    return {"pipelined": pipe["enabled"], "launches_ahead": pipe["launches"],
            "host_stall_ms": pipe["host_stall_ms"],
            "host_plan_ms": pipe["host_plan_ms"],
            "breaker_state": st["breaker_state"],
            "oom_events": st["oom_events"]}


def _sync_checked_launches(server, tally):
    """Run each of ``server``'s pipelined decode and verify launches
    under ``torch.cuda.set_sync_debug_mode("error")``: a launch that
    waits on the card (a blocking copy, a ``.cpu()``, a size read off a
    device tensor) raises.  The retire is left to wait.  Counts the
    checked launches in ``tally`` by kind and sampling
    (``decode_greedy``, ``verify_stochastic``, ...)."""
    import torch

    def wrap(kind, launch):
        def checked(running, *args):
            klass = ("greedy" if all(r.sampling.is_greedy for r in running)
                     else "stochastic")
            torch.cuda.set_sync_debug_mode("error")
            try:
                launched = launch(running, *args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            key = f"{kind}_{klass}"
            tally[key] = tally.get(key, 0) + 1
            return launched
        return checked

    server._launch_decode = wrap("decode", server._launch_decode)
    server._launch_verify = wrap("verify", server._launch_verify)


def _inject_ooms(engine, at):
    """Make each engine method named in ``at`` raise
    ``torch.OutOfMemoryError`` on the listed call numbers, before the
    engine runs (so nothing is launched or counted for it); returns the
    calls seen, by method."""
    import torch
    seen = {}

    def flaky(name, method):
        def call(*args, **kw):
            seen[name] = seen.get(name, 0) + 1
            if seen[name] in at[name]:
                raise torch.OutOfMemoryError(
                    f"injected at {name} call {seen[name]}")
            return method(*args, **kw)
        return call

    for name in at:
        setattr(engine, name, flaky(name, getattr(engine, name)))
    return seen


def _sync_checked_prefill(server, tally):
    """Run each disaggregated step's prefill slice (admission, the
    prefill launches on the prefill engine's stream, the start of their
    tokens' copy back and the event after it) and each hand-off copy into
    the decode pool under ``torch.cuda.set_sync_debug_mode("error")``;
    counts in ``tally`` the prefill launches (``prefill_launches``) and
    the copies (``handoff_copy``) made under it."""
    import torch

    def under_error(call, *args):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    prefill_slice, copy = server._prefill_slice, \
        server.engine.copy_blocks_from

    def checked_slice():
        before = server.prefills
        chunks, produced = under_error(prefill_slice)
        tally["prefill_launches"] = tally.get("prefill_launches", 0) \
            + server.prefills - before + chunks
        return chunks, produced

    def checked_copy(src, pairs):
        tally["handoff_copy"] = tally.get("handoff_copy", 0) + 1
        return under_error(copy, src, pairs)

    server._prefill_slice = checked_slice
    server.engine.copy_blocks_from = checked_copy


def _torn_and_delayed(engine):
    """Make the hand-off copy into ``engine`` raise
    ``torch.OutOfMemoryError`` at its first call after copying half of
    its pairs (torn) and at its second before copying any (delayed);
    returns the calls seen and the torn call's pairs."""
    import torch
    seen = {"calls": 0}
    copy = engine.copy_blocks_from

    def faulty(src, pairs):
        seen["calls"] += 1
        if seen["calls"] == 1:
            seen["torn_pairs"] = len(pairs)
            copy(src, pairs[:len(pairs) // 2])
            raise torch.OutOfMemoryError("injected: a torn hand-off")
        if seen["calls"] == 2:
            raise torch.OutOfMemoryError("injected: a delayed hand-off")
        return copy(src, pairs)

    engine.copy_blocks_from = faulty
    return seen


def _disagg_check(label, st, counts, mono_counts):
    """A disaggregated pass's launches against the monolithic pass's:
    the same B4 launches (one a layer a prompt, in the prefill pool) and
    every prompt handed off once."""
    flash, handoff = counts.get("flash_fwd", 0), st["disagg"]["handoff"]
    if flash != mono_counts["flash_fwd"] \
            or handoff.get("requests") != st["prefills"] \
            or st["disagg"]["prefill_blocks_live"]:
        raise AssertionError(f"{label}: B4 {flash} against the monolithic "
                             f"{mono_counts['flash_fwd']}, hand-offs "
                             f"{handoff}, {st['prefills']} prefills")


def _serve_disagg(shared, common, outs_a, counts_a):
    """(f) disaggregated prefill/decode on the fp32 pool, (a)'s prompts:
    the pipelined pass with its decode launches, prefill slices and
    hand-off copies under sync-debug "error", a consumer thread a
    request on ``stream()``, and the first hand-off copy torn and the
    second delayed by card OOMs; then the tightest prefill pool (one
    full context: every hand-off's blocks go to the next prefill at
    once, which must wait for the copy).  Each pass's tokens are (a)'s
    exactly, its B4 launches (a)'s, its B7 L a decode step."""
    import torch
    from apex_tpu_torch.serving import InferenceServer
    cfg, params, prompts = shared["cfg"], shared["params"], shared["prompts"]
    max_new = len(outs_a[0])
    layers = cfg.num_hidden_layers
    out = {}
    server = InferenceServer(cfg, params, cache_dtype=torch.float32,
                             enable_disagg=True, **common)
    checked = {}
    _sync_checked_launches(server, checked)
    seen = _torn_and_delayed(server.engine)
    _sync_checked_prefill(server, checked)
    outs, wall, counts, st = _serve_once(server, prompts, max_new,
                                         streamed=True)
    _disagg_check("serve (f)", st, counts, counts_a)
    if outs != outs_a or st["oom_events"] != 2 or seen["calls"] < 3 \
            or st["breaker_state"] != "closed" \
            or checked.get("prefill_launches") != st["prefills"] \
            or checked.get("handoff_copy") != seen["calls"] \
            or checked.get("decode_greedy") != st["decode_steps"]:
        raise AssertionError(f"serve (f): tokens equal {outs == outs_a}, "
                             f"oom_events {st['oom_events']}, copies "
                             f"{seen}, sync-checked {checked}")
    out["fp32"] = {"wall_s": wall, "launches": counts, "stats": st,
                   "sync_checked": checked, "faults": seen}
    emit("serve", leg="f", cache="float32", disagg=True,
         tokens_equal_monolithic=True, streams_equal=True,
         b4_launches=counts["flash_fwd"],
         b4_launches_monolithic=counts_a["flash_fwd"],
         b7_launches=counts["decode_attention"],
         decode_steps=st["decode_steps"],
         b7_want=layers * st["decode_steps"], prefills=st["prefills"],
         handoff=st["disagg"]["handoff"], sync_checked_launches=checked,
         torn_pairs=seen.get("torn_pairs"), copy_calls=seen["calls"],
         wall_s=round(wall, 4), **_pipeline_fields(st))
    bps = server.engine.blocks_per_seq
    del server

    tight = InferenceServer(cfg, params, cache_dtype=torch.float32,
                            enable_disagg=True, disagg_prefill_blocks=bps + 1,
                            **common)
    outs_t, wall, counts_t, st_t = _serve_once(tight, prompts, max_new)
    _disagg_check("serve (f) tight", st_t, counts_t, counts_a)
    if outs_t != outs_a or st_t["disagg"]["prefill_blocks_usable"] != bps:
        raise AssertionError(f"serve (f) tight: tokens equal "
                             f"{outs_t == outs_a}, {st_t['disagg']}")
    out["tight"] = {"wall_s": wall, "launches": counts_t, "stats": st_t}
    emit("serve", leg="f", cache="float32", disagg=True,
         prefill_blocks_usable=st_t["disagg"]["prefill_blocks_usable"],
         prefill_blocks_live_peak=st_t["disagg"][
             "prefill_blocks_live_peak"],
         tokens_equal_monolithic=True, b4_launches=counts_t["flash_fwd"],
         b7_launches=counts_t["decode_attention"],
         decode_steps=st_t["decode_steps"], handoff=st_t["disagg"][
             "handoff"], wall_s=round(wall, 4))
    return counts, out


def _plain_layer_norm(mod, x):
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    n2 = mod.scale.numel()
    xhat, _, _ = ln._ln_forward_plain(x.reshape(-1, n2), mod.eps)
    return (xhat * mod.scale + mod.bias).to(x.dtype).reshape(x.shape)


def _plain_dropout(mod, x, key, window=None):
    tf = importlib.import_module("apex_tpu_torch.ops.threefry")
    return x if mod.rate == 0.0 else tf.dropout_plain(x, mod.rate, key,
                                                      window)


def _plain_oracle(model):
    """``model`` with every LayerNorm and every threefry dropout on its
    plain PyTorch version; its attention is the model's plain default.
    The oracle then shares no kernel with the path it checks."""
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")
    tf = importlib.import_module("apex_tpu_torch.ops.threefry")
    for mod in model.modules():
        if isinstance(mod, ln.FusedLayerNorm):
            mod.forward = functools.partial(_plain_layer_norm, mod)
        elif isinstance(mod, tf.Dropout):
            mod.forward = functools.partial(_plain_dropout, mod)
    return model


def _oracle_check(model, prompts, outs, kv_quant=False):
    """Greedy full recompute on the card through the plain oracle (with
    ``kv_quant``, K/V quantized at the source as the int8 pool holds
    them); returns (tokens compared, near-ties that ended a comparison).
    One causal forward a request over its prompt and served tokens: the
    logits at position len(prompt) - 1 + t see exactly the prompt and
    the first t served tokens, what a recompute before token t sees.
    Fails if the oracle launched any of the port's kernels."""
    import torch
    from apex_tpu_torch._kernels import launch_counts
    from apex_tpu_torch.ops import greedy_argmax
    compared = near_ties = 0
    before = launch_counts()
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = torch.tensor([list(p) + list(o[:-1])], device="cuda")
            logits = model(ids, kv_quant=kv_quant)[0, len(p) - 1:]
            refs = greedy_argmax(logits).tolist()
            top2 = torch.topk(logits, 2).values
            gaps = (top2[:, 0] - top2[:, 1]).tolist()
            for t, (got, ref, gap) in enumerate(zip(o, refs, gaps)):
                if got != ref:
                    if gap < NEAR_TIE_GAP:
                        near_ties += 1
                        break
                    raise AssertionError(
                        f"token {t} of a {len(p)}-token prompt: served {got}"
                        f" != oracle {ref} (top-2 gap {gap:.3g})")
                compared += 1
    if launch_counts() != before:
        raise AssertionError("the full-recompute oracle launched a port "
                             "kernel")
    return compared, near_ties


def _serve_model():
    """GPT-2 small's seed-0 model on the card with its plain oracle, its
    state dict and the serve traffic, built once a run (``_shared``) for
    serve, serve_q8 and serve_programs; serve_programs drops it at its
    end."""
    return _shared("gpt2_small_serve", _build_serve_model)


def _build_serve_model():
    from apex_tpu_torch.models import GPTLMHeadModel, gpt_small
    cfg = gpt_small()
    model = GPTLMHeadModel(cfg, device="cuda", seed=0).eval()
    return {"cfg": cfg, "params": model.state_dict(),
            "oracle": _plain_oracle(model), "prompts": _make_prompts(cfg)}


P_PREDICTION = {
    "tokens": "the pipelined and synchronous loops give the same tokens "
              "and launches on the fp32, bf16 and int8 pools, greedy and "
              "stochastic; the fp32 passes equal the greedy full recompute "
              "but at top-2 gaps < 1e-3",
    "sync_debug": "no decode or verify launch waits on the card",
    "oom": "the injected OOMs retry bit for bit, launches exact",
    "tokens_per_s": "pipelined within 0.95-1.08x synchronous on the bf16 "
                    "and int8 pools, inside the host's pass-to-pass "
                    "spread: the window hides only the device tail after "
                    "a step's last launch, and the engine's copies no "
                    "longer block in either loop",
    "idle_share": "0.75-0.9 in both loops (the synchronous loop's earlier "
                  "profiles: 0.81 bf16, 0.89 int8)",
    "host_stall_ms": "p50 under 0.1: the card has finished a step before "
                     "the host comes to retire it",
    "host_plan_ms": "p50 10-20, the whole host step: the path is "
                    "host-bound",
    "disagg": "(f) the disaggregated server's tokens (a)'s exactly on the "
              "fp32 pool, with the tightest prefill pool too (the same "
              "programs on the same contexts; the copy moves every byte), "
              "and (a)'s but at near-ties on the int8 pool; B4 launches "
              "the monolithic pass's; no decode launch, prefill slice or "
              "hand-off copy waits on the card; the torn and the delayed "
              "copy retried whole, oom_events 2; every stream exactly its "
              "request's tokens",
}


def phase_serve():
    import torch
    from apex_tpu_torch.serving import InferenceServer

    emit("serve", prediction=P_PREDICTION)
    shared = _serve_model()
    cfg, params, oracle, prompts = (shared[k] for k in (
        "cfg", "params", "oracle", "prompts"))
    max_new = 32
    common = dict(device="cuda", max_batch_size=8, block_size=16,
                  kv_quant="off", enable_chunked_prefill=False,
                  **LAYERS_OFF)
    results = {}

    # (a) fp32 cache against greedy full recompute: the pipelined loop,
    # its decode launches under sync-debug "error", then the synchronous
    # loop, whose tokens and launches must be the same
    server = InferenceServer(cfg, params, cache_dtype=torch.float32, **common)
    checked = {}
    _sync_checked_launches(server, checked)
    outs_a, wall, counts, st = _serve_once(server, prompts, max_new)
    compared, near_ties = _oracle_check(oracle, prompts, outs_a)
    sync = InferenceServer(cfg, params, cache_dtype=torch.float32,
                           enable_pipeline=False, **common)
    outs_s, wall_s, counts_s, st_s = _serve_once(sync, prompts, max_new)
    if outs_s != outs_a or counts_s != counts \
            or not checked.get("decode_greedy"):
        raise AssertionError(f"serve (a): synchronous tokens equal "
                             f"{outs_s == outs_a}, launches {counts_s} "
                             f"against {counts}, sync-checked {checked}")
    results["fp32"] = {"wall_s": wall, "tokens_per_s": st["tokens_generated"]
                       / wall, "launches": counts, "stats": st,
                       "oracle_tokens_compared": compared,
                       "near_ties": near_ties, "sync_checked": checked,
                       "synchronous": {"wall_s": wall_s, "stats": st_s}}
    emit("serve", cache="float32", tokens=st["tokens_generated"],
         wall_s=round(wall, 4), wall_s_synchronous=round(wall_s, 4),
         prefills=st["prefills"], decode_steps=st["decode_steps"],
         launches=counts, oracle_tokens_compared=compared,
         near_ties=near_ties, preemptions=st["preemptions"],
         synchronous_tokens_equal=True, sync_checked_launches=checked,
         **_pipeline_fields(st))
    del server, sync
    counts_a = counts

    # (f) disaggregated prefill/decode: (a)'s prompts, tokens and B4
    # launches
    counts_f, results["disagg"] = _serve_disagg(shared, common, outs_a,
                                                counts_a)

    # (b) the default bf16 cache, timed: the pipelined loop's passes after
    # a warm-up (the wall is host-bound and the host's CPU is shared),
    # then a pass under the profiler; one synchronous pass gives the same
    # tokens and launches
    server = InferenceServer(cfg, params, **common)
    server.generate(prompts[:2], max_new_tokens=2)
    passes = []
    for _ in range(TIMED_SERVE_PASSES):
        server.engine.reset_cache()
        outs_b, wall, counts, st = _serve_once(server, prompts, max_new)
        passes.append(st["tokens_generated"] / wall)
    sync = InferenceServer(cfg, params, enable_pipeline=False, **common)
    outs_s, _, counts_s, _ = _serve_once(sync, prompts, max_new)
    if outs_s != outs_b or counts_s != counts:
        raise AssertionError("serve (b): the synchronous loop's tokens or "
                             "launches differ from the pipelined loop's")
    del sync
    agree = sum(a == b for oa, ob in zip(outs_a, outs_b)
                for a, b in zip(oa, ob)) / (len(prompts) * max_new)
    tokens_per_s = statistics.median(passes)
    profile = _profile_serve(server, prompts, max_new,
                             label="serve_pipelined")
    results["bf16"] = {"token_agreement_with_fp32": agree,
                       "tokens_per_s": tokens_per_s,
                       "tokens_per_s_passes": passes, "launches": counts,
                       "stats": st, "profile": profile,
                       "synchronous_tokens_equal": True}
    emit("serve", cache="bfloat16", loop="pipelined",
         tokens=st["tokens_generated"], tokens_per_s=tokens_per_s,
         tokens_per_s_passes=passes,
         device_idle_share=profile.get("device_idle_share"),
         batch_occupancy_avg=st["batch_occupancy_avg"],
         queue_depth_peak=st["queue_depth_peak"],
         preemptions=st["preemptions"], prefills=st["prefills"],
         decode_steps=st["decode_steps"], launches=counts,
         token_agreement_with_fp32=round(agree, 4),
         synchronous_tokens_equal=True, **_pipeline_fields(st))
    # (c) card OOMs injected at two decode launches of the pipelined
    # server: the same tokens, the OOMs counted, the launches exact
    flaky = server
    seen = _inject_ooms(flaky.engine, DECODE_OOM_AT)
    flaky.engine.reset_cache()
    outs_c, _, counts_c, st_c = _serve_once(flaky, prompts, max_new)
    want_ooms = sum(map(len, DECODE_OOM_AT.values()))
    if outs_c != outs_b or st_c["oom_events"] != want_ooms \
            or st_c["breaker_state"] != "closed":
        raise AssertionError(f"serve (c): tokens equal {outs_c == outs_b}, "
                             f"oom_events {st_c['oom_events']}, calls "
                             f"{seen}, breaker {st_c['breaker_state']}")
    results["oom"] = {"calls": seen, "launches": counts_c, "stats": st_c}
    emit("serve", cache="bfloat16", run="decode_oom", tokens_equal=True,
         calls=seen, decode_steps=st_c["decode_steps"], launches=counts_c,
         **_pipeline_fields(st_c))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "serve.json").write_text(json.dumps(results, indent=1,
                                                   default=str))
    return {"serve_disagg": counts_f, "serve": counts}


def _lcp(a, b):
    """Length of the agreeing prefix of two token lists."""
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def _serve_emit(label, st, wall, counts, **fields):
    emit("serve_q8", run=label, tokens=st["tokens_generated"],
         wall_s=round(wall, 4), tokens_per_s=st["tokens_generated"] / wall,
         prefills=st["prefills"], decode_steps=st["decode_steps"],
         preemptions=st["preemptions"], launches=counts,
         **_pipeline_fields(st), **fields)


def phase_serve_q8():
    """The int8-pool serving path, (a)-(c) of the module docstring;
    returns the launch counts of the last timed pass of (b)."""
    import torch
    from apex_tpu_torch.serving import InferenceServer, KVCacheConfig

    shared = _serve_model()
    cfg, params, oracle, prompts = (shared[k] for k in (
        "cfg", "params", "oracle", "prompts"))
    max_new = 32
    results = {}

    # (a) fp32 compute against the int8 full recompute
    server = InferenceServer(cfg, params, device="cuda", max_batch_size=8,
                             block_size=16, cache_dtype=torch.float32,
                             kv_quant="int8", enable_chunked_prefill=False,
                             **LAYERS_OFF)
    outs_a, wall, counts, st = _serve_once(server, prompts, max_new)
    mem = st["memory"]
    if mem["cache_dtype"] != "int8" or \
            mem["bytes_per_block"] != Q8_BYTES_PER_BLOCK:
        raise AssertionError(f"serve_q8: the pool is not the int8 one: "
                             f"{mem}")
    compared, near_ties = _oracle_check(oracle, prompts, outs_a,
                                        kv_quant=True)
    results["oracle"] = {"wall_s": wall, "launches": counts, "stats": st,
                         "oracle_tokens_compared": compared,
                         "near_ties": near_ties}
    _serve_emit("oracle", st, wall, counts, memory=mem,
                oracle_tokens_compared=compared, near_ties=near_ties)
    common = dict(device="cuda", max_batch_size=8, block_size=16,
                  cache_dtype=torch.float32, kv_quant="int8",
                  enable_chunked_prefill=False, **LAYERS_OFF)

    # (f) disaggregated prefill/decode from the int8 pool (B8 in the
    # decode pool): (a)'s tokens, but where the two part at an oracle
    # near-tie, and (a)'s B4 launches
    disagg = InferenceServer(cfg, params, enable_disagg=True, **common)
    outs_d, wall_d, counts_d, st_d = _serve_once(disagg, prompts, max_new)
    _disagg_check("serve_q8 (f)", st_d, counts_d, counts)
    same, near_d = _same_but_near_ties(oracle, prompts, outs_d, outs_a,
                                       True)
    results["disagg"] = {"wall_s": wall_d, "launches": counts_d,
                         "stats": st_d, "tokens_equal_to_a": same,
                         "near_ties": near_d}
    _serve_emit("disagg", st_d, wall_d, counts_d, tokens_equal_to_a=same,
                near_ties=near_d, b4_launches_monolithic=counts[
                    "flash_fwd"], b8_want=cfg.num_hidden_layers
                * st_d["decode_steps"], handoff=st_d["disagg"]["handoff"])
    del disagg

    # (b) the same server timed, its pass after a warm-up; one pass of its
    # synchronous twin: the pipelined pass's tokens are (a)'s, the
    # synchronous pass's tokens and launches theirs
    server.generate(prompts[:2], max_new_tokens=2)
    passes = []
    for _ in range(TIMED_SERVE_PASSES):
        server.engine.reset_cache()
        outs_b, wall, timed_counts, st = _serve_once(server, prompts,
                                                     max_new)
        passes.append(st["tokens_generated"] / wall)
    sync = InferenceServer(cfg, params, enable_pipeline=False, **common)
    outs_s, _, counts_s, _ = _serve_once(sync, prompts, max_new)
    if outs_b != outs_a or outs_s != outs_a or counts_s != timed_counts:
        raise AssertionError("serve_q8 (b): the timed passes' tokens or "
                             "launches differ from (a)'s")
    results["timed_pipelined"] = {
        "tokens_per_s": statistics.median(passes),
        "tokens_per_s_passes": passes, "launches": timed_counts,
        "stats": st, "same_tokens_as_a": True,
        "synchronous_tokens_equal": True}
    _serve_emit("timed_pipelined", st, wall, timed_counts,
                tokens_per_s_median=statistics.median(passes),
                tokens_per_s_passes=passes,
                batch_occupancy_avg=st["batch_occupancy_avg"],
                same_tokens_as_a=True, synchronous_tokens_equal=True)
    del server, sync

    # (c) equal pool bytes: bf16 blocks against int8 blocks
    geometry = dict(num_layers=cfg.num_hidden_layers,
                    num_heads=cfg.num_attention_heads,
                    head_dim=cfg.hidden_size // cfg.num_attention_heads,
                    block_size=16, num_blocks=2, dtype=torch.bfloat16)
    budget = EQUAL_BYTES_BF16_BLOCKS * KVCacheConfig(
        **geometry).bytes_per_block
    q8_blocks = budget // KVCacheConfig(quantize="int8",
                                        **geometry).bytes_per_block
    arms, outs = {}, {}
    for arm, quant, blocks in (("bfloat16", "off", EQUAL_BYTES_BF16_BLOCKS),
                               ("int8", "int8", q8_blocks)):
        srv = InferenceServer(cfg, params, device="cuda",
                              max_batch_size=EQUAL_BYTES_SLOTS,
                              block_size=16, num_blocks=blocks,
                              cache_dtype=torch.bfloat16, kv_quant=quant,
                              enable_chunked_prefill=False, **LAYERS_OFF)
        srv.generate(prompts[:2], max_new_tokens=2)
        srv.engine.reset_cache()
        outs[arm], wall, counts, st = _serve_once(srv, prompts, max_new)
        mem = st["memory"]
        if mem["pool_bytes"] > budget:
            raise AssertionError(f"serve_q8 {arm} arm: pool of "
                                 f"{mem['pool_bytes']} B over {budget} B")
        arms[arm] = {"blocks_usable": mem["blocks_usable"],
                     "blocks_live_peak": mem["blocks_live_peak"],
                     "pool_bytes": mem["pool_bytes"],
                     "bytes_per_block": mem["bytes_per_block"],
                     "preemptions": st["preemptions"],
                     "decode_steps": st["decode_steps"],
                     "prefills": st["prefills"],
                     "tokens_per_s": st["tokens_generated"] / wall}
        _serve_emit(f"equal_bytes_{arm}", st, wall, counts,
                    **{key: arms[arm][key] for key in (
                        "blocks_usable", "blocks_live_peak", "pool_bytes",
                        "bytes_per_block")})
        del srv
    agree = sum(_lcp(a, b) for a, b in zip(outs["int8"], outs["bfloat16"])) \
        / sum(len(o) for o in outs["bfloat16"])
    results["equal_bytes"] = {"budget_bytes": budget, "arms": arms,
                              "agreeing_prefix_mean": agree}
    emit("serve_q8", run="equal_bytes", budget_bytes=budget,
         agreeing_prefix_mean=round(agree, 4),
         blocks_usable={a: arms[a]["blocks_usable"] for a in arms})
    if not agree >= Q8_AGREEMENT_MIN:
        raise AssertionError(f"serve_q8: int8 tokens agree with bf16's to "
                             f"a mean prefix of {agree:.3f} < "
                             f"{Q8_AGREEMENT_MIN}")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "serve_q8.json").write_text(json.dumps(results, indent=1,
                                                      default=str))
    return {"serve_q8_disagg": counts_d, "serve_q8": timed_counts}


# -- serve_programs ----------------------------------------------------------

# the engine's remaining programs on serve's model and traffic: the prefill
# chunk, verify's width, the stochastic leg's requests (serve's first 8
# prompts), their classes (one seed a request) and a pool small enough
# that those 8 preempt (they end needing 89 blocks)
PROGRAMS_CHUNK = 64
VERIFY_K = 4
PROGRAMS_BLOCKS = 200
SAMPLED_PROMPTS = 8
STARVED_BLOCKS = 45
SAMPLING_CLASSES = (None, {"temperature": 0.8},
                    {"temperature": 1.0, "top_k": 40},
                    {"temperature": 1.0, "top_p": 0.9},
                    {"temperature": 0.8, "top_k": 40, "top_p": 0.9})
# |card - CPU| of the Gumbel noise, in float32 epsilons of max(|x|, 1)
NOISE_ULPS = 4
# verify's logits against four decode steps, scale-aware, a pool: about
# 9x and 7x the sound readings (1.10e-4 bf16, 2.9e-5 int8); a verify fed
# one position late must land above it
VERIFY_TOL = {"bfloat16": 1e-3, "int8": 2e-4}
# (e) a long prompt arriving while the other slots decode: its length,
# the decoders' new tokens, the decode steps before it arrives and the
# long request's own new tokens
STALL_PROMPT = 1000
STALL_DECODERS = 7
STALL_NEW = 40
STALL_AT = 8
STALL_LONG_NEW = 8

S_PREDICTION = {
    "a_tokens": "equal the greedy full recompute but at top-2 gaps < 1e-3, "
                "as serve (a)",
    "a_launches": "exact: B2 (2L+1) x (chunks + decode steps), B4 0, B7 L "
                  "a decode step; 43 chunks for the 16 prompts at 64",
    "b_int8": "tokens equal the int8 oracle but at near-ties; B8 L a "
              "decode step, B7 0",
    "c_verify": "verify's (8, 4, V) logits within 2e-2 scale-aware of 4 "
                "decode steps' (bf16 pool: the in-chunk K/V are not rounded "
                "to bf16; int8: ~1e-5), argmax equal but at near-ties; "
                "copies, the hand-off and export/import bit for bit",
    "d_sampling": "replay, the greedy rows and the starved pool's streams "
                  "bit for bit; the card's uniform bits the CPU's, its "
                  "noise within 4 eps of max(|x|, 1)",
    "phase_s": "30-60",
    "c_fault": "verify fed one position late (the context off by one "
               "slot): > 1e-2 scale-aware on both pools, far above "
               "VERIFY_TOL",
    "e_stall": "7 slots decoding when a 1000-token prompt arrives (bf16 "
               "pool): the decoders' largest inter-token gap ~1.5-3x "
               "their median under the default chunk (256, four chunks "
               "in four steps) and ~3-6x under the monolithic prefill "
               "(one 1000-row forward in one step); p99 (of ~270 gaps) "
               "the same order, as the 7 stalled gaps are 2.6% of them; "
               "the long request's first token later when chunked "
               "(1.2-2x the monolithic time to first token)",
    "e_disagg": "the disaggregated server's largest decoder gap 0.8-1.25x "
                "the chunked server's in the same pass (the path is "
                "host-bound: each step still launches the decode step and "
                "a chunk from one host thread, and the second stream "
                "hides only the chunk's device time, which the host's "
                "launch time already covers); its median gap within "
                "0.9-1.1x chunked; the long request's first token "
                "1.0-1.3x chunked's (its hand-off and first decode come "
                "a step after the last chunk)",
}


def _chunks(prompts, chunk):
    return sum(-(-len(p) // chunk) for p in prompts)


def _programs_server(shared, quant, dtype, **kw):
    from apex_tpu_torch.serving import InferenceServer
    kw = {**LAYERS_OFF, **kw}
    return InferenceServer(shared["cfg"], shared["params"], device="cuda",
                           max_batch_size=8, block_size=16, cache_dtype=dtype,
                           kv_quant=quant, **kw)


def _programs_chunked(shared, quant, max_new):
    """(a) fp32 pool, (b) int8 pool: chunked serving at PROGRAMS_CHUNK
    against the oracle, launches exact, chunks counted (the timed passes
    are (a)'s on the bf16 pool, beside the monolithic prefill)."""
    import torch
    prompts = shared["prompts"]
    server = _programs_server(shared, quant, torch.float32,
                              prefill_chunk=PROGRAMS_CHUNK)
    outs, wall, counts, st = _serve_once(server, prompts, max_new)
    want_chunks = _chunks(prompts, PROGRAMS_CHUNK)
    if st["prefill_chunks"] != want_chunks or st["preemptions"] \
            or st["prefills"]:
        raise AssertionError(f"serve_programs {quant}: {st['prefills']} "
                             f"prefills, {st['prefill_chunks']} chunks "
                             f"(want {want_chunks}), {st['preemptions']} "
                             f"preemptions")
    compared, near_ties = _oracle_check(shared["oracle"], prompts, outs,
                                        kv_quant=quant == "int8")
    out = {"wall_s": wall, "launches": counts, "stats": st,
           "prefill_chunks": st["prefill_chunks"],
           "chunk_iters_peak": st["chunk_iters_peak"],
           "oracle_tokens_compared": compared, "near_ties": near_ties}
    emit("serve_programs", leg="a" if quant == "off" else "b", pool=quant,
         tokens=st["tokens_generated"], prefill_chunks=st["prefill_chunks"],
         chunk_iters_peak=st["chunk_iters_peak"],
         decode_steps=st["decode_steps"], launches=counts,
         **{k: v for k, v in out.items()
            if k not in ("launches", "stats", "prefill_chunks",
                         "chunk_iters_peak")})
    return counts, out


def _near_tie_argmax(got, want):
    """Rows whose argmax differs: each must have a top-2 gap in ``want``
    below twice that row's largest |got - want| (else AssertionError);
    returns their count."""
    from apex_tpu_torch.ops import greedy_argmax
    g, w = greedy_argmax(got), greedy_argmax(want)
    bad = (g != w).nonzero().tolist()
    for idx in bad:
        top2 = want[tuple(idx)].topk(2).values
        gap = float(top2[0] - top2[1])
        diff = float((got[tuple(idx)] - want[tuple(idx)]).abs().max())
        if gap >= 2 * diff:
            raise AssertionError(f"verify argmax {g[tuple(idx)]} != decode "
                                 f"{w[tuple(idx)]} at {idx} (top-2 gap "
                                 f"{gap:.3g}, |diff| {diff:.3g})")
    return len(bad)


def _same_rows(a, a_blocks, b, b_blocks, label):
    """Every leaf of ``a``'s pool at ``a_blocks`` equals ``b``'s at
    ``b_blocks`` bit for bit."""
    import torch
    sa = torch.from_numpy(a._block_slots(a_blocks, len(a_blocks))).cuda()
    sb = torch.from_numpy(b._block_slots(b_blocks, len(b_blocks))).cuda()
    for name in a.cache:
        if not torch.equal(a.cache[name][:, sa], b.cache[name][:, sb]):
            raise AssertionError(f"serve_programs (c) {label}: leaf {name} "
                                 f"differs")


def _programs_engine(shared, quant):
    """(c) verify against decode steps from the same pool, the block
    copies, the cross-engine copy and export/import, on a bf16 or an int8
    pool (bf16 compute dtype)."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.ops import greedy_argmax
    from apex_tpu_torch.serving import BlockAllocator, DecodeEngine
    cfg, prompts = shared["cfg"], shared["prompts"][:8]
    layers = cfg.num_hidden_layers
    kw = dict(device="cuda", max_batch_size=8, block_size=16,
              cache_dtype=torch.bfloat16, kv_quant=quant,
              num_blocks=PROGRAMS_BLOCKS)
    eng = DecodeEngine(cfg, shared["params"], **kw)
    other = DecodeEngine(cfg, shared["params"], **kw)
    tables, first = [], []
    for p in prompts:
        table = eng.allocator.alloc(BlockAllocator.blocks_for(
            len(p) + VERIFY_K, 16))
        for start in range(0, len(p), PROGRAMS_CHUNK):
            ids, _ = eng.chunk_prefill_sampled(
                p[start:start + PROGRAMS_CHUNK], start, table,
                pad_to=PROGRAMS_CHUNK)
        tables.append(table)
        first.append(int(ids[0]))
    tab = np.zeros((8, eng.blocks_per_seq), np.int64)
    for i, t in enumerate(tables):
        tab[i, :len(t)] = t
    pos = np.array([len(p) for p in prompts])
    snapshot = {n: t.clone() for n, t in eng.cache.items()}
    fed, logits, toks = [], [], first
    for j in range(VERIFY_K):
        fed.append(toks)
        step = eng.decode(np.array(toks), pos + j, tab)
        logits.append(step)
        toks = greedy_argmax(step).tolist()
    dec = torch.stack(logits, dim=1)
    for n, t in eng.cache.items():
        t.copy_(snapshot[n])
    torch.cuda.synchronize()
    reset_launch_counts()
    ver = eng.verify(np.array(fed).T, np.full(8, VERIFY_K), pos, tab)
    torch.cuda.synchronize()
    counts = launch_counts()
    want_counts = {name: (2 * layers + 1 if name == "layer_norm_fwd" else 0)
                   for name in counts}
    if counts != want_counts:
        raise AssertionError(f"serve_programs (c): verify launched {counts}")
    err, max_abs = scale_aware_err(ver, dec)
    near = _near_tie_argmax(ver, dec)
    kind = quant or "bfloat16"
    if not err <= VERIFY_TOL[kind]:
        raise AssertionError(f"serve_programs (c) {kind}: verify logits "
                             f"{err:.3g} from decode's (limit "
                             f"{VERIFY_TOL[kind]})")
    # a plausible fault, the context off by one slot, must fail the gate
    fault, _ = scale_aware_err(eng.verify(np.array(fed).T,
                                          np.full(8, VERIFY_K), pos + 1,
                                          tab), dec)
    if not fault > VERIFY_TOL[kind]:
        raise AssertionError(f"serve_programs (c) {kind}: a verify one "
                             f"position late reads {fault:.3g}, within "
                             f"the limit {VERIFY_TOL[kind]}")
    # block copies inside the pool: a chained batch reads the old blocks
    fresh = eng.allocator.alloc(3)
    before = {n: t.clone() for n, t in eng.cache.items()}
    eng.copy_blocks([(tables[0][0], fresh[0]), (fresh[0], fresh[1]),
                     (tables[0][1], fresh[2])])
    for src, dst in ((tables[0][0], fresh[0]), (fresh[0], fresh[1]),
                     (tables[0][1], fresh[2])):
        for name, pool in eng.cache.items():
            if not torch.equal(pool[:, dst * 16:(dst + 1) * 16],
                               before[name][:, src * 16:(src + 1) * 16]):
                raise AssertionError(f"serve_programs (c) copy_blocks: "
                                     f"{src} -> {dst} leaf {name}")
    # another engine's pool: the hand-off copy, then export -> import
    dst = other.allocator.alloc(len(tables[1]))
    other.copy_blocks_from(eng, list(zip(tables[1], dst)))
    _same_rows(eng, tables[1], other, dst, "copy_blocks_from")
    payload = eng.export_blocks(tables[2])
    dst = other.allocator.alloc(len(tables[2]))
    other.import_blocks(dst, payload)
    _same_rows(eng, tables[2], other, dst, "export/import")
    kept = {n: t.clone() for n, t in other.cache.items()}
    leaf = min(payload["leaves"])
    torn = payload["leaves"][leaf].copy()
    torn.view(np.uint8).reshape(-1)[0] ^= 0xFF
    try:
        other.import_blocks(other.allocator.alloc(len(tables[2])), {
            **payload, "leaves": {**payload["leaves"], leaf: torn}})
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("serve_programs (c): a torn payload imported")
    other.import_blocks([], other.export_blocks([]))
    for name, t in other.cache.items():
        if not torch.equal(t, kept[name]):
            raise AssertionError(f"serve_programs (c): a refused or empty "
                                 f"import wrote leaf {name}")
    out = {"verify_err": err, "verify_max_abs": max_abs,
           "verify_limit": VERIFY_TOL[kind], "verify_fault_err": fault,
           "verify_argmax_near_ties": near, "verify_launches": counts,
           "payload_bytes": sum(a.nbytes for a in payload["leaves"].values()),
           "torn_refused": refused[:80]}
    emit("serve_programs", leg="c", pool=kind, **{
        k: v for k, v in out.items() if k != "verify_launches"})
    return out


def _programs_sampling(shared, max_new):
    """(d) mixed sampling classes on the bf16 pool: the pipelined loop
    (its launches under sync-debug "error") against the synchronous
    loop, the greedy rows against a greedy-only pass and a starved pool,
    each bit for bit; the card's keys, uniform bits and noise against
    the CPU's; the pipelined pass once more under the profiler."""
    import torch
    from apex_tpu_torch.ops import sampling, threefry
    from apex_tpu_torch.serving import SamplingParams
    prompts = shared["prompts"][:SAMPLED_PROMPTS]
    samp = [None if c is None else SamplingParams(seed=1000 + i, **c)
            for i, c in zip(range(len(prompts)),
                            itertools.cycle(SAMPLING_CLASSES))]
    server = _programs_server(shared, "off", torch.bfloat16,
                              prefill_chunk=PROGRAMS_CHUNK)
    sync = _programs_server(shared, "off", torch.bfloat16,
                            prefill_chunk=PROGRAMS_CHUNK,
                            enable_pipeline=False)
    checked = {}
    _sync_checked_launches(server, checked)
    runs = {}
    for run, srv in (("pipelined", server), ("synchronous", sync)):
        runs[run] = _serve_once(srv, prompts, max_new, sampling=samp)
    del sync
    outs, _, counts, st = runs["pipelined"]
    server.engine.reset_cache()
    greedy = _serve_once(server, prompts, max_new)[0]
    starved = _programs_server(shared, "off", torch.bfloat16,
                               prefill_chunk=PROGRAMS_CHUNK,
                               num_blocks=STARVED_BLOCKS)
    starved_outs, _, _, starved_st = _serve_once(starved, prompts, max_new,
                                                 sampling=samp)
    classes = {}
    for s in samp:
        k = "greedy" if s is None else s.klass
        classes[k] = classes.get(k, 0) + 1
    checks = {
        "synchronous": runs["synchronous"][0] == outs
        and runs["synchronous"][2] == counts,
        "sync_checked_stochastic_decode":
            checked.get("decode_stochastic", 0) > 0,
        "greedy_rows": all(o == g for o, g, s in zip(outs, greedy, samp)
                           if s is None),
        "stochastic_rows_differ": any(o != g for o, g, s in
                                      zip(outs, greedy, samp) if s),
        "starved_pool": starved_outs == outs,
        "starved_preempted": starved_st["preemptions"] > 0,
        "class_counts": st["sampling"]["requests"] == classes,
    }
    # one key a request at its first sampled position
    seeds = torch.tensor([s.seed if s else 0 for s in samp])
    pos = torch.tensor([len(p) for p in prompts])
    keys = threefry.fold_in_rows(threefry.fold_in_rows(
        threefry.key_rows(seeds), pos), sampling.SALT_SAMPLE)
    keys_card = threefry.fold_in_rows(threefry.fold_in_rows(
        threefry.key_rows(seeds.cuda()), pos.cuda()), sampling.SALT_SAMPLE)
    vocab = shared["cfg"].vocab_size
    tiny = torch.finfo(torch.float32).tiny
    checks["keys"] = torch.equal(keys_card.cpu(), keys)
    checks["uniform_bits"] = torch.equal(
        threefry.uniform_rows(keys_card, vocab, tiny, 1.0).cpu(),
        threefry.uniform_rows(keys, vocab, tiny, 1.0))
    noise = sampling.sampling_noise(seeds.cuda(), pos.cuda(), vocab).cpu()
    want = sampling.sampling_noise(seeds, pos, vocab)
    eps = torch.finfo(torch.float32).eps
    ulps = float(((noise - want).abs()
                  / (eps * want.abs().clamp_min(1.0))).max())
    checks["noise_within_ulps"] = ulps <= NOISE_ULPS
    rates = {run: r[3]["tokens_generated"] / r[1] for run, r in runs.items()}
    emit("serve_programs", leg="d", launches=counts,
         preemptions_starved=starved_st["preemptions"],
         noise_ulps=ulps, classes=classes, tokens_per_s=rates,
         sync_checked_launches=checked, **checks)
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_programs (d) failed: {failed}")
    server.engine.reset_cache()
    profile = _profile("serve_programs_stochastic", lambda: server.generate(
        prompts, max_new_tokens=max_new, sampling=samp))
    return counts, {"checks": checks, "noise_ulps": ulps,
                    "sync_checked": checked,
                    "launches": counts, "stats": st, "tokens_per_s": rates,
                    "starved_stats": starved_st, "profile": profile}


def _stall_pass(server, shorts, long_prompt):
    """(e) one pass: the short requests decode, the long prompt arrives
    after ``STALL_AT`` steps; returns the decoders' inter-token gaps (ms,
    from each step that gave a request tokens to the next; its first
    step gives two, the prefill's and a decode's), the long request's
    time to its first token (ms), the stats, the launches, where the
    largest gap and the long request's first token fell (steps after
    its arrival) and the largest gap from its arrival on.  A token counts
    when the step that applied it returns (the pipelined loop applies a
    token at its retire, after waiting on that step's own event), with
    no wait on the rest of the card's work: under disaggregation the
    prefill stream's chunks run on while the decoders' tokens retire."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    for engine in (server.engine, server.prefill_engine):
        if engine is not None:
            engine.reset_cache()
    torch.cuda.synchronize()
    reset_launch_counts()
    server.reset_meters()
    reqs = [server.submit(p, STALL_NEW) for p in shorts]
    seen = {}
    gaps, gap_steps, long_req, ttft, steps = [], [], None, None, 0
    while server.has_work:
        if steps == STALL_AT:
            long_req = server.submit(long_prompt, STALL_LONG_NEW)
            t_submit = time.perf_counter()
        server.step()
        now, steps = time.perf_counter(), steps + 1
        for i, r in enumerate(reqs):
            n = len(r.generated)
            if n and seen.get(i, (0, 0))[0] != n:
                if i in seen:
                    gaps.append((now - seen[i][1]) * 1e3)
                    gap_steps.append(steps - STALL_AT)
                seen[i] = (n, now)
        if long_req is not None and ttft is None and long_req.generated:
            ttft = (now - t_submit) * 1e3
            ttft_step = steps - STALL_AT
    counts, st = launch_counts(), server.stats()
    layers = server.engine.cfg.num_hidden_layers
    forwards = st["prefills"] + st["prefill_chunks"] + st["decode_steps"]
    chunked = server.prefill_chunk is not None
    want_chunks = (sum(-(-len(p) // server.prefill_chunk)
                       for p in [*shorts, long_prompt]) if chunked else 0)
    if counts["layer_norm_fwd"] != (2 * layers + 1) * forwards \
            or counts["flash_fwd"] != layers * st["prefills"] \
            or st["prefill_chunks"] != want_chunks \
            or st["prefills"] != (0 if chunked else len(shorts) + 1) \
            or [len(r.generated) for r in reqs] != [STALL_NEW] * len(reqs) \
            or len(long_req.generated) != STALL_LONG_NEW:
        raise AssertionError(f"serve_programs (e): launches {counts}, "
                             f"{st['prefills']} prefills, "
                             f"{st['prefill_chunks']} chunks")
    where = {"gap_max_step": gap_steps[gaps.index(max(gaps))],
             "long_first_token_step": ttft_step,
             "gap_max_from_arrival_ms": max(
                 g for g, at in zip(gaps, gap_steps) if at >= 1)}
    return gaps, ttft, st, counts, where


def _programs_stall(shared):
    """(e) the stall a long prompt puts on a decoding batch: the default
    server (chunks of 256), the monolithic prefill and the
    disaggregated server (chunks of 256 on the prefill pool's stream) on
    the bf16 pool, passes in turns after a warm-up each; the decoders'
    median, p99 and largest inter-token gaps and the long request's
    time to first token, each the median over the passes."""
    import torch
    t0 = time.perf_counter()
    shorts = shared["prompts"][:STALL_DECODERS]
    long_prompt = np.random.default_rng(STALL_PROMPT).integers(
        0, shared["cfg"].vocab_size, STALL_PROMPT).tolist()
    servers = {"chunked": _programs_server(shared, "off", torch.bfloat16),
               "monolithic": _programs_server(shared, "off", torch.bfloat16,
                                              enable_chunked_prefill=False),
               "disagg": _programs_server(shared, "off", torch.bfloat16,
                                          enable_disagg=True)}
    for srv in servers.values():
        srv.generate([shorts[0], long_prompt[:300]], max_new_tokens=2)
    passes = {name: [] for name in servers}
    for _ in range(PROGRAMS_TIMED_PASSES):
        for name, srv in servers.items():
            gaps, ttft, st, counts, where = _stall_pass(srv, shorts,
                                                        long_prompt)
            pipe = st["pipeline"]
            passes[name].append({
                "gap_median_ms": statistics.median(gaps),
                "gap_p99_ms": float(np.percentile(gaps, 99)),
                "gap_max_ms": max(gaps), "gaps": len(gaps),
                "long_ttft_ms": ttft, "prefill_chunks": st["prefill_chunks"],
                "prefills": st["prefills"], "launches": counts,
                "host_stall_ms_max": pipe["host_stall_ms"].get("max"),
                "host_plan_ms_max": pipe["host_plan_ms"].get("max"),
                **where})
    out = {name: {k: statistics.median(p[k] for p in ps)
                  for k in ("gap_median_ms", "gap_p99_ms", "gap_max_ms",
                            "long_ttft_ms", "gap_max_step",
                            "long_first_token_step",
                            "gap_max_from_arrival_ms", "host_stall_ms_max",
                            "host_plan_ms_max")}
           for name, ps in passes.items()}
    out["chunk"] = servers["chunked"].prefill_chunk
    out["seconds"] = time.perf_counter() - t0
    emit("serve_programs", leg="e", **out)
    out["passes"] = passes
    return out


def phase_serve_programs():
    """The engine's remaining programs and stochastic sampling on serve's
    model and traffic, (a)-(d) of the module docstring; returns the
    launches of its three serving paths."""
    import torch
    t0 = time.perf_counter()
    emit("serve_programs", prediction=S_PREDICTION)
    shared = _serve_model()
    max_new = 32
    results = {}
    counts_a, results["a"] = _programs_chunked(shared, "off", max_new)
    counts_b, results["b"] = _programs_chunked(shared, "int8", max_new)
    results["c"] = {quant or "bfloat16": _programs_engine(shared, quant)
                    for quant in (None, "int8")}
    counts_d, results["d"] = _programs_sampling(shared, max_new)
    results["e"] = _programs_stall(shared)
    results["seconds"] = time.perf_counter() - t0
    emit("serve_programs", leg="done", seconds=round(results["seconds"], 3))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "serve_programs.json").write_text(
        json.dumps(results, indent=1, default=str))
    # a kernel reports the last path's launches: B7 serve_chunked's
    return {"serve_stochastic": counts_d, "serve_chunked": counts_a,
            "serve_chunked_q8": counts_b}


# -- serve_features ----------------------------------------------------------

# the reference server's default layers (prefix cache with COW, n-gram
# speculation, overload control) on serve's model
# (a)/(b): a 256-token system prompt (16 full blocks) shared by 16
# requests with tails of 8-64 tokens, and 2 requests that are the system
# prompt alone (whole-context hits: copy-on-write)
FEATURES_SYSTEM = 256
FEATURES_SHARED = 16
FEATURES_COW = 2
FEATURES_TAIL = (8, 64)
FEATURES_NEW = 32
# (c): 8 prompts, each an 8-32-token snippet repeated 4 times; the
# stochastic classes at a low temperature, one seed a request
FEATURES_SNIPPETS = 8
FEATURES_SNIPPET = (8, 32)
FEATURES_REPEATS = 4
FEATURES_STOCH = ({"temperature": 0.2}, {"temperature": 0.2, "top_k": 40},
                  {"temperature": 0.2, "top_p": 0.9},
                  {"temperature": 0.2, "top_k": 40, "top_p": 0.9})
# (d): a pool of 40 usable blocks for (a)'s traffic: the 16 shared blocks
# and 24 for 8 running requests' tails and tokens (each ends needing 2-7)
FEATURES_TIGHT_BLOCKS = 41
# (e): a burst at priorities 0 and 1 into a bounded queue, and the drain
BURST, BURST_WAITING, BURST_NEW = 48, 16, 8
DRAIN_AT = 3

F_PREDICTION = {
    "a_tokens": "equal the greedy full recompute but at top-2 gaps < "
                "1e-3, as serve (a)",
    "a_prefix": "17 of 18 requests hit the 16 system blocks: "
                "prefix_hit_tokens 17 x 256 = 4352, hit rate ~0.84, "
                "prefix_cow_blocks 2, audit clean",
    "b_int8": "the COW copies bit for bit (payload and scales); tokens "
              "equal the int8 server without the cache but at near-ties",
    "c_spec": "the random-weight model falls into short cycles on "
              "repeated snippets: acceptance 0.3-0.8, tokens a batched "
              "step 1.5-3.5; the stochastic replay bit for bit",
    "d_tight": "evictions and preemptions > 0, tokens still the oracle's",
    "e_burst": "16 queued, the rest rejected or displacing priority-1 "
               "work (shed); no priority-0 request shed",
    "launches": "exact: B2 2L+1 a forward (chunk, verify or decode "
                "step), B7/B8 L a decode step, none a verify step, B4 0 "
                "(the default server chunks)",
    "f_tokens": "every offload pass's 256 tokens equal the roomy "
                "offload-off server's exactly (fp32, int8, bf16 through "
                "the disk tier but its torn session, disaggregated); the "
                "torn session's its own cold prefill's, 0 near-ties",
    "f_tiers": "tight pool (60 blocks): each admission past the second "
               "evicts one whole session (26 blocks): demotes ~364 (156 "
               "in pass 1, 208 in pass 2), promotes 8 batches of 25 = "
               "200, host_dropped 0; disk: spills ~356, promotes_disk "
               "175, disk_torn 1",
    "f_launches": "B4 12 x 8 a pass (pass 1's cold prefills; 12 x 9 with "
                  "the torn or stalled session), B7/B8 12 x decode steps",
    "f_syncs": "no decode or verify launch syncs, in steps with a promote "
               "too; every demote export syncs (a .cpu() a leaf: 2 on fp32 "
               "and bf16, 4 on int8), no promote import does (pinned "
               "staging)",
    "f_walls": "a pass of 16 requests 1.5-3 s; offload passes 1.0-1.3x "
               "the roomy server's (a 25-block promote moves ~30 MB fp32 "
               "in each direction, ms against ~100 ms of host-bound steps "
               "a session), the disk tier 1.2-2x (its fsyncs), the socket "
               "1.1-1.3x (encode, loopback, decode)",
    "g_transport": "socket: the in-process tokens, delivered 8, retries "
                   "0; faults: the reset retried (retries 1) and its "
                   "promote exact, the stall skipped (transport_skips 1, "
                   "deadline_exceeded 1), its session cold, 0 near-ties",
    "phase_s": "25-45 before (f) and (g); they add 20-35",
}


def _features_traffic(cfg, seed=1):
    """(shared-prefix prompts with the 2 whole-prompt hits at the end,
    repeated-snippet prompts)."""
    rng = np.random.RandomState(seed)
    vocab = cfg.vocab_size
    system = list(rng.randint(0, vocab, size=FEATURES_SYSTEM))
    shared = [system + list(rng.randint(0, vocab, size=int(
        rng.randint(FEATURES_TAIL[0], FEATURES_TAIL[1] + 1))))
        for _ in range(FEATURES_SHARED)]
    shared += [list(system) for _ in range(FEATURES_COW)]
    snippets = [list(rng.randint(0, vocab, size=int(rng.randint(
        FEATURES_SNIPPET[0], FEATURES_SNIPPET[1] + 1)))) * FEATURES_REPEATS
        for _ in range(FEATURES_SNIPPETS)]
    return shared, snippets


def _features_server(shared, dtype, **kw):
    from apex_tpu_torch.serving import InferenceServer
    kw.setdefault("kv_quant", "off")
    return InferenceServer(shared["cfg"], shared["params"], device="cuda",
                           max_batch_size=8, block_size=16, cache_dtype=dtype,
                           **kw)


def _features_pass(server, first, rest, max_new, sampling=None):
    """Drive the default layers' main path once, every launch count at 0
    just before and read just after: the ``first`` prompts alone until
    each has its first token (their blocks register), then ``rest``.
    Checks the counts against the step accounting
    (:func:`_check_step_launches`) and the pool afterwards: nothing live,
    every block free or cached.  Returns (requests, wall s, counts,
    stats)."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    prompts = list(first) + list(rest)
    per = (list(sampling) if isinstance(sampling, (list, tuple))
           else [sampling] * len(prompts))
    torch.cuda.synchronize()
    reset_launch_counts()
    server.reset_meters()
    t0 = time.perf_counter()
    reqs = [server.submit(p, max_new, sampling=s)
            for p, s in zip(first, per)]
    while not all(r.generated or r.finished for r in reqs):
        server.step()
    reqs += [server.submit(p, max_new, sampling=s)
             for p, s in zip(rest, per[len(first):])]
    while server.has_work:
        server.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = server.stats()
    _check_step_launches("serve_features", server, counts, st)
    server.audit()
    alloc = server.engine.allocator
    cached = st.get("kv_blocks_evictable", 0)
    if alloc.num_live or alloc.num_free + cached != \
            server.engine.cache_cfg.num_blocks - 1:
        raise AssertionError(f"serve_features: {alloc.num_live} blocks "
                             f"live, {alloc.num_free} free, {cached} cached "
                             f"after the pass")
    vocab = server.engine.cfg.vocab_size
    for r in reqs:
        if len(r.generated) != max_new or r.finish_reason != "length" \
                or not all(0 <= t < vocab for t in r.generated):
            raise AssertionError(f"serve_features: request {r.uid} ended "
                                 f"{r.finish_reason} with {r.generated}")
    return reqs, wall, counts, st


def _check_step_launches(label, server, counts, st):
    """A pass's launches against its step accounting: 2L+1 LayerNorms a
    forward (a monolithic prefill, a chunk, a verify or a decode step), L
    flash attentions a monolithic prefill, L decode attentions a decode
    step (B8 from an int8 pool, B7 otherwise) and none a verify step;
    ``stats()["kernel_launches"]`` the same."""
    layers = server.engine.cfg.num_hidden_layers
    decode = ("decode_attention_q8" if server.engine.quantized
              else "decode_attention")
    forwards = (st["prefills"] + st["prefill_chunks"] + st["decode_steps"]
                + st["verify_steps"])
    serve = {"layer_norm_fwd": (2 * layers + 1) * forwards,
             "flash_fwd": layers * st["prefills"],
             decode: layers * st["decode_steps"]}
    want = {name: serve.get(name, 0) for name in counts}
    if counts != want or st["kernel_launches"] != counts:
        raise AssertionError(
            f"{label}: launches {counts} != expected {want} "
            f"({st['prefills']} prefills, {st['prefill_chunks']} chunks, "
            f"{st['decode_steps']} decode, {st['verify_steps']} verify "
            f"steps)")


def _gap_at(model, prompt, out, t, kv_quant):
    """The oracle's top-2 gap at served token ``t`` (its context the
    prompt and ``out[:t]``)."""
    import torch
    with torch.no_grad():
        ids = torch.tensor([list(prompt) + list(out[:t])], device="cuda")
        top2 = torch.topk(model(ids, kv_quant=kv_quant)[0, -1], 2).values
    return float(top2[0] - top2[1])


def _same_but_near_ties(model, prompts, a, b, kv_quant):
    """Two servers' tokens for the same prompts: equal, but where one
    request's streams part at a near-tie of the oracle (that request's
    comparison ends there).  Returns (tokens compared, near-ties)."""
    compared = near_ties = 0
    for p, x, y in zip(prompts, a, b):
        n = _lcp(x, y)
        compared += n
        if n < len(x):
            gap = _gap_at(model, p, x, n, kv_quant)
            if gap >= NEAR_TIE_GAP:
                raise AssertionError(
                    f"serve_features: two servers part at token {n} of a "
                    f"{len(p)}-token prompt (top-2 gap {gap:.3g})")
            near_ties += 1
    return compared, near_ties


def _cow_probe(engine, record):
    """Wrap ``engine.copy_blocks`` to check, right after each copy, every
    destination block against its source, every leaf bit for bit (the
    int8 payload and its scales)."""
    import torch
    copy, bs = engine.copy_blocks, engine.block_size

    def copy_and_check(pairs):
        copy(pairs)
        for src, dst in pairs:
            same = all(torch.equal(t[:, dst * bs:(dst + 1) * bs],
                                   t[:, src * bs:(src + 1) * bs])
                       for t in engine.cache.values())
            record.append({"src": int(src), "dst": int(dst),
                           "leaves": sorted(engine.cache), "equal": same})
            if not same:
                raise AssertionError(f"serve_features: COW copy {src} -> "
                                     f"{dst} differs from its source")

    engine.copy_blocks = copy_and_check


def _features_summary(st):
    spec = st["speculation"]
    return {"tokens": st["tokens_generated"],
            "prefills": st["prefills"], "prefill_chunks": st["prefill_chunks"],
            "decode_steps": st["decode_steps"],
            "verify_steps": st["verify_steps"],
            "drafted": spec["drafted_tokens"],
            "accepted": spec["accepted_tokens"],
            "acceptance_rate": spec["acceptance_rate"],
            "tokens_per_engine_step": spec["tokens_per_engine_step"],
            "prefix_hit_rate": st.get("prefix_hit_rate"),
            "prefix_hit_tokens": st.get("prefix_hit_tokens"),
            "prefix_cow_blocks": st.get("prefix_cow_blocks"),
            "prefix_evicted_blocks": st.get("prefix_evicted_blocks"),
            "preemptions": st["preemptions"]}


def _features_shared_prefix(shared, traffic):
    """(a) the fp32 pool against the oracle; (b) the int8 pool against an
    int8 server without the cache, the COW copies probed; (d) a pool
    tight enough to evict and preempt, against the oracle."""
    import torch
    oracle = shared["oracle"]
    out, counts = {}, {}
    server = _features_server(shared, torch.float32)
    reqs, wall, counts["a"], st = _features_pass(
        server, traffic[:1], traffic[1:], FEATURES_NEW)
    outs = [r.generated for r in reqs]
    compared, near = _oracle_check(oracle, traffic, outs)
    if st["prefix_hit_tokens"] < (FEATURES_SHARED - 1) * FEATURES_SYSTEM \
            or st["prefix_cow_blocks"] != FEATURES_COW:
        raise AssertionError(f"serve_features (a): {_features_summary(st)}")
    out["a"] = {"wall_s": wall, **_features_summary(st),
                "oracle_tokens_compared": compared, "near_ties": near,
                "launches": counts["a"]}
    emit("serve_features", leg="a", pool="float32",
         **{k: v for k, v in out["a"].items()})
    del server

    cows = []
    q8 = _features_server(shared, torch.float32, kv_quant="int8")
    _cow_probe(q8.engine, cows)
    reqs, wall, counts["b"], st = _features_pass(
        q8, traffic[:1], traffic[1:], FEATURES_NEW)
    outs_q8 = [r.generated for r in reqs]
    plain = _features_server(shared, torch.float32, kv_quant="int8",
                             enable_prefix_cache=False)
    ref = [r.generated for r in _features_pass(
        plain, traffic[:1], traffic[1:], FEATURES_NEW)[0]]
    same, near_b = _same_but_near_ties(oracle, traffic, outs_q8, ref, True)
    if len(cows) != FEATURES_COW or st["prefix_cow_blocks"] != FEATURES_COW:
        raise AssertionError(f"serve_features (b): {len(cows)} COW copies "
                             f"probed, stats {_features_summary(st)}")
    out["b"] = {"wall_s": wall, **_features_summary(st), "cow_copies": cows,
                "tokens_equal_to_uncached": same, "near_ties": near_b,
                "launches": counts["b"]}
    emit("serve_features", leg="b", pool="int8",
         **{k: v for k, v in out["b"].items()})
    del q8, plain

    tight = _features_server(shared, torch.float32,
                             num_blocks=FEATURES_TIGHT_BLOCKS)
    reqs, wall, _, st = _features_pass(tight, traffic[:1], traffic[1:],
                                       FEATURES_NEW)
    compared, near = _oracle_check(oracle, traffic,
                                   [r.generated for r in reqs])
    if not st["prefix_evicted_blocks"] or not st["preemptions"]:
        raise AssertionError(f"serve_features (d): no eviction or no "
                             f"preemption: {_features_summary(st)}")
    out["d"] = {"wall_s": wall, **_features_summary(st),
                "blocks_usable": FEATURES_TIGHT_BLOCKS - 1,
                "oracle_tokens_compared": compared, "near_ties": near}
    emit("serve_features", leg="d", **out["d"])
    return out, counts


def _features_speculation(shared, snippets):
    """(c) repeated snippets, greedy on the fp32 pool against the oracle
    with drafts accepted; then the stochastic classes twice from a reset
    pool, bit for bit, the rejection counters read; every decode and
    verify launch under sync-debug "error".  Then the greedy pass again
    with card OOMs injected (``OOM_AT``): the same tokens, the OOMs
    counted, the launches exact."""
    import torch
    from apex_tpu_torch.serving import SamplingParams
    server = _features_server(shared, torch.float32)
    checked = {}
    _sync_checked_launches(server, checked)
    reqs, wall, counts, st = _features_pass(server, [], snippets,
                                            FEATURES_NEW)
    compared, near = _oracle_check(shared["oracle"], snippets,
                                   [r.generated for r in reqs])
    spec = st["speculation"]
    if not spec["drafted_tokens"] or not spec["accepted_tokens"]:
        raise AssertionError(f"serve_features (c): {spec}")
    out = {"greedy": {"wall_s": wall, **_features_summary(st),
                      "oracle_tokens_compared": compared, "near_ties": near,
                      "drafted_per_step": spec["drafted_per_step"],
                      "accepted_per_step": spec["accepted_per_step"],
                      "launches": counts},
           "greedy_tokens": [r.generated for r in reqs]}
    emit("serve_features", leg="c", sampling="greedy",
         **{k: v for k, v in out["greedy"].items()},
         **_pipeline_fields(st))
    samp = [SamplingParams(seed=2000 + i, **c) for i, c in zip(
        range(len(snippets)), itertools.cycle(FEATURES_STOCH))]
    runs = []
    for _ in range(2):
        server.engine.reset_cache()
        reqs, wall, _, st = _features_pass(server, [], snippets,
                                           FEATURES_NEW, sampling=samp)
        runs.append(([r.generated for r in reqs], st))
    rej = runs[0][1]["sampling"]["rejection"]
    if runs[0][0] != runs[1][0] or not rej["drafted_tokens"] \
            or not rej["accepted_tokens"] + rej["resamples"]:
        raise AssertionError(f"serve_features (c): stochastic replay equal "
                             f"{runs[0][0] == runs[1][0]}, rejection {rej}")
    out["stochastic"] = {"replay_equal": True, "rejection": rej,
                         "classes": runs[0][1]["sampling"]["requests"],
                         **_features_summary(runs[0][1])}
    emit("serve_features", leg="c", sampling="stochastic",
         **out["stochastic"])
    if not checked.get("verify_greedy") or not checked.get(
            "verify_stochastic"):
        raise AssertionError(f"serve_features (c): sync-checked launches "
                             f"{checked}")
    out["sync_checked"] = checked

    flaky = _features_server(shared, torch.float32)
    seen = _inject_ooms(flaky.engine, OOM_AT)
    reqs, wall, oom_counts, st = _features_pass(flaky, [], snippets,
                                                FEATURES_NEW)
    same = [r.generated for r in reqs] == out["greedy_tokens"]
    if not same or st["oom_events"] != sum(map(len, OOM_AT.values())) \
            or any(seen.get(name, 0) <= max(calls)
                   for name, calls in OOM_AT.items()) \
            or st["breaker_state"] != "closed":
        raise AssertionError(f"serve_features (c) OOM: tokens equal {same}, "
                             f"oom_events {st['oom_events']}, calls {seen}, "
                             f"breaker {st['breaker_state']}")
    out["oom"] = {"tokens_equal": True, "oom_events": st["oom_events"],
                  "calls": seen, "launches": oom_counts,
                  **_features_summary(st)}
    emit("serve_features", leg="c", run="oom", sync_checked_launches=checked,
         **out["oom"])
    return out, counts


def _features_lifecycle(shared, traffic):
    """(e) a burst at priorities 0 and 1 into a bounded queue: one
    terminal reason each, no priority-0 request shed; a drain begun
    mid-generation gives the undisturbed tokens; close() runs once."""
    import torch
    from apex_tpu_torch.serving import reasons
    server = _features_server(shared, torch.bfloat16,
                              max_waiting=BURST_WAITING)
    prompts = [traffic[i % len(traffic)] for i in range(BURST)]
    reqs = [server.submit(p, BURST_NEW, priority=i % 2)
            for i, p in enumerate(prompts)]
    while server.has_work:
        server.step()
    server.audit()
    ends = {}
    for r in reqs:
        if not r.finished or r.finish_reason not in reasons.TERMINAL_REASONS:
            raise AssertionError(f"serve_features (e): request {r.uid} "
                                 f"ended {r.finish_reason}")
        ends.setdefault(r.priority, {}).setdefault(r.finish_reason, 0)
        ends[r.priority][r.finish_reason] += 1
    if ends[0].get(reasons.SHED) or len(server.scheduler.finished) != BURST:
        raise AssertionError(f"serve_features (e): {ends}")
    burst_st = server.stats()
    # the drain: the undisturbed run, then the same requests with a drain
    # begun after DRAIN_AT steps (a submit during it finishes "draining")
    server.engine.reset_cache()
    want = server.generate(traffic[:8], BURST_NEW)
    server.engine.reset_cache()
    reqs = [server.submit(p, BURST_NEW) for p in traffic[:8]]
    for _ in range(DRAIN_AT):
        server.step()
    live = sum(not r.finished for r in reqs)
    if not live or not any(r.generated for r in reqs):
        raise AssertionError(f"serve_features (e): the drain would begin "
                             f"with {live} requests live")
    server.begin_drain()
    late = server.submit(traffic[8], BURST_NEW)
    final = server.close()
    again = server.close()
    try:
        server.submit(traffic[0], 1)
    except RuntimeError:
        refused = True
    else:
        refused = False
    got = [r.generated for r in reqs]
    if got != want or late.finish_reason != reasons.DRAINING \
            or again is not final or not refused or not final["draining"]:
        raise AssertionError(f"serve_features (e): drain tokens equal "
                             f"{got == want}, late {late.finish_reason}, "
                             f"close once {again is final}, refused "
                             f"{refused}")
    out = {"ends_by_priority": ends, "pressure_peak":
           burst_st["pressure_peak"], "queue_depth_peak":
           burst_st["queue_depth_peak"], "live_at_drain": live,
           "drain_tokens_equal": True, "close_once": True}
    emit("serve_features", leg="e", **out)
    return out


# (f)/(g): session traffic in the reference tests' shape
# (tests/L0/test_offload.py): 8 distinct prompts of 25 full blocks and a
# 3-token tail, 16 new greedy tokens each, two passes of one request at a
# time, pass 2 resubmitting pass 1's prompts; the monolithic prefill
# (B4), so pass 1's cold prefills launch it and pass 2's tails chunk
OFFLOAD_SESSIONS = 8
OFFLOAD_PROMPT = 25 * 16 + 3
OFFLOAD_NEW = 16
# a pool of 60 usable blocks: room for about two sessions (27 each)
OFFLOAD_TIGHT_BLOCKS = 61
# the host tier: every block a pass demotes (~1.2 MB an fp32 block), or
# less than one block, so every demote spills to disk
OFFLOAD_HOST_BYTES = 1 << 30
OFFLOAD_SPILL_HOST_BYTES = 1 << 16
# (g): the transport faults, in the order of pass 2's promote batches
TRANSPORT_FAULTS = ("reset", "stall")


def _offload_traffic(cfg, seed=2):
    rng = np.random.RandomState(seed)
    return [list(rng.randint(0, cfg.vocab_size, size=OFFLOAD_PROMPT))
            for _ in range(OFFLOAD_SESSIONS)]


def _session_pass(server, prompts, before_pass2=None, progress=None,
                  passes=2):
    """Drive the session traffic once (``passes`` passes), every launch
    count at 0 just before and read just after, every pool audited after
    every step; ``before_pass2(server)`` runs between the first two
    passes and ``progress`` (a dict) holds the request being served under
    ``"at"``.  Checks the
    launches against the step accounting (:func:`_check_step_launches`)
    and every request's length.  Returns (outs, wall s, counts,
    stats)."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    reset_launch_counts()
    server.reset_meters()
    t0 = time.perf_counter()
    outs = []
    for p in range(passes):
        if p == 1 and before_pass2 is not None:
            before_pass2(server)
        for prompt in prompts:
            if progress is not None:
                progress["at"] = len(outs)
            req = server.submit(prompt, OFFLOAD_NEW)
            while server.has_work:
                server.step()
                server.audit()
            if req.finish_reason != "length" \
                    or len(req.generated) != OFFLOAD_NEW:
                raise AssertionError(f"offload: request {req.uid} ended "
                                     f"{req.finish_reason} with "
                                     f"{req.generated}")
            outs.append(list(req.generated))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = server.stats()
    _check_step_launches("offload", server, counts, st)
    return outs, wall, counts, st


def _offload_server(shared, dtype, **kw):
    """serve_features' server on the monolithic prefill (B4)."""
    return _features_server(shared, dtype, enable_chunked_prefill=False,
                            **kw)


def _syncs_at_tier_crossings(server, tally):
    """Run the cache home's ``export_blocks`` (a demote) and
    ``import_blocks`` (a promote) under sync-debug "warn" and count, by
    kind, the calls and the calls that synchronized, and every
    synchronizing operation they made."""
    import warnings

    import torch
    engine = server._cache_home()

    def counted(kind, call):
        def run(*args, **kw):
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    out = call(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchroniz" in str(w.message) for w in seen)
            row = tally.setdefault(kind, {"calls": 0, "syncing_calls": 0,
                                          "syncs": 0})
            row["calls"] += 1
            row["syncing_calls"] += bool(syncs)
            row["syncs"] += syncs
            return out
        return run

    engine.export_blocks = counted("demote_export", engine.export_blocks)
    engine.import_blocks = counted("promote_import", engine.import_blocks)


def _promote_steps(server, tally):
    """Count the steps in which a promote ran and the sync-checked decode
    and verify launches made in them (``_sync_checked_launches`` must be
    installed first)."""
    step = server.step

    def counted():
        off = server.offload
        before = off.count("promotes_host") + off.count("promotes_disk")
        launches = server.pipe.count("launches")
        out = step()
        if off.count("promotes_host") + off.count("promotes_disk") > before:
            tally["steps_with_promote"] = \
                tally.get("steps_with_promote", 0) + 1
            tally["launches_in_them"] = tally.get("launches_in_them", 0) \
                + server.pipe.count("launches") - launches
        return out

    server.step = counted


def _offload_check(label, st, counts, outs, want, layers, prefills=None,
                   skip=None):
    """An offload pass against its oracle's tokens: exact for every
    request but ``skip`` (a session that cold-prefilled, held to the near
    tie rule apart); B4 L a pass-1 cold prefill (plus the skip's), the
    promotes counted, nothing rejected or dropped."""
    off = st["offload"]
    prefills = OFFLOAD_SESSIONS + (skip is not None) \
        if prefills is None else prefills
    bad = [i for i, (a, b) in enumerate(zip(outs, want))
           if a != b and i != skip]
    if bad or len(outs) != len(want) or st["prefills"] != prefills \
            or counts.get("flash_fwd") != layers * prefills \
            or not off["demotes"] \
            or not off["promotes_host"] + off["promotes_disk"] \
            or off["crc_rejects"] or off["host_dropped"]:
        raise AssertionError(f"{label}: requests {bad} differ, "
                             f"{st['prefills']} prefills, launches "
                             f"{counts}, offload {off}")


def _offload_emit(label, st, wall, counts, **fields):
    off = st["offload"]
    emit("serve_features", leg=label, wall_s=round(wall, 4),
         prefills=st["prefills"], prefill_chunks=st["prefill_chunks"],
         decode_steps=st["decode_steps"], verify_steps=st["verify_steps"],
         b4_launches=counts.get("flash_fwd", 0),
         b7_launches=counts.get("decode_attention", 0),
         b8_launches=counts.get("decode_attention_q8", 0),
         launches=counts, offload={k: v for k, v in off.items()
                                   if v not in (0, None)},
         transport={k: st["transport"][k] for k in (
             "backend", "attempts", "retries", "delivered", "failures",
             "deadline_exceeded")}, **fields)


def _torn_first_block(server, prompt):
    """Flip the last byte of the first spilled leaf of ``prompt``'s first
    block, keyed by its chain hash; returns the file."""
    from apex_tpu_torch.serving import prefix_cache
    key = prefix_cache._chunk_hash(prefix_cache._ROOT_HASH, prompt[:16])
    entry = Path(server.offload_store.spill_dir) / key.hex()
    leaf = sorted(entry.glob("*.npy"))[0]
    raw = bytearray(leaf.read_bytes())
    raw[-1] ^= 0xFF
    leaf.write_bytes(bytes(raw))
    return leaf


class _FaultScript:
    """The KV transport's ``chaos`` seam, scripted: one fault a send, in
    ``TRANSPORT_FAULTS`` order; a reset raises before the attempt (the
    envelope retries it), a stall raises the deadline's error (not
    retried: the promote is skipped).  Each fires once, so a retry sees a
    healthy wire; ``hit`` records the request being served at each."""

    def __init__(self, kinds, progress):
        self.kinds = list(kinds)
        self.progress = progress
        self.hit = {}

    def plan_send(self, peer):
        if not self.kinds:
            return None
        return _Fault(self.kinds.pop(0), self)


class _Fault:
    def __init__(self, kind, script):
        self.kind, self.script, self.fired = kind, script, False

    def before(self, payload):
        from apex_tpu_torch.serving.transport import (
            TransportConnectionError, TransportTimeoutError)
        if self.fired:
            return payload
        self.fired = True
        self.script.hit[self.kind] = self.script.progress["at"]
        if self.kind == "reset":
            raise TransportConnectionError("chip_smoke: reset mid-frame")
        raise TransportTimeoutError("chip_smoke: stalled past the deadline")

    def after(self, redeliver):
        pass


def _features_offload(shared):
    """(f) the offload tier and (g) the KV transport on the session
    traffic, each pass against a roomy offload-off server on the same
    pool dtype (one a dtype, shared): fp32, int8 (B8) and bf16 through
    the disk tier with a torn spill, disaggregated fp32, and fp32 over a
    ``SocketTransport`` on loopback, then a third pass there with a reset
    and a stall injected.  Returns (results, {path: launches})."""
    import tempfile

    import torch
    from apex_tpu_torch.serving.transport import SocketTransport
    cfg, oracle = shared["cfg"], shared["oracle"]
    layers = cfg.num_hidden_layers
    prompts = _offload_traffic(cfg)
    out, paths = {}, {}
    want = {}
    for name, dtype, quant in (("float32", torch.float32, "off"),
                               ("int8", torch.float32, "int8"),
                               ("bfloat16", torch.bfloat16, "off")):
        roomy = _offload_server(shared, dtype, kv_quant=quant)
        want[name], wall, counts, st = _session_pass(roomy, prompts)
        if st["prefills"] != OFFLOAD_SESSIONS \
                or st["prefix_hit_tokens"] != OFFLOAD_SESSIONS * 25 * 16:
            raise AssertionError(f"offload oracle {name}: "
                                 f"{_features_summary(st)}")
        out[f"oracle_{name}"] = {"wall_s": wall, "launches": counts}
        emit("serve_features", leg="f_oracle", pool=name,
             wall_s=round(wall, 4), launches=counts,
             **_features_summary(st))
        del roomy

    # (f) fp32: tight pool, every demote in the host tier, the decode and
    # verify launches under sync-debug "error", the tier crossings' syncs
    # counted under "warn"
    tight = _offload_server(shared, torch.float32,
                            num_blocks=OFFLOAD_TIGHT_BLOCKS,
                            enable_kv_offload=True,
                            kv_offload_host_bytes=OFFLOAD_HOST_BYTES)
    checked, syncs = {}, {}
    _sync_checked_launches(tight, checked)
    _promote_steps(tight, checked)
    _syncs_at_tier_crossings(tight, syncs)
    outs_f, wall, counts, st = _session_pass(tight, prompts)
    _offload_check("serve_features (f) fp32", st, counts, outs_f,
                   want["float32"], layers)
    compared, near = _oracle_check(oracle, prompts * 2, outs_f)
    if not checked.get("steps_with_promote") \
            or not checked.get("launches_in_them"):
        raise AssertionError(f"serve_features (f): sync-checked {checked}")
    out["f_fp32"] = {"wall_s": wall, "launches": counts, "stats": st,
                     "sync_checked": checked, "tier_syncs": syncs}
    paths["serve_features_offload"] = counts
    _offload_emit("f", st, wall, counts, pool="float32",
                  tokens_equal_roomy=True, oracle_tokens_compared=compared,
                  near_ties=near, sync_checked_launches=checked,
                  tier_crossing_syncs=syncs,
                  promote_ms=st["offload"]["promote_ms"])
    del tight

    # (f) int8: the promoted bytes are the demoted ones, scales included
    q8 = _offload_server(shared, torch.float32, kv_quant="int8",
                         num_blocks=OFFLOAD_TIGHT_BLOCKS,
                         enable_kv_offload=True,
                         kv_offload_host_bytes=OFFLOAD_HOST_BYTES)
    syncs_q8 = {}
    _syncs_at_tier_crossings(q8, syncs_q8)
    outs, wall, counts, st = _session_pass(q8, prompts)
    _offload_check("serve_features (f) int8", st, counts, outs,
                   want["int8"], layers)
    out["f_int8"] = {"wall_s": wall, "launches": counts, "stats": st,
                     "tier_syncs": syncs_q8}
    paths["serve_features_offload_q8"] = counts
    _offload_emit("f", st, wall, counts, pool="int8",
                  tokens_equal_roomy=True, tier_crossing_syncs=syncs_q8)
    del q8

    # (f) bf16 through the disk tier; session 0's first spilled block
    # torn before pass 2: that session cold-prefills, its tokens then
    # its own pass-1 cold prefill's (what the tight offload-off server
    # gives it) under the near-tie rule
    with tempfile.TemporaryDirectory() as spill:
        disk = _offload_server(shared, torch.bfloat16,
                               num_blocks=OFFLOAD_TIGHT_BLOCKS,
                               enable_kv_offload=True,
                               kv_offload_host_bytes=OFFLOAD_SPILL_HOST_BYTES,
                               kv_offload_dir=spill)
        torn = []
        outs, wall, counts, st = _session_pass(
            disk, prompts,
            before_pass2=lambda srv: torn.append(
                str(_torn_first_block(srv, prompts[0]))))
        off = st["offload"]
        _offload_check("serve_features (f) bf16 disk", st, counts, outs,
                       want["bfloat16"], layers,
                       skip=OFFLOAD_SESSIONS)
        _, near_torn = _same_but_near_ties(
            oracle, prompts[:1], outs[OFFLOAD_SESSIONS:][:1], outs[:1],
            False)
        if not off["spills"] or not off["promotes_disk"] \
                or off["disk_torn"] < 1:
            raise AssertionError(f"serve_features (f) disk: {off}")
        out["f_disk"] = {"wall_s": wall, "launches": counts, "stats": st,
                         "torn_leaf": torn, "torn_near_ties": near_torn}
        _offload_emit("f", st, wall, counts, pool="bfloat16", tier="disk",
                      tokens_equal_roomy_but_torn=True,
                      torn_session_near_ties=near_torn)
        del disk

    # (f) disaggregated: the prefill pool (one context, 64 blocks) is the
    # cache home, its exports and imports on the prefill stream
    dis = _offload_server(shared, torch.float32, enable_disagg=True,
                          enable_kv_offload=True,
                          kv_offload_host_bytes=OFFLOAD_HOST_BYTES,
                          disagg_prefill_blocks=65)
    checked_d, syncs_d = {}, {}
    _sync_checked_launches(dis, checked_d)
    _syncs_at_tier_crossings(dis, syncs_d)
    outs, wall, counts, st = _session_pass(dis, prompts)
    _offload_check("serve_features (f) disagg", st, counts, outs,
                   want["float32"], layers)
    out["f_disagg"] = {"wall_s": wall, "launches": counts, "stats": st,
                       "sync_checked": checked_d, "tier_syncs": syncs_d}
    paths["serve_features_offload_disagg"] = counts
    _offload_emit("f", st, wall, counts, pool="float32", disagg=True,
                  tokens_equal_roomy=True, sync_checked_launches=checked_d,
                  tier_crossing_syncs=syncs_d,
                  handoff=st["disagg"]["handoff"])
    del dis

    # (g) the tight fp32 pass over loopback TCP: the in-process pass's
    # tokens, one delivery a promote batch, no retry; then a third pass
    # with a reset and a stall injected through the chaos seam: the reset
    # retried, its promote exact; the stalled promote skipped, its
    # session cold
    sock = _offload_server(shared, torch.float32,
                           num_blocks=OFFLOAD_TIGHT_BLOCKS,
                           enable_kv_offload=True,
                           kv_offload_host_bytes=OFFLOAD_HOST_BYTES,
                           kv_transport=SocketTransport())
    outs, wall, counts, st = _session_pass(sock, prompts)
    _offload_check("serve_features (g) socket", st, counts, outs, outs_f,
                   layers)
    tr = st["transport"]
    if tr["backend"] != "socket" or tr["retries"] or tr["failures"] \
            or tr["delivered"] != st["offload"]["promote_ms"]["count"]:
        raise AssertionError(f"serve_features (g): transport {tr}")
    out["g_socket"] = {"wall_s": wall, "launches": counts, "stats": st}
    _offload_emit("g", st, wall, counts, pool="float32",
                  tokens_equal_inprocess=True,
                  promote_batches=st["offload"]["promote_ms"]["count"])
    progress = {}
    sock.kv_transport.chaos = _FaultScript(TRANSPORT_FAULTS, progress)
    outs3, wall, counts, st = _session_pass(sock, prompts, passes=1,
                                            progress=progress)
    hit = sock.kv_transport.chaos.hit
    stalled = hit.get("stall")
    _offload_check("serve_features (g) faults", st, counts, outs3,
                   outs[OFFLOAD_SESSIONS:], layers, prefills=1,
                   skip=stalled)
    _, near_stall = _same_but_near_ties(
        oracle, [prompts[stalled]], [outs3[stalled]], [outs[stalled]],
        False)
    tr = st["transport"]
    if set(hit) != set(TRANSPORT_FAULTS) or hit["reset"] == stalled \
            or st["offload"]["transport_skips"] != 1 \
            or tr["retries"] != 1 or tr["deadline_exceeded"] != 1 \
            or tr["per_peer"]["offload"]["breaker"] != "closed":
        raise AssertionError(f"serve_features (g) faults: at {hit}, "
                             f"offload {st['offload']}, transport {tr}")
    sock.close()
    out["g_faults"] = {"wall_s": wall, "launches": counts, "stats": st,
                       "faults_at": hit, "stall_near_ties": near_stall}
    _offload_emit("g", st, wall, counts, pool="float32", faults_at=hit,
                  third_pass=True, tokens_equal_but_stalled=True,
                  stalled_session_near_ties=near_stall)
    return out, paths


def phase_serve_features():
    """The reference server's default serving layers on serve's model,
    (a)-(g) and the timing of the module docstring; returns the launches
    of its paths.  Drops the shared serve model at its end."""
    import torch
    t0 = time.perf_counter()
    emit("serve_features", prediction=F_PREDICTION)
    shared = _serve_model()
    traffic, snippets = _features_traffic(shared["cfg"])
    results = {}
    results["shared_prefix"], counts = _features_shared_prefix(shared,
                                                               traffic)
    results["c"], counts["c"] = _features_speculation(shared, snippets)
    results["e"] = _features_lifecycle(shared, traffic)
    results["offload"], offload_paths = _features_offload(shared)
    _SHARED.pop("gpt2_small_serve", None)
    torch.cuda.empty_cache()
    results["seconds"] = time.perf_counter() - t0
    emit("serve_features", leg="done", seconds=round(results["seconds"], 3))
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "serve_features.json").write_text(
        json.dumps(results, indent=1, default=str))
    # a kernel reports the last path's launches: (a)'s and (b)'s
    return {**offload_paths, "serve_features_spec": counts["c"],
            "serve_features_q8": counts["b"], "serve_features": counts["a"]}


# device-time classes of the profiled passes' kernels, by kernel-name
# fragment (first match wins)
KERNEL_CLASSES = (
    ("layer_norm_fwd (port)", ("layer_norm_fwd",)),
    ("layer_norm_bwd (port)", ("layer_norm_bwd",)),
    ("flash_fwd (port)", ("flash_fwd_kernel",)),
    ("flash_bwd_dq (port)", ("flash_bwd_dq_kernel",)),
    ("flash_bwd_dkv (port)", ("flash_bwd_dkv_kernel",)),
    ("fused_adam (port)", ("fused_adam_kernel",)),
    ("threefry_dropout (port)", ("threefry_dropout_kernel",)),
    ("decode_attention (port)", ("decode_attention_kernel",)),
    ("gemm", ("gemm", "gemv", "xmma", "cutlass", "cublas", "nvjet",
              "sm90_")),
    ("gather/scatter", ("index", "gather", "scatter")),
    ("multi-tensor (foreach)", ("multi_tensor_apply", "foreach")),
    ("copy/cast/cat", ("copy", "cat", "Cat")),
    ("reduce", ("reduce", "Reduce")),
    ("elementwise", ("elementwise",)),
)


# the classes of the kernels' template-flag-on instantiations (``true``):
# the flash kernels' dropout branches and the decode kernel's int8 front
FLAG_CLASSES = {
    "flash_fwd (port)": "flash_fwd_dropout (port)",
    "flash_bwd_dq (port)": "flash_bwd_dq_dropout (port)",
    "flash_bwd_dkv (port)": "flash_bwd_dkv_dropout (port)",
    "decode_attention (port)": "decode_attention_q8 (port)",
}


def _kernel_class(name):
    """The class of a kernel name; the flag-on instantiations count
    apart (``FLAG_CLASSES``)."""
    cls = next((c for c, keys in KERNEL_CLASSES
                if any(k in name for k in keys)), "other")
    if cls in FLAG_CLASSES and ("true>" in name or "Lb1E" in name):
        cls = FLAG_CLASSES[cls]
    return cls


def _profile(label, run, **fields):
    """``run()`` once under ``torch.profiler``: device time by kernel
    class and the device's idle share of the run's wall time.  Reports
    ``"not measured"`` when the profiler records no device events.  The
    device events are read off the raw Kineto results: building the
    profiler's Python event list costs ~9 s for a serve pass's ~90,000
    events, and only (start, end, name) is needed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == cuda)
    if not kernels:
        emit("profile", run=label, device_time="not measured")
        return {"device_time": "not measured"}
    by_name, busy_us, end_us = {}, 0.0, None
    for start, end, name in kernels:
        if end_us is None or start >= end_us:
            busy_us += end - start
            end_us = end
        elif end > end_us:
            busy_us += end - end_us
            end_us = end
        by_name[name] = by_name.get(name, 0.0) + end - start
    by_class = {}
    for name, dur in by_name.items():
        cls = _kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + dur
    total = sum(by_class.values())
    out = {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
           "device_idle_share": 1.0 - busy_us / wall_us,
           "kernel_ms_total": total / 1e3, "kernel_launches": len(kernels),
           **fields,
           "by_class_ms": {c: v / 1e3 for c, v in
                           sorted(by_class.items(), key=lambda kv: -kv[1])},
           "top_kernels_ms": {n[:120]: v / 1e3 for n, v in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:15]}}
    emit("profile", run=label, wall_ms=round(out["wall_ms"], 3),
         device_busy_ms=round(out["device_busy_ms"], 3),
         device_idle_share=round(out["device_idle_share"], 4),
         kernel_launches=len(kernels), **fields,
         by_class_ms={c: round(v, 3) for c, v in
                      out["by_class_ms"].items()})
    return out


def _profile_serve(server, prompts, max_new, label="serve"):
    """One more serve pass under the profiler."""
    server.engine.reset_cache()
    server.reset_meters()
    out = _profile(label, lambda: server.generate(prompts,
                                                  max_new_tokens=max_new))
    st = server.stats()
    out["engine_steps"] = (st["prefills"] + st["prefill_chunks"]
                           + st["decode_steps"])
    return out


# -- train -------------------------------------------------------------------

def _per_step_launches(cfg, names):
    """Launches of one training step: 2L+1 LayerNorms forward and
    backward, L attentions forward, dq and dk/dv, one Adam update."""
    n = cfg.num_hidden_layers
    step = {"layer_norm_fwd": 2 * n + 1, "layer_norm_bwd": 2 * n + 1,
            "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "fused_adam": 1}
    return {name: step.get(name, 0) for name in names}


def _plain_attention(q, k, v, bias=None, dropout_fn=None):
    """The causal flash adapter's plain version: causal attention with
    fp32 softmax and, from the ``dropout_fn`` annotation, the kernels'
    hash dropout (``_reference``), differentiable through PyTorch's own
    autograd."""
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    rate, seed = fa.dropout_params(dropout_fn)
    sa = None if seed is None else fa.seed_array(seed, num_heads=q.shape[2])
    return fa._reference(q, k, v, fa.bias_to_kv_mask(bias), True,
                         q.shape[-1] ** -0.5, dropout_rate=rate, seed=sa)


def _plain_adam(lr):
    """FusedAdam whose update is its plain version: launches no B1."""
    from apex_tpu_torch.optimizers import FusedAdam
    adam = importlib.import_module("apex_tpu_torch.optimizers.fused_adam")

    class PlainAdam(FusedAdam):
        def _update(self, p, m, v, g, scalars):
            new = adam._adam_plain(p, m, v, g, scalars, self.eps_inside_sqrt)
            for buf, val in zip((p, m, v), new):
                buf.copy_(val)

    return PlainAdam(lr=lr)


def _train_oracle(cfg, opt_level):
    """The example's model and optimizer with no port kernel in them:
    plain LayerNorm, plain attention, and FusedAdam whose update is its
    plain version.  Same seed, so the same initial weights."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.models import GPTLMHeadModel
    module = _plain_oracle(GPTLMHeadModel(cfg, attention_fn=_plain_attention,
                                          device="cuda", seed=0))
    model, opt = amp.initialize(module, _plain_adam(TRAIN_LR),
                                opt_level=opt_level, verbosity=0)
    params = model.init()
    return model, opt, params, opt.init(params)


def _oracle_steps(cfg, opt_level, batch, steps, deterministic=True):
    """The oracle's losses over ``steps`` steps of the example's
    batches (with ``deterministic=False``, dropout on ``train()``'s step
    keys), and its step-1 gradients; fails if it launched a port
    kernel."""
    import torch
    from apex_tpu_torch._kernels import launch_counts
    from apex_tpu_torch.examples import bert_main_amp, gpt_main_amp
    before = launch_counts()
    model, opt, params, st = _train_oracle(cfg, opt_level)
    data = gpt_main_amp.batches(cfg.vocab_size, batch, TRAIN_SEQ)
    losses, grads1 = [], None
    for step in range(steps):
        ids = torch.from_numpy(next(data)).to("cuda")
        params, st, loss, grads = gpt_main_amp.train_step(
            model, opt, params, st, ids, deterministic=deterministic,
            dropout_key=None if deterministic
            else bert_main_amp.step_key(0, step))
        losses.append(float(loss))
        if step == 0:
            grads1 = grads
    if launch_counts() != before:
        raise AssertionError("the training oracle launched a port kernel")
    return losses, grads1


def _train_o0():
    """(a) O0 at batch 2: losses and step-1 gradients against the oracle,
    and each step's launches."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    want_losses, want_grads = _oracle_steps(cfg, "O0", O0_BATCH, O0_STEPS)
    model, opt, params, st = gpt_main_amp.build(
        cfg, lr=TRAIN_LR, opt_level="O0", device="cuda", seed=0)
    data = gpt_main_amp.batches(cfg.vocab_size, O0_BATCH, TRAIN_SEQ)
    losses, grad_err = [], 0.0
    for step in range(O0_STEPS):
        ids = torch.from_numpy(next(data)).to("cuda")
        torch.cuda.synchronize()
        reset_launch_counts()
        params, st, loss, grads = gpt_main_amp.train_step(model, opt, params,
                                                          st, ids)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != _per_step_launches(cfg, counts):
            raise AssertionError(f"O0 step {step}: launches {counts}")
        losses.append(float(loss))
        if step == 0:
            for name, g in grads.items():
                rel, _ = scale_aware_err(g, want_grads[name])
                grad_err = max(grad_err, rel)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    emit("train", opt_level="O0", batch=O0_BATCH, seq=TRAIN_SEQ,
         losses=losses, oracle_losses=want_losses, loss_rel_err=loss_err,
         step1_grad_err=grad_err, launches_per_step=counts)
    if not (loss_err <= O0_TOL and grad_err <= O0_TOL):
        raise AssertionError(f"O0: loss error {loss_err:.3g}, step-1 grad "
                             f"error {grad_err:.3g} > {O0_TOL}")
    return {"losses": losses, "oracle_losses": want_losses,
            "loss_rel_err": loss_err, "step1_grad_err": grad_err}


def _gpt_train(cfg, opt_level):
    """``train()`` at the example's defaults (B 8, S 1024, ``O2_STEPS``
    steps) with every launch count at 0 just before and read just after
    (exactly ``O2_STEPS`` times the per-step counts); returns the run,
    the counts and the peak memory."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = gpt_main_amp.train(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             steps=O2_STEPS, lr=TRAIN_LR,
                             opt_level=opt_level, device="cuda", seed=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: O2_STEPS * v
            for k, v in _per_step_launches(cfg, counts).items()}
    if counts != want:
        raise AssertionError(f"{opt_level}: launches {counts} != {want}")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"{opt_level}: non-finite loss "
                             f"{out['losses']}")
    return out, counts, peak_gb


def _train_o2():
    """(b) O2 through ``train()`` at the example's defaults, every launch
    count read around the run; losses against the O2 oracle."""
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    out, counts, peak_gb = _gpt_train(cfg, "O2")
    want_losses, _ = _oracle_steps(cfg, "O2", TRAIN_BATCH, O2_STEPS)
    errs = [abs(a - b) for a, b in zip(out["losses"], want_losses)]
    tps = statistics.median(out["tokens_per_s"][1:])
    emit("train", opt_level="O2", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         steps=O2_STEPS, losses=out["losses"], oracle_losses=want_losses,
         max_loss_abs_err=max(errs), tokens_per_s_median=tps,
         step_ms=[1e3 * t for t in out["step_seconds"]],
         loss_scale=out["loss_scale"], skipped_steps=out["skipped_steps"],
         peak_memory_gb=peak_gb, launches=counts)
    if not max(errs) <= O2_LOSS_TOL:
        raise AssertionError(f"O2: loss error {max(errs):.3g} > "
                             f"{O2_LOSS_TOL}")
    return {**out, "oracle_losses": want_losses, "tokens_per_s_median": tps,
            "peak_memory_gb": peak_gb, "launches": counts}


def _train_overflow_and_profile():
    """(c) an overflowed O2 step under sync-debug "error": nothing
    changes but the scale, and no host sync; (d) one O2 step under the
    profiler."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models import lm_loss
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    model, opt, params, st = gpt_main_amp.build(
        cfg, lr=TRAIN_LR, opt_level="O2", device="cuda", seed=0)
    data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    ids = torch.from_numpy(next(data)).to("cuda")
    params, st, _, _ = gpt_main_amp.train_step(model, opt, params, st, ids)
    loss = lm_loss(model.apply(params, ids), ids)
    with amp.scale_loss(loss, st) as scaled:
        grads = dict(zip(params, torch.autograd.grad(
            scaled, list(params.values()))))
    grads["blocks.5.mlp_in.weight"][17, 3] = float("inf")
    inner = st.inner
    snap = (inner.p.clone(), inner.m.clone(), inner.v.clone(),
            inner.step.clone())
    scale0 = float(opt.loss_scale(st))
    skipped0 = int(st.skipped_steps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st = opt.step(params, grads, st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(
        (st.inner.p, st.inner.m, st.inner.v, st.inner.step), snap))
    scale1 = float(opt.loss_scale(st))
    emit("train", overflow_step="inf in blocks.5.mlp_in.weight",
         bits_kept=kept, loss_scale_before=scale0, loss_scale_after=scale1,
         skipped_steps=int(st.skipped_steps), host_syncs=0)
    if not (kept and scale1 == scale0 / 2
            and int(st.skipped_steps) == skipped0 + 1):
        raise AssertionError("the overflow step changed the state or did "
                             "not halve the scale")
    del grads, snap, loss, scaled
    # (d) a warm step, then one under the profiler
    state = {"params": params, "st": st}

    def one_step():
        ids = torch.from_numpy(next(data)).to("cuda")
        state["params"], state["st"], loss, _ = gpt_main_amp.train_step(
            model, opt, state["params"], state["st"], ids)
        float(loss)

    one_step()
    return _profile("train_step_O2", one_step,
                    tokens=TRAIN_BATCH * TRAIN_SEQ)


DDP_STEPS = 3


def _nccl_world_of_one():
    """An NCCL process group of this one rank (NCCL takes one rank a
    GPU)."""
    import torch.distributed as dist
    from apex_tpu_torch.parallel.multiproc import free_port, \
        initialize_distributed
    initialize_distributed("cuda", world_size=1, rank=0,
                           init_method=f"tcp://127.0.0.1:{free_port()}")
    if dist.get_backend() != "nccl":
        raise AssertionError(f"backend {dist.get_backend()}")


def _train_ddp():
    """(e) the data-parallel step through ``DistributedDataParallel`` over
    an NCCL group of one, ``DDP_STEPS`` O2 steps at B 8, S 1024, counts
    read around it: the losses bit for bit those of the same steps
    without DDP."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    kw = dict(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=DDP_STEPS,
              lr=TRAIN_LR, opt_level="O2", device="cuda", seed=0)
    plain = gpt_main_amp.train(cfg, **kw)
    _nccl_world_of_one()
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        ddp = gpt_main_amp.train(cfg, ddp=True, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        dist.destroy_process_group()
    want = {k: DDP_STEPS * v
            for k, v in _per_step_launches(cfg, counts).items()}
    same = ddp["losses"] == plain["losses"]
    emit("train", run="(e) DDP, NCCL world of one", steps=DDP_STEPS,
         losses=ddp["losses"], no_ddp_losses=plain["losses"],
         losses_bit_equal=same,
         step_ms=[1e3 * t for t in ddp["step_seconds"]],
         no_ddp_step_ms=[1e3 * t for t in plain["step_seconds"]],
         tokens_per_s=ddp["tokens_per_s"], peak_memory_gb=peak_gb,
         launches=counts)
    if counts != want:
        raise AssertionError(f"GPT DDP: launches {counts} != {want}")
    if not same:
        raise AssertionError("GPT DDP at a world of one: losses differ "
                             "from the step without DDP")
    return {"losses": ddp["losses"], "no_ddp_losses": plain["losses"],
            "step_seconds": ddp["step_seconds"],
            "no_ddp_step_seconds": plain["step_seconds"],
            "peak_memory_gb": peak_gb, "launches": counts}


def phase_train():
    results = {"O0": _train_o0()}
    results["O2"] = _train_o2()
    results["profile"] = _train_overflow_and_profile()
    results["ddp"] = _train_ddp()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train.json").write_text(json.dumps(results, indent=1,
                                                   default=str))
    return {"train": results["O2"]["launches"],
            "train_ddp": results["ddp"]["launches"]}


# -- train_bert ---------------------------------------------------------------

def _bert_per_step_launches(cfg, names, dropout=True):
    """Launches of one BERT training step with dropout: 2L+2 LayerNorms
    (embeddings, two per layer, the MLM head) forward and backward, L
    flash attentions with dropout forward, dq and dk/dv, 2L+1 hidden
    dropouts (embeddings, two per layer) forward and as many backward;
    nothing else (FusedLAMB is plain PyTorch, an MoE layer's router,
    experts and dispatch are PyTorch products and indexing).  Without
    ``dropout`` the flash kernels' plain branches and no threefry."""
    n = cfg.num_hidden_layers
    sfx = "_dropout" if dropout else ""
    step = {"layer_norm_fwd": 2 * n + 2, "layer_norm_bwd": 2 * n + 2,
            f"flash_fwd{sfx}": n, f"flash_bwd_dq{sfx}": n,
            f"flash_bwd_dkv{sfx}": n,
            "threefry_dropout": 2 * (2 * n + 1) if dropout else 0}
    return {name: step.get(name, 0) for name in names}


def _plain_dropout_attention(q, k, v, bias=None, dropout_fn=None):
    """The flash adapter's plain version for BERT: non-causal attention
    with fp32 softmax and the kernels' hash dropout from the
    ``dropout_fn`` annotation (``_reference``), differentiable through
    PyTorch's own autograd."""
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    rate, seed = fa.dropout_params(dropout_fn)
    sa = None if seed is None else fa.seed_array(seed, num_heads=q.shape[2])
    return fa._reference(q, k, v, fa.bias_to_kv_mask(bias), False,
                         q.shape[-1] ** -0.5, dropout_rate=rate, seed=sa)


def _bert_oracle_steps(cfg, state_dict, opt_level, batch, steps):
    """The example's BERT step with no port kernel in it — plain
    LayerNorm, the plain threefry dropout, the plain flash-with-dropout,
    the same FusedLAMB (plain PyTorch) — from ``state_dict``, the
    example's batches and the step keys of seed 0: its losses and step-1
    gradients.  Fails if it launched a port kernel."""
    import torch
    from apex_tpu_torch._kernels import launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    before = launch_counts()
    model, opt, params, st = bert_main_amp.build(
        cfg, lr=BERT_LR, opt_level=opt_level,
        attention_fn=_plain_dropout_attention, device="cuda",
        state_dict=state_dict)
    _plain_oracle(model.module)
    data = bert_main_amp.batches(cfg, batch, BERT_SEQ)
    losses, grads1 = [], None
    for step in range(steps):
        tensors = tuple(torch.from_numpy(a).to("cuda") for a in next(data))
        params, st, loss, grads = bert_main_amp.train_step(
            model, opt, params, st, tensors, deterministic=False,
            dropout_key=bert_main_amp.step_key(0, step))
        losses.append(float(loss))
        if step == 0:
            grads1 = grads
    if launch_counts() != before:
        raise AssertionError("the BERT oracle launched a port kernel")
    return losses, grads1


def _bert_build(cfg, opt_level, state_dict=None):
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    return bert_main_amp.build(
        cfg, lr=BERT_LR, opt_level=opt_level,
        attention_fn=make_flash_attention(), device="cuda", seed=0,
        state_dict=state_dict)


def _bert_o0():
    """(a) O0, TF32 off, batch 2: losses and step-1 gradients against the
    oracle, and each step's launches."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    cfg = bert_main_amp.get_config("large")
    model, opt, params, st = _bert_build(cfg, "O0")
    state_dict = {k: v.detach().clone()
                  for k, v in model.module.state_dict().items()}
    data = bert_main_amp.batches(cfg, BERT_O0_BATCH, BERT_SEQ)
    losses, counts, grads1 = [], None, None
    for step in range(O0_STEPS):
        tensors = tuple(torch.from_numpy(a).to("cuda") for a in next(data))
        torch.cuda.synchronize()
        reset_launch_counts()
        params, st, loss, grads = bert_main_amp.train_step(
            model, opt, params, st, tensors, deterministic=False,
            dropout_key=bert_main_amp.step_key(0, step))
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts != _bert_per_step_launches(cfg, counts):
            raise AssertionError(f"BERT O0 step {step}: launches {counts}")
        losses.append(float(loss))
        if step == 0:
            grads1 = grads
    del model, opt, params, st
    want_losses, want_grads = _bert_oracle_steps(cfg, state_dict, "O0",
                                                 BERT_O0_BATCH, O0_STEPS)
    grad_err = max(scale_aware_err(g, want_grads[n])[0]
                   for n, g in grads1.items())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    emit("train_bert", opt_level="O0", batch=BERT_O0_BATCH, seq=BERT_SEQ,
         losses=losses, oracle_losses=want_losses, loss_rel_err=loss_err,
         step1_grad_err=grad_err, launches_per_step=counts)
    if not (loss_err <= O0_TOL and grad_err <= O0_TOL):
        raise AssertionError(f"BERT O0: loss error {loss_err:.3g}, step-1 "
                             f"grad error {grad_err:.3g} > {O0_TOL}")
    return {"losses": losses, "oracle_losses": want_losses,
            "loss_rel_err": loss_err, "step1_grad_err": grad_err,
            "launches_per_step": counts}, state_dict


def _bert_o2(state_dict):
    """(b) O2 through ``train()`` at the example's defaults (B 32, S 128)
    with flash attention and dropout, every launch count read around the
    run; losses against the O2 oracle."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    cfg = bert_main_amp.get_config("large")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = bert_main_amp.train(
        cfg, batch=BERT_BATCH, seq_len=BERT_SEQ, steps=O2_STEPS, lr=BERT_LR,
        opt_level="O2", attention_fn=make_flash_attention(),
        deterministic=False, seed=0, device="cuda")
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: O2_STEPS * v
            for k, v in _bert_per_step_launches(cfg, counts).items()}
    if counts != want:
        raise AssertionError(f"BERT O2: launches {counts} != {want}")
    want_losses, _ = _bert_oracle_steps(cfg, state_dict, "O2", BERT_BATCH,
                                        O2_STEPS)
    errs = [abs(a - b) for a, b in zip(out["losses"], want_losses)]
    tps = statistics.median(out["tokens_per_s"][1:])
    emit("train_bert", opt_level="O2", batch=BERT_BATCH, seq=BERT_SEQ,
         steps=O2_STEPS, dropout=DROPOUT, losses=out["losses"],
         oracle_losses=want_losses, max_loss_abs_err=max(errs),
         tokens_per_s_median=tps,
         step_ms=[1e3 * t for t in out["step_seconds"]],
         loss_scale=out["loss_scale"], skipped_steps=out["skipped_steps"],
         peak_memory_gb=peak_gb, launches=counts)
    if not max(errs) <= O2_LOSS_TOL:
        raise AssertionError(f"BERT O2: loss error {max(errs):.3g} > "
                             f"{O2_LOSS_TOL}")
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"BERT O2: non-finite loss {out['losses']}")
    return {**out, "oracle_losses": want_losses, "tokens_per_s_median": tps,
            "peak_memory_gb": peak_gb, "launches": counts}


def _bert_overflow_and_profile(state_dict):
    """(c) an overflowed O2 step under sync-debug "error": the forward
    (its dropout keys and attention seeds made on the host), the
    backward and ``AmpOptimizer(FusedLAMB)``'s step; nothing changes but
    the scale, and no host sync; (d) one O2 step under the profiler."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import bert_main_amp
    cfg = bert_main_amp.get_config("large")
    model, opt, params, st = _bert_build(cfg, "O2", state_dict)
    data = bert_main_amp.batches(cfg, BERT_BATCH, BERT_SEQ)
    steps = itertools.count()

    def batch():
        return tuple(torch.from_numpy(a).to("cuda") for a in next(data))

    params, st, _, _ = bert_main_amp.train_step(
        model, opt, params, st, batch(), deterministic=False,
        dropout_key=bert_main_amp.step_key(0, next(steps)))
    ids, labels, weights, nsp = batch()
    bad = f"encoder.layer_{cfg.num_hidden_layers // 2}.intermediate.weight"
    scale0 = float(opt.loss_scale(st))
    skipped0 = int(st.skipped_steps)
    snap = ({k: v.detach().clone() for k, v in params.items()},
            {k: v.clone() for k, v in st.inner.m.items()},
            {k: v.clone() for k, v in st.inner.v.items()},
            st.inner.step.clone())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mlm, nsp_logits = model.apply(
            params, ids, deterministic=False,
            dropout_key=bert_main_amp.step_key(0, next(steps)))
        loss = bert_main_amp.batch_loss(mlm, nsp_logits, labels, weights,
                                        nsp)
        with amp.scale_loss(loss, st) as scaled:
            grads = dict(zip(params, torch.autograd.grad(
                scaled, list(params.values()))))
        grads[bad][17, 3].fill_(float("inf"))   # a launch, not a copy
        del mlm, nsp_logits, loss, scaled
        params, st = opt.step(params, grads, st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kept = (all(torch.equal(params[k], snap[0][k]) for k in params)
            and all(torch.equal(st.inner.m[k], snap[1][k]) for k in params)
            and all(torch.equal(st.inner.v[k], snap[2][k]) for k in params)
            and torch.equal(st.inner.step, snap[3]))
    scale1 = float(opt.loss_scale(st))
    emit("train_bert", overflow_step=f"inf in {bad}", bits_kept=kept,
         loss_scale_before=scale0, loss_scale_after=scale1,
         skipped_steps=int(st.skipped_steps), host_syncs=0,
         sync_checked="forward, backward and optimizer step")
    if not (kept and scale1 == scale0 / 2
            and int(st.skipped_steps) == skipped0 + 1):
        raise AssertionError("the BERT overflow step changed the state or "
                             "did not halve the scale")
    del grads, snap
    state = {"params": params, "st": st}

    def one_step():
        state["params"], state["st"], loss, _ = bert_main_amp.train_step(
            model, opt, state["params"], state["st"], batch(),
            deterministic=False,
            dropout_key=bert_main_amp.step_key(0, next(steps)))
        float(loss)

    one_step()
    return _profile("train_bert_step_O2", one_step,
                    tokens=BERT_BATCH * BERT_SEQ)


BERT_ACCUM = 4


def _bert_accum_step(cfg, state_dict, accum, batch, *, oracle=False,
                     ddp=False):
    """One O2 step from ``state_dict`` on ``batch`` at ``--grad-accum
    accum`` with step 0's dropout key, on the kernels or (``oracle``) on
    their plain versions; with ``ddp`` through
    ``DistributedDataParallel`` over the current process group.  Returns
    the model, optimizer, params, state and loss."""
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.parallel import DistributedDataParallel
    if oracle:
        model, opt, params, st = bert_main_amp.build(
            cfg, lr=BERT_LR, opt_level="O2",
            attention_fn=_plain_dropout_attention, device="cuda",
            state_dict=state_dict)
        _plain_oracle(model.module)
    else:
        model, opt, params, st = _bert_build(cfg, "O2", state_dict)
    params, st, loss, _ = bert_main_amp.train_step(
        model, opt, params, st, batch, deterministic=False,
        dropout_key=bert_main_amp.step_key(0, 0), grad_accum=accum,
        ddp=DistributedDataParallel(model) if ddp else None)
    return model, opt, params, st, loss


BERT_ACCUM_TIMED = 1      # steps after the checked one, median step ms


def _bert_accum(state_dict):
    """(e) ``--grad-accum``: one step at 1 and one at 4 from the same
    weights and batch, each against the oracle's step, its launches read
    around it (``accum`` times a step's); then ``BERT_ACCUM_TIMED``
    steps timed (median step ms, tokens/s) and the peak memory of that
    model's run alone; an inf planted in microbatch 3's scaled grads
    under sync-debug "error": every bit kept, the scale halved once; the
    4-microbatch step through DDP over an NCCL group of one equal to it
    bit for bit."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    cfg = bert_main_amp.get_config("large")
    data = bert_main_amp.batches(cfg, BERT_BATCH, BERT_SEQ)
    batches = [tuple(torch.from_numpy(a).to("cuda") for a in next(data))
               for _ in range(1 + BERT_ACCUM_TIMED)]
    out, counts = {}, None
    for accum in (1, BERT_ACCUM):
        oracle = _bert_accum_step(cfg, state_dict, accum, batches[0],
                                  oracle=True)
        want_loss = float(oracle[4])
        del oracle
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        model, opt, params, st, loss_t = _bert_accum_step(
            cfg, state_dict, accum, batches[0])
        loss = float(loss_t)
        torch.cuda.synchronize()
        launches = launch_counts()
        want = {k: accum * v for k, v in
                _bert_per_step_launches(cfg, launches).items()}
        if launches != want:
            raise AssertionError(f"BERT grad-accum {accum}: launches "
                                 f"{launches} != {want}")
        if accum == BERT_ACCUM:     # the DDP run's reference, below
            reference = {"loss": loss_t.cpu(), "params": {
                k: v.detach().cpu() for k, v in params.items()}}
        step_ms = []
        for i, batch in enumerate(batches[1:], start=1):
            t0 = time.perf_counter()
            params, st, loss2, _ = bert_main_amp.train_step(
                model, opt, params, st, batch, deterministic=False,
                dropout_key=bert_main_amp.step_key(0, i), grad_accum=accum)
            float(loss2)
            step_ms.append(1e3 * (time.perf_counter() - t0))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if accum == BERT_ACCUM:
            counts = launches
            kept = (model, opt, params, st)
        else:
            del model, opt, params, st
            torch.cuda.empty_cache()
        err = abs(loss - want_loss)
        med = statistics.median(step_ms)
        out[accum] = {"loss": loss, "oracle_loss": want_loss,
                      "loss_abs_err": err, "step_ms": step_ms,
                      "step_ms_median": med,
                      "tokens_per_s": BERT_BATCH * BERT_SEQ / (med / 1e3),
                      "peak_memory_gb": peak_gb, "launches": launches}
        emit("train_bert", run=f"(e) --grad-accum {accum}",
             **out[accum])
        if not err <= O2_LOSS_TOL:
            raise AssertionError(f"BERT grad-accum {accum}: loss error "
                                 f"{err:.3g} > {O2_LOSS_TOL}")

    # an inf in microbatch 3: the whole step skipped, one scale update
    model, opt, params, st = kept
    snap = ({k: v.detach().clone() for k, v in params.items()},
            [t.clone() for t in torch.utils._pytree.tree_leaves(st.inner)])
    scale0, skipped0 = float(opt.loss_scale(st)), int(st.skipped_steps)
    unscale, calls = opt.unscale_grads, []
    bad = f"encoder.layer_{cfg.num_hidden_layers // 2}.intermediate.weight"

    def planting(grads, state, loss_id=0, **kw):
        if len(calls) == 3:
            grads[bad][17, 3].fill_(float("inf"))   # a launch, not a copy
        calls.append(kw.get("update_scale"))
        return unscale(grads, state, loss_id, **kw)

    opt.unscale_grads = planting
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st, _, _ = bert_main_amp.train_step(
            model, opt, params, st, batches[1], deterministic=False,
            dropout_key=bert_main_amp.step_key(0, 99),
            grad_accum=BERT_ACCUM)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        opt.unscale_grads = unscale
    torch.cuda.synchronize()
    kept_bits = (all(torch.equal(params[k], snap[0][k]) for k in params)
                 and all(torch.equal(a, b) for a, b in zip(
                     torch.utils._pytree.tree_leaves(st.inner), snap[1])))
    scale1 = float(opt.loss_scale(st))
    out["overflow"] = {"microbatch": 3, "grad": bad, "bits_kept": kept_bits,
                       "loss_scale_before": scale0,
                       "loss_scale_after": scale1,
                       "unscale_calls_deferred": calls,
                       "skipped_steps": int(st.skipped_steps),
                       "host_syncs": 0}
    emit("train_bert", run="(e) --grad-accum 4, inf in microbatch 3",
         **out["overflow"])
    if not (kept_bits and scale1 == scale0 / 2 and calls == [False] * 4
            and int(st.skipped_steps) == skipped0 + 1):
        raise AssertionError("the grad-accum overflow step changed the "
                             "state or did not halve the scale once")
    del model, opt, params, st, snap, kept
    torch.cuda.empty_cache()

    # the same 4-microbatch step through DDP over NCCL at a world of one
    _nccl_world_of_one()
    try:
        _, _, params, _, loss = _bert_accum_step(cfg, state_dict, BERT_ACCUM,
                                                 batches[0], ddp=True)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
    same = (torch.equal(loss.cpu(), reference["loss"])
            and all(torch.equal(params[k].detach().cpu(),
                                reference["params"][k]) for k in params))
    out["ddp"] = {"loss": float(loss), "bit_equal_to_no_ddp": same}
    emit("train_bert", run="(e) --grad-accum 4 through DDP, NCCL world "
         "of one", **out["ddp"])
    if not same:
        raise AssertionError("BERT grad-accum through DDP at a world of one "
                             "differs from the step without DDP")
    del params, reference
    torch.cuda.empty_cache()
    return out, counts


def phase_train_bert():
    results, state_dict = _bert_o0()
    results = {"O0": results}
    results["O2"] = _bert_o2(state_dict)
    results["profile"] = _bert_overflow_and_profile(state_dict)
    results["accum"], accum_counts = _bert_accum(state_dict)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_bert.json").write_text(json.dumps(results, indent=1,
                                                        default=str))
    return {"train_bert": results["O2"]["launches"],
            "train_bert_accum": accum_counts}


# -- GPT remat and dropout, BERT remat ---------------------------------------

GPT_DROPOUT_STEPS = 3      # GPT-2 small's dropout runs, and BERT remat's


def _gpt_launches(cfg, names, remat=False, dropout=False):
    """Launches of one GPT training step (``_per_step_launches``) under
    remat and dropout: remat runs each block's forward twice (B2 and B4
    twice a block); dropout moves attention onto the dropout branches
    and adds the hidden dropouts: 2L+1 forward (embeddings, two a block)
    and as many backward, and under remat each block's first again in
    the recompute (its output feeds the next LayerNorm, whose input is
    saved; checkpoint stops before the second, whose output nothing
    saves)."""
    n = cfg.num_hidden_layers
    fwd = 2 if remat else 1
    sfx = "_dropout" if dropout else ""
    step = {"layer_norm_fwd": 2 * n * fwd + 1, "layer_norm_bwd": 2 * n + 1,
            "flash_fwd" + sfx: n * fwd, "flash_bwd_dq" + sfx: n,
            "flash_bwd_dkv" + sfx: n, "fused_adam": 1}
    if dropout:
        step["threefry_dropout"] = 2 * (2 * n + 1) + (n if remat else 0)
    return {name: step.get(name, 0) for name in names}


def _bert_remat_launches(cfg, names):
    """``_bert_per_step_launches`` under remat: each layer's forward runs
    twice, its two LayerNorms, its attention and its two hidden dropouts
    (both outputs feed a LayerNorm) with it."""
    n = cfg.num_hidden_layers
    step = _bert_per_step_launches(cfg, names)
    for name, extra in (("layer_norm_fwd", 2 * n), ("flash_fwd_dropout", n),
                        ("threefry_dropout", 2 * n)):
        step[name] += extra
    return step


def _counted_run(train, **kw):
    """``train(**kw)`` with every launch count at 0 just before and read
    just after; returns the run, the counts, the peak memory (GB) and the
    median tokens/s of its steps after the first."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = train(**kw)
    torch.cuda.synchronize()
    counts = launch_counts()
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"non-finite loss {out['losses']}")
    return (out, counts, torch.cuda.max_memory_allocated() / 1e9,
            statistics.median(out["tokens_per_s"][1:]))


def _same_run(a, b):
    """Losses, scaler and every param of two runs bit for bit."""
    import torch
    return (a["losses"] == b["losses"]
            and (a["loss_scale"], a["skipped_steps"], a["applied_steps"])
            == (b["loss_scale"], b["skipped_steps"], b["applied_steps"])
            and all(torch.equal(p, b["params"][k])
                    for k, p in a["params"].items()))


def _check_counts(label, counts, per_step, steps):
    want = {k: steps * v for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} != {want}")


def phase_train_gpt_remat():
    """GPT-2 small through ``gpt_main_amp.train(remat=True)`` at the
    example's defaults (B 8, S 1024, O2, flash, ``O2_STEPS`` steps), the
    counts read around it (B2 and B4 twice a block), beside the same run
    without remat from the same weights and batches: losses, params and
    scaler bit for bit at every step; peak memory and tokens/s of
    both."""
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    kw = dict(cfg=cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=O2_STEPS,
              lr=TRAIN_LR, opt_level="O2", device="cuda", seed=0)
    plain, _, plain_peak, plain_tps = _counted_run(gpt_main_amp.train, **kw)
    remat, counts, peak, tps = _counted_run(gpt_main_amp.train,
                                            remat=True, **kw)
    same = _same_run(remat, plain)
    emit("train_gpt_remat", steps=O2_STEPS, losses=remat["losses"],
         bit_equal_to_no_remat=same, peak_memory_gb=peak,
         no_remat_peak_memory_gb=plain_peak, tokens_per_s_median=tps,
         no_remat_tokens_per_s_median=plain_tps,
         step_ms=[1e3 * t for t in remat["step_seconds"]],
         no_remat_step_ms=[1e3 * t for t in plain["step_seconds"]],
         launches=counts)
    _check_counts("GPT remat", counts, _gpt_launches(cfg, counts, remat=True),
                  O2_STEPS)
    if not same:
        raise AssertionError("GPT remat: the run differs from the one "
                             "without remat")
    return {"train_gpt_remat": counts}


def phase_train_gpt_dropout():
    """GPT-2 small O2 with flash attention at the configuration's own
    dropout (0.1 hidden, 0.1 attention), ``deterministic=False``, step i
    keyed ``step_key(0, i)``, ``GPT_DROPOUT_STEPS`` steps through
    ``train()``: losses within 2e-2 of the kernel-free oracle on the card
    (plain attention with the kernels' hash dropout, the plain threefry
    dropout, the same keys); the same run with remat bit for bit; each
    run's counts read around it."""
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    kw = dict(cfg=cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
              steps=GPT_DROPOUT_STEPS, lr=TRAIN_LR, opt_level="O2",
              device="cuda", seed=0, deterministic=False)
    out, counts, peak, tps = _counted_run(gpt_main_amp.train, **kw)
    _check_counts("GPT dropout", counts,
                  _gpt_launches(cfg, counts, dropout=True), GPT_DROPOUT_STEPS)
    remat, rcounts, rpeak, rtps = _counted_run(gpt_main_amp.train, remat=True,
                                               **kw)
    _check_counts("GPT dropout remat", rcounts,
                  _gpt_launches(cfg, rcounts, remat=True, dropout=True),
                  GPT_DROPOUT_STEPS)
    same = _same_run(remat, out)
    want, _ = _oracle_steps(cfg, "O2", TRAIN_BATCH, GPT_DROPOUT_STEPS,
                            deterministic=False)
    errs = [abs(a - b) for a, b in zip(out["losses"], want)]
    emit("train_gpt_dropout", steps=GPT_DROPOUT_STEPS, dropout=DROPOUT,
         losses=out["losses"], oracle_losses=want,
         max_loss_abs_err=max(errs), remat_bit_equal=same,
         tokens_per_s_median=tps, remat_tokens_per_s_median=rtps,
         peak_memory_gb=peak, remat_peak_memory_gb=rpeak,
         step_ms=[1e3 * t for t in out["step_seconds"]], launches=counts,
         remat_launches=rcounts)
    if not max(errs) <= O2_LOSS_TOL:
        raise AssertionError(f"GPT dropout: loss error {max(errs):.3g} > "
                             f"{O2_LOSS_TOL}")
    if not same:
        raise AssertionError("GPT dropout: the remat run differs")
    return {"train_gpt_dropout": counts, "train_gpt_dropout_remat": rcounts}


def phase_train_bert_remat():
    """``bert_main_amp.train(remat=True)`` at the example's defaults
    (BERT-large, B 32, S 128, O2, FusedLAMB, dropout 0.1, flash),
    ``GPT_DROPOUT_STEPS`` steps, against the same run without remat: bit
    for bit; counts, peak memory and tokens/s of both."""
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    cfg = bert_main_amp.get_config("large")
    kw = dict(cfg=cfg, batch=BERT_BATCH, seq_len=BERT_SEQ,
              steps=GPT_DROPOUT_STEPS, lr=BERT_LR, opt_level="O2",
              attention_fn=make_flash_attention(), deterministic=False,
              seed=0, device="cuda")
    plain, _, plain_peak, plain_tps = _counted_run(bert_main_amp.train, **kw)
    remat, counts, peak, tps = _counted_run(bert_main_amp.train, remat=True,
                                            **kw)
    same = _same_run(remat, plain)
    emit("train_bert_remat", steps=GPT_DROPOUT_STEPS, losses=remat["losses"],
         bit_equal_to_no_remat=same, peak_memory_gb=peak,
         no_remat_peak_memory_gb=plain_peak, tokens_per_s_median=tps,
         no_remat_tokens_per_s_median=plain_tps,
         step_ms=[1e3 * t for t in remat["step_seconds"]],
         no_remat_step_ms=[1e3 * t for t in plain["step_seconds"]],
         launches=counts)
    _check_counts("BERT remat", counts, _bert_remat_launches(cfg, counts),
                  GPT_DROPOUT_STEPS)
    if not same:
        raise AssertionError("BERT remat: the run differs from the one "
                             "without remat")
    return {"train_bert_remat": counts}


# -- adam_rest: FusedAdam's tree and grouped layouts, FP16_Optimizer ---------

ADAM_STEPS = 3
NO_DECAY = [{"match": r"(bias|_ln)", "weight_decay": 0.0}]


def _adam_grads(torch, params, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return {k: 1e-2 * torch.randn(t.shape, device="cuda", generator=g)
            for k, t in params.items()}


def _adam_steps(opt, params, steps, **kw):
    """``steps`` steps of ``opt`` from a copy of ``params`` on the same
    gradients; returns the params, the state and the counts read around
    the steps."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    params = {k: t.clone() for k, t in params.items()}
    state = opt.init(params)
    grads = [_adam_grads(torch, params, 100 + i) for i in range(steps)]
    torch.cuda.synchronize()
    reset_launch_counts()
    for g in grads:
        params, state = opt.step(params, g, state, **kw)
    torch.cuda.synchronize()
    return params, state, launch_counts()


def _overflow_keeps_bits(torch, opt, params, label):
    """One clean step, then an inf planted with ``fill_`` and a step
    with amp's overflow flag under sync-debug "error": every param, m,
    v and the clock keep their bits."""
    from torch.utils import _pytree as pytree
    params, state, _ = _adam_steps(opt, params, 1)
    grads = _adam_grads(torch, params, 7)
    grads["blocks.1.mlp_in.weight"][5].fill_(float("inf"))
    snap = [t.detach().clone() for t in params.values()]
    moments = [t.clone() for t in pytree.tree_leaves(
        (state.m, state.v, state.step))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        overflow = ~torch.stack([torch.isfinite(g).all()
                                 for g in grads.values()]).all()
        params, state = opt.step(params, grads, state, skip=overflow)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kept = all(torch.equal(a.detach(), b)
               for a, b in zip(params.values(), snap)) and all(
        torch.equal(a, b) for a, b in zip(pytree.tree_leaves(
            (state.m, state.v, state.step)), moments))
    if not kept:
        raise AssertionError(f"{label}: the overflowed step changed a bit")
    return True


def _fp16_optimizer_leg(torch, params):
    """The cut-down FP16_Optimizer over GPT-2 small in bf16 (the half
    dtype the JAX test takes): 3 steps with the dynamic scale, the
    second overflowed (an inf planted with ``fill_``), all under
    sync-debug "error": the scale halves once, the step is skipped and
    the master keeps its bits, the others move it."""
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.optimizers import FP16_Optimizer, FusedAdam
    opt = FP16_Optimizer(FusedAdam(lr=TRAIN_LR), dynamic_loss_scale=True)
    half = {k: t.to(torch.bfloat16) for k, t in params.items()}
    state = opt.init(half)
    scale0 = float(opt.loss_scale(state))
    grads = [{k: (v * scale0).to(torch.bfloat16) for k, v in
              _adam_grads(torch, params, 200 + i).items()} for i in range(3)]
    grads[1]["wte.weight"][11].fill_(float("inf"))
    masters, scales = [], []
    torch.cuda.synchronize()
    reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for g in grads:
            half, state = opt.step(half, g, state)
            masters.append(state.master.clone())
            scales.append(state.scaler.loss_scale.clone())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    counts = launch_counts()
    scales = [float(s) for s in scales]
    ok = (scales == [scale0, scale0 / 2, scale0 / 2]
          and torch.equal(masters[0], masters[1])
          and not torch.equal(masters[1], masters[2])
          and int(state.inner.step) == 2
          and counts["fused_adam"] == 3
          and half["wte.weight"].dtype == torch.bfloat16)
    if not ok:
        raise AssertionError(f"FP16_Optimizer: scales {scales}, step "
                             f"{int(state.inner.step)}, launches {counts}")
    return {"loss_scales": scales, "skipped_kept_bits": True,
            "steps_taken": int(state.inner.step), "host_syncs": 0}


def phase_adam_rest():
    """FusedAdam's rest on GPT-2 small's parameter dict (seeded, 196
    leaves) with seeded gradients, ``ADAM_STEPS`` steps a run:
    (a) the tree layout against the flat one, bit for bit, no norm; one
        B1-multi launch a step (the path ``adam_rest``);
    (b) the grouped flat layout (no weight decay on ``bias|_ln``,
        ``max_grad_norm=1.0``) against the tree layout with the same
        groups, within ``ADAM_TOL`` scale-aware (the group norms are
        summed in different orders); one B1-multi launch a step;
    (c) ``update`` equal to ``step``: the updates bit for bit the
        stepped params less the old ones;
    (d) an overflowed step on both layouts under sync-debug "error":
        every bit kept;
    (e) the cut-down FP16_Optimizer (``_fp16_optimizer_leg``)."""
    import torch
    from apex_tpu_torch.optimizers import FusedAdam
    params = _gpt_small_leaves(seed=0)
    kw = dict(lr=TRAIN_LR, weight_decay=0.01)
    tree, tstate, counts = _adam_steps(FusedAdam(layout="tree", **kw), params,
                                       ADAM_STEPS, scale=2.0)
    flat, _, fcounts = _adam_steps(FusedAdam(**kw), params, ADAM_STEPS,
                                   scale=2.0)
    tree_is_flat = all(torch.equal(tree[k], flat[k].detach()) for k in tree)
    groups = dict(kw, param_groups=NO_DECAY, max_grad_norm=1.0)
    gflat, _, gcounts = _adam_steps(FusedAdam(**groups), params, ADAM_STEPS)
    gtree, _, _ = _adam_steps(FusedAdam(layout="tree", **groups), params,
                              ADAM_STEPS)
    grouped_err = max(scale_aware_err(gflat[k].detach(), gtree[k])[0]
                      for k in gtree)
    ups = {}
    for layout in ("tree", "flat"):
        opt = FusedAdam(layout=layout, param_groups=NO_DECAY, **kw)
        grads = _adam_grads(torch, params, 100)
        ref = {k: t.clone() for k, t in params.items()}
        updates, _ = opt.update(grads, opt.init(ref), ref)
        stepped, _ = opt.step({k: t.clone() for k, t in params.items()},
                              grads, opt.init(ref))
        ups[layout] = all(torch.equal(updates[k],
                                      stepped[k].detach() - params[k])
                          for k in params)
    overflow = {layout: _overflow_keeps_bits(
        torch, FusedAdam(layout=layout, param_groups=NO_DECAY, **kw), params,
        f"FusedAdam {layout}") for layout in ("tree", "flat")}
    fp16 = _fp16_optimizer_leg(torch, params)
    emit("adam_rest", leaves=len(params), steps=ADAM_STEPS,
         tree_bit_equal_to_flat=tree_is_flat,
         grouped_flat_vs_tree_err=grouped_err, update_equals_step=ups,
         overflow_bits_kept=overflow, fp16_optimizer=fp16,
         launches=counts, flat_launches=fcounts, grouped_launches=gcounts)
    want = {"fused_adam_multi": ADAM_STEPS}
    for label, got in (("tree", counts), ("grouped", gcounts)):
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"FusedAdam {label}: launches {got}")
    if not (tree_is_flat and grouped_err <= ADAM_TOL and all(ups.values())):
        raise AssertionError(f"FusedAdam: tree == flat {tree_is_flat}, "
                             f"grouped error {grouped_err:.3g}, update == "
                             f"step {ups}")
    return {"adam_rest": counts}


# -- hf_bert: load_hf_bert at BERT-large ---------------------------------------

def _hf_bert_state_dict(torch, cfg, seed=0):
    """A HuggingFace ``BertForPreTraining`` state dict of ``cfg``'s
    shapes on the CPU, from a seeded CPU generator: normal(0.02) weights
    and biases, LayerNorm scales 1 + normal(0.1), the tied
    ``cls.predictions.bias`` and the ``position_ids`` buffer."""
    g = torch.Generator().manual_seed(seed)
    h, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    sd = {}

    def normal(*shape, std=0.02, mean=0.0):
        return torch.empty(shape).normal_(mean, std, generator=g)

    def lin(name, n_out, n_in):
        sd[f"{name}.weight"] = normal(n_out, n_in)
        sd[f"{name}.bias"] = normal(n_out)

    def ln(name):
        sd[f"{name}.weight"] = normal(h, std=0.1, mean=1.0)
        sd[f"{name}.bias"] = normal(h, std=0.1)

    for name, n in (("word_embeddings", v),
                    ("position_embeddings", cfg.max_position_embeddings),
                    ("token_type_embeddings", cfg.type_vocab_size)):
        sd[f"bert.embeddings.{name}.weight"] = normal(n, h)
    ln("bert.embeddings.LayerNorm")
    for i in range(cfg.num_hidden_layers):
        pre = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{pre}.attention.self.{name}", h, h)
        lin(f"{pre}.attention.output.dense", h, h)
        ln(f"{pre}.attention.output.LayerNorm")
        lin(f"{pre}.intermediate.dense", f, h)
        lin(f"{pre}.output.dense", h, f)
        ln(f"{pre}.output.LayerNorm")
    lin("bert.pooler.dense", h, h)
    lin("cls.predictions.transform.dense", h, h)
    ln("cls.predictions.transform.LayerNorm")
    lin("cls.predictions.decoder", v, h)
    sd["cls.predictions.bias"] = sd["cls.predictions.decoder.bias"]
    lin("cls.seq_relationship", 2, h)
    sd["bert.embeddings.position_ids"] = torch.arange(
        cfg.max_position_embeddings)[None]
    return sd


HF_BATCH = 8


def phase_hf_bert():
    """``utils.load_hf_bert`` on a BERT-large HuggingFace-named state dict
    made in-process (``_hf_bert_state_dict``): the conversion's seconds
    on the host clock, every key consumed (a leftover raises), every
    model parameter filled (a strict ``load_state_dict``); the loaded
    model's MLM and NSP logits (fp32, TF32 off, B 8, S 128, padded rows,
    segments) through B2 and B4 (the path ``hf_bert``, counts read
    around it) against the same weights on its own plain path (plain
    LayerNorm and attention: no kernel), within ``O0_TOL`` scale-aware."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.models import BertForPreTraining, bert_large
    from apex_tpu_torch.ops import make_flash_attention
    from apex_tpu_torch.utils import load_hf_bert
    cfg = bert_large()
    sd = _hf_bert_state_dict(torch, cfg)
    t0 = time.perf_counter()
    params = load_hf_bert(sd, cfg.num_hidden_layers,
                          cfg.num_attention_heads)["params"]
    seconds = time.perf_counter() - t0
    model = BertForPreTraining(cfg, attention_fn=make_flash_attention(),
                               device="cuda", seed=None)
    model.load_state_dict(params)
    oracle = _plain_oracle(BertForPreTraining(
        cfg, attention_fn=_plain_dropout_attention, device="cuda",
        seed=None))
    oracle.load_state_dict(params)
    rng = np.random.RandomState(0)
    ids = rng.randint(4, cfg.vocab_size, (HF_BATCH, BERT_SEQ))
    mask = np.ones_like(ids)
    mask[1::2, 100:] = 0
    segs = rng.randint(0, 2, ids.shape)
    args = [torch.from_numpy(a).to("cuda") for a in (ids, mask, segs)]
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_launch_counts()
        got = model(*args)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = oracle(*args)
        torch.cuda.synchronize()
    if launch_counts() != counts:
        raise AssertionError("the hf_bert oracle launched a port kernel")
    errs = [scale_aware_err(a, b)[0] for a, b in zip(got, want)]
    n = cfg.num_hidden_layers
    per_call = {"layer_norm_fwd": 2 * n + 2, "flash_fwd": n}
    emit("hf_bert", keys=len(sd), params=len(params),
         elements=sum(t.numel() for t in params.values()),
         conversion_seconds=seconds, mlm_err=errs[0], nsp_err=errs[1],
         launches=counts)
    _check_counts("hf_bert", counts, {k: per_call.get(k, 0) for k in counts},
                  1)
    if not max(errs) <= O0_TOL:
        raise AssertionError(f"hf_bert: logits error {max(errs):.3g} > "
                             f"{O0_TOL}")
    return {"hf_bert": counts}


# -- train_o1 and train_simple: amp O1 -----------------------------------------

SIMPLE_TOL = 2e-2   # O1 against O0, each epoch's mean loss, absolute
# GPT-2 small's O1 run (the checked one) and one O2 run, timed (the
# O2 run's launches and losses are train's; its repeats were cut so that
# serve_features' offload legs fit in the script's time)
O1_TURNS = ("O1", "O2")


def _o1_cleanup():
    """The end of each O1 phase: the policy's patches removed, the amp
    state reset, and every patched torch function its original again, so
    the policy reaches no later phase."""
    from apex_tpu_torch import amp
    from apex_tpu_torch.amp import _amp_state, patch
    amp.remove_o1_patches()
    _amp_state._amp_state.opt_properties = None
    _amp_state._amp_state.casts_disabled = False
    left = [f"{m.__name__}.{n}" for m, n, _ in patch._targets()
            if hasattr(getattr(m, n), "__amp_original__")]
    if left:
        raise AssertionError(f"O1 patches left installed: {left}")


def _amp_host_costs(model, params, one_step):
    """What amp's model side and O1's policy cost the host in a step (the
    host clock of the card's machine, each loop ended by a sync): the
    mean ms of ``compute_variables`` (the param casts it launches) with
    the norm-output hook context entered and left; the patched calls one
    step makes, counted by shims over the installed wrappers; and a
    wrapper's own cost, ``F.cross_entropy`` on small device tensors,
    wrapped against its original."""
    import collections
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch.amp import patch
    n = 100
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        with model._apply_context():
            model.compute_variables(params)
    torch.cuda.synchronize()
    out = {"model_side_ms": (time.perf_counter() - t0) * 1e3 / n}
    calls = collections.Counter()
    installed = [(m, name, getattr(m, name))
                 for m, name, _ in patch._targets()]

    def shim(fn, key):
        def counted(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return counted

    for m, name, fn in installed:
        setattr(m, name, shim(fn, f"{m.__name__}.{name}"))
    try:
        one_step()
    finally:
        for m, name, fn in installed:
            setattr(m, name, fn)
    out["patched_calls_per_step"] = dict(calls)
    logits = torch.randn(8, 16, device="cuda")
    labels = torch.zeros(8, dtype=torch.int64, device="cuda")
    per_call = {}
    for key, fn in (("wrapped", F.cross_entropy),
                    ("original", F.cross_entropy.__amp_original__)):
        fn(logits, labels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(1000):
            fn(logits, labels)
        torch.cuda.synchronize()
        per_call[key] = (time.perf_counter() - t0) * 1e3
    out["cross_entropy_us"] = per_call
    out["wrapper_us_per_call"] = per_call["wrapped"] - per_call["original"]
    return out


def _o1_layout_overflow_and_profiles():
    """(c) the O1 compute layout: LayerNorm's params enter B2/B3 as the
    fp32 masters themselves (no cast between), every other param bf16,
    and dgamma/dbeta arrive fp32; (d) an overflowed O1 step under
    sync-debug "error" over the forward (the patched ``F.cross_entropy``
    included), the backward and FusedAdam: p, m, v and the step counter
    keep every bit, the scale halves, no host sync; (e) one O1 and one
    O2 step under the profiler, then each level's host costs
    (``_amp_host_costs``; under O2 the O1 wrappers stay installed,
    inert)."""
    import torch
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models import lm_loss
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)

    def batch():
        return torch.from_numpy(next(data)).to("cuda")

    model, opt, params, st = gpt_main_amp.build(
        cfg, lr=TRAIN_LR, opt_level="O1", device="cuda", seed=0)
    compute = model.compute_variables(params)
    ln_names = [n for n in params if "_ln." in n]
    if not (len(ln_names) == 2 * (2 * cfg.num_hidden_layers + 1)
            and all(compute[n] is params[n] for n in ln_names)
            and all(params[n].dtype == torch.float32 for n in ln_names)
            and all(t.dtype == torch.bfloat16 for n, t in compute.items()
                    if n not in ln_names)):
        raise AssertionError("O1: the compute layout is not LayerNorm fp32 "
                             "and the rest bf16")
    params, st, _, grads = gpt_main_amp.train_step(model, opt, params, st,
                                                   batch())
    if not all(g.dtype == torch.float32 for g in grads.values()):
        raise AssertionError("O1: a gradient is not fp32")
    del grads
    ids = batch()
    inner = st.inner
    snap = (inner.p.clone(), inner.m.clone(), inner.v.clone(),
            inner.step.clone())
    scale0, skipped0 = float(opt.loss_scale(st)), int(st.skipped_steps)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = lm_loss(model.apply(params, ids), ids)
        with amp.scale_loss(loss, st) as scaled:
            grads = dict(zip(params, torch.autograd.grad(
                scaled, list(params.values()))))
        grads["blocks.5.mlp_in.weight"][17, 3].fill_(float("inf"))
        del loss, scaled
        params, st = opt.step(params, grads, st)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(
        (st.inner.p, st.inner.m, st.inner.v, st.inner.step), snap))
    scale1 = float(opt.loss_scale(st))
    emit("train_o1", overflow_step="inf in blocks.5.mlp_in.weight",
         bits_kept=kept, loss_scale_before=scale0, loss_scale_after=scale1,
         skipped_steps=int(st.skipped_steps), host_syncs=0,
         sync_checked="forward, backward and optimizer step",
         layernorm_params="fp32 masters, uncast", grads="fp32")
    if not (kept and scale1 == scale0 / 2
            and int(st.skipped_steps) == skipped0 + 1):
        raise AssertionError("the O1 overflow step changed the state or "
                             "did not halve the scale")
    del grads, snap
    profiles = {}
    for level in ("O1", "O2"):
        if level == "O2":
            model, opt, params, st = gpt_main_amp.build(
                cfg, lr=TRAIN_LR, opt_level="O2", device="cuda", seed=0)
        state = {"params": params, "st": st}

        def one_step():
            state["params"], state["st"], loss, _ = gpt_main_amp.train_step(
                model, opt, state["params"], state["st"], batch())
            float(loss)

        one_step()
        profiles[level] = _profile(f"train_step_{level}", one_step,
                                   tokens=TRAIN_BATCH * TRAIN_SEQ)
        profiles[level]["host"] = _amp_host_costs(model, state["params"],
                                                  one_step)
        emit("train_o1", opt_level=level, amp_host=profiles[level]["host"])
        del state, params, st
        torch.cuda.empty_cache()
    return profiles


def phase_train_o1():
    """GPT-2 small under O1 at B 8, S 1024 on B1-B6: (a) ``train()``, its
    launches exact, losses within 2e-2 of the kernel-free O1 oracle;
    (b) tokens/s of O1 and O2 on this card (``O1_TURNS``);
    (c)-(f) in ``_o1_layout_overflow_and_profiles``."""
    import torch
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    try:
        out, counts, peak_gb = _gpt_train(cfg, "O1")
        want_losses, _ = _oracle_steps(cfg, "O1", TRAIN_BATCH, O2_STEPS)
        errs = [abs(a - b) for a, b in zip(out["losses"], want_losses)]
        emit("train_o1", opt_level="O1", batch=TRAIN_BATCH, seq=TRAIN_SEQ,
             steps=O2_STEPS, losses=out["losses"],
             oracle_losses=want_losses, max_loss_abs_err=max(errs),
             step_ms=[1e3 * t for t in out["step_seconds"]],
             loss_scale=out["loss_scale"],
             skipped_steps=out["skipped_steps"], peak_memory_gb=peak_gb,
             launches=counts)
        if not max(errs) <= O2_LOSS_TOL:
            raise AssertionError(f"O1: loss error {max(errs):.3g} > "
                                 f"{O2_LOSS_TOL}")
        runs = {"O1": [out], "O2": []}
        peaks = {"O1": [peak_gb], "O2": []}
        for level in O1_TURNS[1:]:
            torch.cuda.empty_cache()
            run, _, peak = _gpt_train(cfg, level)
            runs[level].append(run)
            peaks[level].append(peak)
        torch.cuda.empty_cache()
        profiles = _o1_layout_overflow_and_profiles()
        summary = {}
        for level in ("O1", "O2"):
            tps = [statistics.median(r["tokens_per_s"][1:])
                   for r in runs[level]]
            prof = profiles[level]
            summary[level] = {
                "tokens_per_s_median": tps, "peak_memory_gb": peaks[level],
                "device_busy_ms": prof.get("device_busy_ms"),
                "kernel_launches": prof.get("kernel_launches"),
                "device_idle_share": prof.get("device_idle_share")}
        emit("train_o1", o1_against_o2=summary,
             order=f"{', '.join(O1_TURNS)} ({O2_STEPS} steps each), then "
             "one profiled step each")
    finally:
        _o1_cleanup()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_o1.json").write_text(json.dumps(
        {"runs": runs, "oracle_losses": want_losses, "profiles": profiles,
         "summary": summary}, indent=1, default=str))
    return counts


def _simple_probe_and_profile():
    """Under the twin's O1: its first Linear runs bf16, ``F.cross_entropy``
    computes in fp32 on bf16 logits, and the probability form of BCE is
    refused; then one O1 step under the profiler."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch import amp
    from apex_tpu_torch.examples import simple_main_amp as simple
    model, opt = amp.initialize(simple.MLP(device="cuda"),
                                simple.transforms.sgd(0.05),
                                opt_level="O1", verbosity=0)
    seen = {}
    model.module.Dense_0.register_forward_hook(
        lambda m, a, out: seen.update(dense_0=out.dtype))
    params = model.init()
    st = opt.init(params)
    x, y = (torch.from_numpy(a).to("cuda")
            for a in simple.synthetic_data(256, 784, 10))
    params, st, _ = simple.train_step(model, opt, params, st, x, y)
    ce = F.cross_entropy(torch.randn(4, 10, device="cuda")
                         .to(torch.bfloat16),
                         torch.zeros(4, dtype=torch.int64, device="cuda"))
    try:
        F.binary_cross_entropy(torch.full((2,), 0.5, device="cuda"),
                               torch.ones(2, device="cuda"))
        banned = False
    except RuntimeError as e:
        banned = "with_logits" in str(e)
    probe = {"dense_0": str(seen.get("dense_0")),
             "cross_entropy_on_bf16_logits": str(ce.dtype),
             "binary_cross_entropy_refused": banned}
    if probe != {"dense_0": "torch.bfloat16",
                 "cross_entropy_on_bf16_logits": "torch.float32",
                 "binary_cross_entropy_refused": True}:
        raise AssertionError(f"O1 dtype probe: {probe}")
    state = {"params": params, "st": st}

    def one_step():
        state["params"], state["st"], loss = simple.train_step(
            model, opt, state["params"], state["st"], x, y)
        float(loss)

    one_step()
    return probe, _profile("train_simple_step_O1", one_step, samples=256)


def phase_train_simple():
    """``examples.simple_main_amp.train()`` at its defaults on the card
    (O1, the synthetic 8192 x 784 data, 5 epochs of 32 steps of 256, seed
    0 weights): finite losses that fall; the same run at O0 from the same
    data and weights, each epoch's mean loss within 2e-2; the dtype
    probe; samples/s (median of epochs 1-4, each epoch ended by reading
    its losses); one O1 step under the profiler."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import simple_main_amp as simple
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        o1 = simple.train()
        torch.cuda.synchronize()
        counts = launch_counts()
        o0 = simple.train("O0")
        probe, profile = _simple_probe_and_profile()
        errs = [abs(a - b) for a, b in zip(o1["epoch_losses"],
                                           o0["epoch_losses"])]
        sps = {k: statistics.median(r["samples_per_s"][1:])
               for k, r in (("O1", o1), ("O0", o0))}
        emit("train_simple", opt_level="O1", epoch_losses=o1["epoch_losses"],
             o0_epoch_losses=o0["epoch_losses"], max_epoch_loss_abs_err=max(
                 errs), samples_per_s_median=sps,
             loss_scale=o1["loss_scale"], skipped_steps=o1["skipped_steps"],
             probe=probe, launches=counts,
             step_profile={k: profile.get(k) for k in (
                 "device_busy_ms", "kernel_launches", "device_idle_share",
                 "wall_ms")})
        if not (np.isfinite(o1["losses"]).all()
                and o1["epoch_losses"][-1] < o1["epoch_losses"][0]):
            raise AssertionError(f"simple O1: losses {o1['epoch_losses']}")
        if not max(errs) <= SIMPLE_TOL:
            raise AssertionError(f"simple: O1 against O0 {max(errs):.3g} > "
                                 f"{SIMPLE_TOL}")
    finally:
        _o1_cleanup()
    return counts


# -- train_dcgan ---------------------------------------------------------------

# O1 against O0 from the same state, each step's D and G loss, relative to
# the O0 loss where it exceeds 1: D soon drives G's loss to ~9, where one
# bf16 step of a logit is 0.0625 and an absolute 2e-2 would ask O1's
# bf16 logits for more than bf16 holds
DCGAN_TOL = 2e-2


def _clone_tree(tree):
    import torch
    from torch.utils import _pytree as pytree
    return pytree.tree_map(
        lambda t: t.detach().clone().requires_grad_(t.requires_grad)
        if isinstance(t, torch.Tensor) else t, tree)


def _dcgan_same_state(args, state_dicts):
    """(b) every iteration of an O1 run from ``state_dicts`` beside the
    O0 step from the same state (params, optimizer and scaler states,
    running statistics) on the same batch: each step's two loss errors,
    relative to the O0 loss where it exceeds 1 (``DCGAN_TOL``).  A
    GAN's free-running trajectories separate, so the levels are held
    step by step; each step runs with its own model's policy active."""
    import torch
    from apex_tpu_torch.amp import _amp_state
    from apex_tpu_torch.examples import dcgan_main_amp as dcgan
    o0 = type(args)(**{**vars(args), "opt_level": "O0"})
    one = list(dcgan.build(args, device="cuda", state_dicts=state_dicts))
    zero = list(dcgan.build(o0, device="cuda", state_dicts=state_dicts))
    data = dcgan.synthetic_batches(args)
    errs = []
    for _ in range(args.iters):
        real, z = (torch.from_numpy(a).to("cuda") for a in next(data))
        with torch.no_grad():
            for m0, m1 in ((zero[0], one[0]), (zero[1], one[1])):
                for b0, b1 in zip(m0.unwrapped.buffers(),
                                  m1.unwrapped.buffers()):
                    b0.copy_(b1)
        _amp_state._amp_state.opt_properties = zero[0].properties
        ref = dcgan.train_step(*zero[:4], *_clone_tree(one[4:8]), real, z)
        _amp_state._amp_state.opt_properties = one[0].properties
        got = dcgan.train_step(*one[:8], real, z)
        one[4:8] = got[:4]
        errs.append(tuple(abs(float(got[i]) - float(ref[i]))
                          / max(1.0, abs(float(ref[i]))) for i in (4, 5)))
    return errs


def _dcgan_overflow(args, state_dicts):
    """(c) an inf in the real batch: D's step skipped (params kept) and
    scaler 0 halved; scalers 1 and 2 kept, G's step taken."""
    import torch
    from apex_tpu_torch.examples import dcgan_main_amp as dcgan
    G, D, optG, optD, pG, pD, sG, sD = dcgan.build(
        args, device="cuda", state_dicts=state_dicts)
    real, z = (torch.from_numpy(a).to("cuda")
               for a in next(dcgan.synthetic_batches(args)))
    real[0, 0, 0, 0].fill_(float("inf"))
    before = _clone_tree((pG, pD))
    scales0 = [float(optD.loss_scale(sD, 0)), float(optD.loss_scale(sD, 1)),
               float(optG.loss_scale(sG, 2))]
    pG2, pD2, sG2, sD2, _, errG = dcgan.train_step(
        G, D, optG, optD, pG, pD, sG, sD, real, z)
    scales = [float(optD.loss_scale(sD2, 0)),
              float(optD.loss_scale(sD2, 1)), float(optG.loss_scale(sG2, 2))]
    d_kept = all(torch.equal(pD2[k], before[1][k]) for k in pD2)
    g_moved = any(not torch.equal(pG2[k], before[0][k]) for k in pG2)
    out = {"d_params_kept": d_kept, "g_stepped": g_moved,
           "scales_before": scales0, "scales_after": scales,
           "d_skipped_steps": int(sD2.skipped_steps),
           "g_applied_steps": int(sG2.applied_steps),
           "loss_g": float(errG)}
    emit("train_dcgan", run="(c) inf in the real batch", **out)
    if not (d_kept and g_moved and scales == [scales0[0] / 2, scales0[1],
                                              scales0[2]]
            and int(sD2.skipped_steps) == 1
            and int(sG2.applied_steps) == 1):
        raise AssertionError(f"DCGAN overflow step: {out}")
    return out


def phase_train_dcgan():
    """``examples.dcgan_main_amp.train()`` at its defaults on the card (O1,
    B 64, 64x64, nz 100, base 64, 20 iterations, seed 0): (a) the run,
    counts read around it, losses finite, images/s (median of iterations
    1-19), peak memory; (b) each iteration's O0 step from the same state
    within ``DCGAN_TOL`` on D's and G's losses, and the free-running O0
    run's distance recorded; (c) the overflow step; (d) one O1 iteration
    under the profiler.  Ends by removing the O1 policy."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import dcgan_main_amp as dcgan
    try:
        args = dcgan.parse_args([])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        o1 = dcgan.train(args, device="cuda")
        torch.cuda.synchronize()
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ips = statistics.median(o1["images_per_s"][1:])
        state_dicts = tuple(
            {k: v.detach().clone() for k, v in m.unwrapped.state_dict()
             .items()}
            for m in (dcgan.build(args, device="cuda")[:2]))
        if not (np.isfinite(o1["loss_d"]).all()
                and np.isfinite(o1["loss_g"]).all()):
            raise AssertionError(f"DCGAN O1: non-finite losses {o1['loss_d']}"
                                 f" {o1['loss_g']}")
        errs = _dcgan_same_state(args, state_dicts)
        o0 = dcgan.train(dcgan.parse_args(["--opt-level", "O0"]),
                         device="cuda")
        free = [max(abs(a - b) for a, b in zip(o1[k], o0[k]))
                for k in ("loss_d", "loss_g")]
        worst = [max(e[i] for e in errs) for i in (0, 1)]
        emit("train_dcgan", run="(a) O1 at the defaults",
             batch=args.b, image=args.image_size, nz=args.nz,
             iters=args.iters, loss_d=o1["loss_d"], loss_g=o1["loss_g"],
             loss_scales=o1["loss_scales"], images_per_s_median=ips,
             step_ms=[1e3 * t for t in o1["step_seconds"]],
             peak_memory_gb=peak_gb, launches=counts)
        emit("train_dcgan", run="(b) O0 from the same state each step",
             max_loss_d_err=worst[0], max_loss_g_err=worst[1],
             tol=DCGAN_TOL, free_running_o0_max_abs_diff={
                 "loss_d": free[0], "loss_g": free[1]},
             o0_images_per_s_median=statistics.median(
                 o0["images_per_s"][1:]))
        if not max(worst) <= DCGAN_TOL:
            raise AssertionError(f"DCGAN: O1 against O0 {worst} > "
                                 f"{DCGAN_TOL}")
        overflow = _dcgan_overflow(args, state_dicts)
        G, D, optG, optD, pG, pD, sG, sD = dcgan.build(
            args, device="cuda", state_dicts=state_dicts)
        data = dcgan.synthetic_batches(args)
        box = {"s": (pG, pD, sG, sD)}

        def one_step():
            real, z = (torch.from_numpy(a).to("cuda") for a in next(data))
            out = dcgan.train_step(G, D, optG, optD, *box["s"], real, z)
            box["s"] = out[:4]
            float(out[5])

        one_step()
        prof = _profile("train_dcgan_step_O1", one_step, images=args.b)
    finally:
        _o1_cleanup()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_dcgan.json").write_text(json.dumps({
        "o1": {k: o1[k] for k in ("loss_d", "loss_g", "step_seconds",
                                  "images_per_s", "loss_scales")},
        "same_state_errs": errs, "free_running_diff": free,
        "overflow": overflow, "profile": prof, "peak_memory_gb": peak_gb},
        indent=1, default=str))
    return counts


# -- train_resnet --------------------------------------------------------------

# the flagship: examples/imagenet/main_amp.py defaults with --sync_bn
# (ResNet-50, 224x224, 1000 classes, B 256 per rank, O2,
# chain(add_decayed_weights(1e-4), sgd(lr_schedule, 0.9))), DDP and
# SyncBatchNorm over NCCL at world size 1
RESNET_STEPS = 10
RESNET_PAIR_BATCH, RESNET_PAIR_STEPS = 32, 3
SYNC_TOL = 2e-5           # two processes against one, scale-aware
DRYRUN_STEPS = 3
GLOO_BATCH = 4            # the dry run's model, split over 2 processes


def _resnet_args(*extra):
    from apex_tpu_torch.examples import imagenet_main_amp as im
    return im.parse_args(["--sync_bn", "--print-freq", "0", *extra])


def _resnet_batches(args, n):
    from apex_tpu_torch.examples import imagenet_main_amp as im
    data = im.synthetic_batches(args, args.steps_per_epoch)
    return [next(data) for _ in range(n)]


def _resnet_full():
    """(a) the full-width step, 10 steps from the example's loop with
    pre-made synthetic batches (the host makes them before the run, so
    numpy's generator is not timed), then one more step profiled."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import imagenet_main_amp as im
    args = _resnet_args()
    batches = _resnet_batches(args, RESNET_STEPS + 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out = im.train(args, device="cuda", steps=RESNET_STEPS,
                   batches=iter(batches[:RESNET_STEPS]))
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ips = statistics.median(out["images_per_s"][1:])
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"train_resnet: non-finite loss "
                             f"{out['losses']}")
    state = {"params": out["params"], "st": out["opt_state"]}
    xs = [tuple(torch.from_numpy(a).to("cuda") for a in b)
          for b in batches[RESNET_STEPS:]]

    def one_step(x, y):
        state["params"], state["st"], loss, _, _ = im.train_step(
            out["model"], out["optimizer"], out["ddp"], state["params"],
            state["st"], x, y, out["norm"])
        float(loss)

    one_step(*xs[0])
    prof = _profile("train_resnet50_step_O2", lambda: one_step(*xs[1]),
                    images=args.b)
    emit("train_resnet", run="(a) full width", arch=args.arch,
         batch=args.b, image=args.image_size, opt_level=args.opt_level,
         sync_bn=args.sync_bn, world_size=1, backend="nccl",
         steps=RESNET_STEPS, losses=out["losses"],
         images_per_s_median=ips, step_ms=[1e3 * t for t in
                                           out["step_seconds"]],
         loss_scale=out["loss_scale"], skipped_steps=out["skipped_steps"],
         peak_memory_gb=peak_gb, launches=counts)
    resume = _resnet_resume(out, state, batches[RESNET_STEPS])
    result = {k: out[k] for k in ("losses", "step_seconds", "images_per_s",
                                  "loss_scale", "skipped_steps")}
    del out, state, xs
    return {**result, "images_per_s_median": ips, "peak_memory_gb": peak_gb,
            "profile": prof, "launches": counts, "resume": resume}


def _torchvision_state_dict(sd, stages=(3, 4, 6, 3), convs=3,
                            block="Bottleneck"):
    """The port ResNet's ``state_dict`` under torchvision's names (the
    inverse of ``utils.load_torch_resnet``), ``num_batches_tracked``
    counters included, as a torchvision checkpoint holds them."""
    import torch
    out = {"conv1.weight": sd["stem_conv.weight"]}

    def bn(src, dst):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{dst}.{leaf}"] = sd[f"{src}.{leaf}"]
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    bn("stem_bn", "bn1")
    k = 0
    for s, n in enumerate(stages, start=1):
        for i in range(n):
            src, dst = f"{block}_{k}", f"layer{s}.{i}"
            for c in range(convs):
                out[f"{dst}.conv{c + 1}.weight"] = sd[f"{src}.Conv_{c}.weight"]
                bn(f"{src}.BatchNorm_{c}", f"{dst}.bn{c + 1}")
            if f"{src}.downsample_conv.weight" in sd:
                out[f"{dst}.downsample.0.weight"] = \
                    sd[f"{src}.downsample_conv.weight"]
                bn(f"{src}.downsample_bn", f"{dst}.downsample.1")
            k += 1
    out["fc.weight"], out["fc.bias"] = sd["fc.weight"], sd["fc.bias"]
    return out


def _same_bits(a, b):
    """Two trees of tensors (and scalars) equal leaf for leaf, bit for
    bit."""
    import torch
    from torch.utils import _pytree as pytree
    la, sa = pytree.tree_flatten(a)
    lb, sb = pytree.tree_flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _resnet_resume(out, state, batch):
    """(f) the whole train state after (a) saved with ``utils.checkpoint``
    and restored into a freshly built twin; one more step from each on
    the same batch with ``--deterministic``: params, momentum, running
    statistics, scaler state and loss bit for bit.  (g)
    ``--torch-weights`` from a torchvision-format ``.pt`` written from
    that state: the logits of the loaded model equal the source's.  The
    card's cuDNN flags are restored afterwards."""
    import torch
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        return _resnet_resume_deterministic(out, state, batch)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def _resnet_resume_deterministic(out, state, batch):
    import shutil
    import torch
    from apex_tpu_torch.examples import imagenet_main_amp as im
    from apex_tpu_torch.utils import checkpoint
    args = _resnet_args("--deterministic")
    dev = torch.device("cuda")
    im._configure_backends(args, dev)
    path = OUT_DIR / "resume_ckpt"
    model, opt = out["model"], out["optimizer"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save(str(path), im.train_state(model, state["params"],
                                              state["st"], 0, 0.0))
    save_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.iterdir())
    twin = im.make_model(args, dev, seed=1)
    m2, opt2, ddp2, p2, s2 = im.build(twin, args, args.steps_per_epoch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p2, s2, start_epoch, _ = im.resume(str(path), m2, p2, s2)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    shutil.rmtree(path)
    x, y = (torch.from_numpy(a).to(dev) for a in batch)
    runs = []
    for m, o, d, p, st in ((model, opt, out["ddp"], state["params"],
                            state["st"]), (m2, opt2, ddp2, p2, s2)):
        p, st, loss, _, _ = im.train_step(m, o, d, p, st, x, y, out["norm"])
        runs.append({"params": p, "opt_state": st, "loss": loss,
                     "stats": dict(m.unwrapped.named_buffers())})
    same = {k: _same_bits(runs[0][k], runs[1][k])
            for k in ("params", "opt_state", "loss", "stats")}
    emit("train_resnet", run="(f) checkpoint and resume",
         checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s,
         start_epoch=start_epoch, next_step_bit_equal=same,
         loss=float(runs[0]["loss"]))
    if not all(same.values()):
        raise AssertionError(f"the resumed step differs: {same}")

    # (g) a torchvision-format checkpoint of this state, loaded as the
    # CLI's --torch-weights loads it
    source = im.make_model(args, dev, seed=2)
    source.load_state_dict({**{k: v.detach() for k, v in
                               runs[0]["params"].items()},
                            **runs[0]["stats"]})
    pt = OUT_DIR / "resnet50_torchvision.pt"
    torch.save({"state_dict": _torchvision_state_dict(
        source.state_dict())}, pt)
    wargs = _resnet_args("--deterministic", "--torch-weights", str(pt))
    loaded = im.make_model(wargs, dev, seed=3)
    im.load_torch_weights(loaded, wargs)
    pt.unlink()
    xn = (x.float() - im.normalizer(dev)[0]) / im.normalizer(dev)[1]
    with torch.no_grad():
        want = source(xn, train=False)
        got = loaded(xn, train=False)
    equal = torch.equal(got, want)
    emit("train_resnet", run="(g) --torch-weights", logits_bit_equal=equal,
         logits_shape=list(got.shape))
    if not equal:
        raise AssertionError("--torch-weights: logits differ from the "
                             "source model's")
    del runs, m2, p2, s2, source, loaded
    return {"checkpoint_bytes": nbytes, "save_s": save_s,
            "restore_s": restore_s, "next_step_bit_equal": same,
            "torch_weights_logits_bit_equal": equal}


IMAGEFOLDER_CLASSES, IMAGEFOLDER_PER_CLASS = 8, 64   # 512 JPEGs
IMAGEFOLDER_SIZE = (320, 256)                        # width, height


def _resnet_image_folder(synthetic_ips):
    """(h) two steps of the ImageNet twin on an ImageFolder tree of 512
    JPEGs this phase writes (when PIL is installed): images/s beside the
    synthetic rate; every loss finite."""
    import importlib.util
    if importlib.util.find_spec("PIL") is None:
        emit("train_resnet", run="(h) ImageFolder --data",
             skipped="PIL is not installed")
        return {"skipped": "PIL is not installed"}
    import shutil
    from PIL import Image
    from apex_tpu_torch.examples import imagenet_main_amp as im
    root = OUT_DIR / "imagefolder"
    rng = np.random.RandomState(0)
    w, h = IMAGEFOLDER_SIZE
    t0 = time.perf_counter()
    for c in range(IMAGEFOLDER_CLASSES):
        d = root / "train" / f"class{c:02d}"
        d.mkdir(parents=True, exist_ok=True)
        for i in range(IMAGEFOLDER_PER_CLASS):
            small = rng.randint(0, 256, (h // 8, w // 8, 3), dtype=np.uint8)
            Image.fromarray(small).resize((w, h), Image.BILINEAR).save(
                d / f"{i:03d}.jpg", quality=90)
    write_s = time.perf_counter() - t0
    try:
        args = _resnet_args("--data", str(root), "--workers", "8")
        out = im.train(args, device="cuda", steps=2)
    finally:
        shutil.rmtree(root)
    result = {"images": IMAGEFOLDER_CLASSES * IMAGEFOLDER_PER_CLASS,
              "jpeg_write_s": write_s, "losses": out["losses"],
              "images_per_s": out["images_per_s"],
              "synthetic_images_per_s_median": synthetic_ips}
    emit("train_resnet", run="(h) ImageFolder --data", **result)
    if not all(np.isfinite(out["losses"])):
        raise AssertionError(f"ImageFolder: non-finite loss {out['losses']}")
    return result


def _resnet_pair_and_overflow():
    """(b) O2 against O0 (TF32 off) from the same weights and batches at
    B 32, 3 steps; (c) the overflow step (an inf in the data) under
    sync-debug "error" on the O2 run's state."""
    import torch
    from apex_tpu_torch.examples import imagenet_main_amp as im
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    runs = {}
    for level in ("O0", "O2"):
        args = _resnet_args("--b", str(RESNET_PAIR_BATCH), "--opt-level",
                            level)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            runs[level] = im.train(
                args, device="cuda", steps=RESNET_PAIR_STEPS,
                batches=iter(_resnet_batches(args, RESNET_PAIR_STEPS)))
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = tf32
    gaps = [abs(a - b) for a, b in zip(runs["O2"]["losses"],
                                       runs["O0"]["losses"])]
    emit("train_resnet", run="(b) O2 against O0", batch=RESNET_PAIR_BATCH,
         o0_losses=runs["O0"]["losses"], o2_losses=runs["O2"]["losses"],
         max_loss_gap=max(gaps))
    if not max(gaps) <= O2_LOSS_TOL:
        raise AssertionError(f"train_resnet: O2 against O0 loss gap "
                             f"{max(gaps):.3g} > {O2_LOSS_TOL}")
    del runs["O0"]
    o2 = runs["O2"]
    model, opt, ddp, norm = o2["model"], o2["optimizer"], o2["ddp"], \
        o2["norm"]
    params, st = o2["params"], o2["opt_state"]
    x, y = (torch.from_numpy(a).to("cuda") for a in _resnet_batches(
        _resnet_args("--b", str(RESNET_PAIR_BATCH)), 1)[0])
    x = x.float()
    x[1, 17, 5].fill_(float("inf"))     # a launch, not a copy
    leaves = torch.utils._pytree.tree_leaves
    snap = ([p.detach().clone() for p in params.values()],
            [t.clone() for t in leaves(st.inner)])
    scale0 = float(opt.loss_scale(st))
    skipped0 = int(st.skipped_steps)
    count0 = int(st.inner[1][1].count)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        params, st, loss, _, _ = im.train_step(model, opt, ddp, params, st,
                                               x, y, norm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    kept = (all(torch.equal(a, b) for a, b in zip(params.values(), snap[0]))
            and all(torch.equal(a, b) for a, b in zip(leaves(st.inner),
                                                      snap[1])))
    count = int(st.inner[1][1].count)
    scale1 = float(opt.loss_scale(st))
    emit("train_resnet", run="(c) overflow step", planted="inf in the data",
         loss=float(loss), bits_kept=kept, schedule_count=count,
         loss_scale_before=scale0, loss_scale_after=scale1,
         skipped_steps=int(st.skipped_steps), host_syncs=0,
         sync_checked="forward, backward, DDP all-reduce and SGD step")
    if not (kept and scale1 == scale0 / 2 and count == count0
            and int(st.skipped_steps) == skipped0 + 1):
        raise AssertionError("train_resnet: the overflow step changed the "
                             "state or did not halve the scale")
    return {"o2_o0_gaps": gaps, "overflow_bits_kept": kept}


def _gloo_data():
    rng = np.random.RandomState(7)
    x = rng.randn(GLOO_BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, GLOO_BATCH).astype(np.int64)
    return x, y


def _fp32_step(x, y):
    """The dry run's model (seed 0) in fp32 on the card, one training
    forward and backward: logits, running statistics, DDP-reduced
    gradients."""
    import torch
    from apex_tpu_torch import entry, parallel
    from apex_tpu_torch.optimizers import transforms
    model = entry.dryrun_model("cuda")
    logits = model(torch.from_numpy(x).cuda(), train=True)
    loss = transforms.softmax_cross_entropy_with_integer_labels(
        logits, torch.from_numpy(y).cuda()).mean()
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    grads = parallel.DistributedDataParallel().reduce_gradients(
        dict(zip(names, grads)))
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return {"logits": logits.detach().cpu(),
            "stats": {k: v.cpu() for k, v in stats.items()},
            "grads": {k: v.cpu() for k, v in grads.items()}}


def _gloo_rank(rank, world, store):
    """(d)'s ranks: half the batch each, SyncBatchNorm and DDP over gloo
    on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        x, y = _gloo_data()
        half = slice(rank * GLOO_BATCH // world,
                     (rank + 1) * GLOO_BATCH // world)
        torch.save(_fp32_step(x[half], y[half]),
                   OUT_DIR / f"gloo_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _resnet_two_processes():
    """(d) two processes on the one card over gloo against this process's
    full batch (its NCCL group of one)."""
    import torch
    import torch.multiprocessing as mp
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    store = OUT_DIR / "gloo_store"
    if store.exists():
        store.unlink()
    mp.start_processes(_gloo_rank, args=(2, str(store)), nprocs=2,
                       join=True, start_method="spawn")
    store.unlink(missing_ok=True)
    ranks = [torch.load(OUT_DIR / f"gloo_rank{r}.pt") for r in range(2)]
    for r in range(2):
        (OUT_DIR / f"gloo_rank{r}.pt").unlink()
    full = _fp32_step(*_gloo_data())
    errs = {"forward": scale_aware_err(
        torch.cat([r["logits"] for r in ranks]), full["logits"])[0]}
    errs["running_stats"] = max(
        scale_aware_err(r["stats"][k], v)[0]
        for r in ranks for k, v in full["stats"].items())
    errs["reduced_grads"] = max(
        scale_aware_err(r["grads"][k], v)[0]
        for r in ranks for k, v in full["grads"].items())
    emit("train_resnet", run="(d) two processes on one card over gloo",
         model="dryrun ResNet fp32", batch=GLOO_BATCH, errors=errs,
         tol=SYNC_TOL)
    if not max(errs.values()) <= SYNC_TOL:
        raise AssertionError(f"train_resnet: two gloo ranks against one "
                             f"process: {errs}")
    return errs


def _resnet_dryrun():
    """(e) ``entry.dryrun(1)`` over NCCL with B1, its DDP, ZeRO-1 and
    ZeRO-2 runs, against the same step on plain Adam; the counts read
    around the O2 kernel run."""
    import torch
    from apex_tpu_torch import entry
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    out, counts = {}, {}
    for level in ("O0", "O2"):
        before = launch_counts()
        oracle = entry.dryrun(1, "cuda", steps=DRYRUN_STEPS, opt_level=level,
                              optimizer=_plain_adam(1e-3))["losses"]
        if launch_counts() != before:
            raise AssertionError("the dry-run oracle launched a port kernel")
        torch.cuda.synchronize()
        reset_launch_counts()
        got = entry.dryrun(1, "cuda", steps=DRYRUN_STEPS,
                           opt_level=level)["losses"]
        torch.cuda.synchronize()
        counts[level] = launch_counts()
        # the DDP, ZeRO-1 and ZeRO-2 runs: one B1 a step each
        want = {k: 3 * DRYRUN_STEPS if k == "fused_adam" else 0
                for k in counts[level]}
        if counts[level] != want:
            raise AssertionError(f"dryrun {level}: launches {counts[level]}")
        err = (max(abs(a - b) / abs(b) for a, b in zip(got, oracle))
               if level == "O0" else max(abs(a - b)
                                         for a, b in zip(got, oracle)))
        tol = O0_TOL if level == "O0" else O2_LOSS_TOL
        out[level] = {"losses": got, "oracle_losses": oracle, "err": err}
        emit("train_resnet", run=f"(e) entry.dryrun(1) {level}", losses=got,
             oracle_losses=oracle, loss_err=err, tol=tol,
             launches=counts[level])
        if not err <= tol:
            raise AssertionError(f"dryrun {level}: loss error {err:.3g} > "
                                 f"{tol}")
    return out, counts["O2"]


def phase_train_resnet():
    import torch
    import torch.distributed as dist
    _nccl_world_of_one()
    try:
        results = {"full": _resnet_full()}
        torch.cuda.empty_cache()
        results["image_folder"] = _resnet_image_folder(
            results["full"]["images_per_s_median"])
        torch.cuda.empty_cache()
        results["pair"] = _resnet_pair_and_overflow()
        torch.cuda.empty_cache()
        results["two_processes"] = _resnet_two_processes()
        results["dryrun"], dry_counts = _resnet_dryrun()
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_resnet.json").write_text(json.dumps(results, indent=1,
                                                          default=str))
    return {"train_resnet": results["full"]["launches"],
            "dryrun": dry_counts}


TP_O0_STEPS, TP_O2_STEPS, ZERO_STEPS = 2, 3, 3
TP_TOL = 1e-4             # O0 against one process: losses relative,
                          # step-1 params scale-aware


def _tp_launches(cfg, names, steps):
    """A TP rank's launches over ``steps`` steps: as the dense step's
    (its local heads through B4-B6) with the tree layout's one B1-multi
    in place of B1."""
    step = dict(_per_step_launches(cfg, names), fused_adam=0,
                fused_adam_multi=1)
    return {name: steps * step.get(name, 0) for name in names}


def _tp_state_dict(cfg, tp):
    """GPT-2 small's seed-0 weights (CPU), ``wte`` padded with zero rows
    to the vocab ``--tp`` trains with (the dense model's rows first)."""
    import torch
    from apex_tpu_torch.models import GPTLMHeadModel
    from apex_tpu_torch.models.gpt import padded_vocab
    sd = GPTLMHeadModel(cfg, device="cpu", seed=0).state_dict()
    rows = padded_vocab(cfg.vocab_size, tp) - cfg.vocab_size
    sd["wte.weight"] = torch.cat([sd["wte.weight"],
                                  sd["wte.weight"].new_zeros(
                                      rows, cfg.hidden_size)])
    return sd


# the dense references two phases share (train_tp_zero's, train_sp's and
# train_sp_compose's GPT-2 small runs, train_sp_compose's and
# train_tp_pp's BERT-large runs): computed once a run, each phase still
# computing its own when it runs alone; their files stay under OUT_DIR
# until main() ends
_SHARED = {}
SHARED_FILES = ("tp_dense_step1.pt", "sp_dense_grads.pt",
                "bert_large_dense_grads.pt")


def _shared(name, compute):
    """``compute()``'s result (a dict), computed on the run's first call
    and reused after; each call emits the seconds it took and the first
    call's."""
    t0 = time.perf_counter()
    fresh = name not in _SHARED
    if fresh:
        _SHARED[name] = (compute(), time.perf_counter() - t0)
    value, first = _SHARED[name]
    emit("dense_reference", name=name, computed=fresh,
         seconds=time.perf_counter() - t0, first_call_seconds=first)
    return dict(value)


@functools.lru_cache(maxsize=None)
def _seed0_bert_large():
    """BERT-large's seed-0 weights (``BertForPreTraining(seed=0)``'s state
    dict) on the host, drawn once a run: the dense references build from
    them, and ``_spawn_seed0`` shares them with the spawned ranks."""
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import BertForPreTraining
    return BertForPreTraining(bert_main_amp.get_config("large"),
                              device="cpu", seed=0).state_dict()


def _spawn_seed0(fn, world, name, state=None):
    """``_spawn`` with a dense BERT state dict on the card as the ranks'
    last argument, shared over CUDA IPC: ``state``, or BERT-large's
    seed-0 weights.  The one way a spawned rank gets its seed-0 weights:
    every build loads the dense dict (``state_dict=seed0``) or its part,
    ``dense_to_rank(seed0, cfg, pp, pipe, tp, tp_rank)`` (a pipeline
    stage, under TP a Megatron slice of one), instead of drawing them;
    the shared copy freed when the ranks end."""
    import torch
    seed0 = {k: v.cuda() for k, v in
             (state if state is not None else _seed0_bert_large()).items()}
    try:
        return _spawn(fn, world, name, seed0)
    finally:
        del seed0
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()


def _tp_dense_reference():
    """One process's dense GPT-2 small runs (``_tp_dense_runs``), shared
    by the run's phases."""
    return _shared("gpt2_small_tp_dense", _tp_dense_runs)


def _tp_dense_runs():
    """One process's dense GPT-2 small runs at B 8, S 1024 from seed 0:
    O0 (its step-1 gradients saved for train_sp's ranks, its step-1
    params for the --tp ranks) and O2."""
    import torch
    from apex_tpu_torch.examples import gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    out = {}
    for level, steps in (("O0", TP_O0_STEPS), ("O2", TP_O2_STEPS)):
        model, opt, params, st = gpt_main_amp.build(
            cfg, lr=TRAIN_LR, opt_level=level, device="cuda", seed=0)
        data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        losses = []
        for step in range(steps):
            ids = torch.from_numpy(next(data)).to("cuda")
            params, st, loss, grads = gpt_main_amp.train_step(
                model, opt, params, st, ids)
            losses.append(float(loss))
            if level == "O0" and step == 0:
                torch.save({k: v.detach().cpu() for k, v in grads.items()},
                           OUT_DIR / "sp_dense_grads.pt")
                sd = {k: v.detach().cpu() for k, v in params.items()}
                torch.save(sd, OUT_DIR / "tp_dense_step1.pt")
            del grads
        out[level] = losses
        del model, opt, params, st
        torch.cuda.empty_cache()
    return out


def _tp_rank_leg(rank):
    """(a) and (b) on this rank of the --tp 2 mesh."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models.gpt import padded_vocab
    from apex_tpu_torch.ops import vocab_parallel_lm_loss
    from apex_tpu_torch.parallel import tensor_parallel as tpar
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    vocab = padded_vocab(cfg.vocab_size, TP)
    sd = _tp_state_dict(cfg, TP)
    dense1 = torch.load(OUT_DIR / "tp_dense_step1.pt")
    dense1["wte.weight"] = torch.cat([dense1["wte.weight"],
                                      dense1["wte.weight"].new_zeros(
                                          vocab - cfg.vocab_size,
                                          cfg.hidden_size)])
    mesh = parallel.create_mesh(tp=TP)
    want1 = tpar.shard_params(dense1, mesh, tpar.gpt_tp_rules(),
                              num_heads=cfg.num_attention_heads)
    del dense1
    out = {}
    for level, steps in (("O0", TP_O0_STEPS), ("O2", TP_O2_STEPS)):
        model, opt, params, st = gpt_main_amp.build(
            dataclasses.replace(cfg, vocab_size=vocab), lr=TRAIN_LR,
            opt_level=level, device="cuda", state_dict=sd, mesh=mesh)
        data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
        losses, seconds, step1_err = [], [], None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        for step in range(steps):
            ids = torch.from_numpy(next(data)).to("cuda")
            t0 = time.perf_counter()
            # the grads dropped: held, they would join the next step's
            params, st, loss = gpt_main_amp.train_step(
                model, opt, params, st, ids, mesh=mesh,
                true_vocab=cfg.vocab_size)[:3]
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if step == 0 and level == "O0":
                step1_err = max(scale_aware_err(params[k], want1[k].cuda())[0]
                                for k in params)
        torch.cuda.synchronize()
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        specs = model.unwrapped.tp_specs()
        same = True
        for name, spec in specs.items():
            if not spec:
                mine = params[name].detach().clone()
                theirs = mine.clone()
                dist.broadcast(theirs, src=0)
                same = same and torch.equal(mine, theirs)
        out[level] = {"losses": losses, "step_seconds": seconds,
                      "tokens_per_s": [TRAIN_BATCH * TRAIN_SEQ / t
                                       for t in seconds],
                      "peak_memory_gb": peak, "launches": counts,
                      "replicated_bitwise": same, "step1_param_err":
                      step1_err, "want_launches": _tp_launches(
                          cfg, counts, steps)}
    # (b) an inf in rank 1's gradient only, with fill_
    ids = torch.from_numpy(next(gpt_main_amp.batches(
        cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ))).to("cuda")
    hidden = model.apply(params, ids, return_hidden=True)
    loss = vocab_parallel_lm_loss(hidden, params["wte.weight"], ids, mesh,
                                  true_vocab=cfg.vocab_size)
    with amp.scale_loss(loss, st) as scaled:
        grads = dict(zip(params, torch.autograd.grad(
            scaled, list(params.values()))))
    if rank == 1:
        grads["blocks.1.mlp_in.weight"].fill_(float("inf"))
    before = {k: v.detach().clone() for k, v in params.items()}
    scale0, skipped0 = float(opt.loss_scale(st)), int(st.skipped_steps)
    params, st = opt.step(params, grads, st)
    out["overflow"] = {
        "bits_kept": all(torch.equal(before[k], params[k]) for k in params),
        "loss_scale_before": scale0,
        "loss_scale_after": float(opt.loss_scale(st)),
        "skipped": int(st.skipped_steps) - skipped0}
    return out


def _zero_rank_leg(rank, world):
    """(c) DDP, ZeRO-1 and ZeRO-2 on GPT-2 small, each rank half of B 8;
    the flat master buffer after ``ZERO_STEPS`` steps against DDP's (a
    host copy, so that it holds no device memory in the later runs).
    Memory a step (GB): what is held at its start, and for each part of
    it, the forward and backward, the gradient reduction and the
    optimizer step (ZeRO-2's reduce-scatter is inside its step), its
    peak and what is held at its end."""
    import torch
    from apex_tpu_torch import amp, parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models import lm_loss
    from apex_tpu_torch.parallel.mesh import WORLD
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    rows = TRAIN_BATCH // world
    batches = [next(data)[rank * rows:(rank + 1) * rows]
               for _ in range(ZERO_STEPS)]
    out, ddp_p = {}, None

    def mark(mem, part):
        torch.cuda.synchronize()
        mem[f"{part}_peak"] = torch.cuda.max_memory_allocated() / 1e9
        mem[f"{part}_end"] = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()

    for leg in ("ddp", "zero1", "zero2"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        model, opt, params, st = gpt_main_amp.build(
            cfg, lr=TRAIN_LR, opt_level="O2", device="cuda", seed=0)
        ddp = parallel.DistributedDataParallel(model)
        if leg != "ddp":
            st = parallel.shard_optimizer_state(st, WORLD)
        if leg == "zero1":
            opt = opt.with_zero(WORLD)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reset_launch_counts()
        losses, steps_mem = [], []
        for ids in batches:
            ids = torch.from_numpy(ids).to("cuda")
            torch.cuda.synchronize()
            mem = {"held": torch.cuda.memory_allocated() / 1e9}
            torch.cuda.reset_peak_memory_stats()
            loss = lm_loss(model.apply(params, ids), ids)
            with amp.scale_loss(loss, st) as scaled:
                grads = dict(zip(params, torch.autograd.grad(
                    scaled, list(params.values()))))
            mark(mem, "forward_backward")
            # the loss as a float: its graph would hold this step's params
            # (autograd's leaf nodes) into the next step, and the last
            # step's into the next run
            losses.append(float(loss))
            del loss, scaled
            if leg == "zero2":
                params, st = opt.zero2_step(params, grads, st, WORLD)
            else:
                grads = ddp.reduce_gradients(grads)
                mark(mem, "reduce")
                params, st = opt.step(params, grads, st)
            mark(mem, "step")
            del grads
            steps_mem.append(mem)
        torch.cuda.synchronize()
        row = {"losses": losses, "launches": launch_counts(),
               "peak_memory_gb": max(v for m in steps_mem
                                     for k, v in m.items()
                                     if k.endswith("_peak")),
               "memory_gb": steps_mem,
               "m_elements": st.inner.m.numel(),
               "buffer_elements": st.inner.p.numel()}
        if leg == "ddp":
            ddp_p = st.inner.p.cpu()
        else:
            row["bitwise_ddp"] = bool(torch.equal(st.inner.p.cpu(), ddp_p))
        out[leg] = row
        del model, opt, params, st, ddp
    return out


def _tp_zero_rank(rank, world, store):
    """(a)-(c)'s ranks: gloo on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = {"tp": _tp_rank_leg(rank)}
        out["tp_seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out["zero"] = _zero_rank_leg(rank, world)
        out["zero_seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"tp_zero_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _dryrun_nccl():
    """(d) one ZeRO-1 and one ZeRO-2 step of ``entry.dryrun``'s flagship
    step over NCCL at a world of one under sync-debug "error" (the
    overflow all-reduce included), each after a first step outside it;
    that its ZeRO runs end bit for bit with its DDP run is held in
    train_resnet's (e)."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import entry
    _nccl_world_of_one()
    try:
        synced = {}
        for leg in ("zero1", "zero2"):
            setup = entry.flagship_setup("cuda", zero=leg)
            model, opt, ddp, params, st, x, y = setup
            params, st, _ = entry.flagship_step(model, opt, ddp, params, st,
                                                x, y, leg)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                params, st, loss = entry.flagship_step(model, opt, ddp,
                                                       params, st, x, y, leg)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            synced[leg] = {"loss": float(loss), "host_syncs": 0,
                           "backend": dist.get_backend()}
    finally:
        dist.destroy_process_group()
    emit("train_tp_zero", run="(d) the dry run's ZeRO steps over NCCL",
         sync_debug_error_steps=synced)


def phase_train_tp_zero():
    """(a) GPT-2 small at --tp 2 (B 8, S 1024, flash) as two processes
    over gloo on the one card, O0 and O2 against one process's dense
    runs, exact launches, replicated params equal on both ranks; (b) an
    inf in rank 1's gradient skips both ranks; (c) DDP, ZeRO-1 and ZeRO-2
    on GPT-2 small, two processes with half of B 8 each, bit for bit;
    (d) the dry run's ZeRO steps over NCCL at a world of one, sync-free."""
    import torch
    import torch.multiprocessing as mp
    from apex_tpu_torch.examples import gpt_main_amp
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dense = _tp_dense_reference()
    dense_s = time.perf_counter() - t0
    store = OUT_DIR / "tp_zero_store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    try:
        mp.start_processes(_tp_zero_rank, args=(2, str(store)), nprocs=2,
                           join=True, start_method="spawn")
    finally:
        store.unlink(missing_ok=True)
    ranks_s = time.perf_counter() - t0
    ranks = []
    for r in range(2):
        path = OUT_DIR / f"tp_zero_rank{r}.json"
        ranks.append(json.loads(path.read_text()))
        path.unlink()
    # (a)
    for level, tol in (("O0", TP_TOL), ("O2", O2_LOSS_TOL)):
        for r, res in enumerate(ranks):
            got = res["tp"][level]
            if level == "O0":
                err = max(abs(a - b) / abs(b)
                          for a, b in zip(got["losses"], dense[level]))
            else:
                err = max(abs(a - b)
                          for a, b in zip(got["losses"], dense[level]))
            emit("train_tp_zero", run=f"(a) --tp 2 {level}", rank=r,
                 batch=TRAIN_BATCH, seq=TRAIN_SEQ, losses=got["losses"],
                 dense_losses=dense[level], loss_err=err, tol=tol,
                 step1_param_err=got["step1_param_err"],
                 replicated_bitwise=got["replicated_bitwise"],
                 tokens_per_s=got["tokens_per_s"],
                 peak_memory_gb=got["peak_memory_gb"],
                 launches=got["launches"])
            if not err <= tol:
                raise AssertionError(f"--tp 2 {level} rank {r}: loss error "
                                     f"{err:.3g} > {tol}")
            if level == "O0" and not got["step1_param_err"] <= TP_TOL:
                raise AssertionError(f"--tp 2 O0 rank {r}: step-1 params "
                                     f"{got['step1_param_err']:.3g}")
            if not got["replicated_bitwise"]:
                raise AssertionError(f"--tp 2 {level}: replicated params "
                                     "differ between the ranks")
            if got["launches"] != got["want_launches"]:
                raise AssertionError(f"--tp 2 {level} rank {r}: launches "
                                     f"{got['launches']} != "
                                     f"{got['want_launches']}")
    # (b)
    for r, res in enumerate(ranks):
        o = res["tp"]["overflow"]
        emit("train_tp_zero", run="(b) inf in rank 1's gradient", rank=r,
             **o)
        if not (o["bits_kept"] and o["skipped"] == 1
                and o["loss_scale_after"] == o["loss_scale_before"] / 2):
            raise AssertionError(f"--tp 2 overflow, rank {r}: {o}")
    # (c)
    for r, res in enumerate(ranks):
        z = res["zero"]
        emit("train_tp_zero", run="(c) DDP, ZeRO-1, ZeRO-2", rank=r,
             batch_per_rank=TRAIN_BATCH // 2, seq=TRAIN_SEQ,
             **{f"{leg}_{key}": z[leg][key] for leg in z
                for key in ("losses", "peak_memory_gb", "memory_gb",
                            "m_elements", "bitwise_ddp") if key in z[leg]})
        cfg = gpt_main_amp.config("small", TRAIN_SEQ)
        for leg in ("ddp", "zero1", "zero2"):
            if leg != "ddp" and not z[leg]["bitwise_ddp"]:
                raise AssertionError(f"{leg} rank {r}: params differ from "
                                     "DDP's")
            want = {k: ZERO_STEPS * v for k, v in
                    _per_step_launches(cfg, z[leg]["launches"]).items()}
            if z[leg]["launches"] != want:
                raise AssertionError(f"{leg}: launches "
                                     f"{z[leg]['launches']}")
    # (d)
    _dryrun_nccl()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "train_tp_zero.json").write_text(json.dumps(
        {"dense": dense, "ranks": ranks, "dense_seconds": dense_s,
         "ranks_seconds": ranks_s}, indent=1, default=str))
    return {"train_tp": ranks[0]["tp"]["O2"]["launches"],
            "train_zero1": ranks[0]["zero"]["zero1"]["launches"],
            "train_zero2": ranks[0]["zero"]["zero2"]["launches"]}


# the sequence-parallel paths: GPT-2 small at --sp 2 (B 8, S 1024) ring
# and Ulysses, long context (B 1, S 8192, ring), BERT-large at
# --ring-attention 2 (B 8, S 512), and --tp 2 at dp 2 with ZeRO-1 over
# the tree moments (B 2 a data index)
SP_O0_STEPS, SP_O2_STEPS = 2, 3
SP_LONG_STEPS = 2         # (b)'s O2 steps at S 8192
SP_BERT_O2_STEPS = 2      # (c)'s O2 steps (5-10 s each on the four)
SP_LONG_SEQ = 8192
SP_BERT_BATCH, SP_BERT_SEQ = 8, 512
SP_ZERO_BATCH, SP_ZERO_STEPS = 2, 2
SP_TOL = 1e-4             # O0 against one process: losses relative,
                          # step-1 grads scale-aware
# BERT-large's O0 gradients compared: the embeddings' LayerNorm, the
# first and last layers and the heads but the 31M-row embedding and
# decoder (the file the dense process writes stays ~0.1 GB)
SP_BERT_GRADS = re.compile(r"embeddings_ln|layer_0\.|layer_23\.|pooler|"
                           r"nsp_classifier|mlm_transform|mlm_ln")
COLLECTIVES = ("broadcast", "all_reduce", "all_gather",
               "all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "batch_isend_irecv")


class _CollectiveCount:
    """Counts the calls of ``torch.distributed``'s collectives the port
    makes (its modules call them through the module) while active."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.counts, self.saved = dist, {}, {}

    def __enter__(self):
        for name in COLLECTIVES:
            fn = self.saved[name] = getattr(self.dist, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(self.dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.dist, name, fn)


def _sp_dense():
    """One process's dense runs the sequence-parallel ranks are held
    against: GPT-2 small O0 (its step-1 gradients saved for the ranks)
    and O2 at B 8, S 1024; GPT-2 small O2 at B 1, S 8192 (peak memory);
    BERT-large O2 and O0 at B 8, S 512 with flash attention (a part of
    its O0 gradients saved)."""
    import torch
    from apex_tpu_torch.examples import bert_main_amp, gpt_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    # GPT-2 small's O0 and O2 runs are train_tp_zero's (the same seed,
    # batches and steps: SP_O0_STEPS, SP_O2_STEPS)
    gpt = _tp_dense_reference()
    out = {"gpt_O0": gpt["O0"], "gpt_O2": gpt["O2"]}
    long_cfg = gpt_main_amp.config("small", SP_LONG_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run = gpt_main_amp.train(long_cfg, batch=1, seq_len=SP_LONG_SEQ,
                             steps=SP_LONG_STEPS, lr=TRAIN_LR,
                             opt_level="O2", device="cuda", seed=0)
    torch.cuda.synchronize()
    out["long"] = {"losses": run["losses"],
                   "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "tokens_per_s": run["tokens_per_s"]}
    del run
    torch.cuda.empty_cache()
    bcfg = bert_main_amp.get_config("large")
    for level, steps in (("O0", 1), ("O2", SP_BERT_O2_STEPS)):
        model, opt, params, st = bert_main_amp.build(
            bcfg, opt_level=level, attention_fn=make_flash_attention(),
            device="cuda", state_dict=_seed0_bert_large())
        data = bert_main_amp.batches(bcfg, SP_BERT_BATCH, SP_BERT_SEQ)
        losses = []
        for step in range(steps):
            batch = tuple(torch.from_numpy(a).to("cuda") for a in next(data))
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch)
            losses.append(float(loss))
            if level == "O0":
                torch.save({k: v.detach().cpu() for k, v in grads.items()
                            if SP_BERT_GRADS.search(k)},
                           OUT_DIR / "sp_bert_grads.pt")
            del grads
        out[f"bert_{level}"] = losses
        del model, opt, params, st
        torch.cuda.empty_cache()
    return out


def _sp_steps(build, step, batches, steps, grads_file=None,
              grads_filter=None):
    """``steps`` steps of a sequence-parallel rank (``build()`` gives
    model, optimizer, params, state, mesh), the launch counts at 0 just
    before and read just after, the collectives counted, the peak
    memory; with ``grads_file``, the step-1 gradients' scale-aware error
    against the dense process's."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    model, opt, params, st, mesh = build()
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.mesh import WORLD
    ddp = DistributedDataParallel(model, process_group=WORLD)
    losses, seconds, grad_err = [], [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CollectiveCount() as coll:
        for i in range(steps):
            batch = next(batches)
            t0 = time.perf_counter()
            params, st, loss, grads = step(model, opt, params, st, batch,
                                           ddp, mesh)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if i == 0 and grads_file is not None:
                want = torch.load(grads_file)
                grad_err = max(scale_aware_err(grads[k], want[k].cuda())[0]
                               for k in want)
                del want
            del grads
    torch.cuda.synchronize()
    out = {"losses": losses, "step_seconds": seconds,
           "launches": launch_counts(), "collectives": dict(coll.counts),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "step1_grad_err": grad_err}
    del model, opt, params, st, ddp
    torch.cuda.empty_cache()
    return out


def _sp_rank_legs(rank, seed0):
    """(a)-(c) on this rank of a (1, 2) sequence mesh; ``seed0``:
    BERT-large's seed-0 weights on the card (``_spawn_seed0``), which
    every BERT build loads."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.examples import bert_main_amp, gpt_main_amp
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    out = {}

    def gpt_build(level, pattern, config):
        def build():
            mesh = parallel.create_mesh(sp=SP)
            return gpt_main_amp.build(config, lr=TRAIN_LR, opt_level=level,
                                      device="cuda", seed=0, mesh=mesh,
                                      sp_attention=pattern) + (mesh,)
        return build

    def gpt_step(model, opt, params, st, ids, ddp, mesh):
        return gpt_main_amp.train_step(model, opt, params, st,
                                       ids.to("cuda"), ddp, mesh=mesh)

    def gpt_batches(batch, seq):
        data = gpt_main_amp.batches(cfg.vocab_size, batch, seq)
        return (torch.from_numpy(next(data)) for _ in itertools.count())

    for pattern in ("ring", "ulysses"):
        out[f"gpt_{pattern}_O0"] = _sp_steps(
            gpt_build("O0", pattern, cfg), gpt_step,
            gpt_batches(TRAIN_BATCH, TRAIN_SEQ), SP_O0_STEPS,
            grads_file=OUT_DIR / "sp_dense_grads.pt")
        out[f"gpt_{pattern}_O2"] = _sp_steps(
            gpt_build("O2", pattern, cfg), gpt_step,
            gpt_batches(TRAIN_BATCH, TRAIN_SEQ), SP_O2_STEPS)
    out["gpt_long"] = _sp_steps(
        gpt_build("O2", "ring", gpt_main_amp.config("small", SP_LONG_SEQ)),
        gpt_step, gpt_batches(1, SP_LONG_SEQ), SP_LONG_STEPS)
    bcfg = bert_main_amp.get_config("large")

    def bert_build(level, pattern):
        def build():
            mesh = parallel.create_mesh(sp=SP)
            return bert_main_amp.build(bcfg, opt_level=level, device="cuda",
                                       state_dict=seed0, mesh=mesh,
                                       sp_attention=pattern) + (mesh,)
        return build

    def bert_step(model, opt, params, st, batch, ddp, mesh):
        return bert_main_amp.train_step(
            model, opt, params, st,
            tuple(torch.from_numpy(a).to("cuda") for a in batch), ddp=ddp,
            mesh=mesh)

    for pattern in ("ring", "ulysses"):
        out[f"bert_{pattern}_O0"] = _sp_steps(
            bert_build("O0", pattern), bert_step,
            bert_main_amp.batches(bcfg, SP_BERT_BATCH, SP_BERT_SEQ), 1,
            grads_file=OUT_DIR / "sp_bert_grads.pt")
        out[f"bert_{pattern}_O2"] = _sp_steps(
            bert_build("O2", pattern), bert_step,
            bert_main_amp.batches(bcfg, SP_BERT_BATCH, SP_BERT_SEQ),
            SP_BERT_O2_STEPS)
    return out


def _sp_rank(rank, world, store, seed0):
    """(a)-(c)'s ranks: gloo on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _sp_rank_legs(rank, seed0)
        seed0.clear()       # the shared blocks released (see _moe_rank)
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"sp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _sp_zero_rank(rank, world, store):
    """(d) on this rank of the (2, 1, 2) mesh: GPT-2 small's --tp 2 step
    with the tree moments whole, then sharded over the data group
    (ZeRO-1, like_params), from the same weights and batches; the params
    of both runs bit for bit, the moment bytes of each."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models.gpt import padded_vocab
    from torch.utils import _pytree as pytree
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        cfg = gpt_main_amp.config("small", TRAIN_SEQ)
        sd = _tp_state_dict(cfg, TP)
        mesh = parallel.create_mesh(tp=TP)
        d = mesh.index("data")
        data = gpt_main_amp.batches(cfg.vocab_size, 2 * SP_ZERO_BATCH,
                                    TRAIN_SEQ)
        rows = [next(data)[d * SP_ZERO_BATCH:(d + 1) * SP_ZERO_BATCH]
                for _ in range(SP_ZERO_STEPS)]
        out, finals = {}, {}
        for zero in (False, True):
            torch.cuda.empty_cache()
            model, opt, params, st = gpt_main_amp.build(
                dataclasses.replace(cfg, vocab_size=padded_vocab(
                    cfg.vocab_size, TP)), lr=TRAIN_LR, opt_level="O2",
                device="cuda", state_dict=sd, mesh=mesh, zero=zero)
            ddp = parallel.DistributedDataParallel(
                model, process_group=mesh.group("data"))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            seconds = []
            for ids in rows:
                t0 = time.perf_counter()
                params, st, loss = gpt_main_amp.train_step(
                    model, opt, params, st, torch.from_numpy(ids).cuda(),
                    ddp, mesh=mesh, true_vocab=cfg.vocab_size)[:3]
                float(loss)
                seconds.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            leg = "zero1" if zero else "whole"
            out[leg] = {
                "launches": launch_counts(), "step_seconds": seconds,
                "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                "moment_bytes": sum(
                    t.numel() * t.element_size() for t in
                    pytree.tree_leaves((st.inner.m, st.inner.v))),
                "loss_scale": float(opt.loss_scale(st)),
                "applied_steps": int(st.applied_steps)}
            finals[leg] = {k: v.detach().cpu() for k, v in params.items()}
            del model, opt, params, st, ddp
        out["bitwise"] = all(torch.equal(finals["whole"][k],
                                         finals["zero1"][k])
                             for k in finals["whole"])
        (OUT_DIR / f"sp_zero_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _spawn(fn, world, name, *extra):
    """``world`` processes running ``fn(rank, world, store, *extra)``
    (CUDA tensors in ``extra`` reach them through CUDA IPC, no copy);
    their JSON results."""
    import torch.multiprocessing as mp
    store = OUT_DIR / f"{name}_store"
    store.unlink(missing_ok=True)
    try:
        mp.start_processes(fn, args=(world, str(store), *extra),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        store.unlink(missing_ok=True)
    ranks = []
    for r in range(world):
        path = OUT_DIR / f"{name}_rank{r}.json"
        ranks.append(json.loads(path.read_text()))
        path.unlink()
    return ranks


def _sp_launches(names, norms, layers, flash_calls, steps, adam):
    """A sequence-parallel rank's launches over ``steps`` steps: the
    dense step's ``norms`` LayerNorms forward and backward,
    ``flash_calls`` of B4, B5 and B6 a layer (the ring's hops this rank
    computes, or 1 for Ulysses), and ``adam`` (``fused_adam``, or
    nothing for FusedLAMB) once a step."""
    step = {"layer_norm_fwd": norms, "layer_norm_bwd": norms,
            "flash_fwd": flash_calls * layers,
            "flash_bwd_dq": flash_calls * layers,
            "flash_bwd_dkv": flash_calls * layers}
    if adam:
        step[adam] = 1
    return {name: steps * step.get(name, 0) for name in names}


def phase_train_sp():
    """(a) GPT-2 small at --sp 2, ring and Ulysses, (b) long context at
    --sp 2 ring, (c) BERT-large at --ring-attention 2, ring and Ulysses,
    as two processes over gloo on the one card against one process's
    dense runs; (d) --tp 2 at dp 2 with ZeRO-1 over the tree moments
    against the moments whole, four processes."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    try:
        dense = _sp_dense()
        dense_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _spawn_seed0(_sp_rank, SP, "sp")
    finally:
        (OUT_DIR / "sp_bert_grads.pt").unlink(missing_ok=True)
    ranks_s = time.perf_counter() - t0
    by_path = {}
    # (a) and (b)
    for pattern in ("ring", "ulysses"):
        for level, tol in (("O0", SP_TOL), ("O2", O2_LOSS_TOL)):
            want = dense[f"gpt_{level}"]
            for r, res in enumerate(ranks):
                got = res[f"gpt_{pattern}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want))
                calls = r + 1 if pattern == "ring" else 1
                steps = SP_O0_STEPS if level == "O0" else SP_O2_STEPS
                want_l = _sp_launches(got["launches"], 25, 12, calls,
                                      steps, "fused_adam")
                emit("train_sp", run=f"(a) GPT-2 small --sp 2 {pattern} "
                     f"{level}", rank=r, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                     losses=got["losses"], dense_losses=want, loss_err=err,
                     tol=tol, step1_grad_err=got["step1_grad_err"],
                     tokens_per_s=[TRAIN_BATCH * TRAIN_SEQ / t
                                   for t in got["step_seconds"]],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches=got["launches"],
                     collectives_a_step={k: v / steps for k, v in
                                         got["collectives"].items()})
                if not err <= tol:
                    raise AssertionError(f"--sp 2 {pattern} {level} rank "
                                         f"{r}: loss error {err:.3g}")
                if level == "O0" and not got["step1_grad_err"] <= SP_TOL:
                    raise AssertionError(
                        f"--sp 2 {pattern} O0 rank {r}: step-1 grads "
                        f"{got['step1_grad_err']:.3g}")
                if got["launches"] != want_l:
                    raise AssertionError(f"--sp 2 {pattern} {level} rank "
                                         f"{r}: launches {got['launches']} "
                                         f"!= {want_l}")
            if level == "O2":
                by_path[f"train_sp_{pattern}"] = ranks[0][
                    f"gpt_{pattern}_O2"]["launches"]
    long_err = 0.0
    for r, res in enumerate(ranks):
        got = res["gpt_long"]
        long_err = max(long_err, max(abs(a - b) for a, b in zip(
            got["losses"], dense["long"]["losses"])))
        emit("train_sp", run="(b) long context, --sp 2 ring", rank=r,
             batch=1, seq=SP_LONG_SEQ, losses=got["losses"],
             dense_losses=dense["long"]["losses"],
             peak_memory_gb=got["peak_memory_gb"],
             dense_peak_memory_gb=dense["long"]["peak_memory_gb"],
             tokens_per_s=[SP_LONG_SEQ / t for t in got["step_seconds"]],
             dense_tokens_per_s=dense["long"]["tokens_per_s"],
             launches=got["launches"])
        if got["launches"] != _sp_launches(got["launches"], 25, 12, r + 1,
                                           SP_LONG_STEPS, "fused_adam"):
            raise AssertionError(f"long context rank {r}: launches "
                                 f"{got['launches']}")
    if not long_err <= O2_LOSS_TOL:
        raise AssertionError(f"long context: loss error {long_err:.3g}")
    by_path["train_sp_long"] = ranks[0]["gpt_long"]["launches"]
    # (c)
    for pattern in ("ring", "ulysses"):
        for level, tol in (("O0", SP_TOL), ("O2", O2_LOSS_TOL)):
            want = dense[f"bert_{level}"]
            for r, res in enumerate(ranks):
                got = res[f"bert_{pattern}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want))
                steps = 1 if level == "O0" else SP_BERT_O2_STEPS
                # the ring's two hops a layer, non-causal; Ulysses one
                want_l = _sp_launches(got["launches"], 2 * BERT_LAYERS + 2,
                                      BERT_LAYERS,
                                      SP if pattern == "ring" else 1, steps,
                                      None)
                emit("train_sp", run=f"(c) BERT-large --ring-attention 2 "
                     f"{pattern} {level}", rank=r, batch=SP_BERT_BATCH,
                     seq=SP_BERT_SEQ, losses=got["losses"],
                     dense_losses=want, loss_err=err, tol=tol,
                     step1_grad_err=got["step1_grad_err"],
                     tokens_per_s=[SP_BERT_BATCH * SP_BERT_SEQ / t
                                   for t in got["step_seconds"]],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches=got["launches"],
                     collectives_a_step={k: v / steps for k, v in
                                         got["collectives"].items()})
                if not err <= tol:
                    raise AssertionError(f"BERT --ring-attention 2 "
                                         f"{pattern} {level} rank {r}: "
                                         f"loss error {err:.3g}")
                if level == "O0" and not got["step1_grad_err"] <= SP_TOL:
                    raise AssertionError(
                        f"BERT {pattern} O0 rank {r}: step-1 grads "
                        f"{got['step1_grad_err']:.3g}")
                if got["launches"] != want_l:
                    raise AssertionError(f"BERT {pattern} {level} rank {r}: "
                                         f"launches {got['launches']} != "
                                         f"{want_l}")
            if level == "O2":
                by_path[f"train_sp_bert_{pattern}"] = ranks[0][
                    f"bert_{pattern}_O2"]["launches"]
    # (d)
    t0 = time.perf_counter()
    zero = _spawn(_sp_zero_rank, 2 * TP, "sp_zero")
    zero_s = time.perf_counter() - t0
    for r, res in enumerate(zero):
        emit("train_sp", run="(d) --tp 2 at dp 2, ZeRO-1 over the tree "
             "moments", rank=r, batch_per_data_index=SP_ZERO_BATCH,
             seq=TRAIN_SEQ, bitwise=res["bitwise"],
             **{f"{leg}_{key}": res[leg][key] for leg in ("whole", "zero1")
                for key in ("moment_bytes", "peak_memory_gb",
                            "step_seconds", "loss_scale", "launches")})
        if not res["bitwise"]:
            raise AssertionError(f"ZeRO-1 over the tree moments, rank {r}: "
                                 "params differ from the whole moments'")
        if not 0.5 <= res["zero1"]["moment_bytes"] / res["whole"][
                "moment_bytes"] <= 0.52:
            raise AssertionError(f"ZeRO-1 rank {r}: moment bytes "
                                 f"{res['zero1']['moment_bytes']} of "
                                 f"{res['whole']['moment_bytes']}")
    by_path["train_sp_zero"] = zero[0]["zero1"]["launches"]
    (OUT_DIR / "train_sp.json").write_text(json.dumps(
        {"dense": dense, "ranks": ranks, "zero": zero,
         "dense_seconds": dense_s, "ranks_seconds": ranks_s,
         "zero_seconds": zero_s}, indent=1, default=str))
    return by_path


# the pipeline paths: BERT-large at --pp 2 (B 32, S 128, M 4), GPipe and
# 1F1B, as two processes over gloo on the one card against one dense
# process; the memory claim at M 4 and M 8; dp 2 x pp 2 as four
# processes; dropout through PipelinedBert; GPT-2 small's PipelinedGPT
PP, PP_BATCH, PP_SEQ, PP_M = 2, 32, 128, 4
PP_O0_STEPS, PP_O2_STEPS = 2, 3
PP_TOL = 1e-4             # O0 against one process: losses relative,
                          # step-1 grads scale-aware
PP_SCHED_TOL = 1e-5       # GPipe against 1F1B: params after step 1,
                          # and (d)'s gradients, scale-aware
PP_MEM = ((4, 32), (8, 64))        # (M, B): a microbatch of 8 rows
PP_MEM_1F1B_GB = 0.7      # (b): 1F1B's step peak grows less from M 4 to 8
PP_PIPE_1F1B_GB = 0.1     # (b): and its schedule's own peak grows less
                          # (S saved inputs of 2 MB, no tick's graph kept)
PP_DP_BATCH = 16          # (c): the rows of a data index
PP_GPT_LENS = (1024, 17, 700, 301, 1024, 5, 512, 64)   # (e)'s padding
# the gradients the dense process writes for the ranks: the embeddings'
# LayerNorm, the first and last layer of each stage and the heads but
# the 31M-row decoder
PP_GRADS = re.compile(r"embeddings_ln|layer_0\.|layer_11\.|layer_12\.|"
                      r"layer_23\.|pooler|nsp_classifier|mlm_transform|"
                      r"mlm_ln")
PP_PREDICTION = {
    "a_losses_O0": "within 1e-4 relative of the dense process, step-1 "
                   "gradients within 1e-4 scale-aware; GPipe and 1F1B "
                   "params after step 1 within 1e-5",
    "a_O2": "within 2e-2 of dense O2 every step",
    "a_step_ms_O2": "GPipe 450-900, 1F1B 550-1100 (gloo hops and the "
                    "heads' gradient broadcast through the host)",
    "a_tokens_per_s_pair_O2": "GPipe 4.5k-9k, 1F1B 3.7k-7.5k",
    "a_peak_gb_rank_O2": "GPipe 6-10, 1F1B 4-7",
    "a_collectives_a_step": "GPipe 8 hop broadcasts, 4 output "
                            "all-reduces (... per leaf), 1 dx broadcast; "
                            "1F1B 20 hop broadcasts and the loss, dx and "
                            "head-gradient broadcasts",
    "a_launches": "exact: GPipe B2 = B3 = 2 + 2*12*4 = 98, B4-B6 48; "
                  "1F1B B2 1 + 4*12*4 (+4 on the last stage), B3 "
                  "1 + 2*12*4 (+4), B4 96, B5 = B6 48",
    "b_memory": "GPipe's peak grows by 1.5-3 GB a rank from M 4 to M 8; "
                "1F1B's grows by under 0.7 GB (the batch and its "
                "embeddings double, the saved stage inputs stay at S)",
    "c_dp2_pp2": "within 1e-4 of the dense process",
    "d_dropout": "1F1B within 1e-5 of GPipe autodiff at the same key",
    "e_gpt": "masked loss within 1e-4 relative of the dense lm_loss, "
             "tied wte gradient within 1e-4 scale-aware",
    "phase_s": "80-130",
    # written after the first round of readings and before the run that
    # takes these: the last stage's forward tick only saves its input,
    # a hop runs only with the stages that send, the O2 runs go through
    # bert_main_amp.train, and the schedule's own memory is read
    "r2_step_ms_O2": "GPipe 320-390 as before; 1F1B 380-470 (from "
                     "480-530: the last stage's M stage forwards and 12 "
                     "of 20 hop broadcasts gone)",
    "r2_collectives_a_step": "GPipe 8 hop broadcasts as before; 1F1B 8 "
                             "hop broadcasts (from 20)",
    "r2_b_schedule_memory": "M 4 to M 8: GPipe's held at its return "
                            "grows 1.2-2.5 GB a rank (0.3-0.6 GB a "
                            "microbatch of 8 rows: 12 layers' saved "
                            "activations); 1F1B's schedule peak grows "
                            "under 0.1 GB",
    "r2_b_step_peak": "the step peak still grows by about 0.5 GB under "
                      "GPipe: the fp32 MLM logits of the 32 extra rows "
                      "(32x128x30522x4 B), which GPipe's heads take on "
                      "the whole batch and 1F1B's on one microbatch",
}


def _pp_launches(names, lps, m, schedule, last, steps, dropout=False):
    """A pipelined BERT rank's launches over ``steps`` steps: GPipe runs
    the embeddings, the stage's ``lps`` layers on each of ``m``
    microbatches and the heads, each forward and backward; 1F1B runs the
    stage forward twice on a stage that sends (its forward tick and the
    rematerialized forward) and once on the last stage (its forward tick
    only saves the input), the embeddings once, and the heads' MLM
    LayerNorm only on the last stage, once a microbatch.  With
    ``dropout`` the flash kernels are their dropout branches and each
    hidden dropout (embeddings, two a layer) launches forward and
    backward."""
    fwd = 2 if schedule == "1f1b" and not last else 1
    heads = (m if last else 0) if schedule == "1f1b" else 1
    sfx = "_dropout" if dropout else ""
    step = {"layer_norm_fwd": 1 + fwd * 2 * lps * m + heads,
            "layer_norm_bwd": 1 + 2 * lps * m + heads,
            f"flash_fwd{sfx}": fwd * lps * m,
            f"flash_bwd_dq{sfx}": lps * m,
            f"flash_bwd_dkv{sfx}": lps * m}
    if dropout:
        step["threefry_dropout"] = 2 + (fwd + 1) * 2 * lps * m
    return {name: steps * step.get(name, 0) for name in names}


def _gpt_pp_launches(names, lps, m, last):
    """A PipelinedGPT rank's launches of one 1F1B loss-and-grad: the
    stage's ``lps`` blocks (two LayerNorms and one attention each) run
    forward twice (once on the last stage) and backward once a
    microbatch; the head's LayerNorm runs on the last stage, once a
    microbatch."""
    heads, fwd = (m, 1) if last else (0, 2)
    step = {"layer_norm_fwd": 2 * fwd * lps * m + heads,
            "layer_norm_bwd": 2 * lps * m + heads,
            "flash_fwd": fwd * lps * m, "flash_bwd_dq": lps * m,
            "flash_bwd_dkv": lps * m}
    return {name: step.get(name, 0) for name in names}


def _pp_gpt_batch(torch):
    from apex_tpu_torch.examples import gpt_main_amp
    ids = next(gpt_main_amp.batches(50257, len(PP_GPT_LENS), TRAIN_SEQ))
    mask = torch.zeros(len(PP_GPT_LENS), TRAIN_SEQ, dtype=torch.int32)
    for i, n in enumerate(PP_GPT_LENS):
        mask[i, :n] = 1
    return torch.from_numpy(ids).cuda(), mask.cuda()


def _pp_dense():
    """One process's dense runs the pipelined ranks are held against:
    BERT-large O0 (2 steps, a part of the step-1 gradients written for
    the ranks) and O2 (3 steps) at B 32, S 128; O0 one step on (c)'s
    global batch (data index 0's and 1's 16 rows); GPT-2 small's masked
    lm_loss and its wte gradient on (e)'s batch."""
    import torch
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import GPTLMHeadModel, gpt_small
    from apex_tpu_torch.models.gpt import lm_loss
    from apex_tpu_torch.ops import make_flash_attention
    out = {}
    cfg = bert_main_amp.get_config("large")
    for level, steps in (("O0", PP_O0_STEPS), ("O2", PP_O2_STEPS)):
        model, opt, params, st = bert_main_amp.build(
            cfg, opt_level=level, attention_fn=make_flash_attention(),
            device="cuda", state_dict=_seed0_bert_large())
        data = bert_main_amp.batches(cfg, PP_BATCH, PP_SEQ)
        losses, seconds = [], []
        for step in range(steps):
            batch = tuple(torch.from_numpy(a).cuda() for a in next(data))
            t0 = time.perf_counter()
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if level == "O0" and step == 0:
                torch.save({k: v.detach().cpu() for k, v in grads.items()
                            if PP_GRADS.search(k)},
                           OUT_DIR / "pp_dense_grads.pt")
            del grads
        out[f"bert_{level}"] = {"losses": losses, "step_seconds": seconds}
        if level == "O0":
            model, opt, params, st = bert_main_amp.build(
                cfg, opt_level="O0", attention_fn=make_flash_attention(),
                device="cuda", state_dict=_seed0_bert_large())
            rows = [next(bert_main_amp.batches(cfg, PP_DP_BATCH, PP_SEQ,
                                               seed=d)) for d in range(2)]
            batch = tuple(torch.from_numpy(np.concatenate(parts)).cuda()
                          for parts in zip(*rows))
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch)
            out["bert_dp"] = {"loss": float(loss)}
            torch.save({k: v.detach().cpu() for k, v in grads.items()
                        if PP_GRADS.search(k)}, OUT_DIR / "pp_dp_grads.pt")
            del grads
        del model, opt, params, st
        torch.cuda.empty_cache()
    gcfg = gpt_small()
    model = GPTLMHeadModel(gcfg, make_flash_attention(causal=True),
                           device="cuda", seed=0)
    ids, mask = _pp_gpt_batch(torch)
    loss = lm_loss(model(ids, mask), ids, mask)
    (wte,) = torch.autograd.grad(loss, [model.wte.weight])
    out["gpt"] = {"loss": float(loss)}
    torch.save(wte.detach().cpu(), OUT_DIR / "pp_gpt_wte.pt")
    del model, wte
    torch.cuda.empty_cache()
    return out


class _PipeMemory:
    """While active, wraps the pipeline schedules
    (``parallel.pipeline.gpipe`` and ``onef1b``, which the pipelined
    models look up at each call) to read the memory of each call above
    what was allocated at its entry: ``peak``, the most allocated inside
    the call, and ``held``, what is still allocated when it returns
    (GPipe's tick graphs, kept for its backward; 1F1B's gradients).  The
    maxima over the calls are kept, and :meth:`step_peak` is the whole
    run's peak across the resets the calls make."""

    def __init__(self):
        import torch
        from apex_tpu_torch.parallel import pipeline
        self.cuda, self.pipeline = torch.cuda, pipeline
        self.peak = self.held = self.outer = 0
        self.saved = {}

    def __enter__(self):
        cuda = self.cuda
        for name in ("gpipe", "onef1b"):
            fn = self.saved[name] = getattr(self.pipeline, name)

            def wrapped(*a, _fn=fn, **kw):
                self.outer = max(self.outer, cuda.max_memory_allocated())
                base = cuda.memory_allocated()
                cuda.reset_peak_memory_stats()
                out = _fn(*a, **kw)
                self.peak = max(self.peak,
                                cuda.max_memory_allocated() - base)
                self.held = max(self.held, cuda.memory_allocated() - base)
                return out
            setattr(self.pipeline, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.pipeline, name, fn)

    def step_peak(self):
        return max(self.outer, self.cuda.max_memory_allocated())


def _pp_train(schedule, m, batch, steps):
    """``steps`` O2 steps of BERT-large through the user's entry,
    ``bert_main_amp.train(..., pp=2, pp_schedule=, pp_microbatches=)``
    (its mesh, its DDP over the data group, its checks, data index 0's
    batches): launch counts at 0 just before and read just after,
    collective calls counted, the whole run's peak and the schedule's
    own memory (:class:`_PipeMemory`)."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CollectiveCount() as coll, _PipeMemory() as mem:
        res = bert_main_amp.train(
            bert_main_amp.get_config("large"), batch=batch, seq_len=PP_SEQ,
            steps=steps, opt_level="O2", attention_fn=make_flash_attention(),
            device="cuda", seed=0, pp=PP, pp_schedule=schedule,
            pp_microbatches=m)
        torch.cuda.synchronize()
    out = {"losses": res["losses"], "step_seconds": res["step_seconds"],
           "launches": launch_counts(), "collectives": dict(coll.counts),
           "peak_memory_gb": mem.step_peak() / 1e9,
           "pipe_peak_gb": mem.peak / 1e9, "pipe_held_gb": mem.held / 1e9}
    del res
    torch.cuda.empty_cache()
    return out


def _pp_run(build, schedule, batches, steps, keep_params=False, **step_kw):
    """``steps`` steps of a pipelined BERT rank: launch counts at 0 just
    before and read just after, collective calls counted, host clock
    around each step (ended by reading the loss), the peak memory and
    the schedule's own (:class:`_PipeMemory`); the step-1 gradients and
    (``keep_params``) the params after step 1, both moved to the host
    so that they hold no device memory through the later steps."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.parallel import DistributedDataParallel
    t0 = time.perf_counter()
    model, opt, params, st, mesh = build()
    build_s = time.perf_counter() - t0
    ddp = DistributedDataParallel(model, process_group=mesh.group("data"))
    losses, seconds, grads1, params1 = [], [], None, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CollectiveCount() as coll, _PipeMemory() as mem:
        for i in range(steps):
            batch = tuple(torch.from_numpy(a).cuda() for a in next(batches))
            scale = float(opt.loss_scale(st))
            t0 = time.perf_counter()
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch, ddp=ddp, mesh=mesh,
                schedule=schedule, **step_kw)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                grads1 = {k: (g.detach() / scale).cpu()
                          for k, g in grads.items()}
                if keep_params:
                    params1 = {k: v.detach().cpu()
                               for k, v in params.items()}
            del grads
        torch.cuda.synchronize()
    out = {"losses": losses, "step_seconds": seconds,
           "build_seconds": build_s,
           "launches": launch_counts(), "collectives": dict(coll.counts),
           "peak_memory_gb": mem.step_peak() / 1e9,
           "pipe_peak_gb": mem.peak / 1e9, "pipe_held_gb": mem.held / 1e9}
    del model, opt, params, st, ddp
    torch.cuda.empty_cache()
    return out, grads1, params1


def _pp_grad_err(grads, want_file, pp, rank, tp=1, tp_rank=0):
    import torch
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models.bert import dense_to_rank
    want = dense_to_rank(torch.load(want_file),
                         bert_main_amp.get_config("large"), pp, rank, tp,
                         tp_rank)
    return max(scale_aware_err(grads[k].cuda(), w.cuda())[0]
               for k, w in want.items())


def _pp_rank_legs(rank, seed0):
    """(a), (b), (d) and (e) on this rank of the (1, 2) pipe mesh;
    ``seed0``: BERT-large's seed-0 weights on the card
    (``_spawn_seed0``), whose stage every BERT build loads."""
    import dataclasses
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import PipelinedGPT, gpt_small
    from apex_tpu_torch.ops import make_flash_attention
    from apex_tpu_torch.models.bert import dense_to_rank
    cfg = bert_main_amp.get_config("large")
    lps, last = BERT_LAYERS // PP, rank == PP - 1
    out = {}

    def make_build(level, m, config=cfg):
        def build():
            mesh = parallel.create_mesh(pp=PP)
            return bert_main_amp.build(
                config, opt_level=level, attention_fn=make_flash_attention(),
                device="cuda", state_dict=dense_to_rank(seed0, config, PP,
                                                        rank),
                mesh=mesh, pp_microbatches=m) + (mesh,)
        return build

    def data(batch=PP_BATCH):
        return bert_main_amp.batches(cfg, batch, PP_SEQ)

    # (a)
    params1 = {}
    for schedule in ("gpipe", "1f1b"):
        res, grads1, params1[schedule] = _pp_run(
            make_build("O0", PP_M), schedule, data(), PP_O0_STEPS,
            keep_params=True)
        res["step1_grad_err"] = _pp_grad_err(
            grads1, OUT_DIR / "pp_dense_grads.pt", PP, rank)
        res["want_launches"] = _pp_launches(res["launches"], lps, PP_M,
                                            schedule, last, PP_O0_STEPS)
        out[f"{schedule}_O0"] = res
        del grads1
        res = _pp_train(schedule, PP_M, PP_BATCH, PP_O2_STEPS)
        res["want_launches"] = _pp_launches(res["launches"], lps, PP_M,
                                            schedule, last, PP_O2_STEPS)
        out[f"{schedule}_O2"] = res
    out["sched_param_err"] = max(
        scale_aware_err(params1["1f1b"][k], params1["gpipe"][k])[0]
        for k in params1["gpipe"])
    del params1
    torch.cuda.empty_cache()
    # (b): M 4 at B 32 is (a)'s O2 run itself (the same call, 3 steps)
    for m, batch in PP_MEM:
        for schedule in ("gpipe", "1f1b"):
            res = out[f"{schedule}_O2"] if (m, batch) == (PP_M, PP_BATCH) \
                else _pp_train(schedule, m, batch, 2)
            out[f"mem_{schedule}_M{m}"] = {
                key: res[key] for key in ("peak_memory_gb", "pipe_peak_gb",
                                          "pipe_held_gb", "step_seconds",
                                          "losses")}
    # (d): one step's gradients, 1F1B against GPipe autodiff, O0
    drop = {}
    for schedule in ("gpipe", "1f1b"):
        res, drop[schedule], _ = _pp_run(
            make_build("O0", PP_M), schedule, data(), 1, deterministic=False,
            dropout_key=bert_main_amp.step_key(0, 0))
        res["want_launches"] = _pp_launches(res["launches"], lps, PP_M,
                                            schedule, last, 1, dropout=True)
        out[f"drop_{schedule}"] = res
    out["drop_grad_err"] = max(
        scale_aware_err(drop["1f1b"][k], drop["gpipe"][k])[0]
        for k in drop["gpipe"])
    del drop
    torch.cuda.empty_cache()
    # (e): GPT-2 small's PipelinedGPT, 1F1B with skewed padding, O0
    mesh = parallel.create_mesh(pp=PP)
    gpt = PipelinedGPT(gpt_small(), mesh, PP, PP_M,
                       attention_fn=make_flash_attention(causal=True),
                       device="cuda", seed=0)
    ids, mask = _pp_gpt_batch(torch)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = gpt.loss_and_grad_1f1b(ids, ids, attention_mask=mask)
    loss = float(loss)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    wte = torch.load(OUT_DIR / "pp_gpt_wte.pt").cuda()
    out["gpt"] = {"loss": loss, "seconds": seconds, "launches": counts,
                  "want_launches": _gpt_pp_launches(counts, 12 // PP, PP_M,
                                                    last),
                  "wte_grad_err": scale_aware_err(
                      grads["embed.wte.weight"], wte)[0]}
    del gpt, grads, wte
    torch.cuda.empty_cache()
    return out


def _pp_rank(rank, world, store, seed0):
    """(a), (b), (d), (e)'s ranks: gloo on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _pp_rank_legs(rank, seed0)
        seed0.clear()       # the shared blocks released (see _moe_rank)
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"pp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _pp_dp_rank(rank, world, store, seed0):
    """(c) on this rank of the (2, 2) mesh: BERT-large O0, one 1F1B step
    and one GPipe step, data index d's 16 rows from ``RandomState(d)``;
    the stage's seed-0 weights from ``seed0`` (``_spawn_seed0``)."""
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import parallel
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        from apex_tpu_torch.models.bert import dense_to_rank
        cfg = bert_main_amp.get_config("large")
        out = {}
        for schedule in ("1f1b", "gpipe"):
            def build():
                mesh = parallel.create_mesh(pp=PP)
                return bert_main_amp.build(
                    cfg, opt_level="O0", attention_fn=make_flash_attention(),
                    device="cuda", state_dict=dense_to_rank(
                        seed0, cfg, PP, rank % PP),
                    mesh=mesh, pp_microbatches=PP_M) + (mesh,)
            d = rank // PP
            res, grads1, _ = _pp_run(
                build, schedule, bert_main_amp.batches(cfg, PP_DP_BATCH,
                                                       PP_SEQ, seed=d), 1)
            res["step1_grad_err"] = _pp_grad_err(
                grads1, OUT_DIR / "pp_dp_grads.pt", PP, rank % PP)
            out[schedule] = res
            del grads1
        seed0.clear()       # the shared blocks released (see _moe_rank)
        (OUT_DIR / f"pp_dp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_train_pp():
    """(a) BERT-large at --pp 2, GPipe and 1F1B, O0 and O2, (b) the
    memory claim, (d) dropout through PipelinedBert and (e) GPT-2
    small's PipelinedGPT, as two processes over gloo on the one card;
    (c) dp 2 x pp 2 as four; each against one dense process."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    emit("train_pp", prediction=PP_PREDICTION)
    t0 = time.perf_counter()
    files = ("pp_dense_grads.pt", "pp_dp_grads.pt", "pp_gpt_wte.pt")
    try:
        dense = _pp_dense()
        dense_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _spawn_seed0(_pp_rank, PP, "pp")
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp_ranks = _spawn_seed0(_pp_dp_rank, 2 * PP, "pp_dp")
        dp_s = time.perf_counter() - t0
    finally:
        for f in files:
            (OUT_DIR / f).unlink(missing_ok=True)
    by_path = {}
    tokens = PP_BATCH * PP_SEQ
    # (a)
    for schedule in ("gpipe", "1f1b"):
        for level, tol in (("O0", PP_TOL), ("O2", O2_LOSS_TOL)):
            want = dense[f"bert_{level}"]["losses"]
            steps = PP_O0_STEPS if level == "O0" else PP_O2_STEPS
            for r, res in enumerate(ranks):
                got = res[f"{schedule}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want))
                emit("train_pp", run=f"(a) BERT-large --pp 2 {schedule} "
                     f"{level}", rank=r, batch=PP_BATCH, seq=PP_SEQ,
                     microbatches=PP_M, losses=got["losses"],
                     dense_losses=want, loss_err=err, tol=tol,
                     step1_grad_err=got.get("step1_grad_err"),
                     step_ms=[1e3 * t for t in got["step_seconds"]],
                     dense_step_ms=[1e3 * t for t in
                                    dense[f"bert_{level}"]["step_seconds"]],
                     tokens_per_s_pair=[tokens / t
                                        for t in got["step_seconds"]],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches_a_step={k: v / steps for k, v in
                                      got["launches"].items()},
                     collectives_a_step={k: v / steps for k, v in
                                         got["collectives"].items()})
                if not err <= tol:
                    raise AssertionError(f"--pp 2 {schedule} {level} rank "
                                         f"{r}: loss error {err:.3g}")
                if level == "O0" and not got["step1_grad_err"] <= PP_TOL:
                    raise AssertionError(
                        f"--pp 2 {schedule} O0 rank {r}: step-1 grads "
                        f"{got['step1_grad_err']:.3g}")
                if got["launches"] != got["want_launches"]:
                    raise AssertionError(
                        f"--pp 2 {schedule} {level} rank {r}: launches "
                        f"{got['launches']} != {got['want_launches']}")
            if level == "O2":
                by_path[f"train_pp_{schedule}"] = ranks[0][
                    f"{schedule}_O2"]["launches"]
    for r, res in enumerate(ranks):
        emit("train_pp", run="(a) GPipe against 1F1B, params after step 1",
             rank=r, err=res["sched_param_err"], tol=PP_SCHED_TOL)
        if not res["sched_param_err"] <= PP_SCHED_TOL:
            raise AssertionError(f"GPipe against 1F1B rank {r}: "
                                 f"{res['sched_param_err']:.3g}")
    # (b)
    for r, res in enumerate(ranks):
        peaks = {k: res[k]["peak_memory_gb"] for k in res
                 if k.startswith("mem_")}
        growth = {s: peaks[f"mem_{s}_M8"] - peaks[f"mem_{s}_M4"]
                  for s in ("gpipe", "1f1b")}
        pipe = {f"{s}_M{m}": {key: res[f"mem_{s}_M{m}"][f"pipe_{key}_gb"]
                              for key in ("peak", "held")}
                for s in ("gpipe", "1f1b") for m in (4, 8)}
        # what the schedule keeps: GPipe its tick graphs at its return,
        # 1F1B the most it needs at once
        pipe_growth = {
            "gpipe_held": (pipe["gpipe_M8"]["held"]
                           - pipe["gpipe_M4"]["held"]),
            "1f1b_peak": (pipe["1f1b_M8"]["peak"]
                          - pipe["1f1b_M4"]["peak"])}
        emit("train_pp", run="(b) peak a rank at M 4 (B 32) and M 8 (B 64), "
             "O2, through bert_main_amp.train", rank=r, peaks_gb=peaks,
             growth_gb=growth, schedule_gb=pipe,
             schedule_growth_gb=pipe_growth,
             step_ms={k: [1e3 * t for t in res[k]["step_seconds"]]
                      for k in peaks})
        if not growth["1f1b"] < min(growth["gpipe"], PP_MEM_1F1B_GB):
            raise AssertionError(f"(b) rank {r}: 1F1B's peak grew "
                                 f"{growth['1f1b']:.3g} GB, GPipe's "
                                 f"{growth['gpipe']:.3g}")
        if not pipe_growth["1f1b_peak"] < min(
                PP_PIPE_1F1B_GB, 0.25 * pipe_growth["gpipe_held"]):
            raise AssertionError(
                f"(b) rank {r}: 1F1B's schedule peak grew "
                f"{pipe_growth['1f1b_peak']:.3g} GB, GPipe's held "
                f"{pipe_growth['gpipe_held']:.3g}")
    # (c)
    for r, res in enumerate(dp_ranks):
        for schedule, got in res.items():
            # each rank's loss is its data index's: their mean over the
            # data group is the global batch's
            loss = sum(dp_ranks[d * PP][schedule]["losses"][0]
                       for d in range(2)) / 2
            err = abs(loss - dense["bert_dp"]["loss"]) / abs(
                dense["bert_dp"]["loss"])
            emit("train_pp", run=f"(c) dp 2 x pp 2 {schedule} O0", rank=r,
                 batch_per_data_index=PP_DP_BATCH, loss=got["losses"][0],
                 data_mean_loss=loss, dense_loss=dense["bert_dp"]["loss"],
                 loss_err=err, step1_grad_err=got["step1_grad_err"],
                 step_ms=[1e3 * t for t in got["step_seconds"]],
                 peak_memory_gb=got["peak_memory_gb"],
                 collectives_a_step=got["collectives"])
            if not err <= PP_TOL:
                raise AssertionError(f"(c) {schedule} rank {r}: loss error "
                                     f"{err:.3g}")
            if not got["step1_grad_err"] <= PP_TOL:
                raise AssertionError(f"(c) {schedule} rank {r}: grads "
                                     f"{got['step1_grad_err']:.3g}")
    # (d)
    for r, res in enumerate(ranks):
        emit("train_pp", run="(d) dropout 0.1, 1F1B against GPipe autodiff",
             rank=r, grad_err=res["drop_grad_err"], tol=PP_SCHED_TOL,
             launches={s: res[f"drop_{s}"]["launches"]
                       for s in ("gpipe", "1f1b")})
        if not res["drop_grad_err"] <= PP_SCHED_TOL:
            raise AssertionError(f"(d) rank {r}: {res['drop_grad_err']:.3g}")
        for s in ("gpipe", "1f1b"):
            got = res[f"drop_{s}"]
            if got["launches"] != got["want_launches"]:
                raise AssertionError(f"(d) {s} rank {r}: launches "
                                     f"{got['launches']} != "
                                     f"{got['want_launches']}")
    by_path["train_pp_dropout"] = ranks[0]["drop_1f1b"]["launches"]
    # (e)
    for r, res in enumerate(ranks):
        got = res["gpt"]
        err = abs(got["loss"] - dense["gpt"]["loss"]) / abs(
            dense["gpt"]["loss"])
        emit("train_pp", run="(e) GPT-2 small PipelinedGPT pp 2, 1F1B, "
             "skewed padding, O0", rank=r, batch=len(PP_GPT_LENS),
             seq=TRAIN_SEQ, microbatches=PP_M, loss=got["loss"],
             dense_loss=dense["gpt"]["loss"], loss_err=err,
             wte_grad_err=got["wte_grad_err"],
             step_ms=1e3 * got["seconds"], launches=got["launches"])
        if not (err <= PP_TOL and got["wte_grad_err"] <= PP_TOL):
            raise AssertionError(f"(e) rank {r}: loss {err:.3g}, wte "
                                 f"{got['wte_grad_err']:.3g}")
        if got["launches"] != got["want_launches"]:
            raise AssertionError(f"(e) rank {r}: launches "
                                 f"{got['launches']} != "
                                 f"{got['want_launches']}")
    by_path["train_pp_gpt"] = ranks[0]["gpt"]["launches"]
    (OUT_DIR / "train_pp.json").write_text(json.dumps(
        {"dense": dense, "ranks": ranks, "dp_ranks": dp_ranks,
         "dense_seconds": dense_s, "ranks_seconds": ranks_s,
         "dp_seconds": dp_s}, indent=1, default=str))
    emit("train_pp", dense_seconds=dense_s, ranks_seconds=ranks_s,
         dp_seconds=dp_s)
    return by_path


# the composed axes: BERT-large at --pp 2 --ring-attention 2 (B 16, S
# 512, M 4), GPipe with ring and 1F1B with Ulysses, dropout through
# PipelinedBert with Ulysses, GPT-2 small's PipelinedGPT (B 8, S 1024,
# M 4), as four processes over gloo on the one card (dp 1 x sp 2 x pp
# 2); GPT-2 small --sp 2 --tp 2 as four more; each against one dense
# process
CSP, CPP = 2, 2
CB_BATCH, CB_SEQ, C_M = 16, 512, 4
C_O0_STEPS, C_O2_STEPS = 2, 2
C_TOL = 1e-4              # O0 against one process: losses relative,
                          # step-1 grads (params for (d)) scale-aware
C_SCHED_TOL = 1e-5        # GPipe against 1F1B: params after step 1, and
                          # (b)'s gradients, scale-aware
C_LOGIT_TOL = 2e-4        # (c) GPipe's logits, scale-aware
C_PREDICTION = {
    "a_losses_O0": "GPipe-ring and 1F1B-Ulysses within 1e-4 relative of "
                   "the dense process, step-1 gradients within 1e-4 "
                   "scale-aware (measured error 1e-7 to 1e-6, as train_pp's "
                   "--pp 2 and train_sp's --ring-attention 2); GPipe and "
                   "1F1B params after step 1 within 1e-5",
    "a_O2": "within 2e-2 of dense O2 every step",
    "a_step_ms_O2": "GPipe-ring 600-1500, 1F1B-Ulysses 700-1800 (the "
                    "K/V rotations and all-to-alls, 96 a step a rank, "
                    "through the host beside the pipe hops; four "
                    "processes share the card)",
    "a_tokens_per_s_four_O2": "GPipe-ring 5.5k-14k, 1F1B-Ulysses "
                              "4.5k-12k (8192 tokens a step for the four)",
    "a_peak_gb_rank_O2": "GPipe 13-17, 1F1B 12-16 (train_pp's --pp 2 "
                         "ranks held 13.1-13.6, most of it the "
                         "replicated embeddings, heads and their LAMB "
                         "state); the four 52-68, under the card's 80",
    "a_collectives_a_step": "GPipe-ring: about 2 broadcasts a K/V "
                            "rotation (12 layers x 4 microbatches, "
                            "forward and backward) beside train_pp's 8 pipe "
                            "hops; 1F1B-Ulysses: the all-to-alls as "
                            "broadcasts, 4 q/k/v and 4 output swaps a "
                            "layer a microbatch each way, and the "
                            "gathered hidden states",
    "a_launches": "exact: GPipe-ring B2 = B3 = 2 + 2*12*4 = 98, B4-B6 "
                  "2*12*4 = 96 (two hops a layer a microbatch); "
                  "1F1B-Ulysses B2 1 + 4*12*4 (+4 on the last stage), B3 "
                  "1 + 2*12*4 (+4), B4 96 (48 on the last stage), B5 = "
                  "B6 48",
    "a_1f1b_ring": "exits with the JAX example's message",
    "b_dropout": "1F1B within 1e-5 of GPipe autodiff at the same key",
    "c_gpt": "1F1B-Ulysses loss within 1e-4 relative of the dense "
             "lm_loss, tied wte gradient within 1e-4 scale-aware; "
             "GPipe-ring logits within 2e-4 scale-aware",
    "d_sp_tp_O0": "ring and Ulysses losses within 1e-4 relative, step-1 "
                  "params within 1e-4 scale-aware",
    "d_sp_tp_O2": "within 2e-2 every step",
    "d_tokens_per_s_four_O2": "3k-9k (gloo all-reduces of the "
                              "row-parallel outputs and the sequence "
                              "swaps through the host)",
    "d_peak_gb_rank_O2": "3-7",
    "phase_s": "150-300",
}


def _compose_launches(names, lps, m, schedule, last, steps, calls,
                      dropout=False):
    """A pipelined BERT rank's launches (``_pp_launches``) with ``calls``
    flash calls an attention: the ring's two hops, Ulysses' one."""
    counts = _pp_launches(names, lps, m, schedule, last, steps, dropout)
    return {k: v * calls if k.startswith("flash_") else v
            for k, v in counts.items()}


BERT_DENSE_GRADS = "bert_large_dense_grads.pt"


def _bert_large_dense():
    """One process's dense BERT-large runs (``_bert_large_dense_runs``),
    shared by the run's phases."""
    return _shared("bert_large_dense", _bert_large_dense_runs)


def _bert_large_dense_runs():
    """One process's dense BERT-large runs at B 16, S 512 (seed 0, flash
    attention): O0 ``C_O0_STEPS`` steps, the step-1 gradients of the
    ``PP_GRADS`` leaves written to ``BERT_DENSE_GRADS``, and O2
    ``C_O2_STEPS`` steps; each its losses and step seconds."""
    import torch
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    out = {}
    cfg = bert_main_amp.get_config("large")
    for level, steps in (("O0", C_O0_STEPS), ("O2", C_O2_STEPS)):
        model, opt, params, st = bert_main_amp.build(
            cfg, opt_level=level, attention_fn=make_flash_attention(),
            device="cuda", state_dict=_seed0_bert_large())
        data = bert_main_amp.batches(cfg, CB_BATCH, CB_SEQ)
        losses, seconds = [], []
        for step in range(steps):
            batch = tuple(torch.from_numpy(a).cuda() for a in next(data))
            t0 = time.perf_counter()
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if level == "O0" and step == 0:
                torch.save({k: v.detach().cpu() for k, v in grads.items()
                            if PP_GRADS.search(k)},
                           OUT_DIR / BERT_DENSE_GRADS)
            del grads
        out[f"bert_{level}"] = {"losses": losses, "step_seconds": seconds}
        del model, opt, params, st
        torch.cuda.empty_cache()
    return out


def _compose_dense():
    """One process's dense runs: BERT-large O0 and O2 at B 16, S 512
    (``_bert_large_dense``, a part of the step-1 gradients written for
    the ranks); GPT-2 small's lm_loss, its wte gradient, its wte and its final
    hidden states at B 8, S 1024; GPT-2 small's O0 and O2 steps for (d)
    (``_tp_dense_reference``)."""
    import torch
    from apex_tpu_torch.models import GPTLMHeadModel, gpt_small
    from apex_tpu_torch.models.gpt import lm_loss
    from apex_tpu_torch.ops import make_flash_attention
    out = _bert_large_dense()
    model = GPTLMHeadModel(gpt_small(), make_flash_attention(causal=True),
                           device="cuda", seed=0)
    ids = torch.from_numpy(next(_c_gpt_batches())).cuda()
    hidden = model(ids, return_hidden=True)
    loss = lm_loss(torch.nn.functional.linear(hidden, model.wte.weight)
                   .float(), ids)
    (wte,) = torch.autograd.grad(loss, [model.wte.weight])
    out["gpt"] = {"loss": float(loss)}
    torch.save({"wte": wte.detach().cpu(), "hidden": hidden.detach().cpu(),
                "wte_weight": model.wte.weight.detach().cpu()},
               OUT_DIR / "c_gpt.pt")
    del model, wte, hidden
    torch.cuda.empty_cache()
    out["sp_tp"] = _tp_dense_reference()
    return out


def _c_gpt_batches():
    from apex_tpu_torch.examples import gpt_main_amp
    return gpt_main_amp.batches(50257, TRAIN_BATCH, TRAIN_SEQ)


def _compose_run(build, schedule, batches, steps, keep_params=False,
                 keep_final=None, **step_kw):
    """``steps`` steps of a BERT rank of the (1, 2, 2) mesh: its DDP over
    the example's group (the data group under 1F1B, the (data x sp)
    ranks under GPipe), launch counts at 0 just before and read just
    after, collectives counted, host clock around each step, the peak;
    the step-1 gradients and (``keep_params``) params on the host, or
    (``keep_final``, a pattern) the params after the last step whose
    names match it."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.parallel import DistributedDataParallel
    t0 = time.perf_counter()
    model, opt, params, st, mesh = build()
    build_s = time.perf_counter() - t0
    ddp = DistributedDataParallel(model, process_group=mesh.group(
        "data" if schedule == "1f1b" else "data_sp"))
    losses, seconds, grads1, params1 = [], [], None, None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CollectiveCount() as coll:
        for i in range(steps):
            batch = tuple(torch.from_numpy(a).cuda() for a in next(batches))
            scale = float(opt.loss_scale(st))
            t0 = time.perf_counter()
            params, st, loss, grads = bert_main_amp.train_step(
                model, opt, params, st, batch, ddp=ddp, mesh=mesh,
                schedule=schedule, **step_kw)
            losses.append(float(loss))
            seconds.append(time.perf_counter() - t0)
            if i == 0:
                grads1 = {k: (g.detach() / scale).cpu()
                          for k, g in grads.items()}
                if keep_params:
                    params1 = {k: v.detach().cpu()
                               for k, v in params.items()}
            del grads
        torch.cuda.synchronize()
    out = {"losses": losses, "step_seconds": seconds,
           "build_seconds": build_s,
           "launches": launch_counts(), "collectives": dict(coll.counts),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if keep_final is not None:
        params1 = {k: v.detach().cpu() for k, v in params.items()
                   if keep_final.search(k)}
    del model, opt, params, st, ddp
    torch.cuda.empty_cache()
    return out, grads1, params1


def _compose_o2(schedule, pattern):
    """``C_O2_STEPS`` O2 steps of BERT-large through the user's entry,
    ``bert_main_amp.train(..., pp=2, sp=2, sp_attention=)``: launches,
    collectives and the peak, as ``_pp_train``."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with _CollectiveCount() as coll:
        res = bert_main_amp.train(
            bert_main_amp.get_config("large"), batch=CB_BATCH,
            seq_len=CB_SEQ, steps=C_O2_STEPS, opt_level="O2",
            attention_fn=make_flash_attention(), device="cuda", seed=0,
            pp=CPP, pp_schedule=schedule, pp_microbatches=C_M, sp=CSP,
            sp_attention=pattern)
        torch.cuda.synchronize()
    out = {"losses": res["losses"], "step_seconds": res["step_seconds"],
           "launches": launch_counts(), "collectives": dict(coll.counts),
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    del res
    torch.cuda.empty_cache()
    return out


def _compose_rank_legs(rank, seed0):
    """(a), (b) and (c) on this rank of the (1, 2, 2) mesh; ``seed0``:
    BERT-large's seed-0 weights on the card (``_spawn_seed0``), whose
    stage every BERT build loads."""
    import torch
    import torch.nn.functional as F
    from apex_tpu_torch import parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import PipelinedGPT, gpt_small
    from apex_tpu_torch.models.bert import dense_to_rank
    cfg = bert_main_amp.get_config("large")
    mesh0 = parallel.create_mesh(sp=CSP, pp=CPP)
    sp_rank, pipe = mesh0.index("sp"), mesh0.index("pipe")
    lps, last = BERT_LAYERS // CPP, pipe == CPP - 1
    out = {"coords": [0, sp_rank, pipe]}

    def make_build(level, pattern, config=cfg):
        def build():
            mesh = parallel.create_mesh(sp=CSP, pp=CPP)
            return bert_main_amp.build(
                config, opt_level=level, device="cuda",
                state_dict=dense_to_rank(seed0, config, CPP, pipe),
                mesh=mesh, sp_attention=pattern,
                pp_microbatches=C_M) + (mesh,)
        return build

    def data():
        return bert_main_amp.batches(cfg, CB_BATCH, CB_SEQ)

    # (a)
    params1 = {}
    for schedule, pattern in (("gpipe", "ring"), ("1f1b", "ulysses")):
        calls = CSP if pattern == "ring" else 1
        res, grads1, params1[schedule] = _compose_run(
            make_build("O0", pattern), schedule, data(), C_O0_STEPS,
            keep_params=True)
        res["step1_grad_err"] = _pp_grad_err(
            grads1, OUT_DIR / BERT_DENSE_GRADS, CPP, pipe)
        res["want_launches"] = _compose_launches(
            res["launches"], lps, C_M, schedule, last, C_O0_STEPS, calls)
        out[f"{schedule}_O0"] = res
        del grads1
        res = _compose_o2(schedule, pattern)
        res["want_launches"] = _compose_launches(
            res["launches"], lps, C_M, schedule, last, C_O2_STEPS, calls)
        out[f"{schedule}_O2"] = res
    out["sched_param_err"] = max(
        scale_aware_err(params1["1f1b"][k].cuda(),
                        params1["gpipe"][k].cuda())[0]
        for k in params1["gpipe"])
    del params1
    try:
        bert_main_amp.check_pipeline(cfg, CB_BATCH, 1, CPP, "1f1b", C_M,
                                     CSP, CSP * CPP, CB_SEQ, "ring")
        out["ring_1f1b"] = None
    except SystemExit as e:
        out["ring_1f1b"] = str(e)
    torch.cuda.empty_cache()
    # (b): one step's gradients with dropout, 1F1B against GPipe, O0
    drop = {}
    for schedule in ("gpipe", "1f1b"):
        res, drop[schedule], _ = _compose_run(
            make_build("O0", "ulysses"), schedule, data(), 1,
            deterministic=False, dropout_key=bert_main_amp.step_key(0, 0))
        res["want_launches"] = _compose_launches(
            res["launches"], lps, C_M, schedule, last, 1, 1, dropout=True)
        out[f"drop_{schedule}"] = res
    out["drop_grad_err"] = max(
        scale_aware_err(drop["1f1b"][k].cuda(), drop["gpipe"][k].cuda())[0]
        for k in drop["gpipe"])
    del drop
    torch.cuda.empty_cache()
    # (c): GPT-2 small's PipelinedGPT, 1F1B with Ulysses, GPipe with ring
    ids = torch.from_numpy(next(_c_gpt_batches())).cuda()
    dense = torch.load(OUT_DIR / "c_gpt.pt")
    sl = TRAIN_SEQ // CSP
    gpt = {}
    for schedule, make in (("1f1b", parallel.make_ulysses_attention),
                           ("gpipe", parallel.make_ring_attention)):
        model = PipelinedGPT(gpt_small(), mesh0, CPP, C_M, seq_axis="sp",
                             attention_fn=make(mesh0.group("sp"),
                                               causal=True),
                             device="cuda", seed=0)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        if schedule == "1f1b":
            loss, grads = model.loss_and_grad_1f1b(ids, ids)
            got = {"loss": float(loss), "wte_grad_err": scale_aware_err(
                grads["embed.wte.weight"], dense["wte"].cuda())[0]}
            want = _gpt_pp_launches(launch_counts(), 12 // CPP, C_M, last)
            del grads
        else:
            with torch.no_grad():
                logits = model(ids)
                want_logits = F.linear(
                    dense["hidden"][:, sp_rank * sl:(sp_rank + 1) * sl]
                    .cuda(), dense["wte_weight"].cuda()).float()
                got = {"logit_err": scale_aware_err(logits,
                                                    want_logits)[0]}
            del logits, want_logits
            names = launch_counts()
            n = 12 // CPP * C_M
            step = {"layer_norm_fwd": 2 * n + 1,
                    "flash_fwd": (sp_rank + 1) * n}
            want = {k: step.get(k, 0) for k in names}
        torch.cuda.synchronize()
        got.update(seconds=time.perf_counter() - t0,
                   launches=launch_counts(), want_launches=want)
        gpt[schedule] = got
        del model
        torch.cuda.empty_cache()
    out["gpt"] = gpt
    del dense
    return out


def _compose_rank(rank, world, store, seed0):
    """(a)-(d)'s ranks, one world of four for both meshes: gloo on CUDA
    tensors, TF32 off."""
    import gc
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _compose_rank_legs(rank, seed0)
        seed0.clear()       # the shared blocks released (see _moe_rank)
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"compose_rank{rank}.json").write_text(json.dumps(out))
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out = _sp_tp_rank_legs(rank)
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"sp_tp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def _sp_tp_o0(cfg, vocab, sd, pattern, want1):
    """(d)'s O0 leg on this rank: ``C_O0_STEPS`` steps through ``build``
    and ``train_step`` (DDP over ``"data_sp"``, as ``train`` makes it),
    so that the params after step 1 can be held against the dense
    process's, sliced as this rank's."""
    import dataclasses
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.examples import gpt_main_amp
    mesh = parallel.create_mesh(sp=CSP, tp=TP)
    model, opt, params, st = gpt_main_amp.build(
        dataclasses.replace(cfg, vocab_size=vocab), lr=TRAIN_LR,
        opt_level="O0", device="cuda", state_dict=sd, mesh=mesh,
        sp_attention=pattern)
    ddp = parallel.DistributedDataParallel(
        model, process_group=mesh.group("data_sp"))
    data = gpt_main_amp.batches(cfg.vocab_size, TRAIN_BATCH, TRAIN_SEQ)
    losses, seconds, step1_err = [], [], None
    for step in range(C_O0_STEPS):
        ids = torch.from_numpy(next(data)).to("cuda")
        t0 = time.perf_counter()
        params, st, loss = gpt_main_amp.train_step(
            model, opt, params, st, ids, ddp, mesh=mesh,
            true_vocab=cfg.vocab_size)[:3]
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
        if step == 0:
            step1_err = max(scale_aware_err(params[k], want1[k].cuda())[0]
                            for k in params)
    del model, opt, params, st, ddp
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": seconds,
            "step1_param_err": step1_err}


def _sp_tp_rank_legs(rank):
    """(d) on this rank of the (1, 2, 2) (data, sp, model) mesh: GPT-2
    small --sp 2 --tp 2, Ulysses and ring, O0 through ``build`` and
    ``train_step`` (its params after step 1 against the dense process's,
    sliced as this rank's) and O2 through the user's entry,
    ``gpt_main_amp.train(tp=2, sp=2)``, which makes its own mesh, DDP
    group, checks and overflow groups; launches, collectives and the
    peak are read around the O2 run."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import gpt_main_amp
    from apex_tpu_torch.models.gpt import padded_vocab
    from apex_tpu_torch.parallel import tensor_parallel as tpar
    cfg = gpt_main_amp.config("small", TRAIN_SEQ)
    vocab = padded_vocab(cfg.vocab_size, TP)
    sd = _tp_state_dict(cfg, TP)
    dense1 = torch.load(OUT_DIR / "tp_dense_step1.pt")
    dense1["wte.weight"] = torch.cat([dense1["wte.weight"],
                                      dense1["wte.weight"].new_zeros(
                                          vocab - cfg.vocab_size,
                                          cfg.hidden_size)])
    mesh = parallel.create_mesh(sp=CSP, tp=TP)
    sp_rank = mesh.index("sp")
    want1 = tpar.shard_params(dense1, mesh, tpar.gpt_tp_rules(),
                              num_heads=cfg.num_attention_heads)
    del dense1
    out = {"coords": [0, sp_rank, mesh.index("model")]}
    for pattern in ("ulysses", "ring"):
        calls = sp_rank + 1 if pattern == "ring" else 1
        out[f"{pattern}_O0"] = _sp_tp_o0(cfg, vocab, sd, pattern, want1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with _CollectiveCount() as coll:
            res = gpt_main_amp.train(
                cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                steps=C_O2_STEPS, lr=TRAIN_LR, opt_level="O2",
                device="cuda", state_dict=sd, tp=TP, sp=CSP,
                sp_attention=pattern)
            torch.cuda.synchronize()
        counts = launch_counts()
        want = {k: v * calls if k.startswith("flash_") else v
                for k, v in _tp_launches(cfg, counts,
                                         C_O2_STEPS).items()}
        out[f"{pattern}_O2"] = {
            "losses": res["losses"], "step_seconds": res["step_seconds"],
            "tokens_per_s_four": res["tokens_per_s"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": counts, "want_launches": want,
            "collectives": dict(coll.counts)}
        del res
        torch.cuda.empty_cache()
    return out


def phase_train_sp_compose():
    """Sequence parallelism composed with the other axes: (a) BERT-large
    --pp 2 --ring-attention 2, GPipe with ring and 1F1B with Ulysses, O0
    and O2, (b) dropout through PipelinedBert with Ulysses, (c) GPT-2
    small's PipelinedGPT with sp 2, and (d) GPT-2 small --sp 2 --tp 2,
    as one world of four processes over gloo on the one card; each
    against one dense process."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    emit("train_sp_compose", prediction=C_PREDICTION)
    t0 = time.perf_counter()
    files = ("c_gpt.pt",)
    try:
        dense = _compose_dense()
        dense_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        # (a)-(c) and (d) in one world of four (two meshes): one spawn
        ranks = _spawn_seed0(_compose_rank, CSP * CPP, "compose")
        ranks_s = time.perf_counter() - t0
        sp_tp = []
        for r in range(CSP * TP):
            path = OUT_DIR / f"sp_tp_rank{r}.json"
            sp_tp.append(json.loads(path.read_text()))
            path.unlink()
        sp_tp_s = max(res["seconds"] for res in sp_tp)
    finally:
        for f in files:
            (OUT_DIR / f).unlink(missing_ok=True)
    by_path = {}
    tokens = CB_BATCH * CB_SEQ
    peaks = {}
    # (a)
    for schedule, pattern in (("gpipe", "ring"), ("1f1b", "ulysses")):
        for level, tol in (("O0", C_TOL), ("O2", O2_LOSS_TOL)):
            want = dense[f"bert_{level}"]
            steps = C_O0_STEPS if level == "O0" else C_O2_STEPS
            for r, res in enumerate(ranks):
                got = res[f"{schedule}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want["losses"]))
                peaks.setdefault(f"{schedule}_{level}", []).append(
                    got["peak_memory_gb"])
                emit("train_sp_compose", run=f"(a) BERT-large --pp 2 "
                     f"--ring-attention 2 {schedule}-{pattern} {level}",
                     rank=r, coords=res["coords"], batch=CB_BATCH,
                     seq=CB_SEQ, microbatches=C_M, losses=got["losses"],
                     dense_losses=want["losses"], loss_err=err, tol=tol,
                     step1_grad_err=got.get("step1_grad_err"),
                     step_ms=[1e3 * t for t in got["step_seconds"]],
                     dense_step_ms=[1e3 * t for t in want["step_seconds"]],
                     tokens_per_s_four=[tokens / t
                                        for t in got["step_seconds"]],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches_a_step={k: v / steps for k, v in
                                      got["launches"].items()},
                     collectives_a_step={k: v / steps for k, v in
                                         got["collectives"].items()})
                if not err <= tol:
                    raise AssertionError(f"(a) {schedule} {level} rank {r}: "
                                         f"loss error {err:.3g}")
                if level == "O0" and not got["step1_grad_err"] <= C_TOL:
                    raise AssertionError(
                        f"(a) {schedule} O0 rank {r}: step-1 grads "
                        f"{got['step1_grad_err']:.3g}")
                if got["launches"] != got["want_launches"]:
                    raise AssertionError(
                        f"(a) {schedule} {level} rank {r}: launches "
                        f"{got['launches']} != {got['want_launches']}")
            if level == "O2":
                by_path[f"train_pp_sp_{schedule}_{pattern}"] = ranks[0][
                    f"{schedule}_O2"]["launches"]
    emit("train_sp_compose", run="(a) peak a rank, GB, and the four's sum",
         peaks=peaks, sums={k: sum(v) for k, v in peaks.items()})
    for r, res in enumerate(ranks):
        emit("train_sp_compose", run="(a) GPipe-ring against 1F1B-Ulysses, "
             "params after step 1", rank=r, err=res["sched_param_err"],
             tol=C_SCHED_TOL, ring_1f1b=res["ring_1f1b"])
        if not res["sched_param_err"] <= C_SCHED_TOL:
            raise AssertionError(f"(a) GPipe against 1F1B rank {r}: "
                                 f"{res['sched_param_err']:.3g}")
        if not (res["ring_1f1b"] or "").startswith(
                "--pp-schedule 1f1b cannot host ring attention"):
            raise AssertionError(f"(a) 1F1B with ring: {res['ring_1f1b']}")
    # (b)
    for r, res in enumerate(ranks):
        emit("train_sp_compose", run="(b) dropout 0.1 with Ulysses, 1F1B "
             "against GPipe autodiff", rank=r, grad_err=res["drop_grad_err"],
             tol=C_SCHED_TOL, launches={s: res[f"drop_{s}"]["launches"]
                                        for s in ("gpipe", "1f1b")})
        if not res["drop_grad_err"] <= C_SCHED_TOL:
            raise AssertionError(f"(b) rank {r}: {res['drop_grad_err']:.3g}")
        for s in ("gpipe", "1f1b"):
            got = res[f"drop_{s}"]
            if got["launches"] != got["want_launches"]:
                raise AssertionError(f"(b) {s} rank {r}: launches "
                                     f"{got['launches']} != "
                                     f"{got['want_launches']}")
    by_path["train_pp_sp_dropout"] = ranks[0]["drop_1f1b"]["launches"]
    # (c)
    for r, res in enumerate(ranks):
        one, gp = res["gpt"]["1f1b"], res["gpt"]["gpipe"]
        err = abs(one["loss"] - dense["gpt"]["loss"]) / abs(
            dense["gpt"]["loss"])
        emit("train_sp_compose", run="(c) GPT-2 small PipelinedGPT sp 2 x "
             "pp 2: 1F1B-Ulysses and GPipe-ring, O0", rank=r,
             batch=TRAIN_BATCH, seq=TRAIN_SEQ, microbatches=C_M,
             loss=one["loss"], dense_loss=dense["gpt"]["loss"],
             loss_err=err, wte_grad_err=one["wte_grad_err"],
             logit_err=gp["logit_err"], onef1b_ms=1e3 * one["seconds"],
             gpipe_forward_ms=1e3 * gp["seconds"],
             launches={"1f1b": one["launches"], "gpipe": gp["launches"]})
        if not (err <= C_TOL and one["wte_grad_err"] <= C_TOL
                and gp["logit_err"] <= C_LOGIT_TOL):
            raise AssertionError(f"(c) rank {r}: loss {err:.3g}, wte "
                                 f"{one['wte_grad_err']:.3g}, logits "
                                 f"{gp['logit_err']:.3g}")
        for got in (one, gp):
            if got["launches"] != got["want_launches"]:
                raise AssertionError(f"(c) rank {r}: launches "
                                     f"{got['launches']} != "
                                     f"{got['want_launches']}")
    by_path["train_pp_sp_gpt"] = ranks[0]["gpt"]["1f1b"]["launches"]
    # (d)
    for pattern in ("ulysses", "ring"):
        for level, tol in (("O0", C_TOL), ("O2", O2_LOSS_TOL)):
            want = dense["sp_tp"][level]
            for r, res in enumerate(sp_tp):
                got = res[f"{pattern}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want))
                steps = len(got["losses"])
                reading = ({"step1_param_err": got["step1_param_err"]}
                           if level == "O0" else {
                    "tokens_per_s_four": got["tokens_per_s_four"],
                    "peak_memory_gb": got["peak_memory_gb"],
                    "launches": got["launches"],
                    "collectives_a_step": {k: v / steps for k, v in
                                           got["collectives"].items()}})
                emit("train_sp_compose", run=f"(d) GPT-2 small --sp 2 --tp 2 "
                     f"{pattern} {level}" + (" through gpt_main_amp.train"
                                             if level == "O2" else ""),
                     rank=r, coords=res["coords"], batch=TRAIN_BATCH,
                     seq=TRAIN_SEQ, losses=got["losses"], dense_losses=want,
                     loss_err=err, tol=tol,
                     step_ms=[1e3 * t for t in got["step_seconds"]],
                     **reading)
                if not err <= tol:
                    raise AssertionError(f"(d) {pattern} {level} rank {r}: "
                                         f"loss error {err:.3g}")
                if level == "O0" and not got["step1_param_err"] <= C_TOL:
                    raise AssertionError(
                        f"(d) {pattern} O0 rank {r}: step-1 params "
                        f"{got['step1_param_err']:.3g}")
                if level == "O2" and got["launches"] != got["want_launches"]:
                    raise AssertionError(
                        f"(d) {pattern} {level} rank {r}: launches "
                        f"{got['launches']} != {got['want_launches']}")
            if level == "O2":
                by_path[f"train_gpt_sp_tp_{pattern}"] = sp_tp[0][
                    f"{pattern}_O2"]["launches"]
    (OUT_DIR / "train_sp_compose.json").write_text(json.dumps(
        {"dense": dense, "ranks": ranks, "sp_tp": sp_tp,
         "dense_seconds": dense_s, "ranks_seconds": ranks_s,
         "sp_tp_seconds": sp_tp_s}, indent=1, default=str))
    emit("train_sp_compose", dense_seconds=dense_s, ranks_seconds=ranks_s,
         sp_tp_seconds=sp_tp_s)
    return by_path


T_TP, T_PP, T_M = 2, 2, 4      # (a), (b): dp 1 x tp 2 x pp 2; (c) dp 2 x pp 2
T_O0_STEPS, T_O2_STEPS, T_ZERO_STEPS = 2, 2, 3
T_ZERO_BATCH, T_ZERO_SEQ = 16, 128   # (c): the rows of a data index
T_TOL = 1e-4              # O0 against one process: losses relative,
                          # step-1 grads (b: wte's) scale-aware
T_SCHED_TOL = 1e-5        # GPipe against 1F1B: params after step 1
T_ZERO_PARAM_TOL = 1e-5   # (c): the fp32 params after the last step,
                          # ZeRO against replicated, scale-aware
T_ZERO_PARAMS = re.compile(PP_GRADS.pattern + r"|word_embeddings|"
                           r"mlm_decoder")
T_PREDICTION = {
    "a_losses_O0": "GPipe and 1F1B within 1e-4 relative of the dense "
                   "process, step-1 gradients within 1e-4 scale-aware "
                   "(measured error 1e-7 to 1e-6, as train_pp's --pp 2 and "
                   "train_sp_compose's); GPipe against 1F1B params after "
                   "step 1 within 1e-5",
    "a_O2": "within 2e-2 of dense O2 every step",
    "a_step_ms_O2": "GPipe 1500-4000, 1F1B 1800-5000: each layer's two "
                    "row-parallel all-reduces a microbatch forward and two "
                    "column-parallel ones backward (~8 MB bf16 each, 96 a "
                    "step a rank for 12 layers x 4 microbatches) through "
                    "the host beside the pipe hops; four processes share "
                    "the card",
    "a_peak_gb_rank_O2": "7-11: half of a stage's 12 layers' weights, "
                         "grads and LAMB moments (~1.9 GB of train_pp's "
                         "--pp 2 rank's 13.1), the vocab-parallel decoder "
                         "and embeddings halved, the activations of 8 heads "
                         "a rank; the four 28-44 of 80",
    "a_launches": "exact, train_pp's formula at M 4 and 12 layers a stage "
                  "(B2 = B3 = 1 + 2*12*4 + 1 = 98 under GPipe, B4-B6 48): "
                  "TP changes no kernel count, only the heads a launch",
    "b_gpt": "1F1B loss within 1e-4 relative of the dense lm_loss, the "
             "rank's vocab rows of the tied wte gradient within 1e-4 "
             "scale-aware; launches exact (train_pp's GPT formula)",
    "c_zero_O2": "ZeRO over FusedLAMB within 1e-5 of the replicated-state "
                 "run every step (the same bf16 forward; only the trust "
                 "norms' summation order differs; gate 2e-2); LAMB's m and "
                 "v a rank about half of the replicated run's (each leaf "
                 "over 256 elements cut over the 2 data ranks), the peak "
                 "a rank 1-2 GB lower",
    "c_zero_params": "the fp32 params after step 3 (the first and last "
                     "layer of the stage, the word embeddings, the MLM "
                     "decoder, the LNs and heads) within 1e-7 scale-aware "
                     "of the replicated run's, most leaves bit for bit "
                     "(gate 1e-5)",
    "kernels": "B4 at 4x512x8x64 (BERT-large's microbatch, 8 heads a rank) "
               "~0.02 ms, 1.4-1.7x SDPA as at pp Ulysses' same shape; "
               "2x1024x6x64 causal (GPT-2 small) ~0.015 ms",
    "phase_s": "120-220",
}


def _tp_pp_bert_build(level, m_batch=T_M, mesh_kw=None, zero=False,
                      seed0=None):
    """A rank's ``PipelinedBert`` of BERT-large with TP inside the pipeline
    (``mesh_kw`` the mesh: dp 1 x pp 2 x tp 2 by default), flash
    attention, seed 0, under amp ``level`` with the BERT recipe's
    FusedLAMB: its clipping norm over the pipe and model groups, its
    trust-ratio norms of the model-split leaves over the model group
    (``with_tensor_parallel``), the overflow flag over both; ``zero``:
    ZeRO-1 of LAMB's moments over the data group, ``like_params`` the
    model's places; ``seed0``: BERT-large's seed-0 weights on the card
    (``_spawn_seed0``), whose part for the rank's (pipe, model) place
    the build loads instead of drawing them.  Returns the build function
    ``_compose_run`` takes."""
    def build():
        from apex_tpu_torch import amp, parallel
        from apex_tpu_torch.examples import bert_main_amp
        from apex_tpu_torch.models import PipelinedBert
        from apex_tpu_torch.models.bert import dense_to_rank
        from apex_tpu_torch.ops import make_flash_attention
        mesh = parallel.create_mesh(**(mesh_kw or dict(pp=T_PP, tp=T_TP)))
        tp = mesh.shape["model"] > 1
        cfg = bert_main_amp.get_config("large")
        module = PipelinedBert(
            cfg, mesh, mesh.shape["pipe"], m_batch, batch_axis="data",
            tp_axis="model" if tp else None,
            attention_fn=make_flash_attention(), device="cuda",
            seed=None if seed0 is not None else 0)
        if seed0 is not None:
            module.load_state_dict(dense_to_rank(
                seed0, cfg, mesh.shape["pipe"], mesh.index("pipe"),
                mesh.shape["model"], mesh.index("model")))
        lamb = bert_main_amp.make_optimizer().with_model_parallel(
            mesh.group("pipe"), {k: k.startswith("stages.")
                                 for k, _ in module.named_parameters()})
        if tp:
            lamb = lamb.with_tensor_parallel(
                mesh.group("model"),
                {k: "model" in v for k, v in module.param_spec_tree()
                 .items()})
        places = module.tp_places()
        model, opt = amp.initialize(module, lamb, opt_level=level,
                                    verbosity=0)
        opt = opt.with_overflow_groups(mesh.group("pipe"),
                                       mesh.group("model"))
        params = model.init()
        st = opt.init(params)
        if zero:
            opt = opt.with_zero(mesh.group("data"), like_params=places)
            st = parallel.shard_optimizer_state(st, mesh.group("data"),
                                                like_params=places)
        return model, opt, params, st, mesh
    return build


def _tp_pp_gpt_cfg():
    """GPT-2 small with the vocabulary padded to 128 x tp (the JAX
    example's padding under --tp), so the tied wte splits over the model
    ranks."""
    import dataclasses
    from apex_tpu_torch.models import gpt_small
    from apex_tpu_torch.models.gpt import padded_vocab
    return dataclasses.replace(gpt_small(),
                               vocab_size=padded_vocab(50257, T_TP))


def _tp_pp_dense():
    """One process's dense runs: BERT-large O0 and O2 at B 16, S 512
    (``_bert_large_dense``, the step-1 gradients written for the ranks);
    the padded GPT-2 small's lm_loss and wte gradient at B 8, S 1024."""
    import torch
    from apex_tpu_torch.models import GPTLMHeadModel
    from apex_tpu_torch.models.gpt import lm_loss
    from apex_tpu_torch.ops import make_flash_attention
    out = _bert_large_dense()
    cfg = _tp_pp_gpt_cfg()
    model = GPTLMHeadModel(cfg, make_flash_attention(causal=True),
                           device="cuda", seed=0)
    ids = torch.from_numpy(next(_t_gpt_batches())).cuda()
    loss = lm_loss(model(ids), ids)
    (wte,) = torch.autograd.grad(loss, [model.wte.weight])
    out["gpt"] = {"loss": float(loss)}
    torch.save({"wte": wte.detach().cpu()}, OUT_DIR / "t_gpt.pt")
    del model, wte
    torch.cuda.empty_cache()
    return out


def _t_gpt_batches():
    from apex_tpu_torch.examples import gpt_main_amp
    return gpt_main_amp.batches(50257, TRAIN_BATCH, TRAIN_SEQ)


def _state_bytes(st):
    import torch
    inner = st.inner
    return sum(t.numel() * t.element_size() for t in
               torch.utils._pytree.tree_leaves((inner.m, inner.v)))


def _tp_pp_rank_legs(rank, seed0):
    """(a), (b) and (c) on this rank: (a), (b) on the (1, pp 2, tp 2)
    mesh, (c) on (dp 2, pp 2); ``seed0``: BERT-large's seed-0 weights on
    the card (``_spawn_seed0``), whose stage (and, under TP, slice of it)
    every BERT build loads."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import PipelinedGPT
    from apex_tpu_torch.ops import make_flash_attention
    cfg = bert_main_amp.get_config("large")
    mesh0 = parallel.create_mesh(pp=T_PP, tp=T_TP)
    pipe, m = mesh0.index("pipe"), mesh0.index("model")
    lps, last = BERT_LAYERS // T_PP, pipe == T_PP - 1
    out = {"coords": [0, pipe, m]}

    def data():
        return bert_main_amp.batches(cfg, CB_BATCH, CB_SEQ)

    # (a)
    params1 = {}
    for schedule in ("gpipe", "1f1b"):
        res, grads1, params1[schedule] = _compose_run(
            _tp_pp_bert_build("O0", seed0=seed0), schedule, data(),
            T_O0_STEPS, keep_params=True)
        res["step1_grad_err"] = _pp_grad_err(
            grads1, OUT_DIR / BERT_DENSE_GRADS, T_PP, pipe, T_TP, m)
        res["want_launches"] = _pp_launches(
            res["launches"], lps, T_M, schedule, last, T_O0_STEPS)
        out[f"{schedule}_O0"] = res
        del grads1
        res, _, _ = _compose_run(_tp_pp_bert_build("O2", seed0=seed0),
                                 schedule, data(), T_O2_STEPS)
        res["want_launches"] = _pp_launches(
            res["launches"], lps, T_M, schedule, last, T_O2_STEPS)
        out[f"{schedule}_O2"] = res
    out["sched_param_err"] = max(
        scale_aware_err(params1["1f1b"][k].cuda(),
                        params1["gpipe"][k].cuda())[0]
        for k in params1["gpipe"])
    out["param_shapes"] = {k: list(v.shape) for k, v in
                           params1["gpipe"].items() if PP_GRADS.search(k)}
    del params1
    torch.cuda.empty_cache()
    # (b): GPT-2 small's PipelinedGPT, 1F1B, O0
    gcfg = _tp_pp_gpt_cfg()
    ids = torch.from_numpy(next(_t_gpt_batches())).cuda()
    dense = torch.load(OUT_DIR / "t_gpt.pt")
    model = PipelinedGPT(gcfg, mesh0, T_PP, T_M, tp_axis="model",
                         attention_fn=make_flash_attention(causal=True),
                         device="cuda", seed=0)
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, grads = model.loss_and_grad_1f1b(ids, ids)
    loss = float(loss)
    seconds = time.perf_counter() - t0
    counts = launch_counts()
    rows = gcfg.vocab_size // T_TP
    out["gpt"] = {"loss": loss, "seconds": seconds, "launches": counts,
                  "want_launches": _gpt_pp_launches(counts, 12 // T_PP, T_M,
                                                    last),
                  "wte_grad_err": scale_aware_err(
                      grads["embed.wte.weight"],
                      dense["wte"][m * rows:(m + 1) * rows].cuda())[0]}
    del model, grads, dense
    torch.cuda.empty_cache()
    # (c): ZeRO over FusedLAMB at dp 2 x pp 2, O2, GPipe
    mesh = parallel.create_mesh(pp=T_PP)
    d = mesh.index("data")
    zero, final = {}, {}
    for cut in (False, True):
        batches = (tuple(a[d * T_ZERO_BATCH:(d + 1) * T_ZERO_BATCH]
                         for a in b) for b in bert_main_amp.batches(
                             cfg, 2 * T_ZERO_BATCH, T_ZERO_SEQ))
        build = _tp_pp_bert_build("O2", mesh_kw=dict(pp=T_PP), zero=cut,
                                  seed0=seed0)
        state = {}

        def keep_bytes(build=build):
            made = build()
            state["bytes"] = _state_bytes(made[3])
            return made
        res, _, final[cut] = _compose_run(keep_bytes, "gpipe", batches,
                                          T_ZERO_STEPS,
                                          keep_final=T_ZERO_PARAMS)
        res["state_bytes"] = state["bytes"]
        res["want_launches"] = _pp_launches(
            res["launches"], lps, T_M, "gpipe", mesh.index("pipe") == 1,
            T_ZERO_STEPS)
        zero["zero" if cut else "replicated"] = res
    out["zero"] = zero
    out["zero_coords"] = [d, mesh.index("pipe")]
    out["zero_params"] = {
        "leaves": len(final[False]),
        "elements": sum(v.numel() for v in final[False].values()),
        "bitwise": sum(torch.equal(final[True][k], v)
                       for k, v in final[False].items()),
        "err": max(scale_aware_err(final[True][k], v)[0]
                   for k, v in final[False].items())}
    return out


def _tp_pp_rank(rank, world, store, seed0):
    """(a)-(c)'s ranks: gloo on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _tp_pp_rank_legs(rank, seed0)
        seed0.clear()       # the shared blocks released (see _moe_rank)
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"tp_pp_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_train_tp_pp():
    """Tensor parallelism inside the pipeline and ZeRO over FusedLAMB,
    four processes over gloo on the one card: (a) BERT-large
    PipelinedBert at dp 1 x tp 2 x pp 2, GPipe and 1F1B, O0 and O2, (b)
    GPT-2 small's PipelinedGPT at tp 2 x pp 2 under 1F1B, (c) ZeRO over
    FusedLAMB on BERT-large at dp 2 x pp 2, O2, against the
    replicated-state run; (a), (b) against one dense process."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    emit("train_tp_pp", prediction=T_PREDICTION)
    t0 = time.perf_counter()
    files = ("t_gpt.pt",)
    try:
        dense = _tp_pp_dense()
        dense_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranks = _spawn_seed0(_tp_pp_rank, T_TP * T_PP, "tp_pp")
        ranks_s = time.perf_counter() - t0
    finally:
        for f in files:
            (OUT_DIR / f).unlink(missing_ok=True)
    by_path, peaks = {}, {}
    tokens = CB_BATCH * CB_SEQ
    # (a)
    for schedule in ("gpipe", "1f1b"):
        for level, tol in (("O0", T_TOL), ("O2", O2_LOSS_TOL)):
            want = dense[f"bert_{level}"]
            steps = T_O0_STEPS if level == "O0" else T_O2_STEPS
            for r, res in enumerate(ranks):
                got = res[f"{schedule}_{level}"]
                err = max((abs(a - b) / abs(b) if level == "O0"
                           else abs(a - b))
                          for a, b in zip(got["losses"], want["losses"]))
                peaks.setdefault(f"{schedule}_{level}", []).append(
                    got["peak_memory_gb"])
                emit("train_tp_pp", run=f"(a) BERT-large PipelinedBert tp 2 "
                     f"x pp 2 {schedule} {level}", rank=r,
                     coords=res["coords"], batch=CB_BATCH, seq=CB_SEQ,
                     microbatches=T_M, losses=got["losses"],
                     dense_losses=want["losses"], loss_err=err, tol=tol,
                     step1_grad_err=got.get("step1_grad_err"),
                     step_ms=[1e3 * t for t in got["step_seconds"]],
                     dense_step_ms=[1e3 * t for t in want["step_seconds"]],
                     tokens_per_s_four=[tokens / t
                                        for t in got["step_seconds"]],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches_a_step={k: v / steps for k, v in
                                      got["launches"].items()},
                     collectives_a_step={k: v / steps for k, v in
                                         got["collectives"].items()})
                if not err <= tol:
                    raise AssertionError(f"(a) {schedule} {level} rank {r}: "
                                         f"loss error {err:.3g}")
                if level == "O0" and not got["step1_grad_err"] <= T_TOL:
                    raise AssertionError(
                        f"(a) {schedule} O0 rank {r}: step-1 grads "
                        f"{got['step1_grad_err']:.3g}")
                if got["launches"] != got["want_launches"]:
                    raise AssertionError(
                        f"(a) {schedule} {level} rank {r}: launches "
                        f"{got['launches']} != {got['want_launches']}")
            if level == "O2":
                by_path[f"train_tp_pp_{schedule}"] = ranks[0][
                    f"{schedule}_O2"]["launches"]
    emit("train_tp_pp", run="(a) peak a rank, GB, and the four's sum",
         peaks=peaks, sums={k: sum(v) for k, v in peaks.items()})
    for r, res in enumerate(ranks):
        emit("train_tp_pp", run="(a) GPipe against 1F1B, params after step "
             "1", rank=r, err=res["sched_param_err"], tol=T_SCHED_TOL,
             param_shapes=res["param_shapes"])
        if not res["sched_param_err"] <= T_SCHED_TOL:
            raise AssertionError(f"(a) GPipe against 1F1B rank {r}: "
                                 f"{res['sched_param_err']:.3g}")
    # (b)
    for r, res in enumerate(ranks):
        got = res["gpt"]
        err = abs(got["loss"] - dense["gpt"]["loss"]) / abs(
            dense["gpt"]["loss"])
        emit("train_tp_pp", run="(b) GPT-2 small PipelinedGPT tp 2 x pp 2, "
             "1F1B, O0", rank=r, coords=res["coords"], batch=TRAIN_BATCH,
             seq=TRAIN_SEQ, microbatches=T_M, loss=got["loss"],
             dense_loss=dense["gpt"]["loss"], loss_err=err,
             wte_grad_err=got["wte_grad_err"],
             onef1b_ms=1e3 * got["seconds"], launches=got["launches"])
        if not (err <= T_TOL and got["wte_grad_err"] <= T_TOL):
            raise AssertionError(f"(b) rank {r}: loss {err:.3g}, wte "
                                 f"{got['wte_grad_err']:.3g}")
        if got["launches"] != got["want_launches"]:
            raise AssertionError(f"(b) rank {r}: launches "
                                 f"{got['launches']} != "
                                 f"{got['want_launches']}")
    by_path["train_tp_pp_gpt"] = ranks[0]["gpt"]["launches"]
    # (c)
    for r, res in enumerate(ranks):
        rep, cut = res["zero"]["replicated"], res["zero"]["zero"]
        err = max(abs(a - b) for a, b in zip(cut["losses"], rep["losses"]))
        emit("train_tp_pp", run="(c) ZeRO over FusedLAMB, BERT-large dp 2 x "
             "pp 2, GPipe, O2, against the replicated state", rank=r,
             coords=res["zero_coords"], batch=T_ZERO_BATCH, seq=T_ZERO_SEQ,
             microbatches=T_M, losses=cut["losses"],
             replicated_losses=rep["losses"], loss_err=err,
             tol=O2_LOSS_TOL, state_bytes=cut["state_bytes"],
             replicated_state_bytes=rep["state_bytes"],
             peak_memory_gb=cut["peak_memory_gb"],
             replicated_peak_memory_gb=rep["peak_memory_gb"],
             step_ms=[1e3 * t for t in cut["step_seconds"]],
             replicated_step_ms=[1e3 * t for t in rep["step_seconds"]],
             collectives_a_step={k: v / T_ZERO_STEPS for k, v in
                                 cut["collectives"].items()})
        emit("train_tp_pp", run="(c) fp32 params after the last step, ZeRO "
             "against replicated", rank=r, tol=T_ZERO_PARAM_TOL,
             **res["zero_params"])
        if not err <= O2_LOSS_TOL:
            raise AssertionError(f"(c) rank {r}: loss error {err:.3g}")
        if not res["zero_params"]["err"] <= T_ZERO_PARAM_TOL:
            raise AssertionError(f"(c) rank {r}: params after the last "
                                 f"step {res['zero_params']['err']:.3g}")
        if not cut["state_bytes"] < 0.6 * rep["state_bytes"]:
            raise AssertionError(f"(c) rank {r}: state bytes "
                                 f"{cut['state_bytes']} of "
                                 f"{rep['state_bytes']}")
        for run in (rep, cut):
            if run["launches"] != run["want_launches"]:
                raise AssertionError(f"(c) rank {r}: launches "
                                     f"{run['launches']} != "
                                     f"{run['want_launches']}")
    by_path["train_zero_lamb"] = ranks[0]["zero"]["zero"]["launches"]
    (OUT_DIR / "train_tp_pp.json").write_text(json.dumps(
        {"dense": dense, "ranks": ranks, "dense_seconds": dense_s,
         "ranks_seconds": ranks_s}, indent=1, default=str))
    emit("train_tp_pp", dense_seconds=dense_s, ranks_seconds=ranks_s)
    return by_path


# -- train_moe ----------------------------------------------------------------

# BERT-large with Switch-MoE layers: (a) one process, --moe 8 --moe-dispatch
# capacity (factor 1.25) at B 32, S 128, O2; its O0 forwards at B 16;
# (b) --pp 2 at M 4, O0, both dispatches and schedules; (c) EP at ep 2,
# one MoE layer at BERT-large width, both dispatches; (b) and (c) in one
# world of two gloo processes
M_E, M_CF = 8, 1.25
M_O2_STEPS = 3
M_O0_BATCH = 16           # (a)'s O0 forwards and (b)'s batch
M_PP, M_M, M_PP_STEPS = 2, 4, 2
M_EP = 2
M_LOGIT_TOL = 1e-5        # (a) capacity at factor E against dense:
M_AUX_TOL = 1e-6          # logits scale-aware, aux relative; (c)'s aux
M_LOSS_TOL = 1e-5         # (b) 1F1B against GPipe: losses relative,
M_RTOL, M_ATOL = 3e-4, 1e-5   # every step-1 gradient (test_pipeline.py:976)
M_PP_LOGIT_TOL = 1e-4     # (b) GPipe's dense logits against (a)'s
M_EP_TOL = 1e-5           # (c) EP against the replicated layer: out and
                          # gradients, scale-aware
M_LOGITS = "moe_dense_logits.pt"
M_PREDICTION = {
    "a_O2_step_ms": "350-700 at B 32, S 128: BERT-large's dense O2 step "
                    "(170-190 ms) with 1.25x its MLP FLOPs in (8, 640, "
                    "H/F) bmm, the capacity dispatch's gathers and "
                    "scatter-add, and FusedLAMB's passes over 1.71B "
                    "parameters in place of 0.34B",
    "a_tokens_per_s": "6k-12k",
    "a_peak_gb": "40-60: 1.71B fp32 masters, their fp32 grads and "
                 "LAMB's m and v (27 GB), the bf16 compute copies, "
                 "LAMB's temporaries",
    "a_launches": "exact, train_bert's formula without dropout: B2 = "
                  "B3 = 50, B4-B6 24 a step; MoE adds none",
    "a_O0_capacity_vs_dense": "logits within 1e-6 scale-aware (the same "
                              "routing at every layer; only the experts' "
                              "GEMM shapes differ), aux within 1e-7",
    "a_device_split": "gemm 50-70% of the busy time, gather/scatter "
                      "2-8%, multi-tensor (LAMB) 10-30%",
    "b_sched": "1F1B against GPipe: losses within 1e-7 relative, "
               "gradients within 1e-6 of rtol 3e-4 / atol 1e-5's bound, "
               "stage 0's router gradient nonzero for both dispatches",
    "b_logits": "GPipe's dense-dispatch logits within 1e-6 of (a)'s",
    "b_step_ms": "O0 fp32: dense dispatch 2000-6000 (8x the MLP FLOPs on "
                 "the CUDA cores), capacity 800-2500",
    "c_ep": "out within 1e-6 scale-aware, aux within 1e-7, gradients "
            "within 1e-6; expert bytes a rank 134 of 268 MB",
    "phase_s": "90-150",
}


def _moe_cfg(dispatch, capacity_factor=M_CF):
    import dataclasses
    from apex_tpu_torch.examples import bert_main_amp
    return dataclasses.replace(bert_main_amp.get_config("large"),
                               moe_experts=M_E, moe_dispatch=dispatch,
                               moe_capacity_factor=capacity_factor)


def _moe_o2(dense):
    """(a) O2: ``bert_main_amp.build`` and ``train_step`` (what its
    ``train`` runs) for --moe 8 --moe-dispatch capacity at B 32, S 128,
    flash attention, from the seed-0 weights of ``dense`` (the O0 model,
    released once they are copied), counts at 0 just before the steps
    and read just after; the compute layout; one more step under the
    profiler."""
    import torch
    from apex_tpu_torch._kernels import launch_counts, reset_launch_counts
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.ops import make_flash_attention
    cfg = _moe_cfg("capacity")
    t0 = time.perf_counter()
    model, opt, params, st = bert_main_amp.build(
        cfg, opt_level="O2", attention_fn=make_flash_attention(),
        device="cuda", state_dict=dense.state_dict())
    dense.to("meta")
    # the blocks (b)'s ranks mapped are freed once their handles are
    # collected
    torch.cuda.ipc_collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    data = bert_main_amp.batches(cfg, BERT_BATCH, BERT_SEQ)
    batches = [tuple(torch.from_numpy(a).cuda() for a in next(data))
               for _ in range(M_O2_STEPS + 1)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, seconds = [], []
    for i in range(M_O2_STEPS):
        t0 = time.perf_counter()
        params, st, loss, _ = bert_main_amp.train_step(model, opt, params,
                                                       st, batches[i])
        losses.append(float(loss))
        seconds.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: M_O2_STEPS * v for k, v in
            _bert_per_step_launches(cfg, counts, dropout=False).items()}
    compute = model.compute_variables(params)
    layout = {k: str(compute[f"encoder.layer_0.moe.{k}"].dtype)
              for k in ("router.weight", "router.bias", "experts_in",
                        "experts_out")}
    del compute
    n_params = sum(p.numel() for p in params.values())
    state = {"params": params, "st": st}

    def one_step():
        state["params"], state["st"], _, _ = bert_main_amp.train_step(
            model, opt, state["params"], state["st"], batches[-1])

    prof = _profile("train_moe (a) O2 step", one_step, batch=BERT_BATCH,
                    seq=BERT_SEQ)
    del model, opt, params, st, state, batches
    torch.cuda.empty_cache()
    return {"losses": losses, "step_seconds": seconds, "build_s": build_s,
            "tokens_per_s": [BERT_BATCH * BERT_SEQ / t for t in seconds],
            "peak_memory_gb": peak_gb, "launches": counts,
            "want_launches": want, "layout": layout, "params": n_params,
            "profile": {k: prof.get(k) for k in (
                "wall_ms", "device_busy_ms", "device_idle_share",
                "kernel_launches", "by_class_ms", "top_kernels_ms",
                "device_time")}}


def _moe_o0_forwards():
    """(a) O0 at B 16: one forward of the seed-0 model in dense dispatch
    and one in capacity dispatch at factor E (nothing can drop), the same
    weights; the dense MLM logits saved for (b).  Returns the readings
    and the dense model (its weights start (a)'s O2 run)."""
    import torch
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models import BertForPreTraining
    from apex_tpu_torch.ops import make_flash_attention
    ids = torch.from_numpy(next(bert_main_amp.batches(
        _moe_cfg("dense"), M_O0_BATCH, BERT_SEQ))[0]).cuda()
    t0 = time.perf_counter()
    dense = BertForPreTraining(_moe_cfg("dense"), make_flash_attention(),
                               device="cuda", seed=0)
    sparse = BertForPreTraining(_moe_cfg("capacity", float(M_E)),
                                make_flash_attention(), device="cuda",
                                seed=None)
    sparse.load_state_dict(dense.state_dict())
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        t0 = time.perf_counter()
        mlm_d, nsp_d, aux_d = dense(ids)
        torch.cuda.synchronize()
        dense_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        mlm_c, nsp_c, aux_c = sparse(ids)
        torch.cuda.synchronize()
        capacity_ms = 1e3 * (time.perf_counter() - t0)
    del sparse
    out = {"logit_err": scale_aware_err(mlm_c, mlm_d)[0],
           "nsp_err": scale_aware_err(nsp_c, nsp_d)[0],
           "aux_dense": float(aux_d), "aux_capacity": float(aux_c),
           "aux_rel_err": abs(float(aux_c) - float(aux_d))
           / abs(float(aux_d)),
           "finite": bool(torch.isfinite(mlm_d).all()
                          and torch.isfinite(mlm_c).all()),
           "dense_forward_ms": dense_ms,
           "capacity_forward_ms": capacity_ms, "build_s": build_s}
    torch.save(mlm_d.cpu(), OUT_DIR / M_LOGITS)
    del mlm_d, mlm_c
    torch.cuda.empty_cache()
    return out, dense


def _moe_ep(rank):
    """(c) one MoE layer at BERT-large width (E 8, H 1024, F 4096, B 32 x
    S 128 tokens) at ep 2 against the replicated layer on this rank, both
    dispatches: out, aux and the gradients of x, the router and this
    rank's experts of a weighted sum of out and aux."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.models import MoEMlp
    from apex_tpu_torch.models.moe import EXPERT_LEAVES
    group = parallel.ProcessGroup()
    gen = torch.Generator().manual_seed(1)
    shape = (BERT_BATCH, BERT_SEQ, BERT_HIDDEN)
    x = torch.randn(shape, generator=gen).cuda()
    w = torch.randn(shape, generator=gen).cuda()
    out = {}
    for dispatch in ("dense", "capacity"):
        res, ms = {}, {}
        for label, ep in (("whole", None), ("ep", group)):
            mod = MoEMlp(M_E, BERT_HIDDEN, 4 * BERT_HIDDEN, dispatch, M_CF,
                         device="cuda", ep=ep, seed=0)
            names = [n for n, _ in mod.named_parameters()]
            for _ in range(2):      # the second one timed
                xg = x.clone().requires_grad_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o, a = mod(xg)
                g = torch.autograd.grad((o * w).sum() + 0.37 * a,
                                        [xg] + list(mod.parameters()))
                torch.cuda.synchronize()
                ms[label] = 1e3 * (time.perf_counter() - t0)
            res[label] = {"out": o.detach(), "aux": float(a), "gx": g[0],
                          "grads": dict(zip(names, g[1:])),
                          "bytes": sum(p.numel() * p.element_size()
                                       for n, p in mod.named_parameters()
                                       if n in EXPERT_LEAVES)}
            del mod
        whole, ep = res["whole"], res["ep"]
        el = M_E // M_EP
        grad_err = {}
        for k, gv in ep["grads"].items():
            want = whole["grads"][k]
            if k in EXPERT_LEAVES:
                want = want[rank * el:(rank + 1) * el]
            grad_err[k] = scale_aware_err(gv, want)[0]
        out[dispatch] = {
            "out_err": scale_aware_err(ep["out"], whole["out"])[0],
            "aux_rel_err": abs(ep["aux"] - whole["aux"]) / abs(whole["aux"]),
            "gx_err": scale_aware_err(ep["gx"], whole["gx"])[0],
            "grad_err": grad_err,
            "router_grad_max": float(ep["grads"]["router.weight"]
                                     .abs().max()),
            "expert_bytes": ep["bytes"], "whole_expert_bytes": whole["bytes"],
            "fwd_bwd_ms": ms}
        del res, whole, ep
        torch.cuda.empty_cache()
    return out


def _moe_rank_legs(rank, seed0):
    """(b) and (c) on this rank of the world of two; ``seed0``: the
    seed-0 weights of (a)'s O0 model on the card (``_spawn_seed0``),
    whose stage every build loads."""
    import torch
    from apex_tpu_torch import parallel
    from apex_tpu_torch.examples import bert_main_amp
    from apex_tpu_torch.models.bert import dense_to_rank
    from apex_tpu_torch.ops import make_flash_attention
    mesh0 = parallel.create_mesh(pp=M_PP)
    pipe = mesh0.index("pipe")
    lps, last = BERT_LAYERS // M_PP, pipe == M_PP - 1
    state, out = {}, {"pipe": pipe}
    ids = torch.from_numpy(next(bert_main_amp.batches(
        _moe_cfg("dense"), M_O0_BATCH, BERT_SEQ))[0]).cuda()

    def make_build(dispatch, logits=False):
        def build():
            mesh = parallel.create_mesh(pp=M_PP)
            cfg = _moe_cfg(dispatch)
            made = bert_main_amp.build(
                cfg, opt_level="O0", attention_fn=make_flash_attention(),
                device="cuda", state_dict=dense_to_rank(seed0, cfg, M_PP,
                                                        pipe),
                mesh=mesh, pp_microbatches=M_M)
            if logits:
                # GPipe's dense logits at the seed's weights
                with torch.no_grad():
                    mlm = made[0].apply(made[2], ids)[0]
                    want = torch.load(OUT_DIR / M_LOGITS).cuda()
                    state["logit_err"] = scale_aware_err(mlm, want)[0]
                del mlm, want
            return made + (mesh,)
        return build

    def data():
        return bert_main_amp.batches(_moe_cfg("dense"), M_O0_BATCH,
                                     BERT_SEQ)

    for dispatch in ("dense", "capacity"):
        runs, grads = {}, {}
        for schedule in ("gpipe", "1f1b"):
            res, grads[schedule], _ = _pp_run(
                make_build(dispatch, logits=(dispatch, schedule) == (
                    "dense", "gpipe")), schedule, data(), M_PP_STEPS)
            res["want_launches"] = _pp_launches(
                res["launches"], lps, M_M, schedule, last, M_PP_STEPS)
            runs[schedule] = res
        worst, bad = 0.0, []
        for k, g in grads["1f1b"].items():
            a, b = g.cuda(), grads["gpipe"][k].cuda()
            ratio = float(((a - b).abs() / (M_ATOL + M_RTOL * b.abs()))
                          .max())
            worst = max(worst, ratio)
            if ratio > 1.0:
                bad.append(k)
            del a, b
        routers = {k: [float(grads[s][k].abs().max()) for s in grads]
                   for k in grads["gpipe"] if k.endswith("router.weight")}
        runs["grad_bound_ratio"] = worst
        runs["grads_out_of_bound"] = bad[:8]
        runs["router_grad_max"] = routers
        runs["loss_rel_err"] = max(
            abs(a - b) / abs(b) for a, b in zip(runs["1f1b"]["losses"],
                                                runs["gpipe"]["losses"]))
        out[dispatch] = runs
        del grads
        torch.cuda.empty_cache()
    out["logit_err"] = state["logit_err"]
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["ep"] = _moe_ep(rank)
    out["ep_seconds"] = time.perf_counter() - t0
    return out


def _moe_rank(rank, world, store, seed0):
    """(b)-(c)'s ranks: gloo on CUDA tensors, TF32 off."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        out = _moe_rank_legs(rank, seed0)
        # release the shared blocks now (the spawned process's own
        # arguments hold this dict to the end): the producer frees them
        # only once every consumer has
        seed0.clear()
        out["seconds"] = time.perf_counter() - t0
        (OUT_DIR / f"moe_rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def phase_train_moe():
    """Switch-MoE: (a) BERT-large --moe 8 --moe-dispatch capacity in one
    process, O2, and its O0 capacity-at-E forward against dense; (b)
    --moe 8 --pp 2 1F1B against GPipe, both dispatches, and (c) EP at ep
    2, as two processes over gloo on the one card."""
    import gc
    import torch
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    emit("train_moe", prediction=M_PREDICTION)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    # what the earlier phases leave on the card: (b)'s two ranks share it
    emit("train_moe", main_process_allocated_gb=torch.cuda
         .memory_allocated() / 1e9, main_process_reserved_gb=torch.cuda
         .memory_reserved() / 1e9)
    try:
        t0 = time.perf_counter()
        fwd, dense = _moe_o0_forwards()
        a_o0_s = time.perf_counter() - t0
        # (b) and (c) before (a)'s O2 run: the ranks load their stages of
        # the seed-0 weights from this model, which stays on the card
        # until they end, instead of drawing 1.78B normals each
        t0 = time.perf_counter()
        ranks = _spawn_seed0(_moe_rank, M_PP, "moe", dense.state_dict())
        ranks_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        a = _moe_o2(dense)
        del dense
        a_o2_s = time.perf_counter() - t0
    finally:
        (OUT_DIR / M_LOGITS).unlink(missing_ok=True)
    by_path = {"train_moe": a["launches"]}
    tokens = BERT_BATCH * BERT_SEQ
    # (a)
    emit("train_moe", run="(a) BERT-large --moe 8 --moe-dispatch capacity "
         "O2", batch=BERT_BATCH, seq=BERT_SEQ, capacity_factor=M_CF,
         params=a["params"], losses=a["losses"],
         step_ms=[1e3 * t for t in a["step_seconds"]],
         tokens_per_s=a["tokens_per_s"], peak_memory_gb=a["peak_memory_gb"],
         build_s=a["build_s"], layout=a["layout"], launches=a["launches"])
    emit("train_moe", run="(a) O2 step, device time by class",
         **a["profile"])
    if not all(np.isfinite(a["losses"])):
        raise AssertionError(f"(a) non-finite loss {a['losses']}")
    if a["launches"] != a["want_launches"]:
        raise AssertionError(f"(a) launches {a['launches']} != "
                             f"{a['want_launches']}")
    if a["layout"] != {"router.weight": "torch.float32",
                       "router.bias": "torch.float32",
                       "experts_in": "torch.bfloat16",
                       "experts_out": "torch.bfloat16"}:
        raise AssertionError(f"(a) compute layout {a['layout']}")
    emit("train_moe", run="(a) O0 capacity at factor E against dense",
         batch=M_O0_BATCH, seq=BERT_SEQ, **fwd, logit_tol=M_LOGIT_TOL,
         aux_tol=M_AUX_TOL)
    if not (fwd["finite"] and fwd["logit_err"] <= M_LOGIT_TOL
            and fwd["aux_rel_err"] <= M_AUX_TOL):
        raise AssertionError(f"(a) capacity against dense: {fwd}")
    # (b)
    for r, res in enumerate(ranks):
        for dispatch in ("dense", "capacity"):
            runs = res[dispatch]
            for schedule in ("gpipe", "1f1b"):
                got = runs[schedule]
                emit("train_moe", run=f"(b) --moe 8 --pp 2 {dispatch} "
                     f"{schedule} O0", rank=r, pipe=res["pipe"],
                     batch=M_O0_BATCH, seq=BERT_SEQ, microbatches=M_M,
                     losses=got["losses"],
                     step_ms=[1e3 * t for t in got["step_seconds"]],
                     tokens_per_s_pair=[M_O0_BATCH * BERT_SEQ / t
                                        for t in got["step_seconds"]],
                     build_s=got["build_seconds"],
                     peak_memory_gb=got["peak_memory_gb"],
                     launches=got["launches"],
                     collectives_a_step={k: v / M_PP_STEPS for k, v in
                                         got["collectives"].items()})
                if got["launches"] != got["want_launches"]:
                    raise AssertionError(
                        f"(b) {dispatch} {schedule} rank {r}: launches "
                        f"{got['launches']} != {got['want_launches']}")
                if not all(np.isfinite(got["losses"])):
                    raise AssertionError(f"(b) {dispatch} {schedule}: "
                                         f"{got['losses']}")
            emit("train_moe", run=f"(b) 1F1B against GPipe, {dispatch}",
                 rank=r, loss_rel_err=runs["loss_rel_err"],
                 loss_tol=M_LOSS_TOL,
                 grad_bound_ratio=runs["grad_bound_ratio"],
                 rtol=M_RTOL, atol=M_ATOL,
                 router_grad_max=runs["router_grad_max"])
            if not runs["loss_rel_err"] <= M_LOSS_TOL:
                raise AssertionError(f"(b) {dispatch} rank {r}: loss "
                                     f"{runs['loss_rel_err']:.3g}")
            if runs["grads_out_of_bound"]:
                raise AssertionError(f"(b) {dispatch} rank {r}: gradients "
                                     f"{runs['grads_out_of_bound']}")
            if not runs["router_grad_max"] or not all(
                    v > 0 for vs in runs["router_grad_max"].values()
                    for v in vs):
                raise AssertionError(f"(b) {dispatch} rank {r}: a zero "
                                     "router gradient")
        emit("train_moe", run="(b) GPipe's dense logits against (a)'s",
             rank=r, err=res["logit_err"], tol=M_PP_LOGIT_TOL)
        if not res["logit_err"] <= M_PP_LOGIT_TOL:
            raise AssertionError(f"(b) rank {r}: logits "
                                 f"{res['logit_err']:.3g}")
    for schedule in ("gpipe", "1f1b"):
        by_path[f"train_moe_pp_{schedule}"] = ranks[0]["capacity"][
            schedule]["launches"]
    # (c)
    for r, res in enumerate(ranks):
        for dispatch, got in res["ep"].items():
            emit("train_moe", run=f"(c) EP at ep 2, {dispatch}", rank=r,
                 tokens=tokens, **got, tol=M_EP_TOL, aux_tol=M_AUX_TOL)
            errs = [got["out_err"], got["gx_err"],
                    *got["grad_err"].values()]
            if not (max(errs) <= M_EP_TOL
                    and got["aux_rel_err"] <= M_AUX_TOL
                    and got["router_grad_max"] > 0
                    and 2 * got["expert_bytes"]
                    == got["whole_expert_bytes"]):
                raise AssertionError(f"(c) {dispatch} rank {r}: {got}")
    seconds = {"a_o2": a_o2_s, "a_o0": a_o0_s, "ranks": ranks_s,
               "rank_legs": [res["seconds"] for res in ranks],
               "ep": [res["ep_seconds"] for res in ranks]}
    (OUT_DIR / "train_moe.json").write_text(json.dumps(
        {"a": a, "a_o0": fwd, "ranks": ranks, "seconds": seconds},
        indent=1, default=str))
    emit("train_moe", seconds=seconds)
    return by_path


PHASES = ("device", "build", "kernels", "train_resnet", "serve", "serve_q8",
          "serve_programs", "serve_features", "train", "train_bert",
          "train_gpt_remat", "train_gpt_dropout",
          "train_bert_remat", "adam_rest", "hf_bert", "train_tp_zero",
          "train_sp", "train_pp", "train_sp_compose", "train_tp_pp",
          "train_moe", "train_o1", "train_simple", "train_dcgan")


def main(phases=PHASES):
    try:
        _main(phases)
    finally:
        for f in SHARED_FILES:
            (OUT_DIR / f).unlink(missing_ok=True)


def _main(phases):
    t_start = time.perf_counter()
    name, smi_line = phase_device()
    sys.path.insert(0, str(REPO))
    import torch
    kernels = None
    seconds = {}
    if "build" in phases:
        t0 = time.perf_counter()
        phase_build()
        seconds["build"] = time.perf_counter() - t0
    if "kernels" in phases:
        t0 = time.perf_counter()
        kernels = phase_kernels()
        seconds["kernels"] = time.perf_counter() - t0
    # each main path runs with the counts at 0 just before it; a kernel
    # reports the launches of the last path that ran it (GPT training
    # under O1, then the HuggingFace BERT's forward, then FusedAdam's
    # tree layout, then BERT under remat, then GPT with dropout under
    # remat and without, then GPT under remat, then BERT's grad-accum
    # step, then BERT training, then GPT's DDP step, then GPT training,
    # then int8 serving, then serving, then the flagship's dry run);
    # train_resnet's phase drives two paths, the ResNet-50 step and
    # entry.dryrun, train's the GPT step and its DDP step, train_bert's
    # the BERT step and its grad-accum step, train_gpt_dropout's the
    # GPT step with dropout and the same under remat; train_tp_zero's
    # the --tp 2 step (rank 0's counts, read in its process), the ZeRO-1
    # GPT steps and the ZeRO-2 ones (rank 0's, each run's own);
    # train_sp's the --sp 2 ring and Ulysses steps, the long-context
    # step, BERT's ring and Ulysses steps and the ZeRO-1 --tp 2 step
    # (rank 0's, read in its process); the
    # O1 phases run last and remove their op policy at their end
    for phase, run in (("train_resnet", phase_train_resnet),
                       ("serve", phase_serve), ("serve_q8", phase_serve_q8),
                       ("serve_programs", phase_serve_programs),
                       ("serve_features", phase_serve_features),
                       ("train", phase_train),
                       ("train_bert", phase_train_bert),
                       ("train_gpt_remat", phase_train_gpt_remat),
                       ("train_gpt_dropout", phase_train_gpt_dropout),
                       ("train_bert_remat", phase_train_bert_remat),
                       ("adam_rest", phase_adam_rest),
                       ("hf_bert", phase_hf_bert),
                       ("train_tp_zero", phase_train_tp_zero),
                       ("train_sp", phase_train_sp),
                       ("train_pp", phase_train_pp),
                       ("train_sp_compose", phase_train_sp_compose),
                       ("train_tp_pp", phase_train_tp_pp),
                       ("train_moe", phase_train_moe),
                       ("train_o1", phase_train_o1),
                       ("train_simple", phase_train_simple),
                       ("train_dcgan", phase_train_dcgan)):
        if phase not in phases:
            continue
        t0 = time.perf_counter()
        by_path = run()
        seconds[phase] = time.perf_counter() - t0
        if phase not in ("train_resnet", "serve", "serve_q8",
                         "serve_programs",
                         "serve_features", "train",
                         "train_bert",
                         "train_gpt_remat", "train_gpt_dropout",
                         "train_bert_remat", "adam_rest", "hf_bert",
                         "train_tp_zero", "train_sp", "train_pp",
                         "train_sp_compose", "train_tp_pp", "train_moe"):
            by_path = {phase: by_path}
        for path, counts in by_path.items():
            for k in (kernels or {}).values():
                n = counts.get(k["name"], 0)
                k["launches_by_path"][path] = n
                if n:
                    k["launches"] = n
    if kernels is not None and set(phases) >= set(PHASES):
        idle = [k["name"] for k in kernels.values() if not k["launches"]]
        if idle:
            raise AssertionError(f"kernels no main path launched: {idle}")
    emit("done", seconds=round(time.perf_counter() - t_start, 3),
         phase_seconds={k: round(v, 3) for k, v in seconds.items()})
    print(smi_line)
    if kernels is not None:
        print(json.dumps({"kernels": [
            {key: v for key, v in k.items() if key != "variants"}
            for k in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
