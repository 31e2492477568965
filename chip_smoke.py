#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out PATH]

1. Builds every kernel of the serving, training (GPT and T5), packed
   attention, normalization and codec paths from ``apex_tpu_torch/csrc``
   with ``nvcc`` (one process per source, all at once); each kernel phase
   below starts as soon as its own source is built.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   fp32 and bf16, with the tolerance stated; times of kernel, plain version
   and the nearest library call, and each kernel's bound:
   * LayerNorm forward at the serving path's shapes (``F.layer_norm``)
     and with its mean/rstd at the training paths' (GPT's (8192, 768),
     T5's (4096 | 1024, 512)), y and the statistics bitwise over two
     launches and for 8 of the rows launched alone;
   * paged attention on its route (bf16 on the tensor cores,
     ``paged_mma_fwd``; fp32 on the CUDA cores, ``paged_attention_fwd``)
     at the serve programs' calls: decode (8 rows; 32 too), verify (8
     slots x 5 rows) and a prefill chunk (1 slot x 32 rows), full-
     precision, int8 and int4 pools (SDPA over each slot's K/V gathered
     beforehand); head_dim 80, 96 and 256 checked; the same rows as
     groups of 32, 5 and 1, and a repeat, bitwise equal;
   * the fused layer (the megakernel) for one GPT-2-124M layer, decode (8
     rows) and verify (8 x 5 rows), fp32 and bf16, fp / int8 / int4
     pools, and for one layer of the head_dim-80 and 2 x 320 GPTs and a
     32-slot verify call (160 rows): x', K, V and fp pools within
     tolerance of its plain version, quantized codes and scales equal to
     the plain codec's write of its K/V, two launches bitwise equal, a
     slot launched alone bitwise equal to its rows in the call, the
     shared memory the gate counts equal to the kernel's; timed beside
     the plain version and the per-op layer (no single PyTorch call
     computes a layer); its ptxas lines and SASS ``HMMA`` counts (every
     bf16 instantiation has some, no fp32 one);
   * LayerNorm backward at the same training shapes, with a bitwise
     repeat check of dW/dB (autograd through ``F.layer_norm``);
   * RMSNorm forward and backward at GPT-2-124M's training rows (8192,
     768), T5-small's (4096, 512) and a wide row (2048, 12288), x and
     weight as fp32/fp32, bf16/bf16 and bf16/fp32, and LayerNorm with a
     bf16 x and an fp32 weight and at hidden 12,288: within tolerance of
     the plain versions, the forward bitwise over two launches and for 8
     of the rows alone, the backward bitwise over two launches
     (``F.rms_norm`` / ``F.layer_norm``); then the normalization main
     path: ``MixedFusedRMSNorm``, ``FusedRMSNorm`` (bf16 params) and
     ``MixedFusedLayerNorm`` forward + backward on bf16 batches, one
     launch of each kernel (counts reset just before, read just after);
   * the codec at GPT-2-124M's gradient as one flat buffer (124,477,440
     elements), fp32 and bf16, int8 (block 256) and int4 (group 128, the
     nibbles packed and unpacked in the kernels), nearest and
     stochastic: codes, scales and dequantized values bitwise the plain
     versions' (no single PyTorch call computes the codec), each kernel
     timed alone and through its public entry point; then the codec main
     path, ``quantize_blockwise`` + ``dequantize_blockwise`` and the int4
     pair through the public entry points, one launch each, the round
     trip within half a step (one step stochastic), the pair's time;
   * flash attention forward, dQ and dK/dV at GPT's flagship shape (8 x
     12 heads, 1024, 64) causal, at a non-causal and at a dropout shape,
     and with a bias, beside the d(bias) kernel, at T5-small's: the
     encoder's (8 x 8 heads, 512, 64) with an fp32 (8, 512, 512) bias,
     the decoder's causal (.., 128, ..) with an (8, 128, 128) bias, and
     the rectangular cross-attention 128 x 512 without one; d(bias)
     bitwise equal over two launches and zero above the causal diagonal
     (``F.scaled_dot_product_attention`` forward and backward, with the
     bias as a float mask over the batch); and at the shapes JAX's kernel
     takes that the first kernels refused: GPT-2's width as 6 heads of
     128, head_dim 40, tail tiles at 1000 x 1000 causal and 200 x 328
     with a T5 bias, head_dim 256 and 192 (the D = 256
     instantiation) causal and with a bias, 512 and 320 (the CUDA-core D
     = 512, 32-row tiles) causal and with a bias, and 1024 (D = 1024,
     16-row tiles) causal and 2048 (D = 2048, 8-row tiles) with a bias,
     and above 2048 (the wide kernels, the head dim in 2048-column
     chunks) 2056 causal with a bias and 4096 causal with dropout and
     rectangular with a bias; each case
     on its route (bf16 up to head_dim 256: the tensor-core forward, dQ,
     dK/dV and d(bias) of ``csrc/flash_mma.cu``; fp32 and head_dim above
     256: the CUDA-core kernels), the forward, dQ and dK/dV bitwise over
     two launches;
     the tensor-core kernels' ptxas registers and spills and their count
     of tensor-core (HMMA) instructions in the built library (SASS from
     ``cuobjdump``), which must be nonzero in every instantiation;
   * the varlen kernels (forward, dQ, dK/dV) at the packed path's shape
     (one row of 8192 tokens, 12 heads of 64, documents of 64-1024
     tokens from numpy seed 1, the rest padding), fp32 and bf16, causal
     and not, the same row at 4 heads of 256 and 2 of 512, causal; pad rows
     exactly 0 (their lse NEG_INF), the three kernels on their route
     (bf16 up to head_dim 256: the tensor-core kernels of
     ``csrc/flash_varlen_mma.cu``, their ptxas lines and SASS ``HMMA``
     counts reported), o, lse, dq, dk and dv bitwise over two launches,
     and through ``flash_attention_varlen``
     at a misaligned total (8100); times (the tile tables built
     beforehand, once per call as the packed path does; their build timed
     beside) next to SDPA with the dense block-diagonal mask, PyTorch's
     own varlen flash attention on the same documents (bf16 up to
     head_dim 256, a yardstick outside every gate) and the dense causal
     flash kernels at the same T, the CUDA-core kernels (fp32) beside the
     tensor-core ones;
     and a short packed row (256 tokens, 2 heads) at head_dim 2056 causal
     and 4096 bidirectional (the wide kernels), fp32 and bf16, checked;
   * ``layer_norm`` without weight or bias on CUDA: the plain version,
     bitwise, no launch;
   * the fused LM-head + CE forward, dX and dW at the training shape
     (8192, 768, V 50304), a ragged one (96 rows, V 1000), T5's (1024,
     512, V 32128) and a wide one (512, 2048, V 1000), each on its route
     (bf16: the tensor-core kernels of ``csrc/lm_head_mma.cu``, their
     ptxas lines and SASS ``HMMA`` counts reported; fp32:
     ``csrc/lm_head_loss.cu``), dX and dW held row by row and with the
     softmax term alone, with a bitwise repeat check of the forward, dX
     and dW, and the fp32 dX at the wide shape also held to an fp64
     evaluation of its formula (``torch.matmul`` + ``F.cross_entropy``,
     forward and autograd);
   * the Adam tail on each of GPT-2-124M's 16 and T5-small's 39 leaf
     shapes in both decay modes, the LAMB sums with a bitwise repeat, and
     each step's launches timed (``torch.optim.AdamW(fused=True).step()``);
   * hidden dropout (``csrc/dropout.cu``, JAX's threefry bits; no TPU
     kernel) at GPT-2's (8, 1024, 768), T5's (8, 512, 512) and an odd
     count, fp32 and bf16, rate 0.1: y and dx bitwise the plain version's
     (the int64 draw), two launches a call, the keep share within 5σ of
     0.9; timed against its bound (bytes or int32 operations, the larger)
     beside ``F.dropout`` (Philox: not the same function).
3. Engine phase: GPT-2-124M at full width (random weights from a numpy
   seed), ``ServeConfig(num_slots=8, prefill_chunk=32)`` — whose default
   ``megakernel="auto"`` runs decode and verify through the fused layer —
   16 requests of 64-512 prompt tokens (several sharing a 64-token
   prefix, one exactly that prefix) generating 32 tokens greedily:
   * fp32 through the kernels vs fp32 with the plain versions forced,
     fused vs per-op (``megakernel="off"``), and fused vs per-op with
     int8 and int4 pools on 6 requests: equal streams (the first
     mismatch and its top-2 logit gap reported otherwise), and logits
     that agree on a small input;
   * bf16 with ``spec_k=0`` (the serving main path: launch counts are
     reset just before it and read just after) and with ``spec_k=4``:
     equal streams; the launches of one decode and one verify call
     (megakernel 12, LayerNorm 1, no paged attention); int8 and int4
     pools with ``spec_k`` 0 and 4 (equal streams, tokens/s, pool bytes);
     the per-op path with its launches; the main path's prefill chunks
     launch ``paged_mma_fwd`` (fp32's ``paged_attention_fwd``);
   * where a steady-state bf16 step's time goes (torch.profiler), fused
     and per-op: the card's busy share and the top kernels; and where a
     per-op prefill chunk's goes (host ms, device busy ms, the paged
     kernels' share);
   * bf16 at 32 slots (32 requests, 16 new tokens each), ``spec_k`` 0
     and 4, both fused (a verify call is 160 rows): equal streams;
   * GPTs of head_dim 80 (12 x 80, hidden 960) and 320 (2 x 320, hidden
     640), 2 layers, 4 requests, each type twice: ``megakernel="auto"``
     fuses them (fused-layer launches; fp32 streams equal to the plain
     versions' and to the per-op path's) and ``megakernel="off"`` serves
     per-op through paged attention's route (``paged_attention_fwd`` /
     ``paged_mma_fwd`` at 80, ``paged_wide_fwd`` at 320).
   * the engine's telemetry (``engine_monitor``, bf16, the same 16
     requests, the fused main path; launch counts reset just before the
     monitored run, read just after): a ``JsonlSink``, an
     ``EventLog(keep=True)``, an ``SloSpec``, a ``Meter`` and
     ``peak_flops_per_s`` at the card's bf16 peak; streams bitwise equal
     to the run without telemetry, one sink record a step, every
     request's events in lifecycle order, the Chrome trace built,
     ``stats()``'s ``hists`` / ``slo_report`` / ``meter`` (meter tokens =
     generated tokens), and two requests evicted mid-decode and restored
     giving the uninterrupted streams; decode-step p50 and host ms a step
     with telemetry off and on, two runs each in turns;
   * per-tenant LoRA (``engine_lora``, bf16, ``lora_rank=16``,
     ``max_adapters=4``, two adapters from numpy seeds, 8 of the 16
     requests bound; the main run's counts reset just before it and read
     just after): the per-op kernels (``decode_kernel == "cuda"``) with
     the megakernel fallback reason logged; base-traffic streams bitwise
     equal to a ``megakernel="off"`` engine without adapters; ``spec_k=4``
     equal to ``spec_k=0`` for all 16; LayerNorm 25 and ``paged_mma_fwd``
     12 launches a decode and a verify call, as the per-op base; in fp32
     a tenant's prefill logits within 1e-4 (+ 1e-4 relative) of the
     merged-weight model and its greedy streams equal to the merged
     engine's up to the first near-tie (top-2 gap < ``NEAR_TIE``);
     adapter-load ms, pool bytes, tokens/s, decode-step p50.
4. Train phase: GPT-2-124M at full width and depth, full remat, the JAX
   defaults ``fused_loss=True`` and ``FusedAdam(lr=1e-4,
   fused_tail="auto")``:
   * fp32, batch 2 x 1024: loss and every gradient leaf through the
     kernels vs the plain versions forced; the same in bf16 (the
     tensor-core route), loss within BF16_LOSS_RTOL and every leaf within
     BF16_GRAD_NORM_RTOL in norm;
   * bf16, batch 8 x 1024 (the training main path): the launch counts of
     one step (reset just before it, read just after) equal the per-step
     table (LN fwd 49, LN bwd 25, tensor-core flash fwd 24, tensor-core
     dQ 12, tensor-core dK/dV 12, tensor-core LM-head
     fwd, dX and dW 1 each, Adam tail 16); the loss stays
     finite and
     falls over 10 steps on the fixed batch; a second run from the same
     seed repeats the losses bitwise; tokens/s, step ms p50, MFU, peak
     memory, and the card's busy share and top kernels over a profiled
     window;
   * the unfused step (``fused_loss=False``, ``fused_tail="off"``)
     timed over 10 steps at the same batch and profiled over 3: both
     tokens/s and device busy ms per step side by side.
5. T5 train phase: T5-small (``T5Config(relative_position_bias=True,
   encoder_final_ln=True)``, 6 + 6 layers, hidden 512, 8 heads, vocab
   32128) at full width and depth, full remat, the fused LM-head loss,
   ``FusedAdam(lr=1e-4, fused_tail="auto")``, 512 encoder and 128 decoder
   tokens a row:
   * fp32, batch 2: loss and every gradient leaf (the bias tables
     included, which must get a gradient) through the kernels vs the plain
     versions forced; the bf16 gate as GPT's;
   * bf16, batch 8 (the T5 main path): the launch counts of one step
     (reset just before it, read just after) equal the per-step table
     (LN fwd 62, LN bwd 32, tensor-core flash fwd 36 of which 24 with a
     bias, tensor-core dQ 18 (12 with a bias), tensor-core dK/dV 18,
     tensor-core d(bias) 12, tensor-core LM-head fwd, dX and dW 1 each,
     Adam tail 39); the loss stays
     finite and falls over 10 steps; a second run from the same seed
     repeats the losses bitwise; train tokens/s (encoder + decoder), step
     ms p50, peak memory, busy share and top kernels over 3 profiled
     steps.
6. Dropout phases (``train_dropout``, ``t5_dropout``): GPT-2-124M bf16 at
   8 x 1024 with GPT-2's dropout (attention and hidden 0.1) under each
   remat policy (``full``, ``dots``, ``dots_attn``), step i's key
   ``fold_in(prng_key(0), i)``: launches a step (reset just before the
   first step, read just after; ``dots_attn``'s is the main path of the
   ``hidden_dropout`` entry), the first step's loss and gradients bitwise
   equal across the policies, a falling loss, ``dots_attn`` repeating
   bitwise, no key equal to the rates-0 step; an fp32 check at 2 layers
   (kernels vs plain); step ms, busy ms, tokens/s and peak memory per
   policy. T5-small the same way at 8 x (512 + 128) (full remat, its only
   policy), fp32 check at 2 + 2 layers.
7. Functional phase: ``FusedScaleMaskSoftmax`` at (8, 12, 1024, 1024)
   causal and padding, ``softmax_cross_entropy_loss`` at (8192, 50304)
   with smoothing 0.1, ``MLP([1024, 4096, 4096, 1024])`` and
   ``FusedDenseGeluDense(768 -> 3072 -> 768)``: forward and backward on
   the card held to the CPU's in fp32; device ms in bf16 and fp32.
8. Packed path: ``contrib.fmha.FMHA`` (12 heads of 64) over the packed
   row of 8192 tokens, forward plus backward through autograd, bf16 and
   fp32, causal and bidirectional: one launch of each varlen kernel per
   run (each on its route; counts reset just before it and read just
   after), pad rows of o
   and dqkv exactly 0, a second run bitwise equal, and in fp32 o and dqkv
   equal to ``flash_attention`` run document by document (1e-5); device
   and wall ms, tokens/s, and a profile of the bf16 causal run.
9. Amp phase (mixed precision on the training main path):
   * O2 GPT-2-124M bf16 at 8 x 1024 (fp32 masters, LN params fp32,
     dynamic scale 2**16) with ``FusedAdam(lr=1e-4)`` over the masters,
     composed from ``amp``'s public pieces: the launches of 10 steps
     (counts reset just before, read just after) equal 10 x the train
     table; a falling loss repeating bitwise from the same seed; no more
     synchronizing calls a step than the plain bf16 step (timed beside it:
     step ms p50, busy ms, tokens/s); the model copy and the unscale
     timed alone; a step at scale 2**127 (the scaled loss is inf; one
     gradient leaf made inf) keeps masters, m, v and the count bitwise and
     halves the scale, and a step after restoring 2**16 trains;
   * at GPT-2's widths and 2 layers, fp32: O0 and O2 with FusedAdam,
     FusedLAMB, FusedSGD (Nesterov), FusedAdagrad, FusedNovoGrad and
     LARC(SGD), 3 steps on the card held to the same on the CPU; O1
     (``autocast``) one forward + backward held to the CPU's within the
     bf16 gate, flash and the LM head on their fp32 routes;
   * ``fp8_dot`` through ``MLP([1024, 4096, 4096, 1024])`` on 4096 rows,
     10 steps: every cast's codes and the delayed-scaling state bitwise
     the CPU's from the same values; the product's two routes
     (``torch._scaled_mm``, the fp32 product of the upcast codes) held to
     each other and timed.
10. fp16 (``amp_fp16``): GPT-2-124M at 8 x 1024, 3 steps each, under amp
   O2 with ``half_dtype=torch.float16`` (fp32 masters), under
   ``fp16_utils.FP16_Optimizer(FusedAdam)`` and as a pure fp16 step
   (``GPTConfig(dtype=float16)``): the train table's launches a step, the
   flash, LN and LM-head kernels' fp16 instantiations in a step's profile
   (and the Adam tail's in the pure step), finite losses, no more
   synchronizing calls than the bf16 O2 step, an overflow step keeping
   masters, m, v and the count bitwise. The kernel phases above hold every
   kernel a training path reaches in fp16 too (its bf16 gate), timed.
11. BERT (``bert``): ``BertConfig()`` MLM in bf16 at 8 x 512, 15 % of
   positions predicted, FusedAdam, 3 steps unpadded (the non-causal
   tensor-core flash kernels) and 3 with a padded tail on half the rows
   (reference attention): launches a step, finite losses, step ms, busy
   ms, tokens/s, peak memory; the bf16 gate at batch 2.
12. ``multihead_attn``: ``SelfMultiheadAttn(1024, 16, dropout=0.1,
   include_norm_add=True, bias=True)`` at (32, 128, 1024) bf16 and
   ``EncdecMultiheadAttn`` over a 256-token memory, forward + backward in
   training: one launch each of flash fwd / dQ / dK-dV (in-kernel dropout)
   and LN fwd / bwd, held to the plain path under the same key.
13. ``transducer``: joint + RNN-T loss forward and backward in fp32 at B 8,
   T 256, U 64, joint width 512, vocab 1024, the NLL held to an fp64 run
   of the same recursion on the card.
14. ``ddp`` (data parallel, A7a): the GPT-2-124M bf16 step at 8 x 1024
   with ``DistributedDataParallel`` over the dp axis of ``build_mesh()``
   on a one-rank NCCL group (a real communicator: ``all_reduce``,
   ``all_to_all_single`` and ``all_gather_into_tensor`` launch), policies
   ``none``, ``int8``, ``int8_ef`` and ``int4_ef`` (block 256, 10 M
   element buckets), DDP_STEPS (3) steps each beside the same steps
   without DDP:
   ``none`` bitwise the no-DDP losses and params, the EF policies within
   ``DDP_EF_GATE`` of ``none``, ``int8_ef`` bitwise over two runs, each
   compressed bucket bitwise the plain codec's round trip, the codec
   kernels' launches the count the bucket list gives, no plain codec
   call; step and busy ms, the codec's and NCCL's ms a step, peak memory,
   the wire bytes of the metrics and of the issued collectives.
15. ``syncbn_dp``: ResNet-50 (the resnet phase's) with its batch norms
   converted to the dp axis and DDP ``none``, 3 steps bitwise the
   local-BN run's (losses, masters, running statistics), one statistics
   all-reduce per BN layer per forward and backward; img/s of both.
16. ``zero1`` (ZeRO-1, A7b): the GPT-2-124M bf16 step at 8 x 1024 through
   ``build_train_step(plan=ParallelismPlan.preset("zero1"))``
   (``DistributedFusedAdam(lr=1e-4)`` on a one-rank NCCL group: the
   gradient reduce-scatter, the Adam tail kernel on fp32 shards, the
   all-gather), policies ``none``, ``int8``, ``int8_ef`` and the e5m2
   gather, DDP_STEPS steps each beside amp O2 from the same weights:
   ``none``
   within 1e-2 (rel) of amp O2's losses, the wires within 0.02 of
   ``none``, the e5m2 params bitwise a host emulation of JAX's clip →
   bf16 → e5m2 of the run's masters; the train table's launches
   (one tail a leaf) and the codec's a compressed leaf, no plain tail or
   codec call, no synchronizing call a step; the tail kernel on fp32
   shards against its plain version, timed against 28 bytes an element.
17. ``fsdp``: the same step through ``preset("fsdp")`` (``FSDPAdam``,
   the loss over ``FSDP.gather`` of the fp32 master shards): ``none``'s
   losses and masters bitwise zero1 ``none``'s; an int8 gradient wire
   within 0.05, int8 / int4 weight gathers within 0.02 / 0.1 of ``none``;
   the same launch, plain-call and sync gates.
18. ``dist_lamb``: ``BertConfig()`` MLM at 8 x 512 with
   ``DistributedFusedLAMB`` (the LAMB tail kernel a leaf, the trust
   ratio's sums in one all-reduce) beside ``FusedLAMB`` over fp32
   masters: losses within 1e-2 every step; launches, plain calls, syncs
   as above. Each of 16-18 records step, host and busy ms, the tails',
   codec's and collectives' device ms a step and peak memory; 16 also
   the modelled (not measured) HBM bytes of ddp / zero1 / fsdp at W = 8.
19. ``lm_head_vocab_shard`` (beside the LM-head phase): the fused LM-head
   kernels at GPT-2's width on a 25,152-row vocab shard with every
   target outside it (half negative, half >= V_local, as a non-owner rank
   of the vocab-parallel loss sees them), fp32 and bf16, against their
   plain versions; pred 0 on every row.
20. ``ring_chunks`` (beside the flash phase, C7): the flash kernels with
   JAX's ``[seed, q_off, k_off]`` on 4 ring chunks of GPT-2's attention
   (8, 12, 1024, 64) causal and T5-small's biased (8, 8, 512, 64), both
   with dropout 0.1, fp32 and bf16: each chunk against its plain version
   at its offsets, the chunks merged by lse (and their gradients summed,
   d(bias) tiled) against one dense call with the same seed; a chunk's
   kernel times with offsets set beside offsets 0.
21. ``tp`` and ``t5_tp`` (tensor and sequence parallelism, A7c): GPT-2
   (``megatron_sp``, the fused vocab-parallel LM head) and T5-small
   (``megatron_sp``) through the tp layers on a one-rank NCCL group,
   TP_STEPS (3) steps each, held to the train / t5_train phase's run
   without a mesh (same seed and batch; its parameters kept after those
   steps): losses and every parameter bitwise, the same kernel launches;
   step, host and busy ms and the collectives a step (none cross a
   one-rank axis).
22. ``pipeline`` (A7d.1): GPT-2-124M bf16 at 8 x 1024 (untied head,
   fused LM-head loss) through ``forward_backward_no_pipelining``, 1F1B
   with and without the stage remat and the interleaved schedule (vp 2,
   chunks of 6 layers), M = 4, ``FusedAdam(lr=1e-4)`` after the driver,
   TP_STEPS steps each on a one-rank NCCL group
   (``initialize_model_parallel(pp=1)``), beside the plain ``gpt_loss``
   step over the whole batch from the same weights: every step's loss
   within PIPE_LOSS_RTOL (4e-4), the first step's gradients within
   BF16_GRAD_NORM_RTOL in norm; each kernel's launches a step equal to
   ``gpt_pipeline_launches`` (in M, L, vp and the remat), no
   plain-version call, 0 synchronizing calls a step; the stage remat's
   peak memory below 1F1B's without it; one fp32 step of every run
   within 1e-5 (loss and every gradient leaf) of the plain step. Step,
   host and busy ms and peak memory of each run.
23. ``t5_pipeline``: T5-small (the t5_train phase's config and batch)
   through ``forward_backward_pipelining_enc_dec`` at pp = 1, M = 4,
   with and without the stage remat, the same checks
   (``t5_pipeline_launches``; the first loss beside ``t5_loss``'s, the
   steps, gradients and the fp32 steps, no-pipelining's too, beside the
   same functions over the whole batch). At one rank
   the hops and the pp sums issue no collective: phases 22-23 show the
   schedules' device work (microbatching, the stage remat, the launch
   order), not the wire; pp > 1 is held to JAX on the CPU in ``gloo``
   (``tests/test_torch_pipeline_*.py``).
24. ``moe`` (A7d.2): GPT-2-124M bf16 with 8 experts (top-2, capacity
   factor 1.25) at 8 x 1024 on a one-rank NCCL group (ep = dp = 1, no
   exchange), TP_STEPS ``FusedAdam(lr=1e-4)`` steps: JAX's single-expert
   identity in fp32 at full width (E = 1, top-1, zero router, C = 8200:
   the dense step plus ``lb_loss_weight``, loss and every leaf's norm
   within 1e-5), the bf16 first step beside an fp32 step of the same
   weights (``MOE_LOSS_RTOL``, ``MOE_GRAD_NORM_RTOL``,
   ``MOE_GRAD_DIFF_RTOL``), that fp32 step beside the same GPT with a
   plain MoE layer written without ``transformer.moe``
   (``make_plain_moe_mlp``: loss and every leaf's difference within
   ``MOE_PLAIN_RTOL``), finite losses,
   launches a step equal to ``moe_launches``, no plain-version call, 0
   synchronizing calls a step; ``fraction_kept`` a layer, step, host and
   busy ms, peak memory.
25. ``serve_pp`` / ``serve_fsdp`` (A8.2): the engine phase's requests
   (the first 8) through ``serve.build_engine`` with
   ``ParallelismPlan(pp=2)`` (both stages on the card; greedy and
   ``spec_k = 3`` streams) and ``ParallelismPlan("fsdp", dp=1)`` (a
   one-rank NCCL group; greedy streams), 16 slots, bitwise the plain
   per-op engine's; a decode call's launches against their formulas
   (M · L paged attention and M · (2L + 1) LN through the stages; with
   the int8 ``weight_gather`` the codec's quantize and dequantize a
   gathered leaf, ``fsdp_codec_launches``); the int8 engine's first
   logits within ``FSDP_WG_LOGIT_RTOL``; bubble, step ms,
   ``weight_gather_ms`` and the wire bytes. tp > 1 serving and ep > 1
   need several cards: they are held to JAX on the CPU in ``gloo``
   (``tests/test_torch_moe.py``, ``tests/test_torch_serve_sharded.py``).
26. Prints detail lines, the wall seconds of each phase (and of each
   source's build), the card's ``nvidia-smi`` name and power limit,
   the ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``. Any failed phase raises: the exit
   code is then nonzero and the last line is not printed.

Needs one CUDA device and ``nvcc``; exits nonzero without printing a result
when CUDA is absent or the package is not beside this script.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
# fp16 cases are held to their kernel's bf16 gate: fp16 keeps three more
# mantissa bits, so that gate is the loosest it may have
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
KERNEL_ITERS = 50
SLEEP_CYCLES_PER_S = 2.0e9         # above the H100's SM clock: sleeps long
TRAIN_ROWS = 8 * 1024              # b·s of the training main path
# the T5 main path's batch; T5-small's split: 512 inputs, 128 targets
# (pre-training's 512 / 114, rounded up: 114 is not a multiple of 8, so
# JAX's own kernel gate would send it to the reference attention)
T5_BATCH, T5_ENC, T5_DEC = 8, 512, 128
T5_HIDDEN = 512                    # T5-small's width
T5_LN_ROWS = (T5_BATCH * T5_ENC, T5_BATCH * T5_DEC)   # encoder, decoder
# the serving path's LayerNorm calls at GPT-2's width: 4-256 rows (decode
# and verify steps, prefill chunks), no statistics
LN_SERVE_ROWS = (4, 8, 32, 8 * 32)
KV_MODES = {"none": {}, "int8": dict(quantized=True, bits=8),
            "int4": dict(quantized=True, bits=4)}


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = KERNEL_ITERS, flush=None) -> float:
    """Mean device time of one call of ``fn`` over ``iters`` calls: CUDA
    events around each call, ``flush`` (evicting the L2 cache where the
    real caller finds it cold) between calls outside the events. A
    sleeping kernel holds the stream while the host enqueues every call,
    so the card runs them back to back and the events see device time,
    not the host's launch latency."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if flush is not None:
        flush()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int((2 * iters * host_s + 2e-3) * SLEEP_CYCLES_PER_S))
    pairs = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def bound_ms(bytes_moved: float, ops: float, dtype_name: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_close(name, got, want, atol, rtol):
    """Max abs error of ``got`` vs ``want``; raises unless every element is
    finite and within ``atol + rtol * |want|``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(got.isfinite().all()) or bool(
            (err > atol + rtol * want.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{float(err.max()):.3e} (atol {atol}, rtol {rtol})")
    return float(err.max())


def check_rows(name, got, want, atol_of_row_max, rtol):
    """``check_close`` for a 2-d tensor whose rows differ in scale: each
    element within ``atol_of_row_max · max|want[row]| + rtol · |want|``,
    so a row of small values (a vocab row of dW that no target hits) is
    held to its own scale, not to the largest row's. Compared in fp64
    when ``want`` is fp64, else in fp32. Returns the max abs error and the
    largest row's max abs error over its max |want|."""
    got, want = ((got.double(), want) if want.element_size() == 8
                 else (got.float(), want.float()))
    err = (got - want).abs()
    row_max = want.abs().amax(dim=1, keepdim=True)
    if not bool(got.isfinite().all()) or bool(
            (err > atol_of_row_max * row_max + rtol * want.abs()).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{float(err.max()):.3e} (atol {atol_of_row_max} of each row's "
            f"max, rtol {rtol})")
    row_err = err.amax(dim=1, keepdim=True) / row_max.clamp_min(1e-30)
    return float(err.max()), float(row_err.max())


def ptxas_lines(log: str):
    """(kernel, line) for each register, spill or error line of an ``nvcc
    -Xptxas -v`` log; the kernel is named from the mangled entry the line
    belongs to, e.g. ``flash_fwd_kernel[bf16, 64, 1]`` (type, then the
    integer template arguments)."""
    import re

    kernel, out = "", []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            base = re.findall(r"\d([a-z][a-z_]*_kernel)[IE]", entry)
            args = re.findall(r"L[ib](\d+)E", entry)
            # the input type, where the kernel takes one as a template
            # argument
            kind = re.search(r"_kernelI(13__nv_bfloat16|6__half|f)", entry)
            kind = [_type_name(kind.group(1))] if kind else []
            kernel = (f"{base[-1] if base else entry[:40]}"
                      f"[{', '.join([*kind, *args])}]")
        elif "registers" in line or "spill" in line or "error" in line:
            out.append((kernel, line.strip()))
    return out


def sass_opcode_counts(ku, source, function):
    """{SASS function: {opcode: count}} for the functions of the built
    library of ``csrc/<source>.cu`` whose names match the regex
    ``function`` (``cuobjdump --dump-sass``; an opcode without its
    modifiers)."""
    import os
    import re

    cuobjdump = os.path.join(os.path.dirname(ku.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(ku._lib_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S*" + function + r"\S*)", line)
        if m:
            fn = m.group(1)
            counts[fn] = {}
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if fn and m:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return counts


def sass_hmma_counts(ku, source, function, name, bf16=None):
    """{instantiation: count of tensor-core instructions (HMMA, HGMMA)} in
    the built library of ``csrc/<source>.cu``, from ``cuobjdump
    --dump-sass``: each SASS function matching the regex ``function`` is
    named ``name(match)``. With a dict ``bf16``, each instantiation's
    count of those with the ``.BF16`` operand type (an fp16 product has
    none) is written there."""
    import os
    import re

    cuobjdump = os.path.join(os.path.dirname(ku.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(ku._lib_path(source))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?" + function, line)
        if m:
            fn = name(m)
            counts[fn] = 0
            if bf16 is not None:
                bf16[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
            if bf16 is not None and ".BF16" in line:
                bf16[fn] += 1
    return counts


def tensor_core_info(ku, built, source, counts, kernels):
    """Per key of ``kernels`` ({key: (name prefix in ``counts``, number of
    instantiations, name prefix in the ptxas log)}): the ptxas register
    and spill lines of each instantiation of the kernel in
    ``csrc/<source>.cu`` and its count of tensor-core instructions
    (``counts``, from :func:`sass_hmma_counts`): the proof that its
    products run on the tensor cores. Raises if an instantiation has
    none."""
    log = built.get(source, {}).get("log", "")
    out = {}
    for key, (base, want, logged) in kernels.items():
        mine = {k: v for k, v in counts.items() if k.startswith(base)}
        if len(mine) != want or not all(mine.values()):
            raise AssertionError(f"{base}: tensor-core instructions per "
                                 f"instantiation {mine}")
        out[key] = {"sass_hmma": mine, "ptxas": [
            f"{k}: {line}" for k, line in ptxas_lines(log)
            if k.startswith(logged)]}
    return out


# the half element types of the tensor-core kernels' mangled names
HALF_MANGLED = r"(13__nv_bfloat16|6__half)"


def half_types(info, bf16):
    """Each key of ``info``: its instantiations' tensor-core instructions
    by element type, and how many of them carry the ``.BF16`` operand
    type (``bf16``, from :func:`sass_hmma_counts`): all of a bf16
    instantiation's, none of an fp16 one's (f16 ``mma.sync``)."""
    for entry in info.values():
        entry["hmma_bf16_operands"] = {
            k: bf16.get(k, 0) for k in entry["sass_hmma"]}
    return info


def mma_kernel_info(ku, built):
    """The tensor-core flash forward, dQ and dK/dV (``csrc/flash_mma.cu``,
    16 instantiations each: bf16 and fp16, D 32-256 with and without a
    bias) and d(bias) (8: bf16 and fp16, D 32-256)."""
    bf16 = {}
    counts = sass_hmma_counts(
        ku, "flash_mma",
        r"(flash_mma_(?:fwd|dq|dkv|dbias)_kernel)I" + HALF_MANGLED
        + r"Li(\d+)E(?:Lb([01])E)?",
        lambda m: f"{m.group(1)}[{_type_name(m.group(2))}, {m.group(3)}"
                  f"{', bias' * int(m.group(4) or 0)}]", bf16)
    return half_types(tensor_core_info(ku, built, "flash_mma", counts, {
        "fwd": ("flash_mma_fwd_kernel", 16, "flash_mma_fwd_kernel"),
        "dq": ("flash_mma_dq_kernel", 16, "flash_mma_dq_kernel"),
        "dkv": ("flash_mma_dkv_kernel", 16, "flash_mma_dkv_kernel"),
        "dbias": ("flash_mma_dbias_kernel", 8, "flash_mma_dbias_kernel")}),
        bf16)


def lm_mma_kernel_info(ku, built):
    """The tensor-core LM-head forward (``csrc/lm_head_mma.cu``, one
    instantiation a type), dX and dW (one kernel with 4 instantiations
    each a type: panels of 128, 256, 384 and 512 columns); bf16 and
    fp16."""
    bf16 = {}
    counts = sass_hmma_counts(
        ku, "lm_head_mma",
        r"lm_mma_(?:bwd_kernelI" + HALF_MANGLED + r"Lb([01])ELi(\d+)E"
        r"|fwd_kernelI" + HALF_MANGLED + r"E)",
        lambda m: f"lm_mma_fwd_kernel[{_type_name(m.group(4))}]"
        if m.group(1) is None else
        f"lm_mma_bwd_kernel[{'dw' if m.group(2) == '1' else 'dx'}, "
        f"{_type_name(m.group(1))}, {m.group(3)}]", bf16)
    return half_types(tensor_core_info(ku, built, "lm_head_mma", counts, {
        "fwd": ("lm_mma_fwd_kernel", 2, "lm_mma_fwd_kernel"),
        "dx": ("lm_mma_bwd_kernel[dx", 8, "lm_mma_bwd_kernel["),
        "dw": ("lm_mma_bwd_kernel[dw", 8, "lm_mma_bwd_kernel[")}), bf16)


def varlen_mma_kernel_info(ku, built):
    """The tensor-core varlen forward, dQ and dK/dV
    (``csrc/flash_varlen_mma.cu``, 8 instantiations each: bf16 and fp16,
    D 32-256)."""
    bf16 = {}
    counts = sass_hmma_counts(
        ku, "flash_varlen_mma",
        r"(varlen_mma_(?:fwd|dq|dkv)_kernel)I" + HALF_MANGLED + r"Li(\d+)E",
        lambda m: f"{m.group(1)}[{_type_name(m.group(2))}, {m.group(3)}]",
        bf16)
    return half_types(tensor_core_info(ku, built, "flash_varlen_mma", counts, {
        key: (f"varlen_mma_{key}_kernel", 8, f"varlen_mma_{key}_kernel")
        for key in ("fwd", "dq", "dkv")}), bf16)


def check_half_operands(what, counts, bf16):
    """Every instantiation of ``counts`` (from :func:`sass_hmma_counts`)
    named for a half type issues tensor-core instructions of that type:
    a bf16 one all with the ``.BF16`` operand type, an fp16 one (f16
    ``mma.sync``) none. Raises otherwise."""
    bad = {k: (v, bf16.get(k, 0)) for k, v in counts.items()
           if ("f16" in k and "bf16" not in k and bf16.get(k, 0))
           or ("bf16" in k and bf16.get(k, 0) != v)}
    if bad:
        raise AssertionError(f"{what}: tensor-core operand types wrong "
                             f"(HMMA, of which .BF16): {bad}")


def paged_mma_kernel_info(ku, built):
    """The tensor-core paged attention (``csrc/paged_mma.cu``, 24
    instantiations: D 32-256 x full-precision, int8 and int4 pools x bf16
    and fp16 tiles): each with tensor-core instructions, a bf16 one's all
    ``.BF16``, an fp16 one's none (f16 HMMA)."""
    bf16 = {}
    counts = sass_hmma_counts(
        ku, "paged_mma",
        r"(paged_mma_kernel)ILi(\d+)ELi(\d+)E" + HALF_MANGLED,
        lambda m: f"{m.group(1)}[{_type_name(m.group(4))}, {m.group(2)}, "
                  f"{m.group(3)}]", bf16)
    check_half_operands("paged_mma_kernel", counts, bf16)
    return half_types(tensor_core_info(ku, built, "paged_mma", counts, {
        "fwd": ("paged_mma_kernel", 24, "paged_mma_kernel")}), bf16)


def _type_name(mangled: str) -> str:
    """f32 / bf16 / f16 for a mangled template argument (``f``,
    ``13__nv_bfloat16``, ``6__half``)."""
    return {"f": "f32", "6__half": "f16"}.get(mangled, "bf16")


def megakernel_kernel_info(ku, built):
    """The fused layer (``csrc/megakernel.cu``, 36 instantiations: fp32,
    bf16 and fp16 x full-precision, int8 and int4 pools x the attention
    walk's head-dim buckets 64, 128, 256 and the wide walk, and its GEMM
    routine, not inlined, one a type): the ptxas lines and the tensor-core
    instructions of each. The half GEMMs and every half walk below 256
    must have some (where the routine is listed inside each kernel, every
    half kernel must), a bf16 one's all ``.BF16``, an fp16 one's none (f16
    HMMA); nothing fp32 any (no TF32)."""
    bf16 = {}
    counts = sass_hmma_counts(
        ku, "megakernel",
        r"(?:fused_layer_kernelI" + HALF_MANGLED[:-1] + r"|f)Li(\d)ELi(\d+)E"
        r"|(gemm)I" + HALF_MANGLED[:-1] + r"|f)E)",
        lambda m: (f"fused_layer_kernel[{_type_name(m.group(1))}, "
                   f"{m.group(2)}, {m.group(3)}]" if m.group(4) is None
                   else f"gemm[{_type_name(m.group(5))}]"), bf16)
    kern = {k: v for k, v in counts.items() if k.startswith("fused")}
    gemm = {k: v for k, v in counts.items() if k.startswith("gemm")}
    ok = len(kern) == 36 and not any(v for k, v in counts.items()
                                     if "f32" in k)
    for t in ("bf16", "f16"):
        half = {k: v for k, v in kern.items() if f"[{t}," in k}
        ok = ok and all(v for k, v in half.items()
                        if not k.endswith(", 0]")) and (
            all(half.values()) or gemm.get(f"gemm[{t}]", 0) > 0)
    if not ok:
        raise AssertionError(f"fused_layer_kernel: tensor-core instructions "
                             f"per instantiation {counts}")
    check_half_operands("fused_layer_kernel", counts, bf16)
    log = built.get("megakernel", {}).get("log", "")
    return {"sass_hmma": counts, "hmma_bf16_operands": bf16, "ptxas": [
        f"{k}: {line}" for k, line in ptxas_lines(log)
        if k.startswith("fused_layer_kernel")]}


def start_builds(ku):
    """Start one ``nvcc`` per kernel source, all together, each from its
    own thread, so a phase can begin once its sources are built while a
    slower one still compiles. Returns ``(built, wait)``: ``built`` fills
    with ``ku.build``'s record per source; ``wait(*names)`` joins those
    builds (every build with no names) and re-raises a failed one. The
    threads are not daemons: the script never exits before its nvcc
    processes."""
    import threading

    built, errors, threads = {}, {}, {}

    def one(name):
        try:
            built.update(ku.build([name]))
        except BaseException as e:          # re-raised by wait()
            errors[name] = e

    for name in ku.KERNEL_SOURCES:
        threads[name] = threading.Thread(target=one, args=(name,))
        threads[name].start()

    def wait(*names):
        for name in names or tuple(threads):
            threads[name].join()
            if name in errors:
                raise errors[name]
    return built, wait


# ---------------------------------------------------------------------------
# kernel phase


def norm_fwd_bitwise(torch, tag, fwd, x):
    """The norm forward's bitwise gates (a row's sum order is set by
    hidden alone): ``fwd(x)`` (a tuple, y and any statistics) gives the
    same bits twice, and ``min(8, rows // 2)`` rows from the middle of x,
    launched alone, give the bits they have inside the whole call (the
    engine's 8-row decode and 64-row chunk calls, the remat replay).
    Raises otherwise."""
    first, again = fwd(x), fwd(x)
    rows = x.shape[0]
    n = max(1, min(8, rows // 2))
    at = (rows - n) // 2
    alone = fwd(x[at:at + n].contiguous())
    torch.cuda.synchronize()
    if not all(bool(torch.equal(a, c)) for a, c in zip(first, again)):
        raise AssertionError(f"{tag}: forward not bitwise equal over two "
                             f"launches")
    if not all(bool(torch.equal(a[at:at + n], c))
               for a, c in zip(first, alone)):
        raise AssertionError(f"{tag}: rows {at}-{at + n - 1} alone differ "
                             f"from the same rows in the {rows}-row call")


def layer_norm_phase(torch, dev):
    """LayerNorm forward at the serving path's shapes (4-256 rows of 768,
    no statistics) and at the training paths' (GPT's b·s = 8192 rows of
    768, T5's 4096 encoder and 1024 decoder rows of 512, with the fp32
    mean/rstd the backward reads; fp16 there too): y within tol[dtype] of
    the plain version, mean and rstd within atol/rtol 2e-5 (fp32 sums over
    the columns in another order); y (and mean, rstd) bitwise over two
    launches and for the middle rows launched alone
    (:func:`norm_fwd_bitwise`). The training shapes are timed with the L2
    flushed between calls, as the backward is."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.layer_norm import (layer_norm_fwd,
                                               layer_norm_fwd_reference)

    eps = 1e-5
    tol = {"float32": (1e-5, 1e-5), "bfloat16": (1e-3, 8e-3),
           "float16": (1e-3, 8e-3)}
    stats_tol = (2e-5, 2e-5)
    gen = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dt).split(".")[1]
        for rows, hidden, stats in (
                # fp16 at the training paths' shapes only: no serving
                # path runs fp16
                *((r, 768, False) for r in LN_SERVE_ROWS
                  if dt != torch.float16),
                (TRAIN_ROWS, 768, True),
                *((r, T5_HIDDEN, True) for r in T5_LN_ROWS)):
            x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
                 + 1).to(dt)
            w = (1 + 0.1 * torch.randn(hidden, device=dev,
                                       generator=gen)).to(dt)
            b = (0.1 * torch.randn(hidden, device=dev, generator=gen)).to(dt)
            got = layer_norm_fwd(x, w, b, eps, stats=stats)
            want = layer_norm_fwd_reference(x, w, b, eps)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            tag = f"{dname} rows={rows} hidden={hidden}"
            if stats:
                err = check_close(f"layer_norm_fwd y {tag}", got[0], want[0],
                                  atol, rtol)
                stats_err = max(
                    check_close(f"layer_norm_fwd mean {tag}", got[1],
                                want[1], *stats_tol),
                    check_close(f"layer_norm_fwd rstd {tag}", got[2],
                                want[2], *stats_tol))
            else:
                err = check_close(f"layer_norm_fwd {tag}", got, want[0],
                                  atol, rtol)
            norm_fwd_bitwise(
                torch, f"layer_norm_fwd {tag}",
                lambda xx: (layer_norm_fwd(xx, w, b, eps, stats=True)
                            if stats else (layer_norm_fwd(xx, w, b, eps),)),
                x)
            esz = x.element_size()
            bms, by = bound_ms((2 * rows * hidden + 2 * hidden) * esz
                               + (8 * rows if stats else 0),
                               8.0 * rows * hidden, dname)
            flush = flush_buf.zero_ if stats else None
            case = {
                "dtype": dname, "rows": rows, "hidden": hidden,
                "stats": stats, "max_abs_err": err, "atol": atol,
                "rtol": rtol, "bitwise_repeat": True, "row_invariant": True,
                "ms": time_ms(torch, lambda: layer_norm_fwd(
                    x, w, b, eps, stats=stats), flush=flush),
                "plain_ms": time_ms(torch, lambda: layer_norm_fwd_reference(
                    x, w, b, eps), flush=flush),
                "library_ms": time_ms(
                    torch, lambda: F.layer_norm(x, (hidden,), w, b, eps),
                    flush=flush),
                "bound_ms": bms, "bound_by": by}
            if stats:
                case.update(stats_max_abs_err=stats_err,
                            stats_atol=stats_tol[0], stats_rtol=stats_tol[1])
            cases.append(case)
    return cases


def quant_pools(torch, dev, cfg, bt, seed):
    """One layer's pools for ``cfg`` with every position of every row's
    blocks written through the plain codec (``paged_write``) from random
    K/V, made on the card."""
    from apex_tpu_torch.serve.kv_cache import init_kv_cache, paged_write

    n, mb = bt.shape
    bs, heads, hd = cfg.block_size, cfg.num_heads, cfg.head_dim
    layer = {k: v[0] for k, v in init_kv_cache(cfg, dev).items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    pos = torch.arange(mb * bs, device=dev).repeat(n)
    k, v = (torch.randn(heads, n * mb * bs, hd, device=dev, generator=gen)
            .to(cfg.dtype) for _ in range(2))
    paged_write(layer, cfg, k, v, bt.repeat_interleave(mb * bs, dim=0), pos,
                torch.ones_like(pos, dtype=torch.bool))
    return layer


SERVE_HEADS, SERVE_HD, SERVE_BS, SERVE_CTX = 12, 64, 16, 1024


def paged_draws():
    """The serving shapes' contexts and block tables, keyed (dtype name,
    rows), drawn from numpy seed 0 in one fixed order: per row count, an
    idle row (ctx 0), a full row (1024) and the rest uniform."""
    import numpy as np

    mb = SERVE_CTX // SERVE_BS
    rng = np.random.default_rng(0)
    out = {}
    for dname in ("float32", "bfloat16", "float16"):
        for n in (8, 32):
            ctx = rng.integers(1, SERVE_CTX + 1, n)
            ctx[0] = 0
            ctx[1] = SERVE_CTX
            bt = rng.permutation(n * mb).reshape(n, mb).astype(np.int32)
            out[(dname, n)] = (ctx, bt)
    return out


# the per-op serve calls' row groups: decode (8 slots x 1 row), verify (8
# slots x spec_k + 1 = 5 rows) and a prefill chunk (1 slot x 32 rows)
PAGED_KINDS = {"decode": (8, 1), "verify": (8, 5), "prefill": (1, 32)}
# checked and timed beside the serving 64; above 256 the wide walk
PAGED_HEAD_DIMS = (80, 96, 256, 264, 320, 512, 1024, 2056)


def paged_case(torch, dev, dt, mode, kind, hd=SERVE_HD, rows=None):
    """One paged-attention call of a serve program at the serving shapes
    (12 heads, block 16, 1024 positions a slot): ``decode`` the 8 (or
    ``rows``) rows of ``paged_draws`` (an idle row, a full one); ``verify``
    8 slots' next 5 positions from lengths of numpy seed 1, slot 0 idle;
    ``prefill`` one slot's chunk of 32 rows, contexts 481-512. Pools of
    random K/V, quantized through the plain codec. Returns (q, pools, cfg,
    block-table rows, contexts, group size, slot tables)."""
    import numpy as np

    from apex_tpu_torch.serve.kv_cache import KVCacheConfig

    dname = str(dt).split(".")[1]
    heads, bs, cap = SERVE_HEADS, SERVE_BS, SERVE_CTX
    mb = cap // bs
    slots, g = PAGED_KINDS[kind]
    if kind == "decode":
        ctx, tables = paged_draws()[(dname, rows or slots)]
        slots = len(ctx)
    else:
        rng = np.random.default_rng(1)
        tables = rng.permutation(slots * mb).reshape(slots, mb)
        if kind == "verify":
            seq = rng.integers(1, cap - g, slots)
            ctx = (seq[:, None] + np.arange(1, g + 1)[None, :])
            ctx[0] = 0
        else:
            ctx = 480 + np.arange(1, g + 1)[None, :]
        ctx = ctx.reshape(-1)
    blocks = slots * mb
    cfg = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                        num_blocks=blocks, block_size=bs, dtype=dt,
                        **KV_MODES[mode])
    bt_t = torch.from_numpy(tables.astype(np.int32)).to(dev)
    seed = slots * g + hd
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mode == "none":
        pools = {k: torch.randn(heads, blocks + 1, bs, hd, device=dev,
                                generator=gen).to(dt) for k in "kv"}
    else:
        pools = quant_pools(torch, dev, cfg, bt_t, seed=seed)
    q = torch.randn(slots * g, heads, hd, device=dev, generator=gen).to(dt)
    ctx_t = torch.from_numpy(np.asarray(ctx, np.int32)).to(dev)
    return (q, pools, cfg, bt_t.repeat_interleave(g, dim=0), ctx_t, g,
            bt_t)


def paged_attention_phase(torch, dev):
    """Paged attention against its plain version on its route
    (``_paged_route``: bf16 and fp16 ``paged_mma_fwd`` on the tensor
    cores, fp32 ``paged_attention_fwd``), fp32, bf16 and fp16 q (fp16
    since C6, held to the bf16 gates), full-precision / int8 /
    int4 pools, at the serve programs' calls (``PAGED_KINDS``: decode at 8
    rows, and 32 for full-precision pools; verify 8 x 5; a prefill chunk 1
    x 32, ``rows_per_table`` as ``paged_layer_stack`` passes it), timed
    beside the plain version and SDPA (one call over each slot's K/V,
    gathered and dequantized beforehand, a per-row context mask); checked
    and timed (verify) at every PAGED_HEAD_DIMS, up to 256 on the route
    of the query's type, above it the wide walk (``paged_wide_fwd``, every
    type); the same rows launched as groups of 32, 5 and 1 bitwise
    equal, and repeats bitwise, at head_dim 64 and 512.
    Tolerances: fp32 (2e-5, 1e-4); bf16 (1e-3, 8e-3) with full-precision
    pools and (1e-2, 8e-3) with quantized ones (the plain version
    dequantizes into the model dtype). Bound: each slot's live K/V read
    once (its largest context) + q and o + tables, or 4·Σctx·H·D
    operations."""
    import numpy as np
    import torch.nn.functional as F

    from apex_tpu_torch.serve.decode import (_paged_route,
                                             paged_attention_fwd,
                                             paged_attention_reference)
    from apex_tpu_torch.serve.kv_cache import _elem_bytes, gather_kv

    tol = {"float32": (2e-5, 1e-4), "bfloat16": (1e-3, 8e-3),
           "float16": (1e-3, 8e-3)}
    quant_tol = {"float32": (2e-5, 1e-4), "bfloat16": (1e-2, 8e-3),
                 "float16": (1e-2, 8e-3)}
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {"cases": [], "head_dims": [], "bitwise": []}

    def check(tag, dt, mode, kind, hd=SERVE_HD, rows=None):
        q, pools, cfg, bt, ctx, g, tables = paged_case(torch, dev, dt, mode,
                                                       kind, hd, rows)
        dname = str(dt).split(".")[1]
        scale = 1.0 / math.sqrt(hd)
        got = paged_attention_fwd(q, pools, cfg, bt, ctx, scale,
                                  rows_per_table=g)
        want = paged_attention_reference(q, pools, cfg, bt, ctx,
                                         scale=scale)
        torch.cuda.synchronize()
        atol, rtol = (tol if mode == "none" else quant_tol)[dname]
        err = check_close(f"{tag} {kind} {mode} {dname} d={hd}", got, want,
                          atol, rtol)
        idle = ctx == 0
        if bool(idle.any()) and bool(got[idle].abs().max() != 0):
            raise AssertionError(f"{tag}: a ctx == 0 row is not zeros")
        rec = {"kind": kind, "dtype": dname, "kv": mode, "rows": q.shape[0],
               "rows_per_table": g, "heads": SERVE_HEADS, "head_dim": hd,
               "block_size": SERVE_BS, "entry": _paged_route(dt, hd),
               "ctx_sum": int(ctx.sum()), "ctx_max": int(ctx.max()),
               "max_abs_err": err, "atol": atol, "rtol": rtol}
        return rec, (q, pools, cfg, bt, ctx, g, tables, scale)

    def timed(rec, args, iters=KERNEL_ITERS):
        """``rec`` with the call's times (kernel, plain version, SDPA over
        each slot's gathered K/V with a per-row context mask) and bound."""
        q, pools, cfg, bt, ctx, g, tables, scale = args
        hd = cfg.head_dim
        slots = tables.shape[0]
        k_all, v_all = gather_kv(pools, cfg, tables)
        qs = q.reshape(slots, g, SERVE_HEADS, hd).transpose(1, 2)
        kpos = torch.arange(SERVE_CTX, device=dev)
        keep = kpos[None, None, None, :] < ctx.reshape(slots, 1, g, 1)
        live = int(ctx.reshape(slots, g).max(1).values.sum())
        esz = q.element_size()
        bms, by = bound_ms(
            live * SERVE_HEADS * hd * 2 * _elem_bytes(cfg)
            + 2 * q.numel() * esz + tables.numel() * 4 + ctx.numel() * 4,
            4.0 * rec["ctx_sum"] * SERVE_HEADS * hd, rec["dtype"])
        rec.update(
            live_slot_positions=live,
            ms=time_ms(torch, lambda: paged_attention_fwd(
                q, pools, cfg, bt, ctx, scale, rows_per_table=g),
                iters=iters, flush=flush_buf.zero_),
            plain_ms=time_ms(torch, lambda: paged_attention_reference(
                q, pools, cfg, bt, ctx, scale=scale), iters=iters,
                flush=flush_buf.zero_),
            library_ms=time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qs, k_all, v_all, attn_mask=keep, scale=scale),
                iters=iters, flush=flush_buf.zero_),
            bound_ms=bms, bound_by=by)
        return rec

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dt).split(".")[1]
        for kind, mode, rows in (
                ("decode", "none", 8), ("decode", "none", 32),
                ("decode", "int8", 8), ("decode", "int4", 8),
                *((k, m, None) for k in ("verify", "prefill")
                  for m in ("none", "int8", "int4"))):
            rec, args = check("paged attention", dt, mode, kind, rows=rows)
            out["cases"].append(timed(rec, args))
            del args
        # every head dim beside the serving 64 at the verify call, the wide
        # walk's (above 256) among them, timed with fewer calls
        for hd in PAGED_HEAD_DIMS:
            for mode in ("none", "int8", "int4"):
                rec, args = check("paged attention", dt, mode, "verify", hd)
                # fp16 (C6): every head dim checked, the wide walk's d320
                # timed
                if dt != torch.float16 or (hd, mode) == (320, "none"):
                    rec = timed(rec, args, iters=10)
                out["head_dims"].append(rec)
                del args
                torch.cuda.empty_cache()
        # the same rows as groups of 32 (two slots' prefill chunks), of 5
        # (the first 30 rows of each slot) and of 1, and a repeat; at the
        # serving head dim and at a wide one
        for hd, mode in itertools.product((SERVE_HD, 512),
                                          ("none", "int8", "int4")):
            q, pools, cfg, bt, _, g, tables, scale = check(
                "paged attention", dt, mode, "prefill", hd)[1]
            rng = np.random.default_rng(2)
            bt = tables.repeat(2, 1).repeat_interleave(g, dim=0)
            q = torch.cat([q, q.flip(0)])
            ctx = torch.from_numpy(rng.integers(
                0, SERVE_CTX + 1, 2 * g).astype(np.int32)).to(dev)
            keep = (torch.arange(2 * g, device=dev) % g) < 30

            def run(rows, gg):
                return paged_attention_fwd(q[rows].contiguous(), pools, cfg,
                                           bt[rows], ctx[rows], scale,
                                           rows_per_table=gg)
            every = torch.ones_like(keep)
            g32, g1, g5, again = (run(every, 32), run(every, 1),
                                  run(keep, 5), run(every, 32))
            torch.cuda.synchronize()
            same = {"groups_1": bool(torch.equal(g32, g1)),
                    "groups_5": bool(torch.equal(g32[keep], g5)),
                    "repeat": bool(torch.equal(g32, again))}
            if not all(same.values()):
                raise AssertionError(f"paged attention {mode} {dname} d{hd}:"
                                     f" a row's bits depend on its group: "
                                     f"{same}")
            out["bitwise"].append({"dtype": dname, "kv": mode,
                                   "head_dim": hd,
                                   "entry": _paged_route(dt, hd), **same})
            del pools
    return out


def layer_norm_bwd_phase(torch, dev):
    """LayerNorm backward at the training paths' shapes (GPT's b·s = 8192
    rows of 768; T5's 4096 encoder and 1024 decoder rows of 512): dx, dw,
    db vs the plain version (dw/db sum the rows, so their atol is
    2e-5·sqrt(rows) in fp32 and one bf16 rounding plus 2e-3·sqrt(rows) in
    bf16), and dw/db bitwise equal over repeats. Both sides read the
    forward kernel's mean/rstd, which ``layer_norm_phase`` holds against
    the plain version at these shapes. fp16 as bf16."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.layer_norm import (layer_norm_bwd,
                                               layer_norm_bwd_reference,
                                               layer_norm_fwd)

    eps = 1e-5
    tol = {"float32": (2e-5, 1e-5), "bfloat16": (2e-3, 8e-3),
           "float16": (2e-3, 8e-3)}
    gen = torch.Generator(device=dev).manual_seed(2)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = []
    for (rows, hidden), dt in itertools.product(
            ((TRAIN_ROWS, 768), *((r, T5_HIDDEN) for r in T5_LN_ROWS)),
            (torch.float32, torch.bfloat16, torch.float16)):
        dname = str(dt).split(".")[1]
        tag = f"{dname} rows={rows} hidden={hidden}"
        x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
             + 1).to(dt)
        w = (1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)).to(dt)
        b = (0.1 * torch.randn(hidden, device=dev, generator=gen)).to(dt)
        dy = torch.randn(rows, hidden, device=dev, generator=gen).to(dt)
        _, mean, rstd = layer_norm_fwd(x, w, b, eps, stats=True)
        got = layer_norm_bwd(dy, x, mean, rstd, w)
        want = layer_norm_bwd_reference(dy, x, mean, rstd, w)
        torch.cuda.synchronize()
        atol, rtol = tol[dname]
        sum_atol = atol * math.sqrt(rows)
        err = max(
            check_close(f"layer_norm_bwd dx {tag}", got[0], want[0], atol,
                        rtol),
            check_close(f"layer_norm_bwd dw {tag}", got[1], want[1],
                        sum_atol, rtol),
            check_close(f"layer_norm_bwd db {tag}", got[2], want[2],
                        sum_atol, rtol))
        for _ in range(3):
            again = layer_norm_bwd(dy, x, mean, rstd, w)
            if not all(bool(torch.equal(a, c)) for a, c in zip(got, again)):
                raise AssertionError(f"layer_norm_bwd {tag}: dx/dw/db not "
                                     f"bitwise equal over repeats")
        xl, wl, bl = (t.clone().requires_grad_() for t in (x, w, b))
        y_lib = F.layer_norm(xl, (hidden,), wl, bl, eps)
        esz = x.element_size()
        bms, by = bound_ms(3 * rows * hidden * esz + 8 * rows
                           + 3 * hidden * esz, 12.0 * rows * hidden, dname)
        cases.append({
            "dtype": dname, "rows": rows, "hidden": hidden,
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "dw_db_atol": sum_atol, "bitwise_repeat": True,
            "ms": time_ms(torch, lambda: layer_norm_bwd(dy, x, mean, rstd, w),
                          flush=flush_buf.zero_),
            "plain_ms": time_ms(torch, lambda: layer_norm_bwd_reference(
                dy, x, mean, rstd, w), flush=flush_buf.zero_),
            "library_ms": time_ms(torch, lambda: torch.autograd.grad(
                y_lib, (xl, wl, bl), dy, retain_graph=True),
                flush=flush_buf.zero_),
            "bound_ms": bms, "bound_by": by})
    return cases


# RMSNorm (B #3-4) and the LayerNorm repairs at the sizes the card runs:
# GPT-2-124M's training rows (8192, 768), T5-small's encoder rows (4096,
# 512) and one wide row of GPT-3's width (2048, 12288)
NORM_SHAPES = [  # (name, rows, hidden, (x, weight) types held)
    ("gpt2", TRAIN_ROWS, 768, (("float32", "float32"),
                               ("bfloat16", "bfloat16"),
                               ("bfloat16", "float32"),
                               ("float16", "float16"),
                               ("float16", "float32"))),
    ("t5_small", T5_LN_ROWS[0], T5_HIDDEN, (("float32", "float32"),
                                            ("bfloat16", "bfloat16"),
                                            ("bfloat16", "float32"),
                                            ("float16", "float16"),
                                            ("float16", "float32"))),
    ("wide", 2048, 12288, (("bfloat16", "bfloat16"),
                           ("bfloat16", "float32"))),
]
# the main path's module runs: (name, x shape, module, param type); the
# T5 run keeps bf16 params, the others JAX's fp32 default
NORM_MODULE_RUNS = [
    ("gpt2", (8, 1024, 768), "MixedFusedRMSNorm", "float32"),
    ("t5_small", (8, 512, 512), "FusedRMSNorm", "bfloat16"),
    ("wide", (2, 1024, 12288), "MixedFusedRMSNorm", "float32"),
    ("gpt2_ln", (8, 1024, 768), "MixedFusedLayerNorm", "float32"),
]
# the forward's and the backward's designs, named beside their times in
# the kernels line
NORM_FWD_DESIGN = ("x read once, a row's chunks in registers from load to "
                   "store; one-warp teams (eight a block) to 768 columns, "
                   "teams of up to 16 warps to 12,288 (w and b in shared "
                   "memory once a block, the next row's loads before this "
                   "row's sums), one team of up to 32 warps above; the sum "
                   "order set by _fwd_plan(hidden) alone")
NORM_BWD_DESIGN = ("one pass over dy and x (cp.async ring, a part of the "
                   "rows a block or cluster) + an ordered sum of the "
                   "partial rows (programmatic dependent launch)")
# y, dx: fp32 1e-5; bf16 one bf16 step of the output (rtol 2**-7) over a
# small atol (dx's fp32 sums round in another order before the cast);
# dw, db sum the rows: their atol grows with sqrt(rows)
NORM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-5, 2 ** -7),
            "float16": (1e-5, 2 ** -7)}
NORM_SUM_ATOL = {"float32": 2e-5, "bfloat16": 2e-3, "float16": 2e-3}


def norm_phase(torch, dev, ku):
    """RMSNorm forward and backward (B #3-4), and LayerNorm with a bf16 or
    fp16 x and an fp32 weight and at hidden 12,288 (the repairs; fp16 x
    with an fp16 or fp32 weight is amp's), vs their plain
    versions at NORM_SHAPES in each (x, weight) type: y, dx and the fp32
    row statistics within NORM_TOL (rstd, mean 2e-5), dw (and db) within
    NORM_SUM_ATOL·sqrt(rows), y and the statistics bitwise over two
    launches and for the middle rows alone (:func:`norm_fwd_bitwise`), and
    dx, dw (db) bitwise over two launches.
    Times with the L2 flushed between calls beside the bound, the plain
    version and ``F.rms_norm`` / ``F.layer_norm`` (forward, autograd for
    the backward; the weight cast to x's type where they differ, which
    those calls need). Then the main path: each of NORM_MODULE_RUNS
    forward + backward through its ``normalization`` module on a bf16
    batch, the launch counts reset just before and read just after (one
    forward and one backward kernel, nothing else), output and gradients
    within tolerance of the same module with the plain versions forced,
    and its device time."""
    import torch.nn.functional as F

    import apex_tpu_torch.normalization as norm
    from apex_tpu_torch.ops.layer_norm import (
        layer_norm_bwd, layer_norm_bwd_reference, layer_norm_fwd,
        layer_norm_fwd_reference, rms_norm_bwd, rms_norm_bwd_reference,
        rms_norm_fwd, rms_norm_fwd_reference)

    eps = 1e-5
    gen = torch.Generator(device=dev).manual_seed(7)
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    timed = lambda fn, iters=20: time_ms(torch, fn, iters=iters,
                                         flush=flush_buf.zero_)
    dt_of = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    cases = []
    for (name, rows, hidden, types), kind in itertools.product(
            NORM_SHAPES, ("rms", "ln")):
        for xt, wt in types:
            if kind == "ln" and wt != "float32" and name != "wide":
                continue    # LN's own types: held by the LN phases
            x = (torch.randn(rows, hidden, device=dev, generator=gen) * 2
                 + 0.5).to(dt_of[xt])
            w = (1 + 0.1 * torch.randn(hidden, device=dev,
                                       generator=gen)).to(dt_of[wt])
            b = (0.1 * torch.randn(hidden, device=dev,
                                   generator=gen)).to(dt_of[wt])
            dy = torch.randn(rows, hidden, device=dev,
                             generator=gen).to(dt_of[xt])
            tag = f"{kind} {name} x {xt} w {wt}"
            atol, rtol = NORM_TOL[xt]
            sum_atol = NORM_SUM_ATOL[wt] * math.sqrt(rows)
            if kind == "rms":
                vecs, fwd, fwd_ref = (w,), rms_norm_fwd, rms_norm_fwd_reference
                bwd = lambda stats: rms_norm_bwd(dy, x, *stats, w)
                bwd_ref = lambda stats: rms_norm_bwd_reference(dy, x,
                                                               *stats, w)
                lib_fwd = lambda xx, ww: F.rms_norm(xx, (hidden,), ww, eps)
            else:
                vecs, fwd, fwd_ref = ((w, b), layer_norm_fwd,
                                      layer_norm_fwd_reference)
                bwd = lambda stats: layer_norm_bwd(dy, x, *stats, w)
                bwd_ref = lambda stats: layer_norm_bwd_reference(dy, x,
                                                                 *stats, w)
                lib_fwd = lambda xx, ww: F.layer_norm(
                    xx, (hidden,), ww, b.to(xx.dtype), eps)
            got = fwd(x, *vecs, eps, stats=True)
            want = fwd_ref(x, *vecs, eps)
            torch.cuda.synchronize()
            err = check_close(f"{tag} y", got[0], want[0], atol, rtol)
            stats_err = max(check_close(f"{tag} stats", a, c, 2e-5, 2e-5)
                            for a, c in zip(got[1:], want[1:]))
            norm_fwd_bitwise(torch, f"{tag} forward",
                             lambda xx: fwd(xx, *vecs, eps, stats=True), x)
            stats = got[1:]
            grads = bwd(stats)
            grads_p = bwd_ref(stats)
            torch.cuda.synchronize()
            err = max(err, check_close(f"{tag} dx", grads[0], grads_p[0],
                                       atol, rtol))
            sum_err = max(check_close(f"{tag} dw/db", a, c, sum_atol,
                                      NORM_TOL[wt][1])
                          for a, c in zip(grads[1:], grads_p[1:]))
            if not all(bool(torch.equal(a, c))
                       for a, c in zip(grads, bwd(stats))):
                raise AssertionError(f"{tag}: backward not bitwise equal "
                                     f"over two launches")
            xl = x.clone().requires_grad_()
            wl = w.to(x.dtype).clone().requires_grad_()
            y_lib = lib_fwd(xl, wl)
            xb, wb = x.element_size(), w.element_size()
            n = rows * hidden
            nvec = len(vecs)
            case = {
                "kind": kind, "shape": name, "rows": rows, "hidden": hidden,
                "x_dtype": xt, "w_dtype": wt, "atol": atol, "rtol": rtol,
                "sum_atol": sum_atol, "bitwise_repeat": True,
                "fwd_row_invariant": True,
                "max_abs_err": err, "stats_max_abs_err": stats_err,
                "sum_max_abs_err": sum_err,
                "fwd": dict(zip(("bound_ms", "bound_by"), bound_ms(
                    2 * n * xb + nvec * hidden * wb + 4 * rows * len(stats),
                    4.0 * n, "float32"))),
                "bwd": dict(zip(("bound_ms", "bound_by"), bound_ms(
                    3 * n * xb + (1 + nvec) * hidden * wb
                    + 4 * rows * len(stats), 8.0 * n, "float32")))}
            case["fwd"].update(
                ms=timed(lambda: fwd(x, *vecs, eps, stats=True)),
                plain_ms=timed(lambda: fwd_ref(x, *vecs, eps), 10),
                library_ms=timed(lambda: lib_fwd(x, w.to(x.dtype))))
            case["bwd"].update(
                ms=timed(lambda: bwd(stats)),
                plain_ms=timed(lambda: bwd_ref(stats), 10),
                library_ms=timed(lambda: torch.autograd.grad(
                    y_lib, (xl, wl), dy, retain_graph=True)))
            cases.append(case)
            del x, w, b, dy, got, want, grads, grads_p, xl, wl, y_lib
    # the main path: the modules, forward + backward
    runs = []
    for name, shape, module, pt in NORM_MODULE_RUNS:
        x = torch.randn(*shape, device=dev, generator=gen).bfloat16()
        dy = torch.randn(*shape, device=dev, generator=gen).bfloat16()
        hidden = shape[-1]
        w0 = 1 + 0.1 * torch.randn(hidden, device=dev, generator=gen)
        b0 = 0.1 * torch.randn(hidden, device=dev, generator=gen)
        outs, launches = [], None
        for plain in (False, True):
            mod = getattr(norm, module)(hidden, param_dtype=dt_of[pt],
                                        device=dev)
            with torch.no_grad():
                mod.weight.copy_(w0)
                if mod.bias is not None:
                    mod.bias.copy_(b0)
            xl = x.clone().requires_grad_()

            def run():
                y = mod(xl)
                y.backward(dy)
                return y
            if plain:
                with ku.force_plain():
                    y = run()
            else:
                ku.reset_launch_counts()
                y = run()
                torch.cuda.synchronize()
                launches = ku.launch_counts()
            outs.append([y.detach(), xl.grad]
                        + [t.grad for t in (mod.weight, mod.bias)
                           if t is not None])
        kname = "rms_norm" if "RMS" in module else "layer_norm"
        want = {f"{kname}_fwd": 1, f"{kname}_bwd": 1}
        if launches != want:
            raise AssertionError(f"{module} {name}: launches {launches}, "
                                 f"want {want}")
        rows = x.numel() // hidden
        sum_tol = (NORM_SUM_ATOL[pt] * math.sqrt(rows), NORM_TOL[pt][1])
        err = max(check_close(f"{module} {name} {what}", a, c, *tol)
                  for what, a, c, tol in zip(
                      ("y", "dx", "dw", "db"), *outs,
                      (NORM_TOL["bfloat16"], NORM_TOL["bfloat16"], sum_tol,
                       sum_tol)))
        if not all(bool(t.isfinite().all()) for t in outs[0]):
            raise AssertionError(f"{module} {name}: not finite")
        mod = getattr(norm, module)(hidden, param_dtype=dt_of[pt],
                                    device=dev)
        xl = x.clone().requires_grad_()
        runs.append({
            "name": name, "module": module, "shape": list(shape),
            "param_dtype": pt, "launches": launches, "max_abs_err": err,
            "fwd_bwd_ms": timed(lambda: mod(xl).backward(dy))})
        del x, dy, outs, xl, mod
    torch.cuda.empty_cache()
    return {"cases": cases, "runs": runs}


# the codec at GPT-2-124M's gradient as one flat buffer, padded to whole
# 32-row steps of 256-element blocks (JAX's gate): int8 at block 256 and
# int4 at group 128 over the same buffer, fp32 and bf16
CODEC_GRAD_ELEMS = 124_475_904
CODEC_SEED = 1234


def codec_phase(torch, dev, ku):
    """The codec kernels (B #16-18) vs their plain versions at
    ``padded_size(124,475,904, 256·32)`` elements, fp32, bf16 and fp16
    (since C6: read in its own type, upcast in the kernel, its codes and
    scales bitwise the fp32 path's on the same values), int8
    (block 256) and int4 (group 128, the nibbles packed and unpacked in
    the kernels), nearest and stochastic: codes and scales bitwise equal
    (the same IEEE quotient, rint and counter hash), the codes bitwise
    over two launches, dequantize bitwise (from the nearest codes of both
    types); times beside the bound, the plain version and the public
    entry point's (which includes any reshape, pack or unpack around the
    kernel); no single PyTorch call computes the codec. Then the main
    path: ``quantize_blockwise`` + ``dequantize_blockwise`` (and the int4
    pair) on the fp32 buffer through the public entry points, nearest and
    stochastic, the launch counts reset just before and read just after
    (one quantize and one dequantize launch each), the round trip within
    half a step (nearest) or one step (stochastic) of x, finite; the
    pair's device time; the same main path on the buffer in fp16 beside
    it, each pair with its byte bound."""
    from apex_tpu_torch.comm import quantize as pq

    n = pq.padded_size(CODEC_GRAD_ELEMS, 256 * pq._ROWS_PER_STEP)
    gen = torch.Generator(device=dev).manual_seed(11)
    base = torch.randn(n, device=dev, generator=gen) * 1e-3
    public = {8: (pq.quantize_blockwise, pq.dequantize_blockwise),
              4: (pq.quantize_blockwise_int4, pq.dequantize_blockwise_int4)}
    cases = []
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        dname = str(dt).split(".")[1]
        x = base.to(dt)
        for bits, block in ((8, 256), (4, 128)):
            qmax = pq.qmax_for_bits(bits)
            packed = bits == 4
            code_bytes = n / 2 if packed else n
            quant, dequant = public[bits]
            x2d = x.view(-1, block)
            for seed in (None, CODEC_SEED):
                mode = "nearest" if seed is None else "stochastic"
                tag = f"codec {dname} int{bits} {mode}"
                q, s = pq.quantize_blocks(x2d, qmax, seed, packed)
                q_p, s_p = pq.quantize_blocks_reference(x2d, qmax, seed,
                                                        packed)
                torch.cuda.synchronize()
                if not (torch.equal(q, q_p) and torch.equal(s, s_p)):
                    raise AssertionError(
                        f"{tag}: codes differ at "
                        f"{int((q != q_p).sum())} of {q.numel()} bytes, "
                        f"scales at {int((s != s_p).sum())}")
                if not torch.equal(q, pq.quantize_blocks(x2d, qmax, seed,
                                                         packed)[0]):
                    raise AssertionError(f"{tag}: two launches differ")
                if dt == torch.float16:
                    q32, s32 = pq.quantize_blocks(x2d.float(), qmax, seed,
                                                  packed)
                    if not (torch.equal(q, q32) and torch.equal(s, s32)):
                        raise AssertionError(f"{tag}: not the fp32 path's "
                                             f"codes on the same values")
                    del q32, s32
                del q_p, s_p
                case = {"dtype": dname, "bits": bits, "block": block,
                        "mode": mode, "packed": packed, "elements": n,
                        "bitwise": True, "max_abs_err": 0.0,
                        "library_ms": None}
                case.update(zip(("bound_ms", "bound_by"), bound_ms(
                    n * x.element_size() + code_bytes + 4 * n / block,
                    3.0 * n, "float32")))
                case.update(
                    ms=time_ms(torch, lambda: pq.quantize_blocks(
                        x2d, qmax, seed, packed), iters=20),
                    plain_ms=time_ms(torch, lambda: pq.quantize_blocks_reference(
                        x2d, qmax, seed, packed), iters=5),
                    public_ms=time_ms(torch, lambda: quant(
                        x, block, seed is not None, seed), iters=20))
                if seed is None:
                    y = pq.dequantize_blocks(q, s, packed)
                    if not torch.equal(y, pq.dequantize_blocks_reference(
                            q, s, packed)):
                        raise AssertionError(f"{tag}: dequantize differs")
                    flat = q.view(-1)
                    deq = {"max_abs_err": 0.0, "bitwise": True,
                           "library_ms": None}
                    deq.update(zip(("bound_ms", "bound_by"), bound_ms(
                        code_bytes + 4 * n / block + 4 * n, 1.0 * n,
                        "float32")))
                    deq.update(
                        ms=time_ms(torch, lambda: pq.dequantize_blocks(
                            q, s, packed), iters=20),
                        plain_ms=time_ms(
                            torch, lambda: pq.dequantize_blocks_reference(
                                q, s, packed), iters=5),
                        public_ms=time_ms(torch, lambda: dequant(
                            flat, s, block), iters=20))
                    case["dequantize"] = deq
                    del y, flat
                cases.append(case)
                del q, s
        del x, x2d
    # the main path: the public entry points on the fp32 gradient buffer;
    # then on the buffer in fp16
    runs = []
    half = base.half()
    for src, bits, block, stochastic in (
            *((base, b, bl, st) for b, bl in ((8, 256), (4, 128))
              for st in (False, True)),
            *((half, b, bl, st) for b, bl in ((8, 256), (4, 128))
              for st in (False, True))):
        quant, dequant = public[bits]
        seed = CODEC_SEED if stochastic else None
        ku.reset_launch_counts()
        codes, scales = quant(src, block, stochastic, seed)
        back = dequant(codes, scales, block)
        torch.cuda.synchronize()
        launches = ku.launch_counts()
        mode = "stochastic" if stochastic else "nearest"
        want = {f"quantize_blockwise[{mode}]": 1,
                "dequantize_blockwise": 1}
        if launches != want:
            raise AssertionError(f"codec int{bits} {mode}: launches "
                                 f"{launches}, want {want}")
        err = (back - src.float()).view(-1, block).abs()
        step = scales[:, None] * (1.0 if stochastic else 0.5)
        # fp32 rounding of y and of q·scale: well under 1e-4 of a step
        if not bool(back.isfinite().all()) or bool(
                (err > step * (1 + 1e-4)).any()):
            raise AssertionError(f"codec int{bits} {mode}: round trip "
                                 f"beyond {'one' if stochastic else 'half a'}"
                                 f" step")
        runs.append({"dtype": str(src.dtype).split(".")[1],
                     "bits": bits, "block": block, "mode": mode,
                     "elements": n, "launches": launches,
                     "max_abs_err": float(err.max()),
                     "max_err_in_steps": float((err / scales[:, None])
                                               .max())})
        del codes, scales, back, err, step
        runs[-1]["pair_ms"] = time_ms(torch, lambda: dequant(
            *quant(src, block, stochastic, seed), block), iters=20)
        code_bytes = n / 2 if bits == 4 else n
        runs[-1].update(zip(("pair_bound_ms", "pair_bound_by"), bound_ms(
            n * src.element_size() + 2 * (code_bytes + 4 * n / block)
            + 4 * n, 4.0 * n, "float32")))
    del base, half
    torch.cuda.empty_cache()
    return {"cases": cases, "runs": runs}


FLASH_SHAPES = [  # (name, batch, heads, sq, sk, d, causal, dropout rate, bias)
    ("flagship", 8, 12, 1024, 1024, 64, True, 0.0, False),
    ("non_causal", 2, 12, 512, 512, 64, False, 0.0, False),
    ("dropout", 2, 12, 512, 512, 64, True, 0.1, False),
    # T5-small: encoder and decoder self-attention with their fp32
    # (heads, sq, sk) bias, the rectangular cross-attention without one
    ("t5_enc", 8, 8, 512, 512, 64, False, 0.0, True),
    ("t5_dec", 8, 8, 128, 128, 64, True, 0.0, True),
    ("t5_cross", 8, 8, 128, 512, 64, False, 0.0, False),
    # shapes JAX's kernel takes that the first kernels refused: GPT-2's
    # width as 6 heads of 128, head_dim 40, and lengths that end in a
    # partial 64-row tile, causal and with a T5 bias
    ("gpt_d128", 8, 6, 1024, 1024, 128, True, 0.0, False),
    ("d40", 2, 12, 512, 512, 40, True, 0.0, False),
    ("tail_causal", 2, 12, 1000, 1000, 64, True, 0.0, False),
    ("tail_bias", 8, 8, 200, 328, 64, False, 0.0, True),
    # head dims 136-256, the kernels' D = 256 instantiation: 256 (Gemma's
    # head width) and 192, causal, and with a T5-style bias
    ("d256", 2, 8, 1024, 1024, 256, True, 0.0, False),
    ("d192", 2, 8, 1024, 1024, 192, True, 0.0, False),
    ("d256_bias", 2, 8, 512, 512, 256, False, 0.0, True),
    ("d192_bias", 2, 8, 256, 256, 192, True, 0.0, True),
    # head dims 264-512: the CUDA-core kernels' D = 512 (32-row tiles),
    # in both types, causal, and with a bias
    ("d512", 1, 4, 512, 512, 512, True, 0.0, False),
    ("d320_bias", 2, 4, 256, 256, 320, False, 0.0, True),
    # head dims 520-2048: D = 1024 (16-row tiles) causal, and D = 2048
    # (8-row tiles) with a bias
    ("d1024", 1, 2, 256, 256, 1024, True, 0.0, False),
    ("d2048_bias", 1, 2, 128, 128, 2048, False, 0.0, True),
    # above 2048: the wide kernels (the head dim in 2048-column chunks),
    # causal with a bias at a tail, causal with dropout, and rectangular
    # with a bias
    ("d2056_bias", 1, 2, 136, 136, 2056, True, 0.0, True),
    ("d4096", 1, 2, 128, 128, 4096, True, 0.1, False),
    ("d4096_bias", 1, 2, 72, 200, 4096, False, 0.0, True),
]
# the shapes of FLASH_SHAPES that run in the D = 256 instantiation, and in
# D = 512-2048 (the CUDA-core kernels in both types), without and with a
# bias
D256_SHAPES = ("d256", "d192", "d256_bias", "d192_bias")
D_WIDE_SHAPES = ("d512", "d1024", "d4096")
D_WIDE_BIAS_SHAPES = ("d320_bias", "d2048_bias", "d2056_bias", "d4096_bias")
# d(bias) in both input types: fp32 products of the same inputs on both
# sides, fp32 sums over the batch in another order
DBIAS_TOL = (1e-4, 1e-4)
# the shapes also held and timed in fp16: GPT-2's (the amp fp16 path's),
# T5-small's three, head_dim 256 (tensor cores) and above 256 (the
# CUDA-core kernels, and the wide ones with a bias)
FLASH_FP16_SHAPES = ("flagship", "dropout", "non_causal", "t5_enc",
                     "t5_dec", "t5_cross", "d256", "d512", "d2056_bias")


def flash_bounds(bh, sq, sk, d, causal, esz, dname, heads=0):
    """(fwd, dq, dkv, dbias) bounds: max(FLOPs / peak, bytes / 3.35 TB/s),
    the causal FLOPs half of 4, 6, 8 and 4 · bh·sq·sk·d (d(bias) forms the
    two products q·kᵀ and dO·vᵀ); bytes count each input read once and
    each output written once (lse, delta fp32; with ``heads`` an fp32
    (heads, sq, sk) bias read by each kernel and written once by d(bias)).
    """
    half = 0.5 if causal else 1.0
    tq = bh * sq * d * esz         # one (bh, sq, d) tensor
    tk = bh * sk * d * esz         # one (bh, sk, d) tensor
    row = 4 * bh * sq              # one fp32 (bh, sq) vector
    bias = 4 * heads * sq * sk     # the fp32 bias, or d(bias)
    ops = half * bh * sq * sk * d
    return (bound_ms(2 * tq + 2 * tk + row + bias, 4 * ops, dname),
            bound_ms(3 * tq + 2 * tk + 2 * row + bias, 6 * ops, dname),
            bound_ms(2 * tq + 4 * tk + 2 * row + bias, 8 * ops, dname),
            bound_ms(2 * tq + 2 * tk + 2 * row + 2 * bias, 4 * ops, dname))


def flash_phase(torch, dev):
    """The flash kernels vs their plain versions at each shape of
    FLASH_SHAPES, fp32 and bf16 (lse and delta from the kernel forward feed
    the backwards), each case on the route ``_flash_route`` gives it (the
    tensor-core kernels for bf16 up to head_dim 256, the CUDA-core kernels
    otherwise): o, lse, dq, dk, dv and, with a bias, d(bias), which must
    also be zero above the causal diagonal; the forward, dQ, dK/dV and
    d(bias) bitwise equal over two launches.
    Tolerance: fp32 atol/rtol 1e-4 (sums over up to 1024 keys
    in another order); bf16 one output rounding (rtol 2**-7) plus atol
    1e-2 (p and ds are rounded to bf16 before their products, at other
    running maxima; the largest error measured at these shapes is one
    bf16 step at |o| < 2, 7.8e-3); fp16 at FLASH_FP16_SHAPES under the
    bf16 gate, on the same routes; d(bias) DBIAS_TOL in every type. Times
    at every shape (flushing the L2 between calls) beside SDPA forward and
    backward on the (batch, heads, s, d) view; with a bias, SDPA takes it
    (and the causal mask) as a float ``attn_mask`` expanded over the
    batch, and its backward sums the mask's gradient over the batch."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.attention import (
        _flash_route, flash_attention_bwd_dbias,
        flash_attention_bwd_dbias_reference, flash_attention_bwd_dkv,
        flash_attention_bwd_dq, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_fwd_reference)

    tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7),
           "float16": (1e-2, 2 ** -7)}
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    seed = 1234
    cases = []
    for name, b, heads, sq, sk, d, causal, rate, has_bias in FLASH_SHAPES:
        bh = b * heads
        for dt in (torch.float32, torch.bfloat16,
                   *((torch.float16,) if name in FLASH_FP16_SHAPES else ())):
            dname = str(dt).split(".")[1]
            q, do = (torch.randn(bh, sq, d, device=dev, generator=gen).to(dt)
                     for _ in range(2))
            k, v = (torch.randn(bh, sk, d, device=dev, generator=gen).to(dt)
                    for _ in range(2))
            bias = (torch.randn(heads, sq, sk, device=dev, generator=gen)
                    if has_bias else None)
            args = (1.0 / math.sqrt(d), causal, rate, seed)
            kw = {"bias": bias}
            o, lse = flash_attention_fwd(q, k, v, *args, **kw)
            o_p, lse_p = flash_attention_fwd_reference(q, k, v, *args, **kw)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, *args, **kw)
            dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, *args,
                                             **kw)
            want = flash_attention_bwd_reference(q, k, v, o, lse, do, *args,
                                                 **kw)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            tag = f"{name} {dname}"
            case = {"shape": name, "dtype": dname, "batch": b,
                    "heads": heads, "bh": bh, "sq": sq, "sk": sk,
                    "head_dim": d, "causal": causal, "dropout": rate,
                    "bias": has_bias, "atol": atol, "rtol": rtol,
                    "route": _flash_route(dt, d),
                    "fwd": {"max_abs_err": max(
                        check_close(f"flash fwd o {tag}", o, o_p, atol, rtol),
                        check_close(f"flash fwd lse {tag}", lse, lse_p, 1e-4,
                                    1e-5))},
                    "dq": {"max_abs_err": check_close(
                        f"flash dq {tag}", dq, want[0], atol, rtol)},
                    "dkv": {"max_abs_err": max(
                        check_close(f"flash dk {tag}", dk, want[1], atol,
                                    rtol),
                        check_close(f"flash dv {tag}", dv, want[2], atol,
                                    rtol))}}
            del o_p, lse_p, want
            # the forward, dQ and dK/dV: the same bits from a second launch
            o2, lse2 = flash_attention_fwd(q, k, v, *args, **kw)
            dq2 = flash_attention_bwd_dq(q, k, v, do, lse, delta, *args,
                                         **kw)
            dk2, dv2 = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                               *args, **kw)
            if not all(torch.equal(a, b2) for a, b2 in (
                    (o, o2), (lse, lse2), (dq, dq2), (dk, dk2), (dv, dv2))):
                raise AssertionError(f"flash fwd / dq / dkv {tag}: two "
                                     f"launches differ")
            for key in ("fwd", "dq", "dkv"):
                case[key]["bitwise_repeat"] = True
            del o2, lse2, dq2, dk2, dv2
            keys = ("fwd", "dq", "dkv")
            if has_bias:
                db = flash_attention_bwd_dbias(q, k, v, do, lse, delta, *args,
                                               **kw)
                db_p = flash_attention_bwd_dbias_reference(q, k, v, o, lse,
                                                           do, *args, **kw)
                torch.cuda.synchronize()
                case["dbias"] = {
                    "max_abs_err": check_close(f"flash dbias {tag}", db, db_p,
                                               *DBIAS_TOL),
                    "atol": DBIAS_TOL[0], "rtol": DBIAS_TOL[1]}
                if causal and bool(db.triu(1 + sk - sq).any()):
                    raise AssertionError(f"flash dbias {tag}: nonzero above "
                                         f"the causal diagonal")
                if not torch.equal(db, flash_attention_bwd_dbias(
                        q, k, v, do, lse, delta, *args, **kw)):
                    raise AssertionError(f"flash dbias {tag}: two launches "
                                         f"differ")
                case["dbias"]["bitwise_repeat"] = True
                keys += ("dbias",)
                del db, db_p
            # library yardstick: SDPA on the (batch, heads, s, d) view, fwd
            # and the whole bwd (dq, dk, dv and d(mask) in one call)
            q4, k4, v4 = (t.view(b, heads, -1, d).clone().requires_grad_()
                          for t in (q, k, v))
            sdpa = {"dropout_p": rate} if rate else {}
            leaves = (q4, k4, v4)
            if has_bias:
                b_leaf = bias.clone().requires_grad_()
                m = b_leaf
                if causal:
                    m = m.masked_fill(torch.ones(
                        sq, sk, dtype=torch.bool, device=dev).triu(1),
                        float("-inf"))
                sdpa["attn_mask"] = m.to(dt).expand(b, heads, sq, sk)
                leaves += (b_leaf,)
            else:
                sdpa["is_causal"] = causal
            o_lib = F.scaled_dot_product_attention(q4, k4, v4, **sdpa)
            do4 = do.view(b, heads, sq, d)
            timed = lambda fn: time_ms(torch, fn, iters=20,
                                       flush=flush_buf.zero_)
            lib_bwd = timed(lambda: torch.autograd.grad(
                o_lib, leaves, do4, retain_graph=True))
            plain_bwd = timed(lambda: flash_attention_bwd_reference(
                q, k, v, o, lse, do, *args, **kw))
            case["fwd"].update(
                ms=timed(lambda: flash_attention_fwd(q, k, v, *args, **kw)),
                plain_ms=timed(lambda: flash_attention_fwd_reference(
                    q, k, v, *args, **kw)),
                library_ms=timed(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, **sdpa)))
            case["dq"].update(
                ms=timed(lambda: flash_attention_bwd_dq(
                    q, k, v, do, lse, delta, *args, **kw)),
                plain_ms=plain_bwd, library_ms=lib_bwd)
            case["dkv"].update(
                ms=timed(lambda: flash_attention_bwd_dkv(
                    q, k, v, do, lse, delta, *args, **kw)),
                plain_ms=plain_bwd, library_ms=lib_bwd)
            if has_bias:
                case["dbias"].update(
                    ms=timed(lambda: flash_attention_bwd_dbias(
                        q, k, v, do, lse, delta, *args, **kw)),
                    plain_ms=timed(
                        lambda: flash_attention_bwd_dbias_reference(
                            q, k, v, o, lse, do, *args, **kw)),
                    library_ms=lib_bwd)
            bounds = flash_bounds(bh, sq, sk, d, causal, q.element_size(),
                                  dname, heads if has_bias else 0)
            for key, (bms, by) in zip(keys, bounds):
                case[key].update(bound_ms=bms, bound_by=by)
            cases.append(case)
            del q, k, v, do, o, lse, delta, dq, dk, dv, bias, q4, k4, v4
            del o_lib, sdpa, leaves
    torch.cuda.empty_cache()
    return cases


# the packed path: one row of PACK_T tokens at GPT-2-124M's attention width
# (12 heads of 64), documents of 64-1024 tokens drawn from numpy seed 1 and
# packed until the next would overflow; the rest is padding (segment -1)
PACK_T, PACK_HEADS, PACK_D = 8192, 12, 64
PACK_MISALIGNED_T = 8100           # not a multiple of the 64-row tile
# the same packed row at head_dim 256 (the kernels' D = 256
# instantiation; Gemma's head width), 4 heads, and at 512 (D = 512, 32-row
# tiles), 2 heads, causal
PACK_D256_HEADS = 4
PACK_D512_HEADS = 2
# a short packed row (documents of 24-120 tokens from numpy seed 2, the
# rest padding) at the head dims above 2048 (the wide kernels), 2 heads:
# head_dim 2056 causal and 4096 bidirectional
PACK_WIDE_T, PACK_WIDE_HEADS = 256, 2
PACK_WIDE_CASES = ((2056, True), (4096, False))
def varlen_entries(dtype, d: int):
    """The varlen forward, dQ and dK/dV entries one packed forward plus
    backward launches at this dtype and head dim, on their route
    (``_varlen_route``: bf16 up to 256 on the tensor cores)."""
    from apex_tpu_torch.ops.attention_varlen import _varlen_route

    mma = "mma_" if _varlen_route(dtype, d) == "tensor_core" else ""
    return tuple(f"flash_varlen_{mma}{k}" for k in ("fwd", "bwd_dq",
                                                     "bwd_dkv"))


def varlen_library(torch, q, k, v, do, lens, causal):
    """PyTorch's own varlen flash attention on the documents ``lens`` of
    the packed row in q, k, v, dO ((1, heads, T, d) bf16): q, k, v as
    (tokens, heads, d) cut to the real tokens, with their cu_seqlens.
    ``torch.nn.attention.varlen.varlen_attn`` (``window_size=(-1, 0)``
    when causal) where this torch has it, else
    ``aten._flash_attention_forward`` / ``_backward`` with ``cum_seq_q`` /
    ``cum_seq_k``. Returns ``(api, fwd, bwd, o)``: the call's name, one
    forward, one backward (dq, dk, dv) and the forward's output, (1,
    heads, real tokens, d). A yardstick only: the port never calls it."""
    n = sum(lens)
    cu = torch.tensor([0, *itertools.accumulate(lens)], dtype=torch.int32,
                      device=q.device)
    q3, k3, v3, do3 = (x[0, :, :n].transpose(0, 1).contiguous()
                       for x in (q, k, v, do))
    mx, scale = max(lens), 1.0 / math.sqrt(q.shape[-1])
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError:
        varlen_attn = None
    if varlen_attn is not None:
        window = (-1, 0) if causal else (-1, -1)

        def fwd():
            return varlen_attn(q3, k3, v3, cu, cu, mx, mx, scale=scale,
                               window_size=window)
        leaves = [x.clone().requires_grad_() for x in (q3, k3, v3)]
        out = varlen_attn(*leaves, cu, cu, mx, mx, scale=scale,
                          window_size=window)

        def bwd():
            return torch.autograd.grad(out, leaves, do3, retain_graph=True)
        api = "torch.nn.attention.varlen.varlen_attn"
    else:
        def fwd():
            return torch.ops.aten._flash_attention_forward(
                q3, k3, v3, cu, cu, mx, mx, 0.0, causal, False, scale=scale)
        out, lse, rng, unused, _ = fwd()

        def bwd():
            return torch.ops.aten._flash_attention_backward(
                do3, q3, k3, v3, out, lse, cu, cu, mx, mx, 0.0, causal, rng,
                unused, scale=scale)
        api = "aten._flash_attention_forward/_backward"
    return api, fwd, bwd, out.detach().transpose(0, 1)[None]


def packed_lengths(total: int = PACK_T, seed: int = 1, lo: int = 64,
                   hi: int = 1024):
    """Document lengths uniform in [lo, hi] from numpy ``seed``, drawn
    until the next would overflow ``total``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = []
    while True:
        n = int(rng.integers(lo, hi + 1))
        if sum(lens) + n > total:
            return lens
        lens.append(n)


def packed_segments(torch, dev, lens, total: int):
    """(1, total) int32 segment ids of the documents ``lens``, then -1."""
    seg = torch.full((1, total), -1, dtype=torch.int32, device=dev)
    start = 0
    for i, n in enumerate(lens):
        seg[0, start:start + n] = i
        start += n
    return seg


def live_scores(lens, causal: bool) -> int:
    """Scores a head must form: Σ L² over the documents, Σ L(L+1)/2 when
    causal."""
    return sum(n * (n + 1) // 2 if causal else n * n for n in lens)


def varlen_bounds(heads, t, d, s_live, esz, dname):
    """(fwd, dq, dkv) bounds of the varlen kernels: flash's byte counts
    with T tokens for both sq and sk, plus the int32 segment ids read, and
    4, 6 and 8 · heads · S · d operations over the S live scores of a
    head."""
    tq = heads * t * d * esz       # one (heads, T, d) tensor
    row = 4 * heads * t            # one fp32 (heads, T) vector
    seg = 2 * 4 * t                # seg_q and seg_k
    ops = heads * s_live * d
    return (bound_ms(4 * tq + row + seg, 4 * ops, dname),
            bound_ms(5 * tq + 2 * row + seg, 6 * ops, dname),
            bound_ms(6 * tq + 2 * row + seg, 8 * ops, dname))


def varlen_phase(torch, dev):
    """The varlen kernels (B #9-11) vs their plain versions on the card at
    the packed path's shape (one row of PACK_T tokens, 12 heads of 64, the
    documents of ``packed_lengths()``), fp32 and bf16, causal and not:
    o, lse, dq, dk, dv within flash's tolerances (fp32 atol/rtol 1e-4, bf16
    atol 1e-2 + rtol 2**-7), pad rows of o and dq and pad keys of dk and
    dv exactly 0, pad rows' lse NEG_INF. Then the front door
    (``flash_attention_varlen``) at a misaligned total (PACK_MISALIGNED_T,
    padded to the tile and sliced back): output and q/k/v gradients
    kernels vs plain versions forced, same tolerances. Times at every
    shape (L2 flushed between calls) beside the bound, the plain version,
    SDPA with the dense block-diagonal boolean mask (pad rows attend to
    themselves, so no row is empty; a yardstick only) and the dense causal
    flash kernels at the same T, whose ratio shows the block skipping.
    Each kernel is timed as the packed path calls it, with the tile tables
    built beforehand (once per call of ``VarlenAttention``, shared by the
    three kernels); their build is timed beside (``tables_ms``), and each
    kernel again with the tables built inside the timed call
    (``ms_tables_in_call``). dK/dV runs on its route (bf16 up to head_dim
    256: the tensor-core kernel of ``csrc/flash_varlen_mma.cu``).
    The same row at head_dim 256 (PACK_D256_HEADS heads) and 512
    (PACK_D512_HEADS heads), causal, is held and timed the same way,
    without the dense flash comparison. fp16 (the bf16 gate) at head_dim
    64 and 512, causal."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import _kernel_util as ku
    from apex_tpu_torch.ops.attention import (flash_attention_bwd_dkv,
                                              flash_attention_bwd_dq,
                                              flash_attention_fwd)
    from apex_tpu_torch.ops.attention_varlen import (
        NEG_INF, _tables, _varlen_route, flash_attention_varlen,
        flash_varlen_bwd_dkv, flash_varlen_bwd_dq, flash_varlen_bwd_reference,
        flash_varlen_fwd, flash_varlen_fwd_reference)

    tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7),
           "float16": (1e-2, 2 ** -7)}
    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    heads, t, d = PACK_HEADS, PACK_T, PACK_D
    lens = packed_lengths()
    seg = packed_segments(torch, dev, lens, t)
    pad = seg[0] < 0
    timed = lambda fn, iters=20: time_ms(torch, fn, iters=iters,
                                         flush=flush_buf.zero_)
    dense = {}                      # dense causal flash ms per dtype
    cases = []
    for heads, d, causal in ((heads, d, True), (heads, d, False),
                             (PACK_D256_HEADS, 256, True),
                             (PACK_D512_HEADS, 512, True)):
        s_live = live_scores(lens, causal)
        allowed = (seg[0][:, None] == seg[0][None, :]) & ~pad[:, None]
        if causal:
            allowed &= torch.ones(t, t, dtype=torch.bool, device=dev).tril()
        sdpa_mask = allowed | torch.eye(t, dtype=torch.bool, device=dev)
        # fp16 on the causal row at head_dim 64 (tensor cores) and 512
        # (CUDA cores)
        fp16 = (torch.float16,) if causal and d in (PACK_D, 512) else ()
        for dt in (torch.float32, torch.bfloat16, *fp16):
            dname = str(dt).split(".")[1]
            q, k, v, do = (torch.randn(1, heads, t, d, device=dev,
                                       generator=gen).to(dt)
                           for _ in range(4))
            args = (1.0 / math.sqrt(d), causal)
            vargs = (q, k, v, seg, seg)
            o, lse = flash_varlen_fwd(*vargs, *args)
            o_p, lse_p = flash_varlen_fwd_reference(*vargs, *args)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            dq = flash_varlen_bwd_dq(*vargs, do, lse, delta, *args)
            dk, dv = flash_varlen_bwd_dkv(*vargs, do, lse, delta, *args)
            want = flash_varlen_bwd_reference(*vargs, o, lse, do, *args)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            tag = f"varlen {'causal' if causal else 'bidirectional'} {dname}"
            case = {"dtype": dname, "causal": causal, "tokens": t,
                    "heads": heads, "head_dim": d, "documents": len(lens),
                    "pad_tokens": int(pad.sum()), "live_scores": s_live,
                    "atol": atol, "rtol": rtol,
                    "entries": dict(zip(("fwd", "dq", "dkv"),
                                        varlen_entries(dt, d))),
                    "fwd": {"max_abs_err": max(
                        check_close(f"{tag} o", o, o_p, atol, rtol),
                        check_close(f"{tag} lse", lse, lse_p, 1e-4, 1e-5))},
                    "dq": {"max_abs_err": check_close(f"{tag} dq", dq,
                                                      want[0], atol, rtol)},
                    "dkv": {"max_abs_err": max(
                        check_close(f"{tag} dk", dk, want[1], atol, rtol),
                        check_close(f"{tag} dv", dv, want[2], atol, rtol))}}
            for name, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                if bool(x[0][:, pad].any()):
                    raise AssertionError(f"{tag}: {name} of pad rows not 0")
            if not bool((lse[0, :, pad] == NEG_INF).all()):
                raise AssertionError(f"{tag}: pad rows' lse not NEG_INF")
            o2, lse2 = flash_varlen_fwd(*vargs, *args)
            dq2 = flash_varlen_bwd_dq(*vargs, do, lse, delta, *args)
            dk2, dv2 = flash_varlen_bwd_dkv(*vargs, do, lse, delta, *args)
            for key, pairs in (("fwd", ((o, o2), (lse, lse2))),
                               ("dq", ((dq, dq2),)),
                               ("dkv", ((dk, dk2), (dv, dv2)))):
                if not all(torch.equal(a, b) for a, b in pairs):
                    raise AssertionError(f"{tag}: {key} not bitwise equal "
                                         f"over repeats")
                case[key]["bitwise_repeat"] = True
            del o_p, lse_p, want, o2, lse2, dq2, dk2, dv2
            mma = _varlen_route(dt, d) == "tensor_core"
            tabs = _tables(seg, seg, causal, mma)
            case["tables_ms"] = timed(lambda: _tables(seg, seg, causal, mma))
            q4, k4, v4 = (x.clone().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(q4, k4, v4,
                                                   attn_mask=sdpa_mask)
            lib_bwd = timed(lambda: torch.autograd.grad(
                o_lib, (q4, k4, v4), do, retain_graph=True), 10)
            plain_bwd = timed(lambda: flash_varlen_bwd_reference(
                *vargs, o, lse, do, *args), 5)
            if d == PACK_D and dname not in dense:
                q3, k3, v3, do3 = (x.view(heads, t, d) for x in (q, k, v, do))
                lse3, delta3 = lse.view(heads, t, 1), delta.view(heads, t, 1)
                sc = args[0]
                dense[dname] = {
                    "fwd": timed(lambda: flash_attention_fwd(
                        q3, k3, v3, sc, True)),
                    "dq": timed(lambda: flash_attention_bwd_dq(
                        q3, k3, v3, do3, lse3, delta3, sc, True)),
                    "dkv": timed(lambda: flash_attention_bwd_dkv(
                        q3, k3, v3, do3, lse3, delta3, sc, True))}
            case["fwd"].update(
                ms=timed(lambda: flash_varlen_fwd(*vargs, *args,
                                                  tables=tabs)),
                ms_tables_in_call=timed(lambda: flash_varlen_fwd(*vargs,
                                                                 *args)),
                plain_ms=timed(lambda: flash_varlen_fwd_reference(
                    *vargs, *args), 5),
                library_ms=timed(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, attn_mask=sdpa_mask), 10))
            case["dq"].update(
                ms=timed(lambda: flash_varlen_bwd_dq(*vargs, do, lse, delta,
                                                     *args, tables=tabs)),
                ms_tables_in_call=timed(lambda: flash_varlen_bwd_dq(
                    *vargs, do, lse, delta, *args)),
                plain_ms=plain_bwd, library_ms=lib_bwd)
            case["dkv"].update(
                ms=timed(lambda: flash_varlen_bwd_dkv(*vargs, do, lse, delta,
                                                      *args, tables=tabs)),
                ms_tables_in_call=timed(lambda: flash_varlen_bwd_dkv(
                    *vargs, do, lse, delta, *args)),
                plain_ms=plain_bwd, library_ms=lib_bwd)
            # PyTorch's varlen flash attention on the same documents (bf16,
            # head_dim <= 256): a yardstick, outside every gate
            lib = {"api": None, "fwd_ms": None, "bwd_ms": None}
            if mma:
                try:
                    api, lib_f, lib_b, o_lib3 = varlen_library(
                        torch, q, k, v, do, lens, causal)
                    lib = {"api": api, "fwd_ms": timed(lib_f, 10),
                           "bwd_ms": timed(lib_b, 10),
                           "o_max_abs_diff": float(
                               (o_lib3.float() - o[:, :, :sum(lens)].float())
                               .abs().max())}
                    del o_lib3
                except Exception as e:     # recorded, not gated
                    lib["error"] = f"{type(e).__name__}: {e}"[:300]
            case["varlen_library"] = lib
            for key, ms in (("fwd", lib["fwd_ms"]), ("dq", lib["bwd_ms"]),
                            ("dkv", lib["bwd_ms"])):
                case[key]["varlen_library_ms"] = ms
            for key, (bms, by) in zip(("fwd", "dq", "dkv"), varlen_bounds(
                    heads, t, d, s_live, q.element_size(), dname)):
                case[key].update(bound_ms=bms, bound_by=by)
                if d == PACK_D:
                    case[key].update(
                        dense_causal_flash_ms=dense[dname][key],
                        ratio_to_dense_causal_flash=(case[key]["ms"]
                                                     / dense[dname][key]))
            cases.append(case)
            del q, k, v, do, o, lse, delta, dq, dk, dv, q4, k4, v4, o_lib
            del tabs
        del allowed, sdpa_mask
    # the front door at a total that is not a multiple of the tile
    heads, d = PACK_HEADS, PACK_D
    tm = PACK_MISALIGNED_T
    lens_m = packed_lengths(tm)
    seg_m = packed_segments(torch, dev, lens_m, tm)
    misaligned = []
    for causal in (True, False):
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            q, k, v, do = (torch.randn(1, heads, tm, d, device=dev,
                                       generator=gen).to(dt)
                           for _ in range(4))
            runs = []
            for plain in (False, True):
                leaves = [x.clone().requires_grad_() for x in (q, k, v)]
                before = ku.launch_counts()
                if plain:
                    with ku.force_plain():
                        o = flash_attention_varlen(*leaves, seg_m,
                                                   causal=causal)
                        o.backward(do)
                else:
                    o = flash_attention_varlen(*leaves, seg_m, causal=causal)
                    o.backward(do)
                torch.cuda.synchronize()
                after = ku.launch_counts()
                want_n = 0 if plain else 1
                if any(after.get(n, 0) - before.get(n, 0) != want_n
                       for n in varlen_entries(dt, d)):
                    raise AssertionError(
                        f"varlen misaligned {dname}: launches {after} after "
                        f"{before}")
                runs.append([o.detach()] + [x.grad for x in leaves])
            atol, rtol = tol[dname]
            tag = f"varlen misaligned T={tm} causal={causal} {dname}"
            if runs[0][0].shape != (1, heads, tm, d):
                raise AssertionError(f"{tag}: shape {runs[0][0].shape}")
            misaligned.append({
                "dtype": dname, "causal": causal, "tokens": tm,
                "max_abs_err": max(
                    check_close(f"{tag} {name}", a, b, atol, rtol)
                    for name, a, b in zip(("o", "dq", "dk", "dv"), *runs))})
            del q, k, v, do, runs
    torch.cuda.empty_cache()
    return {"cases": cases, "misaligned": misaligned}


def varlen_wide_phase(torch, dev):
    """The varlen kernels above head dim 2048 (the wide kernels) vs their
    plain versions on a short packed row (PACK_WIDE_T tokens, documents of
    24-120 tokens from numpy seed 2, PACK_WIDE_HEADS heads) at the head
    dims of PACK_WIDE_CASES, fp32 and bf16 (and fp16 on the causal one,
    under the bf16 gate): o, lse, dq, dk, dv within
    flash's tolerances (fp32 atol/rtol 1e-4, bf16 atol 1e-2 + rtol
    2**-7), pad rows of o, dq, dk and dv exactly 0. Untimed."""
    from apex_tpu_torch.ops.attention_varlen import (
        flash_varlen_bwd_dkv, flash_varlen_bwd_dq,
        flash_varlen_bwd_reference, flash_varlen_fwd,
        flash_varlen_fwd_reference)

    tol = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7),
           "float16": (1e-2, 2 ** -7)}
    gen = torch.Generator(device=dev).manual_seed(6)
    lens_w = packed_lengths(PACK_WIDE_T, seed=2, lo=24, hi=120)
    seg_w = packed_segments(torch, dev, lens_w, PACK_WIDE_T)
    pad_w = seg_w[0] < 0
    wide = []
    for d, causal in PACK_WIDE_CASES:
        for dt in (torch.float32, torch.bfloat16,
                   *((torch.float16,) if causal else ())):
            dname = str(dt).split(".")[1]
            q, k, v, do = (torch.randn(1, PACK_WIDE_HEADS, PACK_WIDE_T, d,
                                       device=dev, generator=gen).to(dt)
                           for _ in range(4))
            args = (1.0 / math.sqrt(d), causal)
            vargs = (q, k, v, seg_w, seg_w)
            o, lse = flash_varlen_fwd(*vargs, *args)
            o_p, lse_p = flash_varlen_fwd_reference(*vargs, *args)
            delta = (do.float() * o.float()).sum(-1, keepdim=True)
            dq = flash_varlen_bwd_dq(*vargs, do, lse, delta, *args)
            dk, dv = flash_varlen_bwd_dkv(*vargs, do, lse, delta, *args)
            want = flash_varlen_bwd_reference(*vargs, o, lse, do, *args)
            torch.cuda.synchronize()
            atol, rtol = tol[dname]
            tag = f"varlen d{d} causal={causal} {dname}"
            err = max(check_close(f"{tag} o", o, o_p, atol, rtol),
                      check_close(f"{tag} lse", lse, lse_p, 1e-4, 1e-5),
                      *(check_close(f"{tag} {name}", a, b, atol, rtol)
                        for name, a, b in zip(("dq", "dk", "dv"),
                                              (dq, dk, dv), want)))
            for name, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
                if bool(x[0][:, pad_w].any()):
                    raise AssertionError(f"{tag}: {name} of pad rows not 0")
            wide.append({"dtype": dname, "causal": causal, "head_dim": d,
                         "heads": PACK_WIDE_HEADS, "tokens": PACK_WIDE_T,
                         "documents": len(lens_w), "atol": atol,
                         "rtol": rtol, "max_abs_err": err})
            del q, k, v, do, o, o_p, lse, lse_p, delta, dq, dk, dv, want
    torch.cuda.empty_cache()
    return wide


def fmha_phase(torch, dev, ku):
    """The packed path: ``contrib.fmha.FMHA`` (12 heads of 64, no
    parameters) over one packed row of PACK_T tokens (the documents of
    ``packed_lengths()``, the rest padding), forward plus backward through
    autograd, bf16 and fp32, causal (GPT-style packed pre-training) and
    bidirectional (BERT-style, Apex fmha's origin). Gates, all hard: the
    launch counts of each run (reset just before it, read just after) are
    exactly one of each varlen kernel; pad rows of o and of dqkv are
    exactly 0; a second run gives the same bits; in fp32, o and dqkv
    equal the port's own ``flash_attention`` run document by document
    (atol/rtol 1e-5; documents whose length is a multiple of 8 go through
    the flash kernels, the others through the reference attention, as
    JAX routes them). Times: device ms of one forward plus backward (CUDA
    events), wall ms p50 of 5, attention tokens/s, and a profile of one
    bf16 causal run (busy share, top kernels)."""
    from apex_tpu_torch.contrib.fmha import FMHA
    from apex_tpu_torch.ops.attention import flash_attention

    heads, t, d = PACK_HEADS, PACK_T, PACK_D
    lens = packed_lengths()
    starts = [0, *itertools.accumulate(lens)]
    n_real = starts[-1]
    cu = torch.tensor(starts, dtype=torch.int32, device=dev)
    mod = FMHA(num_heads=heads)
    if list(mod.parameters()):
        raise AssertionError("FMHA has parameters")
    gen = torch.Generator(device=dev).manual_seed(7)

    def run(qkv, do, causal):
        x = qkv.clone().requires_grad_()
        o = mod(x, cu, causal=causal)
        o.backward(do)
        return o.detach(), x.grad

    out = {"tokens": t, "documents": len(lens), "lengths": lens,
           "pad_tokens": t - n_real, "runs": []}
    for dt in (torch.bfloat16, torch.float32):
        dname = str(dt).split(".")[1]
        want_counts = {n: 1 for n in varlen_entries(dt, d)}
        qkv = torch.randn(t, 3, heads, d, device=dev, generator=gen).to(dt)
        do = torch.randn(t, heads, d, device=dev, generator=gen).to(dt)
        for causal in (True, False):
            tag = f"fmha {'causal' if causal else 'bidirectional'} {dname}"
            torch.cuda.synchronize()
            ku.reset_launch_counts()
            o, g = run(qkv, do, causal)
            torch.cuda.synchronize()
            counts = ku.launch_counts()
            if counts != want_counts:
                raise AssertionError(f"{tag}: one forward plus backward "
                                     f"launched {counts}, expected "
                                     f"{want_counts}")
            if not (bool(o.isfinite().all()) and bool(g.isfinite().all())):
                raise AssertionError(f"{tag}: non-finite output")
            if bool(o[n_real:].any()) or bool(g[n_real:].any()):
                raise AssertionError(f"{tag}: pad rows of o or dqkv not 0")
            o2, g2 = run(qkv, do, causal)
            if not (torch.equal(o, o2) and torch.equal(g, g2)):
                raise AssertionError(f"{tag}: two runs differ")
            entry = {"dtype": dname, "causal": causal, "launches": counts,
                     "bitwise_repeat": True, "pad_rows_zero": True}
            if dt == torch.float32:
                errs, on_kernels = [], 0
                for a, n in zip(starts, lens):
                    leaves = [qkv[a:a + n, i].transpose(0, 1)[None]
                              .contiguous().requires_grad_()
                              for i in range(3)]
                    od = flash_attention(*leaves, causal=causal)
                    od.backward(do[a:a + n].transpose(0, 1)[None])
                    on_kernels += n % 8 == 0
                    errs.append(check_close(
                        f"{tag} doc at {a} o", o[a:a + n],
                        od[0].transpose(0, 1), 1e-5, 1e-5))
                    for i, leaf in enumerate(leaves):
                        errs.append(check_close(
                            f"{tag} doc at {a} dqkv[{i}]", g[a:a + n, i],
                            leaf.grad[0].transpose(0, 1), 1e-5, 1e-5))
                entry.update(per_document_max_abs_err=max(errs),
                             per_document_tol=1e-5,
                             documents_on_flash_kernels=on_kernels)
            walls = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(qkv, do, causal)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            ms = time_ms(torch, lambda: run(qkv, do, causal), iters=10)
            entry.update(fwd_bwd_device_ms=ms,
                         fwd_bwd_wall_ms_p50=sorted(walls)[2],
                         tokens_per_s=n_real / (sorted(walls)[2] / 1e3))
            if dt == torch.bfloat16 and causal:
                entry["profile"] = profiled(torch, lambda: run(qkv, do,
                                                               causal))
            out["runs"].append(entry)
            del o, g, o2, g2
        del qkv, do
    torch.cuda.empty_cache()
    return out


def layer_norm_non_affine_check(torch, dev, ku):
    """``layer_norm(x, None, None)`` (and with a weight alone) on a CUDA
    tensor returns the plain version's result, bitwise, with no kernel
    launch and no raise, as JAX sends the non-affine form to its
    reference."""
    from apex_tpu_torch.ops.layer_norm import (layer_norm,
                                               layer_norm_reference)

    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.randn(TRAIN_ROWS, 768, device=dev, generator=gen)
    w = torch.randn(768, device=dev, generator=gen)
    before = ku.launch_counts()
    for dt in (torch.float32, torch.bfloat16):
        for args in ((None, None), (w.to(dt), None)):
            got = layer_norm(x.to(dt), *args)
            if not torch.equal(got, layer_norm_reference(x.to(dt), *args)):
                raise AssertionError("non-affine layer_norm on CUDA differs "
                                     "from its plain version")
    if ku.launch_counts() != before:
        raise AssertionError("non-affine layer_norm launched a kernel")
    return {"rows": TRAIN_ROWS, "hidden": 768, "equal_to_plain": True}


LM_SHAPES = [  # (name, rows, hidden, vocab)
    ("train", TRAIN_ROWS, 768, 50304),
    ("ragged", 96, 768, 1000),
    ("t5", T5_BATCH * T5_DEC, T5_HIDDEN, 32128),   # T5-small's head
    ("wide", 512, 2048, 1000),     # bf16: clusters of 8 CTAs, 2 dX splits
]
# the shapes whose kernels are timed: the training and T5 main paths'
LM_TIMED = ("train", "t5")
# the upstream gradient's scale in the fp16 cases: the dynamic loss
# scaler's initial 2**16 (amp's and FP16_Optimizer's fp16 paths)
FP16_LOSS_SCALE = 2.0 ** 16
# the shape whose fp32 dX is also held against an fp64 evaluation of its
# formula: at h 2048, with no target hit, dx's softmax term cancels to a
# small row max, where the fp32 gate is tightest
LM_FP64 = "wide"


def lm_head_bounds(n, h, v, esz, dname):
    """(fwd, dx, dw) bounds: max(FLOPs / peak, bytes / 3.35 TB/s). The
    forward does 2·n·V·h, each backward kernel recomputes the scores and
    does one more product, 4·n·V·h. Bytes: x and w read once, the int64
    targets and fp32 row vectors (lse, pred, g), dx or dw written once."""
    xw = (n * h + v * h) * esz
    return (bound_ms(xw + 8 * n + 8 * n, 2.0 * n * v * h, dname),
            bound_ms(xw + 16 * n + n * h * esz, 4.0 * n * v * h, dname),
            bound_ms(xw + 16 * n + v * h * esz, 4.0 * n * v * h, dname))


def lm_head_fp64_check(torch, x, w, t, lse, g, atol, rtol, tag):
    """dx = (exp(s − lse) − onehot(t))·g · w evaluated in fp64 from the
    fp32 x, w, lse and g, with the targets ``t`` and with none hit; the
    CUDA-core dX and the plain version each held to it row by row under
    the fp32 gate (``check_rows``). Returns each one's largest row error
    over its row's max."""
    from apex_tpu_torch.ops.lm_head_loss import (lm_head_loss_bwd_dx,
                                                 lm_head_loss_bwd_reference)

    s64 = torch.matmul(x.double(), w.double().t())
    cols = torch.arange(w.shape[0], device=x.device)[None, :]
    out = {}
    for label, tt in (("targets", t), ("no_target", torch.full_like(t, -1))):
        p = torch.exp(s64 - lse.double()[:, None])
        dl = (p - (cols == tt[:, None]).double()) * g.double()[:, None]
        want = torch.matmul(dl, w.double())
        del p, dl
        out[label] = {
            "kernel_max_row_rel_err": check_rows(
                f"lm_head dx vs fp64 {label} {tag}",
                lm_head_loss_bwd_dx(x, w, tt, lse, g), want, atol, rtol)[1],
            "plain_max_row_rel_err": check_rows(
                f"lm_head plain dx vs fp64 {label} {tag}",
                lm_head_loss_bwd_reference(x, w, tt, lse, g)[0], want,
                atol, rtol)[1]}
        del want
    return out


def lm_head_phase(torch, dev):
    """The fused LM-head + CE kernels (forward, dX, dW) vs their plain
    versions at the training shape (8192 rows, h 768, V 50304), a ragged
    one (96 rows, V 1000), T5-small's (1024 decoder rows, h 512, V 32128)
    and a wide one (512 rows, h 2048, V 1000), fp32 and bf16, each
    kernel on its route (bf16: the tensor-core forward, dX and dW of
    ``csrc/lm_head_mma.cu``; fp32: ``csrc/lm_head_loss.cu``). Tolerance:
    lse, pred and the loss atol/rtol 2e-5 (fp32) and 2e-4 (bf16: the same
    bf16 products, fp32 sums in another order); dx and dw, row by row
    (``check_rows``),
    1e-5 of the row's max plus rtol 1e-4 (fp32) and 1e-2 of the row's max
    plus one bf16 step (bf16: dl is rounded to bf16 on both sides from
    scores that differ in the last fp32 bits). With g = 1/n most vocab
    rows of dW get no target and hold only the softmax term, a thousandth
    of a hit row's scale, so each row is held to its own max. The softmax
    term alone is checked too: dx and dw with no target hit (targets -1),
    where the one-hot term of dx no longer hides it. The forward (lse,
    pred), dX and dW bitwise equal over repeats, each call one launch of
    its route's entry. At LM_FP64 in fp32, the CUDA-core dX and the plain
    version, with targets and with none, are each held to an fp64
    evaluation of dx from the same x, w, lse and g under the same gate.
    Times (bf16, LM_TIMED) beside the unfused pair torch.matmul +
    F.cross_entropy: its forward, and its autograd (dx and dw together)
    for both backward rows; fp32 at the same shapes for the CUDA-core
    forward, dX and dW. fp16 at the training, T5 and wide shapes on the
    tensor-core route under the bf16 gates, timed as bf16, with g =
    FP16_LOSS_SCALE / n (the loss-scaled gradient fp16 training feeds)."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops import _kernel_util as ku
    from apex_tpu_torch.ops.lm_head_loss import (_lm_head_route,
                                                 lm_head_loss_bwd_dw,
                                                 lm_head_loss_bwd_dx,
                                                 lm_head_loss_bwd_reference,
                                                 lm_head_loss_fwd,
                                                 lm_head_loss_fwd_reference)

    gen = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for name, n, h, v in LM_SHAPES:
        for dt in (torch.float32, torch.bfloat16,
                   *((torch.float16,) if name != "ragged" else ())):
            dname = str(dt).split(".")[1]
            route = _lm_head_route(dt, h)
            entry = ("lm_head_mma_fwd" if route == "tensor_core"
                     else "lm_head_loss_fwd")
            x = torch.randn(n, h, device=dev, generator=gen).to(dt)
            w = (0.05 * torch.randn(v, h, device=dev, generator=gen)).to(dt)
            t = torch.randint(0, v, (n,), device=dev, generator=gen)
            # d mean / d loss; in fp16 times amp's initial loss scale, as
            # the fp16 paths feed it: unscaled, dl = (p - hit) / n is far
            # below fp16's smallest normal (6.1e-5) and rounds to its
            # subnormal steps on both sides
            g = torch.full((n,), (FP16_LOSS_SCALE if dt == torch.float16
                                  else 1.0) / n, device=dev)
            before = ku.launch_counts()
            lse, pred = lm_head_loss_fwd(x, w, t)
            if ku.launch_counts().get(entry, 0) != before.get(entry, 0) + 1:
                raise AssertionError(f"lm_head fwd {name} {dname}: launches "
                                     f"{ku.launch_counts()}, expected one "
                                     f"of {entry}")
            dx = lm_head_loss_bwd_dx(x, w, t, lse, g)
            dw = lm_head_loss_bwd_dw(x, w, t, lse, g)
            lse_p, pred_p = lm_head_loss_fwd_reference(x, w, t)
            dx_p, dw_p = lm_head_loss_bwd_reference(x, w, t, lse, g)
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            tol = 2e-5 if dt == torch.float32 else 2e-4   # fp16 as bf16
            err_fwd = max(
                check_close(f"lm_head fwd lse {tag}", lse, lse_p, tol, tol),
                check_close(f"lm_head fwd pred {tag}", pred, pred_p, tol,
                            tol),
                check_close(f"lm_head loss {tag}", lse - pred,
                            lse_p - pred_p, tol, tol))
            atol, rtol = ((1e-5, 1e-4) if dt == torch.float32
                          else (1e-2, 2 ** -7))
            err_dx, row_dx = check_rows(f"lm_head dx {tag}", dx, dx_p, atol,
                                        rtol)
            err_dw, row_dw = check_rows(f"lm_head dw {tag}", dw, dw_p, atol,
                                        rtol)
            dw_abs = dw_p.float().abs()
            dw_scale = {"median_abs": float(dw_abs.median()),
                        "max_abs": float(dw_abs.max())}
            del lse_p, pred_p, dx_p, dw_p, dw_abs
            # the softmax term alone: no target hit
            t_none = torch.full_like(t, -1)
            dx_s, dw_s = (lm_head_loss_bwd_dx(x, w, t_none, lse, g),
                          lm_head_loss_bwd_dw(x, w, t_none, lse, g))
            dx_sp, dw_sp = lm_head_loss_bwd_reference(x, w, t_none, lse, g)
            soft = {"dx_max_row_rel_err": check_rows(
                        f"lm_head dx softmax term {tag}", dx_s, dx_sp, atol,
                        rtol)[1],
                    "dw_max_row_rel_err": check_rows(
                        f"lm_head dw softmax term {tag}", dw_s, dw_sp, atol,
                        rtol)[1],
                    "dw_median_abs": float(dw_sp.float().abs().median())}
            del t_none, dx_s, dw_s, dx_sp, dw_sp
            fp64 = (lm_head_fp64_check(torch, x, w, t, lse, g, atol, rtol,
                                       tag)
                    if name == LM_FP64 and dt == torch.float32 else None)
            for _ in range(2):
                again = lm_head_loss_fwd(x, w, t)
                if not (torch.equal(lse, again[0])
                        and torch.equal(pred, again[1])):
                    raise AssertionError(f"lm_head fwd {tag}: not bitwise "
                                         f"equal over repeats")
                if not torch.equal(dx, lm_head_loss_bwd_dx(x, w, t, lse, g)):
                    raise AssertionError(f"lm_head dx {tag}: not bitwise "
                                         f"equal over repeats")
                if not torch.equal(dw, lm_head_loss_bwd_dw(x, w, t, lse, g)):
                    raise AssertionError(f"lm_head dw {tag}: not bitwise "
                                         f"equal over repeats")
            case = {"shape": name, "dtype": dname, "rows": n, "hidden": h,
                    "vocab": v, "route": route, "fwd_entry": entry,
                    "lse_pred_tol": tol, "atol_of_row_max": atol,
                    "rtol": rtol, "fwd_bitwise_repeat": True,
                    "dx_bitwise_repeat": True, "dw_bitwise_repeat": True,
                    "fwd": {"max_abs_err": err_fwd},
                    "dx": {"max_abs_err": err_dx, "max_row_rel_err": row_dx},
                    "dw": {"max_abs_err": err_dw, "max_row_rel_err": row_dw,
                           **dw_scale},
                    "softmax_term_only": soft}
            if fp64 is not None:
                case["dx_vs_fp64"] = fp64
            if name in LM_TIMED:
                b_fwd, b_dx, b_dw = lm_head_bounds(n, h, v, x.element_size(),
                                                   dname)
                timed = lambda fn: time_ms(torch, fn, iters=10)
                xl, wl = (a.clone().requires_grad_() for a in (x, w))
                loss_lib = F.cross_entropy(torch.matmul(xl, wl.t()), t,
                                           reduction="none")
                lib_bwd = timed(lambda: torch.autograd.grad(
                    loss_lib, (xl, wl), g, retain_graph=True))
                plain_bwd = timed(lambda: lm_head_loss_bwd_reference(
                    x, w, t, lse, g))
                case["fwd"].update(
                    ms=timed(lambda: lm_head_loss_fwd(x, w, t)),
                    plain_ms=timed(lambda: lm_head_loss_fwd_reference(
                        x, w, t)),
                    library_ms=timed(lambda: F.cross_entropy(
                        torch.matmul(x, w.t()), t, reduction="none")),
                    bound_ms=b_fwd[0], bound_by=b_fwd[1])
                case["dx"].update(
                    ms=timed(lambda: lm_head_loss_bwd_dx(x, w, t, lse, g)),
                    plain_ms=plain_bwd, library_ms=lib_bwd,
                    bound_ms=b_dx[0], bound_by=b_dx[1])
                case["dw"].update(
                    ms=timed(lambda: lm_head_loss_bwd_dw(x, w, t, lse, g)),
                    plain_ms=plain_bwd, library_ms=lib_bwd,
                    bound_ms=b_dw[0], bound_by=b_dw[1])
                del xl, wl, loss_lib
            cases.append(case)
            del x, w, t, g, lse, pred, dx, dw
            torch.cuda.empty_cache()
    return cases


def adam_tail_phase(torch, dev):
    """The Adam tail kernel on every leaf shape of GPT-2-124M (16) and of
    T5-small (39), bf16 p and g with fp32 m and v, in both decay modes
    (decoupled and L2, weight decay 0.01) and with none: u, m', v' within
    rtol 1e-6 / atol 1e-7 of the plain version (IEEE division and square
    root on both sides). The LAMB variant's Σp² and Σu² within rtol 1e-5
    of the plain sums, bitwise equal over repeats. Times each model's
    train-step launches (one per leaf, no decay, as FusedAdam(lr=1e-4))
    against the bound of 24 bytes an element, beside the plain version and
    torch.optim.AdamW(fused=True) over the same leaves (timed only). The
    device pointers of the amp path: a clear found_inf flag with c1, c2
    read from the card gives the null-pointer launch's bits, a set flag
    leaves m and v and writes u = 0 (p unchanged); that variant's step
    timed beside the null one (``flagged_ms``).
    Returns GPT's record with T5's under "t5" and GPT's with fp16 g and p
    under "float16"."""
    import numpy as np

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                                 fused_adam_tail,
                                                 fused_lamb_tail,
                                                 lamb_tail_reference)
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTConfig, init_gpt_params_numpy)
    from apex_tpu_torch.transformer.testing.standalone_t5 import (
        init_t5_params_numpy)

    gen = torch.Generator(device=dev).manual_seed(5)
    kw = dict(betas=(0.9, 0.999), eps=1e-8)
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(3))
    c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(3))

    def one_model(model, tree, dt=torch.bfloat16):
        leaves = []
        for name, a in named_leaves(tree):
            shape = tuple(a.shape)
            leaves.append((f"{model} {name}",
                           torch.randn(shape, device=dev, generator=gen)
                           .to(dt),                               # g
                           0.01 * torch.randn(shape, device=dev,
                                              generator=gen),
                           1e-4 * torch.rand(shape, device=dev,
                                             generator=gen),
                           torch.randn(shape, device=dev, generator=gen)
                           .to(dt)))                              # p
        worst, sums_err = 0.0, 0.0
        for wd, adam_w in ((0.0, True), (0.01, True), (0.01, False)):
            for name, g, m, v, p in leaves:
                want = adam_tail_reference(g, m, v, p, c1, c2,
                                           weight_decay=wd,
                                           adam_w_mode=adam_w, **kw)
                m_k, v_k = m.clone(), v.clone()
                got = fused_adam_tail(g, m_k, v_k, p, c1, c2,
                                      weight_decay=wd, adam_w_mode=adam_w,
                                      **kw)
                torch.cuda.synchronize()
                for a, b, what in zip(got, want, ("u", "m", "v")):
                    worst = max(worst, check_close(
                        f"adam tail {what} {name} wd={wd} adam_w={adam_w}",
                        a, b, 1e-7, 1e-6))
        for name, g, m, v, p in leaves:
            want = lamb_tail_reference(g, m, v, p, c1, c2, weight_decay=0.01,
                                       **kw)
            runs = [fused_lamb_tail(g, m.clone(), v.clone(), p, c1, c2,
                                    weight_decay=0.01, **kw)
                    for _ in range(2)]
            torch.cuda.synchronize()
            for a, b in zip(runs[0][3:], want[3:]):
                sums_err = max(sums_err, check_close(
                    f"lamb sums {name}", a, b, 0.0, 1e-5) / float(b))
            if not all(bool(torch.equal(a, b)) for a, b in zip(*runs)):
                raise AssertionError(f"lamb tail {name}: not bitwise equal "
                                     f"over repeats")

        # the device pointers (the amp path's): a clear flag and the
        # corrections from the card give the null-pointer launch's bits; a
        # set flag keeps m and v, writes u = 0 and so keeps p
        corr = torch.full((2,), c1, dtype=torch.float32, device=dev)
        corr[1:].fill_(c2)
        clear = torch.zeros(1, device=dev)
        for name, g, m, v, p in leaves:
            null = fused_adam_tail(g, m.clone(), v.clone(), p, c1, c2, **kw)
            flagged = fused_adam_tail(g, m.clone(), v.clone(), p, c1, c2,
                                      corr=corr, found_inf=clear, **kw)
            m_s, v_s = m.clone(), v.clone()
            u_s, _, _ = fused_adam_tail(g, m_s, v_s, p, c1, c2, corr=corr,
                                        found_inf=torch.ones(1, device=dev),
                                        **kw)
            torch.cuda.synchronize()
            if not all(bool(torch.equal(a, b))
                       for a, b in zip(null, flagged)):
                raise AssertionError(f"adam tail {name}: a clear flag with "
                                     f"device corrections is not bitwise "
                                     f"the null-pointer launch")
            if not (torch.equal(m_s, m) and torch.equal(v_s, v)
                    and torch.equal(u_s, torch.zeros_like(u_s))
                    and torch.equal(p + (-1e-4 * u_s).to(p.dtype), p)):
                raise AssertionError(f"adam tail {name}: a set flag changed "
                                     f"m, v or p")

        def step_kernel():
            for _, g, m, v, p in leaves:
                fused_adam_tail(g, m, v, p, c1, c2, **kw)

        def step_flagged():
            for _, g, m, v, p in leaves:
                fused_adam_tail(g, m, v, p, c1, c2, corr=corr,
                                found_inf=clear, **kw)

        def step_plain():
            for _, g, m, v, p in leaves:
                adam_tail_reference(g, m, v, p, c1, c2, **kw)

        params = [p.clone().requires_grad_() for _, _, _, _, p in leaves]
        for q, (_, g, _, _, _) in zip(params, leaves):
            q.grad = g.clone()
        lib = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.0,
                                fused=True)
        n_el = sum(g.numel() for _, g, _, _, _ in leaves)
        bms, by = bound_ms(24.0 * n_el, 10.0 * n_el, "float32")
        out = {"leaves": len(leaves), "elements": n_el, "rtol": 1e-6,
               "atol": 1e-7, "max_abs_err": worst,
               "lamb_sums_max_rel_err": sums_err, "lamb_sums_rtol": 1e-5,
               "lamb_bitwise_repeat": True,
               "per": f"{model} train step ({len(leaves)} launches)",
               "ms": time_ms(torch, step_kernel, iters=20),
               "flagged_ms": time_ms(torch, step_flagged, iters=20),
               "flag_clear_bitwise_null": True, "flag_set_keeps_state": True,
               "plain_ms": time_ms(torch, step_plain, iters=5),
               "library_ms": time_ms(torch, lib.step, iters=20),
               "bound_ms": bms, "bound_by": by}
        del leaves, params, lib
        torch.cuda.empty_cache()
        return out

    out = one_model("gpt", init_gpt_params_numpy(GPTConfig(), 0))
    out["t5"] = one_model("t5", init_t5_params_numpy(
        t5_config(torch.bfloat16), 0))
    out["float16"] = one_model("gpt", init_gpt_params_numpy(GPTConfig(), 0),
                               torch.float16)
    return out


# the fused layer's tolerances against its plain version (x'): fp32 sums
# in another order (fp pools); with quantized pools a fed row's code can
# flip where the two fp32 K values straddle a rounding midpoint (one code
# step of one score); bf16 one rounding of x' and of its intermediates
MEGA_TOL = {("float32", False): (1e-4, 1e-4), ("float32", True): (2e-3, 1e-3),
            ("bfloat16", False): (2e-2, 2 ** -6),
            ("bfloat16", True): (2e-2, 2 ** -6),
            ("float16", False): (2e-2, 2 ** -6),     # fp16: the bf16 gates
            ("float16", True): (2e-2, 2 ** -6)}
MEGA_KV_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-2, 2 ** -7),
               "float16": (1e-2, 2 ** -7)}
# the fused layer's widths beside GPT-2-124M's: head_dim 80 (12 x 80) and
# 320 (2 x 320), the engine phase's two other GPTs
MEGA_WIDTHS = {64: {}, 80: dict(hidden=960, num_heads=12),
               320: dict(hidden=640, num_heads=2)}


def megakernel_cases():
    """The megakernel phase's cases (dtype name, pool format, call, fed
    rows a slot, head_dim, slots): GPT-2-124M decode (8 x 1) and verify
    (8 x 5) in the three types and every pool format; head_dim 80 and 320
    decode and verify in the three types (fp pools; bf16 verify with int8
    and int4 too); and a 32-slot verify call (32 x 5 = 160 rows, past one
    64-row tile) in the three types, bf16 with every pool format."""
    out = []
    types = ("float32", "bfloat16", "float16")
    for dname in types:
        for mode in KV_MODES:
            for what, q in (("decode", 1), ("verify", 5)):
                out.append((dname, mode, what, q, 64, 8))
    for hd in (80, 320):
        for dname in types:
            for what, q in (("decode", 1), ("verify", 5)):
                out.append((dname, "none", what, q, hd, 8))
        for mode in ("int8", "int4"):
            out.append(("bfloat16", mode, "verify", 5, hd, 8))
    out.append(("float32", "none", "verify", 5, 64, 32))
    out.append(("float16", "none", "verify", 5, 64, 32))
    for mode in KV_MODES:
        out.append(("bfloat16", mode, "verify", 5, 64, 32))
    return out


def megakernel_case(torch, dev, dtype, mode, q, hd=64, n=8):
    """One layer of GPT-2-124M (or of the head_dim-``hd`` GPT of
    ``MEGA_WIDTHS``; weights from numpy seed 0, biases and LN weights
    perturbed so every vector shows), ``n`` slots (8 or 32) holding the
    paged phase's bf16 contexts (slot 0 idle, slot 1 full: its verify rows
    run past its blocks), fed rows at the end of each context (decode q=1,
    verify q=5, every row real)."""
    import numpy as np

    from apex_tpu_torch.serve.kv_cache import (KVCacheConfig, init_kv_cache,
                                               paged_write)
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    cfg = GPTConfig(num_layers=1, dtype=dtype, **MEGA_WIDTHS[hd])
    bs, max_ctx = SERVE_BS, SERVE_CTX
    mb = max_ctx // bs
    heads, hd, h = cfg.num_heads, cfg.head_dim, cfg.hidden
    gen = torch.Generator(device=dev).manual_seed(3)
    lp = {}
    for name, t in init_gpt_params(cfg, seed=0, device=dev)["layers"].items():
        t = t[0].float()
        if t.dim() == 1:
            t = t + 0.1 * torch.randn(t.shape, device=dev, generator=gen)
        lp[name] = t.to(dtype).contiguous()
    kv = KVCacheConfig(num_layers=1, num_heads=heads, head_dim=hd,
                       num_blocks=n * mb, block_size=bs, dtype=dtype,
                       **KV_MODES[mode])
    ctx, bt = paged_draws()[("bfloat16", n)]
    bt = torch.from_numpy(bt).to(dev)
    start = torch.from_numpy(np.maximum(ctx - 1, 0).astype(np.int32)).to(dev)
    active = torch.from_numpy(ctx > 0).to(dev)
    layer = {k: v[0] for k, v in init_kv_cache(kv, dev).items()}
    pos = torch.arange(mb * bs, device=dev).repeat(n)
    old = pos < start.long().repeat_interleave(mb * bs)
    k, v = (torch.randn(heads, n * mb * bs, hd, device=dev, generator=gen)
            .to(dtype) for _ in range(2))
    paged_write(layer, kv, k, v, bt.repeat_interleave(mb * bs, dim=0), pos,
                old)
    x = torch.randn(n, q, h, device=dev, generator=gen).to(dtype)
    n_fed = torch.full((n,), q, dtype=torch.int32, device=dev)
    return cfg, kv, lp, layer, x, bt, start, n_fed, active


def megakernel_bound(cfg, kv, start, active, q, dname):
    """Least time of one fused layer: the layer's weights and vectors read
    once, each slot's attended pool positions read once (whole blocks, as
    the serving byte model counts), the fed rows' K/V written, x read and
    x', K, V written; operations 2·rows per weight element plus 4 per
    attended K/V element pair, at the dtype's peak."""
    from apex_tpu_torch.serve.kv_cache import _elem_bytes
    from apex_tpu_torch.serve.megakernel import layer_weight_bytes

    h, f, heads, hd = cfg.hidden, cfg.ffn_hidden, cfg.num_heads, cfg.head_dim
    cap = kv.num_blocks // start.shape[0] * kv.block_size
    esz = 4 if dname == "float32" else 2
    rows = start.shape[0] * q
    read_tok, written, att = 0, 0, 0
    for s, a in zip(start.tolist(), active.tolist()):
        if not a:
            continue
        last = min(s + q, cap)                    # positions attended
        read_tok += -(-last // kv.block_size) * kv.block_size
        written += max(0, min(s + q, cap) - s)
        att += sum(min(s + w + 1, cap) for w in range(q))
    elem = _elem_bytes(kv)
    bytes_moved = (layer_weight_bytes(cfg) + read_tok * heads * hd * 2 * elem
                   + written * heads * hd * 2 * elem + 4 * rows * h * esz)
    ops = 2.0 * rows * (4 * h * h + 2 * h * f) + 4.0 * att * heads * hd
    return bound_ms(bytes_moved, ops, dname)


def megakernel_phase(torch, dev):
    """The fused layer against its plain version at ``megakernel_cases()``
    (GPT-2-124M decode (8 rows) and verify (8 x 5 rows), fp32, bf16 and
    fp16 (since C6, held to the bf16 gates), each pool format; head_dim
    80 and 320; 32 x 5 = 160 rows): x', K and V within MEGA_TOL /
    MEGA_KV_TOL; fp pools within MEGA_KV_TOL;
    int8/int4 codes and scales equal to the plain codec's write of the
    kernel's own K/V (the count that differ, which must be 0); two
    launches bitwise equal (x', K, V, pools); slot 2 launched alone (and,
    at 32 slots, slot 12, whose rows 60-64 straddle the first 64-row
    chunk) bitwise equal to its rows in the call; the shared memory the
    gate counts equal to the C entry's. Times: the kernel, its plain
    version, and the per-op layer (the eager layer body with the port's
    LayerNorm and paged-attention kernels, ``paged_layer_stack`` on one
    layer: no single PyTorch call computes a layer), the L2 flushed
    between calls as 12 layers in a row would find it."""
    from apex_tpu_torch.ops import _kernel_util as ku
    from apex_tpu_torch.serve.decode import kv_mode, paged_layer_stack
    from apex_tpu_torch.serve.kv_cache import paged_write
    from apex_tpu_torch.serve.megakernel import (fused_layer_fwd,
                                                 fused_layer_reference,
                                                 kernel_smem_bytes)

    from apex_tpu_torch.serve import megakernel as mk

    flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
    lib = ku.load_kernel("megakernel", mk._SIGNATURES)
    dt_of = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "float16": torch.float16}
    cases = []
    for dname, mode, what, q, hd, n in megakernel_cases():
        dt = dt_of[dname]
        cfg, kv, lp, layer, x, bt, start, n_fed, active = \
            megakernel_case(torch, dev, dt, mode, q, hd, n)
        smem = lib.fused_layer_smem_bytes(cfg.hidden, hd, cfg.ffn_hidden,
                                          kv_mode(kv), kv.kv_group,
                                          ku.dtype_code(dt))
        counted = kernel_smem_bytes(cfg.hidden, hd, cfg.ffn_hidden, dt,
                                    kv_mode(kv), kv.kv_group)
        if smem != counted:
            raise AssertionError(
                f"megakernel shared memory: the kernel needs {smem} B, "
                f"megakernel_refusal counts {counted}")
        nv = None if q == 1 else n_fed
        args = (cfg, kv, bt, start, nv, active)
        pools = {}

        def run(fn, key, sl=slice(None)):
            pools[key] = {k: v.clone() for k, v in layer.items()}
            return fn(x[sl].contiguous(), lp, pools[key], cfg, kv, bt[sl],
                      start[sl], None if nv is None else nv[sl], active[sl])

        got = run(fused_layer_fwd, "kernel")
        want = run(fused_layer_reference, "plain")
        again = run(fused_layer_fwd, "again")
        alone = {i: run(fused_layer_fwd, f"alone{i}", slice(i, i + 1))
                 for i in ((2, 12) if n == 32 else (2,))}
        torch.cuda.synchronize()
        tag = f"megakernel {what} {mode} {dname} d{hd} {n}x{q}"
        atol, rtol = MEGA_TOL[(dname, mode != "none")]
        err = check_close(f"{tag} x'", got[0], want[0], atol, rtol)
        kv_atol, kv_rtol = MEGA_KV_TOL[dname]
        kv_err = max(check_close(f"{tag} {nm}", a, b, kv_atol, kv_rtol)
                     for nm, a, b in zip("kv", got[1:], want[1:]))
        differ = 0
        if mode == "none":
            for nm in layer:   # the plain version fills the trash
                kv_err = max(kv_err, check_close(
                    f"{tag} pool {nm}", pools["kernel"][nm][:, :-1],
                    pools["plain"][nm][:, :-1], kv_atol, kv_rtol))
        else:
            codec = {k: v.clone() for k, v in layer.items()}
            offs = torch.arange(q, device=dev)
            pos = (start.long()[:, None] + offs).reshape(-1)
            valid = (active[:, None] & (offs[None, :] < q)).reshape(-1)
            heads = kv.num_heads
            paged_write(codec, kv,
                        got[1].reshape(-1, heads, hd).transpose(0, 1),
                        got[2].reshape(-1, heads, hd).transpose(0, 1),
                        bt.repeat_interleave(q, dim=0), pos, valid)
            differ = sum(int((pools["kernel"][nm][:, :-1]
                              != codec[nm][:, :-1]).sum())
                         for nm in layer)
            if differ:
                raise AssertionError(
                    f"{tag}: {differ} pool codes/scales differ from "
                    f"the plain codec's write of the kernel's K/V")
        if not (all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                and all(bool(torch.equal(pools["kernel"][nm][:, :-1],
                                         pools["again"][nm][:, :-1]))
                        for nm in layer)):
            raise AssertionError(f"{tag}: two launches differ")
        for i, one in alone.items():
            if not all(bool(torch.equal(a[i:i + 1], b))
                       for a, b in zip(got, one)):
                raise AssertionError(f"{tag}: slot {i} alone differs from "
                                     f"its rows in the call")
        layers1 = {k: v[None] for k, v in lp.items()}
        cache1 = {k: v[None].clone() for k, v in layer.items()}
        n_valid = (n_fed if nv is not None else torch.ones_like(n_fed))
        bms, by = megakernel_bound(cfg, kv, start, active, q, dname)
        timed = {k: v.clone() for k, v in layer.items()}
        # fp16 (C6): GPT-2's 8-slot calls timed, the other cases checked
        skip_times = dname == "float16" and (hd, n) != (SERVE_HD, 8)
        if skip_times:
            cases.append({
                "case": what, "dtype": dname, "kv": mode, "head_dim": hd,
                "slots": n, "rows": n * q, "max_abs_err": err, "atol": atol,
                "rtol": rtol, "kv_max_abs_err": kv_err, "kv_atol": kv_atol,
                "kv_rtol": kv_rtol, "codes_differ": differ,
                "bitwise_repeat": True, "rows_independent_of_batch": True,
                "smem_bytes": smem, "bound_ms": bms, "bound_by": by})
            del pools, timed, cache1, layer, got, want, again, alone
            continue
        cases.append({
            "case": what, "dtype": dname, "kv": mode, "head_dim": hd,
            "slots": n, "rows": n * q,
            "max_abs_err": err, "atol": atol, "rtol": rtol,
            "kv_max_abs_err": kv_err, "kv_atol": kv_atol,
            "kv_rtol": kv_rtol, "codes_differ": differ,
            "bitwise_repeat": True, "rows_independent_of_batch": True,
            "smem_bytes": smem,
            "ms": time_ms(torch, lambda: fused_layer_fwd(
                x, lp, timed, *args), flush=flush_buf.zero_),
            "plain_ms": time_ms(torch, lambda: fused_layer_reference(
                x, lp, timed, *args), iters=10, flush=flush_buf.zero_),
            "per_op_layer_ms": time_ms(torch, lambda: paged_layer_stack(
                x, layers1, start, n_valid, active, cache1, bt, cfg,
                kv), iters=20, flush=flush_buf.zero_),
            "library_ms": None, "bound_ms": bms, "bound_by": by})
        del pools, timed, cache1, layer, got, want, again, alone
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# engine phase


def make_requests(vocab: int, seed: int = 1, count: int = 16,
                  max_new_tokens: int = 32):
    import numpy as np

    from apex_tpu_torch.serve import Request

    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 64).tolist()
    lens = rng.integers(64, 513, count)
    reqs = []
    for i, n in enumerate(lens):
        if i == 13:
            toks = list(prefix)            # a full-prefix hit (CoW)
        elif i % 2 == 0:
            toks = prefix + rng.integers(0, vocab, int(n) - 64).tolist()
        else:
            toks = rng.integers(0, vocab, int(n)).tolist()
        reqs.append(Request(f"r{i:02d}", toks, max_new_tokens=max_new_tokens))
    return reqs


def serve(torch, params, cfg, dev, spec_k: int, requests, drafter=None,
          **scfg):
    """Serve ``requests`` to completion on a fresh engine
    (``ServeConfig(num_slots=8, prefill_chunk=32, spec_k=..., **scfg)``,
    ``scfg`` may set ``num_slots``; the engine's default drafter unless
    ``drafter``); returns the streams and the run's figures."""
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        **{"num_slots": 8, "prefill_chunk": 32, **scfg}, spec_k=spec_k),
        device=dev, drafter=drafter)
    t0 = time.perf_counter()
    streams = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    for r in requests:
        s = streams[r.uid]
        if len(s) != r.max_new_tokens or not all(
                0 <= t < cfg.vocab_size for t in s):
            raise AssertionError(f"{r.uid}: bad stream {s}")
    keep = ("completed", "steps", "generated_tokens", "tokens_per_s",
            "ttft_ms_p50", "ttft_ms_p99", "decode_step_ms_p50",
            "decode_step_ms_p99", "prefix_cache", "speculative",
            "megakernel", "decode_kernel", "verify_kernel", "kv_bits",
            "kv_cache_bytes")
    out = {k: st.get(k) for k in keep}
    out["wall_s"] = wall
    return streams, out


def last_logits(torch, params, cfg, dev, tokens):
    """Next-token logits after ``tokens``, through chunked prefill into a
    fresh one-slot cache."""
    from apex_tpu_torch.serve import (KVCacheConfig, gpt_prefill_chunk,
                                      init_kv_cache)

    bs, chunk = 16, 32
    mb = -(-cfg.max_seq // bs)
    kv = KVCacheConfig(num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                       head_dim=cfg.head_dim, num_blocks=mb, block_size=bs,
                       dtype=cfg.dtype)
    cache = init_kv_cache(kv, dev)
    row = torch.arange(mb, dtype=torch.int32, device=dev)
    logits = None
    for c in range(0, len(tokens), chunk):
        part = tokens[c:c + chunk]
        t = torch.zeros(chunk, dtype=torch.int32, device=dev)
        t[:len(part)] = torch.tensor(part, dtype=torch.int32, device=dev)
        cache, logits = gpt_prefill_chunk(params, t, c, len(part), cache,
                                          row, cfg, kv)
    return logits


def profile_decode(torch, params, cfg, dev, requests, steps: int = 20,
                   **scfg):
    """Where a steady-state engine step's time goes: the wall time of
    ``steps`` steps without the profiler, then the same number of steps
    under torch.profiler for the device's busy time (union of its
    kernel and copy intervals) and the top kernels by device time."""
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, prefill_chunk=32, **scfg), device=dev)
    for r in requests:
        eng.submit(r)
    for _ in range(40):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = profiled(torch, lambda: [eng.step() for _ in range(steps)])
    out.update(steps=steps, wall_ms=wall_ms, decode_kernel=eng.decode_kernel,
               device_busy_share_of_unprofiled_wall=(
                   out["device_busy_ms"] / wall_ms))
    return out


class RepeatDrafter:
    """Proposes k copies of the last token, so every step with room for
    drafts is a verify call."""

    def propose(self, tokens, k):
        return [tokens[-1]] * k


def launches_per_call(torch, ku, eng, spec_k: int, want):
    """Kernel launches of one decode (spec_k 0) or verify (spec_k > 0)
    call of ``eng`` (``ServeConfig(num_slots=8, ...)``), counted over one
    step taken once all eight slots are decoding (a third of them on
    adapters t1 / t2 when the engine has adapters) and no prompt is left
    to prefill; raises unless they are ``want``."""
    from apex_tpu_torch.serve import Request

    for i in range(8):
        eng.submit(Request(f"p{i}", list(range(1 + i, 17 + i)),
                           max_new_tokens=24,
                           adapter=("t1", "t2", None)[i % 3]
                           if eng.adapters is not None else None))
    while eng._pending or eng._prefill_queue:
        eng.step()
    torch.cuda.synchronize()
    calls = (eng._decode_steps, eng._verify_steps)
    ku.reset_launch_counts()
    eng.step()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    kind = ("verify" if eng._verify_steps > calls[1] else
            "decode" if eng._decode_steps > calls[0] else "none")
    if kind != ("verify" if spec_k else "decode") or counts != want:
        raise AssertionError(f"one {kind} call ({eng.decode_kernel}) "
                             f"launched {counts}, expected {want}")
    return {"call": kind, "launches": counts}


def fused_launches_per_call(torch, ku, params, cfg, dev, spec_k: int):
    """:func:`launches_per_call` of the default (fused) engine: the fused
    layer a layer and the head's LayerNorm."""
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, prefill_chunk=32, spec_k=spec_k), device=dev,
        drafter=RepeatDrafter() if spec_k else None)
    return launches_per_call(torch, ku, eng, spec_k, {
        "megakernel": cfg.num_layers, "layer_norm_fwd": 1})


def profiled(torch, fn, match=(), groups=None):
    """Run ``fn`` once under torch.profiler: its wall time, the device's
    busy time (union of its kernel and copy intervals; the device-side
    copies of host annotations such as ``Optimizer.step`` are left out),
    idle share, the top kernels by device time, the device time of the
    kernels whose names hold one of the strings ``match``, and for each
    of ``groups`` (name: strings) its kernels' device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        profiled_wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name not in host_names)
    busy_us, end = 0.0, float("-inf")
    by_name = {}
    for start, stop, name in spans:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + stop - start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"profiled_wall_ms": profiled_wall_ms,
            "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1.0 - busy_us / 1e3 / profiled_wall_ms,
            "top": [{"name": k[:80], "count": n, "device_ms": us / 1e3}
                    for k, (n, us) in top],
            "matched_device_ms": sum(us for k, (_, us) in by_name.items()
                                     if any(m in k for m in match)) / 1e3,
            "group_device_ms": {
                g: sum(us for k, (_, us) in by_name.items()
                       if any(m in k for m in ms)) / 1e3
                for g, ms in (groups or {}).items()},
            "group_events": {
                g: {k[:80]: n for k, (n, _) in by_name.items()
                    if any(m in k for m in ms)}
                for g, ms in (groups or {}).items()}}


def first_mismatch(a, b):
    for uid in sorted(a):
        for j, (x, y) in enumerate(zip(a[uid], b[uid])):
            if x != y:
                return uid, j
    return None


def top2_gap(torch, logits) -> float:
    v = torch.topk(logits.float(), 2).values
    return float(v[0] - v[1])


def streams_equal(torch, what, a, b, requests, logits_at=None):
    """Raise at the first token where streams ``a`` and ``b`` differ,
    with the top-2 logit gap there when ``logits_at(tokens)`` is given."""
    miss = first_mismatch(a, b)
    if miss is None:
        return
    uid, j = miss
    gap = ""
    if logits_at is not None:
        req = next(r for r in requests if r.uid == uid)
        ctx = list(req.tokens) + a[uid][:j]
        gap = f"; top-2 logit gap there {top2_gap(torch, logits_at(ctx)):.3e}"
    raise AssertionError(f"{what}: streams differ at {uid} token {j}: "
                         f"{a[uid][j]} vs {b[uid][j]}{gap}")


def profile_prefill(torch, params, cfg, dev, tokens):
    """Where per-op prefill chunks' time goes: one prompt's chunks of 32
    through ``gpt_prefill_chunk`` into a fresh one-slot cache, on the host
    clock (synced at the end), then again under torch.profiler: the
    device's busy time and the paged-attention kernels' part of it."""
    last_logits(torch, params, cfg, dev, tokens)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last_logits(torch, params, cfg, dev, tokens)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    out = profiled(torch, lambda: last_logits(torch, params, cfg, dev,
                                              tokens), match=("paged",))
    chunks = -(-len(tokens) // 32)
    out.update(chunks=chunks, tokens=len(tokens), wall_ms=wall_ms,
               host_ms_per_chunk=wall_ms / chunks,
               device_busy_ms_per_chunk=out["device_busy_ms"] / chunks,
               paged_device_ms_per_chunk=out["matched_device_ms"] / chunks,
               paged_share_of_busy=(out["matched_device_ms"]
                                    / out["device_busy_ms"]))
    return out


# the engine phase's other GPTs: 12 heads of 80 (the walks' 128 bucket)
# and 2 heads of 320 (the wide walk), 2 layers each
HD80 = dict(hidden=960, num_heads=12, num_layers=2)
HD320 = dict(hidden=640, num_heads=2, num_layers=2)


def engine_width_phase(torch, dev, ku, requests, widths, per_op_entry):
    """A GPT of ``widths`` (``HD80``, ``HD320``), 4 requests, run twice
    in each type: ``megakernel="auto"``, which fuses it on the card (its
    calls launch the fused layer), and ``megakernel="off"``, the per-op
    path through paged attention's route (``per_op_entry[dtype]``; no
    fused layer). fp32 streams through the fused layer equal those with
    the plain versions forced and those of the per-op path."""
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    reqs = requests[:4]
    hd = widths["hidden"] // widths["num_heads"]
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        cfg = GPTConfig(dtype=dt, **widths)
        params = init_gpt_params(cfg, seed=0, device=dev)
        ku.reset_launch_counts()
        fused, rec = serve(torch, params, cfg, dev, 0, reqs)
        rec["launches"] = counts = ku.launch_counts()
        if rec["decode_kernel"] != "fused" or not counts.get("megakernel"):
            raise AssertionError(f"head_dim {hd} {dname}: expected the "
                                 f"fused layer, got {rec['decode_kernel']} "
                                 f"{counts}")
        ku.reset_launch_counts()
        per_op, off = serve(torch, params, cfg, dev, 0, reqs,
                            megakernel="off")
        off["launches"] = counts = ku.launch_counts()
        entry = per_op_entry[dname]
        if (off["decode_kernel"] != "cuda" or not counts.get(entry)
                or counts.get("megakernel")):
            raise AssertionError(f"head_dim {hd} {dname} off: expected the "
                                 f"per-op path through {entry}, got "
                                 f"{off['decode_kernel']} {counts}")
        if dt == torch.float32:
            with ku.force_plain():
                plain, out["float32_plain"] = serve(torch, params, cfg, dev,
                                                    0, reqs)
            streams_equal(torch, f"head_dim {hd} fp32 fused vs plain",
                          fused, plain, reqs)
            streams_equal(torch, f"head_dim {hd} fp32 fused vs per-op",
                          fused, per_op, reqs)
        out[dname] = rec
        out[f"{dname}_off"] = off
        del params
    return out


def engine_hd80_phase(torch, dev, ku, requests):
    """The head_dim-80 GPT (``HD80``): fused, and per-op through
    ``paged_attention_fwd`` (fp32) and ``paged_mma_fwd`` (bf16)."""
    return engine_width_phase(torch, dev, ku, requests, HD80, {
        "float32": "paged_attention_fwd", "bfloat16": "paged_mma_fwd"})


def engine_hd320_phase(torch, dev, ku, requests):
    """The 2 x 320 GPT (``HD320``): fused, and per-op through the wide
    walk (``paged_wide_fwd``) in both types."""
    return engine_width_phase(torch, dev, ku, requests, HD320, {
        "float32": "paged_wide_fwd", "bfloat16": "paged_wide_fwd"})


def engine_32_slots(torch, dev, ku, params, cfg):
    """The bf16 GPT-2-124M engine at 32 slots: 32 requests (numpy seed 2,
    16 new tokens each) with ``spec_k=0`` and ``spec_k=4`` (drafts from
    ``RepeatDrafter``, so every step with room verifies), both fused (a
    verify call is 32 x 5 = 160 rows, one launch a layer): equal
    streams."""
    reqs = make_requests(cfg.vocab_size, seed=2, count=32, max_new_tokens=16)
    out = {}
    streams = {}
    for k in (0, 4):
        ku.reset_launch_counts()
        streams[k], out[f"spec{k}"] = serve(
            torch, params, cfg, dev, k, reqs, num_slots=32,
            drafter=RepeatDrafter() if k else None)
        out[f"spec{k}"]["launches"] = counts = ku.launch_counts()
        rec = out[f"spec{k}"]
        if (rec["decode_kernel"] != "fused" or not counts.get("megakernel")
                or (k and (rec["verify_kernel"] != "fused" or not
                           rec["speculative"]["verify_steps"]))):
            raise AssertionError(f"32 slots spec_k={k}: expected fused "
                                 f"decode and verify calls, got "
                                 f"{rec['decode_kernel']} "
                                 f"{rec['verify_kernel']} "
                                 f"{rec['speculative']} {counts}")
    streams_equal(torch, "bf16 32 slots spec_k=4 vs spec_k=0 (fused)",
                  streams[4], streams[0], reqs)
    return out


def engine_phase(torch, dev, ku):
    """GPT-2-124M at full width. ``ServeConfig()`` resolves to the fused
    per-layer kernel on the card (``decode_kernel == "fused"``). fp32:
    kernels vs plain versions forced (streams), fused vs per-op
    (``megakernel="off"``) streams, and the same with int8 and int4 pools
    on the first 6 requests. bf16: the main path (``spec_k=0``, fused;
    launch counts reset just before and read just after), ``spec_k=4``
    streams equal to it, launches per decode and verify call, int8 and
    int4 pools with spec_k 0 and 4 (equal streams, tokens/s, pool bytes,
    launches), the per-op path (``megakernel="off"``) with its launches,
    and 20 steady steps profiled on each path; one prompt's per-op prefill
    chunks profiled; the 32-slot ``spec_k`` 0 / 4 runs (``engine_32_slots``,
    160-row verify calls); the head_dim 80 and 320 runs, fused and per-op
    (``engine_hd80_phase``, ``engine_hd320_phase``). The
    prefill chunks launch paged attention on its route: ``paged_mma_fwd``
    in bf16, ``paged_attention_fwd`` in fp32."""
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    result = {}
    cfg32 = GPTConfig(dtype=torch.float32)
    params32 = init_gpt_params(cfg32, seed=0, device=dev)
    requests = make_requests(cfg32.vocab_size)

    def logits32(tokens):
        return last_logits(torch, params32, cfg32, dev, tokens)

    # logits on a small input: kernels vs plain versions
    probe = requests[1].tokens[:40]
    lk = logits32(probe)
    with ku.force_plain():
        lp = logits32(probe)
    err = float((lk - lp).abs().max())
    if not bool(torch.isfinite(lk).all()) or err > 1e-3:
        raise AssertionError(f"fp32 logits: kernels vs plain max abs err "
                             f"{err:.3e} (limit 1e-3)")
    result["fp32_logits_max_abs_err"] = err

    ku.reset_launch_counts()
    s_kernel, result["fp32_kernels"] = serve(torch, params32, cfg32, dev, 0,
                                             requests)
    result["fp32_kernels"]["launches"] = ku.launch_counts()
    if result["fp32_kernels"]["decode_kernel"] != "fused":
        raise AssertionError("ServeConfig() did not resolve to the fused "
                             "layer on the card")
    if not result["fp32_kernels"]["launches"].get("paged_attention_fwd"):
        raise AssertionError("the fp32 prefill chunks never launched "
                             "paged_attention_fwd")
    with ku.force_plain():
        before = ku.launch_counts()
        s_plain, result["fp32_plain"] = serve(torch, params32, cfg32, dev, 0,
                                              requests)
        if ku.launch_counts() != before:
            raise AssertionError("force_plain run launched a kernel")
    streams_equal(torch, "fp32 kernels vs plain", s_kernel, s_plain,
                  requests, logits32)
    s_off, result["fp32_off"] = serve(torch, params32, cfg32, dev, 0,
                                      requests, megakernel="off")
    streams_equal(torch, "fp32 fused vs per-op", s_kernel, s_off, requests,
                  logits32)
    subset = requests[:6]
    for kvq in ("int8", "int4"):
        ku.reset_launch_counts()
        s_on, result[f"fp32_{kvq}"] = serve(torch, params32, cfg32, dev, 0,
                                            subset, kv_quant=kvq)
        result[f"fp32_{kvq}"]["launches"] = ku.launch_counts()
        s_off, result[f"fp32_{kvq}_off"] = serve(
            torch, params32, cfg32, dev, 0, subset, kv_quant=kvq,
            megakernel="off")
        streams_equal(torch, f"fp32 {kvq} fused vs per-op", s_on, s_off,
                      subset)
    del params32

    cfg16 = GPTConfig(dtype=torch.bfloat16)
    params16 = init_gpt_params(cfg16, seed=0, device=dev)
    ku.reset_launch_counts()
    s16, result["bf16_spec0"] = serve(torch, params16, cfg16, dev, 0,
                                      requests)
    launches = ku.launch_counts()
    result["bf16_spec0"]["launches"] = launches
    if result["bf16_spec0"]["decode_kernel"] != "fused":
        raise AssertionError("the bf16 main path did not run fused")
    for name in ("megakernel", "layer_norm_fwd", "paged_mma_fwd"):
        if launches.get(name, 0) <= 0:
            raise AssertionError(f"the main path never launched {name}")
    s16k, result["bf16_spec4"] = serve(torch, params16, cfg16, dev, 4,
                                       requests)
    streams_equal(torch, "bf16 spec_k=4 vs spec_k=0 (fused)", s16k, s16,
                  requests)
    result["bf16_32_slots"] = engine_32_slots(torch, dev, ku, params16,
                                              cfg16)
    result["launches_per_call"] = {
        "decode": fused_launches_per_call(torch, ku, params16, cfg16, dev, 0),
        "verify": fused_launches_per_call(torch, ku, params16, cfg16, dev,
                                          4)}
    quant_launches = {}
    for kvq in ("int8", "int4"):
        ku.reset_launch_counts()
        a, result[f"bf16_{kvq}_spec0"] = serve(torch, params16, cfg16, dev,
                                               0, requests, kv_quant=kvq)
        quant_launches[kvq] = ku.launch_counts()
        result[f"bf16_{kvq}_spec0"]["launches"] = quant_launches[kvq]
        b, result[f"bf16_{kvq}_spec4"] = serve(torch, params16, cfg16, dev,
                                               4, requests, kv_quant=kvq)
        streams_equal(torch, f"bf16 {kvq} spec_k=4 vs spec_k=0 (fused)", b,
                      a, requests)
    ku.reset_launch_counts()
    _, result["bf16_off"] = serve(torch, params16, cfg16, dev, 0, requests,
                                  megakernel="off")
    result["bf16_off"]["launches"] = off = ku.launch_counts()
    if (result["bf16_off"]["decode_kernel"] != "cuda"
            or off.get("megakernel", 0) or not off.get("paged_mma_fwd")
            or not off.get("layer_norm_fwd")):
        raise AssertionError(f"the per-op path's launches look wrong: {off}")
    result["bf16_profile"] = profile_decode(torch, params16, cfg16, dev,
                                            requests)
    result["bf16_profile_off"] = profile_decode(
        torch, params16, cfg16, dev, requests, megakernel="off")
    result["bf16_prefill_profile"] = profile_prefill(
        torch, params16, cfg16, dev,
        max((r.tokens for r in requests), key=len))
    del params16
    result["head_dim_80"] = engine_hd80_phase(torch, dev, ku, requests)
    result["head_dim_320"] = engine_hd320_phase(torch, dev, ku, requests)
    return result, launches, quant_launches


# the fp16 serving kernels' families in a profiler's kernel names
SERVE_HALF_KERNELS = {"megakernel": "fused_layer_kernel",
                      "paged_mma": "paged_mma_kernel",
                      "layer_norm": "norm_"}


class WarningsCaught:
    """Collects the WARNING records of a logger while installed (the
    engine's fallback warnings, ``apex_tpu_torch.serve``)."""

    def __init__(self, name):
        import logging

        self.logger = logging.getLogger(name)
        self.messages = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                outer.messages.append(record.getMessage())

        self.handler = Handler(logging.WARNING)

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


ENGINE16_PATH = ("InferenceEngine, GPT-2-124M fp16, ServeConfig(num_slots=8, "
                 "prefill_chunk=32), the engine phase's 16 requests")


def engine_fp16_phase(torch, dev, ku, bf16_calls):
    """C6's main path: GPT-2-124M in fp16 (``GPTConfig(dtype=float16)``,
    weights from numpy seed 0) serving the engine phase's 16 requests
    (``ServeConfig(num_slots=8, prefill_chunk=32)``), fused by default:
    decode through the fp16 fused layer, the prefill chunks through the
    fp16 ``paged_mma_fwd``; launch counts reset just before and read just
    after. Gates: it resolves to the fused layer; ``spec_k=4`` streams
    equal ``spec_k=0``'s; one decode and one verify call launch what
    bf16's do (``bf16_calls``, the engine phase's: the fused layer a
    layer, the head's LN); ``megakernel="off"`` runs the per-op path (LN
    and paged attention, no fused layer); int8 and int4 pools serve
    (fused); no warning is logged (no fallback); a profiled two-request run shows the
    fused layer's, paged attention's and LN's ``__half`` instantiations.
    Records tokens/s, TTFT p50 and decode-step ms p50 of each run beside
    the bf16 engine's main path run in the same process."""
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    result = {"path": ENGINE16_PATH}
    requests = make_requests(GPTConfig().vocab_size)
    with WarningsCaught("apex_tpu_torch.serve") as caught:
        cfg_b = GPTConfig(dtype=torch.bfloat16)
        params_b = init_gpt_params(cfg_b, seed=0, device=dev)
        _, result["bf16_spec0"] = serve(torch, params_b, cfg_b, dev, 0,
                                        requests)
        del params_b
        cfg = GPTConfig(dtype=torch.float16)
        params = init_gpt_params(cfg, seed=0, device=dev)
        ku.reset_launch_counts()
        s0, result["fp16_spec0"] = serve(torch, params, cfg, dev, 0,
                                         requests)
        launches = ku.launch_counts()
        result["fp16_spec0"]["launches"] = launches
        if result["fp16_spec0"]["decode_kernel"] != "fused":
            raise AssertionError("the fp16 engine did not run fused")
        for name in ("megakernel", "layer_norm_fwd", "paged_mma_fwd"):
            if launches.get(name, 0) <= 0:
                raise AssertionError(f"the fp16 main path never launched "
                                     f"{name}")
        s4, result["fp16_spec4"] = serve(torch, params, cfg, dev, 4,
                                         requests)
        streams_equal(torch, "fp16 spec_k=4 vs spec_k=0 (fused)", s4, s0,
                      requests)
        calls = {
            "decode": fused_launches_per_call(torch, ku, params, cfg, dev, 0),
            "verify": fused_launches_per_call(torch, ku, params, cfg, dev,
                                              4)}
        if calls != bf16_calls:
            raise AssertionError(f"fp16 launches a call {calls}, bf16's "
                                 f"{bf16_calls}")
        result["launches_per_call"] = calls
        ku.reset_launch_counts()
        _, result["fp16_off"] = serve(torch, params, cfg, dev, 0, requests,
                                      megakernel="off")
        result["fp16_off"]["launches"] = off = ku.launch_counts()
        if (result["fp16_off"]["decode_kernel"] != "cuda"
                or off.get("megakernel", 0) or not off.get("paged_mma_fwd")
                or not off.get("layer_norm_fwd")):
            raise AssertionError(f"the fp16 per-op path's launches look "
                                 f"wrong: {off}")
        for kvq in ("int8", "int4"):
            ku.reset_launch_counts()
            _, result[f"fp16_{kvq}_spec0"] = serve(
                torch, params, cfg, dev, 0, requests, kv_quant=kvq)
            result[f"fp16_{kvq}_spec0"]["launches"] = ku.launch_counts()
        result["half_kernels"] = half_kernel_counts(
            torch, lambda: serve(torch, params, cfg, dev, 0, requests[:2]),
            SERVE_HALF_KERNELS)
        if set(result["half_kernels"]) != set(SERVE_HALF_KERNELS):
            raise AssertionError(f"fp16 instantiations launched: "
                                 f"{result['half_kernels']}")
        del params
    result["warnings"] = caught.messages
    if caught.messages:
        raise AssertionError(f"the fp16 engine logged {caught.messages}")
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# the serving engine's telemetry and per-tenant LoRA adapters

LIFECYCLE = ("submitted", "admitted", "prefill_start", "prefill_end",
             "first_token")
LORA_RANK, LORA_ADAPTERS = 16, 4
# the requests bound to an adapter (make_requests' 8 of 16; the even ones
# share the 64-token prefix, 13 is that prefix alone): t1, t2 in turn
LORA_BOUND = (0, 3, 4, 7, 8, 11, 12, 13)
LORA_SCALE = 2.0
LORA_ATOL, LORA_RTOL = 1e-4, 1e-4    # JAX's merged-weight tolerance
NEAR_TIE = 1e-3                       # top-2 gap below which a flip is a tie


def run_engine(torch, eng, requests):
    """Serve ``requests`` on ``eng``; the streams, wall seconds, host ms a
    step (wall / engine steps) and ``stats()``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    streams = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    return streams, {"wall_s": wall, "steps": st["steps"],
                     "host_ms_per_step": wall * 1e3 / st["steps"],
                     "decode_step_ms_p50": st["decode_step_ms_p50"],
                     "decode_step_ms_p99": st["decode_step_ms_p99"],
                     "tokens_per_s": st["tokens_per_s"],
                     "decode_kernel": st["decode_kernel"]}, st


def check_lifecycles(records, uids):
    """Every request's events in lifecycle order, its stamps on the one
    clock non-decreasing: submitted, admitted, prefill_start, prefill_end,
    first_token, decode_chunk*, retired. (Across requests the log is in
    emission order: a step stamps its decode chunks once, after the token
    fence, as JAX's engine does, and a retirement in the same step is
    stamped when it happens.)"""
    by_uid, last_t = {}, {}
    for r in records:
        if r.get("kind") != "event" or "uid" not in r:
            continue
        uid = r["uid"]
        if r["t_ms"] < last_t.get(uid, float("-inf")):
            raise AssertionError(f"{uid}: event clock went back at {r}")
        last_t[uid] = r["t_ms"]
        by_uid.setdefault(uid, []).append(r["event"])
    if set(by_uid) != set(uids):
        raise AssertionError(f"events for {sorted(by_uid)}, expected "
                             f"{sorted(uids)}")
    for uid, evs in by_uid.items():
        head, tail = tuple(evs[:len(LIFECYCLE)]), evs[len(LIFECYCLE):]
        if (head != LIFECYCLE or not tail or tail[-1] != "retired"
                or any(e != "decode_chunk" for e in tail[:-1])):
            raise AssertionError(f"{uid}: events out of lifecycle order: "
                                 f"{evs}")
    return {uid: len(evs) for uid, evs in by_uid.items()}


def evict_restore_run(torch, eng, requests, victims, after=4, away=3):
    """Serve ``requests``, evicting each victim once it has decoded
    ``after`` tokens and restoring it ``away`` steps later (or as soon as
    a slot is free); returns the streams."""
    for r in requests:
        eng.submit(r)
    evicted, done = {}, set()
    while eng.active or evicted:
        eng.step()
        for uid in victims:
            if uid in done or uid in evicted:
                continue
            slot = next((i for i, s in enumerate(eng._slots)
                         if s is not None and s.request.uid == uid), None)
            if (slot is not None and eng._active[slot]
                    and len(eng._slots[slot].generated) >= after):
                evicted[uid] = [eng.evict_slot(uid), away]
        for uid in list(evicted):
            evicted[uid][1] -= 1
            if evicted[uid][1] < 0 and eng._free_slot() is not None:
                eng.restore_slot(evicted.pop(uid)[0])
                done.add(uid)
    torch.cuda.synchronize()
    if done != set(victims):
        raise AssertionError(f"evicted and restored {sorted(done)}, "
                             f"expected {sorted(victims)}")
    return eng.finished


def engine_monitor_phase(torch, dev, ku, card):
    """GPT-2-124M bf16 on the fused main path with every telemetry piece
    on: a ``JsonlSink`` in a temporary directory, ``EventLog(keep=True)``,
    an ``SloSpec``, a ``Meter`` and ``peak_flops_per_s`` set to the card's
    bf16 dense peak (launch counts reset just before the run, read just
    after). Gates: streams bitwise equal to the run without telemetry;
    one sink record per engine step; every request's events in lifecycle
    order; the Chrome trace builds; ``stats()`` has ``hists``,
    ``slo_report`` and ``meter``, and the meter's tokens are the generated
    tokens; two requests evicted mid-decode and restored give the
    uninterrupted streams. The decode-step p50 and host ms a step with
    telemetry on and off (two runs each, in turns)."""
    import os
    import tempfile

    from apex_tpu_torch.monitor import (EventLog, Meter, SloSpec,
                                        JsonlSink, chrome_trace, read_jsonl)
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    cfg = GPTConfig(dtype=torch.bfloat16)
    params = init_gpt_params(cfg, seed=0, device=dev)
    requests = make_requests(cfg.vocab_size)
    scfg = ServeConfig(num_slots=8, prefill_chunk=32)
    out = {"off": [], "on": []}
    ref = None
    with tempfile.TemporaryDirectory() as tmp:
        for turn in range(2):
            eng = InferenceEngine(params, cfg, scfg, device=dev)
            streams, rec, _ = run_engine(torch, eng, requests)
            out["off"].append(rec)
            if ref is None:
                ref = streams
            streams_equal(torch, "telemetry off, two runs", streams, ref,
                          requests)
            path = os.path.join(tmp, f"steps{turn}.jsonl")
            sink = JsonlSink(path)
            events = EventLog(keep=True)
            eng = InferenceEngine(
                params, cfg, scfg, device=dev, sink=sink, events=events,
                slo=SloSpec(ttft_ms=2000.0, tpot_ms=50.0), meter=Meter(),
                peak_flops_per_s=PEAK_OPS_PER_S["bfloat16"])
            ku.reset_launch_counts()
            streams, rec, st = run_engine(torch, eng, requests)
            rec["launches"] = ku.launch_counts()
            sink.close()
            out["on"].append(rec)
            streams_equal(torch, "telemetry on vs off", streams, ref,
                          requests)
            if rec["decode_kernel"] != "fused" or not all(
                    rec["launches"].get(k) for k in (
                        "megakernel", "layer_norm_fwd", "paged_mma_fwd")):
                raise AssertionError(f"the monitored run did not take the "
                                     f"fused main path: "
                                     f"{rec['decode_kernel']} "
                                     f"{rec['launches']}")
            sink_recs = list(read_jsonl(path))
            if len(sink_recs) != st["steps"]:
                raise AssertionError(f"{len(sink_recs)} sink records for "
                                     f"{st['steps']} engine steps")
            decode_recs = [r for r in sink_recs if r["phase"] == "decode"]
            if not decode_recs or not all(
                    "decode_mfu" in r and r["active_slots"] >= 1
                    for r in decode_recs):
                raise AssertionError("decode records without decode_mfu or "
                                     "active slots")
            n_events = check_lifecycles(events.records,
                                        [r.uid for r in requests])
            trace = chrome_trace(events.records)
            json.dumps(trace)
            for key in ("hists", "slo_report", "meter"):
                if key not in st:
                    raise AssertionError(f"stats() lacks {key}")
            meter_tokens = st["meter"]["totals"]["tokens"]
            if meter_tokens != st["generated_tokens"]:
                raise AssertionError(f"meter tokens {meter_tokens} != "
                                     f"generated {st['generated_tokens']}")
            rec.update(sink_records=len(sink_recs),
                       events=len(events.records),
                       events_per_request_max=max(n_events.values()),
                       trace_events=len(trace["traceEvents"]),
                       slo_good=st["slo_report"]["good"],
                       mfu_median=sorted(r["decode_mfu"] for r in
                                         decode_recs)[len(decode_recs) // 2])
            del eng, sink, events
    victims = [requests[2].uid, requests[5].uid]
    eng = InferenceEngine(params, cfg, scfg, device=dev)
    got = evict_restore_run(torch, eng, requests, victims)
    streams_equal(torch, "evict + restore vs uninterrupted", got, ref,
                  requests)
    out["evicted"] = victims
    out["card"] = card
    for key in ("decode_step_ms_p50", "host_ms_per_step"):
        out[f"{key}_off"] = sorted(r[key] for r in out["off"])
        out[f"{key}_on"] = sorted(r[key] for r in out["on"])
    out["launches"] = out["on"][-1]["launches"]
    del params
    return out


def numpy_adapter(torch, cfg, seed: int, dev, dtype=None, std=0.02):
    """One LoRA adapter's factors for ``cfg`` at rank :data:`LORA_RANK`
    from numpy seed ``seed`` (normal(std)), carried to the card with
    ``convert.adapter_weights_from_numpy``."""
    import numpy as np

    from apex_tpu_torch.convert import adapter_weights_from_numpy
    from apex_tpu_torch.serve import ADAPTER_TARGETS

    h, f, L = cfg.hidden, cfg.ffn_hidden, cfg.num_layers
    dims = {"qkv": (h, 3 * h), "out": (h, h), "fc1": (h, f), "fc2": (f, h)}
    rng = np.random.default_rng(seed)
    w = {}
    for t in ADAPTER_TARGETS:
        d_in, d_out = dims[t]
        w[f"{t}_a"] = (rng.standard_normal((L, d_in, LORA_RANK))
                       * std).astype(np.float32)
        w[f"{t}_b"] = (rng.standard_normal((L, LORA_RANK, d_out))
                       * std).astype(np.float32)
    return adapter_weights_from_numpy(w, dev, dtype or cfg.dtype)


def lora_requests(requests):
    """``requests`` with :data:`LORA_BOUND` bound to t1 and t2 in turn."""
    import dataclasses

    bound = {requests[i].uid: ("t1", "t2")[j % 2]
             for j, i in enumerate(LORA_BOUND)}
    return [dataclasses.replace(r, adapter=bound.get(r.uid))
            for r in requests], bound


def lora_engine(torch, params, cfg, dev, spec_k=0, weights=(), **kw):
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig

    eng = InferenceEngine(params, cfg, ServeConfig(
        num_slots=8, prefill_chunk=32, spec_k=spec_k, lora_rank=LORA_RANK,
        max_adapters=LORA_ADAPTERS), device=dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, w in weights:
        eng.load_adapter(name, w, scale=LORA_SCALE)
    torch.cuda.synchronize()
    return eng, (time.perf_counter() - t0) * 1e3 / max(1, len(weights))


def engine_lora_phase(torch, dev, ku, card):
    """GPT-2-124M bf16 with per-tenant LoRA (``lora_rank=16``,
    ``max_adapters=4``, two adapters from numpy seeds 11 and 12, scale 2)
    and :data:`LORA_BOUND` (8 of the 16 requests) bound to them: the
    engine resolves to the per-op kernels (``decode_kernel == "cuda"``)
    with the fallback reason logged; the main run's launch counts reset
    just before it and read just after; base-traffic streams bitwise
    equal to a ``megakernel="off"`` engine without adapters; ``spec_k=4``
    streams (every step with room a verify call) equal to ``spec_k=0``
    for all 16; launches of one decode and one verify call equal to the
    per-op base's; in fp32, a tenant's prefill logits through the adapter
    pool within 1e-4 of the merged-weight model and its greedy streams
    equal to the merged engine's up to the first near-tie."""
    import dataclasses
    import logging

    from apex_tpu_torch.serve import (InferenceEngine, ServeConfig,
                                      adapter_pool_bytes, gpt_prefill_chunk,
                                      init_adapter_pool, init_kv_cache,
                                      merge_adapter_params, write_adapter)
    from apex_tpu_torch.serve.kv_cache import KVCacheConfig
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    class Capture(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    out = {"card": card}
    cfg = GPTConfig(dtype=torch.bfloat16)
    params = init_gpt_params(cfg, seed=0, device=dev)
    requests = make_requests(cfg.vocab_size)
    bound_reqs, bound = lora_requests(requests)
    weights = [("t1", numpy_adapter(torch, cfg, 11, dev)),
               ("t2", numpy_adapter(torch, cfg, 12, dev))]
    cap = Capture()
    log = logging.getLogger("apex_tpu_torch.serve")
    log.addHandler(cap)
    try:
        eng, load_ms = lora_engine(torch, params, cfg, dev, weights=weights)
    finally:
        log.removeHandler(cap)
    if eng.decode_kernel != "cuda" or eng.megakernel_enabled:
        raise AssertionError(f"the adapter engine runs {eng.decode_kernel}, "
                             f"expected the per-op kernels ('cuda')")
    if not any("LoRA" in line for line in cap.lines):
        raise AssertionError(f"the megakernel fallback reason was not "
                             f"logged: {cap.lines}")
    out["fallback_log"] = cap.lines
    ku.reset_launch_counts()
    s0, rec, st = run_engine(torch, eng, bound_reqs)
    rec["launches"] = launches = ku.launch_counts()
    if launches.get("megakernel") or not all(
            launches.get(k) for k in ("layer_norm_fwd", "paged_mma_fwd")):
        raise AssertionError(f"the LoRA main path's launches look wrong: "
                             f"{launches}")
    ad = st["adapters"]
    if ad["hits"] != len(LORA_BOUND) or ad["resident"] != 2:
        raise AssertionError(f"adapter counters: {ad}")
    out["spec0"] = rec
    out["adapter_load_ms"] = load_ms
    out["pool_bytes"] = ad["pool_bytes"]
    if ad["pool_bytes"] != adapter_pool_bytes(cfg, LORA_RANK, LORA_ADAPTERS):
        raise AssertionError("pool bytes do not match the pool")
    out["stats_adapters"] = ad
    base, out["base_off"] = serve(torch, params, cfg, dev, 0, requests,
                                  megakernel="off")
    unbound = [r for r in requests if r.uid not in bound]
    streams_equal(torch, "LoRA engine base traffic vs engine without "
                  "adapters", {r.uid: s0[r.uid] for r in unbound},
                  {r.uid: base[r.uid] for r in unbound}, unbound)
    differs = sum(s0[u] != base[u] for u in bound)
    out["bound_streams_differing_from_base"] = differs
    if not differs:
        raise AssertionError("no adapter-bound stream differs from the "
                             "base model's: the adapters did nothing")
    eng4, _ = lora_engine(torch, params, cfg, dev, spec_k=4,
                          weights=weights, drafter=RepeatDrafter())
    s4, out["spec4"], st4 = run_engine(torch, eng4, bound_reqs)
    if not st4["speculative"]["verify_steps"]:
        raise AssertionError("the spec_k=4 LoRA run made no verify call")
    streams_equal(torch, "LoRA spec_k=4 vs spec_k=0", s4, s0, bound_reqs)
    # the per-op table: LayerNorm 2 a layer + the head's, paged
    # attention one a layer
    per_op = {"layer_norm_fwd": 2 * cfg.num_layers + 1,
              "paged_mma_fwd": cfg.num_layers}
    out["launches_per_call"] = {
        "lora_decode": launches_per_call(
            torch, ku, lora_engine(torch, params, cfg, dev,
                                   weights=weights)[0], 0, per_op),
        "lora_verify": launches_per_call(
            torch, ku, lora_engine(torch, params, cfg, dev, spec_k=4,
                                   weights=weights,
                                   drafter=RepeatDrafter())[0], 4, per_op),
        "base_decode": launches_per_call(
            torch, ku, InferenceEngine(params, cfg, ServeConfig(
                num_slots=8, prefill_chunk=32, megakernel="off"),
                device=dev), 0, per_op)}
    del eng, eng4, params

    # fp32: the adapter pool against the merged-weight model
    cfg32 = GPTConfig(dtype=torch.float32)
    params32 = init_gpt_params(cfg32, seed=0, device=dev)
    w1 = numpy_adapter(torch, cfg32, 11, dev)
    merged = merge_adapter_params(params32, w1, scale=LORA_SCALE)
    pool = init_adapter_pool(cfg32, LORA_RANK, LORA_ADAPTERS, device=dev)
    write_adapter(pool, 1, w1, scale=LORA_SCALE)
    bs, chunk = 16, 32
    mb = -(-cfg32.max_seq // bs)
    kv = KVCacheConfig(num_layers=cfg32.num_layers,
                       num_heads=cfg32.num_heads, head_dim=cfg32.head_dim,
                       num_blocks=mb, block_size=bs, dtype=cfg32.dtype)

    def logits_of(p, tokens, **kw):
        cache = init_kv_cache(kv, dev)
        row = torch.arange(mb, dtype=torch.int32, device=dev)
        logits = None
        for c in range(0, len(tokens), chunk):
            part = tokens[c:c + chunk]
            t = torch.zeros(chunk, dtype=torch.int32, device=dev)
            t[:len(part)] = torch.tensor(part, dtype=torch.int32,
                                         device=dev)
            cache, logits = gpt_prefill_chunk(p, t, c, len(part), cache,
                                              row, cfg32, kv, **kw)
        return logits

    probe = requests[0].tokens[:100]
    got = logits_of(params32, probe, adapters=pool, adapter_id=1)
    want = logits_of(merged, probe)
    torch.testing.assert_close(got, want, atol=LORA_ATOL, rtol=LORA_RTOL)
    out["fp32_logits_max_abs_err"] = float((got - want).abs().max())
    out["fp32_logits_differ_from_base"] = float(
        (want - logits_of(params32, probe)).abs().max())
    t1_reqs = [r for r in bound_reqs if r.adapter == "t1"]
    eng32, _ = lora_engine(torch, params32, cfg32, dev,
                           weights=[("t1", w1)])
    got_s = eng32.run(t1_reqs)
    want_s, _ = serve(torch, merged, cfg32, dev, 0,
                      [dataclasses.replace(r, adapter=None)
                       for r in t1_reqs], megakernel="off")
    ties = {}
    for r in t1_reqs:
        a, b = got_s[r.uid], want_s[r.uid]
        j = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        gap = top2_gap(torch, logits_of(merged, list(r.tokens) + b[:j]))
        if gap >= NEAR_TIE:
            raise AssertionError(f"fp32 LoRA vs merged: {r.uid} differs at "
                                 f"token {j} ({a[j]} vs {b[j]}) where the "
                                 f"top-2 gap is {gap:.3e} (>= {NEAR_TIE})")
        ties[r.uid] = {"token": j, "top2_gap": gap}
    out["fp32_merged_streams"] = {"requests": len(t1_reqs),
                                  "equal": len(t1_reqs) - len(ties),
                                  "near_ties": ties}
    del params32, merged, eng32, pool
    return out


# ---------------------------------------------------------------------------
# train phase

# kernel launches of one GPT-2-124M train step (12 layers, full remat):
# 2 LN per layer + the head's, each layer's LNs and attention replayed in
# backward, one backward per forward; the fused LM-head loss once (outside
# the remat blocks); the Adam tail once per leaf (16 leaves)
TRAIN_LAUNCHES = {"layer_norm_fwd": 25 + 24, "layer_norm_bwd": 25,
                  "flash_mma_fwd": 12 + 12,
                  "flash_mma_bwd_dq": 12,
                  "flash_mma_bwd_dkv": 12,
                  "lm_head_mma_fwd": 1, "lm_head_mma_bwd_dx": 1,
                  "lm_head_mma_bwd_dw": 1, "fused_adam_tail": 16}


def train_fp32_check(torch, dev, ku):
    """One fp32 GPT-2-124M forward + backward (batch 2 x 1024, full remat,
    the default fused LM-head loss) through the kernels vs the same with
    the plain versions forced.
    Tolerance: loss relative 1e-5; every gradient leaf max |kernel - plain|
    <= 1e-5 * max |plain| (fp32 through 12 layers, sums in other orders;
    the largest measured is 1.3e-6 of the leaf's scale)."""
    import numpy as np

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig, gpt_loss,
                                                    init_gpt_params)

    cfg = GPTConfig(dtype=torch.float32)
    params = init_gpt_params(cfg, seed=0, device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1024))).to(dev)
    tgt = torch.roll(tok, -1, dims=1)
    return {"batch": 2, "seq": 1024, **fp32_gate(
        torch, ku, "train", leaves, lambda: gpt_loss(params, tok, tgt, cfg),
        {"lm_head_loss_bwd_dw": 1})}


# the bf16 gates of the GPT and T5 phases: loss relative error, and each
# gradient leaf's |kernels - plain| norm over its plain norm. Both sides
# round to bf16 at the same places (the flash kernels' p and ds, every
# layer's output); the kernels sum in other orders, so a bf16 output can
# land one rounding step (2**-8 relative) away, and that difference runs
# through every later layer and back
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_NORM_RTOL = 5e-2


def bf16_gate(torch, ku, what, leaves, loss_fn):
    """One bf16 forward + backward through the kernels (launch counts
    reset just before, read just after) vs the same with the plain
    versions forced: the loss within BF16_LOSS_RTOL and every gradient
    leaf within BF16_GRAD_NORM_RTOL of the plain one, in norm."""

    def loss_and_grads():
        for _, p in leaves:
            p.grad = None
        loss = loss_fn()
        loss.backward()
        return loss.item(), [p.grad.float() for _, p in leaves]

    ku.reset_launch_counts()
    lk, gk = loss_and_grads()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    with ku.force_plain():
        lp, gp = loss_and_grads()
    loss_err = abs(lk - lp) / abs(lp)
    if not math.isfinite(lk) or loss_err > BF16_LOSS_RTOL:
        raise AssertionError(f"bf16 {what} loss: kernels {lk} vs plain {lp}"
                             f" (rel {loss_err:.3e}, limit {BF16_LOSS_RTOL})")
    worst, worst_name = 0.0, ""
    for (name, _), a, b in zip(leaves, gk, gp):
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        if not bool(a.isfinite().all()) or rel > BF16_GRAD_NORM_RTOL:
            raise AssertionError(
                f"bf16 {what} grad {name}: |kernels - plain| / |plain| = "
                f"{rel:.3e} (limit {BF16_GRAD_NORM_RTOL})")
        if rel > worst:
            worst, worst_name = rel, name
    return {"loss_kernels": lk, "loss_plain": lp, "loss_rel_err": loss_err,
            "loss_rtol": BF16_LOSS_RTOL, "grad_max_norm_rel_err": worst,
            "grad_worst_leaf": worst_name,
            "grad_norm_rtol": BF16_GRAD_NORM_RTOL, "launches": counts}


def train_bf16_check(torch, dev, ku):
    """The bf16 gate on GPT-2-124M (batch 2 x 1024, the default step's
    loss: full remat, fused LM-head loss): its flash forward, dQ and dK/dV
    and its LM-head forward, dX and dW run on the tensor cores, which the
    fp32 check does not reach."""
    import numpy as np

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig, gpt_loss,
                                                    init_gpt_params)

    cfg = GPTConfig()
    params = init_gpt_params(cfg, seed=0, device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1024))).to(dev)
    tgt = torch.roll(tok, -1, dims=1)
    out = bf16_gate(torch, ku, "train", leaves,
                    lambda: gpt_loss(params, tok, tgt, cfg))
    for name in ("flash_mma_fwd", "flash_mma_bwd_dq", "flash_mma_bwd_dkv",
                 "lm_head_mma_fwd", "lm_head_mma_bwd_dx",
                 "lm_head_mma_bwd_dw"):
        if out["launches"].get(name, 0) != TRAIN_LAUNCHES[name]:
            raise AssertionError(f"bf16 check launches {out['launches']}")
    return {"batch": 2, "seq": 1024, **out}


def timed_steps_of(torch, step, n: int, hosts=None):
    """Wall seconds of ``n`` calls of ``step``, each ended by a sync; the
    host seconds of each (the call's return, before the sync) appended to
    ``hosts`` when given."""
    durs = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        if hosts is not None:
            hosts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        durs.append(time.perf_counter() - t0)
    return durs


def unfused_step(torch, dev, batch: int, seq: int, steps: int = 10):
    """The unfused step (``fused_loss=False``, ``fused_tail="off"``: logits
    + CE and the Adam op chain) at the same batch, for the fused-vs-unfused
    comparison on this card: tokens/s over ``steps`` timed steps after two
    warm-up steps, the device's busy ms per step over 3 profiled steps
    (host-clock step times spread more between calls than device time),
    and the losses, which must be finite and fall."""
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)

    step = build_train_step(GPTConfig(fused_loss=False), batch, seq,
                            device=dev, seed=0, fused_tail="off")[0]
    losses = [float(step()) for _ in range(2)]
    durs = timed_steps_of(torch, step, steps)
    prof = profiled(torch, lambda: [step() for _ in range(3)])
    del step
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses) or not losses[1] < losses[0]:
        raise AssertionError(f"unfused bf16 loss did not fall: {losses}")
    return {"fused_loss": False, "fused_tail": "off", "losses": losses,
            "tokens_per_s": batch * seq * steps / sum(durs),
            "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
            "step_ms": [d * 1e3 for d in durs],
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "top": prof["top"]}


def train_phase(torch, dev, ku, steps: int = 10, timed_steps: int = 10):
    """The bf16 default step (the training main path): launch counts of one
    step, a falling and bitwise repeatable loss, speed, memory and the
    card's busy share; then the unfused step timed beside it."""
    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)

    phase_s = {}
    t0 = time.perf_counter()
    result = {"fp32_check": train_fp32_check(torch, dev, ku)}
    torch.cuda.empty_cache()
    phase_s["fp32_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["bf16_check"] = train_bf16_check(torch, dev, ku)
    torch.cuda.empty_cache()
    phase_s["bf16_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = GPTConfig()         # bf16, full remat, fused LM-head loss
    batch, seq = 8, 1024
    assert batch * seq == TRAIN_ROWS
    torch.cuda.reset_peak_memory_stats()
    step, params, _, _, _ = build_train_step(cfg, batch, seq, device=dev,
                                             seed=0)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    ku.reset_launch_counts()
    losses = [step()]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"train step launches {launches}, expected "
                             f"{TRAIN_LAUNCHES}")
    losses += [step() for _ in range(TP_STEPS - 1)]
    # the no-mesh run the tp phase holds its variants to, bitwise
    after_tp_steps = {k: p.detach().clone() for k, p in named_leaves(params)}
    losses += [step() for _ in range(steps - TP_STEPS)]
    losses = torch.stack(losses)
    vals = losses.tolist()
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"bf16 train loss did not fall: {vals}")
    durs = timed_steps_of(torch, step, timed_steps)
    tokens_per_s = batch * seq * timed_steps / sum(durs)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profiled(torch, lambda: [step() for _ in range(3)])
    prof["device_busy_share_of_unprofiled_wall"] = (
        prof["device_busy_ms"] / (3 * sum(durs) / timed_steps * 1e3))
    del step, params
    torch.cuda.empty_cache()
    phase_s["default_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step2 = build_train_step(cfg, batch, seq, device=dev, seed=0)[0]
    again = torch.stack([step2() for _ in range(steps)])
    if not torch.equal(losses, again):
        raise AssertionError(f"bf16 losses differ between two runs from one "
                             f"seed: {vals} vs {again.tolist()}")
    del step2
    torch.cuda.empty_cache()
    phase_s["bitwise_repeat"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["unfused_step"] = unfused_step(torch, dev, batch, seq)
    phase_s["unfused_step"] = time.perf_counter() - t0
    result.update({
        "phase_s": phase_s,
        "batch": batch, "seq": seq, "n_params": n_params,
        "launches_per_step": launches, "losses": vals,
        "bitwise_repeat": True, "tokens_per_s": tokens_per_s,
        "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
        "step_ms": [d * 1e3 for d in durs],
        "mfu_6n": 6 * n_params * tokens_per_s / PEAK_OPS_PER_S["bfloat16"],
        "mfu_bench_py": (6 * n_params + 6 * cfg.num_layers * cfg.hidden * seq)
        * tokens_per_s / PEAK_OPS_PER_S["bfloat16"],
        "peak_mem_gib": peak_gib, "profile_3_steps": prof,
        "_leaves_after_tp_steps": after_tp_steps})
    return result


# ---------------------------------------------------------------------------
# T5 train phase

# kernel launches of one T5-small train step (6 + 6 layers, full remat):
# LN 2 per encoder and 3 per decoder layer, each replayed in backward, plus
# the encoder-final and the head LN; flash forward for each self-attention
# (with its stack's bias) and each cross-attention (none), replayed; one
# backward of each; d(bias) once per self-attention; the fused LM-head loss
# once; the Adam tail once per leaf (39 leaves)
T5_LAUNCHES = {"layer_norm_fwd": 2 * (6 * 2 + 6 * 3) + 2,
               "layer_norm_bwd": 6 * 2 + 6 * 3 + 2,
               "flash_mma_fwd": 2 * 18,
               "flash_mma_fwd[bias]": 2 * 12,
               "flash_mma_bwd_dq": 18,
               "flash_mma_bwd_dq[bias]": 12,
               "flash_mma_bwd_dkv": 18,
               "flash_mma_bwd_dkv[bias]": 12,
               "flash_mma_bwd_dbias": 12,
               "lm_head_mma_fwd": 1, "lm_head_mma_bwd_dx": 1,
               "lm_head_mma_bwd_dw": 1, "fused_adam_tail": 39}


def t5_config(dtype):
    from apex_tpu_torch.transformer.testing import T5Config

    return T5Config(dtype=dtype, relative_position_bias=True,
                    encoder_final_ln=True)


def t5_fp32_check(torch, dev, ku):
    """One fp32 T5-small forward + backward (batch 2, 512 + 128 tokens,
    full remat, the fused LM-head loss) through the kernels vs the same
    with the plain versions forced. Tolerance as the GPT check: loss
    relative 1e-5; every gradient leaf max |kernel - plain| <= 1e-5 * max
    |plain|. The bias tables rel_enc / rel_dec must get nonzero
    gradients."""
    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (build_t5_train_step,
                                                    t5_loss)

    cfg = t5_config(torch.float32)
    _, params, _, (enc, dec, tgt) = build_t5_train_step(
        cfg, 2, T5_ENC, T5_DEC, device=dev, seed=0)
    leaves = list(named_leaves(params))
    out = fp32_gate(torch, ku, "T5", leaves,
                    lambda: t5_loss(params, enc, dec, tgt, cfg),
                    {"flash_attention_bwd_dbias": 12},
                    nonzero=("embed.rel_enc", "embed.rel_dec"))
    return {"batch": 2, "seq_enc": T5_ENC, "seq_dec": T5_DEC, **out}


def t5_bf16_check(torch, dev, ku):
    """The bf16 gate on T5-small (batch 2, 512 + 128 tokens, full remat,
    fused loss): its flash forward, dQ and dK/dV, with and without the
    bias, its d(bias) and its LM-head forward, dX and dW run on the
    tensor cores, which the fp32 check does not reach."""
    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (build_t5_train_step,
                                                    t5_loss)

    cfg = t5_config(torch.bfloat16)
    _, params, _, (enc, dec, tgt) = build_t5_train_step(
        cfg, 2, T5_ENC, T5_DEC, device=dev, seed=0)
    out = bf16_gate(torch, ku, "T5", list(named_leaves(params)),
                    lambda: t5_loss(params, enc, dec, tgt, cfg))
    for name in ("flash_mma_fwd", "flash_mma_fwd[bias]", "flash_mma_bwd_dq",
                 "flash_mma_bwd_dq[bias]", "flash_mma_bwd_dkv",
                 "flash_mma_bwd_dkv[bias]", "flash_mma_bwd_dbias",
                 "lm_head_mma_fwd", "lm_head_mma_bwd_dx",
                 "lm_head_mma_bwd_dw"):
        if out["launches"].get(name, 0) != T5_LAUNCHES[name]:
            raise AssertionError(f"bf16 T5 check launches {out['launches']}")
    return {"batch": 2, "seq_enc": T5_ENC, "seq_dec": T5_DEC, **out}


def t5_train_phase(torch, dev, ku, steps: int = 10, timed_steps: int = 10):
    """T5-small (``T5Config(relative_position_bias=True,
    encoder_final_ln=True)``: 6 + 6 layers, hidden 512, 8 heads of 64,
    vocab 32128), full remat, the fused LM-head loss, ``FusedAdam(lr=1e-4,
    fused_tail="auto")``: the fp32 check, then the bf16 step at batch 8 x
    (512 + 128) (the T5 main path): the launch counts of one step (reset
    just before it, read just after) equal T5_LAUNCHES; the loss stays
    finite and falls over 10 steps; a second run from the same seed
    repeats the losses bitwise; train tokens/s (encoder + decoder tokens),
    step ms p50, peak memory, and the card's busy share and top kernels
    over a profiled window."""
    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import build_t5_train_step

    phase_s = {}
    t0 = time.perf_counter()
    result = {"fp32_check": t5_fp32_check(torch, dev, ku)}
    torch.cuda.empty_cache()
    phase_s["fp32_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    result["bf16_check"] = t5_bf16_check(torch, dev, ku)
    torch.cuda.empty_cache()
    phase_s["bf16_check"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg = t5_config(torch.bfloat16)
    torch.cuda.reset_peak_memory_stats()
    step, params, _, _ = build_t5_train_step(cfg, T5_BATCH, T5_ENC, T5_DEC,
                                             device=dev, seed=0)
    n_params = sum(p.numel() for _, p in named_leaves(params))
    ku.reset_launch_counts()
    losses = [step()]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    if launches != T5_LAUNCHES:
        raise AssertionError(f"T5 train step launches {launches}, expected "
                             f"{T5_LAUNCHES}")
    losses += [step() for _ in range(TP_STEPS - 1)]
    after_tp_steps = {k: p.detach().clone() for k, p in named_leaves(params)}
    losses += [step() for _ in range(steps - TP_STEPS)]
    losses = torch.stack(losses)
    vals = losses.tolist()
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"T5 bf16 train loss did not fall: {vals}")
    durs = timed_steps_of(torch, step, timed_steps)
    tokens = T5_BATCH * (T5_ENC + T5_DEC)
    tokens_per_s = tokens * timed_steps / sum(durs)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profiled(torch, lambda: [step() for _ in range(3)])
    prof["device_busy_share_of_unprofiled_wall"] = (
        prof["device_busy_ms"] / (3 * sum(durs) / timed_steps * 1e3))
    del step, params
    torch.cuda.empty_cache()
    phase_s["bf16_step"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    step2 = build_t5_train_step(cfg, T5_BATCH, T5_ENC, T5_DEC, device=dev,
                                seed=0)[0]
    again = torch.stack([step2() for _ in range(steps)])
    if not torch.equal(losses, again):
        raise AssertionError(f"T5 bf16 losses differ between two runs from "
                             f"one seed: {vals} vs {again.tolist()}")
    del step2
    torch.cuda.empty_cache()
    phase_s["bitwise_repeat"] = time.perf_counter() - t0
    result.update({
        "phase_s": phase_s, "batch": T5_BATCH, "seq_enc": T5_ENC,
        "seq_dec": T5_DEC, "n_params": n_params,
        "launches_per_step": launches, "losses": vals,
        "bitwise_repeat": True, "tokens_per_s": tokens_per_s,
        "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
        "step_ms": [d * 1e3 for d in durs],
        "peak_mem_gib": peak_gib, "profile_3_steps": prof,
        "_leaves_after_tp_steps": after_tp_steps})
    return result


# ---------------------------------------------------------------------------
# hidden dropout (csrc/dropout.cu), GPT and T5 training with dropout and
# the remat policies, and the Megatron functional ops

# instructions one element of the dropout kernel needs at least: threefry's
# 20 rounds of add, rotate (one funnel shift) and xor (60), the key
# injections an add cannot absorb (x1's five and the last of x0's; x0's
# others fold into the next round's three-input add), the xor of the two
# hashed words, the compare against the threshold, the product, the select
# and the counter's step
DROPOUT_OPS_PER_ELEMENT = 71
# the most instructions the H100 issues: 4 warp instructions (128 lanes) a
# clock on each of 132 SMs at 1.98 GHz, whatever their pipe (integer adds
# also issue on the FMA pipe as IMAD)
PEAK_INSTR_PER_S = 132 * 128 * 1.98e9
DROPOUT_RATE = 0.1
DROPOUT_SHAPES = [("gpt", (8, 1024, 768)), ("t5", (8, 512, 512)),
                  ("odd", (1_000_003,))]
DROPOUT_POLICIES = ("full", "dots", "dots_attn")


def dropout_bound(n: int, esz: int):
    """The dropout's bound: each element read and written once (bytes), or
    DROPOUT_OPS_PER_ELEMENT instructions at PEAK_INSTR_PER_S."""
    t_bytes = 2 * n * esz / HBM_BYTES_PER_S * 1e3
    t_ops = DROPOUT_OPS_PER_ELEMENT * n / PEAK_INSTR_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_bound_ms": t_bytes, "ops_bound_ms": t_ops,
            "bound_formula": f"max(2·n·{esz} B / 3.35e12 B/s, "
                             f"{DROPOUT_OPS_PER_ELEMENT}·n instructions / "
                             f"{PEAK_INSTR_PER_S:.4g} issued/s)"}


def dropout_phase(torch, dev, ku):
    """The hidden-dropout kernel at GPT-2's site (8, 1024, 768), T5-small's
    (8, 512, 512) and an odd count (1,000,003), fp32, bf16 and fp16, rate
    0.1:
    y bitwise the plain version's (the int64 threefry draw) and over two
    launches; through ``hidden_dropout``'s autograd, y and dx bitwise, two
    launches counted a call; the keep share within 5σ of 0.9. Times the
    kernel, the plain version and ``F.dropout`` (Philox: not the same
    function, a rate yardstick only) against the bound."""
    import torch.nn.functional as F

    from apex_tpu_torch.ops.dropout import (hidden_dropout,
                                            hidden_dropout_fwd,
                                            hidden_dropout_reference)
    from apex_tpu_torch.transformer.tensor_parallel import prng_key

    gen = torch.Generator(device=dev).manual_seed(7)
    rate, cases = DROPOUT_RATE, []
    for shape_name, shape in DROPOUT_SHAPES:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            x = torch.randn(*shape, device=dev, generator=gen).to(dt)
            dy = torch.randn(*shape, device=dev, generator=gen).to(dt)
            key = prng_key(len(cases) + 1)
            tag = f"dropout {shape_name} {dt}"
            y = hidden_dropout_fwd(x, rate, key)
            again = hidden_dropout_fwd(x, rate, key)
            plain = hidden_dropout_reference(x, rate, key)
            torch.cuda.synchronize()
            if not (torch.equal(y, plain) and torch.equal(y, again)):
                raise AssertionError(f"{tag}: kernel not bitwise its plain "
                                     f"version or its repeat")
            xr = x.clone().requires_grad_()
            before = ku.launch_counts().get("hidden_dropout", 0)
            out = hidden_dropout(xr, rate, key)
            out.backward(dy)
            torch.cuda.synchronize()
            launches = ku.launch_counts()["hidden_dropout"] - before
            if launches != 2 or not torch.equal(out, y) or not torch.equal(
                    xr.grad, hidden_dropout_reference(dy, rate, key)):
                raise AssertionError(f"{tag}: autograd launches {launches} "
                                     f"or y / dx not bitwise the plain "
                                     f"version's")
            live = x != 0
            n_live = int(live.sum())
            keep = int(((y != 0) & live).sum()) / n_live
            sigma = math.sqrt(rate * (1 - rate) / n_live)
            if abs(keep - (1 - rate)) > 5 * sigma:
                raise AssertionError(f"{tag}: keep share {keep} is more than "
                                     f"5 sigma ({sigma:.2e}) from {1 - rate}")
            n = x.numel()
            cases.append({
                "shape": shape_name, "dims": list(shape), "elements": n,
                "dtype": str(dt).split(".")[-1], "rate": rate,
                "max_abs_err": 0.0, "bitwise": True, "keep_share": keep,
                "keep_sigma": sigma, "launches_per_call": launches,
                "ms": time_ms(torch, lambda: hidden_dropout_fwd(x, rate, key)),
                "plain_ms": time_ms(torch, lambda: hidden_dropout_reference(
                    x, rate, key), iters=5),
                "library_ms": None,
                "f_dropout_ms_not_the_same_function": time_ms(
                    torch, lambda: F.dropout(x, rate, training=True)),
                **dropout_bound(n, x.element_size())})
            del x, dy, y, again, plain, xr, out
            torch.cuda.empty_cache()
    return cases


def dropout_train_launches(policy: str):
    """Kernel launches of one GPT-2-124M step with both rates 0.1: the
    default step's table, the flash forward not replayed under
    ``dots_attn`` (it saves (o, lse)), and hidden dropout at 25 sites (the
    embedding's and two a layer): 25 forward, 12 in the recompute (a
    layer's recompute stops after the attention branch's, the last of its
    outputs that backward reads), 25 backward."""
    want = dict(TRAIN_LAUNCHES, hidden_dropout=25 + 12 + 25)
    if policy == "dots_attn":
        want["flash_mma_fwd"] = 12
    return want


# one T5-small step with both rates 0.1: the T5 table and hidden dropout at
# 32 sites (each stack's embedding, 2 a encoder and 3 a decoder layer): 32
# forward, 18 in the recompute (an encoder layer's 1, a decoder layer's 2:
# the MLP branch's is not replayed), 32 backward
T5_DROPOUT_LAUNCHES = dict(T5_LAUNCHES, hidden_dropout=32 + 18 + 32)


def fp32_gate(torch, ku, what, leaves, loss_fn, want_launches, nonzero=()):
    """One fp32 forward + backward through the kernels (launch counts
    reset just before, read just after, each of ``want_launches`` as
    given) vs the same with the plain versions forced: loss relative 1e-5,
    every gradient leaf max |kernels - plain| <= 1e-5 · max |plain| (the
    train phases' fp32 gate); the leaves named in ``nonzero`` must get a
    nonzero gradient through the kernels (their max |grad| reported as
    ``rel_table_grad_max_abs``)."""

    def loss_and_grads():
        for _, p in leaves:
            p.grad = None
        loss = loss_fn()
        loss.backward()
        return loss.item(), [p.grad for _, p in leaves]

    ku.reset_launch_counts()
    lk, gk = loss_and_grads()
    torch.cuda.synchronize()
    counts = ku.launch_counts()
    wrong = {k: (counts.get(k, 0), v) for k, v in want_launches.items()
             if counts.get(k, 0) != v}
    if wrong:
        raise AssertionError(f"fp32 {what} launches (got, want): {wrong}")
    with ku.force_plain():
        before = ku.launch_counts()
        lp, gp = loss_and_grads()
        if ku.launch_counts() != before:
            raise AssertionError(f"force_plain {what} launched a kernel")
    loss_err = abs(lk - lp) / abs(lp)
    if not math.isfinite(lk) or loss_err > 1e-5:
        raise AssertionError(f"fp32 {what} loss: kernels {lk} vs plain {lp}")
    worst, named = 0.0, {}
    for (name, _), a, b in zip(leaves, gk, gp):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not bool(a.isfinite().all()) or err > 1e-5 * scale:
            raise AssertionError(
                f"fp32 {what} grad {name}: kernels vs plain max abs err "
                f"{err:.3e} (limit 1e-5 * {scale:.3e})")
        worst = max(worst, err / scale if scale else 0.0)
        if name in nonzero:
            named[name] = float(a.abs().max())
            if named[name] <= 0.0:
                raise AssertionError(f"fp32 {what} grad {name} is zero")
    out = {"loss_kernels": lk, "loss_plain": lp, "loss_rel_err": loss_err,
           "grad_max_rel_err": worst, "launches": counts}
    if nonzero:
        out["rel_table_grad_max_abs"] = named
    return out


def dropout_step_run(torch, ku, step, keys, timed_keys, want, tokens):
    """One policy's run of a dropout train step: the first step's launches
    (counts reset just before, read just after) equal to ``want``, the
    loss finite and falling over ``keys``, then step ms and tokens/s
    (``tokens`` a step) over all but 3 of ``timed_keys``, peak memory and
    the last 3 steps profiled."""
    ku.reset_launch_counts()
    losses = [step(keys[0])]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    if launches != want:
        raise AssertionError(f"dropout step launches {launches}, expected "
                             f"{want}")
    losses += [step(k) for k in keys[1:]]
    vals = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"dropout train loss did not fall: {vals}")
    it = iter(timed_keys)
    durs = timed_steps_of(torch, lambda: step(next(it)), len(timed_keys) - 3)
    prof = profiled(torch, lambda: [step(next(it)) for _ in range(3)])
    return {"launches_per_step": launches, "losses": vals,
            "losses_t": torch.stack(losses),
            "tokens_per_s": tokens * len(durs) / sum(durs),
            "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
            "step_ms": [d * 1e3 for d in durs],
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "top": prof["top"][:6]}


def train_dropout_phase(torch, dev, ku, steps: int = 10):
    """GPT-2-124M bf16 at 8 x 1024 with GPT-2's dropout (attention and
    hidden 0.1) under each remat policy, the key of step i
    ``fold_in(prng_key(0), i)`` (the caller's stream): launches a step equal
    to ``dropout_train_launches``; the first step's loss and every gradient
    bitwise equal across the three policies; the loss falls over 10 steps
    and (``dots_attn``, the main path) repeats bitwise from a second build;
    the step without a key equals the rates-0 config's bitwise. An fp32
    check at 2 layers: kernels vs plain within the train phase's gate.
    Step ms p50, busy ms, tokens/s and peak memory for each policy."""
    import numpy as np

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.tensor_parallel import fold_in, prng_key
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step,
                                                    gpt_loss,
                                                    init_gpt_params)

    rates = dict(attention_dropout=DROPOUT_RATE, hidden_dropout=DROPOUT_RATE)
    base = prng_key(0)
    key = fold_in(base, 0)
    cfg32 = GPTConfig(dtype=torch.float32, num_layers=2,
                      remat_policy="dots_attn", **rates)
    params = init_gpt_params(cfg32, seed=0, device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg32.vocab_size,
                                        (2, 1024))).to(dev)
    tgt = torch.roll(tok, -1, dims=1)
    result = {"fp32_check": {"layers": 2, "batch": 2, "seq": 1024, **fp32_gate(
        torch, ku, "train_dropout", leaves,
        lambda: gpt_loss(params, tok, tgt, cfg32, dropout_key=key),
        {"hidden_dropout": 5 + 2 + 5, "flash_attention_fwd": 2})}}
    del params, leaves
    torch.cuda.empty_cache()
    batch, seq = 8, 1024
    keys = [fold_in(base, i) for i in range(steps)]
    timed = [fold_in(base, steps + i) for i in range(13)]
    firsts, runs = {}, {}
    for policy in DROPOUT_POLICIES:
        cfg = GPTConfig(remat_policy=policy, **rates)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, params, _, _, _ = build_train_step(cfg, batch, seq, device=dev,
                                                 seed=0)
        first_grads = []

        def first_step(k, step=step, params=params, out=first_grads):
            loss = step(k)
            if not out:
                out.extend(p.grad.clone() for _, p in named_leaves(params))
            return loss

        run = dropout_step_run(torch, ku, first_step, keys, timed,
                               dropout_train_launches(policy), batch * seq)
        firsts[policy] = (run["losses_t"][0], first_grads)
        runs[policy] = run
        del step, params, first_step
    loss0, grads0 = firsts["full"]
    for policy in ("dots", "dots_attn"):
        loss, grads = firsts[policy]
        if not torch.equal(loss, loss0) or not all(
                torch.equal(a, b) for a, b in zip(grads, grads0)):
            raise AssertionError(f"{policy}: first step's loss or gradients "
                                 f"not bitwise full remat's")
    del firsts, grads0
    torch.cuda.empty_cache()
    cfg = GPTConfig(remat_policy="dots_attn", **rates)
    step = build_train_step(cfg, batch, seq, device=dev, seed=0)[0]
    again = torch.stack([step(k) for k in keys])
    if not torch.equal(again, runs["dots_attn"]["losses_t"]):
        raise AssertionError(f"dots_attn dropout losses differ between two "
                             f"runs: {again.tolist()}")
    step = build_train_step(cfg, batch, seq, device=dev, seed=0)[0]
    eval_loss = step()
    step = build_train_step(GPTConfig(remat_policy="dots_attn"), batch, seq,
                            device=dev, seed=0)[0]
    rates0_loss = step()
    if not torch.equal(eval_loss, rates0_loss):
        raise AssertionError(f"the step without a key ({eval_loss.item()}) "
                             f"is not the rates-0 step ({rates0_loss.item()})")
    del step
    torch.cuda.empty_cache()
    for run in runs.values():
        del run["losses_t"]
    result.update({"batch": batch, "seq": seq, "rate": DROPOUT_RATE,
                   "policies": runs, "bitwise_across_policies": True,
                   "bitwise_repeat": True,
                   "no_key_equals_rates_0": eval_loss.item()})
    return result


def t5_dropout_phase(torch, dev, ku, steps: int = 5):
    """T5-small (the T5 phase's config) bf16 at 8 x (512 + 128) with both
    rates 0.1, the key of step i ``fold_in(prng_key(1), i)``: the first
    step's launches equal T5_DROPOUT_LAUNCHES; the loss finite and
    repeating bitwise from a second build; an fp32 check at 2 + 2 layers,
    kernels vs plain within the train phase's gate. Step ms p50, busy ms,
    tokens/s, peak memory."""
    import dataclasses

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.tensor_parallel import fold_in, prng_key
    from apex_tpu_torch.transformer.testing import (build_t5_train_step,
                                                    t5_loss)

    rates = dict(attention_dropout=DROPOUT_RATE, hidden_dropout=DROPOUT_RATE)
    base = prng_key(1)
    cfg32 = dataclasses.replace(t5_config(torch.float32), enc_layers=2,
                                dec_layers=2, **rates)
    _, params, _, (enc, dec, tgt) = build_t5_train_step(
        cfg32, 2, T5_ENC, T5_DEC, device=dev, seed=0)
    key = fold_in(base, 0)
    result = {"fp32_check": {"layers": "2 + 2", "batch": 2, **fp32_gate(
        torch, ku, "t5_dropout", list(named_leaves(params)),
        lambda: t5_loss(params, enc, dec, tgt, cfg32, dropout_key=key),
        # 12 sites (2 embeddings, 2 + 2 encoder, 3 + 3 decoder) forward and
        # backward, 2 + 4 in the recompute
        {"hidden_dropout": 12 + 6 + 12, "flash_attention_bwd_dbias": 4})}}
    del params
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(t5_config(torch.bfloat16), **rates)
    keys = [fold_in(base, i) for i in range(steps)]
    timed = [fold_in(base, steps + i) for i in range(13)]
    torch.cuda.reset_peak_memory_stats()
    step = build_t5_train_step(cfg, T5_BATCH, T5_ENC, T5_DEC, device=dev,
                               seed=0)[0]
    run = dropout_step_run(torch, ku, step, keys, timed, T5_DROPOUT_LAUNCHES,
                           T5_BATCH * (T5_ENC + T5_DEC))
    del step
    torch.cuda.empty_cache()
    step = build_t5_train_step(cfg, T5_BATCH, T5_ENC, T5_DEC, device=dev,
                               seed=0)[0]
    again = torch.stack([step(k) for k in keys])
    if not torch.equal(again, run.pop("losses_t")):
        raise AssertionError(f"T5 dropout losses differ between two runs: "
                             f"{again.tolist()}")
    del step
    torch.cuda.empty_cache()
    result.update({"batch": T5_BATCH, "seq_enc": T5_ENC, "seq_dec": T5_DEC,
                   "rate": DROPOUT_RATE, "bitwise_repeat": True, **run})
    return result


def functional_phase(torch, dev):
    """The Megatron functional ops at realistic sizes, each module's forward
    and backward on the card held to the same module on the CPU in fp32
    (TF32 off): the output and every gradient within ``tol`` of the CPU
    tensor in norm, |card - CPU| / |CPU| (fp32 sums in other orders; for
    the MLP, ReLU's gradient steps where a pre-activation lies within a
    rounding of 0, and the two sum orders put some on either side: fp32
    against fp64 on the CPU differ by 1.0e-3 in dx and the first kernel's
    gradient); then its device ms a forward + backward in bf16 (fp32
    too): ``FusedScaleMaskSoftmax``
    at (8, 12, 1024, 1024) causal and padding (the fused path, bf16
    input), ``softmax_cross_entropy_loss`` at (8192, 50304), smoothing
    0.1, ``MLP([1024, 4096, 4096, 1024])`` on 4096 rows and
    ``FusedDenseGeluDense(768 -> 3072 -> 768)`` on 8192 rows."""
    import numpy as np

    from apex_tpu_torch.convert import module_from_numpy
    from apex_tpu_torch.fused_dense import FusedDenseGeluDense
    from apex_tpu_torch.mlp import MLP
    from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss
    from apex_tpu_torch.transformer.enums import AttnMaskType
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax

    rng = np.random.default_rng(11)
    torch.manual_seed(11)      # the modules' initial weights
    cpu = torch.device("cpu")

    def softmax_case(mask_type):
        shape = (8, 12, 1024, 1024)
        x = rng.standard_normal(shape, dtype=np.float32) * 3
        dy = rng.standard_normal(shape, dtype=np.float32)
        mask = np.zeros((8, 1, 1024, 1024), bool)
        mask[:, :, :, 896:] = True

        def make(device, dtype):
            mod = FusedScaleMaskSoftmax(
                input_in_bf16=dtype == torch.bfloat16,
                attn_mask_type=getattr(AttnMaskType, mask_type),
                scale=0.125)
            # the fused path for bf16 input; fp32 takes the torch path, so
            # the fp32 check runs the fused functions themselves
            if dtype == torch.float32:
                mod.is_kernel_available = lambda *a: True
            xt = torch.from_numpy(x).to(device, dtype).requires_grad_()
            m = (None if mask_type == "causal"
                 else torch.from_numpy(mask).to(device))
            return (lambda: mod(xt, m)), [("x", xt)], \
                torch.from_numpy(dy).to(device, dtype)
        return make, 1e-5

    def xent_case():
        logits = rng.standard_normal((8192, 50304), dtype=np.float32) * 4
        labels = rng.integers(0, 50304, 8192)
        dloss = rng.standard_normal(8192, dtype=np.float32)

        def make(device, dtype):
            xt = torch.from_numpy(logits).to(device, dtype).requires_grad_()
            lt = torch.from_numpy(labels).to(device)
            return (lambda: softmax_cross_entropy_loss(
                xt, lt, 0.1, half_to_float=True)), [("logits", xt)], \
                torch.from_numpy(dloss).to(device)
        return make, 1e-5

    def module_case(build, rows, width, out_width):
        ref = build(torch.float32, cpu)
        params = {n: p.detach().numpy().copy()
                  for n, p in ref.named_parameters()}
        x = rng.standard_normal((rows, width), dtype=np.float32)

        def make(device, dtype):
            mod = build(dtype, device)
            module_from_numpy(params, mod)
            xt = torch.from_numpy(x).to(device, dtype).requires_grad_()
            dy = torch.from_numpy(np.random.default_rng(12).standard_normal(
                (rows, out_width), dtype=np.float32)).to(device, dtype)
            return (lambda: mod(xt)), [("x", xt), *mod.named_parameters()], \
                dy
        return make

    cases = {
        "FusedScaleMaskSoftmax causal (8, 12, 1024, 1024)":
            softmax_case("causal"),
        "FusedScaleMaskSoftmax padding (8, 12, 1024, 1024)":
            softmax_case("padding"),
        "softmax_cross_entropy_loss (8192, 50304) smoothing 0.1":
            xent_case(),
        "MLP([1024, 4096, 4096, 1024]) x 4096 rows": (module_case(
            lambda dt, d: MLP([1024, 4096, 4096, 1024], dtype=dt, device=d),
            4096, 1024, 1024), 5e-3),
        "FusedDenseGeluDense(768 -> 3072 -> 768) x 8192 rows": (module_case(
            lambda dt, d: FusedDenseGeluDense(768, 3072, 768, dtype=dt,
                                              device=d), 8192, 768, 768),
            1e-4),
    }
    out = []
    for name, (make, tol) in cases.items():
        results = {}
        for side, device in (("cpu", cpu), ("card", dev)):
            fn, leaves, dy = make(device, torch.float32)
            y = fn()
            y.backward(dy)
            results[side] = [("out", y.detach())] + [
                (n, t.grad) for n, t in leaves]
            del fn, leaves, dy, y
        norm_err, max_err = {}, {}
        for (n, want), (_, got) in zip(results["cpu"], results["card"]):
            diff = got.cpu() - want
            norm_err[n] = float(diff.norm() / want.norm())
            max_err[n] = float(diff.abs().max() / want.abs().max())
            if not bool(got.isfinite().all()) or norm_err[n] > tol:
                raise AssertionError(f"{name} {n}: card vs CPU |diff| / |CPU|"
                                     f" = {norm_err[n]:.3e} (limit {tol})")
        del results
        rec = {"case": name, "norm_tol": tol, "norm_err": norm_err,
               "max_err_of_max": max_err}
        for dtype in (torch.bfloat16, torch.float32):
            fn, leaves, dy = make(dev, dtype)
            rec[f"fwd_bwd_ms_{str(dtype).split('.')[-1]}"] = time_ms(
                torch, lambda: fn().backward(dy), iters=10)
            del fn, leaves, dy
            torch.cuda.empty_cache()
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# amp phase: mixed precision on the training main path

AMP_PATH = "amp O2, GPT-2-124M bf16, 8 x 1024, FusedAdam(lr=1e-4)"
AMP_BATCH, AMP_SEQ = 8, 1024       # the O2 main path's tokens a step
AMP_CHECK_ROWS = (1, 64)           # batch, seq of the 2-layer card checks
AMP_STATE_RTOL = 1e-4              # each state tensor, in norm
AMP_MASTER_RTOL = 1e-5             # each master leaf (or the model), in norm
# optimizers whose steps divide each element's gradient by its own running
# magnitude (u = g/|g| at step 1), by the state entry holding it. The train
# phases' fp32 gate holds a gradient to 1e-5 of its leaf's largest, so an
# element AMP_NOISE below that largest may carry a relative error of 1e-2
# and, where its exact gradient is zero (the key bias: softmax is shift-
# invariant), its step's sign is summation noise on either side. For
# these optimizers each leaf's update (master - initial) over its other
# elements is held to AMP_UPDATE_RTOL in norm, and the noise elements
# within 2·steps·lr·1.05 (a step of opposite sign each time, |u| <= 1.05
# in the first steps)
AMP_ELEMENTWISE = {"FusedAdam": "exp_avg_sq", "FusedLAMB": "exp_avg_sq",
                   "FusedAdagrad": "sum"}
AMP_NOISE = 1e-3
AMP_UPDATE_RTOL = 1e-2


def amp_optimizers():
    """The optimizers of the fp32 card check, by name."""
    from apex_tpu_torch.optimizers import (LARC, FusedAdagrad, FusedAdam,
                                           FusedLAMB, FusedNovoGrad,
                                           FusedSGD)

    return {
        "FusedAdam": lambda ps: FusedAdam(ps, lr=1e-4),
        "FusedLAMB": lambda ps: FusedLAMB(ps, lr=1e-3),
        "FusedSGD": lambda ps: FusedSGD(ps, lr=1e-2, momentum=0.9,
                                        nesterov=True),
        "FusedAdagrad": lambda ps: FusedAdagrad(ps, lr=1e-4),
        "FusedNovoGrad": lambda ps: FusedNovoGrad(ps, lr=1e-3),
        "LARC(SGD)": lambda ps: LARC(FusedSGD(ps, lr=1e-2, momentum=0.9),
                                     lr=1e-2),
    }


def kept_bitwise(torch, before, after):
    """Two snapshots (masters, optimizer state tensors, count) equal."""
    return (all(torch.equal(a, b) for a, b in zip(before[0], after[0]))
            and all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
            and torch.equal(torch.as_tensor(before[2]),
                            torch.as_tensor(after[2])))


def opt_snapshot(torch, masters, opt):
    """Copies of the masters, every optimizer state tensor and the step
    count."""
    state = [v.clone() for p in masters for v in opt.state[p].values()
             if torch.is_tensor(v)]
    count = opt.param_groups[0]["step"]
    return ([p.detach().clone() for p in masters], state,
            count.clone() if torch.is_tensor(count) else count)


class AmpRun:
    """A GPT train step composed from amp's public pieces, as a user
    writes it: ``initialize``, the model copy written in place each step
    (``model_params(out=)``), the scaled loss's gradients, and
    ``apply_grads_with_optimizer`` (unscale, overflow check, scale update
    and the optimizer's guarded step, all on the device). ``autocast``
    runs the loss under O1's per-op casts."""

    def __init__(self, torch, cfg, params_np, tok, tgt, dev, level="O2",
                 half_dtype=None, make_opt=None, autocast=False):
        from apex_tpu_torch import amp
        from apex_tpu_torch.convert import params_from_numpy
        from apex_tpu_torch.optimizers import FusedAdam
        from apex_tpu_torch.optimizers._common import tree_leaves, tree_map

        self.torch, self.amp, self.cfg = torch, amp, cfg
        self.tok, self.tgt = tok.to(dev), tgt.to(dev)
        # cloned: a CPU tensor from numpy shares the array's memory
        params = tree_map(lambda t: t.clone(),
                          params_from_numpy(params_np, dev, dtype=cfg.dtype))
        self.state, _ = amp.initialize(
            params, level, half_dtype=half_dtype or torch.bfloat16)
        del params
        self.model = amp.model_params(self.state)
        self.leaves = amp.trainable_leaves(self.model)
        self.masters = tree_leaves(self.state.master_params)
        self.opt = (make_opt or (lambda ps: FusedAdam(ps, lr=1e-4)))(
            self.masters)
        self.autocast = autocast
        self.skipped = None

    def loss(self):
        from apex_tpu_torch.transformer.testing import gpt_loss

        fn = lambda: gpt_loss(self.model, self.tok, self.tgt, self.cfg)
        return self.amp.autocast(fn)() if self.autocast else fn()

    def step(self):
        amp = self.amp
        amp.model_params(self.state, out=self.model)
        loss = self.loss()
        grads = self.torch.autograd.grad(amp.scale_loss(loss, self.state),
                                         self.leaves)
        self.state, _, self.skipped = amp.apply_grads_with_optimizer(
            self.state, grads, self.opt)
        return loss.detach()

    def snapshot(self):
        return opt_snapshot(self.torch, self.masters, self.opt)


def count_syncs(torch, fn, messages=None) -> int:
    """Synchronizing CUDA calls ``fn`` makes (``set_sync_debug_mode``
    warnings, every one recorded; their texts appended to ``messages``
    when given). The mode's own notice, which a process's first use
    prints once ("... is a prototype feature ..."), is no call."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught
             if "synchroniz" in str(w.message)
             and "prototype feature" not in str(w.message)]
    if messages is not None:
        messages.extend(m[:300] for m in syncs)
    return len(syncs)


def _gpt_batch(torch, vocab, batch, seq, seed=0):
    """``build_train_step``'s tokens: numpy seed + 1, targets rolled by
    one."""
    import numpy as np

    tok = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, vocab, (batch, seq)).astype(np.int64))
    return tok, torch.roll(tok, -1, dims=1)


def amp_main_path(torch, dev, ku, steps: int = 10):
    """O2 GPT-2-124M (bf16 model, fp32 masters, LN params fp32, dynamic
    scale 2**16) at 8 x 1024 with FusedAdam over the masters: the main
    path's launches over ``steps`` steps (counts reset just before, read
    just after) equal ``steps`` x the train table; a falling, finite and
    bitwise repeatable loss; no more synchronizing calls a step than the
    plain bf16 step, which is timed beside it; the model copy and the
    unscale timed alone; then an overflow step (scale 2**127: the scaled
    loss is inf in fp32; one gradient leaf made inf, as the gradients
    need not overflow) that keeps masters, m, v and the count bitwise and
    halves the scale, and a step after restoring 2**16 that trains."""
    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.optimizers._common import tree_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy)

    cfg = GPTConfig()
    batch, seq = AMP_BATCH, AMP_SEQ
    plain = build_train_step(cfg, batch, seq, device=dev, seed=0)[0]
    plain(), plain()
    plain_syncs = count_syncs(torch, plain)
    plain_durs = timed_steps_of(torch, plain, steps)
    plain_prof = profiled(torch, lambda: [plain() for _ in range(3)])
    del plain
    torch.cuda.empty_cache()
    params_np = init_gpt_params_numpy(cfg, 0)
    tok, tgt = _gpt_batch(torch, cfg.vocab_size, batch, seq)
    torch.cuda.reset_peak_memory_stats()
    run = AmpRun(torch, cfg, params_np, tok, tgt, dev)
    ku.reset_launch_counts()
    losses = torch.stack([run.step() for _ in range(steps)])
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    want = {k: steps * v for k, v in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"amp O2 launches over {steps} steps "
                             f"{launches}, expected {want}")
    vals = losses.tolist()
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"amp O2 loss did not fall: {vals}")
    scaler = run.amp.state_dict(run.state)["loss_scaler0"]
    if scaler != {"loss_scale": 2.0 ** 16, "unskipped": steps,
                  "hysteresis_left": 1}:
        raise AssertionError(f"amp O2 scaler after {steps} clean steps: "
                             f"{scaler}")
    amp_syncs = count_syncs(torch, run.step)
    if amp_syncs > plain_syncs:
        raise AssertionError(f"amp step makes {amp_syncs} synchronizing "
                             f"calls, the plain step {plain_syncs}")
    durs = timed_steps_of(torch, run.step, steps)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profiled(torch, lambda: [run.step() for _ in range(3)])
    copy_ms = time_ms(torch, lambda: run.amp.model_params(
        run.state, out=run.model), iters=10)
    grads = list(torch.autograd.grad(
        run.amp.scale_loss(run.loss(), run.state), run.leaves))
    unscale_ms = time_ms(torch, lambda: LossScaler("dynamic").unscale(
        grads, run.state.scaler), iters=10)
    del grads
    # the overflow step: at 2**127 the scaled loss is inf in fp32, but its
    # gradients (2**127 times the loss's) need not overflow, so one leaf's
    # gradient is made inf as well
    before = run.snapshot()
    run.state = run.state._replace(scaler=run.state.scaler._replace(
        loss_scale=torch.full((), 2.0 ** 127, device=dev)))
    run.amp.model_params(run.state, out=run.model)
    scaled = run.amp.scale_loss(run.loss(), run.state)
    grads = list(torch.autograd.grad(scaled, run.leaves))
    natural = not all(bool(torch.isfinite(g).all()) for g in grads)
    grads[0] = grads[0] * float("inf")
    run.state, _, run.skipped = run.amp.apply_grads_with_optimizer(
        run.state, grads, run.opt)
    loss_inf = float(scaled.detach())
    del grads
    after = run.snapshot()
    same = kept_bitwise(torch, before, after)
    scale_after = float(run.state.scaler.loss_scale)
    if not same or not bool(run.skipped) or scale_after != 2.0 ** 126:
        raise AssertionError(f"amp overflow step: state kept bitwise {same}, "
                             f"skipped {bool(run.skipped)}, scale "
                             f"{scale_after}")
    run.state = run.amp.load_state_dict(run.state, {"loss_scaler0": {
        "loss_scale": 2.0 ** 16, "unskipped": 0, "hysteresis_left": 1}})
    loss_next = float(run.step())
    trained = run.snapshot()
    moved = any(not torch.equal(a, b) for a, b in zip(after[0], trained[0]))
    if bool(run.skipped) or not moved or int(trained[2]) != int(after[2]) + 1:
        raise AssertionError("amp: the step after the overflow did not train")
    n_params = sum(p.numel() for p in tree_leaves(run.state.master_params))
    del run, before, after, trained
    torch.cuda.empty_cache()
    again_run = AmpRun(torch, cfg, params_np, tok, tgt, dev)
    again = torch.stack([again_run.step() for _ in range(steps)])
    if not torch.equal(losses, again):
        raise AssertionError(f"amp O2 losses differ between two runs from "
                             f"one seed: {vals} vs {again.tolist()}")
    del again_run
    torch.cuda.empty_cache()
    p50 = lambda d: sorted(d)[len(d) // 2] * 1e3
    return {"path": AMP_PATH, "steps": steps, "losses": vals,
            "bitwise_repeat": True, "launches": launches,
            "launches_per_step": {k: v // steps for k, v in launches.items()},
            "syncs_per_step": amp_syncs, "plain_syncs_per_step": plain_syncs,
            "step_ms_p50": p50(durs), "step_ms": [d * 1e3 for d in durs],
            "tokens_per_s": batch * seq * steps / sum(durs),
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "peak_mem_gib": peak_gib, "top": prof["top"],
            "plain_step_ms_p50": p50(plain_durs),
            "plain_tokens_per_s": batch * seq * steps / sum(plain_durs),
            "plain_device_busy_ms_per_step":
                plain_prof["device_busy_ms"] / 3,
            "model_copy_ms": copy_ms,
            "model_copy_bytes": n_params * (4 + 2),
            "unscale_ms": unscale_ms, "n_params": n_params,
            "overflow": {"scale_in": 2.0 ** 127, "scale_out": scale_after,
                         "scaled_loss": loss_inf,
                         "grads_overflowed_at_2_127": natural,
                         "state_kept_bitwise": True,
                         "next_loss": loss_next, "next_trained": True}}


def _tree_rel(torch, a, b):
    """‖a − b‖ / ‖b‖ over fp32 copies (b on a's device)."""
    a, b = a.detach().float(), b.detach().float().to(a.device)
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def amp_fp32_check(torch, dev, ku, steps: int = 2):
    """At GPT-2's widths and 2 layers, fp32: O0 and O2 (fp32 masters, an
    fp32 model: ``half_dtype=float32``) with each optimizer, ``steps``
    steps on the card (kernels) and on the CPU (plain versions) from the
    same params: the loss within rel 1e-5 each step, every master leaf
    within AMP_MASTER_RTOL of the CPU's in norm (for the AMP_ELEMENTWISE
    optimizers its update within AMP_UPDATE_RTOL, its noise elements
    within the flip bound), every optimizer state tensor within
    AMP_STATE_RTOL, the step count and the scaler state equal."""
    import dataclasses

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy)

    cfg = dataclasses.replace(GPTConfig(dtype=torch.float32), num_layers=2)
    params_np = init_gpt_params_numpy(cfg, 0)
    tok, tgt = _gpt_batch(torch, cfg.vocab_size, *AMP_CHECK_ROWS)
    cpu = torch.device("cpu")
    out, failed = {}, []
    for level in ("O0", "O2"):
        for name, make in amp_optimizers().items():
            card, host = (AmpRun(torch, cfg, params_np, tok, tgt, d, level,
                                 half_dtype=torch.float32, make_opt=make)
                          for d in (dev, cpu))
            worst = {"loss": 0.0, "master": 0.0, "update": 0.0,
                     "state": 0.0, "master_worst_leaf": "",
                     "noise_elements": 0, "noise_max_abs_diff": 0.0}
            initial = [b.detach().clone() for b in host.masters]
            for _ in range(steps):
                lk, lp = float(card.step()), float(host.step())
                worst["loss"] = max(worst["loss"], abs(lk - lp) / abs(lp))
            lr = host.opt.param_groups[0]["lr"]
            flip = 2.0 * steps * lr * 1.05
            names = [k for k, _ in named_leaves(host.state.master_params)]
            for leaf, a, b, b0 in zip(names, card.masters, host.masters,
                                      initial):
                diff = a.detach().cpu() - b.detach()
                for key, v in card.opt.state[a].items():
                    if torch.is_tensor(v):
                        worst["state"] = max(worst["state"], _tree_rel(
                            torch, v, host.opt.state[b][key]))
                if name in AMP_ELEMENTWISE:
                    mag = host.opt.state[b][AMP_ELEMENTWISE[name]].sqrt()
                    keep = mag > AMP_NOISE * mag.max()
                    noisy = diff[~keep].abs()
                    worst["noise_elements"] += int(noisy.numel())
                    if noisy.numel():
                        worst["noise_max_abs_diff"] = max(
                            worst["noise_max_abs_diff"], float(noisy.max()))
                    upd = (b.detach() - b0)[keep]
                    rel = float(diff[keep].norm() / upd.norm().clamp_min(
                        1e-30)) if upd.numel() else 0.0
                    if rel > worst["update"]:
                        worst["update"], worst["master_worst_leaf"] = \
                            rel, leaf
                    continue
                rel = float(diff.norm() / b.detach().norm().clamp_min(1e-30))
                if rel > worst["master"]:
                    worst["master"], worst["master_worst_leaf"] = rel, leaf
            master = worst["master"]
            if (worst["noise_max_abs_diff"] > flip
                    or worst["update"] > AMP_UPDATE_RTOL):
                master = float("inf")
            counts = [int(r.opt.param_groups[0]["step"])
                      for r in (card, host)]
            scalers = [r.amp.state_dict(r.state) for r in (card, host)]
            if (worst["loss"] > 1e-5 or master > AMP_MASTER_RTOL
                    or worst["state"] > AMP_STATE_RTOL
                    or counts != [steps, steps] or scalers[0] != scalers[1]):
                failed.append(f"{level} {name}: card vs CPU {worst}, counts "
                              f"{counts}, scalers {scalers}")
            out[f"{level} {name}"] = worst
            del card, host
    if failed:
        raise AssertionError("amp fp32 check: " + "; ".join(failed))
    return {"rows": AMP_CHECK_ROWS, "layers": 2, "steps": steps,
            "loss_rtol": 1e-5, "master_rtol_norm": AMP_MASTER_RTOL,
            "state_rtol_norm": AMP_STATE_RTOL, "cases": out}


def amp_o1_check(torch, dev, ku):
    """O1 at GPT-2's widths and 2 layers: fp32 params, the loss under
    ``autocast`` (bf16 products), one forward + backward on the card
    (kernels; counts reset just before, read just after) and on the CPU
    (plain versions): the loss within BF16_LOSS_RTOL, every gradient leaf
    within BF16_GRAD_NORM_RTOL of the CPU's in norm. The bias adds promote
    each product back to fp32, so flash, LayerNorm and the LM head get
    fp32 inputs, as JAX traces its custom-VJP regions: their fp32 routes
    (``flash_attention_*``, ``lm_head_loss_*``) launch, no ``*_mma_*``."""
    import dataclasses

    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy)

    cfg = dataclasses.replace(GPTConfig(dtype=torch.float32), num_layers=2)
    params_np = init_gpt_params_numpy(cfg, 0)
    tok, tgt = _gpt_batch(torch, cfg.vocab_size, *AMP_CHECK_ROWS)
    res = []
    for d in (dev, torch.device("cpu")):
        run = AmpRun(torch, cfg, params_np, tok, tgt, d, "O1",
                     autocast=True)
        ku.reset_launch_counts()
        loss = run.loss()
        loss.backward()
        torch.cuda.synchronize()
        res.append((float(loss.detach()), [p.grad.detach().float().cpu()
                                  for p in run.leaves],
                    ku.launch_counts(), loss.dtype))
    (lk, gk, launches, dtype), (lp, gp, _, _) = res
    loss_err = abs(lk - lp) / abs(lp)
    worst = max(float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(gk, gp))
    mma = [k for k in launches if "_mma_" in k]
    if (loss_err > BF16_LOSS_RTOL or worst > BF16_GRAD_NORM_RTOL
            or dtype != torch.float32 or mma
            or not launches.get("flash_attention_fwd")
            or not launches.get("lm_head_loss_fwd")):
        raise AssertionError(f"amp O1 card vs CPU: loss rel {loss_err:.3e}, "
                             f"grads {worst:.3e}, launches {launches}")
    return {"rows": AMP_CHECK_ROWS, "layers": 2, "loss_card": lk,
            "loss_cpu": lp, "loss_rel_err": loss_err,
            "grad_max_norm_rel_err": worst, "launches": launches,
            "flash_dtype": "float32"}


FP8_SIZES = (1024, 4096, 4096, 1024)   # mlp.MLP([1024, 4096, 4096, 1024])
# the routes' agreement, of the output's largest magnitude: Hopper's fp8
# MMA keeps about 14 bits of its running sum (DeepSeek-V3, 2024, §3.3.2)
# between cuBLAS's promotions to fp32; the upcast route sums in fp32
FP8_ROUTE_TOL = 1e-3
FP8_ROWS = 4096


def amp_fp8_check(torch, dev, steps: int = 10):
    """``mlp.MLP(FP8_SIZES)``'s products through ``fp8_dot`` (e4m3
    forward, e5m2 gradient, history 4), ReLU between, mean-square loss,
    SGD 0.1, ``steps`` steps on the card. Each step, every cast of the
    step's tensors (x, w and the incoming gradient of each product) gives
    the same codes on the card and on the CPU from the same values, and
    the delayed-scaling state after the step equals the CPU's update from
    the same amaxes, bitwise. The product's two routes (``_scaled_mm`` on
    the fp8 tensor cores and the fp32 product of the upcast codes) are
    held to each other at each layer's forward and backward shapes on the
    last step's codes, a nonzero product (the
    same codes, sums in other orders and precisions: the max abs
    difference within FP8_ROUTE_TOL of the output's largest magnitude) and
    timed."""
    import numpy as np

    from apex_tpu_torch.amp import fp8
    from apex_tpu_torch.mlp import MLP

    rec = fp8.Fp8Recipe(history_len=4)
    torch.manual_seed(0)
    mlp = MLP(list(FP8_SIZES))
    n = len(FP8_SIZES) - 1
    params = {k: v.detach().to(dev) for k, v in mlp.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (FP8_ROWS, FP8_SIZES[0])).astype(np.float32)).to(dev)
    st = fp8.init_fp8_state([str(i) for i in range(n)], rec, device=dev)
    cpu = lambda t: t.detach().cpu()

    def codes_equal(t, scale, dtype):
        a = fp8.cast_fp8(t, scale, dtype).view(torch.uint8).cpu()
        b = fp8.cast_fp8(cpu(t), cpu(scale), dtype).view(torch.uint8)
        return bool(torch.equal(a, b))

    def state_cpu(old, t, dtype):
        amax, over = fp8._observe(cpu(t), cpu(old.scale), dtype)
        return fp8.update_tensor_state(fp8.Fp8TensorState(
            *(cpu(v) for v in old)), amax, over, dtype, rec)

    def same_state(a, b):
        return all(bool(torch.equal(cpu(u), v)) for u, v in zip(a, b))

    losses, routes = [], {}
    for step in range(steps):
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        h, ins, outs, fwd = x, [], [], {}
        for i in range(n):
            ins.append(h.detach())
            y, fwd[str(i)] = fp8.fp8_dot(h, leaves[f"kernel_{i}"],
                                         st[str(i)], rec)
            y.retain_grad()
            outs.append(y)
            h = y + leaves[f"bias_{i}"]
            if i < n - 1:
                h = torch.relu(h)
        loss = torch.mean(h ** 2)
        loss.backward()
        new = fp8.merge_state_grads(fwd)
        for i in range(n):
            old, w, dy = st[str(i)], leaves[f"kernel_{i}"], outs[i].grad
            for t, scale, dt in ((ins[i], old.x.scale, rec.fwd_dtype),
                                 (w, old.w.scale, rec.fwd_dtype),
                                 (dy, old.g.scale, rec.grad_dtype)):
                if not codes_equal(t, scale, dt):
                    raise AssertionError(f"fp8 step {step} product {i}: "
                                         f"card codes differ from the CPU's")
            for half, t, dt in (("x", ins[i], rec.fwd_dtype),
                                ("w", w, rec.fwd_dtype),
                                ("g", dy, rec.grad_dtype)):
                if not same_state(getattr(new[str(i)], half),
                                  state_cpu(getattr(old, half), t, dt)):
                    raise AssertionError(f"fp8 step {step} product {i}: "
                                         f"state {half} differs from the "
                                         f"CPU's update")
            if step == steps - 1:
                # the last step: at step 0 the gradient's delayed scale
                # is still 1 and its e5m2 codes underflow to 0
                qx = fp8.cast_fp8(ins[i], old.x.scale, rec.fwd_dtype)
                qw = fp8.cast_fp8(w, old.w.scale, rec.fwd_dtype)
                qdy = fp8.cast_fp8(dy, old.g.scale, rec.grad_dtype)
                for what, a, b in (("fwd", qx, qw), ("dx", qdy, qw.t()),
                                   ("dw", qx.t(), qdy)):
                    tc = fp8.fp8_matmul(a, b, "scaled_mm")
                    up = fp8.fp8_matmul(a, b, "upcast")
                    err = float((tc - up).abs().max().detach())
                    scale = float(up.abs().max().detach())
                    if not scale > 0.0 or err > FP8_ROUTE_TOL * scale:
                        raise AssertionError(f"fp8 product {i} {what}: "
                                             f"routes differ by {err:.3e}")
                    routes[f"{i} {what}"] = {
                        "shape": [a.shape[0], a.shape[1], b.shape[1]],
                        "types": [str(a.dtype), str(b.dtype)],
                        "route": fp8.fp8_route(a, b),
                        "max_abs_err": err, "rel_err": err / scale,
                        "scaled_mm_ms": time_ms(torch, lambda: fp8.fp8_matmul(
                            a, b, "scaled_mm"), iters=10),
                        "upcast_ms": time_ms(torch, lambda: fp8.fp8_matmul(
                            a, b, "upcast"), iters=10)}
        with torch.no_grad():
            params = {k: v - 0.1 * v.grad for k, v in leaves.items()}
        st = new
        losses.append(float(loss.detach()))
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"fp8 MLP loss did not fall: {losses}")
    return {"sizes": list(FP8_SIZES), "rows": FP8_ROWS, "steps": steps,
            "losses": losses, "codes_bitwise_card_cpu": True,
            "state_bitwise_card_cpu": True, "routes": routes,
            "metrics": {k: float(v) for k, v in fp8.fp8_metrics(st).items()
                        if k.endswith("overflow_rate")}}


def amp_phase(torch, dev, ku):
    """The amp phase: the O2 main path, the fp32 and O1 card checks and
    the fp8 products, each's wall seconds."""
    out, secs = {}, {}
    for name, fn in (("o2", amp_main_path), ("fp32_check", amp_fp32_check),
                     ("o1_check", amp_o1_check)):
        t0 = time.perf_counter()
        out[name] = fn(torch, dev, ku)
        torch.cuda.empty_cache()
        secs[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["fp8"] = amp_fp8_check(torch, dev)
    torch.cuda.empty_cache()
    secs["fp8"] = time.perf_counter() - t0
    out["phase_s"] = secs
    return out


# ---------------------------------------------------------------------------
# fp16 on the training main path (ROADMAP C4), fp16_utils, BERT, the
# multi-head attention modules and the transducer

AMP16_PATH = ("amp O2 half_dtype=float16, GPT-2-124M, 8 x 1024, "
              "FusedAdam(lr=1e-4)")
FP16_OPT_PATH = ("FP16_Optimizer(FusedAdam(lr=1e-4), dynamic 2**16), "
                 "GPT-2-124M fp16, 8 x 1024")
PURE_FP16_PATH = "build_train_step(GPTConfig(dtype=float16), 8, 1024)"
AMP16_STEPS = 3
# the kernels whose fp16 instantiations a step's profile must show: kernel
# name stems (the profile's names hold the template arguments, __half)
HALF_KERNELS = {"flash": "flash_mma_", "layer_norm": "norm_",
                "lm_head": "lm_mma_", "adam_tail": "adam_tail_kernel"}


def half_kernel_counts(torch, fn, families=None):
    """Run ``fn`` under torch.profiler: launches of the CUDA kernels of
    ``families`` (HALF_KERNELS unless given) whose names hold ``__half``
    (their fp16 instantiations), by family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or "__half" not in e.name:
            continue
        for fam, stem in (families or HALF_KERNELS).items():
            if stem in e.name:
                out[fam] = out.get(fam, 0) + 1
    return out


def fp16_steps(torch, ku, what, step, steps, bf16_syncs, want_half):
    """``steps`` steps of ``step`` (fp16): launches (counts reset just
    before, read just after) equal ``steps`` x the train table, finite
    losses; then ``steps`` timed steps, and no more synchronizing calls in
    the next step than the bf16 O2 step makes after its own warm-up; the
    fp16 instantiations of ``want_half`` in a step's profile; step ms
    p50, tokens/s, busy ms and idle share over a profiled step, peak
    memory."""
    torch.cuda.reset_peak_memory_stats()
    ku.reset_launch_counts()
    losses = torch.stack([step() for _ in range(steps)])
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    want = {k: steps * v for k, v in TRAIN_LAUNCHES.items()}
    if launches != want:
        raise AssertionError(f"{what}: launches over {steps} steps "
                             f"{launches}, expected {want}")
    vals = losses.float().tolist()
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"{what}: loss not finite {vals}")
    durs = timed_steps_of(torch, step, steps)
    why = []
    syncs = count_syncs(torch, step, why)
    if syncs > bf16_syncs:
        raise AssertionError(f"{what}: {syncs} synchronizing calls a step, "
                             f"the bf16 O2 step {bf16_syncs}: {why}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profiled(torch, step)
    half = half_kernel_counts(torch, step)
    missing = [f for f in want_half if not half.get(f)]
    if missing:
        raise AssertionError(f"{what}: no fp16 instantiation of {missing} "
                             f"in a step's profile ({half})")
    return {"steps": steps, "losses": vals, "launches": launches,
            "launches_per_step": {k: v // steps for k, v in launches.items()},
            "syncs_per_step": syncs, "half_kernel_launches_a_step": half,
            "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
            "tokens_per_s": AMP_BATCH * AMP_SEQ * steps / sum(durs),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "peak_mem_gib": peak, "top": prof["top"][:6]}


def amp_fp16_phase(torch, dev, ku, bf16_syncs, steps: int = AMP16_STEPS):
    """fp16 on the training main path (C4): GPT-2-124M at 8 x 1024 three
    ways, ``steps`` steps each through :func:`fp16_steps`:
    * amp O2 with ``half_dtype=torch.float16`` (an fp16 model, LN params
      and the masters fp32, dynamic scale 2**16) and FusedAdam over the
      masters, as ``AmpRun`` composes it: the flash, LN and LM-head
      kernels in fp16; then a step at scale 2**127 (one gradient leaf
      made inf) keeps masters, m, v and the count bitwise and halves the
      scale;
    * ``FP16_Optimizer(FusedAdam)`` with a dynamic scaler (2**16) over
      ``convert_network(params, float16)`` (norm params fp32), the model
      refreshed from the masters in place each step: the same kernels and
      the same overflow step;
    * the pure fp16 step (``build_train_step`` at
      ``GPTConfig(dtype=float16)``: FusedAdam on the fp16 params), whose
      Adam tail takes fp16 g and p (the two above step fp32 masters)."""
    import dataclasses

    from apex_tpu_torch.convert import params_from_numpy
    from apex_tpu_torch.fp16_utils import FP16_Optimizer, convert_network
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._common import tree_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step,
                                                    gpt_loss)
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy)

    cfg = dataclasses.replace(GPTConfig(), dtype=torch.float32)
    params_np = init_gpt_params_numpy(cfg, 0)
    # on the card once: a copy from the host each step would synchronize
    tok, tgt = (t.to(dev) for t in _gpt_batch(torch, cfg.vocab_size,
                                               AMP_BATCH, AMP_SEQ))
    fwd_half = ("flash", "layer_norm", "lm_head")
    out = {}

    run = AmpRun(torch, cfg, params_np, tok, tgt, dev,
                 half_dtype=torch.float16)
    if run.model["layers"]["qkv_kernel"].dtype != torch.float16:
        raise AssertionError("amp O2 fp16: the model is not fp16")
    out["o2"] = fp16_steps(torch, ku, "amp O2 fp16", run.step, steps,
                           bf16_syncs, fwd_half)
    before = run.snapshot()
    run.state = run.state._replace(scaler=run.state.scaler._replace(
        loss_scale=torch.full((), 2.0 ** 127, device=dev)))
    run.amp.model_params(run.state, out=run.model)
    grads = list(torch.autograd.grad(
        run.amp.scale_loss(run.loss(), run.state), run.leaves))
    grads[0] = grads[0] * float("inf")
    run.state, _, skipped = run.amp.apply_grads_with_optimizer(
        run.state, grads, run.opt)
    del grads
    same = kept_bitwise(torch, before, run.snapshot())
    scale = float(run.state.scaler.loss_scale)
    if not (same and bool(skipped) and scale == 2.0 ** 126):
        raise AssertionError(f"amp O2 fp16 overflow step: kept {same}, "
                             f"skipped {bool(skipped)}, scale {scale}")
    out["o2"]["overflow"] = {"scale_in": 2.0 ** 127, "scale_out": scale,
                             "state_kept_bitwise": True}
    del run, before
    torch.cuda.empty_cache()

    model = convert_network(params_from_numpy(params_np, dev), torch.float16)
    leaves = tree_leaves(model)
    for x in leaves:
        x.requires_grad_(True)
    opt = FP16_Optimizer(FusedAdam(leaves, lr=1e-4), dynamic_loss_scale=True,
                         dynamic_loss_args={"init_scale": 2.0 ** 16})
    state = [opt.init(model)]

    def grads_of():
        loss = gpt_loss(model, tok, tgt, cfg)
        return loss, list(torch.autograd.grad(
            opt.scale_loss(loss, state[0]), leaves))

    def refresh(masters):
        with torch.no_grad():
            for dst, src in zip(leaves, tree_leaves(masters)):
                dst.copy_(src)

    def fp16_opt_step():
        loss, grads = grads_of()
        masters, state[0], _ = opt.step(grads, state[0])
        refresh(masters)
        return loss.detach()

    out["fp16_optimizer"] = fp16_steps(torch, ku, "FP16_Optimizer",
                                       fp16_opt_step, steps, bf16_syncs,
                                       fwd_half)
    masters = tree_leaves(state[0].master_params)
    before = opt_snapshot(torch, masters, opt.optimizer)
    scale_in = float(state[0].scaler.loss_scale)
    _, grads = grads_of()
    grads[0] = grads[0] * float("inf")
    _, state[0], skipped = opt.step(grads, state[0])
    del grads
    same = kept_bitwise(torch, before,
                        opt_snapshot(torch, masters, opt.optimizer))
    scale = float(state[0].scaler.loss_scale)
    if not (same and bool(skipped) and scale == scale_in / 2):
        raise AssertionError(f"FP16_Optimizer overflow step: kept {same}, "
                             f"skipped {bool(skipped)}, scale {scale_in} -> "
                             f"{scale}")
    out["fp16_optimizer"]["overflow"] = {
        "scale_in": scale_in, "scale_out": scale,
        "state_kept_bitwise": True}
    del model, leaves, opt, state, masters, before
    torch.cuda.empty_cache()

    step = build_train_step(dataclasses.replace(GPTConfig(),
                                                dtype=torch.float16),
                            AMP_BATCH, AMP_SEQ, device=dev, seed=0)[0]
    out["pure_fp16"] = fp16_steps(torch, ku, "pure fp16 step", step, steps,
                                  bf16_syncs, (*fwd_half, "adam_tail"))
    del step
    torch.cuda.empty_cache()
    return out


BERT_BATCH, BERT_SEQ = 8, 512
BERT_MLM_SHARE = 0.15              # positions predicted, BERT's 15 %
BERT_STEPS = 3
BERT_CHECK_BATCH = 2               # rows of the bf16 kernels-vs-plain gate


def bert_batch(torch, dev, cfg, batch, seq, padded, seed=0):
    """MLM inputs from numpy ``seed``: random tokens and targets, 15 % of
    positions predicted, token types 0 then 1 (two segments of half the
    row); with ``padded`` every second row ends in a padded tail (keys
    masked, no prediction there)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab_size, (batch, seq))
    tgt = rng.integers(0, cfg.vocab_size, (batch, seq))
    lm = rng.random((batch, seq)) < BERT_MLM_SHARE
    types = np.broadcast_to(np.arange(seq) >= seq // 2, (batch, seq))
    pad = None
    if padded:
        lens = np.where(np.arange(batch) % 2 == 1,
                        rng.integers(seq // 4, seq, batch), seq)
        pad = np.arange(seq)[None, :] >= lens[:, None]
        lm &= ~pad
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return (t(tok), t(tgt), t(lm.astype(np.float32)), t(types.astype(
        np.int64)), None if pad is None else t(pad))


def bert_launches(cfg, n_leaves, padded):
    """One BERT step's launches: two LNs a layer and the embedding's and
    the head's (the layers' again in the full-remat recompute), the three
    non-causal flash kernels a layer (the forward again in the recompute)
    unless a padding mask sends attention to the reference, one Adam tail
    a leaf."""
    L, again = cfg.num_layers, (2 if cfg.remat else 1)
    out = {"layer_norm_fwd": 2 * L * again + 2, "layer_norm_bwd": 2 * L + 2,
           "fused_adam_tail": n_leaves}
    if not padded:
        out.update(flash_mma_fwd=L * again, flash_mma_bwd_dq=L,
                   flash_mma_bwd_dkv=L)
    return out


def bert_phase(torch, dev, ku, steps: int = BERT_STEPS):
    """BERT MLM (``BertConfig()``: GPT-2-124M's widths, 2 token types,
    full remat) in bf16 at BERT_BATCH x BERT_SEQ with FusedAdam(lr=1e-4),
    ``steps`` steps twice: without padding (the non-causal tensor-core
    flash kernels) and with a padded tail on half the rows (a padding
    mask: reference attention, as JAX's masked call takes its XLA path).
    Each run's launches (counts reset just before, read just after) equal
    ``steps`` x :func:`bert_launches`; finite losses; step ms p50,
    tokens/s, busy ms and idle share over a profiled step, peak memory.
    Then the bf16 gate at BERT_CHECK_BATCH rows, unpadded: loss and every
    gradient leaf through the kernels vs the plain versions forced."""
    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.transformer.testing import (BertConfig,
                                                    bert_mlm_loss,
                                                    init_bert_params)
    from apex_tpu_torch.transformer.testing.train import _step_over

    cfg = BertConfig()
    out = {}
    for padded in (False, True):
        params = init_bert_params(cfg, seed=0, device=dev)
        tok, tgt, lm, types, pad = bert_batch(torch, dev, cfg, BERT_BATCH,
                                              BERT_SEQ, padded)
        step = _step_over(params, "auto", lambda key: bert_mlm_loss(
            params, tok, tgt, lm, cfg, token_types=types,
            padding_mask=pad))[0]
        n_leaves = len(list(named_leaves(params)))
        torch.cuda.reset_peak_memory_stats()
        ku.reset_launch_counts()
        losses = torch.stack([step() for _ in range(steps)])
        torch.cuda.synchronize()
        launches = ku.launch_counts()
        one = bert_launches(cfg, n_leaves, padded)
        want = {k: steps * v for k, v in one.items()}
        what = "bert padded" if padded else "bert"
        if launches != want:
            raise AssertionError(f"{what}: launches over {steps} steps "
                                 f"{launches}, expected {want}")
        vals = losses.float().tolist()
        if not all(math.isfinite(v) for v in vals):
            raise AssertionError(f"{what}: loss not finite {vals}")
        durs = timed_steps_of(torch, step, steps)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof = profiled(torch, step)
        out["padded" if padded else "unpadded"] = {
            "batch": BERT_BATCH, "seq": BERT_SEQ, "steps": steps,
            "padded_rows": 0 if pad is None else int(pad.any(1).sum()),
            "pad_tokens": 0 if pad is None else int(pad.sum()),
            "predicted": int(lm.sum()), "losses": vals,
            "launches": launches, "launches_per_step": one,
            "step_ms_p50": sorted(durs)[len(durs) // 2] * 1e3,
            "tokens_per_s": BERT_BATCH * BERT_SEQ * steps / sum(durs),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "peak_mem_gib": peak, "top": prof["top"][:6]}
        del params, step, tok, tgt, lm, types, pad
        torch.cuda.empty_cache()
    params = init_bert_params(cfg, seed=1, device=dev)
    leaves = list(named_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    tok, tgt, lm, types, _ = bert_batch(torch, dev, cfg, BERT_CHECK_BATCH,
                                        BERT_SEQ, False, seed=2)
    out["bf16_check"] = bf16_gate(torch, ku, "bert", leaves,
                                  lambda: bert_mlm_loss(
                                      params, tok, tgt, lm, cfg,
                                      token_types=types))
    del params, leaves
    torch.cuda.empty_cache()
    return out


MHA_SHAPE = (32, 128, 1024)        # batch, tokens, Transformer-big's width
MHA_HEADS, MHA_MEMORY, MHA_DROPOUT = 16, 256, 0.1
MHA_OUT_RTOL = 1e-2                # the output, |kernels - plain| in norm
# one training forward + backward of either module: flash with in-kernel
# dropout, the pre-LayerNorm
MHA_LAUNCHES = {"flash_mma_fwd": 1, "flash_mma_bwd_dq": 1,
                "flash_mma_bwd_dkv": 1, "layer_norm_fwd": 1,
                "layer_norm_bwd": 1}


def multihead_attn_phase(torch, dev, ku):
    """``SelfMultiheadAttn(1024, 16, dropout=0.1, include_norm_add=True,
    bias=True)`` at MHA_SHAPE and ``EncdecMultiheadAttn`` at the same
    widths over a MHA_MEMORY-token memory, bf16 params and input, one
    forward and backward in training under one threefry key: one launch
    each of the flash forward, dQ and dK/dV (in-kernel dropout) and of
    the LN forward and backward (counts reset just before, read just
    after); the output within MHA_OUT_RTOL and every gradient within
    BF16_GRAD_NORM_RTOL of the same call with the plain versions forced
    (the same keep mask: the counter hash of the same seed), in norm; the
    eval output differs. Times forward + backward."""
    from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                       SelfMultiheadAttn)
    from apex_tpu_torch.transformer.tensor_parallel import prng_key

    b, s, e = MHA_SHAPE
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(b, s, e, device=dev, generator=gen).bfloat16()
    mem = torch.randn(b, MHA_MEMORY, e, device=dev, generator=gen).bfloat16()
    dy = torch.randn(b, s, e, device=dev, generator=gen).bfloat16()
    kw = dict(dropout=MHA_DROPOUT, include_norm_add=True, bias=True,
              param_dtype=torch.bfloat16, device=dev)
    key = prng_key(3)
    want = MHA_LAUNCHES
    out = {}
    for name, mod, args in (
            ("self", SelfMultiheadAttn(e, MHA_HEADS, **kw), (x,)),
            ("encdec", EncdecMultiheadAttn(e, MHA_HEADS, **kw), (x, mem))):
        def run():
            ins = [a.clone().requires_grad_() for a in args]
            for p in mod.parameters():
                p.grad = None
            y = mod(*ins, dropout_rng=key)
            y.backward(dy)
            return ([y.detach()] + [a.grad for a in ins]
                    + [p.grad for p in mod.parameters()])

        ku.reset_launch_counts()
        got = run()
        torch.cuda.synchronize()
        launches = ku.launch_counts()
        if launches != want:
            raise AssertionError(f"multihead_attn {name}: launches "
                                 f"{launches}, expected {want}")
        with ku.force_plain():
            plain = run()
        names = (["out"] + [f"d{i}" for i in range(len(args))]
                 + [n for n, _ in mod.named_parameters()])
        worst = {}
        for n, a, c in zip(names, got, plain):
            rel = float((a.float() - c.float()).norm()
                        / c.float().norm().clamp_min(1e-30))
            limit = MHA_OUT_RTOL if n == "out" else BF16_GRAD_NORM_RTOL
            if not bool(a.isfinite().all()) or rel > limit:
                raise AssertionError(f"multihead_attn {name} {n}: |kernels "
                                     f"- plain| / |plain| = {rel:.3e} "
                                     f"(limit {limit})")
            worst[n] = rel
        with torch.no_grad():
            ev = mod(*args, is_training=False)
            if torch.equal(ev, got[0]):
                raise AssertionError(f"multihead_attn {name}: training "
                                     f"output equals eval's (no dropout)")
        ins = [a.clone().requires_grad_() for a in args]
        ms = time_ms(torch, lambda: mod(*ins, dropout_rng=key).backward(dy),
                     iters=10)
        out[name] = {"shape": list(MHA_SHAPE), "heads": MHA_HEADS,
                     "memory": MHA_MEMORY if name == "encdec" else None,
                     "dropout": MHA_DROPOUT, "launches": launches,
                     "rel_err_in_norm": worst,
                     "out_rtol": MHA_OUT_RTOL,
                     "grad_rtol": BF16_GRAD_NORM_RTOL,
                     "fwd_bwd_ms": ms, "tokens_per_s": b * s / ms * 1e3}
        del got, plain, ins, mod
        torch.cuda.empty_cache()
    return out


TRANS_B, TRANS_T, TRANS_U, TRANS_H, TRANS_V = 8, 256, 64, 512, 1024
TRANS_RTOL = 1e-5                  # each sequence's NLL, fp32 vs fp64


def transducer_phase(torch, dev, ku):
    """RNN-T in fp32 at TRANS_B x TRANS_T frames, TRANS_U labels, joint
    width TRANS_H, vocab TRANS_V (lengths from numpy seed 3, the first
    row full): ``TransducerJoint(relu=True)`` of f (B, T, H) and g (B,
    U+1, H), a linear to the vocab (the (B, T, U+1, V) fp32 lattice, 545
    MB), ``TransducerLoss`` (log-softmax, the anti-diagonal alpha
    recursion) and autograd back to f, g and the projection: finite
    gradients, no kernel launched (the module has none), each sequence's
    NLL within TRANS_RTOL of an fp64 run of the same functions on the
    card; forward + backward ms, frames/s, peak memory."""
    import numpy as np

    from apex_tpu_torch.contrib.transducer import (TransducerJoint,
                                                   TransducerLoss,
                                                   transducer_loss)

    B, T, U, H, V = TRANS_B, TRANS_T, TRANS_U, TRANS_H, TRANS_V
    rng = np.random.default_rng(3)
    f_len = T - rng.integers(0, T // 4, B)
    y_len = U - rng.integers(0, U // 4, B)
    f_len[0], y_len[0] = T, U
    t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    f_len, y_len = t(f_len), t(y_len)
    label = t(rng.integers(1, V, (B, U)))
    gen = torch.Generator(device=dev).manual_seed(13)
    f = torch.randn(B, T, H, device=dev, generator=gen).requires_grad_()
    g = torch.randn(B, U + 1, H, device=dev, generator=gen).requires_grad_()
    w = (torch.randn(H, V, device=dev, generator=gen)
         / math.sqrt(H)).requires_grad_()
    joint, loss_mod = TransducerJoint(relu=True), TransducerLoss()

    def fwd_bwd():
        x = torch.matmul(joint(f, g, f_len, y_len + 1), w)
        nll = loss_mod(x, label, f_len, y_len)
        nll.sum().backward()
        return nll.detach()

    torch.cuda.reset_peak_memory_stats()
    ku.reset_launch_counts()
    nll = fwd_bwd()
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    if launches:
        raise AssertionError(f"transducer launched kernels: {launches}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for name, a in (("nll", nll), ("df", f.grad), ("dg", g.grad),
                    ("dw", w.grad)):
        if not bool(a.isfinite().all()) or not bool(a.abs().max() > 0):
            raise AssertionError(f"transducer {name} not finite or zero")
    with torch.no_grad():
        x64 = torch.matmul(joint(f.double(), g.double(), f_len, y_len + 1),
                           w.double())
        nll64 = transducer_loss(torch.log_softmax(x64, -1), label, f_len,
                                y_len)
        del x64
    rel = float(((nll.double() - nll64).abs() / nll64.abs()).max())
    if rel > TRANS_RTOL:
        raise AssertionError(f"transducer NLL vs fp64: rel {rel:.3e} "
                             f"(limit {TRANS_RTOL})")
    for p in (f, g, w):
        p.grad = None
    ms = time_ms(torch, fwd_bwd, iters=3)
    out = {"batch": B, "frames": T, "labels": U, "joint_hidden": H,
           "vocab": V, "lattice_bytes": B * T * (U + 1) * V * 4,
           "nll_mean": float(nll.mean()), "nll_rel_err_vs_fp64": rel,
           "rtol": TRANS_RTOL, "launches": launches, "fwd_bwd_ms": ms,
           "frames_per_s": B * T / ms * 1e3, "peak_mem_gib": peak}
    del f, g, w, nll, nll64
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# contrib.sparsity (ASP) on the flagship step

ASP_STEPS = 3
ASP_TIMED = 5
ASP_PERM_BLOCK = (768, 128)    # fc1's rows x its first 128 columns
ASP_PATH = ("ASP m4n2_1d (JAX's whitelist) over GPT-2-124M bf16, 8 x 1024, "
            "the fused loss, FusedAdam(lr=1e-4) wrapped by "
            "init_optimizer_for_pruning")


def asp_phase(torch, dev, ku):
    """``contrib.sparsity`` on the training main path: the dense default
    step (``build_train_step``) timed first; then ASP's 2:4 masks
    (``m4n2_1d``, JAX's whitelist) computed on the card over a fresh
    GPT-2-124M tree (timed; one leaf's mask equal to the CPU's), applied,
    and ``ASP_STEPS`` steps of the same step with ``FusedAdam`` wrapped by
    ``init_optimizer_for_pruning`` (counts reset just before the first
    step and read just after: the train table, the Adam tail 16). Gates:
    finite losses; every pruned slot exactly 0 after every step. Records
    the mask time, step ms and busy ms beside the dense step's, the
    pruned share, and one ``permute_and_mask`` on the host over a (768,
    128) block of layer 0's dense fc1 kernel (seconds, and the magnitude
    2:4 keeps with and without the permutation; the whole (768, 3072)
    kernel is out of reach: the search scores each column against all
    others every sweep)."""
    import numpy as np

    from apex_tpu_torch.contrib.sparsity import ASP, create_mask
    from apex_tpu_torch.contrib.sparsity.permutation import permute_and_mask
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step,
                                                    gpt_loss,
                                                    init_gpt_params)
    from apex_tpu_torch.transformer.testing.train import param_leaves

    cfg = GPTConfig()
    batch, seq = 8, 1024
    dense, _, _, tok, tgt = build_train_step(cfg, batch, seq, device=dev,
                                             seed=0)
    dense(), dense()
    dense_durs = timed_steps_of(torch, dense, ASP_TIMED)
    dense_prof = profiled(torch, lambda: [dense() for _ in range(3)])
    del dense
    torch.cuda.empty_cache()

    params = init_gpt_params(cfg, seed=0, device=dev)
    rows, cols = ASP_PERM_BLOCK      # the dense block the search permutes
    block = params["layers"]["fc1_kernel"][0][:rows, :cols].float().cpu()
    asp = ASP()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = asp.compute_sparse_masks(params)
    torch.cuda.synchronize()
    mask_ms = (time.perf_counter() - t0) * 1e3
    pairs = []

    def collect(p, m, path=""):
        if isinstance(p, dict):
            for k in p:
                collect(p[k], m[k], f"{path}{k}/")
        elif m is not None:
            pairs.append((path[:-1], p, m))

    collect(params, masks)
    qkv = params["layers"]["qkv_kernel"]
    if not torch.equal(masks["layers"]["qkv_kernel"].cpu(),
                       create_mask(qkv.cpu())):
        raise AssertionError("asp: the card's qkv mask is not the CPU's")
    masked = sum(m.numel() for _, _, m in pairs)
    n_masked = len(pairs)
    pruned_share = 1.0 - float(sum(int(m.sum()) for _, _, m in pairs)
                               ) / masked
    asp.apply_masks(params, masks, in_place=True)
    leaves = param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = asp.init_optimizer_for_pruning(FusedAdam(leaves, lr=1e-4), masks,
                                         params)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = gpt_loss(params, tok, tgt, cfg)
        loss.backward()
        opt.step()
        return loss.detach()

    zero = torch.ones((), dtype=torch.bool, device=dev)
    ku.reset_launch_counts()
    losses = [step()]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    if launches != TRAIN_LAUNCHES:
        raise AssertionError(f"asp step launches {launches}, expected "
                             f"{TRAIN_LAUNCHES}")
    for i in range(ASP_STEPS):
        if i:
            losses.append(step())
        for _, p, m in pairs:
            zero &= (p.detach()[~m] == 0).all()
    vals = torch.stack(losses).tolist()
    if not bool(zero):
        raise AssertionError("asp: a pruned slot moved off 0 in a step")
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"asp losses not finite: {vals}")
    durs = timed_steps_of(torch, step, ASP_TIMED)
    prof = profiled(torch, lambda: [step() for _ in range(3)])
    for _, p, m in pairs:
        zero &= (p.detach()[~m] == 0).all()
    if not bool(zero):
        raise AssertionError("asp: a pruned slot moved off 0 in a step")
    del params, opt, leaves, masks, pairs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, perm, base, best = permute_and_mask(block.numpy(), escape_attempts=0)
    perm_s = time.perf_counter() - t0
    p50 = lambda d: sorted(d)[len(d) // 2] * 1e3
    return {"path": ASP_PATH, "steps": ASP_STEPS, "losses": vals,
            "pruned_slots_stay_zero": True, "launches_per_step": launches,
            "mask_ms": mask_ms, "masked_leaves": n_masked,
            "masked_elements": masked, "pruned_share": pruned_share,
            "step_ms_p50": p50(durs), "step_ms": [d * 1e3 for d in durs],
            "device_busy_ms_per_step": prof["device_busy_ms"] / 3,
            "device_idle_share": prof["device_idle_share"],
            "tokens_per_s": batch * seq * ASP_TIMED / sum(durs),
            "dense_step_ms_p50": p50(dense_durs),
            "dense_device_busy_ms_per_step": dense_prof["device_busy_ms"] / 3,
            "dense_tokens_per_s": batch * seq * ASP_TIMED / sum(dense_durs),
            "permute_and_mask": {
                "matrix": f"layers/fc1_kernel[0][:{rows}, :{cols}]",
                "shape": [rows, cols], "escape_attempts": 0,
                "host_s": perm_s, "magnitude_unpermuted": base,
                "magnitude_permuted": best, "gain": best / base,
                "columns_moved": int((perm != np.arange(cols)).sum())}}


# ---------------------------------------------------------------------------
# models: ResNet-50 (the imagenet example) and DCGAN

RESNET_BATCH, RESNET_PX, RESNET_CLASSES = 64, 224, 1000
RESNET_STEPS = 5
RESNET_PATH = ("ResNet50 at examples/imagenet/main_amp.py's defaults: batch "
               "64 at 224 px, 1000 classes, amp O2 bf16 (BN leaves as amp's "
               "norm predicate keeps them fp32), FusedSGD(lr 0.1, momentum "
               "0.9, weight decay 1e-4), one device, local BN")


def resnet_run(torch, dev, sync: bool = False, ddp=None):
    """One ResNet-50 O2 training run from numpy seed 0 (weights from the
    model's seed, one fixed batch): returns ``step`` and the model (the
    amp state in ``step.box[0]``). ``sync``: the batch norms converted to
    the dp axis of the current mesh; ``ddp``: its average of the
    gradients before the update."""
    import numpy as np

    from apex_tpu_torch import amp
    from apex_tpu_torch.convert import param_tree
    from apex_tpu_torch.models import ResNet50, make_norm
    from apex_tpu_torch.optimizers import FusedSGD
    from apex_tpu_torch.optimizers._common import tree_leaves

    model = ResNet50(num_classes=RESNET_CLASSES, norm=make_norm(),
                     dtype=torch.bfloat16, device=dev, seed=0)
    if sync:
        from apex_tpu_torch.parallel import convert_syncbn_model

        model = convert_syncbn_model(model, axis_name="dp")
    tree = param_tree(model)
    state, _ = amp.initialize(tree, "O2")
    for p, c in zip(tree_leaves(tree), tree_leaves(amp.model_params(state))):
        p.data = c                  # the module holds the O2 model copy
    leaves = tree_leaves(tree)
    opt = FusedSGD(tree_leaves(state.master_params), lr=0.1, momentum=0.9,
                   weight_decay=1e-4)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, RESNET_PX, RESNET_PX, 3), dtype=np.float32)).to(
        dev).to(torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, RESNET_CLASSES,
                                      RESNET_BATCH)).to(dev)
    box = [state]

    def step():
        amp.model_params(box[0], out=tree)
        loss = torch.nn.functional.cross_entropy(model(x).float(), y)
        grads = torch.autograd.grad(amp.scale_loss(loss, box[0]), leaves)
        if ddp is not None:
            grads = ddp.average_gradients(list(grads))
        box[0], _, _ = amp.apply_grads_with_optimizer(box[0], grads, opt)
        return loss.detach()

    step.box = box
    return step, model


def resnet_phase(torch, dev, ku):
    """ResNet-50 trained at the imagenet example's defaults (RESNET_PATH)
    for RESNET_STEPS steps, twice from one seed under cuDNN's
    deterministic algorithms (``CUBLAS_WORKSPACE_CONFIG`` set before the
    first cuBLAS handle, ``main``): finite, falling losses and the two
    loss curves bitwise equal (the reference's ``--deterministic``).
    Records img/s, step ms, busy ms and idle share (torch.profiler over 2
    steps), peak memory, the top kernels and the launches of the port's
    kernels (none: the convolutions are cuDNN's, the head and SGD plain
    PyTorch, as JAX leaves them to XLA)."""
    import torch.backends.cudnn as cudnn

    was = (cudnn.deterministic, cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        curves = []
        torch.cuda.reset_peak_memory_stats()
        for run in range(2):
            step, model = resnet_run(torch, dev)
            if run == 0:
                ku.reset_launch_counts()
            curves.append(torch.stack([step() for _ in range(RESNET_STEPS)]))
            torch.cuda.synchronize()
            if run == 0:
                launches = ku.launch_counts()
                durs = timed_steps_of(torch, step, RESNET_STEPS)
                prof = profiled(torch, lambda: [step() for _ in range(2)])
            del step, model
            torch.cuda.empty_cache()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        cudnn.deterministic, cudnn.benchmark = was[:2]
        torch.use_deterministic_algorithms(was[2])
    vals = curves[0].tolist()
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"resnet50 loss did not fall: {vals}")
    if not torch.equal(curves[0], curves[1]):
        raise AssertionError(f"resnet50 loss curves differ between two runs "
                             f"from one seed: {vals} vs "
                             f"{curves[1].tolist()}")
    p50 = sorted(durs)[len(durs) // 2]
    return {"path": RESNET_PATH, "steps": RESNET_STEPS, "losses": vals,
            "bitwise_repeat": True,
            "cublas_workspace_config": os.environ.get(
                "CUBLAS_WORKSPACE_CONFIG"),
            "launches": launches, "step_ms_p50": p50 * 1e3,
            "step_ms": [d * 1e3 for d in durs],
            "img_per_s": RESNET_BATCH * len(durs) / sum(durs),
            "device_busy_ms_per_step": prof["device_busy_ms"] / 2,
            "device_idle_share": prof["device_idle_share"],
            "peak_mem_gib": peak, "top": prof["top"]}


DCGAN_ISIZE, DCGAN_BATCH, DCGAN_NZ, DCGAN_WIDTH = 64, 64, 100, 64
DCGAN_ITERS = 3
DCGAN_PATH = ("DCGAN at PyTorch's DCGAN defaults: 64 x 64 images, batch 64, "
              "nz 100, ngf = ndf = 64, bf16 compute; errD_real, errD_fake "
              "and errG each under its own dynamic LossScaler (loss_id "
              "0-2); FusedAdam(lr 2e-4, betas (0.5, 0.999)) for G and D")


def dcgan_phase(torch, dev, ku):
    """DCGAN_ITERS iterations of the DCGAN example's step (DCGAN_PATH), as
    JAX's ``examples/dcgan/main_amp.py`` composes it: D on the real batch
    and on G's detached fakes, each loss scaled and unscaled by its own
    scaler, the fp32 gradients added, one guarded Adam step (skipped on
    either overflow); then G through D with the third scaler. Counts reset
    just before and read just after: the Adam tail once per leaf of each
    model an iteration. Gates: finite losses, the launches. Records the
    iteration ms (p50), images/s and peak memory."""
    import numpy as np

    from apex_tpu_torch.amp import LossScaler
    from apex_tpu_torch.models import Discriminator, Generator
    from apex_tpu_torch.optimizers import FusedAdam

    bf = torch.bfloat16
    g = Generator(isize=DCGAN_ISIZE, nz=DCGAN_NZ, ngf=DCGAN_WIDTH, dtype=bf,
                  device=dev, seed=0)
    d = Discriminator(isize=DCGAN_ISIZE, ndf=DCGAN_WIDTH, dtype=bf,
                      device=dev, seed=1)
    g_leaves, d_leaves = list(g.parameters()), list(d.parameters())
    opt_g = FusedAdam(g_leaves, lr=2e-4, betas=(0.5, 0.999))
    opt_d = FusedAdam(d_leaves, lr=2e-4, betas=(0.5, 0.999))
    scalers = [LossScaler("dynamic") for _ in range(3)]
    states = [s.init_state(dev) for s in scalers]
    rng = np.random.default_rng(0)
    real = torch.from_numpy(rng.uniform(
        -1, 1, (DCGAN_BATCH, DCGAN_ISIZE, DCGAN_ISIZE, 3)).astype(
        np.float32)).to(dev).to(bf)
    zs = [torch.from_numpy(rng.standard_normal(
        (DCGAN_BATCH, 1, 1, DCGAN_NZ), dtype=np.float32)).to(dev).to(bf)
        for _ in range(DCGAN_ITERS + 4)]
    ones = torch.ones(DCGAN_BATCH, device=dev)
    zeros = torch.zeros(DCGAN_BATCH, device=dev)
    bce = torch.nn.functional.binary_cross_entropy_with_logits

    def grads_of(i, loss, leaves):
        grads = torch.autograd.grad(scalers[i].scale_loss(loss, states[i]),
                                    leaves)
        g32, found = scalers[i].unscale(list(grads), states[i])
        states[i], skip = scalers[i].update_scale(states[i], found)
        return g32, skip

    def iteration(z):
        fake = g(z)
        err_real = bce(d(real).float(), ones)
        gr, skip0 = grads_of(0, err_real, d_leaves)
        err_fake = bce(d(fake.detach()).float(), zeros)
        gf, skip1 = grads_of(1, err_fake, d_leaves)
        for p, a, b in zip(d_leaves, gr, gf):
            p.grad = a + b
        opt_d.step(found_inf=(skip0 | skip1).float())
        err_g = bce(d(g(z)).float(), ones)
        gg, skip2 = grads_of(2, err_g, g_leaves)
        for p, a in zip(g_leaves, gg):
            p.grad = a
        opt_g.step(found_inf=skip2.float())
        return torch.stack([(err_real + err_fake).detach(), err_g.detach()])

    torch.cuda.reset_peak_memory_stats()
    ku.reset_launch_counts()
    losses = [iteration(zs[i]) for i in range(DCGAN_ITERS)]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    want = {"fused_adam_tail": DCGAN_ITERS * (len(g_leaves) + len(d_leaves))}
    if launches != want:
        raise AssertionError(f"dcgan launches {launches}, expected {want}")
    vals = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for row in vals for v in row):
        raise AssertionError(f"dcgan losses not finite: {vals}")
    durs = timed_steps_of(torch, lambda: iteration(zs[DCGAN_ITERS]), 3)
    prof = profiled(torch, lambda: iteration(zs[DCGAN_ITERS + 1]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del g, d, opt_g, opt_d
    torch.cuda.empty_cache()
    p50 = sorted(durs)[len(durs) // 2]
    return {"path": DCGAN_PATH, "iterations": DCGAN_ITERS,
            "losses_d_g": vals, "launches": launches,
            "launches_per_iteration": {k: v // DCGAN_ITERS
                                       for k, v in launches.items()},
            "iteration_ms_p50": p50 * 1e3,
            "iteration_ms": [t * 1e3 for t in durs],
            "img_per_s": DCGAN_BATCH / p50,
            "device_busy_ms_per_iteration": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "peak_mem_gib": peak, "top": prof["top"]}


# ---------------------------------------------------------------------------
# RNN: the sentiment-discovery mLSTM

RNN_HIDDEN, RNN_EMBED, RNN_VOCAB = 4096, 64, 256
RNN_SEQ, RNN_BATCH, RNN_STEPS = 256, 32, 2
RNN_PATH = ("mLSTM of NVIDIA's sentiment-discovery: hidden 4096, byte "
            "embedding 64 over 256 bytes, a 4096 -> 256 head; sequence 256, "
            "batch 32; fp16 under amp O2 (dynamic loss scale), "
            "FusedAdam(lr=5e-4) over the fp32 masters")


def rnn_phase(torch, dev, ku):
    """RNN_STEPS training steps of the mLSTM (RNN_PATH) on one batch of
    bytes from numpy seed 0 (next-byte prediction), composed from amp's
    public pieces as the amp phase's step. Counts reset just before and
    read just after: the Adam tail once per leaf a step. Gates: finite
    losses, the launches. Records step ms, tokens/s, peak memory and the
    profile of one step (busy ms, idle share, top kernels)."""
    import numpy as np

    from apex_tpu_torch import amp
    from apex_tpu_torch.RNN import mLSTM
    from apex_tpu_torch.convert import param_tree
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._common import tree_leaves

    rng = np.random.default_rng(0)
    cell = mLSTM(RNN_EMBED, RNN_HIDDEN, device=dev, seed=0)
    head_std = 1.0 / math.sqrt(RNN_HIDDEN)
    tree = {"embed": torch.from_numpy(rng.standard_normal(
                (RNN_VOCAB, RNN_EMBED), dtype=np.float32)).to(dev),
            "rnn": param_tree(cell),
            "head": {"kernel": torch.from_numpy(
                         rng.standard_normal((RNN_HIDDEN, RNN_VOCAB),
                                             dtype=np.float32)
                         * np.float32(head_std)).to(dev),
                     "bias": torch.zeros(RNN_VOCAB, device=dev)}}
    state, _ = amp.initialize(tree, "O2", half_dtype=torch.float16)
    model = amp.model_params(state)
    for p, c in zip(tree_leaves(tree["rnn"]), tree_leaves(model["rnn"])):
        p.data = c
    model["rnn"] = tree["rnn"]      # the module's own, now fp16, tensors
    leaves = amp.trainable_leaves(model)
    opt = FusedAdam(tree_leaves(state.master_params), lr=5e-4)
    tok = torch.from_numpy(rng.integers(0, RNN_VOCAB,
                                        (RNN_BATCH, RNN_SEQ + 1))).to(dev)
    box = [state]

    def step():
        amp.model_params(box[0], out=model)
        ys, _ = cell(model["embed"][tok[:, :-1]])
        logits = ys @ model["head"]["kernel"] + model["head"]["bias"]
        loss = torch.nn.functional.cross_entropy(
            logits.float().reshape(-1, RNN_VOCAB), tok[:, 1:].reshape(-1))
        grads = torch.autograd.grad(amp.scale_loss(loss, box[0]), leaves)
        box[0], _, _ = amp.apply_grads_with_optimizer(box[0], grads, opt)
        return loss.detach()

    torch.cuda.reset_peak_memory_stats()
    ku.reset_launch_counts()
    losses = [step() for _ in range(RNN_STEPS)]
    torch.cuda.synchronize()
    launches = ku.launch_counts()
    want = {"fused_adam_tail": RNN_STEPS * len(leaves)}
    if launches != want:
        raise AssertionError(f"rnn launches {launches}, expected {want}")
    vals = torch.stack(losses).tolist()
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"rnn losses not finite: {vals}")
    durs = timed_steps_of(torch, step, 2)
    prof = profiled(torch, step)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del cell, tree, model, opt, leaves
    torch.cuda.empty_cache()
    p50 = sorted(durs)[len(durs) // 2]
    return {"path": RNN_PATH, "steps": RNN_STEPS, "losses": vals,
            "launches": launches,
            "launches_per_step": {k: v // RNN_STEPS
                                  for k, v in launches.items()},
            "step_ms_p50": p50 * 1e3, "step_ms": [t * 1e3 for t in durs],
            "tokens_per_s": RNN_BATCH * RNN_SEQ / p50,
            "device_busy_ms_per_step": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "peak_mem_gib": peak, "top": prof["top"]}


# ---------------------------------------------------------------------------
# data parallel (A7a): DDP's compressed gradient wire and SyncBatchNorm
# over a one-rank NCCL group

DDP_POLICIES = ("none", "int8", "int8_ef", "int4_ef")
DDP_BATCH, DDP_SEQ = 8, 1024
# steps of each data-parallel run (DDP, ZeRO-1, FSDP; dist_lamb's too):
# 3 since the tensor-parallel phases joined the script, to keep it well
# inside its time limit
DDP_STEPS = 3
DDP_TIMED = 3
DDP_PATH = ("GPT-2-124M bf16, 8 x 1024, full remat, fused LM-head loss, "
            "FusedAdam(lr=1e-4); DistributedDataParallel over the "
            "dp axis of build_mesh() on a one-rank NCCL group, "
            "CompressionConfig defaults (block 256, min_elements 2048), "
            "message size 10 M elements")
# the largest |loss - none loss| over the steps an EF policy may show:
# int8_ef JAX's gate (tests/test_comm_mesh.py:488), absolute; int4_ef a
# share of none's loss drop over the run, set from the CPU rehearsal of
# this phase on one rank (2.0-3.3 % at hidden 128-256, 2-4 layers)
DDP_EF_GATE = {"int8_ef": ("abs", 0.02), "int4_ef": ("drop_share", 0.10)}
# the codec path's nearest round trip on the card: the kernels' codes and
# scales are the plain versions' bit for bit (the codec phase's gate)
DDP_USE_PALLAS = None
# the profile's kernel groups a DDP step is split into (names holding
# one of the strings): the codec kernels, NCCL's kernels, the copies
DDP_PROFILE_GROUPS = {"codec": ("quantize_kernel", "dequantize_kernel"),
                      "nccl": ("nccl", "Nccl"),
                      "copy": ("Memcpy", "memcpy")}
SYNCBN_STEPS = 3
SYNCBN_LATENCY_CALLS = 200
SYNCBN_PATH = ("ResNet50 as RESNET_PATH, its SyncBatchNorms converted "
               "(convert_syncbn_model) to the dp axis of build_mesh() on a "
               "one-rank NCCL group, DistributedDataParallel policy none")


class OneRankGroup:
    """A one-rank process group on this process's card for a phase: NCCL
    (no fallback: its failure fails the phase), the mesh built over it,
    torn down on exit."""

    def __init__(self, torch, dev):
        self.torch, self.dev = torch, dev

    def __enter__(self):
        import torch.distributed as dist

        from apex_tpu_torch.parallel.mesh import build_mesh
        from apex_tpu_torch.parallel.multiproc import initialize_distributed

        initialize_distributed(device=self.dev)
        backend = str(dist.get_backend())
        if self.dev.type == "cuda" and "nccl" not in backend:
            raise AssertionError(f"the card's group runs {backend}, not "
                                 f"NCCL")
        self.mesh = build_mesh()
        self.backend = backend
        return self

    def __exit__(self, *exc):
        from apex_tpu_torch.parallel.multiproc import destroy_distributed

        destroy_distributed()


class PlainCalls:
    """Counts calls of the named plain versions while open (``targets``:
    (module, attribute) pairs); the card's path must make none."""

    def __init__(self, targets):
        self.targets, self.saved, self.calls = targets, [], 0

    def __enter__(self):
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def counted(*a, _fn=fn, **k):
                self.calls += 1
                return _fn(*a, **k)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def plain_codec_calls():
    """The codec's plain versions and JAX's reference codes."""
    from apex_tpu_torch.comm import quantize as pq

    return PlainCalls([(pq, name) for name in (
        "quantize_blocks_reference", "dequantize_blocks_reference",
        "_codes")])


def ddp_config(policy: str):
    from apex_tpu_torch.comm import CompressionConfig

    return CompressionConfig(policy=policy, use_pallas=DDP_USE_PALLAS)


def ddp_codec_launches(sizes, cfg):
    """The codec kernels' launches of one DDP step at one rank: each
    compressed bucket quantizes twice (pass 1, pass 3) and dequantizes
    twice (the exchanged chunks, the gathered result), and once more
    under EF (pass 1's error); pass 3's error reads the result."""
    n = sum(1 for s in sizes if cfg.compresses(s))
    if not n:
        return {}
    return {"quantize_blockwise[nearest]": 2 * n,
            "dequantize_blockwise": (3 if cfg.error_feedback else 2) * n}


def ddp_codec_bound(sizes, cfg, world: int = 1):
    """Bytes the codec launches of one step must move (each input read
    once, each output written once) and the byte bound in ms."""
    from apex_tpu_torch.comm.quantize import padded_size

    code = cfg.bits / 8.0
    total = 0.0
    for s in sizes:
        if not cfg.compresses(s):
            continue
        m = padded_size(s, cfg.block_size * world)
        side = 4.0 * m / cfg.block_size
        quant = 4.0 * m + code * m + side               # fp32 in
        deq = code * m + side + 4.0 * m                  # fp32 out
        total += (quant + quant / world
                  + deq * (2 + (1 if cfg.error_feedback else 0)))
    return total, total / HBM_BYTES_PER_S * 1e3


def ddp_bucket_check(torch, cfg, flats, residuals):
    """Each compressed bucket through ``compressed_allreduce`` (the
    kernels) against the plain codec's chain on the same input: quantize
    → dequantize → requantize → dequantize with the kernels' plain
    versions, the result bitwise; under EF the new residual bitwise the
    plain (x + r − dq1) + (dq1 − dq2) and within fp32 rounding of (x + r)
    − round trip."""
    from apex_tpu_torch.comm import quantize as pq
    from apex_tpu_torch.comm.collectives import (_pad_to,
                                                 compressed_allreduce)

    qmax, packed = ((pq.QMAX4, True) if cfg.bits == 4
                    else (pq.QMAX, False))
    bsz = cfg.block_size
    checked, worst = 0, 0.0
    for flat, r in zip(flats, residuals):
        n = flat.numel()
        if not cfg.compresses(n):
            continue
        out, new_r = compressed_allreduce(flat, "dp", cfg, residual=r)
        x = flat.float() if r is None else flat.float() + r
        padded = _pad_to(x, pq.padded_size(n, bsz))
        q1, s1 = pq.quantize_blocks_reference(padded.view(-1, bsz), qmax,
                                              None, packed)
        d1 = pq.dequantize_blocks_reference(q1, s1, packed).reshape(-1)
        q2, s2 = pq.quantize_blocks_reference(d1.view(-1, bsz), qmax,
                                              None, packed)
        d2 = pq.dequantize_blocks_reference(q2, s2, packed).reshape(-1)
        if not torch.equal(out, d2[:n]):
            bad = int((out != d2[:n]).sum())
            raise AssertionError(f"ddp {cfg.policy}: a bucket of {n} "
                                 f"differs from the plain codec's round "
                                 f"trip at {bad} elements")
        if cfg.error_feedback:
            want = ((padded - d1) + (d1 - d2))[:n]
            if not torch.equal(new_r, want):
                raise AssertionError(f"ddp {cfg.policy}: the residual of a "
                                     f"bucket of {n} is not the plain one")
            direct = (x - d2[:n]).abs()
            diff = float((new_r - (x - d2[:n])).abs().max())
            tol = 4 * 2.0 ** -24 * float(x.abs().max() + direct.max())
            if diff > tol:
                raise AssertionError(f"ddp {cfg.policy}: residual off "
                                     f"(x + r) - round trip by {diff:.3e}")
            worst = max(worst, diff)
        checked += 1
    return {"buckets_checked": checked, "residual_vs_direct_max": worst}


def ddp_run(torch, dev, ku, ddp, steps: int = DDP_STEPS,
            timed: int = DDP_TIMED, record: bool = True):
    """One run of the GPT main path with ``ddp`` (None: no DDP) from
    seed 0: the first step's launches, collectives and plain codec calls
    (counts reset just before it, read just after), the losses of
    ``steps`` steps, the final params, then ``timed`` timed steps and a
    profiled one."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)
    from apex_tpu_torch.transformer.testing.train import param_leaves

    cfg = GPTConfig()
    torch.cuda.reset_peak_memory_stats()
    step, params, _, tok, tgt = build_train_step(
        cfg, DDP_BATCH, DDP_SEQ, device=dev, seed=0, ddp=ddp)
    with plain_codec_calls() as plain, \
            accounting.record_collectives() as rec:
        ku.reset_launch_counts()
        losses = [step()]
        torch.cuda.synchronize()
        launches = ku.launch_counts()
    losses += [step() for _ in range(steps - 1)]
    losses = torch.stack(losses)
    out = {"losses": losses, "launches": launches,
           "plain_codec_calls": plain.calls, "collectives": rec,
           "params": [p.detach().clone() for p in param_leaves(params)],
           "state": step.ddp_state, "step": step,
           "gpt": (params, tok, tgt, cfg)}
    if record:
        durs = timed_steps_of(torch, step, timed)
        out["step_ms"] = [d * 1e3 for d in durs]
        out["prof"] = profiled(torch, step, groups=DDP_PROFILE_GROUPS)
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def ddp_phase(torch, dev, ku):
    """DDP on the GPT main path (DDP_PATH) under each of DDP_POLICIES,
    DDP_STEPS steps each, beside the same steps without DDP, in one
    process on one rank. Gates: ``none`` bitwise the no-DDP losses and
    final params; each EF policy within DDP_EF_GATE of ``none`` at every
    step, every curve finite and falling; ``int8_ef`` twice from one seed
    bitwise; each compressed bucket bitwise the plain codec's round trip
    (``ddp_bucket_check``); the first step's launches the train table
    plus ``ddp_codec_launches`` of the bucket list, no plain codec call on
    the path; collectives issued on NCCL. Records step and busy ms, the
    codec's and NCCL's device ms a step (profiler), peak memory, the
    metrics' and ``collective_report``'s wire bytes (0 at one rank: the
    ring model's (W-1)/W) and the modeled bytes at 8 ranks."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.comm.collectives import allreduce_wire_bytes
    from apex_tpu_torch.optimizers._common import tree_leaves
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.transformer.testing import gpt_loss

    result = {"path": DDP_PATH, "steps": DDP_STEPS, "policies": {}}
    with OneRankGroup(torch, dev) as grp:
        result["backend"] = grp.backend
        result["mesh"] = dict(grp.mesh.shape)
        base = ddp_run(torch, dev, ku, None)
        base_vals = base["losses"].tolist()
        if TRAIN_LAUNCHES and base["launches"] != TRAIN_LAUNCHES:
            raise AssertionError(f"no-DDP step launches {base['launches']}"
                                 f", expected {TRAIN_LAUNCHES}")
        result["no_ddp"] = {
            "losses": base_vals, "step_ms": base["step_ms"],
            "step_ms_p50": sorted(base["step_ms"])[DDP_TIMED // 2],
            "device_busy_ms": base["prof"]["device_busy_ms"],
            "peak_mem_gib": base["peak_mem_gib"]}
        base_params = base.pop("params")
        del base
        torch.cuda.empty_cache()
        for policy in DDP_POLICIES:
            cfg = ddp_config(policy)
            ddp = DistributedDataParallel(compression=cfg)
            run = ddp_run(torch, dev, ku, ddp)
            vals = run["losses"].tolist()
            if not all(math.isfinite(v) for v in vals) or \
                    not vals[-1] < vals[0]:
                raise AssertionError(f"ddp {policy}: loss did not fall: "
                                     f"{vals}")
            leaves = run["params"]
            sizes = [sum(leaves[i].numel() for i in idxs)
                     for _, idxs in ddp.buckets(leaves)]
            want = {**TRAIN_LAUNCHES, **ddp_codec_launches(sizes, cfg)}
            if TRAIN_LAUNCHES and run["launches"] != want:
                raise AssertionError(f"ddp {policy}: launches "
                                     f"{run['launches']}, expected {want}")
            if run["plain_codec_calls"] and DDP_USE_PALLAS is None:
                raise AssertionError(f"ddp {policy}: {run['plain_codec_calls']}"
                                     f" plain codec calls on the path")
            rec = run["collectives"]
            rep = accounting.collective_report(rec)
            tagged = {t: sum(1 for c in rec if c.tag == t)
                      for t in sorted({c.tag for c in rec})}
            if policy == "none":
                if not torch.equal(run["losses"], torch.tensor(
                        base_vals, device=run["losses"].device)) or not all(
                        torch.equal(a, b) for a, b in zip(leaves,
                                                          base_params)):
                    raise AssertionError("ddp none: not bitwise the no-DDP "
                                         "steps")
            gap = max(abs(a - b) for a, b in zip(vals, base_vals))
            if policy in DDP_EF_GATE:
                kind, tol = DDP_EF_GATE[policy]
                limit = tol * (base_vals[0] - base_vals[-1]) \
                    if kind == "drop_share" else tol
                if gap > limit:
                    raise AssertionError(f"ddp {policy}: |loss - none| "
                                         f"{gap:.4f} above {limit:.4f}")
            check = {}
            if cfg.enabled:
                params, tok, tgt, gcfg = run["gpt"]
                p_leaves = [p for p in tree_leaves(params)]
                grads = torch.autograd.grad(gpt_loss(params, tok, tgt, gcfg),
                                            p_leaves)
                state = run["state"]["comm_state"]
                flats, res = [], []
                for _, idxs in ddp.buckets(list(grads)):
                    flats.append(torch.cat([grads[i].reshape(-1).float()
                                            for i in idxs]))
                    res.append(None if state is None else torch.cat(
                        [state[i].reshape(-1) for i in idxs]))
                check = ddp_bucket_check(torch, cfg, flats, res)
                del grads, flats, res
            metrics = run["state"]["metrics"].as_dict()
            nbytes, bound = ddp_codec_bound(sizes, cfg)
            prof = run["prof"]
            result["policies"][policy] = {
                "losses": vals, "max_gap_to_none": gap,
                "launches_first_step": run["launches"],
                "codec_launches_per_step": ddp_codec_launches(sizes, cfg),
                "plain_codec_calls": run["plain_codec_calls"],
                "buckets": len(sizes), "bucket_elements": sizes,
                "compressed_buckets": sum(1 for s in sizes
                                          if cfg.compresses(s)),
                "bucket_check": check,
                "step_ms": run["step_ms"],
                "step_ms_p50": sorted(run["step_ms"])[DDP_TIMED // 2],
                "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "codec_ms_per_step": prof["group_device_ms"]["codec"],
                "nccl_ms_per_step": prof["group_device_ms"]["nccl"],
                "copy_ms_per_step": prof["group_device_ms"]["copy"],
                "group_events": prof["group_events"],
                "top": prof["top"],
                "codec_bytes_per_step": nbytes,
                "codec_bound_ms_per_step": bound,
                "peak_mem_gib": run["peak_mem_gib"],
                "metrics": metrics,
                "report": {"counts": rep.counts,
                           "result_bytes": rep.result_bytes,
                           "wire_bytes": rep.wire_bytes,
                           "by_tag": tagged},
                "modeled_wire_bytes_8_ranks": sum(
                    allreduce_wire_bytes(s, 2, 8, cfg) for s in sizes),
                "modeled_fp32_wire_bytes_8_ranks": sum(
                    allreduce_wire_bytes(s, 4, 8, None) for s in sizes)}
            if policy == "int8_ef":
                again = ddp_run(torch, dev, ku, DistributedDataParallel(
                    compression=cfg), record=False)
                if not torch.equal(run["losses"], again["losses"]):
                    raise AssertionError("ddp int8_ef: two runs from one "
                                         "seed differ")
                result["policies"][policy]["bitwise_repeat"] = True
                del again
            del run, leaves
            torch.cuda.empty_cache()
    return result


def syncbn_dp_phase(torch, dev, ku):
    """ResNet-50 (RESNET_PATH) with its SyncBatchNorms converted to the dp
    axis of a one-rank NCCL group and DDP ``none`` (SYNCBN_PATH) against
    the local-BN run, SYNCBN_STEPS steps each from one seed under cuDNN's
    deterministic algorithms: the loss curves, the final masters and the
    running statistics bitwise equal; one all-reduce of the packed
    statistics per BN layer per forward (and one of their gradients per
    backward), counted from the issued collectives; img/s of both."""
    import torch.backends.cudnn as cudnn

    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.optimizers._common import tree_leaves
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

    was = (cudnn.deterministic, cudnn.benchmark,
           torch.are_deterministic_algorithms_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    runs = {}
    try:
        with OneRankGroup(torch, dev) as grp:
            for label in ("local", "sync"):
                sync = label == "sync"
                step, model = resnet_run(
                    torch, dev, sync=sync,
                    ddp=DistributedDataParallel() if sync else None)
                bns = [m for m in model.modules()
                       if isinstance(m, SyncBatchNorm)]
                if sync != all(m.axis_name == "dp" for m in bns):
                    raise AssertionError(f"syncbn_dp {label}: axis names "
                                         f"{[m.axis_name for m in bns]}")
                with accounting.record_collectives() as rec:
                    losses = [step()]
                    torch.cuda.synchronize()
                losses += [step() for _ in range(SYNCBN_STEPS - 1)]
                durs = timed_steps_of(torch, step, SYNCBN_STEPS)
                runs[label] = {
                    "losses": torch.stack(losses),
                    "masters": [t.clone() for t in tree_leaves(
                        step.box[0].master_params)],
                    "stats": [t.clone() for m in bns
                              for t in (m.mean, m.var)],
                    "bn_layers": len(bns), "durs": durs,
                    "tags": {t: sum(1 for c in rec if c.tag == t)
                             for t in sorted({c.tag for c in rec})},
                    "kinds": accounting.collective_report(rec).counts}
                runs[label]["prof"] = profiled(torch, step,
                                               groups=DDP_PROFILE_GROUPS)
                del step, model, bns
                torch.cuda.empty_cache()
            runs["latency"] = allreduce_latency(torch, dev, grp.mesh)
    finally:
        cudnn.deterministic, cudnn.benchmark = was[:2]
        torch.use_deterministic_algorithms(was[2])
    loc, syn = runs["local"], runs["sync"]
    if not torch.equal(loc["losses"], syn["losses"]):
        raise AssertionError(f"syncbn_dp: losses differ from local BN: "
                             f"{loc['losses'].tolist()} vs "
                             f"{syn['losses'].tolist()}")
    for what in ("masters", "stats"):
        if not all(torch.equal(a, b) for a, b in zip(loc[what], syn[what])):
            raise AssertionError(f"syncbn_dp: {what} differ from local BN")
    n_bn = syn["bn_layers"]
    fwd = syn["tags"].get("sync_batch_stats", 0)
    bwd = syn["tags"].get("sync_batch_stats.grad", 0)
    if fwd != n_bn or bwd != n_bn or loc["tags"]:
        raise AssertionError(f"syncbn_dp: {fwd} forward / {bwd} backward "
                             f"statistics all-reduces for {n_bn} BN layers "
                             f"(local run: {loc['tags']})")
    vals = syn["losses"].tolist()
    if not all(math.isfinite(v) for v in vals):
        raise AssertionError(f"syncbn_dp: losses not finite: {vals}")
    lat = runs["latency"]

    def p50(d):
        return sorted(d)[len(d) // 2]

    return {"path": SYNCBN_PATH, "steps": SYNCBN_STEPS, "losses": vals,
            "bitwise_equal_to_local": True, "bn_layers": n_bn,
            "collectives_first_step": syn["tags"],
            "collective_kinds_first_step": syn["kinds"],
            "step_ms_p50": p50(syn["durs"]) * 1e3,
            "local_step_ms_p50": p50(loc["durs"]) * 1e3,
            "img_per_s": RESNET_BATCH / p50(syn["durs"]),
            "local_img_per_s": RESNET_BATCH / p50(loc["durs"]),
            **{f"{k}_device_busy_ms": runs[k]["prof"]["device_busy_ms"]
               for k in ("local", "sync")},
            **{f"{k}_profiled_wall_ms": runs[k]["prof"]["profiled_wall_ms"]
               for k in ("local", "sync")},
            "sync_nccl_ms": syn["prof"]["group_device_ms"]["nccl"],
            "sync_group_events": syn["prof"]["group_events"],
            "allreduce_latency": lat}


def allreduce_latency(torch, dev, mesh, calls: int = SYNCBN_LATENCY_CALLS):
    """One statistics pack's all-reduce ((3, 2048) fp32, ResNet-50's
    widest) on the mesh's dp group, ``calls`` in a row after a warm-up:
    host µs a call (enqueue) and device µs a call (CUDA events)."""
    import torch.distributed as dist

    x = torch.zeros(3, 2048, device=dev)
    group = mesh.group("dp")
    for _ in range(10):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        dist.all_reduce(x, group=group)
    end.record()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return {"calls": calls, "host_us_per_call": host / calls * 1e6,
            "device_us_per_call": start.elapsed_time(end) / calls * 1e3,
            "shape": [3, 2048]}


# ---------------------------------------------------------------------------
# ZeRO and FSDP (A7b): the sharded optimizers and the gather on demand over
# a one-rank NCCL group

ZERO_POLICIES = ("none", "int8", "int8_ef", "e5m2")
FSDP_RUNS = ("none", "grad_int8", "gather_int8", "gather_int4")
ZERO_PATH = ("GPT-2-124M bf16, 8 x 1024, full remat, fused LM-head loss; "
             "build_train_step(plan=ParallelismPlan.preset('zero1', ...)): "
             "DistributedFusedAdam(lr=1e-4) over the dp axis of plan.mesh() "
             "on a one-rank NCCL group, CompressionConfig defaults (block "
             "256, min_elements 2048)")
FSDP_PATH = ("GPT-2-124M bf16, 8 x 1024, full remat, fused LM-head loss; "
             "build_train_step(plan=ParallelismPlan.preset('fsdp', ...)): "
             "the loss over FSDP.gather(master, meta), FSDPAdam(lr=1e-4) "
             "on the fp32 master shards, one-rank NCCL group; int8 codecs "
             "at CompressionConfig's defaults, int4 at block 128")
DIST_LAMB_PATH = ("BertConfig() MLM bf16, 8 x 512 unpadded, 15 % predicted; "
                  "DistributedFusedLAMB(lr=1e-3, eps=1e-6, weight_decay=0.01,"
                  " max_grad_norm=1.0, grad_averaging, the fused LAMB tail) "
                  "over a one-rank NCCL group, beside FusedLAMB with the "
                  "same hyperparameters over fp32 masters of the same bf16 "
                  "weights")
# the largest |loss - none loss| over the run each compressed wire may
# show: JAX's tolerances (tests/test_fsdp.py:558-604; int8_ef as DDP's)
ZERO_GATE = {"int8": 0.02, "int8_ef": 0.02}
FSDP_GATE = {"gather_int8": 0.02, "grad_int8": 0.05, "gather_int4": 0.1}
ZERO_REF_RTOL = 1e-2      # zero1 / fsdp none vs amp O2, §2's bf16 loss gate
DIST_LAMB_STEPS = DDP_STEPS
DIST_LAMB_LR = 1e-3
DIST_LAMB_ATOL = 1e-2     # dist_lamb's loss vs FusedLAMB's, every step
ZERO_PROFILE_GROUPS = {"tail": ("adam_tail_kernel", "sum_parts_kernel"),
                       "codec": ("quantize_kernel", "dequantize_kernel"),
                       "nccl": ("nccl", "Nccl"),
                       "copy": ("Memcpy", "memcpy")}
# the e5m2 transport's largest value (JAX clips to it before the cast)
E5M2_MAX = 57344.0


def plain_tail_calls():
    """The Adam / LAMB tail's plain versions, wherever the sharded path
    looks them up."""
    from apex_tpu_torch.contrib.optimizers import _sharding
    from apex_tpu_torch.contrib.optimizers import distributed_fused_lamb
    from apex_tpu_torch.ops import fused_update

    return PlainCalls([(fused_update, "adam_tail_reference"),
                       (fused_update, "lamb_tail_reference"),
                       (_sharding, "adam_tail_reference"),
                       (distributed_fused_lamb, "lamb_tail_reference")])


def zero_codec_launches(sizes, cfg, ef: bool = False):
    """The codec kernels' launches of one sharded step at one rank, for
    each leaf the wire compresses: one quantize and one dequantize (the
    received chunks), and under EF one more dequantize (pass 1's
    error)."""
    if cfg is None:
        return {}
    n = sum(1 for s in sizes if cfg.compresses(s))
    if not n:
        return {}
    return {"quantize_blockwise[nearest]": n,
            "dequantize_blockwise": (2 if ef else 1) * n}


def zero_codec_bound(sizes, cfg, ef: bool = False):
    """Bytes of those launches (fp32 in and out, the codes and scales) and
    the byte bound in ms."""
    from apex_tpu_torch.comm.quantize import padded_size

    if cfg is None:
        return 0.0, 0.0
    code = cfg.bits / 8.0
    total = 0.0
    for s in sizes:
        if not cfg.compresses(s):
            continue
        m = padded_size(s, cfg.block_size)
        side = 4.0 * m / cfg.block_size
        total += (4.0 * m + code * m + side) + (2 if ef else 1) * (
            code * m + side + 4.0 * m)
    return total, total / HBM_BYTES_PER_S * 1e3


def e5m2_emulation(x):
    """JAX's e5m2 transport on the host, by bits: clip to ±57344 in fp32,
    round to bf16 (nearest even), then to float8_e5m2 (2 mantissa bits,
    nearest even; below 2**-14 multiples of 2**-16) -> fp32 values."""
    import numpy as np

    x = np.clip(np.asarray(x, np.float32), -E5M2_MAX, E5M2_MAX)
    u = x.view(np.uint32).astype(np.uint64)
    b = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(
        np.uint32).view(np.float32)
    ub = b.view(np.uint32).astype(np.uint64)
    normal = ((ub + 0xFFFFF + ((ub >> 21) & 1)) & 0xFFE00000).astype(
        np.uint32).view(np.float32)
    sub = (np.round(b.astype(np.float64) * 2.0 ** 16) / 2.0 ** 16).astype(
        np.float32)
    return np.where(np.abs(b) < 2.0 ** -14, sub, normal)


def plan_run(torch, dev, ku, plan, steps: int = DDP_STEPS,
             timed: int = DDP_TIMED):
    """One run of the GPT main path through ``build_train_step(plan=)``
    from seed 0, the plan's mesh over the current one-rank group: the
    first step's launches, collectives and plain codec / tail calls
    (counts reset just before it, read just after), the synchronizing
    calls of the last of ``steps`` steps, the losses, the fp32 masters
    (unpadded: one rank owns the whole leaf) and the leaves' params after
    that step, then
    ``timed`` timed steps and a profiled one."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.optimizers._common import tree_leaves
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)

    plan.mesh()
    cfg = GPTConfig()
    torch.cuda.reset_peak_memory_stats()
    step, params, opt, tok, tgt = build_train_step(
        cfg, DDP_BATCH, DDP_SEQ, device=dev, seed=0, plan=plan)
    with plain_codec_calls() as pcodec, plain_tail_calls() as ptail, \
            accounting.record_collectives() as rec:
        ku.reset_launch_counts()
        losses = [step()]
        torch.cuda.synchronize()
        launches = ku.launch_counts()
    losses += [step() for _ in range(steps - 2)]
    messages = []
    syncs = count_syncs(torch, lambda: losses.append(step()), messages)
    losses = torch.stack(losses)
    st = step.plan_state["state"]
    sizes = [p.numel() for p in tree_leaves(params)]
    masters = [m.detach()[:n].clone()
               for m, n in zip(tree_leaves(st.master), sizes)]
    gathered = [p.detach().clone() for p in tree_leaves(params)]
    hosts = []
    walls = timed_steps_of(torch, step, timed, hosts)
    prof = profiled(torch, step, groups=ZERO_PROFILE_GROUPS)
    return {"losses": losses, "launches": launches,
            "plain_codec_calls": pcodec.calls,
            "plain_tail_calls": ptail.calls, "collectives": rec,
            "syncs": syncs, "sync_messages": messages[:3],
            "masters": masters, "gathered": gathered, "params": params,
            "sizes": sizes,
            "shard_shapes": [tuple(m.shape) for m in tree_leaves(st.master)],
            "step_ms": [d * 1e3 for d in walls],
            "host_ms": [d * 1e3 for d in hosts], "prof": prof,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def plan_record(run, codec_launches, codec_bytes, codec_bound):
    """The printed / recorded numbers of a :func:`plan_run`."""
    from apex_tpu_torch.comm import accounting

    prof, rec = run["prof"], run["collectives"]
    p50 = lambda d: sorted(d)[len(d) // 2]
    return {"losses": run["losses"].tolist(),
            "launches_first_step": run["launches"],
            "codec_launches_per_step": codec_launches,
            "plain_codec_calls": run["plain_codec_calls"],
            "plain_tail_calls": run["plain_tail_calls"],
            "syncs_per_step": run["syncs"],
            "step_ms": run["step_ms"], "step_ms_p50": p50(run["step_ms"]),
            "host_ms_p50": p50(run["host_ms"]),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "tail_ms_per_step": prof["group_device_ms"]["tail"],
            "codec_ms_per_step": prof["group_device_ms"]["codec"],
            "nccl_ms_per_step": prof["group_device_ms"]["nccl"],
            "copy_ms_per_step": prof["group_device_ms"]["copy"],
            "group_events": prof["group_events"], "top": prof["top"][:6],
            "codec_bytes_per_step": codec_bytes,
            "codec_bound_ms_per_step": codec_bound,
            "peak_mem_gib": run["peak_mem_gib"],
            "collectives_first_step": {
                t: sum(1 for c in rec if c.tag == t)
                for t in sorted({c.tag for c in rec})},
            "collective_kinds": accounting.collective_report(rec).counts}


def check_plan_run(what, run, want, base_vals=None, gate=None,
                   falling: bool = True):
    """The gates every sharded run shares: finite (and, when ``falling``,
    falling) losses; the first step's launches ``want``; no plain tail or
    codec call; no synchronizing call a step; with ``gate``, every step's
    loss within it of ``base_vals``."""
    vals = run["losses"].tolist()
    if not all(math.isfinite(v) for v in vals) or (
            falling and not vals[-1] < vals[0]):
        raise AssertionError(f"{what}: loss not finite or did not fall: "
                             f"{vals}")
    if TRAIN_LAUNCHES and run["launches"] != want:
        raise AssertionError(f"{what}: launches {run['launches']}, "
                             f"expected {want}")
    if run["plain_tail_calls"] or (run["plain_codec_calls"]
                                   and DDP_USE_PALLAS is None):
        raise AssertionError(f"{what}: {run['plain_tail_calls']} plain tail "
                             f"and {run['plain_codec_calls']} plain codec "
                             f"calls on the path")
    if run["syncs"]:
        raise AssertionError(f"{what}: {run['syncs']} synchronizing calls "
                             f"a step: {run['sync_messages']}")
    if gate is not None:
        gap = max(abs(a - b) for a, b in zip(vals, base_vals))
        if gap > gate:
            raise AssertionError(f"{what}: |loss - none| {gap:.4f} above "
                                 f"{gate}")
        return gap
    return None


def _shards(torch, dev, gen, sizes):
    """(g, m, v, p) fp32 flat shards of the given sizes."""
    return [(torch.randn(n, device=dev, generator=gen),
             0.01 * torch.randn(n, device=dev, generator=gen),
             1e-4 * torch.rand(n, device=dev, generator=gen),
             torch.randn(n, device=dev, generator=gen)) for n in sizes]


def shard_tail_check(torch, dev, sizes, lamb: bool = False):
    """The tail kernel on the sharded paths' inputs: fp32 g and p as flat
    ``(k,)`` shards (one rank: k = the leaf's elements), c1 and c2 from a
    device pointer, against its plain version: u, m', v' within rtol 1e-6
    / atol 1e-7 (Adam in both decay modes; LAMB with decay 0.01 and its
    Σp², Σu² within rtol 1e-5). Times the step's launches over ``sizes``
    against the bound of 28 bytes an element (g, p, u 4 each, m and v read
    and written), beside the plain version and, for Adam,
    ``torch.optim.AdamW(fused=True)`` over fp32 params (fp32 moments: the
    same function but that it writes p in place of u; LAMB has no library
    call)."""
    from apex_tpu_torch.ops.fused_update import (adam_tail_reference,
                                                 fused_adam_tail,
                                                 fused_lamb_tail,
                                                 lamb_tail_reference)

    gen = torch.Generator(device=dev).manual_seed(7)
    kw = dict(betas=(0.9, 0.999), eps=1e-8)
    corr = torch.full((2,), 0.9, device=dev)
    corr[1:].fill_(0.999)
    corr = 1.0 - torch.pow(corr, torch.full((), 3.0, device=dev))
    leaves = _shards(torch, dev, gen, sizes)
    worst, sums_err = 0.0, 0.0
    modes = ((0.01, True),) if lamb else ((0.0, True), (0.01, True),
                                          (0.01, False))
    for wd, adam_w in modes:
        for i, (g, m, v, p) in enumerate(leaves):
            if lamb:
                want = lamb_tail_reference(g, m, v, p, 1.0, 1.0, corr=corr,
                                           weight_decay=wd, **kw)
                got = fused_lamb_tail(g, m.clone(), v.clone(), p, 1.0, 1.0,
                                      corr=corr, weight_decay=wd, **kw)
                for a, b in zip(got[3:], want[3:]):
                    sums_err = max(sums_err, check_close(
                        f"shard lamb sums leaf {i}", a, b, 0.0, 1e-5)
                        / float(b))
            else:
                want = adam_tail_reference(g, m, v, p, 1.0, 1.0, corr=corr,
                                           weight_decay=wd,
                                           adam_w_mode=adam_w, **kw)
                got = fused_adam_tail(g, m.clone(), v.clone(), p, 1.0, 1.0,
                                      corr=corr, weight_decay=wd,
                                      adam_w_mode=adam_w, **kw)
            for a, b, what in zip(got[:3], want[:3], ("u", "m", "v")):
                worst = max(worst, check_close(
                    f"shard tail {what} leaf {i} wd={wd}", a, b, 1e-7,
                    1e-6))
    tail = fused_lamb_tail if lamb else fused_adam_tail
    plain = lamb_tail_reference if lamb else adam_tail_reference
    wd = 0.01 if lamb else 0.0

    def step_kernel():
        for g, m, v, p in leaves:
            tail(g, m, v, p, 1.0, 1.0, corr=corr, weight_decay=wd, **kw)

    def step_plain():
        for g, m, v, p in leaves:
            plain(g, m, v, p, 1.0, 1.0, corr=corr, weight_decay=wd,
                  in_place=True, **kw)

    n_el = sum(sizes)
    bms, by = bound_ms(28.0 * n_el, (14.0 if lamb else 10.0) * n_el,
                       "float32")
    out = {"leaves": len(sizes), "elements": n_el, "rtol": 1e-6,
           "atol": 1e-7, "max_abs_err": worst,
           "per": f"the sharded step's {len(sizes)} "
                  f"{'LAMB' if lamb else 'Adam'} launches, fp32 g and p",
           "ms": time_ms(torch, step_kernel, iters=20),
           "plain_ms": time_ms(torch, step_plain, iters=5),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    if lamb:
        out.update(lamb_sums_max_rel_err=sums_err, lamb_sums_rtol=1e-5)
    else:
        params = [p.clone().requires_grad_() for _, _, _, p in leaves]
        for q, (g, _, _, _) in zip(params, leaves):
            q.grad = g.clone()
        lib = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.0,
                                fused=True)
        out["library_ms"] = time_ms(torch, lib.step, iters=20)
        del params, lib
    del leaves
    torch.cuda.empty_cache()
    return out


def zero_reference_run(torch, dev, steps: int = DDP_STEPS):
    """amp O2 from the same weights and batch (fp32 masters,
    ``FusedAdam(lr=1e-4)``): the reference curve of the sharded runs."""
    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy)

    cfg = GPTConfig()
    tok, tgt = _gpt_batch(torch, cfg.vocab_size, DDP_BATCH, DDP_SEQ)
    run = AmpRun(torch, cfg, init_gpt_params_numpy(cfg, 0), tok, tgt, dev)
    losses = torch.stack([run.step() for _ in range(steps)]).tolist()
    del run
    torch.cuda.empty_cache()
    return losses


def check_reference(what, vals, ref):
    rel = max(abs(a - b) / abs(b) for a, b in zip(vals, ref))
    if rel > ZERO_REF_RTOL:
        raise AssertionError(f"{what}: losses {vals} off amp O2's {ref} by "
                             f"{rel:.3e} (rel)")
    return rel


def modeled_hbm(params):
    """``fsdp.accounting.hbm_params_bytes`` of ``params``' tree (GPT-2-124M,
    bf16) under ``ddp`` / ``zero1`` / ``fsdp`` at W = 8: modelled, not
    measured."""
    from apex_tpu_torch.fsdp import FSDP
    from apex_tpu_torch.fsdp.accounting import hbm_params_bytes

    meta = FSDP().meta(params)
    return {s: hbm_params_bytes(meta, strategy=s, world=8)
            for s in ("ddp", "zero1", "fsdp")}


def zero1_phase(torch, dev, ku):
    """ZeRO-1 on the GPT main path (ZERO_PATH) under each of
    ZERO_POLICIES, DDP_STEPS steps each from seed 0, in one process on one
    rank; amp O2 from the same weights beside them. Gates: ``none``
    within ZERO_REF_RTOL of amp O2's losses; the compressed wires within
    ZERO_GATE of ``none``; ``e5m2``'s params bitwise the host emulation
    of JAX's clip → bf16 → e5m2 of its masters; every run's first-step launches the train table (16 tail
    launches, one a leaf) plus ``zero_codec_launches``, no plain tail or
    codec call, no synchronizing call a step, falling losses. Then the
    tail kernel at the shards' inputs (``shard_tail_check``). Records step,
    host and busy ms, the tails', codec's and collectives' device ms a
    step, peak memory, shard shapes, and the modeled HBM bytes at W = 8.
    ``none``'s losses and masters are kept for the fsdp phase."""
    from apex_tpu_torch.comm import CompressionConfig
    from apex_tpu_torch.parallel import ParallelismPlan

    import numpy as np

    result = {"path": ZERO_PATH, "steps": DDP_STEPS, "policies": {}}
    with OneRankGroup(torch, dev) as grp:
        result["backend"] = grp.backend
        ref = zero_reference_run(torch, dev)
        result["amp_o2_losses"] = ref
        keep = {}
        for policy in ZERO_POLICIES:
            kw = {}
            if policy == "e5m2":
                kw["e5m2_allgather"] = True
            elif policy != "none":
                kw["compression"] = CompressionConfig(
                    policy=policy, use_pallas=DDP_USE_PALLAS)
            plan = ParallelismPlan.preset("zero1", **kw)
            run = plan_run(torch, dev, ku, plan)
            cfg = kw.get("compression")
            ef = cfg is not None and cfg.error_feedback
            codec = zero_codec_launches(run["sizes"], cfg, ef)
            want = {**TRAIN_LAUNCHES, **codec}
            # e5m2's two mantissa bits hold a weight still under lr 1e-4
            # updates: its curve need not fall in DDP_STEPS steps
            gap = check_plan_run(f"zero1 {policy}", run, want,
                                 keep.get("losses"), ZERO_GATE.get(policy),
                                 falling=policy != "e5m2")
            nbytes, bound = zero_codec_bound(run["sizes"], cfg, ef)
            rec = plan_record(run, codec, nbytes, bound)
            rec["max_gap_to_none"] = gap
            rec["shard_shapes"] = run["shard_shapes"]
            if policy == "none":
                rec["rel_to_amp_o2"] = check_reference(
                    "zero1 none", rec["losses"], ref)
                keep = {"losses": rec["losses"], "masters": run["masters"],
                        "loss_tensor": run["losses"],
                        "params": run["params"]}
            if policy == "e5m2":
                from apex_tpu_torch.optimizers._common import tree_leaves

                rec["max_gap_to_none"] = max(abs(a - b) for a, b in zip(
                    rec["losses"], keep["losses"]))     # not gated

                rounded = 0
                for p, m in zip(run["gathered"], run["masters"]):
                    want_p = e5m2_emulation(m.cpu().numpy())
                    got_p = p.detach().float().cpu().numpy().reshape(-1)
                    if not np.array_equal(got_p, want_p):
                        bad = int((got_p != want_p).sum())
                        raise AssertionError(f"zero1 e5m2: {bad} gathered "
                                             f"params differ from the host "
                                             f"emulation")
                    rounded += int((got_p != m.cpu().numpy()).sum())
                rec["e5m2_bitwise_host_emulation"] = True
                rec["e5m2_rounded_elements"] = rounded
            result["policies"][policy] = rec
            del run
            torch.cuda.empty_cache()
        result["shard_tail"] = shard_tail_check(
            torch, dev, [m.numel() for m in keep["masters"]])
    result["modeled_hbm_params_bytes_8_ranks"] = modeled_hbm(
        keep.pop("params"))
    result["_keep"] = keep
    return result


def fsdp_phase(torch, dev, ku, zero1):
    """FSDP on the GPT main path (FSDP_PATH), each of FSDP_RUNS for
    DDP_STEPS steps from seed 0 on one rank. Gates: ``none``'s losses and
    fp32 masters bitwise zero1 ``none``'s (the same tail, exact gathers at
    one rank, the same bf16 gradients) and within ZERO_REF_RTOL of amp
    O2's; the int8 / int4 wires within FSDP_GATE of ``none``; the first
    step's launches the train table plus the codec's (a quantize and a
    dequantize a compressed leaf: the gather's forward, or the
    reduce-scatter's backward), no plain tail or codec call, no
    synchronizing call a step, falling losses. Records as zero1's."""
    from apex_tpu_torch.comm import CompressionConfig
    from apex_tpu_torch.parallel import ParallelismPlan

    keep = zero1.pop("_keep")
    result = {"path": FSDP_PATH, "steps": DDP_STEPS, "runs": {}}
    with OneRankGroup(torch, dev) as grp:
        result["backend"] = grp.backend
        base = None
        for label in FSDP_RUNS:
            kw = {}
            if label != "none":
                where, bits = label.split("_")
                cfg = CompressionConfig(
                    policy=bits, use_pallas=DDP_USE_PALLAS,
                    **({"block_size": 128} if bits == "int4" else {}))
                kw["compression" if where == "grad" else "weight_gather"] = cfg
            cfg = kw.get("compression", kw.get("weight_gather"))
            run = plan_run(torch, dev, ku, ParallelismPlan.preset("fsdp",
                                                                  **kw))
            codec = zero_codec_launches(run["sizes"], cfg)
            gap = check_plan_run(f"fsdp {label}", run,
                                 {**TRAIN_LAUNCHES, **codec}, base,
                                 FSDP_GATE.get(label))
            nbytes, bound = zero_codec_bound(run["sizes"], cfg)
            rec = plan_record(run, codec, nbytes, bound)
            rec["max_gap_to_none"] = gap
            rec["shard_shapes"] = run["shard_shapes"]
            if label == "none":
                if not torch.equal(run["losses"], keep["loss_tensor"]) or \
                        not all(torch.equal(a, b) for a, b in
                                zip(run["masters"], keep["masters"])):
                    raise AssertionError(
                        f"fsdp none: not bitwise zero1 none (losses "
                        f"{rec['losses']} vs {keep['losses']})")
                rec["bitwise_zero1_none"] = True
                rec["rel_to_amp_o2"] = check_reference(
                    "fsdp none", rec["losses"], zero1["amp_o2_losses"])
                base = rec["losses"]
            result["runs"][label] = rec
            del run
            torch.cuda.empty_cache()
    del keep
    torch.cuda.empty_cache()
    return result


def dist_lamb_phase(torch, dev, ku, steps: int = DIST_LAMB_STEPS):
    """BERT MLM (DIST_LAMB_PATH): DistributedFusedLAMB on a one-rank NCCL
    group beside FusedLAMB over fp32 masters, ``steps`` steps each from
    the same bf16 weights and batch. Gates: every step's loss within
    DIST_LAMB_ATOL of FusedLAMB's, finite and falling; the first step's
    launches BERT's table with one LAMB tail (``fused_lamb_tail``) a leaf
    and no Adam tail, no plain tail call, no synchronizing call a step.
    Then the LAMB tail at BERT's shards, fp32 (``shard_tail_check``).
    Records step, host and busy ms, the tails' and collectives' device ms
    a step, peak memory."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.contrib.optimizers import DistributedFusedLAMB
    from apex_tpu_torch.optimizers import FusedLAMB
    from apex_tpu_torch.optimizers._common import (tree_leaves,
                                                   tree_unflatten)
    from apex_tpu_torch.parallel.mesh import build_mesh
    from apex_tpu_torch.transformer.testing import (BertConfig,
                                                    bert_mlm_loss,
                                                    init_bert_params)

    cfg = BertConfig()
    hyper = dict(lr=DIST_LAMB_LR, betas=(0.9, 0.999), eps=1e-6,
                 weight_decay=0.01, max_grad_norm=1.0, grad_averaging=True)
    tok, tgt, lm, types, _ = bert_batch(torch, dev, cfg, BERT_BATCH,
                                        BERT_SEQ, False)
    out = {"path": DIST_LAMB_PATH, "steps": steps}

    # FusedLAMB over fp32 masters of the bf16 weights, the model copied
    # from them each step (the comparator; its launches are not counted)
    params = init_bert_params(cfg, seed=0, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    masters = [p.detach().float().clone().requires_grad_(True)
               for p in leaves]
    opt = FusedLAMB(masters, **hyper)
    ref = []
    for _ in range(steps):
        loss = bert_mlm_loss(params, tok, tgt, lm, cfg, token_types=types)
        grads = torch.autograd.grad(loss, leaves)
        for m, g in zip(masters, grads):
            m.grad = g.float()
        opt.step()
        with torch.no_grad():
            for p, m in zip(leaves, masters):
                p.copy_(m)
        ref.append(float(loss.detach()))
    del params, leaves, masters, opt
    torch.cuda.empty_cache()

    with OneRankGroup(torch, dev) as grp:
        out["backend"] = grp.backend
        build_mesh()
        torch.cuda.reset_peak_memory_stats()
        params = init_bert_params(cfg, seed=0, device=dev)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        lamb = DistributedFusedLAMB(**hyper)
        box = {"st": lamb.init(params)}

        def step():
            loss = bert_mlm_loss(params, tok, tgt, lm, cfg,
                                 token_types=types)
            grads = torch.autograd.grad(loss, leaves)
            new, box["st"] = lamb.step(tree_unflatten(params, list(grads)),
                                       box["st"], params)
            with torch.no_grad():
                for p, n in zip(leaves, tree_leaves(new)):
                    p.copy_(n)
            return loss.detach()

        with plain_tail_calls() as ptail, \
                accounting.record_collectives() as rec:
            ku.reset_launch_counts()
            losses = [step()]
            torch.cuda.synchronize()
            launches = ku.launch_counts()
        losses += [step() for _ in range(steps - 2)]
        messages = []
        syncs = count_syncs(torch, lambda: losses.append(step()), messages)
        vals = torch.stack(losses).tolist()
        one = bert_launches(cfg, len(leaves), False)
        del one["fused_adam_tail"]
        one["fused_lamb_tail"] = len(leaves)
        if TRAIN_LAUNCHES and launches != one:
            raise AssertionError(f"dist_lamb: first step launches "
                                 f"{launches}, expected {one}")
        if ptail.calls or syncs:
            raise AssertionError(f"dist_lamb: {ptail.calls} plain tail "
                                 f"calls, {syncs} synchronizing calls a "
                                 f"step: {messages[:3]}")
        if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
            raise AssertionError(f"dist_lamb: loss did not fall: {vals}")
        gap = max(abs(a - b) for a, b in zip(vals, ref))
        if gap > DIST_LAMB_ATOL:
            raise AssertionError(f"dist_lamb: losses {vals} off FusedLAMB's "
                                 f"{ref} by {gap:.4f}")
        hosts = []
        walls = timed_steps_of(torch, step, DDP_TIMED, hosts)
        prof = profiled(torch, step, groups=ZERO_PROFILE_GROUPS)
        sizes = [p.numel() for p in leaves]
        p50 = lambda d: sorted(d)[len(d) // 2] * 1e3
        out.update({
            "losses": vals, "fused_lamb_losses": ref, "max_gap": gap,
            "launches_first_step": launches, "launches_per_step": one,
            "plain_tail_calls": ptail.calls, "syncs_per_step": syncs,
            "collectives_first_step": {
                t: sum(1 for c in rec if c.tag == t)
                for t in sorted({c.tag for c in rec})},
            "step_ms_p50": p50(walls), "host_ms_p50": p50(hosts),
            "tokens_per_s": BERT_BATCH * BERT_SEQ * len(walls) / sum(walls),
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "tail_ms_per_step": prof["group_device_ms"]["tail"],
            "nccl_ms_per_step": prof["group_device_ms"]["nccl"],
            "copy_ms_per_step": prof["group_device_ms"]["copy"],
            "top": prof["top"][:6],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "leaves": len(leaves), "elements": sum(sizes)})
        del params, leaves, box
        torch.cuda.empty_cache()
    out["shard_tail"] = shard_tail_check(torch, dev, sizes, lamb=True)
    return out


# ---------------------------------------------------------------------------
# tensor and sequence parallelism (A7c): the ring chunks' offsets (C7), the
# LM head on a vocab shard, GPT-2 and T5-small through the tp layers

RING_SHAPE = (8, 12, 1024, 64)     # GPT-2's attention: batch, heads, seq, d
RING_T5_SHAPE = (8, 8, 512, 64)    # T5-small's encoder self-attention
RING_CHUNKS = 4
RING_RATE = 0.1
RING_SEED = 1234
RING_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 2 ** -7)}
LM_SHARD_VOCAB = 50304 // 2        # V_local of GPT-2's vocab over tp = 2
# steps of each tp and pipeline run; the train and t5_train phases keep
# their parameters after this many steps for the tp phases
TP_STEPS = DDP_STEPS
TP_TIMED = 3
TP_PATH = ("GPT-2-124M bf16, 8 x 1024, full remat, FusedAdam(lr=1e-4), "
           "through the tp layers on a one-rank NCCL group (tp = sp = 1)")
T5_TP_PATH = ("T5-small (relative bias, encoder-final LN) bf16, 8 x 512 / "
              "128, FusedAdam(lr=1e-4), through the tp layers on a one-rank "
              "NCCL group (tp = sp = 1)")
# variant -> GPTConfig fields; each is held to the train phase's run of
# GPTConfig() (no mesh), as T5's to the t5_train phase's
TP_VARIANTS = {"megatron_sp": dict(megatron_sp=True), "lm_head_tp": {}}
T5_TP_VARIANTS = {"megatron_sp": dict(megatron_sp=True)}


def lm_head_shard_phase(torch, dev):
    """The LM-head kernels (forward, dX, dW) on a vocab shard's rows as a
    rank that owns none of the targets sees them: GPT-2's width, 8192 rows,
    V_local = 25152 (50304 over tp = 2), the targets localized by one
    shard so half are negative and half >= V_local (the vocab-parallel
    loss's non-owner rows; no target in range), fp32 and bf16, each held to
    its plain version with the same targets under the lm_head phase's
    gates; pred is 0 on every row of both."""
    from apex_tpu_torch.ops.lm_head_loss import (lm_head_loss_bwd_dw,
                                                 lm_head_loss_bwd_dx,
                                                 lm_head_loss_bwd_reference,
                                                 lm_head_loss_fwd,
                                                 lm_head_loss_fwd_reference)

    gen = torch.Generator(device=dev).manual_seed(6)
    n, h, v = TRAIN_ROWS, 768, LM_SHARD_VOCAB
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        x = torch.randn(n, h, device=dev, generator=gen).to(dt)
        w = (0.05 * torch.randn(v, h, device=dev, generator=gen)).to(dt)
        t0 = torch.randint(0, v, (n,), device=dev, generator=gen)
        above = torch.randint(0, 2, (n,), device=dev, generator=gen) == 1
        t = torch.where(above, t0 + v, t0 - v)
        g = torch.full((n,), 1.0 / n, device=dev)
        lse, pred = lm_head_loss_fwd(x, w, t)
        dx = lm_head_loss_bwd_dx(x, w, t, lse, g)
        dw = lm_head_loss_bwd_dw(x, w, t, lse, g)
        lse_p, pred_p = lm_head_loss_fwd_reference(x, w, t)
        dx_p, dw_p = lm_head_loss_bwd_reference(x, w, t, lse, g)
        torch.cuda.synchronize()
        if bool((pred != 0).any()) or bool((pred_p != 0).any()):
            raise AssertionError(f"lm_head shard {dname}: a target outside "
                                 f"[0, V_local) picked a score")
        tag = f"vocab shard {dname}"
        tol = 2e-5 if dt == torch.float32 else 2e-4
        atol, rtol = ((1e-5, 1e-4) if dt == torch.float32
                      else (1e-2, 2 ** -7))
        cases.append({
            "dtype": dname, "rows": n, "hidden": h, "vocab_local": v,
            "negative_targets": int((t < 0).sum()),
            "targets_at_or_above_vocab_local": int((t >= v).sum()),
            "pred_all_zero": True,
            "fwd_max_abs_err": check_close(f"lm_head lse {tag}", lse, lse_p,
                                           tol, tol),
            "dx_max_row_rel_err": check_rows(f"lm_head dx {tag}", dx, dx_p,
                                             atol, rtol)[1],
            "dw_max_row_rel_err": check_rows(f"lm_head dw {tag}", dw, dw_p,
                                             atol, rtol)[1],
            "lse_pred_tol": tol, "atol_of_row_max": atol, "rtol": rtol})
        del x, w, t, g, lse, pred, dx, dw, lse_p, pred_p, dx_p, dw_p
        torch.cuda.empty_cache()
    return cases


def _ring_merge(torch, o_bar, lse_run, o_c, lse_c):
    """One chunk merged into a row block's running (o, lse), fp32."""
    lse_new = torch.logaddexp(lse_run, lse_c)
    return (o_bar * torch.exp(lse_run - lse_new)
            + o_c.float() * torch.exp(lse_c - lse_new)), lse_new


def ring_chunks_phase(torch, dev):
    """C7 on the card: the flash kernels with JAX's [seed, q_off, k_off] at
    GPT-2's attention shape (8, 12, 1024, 64), causal, dropout 0.1, in fp32
    and bf16, split into RING_CHUNKS sequence chunks as ring attention runs
    them. Each live chunk (i, j <= i; the diagonal causal) runs the forward,
    dQ and dK/dV kernels at offsets (i·s, j·s), each held to its plain
    version with the same offsets (the flash phase's gates); the chunks'
    (o, lse) merged by log-sum-exp, and their dQ / dK / dV summed (against
    the dense lse, as the ring's second pass runs them), are held to one
    dense kernel call with the same seed under the same gates. Then
    T5-small's encoder self-attention (8, 8, 512, 64) with its fp32 bias,
    non-causal, dropout 0.1: each chunk's d(bias) at its offsets against
    its plain version, and the chunks' d(bias) tiled into the dense one.
    Times of the four kernels at a chunk with offsets set beside offsets 0
    (bf16, the same chunk)."""
    from apex_tpu_torch.ops import attention as pa

    gen = torch.Generator(device=dev).manual_seed(8)
    out = {"cases": [], "timed": {}}
    for shape, bias_on in ((RING_SHAPE, False), (RING_T5_SHAPE, True)):
        b, hh, S, d = shape
        s = S // RING_CHUNKS
        causal = not bias_on
        scale = 1.0 / math.sqrt(d)
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[1]
            atol, rtol = RING_TOL[dname]
            q, k, v, do = (torch.randn(b * hh, S, d, device=dev,
                                       generator=gen).to(dt)
                           for _ in range(4))
            bias = (torch.randn(hh, S, S, device=dev, generator=gen)
                    if bias_on else None)
            args = (scale, causal, RING_RATE, RING_SEED)
            o_d, lse_d = pa.flash_attention_fwd(q, k, v, *args, bias=bias)
            delta = (do.float() * o_d.float()).sum(-1, keepdim=True)
            dq_d = pa.flash_attention_bwd_dq(q, k, v, do, lse_d, delta,
                                             *args, bias=bias)
            dk_d, dv_d = pa.flash_attention_bwd_dkv(q, k, v, do, lse_d,
                                                    delta, *args, bias=bias)
            db_d = (pa.flash_attention_bwd_dbias(q, k, v, do, lse_d, delta,
                                                 *args, bias=bias)
                    if bias_on else None)
            errs = {"fwd": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0,
                    "dbias": 0.0}
            dq = torch.zeros(b * hh, S, d, device=dev)
            dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
            db = torch.zeros(hh, S, S, device=dev) if bias_on else None
            o_m = torch.zeros(b * hh, S, d, device=dev)
            lse_m = torch.full((b * hh, S, 1), pa.NEG_INF, device=dev)
            tag = f"ring {'t5' if bias_on else 'gpt'} {dname}"
            for i in range(RING_CHUNKS):
                rows = slice(i * s, (i + 1) * s)
                qc, doc = q[:, rows].contiguous(), do[:, rows].contiguous()
                lse_i = lse_d[:, rows].contiguous()
                delta_i = delta[:, rows].contiguous()
                o_bar = torch.zeros(b * hh, s, d, device=dev)
                lse_run = torch.full((b * hh, s, 1), pa.NEG_INF, device=dev)
                for j in range(RING_CHUNKS if not causal else i + 1):
                    cols = slice(j * s, (j + 1) * s)
                    kc, vc = k[:, cols].contiguous(), v[:, cols].contiguous()
                    bc = (bias[:, rows, cols].contiguous() if bias_on
                          else None)
                    cargs = (scale, causal and i == j, RING_RATE, RING_SEED)
                    offs = dict(q_off=i * s, k_off=j * s)
                    o_c, lse_c = pa.flash_attention_fwd(qc, kc, vc, *cargs,
                                                        bias=bc, **offs)
                    o_p, lse_p = pa.flash_attention_fwd_reference(
                        qc, kc, vc, *cargs, bias=bc, **offs)
                    errs["fwd"] = max(errs["fwd"], check_close(
                        f"{tag} fwd o ({i},{j})", o_c, o_p, atol, rtol),
                        check_close(f"{tag} fwd lse ({i},{j})", lse_c,
                                    lse_p, 1e-4, 1e-4))
                    o_bar, lse_run = _ring_merge(torch, o_bar, lse_run, o_c,
                                                 lse_c)
                    dq_c = pa.flash_attention_bwd_dq(
                        qc, kc, vc, doc, lse_i, delta_i, *cargs, bias=bc,
                        **offs)
                    dk_c, dv_c = pa.flash_attention_bwd_dkv(
                        qc, kc, vc, doc, lse_i, delta_i, *cargs, bias=bc,
                        **offs)
                    want = pa.flash_attention_bwd_reference(
                        qc, kc, vc, o_d[:, rows].contiguous(), lse_i, doc,
                        *cargs, bias=bc, **offs)
                    for key, got, w_ in (("dq", dq_c, want[0]),
                                         ("dk", dk_c, want[1]),
                                         ("dv", dv_c, want[2])):
                        errs[key] = max(errs[key], check_close(
                            f"{tag} {key} ({i},{j})", got, w_, atol, rtol))
                    dq[:, rows] += dq_c.float()
                    dk[:, cols] += dk_c.float()
                    dv[:, cols] += dv_c.float()
                    if bias_on:
                        db_c = pa.flash_attention_bwd_dbias(
                            qc, kc, vc, doc, lse_i, delta_i, *cargs,
                            bias=bc, **offs)
                        db_p = pa.flash_attention_bwd_dbias_reference(
                            qc, kc, vc, o_d[:, rows].contiguous(), lse_i,
                            doc, *cargs, bias=bc, **offs)
                        errs["dbias"] = max(errs["dbias"], check_close(
                            f"{tag} dbias ({i},{j})", db_c, db_p,
                            *DBIAS_TOL))
                        db[:, rows, cols] = db_c
                o_m[:, rows] = o_bar
                lse_m[:, rows] = lse_run
            torch.cuda.synchronize()
            case = {"shape": list(shape), "dtype": dname, "causal": causal,
                    "bias": bias_on, "chunks": RING_CHUNKS,
                    "dropout": RING_RATE, "atol": atol, "rtol": rtol,
                    "chunk_vs_plain_max_abs_err": errs,
                    "merged_vs_dense_max_abs_err": {
                        "o": check_close(f"{tag} merged o", o_m.to(dt), o_d,
                                         atol, rtol),
                        "lse": check_close(f"{tag} merged lse", lse_m,
                                           lse_d, 1e-4, 1e-4),
                        "dq": check_close(f"{tag} summed dq", dq.to(dt),
                                          dq_d, atol, rtol),
                        "dk": check_close(f"{tag} summed dk", dk.to(dt),
                                          dk_d, atol, rtol),
                        "dv": check_close(f"{tag} summed dv", dv.to(dt),
                                          dv_d, atol, rtol)}}
            if bias_on:
                case["merged_vs_dense_max_abs_err"]["dbias"] = check_close(
                    f"{tag} tiled dbias", db, db_d, *DBIAS_TOL)
            out["cases"].append(case)
            if dt == torch.bfloat16:
                out["timed"]["t5" if bias_on else "gpt"] = ring_chunk_times(
                    torch, pa, q, k, v, do, lse_d, delta, bias, s, scale,
                    causal)
            del q, k, v, do, o_d, lse_d, delta, dq_d, dk_d, dv_d, dq, dk
            del dv, o_m, lse_m, db, db_d, bias
            torch.cuda.empty_cache()
    return out


def ring_chunk_times(torch, pa, q, k, v, do, lse, delta, bias, s, scale,
                     causal):
    """The four kernels on chunk (RING_CHUNKS - 1, 1) (a full chunk below
    the diagonal) at its offsets beside offsets 0, with their bounds."""
    i, j = RING_CHUNKS - 1, 1
    rows, cols = slice(i * s, (i + 1) * s), slice(j * s, (j + 1) * s)
    qc, doc = q[:, rows].contiguous(), do[:, rows].contiguous()
    kc, vc = k[:, cols].contiguous(), v[:, cols].contiguous()
    lse_i, delta_i = lse[:, rows].contiguous(), delta[:, rows].contiguous()
    bc = None if bias is None else bias[:, rows, cols].contiguous()
    cargs = (scale, False, RING_RATE, RING_SEED)
    heads = 0 if bias is None else bias.shape[0]
    bounds = flash_bounds(qc.shape[0], s, s, qc.shape[-1], False,
                          qc.element_size(), "bfloat16", heads)
    out = {"chunk": [i, j], "rows": s}
    kernels = {
        "fwd": lambda o: pa.flash_attention_fwd(qc, kc, vc, *cargs, bias=bc,
                                                **o),
        "dq": lambda o: pa.flash_attention_bwd_dq(qc, kc, vc, doc, lse_i,
                                                  delta_i, *cargs, bias=bc,
                                                  **o),
        "dkv": lambda o: pa.flash_attention_bwd_dkv(qc, kc, vc, doc, lse_i,
                                                    delta_i, *cargs,
                                                    bias=bc, **o)}
    if bc is not None:
        kernels["dbias"] = lambda o: pa.flash_attention_bwd_dbias(
            qc, kc, vc, doc, lse_i, delta_i, *cargs, bias=bc, **o)
    for (name, fn), (bms, by) in zip(kernels.items(), bounds):
        out[name] = {
            "ms_offsets_set": time_ms(torch, lambda: fn(dict(
                q_off=i * s, k_off=j * s))),
            "ms_offsets_0": time_ms(torch, lambda: fn({})),
            "bound_ms": bms, "bound_by": by}
    return out


def _mesh_state(torch, tp: bool):
    """Install the one-rank tp mesh (``parallel_state``) or none."""
    from apex_tpu_torch.parallel.mesh import set_mesh
    from apex_tpu_torch.transformer import parallel_state

    parallel_state.destroy_model_parallel()
    set_mesh(None)
    if tp:
        parallel_state.initialize_model_parallel(1)


def tp_run(torch, ku, build, steps: int, timed: int):
    """``steps`` steps of a fresh ``build()`` step from seed 0: the first
    step's launches and collectives (counts reset just before it, read
    just after), the losses, the leaves after the last step, then
    ``timed`` timed steps (host and wall ms) and a profiled one."""
    from apex_tpu_torch.comm import accounting
    from apex_tpu_torch.convert import named_leaves

    step, params = build()
    with accounting.record_collectives() as rec:
        ku.reset_launch_counts()
        losses = [step()]
        torch.cuda.synchronize()
        launches = ku.launch_counts()
    losses += [step() for _ in range(steps - 1)]
    losses = torch.stack(losses)
    leaves = {k: p.detach().clone() for k, p in named_leaves(params)}
    hosts = []
    walls = timed_steps_of(torch, step, timed, hosts)
    prof = profiled(torch, step)
    del step, params
    torch.cuda.empty_cache()
    return {"losses": losses, "leaves": leaves, "launches": launches,
            "collectives": accounting.collective_report(rec).counts,
            "step_ms": [w * 1e3 for w in walls],
            "host_ms": [h * 1e3 for h in hosts],
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"]}


def no_mesh_base(train, steps: int = TP_STEPS):
    """The train / t5_train phase's run (no mesh, seed 0, the same batch)
    as a tp phase's base: its first ``steps`` losses, its parameters after
    them, its first step's launches and its times."""
    prof = train["profile_3_steps"]
    return {"losses": train["losses"][:steps],
            "leaves": train.pop("_leaves_after_tp_steps"),
            "launches": train["launches_per_step"],
            "step_ms_p50": train["step_ms_p50"],
            "device_busy_ms": prof["device_busy_ms"] / 3,
            "device_idle_share": prof["device_idle_share"]}


def tp_record(run, base):
    """The printed / recorded numbers of a :func:`tp_run` beside the run
    without a mesh: losses and every leaf bitwise, the same launches."""
    p50 = lambda d: sorted(d)[len(d) // 2]
    vals = run["losses"].tolist()
    if not all(math.isfinite(x) for x in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"tp run's loss did not fall: {vals}")
    bad = [k for k in base["leaves"]
           if not torch_equal(run["leaves"][k], base["leaves"][k])]
    if vals != base["losses"] or bad:
        raise AssertionError(f"tp run differs from the run without tp: "
                             f"losses {vals} vs {base['losses']}, "
                             f"leaves {bad[:4]}")
    if run["launches"] != base["launches"]:
        raise AssertionError(f"tp run launches {run['launches']} differ "
                             f"from the run without tp's "
                             f"{base['launches']}")
    return {"losses": vals, "bitwise_to_no_tp": True,
            "launches_first_step": run["launches"],
            "collectives_per_step": run["collectives"],
            "step_ms_p50": p50(run["step_ms"]),
            "host_ms_p50": p50(run["host_ms"]),
            "device_busy_ms": run["device_busy_ms"],
            "device_idle_share": run["device_idle_share"]}


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def tp_phase(torch, dev, ku, train, steps: int = TP_STEPS,
             timed: int = TP_TIMED):
    """GPT-2-124M bf16 at 8 x 1024, full width and depth, through the tp
    layers on a one-rank NCCL group, TP_STEPS steps of each of
    TP_VARIANTS: megatron_sp and the fused vocab-parallel LM head
    (``lm_head_loss(axis_name="tp")``). At one rank every mapping, ring
    and the head's merge is the identity, so each runs the arithmetic of
    the run without a mesh, which the train phase made (seed 0, the same
    batch): losses and every parameter after the steps are held bitwise
    to it and the first step's kernel launches equal its. The first
    step's collectives are recorded (none cross a one-rank axis)."""
    from apex_tpu_torch.transformer.testing import (GPTConfig,
                                                    build_train_step)

    def build(fields):
        cfg = GPTConfig(**fields)
        step, params, _, _, _ = build_train_step(cfg, DDP_BATCH, DDP_SEQ,
                                                 device=dev, seed=0)
        return step, params

    base = no_mesh_base(train, steps)
    result = {"path": TP_PATH, "steps": steps, "variants": {},
              "no_tp": {k: base[k] for k in (
                  "losses", "step_ms_p50", "device_busy_ms",
                  "device_idle_share", "launches")}}
    with OneRankGroup(torch, dev) as group:
        result["backend"] = group.backend
        for name, fields in TP_VARIANTS.items():
            _mesh_state(torch, True)
            run = tp_run(torch, ku, lambda: build(fields), steps, timed)
            result["variants"][name] = tp_record(run, base)
            del run
        _mesh_state(torch, False)
    del base
    torch.cuda.empty_cache()
    return result


def t5_tp_phase(torch, dev, ku, t5_train, steps: int = TP_STEPS,
                timed: int = TP_TIMED):
    """T5-small bf16 (the t5_train phase's config and batch) through the tp
    layers under megatron_sp on a one-rank NCCL group, TP_STEPS steps,
    held to the t5_train phase's run without a mesh: losses and every
    parameter bitwise, the same kernel launches (the relative bias through
    flash's bias path and d(bias))."""
    import dataclasses

    from apex_tpu_torch.transformer.testing import build_t5_train_step

    def build(fields):
        cfg = dataclasses.replace(t5_config(torch.bfloat16), **fields)
        step, params, _, _ = build_t5_train_step(cfg, T5_BATCH, T5_ENC,
                                                 T5_DEC, device=dev, seed=0)
        return step, params

    base = no_mesh_base(t5_train, steps)
    result = {"path": T5_TP_PATH, "steps": steps, "variants": {},
              "no_tp": {k: base[k] for k in (
                  "losses", "step_ms_p50", "device_busy_ms",
                  "device_idle_share", "launches")}}
    with OneRankGroup(torch, dev) as group:
        result["backend"] = group.backend
        for name, fields in T5_TP_VARIANTS.items():
            _mesh_state(torch, True)
            run = tp_run(torch, ku, lambda: build(fields), steps, timed)
            result["variants"][name] = tp_record(run, base)
            del run
        _mesh_state(torch, False)
    del base
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# pipeline parallelism (one rank: the schedules' device work, not the wire)

PIPE_M = 4
PIPE_LR = 1e-4
PIPE_PATH = ("GPT-2-124M bf16, 8 x 1024, full remat, fused LM-head loss, "
             "untied head, FusedAdam(lr=1e-4), through the pipeline "
             "schedules on a one-rank NCCL group "
             "(initialize_model_parallel(pp=1)), M = 4")
T5_PIPE_PATH = ("T5-small (relative bias, encoder-final LN) bf16, 8 x 512 / "
                "128, FusedAdam(lr=1e-4), through "
                "forward_backward_pipelining_enc_dec on a one-rank NCCL "
                "group (pp = 1), M = 4")
# run -> (schedule, virtual pipeline size, stage remat)
PIPE_RUNS = {"no_pipelining": ("none", None, False),
             "1f1b": ("1f1b", None, True),
             "1f1b_no_remat": ("1f1b", None, False),
             "interleaved_vp2": ("interleaved", 2, True)}
T5_PIPE_RUNS = {"enc_dec": True, "enc_dec_no_remat": False}
# every run's fp32 first step against the plain step's: JAX's step gate
PIPE_FP32_RTOL = 1e-5
# every bf16 step's loss against the plain step's: 4x the largest gap
# measured over three steps (1.04e-4 on an H100 80GB HBM3 at 700 W; the
# first step, from the same weights, agreed bitwise)
PIPE_LOSS_RTOL = 4e-4


def gpt_pipeline_launches(M, L, vp, remat, leaves):
    """Kernel launches of one GPT pipeline step at pp = 1: each of the M
    microbatches runs its L layers forward (LN 2, flash 1 a layer), each
    layer's remat replays them in backward, the head's LN and the fused LM
    head once; with the stage remat the stage's recompute replays each of
    its vp chunks up to the input of the chunk's last layer (a
    non-reentrant checkpoint stops once the tensors backward reads are
    back: L - vp layers); one Adam tail a leaf."""
    replay = L - (vp or 1) if remat else 0
    return {"layer_norm_fwd": M * (4 * L + 1 + 2 * replay),
            "layer_norm_bwd": M * (2 * L + 1),
            "flash_mma_fwd": M * (2 * L + replay),
            "flash_mma_bwd_dq": M * L, "flash_mma_bwd_dkv": M * L,
            "lm_head_mma_fwd": M, "lm_head_mma_bwd_dx": M,
            "lm_head_mma_bwd_dw": M, "fused_adam_tail": leaves}


def t5_pipeline_launches(M, le, ld, remat, leaves):
    """Kernel launches of one T5 enc-dec pipeline step at pp = 1: per
    microbatch the t5_train table's layers (LN 2 an encoder and 3 a
    decoder layer, flash 1 a self- and 1 a cross-attention, each replayed
    by the layer remat; the encoder-final LN at the decoder stage's entry
    and the head's LN, JAX's unfused pipeline head: no LM-head kernel);
    the stage remat replays each stage up to its last layer's input (and
    the encoder-final LN); one Adam tail a leaf."""
    re_, rd = (le - 1, ld - 1) if remat else (0, 0)
    return {"layer_norm_fwd": M * (4 * le + 6 * ld + 2 + 2 * re_ + 3 * rd
                                   + (1 if remat else 0)),
            "layer_norm_bwd": M * (2 * le + 3 * ld + 2),
            "flash_mma_fwd": M * (2 * le + 4 * ld + re_ + 2 * rd),
            "flash_mma_fwd[bias]": M * (2 * le + 2 * ld + re_ + rd),
            "flash_mma_bwd_dq": M * (le + 2 * ld),
            "flash_mma_bwd_dq[bias]": M * (le + ld),
            "flash_mma_bwd_dkv": M * (le + 2 * ld),
            "flash_mma_bwd_dkv[bias]": M * (le + ld),
            "flash_mma_bwd_dbias": M * (le + ld), "fused_adam_tail": leaves}


def plain_kernel_calls():
    """The training kernels' plain versions, wherever the paths look them
    up (the pipeline runs on the card must make none)."""
    import importlib

    from apex_tpu_torch.optimizers import fused_adam
    from apex_tpu_torch.ops import fused_update

    att = importlib.import_module("apex_tpu_torch.ops.attention")
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    lm = importlib.import_module("apex_tpu_torch.ops.lm_head_loss")
    return PlainCalls(
        [(att, n) for n in ("flash_attention_fwd_reference",
                            "flash_attention_bwd_reference",
                            "flash_attention_bwd_dbias_reference",
                            "attention_reference")]
        + [(ln, n) for n in ("layer_norm_fwd_reference",
                             "layer_norm_bwd_reference")]
        + [(lm, n) for n in ("lm_head_loss_fwd_reference",
                             "lm_head_loss_bwd_reference")]
        + [(fused_update, "adam_tail_reference"),
           (fused_adam, "adam_tail_reference")])


def pipe_train_step(torch, drive, params, opt, leaves):
    """One step: ``drive()`` -> (loss, grads), the grads set as the
    leaves' ``.grad``, the optimizer's update; the loss."""
    from apex_tpu_torch.optimizers._common import tree_leaves

    def step():
        loss, grads = drive()
        for p, g in zip(leaves, tree_leaves(grads)):
            p.grad = g
        opt.step()
        return loss
    return step


def pipe_grads(params):
    """The gradients the last step set, by leaf name (the plain GPT tree's
    ``layers.`` named ``stages.`` as in the pipeline tree), copied to the
    host so that they take no room in the runs' peak memory."""
    from apex_tpu_torch.convert import named_leaves

    return {k.replace("layers.", "stages.", 1): p.grad.detach().cpu()
            for k, p in named_leaves(params)}


def pipe_run(torch, ku, build, steps: int = TP_STEPS,
             timed: int = TP_TIMED):
    """``steps`` steps of ``build()``'s step from seed 0: the first step's
    launches and plain-version calls (counts reset just before it, read
    just after) and gradients, the synchronizing calls and peak memory of
    the last, the losses; then ``timed`` timed steps and a profiled
    one."""
    step, params = build()
    with plain_kernel_calls() as plain:
        ku.reset_launch_counts()
        losses = [step()]
        torch.cuda.synchronize()
        launches = ku.launch_counts()
    grads0 = pipe_grads(params)
    losses += [step() for _ in range(steps - 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    syncs = count_syncs(torch, lambda: losses.append(step()))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hosts = []
    walls = timed_steps_of(torch, step, timed, hosts)
    prof = profiled(torch, step)
    del step, params
    torch.cuda.empty_cache()
    p50 = lambda d: sorted(d)[len(d) // 2]
    return {"losses": torch.stack(losses).tolist(), "grads0": grads0,
            "launches": launches, "plain_calls": plain.calls,
            "syncs_per_step": syncs, "peak_mem_gib": peak,
            "step_ms_p50": p50(walls) * 1e3,
            "host_ms_p50": p50(hosts) * 1e3,
            "device_busy_ms": prof["device_busy_ms"],
            "device_idle_share": prof["device_idle_share"],
            "top": prof["top"][:8]}


def grad_rel_errs(torch, grads, base):
    """Each leaf's gradient beside the plain step's, in norm (the leaf
    reshaped to the plain one's: the interleaved chunk stack is the
    layer stack cut in vp)."""
    if set(grads) != set(base):
        raise AssertionError(f"gradient leaves {sorted(grads)} vs the plain "
                             f"step's {sorted(base)}")
    rel = {}
    for k, b in base.items():
        a = grads[k].float().reshape(b.shape)
        b = b.float()
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{k}: non-finite gradient")
        rel[k] = float((a - b).norm() / b.norm().clamp_min(1e-30))
    return rel


def pipe_checks(torch, what, run, base, want, loss_base=None):
    """A pipeline run beside the plain step: every step's loss within
    PIPE_LOSS_RTOL, the first step's gradients (the same weights) within
    BF16_GRAD_NORM_RTOL in norm, the launches the formula's, no
    plain-version call, no synchronizing call, a falling loss. Returns
    the worst leaf's gradient error."""
    vals = run["losses"]
    if not all(math.isfinite(v) for v in vals) or not vals[-1] < vals[0]:
        raise AssertionError(f"{what}: loss did not fall: {vals}")
    for i, (a, b) in enumerate(zip(vals, loss_base or base["losses"])):
        if not abs(a - b) <= PIPE_LOSS_RTOL * abs(b):
            raise AssertionError(f"{what}: step {i} loss {a} vs the plain "
                                 f"step's {b} (rtol {PIPE_LOSS_RTOL})")
    rel = grad_rel_errs(torch, run.pop("grads0"), base["grads0"])
    worst = max(rel, key=rel.get)
    if not rel[worst] <= BF16_GRAD_NORM_RTOL:
        raise AssertionError(f"{what}: first step's {worst} gradient "
                             f"{rel[worst]:.3e} from the plain step's "
                             f"(limit {BF16_GRAD_NORM_RTOL})")
    if run["launches"] != want:
        raise AssertionError(f"{what}: launches {run['launches']}, the "
                             f"formula gives {want}")
    if run["plain_calls"]:
        raise AssertionError(f"{what}: {run['plain_calls']} plain-version "
                             f"calls")
    if run["syncs_per_step"]:
        raise AssertionError(f"{what}: {run['syncs_per_step']} "
                             f"synchronizing calls a step")
    return rel[worst]


def pipe_record(run, extra=None):
    return {k: run[k] for k in (
        "losses", "launches", "syncs_per_step", "peak_mem_gib", "step_ms_p50",
        "host_ms_p50", "device_busy_ms", "device_idle_share",
        "top")} | (extra or {})


def pipe_fp32_gate(torch, what, runs):
    """One fp32 step of each of ``runs`` (name -> ``(make_params,
    drive)``, ``drive(params) -> (loss, grads)``; the first the plain
    step over the whole batch) from the same weights: every other run's
    loss and every gradient leaf (in norm) within PIPE_FP32_RTOL of the
    plain step's, JAX's step gate. Returns the plain loss and each run's
    loss and errors."""
    from apex_tpu_torch.convert import named_leaves

    base, out = None, {"rtol": PIPE_FP32_RTOL, "runs": {}}
    for run, (make_params, drive) in runs.items():
        params = make_params()
        loss, grads = drive(params)
        got = {k.replace("layers.", "stages.", 1): g
               for k, g in named_leaves(grads)}
        del params, grads
        if base is None:
            base, out["loss_plain"] = got, float(loss)
            continue
        rel = grad_rel_errs(torch, got, base)
        worst = max(rel, key=rel.get)
        loss_rel = abs(float(loss) - out["loss_plain"]) / abs(
            out["loss_plain"])
        if not (loss_rel <= PIPE_FP32_RTOL and rel[worst] <= PIPE_FP32_RTOL):
            raise AssertionError(f"{what} {run}: fp32 step vs the plain "
                                 f"step: loss rel {loss_rel:.2e}, worst leaf "
                                 f"{worst} {rel[worst]:.2e}")
        out["runs"][run] = {"loss": float(loss), "loss_rel": loss_rel,
                            "worst_leaf": worst,
                            "worst_leaf_rel": rel[worst]}
        del got
        torch.cuda.empty_cache()
    return out


def spec_step(spec):
    """A PipelineSpec's three functions composed over one microbatch (the
    no-pipelining step function; the whole model is one stage)."""
    def fwd(p, mb):
        h = spec.stage_fn(p["stages"], spec.embed_fn(p["embed"], mb[0]))
        return spec.loss_fn(p["head"], h, mb[1])
    return fwd


def pipeline_phase(torch, dev, ku):
    """GPT-2-124M bf16 at 8 x 1024 (``GPTConfig()``, the untied head the
    pipeline needs) through the schedules on a one-rank NCCL group
    (``initialize_model_parallel(pp=1)``), TP_STEPS steps of each of
    PIPE_RUNS with ``FusedAdam(lr=1e-4)`` after the driver, M = 4, beside
    the plain ``gpt_loss`` step over the whole batch from the same
    weights: every step's loss within PIPE_LOSS_RTOL, the first step's
    gradients within BF16_GRAD_NORM_RTOL, launches a step equal to
    :func:`gpt_pipeline_launches`, no plain-version call, 0 synchronizing
    calls a step; the stage remat's peak memory below 1F1B's without it;
    one fp32 step of every run within PIPE_FP32_RTOL of the plain
    ``gpt_loss`` step (loss and every gradient leaf). At one rank the
    hops and the pp sums issue no collective: this is the schedules'
    device work (microbatching, the stage remat, the launch order), not
    the wire."""
    import dataclasses

    from apex_tpu_torch.convert import pipeline_params_from_numpy
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._common import tree_unflatten
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sch
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
        trainable_leaves,
    )
    from apex_tpu_torch.transformer.testing import (GPTConfig, gpt_loss,
                                                    gpt_pipeline_params_numpy,
                                                    gpt_pipeline_spec,
                                                    gpt_pipeline_specs_tree)

    tok, tgt = (t.to(dev) for t in _gpt_batch(torch, GPTConfig().vocab_size,
                                              DDP_BATCH, DDP_SEQ))

    def model(cfg):
        """The config's spec and its run's drivers: run -> ``(make_params,
        drive)``, ``drive(params) -> (loss, grads)``, the plain
        ``gpt_loss`` step first."""
        untied = dataclasses.replace(cfg, tie_embeddings=False)
        tree = gpt_pipeline_params_numpy(cfg, 1, seed=0)
        spec, L = gpt_pipeline_spec(cfg), cfg.num_layers

        def local_tree(vp):
            t = tree
            if vp:
                t = dict(tree, stages={k: v.reshape((vp, 1, L // vp)
                                                    + v.shape[2:])
                                       for k, v in tree["stages"].items()})
            return pipeline_params_from_numpy(
                t, dev, cfg.dtype,
                specs=gpt_pipeline_specs_tree(cfg, interleaved=bool(vp)))

        def plain_params():
            p = local_tree(None)
            return {"embed": p["embed"], "layers": p["stages"],
                    "head": p["head"]}

        def plain(params):
            leaves = trainable_leaves(params)
            loss = gpt_loss(params, tok, tgt, untied)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), tree_unflatten(params, list(grads))

        runs = {"plain": (plain_params, plain)}
        for run, (kind, vp, remat) in PIPE_RUNS.items():
            kw = dict(num_microbatches=PIPE_M)
            if kind == "none":
                def drive(params, kw=kw):
                    return sch.forward_backward_no_pipelining(
                        spec_step(spec), (tok, tgt), params, **kw)
            elif kind == "1f1b":
                def drive(params, kw=kw, remat=remat):
                    return sch.forward_backward_pipelining_without_interleaving(
                        spec, params, (tok, tgt), remat=remat, **kw)
            else:
                def drive(params, kw=kw, vp=vp, remat=remat):
                    return sch.forward_backward_pipelining_with_interleaving(
                        spec, params, (tok, tgt), virtual_pipeline_size=vp,
                        remat=remat, **kw)
            runs[run] = (lambda vp=vp: local_tree(vp), drive)
        return runs

    def build(make_params, drive):
        def make():
            params = make_params()
            leaves = trainable_leaves(params)
            opt = FusedAdam(leaves, lr=PIPE_LR)
            return pipe_train_step(torch, lambda: drive(params), params, opt,
                                   leaves), params
        return make

    L = GPTConfig().num_layers
    result = {"path": PIPE_PATH, "steps": TP_STEPS, "M": PIPE_M, "runs": {}}
    with OneRankGroup(torch, dev) as group:
        result["backend"] = group.backend
        parallel_state.destroy_model_parallel()
        parallel_state.initialize_model_parallel(1, 1)
        result["fp32_check"] = pipe_fp32_gate(
            torch, "pipeline", model(GPTConfig(dtype=torch.float32)))
        runs = model(GPTConfig())
        plain = pipe_run(torch, ku, build(*runs.pop("plain")))
        n_leaves = len(plain["grads0"])
        for run, (kind, vp, remat) in PIPE_RUNS.items():
            r = pipe_run(torch, ku, build(*runs[run]))
            want = gpt_pipeline_launches(PIPE_M, L, vp,
                                         remat and kind != "none", n_leaves)
            worst = pipe_checks(torch, f"pipeline {run}", r, plain, want)
            result["runs"][run] = pipe_record(r, {
                "grads_worst_rel": worst, "launches_formula": want})
            del r
        result["plain"] = pipe_record(plain)
        parallel_state.destroy_model_parallel()
    runs = result["runs"]
    if not runs["1f1b"]["peak_mem_gib"] < runs["1f1b_no_remat"]["peak_mem_gib"]:
        raise AssertionError(f"the stage remat's peak "
                             f"{runs['1f1b']['peak_mem_gib']:.3f} GiB is not "
                             f"below 1F1B's without it "
                             f"{runs['1f1b_no_remat']['peak_mem_gib']:.3f}")
    del plain
    torch.cuda.empty_cache()
    return result


def t5_pipeline_phase(torch, dev, ku, t5_train):
    """T5-small bf16 (the t5_train phase's config and batch) through
    ``forward_backward_pipelining_enc_dec`` at pp = 1 on a one-rank NCCL
    group, M = 4, with and without the stage remat, TP_STEPS steps with
    ``FusedAdam(lr=1e-4)``: the first loss within PIPE_LOSS_RTOL of
    ``t5_loss``'s (the t5_train phase's run from the same seed and batch);
    every step's loss and the first step's gradients beside the same
    functions run over the whole batch in one pass (the pipeline tree
    unties the LM rows and copies the bias tables and the encoder-final
    LN into the stages, so after an update it is another model than
    ``t5_loss``'s); launches as :func:`t5_pipeline_launches`, no
    plain-version call, 0 synchronizing calls, the remat's peak below the
    run without it; one fp32 step of no-pipelining (M = 4) and of both
    enc-dec runs within PIPE_FP32_RTOL of the whole-batch pass."""
    import numpy as np

    from apex_tpu_torch.convert import pipeline_params_from_numpy
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sch
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
        trainable_leaves,
    )
    from apex_tpu_torch.transformer.testing import (t5_enc_dec_spec,
                                                    t5_pipeline_params_numpy,
                                                    t5_pipeline_specs_tree)

    def batch_on(dev_):
        """``build_t5_train_step``'s batch: numpy seed 1, encoder tokens
        then decoder tokens, targets rolled by one."""
        vocab = t5_config(torch.bfloat16).vocab_size
        rng = np.random.default_rng(1)
        enc = torch.from_numpy(rng.integers(0, vocab, (T5_BATCH, T5_ENC)))
        dec = torch.from_numpy(rng.integers(0, vocab, (T5_BATCH, T5_DEC)))
        return tuple(t.to(dev_) for t in (enc, dec, torch.roll(dec, -1, 1)))

    def sequential(spec):
        def fwd(p, mb):
            mem = spec.enc_stage_fn(p["enc_stages"],
                                    spec.enc_embed_fn(p["embed"], mb[0]))
            h = spec.dec_stage_fn(p["dec_stages"],
                                  spec.dec_embed_fn(p["embed"], mb[1]), mem)
            return spec.loss_fn(p["head"], h, mb[2])
        return fwd

    batch = batch_on(dev)

    def model(cfg):
        """run -> ``(make_params, drive)``: the whole-batch pass first,
        then no-pipelining (fp32 only) and the enc-dec runs."""
        spec, tree = t5_enc_dec_spec(cfg), t5_pipeline_params_numpy(
            cfg, 1, seed=0)

        def make():
            return pipeline_params_from_numpy(
                tree, dev, cfg.dtype, specs=t5_pipeline_specs_tree(cfg))

        def loop(M):
            return lambda p: sch.forward_backward_no_pipelining(
                sequential(spec), batch, p, num_microbatches=M)
        runs = {"plain": (make, loop(1)), "no_pipelining": (make,
                                                            loop(PIPE_M))}
        for run, remat in T5_PIPE_RUNS.items():
            runs[run] = (make, lambda p, remat=remat:
                         sch.forward_backward_pipelining_enc_dec(
                             spec, p, batch, num_microbatches=PIPE_M,
                             remat=remat))
        return runs

    def build(make_params, drive):
        def make():
            params = make_params()
            leaves = trainable_leaves(params)
            opt = FusedAdam(leaves, lr=PIPE_LR)
            return pipe_train_step(torch, lambda: drive(params), params, opt,
                                   leaves), params
        return make

    out = {"path": T5_PIPE_PATH, "steps": TP_STEPS, "M": PIPE_M, "runs": {}}
    with OneRankGroup(torch, dev) as group:
        out["backend"] = group.backend
        parallel_state.destroy_model_parallel()
        parallel_state.initialize_model_parallel(1, 1)
        out["fp32_check"] = pipe_fp32_gate(torch, "t5_pipeline",
                                           model(t5_config(torch.float32)))
        cfg = t5_config(torch.bfloat16)
        runs = model(cfg)
        plain = pipe_run(torch, ku, build(*runs["plain"]))
        t5_first = t5_train["losses"][0]
        if not abs(plain["losses"][0] - t5_first) <= (
                PIPE_LOSS_RTOL * abs(t5_first)):
            raise AssertionError(f"the pipeline tree's first loss "
                                 f"{plain['losses'][0]} vs t5_loss's "
                                 f"{t5_first} (rtol {PIPE_LOSS_RTOL})")
        n_leaves = len(plain["grads0"])
        for run, remat in T5_PIPE_RUNS.items():
            r = pipe_run(torch, ku, build(*runs[run]))
            want = t5_pipeline_launches(PIPE_M, cfg.enc_layers,
                                        cfg.dec_layers, remat, n_leaves)
            worst = pipe_checks(torch, f"t5_pipeline {run}", r, plain, want)
            out["runs"][run] = pipe_record(r, {
                "grads_worst_rel": worst, "launches_formula": want})
            del r
        out["plain"] = pipe_record(plain, {"t5_loss_first": t5_first})
        parallel_state.destroy_model_parallel()
    runs = out["runs"]
    if not (runs["enc_dec"]["peak_mem_gib"]
            < runs["enc_dec_no_remat"]["peak_mem_gib"]):
        raise AssertionError("T5: the stage remat's peak is not below the "
                             "run without it")
    del plain
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# mixture of experts (one rank: ep = dp = 1, no exchange)

MOE_EXPERTS, MOE_TOP_K, MOE_FACTOR = 8, 2, 1.25
MOE_PATH = ("GPT-2-124M bf16 with num_experts=8 (top-2, capacity factor "
            "1.25), 8 x 1024, full remat, fused LM-head loss, "
            "FusedAdam(lr=1e-4), on a one-rank NCCL group (ep = dp = 1)")
# one fp32 step of JAX's single-expert identity (E = 1, top-1, a zero
# router, factor 1.0: C = 8200 >= 8192 keeps every token) against the
# dense gpt_loss step on the same weights plus lb_loss_weight: the loss
# and every gradient leaf's norm
MOE_FP32_RTOL = 1e-5
# the bf16 8-expert first step against an fp32 run of the same weights and
# batch (stated before the first run on the card): the loss within 1e-2
# and each gradient leaf's norm within 5e-2 of the fp32 leaf's norm (a
# routing decision may flip where bf16 moves a near tie, so the leaves
# are held in norm, their differences reported)
MOE_LOSS_RTOL = 1e-2
MOE_GRAD_NORM_RTOL = 5e-2
# the same bf16 step: each gradient leaf's difference from the fp32 leaf
# within half the fp32 leaf's norm (a gradient of the same norm pointing
# an unrelated way is about 1.4 off, a reversed one 2)
MOE_GRAD_DIFF_RTOL = 0.5
# one fp32 step of the 8-expert model against the same GPT with
# plain_moe_mlp (no transformer.moe) in place of its MoE layer: the loss
# and each gradient leaf's difference norm within 1e-5 of the plain
# step's (relative)
MOE_PLAIN_RTOL = 1e-5


def moe_launches(n_leaves):
    """Kernel launches of one MoE GPT-2 step: the dense step's table (the
    routing, the dispatch, expert and combine products are torch.matmul /
    bmm outside any kernel, as JAX's einsums) and one Adam tail a leaf
    (17: the fp32 router and four expert leaves for the four dense FFN
    leaves)."""
    return dict(TRAIN_LAUNCHES, fused_adam_tail=n_leaves)


def _loss_and_grads(torch, cfg, tree, dev, tok, tgt, dtype=None):
    """One gpt_loss forward + backward of ``tree`` (numpy) as ``dtype``
    tensors: the loss and each gradient leaf on the host."""
    from apex_tpu_torch.convert import named_leaves, params_from_numpy
    from apex_tpu_torch.transformer.testing import gpt_loss

    params = params_from_numpy(tree, dev, dtype=dtype)
    names = [k for k, _ in named_leaves(params)]
    leaves = [p.requires_grad_() for _, p in named_leaves(params)]
    loss = gpt_loss(params, tok, tgt, cfg)
    grads = torch.autograd.grad(loss, leaves)
    out = {k: g.detach().float().cpu() for k, g in zip(names, grads)}
    del params, leaves, grads
    torch.cuda.empty_cache()
    return float(loss), out


def moe_fp32_identity(torch, dev, tok, tgt):
    """JAX's single-expert identity at full width in fp32: the MoE GPT
    (E = 1, top-1, zero router, factor 1.0) carrying the dense GPT's FFN
    as its expert equals the dense GPT plus ``lb_loss_weight`` (lb = 1,
    z = 0), loss and every shared gradient leaf's norm within
    MOE_FP32_RTOL."""
    import dataclasses

    import numpy as np

    from apex_tpu_torch.transformer.testing import GPTConfig
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        init_gpt_params_numpy,
    )

    dense_cfg = GPTConfig(dtype=torch.float32)
    moe_cfg = dataclasses.replace(dense_cfg, num_experts=1, moe_top_k=1,
                                  moe_capacity_factor=1.0)
    cap = moe_cfg.moe_config.capacity(TRAIN_ROWS)
    if cap < TRAIN_ROWS:
        raise AssertionError(f"capacity {cap} drops tokens")
    dense = init_gpt_params_numpy(dense_cfg, seed=0)
    layers = dict(dense["layers"])
    for k in ("fc1_kernel", "fc1_bias", "fc2_kernel", "fc2_bias"):
        layers[k] = layers[k][:, None]
    layers["router"] = np.zeros((dense_cfg.num_layers, dense_cfg.hidden, 1),
                                np.float32)
    tree = {"embed": dense["embed"], "layers": layers, "head": dense["head"]}
    l_dense, g_dense = _loss_and_grads(torch, dense_cfg, dense, dev, tok, tgt)
    l_moe, g_moe = _loss_and_grads(torch, moe_cfg, tree, dev, tok, tgt)
    weight = moe_cfg.moe_config.lb_loss_weight
    loss_rel = abs(l_moe - weight - l_dense) / abs(l_dense)
    rel = {k: abs(float(g_moe[k].norm()) - float(g.norm()))
           / max(float(g.norm()), 1e-30) for k, g in g_dense.items()}
    worst = max(rel, key=rel.get)
    if not (loss_rel <= MOE_FP32_RTOL and rel[worst] <= MOE_FP32_RTOL):
        raise AssertionError(f"moe single-expert fp32 step vs dense + "
                             f"{weight}: loss rel {loss_rel:.2e}, worst leaf "
                             f"{worst} {rel[worst]:.2e} (limit "
                             f"{MOE_FP32_RTOL})")
    return {"capacity": cap, "loss_dense": l_dense, "loss_moe": l_moe,
            "lb_loss_weight": weight, "loss_rel": loss_rel,
            "worst_leaf": worst, "worst_leaf_norm_rel": rel[worst],
            "rtol": MOE_FP32_RTOL}


def make_plain_moe_mlp(margins):
    """A stand-in for ``transformer.moe.moe_mlp`` at one rank, written
    plainly without it: top-k by repeated argmax (the lower expert on
    ties), the gates renormalised over k, then for each expert its
    choices in priority order (every token's first choice in token order,
    then every second choice) cut at the capacity, their rows gathered by
    index through the expert's FFN and added back weighted by their gates;
    the Switch and z losses as JAX defines them. Each call appends the
    smallest gap between a token's k-th and (k+1)-th probability to
    ``margins`` (how far a rounding difference must move a logit to
    change a choice)."""
    import torch
    import torch.nn.functional as F

    def plain_moe_mlp(params, x, cfg, ep_axis=None, seq_shard_axis=None):
        if seq_shard_axis is not None:
            raise ValueError("plain_moe_mlp: one rank's tokens only")
        h = x.shape[-1]
        xf = x.reshape(-1, h)
        t, e, k = xf.shape[0], cfg.num_experts, cfg.top_k
        cap = cfg.capacity(t)
        logits = xf.float() @ params["router"]
        probs = torch.softmax(logits, dim=-1)
        rest = probs.detach().clone()
        idx = []
        for _ in range(k):
            i = torch.argmax(rest, dim=-1)
            idx.append(i)
            rest.scatter_(1, i[:, None], -1.0)
        if k < e:
            nxt = rest.max(-1).values
            margins.append(float((probs.gather(
                1, idx[-1][:, None])[:, 0] - nxt).min()))
        idx = torch.stack(idx, 1)                                 # (T, k)
        gate = probs.gather(1, idx)
        gate = gate / gate.sum(-1, keepdim=True)
        out = torch.zeros_like(xf)
        kept = 0
        for ex in range(e):
            rows = [torch.nonzero(idx[:, j] == ex)[:, 0] for j in range(k)]
            gates = [gate[r, j] for j, r in enumerate(rows)]
            rows, gates = torch.cat(rows)[:cap], torch.cat(gates)[:cap]
            kept += rows.numel()
            y = xf[rows] @ params["fc1_kernel"][ex].to(x.dtype)
            y = F.gelu(y + params["fc1_bias"][ex], approximate="tanh")
            y = y @ params["fc2_kernel"][ex].to(x.dtype)
            y = y + params["fc2_bias"][ex]
            out = out.index_add(0, rows, gates.to(x.dtype)[:, None] * y)
        frac = F.one_hot(idx[:, 0], e).float().mean(0)
        lb_loss = e * (frac * probs.mean(0)).sum()
        z = torch.logsumexp(logits, dim=-1)
        z_loss = (z * z).mean()
        aux = {"lb_loss": lb_loss, "z_loss": z_loss,
               "fraction_kept": torch.tensor(kept / (t * k),
                                             device=x.device),
               "loss": (cfg.lb_loss_weight * lb_loss
                        + cfg.z_loss_weight * z_loss)}
        return out.reshape(x.shape), aux

    return plain_moe_mlp


def moe_plain_check(torch, cfg32, tree, dev, tok, tgt, l32, g32):
    """One fp32 step of the GPT with ``make_plain_moe_mlp``'s layer in
    place of ``transformer.moe.moe_mlp`` against the port's fp32 step
    (``l32``, ``g32``) on the same weights and batch: the loss and each
    gradient leaf's difference norm within MOE_PLAIN_RTOL of the plain
    step's."""
    import apex_tpu_torch.transformer.moe as moe_mod

    margins, orig = [], moe_mod.moe_mlp
    moe_mod.moe_mlp = make_plain_moe_mlp(margins)
    try:
        lp, gp = _loss_and_grads(torch, cfg32, tree, dev, tok, tgt)
    finally:
        moe_mod.moe_mlp = orig
    loss_rel = abs(l32 - lp) / abs(lp)
    diff = {k: float((g32[k] - g).norm()) / max(float(g.norm()), 1e-30)
            for k, g in gp.items()}
    worst = max(diff, key=diff.get)
    if not (loss_rel <= MOE_PLAIN_RTOL and diff[worst] <= MOE_PLAIN_RTOL):
        raise AssertionError(
            f"moe fp32 step vs the plain MoE layer: loss rel "
            f"{loss_rel:.2e}, worst leaf difference {worst} "
            f"{diff[worst]:.2e} (limit {MOE_PLAIN_RTOL})")
    return {"loss_plain": lp, "loss_rel": loss_rel, "worst_leaf": worst,
            "worst_leaf_diff_rel": diff[worst], "diff_norm_rel": diff,
            "smallest_topk_margin": min(margins), "rtol": MOE_PLAIN_RTOL}


def moe_fraction_kept(torch, cfg, params, tok, tgt):
    """Each layer's ``fraction_kept`` on a no-grad forward (the first
    step's weights): ``moe_mlp``'s aux, recorded around the call."""
    import apex_tpu_torch.transformer.moe as moe_mod
    from apex_tpu_torch.transformer.testing import gpt_loss

    kept, orig = [], moe_mod.moe_mlp

    def record(*a, **kw):
        out, aux = orig(*a, **kw)
        kept.append(aux["fraction_kept"])
        return out, aux

    moe_mod.moe_mlp = record
    try:
        with torch.no_grad():
            gpt_loss(params, tok, tgt, cfg)
    finally:
        moe_mod.moe_mlp = orig
    return torch.stack(kept).tolist()


def moe_phase(torch, dev, ku):
    """GPT-2-124M bf16 with 8 experts (MOE_PATH) on a one-rank NCCL group:
    JAX's single-expert identity in fp32 (:func:`moe_fp32_identity`);
    TP_STEPS steps of the 8-expert model under ``FusedAdam(lr=1e-4)``
    (every loss finite, the first step's launches the formula's,
    :func:`moe_launches`, no plain-version call, 0 synchronizing calls a
    step), its first step beside an fp32 step of the same weights and
    batch (MOE_LOSS_RTOL, MOE_GRAD_NORM_RTOL, MOE_GRAD_DIFF_RTOL), that
    fp32 step beside the plain MoE layer's (:func:`moe_plain_check`);
    each layer's ``fraction_kept``; step, host and busy ms and peak
    memory."""
    import dataclasses

    from apex_tpu_torch.convert import named_leaves
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer import parallel_state
    from apex_tpu_torch.transformer.pipeline_parallel.schedules.common import (
        trainable_leaves,
    )
    from apex_tpu_torch.transformer.testing import GPTConfig, gpt_loss
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        gpt_params_from_numpy,
        init_gpt_params_numpy,
    )

    tok, tgt = (t.to(dev) for t in _gpt_batch(torch, GPTConfig().vocab_size,
                                              DDP_BATCH, DDP_SEQ))
    cfg = GPTConfig(num_experts=MOE_EXPERTS, moe_top_k=MOE_TOP_K,
                    moe_capacity_factor=MOE_FACTOR)
    result = {"path": MOE_PATH, "steps": TP_STEPS,
              "capacity": cfg.moe_config.capacity(TRAIN_ROWS)}
    with OneRankGroup(torch, dev) as group:
        result["backend"] = group.backend
        parallel_state.destroy_model_parallel()
        parallel_state.initialize_model_parallel(1, 1)
        result["fp32_identity"] = moe_fp32_identity(torch, dev, tok, tgt)
        tree = init_gpt_params_numpy(cfg, seed=0)
        result["n_params"] = sum(int(v.size)
                                 for _, v in named_leaves(tree))

        def build():
            params = gpt_params_from_numpy(tree, cfg, dev)
            if params["layers"]["router"].dtype != torch.float32:
                raise AssertionError("the router is not fp32")
            leaves = trainable_leaves(params)
            opt = FusedAdam(leaves, lr=PIPE_LR)

            def step():
                loss = gpt_loss(params, tok, tgt, cfg)
                for p, g in zip(leaves, torch.autograd.grad(loss, leaves)):
                    p.grad = g
                opt.step()
                return loss.detach()
            return step, params

        params0 = gpt_params_from_numpy(tree, cfg, dev)
        result["fraction_kept"] = moe_fraction_kept(torch, cfg, params0, tok,
                                                    tgt)
        del params0
        run = pipe_run(torch, ku, build)
        want = moe_launches(len(run["grads0"]))
        if run["launches"] != want:
            raise AssertionError(f"moe: launches {run['launches']}, the "
                                 f"formula gives {want}")
        if run["plain_calls"] or run["syncs_per_step"]:
            raise AssertionError(f"moe: {run['plain_calls']} plain-version "
                                 f"calls, {run['syncs_per_step']} "
                                 f"synchronizing calls a step")
        if not all(math.isfinite(v) for v in run["losses"]):
            raise AssertionError(f"moe: non-finite loss {run['losses']}")
        l32, g32 = _loss_and_grads(torch, dataclasses.replace(
            cfg, dtype=torch.float32), tree, dev, tok, tgt)
        g16 = {k.replace("stages.", "layers.", 1): g
               for k, g in run.pop("grads0").items()}
        loss_rel = abs(run["losses"][0] - l32) / abs(l32)
        norm_rel = {k: abs(float(g16[k].norm()) - float(g.norm()))
                    / max(float(g.norm()), 1e-30) for k, g in g32.items()}
        diff_rel = {k: float((g16[k] - g).norm())
                    / max(float(g.norm()), 1e-30) for k, g in g32.items()}
        worst = max(norm_rel, key=norm_rel.get)
        worst_diff = max(diff_rel, key=diff_rel.get)
        if not (loss_rel <= MOE_LOSS_RTOL
                and norm_rel[worst] <= MOE_GRAD_NORM_RTOL
                and diff_rel[worst_diff] <= MOE_GRAD_DIFF_RTOL):
            raise AssertionError(
                f"moe bf16 first step vs fp32: loss rel {loss_rel:.2e} "
                f"(limit {MOE_LOSS_RTOL}), worst leaf norm {worst} "
                f"{norm_rel[worst]:.2e} (limit {MOE_GRAD_NORM_RTOL}), "
                f"worst leaf difference {worst_diff} "
                f"{diff_rel[worst_diff]:.2e} (limit {MOE_GRAD_DIFF_RTOL})")
        result["bf16_vs_fp32"] = {
            "loss_fp32": l32, "loss_rel": loss_rel, "worst_leaf": worst,
            "worst_leaf_norm_rel": norm_rel[worst],
            "worst_diff_leaf": worst_diff,
            "worst_leaf_diff_rel": diff_rel[worst_diff],
            "diff_norm_rel": diff_rel, "loss_rtol": MOE_LOSS_RTOL,
            "grad_norm_rtol": MOE_GRAD_NORM_RTOL,
            "grad_diff_rtol": MOE_GRAD_DIFF_RTOL}
        result["fp32_vs_plain"] = moe_plain_check(
            torch, dataclasses.replace(cfg, dtype=torch.float32), tree, dev,
            tok, tgt, l32, g32)
        result.update(pipe_record(run, {"launches_formula": want}))
        parallel_state.destroy_model_parallel()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# plan-sharded serving (serve.sharded, one card)

# 16 slots: a pipeline decode call's microbatches hold 8 rows each, inside
# the LayerNorm kernel's gate (JAX's: whole 8-row blocks)
SERVE_SLOTS = 16
# the first 8 of the engine phase's 16 requests (the phases' time: the
# per-op engines are host-bound, ≈ 1 s a request)
SERVE_REQUESTS = 8
SERVE_PP_PATH = ("the engine phase's GPT-2-124M bf16 requests through "
                 "build_engine(ServeConfig(num_slots=16, prefill_chunk=32, "
                 "plan=ParallelismPlan(pp=2))), both stages on the card")
SERVE_FSDP_PATH = ("the same requests through build_engine with "
                   "ParallelismPlan('fsdp', dp=1) on a one-rank NCCL group "
                   "(each layer's weights gathered from its resident shard "
                   "every call)")
# the int8 weight_gather engine's first prefill logits against the plain
# engine's (stated before the first run on the card): the largest logit
# difference within 5e-2 of the largest plain logit
FSDP_WG_LOGIT_RTOL = 5e-2


def plan_last_logits(torch, eng, tokens, chunk: int = 32):
    """Next-token logits after ``tokens`` through ``eng``'s per-op prefill
    program (its params, ``gather_layer`` and tp axis) into a fresh cache
    of its layout."""
    from apex_tpu_torch.serve import gpt_prefill_chunk, init_kv_cache

    dev = eng.device
    cache = init_kv_cache(eng.kv_cfg, dev)
    row = torch.arange(eng._blocks_per_slot, dtype=torch.int32, device=dev)
    logits = None
    for c in range(0, len(tokens), chunk):
        part = tokens[c:c + chunk]
        t = torch.zeros(chunk, dtype=torch.int32, device=dev)
        t[:len(part)] = torch.tensor(part, dtype=torch.int32, device=dev)
        cache, logits = gpt_prefill_chunk(eng.params, t, c, len(part), cache,
                                          row, eng.cfg, eng.kv_cfg,
                                          **eng._per_op_kw())
    return logits


def run_plan_engine(torch, ku, eng, requests):
    """Serve ``requests`` on ``eng`` (counts reset just before, read just
    after): the streams, the run's launches and wall seconds, and
    ``stats()``."""
    ku.reset_launch_counts()
    t0 = time.perf_counter()
    streams = eng.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return streams, ku.launch_counts(), wall, eng.stats()


def decode_call_launches(torch, ku, eng):
    """Kernel launches of one decode call of ``eng`` (every slot's row) once
    eight slots are decoding and no prompt is left to prefill."""
    from apex_tpu_torch.serve import Request

    for i in range(8):
        eng.submit(Request(f"p{i}", list(range(1 + i, 17 + i)),
                           max_new_tokens=24))
    while eng._pending or eng._prefill_queue:
        eng.step()
    torch.cuda.synchronize()
    ku.reset_launch_counts()
    eng.step()
    torch.cuda.synchronize()
    return ku.launch_counts()


def serve_plain_streams(torch, dev, params, cfg, requests):
    """The plain engine's per-op runs (``megakernel="off"``), greedy and
    ``spec_k = 3``: their streams, what the plan engines are held to, and
    figures."""
    return {k: serve(torch, params, cfg, dev, k, requests,
                     num_slots=SERVE_SLOTS, megakernel="off")
            for k in (0, 3)}


def per_op_decode_launches(cfg, rows: int, calls: int = 1):
    """A per-op decode call's launches over ``calls`` row groups of
    ``rows`` rows: paged attention a layer, LayerNorm twice a layer and
    once in the head where its gate takes the rows."""
    import importlib

    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    L = cfg.num_layers
    out = {"paged_mma_fwd": calls * L}
    if ln._pallas_ok(rows, cfg.hidden):
        out["layer_norm_fwd"] = calls * (2 * L + 1)
    return out


def serve_pp_phase(torch, dev, ku):
    """SERVE_PP_PATH: the greedy and ``spec_k = 3`` streams bitwise the
    plain engine's at ``megakernel="off"``; paged-attention and LN
    launches of one decode call (M microbatches through both stages:
    :func:`per_op_decode_launches` over M groups of 16 / M rows), the
    modelled and measured bubble, step ms."""
    from apex_tpu_torch.parallel import ParallelismPlan
    from apex_tpu_torch.serve import ServeConfig, build_engine
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    cfg = GPTConfig()
    params = init_gpt_params(cfg, seed=0, device=dev)
    requests = make_requests(cfg.vocab_size)[:SERVE_REQUESTS]
    runs = serve_plain_streams(torch, dev, params, cfg, requests)
    plain = {k: s for k, (s, _) in runs.items()}
    result = {"path": SERVE_PP_PATH, "runs": {}, "plain": {
        f"spec_k_{k}": {f: st[f] for f in ("steps", "decode_step_ms_p50",
                                           "tokens_per_s", "wall_s")}
        for k, (_, st) in runs.items()}}
    for k in (0, 3):
        eng = build_engine(params, cfg, ServeConfig(
            num_slots=SERVE_SLOTS, prefill_chunk=32, spec_k=k,
            plan=ParallelismPlan(pp=2)), device=dev, devices=[dev, dev])
        streams, launches, wall, st = run_plan_engine(torch, ku, eng,
                                                      requests)
        streams_equal(torch, f"serve_pp spec_k={k} vs the plain per-op "
                      f"engine", streams, plain[k], requests)
        result["runs"][f"spec_k_{k}"] = {
            "launches_run": launches, "wall_s": wall,
            "steps": st["steps"],
            "decode_step_ms_p50": st.get("decode_step_ms_p50"),
            "tokens_per_s": st.get("tokens_per_s"),
            **{f: st[f] for f in ("decode_kernel", "pp_microbatches",
                                  "pp_bubble_fraction",
                                  "pp_bubble_fraction_modeled",
                                  "pp_credit_waits", "hbm_model_bytes",
                                  "hbm_chip_bytes")}}
        del eng
    eng = build_engine(params, cfg, ServeConfig(
        num_slots=SERVE_SLOTS, prefill_chunk=32, plan=ParallelismPlan(pp=2)),
        device=dev, devices=[dev, dev])
    M = eng.stats()["pp_microbatches"]
    call = decode_call_launches(torch, ku, eng)
    want = per_op_decode_launches(cfg, SERVE_SLOTS // M, M)
    if call != want:
        raise AssertionError(f"serve_pp decode call launched {call}, the "
                             f"formula gives {want}")
    result["decode_call_launches"] = call
    del eng, params
    torch.cuda.empty_cache()
    return result, plain


def fsdp_codec_launches(cfg, wg):
    """Quantize and dequantize launches of one call of an fsdp engine with
    ``weight_gather=wg``: one each for every leaf of every layer whose
    gather is compressed (``wg.compresses``: the codec's kernels take
    every such shard on the card, ``CompressionConfig.quantize``)."""
    import math as _m

    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        gpt_param_specs,
    )

    h, f = cfg.hidden, cfg.ffn_hidden
    shapes = {"ln1_w": (h,), "ln1_b": (h,), "qkv_kernel": (h, 3 * h),
              "qkv_bias": (3 * h,), "out_kernel": (h, h), "out_bias": (h,),
              "ln2_w": (h,), "ln2_b": (h,), "fc1_kernel": (h, f),
              "fc1_bias": (f,), "fc2_kernel": (f, h), "fc2_bias": (h,)}
    assert set(shapes) == set(gpt_param_specs(cfg)["layers"])
    n_kernel = sum(wg.compresses(_m.prod(s)) for s in shapes.values())
    return {"quantize_blockwise[nearest]": cfg.num_layers * n_kernel,
            "dequantize_blockwise": cfg.num_layers * n_kernel}


def serve_fsdp_phase(torch, dev, ku, plain):
    """SERVE_FSDP_PATH: the greedy streams bitwise the plain per-op
    engine's, the first prefill logits too; with
    ``weight_gather=CompressionConfig(policy="int8")``, a decode call's
    quantize and dequantize launches the formula's
    (:func:`fsdp_codec_launches`) beside the layers' paged attention and
    LN, the first prefill logits within FSDP_WG_LOGIT_RTOL of the plain
    engine's; ``weight_gather_ms`` and the wire bytes reported."""
    from apex_tpu_torch.comm import CompressionConfig
    from apex_tpu_torch.parallel import ParallelismPlan
    from apex_tpu_torch.serve import InferenceEngine, ServeConfig, \
        build_engine
    from apex_tpu_torch.transformer.testing import GPTConfig, init_gpt_params

    cfg = GPTConfig()
    params = init_gpt_params(cfg, seed=0, device=dev)
    requests = make_requests(cfg.vocab_size)[:SERVE_REQUESTS]
    probe = requests[1].tokens[:40]
    base = InferenceEngine(params, cfg, ServeConfig(
        num_slots=SERVE_SLOTS, prefill_chunk=32, megakernel="off"),
        device=dev)
    want_logits = plan_last_logits(torch, base, probe)
    del base
    result = {"path": SERVE_FSDP_PATH, "runs": {}}
    wg8 = CompressionConfig(policy="int8")
    with OneRankGroup(torch, dev) as group:
        result["backend"] = group.backend
        for name, wg in (("none", None), ("int8", wg8)):
            plan = ParallelismPlan("fsdp", dp=1, weight_gather=wg)

            eng = build_engine(params, cfg, ServeConfig(
                num_slots=SERVE_SLOTS, prefill_chunk=32, plan=plan),
                device=dev)
            logits = plan_last_logits(torch, eng, probe)
            err = float((logits - want_logits).abs().max())
            scale = float(want_logits.abs().max())
            rec = {"first_logits_max_abs_err": err,
                   "first_logits_rel_of_max": err / scale}
            if wg is None:
                if not torch.equal(logits, want_logits):
                    raise AssertionError(f"serve_fsdp: first logits differ "
                                         f"from the plain engine's ({err})")
            elif not err <= FSDP_WG_LOGIT_RTOL * scale:
                raise AssertionError(
                    f"serve_fsdp int8 weight_gather: first logits max abs "
                    f"err {err:.3e} > {FSDP_WG_LOGIT_RTOL} x {scale:.3f}")
            if wg is None:
                # the whole run only without a codec (int8 weights move
                # the greedy streams: not a claim this phase makes)
                streams, launches, wall, st = run_plan_engine(torch, ku, eng,
                                                              requests)
                streams_equal(torch, "serve_fsdp vs the plain per-op engine",
                              streams, plain[0], requests)
                rec["run"] = {
                    "launches_run": launches, "wall_s": wall,
                    "steps": st["steps"],
                    "decode_step_ms_p50": st.get("decode_step_ms_p50"),
                    "tokens_per_s": st.get("tokens_per_s")}
            call = decode_call_launches(torch, ku, eng)
            st = eng.stats()
            rec.update({f: st[f] for f in (
                "decode_kernel", "plan_world", "hbm_model_bytes",
                "hbm_chip_bytes", "weight_gather_ms",
                "weight_gather_wire_bytes")})
            want = per_op_decode_launches(cfg, SERVE_SLOTS)
            if wg is not None:
                want.update(fsdp_codec_launches(cfg, wg))
            if call != want:
                raise AssertionError(f"serve_fsdp {name}: one decode call "
                                     f"launched {call}, the formula gives "
                                     f"{want}")
            rec["decode_call_launches"] = call
            result["runs"][name] = rec
            del eng
    del params
    torch.cuda.empty_cache()
    return result


def attach_fp16(kernels, ln_cases, lnb_cases, nrm, fa_cases, vl, lm_cases,
                adam, drop_cases):
    """Each kernel's fp16 cases under its entry's ``float16`` key (as its
    bf16 ones sit at the top level or by shape): by case, the largest
    error and the times (kernel, plain version, bound, the library call
    in fp16); untimed cases their error. Raises if a kernel a training
    path reaches (C4) has no fp16 case."""
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    rows = {}

    def add(kname, label, err, times=None):
        rows.setdefault(kname, {})[label] = {
            "max_abs_err": err,
            **({k: times[k] for k in timing} if times and "ms" in times
               else {})}

    f16 = "float16"
    for c in ln_cases:
        if c["dtype"] == f16:
            add("layer_norm_fwd", f"rows_{c['rows']}_h{c['hidden']}",
                c["max_abs_err"], c)
    for c in lnb_cases:
        if c["dtype"] == f16:
            add("layer_norm_bwd", f"rows_{c['rows']}_h{c['hidden']}",
                c["max_abs_err"], c)
    for c in nrm["cases"]:
        if c["x_dtype"] == f16:
            kname = "rms_norm" if c["kind"] == "rms" else "layer_norm"
            for key in ("fwd", "bwd"):
                add(f"{kname}_{key}", f"{c['shape']}_w_{c['w_dtype']}",
                    max(c["max_abs_err"], c["sum_max_abs_err"]), c[key])
    for c in fa_cases:
        if c["dtype"] != f16:
            continue
        prefix = ("flash_mma" if c["route"] == "tensor_core"
                  else "flash_attention")
        for key, kn in (("fwd", "fwd"), ("dq", "bwd_dq"), ("dkv", "bwd_dkv"),
                        ("dbias", "bwd_dbias")):
            if key in c:
                tail = "[bias]" if c["bias"] and key != "dbias" else ""
                add(f"{prefix}_{kn}{tail}", c["shape"],
                    c[key]["max_abs_err"], c[key])
    for c in vl["cases"]:
        if c["dtype"] == f16:
            for key in ("fwd", "dq", "dkv"):
                add(c["entries"][key], f"packed_d{c['head_dim']}_causal",
                    c[key]["max_abs_err"], c[key])
    for c in vl["wide"]:
        if c["dtype"] == f16:
            for kn in ("fwd", "bwd_dq", "bwd_dkv"):
                add(f"flash_varlen_{kn}", f"wide_d{c['head_dim']}",
                    c["max_abs_err"])
    for c in lm_cases:
        if c["dtype"] == f16:
            for key, kn in (("fwd", "fwd"), ("dx", "bwd_dx"),
                            ("dw", "bwd_dw")):
                add(f"lm_head_mma_{kn}", c["shape"], c[key]["max_abs_err"],
                    c[key])
    a = adam[f16]
    add("fused_adam_tail", a["per"], a["max_abs_err"], a)
    for c in drop_cases:
        if c["dtype"] == f16:
            add("hidden_dropout", c["shape"], c["max_abs_err"], c)
    c4 = [k["name"] for k in kernels if k["name"].startswith(
        ("layer_norm", "rms_norm", "flash_", "lm_head_mma",
         "fused_adam_tail", "hidden_dropout"))]
    missing = [n for n in c4 if n not in rows]
    if missing:
        raise AssertionError(f"no fp16 case for {missing}")
    for k in kernels:
        if k["name"] in rows:
            k[f16] = rows[k["name"]]


def attach_fp16_serving(kernels, pa, mk_cases, codec, e16):
    """C6: the serving kernels' and the codec's fp16 cases under each
    entry's ``float16`` key, with the fp16 main paths' launches (the
    fp16 engine's runs; the codec's fp16 runs): paged attention per pool
    format (decode 8 rows at the top, verify and prefill beside, the
    largest error over every fp16 case of the route, head dims included),
    the wide walk, the fused layer (decode, verify beside), quantize and
    dequantize (int8 at the top, int4 beside). Raises if one of them has
    no fp16 case."""
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    f16 = "float16"

    def pick(cases, **where):
        return next(c for c in cases
                    if all(c[k] == v for k, v in where.items()))

    def times(c, extra=()):
        return {k: c[k] for k in (*timing, *extra)}

    runs = {"none": e16["fp16_spec0"]["launches"],
            "int8": e16["fp16_int8_spec0"]["launches"],
            "int4": e16["fp16_int4_spec0"]["launches"]}
    every = pa["cases"] + pa["head_dims"]
    rows = {}
    for kvq in ("none", "int8", "int4"):
        mine = [x for x in every if x["dtype"] == f16 and x["kv"] == kvq
                and x["entry"] == "paged_mma_fwd"]
        rows["paged_mma_fwd" if kvq == "none" else
             f"paged_mma_fwd[{kvq}]"] = {
            "launches": runs[kvq].get("paged_mma_fwd", 0),
            "path": e16["path"],
            "max_abs_err": max(x["max_abs_err"] for x in mine),
            **times(pick(pa["cases"], dtype=f16, rows=8, kv=kvq)),
            **{kind: times(pick(pa["cases"], dtype=f16, kv=kvq, kind=kind))
               for kind in ("verify", "prefill")},
            "bitwise_over_groups_and_repeats": all(
                pick(pa["bitwise"], dtype=f16, kv=kvq, head_dim=SERVE_HD)[k]
                for k in ("groups_1", "groups_5", "repeat"))}
    wide = [x for x in pa["head_dims"] if x["dtype"] == f16
            and x["entry"] == "paged_wide_fwd"]
    rows["paged_wide_fwd"] = {
        "max_abs_err": max(x["max_abs_err"] for x in wide),
        **times(pick(wide, kv="none", head_dim=320)),
        **{f"d{x['head_dim']}_{x['kv']}": {
            "max_abs_err": x["max_abs_err"], **(times(x) if "ms" in x else {})}
            for x in wide}}
    mk16 = [c for c in mk_cases if c["dtype"] == f16]
    rows["megakernel"] = {
        "launches": runs["none"].get("megakernel", 0),
        "path": e16["path"],
        "max_abs_err": max(c["max_abs_err"] for c in mk16),
        **times(pick(mk16, kv="none", case="decode", head_dim=SERVE_HD,
                     slots=8), ("per_op_layer_ms",)),
        "verify": times(pick(mk16, kv="none", case="verify",
                             head_dim=SERVE_HD, slots=8),
                        ("per_op_layer_ms",)),
        "cases_checked": len(mk16)}
    ctiming = ("public_ms",)
    for mode in ("nearest", "stochastic"):
        kname = f"quantize_blockwise[{mode}]"
        mine = {x["bits"]: x for x in codec["cases"]
                if x["dtype"] == f16 and x["mode"] == mode}
        rows[kname] = {
            "launches": sum(r["launches"].get(kname, 0)
                            for r in codec["runs"] if r["dtype"] == f16),
            "max_abs_err": 0.0, "bitwise": True,
            "bitwise_fp32_path": True,
            **times(mine[8], ctiming),
            "int4": times(mine[4], ctiming),
            "main_path_pairs": {f"int{r['bits']}": {
                k: r[k] for k in ("pair_ms", "pair_bound_ms",
                                  "max_err_in_steps")}
                for r in codec["runs"] if r["dtype"] == f16
                and r["mode"] == mode}}
    deq = {x["bits"]: x["dequantize"] for x in codec["cases"]
           if x["dtype"] == f16 and "dequantize" in x}
    rows["dequantize_blockwise"] = {
        "launches": sum(r["launches"].get("dequantize_blockwise", 0)
                        for r in codec["runs"] if r["dtype"] == f16),
        "max_abs_err": 0.0, "bitwise": True,
        **times(deq[8], ctiming), "int4": times(deq[4], ctiming)}
    names = {k["name"] for k in kernels}
    missing = [n for n in rows if n not in names]
    if missing:
        raise AssertionError(f"no kernels-line entry for {missing}")
    for k in kernels:
        if k["name"] in rows:
            k[f16] = rows[k["name"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the full JSON record here")
    args = ap.parse_args(argv)
    # the resnet phase's deterministic cuBLAS needs a fixed workspace,
    # set before the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        import torch
    except ImportError:
        return _fail("torch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device: this script measures the port on a GPU")
    try:
        from apex_tpu_torch.ops import _kernel_util as ku
    except ImportError as e:
        return _fail(f"the apex_tpu_torch package is not beside this script "
                     f"({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()

    t0 = time.perf_counter()
    built, wait = start_builds(ku)
    # wall seconds of each phase, so a longer run says where it went
    seconds = {"build_wait": 0.0}

    def phase(name, sources, fn, *args):
        t = time.perf_counter()
        wait(*sources)
        seconds["build_wait"] += time.perf_counter() - t
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    # each kernel phase starts once its own sources are built, in the
    # order the builds end (quantize, dropout and fused_update build in
    # seconds, flash_attention.cu takes longest), so the phases run while
    # the slower sources still compile
    codec = phase("codec", ("quantize",), codec_phase, torch, dev, ku)
    drop_cases = phase("dropout", ("dropout",), dropout_phase, torch, dev, ku)
    adam = phase("adam_tail", ("fused_update",), adam_tail_phase, torch, dev)
    pa = phase("paged_attention", ("paged_attention", "paged_mma"),
               paged_attention_phase, torch, dev)
    pa_cases = pa["cases"]
    lm_cases = phase("lm_head_loss", ("lm_head_loss", "lm_head_mma"),
                     lm_head_phase, torch, dev)
    lm_shard = phase("lm_head_vocab_shard", ("lm_head_loss", "lm_head_mma"),
                     lm_head_shard_phase, torch, dev)
    ln_cases = phase("layer_norm", ("layer_norm",), layer_norm_phase, torch,
                     dev)
    ln_non_affine = phase("layer_norm_non_affine", ("layer_norm",),
                          layer_norm_non_affine_check, torch, dev, ku)
    lnb_cases = phase("layer_norm_bwd", ("layer_norm",),
                      layer_norm_bwd_phase, torch, dev)
    nrm = phase("rms_norm", ("layer_norm",), norm_phase, torch, dev, ku)
    mk_cases = phase("megakernel", ("megakernel", "paged_attention",
                                    "paged_mma", "layer_norm"),
                     megakernel_phase, torch, dev)
    fa_cases = phase("flash_attention", ("flash_attention", "flash_mma"),
                     flash_phase, torch, dev)
    ring = phase("ring_chunks", ("flash_attention", "flash_mma"),
                 ring_chunks_phase, torch, dev)
    vl = phase("flash_varlen", ("flash_attention", "flash_mma",
                                "flash_varlen", "flash_varlen_mma"),
               varlen_phase, torch, dev)
    vl["wide"] = phase("flash_varlen_wide", ("flash_varlen",),
                       varlen_wide_phase, torch, dev)
    wait()
    for name, b in built.items():
        for kernel, line in ptxas_lines(b["log"]):
            print(f"[nvcc {name}] {kernel}: {line}", file=sys.stderr)
    seconds["build_per_source"] = {name: b["seconds"]
                                   for name, b in built.items()}
    build_s = max(seconds["build_per_source"].values(), default=0.0)
    seconds["build"] = build_s
    kernel_s = sum(seconds[k] for k in (
        "layer_norm", "layer_norm_non_affine", "paged_attention",
        "layer_norm_bwd", "rms_norm", "codec", "flash_attention",
        "flash_varlen", "flash_varlen_wide", "lm_head_loss", "adam_tail",
        "megakernel", "dropout"))
    seconds["builds_and_kernel_phases"] = time.perf_counter() - t0
    engine, launches, quant_launches = phase("engine", (), engine_phase,
                                             torch, dev, ku)
    e16 = phase("engine_fp16", (), engine_fp16_phase, torch, dev, ku,
                engine["launches_per_call"])
    mon = phase("engine_monitor", (), engine_monitor_phase, torch, dev, ku,
                card)
    lora = phase("engine_lora", (), engine_lora_phase, torch, dev, ku, card)
    train = phase("train", (), train_phase, torch, dev, ku)
    seconds["train_parts"] = train["phase_s"]
    train_launches = train["launches_per_step"]
    trd = phase("train_dropout", (), train_dropout_phase, torch, dev, ku)
    t5 = phase("t5_train", (), t5_train_phase, torch, dev, ku)
    seconds["t5_train_parts"] = t5["phase_s"]
    t5_launches = t5["launches_per_step"]
    t5d = phase("t5_dropout", (), t5_dropout_phase, torch, dev, ku)
    fmha = phase("fmha", (), fmha_phase, torch, dev, ku)
    func = phase("functional", (), functional_phase, torch, dev)
    amp_res = phase("amp", (), amp_phase, torch, dev, ku)
    seconds["amp_parts"] = amp_res["phase_s"]
    amp16 = phase("amp_fp16", (), amp_fp16_phase, torch, dev, ku,
                  amp_res["o2"]["syncs_per_step"])
    bert = phase("bert", (), bert_phase, torch, dev, ku)
    mha = phase("multihead_attn", (), multihead_attn_phase, torch, dev, ku)
    trans = phase("transducer", (), transducer_phase, torch, dev, ku)
    asp = phase("asp", (), asp_phase, torch, dev, ku)
    resnet = phase("resnet", (), resnet_phase, torch, dev, ku)
    dcgan = phase("dcgan", (), dcgan_phase, torch, dev, ku)
    rnn = phase("rnn", (), rnn_phase, torch, dev, ku)
    ddp = phase("ddp", (), ddp_phase, torch, dev, ku)
    sbn = phase("syncbn_dp", (), syncbn_dp_phase, torch, dev, ku)
    zero1 = phase("zero1", (), zero1_phase, torch, dev, ku)
    fsdp = phase("fsdp", (), fsdp_phase, torch, dev, ku, zero1)
    dlamb = phase("dist_lamb", (), dist_lamb_phase, torch, dev, ku)
    tp = phase("tp", (), tp_phase, torch, dev, ku, train)
    t5_tp = phase("t5_tp", (), t5_tp_phase, torch, dev, ku, t5)
    pipe = phase("pipeline", (), pipeline_phase, torch, dev, ku)
    t5_pipe = phase("t5_pipeline", (), t5_pipeline_phase, torch, dev, ku, t5)
    moe = phase("moe", (), moe_phase, torch, dev, ku)
    spp, serve_plain = phase("serve_pp", (), serve_pp_phase, torch, dev, ku)
    sfs = phase("serve_fsdp", (), serve_fsdp_phase, torch, dev, ku,
                serve_plain)
    name = torch.cuda.get_device_name(0)
    # the phases' record, written before the kernels line is assembled
    record = {"card": card, "build_s": build_s, "kernel_phase_s": kernel_s,
              "engine_phase_s": seconds["engine"],
              "train_phase_s": seconds["train"], "seconds": seconds,
              "layer_norm": ln_cases, "paged_attention": pa,
              "layer_norm_bwd": lnb_cases, "flash_attention": fa_cases,
              "lm_head_loss": lm_cases, "adam_tail": adam,
              "megakernel": mk_cases, "flash_varlen": vl, "fmha": fmha,
              "layer_norm_non_affine": ln_non_affine, "norm": nrm,
              "codec": codec,
              "engine": engine, "engine_fp16": e16, "engine_monitor": mon,
              "engine_lora": lora, "train": train, "t5_train": t5,
              "dropout": drop_cases, "train_dropout": trd,
              "t5_dropout": t5d, "functional": func, "amp": amp_res,
              "amp_fp16": amp16, "bert": bert, "multihead_attn": mha,
              "transducer": trans, "asp": asp, "resnet": resnet,
              "dcgan": dcgan, "rnn": rnn, "ddp": ddp, "syncbn_dp": sbn,
              "zero1": zero1, "fsdp": fsdp, "dist_lamb": dlamb,
              "lm_head_vocab_shard": lm_shard, "ring_chunks": ring, "tp": tp,
              "t5_tp": t5_tp, "pipeline": pipe, "t5_pipeline": t5_pipe,
              "moe": moe, "serve_pp": spp, "serve_fsdp": sfs}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)

    def pick(cases, **where):
        return next(c for c in cases
                    if all(c[k] == v for k, v in where.items()))

    # the serving main path's shapes: bf16, 8 decode rows
    ln = pick(ln_cases, dtype="bfloat16", rows=8)
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # LN forward also runs on the training main path, at (8192, 768) with
    # its statistics: that path's launches and times beside the serving
    # path's
    ln_train = pick(ln_cases, dtype="bfloat16", rows=TRAIN_ROWS)

    def t5_entry(kname, cases, key=None, **where):
        """The T5 main path's launches of ``kname`` and, at its shapes
        (cases with ``where``), the largest error and the bf16 times of
        each (the first case's at the top level, the rest by rows)."""
        mine = [c for c in cases
                if all(c[k] == v for k, v in where.items())]
        bf = [c[key] if key else c for c in mine
              if c["dtype"] == "bfloat16"]
        out = {"launches": t5_launches[kname],
               "max_abs_err": max((c[key] if key else c)["max_abs_err"]
                                  for c in mine),
               **{k: bf[0][k] for k in timing}}
        for c, b in zip([c for c in mine if c["dtype"] == "bfloat16"][1:],
                        bf[1:]):
            out[f"rows_{c['rows']}"] = {k: b[k] for k in timing}
        return out

    kernels = [
        {"name": "layer_norm_fwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/layer_norm.cu",
         "replaces": "apex_tpu/ops/layer_norm.py:191",
         "design": NORM_FWD_DESIGN,
         "launches": launches.get("layer_norm_fwd", 0),
         "max_abs_err": max(c["max_abs_err"] for c in ln_cases),
         **{k: ln[k] for k in timing},
         "train": {"launches": train_launches["layer_norm_fwd"],
                   "rows": TRAIN_ROWS, "max_abs_err": ln_train["max_abs_err"],
                   "stats_max_abs_err": max(c["stats_max_abs_err"]
                                            for c in ln_cases if c["stats"]),
                   **{k: ln_train[k] for k in timing}},
         "t5": {"rows": list(T5_LN_ROWS), "hidden": T5_HIDDEN,
                **t5_entry("layer_norm_fwd", ln_cases, hidden=T5_HIDDEN)}},
    ]
    # Paged attention, one entry per route and pool format: bf16 on the
    # tensor cores (launched by the bf16 main path's prefill chunks, and
    # the int8 / int4 runs'), fp32 on the CUDA cores (the fp32 engine
    # runs' prefill chunks). Times at 8 decode rows, with the verify (8 x
    # 5) and prefill-chunk (1 x 32) calls beside them; errors over every
    # case of the route and format, head dims 80, 96 and 256 included.
    pm_info = paged_mma_kernel_info(ku, built)
    fp32_launches_of = {"none": engine["fp32_kernels"]["launches"],
                        "int8": engine["fp32_int8"]["launches"],
                        "int4": engine["fp32_int4"]["launches"]}
    bf16_launches_of = {"none": launches, **quant_launches}
    for entry, source, dname, runs in (
            ("paged_mma_fwd", "paged_mma", "bfloat16", bf16_launches_of),
            ("paged_attention_fwd", "paged_attention", "float32",
             fp32_launches_of)):
        for kvq in ("none", "int8", "int4"):
            c = pick(pa_cases, dtype=dname, rows=8, kv=kvq)
            mine = [x for x in pa_cases + pa["head_dims"]
                    if x["entry"] == entry and x["kv"] == kvq]
            kernels.append(
                {"name": entry if kvq == "none" else f"{entry}[{kvq}]",
                 "route": "cuda",
                 "source": f"apex_tpu_torch/csrc/{source}.cu",
                 "replaces": "apex_tpu/serve/decode.py:228",
                 "launches": runs[kvq].get(entry, 0),
                 "max_abs_err": max(x["max_abs_err"] for x in mine),
                 **{k: c[k] for k in timing},
                 **{kind: {k: pick(pa_cases, dtype=dname, kv=kvq,
                                   kind=kind)[k] for k in timing}
                    for kind in ("verify", "prefill")},
                 "head_dims_checked": sorted({x["head_dim"] for x in mine}),
                 "bitwise_over_groups_and_repeats": all(
                     pick(pa["bitwise"], dtype=dname, kv=kvq,
                          head_dim=SERVE_HD)[k]
                     for k in ("groups_1", "groups_5", "repeat")),
                 **(pm_info["fwd"] if entry == "paged_mma_fwd" else {})})
    # The wide walk (head_dim > 256, both types): launched by the head_dim
    # 320 GPT's per-op serving runs (counts reset just before each, read
    # just after); timed at the verify call, bf16 d320 at the top level,
    # every wide head dim, type and pool format beside it.
    wide = [x for x in pa["head_dims"] if x["entry"] == "paged_wide_fwd"]
    w320 = pick(wide, dtype="bfloat16", kv="none", head_dim=320)
    hd320 = engine["head_dim_320"]
    kernels.append(
        {"name": "paged_wide_fwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/paged_attention.cu",
         "replaces": "apex_tpu/serve/decode.py:228",
         "launches": hd320["bfloat16_off"]["launches"].get(
             "paged_wide_fwd", 0),
         "launches_fp32": hd320["float32_off"]["launches"].get(
             "paged_wide_fwd", 0),
         "path": "InferenceEngine, GPT 2 x 320 heads, per-op",
         "shape": "verify 8 x 5 rows, 12 heads, d 320, bf16",
         "max_abs_err": max(x["max_abs_err"] for x in wide),
         **{k: w320[k] for k in timing},
         **{f"d{x['head_dim']}_{x['dtype']}_{x['kv']}": {
             "max_abs_err": x["max_abs_err"],
             **{k: x[k] for k in timing if k in x}}
            for x in wide if x is not w320},
         "bitwise_over_groups_and_repeats": all(
             x[k] for x in pa["bitwise"] if x["head_dim"] != SERVE_HD
             for k in ("groups_1", "groups_5", "repeat"))})
    # the fused layer: launched by the serving main path's decode calls;
    # timed for bf16 decode at 8 rows (GPT-2-124M), verify (8 x 5) beside
    # it; its comparator is the per-op layer; the tensor cores' proof
    mk = pick(mk_cases, dtype="bfloat16", kv="none", case="decode",
              head_dim=SERVE_HD, slots=8)
    mkv = pick(mk_cases, dtype="bfloat16", kv="none", case="verify",
               head_dim=SERVE_HD, slots=8)
    kernels.append(
        {"name": "megakernel", "route": "cuda",
         "source": "apex_tpu_torch/csrc/megakernel.cu",
         "replaces": "apex_tpu/serve/megakernel.py:668",
         "launches": launches.get("megakernel", 0),
         "max_abs_err": max(c["max_abs_err"] for c in mk_cases),
         "per_op_layer_ms": mk["per_op_layer_ms"],
         **{k: mk[k] for k in timing},
         "verify": {k: mkv[k] for k in (*timing, "per_op_layer_ms")},
         "cases_checked": len(mk_cases),
         **megakernel_kernel_info(ku, built)})
    # the training main path's shapes: bf16, LN (8192, 768), attention
    # (96, 1024, 64) causal
    lnb = pick(lnb_cases, dtype="bfloat16", rows=TRAIN_ROWS)
    kernels.append(
        {"name": "layer_norm_bwd", "route": "cuda",
         "source": "apex_tpu_torch/csrc/layer_norm.cu",
         "replaces": "apex_tpu/ops/layer_norm.py:224",
         "design": NORM_BWD_DESIGN,
         "launches": train_launches["layer_norm_bwd"],
         "max_abs_err": max(c["max_abs_err"] for c in lnb_cases),
         **{k: lnb[k] for k in timing},
         "t5": {"rows": list(T5_LN_ROWS), "hidden": T5_HIDDEN,
                **t5_entry("layer_norm_bwd", lnb_cases, hidden=T5_HIDDEN)}})
    # the repaired LayerNorm: bf16 x with an fp32 weight at GPT-2's training
    # rows (launched once each by MixedFusedLayerNorm on the main path) and
    # GPT-3's width, beside each LN kernel's own entry
    ln_run = pick(nrm["runs"], name="gpt2_ln")
    for entry in kernels:
        if entry["name"] in ("layer_norm_fwd", "layer_norm_bwd"):
            key = entry["name"][-3:]
            for label, shape, xt, wt in (
                    ("mixed", "gpt2", "bfloat16", "float32"),
                    ("mixed_t5", "t5_small", "bfloat16", "float32"),
                    ("wide", "wide", "bfloat16", "bfloat16"),
                    ("wide_mixed", "wide", "bfloat16", "float32")):
                c = pick(nrm["cases"], kind="ln", shape=shape, x_dtype=xt,
                         w_dtype=wt)
                entry[label] = {"rows": c["rows"], "hidden": c["hidden"],
                                "max_abs_err": c["max_abs_err"],
                                **{k: c[key][k] for k in timing}}
            entry["mixed"]["module_launches"] = ln_run["launches"][
                entry["name"]]
    # RMSNorm (B #3-4): launched by the main path's MixedFusedRMSNorm at
    # GPT-2's training rows (bf16 x, fp32 weight), timed there; the other
    # shapes and types beside it
    rms_run = pick(nrm["runs"], name="gpt2")
    rms_main = pick(nrm["cases"], kind="rms", shape="gpt2",
                    x_dtype="bfloat16", w_dtype="float32")
    for key, kname, line in (("fwd", "rms_norm_fwd", 262),
                             ("bwd", "rms_norm_bwd", 292)):
        kernels.append(
            {"name": kname, "route": "cuda",
             "source": "apex_tpu_torch/csrc/layer_norm.cu",
             "replaces": f"apex_tpu/ops/layer_norm.py:{line}",
             "design": NORM_BWD_DESIGN if key == "bwd" else NORM_FWD_DESIGN,
             "launches": rms_run["launches"][kname],
             "path": "normalization.MixedFusedRMSNorm",
             "shape": f"({rms_main['rows']}, {rms_main['hidden']}) bf16 x, "
                      f"fp32 weight",
             "max_abs_err": max(c["max_abs_err"] for c in nrm["cases"]
                                if c["kind"] == "rms"),
             **{k: rms_main[key][k] for k in timing},
             **{f"{c['shape']}_{c['x_dtype']}_{c['w_dtype']}": {
                 "rows": c["rows"], "hidden": c["hidden"],
                 **{k: c[key][k] for k in timing}}
                for c in nrm["cases"] if c["kind"] == "rms"
                and c is not rms_main}})
    # the codec (B #16-18): launched by the main path's quantize_blockwise
    # and _int4 pairs on GPT-2-124M's fp32 gradient, timed there (int8,
    # block 256); bf16 and int4 (packed in the kernels) beside it, each
    # with its public entry point's time; no single PyTorch call computes
    # it (library_ms null)
    codec_timing = timing + ("public_ms",)
    for mode, line in (("nearest", 213), ("stochastic", 201)):
        kname = f"quantize_blockwise[{mode}]"
        c = pick(codec["cases"], dtype="float32", bits=8, mode=mode)
        kernels.append(
            {"name": kname, "route": "cuda",
             "source": "apex_tpu_torch/csrc/quantize.cu",
             "replaces": f"apex_tpu/comm/quantize.py:{line}",
             "launches": sum(r["launches"].get(kname, 0)
                             for r in codec["runs"]
                             if r["dtype"] == "float32"),
             "path": "comm.quantize_blockwise(_int4)",
             "shape": f"{c['elements']} elements fp32, int8, block 256",
             "max_abs_err": 0.0, "bitwise": True,
             **{k: c[k] for k in codec_timing},
             **{f"{x['dtype']}_int{x['bits']}": {k: x[k]
                                                 for k in codec_timing}
                for x in codec["cases"] if x["mode"] == mode
                and x is not c}})
    deq = {(x["dtype"], x["bits"]): x["dequantize"] for x in codec["cases"]
           if "dequantize" in x}
    kernels.append(
        {"name": "dequantize_blockwise", "route": "cuda",
         "source": "apex_tpu_torch/csrc/quantize.cu",
         "replaces": "apex_tpu/comm/quantize.py:226",
         "launches": sum(r["launches"].get("dequantize_blockwise", 0)
                         for r in codec["runs"] if r["dtype"] == "float32"),
         "path": "comm.dequantize_blockwise(_int4)",
         "shape": f"{codec['cases'][0]['elements']} codes, block 256",
         "max_abs_err": 0.0, "bitwise": True,
         **{k: deq["float32", 8][k] for k in codec_timing},
         **{f"{d}_int{b}": {k: v[k] for k in codec_timing}
            for (d, b), v in deq.items() if (d, b) != ("float32", 8)}})
    # The flash kernels. Main paths: the bf16 GPT and T5 steps run the
    # tensor-core forward, dQ, dK/dV and d(bias) (flash_mma_*); their
    # launches and bf16 times at the steps' shapes (GPT's flagship, T5's
    # cross-attention, the bias kernels at T5's encoder with the decoder
    # beside it) and at the other FLASH_SHAPES. The CUDA-core kernels now
    # run fp32 inputs and head_dim above 256: their launches from the fp32
    # train checks (counts reset just before, read just after), fp32 times
    # at the same shapes, bf16 at D = 512-2048 and above (the wide kernels).
    def flash_case(shape, dtype="bfloat16"):
        return pick(fa_cases, dtype=dtype, shape=shape)

    def rows_of(key, shapes, dtype="bfloat16"):
        return {(shape if dtype == "bfloat16" else f"{shape}_fp32"): {
            "route": flash_case(shape, dtype)["route"],
            "max_abs_err": flash_case(shape, dtype)[key]["max_abs_err"],
            **{k: flash_case(shape, dtype)[key][k] for k in timing}}
            for shape in shapes}

    def errs(key, route, bias):
        return max(c[key]["max_abs_err"] for c in fa_cases
                   if c["route"] == route and c["bias"] == bias)

    plain_shapes = ("gpt_d128", "d40", "tail_causal", *D256_SHAPES[:2])
    bias_shapes = ("tail_bias", *D256_SHAPES[2:])
    fp32_launches = train["fp32_check"]["launches"]
    t5_fp32_launches = t5["fp32_check"]["launches"]
    mma_info = mma_kernel_info(ku, built)
    for key, kname, line in (("fwd", "flash_mma_fwd", 297),
                             ("dq", "flash_mma_bwd_dq", 532),
                             ("dkv", "flash_mma_bwd_dkv", 570)):
        common = {"route": "cuda",
                  "source": "apex_tpu_torch/csrc/flash_mma.cu",
                  "replaces": f"apex_tpu/ops/attention.py:{line}",
                  **mma_info[key]}
        kernels.append(
            {"name": kname, **common, "launches": train_launches[kname],
             "max_abs_err": errs(key, "tensor_core", False),
             **{k: flash_case("flagship")[key][k] for k in timing},
             "t5_cross": {"launches": t5_launches[kname]
                          - t5_launches[f"{kname}[bias]"],
                          **rows_of(key, ("t5_cross",))["t5_cross"]},
             **rows_of(key, ("non_causal", "dropout", *plain_shapes))})
        kernels.append(
            {"name": f"{kname}[bias]", **common,
             "launches": t5_launches[f"{kname}[bias]"], "path": "t5_train",
             "shape": "t5_enc (64, 512, 512, 64) bias (8, 512, 512)",
             "max_abs_err": errs(key, "tensor_core", True),
             **{k: flash_case("t5_enc")[key][k] for k in timing},
             **rows_of(key, ("t5_dec", *bias_shapes))})
    kernels.append(
        {"name": "flash_mma_bwd_dbias", "route": "cuda",
         "source": "apex_tpu_torch/csrc/flash_mma.cu",
         "replaces": "apex_tpu/ops/attention.py:607", **mma_info["dbias"],
         "launches": t5_launches["flash_mma_bwd_dbias"], "path": "t5_train",
         "shape": "t5_enc (64, 512, 512, 64) bias (8, 512, 512)",
         "max_abs_err": errs("dbias", "tensor_core", True),
         **{k: flash_case("t5_enc")["dbias"][k] for k in timing},
         **rows_of("dbias", ("t5_dec", *bias_shapes))})
    for key, kname, line in (("fwd", "flash_attention_fwd", 297),
                             ("dq", "flash_attention_bwd_dq", 532),
                             ("dkv", "flash_attention_bwd_dkv", 570)):
        common = {"route": "cuda",
                  "source": "apex_tpu_torch/csrc/flash_attention.cu",
                  "replaces": f"apex_tpu/ops/attention.py:{line}"}
        kernels.append(
            {"name": kname, **common, "launches": fp32_launches[kname],
             "path": "train fp32 check (fp32 inputs; head_dim above 256)",
             "shape": "flagship (96, 1024, 64) fp32",
             "max_abs_err": errs(key, "cuda_core", False),
             **{k: flash_case("flagship", "float32")[key][k]
                for k in timing},
             **rows_of(key, ("t5_cross", *plain_shapes), "float32"),
             **rows_of(key, D_WIDE_SHAPES),
             **rows_of(key, D_WIDE_SHAPES, "float32")})
        kernels.append(
            {"name": f"{kname}[bias]", **common,
             "launches": t5_fp32_launches[f"{kname}[bias]"],
             "path": "t5 fp32 check", "shape": "t5_enc fp32",
             "max_abs_err": errs(key, "cuda_core", True),
             **{k: flash_case("t5_enc", "float32")[key][k] for k in timing},
             **rows_of(key, D_WIDE_BIAS_SHAPES),
             **rows_of(key, D_WIDE_BIAS_SHAPES, "float32")})
    kernels.append(
        {"name": "flash_attention_bwd_dbias", "route": "cuda",
         "source": "apex_tpu_torch/csrc/flash_attention.cu",
         "replaces": "apex_tpu/ops/attention.py:607",
         "launches": t5_fp32_launches["flash_attention_bwd_dbias"],
         "path": "t5 fp32 check", "shape": "t5_enc fp32",
         "max_abs_err": errs("dbias", "cuda_core", True),
         **{k: flash_case("t5_enc", "float32")["dbias"][k] for k in timing},
         **rows_of("dbias", ("t5_dec", "tail_bias"), "float32"),
         **rows_of("dbias", D_WIDE_BIAS_SHAPES),
         **rows_of("dbias", D_WIDE_BIAS_SHAPES, "float32")})
    # the packed path's kernels: launches of one bf16 causal forward plus
    # backward through FMHA; times at its shape, bf16 causal, with the
    # bidirectional times, PyTorch's varlen flash attention and the dense
    # causal flash kernels beside them. bf16 up to head_dim 256 runs the
    # tensor-core kernels; the CUDA-core ones now run fp32 (launched by
    # the fp32 FMHA run, timed fp32) and bf16 above 256 (d512)
    vc = pick(vl["cases"], dtype="bfloat16", causal=True, head_dim=PACK_D)
    vb = pick(vl["cases"], dtype="bfloat16", causal=False, head_dim=PACK_D)
    v256 = pick(vl["cases"], dtype="bfloat16", head_dim=256)
    v512 = pick(vl["cases"], dtype="bfloat16", head_dim=512)
    vc32 = pick(vl["cases"], dtype="float32", causal=True, head_dim=PACK_D)
    vb32 = pick(vl["cases"], dtype="float32", causal=False, head_dim=PACK_D)
    main_run = pick(fmha["runs"], dtype="bfloat16", causal=True)
    fp32_run = pick(fmha["runs"], dtype="float32", causal=True)
    packed = (f"packed (1, {vc['heads']}, {vc['tokens']}, {vc['head_dim']}), "
              f"{vc['documents']} documents, causal")

    def varlen_err(key, entry):
        """The largest error of ``entry``: its cases, the misaligned front
        door in the types it runs, and (CUDA cores) the wide kernels."""
        mma = "mma" in entry
        return max([c[key]["max_abs_err"] for c in vl["cases"]
                    if c["entries"][key] == entry]
                   + [c["max_abs_err"] for c in vl["misaligned"]
                      if (c["dtype"] == "bfloat16") == mma]
                   + ([] if mma else [c["max_abs_err"] for c in vl["wide"]]))

    def varlen_rows(key, case):
        return {"heads": case["heads"], "causal": case["causal"],
                **{k: case[key][k] for k in timing},
                "varlen_library_ms": case[key]["varlen_library_ms"],
                "tables_ms": case["tables_ms"],
                "ms_tables_in_call": case[key]["ms_tables_in_call"]}

    vl_info = varlen_mma_kernel_info(ku, built)
    for key, kernel, line in (("fwd", "fwd", 377), ("dq", "bwd_dq", 414),
                              ("dkv", "bwd_dkv", 451)):
        mma, core = f"flash_varlen_mma_{kernel}", f"flash_varlen_{kernel}"
        kernels.append(
            {"name": mma, "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_varlen_mma.cu",
             "replaces": f"apex_tpu/ops/attention_varlen.py:{line}",
             **vl_info[key],
             "launches": main_run["launches"][mma], "path": "fmha",
             "shape": packed, "max_abs_err": varlen_err(key, mma),
             "bitwise_repeat": True,
             **{k: vc[key][k] for k in timing},
             "varlen_library_ms": vc[key]["varlen_library_ms"],
             "varlen_library_api": vc["varlen_library"]["api"],
             "tables_ms": vc["tables_ms"],
             "ms_tables_in_call": vc[key]["ms_tables_in_call"],
             "dense_causal_flash_ms": vc[key]["dense_causal_flash_ms"],
             "ratio_to_dense_causal_flash":
                 vc[key]["ratio_to_dense_causal_flash"],
             "bidirectional": varlen_rows(key, vb),
             "d256": varlen_rows(key, v256)})
        kernels.append(
            {"name": core, "route": "cuda",
             "source": "apex_tpu_torch/csrc/flash_varlen.cu",
             "replaces": f"apex_tpu/ops/attention_varlen.py:{line}",
             "launches": fp32_run["launches"][core],
             "path": "fmha fp32 (fp32 inputs; bf16 above head_dim 256)",
             "shape": packed + " fp32", "max_abs_err": varlen_err(key, core),
             "bitwise_repeat": True,
             **{k: vc32[key][k] for k in timing},
             "tables_ms": vc32["tables_ms"],
             "ms_tables_in_call": vc32[key]["ms_tables_in_call"],
             "bidirectional_fp32": varlen_rows(key, vb32),
             "d512": varlen_rows(key, v512),
             "wide": {f"d{c['head_dim']}_{c['dtype']}": c["max_abs_err"]
                      for c in vl["wide"]}})
    # the fused loss at the training shape (8192, 768, 50304) bf16: the
    # tensor-core forward, dX and dW, with T5's shape beside it; the
    # CUDA-core forward, dX and dW now run fp32 inputs: their launches from
    # the fp32 train check, fp32 times at the same shapes
    lm_shape = {"train": pick(lm_cases, dtype="bfloat16", shape="train"),
                "t5": pick(lm_cases, dtype="bfloat16", shape="t5")}
    lm_fp32 = pick(lm_cases, dtype="float32", shape="train")
    lm_info = lm_mma_kernel_info(ku, built)
    t5_shape = [lm_shape["t5"][k] for k in ("rows", "hidden", "vocab")]
    lm_c1 = pick(lm_cases, dtype="float32", shape=LM_FP64)["dx_vs_fp64"]
    for key, kname, line in (("fwd", "lm_head_mma_fwd", 198),
                             ("dx", "lm_head_mma_bwd_dx", 244),
                             ("dw", "lm_head_mma_bwd_dw", 263)):
        kernels.append(
            {"name": kname, "route": "cuda",
             "source": "apex_tpu_torch/csrc/lm_head_mma.cu",
             "replaces": f"apex_tpu/ops/lm_head_loss.py:{line}",
             "launches": train_launches[kname],
             "max_abs_err": max(c[key]["max_abs_err"] for c in lm_cases
                                if c["dtype"] == "bfloat16"),
             **{k: lm_shape["train"][key][k] for k in timing},
             "t5": {"shape": t5_shape,
                    **t5_entry(kname, lm_cases, key, shape="t5",
                               dtype="bfloat16")},
             **lm_info[key]})
    for key, kname, line in (("fwd", "lm_head_loss_fwd", 198),
                             ("dx", "lm_head_loss_bwd_dx", 244),
                             ("dw", "lm_head_loss_bwd_dw", 263)):
        kernels.append(
            {"name": kname, "route": "cuda",
             "source": "apex_tpu_torch/csrc/lm_head_loss.cu",
             "replaces": f"apex_tpu/ops/lm_head_loss.py:{line}",
             "launches": fp32_launches[kname],
             "path": "train fp32 check (fp32 inputs)",
             "shape": "train (8192, 768, V 50304) fp32",
             "max_abs_err": max(c[key]["max_abs_err"] for c in lm_cases
                                if c["dtype"] == "float32"),
             **{k: lm_fp32[key][k] for k in timing},
             **({"wide_vs_fp64": lm_c1} if key == "dx" else {})})
    kernels.append(
        {"name": "fused_adam_tail", "route": "cuda",
         "source": "apex_tpu_torch/csrc/fused_update.cu",
         "replaces": "apex_tpu/ops/fused_update.py:160",
         "launches": train_launches["fused_adam_tail"],
         "max_abs_err": adam["max_abs_err"], "per": adam["per"],
         **{k: adam[k] for k in timing},
         "t5": {"launches": t5_launches["fused_adam_tail"],
                **{k: adam["t5"][k] for k in ("max_abs_err", "per",
                                              *timing)}}})
    # the hidden-dropout kernel: no TPU counterpart (JAX's dropout is XLA);
    # its main path is the dots_attn dropout step's
    gd = pick(drop_cases, shape="gpt", dtype="bfloat16")
    td = pick(drop_cases, shape="t5", dtype="bfloat16")
    drop_extra = ("f_dropout_ms_not_the_same_function", "bound_formula",
                  "bytes_bound_ms", "ops_bound_ms")
    drop_sass = sass_opcode_counts(ku, "dropout", "dropout_kernel")
    kernels.append(
        {"name": "hidden_dropout", "route": "cuda",
         "source": "apex_tpu_torch/csrc/dropout.cu",
         "replaces": "none: XLA's bernoulli + where of JAX's _hidden_dropout "
                     "(apex_tpu/transformer/testing/standalone_gpt.py:314)",
         "launches": trd["policies"]["dots_attn"]["launches_per_step"][
             "hidden_dropout"],
         "path": "build_train_step(GPTConfig(attention_dropout=0.1, "
                 "hidden_dropout=0.1, remat_policy='dots_attn'), 8, 1024)",
         "shape": "(8, 1024, 768) bf16",
         "max_abs_err": max(c["max_abs_err"] for c in drop_cases),
         **{k: gd[k] for k in (*timing, *drop_extra)},
         "cases": [{k: c[k] for k in ("shape", "dtype", "elements", "ms",
                                      "plain_ms", "bound_ms", "bound_by",
                                      "keep_share",
                                      "f_dropout_ms_not_the_same_function")}
                   for c in drop_cases],
         "t5": {"launches": t5d["launches_per_step"]["hidden_dropout"],
                "shape": "(8, 512, 512) bf16",
                **{k: td[k] for k in (*timing, *drop_extra)}},
         "sass_opcodes": drop_sass})
    for run in ("fp32_kernels", "fp32_plain", "fp32_off", "fp32_int8",
                "fp32_int8_off", "fp32_int4", "fp32_int4_off", "bf16_spec0",
                "bf16_spec4", "bf16_int8_spec0", "bf16_int8_spec4",
                "bf16_int4_spec0", "bf16_int4_spec4", "bf16_off"):
        e = engine[run]
        print(f"{run} ({e['decode_kernel']}, kv_bits {e['kv_bits']}, pools "
              f"{e['kv_cache_bytes']} B): tokens/s {e['tokens_per_s']} "
              f"ttft_ms_p50 {e['ttft_ms_p50']} decode_step_ms_p50 "
              f"{e['decode_step_ms_p50']} on {card}")
    for key in ("decode", "verify"):
        print(f"launches per {key} call (fused): "
              f"{engine['launches_per_call'][key]['launches']}")
    for key in ("bf16_profile", "bf16_profile_off"):
        pr = engine[key]
        print(f"{key} ({pr['decode_kernel']}): {pr['steps']} steps wall "
              f"{pr['wall_ms']:.2f} ms, device busy {pr['device_busy_ms']:.2f}"
              f" ms (share {pr['device_busy_share_of_unprofiled_wall']:.3f})")
        for t in pr["top"][:6]:
            print(f"  top kernel: {t['device_ms']:.3f} ms x{t['count']} "
                  f"{t['name']}")
    for c in mk_cases:
        times = (f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, per-op "
                 f"layer {c['per_op_layer_ms']:.4f}, bound "
                 f"{c['bound_ms']:.4f} {c['bound_by']})" if "ms" in c
                 else "checked, not timed")
        print(f"megakernel {c['case']} {c['kv']} {c['dtype']} head_dim "
              f"{c['head_dim']} rows {c['rows']}: {times}; x' err "
              f"{c['max_abs_err']:.3e}, K/V err {c['kv_max_abs_err']:.3e}, "
              f"codes differ {c['codes_differ']}")
    for c in pa_cases:
        print(f"{c['entry']} {c['kind']} {c['kv']} {c['dtype']} rows "
              f"{c['rows']} (groups of {c['rows_per_table']}, ctx sum "
              f"{c['ctx_sum']}): {c['ms']:.4f} ms (plain "
              f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, bound "
              f"{c['bound_ms']:.5f}); err {c['max_abs_err']:.3e} on {card}")
    for c in pa["head_dims"]:
        times = (f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, library "
                 f"{c['library_ms']:.4f}, bound {c['bound_ms']:.5f})"
                 if "ms" in c else "checked, not timed")
        print(f"{c['entry']} head_dim {c['head_dim']} verify {c['kv']} "
              f"{c['dtype']}: {times}; err {c['max_abs_err']:.3e} on "
              f"{card}")
    print(f"paged groups 32 / 5 / 1 and repeats bitwise: {pa['bitwise']}")
    pp = engine["bf16_prefill_profile"]
    print(f"per-op prefill chunks bf16 ({pp['chunks']} of 32 tokens): host "
          f"{pp['host_ms_per_chunk']:.3f} ms a chunk, device busy "
          f"{pp['device_busy_ms_per_chunk']:.3f} ms, paged attention "
          f"{pp['paged_device_ms_per_chunk']:.4f} ms "
          f"({pp['paged_share_of_busy']:.3f} of busy) on {card}")
    for hd, dname in itertools.product((80, 320), ("float32", "bfloat16")):
        e = engine[f"head_dim_{hd}"][dname]
        print(f"head_dim {hd} {dname} ({e['decode_kernel']}): tokens/s "
              f"{e['tokens_per_s']} launches {e['launches']}")
    fp, prof = train["fp32_check"], train["profile_3_steps"]
    print(f"train fp32 check (batch 2 x 1024): loss kernels "
          f"{fp['loss_kernels']} plain {fp['loss_plain']} grad max rel err "
          f"{fp['grad_max_rel_err']:.3e}")
    print(f"train bf16 batch 8 x 1024: tokens/s {train['tokens_per_s']:.1f} "
          f"step_ms_p50 {train['step_ms_p50']:.2f} mfu(6N) "
          f"{train['mfu_6n']:.4f} mfu(bench.py) {train['mfu_bench_py']:.4f} "
          f"peak {train['peak_mem_gib']:.2f} GiB busy share "
          f"{prof['device_busy_share_of_unprofiled_wall']:.3f} (of the "
          f"profiled wall {1 - prof['device_idle_share']:.3f}) "
          f"losses {[round(v, 4) for v in train['losses']]} on {card}")
    for what, chk in (("train", train["bf16_check"]),
                      ("t5", t5["bf16_check"])):
        print(f"{what} bf16 check (batch 2): loss kernels "
              f"{chk['loss_kernels']} plain {chk['loss_plain']} (rel "
              f"{chk['loss_rel_err']:.3e}, limit {chk['loss_rtol']}); grad "
              f"max |k - p| / |p| {chk['grad_max_norm_rel_err']:.3e} at "
              f"{chk['grad_worst_leaf']} (limit {chk['grad_norm_rtol']})")
    un = train["unfused_step"]
    print(f"train bf16 tokens/s: default step (fused loss, fused Adam tail) "
          f"{train['tokens_per_s']:.1f}, unfused step (fused_loss=False, "
          f"fused_tail='off') {un['tokens_per_s']:.1f} (step_ms_p50 "
          f"{train['step_ms_p50']:.2f} vs {un['step_ms_p50']:.2f}; device "
          f"busy ms per step {prof['device_busy_ms'] / 3:.2f} vs "
          f"{un['device_busy_ms_per_step']:.2f}) on {card}")
    for t in prof["top"]:
        print(f"  train top kernel: {t['device_ms']:.2f} ms x{t['count']} "
              f"{t['name']}")
    for c in fa_cases:
        keys = ("fwd", "dq", "dkv") + (("dbias",) if c["bias"] else ())
        text = ", ".join(f"{k} err {c[k]['max_abs_err']:.3e}" for k in keys)
        text += "; " + " ".join(
            f"{k} {c[k]['ms']:.4f} ms (plain {c[k]['plain_ms']:.4f}, "
            f"library {c[k]['library_ms']:.4f}, bound "
            f"{c[k]['bound_ms']:.4f} {c[k]['bound_by']})" for k in keys)
        print(f"flash {c['shape']} {c['dtype']} route {c['route']} (b "
              f"{c['batch']}, heads {c['heads']}, {c['sq']} x {c['sk']}, "
              f"d {c['head_dim']}, causal {c['causal']}, bias {c['bias']}):"
              f" {text}")
    for what, infos in (("flash", mma_info), ("lm_head", lm_info),
                        ("flash_varlen", vl_info)):
        for key, info in infos.items():
            print(f"tensor-core {what} {key} HMMA/HGMMA per instantiation: "
                  f"{info['sass_hmma']}")
            for line in info["ptxas"]:
                print(f"  ptxas {line}")
    for c in vl["cases"]:
        text = " ".join(
            f"{k} {c[k]['ms']:.4f} ms (plain {c[k]['plain_ms']:.4f}, library "
            f"{c[k]['library_ms']:.4f}, varlen library "
            f"{c[k]['varlen_library_ms'] or float('nan'):.4f}, bound "
            f"{c[k]['bound_ms']:.4f} {c[k]['bound_by']}, dense causal flash "
            f"{c[k].get('dense_causal_flash_ms', float('nan')):.4f}) err "
            f"{c[k]['max_abs_err']:.3e}" for k in ("fwd", "dq", "dkv"))
        text += "; tables built in the call: " + ", ".join(
            f"{k} {c[k]['ms_tables_in_call']:.4f} ms"
            for k in ("fwd", "dq", "dkv"))
        print(f"flash_varlen {'causal' if c['causal'] else 'bidirectional'} "
              f"{c['dtype']} (1, {c['heads']}, {c['tokens']}, "
              f"{c['head_dim']}; {c['documents']} documents, "
              f"{c['pad_tokens']} pad; {'/'.join(c['entries'].values())}"
              f", tables "
              f"{c['tables_ms']:.4f} ms): {text} on {card}")
        if c["varlen_library"]["api"] or "error" in c["varlen_library"]:
            print(f"  varlen library: {c['varlen_library']}")
    for c in vl["misaligned"]:
        print(f"flash_varlen misaligned T={c['tokens']} causal {c['causal']} "
              f"{c['dtype']}: kernels vs plain err {c['max_abs_err']:.3e}")
    for c in vl["wide"]:
        print(f"flash_varlen wide d {c['head_dim']} causal {c['causal']} "
              f"{c['dtype']} (1, {c['heads']}, {c['tokens']}): kernels vs "
              f"plain err {c['max_abs_err']:.3e}")
    for r in fmha["runs"]:
        doc = (f", per-document vs flash_attention err "
               f"{r['per_document_max_abs_err']:.3e} "
               f"({r['documents_on_flash_kernels']} of {fmha['documents']} "
               f"on the flash kernels)" if "per_document_max_abs_err" in r
               else "")
        print(f"fmha {'causal' if r['causal'] else 'bidirectional'} "
              f"{r['dtype']} (T {fmha['tokens']}, {fmha['documents']} "
              f"documents, {fmha['pad_tokens']} pad): fwd+bwd device "
              f"{r['fwd_bwd_device_ms']:.3f} ms, wall p50 "
              f"{r['fwd_bwd_wall_ms_p50']:.3f} ms, {r['tokens_per_s']:.0f} "
              f"tokens/s, launches {r['launches']}{doc} on {card}")
    fprof = main_run["profile"]
    print(f"fmha bf16 causal profile: wall {fprof['profiled_wall_ms']:.3f} "
          f"ms, device busy {fprof['device_busy_ms']:.3f} ms (idle share "
          f"{fprof['device_idle_share']:.3f})")
    for t in fprof["top"][:6]:
        print(f"  fmha top kernel: {t['device_ms']:.3f} ms x{t['count']} "
              f"{t['name']}")
    print(f"layer_norm non-affine on CUDA: {ln_non_affine}")
    t5fp, t5prof = t5["fp32_check"], t5["profile_3_steps"]
    print(f"t5 fp32 check (batch 2, {T5_ENC} + {T5_DEC}): loss kernels "
          f"{t5fp['loss_kernels']} plain {t5fp['loss_plain']} grad max rel "
          f"err {t5fp['grad_max_rel_err']:.3e} rel-table grads "
          f"{t5fp['rel_table_grad_max_abs']}")
    print(f"t5 bf16 batch {T5_BATCH} x ({T5_ENC} + {T5_DEC}): params "
          f"{t5['n_params']} tokens/s {t5['tokens_per_s']:.1f} step_ms_p50 "
          f"{t5['step_ms_p50']:.2f} peak {t5['peak_mem_gib']:.2f} GiB busy "
          f"ms per step {t5prof['device_busy_ms'] / 3:.2f} (share "
          f"{t5prof['device_busy_share_of_unprofiled_wall']:.3f}) losses "
          f"{[round(v, 4) for v in t5['losses']]} on {card}")
    print(f"t5 launches per step: {t5_launches}")
    for t in t5prof["top"]:
        print(f"  t5 top kernel: {t['device_ms']:.2f} ms x{t['count']} "
              f"{t['name']}")
    for shape in ("train", "t5"):
        cs = pick(lm_cases, dtype="bfloat16", shape=shape)
        for key in ("fwd", "dx", "dw"):
            c = cs[key]
            print(f"lm_head_loss {key} bf16 ({cs['rows']}, {cs['hidden']}, "
                  f"{cs['vocab']}): {c['ms']:.4f} ms (plain "
                  f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, "
                  f"bound {c['bound_ms']:.4f}) on {card}")
    for label, e in lm_c1.items():
        print(f"lm_head_loss dx fp32 {LM_FP64} vs fp64 ({label}): kernel "
              f"{e['kernel_max_row_rel_err']:.3e}, plain "
              f"{e['plain_max_row_rel_err']:.3e} of the row's max")
    for c in lm_cases:
        s = c["softmax_term_only"]
        print(f"lm_head_loss gates {c['shape']} {c['dtype']}: dx max abs err "
              f"{c['dx']['max_abs_err']:.3e} ({c['dx']['max_row_rel_err']:.3e}"
              f" of its row's max), dw {c['dw']['max_abs_err']:.3e} "
              f"({c['dw']['max_row_rel_err']:.3e}); |dw| median "
              f"{c['dw']['median_abs']:.3e} max {c['dw']['max_abs']:.3e}; "
              f"softmax term alone dx {s['dx_max_row_rel_err']:.3e} dw "
              f"{s['dw_max_row_rel_err']:.3e} of the row's max (|dw| median "
              f"{s['dw_median_abs']:.3e}); gate {c['atol_of_row_max']} of "
              f"the row's max + rtol {c['rtol']:.3e}")
    for a in (adam, adam["t5"]):
        print(f"fused_adam_tail ({a['per']}, {a['elements']} elements): "
              f"{a['ms']:.4f} ms (plain {a['plain_ms']:.4f}, "
              f"AdamW(fused=True) {a['library_ms']:.4f}, bound "
              f"{a['bound_ms']:.4f})")
    for c in ln_cases:
        if c["stats"]:
            print(f"layer_norm_fwd {c['dtype']} ({c['rows']}, "
                  f"{c['hidden']}) (stats): "
                  f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, library "
                  f"{c['library_ms']:.4f}, bound {c['bound_ms']:.4f})")
    for c in lnb_cases:
        print(f"layer_norm_bwd {c['dtype']} ({c['rows']}, {c['hidden']}): "
              f"{c['ms']:.4f} ms (plain "
              f"{c['plain_ms']:.4f}, library {c['library_ms']:.4f}, bound "
              f"{c['bound_ms']:.4f})")
    for c in nrm["cases"]:
        print(f"{c['kind']} {c['shape']} ({c['rows']}, {c['hidden']}) x "
              f"{c['x_dtype']} w {c['w_dtype']}: err {c['max_abs_err']:.3e} "
              f"(dw/db {c['sum_max_abs_err']:.3e}); " + " ".join(
                  f"{k} {c[k]['ms']:.4f} ms (plain {c[k]['plain_ms']:.4f}, "
                  f"library {c[k]['library_ms']:.4f}, bound "
                  f"{c[k]['bound_ms']:.4f})" for k in ("fwd", "bwd"))
              + f" on {card}")
    for r in nrm["runs"]:
        print(f"{r['module']} {r['name']} {r['shape']} bf16, "
              f"{r['param_dtype']} params: fwd+bwd {r['fwd_bwd_ms']:.4f} ms, "
              f"launches {r['launches']}, vs plain {r['max_abs_err']:.3e}")
    for c in codec["cases"]:
        d = c.get("dequantize")
        print(f"codec {c['dtype']} int{c['bits']} block {c['block']} "
              f"{c['mode']} ({c['elements']} elements): quantize "
              f"{c['ms']:.4f} ms (public {c['public_ms']:.4f}, plain "
              f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f}) bitwise"
              + (f"; dequantize {d['ms']:.4f} ms (public "
                 f"{d['public_ms']:.4f}, plain {d['plain_ms']:.4f}, bound "
                 f"{d['bound_ms']:.4f}) bitwise" if d else "")
              + f" on {card}")
    for r in codec["runs"]:
        print(f"codec main path {r['dtype']} int{r['bits']} {r['mode']}: "
              f"launches {r['launches']}, round trip max "
              f"{r['max_err_in_steps']:.4f} steps, pair {r['pair_ms']:.4f} "
              f"ms (bound {r['pair_bound_ms']:.4f}) on {card}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    # the telemetry and LoRA main paths' launches beside each kernel they
    # run: the monitored fused run (megakernel, the head's LN, the prefill
    # chunks' paged attention) and the LoRA per-op run, with its launches
    # a decode and a verify call
    by_name = {k["name"]: k for k in kernels}
    calls = lora["launches_per_call"]
    for kname in ("megakernel", "layer_norm_fwd", "paged_mma_fwd"):
        by_name[kname]["monitored"] = {
            "launches": mon["launches"].get(kname, 0),
            "path": "InferenceEngine + JsonlSink, EventLog, SloSpec, Meter"}
    for kname in ("layer_norm_fwd", "paged_mma_fwd"):
        by_name[kname]["lora"] = {
            "launches": lora["spec0"]["launches"].get(kname, 0),
            "per_decode_call": calls["lora_decode"]["launches"][kname],
            "per_verify_call": calls["lora_verify"]["launches"][kname],
            "path": f"InferenceEngine lora_rank={LORA_RANK}, per-op"}
    for what in ("off", "on"):
        p50 = mon[f"decode_step_ms_p50_{what}"]
        host = mon[f"host_ms_per_step_{what}"]
        print(f"engine_monitor bf16 GPT-2-124M fused, telemetry {what}: "
              f"decode_step_ms_p50 {p50} host_ms_per_step "
              f"{[round(h, 4) for h in host]} on {card}")
    on = mon["on"][-1]
    print(f"engine_monitor telemetry on: {on['sink_records']} sink records "
          f"for {on['steps']} steps, {on['events']} events, "
          f"{on['trace_events']} trace events, slo good {on['slo_good']}, "
          f"decode_mfu median {on['mfu_median']:.4f}, launches "
          f"{on['launches']}; evicted + restored {mon['evicted']} bitwise")
    sp = lora["spec0"]
    print(f"engine_lora bf16 GPT-2-124M rank {LORA_RANK}, "
          f"{len(LORA_BOUND)} of 16 requests on 2 adapters "
          f"({sp['decode_kernel']}): adapter load "
          f"{lora['adapter_load_ms']:.3f} ms, pool {lora['pool_bytes']} "
          f"bytes, tokens/s {sp['tokens_per_s']}, decode_step_ms_p50 "
          f"{sp['decode_step_ms_p50']} (spec_k=4 "
          f"{lora['spec4']['decode_step_ms_p50']}), host_ms_per_step "
          f"{sp['host_ms_per_step']:.4f}; per-op base without adapters "
          f"tokens/s {lora['base_off']['tokens_per_s']} decode_step_ms_p50 "
          f"{lora['base_off']['decode_step_ms_p50']} on {card}")
    print(f"engine_lora launches a call: "
          f"{ {k: v['launches'] for k, v in calls.items()} }; fp32 logits "
          f"vs merged weights {lora['fp32_logits_max_abs_err']:.3e} "
          f"(limit {LORA_ATOL} + {LORA_RTOL} rel); merged-engine streams "
          f"{lora['fp32_merged_streams']}")
    # the amp main path's launches a step beside each kernel it runs
    o2 = amp_res["o2"]
    for kname, per in o2["launches_per_step"].items():
        by_name[kname]["amp"] = {"launches": per,
                                 "launches_10_steps": o2["launches"][kname],
                                 "path": AMP_PATH}
    by_name["fused_adam_tail"]["amp"].update(
        flagged_ms=adam["flagged_ms"],
        flagged="c1, c2 and found_inf read from the card")
    print(f"amp O2 {AMP_PATH}: step_ms_p50 {o2['step_ms_p50']:.2f} busy ms "
          f"{o2['device_busy_ms_per_step']:.2f} tokens/s "
          f"{o2['tokens_per_s']:.1f} peak {o2['peak_mem_gib']:.2f} GiB "
          f"syncs a step {o2['syncs_per_step']}; plain bf16 step "
          f"step_ms_p50 {o2['plain_step_ms_p50']:.2f} busy ms "
          f"{o2['plain_device_busy_ms_per_step']:.2f} tokens/s "
          f"{o2['plain_tokens_per_s']:.1f} syncs a step "
          f"{o2['plain_syncs_per_step']}; model copy "
          f"{o2['model_copy_ms']:.4f} ms, unscale {o2['unscale_ms']:.4f} "
          f"ms; losses {[round(v, 4) for v in o2['losses']]} on {card}")
    print(f"amp overflow step: {o2['overflow']}; launches a step "
          f"{o2['launches_per_step']}")
    print(f"amp fp32 card vs CPU (2 layers, {AMP_CHECK_ROWS}): "
          f"{amp_res['fp32_check']['cases']}")
    o1 = amp_res["o1_check"]
    print(f"amp O1 card vs CPU (2 layers): loss rel "
          f"{o1['loss_rel_err']:.3e}, grads {o1['grad_max_norm_rel_err']:.3e}"
          f" in norm, launches {o1['launches']}")
    f8 = amp_res["fp8"]
    for key, r in f8["routes"].items():
        print(f"amp fp8 product {key} {r['shape']} {r['types']}: "
              f"route {r['route']}, scaled_mm {r['scaled_mm_ms']:.4f} ms, "
              f"upcast {r['upcast_ms']:.4f} ms, rel diff {r['rel_err']:.2e} "
              f"on {card}")
    print(f"amp fp8 MLP {f8['sizes']} x {f8['rows']}: codes and state "
          f"bitwise card vs CPU over {f8['steps']} steps, losses "
          f"{[round(v, 5) for v in f8['losses']]}")
    by_name["flash_mma_fwd"]["train_dropout"] = {
        policy: run["launches_per_step"]["flash_mma_fwd"]
        for policy, run in trd["policies"].items()}
    for c in drop_cases:
        print(f"hidden_dropout {c['shape']} {c['dims']} {c['dtype']}: "
              f"{c['ms']:.4f} ms (plain {c['plain_ms']:.4f}, bound "
              f"{c['bound_ms']:.4f} {c['bound_by']}: bytes "
              f"{c['bytes_bound_ms']:.4f}, instructions "
              f"{c['ops_bound_ms']:.4f} = {c['bound_formula']}; F.dropout "
              f"{c['f_dropout_ms_not_the_same_function']:.4f}, not the same "
              f"function (Philox)); bitwise, keep {c['keep_share']:.5f} on "
              f"{card}")
    for fn, ops in drop_sass.items():
        print(f"hidden_dropout SASS {fn}: {sum(ops.values())} instructions "
              f"{dict(sorted(ops.items(), key=lambda kv: -kv[1]))}")
    for policy, r in trd["policies"].items():
        print(f"train_dropout GPT-2-124M bf16 8 x 1024 rates 0.1 {policy}: "
              f"step_ms_p50 {r['step_ms_p50']:.2f} busy ms "
              f"{r['device_busy_ms_per_step']:.2f} tokens/s "
              f"{r['tokens_per_s']:.1f} peak {r['peak_mem_gib']:.2f} GiB "
              f"launches {r['launches_per_step']} losses "
              f"{[round(v, 4) for v in r['losses']]} on {card}")
    fp32d = {k: v for k, v in trd["fp32_check"].items() if k != "launches"}
    print(f"train_dropout fp32 check (2 layers): {fp32d}"
          f"; policies bitwise equal, dots_attn repeats bitwise, no key = "
          f"rates 0 ({trd['no_key_equals_rates_0']})")
    print(f"t5_dropout T5-small bf16 {T5_BATCH} x ({T5_ENC} + {T5_DEC}) "
          f"rates 0.1: step_ms_p50 {t5d['step_ms_p50']:.2f} busy ms "
          f"{t5d['device_busy_ms_per_step']:.2f} tokens/s "
          f"{t5d['tokens_per_s']:.1f} peak {t5d['peak_mem_gib']:.2f} GiB "
          f"launches {t5d['launches_per_step']}; fp32 check (2 + 2) loss "
          f"rel {t5d['fp32_check']['loss_rel_err']:.3e} grad "
          f"{t5d['fp32_check']['grad_max_rel_err']:.3e} on {card}")
    for c in func:
        print(f"functional {c['case']}: card vs CPU fp32 "
              f"{ {k: f'{v:.2e}' for k, v in c['norm_err'].items()} } in "
              f"norm (limit {c['norm_tol']}); fwd + bwd "
              f"{c['fwd_bwd_ms_bfloat16']:.4f} ms bf16, "
              f"{c['fwd_bwd_ms_float32']:.4f} ms fp32 on {card}")
    # fp16 (C4): each kernel's fp16 cases, and the fp16 main paths'
    # launches beside each kernel they run; then BERT's and the
    # multi-head attention modules'
    attach_fp16(kernels, ln_cases, lnb_cases, nrm, fa_cases, vl, lm_cases,
                adam, drop_cases)
    attach_fp16_serving(kernels, pa, mk_cases, codec, e16)
    for key in ("bf16_spec0", "fp16_spec0", "fp16_spec4", "fp16_off",
                "fp16_int8_spec0", "fp16_int4_spec0"):
        r = e16[key]
        print(f"engine_fp16 {key} ({r['decode_kernel']}, kv_bits "
              f"{r['kv_bits']}): {r['tokens_per_s']:.1f} tokens/s, TTFT "
              f"p50 {r['ttft_ms_p50']:.2f} ms, decode step p50 "
              f"{r['decode_step_ms_p50']:.3f} ms, wall {r['wall_s']:.2f} s"
              + (f", launches {r['launches']}" if "launches" in r else "")
              + f" on {card}")
    print(f"engine_fp16 launches a call {e16['launches_per_call']}, fp16 "
          f"instantiations in a profiled run {e16['half_kernels']}, "
          f"warnings {e16['warnings']}")
    for run, path in (("o2", AMP16_PATH), ("fp16_optimizer", FP16_OPT_PATH),
                      ("pure_fp16", PURE_FP16_PATH)):
        for kname, per in amp16[run]["launches_per_step"].items():
            by_name[kname].setdefault("amp_fp16", {})[run] = {
                "launches": per, "path": path}
    for run in ("unpadded", "padded"):
        for kname, per in bert[run]["launches_per_step"].items():
            by_name[kname].setdefault("bert", {})[run] = {
                "launches": per, "path": f"BertConfig() bf16 MLM, "
                                         f"{BERT_BATCH} x {BERT_SEQ}, {run}"}
    for run, r in mha.items():
        for kname, n in r["launches"].items():
            by_name[kname].setdefault("multihead_attn", {})[run] = {
                "launches": n, "shape": r["shape"]}
    for run, path in (("o2", AMP16_PATH), ("fp16_optimizer", FP16_OPT_PATH),
                      ("pure_fp16", PURE_FP16_PATH)):
        r = amp16[run]
        print(f"amp_fp16 {path}: step_ms_p50 {r['step_ms_p50']:.2f} busy ms "
              f"{r['device_busy_ms']:.2f} (idle share "
              f"{r['device_idle_share']:.3f}) tokens/s "
              f"{r['tokens_per_s']:.1f} peak {r['peak_mem_gib']:.2f} GiB "
              f"syncs a step {r['syncs_per_step']}, fp16 kernels a step "
              f"{r['half_kernel_launches_a_step']}, losses "
              f"{[round(v, 4) for v in r['losses']]}"
              + (f", overflow step {r['overflow']}" if "overflow" in r
                 else "") + f" on {card}")
    for run in ("unpadded", "padded"):
        r = bert[run]
        print(f"bert BertConfig() bf16 {run} {r['batch']} x {r['seq']} "
              f"({r['padded_rows']} padded rows, {r['pad_tokens']} pad "
              f"tokens, {r['predicted']} predicted): step_ms_p50 "
              f"{r['step_ms_p50']:.2f} busy ms {r['device_busy_ms']:.2f} "
              f"(idle share {r['device_idle_share']:.3f}) tokens/s "
              f"{r['tokens_per_s']:.1f} peak {r['peak_mem_gib']:.2f} GiB "
              f"launches a step {r['launches_per_step']} losses "
              f"{[round(v, 4) for v in r['losses']]} on {card}")
    chk = bert["bf16_check"]
    print(f"bert bf16 check (batch {BERT_CHECK_BATCH}): loss kernels "
          f"{chk['loss_kernels']} plain {chk['loss_plain']} (rel "
          f"{chk['loss_rel_err']:.3e}); grad max |k - p| / |p| "
          f"{chk['grad_max_norm_rel_err']:.3e} at {chk['grad_worst_leaf']}")
    for run, r in mha.items():
        print(f"multihead_attn {run} {r['shape']} heads {r['heads']} memory "
              f"{r['memory']} bf16 dropout {r['dropout']}: fwd+bwd "
              f"{r['fwd_bwd_ms']:.3f} ms ({r['tokens_per_s']:.0f} tokens/s), "
              f"launches {r['launches']}, vs plain in norm "
              f"{ {k: f'{v:.2e}' for k, v in r['rel_err_in_norm'].items()} }"
              f" on {card}")
    print(f"transducer fp32 B {trans['batch']} T {trans['frames']} U "
          f"{trans['labels']} H {trans['joint_hidden']} V {trans['vocab']} "
          f"(lattice {trans['lattice_bytes']} B): fwd+bwd "
          f"{trans['fwd_bwd_ms']:.2f} ms ({trans['frames_per_s']:.0f} "
          f"frames/s), peak {trans['peak_mem_gib']:.2f} GiB, NLL mean "
          f"{trans['nll_mean']:.3f}, vs fp64 rel "
          f"{trans['nll_rel_err_vs_fp64']:.2e} on {card}")
    # the new slice's main paths' launches beside each kernel they run:
    # ASP's pruned step (the train table), DCGAN's and the mLSTM's Adam
    # tails
    for kname, per in asp["launches_per_step"].items():
        by_name[kname]["asp"] = {"launches": per, "path": ASP_PATH}
    by_name["fused_adam_tail"]["dcgan"] = {
        "launches": dcgan["launches_per_iteration"]["fused_adam_tail"],
        "path": DCGAN_PATH}
    by_name["fused_adam_tail"]["rnn"] = {
        "launches": rnn["launches_per_step"]["fused_adam_tail"],
        "path": RNN_PATH}
    pm = asp["permute_and_mask"]
    print(f"asp {ASP_PATH}: masks {asp['mask_ms']:.2f} ms on the card "
          f"({asp['masked_leaves']} leaves, {asp['masked_elements']} "
          f"elements, pruned share {asp['pruned_share']:.4f}); step_ms_p50 "
          f"{asp['step_ms_p50']:.2f} (dense {asp['dense_step_ms_p50']:.2f}) "
          f"busy ms {asp['device_busy_ms_per_step']:.2f} (dense "
          f"{asp['dense_device_busy_ms_per_step']:.2f}), tokens/s "
          f"{asp['tokens_per_s']:.1f} (dense {asp['dense_tokens_per_s']:.1f})"
          f", launches a step {asp['launches_per_step']}, losses "
          f"{[round(v, 4) for v in asp['losses']]}, pruned slots stay 0; "
          f"permute_and_mask {pm['matrix']} {pm['host_s']:.2f} s on the "
          f"host, 2:4 magnitude {pm['magnitude_unpermuted']:.3f} -> "
          f"{pm['magnitude_permuted']:.3f} (x{pm['gain']:.5f}) on {card}")
    print(f"resnet {RESNET_PATH}: step_ms_p50 {resnet['step_ms_p50']:.2f}, "
          f"{resnet['img_per_s']:.1f} img/s, busy ms "
          f"{resnet['device_busy_ms_per_step']:.2f} (idle share "
          f"{resnet['device_idle_share']:.3f}), peak "
          f"{resnet['peak_mem_gib']:.2f} GiB, losses "
          f"{[round(v, 4) for v in resnet['losses']]} (two runs bitwise "
          f"equal), port kernel launches {resnet['launches']}, top "
          f"{[(t['name'][:40], round(t['device_ms'], 2))
              for t in resnet['top'][:4]]}"
          f" on {card}")
    print(f"dcgan {DCGAN_PATH}: iteration_ms_p50 "
          f"{dcgan['iteration_ms_p50']:.2f}, {dcgan['img_per_s']:.1f} img/s, "
          f"busy ms {dcgan['device_busy_ms_per_iteration']:.2f} (idle share "
          f"{dcgan['device_idle_share']:.3f}), peak "
          f"{dcgan['peak_mem_gib']:.2f} GiB, launches an iteration "
          f"{dcgan['launches_per_iteration']}, losses (D, G) "
          f"{[[round(v, 4) for v in r] for r in dcgan['losses_d_g']]} on "
          f"{card}")
    print(f"rnn {RNN_PATH}: step_ms_p50 {rnn['step_ms_p50']:.1f}, "
          f"{rnn['tokens_per_s']:.1f} tokens/s, busy ms "
          f"{rnn['device_busy_ms_per_step']:.1f} (idle share "
          f"{rnn['device_idle_share']:.3f}), peak {rnn['peak_mem_gib']:.2f} "
          f"GiB, launches a step {rnn['launches_per_step']}, losses "
          f"{[round(v, 4) for v in rnn['losses']]} on {card}")
    # the data-parallel slice: the codec kernels' launches a step on the
    # DDP path (each compressed bucket's passes), the codec's device ms a
    # step beside its byte bound, under each compressed policy
    for kname in ("quantize_blockwise[nearest]", "dequantize_blockwise"):
        by_name[kname]["ddp"] = {
            policy: {"launches_per_step": r["codec_launches_per_step"].get(
                         kname, 0),
                     "launches_first_step": r["launches_first_step"].get(
                         kname, 0),
                     "codec_ms_per_step": r["codec_ms_per_step"],
                     "codec_bound_ms_per_step": r["codec_bound_ms_per_step"],
                     "path": DDP_PATH}
            for policy, r in ddp["policies"].items() if policy != "none"}
    base = ddp["no_ddp"]
    print(f"ddp {DDP_PATH} ({ddp['backend']}, mesh {ddp['mesh']}): no DDP "
          f"step_ms_p50 {base['step_ms_p50']:.2f} busy ms "
          f"{base['device_busy_ms']:.2f} peak {base['peak_mem_gib']:.2f} GiB"
          f" losses {[round(v, 4) for v in base['losses']]} on {card}")
    for policy, r in ddp["policies"].items():
        m = r["metrics"]
        print(f"ddp {policy}: step_ms_p50 {r['step_ms_p50']:.2f} busy ms "
              f"{r['device_busy_ms']:.2f} (idle share "
              f"{r['device_idle_share']:.3f}), codec "
              f"{r['codec_ms_per_step']:.4f} ms a step (bound "
              f"{r['codec_bound_ms_per_step']:.4f}), NCCL "
              f"{r['nccl_ms_per_step']:.4f} ms, copies "
              f"{r['copy_ms_per_step']:.4f} ms, peak {r['peak_mem_gib']:.2f} "
              f"GiB, {r['compressed_buckets']} of {r['buckets']} buckets "
              f"compressed, codec launches a step "
              f"{r['codec_launches_per_step']}, plain codec calls "
              f"{r['plain_codec_calls']}, losses "
              f"{[round(v, 4) for v in r['losses']]} (max gap to none "
              f"{r['max_gap_to_none']:.2e}), metrics wire "
              f"{m['comm_wire_bytes']:.0f} B ratio "
              f"{m['comm_compression_ratio']:.3f}, issued "
              f"{r['report']['counts']} wire "
              f"{r['report']['wire_bytes']:.0f} B, modeled at 8 ranks "
              f"{r['modeled_wire_bytes_8_ranks']:.0f} B (fp32 "
              f"{r['modeled_fp32_wire_bytes_8_ranks']:.0f}) on {card}")
    print(f"syncbn_dp {SYNCBN_PATH}: {sbn['img_per_s']:.1f} img/s (local "
          f"{sbn['local_img_per_s']:.1f}), step_ms_p50 "
          f"{sbn['step_ms_p50']:.2f} (local {sbn['local_step_ms_p50']:.2f}),"
          f" {sbn['bn_layers']} BN layers, collectives a step "
          f"{sbn['collectives_first_step']}, busy ms "
          f"{sbn['sync_device_busy_ms']:.2f} (local "
          f"{sbn['local_device_busy_ms']:.2f}), NCCL "
          f"{sbn['sync_nccl_ms']:.3f} ms a step, one (3, 2048) all-reduce "
          f"{sbn['allreduce_latency']['host_us_per_call']:.1f} host µs / "
          f"{sbn['allreduce_latency']['device_us_per_call']:.1f} device µs,"
          f" bitwise equal to local BN, losses "
          f"{[round(v, 4) for v in sbn['losses']]} on {card}")
    # the ZeRO / FSDP slice: the tail's launches a step on the sharded
    # paths (fp32 shards; LAMB's variant on dist_lamb) with its time at
    # the shards' inputs, and the codec's launches, device ms and bound a
    # step under each compressed wire
    tail = by_name["fused_adam_tail"]
    z_none, f_none = zero1["policies"]["none"], fsdp["runs"]["none"]
    tail["zero1"] = {"launches": z_none["launches_first_step"][
        "fused_adam_tail"], "path": ZERO_PATH,
        "shard": zero1["shard_tail"],
        "tail_ms_per_step": z_none["tail_ms_per_step"]}
    tail["fsdp"] = {"launches": f_none["launches_first_step"][
        "fused_adam_tail"], "path": FSDP_PATH,
        "tail_ms_per_step": f_none["tail_ms_per_step"]}
    tail["dist_lamb"] = {"launches": dlamb["launches_first_step"][
        "fused_lamb_tail"], "variant": "fused_lamb_tail (the kernel's "
        "Σp² / Σu² instantiation)", "path": DIST_LAMB_PATH,
        "shard": dlamb["shard_tail"],
        "tail_ms_per_step": dlamb["tail_ms_per_step"]}
    for kname in ("quantize_blockwise[nearest]", "dequantize_blockwise"):
        for key, runs, path in (("zero1", zero1["policies"], ZERO_PATH),
                                ("fsdp", fsdp["runs"], FSDP_PATH)):
            by_name[kname][key] = {
                label: {"launches_per_step": r["codec_launches_per_step"]
                        .get(kname, 0),
                        "launches_first_step": r["launches_first_step"]
                        .get(kname, 0),
                        "codec_ms_per_step": r["codec_ms_per_step"],
                        "codec_bound_ms_per_step":
                            r["codec_bound_ms_per_step"], "path": path}
                for label, r in runs.items() if r["codec_launches_per_step"]}
    hbm = zero1["modeled_hbm_params_bytes_8_ranks"]
    print(f"zero1 / fsdp modelled (fsdp.accounting.hbm_params_bytes, not "
          f"measured) GPT-2-124M bf16 at W = 8: "
          + ", ".join(f"{k} {v['total'] / 2 ** 30:.3f} GiB" for k, v in
                      hbm.items()))
    print(f"zero1 {ZERO_PATH} ({zero1['backend']}): amp O2 reference losses "
          f"{[round(v, 4) for v in zero1['amp_o2_losses']]} on {card}")
    for what, runs in (("zero1", zero1["policies"]), ("fsdp", fsdp["runs"])):
        for label, r in runs.items():
            gap = r["max_gap_to_none"]
            print(f"{what} {label}: step_ms_p50 {r['step_ms_p50']:.2f} host "
                  f"ms {r['host_ms_p50']:.2f} busy ms "
                  f"{r['device_busy_ms']:.2f} (idle share "
                  f"{r['device_idle_share']:.3f}), tail "
                  f"{r['tail_ms_per_step']:.4f} ms, codec "
                  f"{r['codec_ms_per_step']:.4f} ms (bound "
                  f"{r['codec_bound_ms_per_step']:.4f}), NCCL "
                  f"{r['nccl_ms_per_step']:.4f} ms, copies "
                  f"{r['copy_ms_per_step']:.4f} ms, peak "
                  f"{r['peak_mem_gib']:.2f} GiB, syncs a step "
                  f"{r['syncs_per_step']}, codec launches a step "
                  f"{r['codec_launches_per_step']}, collectives "
                  f"{r['collective_kinds']}, losses "
                  f"{[round(v, 4) for v in r['losses']]}"
                  + ("" if gap is None else f" (max gap to none {gap:.2e})")
                  + f" on {card}")
    st = zero1["shard_tail"]
    print(f"fused_adam_tail at the shards (fp32 g and p, {st['elements']} "
          f"elements, {st['leaves']} launches): {st['ms']:.4f} ms, bound "
          f"{st['bound_ms']:.4f} ({st['bound_by']}), plain "
          f"{st['plain_ms']:.4f}, AdamW(fused=True) fp32 "
          f"{st['library_ms']:.4f}, max err {st['max_abs_err']:.2e} on "
          f"{card}")
    print(f"dist_lamb {DIST_LAMB_PATH}: step_ms_p50 "
          f"{dlamb['step_ms_p50']:.2f} host ms {dlamb['host_ms_p50']:.2f} "
          f"busy ms {dlamb['device_busy_ms']:.2f} (idle share "
          f"{dlamb['device_idle_share']:.3f}), LAMB tails "
          f"{dlamb['tail_ms_per_step']:.4f} ms ({dlamb['leaves']} launches, "
          f"shards {dlamb['shard_tail']['ms']:.4f} ms vs bound "
          f"{dlamb['shard_tail']['bound_ms']:.4f}), NCCL "
          f"{dlamb['nccl_ms_per_step']:.4f} ms, peak "
          f"{dlamb['peak_mem_gib']:.2f} GiB, syncs a step "
          f"{dlamb['syncs_per_step']}, collectives "
          f"{dlamb['collectives_first_step']}, losses "
          f"{[round(v, 4) for v in dlamb['losses']]} vs FusedLAMB "
          f"{[round(v, 4) for v in dlamb['fused_lamb_losses']]} (max gap "
          f"{dlamb['max_gap']:.2e}) on {card}")
    # the tensor- and sequence-parallel slice: each kernel's launches on
    # the tp paths' first steps (GPT-2 and T5-small through the tp layers,
    # one rank), the ring chunks' checks and times with offsets (flash),
    # the vocab shard's (LM head)
    for kname in by_name:
        for path, res in (("tp", tp), ("t5_tp", t5_tp)):
            runs = {v: r["launches_first_step"].get(kname, 0)
                    for v, r in res["variants"].items()}
            if any(runs.values()):
                by_name[kname].setdefault("tp_paths", {})[path] = {
                    "launches_first_step": runs, "path": res["path"]}
    ring_key = {"flash_mma_fwd": "fwd", "flash_mma_bwd_dq": "dq",
                "flash_mma_bwd_dkv": "dkv", "flash_mma_bwd_dbias": "dbias"}
    for kname, key in ring_key.items():
        rc = [c for c in ring["cases"] if key != "dbias" or c["bias"]]
        err_key = {"fwd": "fwd", "dq": "dq", "dkv": "dk",
                   "dbias": "dbias"}[key]
        by_name[kname]["ring_chunks"] = {
            "chunks": RING_CHUNKS, "offsets": "q_off = i*s, k_off = j*s",
            "chunk_vs_plain_max_abs_err": max(
                c["chunk_vs_plain_max_abs_err"][err_key] for c in rc),
            "merged_vs_dense_max_abs_err": max(
                c["merged_vs_dense_max_abs_err"][
                    {"fwd": "o", "dkv": "dk"}.get(key, key)] for c in rc),
            **{shape: t[key] for shape, t in ring["timed"].items()
               if key in t}}
    for kname in ("lm_head_mma_fwd", "lm_head_mma_bwd_dx",
                  "lm_head_mma_bwd_dw", "lm_head_loss_fwd",
                  "lm_head_loss_bwd_dx", "lm_head_loss_bwd_dw"):
        dname = "bfloat16" if "mma" in kname else "float32"
        c = pick(lm_shard, dtype=dname)
        by_name[kname]["vocab_shard"] = {
            k: c[k] for k in ("rows", "hidden", "vocab_local",
                              "negative_targets",
                              "targets_at_or_above_vocab_local",
                              "pred_all_zero", "fwd_max_abs_err",
                              "dx_max_row_rel_err", "dw_max_row_rel_err")}
    for c in lm_shard:
        print(f"lm_head vocab shard {c['dtype']} ({c['rows']} x "
              f"{c['hidden']}, V_local {c['vocab_local']}, "
              f"{c['negative_targets']} targets < 0, "
              f"{c['targets_at_or_above_vocab_local']} >= V_local): pred 0 "
              f"everywhere, lse err {c['fwd_max_abs_err']:.2e}, dx / dw row "
              f"rel err {c['dx_max_row_rel_err']:.2e} / "
              f"{c['dw_max_row_rel_err']:.2e} on {card}")
    for c in ring["cases"]:
        print(f"ring_chunks {c['shape']} {c['dtype']} causal={c['causal']} "
              f"bias={c['bias']} dropout {c['dropout']}, {c['chunks']} "
              f"chunks: chunk vs plain {c['chunk_vs_plain_max_abs_err']}, "
              f"merged vs dense {c['merged_vs_dense_max_abs_err']} on {card}")
    for shape, t in ring["timed"].items():
        print(f"ring_chunks {shape} bf16 chunk {t['chunk']} ({t['rows']} "
              f"rows): " + ", ".join(
                  f"{k} {v['ms_offsets_set']:.4f} ms (offsets 0 "
                  f"{v['ms_offsets_0']:.4f}, bound {v['bound_ms']:.4f})"
                  for k, v in t.items() if isinstance(v, dict))
              + f" on {card}")
    for label, res in (("tp", tp), ("t5_tp", t5_tp)):
        base = res["no_tp"]
        print(f"{label} {res['path']} ({res['backend']}): no mesh (the "
              f"{'train' if label == 'tp' else 't5_train'} phase's run) "
              f"step_ms_p50 {base['step_ms_p50']:.2f} busy ms "
              f"{base['device_busy_ms']:.2f} on {card}")
        for vname, r in res["variants"].items():
            print(f"{label} {vname}: step_ms_p50 {r['step_ms_p50']:.2f} host "
                  f"ms {r['host_ms_p50']:.2f} busy ms "
                  f"{r['device_busy_ms']:.2f} (idle share "
                  f"{r['device_idle_share']:.3f}), collectives a step "
                  f"{ {k: n for k, n in r['collectives_per_step'].items() if n} }"
                  f", losses {[round(v, 4) for v in r['losses']]} bitwise "
                  f"the run without a mesh, same launches on {card}")
    # the pipeline slice: each kernel's launches a step on the schedules'
    # runs (GPT-2 and T5-small, one rank, M = 4)
    for kname in by_name:
        for path, res in (("pipeline", pipe), ("t5_pipeline", t5_pipe)):
            runs = {v: r["launches"].get(kname, 0)
                    for v, r in res["runs"].items()}
            if any(runs.values()):
                by_name[kname].setdefault("pipeline_paths", {})[path] = {
                    "launches_per_step": runs, "M": res["M"],
                    "path": res["path"]}
    for label, res in (("pipeline", pipe), ("t5_pipeline", t5_pipe)):
        base, fp = res["plain"], res["fp32_check"]
        fp_runs = {run: (f"{f['loss_rel']:.2e}", f"{f['worst_leaf_rel']:.2e}")
                   for run, f in fp["runs"].items()}
        print(f"{label} {res['path']} ({res['backend']}): plain step "
              f"step_ms_p50 {base['step_ms_p50']:.2f} host ms "
              f"{base['host_ms_p50']:.2f} busy ms "
              f"{base['device_busy_ms']:.2f} peak "
              f"{base['peak_mem_gib']:.3f} GiB losses "
              f"{[round(v, 4) for v in base['losses']]}, top "
              f"{[(t['name'][:40], round(t['device_ms'], 2)) for t in base['top'][:4]]}"
              f"; fp32 step beside it (loss rel, worst leaf rel) "
              f"{fp_runs} on {card}")
        for run, r in res["runs"].items():
            print(f"{label} {run}: step_ms_p50 {r['step_ms_p50']:.2f} host "
                  f"ms {r['host_ms_p50']:.2f} busy ms "
                  f"{r['device_busy_ms']:.2f} (idle share "
                  f"{r['device_idle_share']:.3f}), peak "
                  f"{r['peak_mem_gib']:.3f} GiB, syncs a step "
                  f"{r['syncs_per_step']}, first step's worst gradient "
                  f"leaf {r['grads_worst_rel']:.2e} from the plain step's, "
                  f"losses {[round(v, 4) for v in r['losses']]}, launches "
                  f"{r['launches']} (the formula's), top "
                  f"{[(t['name'][:40], round(t['device_ms'], 2)) for t in r['top'][:4]]}"
                  f" on {card}")
    # the MoE slice: each kernel's launches a step of the 8-expert GPT-2
    for kname, n in moe["launches"].items():
        by_name[kname]["moe"] = {"launches_per_step": n, "path": MOE_PATH}
    print(f"moe {moe['path']} ({moe['backend']}): capacity "
          f"{moe['capacity']}, {moe['n_params']} parameters, step_ms_p50 "
          f"{moe['step_ms_p50']:.2f} host ms {moe['host_ms_p50']:.2f} busy "
          f"ms {moe['device_busy_ms']:.2f} (idle share "
          f"{moe['device_idle_share']:.3f}), peak {moe['peak_mem_gib']:.3f} "
          f"GiB, syncs a step {moe['syncs_per_step']}, fraction_kept "
          f"{[round(v, 4) for v in moe['fraction_kept']]}, losses "
          f"{[round(v, 4) for v in moe['losses']]}, launches "
          f"{moe['launches']} (the formula's), top "
          f"{[(t['name'][:40], round(t['device_ms'], 2)) for t in moe['top'][:6]]}"
          f" on {card}")
    fi, bv, fp = (moe["fp32_identity"], moe["bf16_vs_fp32"],
                  moe["fp32_vs_plain"])
    print(f"moe fp32 single-expert identity: loss {fi['loss_moe']:.6f} - "
          f"{fi['lb_loss_weight']} vs dense {fi['loss_dense']:.6f} (rel "
          f"{fi['loss_rel']:.2e}), worst leaf norm {fi['worst_leaf']} "
          f"{fi['worst_leaf_norm_rel']:.2e}; bf16 first step vs fp32: loss "
          f"rel {bv['loss_rel']:.2e}, worst leaf norm {bv['worst_leaf']} "
          f"{bv['worst_leaf_norm_rel']:.2e}, worst leaf difference "
          f"{bv['worst_diff_leaf']} {bv['worst_leaf_diff_rel']:.2e} (limit "
          f"{bv['grad_diff_rtol']}); fp32 step vs the plain MoE layer: loss "
          f"rel {fp['loss_rel']:.2e}, worst leaf difference "
          f"{fp['worst_leaf']} {fp['worst_leaf_diff_rel']:.2e} (limit "
          f"{fp['rtol']}), smallest top-k margin "
          f"{fp['smallest_topk_margin']:.2e} on {card}")
    # the plan-sharded serving slice: the per-op kernels on the pp and fsdp
    # engines (launches of one decode call and of each whole run)
    for kname, n in spp["decode_call_launches"].items():
        by_name[kname]["serve_pp"] = {
            "decode_call_launches": n, "path": SERVE_PP_PATH,
            "run_launches": {r: v["launches_run"].get(kname, 0)
                             for r, v in spp["runs"].items()}}
    for run, rec in sfs["runs"].items():
        for kname, n in rec["decode_call_launches"].items():
            by_name[kname].setdefault("serve_fsdp", {})[run] = {
                "decode_call_launches": n, "path": SERVE_FSDP_PATH}
    for run, r in spp["plain"].items():
        print(f"serve_pp plain per-op engine {run}: {r['steps']} steps, "
              f"decode_step_ms_p50 {r['decode_step_ms_p50']}, tokens/s "
              f"{r['tokens_per_s']}, wall {r['wall_s']:.2f} s on {card}")
    for run, r in spp["runs"].items():
        print(f"serve_pp {run}: streams bitwise the plain per-op engine's, "
              f"{r['steps']} steps, decode_step_ms_p50 "
              f"{r['decode_step_ms_p50']}, tokens/s {r['tokens_per_s']}, "
              f"bubble {r['pp_bubble_fraction']:.4f} (modelled "
              f"{r['pp_bubble_fraction_modeled']:.4f}, M "
              f"{r['pp_microbatches']}), credit waits {r['pp_credit_waits']}"
              f", wall {r['wall_s']:.2f} s; one decode call "
              f"{spp['decode_call_launches']} on {card}")
    for run, r in sfs["runs"].items():
        print(f"serve_fsdp {run} ({sfs['backend']}): first logits max abs "
              f"err {r['first_logits_max_abs_err']:.3e} "
              f"({r['first_logits_rel_of_max']:.2e} of the largest), "
              f"weight_gather_ms {r['weight_gather_ms']:.3f}, wire bytes "
              f"{r['weight_gather_wire_bytes']}, one decode call "
              f"{r['decode_call_launches']}"
              + (f", streams bitwise the plain per-op engine's, "
                 f"decode_step_ms_p50 {r['run']['decode_step_ms_p50']}"
                 if "run" in r else "") + f" on {card}")
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels its path never launched: {idle}")
    print(json.dumps({"seconds": seconds}))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
