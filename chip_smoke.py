#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

  python3 chip_smoke.py

Needs one CUDA card (an H100 for the sm_90a kernels) and the CUDA toolkit;
builds the kernels from ``src/repro_torch/kernels/csrc`` first.  Each phase
prints one line, and any failure exits non-zero:

  1. the card, torch/CUDA versions and the kernels' build time
  2. gemv against its plain version, each shape on the path gemv_path
     chooses (the stream path at the main shape, ragged K and N, f32 at one
     and two row blocks; the panel path at rows TMA cannot read) and the
     main shape forced onto the panel path
  3. fused_matmul_allreduce (one rank) against its plain version: the
     decode shape on the path the wrapper chooses (fused_path) and forced
     onto each other path, f32 calls (stream path; an unaligned w on the
     panel path), and the tensor-core tile path at
     [2048,13696]@[13696,4096], ragged [130,1000]@[1000,1024] and
     [2049,4104]@[4104,4096], and 100 rows (below the tile's 128); a
     stream plan launched again after a plan of the same kernel that needs
     less shared memory was built (gemv and the fused kernel)
  4. the fused kernel's 4-rank world emulated on the card, against
     fused_matmul_allreduce_ref_ranks (3 calls back to back per case to
     reuse the flags across epochs, both schedules): the stream and panel
     paths at 4 rows (f32 with both wires, bf16), the stream path at a
     ragged 96-column chunk, the tile path at 4, 256 and 130 rows
  5. full-width chatglm3-6b greedy decode through DecodeEngine, kernel mode
     against bulk mode (launches per path, teacher-forced logits and both
     token streams)
  6. times from CUDA events (the decode shape on every path), and each
     wrapper's device time per launch and host time per call
  7. the MoE kernels (fused_dispatch_a2a, fused_gemm_a2a, and the chain of
     the two) against their plain versions at n_dev = 1: dbrx-132b's
     main-path shapes with its full expert weights (fused_gemm_a2a on the
     stream path gemm_a2a_path chooses and forced onto the panel path; the
     stream plan and the clusters the card holds at each split), and
     ragged f32 shapes on the path gemm_a2a_path picks (F = 777: panel;
     F = 776: stream)
  8. both MoE kernels' 4-rank world emulated on the card at dbrx's widths,
     and the chain of the two (both wires, both schedules, chunks_per_rank
     1 and 2, skew 0 and 1, capacity 2 and 8; 3 calls back to back per
     case; the expert FFN on the stream path, and in every case also on
     the panel path)
  9. full-width dbrx-132b (cut to 8 of its 40 layers) greedy decode through
     DecodeEngine, kernel mode against bulk mode: the launch counts (every
     fused_gemm_a2a launch on the stream path), every MoE layer's kernel
     output against bulk on the identical input, and the whole model
     teacher-forced (tokens and experts) against bulk and an exact f32
     evaluation (logits, and the k and v caches after the last step), with
     where each mode's own router first parts from the kernel run's
 10. the MoE kernels' and dbrx decode's times from CUDA events: both
     fused_gemm_a2a paths beside the bulk einsums in turns, with the stream
     path's and the einsums' device time and host time per call, and the
     stream path at each cluster split from 1 to 8 CTAs; the
     dispatch's device time per launch and host time per call beside
     Tensor.copy_'s
 11. embedding_pool against its plain version: DLRM's main-path shape (128
     of its 512 tables of 1,000,000 x 92 f32, batch 8192, pooling 70, the
     first and last rows included) on the path bag_path chooses and forced
     onto the other, the ring path bit-identical to the warp path, and
     ragged shapes (D 1, 8, 93, 160, 256, 257, L 1, bag counts off the CTA's
     multiple, bf16 tables at D 4, 64 and 92, an unaligned table), each on
     bag_path's path and, where the ring path takes it, bit-identical on it
 12. fused_embedding_a2a on bag_path's path and forced onto each path: one
     rank at the main-path shape bit-identical to embedding_pool; its
     4-rank world emulated on the card at full width ([4, 32, V, D]
     tables) bit-identical to embedding_pool's rows, both schedules, 3
     calls back to back each; ragged 3-rank worlds (D 92 and 93) against
     their plain version
 13. the full-width DLRM forward (128 tables, DLRMBatches(seed=0) batch of
     8192) through the registry's bundle in kernel and bulk mode: launch
     counts (1 pooling launch per forward, on bag_path's path; 4 at
     chunks_per_rank 4, where the pooled output is bit-identical), logits
     and loss kernel vs bulk
 14. the bag kernels' registers and CTAs an SM on each path, both
     kernels and the world on each path beside the bound, the
     gathered-bytes floor, the plain versions and F.embedding_bag; both
     paths on indices whose rows stay in L2 and on rows in sequence; both
     paths at bf16 rows of D = 64; the ring-size sweep; the forward in both
     modes with profiles (the scratch builds of the ring path's design study were
     cut for phases 44-48's time)
 15. wkv6 against its plain chunked version and the per-step scan at the
     main-path shape (rwkv6-7b's prefill: B*H = 4*64, T = 512, N = 64,
     chunk 64; decays across the clip range, a non-zero bonus) and edge
     shapes (one chunk, chunks 8/16/32, T below the chunk, N 16 and 32,
     16 and 10 chunks: more than a cluster's 8 CTAs, chunk 20 off the
     8-step sub-chunk, B*H = 65600 heads), an unsupported N or chunk
     raising; gemm against
     its plain version at
     ragged M, N, K (1, 33, 1000, 4097; the CUDA-core kernel) and at shapes
     the bf16 tile path takes ([2048,4096]@[4096,4096], [1000,4104]@
     [4104,1032], [1,64]@[64,8], [4097,64]@[64,4096]), in f32 and bf16
 16. full-width rwkv6-7b prefill (4 x 512 seeded tokens, random mu, w0 and
     u) through the registry's bundle in kernel and bulk mode: launch
     counts (64 fused launches on the tile path), every layer's wkv6 output
     and state against the plain version on its identical input, logits
     and states of both modes against an exact f32 evaluation
 17. 8 greedy decode steps from phase 16's states (launch counts per path;
     logits teacher-forced, kernel vs bulk vs exact f32), and the
     prefill/decode hand-off: a 64-token prefill against 64 decode steps
     from init_state
 18. times from CUDA events: wkv6 and gemm (both kernels) against their
     bounds, plain versions and torch.matmul (wkv6 also with the
     exponentials of the reference's form and of the kernel's, and their
     time at 16 a clock per SM); the fused kernel at prefill
     rows on layer 0's w_o and channel-mix w_v, checked on the tile path and
     timed on the stream path; the row sweep that sets TILE_ROWS
     (chatglm3-6b's w_down at 1-2048 rows, the stream and tile paths beside
     torch.matmul); prefill per
     batch and decode per step in both modes with profiles
 19. flash_attention against its plain version at the main-path shape
     (chatglm3-6b's prefill: B 4, S 2048, 32 query heads over 2 kv heads of
     128, bf16, causal) and edge shapes (non-causal, S 1/37/127/128/129/
     255/1000/2049, 16 query heads per kv head, hd 64, f32, one kv head per
     query head), each on the path flash_path chooses and every bf16 hd 128
     shape on the CUDA-core path too; hd 96, a window or softcap of 0 or
     f32 forced onto the tile path raising
 20. full-width chatglm3-6b prefill (4 x 2048 seeded tokens) through the
     registry's bundle in kernel and bulk mode: launch counts (28 flash in
     kernel mode, all on the tile path; 0 in bulk mode, which runs
     span_attention as the reference's bulk branch does; no fused GEMV),
     every layer's flash
     output against the plain version on its identical input, logits and
     caches against an exact f32 evaluation (the bound: bulk mode's own
     distance); the hand-off: 8 greedy decode steps from position 2048 in
     a 4096-position cache, the first step's logits against a prefill over
     2049 tokens, and both modes' token streams
 21. times from CUDA events: the flash kernel per layer on both paths
     against its bound, its plain version and
     F.scaled_dot_product_attention; prefill per batch and decode per step
     in both modes; profiles
 22. chatglm3-6b's prefill at the reference's prefill_32k length, cut from
     batch 32 to 4 x 32768 seeded tokens (68 GB at its peak), kernel mode:
     the flash kernel at [4, 32768, 32, 128] on both paths against SDPA and
     its bound, query heads 0 and 16 of every batch row against the plain
     version on that head (at BF16_TOL and scaled to each row), the
     prefill's launches (28, tile path), finite logits, time, peak memory
     per row and profile
 23. full-width chatglm3-6b served through the paged engine (chunked
     prefill) on phase 20's weights, kernel and bulk mode: (a) the
     launcher's own traffic through launch.serve.main(["--paged", ...])
     (8 seeded requests of 2-5 tokens, batch 4, 16 new tokens, block 16,
     chunk 8, the default pool of 512 blocks), kernel mode against bulk
     mode teacher-forced (bound: LOGITS_TOL_FACTOR x (b)'s bulk distance
     from an exact f32 evaluation; (a)'s own exact replay was cut for
     phases 44-48's time), both token streams; (b) prompts of 1,
     37, 140 and 250 seeded tokens, 8 new each: the same bound, and each
     request's first generated token's logits (bulk) against a dense
     prefill_forward of its prompt; (c) (b)'s traffic on 51 blocks, where
     admissions are deferred and a request is preempted, every request
     drained; (d) launches per step (28 fused, tile path at the chunk's 32
     rows, stream path at C = 1's 4; no flash, no gemv); (e) serve_step at
     C = 1 and C = 8 under torch.cuda.set_sync_debug_mode("error"); (f) the
     fused kernel at [32,13696]@[13696,4096] bf16 against its plain version
 24. times from CUDA events: serve_step at C = 1 and C = 8 in both modes
     (one turn each), profiles, tok/s of the launcher's traffic through the
     paged and the dense engine (one drain each), the fused kernel at 32 rows on the tile and stream paths
     beside torch.matmul and its bound, the pool's bytes against the dense
     cache's
 25. the flash kernel for training at the prefill's shape (bf16, tile path)
     and an f32 shape (CUDA-core path): its softmax statistics m and l
     against the plain version's, its output with statistics bit-identical
     to without, and dq, dk, dv (the kernel's forward, the analytic
     backward) within LOGITS_TOL_FACTOR x bulk mode's (autograd through
     span_attention) distance from an exact evaluation (f32; f64 for the
     f32 case); the backward's time beside SDPA's backward and its bound
 26. every parameter's gradient of 2 full-width chatglm3-6b layers at
     16 x 64 tokens in kernel and bulk mode against an exact f32
     evaluation (kernel mode within LOGITS_TOL_FACTOR x bulk's on every
     leaf), 4 flash launches (forward and remat) in kernel mode
 27. the launcher, launch.train.main, at full width (28 layers, AdamW with
     f32 moments, lr TRAIN_LR): 6 steps at 16 x 64 in each mode from seed 0 (finite
     losses, the sixth below the first, step 1's kernel loss within
     LOGITS_TOL_FACTOR x bulk's distance from an exact f32 evaluation,
     steps 2-6 within TRAIN_LOSS_REL of bulk's, 56 flash launches a
     kernel-mode step, 0 in bulk mode; ms a step, its forward / backward /
     optimizer split, tok/s, device busy share, peak memory); then 3
     kernel-mode steps at 4 x 2048 tokens
 28. (cut for phases 44-48's time: the serving launcher at tp = 4 in
     fused mode, which phase 31 runs with the same gates and auto knobs)
 29. (run after phase 35) a spawned tp = 4 world on the card,
     teacher-forced on the first TP_STEPS (2) of phase 5's inputs, logits against phase 5's exact f32
     evaluation: fused within LOGITS_TOL_FACTOR x bulk's own distance at
     that tp, skew 1 bit-identical to skew 0, an fp8 wire within its stated
     bound, every rank's logits equal (the tp = 2 world and the oblivious
     and bf16-wire settings were cut for phases 44-48's time); then matmul_allreduce fused (by
     rows) and bulk at [4,13696]@[13696,4096] row-sharded over the world
     against torch.matmul of the whole in f32.  Every time 28-29 print is
     labelled "one card, N processes, wire staged through host": no
     NVLink number
 30. the overlap autotuner at tp = 1 on phase 5's seed-0 weights, kernel
     mode: (a) launch.serve.main with --granularity auto --wire auto (the
     H100 NVLink link class), every decision printed, 28 fused launches a
     step, the streams phase 5's (or apart first at a near tie); (b) a
     DegradationPolicy with the FFN down's key quarantined through
     record_failure: phase 5's teacher-forced steps with 0 fused launches,
     28 demotions a step, logits within LOGITS_TOL_FACTOR x bulk mode's
     distance from exact f32; (c) released after cooldown record_healthy
     calls: 28 launches a step again; (d) the host time of one cache-hit
     resolve (through the memo and through the TuneKey)
 31. (after phase 29) the launcher at tp = 4 (gloo, one card; its main()
     in 4 of the pool's processes, joined through --coordinator) with
     --fusion fused --granularity auto --wire auto --calibrate
     --tune-cache: every rank's
     model and measured decisions and candidate times equal, the cache's
     keys under the gloo link class, the streams phase 28's (or apart first
     at a near tie).  (A second launch from the saved cache was cut for
     phases 41-43's time; tests/test_torch_autotune.py holds the round
     trip.)  Labelled "one card, N processes, wire staged through host: not
     NVLink"
 32. flash_attention with gemma2-27b's sliding window (4096) and softcap
     (50) against its plain version: [1, 8192, 32/16, 128] bf16 (scale
     144^-0.5, q scaled so that the scores reach 2-3x the cap; the share the
     cap bends printed) with both, either alone, a window of 1000 at S =
     3001 (causal and not), hd 64 in bf16 and the CUDA-core path in f32 at hd
     64 and 128, every bf16 hd 128 shape also on the CUDA-core path; m and l
     with both against the plain version's; the op's gradient with both
     against bulk mode's autograd through span_attention, each from an
     exact evaluation; times at [4, 2048, 32/16, 128] with and without the
     cap and at [1, 32768, 32/16, 128] causal, windowed and both, beside
     their bounds (the flex_attention yardsticks were cut for phases
     44-48's time)
 33. full-width gemma2-27b (46 layers, seed-0 weights) prefill of 1 x 8192
     seeded tokens in kernel and bulk mode: 46 flash launches on the tile
     path (23 windowed, all capped), every layer's flash output against the
     plain version on its input, logits against an exact f32 evaluation
     (layers upcast one at a time); 8 greedy decode steps from position 8192
     in an 8200-position cache, the first against a prefill over 8193
     tokens, both modes' streams; prefill times, profile, peak memory
 34. gemma2-27b decode through DecodeEngine at the launcher's traffic
     (batch 4, 4 requests x 8 tokens): 46 fused launches a step on the stream
     path, teacher-forced logits against bulk mode and exact f32, streams;
     the launcher itself, --arch gemma2-27b --paged (block 16, chunk 8), in
     both modes: 46 fused launches a step (the tile path at the chunk's 32
     rows), teacher-forced logits, streams; times of decode and serve steps,
     profiles, the fused kernel at [4,36864]@[36864,4608] and at 32 rows
     beside torch.matmul and its bound
 35. flash_attention as a KV-ring hop's consumer (keys of their own length
     Sk at an offset delta from the queries, statistics with stats=True)
     against its plain version on both paths: chatglm3-6b's hops at tp = 4
     ([4, 512, 32/2, 128]: the local causal span, whole spans of ranks d-1
     and d-3, a sub-chunk of 256 keys), gemma2-27b's windowed and capped hop
     at tp = 4 ([1, 2048, 32/16, 128], delta 4096, window 4096, cap 50; its
     last row sees no key) and a span no row sees (o = 0, m = -1e30, l =
     0); o, m and l; Sk = Sq, delta = 0 bit-identical to the call without
     them; times beside the bound and F.scaled_dot_product_attention on the
     same unmasked hop
 36. a spawned tp = 4 gloo world on the card, full-width chatglm3-6b
     prefill of the first RING_B (1) of phase 20's 4 rows of 2048 tokens
     through prefill_fn in bulk and
     kernel mode and fused at 2 sub-chunks with a bf16 wire at skew 0 and
     1; logits against phase 20's exact f32 evaluation and each rank's
     cache chunk against phase 20's kernel-mode rows, within
     LOGITS_TOL_FACTOR x bulk's own distance; every rank's logits equal; skew 1
     bit-identical to skew 0; 28 (1 + d) flash launches on rank d in kernel
     mode, 0 otherwise; the hand-off (the chunks gathered into a tp = 4
     decode cache, one fused-mode decode step from position 2048, against
     phase 20's prefill over 2049 tokens); ms a prefill, labelled "one
     card, N processes, wire staged through host"
 37. gemma2-27b at full width cut to its first 4 layers (2 local, 2
     global), prefill of 1 x 8192 seeded tokens at tp = 4 (spawned gloo
     world) in kernel and fused mode: logits against a tp = 1 kernel-mode
     prefill of the same layers and its exact f32 evaluation (within
     LOGITS_TOL_FACTOR x the tp = 1 prefill's distance), the ring's hops a
     layer (2 on the windowed layers, 3 on the global ones) and sends,
     flash launches a rank, ms a prefill
 38. training at tp > 1: a spawned gloo world of 4 ranks on the card,
     full-width chatglm3-6b cut to 2 layers at phase 27's 4 x 2048 tokens
     through loss_fn: tp = 4 in kernel mode and fused at 2 sub-chunks with a
     bf16 wire at skew 0 and 1, tp = 2 (the world's pairs) in kernel mode
     (bulk and plain fused mode at tp = 4 were cut for phases 41-43's time);
     the loss and each rank's shard of every gradient (the whole leaves
     all-reduced) against one exact f32 tp = 1 evaluation written to a file
     the ranks map, within LOGITS_TOL_FACTOR x tp = 1 bulk mode's distance
     on that leaf; every rank's loss equal, the whole leaves' gradients
     bit-identical across the ranks, skew 1 bit-identical to skew 0 (every
     leaf but the table, whose scatter-adds are atomics), 2 L (1 + d) flash
     launches on rank d in kernel mode (forward and remat), 0
     otherwise; ms of forward, backward and the gradients' all-reduce
 39. 3 AdamW steps (lr TRAIN_LR) of the model cut to 2 layers at 4 x 2048
     at tp = 4 in kernel mode (spawned world; fused mode cut for phases
     41-43's time): losses within
     TRAIN_LOSS_REL of 3 tp = 1 kernel-mode steps, every whole parameter
     bit-identical across the ranks after the last step, ms a step split
     into forward, backward, all-reduce and optimizer, each rank's peak
     memory
 40. the train launcher at tp = 1 (--fusion kernel, full width cut to 2
     layers, 3 steps at lr TRAIN_LR) in this process, the yardstick of the
     same flags at tp = 2 (--backend gloo), which runs after phase 43's
     launchers and is checked there: every rank's losses equal, the losses
     within TRAIN_LOSS_REL of tp = 1's.  Phases 38-40 are labelled "one card, N processes, wire staged
     through host"
 41. paged serving at tp = 4 and 2 (a spawned gloo world of 4 ranks on the
     card; tp = 2 on its pairs), full-width chatglm3-6b cut to PAGED_TP_LAYERS
     layers, fused and bulk mode at tp = 4, fused at tp = 2, phase 23(b)'s
     traffic (prompts of 1-250
     seeded tokens x 8 new, batch 4, chunk 8, the launcher's default pool
     striped over the ranks): every rank's streams equal, and equal to a tp
     = 1 paged run's (bulk) or apart first at a near tie; each request's
     first generated token's logits against a dense prefill_fn of its prompt
     within LOGITS_TOL_FACTOR x the larger of the tp = 1 paged run's and the
     dense prefill's distances from their exact f32 evaluations; each
     stripe's peak of blocks the tables name; ms a serve_step at C = 1 and C
     = 8 (slowest rank), beside tp = 1's
 42. the data axis: first, here, the fused kernel at a (4, 1) replica's
     decode row ([1, 13696] @ layer 0's w_down, the stream path) and flash
     with statistics at its training row ([1, 2048] x 32/2 heads of 128)
     against their plain versions; then one spawned gloo world of 4 ranks
     on the card: (a) (dp, tp) = (4, 1) in kernel mode: DATA_LAYERS-layer
     decode at B = 4 (a replica's one row, the fused kernel's stream path,
     launches counted) teacher-forced, logits within LOGITS_TOL_FACTOR x tp
     = 1 bulk's distance from exact f32; phase 38's gradients (2 layers, 4
     x 2048, a replica's row; timed cold, without a warm-up pass) with
     flash launches a rank, every fsdp shard within LOGITS_TOL_FACTOR x tp
     = 1 bulk's distance; (b) (2, 2) in fused and bulk mode: the same
     decode, phase 41's paged traffic (streams and first tokens as there),
     phase 38's gradients in fused mode (one sub-chunk, f32 wire: every
     shard within LOGITS_TOL_FACTOR x tp = 1 bulk's distance), phase 39's
     first 2 AdamW steps (losses within TRAIN_LOSS_REL of its tp = 1
     steps), ms a step split with the data-axis collectives' host time
     apart; after the gradients and the steps, each leaf bit-identical on
     the ranks that hold the same part of it; each rank's parameter and
     moment bytes a leaf the (1, 2) world's (the pairs) over 2 where the
     leaf splits over data, and a rank's peak memory below the (1, 2)
     world's by at least the bytes that split saves
 43. the launchers at --dp 2 --tp 2, one after the other, each main() in
     the pool's 4 processes: train (phase 40's flags at 2 steps: every
     rank's losses equal, within TRAIN_LOSS_REL of phase 40's first 2 tp =
     1 losses) and serve --paged (full width, fused, 4 requests x 8 tokens:
     every rank's streams equal, phase 5's or apart first at a near tie),
     then phase 40's train launcher at --tp 2 in 2 of them.  (Through
     torch.distributed.run, three launchers at once in 10 processes of
     their own, they took 43.0 s: cut to no process start.)  Phases 41-43 are labelled "one card, N
     processes, wire staged through host"
 44. (runs after phase 10, on phase 9's weights) the MoE kernels at prefill
     rows: the expert FFN's tile path (tensor cores, C > 8) at dbrx's widths
     against its plain version at C = 2560 (the prefill of 4 x 2048), 1280
     (a prefill of 2 x 2048) and 640 (phase 46's training microbatch of 1 x
     2048), launches counted by path; the
     emulated 4-rank world on the tile path at C = 160; the dispatch's VJP
     bit-identical to the kernel on the cotangent; times beside the bound
     and bulk mode's three einsums, in turns
 45. (after 44) dbrx-132b's prefill of 4 x 2048 seeded tokens at phase 9's 8
     layers through prefill_fn in kernel and bulk mode: launches (a dispatch,
     a tile-path expert FFN and a flash launch a layer), no plan built by a
     second prefill, every MoE layer's kernel output against bulk mode on
     its input (REL_BF16), the logits within LOGITS_TOL_FACTOR x bulk's
     distance from an exact f32 evaluation (bulk and exact teacher-forced on
     the kernel run's routing); 8 greedy decode steps from the prefill's
     cache (stream-path launches, bulk teacher-forced on the tokens)
 46. dbrx-132b cut to 2 layers (14 GB bf16) on one card: every gradient at
     16 x 64 tokens in kernel and bulk mode against exact f32 (kernel
     within LOGITS_TOL_FACTOR x bulk's on every leaf, routing teacher-forced
     on the exact run's), launches; 4 steps of Adafactor with 2 microbatches
     at 2 x 2048 on one batch in each mode (the loss falling, steps 2-4 within
     TRAIN_LOSS_REL of bulk's), launches, ms a step, peak memory
 47. dbrx-132b at 2 full-width layers over a spawned gloo world of 4 ranks
     on the card, 2 x 1024 tokens: tp = 4 prefill and gradients in bulk and
     fused mode (skew 0 and 1), (2, 2) decode EP (4 steps) and an Adafactor
     step over shards (on 1 layer) with a forward after it; the tp = 1 yardsticks (exact f32 and bulk, the MoE
     layers run in the world's per-rank blocks, routing teacher-forced)
     made here first; logits, the loss and 65536 sampled elements of every
     gradient within LOGITS_TOL_FACTOR x tp = 1 bulk's distance from exact
     f32, the ranks' logits equal, skew 1 bit-identical to skew 0 (every
     leaf but the table), the (2, 2) losses before and after the step
     within TRAIN_LOSS_REL of tp = 1's, the loss falling
 48. the launchers with --arch dbrx-132b --tp 2 --layers 2 (gloo, fused),
     both at once, each main() in 2 processes of a fresh pool (through
     torch.distributed.run they took 30.1 s): train 1 step at 2 x 1024
     (every rank's loss equal, finite) and serve 4 requests x 8 tokens through decode EP (every
     rank's streams equal).  Phases 47-48 are labelled "one card, N
     processes, wire staged through host"
 49. DLRM training on one card at the paper's widths with 32 of its 512
     tables (11.78 GB), the train_8k batch of 8192: the loss and every
     gradient in bulk and fused mode against an f64 evaluation (65536
     sampled elements of the tables' gradient, the MLP leaves whole),
     fused within LOGITS_TOL_FACTOR x bulk's distance on every leaf (and
     whether its bits are bulk's); kernel mode's gradient raising; 3 AdamW
     steps a mode on the batch (fused within TRAIN_LOSS_REL of bulk's, the
     loss falling; ms a step split, busy share, peak); the trained
     parameters scored in kernel mode (one pooling launch) against bulk's
     logits
 50. DLRM over a (dp, tp) = (2, 2) world of the pool's gloo processes, 16
     tables (4 a rank), batch 8192: scoring in bulk, fused (2 sub-chunks,
     skew 0 and 1, f32 and bf16 wire) and kernel mode (8 embedding_pool
     launches a rank, each against its plain version), every rank's rows
     against tp = 1 bulk's logits, skew 1 bit-identical; a loss with
     gradients in bulk and fused mode (skew 0 and 1), every shard within
     LOGITS_TOL_FACTOR x tp = 1 bulk's distance from f64, skew 1
     bit-identical on every leaf; one AdamW step, the MLP leaves
     bit-identical on every rank after it.  Labelled "one card, N
     processes, wire staged through host"
 51. the train launcher in this process: --arch dlrm --tables 32 --fusion
     fused --batch 8192 --steps 3 --lr 1e-3, the loss falling; ms a step
     split, busy share, peak
 52. full-width chatglm3-6b cut to 1 layer, kernel mode, 6 AdamW steps at
     4 x 512 tokens under the fault-tolerant supervisor with a seeded plan
     (slow link, timeout, rank failure: 2 restarts) and async checkpoints
     every 2 steps: the counts, every leaf of the final state a plain
     loop's bits (where two plain runs differ, within their spread), the
     flash kernel's launches with the replays; each save's and restore's
     seconds and GB/s
 53. the train launcher in this process twice on one --ckpt-dir: 4 steps,
     then 6, resuming at step 4; the losses phase 52's plain steps
 54. the paged serve launcher in this process, 2 layers, kernel mode,
     clean and under --chaos (2 ticks dropped): the same tokens and fused
     launches; a rank loss at one rank raises
 55. the respawn protocol in training: the train launcher on phase 52's
     setup at --dp 2 over gloo as the workers of MultiprocessDriver
     (processes sharing the card), rank 1 SIGKILLed at step 3; rank 0 exits
     17 through the heartbeat watchdog, a world of one resumes from the
     checkpoint; its final checkpoint and losses are, bit for bit, a
     fault-free launcher's from a copy of the checkpoint directory taken at
     generation 0's end and an in-process kernel-mode run's from another
     copy (2 flash launches a layer a step, tile path); detection, respawn
     and restore seconds
 56. the respawn protocol in serving: the dense serve launcher over 2
     layers at --dp 2 with --journal, rank 1 SIGKILLed at tick 10; rank 0
     journals the unfinished requests and exits 17, a world of one drains
     them; every request once, the tokens an uninterrupted drain's (fused
     GEMV + AllReduce launches counted on its stream path)
 57. full-width deepseek-v3-671b cut to 5 of its 61 layers (the 3
     dense-prefix layers and 2 MoE layers, 51.4 GB bf16), kernel mode
     against bulk mode: (a) the serve launcher in this process at --arch
     deepseek-v3-671b --layers 5 --fusion kernel (launches counted); (b)
     the path's three kernels against their plain versions at its shapes
     (the dispatch at C = 1 and 320, the expert FFN's stream path at C = 1
     and tile path at C = 320 on layer 3's 256 experts, the fused GEMV at
     [4,18432]@[18432,7168]); (c) DecodeEngine's drain of 4 requests x 8
     tokens: 2 dispatch, 2 stream-path expert FFN and 3 stream-path fused
     GEMV launches a step, no flash; every MoE layer's kernel output against
     bulk on the identical input; the model teacher-forced (tokens and
     experts) against bulk and exact f32, logits and the latent caches (c,
     kr); (d) a prefill of 4 x 2048 (2 dispatch and 2 tile-path expert FFN
     launches, no flash, no fused GEMV), its logits and latent caches held
     the same way, then 8 greedy decode steps from its cache
 58. times from CUDA events on phase 57's weights: prefill and decode step
     in both modes with the device's busy share; the expert FFN on the main
     path's own buffers (C = 1 stream path, C = 320 tile path) against bulk
     mode's einsums and its bound counted on what the buffer needs; the
     dispatch at both; the fused GEMV against torch.matmul; MLA's plain
     prefill attention a layer
 59. zamba2-7b at its published widths and full depth (81 Mamba-2 blocks:
     13 groups of 6 with the shared attention block after each, and a tail
     of 3; 13.95 GB bf16), kernel mode against bulk mode: (a) the serve
     launcher in this process at --arch zamba2-7b --batch 4, 8 requests,
     so every slot is reused once: 94 stream-path fused GEMV launches a
     step (81 Mamba w_out, 13 shared-MLP downs), no flash; the second
     wave's streams a fresh engine's on those requests (the reused slots'
     states zeroed); (b) the flash kernel at head size 224 against its
     plain version (zamba2's prefill shape [4,2048,32,224] bf16 causal, f32,
     a ragged Sk at an offset with statistics, non-causal, odd S), and the
     fused GEMV at zamba2's three shapes ([4,7168]@[7168,3584] and
     [4,14336]@[14336,7168] on the stream path, [8192,7168]@[7168,3584] on
     the tile path); (c) a prefill of 4 x 2048 (81 tile-path fused GEMV and
     13 flash launches on the CUDA-core path; each flash output against
     plain on its input) in kernel and bulk mode against an exact f32
     evaluation (groups upcast one at a time): logits, SSM and conv states,
     k and v; (d) 8 greedy decode steps from its state (k and v in rows
     [0, 2048) of init_cache's buffers), bulk and exact f32 teacher-forced
     on the kernel run's tokens, logits and final states held the same
     way; the hand-off: a 64-token prefill against a 56-token prefill and
     8 decode steps
 60. times from CUDA events on phase 59's weights: a prefill and a decode
     step in both modes with the device's busy share and top device ops;
     the flash kernel at [4,2048,32,224] against
     F.scaled_dot_product_attention, its plain version and its bound; the
     fused GEMV at zamba2's three shapes against torch.matmul, the plain
     version and the bound
 61. qwen2-vl-2b at its published widths and full depth (28 layers, 12/2
     heads of 128, M-RoPE (16, 24, 24), the stub vision front end; 3.1 GB
     bf16), kernel mode against bulk mode: (a) the serve launcher's drain
     of 8 requests x 8 tokens at batch 4 in kernel mode (28 stream-path
     fused GEMV launches a step, no flash) and in bulk mode (none); (b) a
     prefill of 4 x 2048 with patch embeddings on the first 256 positions
     and mrope_positions' streams (28 tile-path flash launches at GQA 6;
     each flash output against plain on its input) in kernel and bulk
     mode against an exact f32 evaluation (layers upcast one at a time):
     logits, k and v; then 8 greedy decode steps from its cache, bulk and
     exact f32 teacher-forced on the kernel run's tokens; (c) the paged
     serve_step at C = 8 and C = 1 (28 fused GEMV launches, tile and stream
     path) against bulk and exact f32, then again under
     torch.cuda.set_sync_debug_mode("error"); times: a prefill and a
     decode step in both modes (profiles), the flash kernel at
     [4,2048,12/2,128] against F.scaled_dot_product_attention, plain and
     its bound, the fused GEMV at [4,8960]@[8960,1536] and
     [32,8960]@[8960,1536] against torch.matmul, plain and the bound; (d)
     3 AdamW steps of the train launcher in kernel mode at 4 x 2048 with
     its vision extras, lr TRAIN_LR: the loss falls, 56 flash launches a
     step
 62. musicgen-medium at its published widths and full depth (48 layers, 24
     heads of 64, gelu, the stub audio front end; 3.6 GB bf16): phase 61's
     (a), (b) with frame embeddings on every position (48 flash launches on
     the CUDA-core path, head size 64) and times (the flash kernel at
     [4,2048,24,64], the fused GEMV at [4,6144]@[6144,1536]), and (d) at
     16 x 64 tokens
 63. zamba2-7b training at its published widths, depth cut to 13 Mamba-2
     blocks (2 groups of 6 and a tail of 1, the reduced model's
     structure): (a) the loss and every gradient at 4 x 2048 in kernel
     and bulk mode against an exact f32 evaluation, each leaf's largest
     error within LOGITS_TOL_FACTOR x bulk's, the loss within
     LOGITS_TOL_FACTOR x bulk's distance or LOSS_FLOOR's, kernel mode's
     launches (a CUDA-core flash launch at head size 224 a group, forward
     and remat; a tile-path fused GEMM a Mamba block's w_out, forward and
     recompute);
     (b) the train launcher's 3 AdamW steps at 4 x 2048, lr TRAIN_LR, in
     each mode: losses falling, every step's within TRAIN_LOSS_REL of
     bulk's, the launches of every step, the step's split and peak
     memory; (c) the flash op's analytic backward at [4,2048,32,224]
     against an exact f32 evaluation (LOGITS_TOL_FACTOR x bulk's autograd)
     and timed beside SDPA's backward, and the SSD scan's forward and
     backward at a block's [4,2048,112,64] with its peak

chatglm3-6b's weights are freed before phase 7, dbrx-132b's before phase
11, DLRM's before phase 15, rwkv6-7b's before phase 19, the prefill's
before phase 25; phases 28-29 run in processes of their own, each holding
its shards; phase 30 draws the seed-0 weights again; phase 33 draws gemma2-27b's, freed after phase 34;
phases 36-37 run in processes of their own (phase 20's logits, exact
logits and cache stay on the host for phase 36: GLM_PREFILL), phase 37's
tp = 1 yardsticks draw gemma2's first 4 layers and free them first;
phases 38-40 draw chatglm3-6b's first layers here for their tp = 1
yardsticks, free them, and run their worlds in processes of their own;
phases 41-42 do the same, phase 42 reusing phases 38, 39 and 41's
yardsticks (phase 38's exact gradients stay in a file under build/ until
phase 42 ends), and phase 43 runs the launchers.  Phases 44-45 run inside
the dbrx phases, after phase 10, on phase 9's weights; phases 46-51 run
last, in the order 46, 47, 50, 48, 49, 51, each drawing its own weights
(phase 47's and 50's in the pool's processes, 48's in a pool of its
own); phases 52-54 run
after them, each drawing its own weights; phases 55-56 after those, their
workers in processes of their own; phases 57-58 after those, the launcher's
weights drawn and freed before the phase draws its own; phases 59-60 after
those, the same way; phases 61-62 last, the same way, each launcher run
drawing and freeing its own weights; phase 63 after them, drawing
its own.  Phase 29 runs after phase 35: its world starts one pool of 4
rank processes (spawn_world) that the worlds of phases 31, 36-47 and 50
reuse, each opening and closing its own process group (a launcher's
main() through --coordinator, pool_launchers); the pool ends after phase
50, and phase 48 runs in a pool of its own.
Every line ends with the seconds since the previous line and since the
start; the end line gives each phase's seconds.  Phases 5, 9 and 17
and the end print how many launch plans the plan-cached wrappers hold.
Then one JSON line per the kernels, the card's name and power limit, and
the result line.  Float32
matrix products run in full f32 here (``allow_tf32`` off for cuBLAS and
cuDNN), so the plain versions are exact f32 references.  The caching
allocator grows expandable segments (``PYTORCH_CUDA_ALLOC_CONF``, unless
the caller sets it): with fixed segments phase 22's 4 x 32768 prefill runs
out of memory on an 80 GB H100 with 55 GB allocated and 21 GB reserved but
unused.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
import torch  # noqa: E402  (the allocator reads its settings at first use)

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
BF16_FLOPS = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12            # H100 SXM float32 peak outside the tensor cores

# Kernel against its plain version in bf16: both sum in f32, in different
# orders, and round once to bf16, whose step is 2^-8 relative.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
# The flash kernel at 32768 keys against its plain version: a softmax over
# n keys averages n rows of v ~ N(0, 1), so |out| is about sqrt(e / n),
# 0.01-0.02 on long rows, below BF16_TOL's atol.  There every element must
# lie within ROW_REL of its row's rms (plus BF16_TOL's rtol of |want|) and
# every row's ||got - want|| within ROW_REL of ||want||: rounding P and the
# output to bf16 costs 2^-8 relative at most.
ROW_REL = 2.0 ** -6
# f32 inputs with an f32 wire: only the f32 summation order differs
# (TOL["f32"] of tests/test_parity_matrix.py).
F32_TOL = dict(rtol=3e-4, atol=3e-4)
# f32 inputs with wire="bf16": each remote partial is rounded to bf16
# once (WIRE_TOL["bf16"] of tests/test_parity_matrix.py).
WIRE_BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# Logits of kernel mode against bulk mode at full width: the two FFN down
# projections each round once to bf16 but may round differently, and a
# random-weight model carries that difference through 28 bf16 layers into
# the logits, so no fixed bf16 bound holds.  The bound is measured in the
# run instead: the bulk path's own largest distance from an exact f32
# evaluation of the same weights on the same inputs.  A kernel path as
# accurate as the library's lies within twice that of the bulk path; the
# bound allows three times.
LOGITS_TOL_FACTOR = 3.0
# A mean loss against its exact f32 evaluation: each token's loss comes from
# bf16 logits, which round by 2^-8 relative at most, and the B x S tokens'
# roundings are independent, so the mean's rounding is about 2^-8 |loss| /
# sqrt(B x S).  Bulk mode's own distance may fall far below that by chance
# (zamba2-7b's 13 blocks: one f32 step, 9.5e-07 at 11.08, on an H100), so
# the bound is LOGITS_TOL_FACTOR x the larger of the two.
LOSS_FLOOR = 2.0 ** -8

MAIN_B, MAIN_K, MAIN_N = 4, 13696, 4096   # chatglm3-6b w_down, batch 4

# dbrx-132b's MoE layer at batch-4 decode: 16 experts, capacity
# C = ceil(4 tokens x top-4 x 1.25 / 16) = 2, d_model 6144, d_ff 10752
MOE_E, MOE_C, MOE_D, MOE_F = 16, 2, 6144, 10752
DBRX_LAYERS = 8        # of 40: the depth that fits one 80 GB card (53.4 GB)
# DLRM's 512 published tables of 1,000,000 x 92 f32 are 188.4 GB; 128 tables
# (47.1 GB) are one rank's share of a 4-rank world, every width as published
DLRM_TABLES = 128
# The MoE tolerances are relative to the largest |plain| value: the
# reference's init gives expert weights std ~0.22 (fan_in = the expert
# count), so expert outputs are of order 1e3-1e4.  f32 with an f32 wire:
# the summation order only.  bf16 inputs: the kernel keeps h and g in f32
# and rounds u once, as the TPU kernel does; the plain version rounds h, g
# and act(g) h to bf16 as the JAX reference does.  bf16 wire: one bf16
# rounding per value that crosses ranks.
REL_F32, REL_BF16, REL_WIRE_BF16 = 3e-4, 2e-2, 3e-2
# Where kernel and bulk mode first route a token differently, their MoE
# inputs must still agree to rounding: a difference below 2^-4 of the
# largest |h| says a near tie flipped, not a fault.
H_DIVERGE_REL = 2.0 ** -4
# rwkv6-7b: prefill of 4 prompts of 512 seeded tokens (the WKV6 kernel's
# main-path shape B*H = 256, T = 512, N = 64, chunk 64), 8 greedy decode
# steps, and the prefill/decode hand-off over the first 64 tokens
RWKV_B, RWKV_T, RWKV_STEPS, RWKV_HANDOFF = 4, 512, 8, 64
# chatglm3-6b prefill of 4 prompts of 2048 seeded tokens (the flash kernel's
# main-path shape: B 4, S 2048, 32 query heads over 2 kv heads of 128), then
# 8 greedy decode steps from position 2048 in a cache of 4096 positions
GLM_B, GLM_S, GLM_STEPS = 4, 2048, 8
# chatglm3-6b prefill at the reference's prefill_32k length (registry.py:
# batch 32 x 32768), cut to batch 4: each row of 32768 tokens takes 13.6 GB
# beside the 13.4 GB held before the prefill (the weights among them), so
# 4 rows peak at 68 GB of the card's 85; 5 rows also run, at 81.7 GB, but
# the device then idles 4.6 % of the prefill against 0.1 % at 4 (PERF.md
# section 4).  Phase 22 prints the peak, the memory held before the
# prefill, each row's share, and what one more row would need.
LONG_B, LONG_S = 4, 32768
# chatglm3-6b training (phases 25-27): the launcher's defaults, 16 x 64
# tokens, TRAIN_STEPS steps a mode on all 28 layers; phase 26's gradients on
# TRAIN_GRAD_LAYERS layers; then TRAIN_LONG_STEPS kernel-mode steps at the
# prefill's 4 x 2048 tokens on TRAIN_LONG_LAYERS layers
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_GRAD_LAYERS = 16, 64, 6, 2
TRAIN_LONG_B, TRAIN_LONG_S, TRAIN_LONG_STEPS, TRAIN_LONG_LAYERS = 4, 2048, 3, 28
# The launcher's default lr, 3e-3, suits the reduced model (d_model 64).  At
# full width AdamW's first steps move every weight by about the lr, in the
# sign of its gradient, coherently across 4096-wide matrices: on an H100
# the loss rose within 6 steps at a peak lr of 1e-3, 3e-4 and 1e-4 and fell
# at 3e-5 (PERF.md, PR 22).  Phase 27 passes --lr TRAIN_LR.
TRAIN_LR = "3e-5"
# Steps 2-6 of kernel and bulk mode: the two runs start from the same
# weights and differ only by rounding in attention, so their gradients
# differ by bf16 rounding; Adam makes each step about +-lr per element, so
# only elements whose gradient is within that rounding of zero move
# differently (by at most 2 lr each).  The losses must stay within 1 % of
# each other; a wrong or missing attention gradient changes the whole
# update (phase 26 checks the gradients themselves).
TRAIN_LOSS_REL = 0.01


# seconds each phase took: a phase's time runs from the previous line that
# say() printed to its own last line
CLOCK = {"start": time.perf_counter(), "last": time.perf_counter(), "phases": {}}


def say(phase, msg):
    """One result line of ``phase``, ending with the seconds since the
    previous line (this phase's own time, or its part since its previous
    line) and since the start of the script."""
    now = time.perf_counter()
    took = now - CLOCK["last"]
    CLOCK["last"] = now
    CLOCK["phases"][phase] = CLOCK["phases"].get(phase, 0.0) + took
    print(f"[{phase}] {msg} [{took:.1f} s; {now - CLOCK['start']:.1f} s since the start]",
          flush=True)


def phase_seconds() -> str:
    """Every phase's seconds, in the order the phases ran."""
    return ", ".join(f"{p_} {t_:.1f}" for p_, t_ in CLOCK["phases"].items())


# The tensor-parallel world (phases 28-29): full-width chatglm3-6b decode at
# tp = 4, and at tp = 2 with 2 sub-chunks a rank (decode's 4 rows split into
# 2 x 2 ring chunks), as processes that share the one card in a gloo world
# whose wire goes through host memory.  Its times say nothing about NVLink.
TP_WORLD, TP_PAIR, TP_PAIR_Q = 4, 2, 2
# Phase 29's spawned worlds replay the first TP_STEPS of phase 5's 12
# teacher-forced steps a setting (cut from all 12: on one H100 80GB HBM3 a
# step of the tp = 4 world takes about 0.75 s, and its six settings took 63
# s of a 719 s run of this script; cut to 2 when phases 38-40 came, to keep
# the script under 900 s)
TP_STEPS = 2
TP_LABEL = "one card, {} processes, wire staged through host"
# An fp8 wire (e4m3 with a per-chunk scale) keeps 3 mantissa bits against
# bf16's 7: each value it carries rounds by up to 2^-4 relative where the f32
# wire of a bf16 model rounds the same values by 2^-8, 16 times as much, so
# its logits are held to 16 x the f32 wire's bound.  A bf16 wire rounds
# those values as the f32 wire does (the model is bf16) and adds in f32: the
# f32 wire's bound.
FP8_WIRE_FACTOR = 16.0
# the FFN down at decode's shape, row-sharded over the world, against the
# whole product in f32: each rank's partial rounds to bf16 and the ring adds
# the partials in bf16, one rounding (2^-8 relative) per add
TP_OP_TOL = BF16_TOL
GLM_DECODE: dict = {}     # phase 5's run, which phases 28-29 are held to


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def split_ms(fn, calls=1000, prof_calls=200) -> tuple[float, float, float]:
    """(device ms per call, host ms per call, device ops per call) of ``fn``:
    the device time is the sum of the CUDA activity that torch.profiler
    records over ``prof_calls`` calls (CUDA activity only: see
    :func:`profile_device`); the host time is time.perf_counter over
    ``calls`` calls, profiler off, divided by the count (the enqueue: no
    synchronise inside the window)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(prof_calls):
            fn()
        torch.cuda.synchronize()
    dev = [e.time_range.elapsed_us() for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device time")
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return sum(dev) / 1e3 / prof_calls, host, len(dev) / prof_calls


def bound_ms(b, k, n, itemsize):
    """Least time for y[b, n] = x[b, k] @ w[k, n]: each input read once and
    the output written once over HBM, or the FLOPs at the bf16 peak."""
    bytes_moved = (b * k + k * n + b * n) * itemsize
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * b * k * n / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def errors(got, want):
    """Max abs error, and that over the largest |want| (relative error)."""
    d = (got.float() - want.float()).abs().max().item()
    return d, d / max(want.float().abs().max().item(), 1e-30)


def check_close(name, got, want, tol):
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    torch.testing.assert_close(got.float(), want.float(), **tol, msg=lambda m: f"{name}: {m}")
    return errors(got, want)


def check_rows(name, got, want, rel=ROW_REL):
    """``got`` against ``want`` scaled to each row (the last dim) of
    ``want``: every element within ``rel`` x its row's rms plus BF16_TOL's
    rtol x |want|, and every row's distance within ``rel`` of its norm.
    Returns the largest element's share of its bound and the largest row
    distance over the row's norm."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    g, w = got.float(), want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    share = ((g - w).abs() / (rel * rms + BF16_TOL["rtol"] * w.abs())).max().item()
    row = ((g - w).norm(dim=-1) / w.norm(dim=-1)).max().item()
    if not (share <= 1 and row <= rel):
        raise AssertionError(f"{name}: largest element at {share:.3g} of its row-scaled bound, "
                             f"largest row distance {row:.3g} of its norm (bound {rel:.3g})")
    return share, row


def check_rel(name, got, want, rel):
    """Shape, finiteness, and max |got - want| within ``rel`` of max |want|."""
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: non-finite output")
    err = errors(got, want)
    if err[1] > rel:
        raise AssertionError(f"{name}: max abs err {err[0]:.3g} is {err[1]:.3g} of max |want|, "
                             f"above {rel:.3g}")
    return err


def randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def counted_wrappers():
    """Every kernel wrapper with a ``launches`` count."""
    from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_dispatch_a2a.ops import (fused_dispatch_a2a,
                                                            fused_dispatch_a2a_ranks)
    from repro_torch.kernels.fused_embedding_a2a.ops import (fused_embedding_a2a,
                                                             fused_embedding_a2a_ranks)
    from repro_torch.kernels.fused_gemm_a2a.ops import (fused_gemm_a2a, fused_gemm_a2a_ranks,
                                                        fused_moe_chain)
    from repro_torch.kernels.fused_gemv_allreduce.ops import (fused_matmul_allreduce,
                                                              fused_matmul_allreduce_ranks)
    from repro_torch.kernels.gemm.ops import gemm
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.rwkv6.ops import wkv6

    return (fused_matmul_allreduce, fused_matmul_allreduce_ranks, gemv, fused_dispatch_a2a,
            fused_dispatch_a2a_ranks, fused_gemm_a2a, fused_gemm_a2a_ranks, fused_moe_chain,
            embedding_pool_tables, fused_embedding_a2a, fused_embedding_a2a_ranks, wkv6, gemm,
            flash_attention)


def reset_counts():
    """Every wrapper's launch count, and its per-path counts, to 0."""
    for counted in counted_wrappers():
        counted.launches = 0
        for p_ in getattr(counted, "path_launches", {}):
            counted.path_launches[p_] = 0


def launch_counts():
    """wrapper name -> launches, and "name.path" -> that path's launches for
    the wrappers with two kernel paths (fused GEMV/GEMM, gemm)."""
    got = {}
    for c in counted_wrappers():
        got[c.__name__] = c.launches
        got.update({f"{c.__name__}.{p_}": v for p_, v in getattr(c, "path_launches", {}).items()})
    return got


def counted_run(fn, want):
    """``fn()`` with every launch count set to 0 first; fails unless the
    counts after it are ``want`` (wrapper name -> launches, 0 for a wrapper
    not named; "name.path" -> that path's launches, checked where named).
    Returns (fn's result, the counts)."""
    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    got = launch_counts()
    if any(got[n_] != want.get(n_, 0) for n_ in got if "." not in n_ or n_ in want):
        raise AssertionError(f"launches {got}, expected {want} and 0 elsewhere")
    return out, got


def on_path(wrapper, fn):
    """``fn()`` and the kernel path of ``wrapper`` it launched, which must be
    exactly one launch."""
    before = dict(wrapper.path_launches)
    out = fn()
    moved = {p_: v - before[p_] for p_, v in wrapper.path_launches.items() if v != before[p_]}
    if list(moved.values()) != [1]:
        raise AssertionError(f"{wrapper.__name__}: expected one launch, got {moved}")
    return out, next(iter(moved))


def plan_counts() -> str:
    """How many launch plans each plan-cached wrapper holds."""
    from repro_torch.kernels.fused_dispatch_a2a import ops as dispatch_ops
    from repro_torch.kernels.fused_gemm_a2a import ops as ffn_ops
    from repro_torch.kernels.fused_gemv_allreduce import ops as fused_ops
    from repro_torch.kernels.gemv import ops as gemv_ops

    return ", ".join(f"{n_} {len(m._PLANS)}" for n_, m in (
        ("gemv", gemv_ops), ("fused_matmul_allreduce", fused_ops),
        ("fused_dispatch_a2a", dispatch_ops), ("fused_gemm_a2a", ffn_ops)))


def plan_order_check(gen) -> str:
    """A stream plan stays launchable after a plan of the same kernel that
    needs less shared memory is built: rwkv6-7b's w_v ([4,14336]@[14336,4096],
    the deepest slice at 4 rows) is planned and launched, then a shallow
    [4,1024]@[1024,4096] of the same row block, then w_v is launched again
    from its cached plan, through gemv and fused_matmul_allreduce, each held
    against its plain version."""
    from repro_torch.kernels import cluster_capacity, load_library, sm_count
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.kernels.gemv.ops import gemv
    from repro_torch.kernels.gemv.plan import stream_plan
    from repro_torch.kernels.gemv.ref import gemv_ref

    bf16, lib = torch.bfloat16, load_library().lib
    deep_k, shallow_k = 14336, 1024
    xd, wd = randn(gen, (MAIN_B, deep_k), bf16), randn(gen, (deep_k, MAIN_N), bf16, deep_k ** -0.5)
    xs, ws = (randn(gen, (MAIN_B, shallow_k), bf16),
              randn(gen, (shallow_k, MAIN_N), bf16, shallow_k ** -0.5))
    out = []
    for name, fn, ref, fused in (("gemv", gemv, gemv_ref, 0),
                                 ("fused_matmul_allreduce", fused_matmul_allreduce,
                                  fused_matmul_allreduce_ref, 1)):
        cap = cluster_capacity(lib.repro_stream_capacity, fused, 1, 0, name=name)
        deep, shallow = (stream_plan(MAIN_B, k, MAIN_N, sms=sm_count(0), capacity=cap)
                         for k in (deep_k, shallow_k))
        if not (deep.rows_per_block == shallow.rows_per_block and shallow.smem < deep.smem):
            raise AssertionError(f"{name}: plans {deep} and {shallow} do not test the order")
        errs = []
        for x_, w_ in ((xd, wd), (xs, ws), (xd, wd)):
            got, took = on_path(fn, lambda: fn(x_, w_))
            if took != "stream":
                raise AssertionError(f"{name} [{MAIN_B},{x_.shape[1]}]: took the {took} path")
            errs.append(check_close(f"{name} [{MAIN_B},{x_.shape[1]}] after planning "
                                    f"{len(errs)} before it", got, ref(x_, w_), BF16_TOL)[0])
        out.append(f"{name} smem {deep.smem} then {shallow.smem} B, errs "
                   + "/".join(f"{e:.3g}" for e in errs))
    return "; ".join(out)


def serve_requests(step, bundle, batch, n_req, max_new):
    """Drain the launcher's seeded requests through DecodeEngine with the
    step function ``step``; returns (requests, host seconds)."""
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve.engine import DecodeEngine

    cfg = bundle.config
    eng = DecodeEngine(step, lambda b: bundle.init_cache(b, "cuda"), batch,
                       device="cuda", max_seq=cfg.max_seq)
    reqs = make_requests(n_req, cfg.vocab, max_new)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t = time.perf_counter()
    fin = eng.run_until_drained()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    if not fin.drained or len(fin) != n_req:
        raise AssertionError("engine did not drain")
    return reqs, dt


def near_tie_flips(streams_k, streams_b, chose, tol) -> list[str]:
    """Two runs' token streams (per request or slot) may part only at a
    near tie: where they first differ, the yardstick run's logits that chose
    the token (``chose(request, index)``) have a top-2 gap of at most twice
    ``tol`` (each side within it).  Returns a note per differing stream."""
    flips = []
    for key, (sk, sb) in enumerate(zip(streams_k, streams_b)):
        diff = [i for i, (a, b) in enumerate(zip(sk, sb)) if a != b]
        if diff:
            top = chose(key, diff[0]).float().topk(2).values
            gap = (top[0] - top[1]).item()
            flips.append(f"stream {key} token {diff[0]}: top-2 gap {gap:.3g} (allowed "
                         f"{2 * tol:.3g})")
            if gap > 2 * tol:
                raise AssertionError("token streams differ beyond a near tie: " + flips[-1])
    return flips


def timed_decode_runs(serve, dec_k, dec_b) -> str:
    """ms/step and tok/s of a whole drain in each mode, kernel then bulk
    (the turns kernel, bulk, bulk, kernel were cut for the script's time)."""
    def serve_timed(decode):
        log = []
        reqs, dt = serve(decode, log)
        return dt / len(log) * 1e3, sum(len(r.tokens) for r in reqs) / dt

    runs = {"kernel": [], "bulk": []}
    for mode, dec in (("kernel", dec_k), ("bulk", dec_b)):
        runs[mode].append(serve_timed(dec))
    return "; ".join(f"{m}: " + ", ".join(f"{ms:.2f} ms/step {tps:.1f} tok/s" for ms, tps in v)
                     for m, v in runs.items())


def wrapper_times() -> dict:
    """Loop time (CUDA events around back-to-back calls), device time per
    launch and host time per call (:func:`split_ms`) of the wrappers whose
    host cost the decode pays, at their main-path shapes: dbrx's dispatch
    beside Tensor.copy_, chatglm3-6b's w_down through gemv and
    fused_matmul_allreduce beside torch.matmul.  Only the public entry
    points are called, so the same function times another checkout's
    package when that checkout's ``src`` comes first on ``sys.path``."""
    from repro_torch.kernels import load_library
    from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
    from repro_torch.kernels.gemv.ops import gemv

    load_library()
    gen = torch.Generator(device="cuda").manual_seed(1)
    xt = randn(gen, (1, 1, MOE_E, MOE_C, MOE_D), torch.bfloat16)
    dst = torch.empty_like(xt)
    x = randn(gen, (MAIN_B, MAIN_K), torch.bfloat16)
    w = randn(gen, (MAIN_K, MAIN_N), torch.bfloat16, MAIN_K ** -0.5)
    got = {}
    for name, fn in (("fused_dispatch_a2a", lambda: fused_dispatch_a2a(xt)),
                     ("Tensor.copy_", lambda: dst.copy_(xt)), ("gemv", lambda: gemv(x, w)),
                     ("fused_matmul_allreduce", lambda: fused_matmul_allreduce(x, w)),
                     ("torch.matmul", lambda: torch.matmul(x, w))):
        loop = time_ms(fn, iters=200)
        dev, host, ops = split_ms(fn)
        got[name] = {"loop_ms": loop, "device_ms": dev, "host_ms": host, "device_ops": ops}
    return got


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import load_library
    from repro_torch.kernels.fused_gemv_allreduce.ops import (
        TILE_ROWS, fused_matmul_allreduce, fused_matmul_allreduce_ranks, fused_path)
    from repro_torch.kernels.fused_gemv_allreduce.ref import (
        fused_matmul_allreduce_ref, fused_matmul_allreduce_ref_ranks)
    from repro_torch.kernels.gemv.ops import gemv, gemv_path
    from repro_torch.kernels.gemv.ref import gemv_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    gen = torch.Generator(device="cuda").manual_seed(1)

    # 1 ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = load_library()
    load_s = time.perf_counter() - t0
    print(built.build_log, file=sys.stderr)
    say(1, f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
           f"kernels built in {built.build_seconds:.1f}s (loaded in {load_s:.1f}s) "
           f"-> {built.path.name}")

    # 2 ---------------------------------------------------------------
    # each shape on the path gemv_path chooses: the main shape (stream), ragged
    # K and N TMA still reads (stream), f32 (stream, one and two row blocks),
    # rows TMA cannot read (panel); the main shape also forced onto the panel
    bf16, f32 = torch.bfloat16, torch.float32
    x = randn(gen, (MAIN_B, MAIN_K), bf16)
    w = randn(gen, (MAIN_K, MAIN_N), bf16, MAIN_K ** -0.5)
    gemv_cases = {}
    for b, k, n, dt in ((MAIN_B, MAIN_K, MAIN_N, bf16), (5, 1000, 1000, bf16),
                        (11, 1000, 1001, bf16), (3, 777, 200, f32), (9, 4097, 1000, f32),
                        (3, 777, 201, f32), (1, 1, 8, bf16)):
        xg = x if b == MAIN_B else randn(gen, (b, k), dt)
        wg = w if b == MAIN_B else randn(gen, (k, n), dt, k ** -0.5)
        got, took = on_path(gemv, lambda: gemv(xg, wg))
        if took != gemv_path(dt, b, k, n):
            raise AssertionError(f"gemv [{b},{k}]@[{k},{n}]: took the {took} path")
        gemv_cases[f"[{b},{k}]@[{k},{n}] {str(dt)[6:]} {took}"] = check_close(
            f"gemv [{b},{k}]@[{k},{n}] {took}", got, gemv_ref(xg, wg),
            BF16_TOL if dt == bf16 else F32_TOL)
    gemv_err = gemv_cases[f"[{MAIN_B},{MAIN_K}]@[{MAIN_K},{MAIN_N}] bfloat16 stream"]
    gemv_cases["main shape forced onto the panel path"] = check_close(
        "gemv main panel", gemv(x, w, _path="panel"), gemv_ref(x, w), BF16_TOL)
    say(2, f"gemv vs plain (bound {BF16_TOL} bf16, {F32_TOL} f32), max abs/rel err on the path "
           f"gemv_path chooses: " + "; ".join(f"{n_} {e[0]:.3g}/{e[1]:.3g}"
                                              for n_, e in gemv_cases.items()))

    # 3 ---------------------------------------------------------------
    # the decode shape on the path the wrapper chooses and forced onto each of
    # the others; f32 calls (the stream path) and one TMA cannot read (the
    # panel path); the tile path at prefill rows, ragged edges (M, K off the
    # 128 x 64 tile) and one M below the tile's 128 rows
    main_path = fused_path(bf16, MAIN_B, MAIN_K, MAIN_N)
    fused_want = fused_matmul_allreduce_ref(x, w)
    fused_out, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, w))
    if took != main_path:
        raise AssertionError(f"fused n_dev=1: took the {took} path, fused_path says {main_path}")
    fused_err = check_close(f"fused n_dev=1 {took} path", fused_out, fused_want, BF16_TOL)
    forced = {p_: check_close(f"fused n_dev=1 {p_} path", fused_matmul_allreduce(x, w, _path=p_),
                              fused_want, BF16_TOL)
              for p_ in ("stream", "panel", "tile") if p_ != main_path}
    f32_cases = []
    for b, k, n, off in ((8, 2000, 1024, 0), (3, 777, 200, 0), (3, 777, 224, 1)):
        # off: w one element past a 16-byte boundary, which TMA cannot read
        xf = randn(gen, (b, k), f32)
        wf = randn(gen, (k * n + off,), f32, k ** -0.5)[off:].view(k, n)
        f32_out, f32_took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(xf, wf))
        if f32_took != fused_path(f32, b, k, n, aligned=off == 0):
            raise AssertionError(f"fused [{b},{k}]@[{k},{n}] f32 took the {f32_took} path")
        e = check_close(f"fused n_dev=1 f32 [{b},{k}]@[{k},{n}] {f32_took} path", f32_out,
                        fused_matmul_allreduce_ref(xf, wf), F32_TOL)
        f32_cases.append(f"[{b},{k}]@[{k},{n}]{' (unaligned w)' if off else ''} on the "
                         f"{f32_took} path {e[0]:.3g}/{e[1]:.3g}")
    tile_cases = []
    for b, k, n in ((2048, MAIN_K, MAIN_N), (130, 1000, 1024), (2049, 4104, 4096),
                    (100, 4096, 1024)):
        xt, wt = randn(gen, (b, k), bf16), randn(gen, (k, n), bf16, k ** -0.5)
        got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(xt, wt))
        if took != "tile":
            raise AssertionError(f"fused [{b},{k}]@[{k},{n}] bf16 took the {took} path")
        err = check_close(f"fused [{b},{k}]@[{k},{n}] tile path", got,
                          fused_matmul_allreduce_ref(xt, wt), BF16_TOL)
        tile_cases.append(f"[{b},{k}]@[{k},{n}] {err[0]:.3g}/{err[1]:.3g}")
    del xt, wt, got
    order_txt = plan_order_check(gen)
    say(3, f"fused_matmul_allreduce n_dev=1 vs plain (bound {BF16_TOL} bf16, {F32_TOL} f32), max "
           f"abs/rel err: [4,13696]@[13696,4096] bf16 on the {main_path} path (TILE_ROWS = "
           f"{TILE_ROWS}) {fused_err[0]:.3g}/{fused_err[1]:.3g}, "
           + ", ".join(f"forced onto the {p_} path {e[0]:.3g}/{e[1]:.3g}" for p_, e in forced.items())
           + "; f32 " + ", ".join(f32_cases) + "; bf16 on the tile path: " + "; ".join(tile_cases)
           + f"; a deep plan launched after a shallow one of the same row block: {order_txt}")

    # 4 ---------------------------------------------------------------
    n_dev, k_loc = 4, MAIN_K // 4
    cases = []
    for dtype, wire, tol, rows, kk, nn, path in (
            (f32, "f32", F32_TOL, MAIN_B, k_loc, MAIN_N, "stream"),
            (f32, "bf16", WIRE_BF16_TOL, MAIN_B, k_loc, MAIN_N, "stream"),
            (f32, "f32", F32_TOL, MAIN_B, k_loc, MAIN_N, "panel"),
            (f32, "bf16", WIRE_BF16_TOL, MAIN_B, k_loc, MAIN_N, "panel"),
            (bf16, "f32", BF16_TOL, MAIN_B, k_loc, MAIN_N, "stream"),
            (bf16, "f32", BF16_TOL, MAIN_B, k_loc, MAIN_N, "panel"),
            (bf16, "f32", BF16_TOL, 11, 1000, 4 * 96, "stream"),
            (bf16, "f32", BF16_TOL, MAIN_B, k_loc, MAIN_N, "tile"),
            (bf16, "f32", BF16_TOL, 256, k_loc, MAIN_N, "tile"),
            (bf16, "f32", BF16_TOL, 130, 1000, 1024, "tile")):
        xs = randn(gen, (n_dev, rows, kk), dtype)
        ws = randn(gen, (n_dev, kk, nn), dtype, (n_dev * kk) ** -0.5)
        # bf16 and the panel paths are forced (phases 3 and 5 check the
        # wrapper's choice); an f32 stream call must choose its path itself
        force = None if dtype == f32 and path == "stream" else path
        for comm_aware in (True, False):
            want = fused_matmul_allreduce_ref_ranks(xs, ws, wire, comm_aware)
            outs = []
            for _ in range(3):   # back to back: 3 epochs on the same flag words
                o, took = on_path(fused_matmul_allreduce_ranks, lambda: fused_matmul_allreduce_ranks(
                    xs, ws, wire=wire, comm_aware=comm_aware, _path=force))
                if took != path:
                    raise AssertionError(f"world {dtype} rows {rows}: took the {took} path")
                outs.append(o)
            name = (f"{str(dtype)[6:]}/wire={wire}/[{n_dev},{rows},{kk}]@[{n_dev},{kk},{nn}]/"
                    f"{path}/comm_aware={comm_aware}")
            errs = [check_close(f"world {name} call {i}", o, want, tol)
                    for i, o in enumerate(outs)]
            cases.append(f"{name} {max(e[0] for e in errs):.3g}/{max(e[1] for e in errs):.3g}")
    del xs, ws, outs
    say(4, f"emulated {n_dev}-rank world, 3 calls each, max abs/rel err: " + "; ".join(cases))

    kernels = chatglm_decode(card, x, w, fused_err, gemv_err, main_path)
    torch.cuda.empty_cache()
    kernels += dbrx_phases(card, gen)
    torch.cuda.empty_cache()
    kernels += dlrm_phases(card, gen)
    torch.cuda.empty_cache()
    fused_extra, rows = rwkv6_phases(card, gen)
    # the fused kernel's row (phase 6) gains its numbers at prefill rows
    next(k_ for k_ in kernels if k_["name"] == "fused_matmul_allreduce").update(fused_extra)
    kernels += rows
    torch.cuda.empty_cache()
    rows, fused_paged = chatglm_prefill_phases(card, gen)
    # the fused kernel's row (phase 6) gains its numbers at the chunk's rows
    next(k_ for k_ in kernels if k_["name"] == "fused_matmul_allreduce").update(fused_paged)
    kernels += rows
    torch.cuda.empty_cache()
    # the flash kernel's row gains its training numbers (phases 25-27)
    next(k_ for k_ in kernels if k_["name"] == "flash_attention").update(train_phases(card, gen))
    torch.cuda.empty_cache()
    autotune_phases(card)
    flash_row = next(k_ for k_ in kernels if k_["name"] == "flash_attention")
    flash_row.update(flash_window_phase(card, gen))
    flash_gemma, fused_gemma = gemma2_phases(card, gen)
    flash_row.update(flash_gemma)
    next(k_ for k_ in kernels if k_["name"] == "fused_matmul_allreduce").update(fused_gemma)
    torch.cuda.empty_cache()
    # the flash row gains its KV-ring numbers (phases 35-37)
    flash_row.update(flash_ring_phase(card, gen))
    # phase 29 runs here, after the single-card phases 30-35 (whose peaks want
    # the card's memory), and its world starts the pool of rank processes
    # that phases 31 and 36-50 reuse
    tp_phases(card)
    # phase 31's launcher runs in the pool phase 29 started
    autotune_world_phase(card)
    flash_row.update(ring_prefill_phase(card))
    flash_row.update(gemma2_ring_phase(card, gen))
    torch.cuda.empty_cache()
    # the flash row gains its numbers of training at tp > 1 (phases 38-40)
    flash_row.update(train_tp_phases(card))
    torch.cuda.empty_cache()
    paged_tp_phase(card)
    torch.cuda.empty_cache()
    # the flash and fused rows gain their launches over data replicas (phase 42)
    dp_row = data_axis_phase(card)
    PAGED_TP.clear()
    fused_keys = ("dp_decode_launches", "dp_row_err")
    flash_row.update({k_: v for k_, v in dp_row.items() if k_ not in fused_keys})
    next(k_ for k_ in kernels if k_["name"] == "fused_matmul_allreduce").update(
        {k_: dp_row[k_] for k_ in fused_keys})
    data_launcher_phase(card)
    torch.cuda.empty_cache()
    # the MoE rows gain their training numbers (phase 46)
    trained = dbrx_train_phase(card)
    torch.cuda.empty_cache()
    moe_row = next(k_ for k_ in kernels if k_["name"] == "fused_gemm_a2a")
    moe_row["path_launches"]["tile_train_step"] = trained.pop("train_tile_launches_per_step")
    next(k_ for k_ in kernels if k_["name"] == "fused_dispatch_a2a")["train_launches_per_step"] = \
        trained.pop("train_dispatch_launches_per_step")
    moe_row.update(trained)
    dbrx_world_phase(card)
    torch.cuda.empty_cache()
    # the embedding_pool row gains its launches over a world (phase 50) and
    # in training (phase 49)
    pool_row = next(k_ for k_ in kernels if k_["name"] == "embedding_pool")
    pool_row.update(dlrm_world_phase(card))
    # phase 48's launchers run in a pool of their own: in the pool phases
    # 29-50 had used, its train launcher ran out of memory on an H100 80GB
    # HBM3, in a fresh one it did not
    stop_pool()
    dbrx_launcher_phase(card)
    stop_pool()
    torch.cuda.empty_cache()
    pool_row.update(dlrm_train_phase(card))
    torch.cuda.empty_cache()
    dlrm_launcher_phase(card)
    torch.cuda.empty_cache()
    # the flash row gains its launches under the supervisor (phases 52-54)
    # and in the respawn drills (phases 55-56), the fused row in the latter
    flash_row.update(runtime_phases(card))
    flash_drill, fused_drill = respawn_phases(card)
    flash_row.update(flash_drill)
    next(k_ for k_ in kernels if k_["name"] == "fused_matmul_allreduce").update(fused_drill)
    torch.cuda.empty_cache()
    # the three kernels on deepseek-v3's path gain their numbers at its
    # shapes (phases 57-58)
    for name, extra in deepseek_phases(card).items():
        next(k_ for k_ in kernels if k_["name"] == name).update(extra)
    torch.cuda.empty_cache()
    # the flash and fused rows gain their numbers at zamba2-7b's shapes
    # (phases 59-60)
    for name, extra in zamba2_phases(card).items():
        next(k_ for k_ in kernels if k_["name"] == name).update(extra)
    torch.cuda.empty_cache()
    # the flash and fused rows gain their numbers at qwen2-vl-2b's and
    # musicgen-medium's shapes (phases 61-62)
    for name, extra in frontend_phases(card).items():
        next(k_ for k_ in kernels if k_["name"] == name).update(extra)
    torch.cuda.empty_cache()
    # the flash and fused rows gain their numbers of zamba2-7b's training
    # (phase 63)
    for name, extra in zamba2_train_phase(card).items():
        next(k_ for k_ in kernels if k_["name"] == name).update(extra)
    say("end", f"plans cached: {plan_counts()}; seconds per phase: {phase_seconds()}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def chatglm_decode(card, x, w, fused_err, gemv_err, main_path) -> list[dict]:
    """Phases 5 and 6: full-width chatglm3-6b decode and times; returns the
    JSON rows of its kernels.  Its weights are freed on return."""
    # 5 ---------------------------------------------------------------
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.fused_gemv_allreduce.ops import PATHS, fused_matmul_allreduce
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.kernels import cluster_capacity, load_library, sm_count
    from repro_torch.kernels.gemv.ops import gemv, gemv_path
    from repro_torch.kernels.gemv.plan import stream_plan
    from repro_torch.kernels.gemv.ref import gemv_ref
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bundle = get_arch("chatglm3-6b")
    cfg = bundle.config
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)
    batch, n_req, max_new = 4, 4, 8

    def serve(decode, log=None):
        def step(tok, cache, pos):
            logits, cache = decode(params, tok, cache, pos)
            if log is not None:
                log.append((tok.clone(), pos.clone(), logits.clone()))
            return logits, cache
        return serve_requests(step, bundle, batch, n_req, max_new)

    log_k, log_b = [], []
    reset_counts()
    reqs_k, _ = serve(dec_k, log_k)
    launches = launch_counts()
    steps = len(log_k)
    fused_n = launches["fused_matmul_allreduce"]
    if fused_n != cfg.n_layers * steps or launches[f"fused_matmul_allreduce.{main_path}"] != fused_n:
        raise AssertionError(f"fused kernel launched {fused_n} times in {steps} steps of "
                             f"{cfg.n_layers} layers, not all on the {main_path} path: {launches}")
    reqs_b, _ = serve(dec_b, log_b)

    # teacher-forced: bulk mode, and bulk mode in exact f32 arithmetic on
    # an f32 copy of the same weights, on exactly the kernel run's inputs
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params32 = _map(params, lambda t: t.float())
    dec_x = exact.decode_fn(ctx_b)
    cache_b, cache_x = bundle.init_cache(batch, "cuda"), exact.init_cache(batch, "cuda")
    logits_bt, err_kb, err_bx, err_kx = [], 0.0, 0.0, 0.0
    exact_steps = []
    for tok, pos, lk in log_k:
        lb, cache_b = dec_b(params, tok, cache_b, pos)
        lx, cache_x = dec_x(params32, tok, cache_x, pos)
        exact_steps.append(lx.cpu())
        for t in (lk, lb):
            if t.shape != (batch, 1, cfg.vocab) or not torch.isfinite(t).all():
                raise AssertionError(f"logits: shape {tuple(t.shape)} or non-finite")
        err_kb = max(err_kb, (lk - lb).abs().max().item())
        err_bx = max(err_bx, (lb - lx).abs().max().item())
        err_kx = max(err_kx, (lk - lx).abs().max().item())
        logits_bt.append(lb)
    del params32, cache_x
    logits_tol = LOGITS_TOL_FACTOR * err_bx
    # phases 28-29 hold the tp world to this run: its inputs, exact logits,
    # kernel-mode streams and logits, and bulk mode's distance
    GLM_DECODE.update(inputs=[(tok.cpu(), pos.cpu()) for tok, pos, _ in log_k],
                      exact=exact_steps, kernel_logits=[lk.cpu() for _, _, lk in log_k],
                      streams=[list(r.tokens) for r in reqs_k],
                      prompts=[len(r.prompt) for r in reqs_k], err_bx=err_bx, vocab=cfg.vocab,
                      logits_tol=logits_tol)
    if err_kb > logits_tol:
        raise AssertionError(f"teacher-forced logits: kernel vs bulk {err_kb:.3g} > "
                             f"{LOGITS_TOL_FACTOR} x bulk vs exact f32 {err_bx:.3g}")
    if not all(0 <= t < cfg.vocab for r in reqs_k + reqs_b for t in r.tokens):
        raise AssertionError("a token out of range")
    differing = sum(a != b for rk, rb in zip(reqs_k, reqs_b) for a, b in zip(rk.tokens, rb.tokens))
    # request r sits in slot r from the first step: its token t was chosen
    # at step len(prompt) - 1 + t
    flips = near_tie_flips([r.tokens for r in reqs_k], [r.tokens for r in reqs_b],
                           lambda r, t: logits_bt[len(reqs_k[r].prompt) - 1 + t][r, 0],
                           logits_tol)
    say(5, f"chatglm3-6b full width ({cfg.n_layers}L d{cfg.d_model}, {n_params / 1e9:.2f}B "
           f"params, {cfg.param_dtype}, init {init_s:.1f}s), batch {batch}, {n_req} requests x {max_new} "
           f"tokens: {steps} decode steps, fused kernel launches {fused_n} (= {cfg.n_layers} x "
           f"{steps}, all on the {main_path} path), gemv launches {launches['gemv']}; teacher-forced "
           f"logits max abs err: kernel vs bulk {err_kb:.3g} (bound {logits_tol:.3g}), "
           f"bulk vs exact f32 {err_bx:.3g}, kernel vs exact f32 {err_kx:.3g}; kernel streams "
           f"{[r.tokens for r in reqs_k]}; bulk streams {[r.tokens for r in reqs_b]}; "
           f"differing tokens {differing}" + (f" ({'; '.join(flips)})" if flips else "")
           + f"; plans cached: {plan_counts()}")

    # 6 ---------------------------------------------------------------
    t_fused = time_ms(lambda: fused_matmul_allreduce(x, w))
    t_paths = {p_: time_ms(lambda: fused_matmul_allreduce(x, w, _path=p_)) for p_ in PATHS}
    t_gemv = time_ms(lambda: gemv(x, w))
    t_gemv_panel = time_ms(lambda: gemv(x, w, _path="panel"))
    t_lib = time_ms(lambda: torch.matmul(x, w))
    t_plain = time_ms(lambda: fused_matmul_allreduce_ref(x, w), iters=10)
    t_gemv_plain = time_ms(lambda: gemv_ref(x, w), iters=10)
    bnd, bound_by = bound_ms(MAIN_B, MAIN_K, MAIN_N, 2)
    split = wrapper_times()
    g_path = gemv_path(x.dtype, MAIN_B, MAIN_K, MAIN_N)
    # the stream path's split: sized to the clusters the card holds at once,
    # beside the split shared memory alone would give
    cap = cluster_capacity(load_library().lib.repro_stream_capacity, 0, 1, 0, name="gemv")
    sp = stream_plan(MAIN_B, MAIN_K, MAIN_N, sms=sm_count(0), capacity=cap)
    by_smem = stream_plan(MAIN_B, MAIN_K, MAIN_N, sms=sm_count(0))
    plan_txt = (f"stream plan {sp.splits} CTAs a cluster, {sp.units} clusters, of which the card "
                f"holds {cap(sp.splits, sp.rows_per_block, sp.ks)} at once; by shared memory "
                f"alone {by_smem.splits} a cluster, of which it holds "
                f"{cap(by_smem.splits, by_smem.rows_per_block, by_smem.ks)}")

    prof_txt = profile_decode(dec_k, params, bundle.init_cache(batch, "cuda"), log_k[:4])
    decode_txt = timed_decode_runs(serve, dec_k, dec_b)
    say(6, f"on {card}: [4,13696]@[13696,4096] bf16: fused kernel {t_fused:.4f} ms ({main_path} "
           f"path; by path " + ", ".join(f"{p_} {t_:.4f}" for p_, t_ in t_paths.items())
           + f" ms), gemv {t_gemv:.4f} ms ({g_path} path; panel path {t_gemv_panel:.4f} ms), "
           f"{plan_txt}; torch.matmul {t_lib:.4f} ms, plain {t_plain:.4f} ms (gemv's plain "
           f"{t_gemv_plain:.4f} ms), bound {bnd:.4f} ms ({bound_by}); the wrappers' loop ms / "
           f"device ms per launch / host ms per call / device ops per call: "
           + ", ".join(f"{n_} {v['loop_ms']:.4f}/{v['device_ms']:.5f}/{v['host_ms']:.4f}/"
                       f"{v['device_ops']:.0f}" for n_, v in split.items())
           + f"; decode (batch {batch}, {n_req} requests x {max_new} tokens, host clock around "
           f"the drain): {decode_txt}; profile of kernel-mode decode: {prof_txt}")

    kernels = [
        {"name": "fused_matmul_allreduce", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_gemv_allreduce.cu",
         "replaces": "src/repro/kernels/fused_gemv_allreduce/kernel.py:59",
         "launches": fused_n, "max_abs_err": fused_err[0], "ms": t_fused, "plain_ms": t_plain,
         "bound_ms": bnd, "bound_by": bound_by, "library_ms": t_lib,
         "path": main_path, "shape": f"[{MAIN_B},{MAIN_K}]@[{MAIN_K},{MAIN_N}] bf16",
         "path_launches": {p_: launches[f"fused_matmul_allreduce.{p_}"] for p_ in PATHS},
         "path_ms": t_paths, "device_ms": split["fused_matmul_allreduce"]["device_ms"],
         "host_ms": split["fused_matmul_allreduce"]["host_ms"]},
        {"name": "gemv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gemv.cu",
         "replaces": "src/repro/kernels/gemv/kernel.py:19",
         "launches": launches["gemv"], "main_path": False, "max_abs_err": gemv_err[0],
         "ms": t_gemv, "plain_ms": t_gemv_plain, "bound_ms": bnd, "bound_by": bound_by,
         "library_ms": t_lib, "path": g_path, "panel_ms": t_gemv_panel,
         "device_ms": split["gemv"]["device_ms"], "host_ms": split["gemv"]["host_ms"]},
    ]
    return kernels


def dbrx_phases(card, gen) -> list[dict]:
    """Phases 7-10: the MoE kernels, their emulated world, full-width
    dbrx-132b decode (8 layers) and times; returns the JSON rows of the MoE
    kernels."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.fused_dispatch_a2a.ops import (fused_dispatch_a2a,
                                                            fused_dispatch_a2a_ranks)
    from repro_torch.kernels.fused_dispatch_a2a.ref import (fused_dispatch_a2a_ref,
                                                            fused_dispatch_a2a_ref_ranks)
    from repro_torch.kernels import cluster_capacity, load_library, sm_count
    from repro_torch.kernels.fused_gemm_a2a.ops import (fused_gemm_a2a, fused_gemm_a2a_ranks,
                                                        fused_moe_chain, gemm_a2a_path)
    from repro_torch.kernels.fused_gemm_a2a.plan import ffn_plan
    from repro_torch.kernels.fused_gemm_a2a.ref import (fused_gemm_a2a_ref,
                                                        fused_gemm_a2a_ref_ranks)
    from repro_torch.models.moe import moe_init
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bf16, f32 = torch.bfloat16, torch.float32
    bundle = get_arch("dbrx-132b")
    bundle = dataclasses.replace(bundle, config=dataclasses.replace(
        bundle.config, n_layers=DBRX_LAYERS))
    cfg = bundle.config
    E, C, D, Fd = MOE_E, MOE_C, MOE_D, MOE_F

    # 7 ---------------------------------------------------------------
    w = moe_init(gen, cfg.moe, bf16)             # one layer's full expert weights, 6.34 GB
    wu, wg, wd = w["w_up"], w["w_gate"], w["w_down"]
    xt = randn(gen, (1, 1, E, C, D), bf16)        # the dispatch buffer of one decode step
    if not torch.equal(fused_dispatch_a2a(xt), fused_dispatch_a2a_ref(xt)):
        raise AssertionError("fused_dispatch_a2a main: differs from its plain version")
    ffn_want = fused_gemm_a2a_ref(xt, wu, wg, wd, "silu")
    ffn_path = gemm_a2a_path(bf16, 1, 1, E, C, D, Fd)
    got, took = on_path(fused_gemm_a2a, lambda: fused_gemm_a2a(xt, wu, wg, wd))
    if took != ffn_path or took != "stream":
        raise AssertionError(f"fused_gemm_a2a main: took the {took} path, gemm_a2a_path says "
                             f"{ffn_path}")
    ffn_err = check_rel(f"fused_gemm_a2a main {took}", got, ffn_want, REL_BF16)
    ffn_panel_err = check_rel("fused_gemm_a2a main forced onto the panel path",
                              fused_gemm_a2a(xt, wu, wg, wd, _path="panel"), ffn_want, REL_BF16)
    chain_err = check_rel("fused_moe_chain main", fused_moe_chain(xt, wu, wg, wd),
                          fused_gemm_a2a_ref(fused_dispatch_a2a_ref(xt), wu, wg, wd, "silu"),
                          REL_BF16)
    # the stream path's partition at the main shape, and the clusters the
    # card holds at each split (tests/test_torch_gemv_plan.py's H100_FFN)
    lib = load_library().lib
    ffn_cap = cluster_capacity(lib.repro_gemm_a2a_stream_capacity, 1, 0, name="fused_gemm_a2a")
    ffn_sp = ffn_plan(1, 1, E, C, D, Fd, sms=sm_count(0), capacity=ffn_cap)
    ceil32 = lambda v: -(-v // 32) * 32
    ffn_caps = {sp: ffn_cap(sp, ffn_sp.rows_per_block, ceil32(max(-(-D // sp), -(-Fd // sp))))
                for sp in range(1, 9)}
    del w, wu, wg, wd, got, ffn_want
    rag = {}
    for fd in (777, 776):                          # F rows TMA cannot read, and can
        xr = randn(gen, (1, 1, 3, 5, 1000), f32)   # ragged E, C, D and F
        wur, wgr = (randn(gen, (3, 1000, fd), f32, 1000 ** -0.5) for _ in range(2))
        wdr = randn(gen, (3, fd, 1000), f32, fd ** -0.5)
        want_path = gemm_a2a_path(f32, 1, 1, 3, 5, 1000, fd)
        for act in ("silu", "gelu", "relu"):
            got, took = on_path(fused_gemm_a2a, lambda: fused_gemm_a2a(xr, wur, wgr, wdr, act=act))
            if took != want_path:
                raise AssertionError(f"fused_gemm_a2a ragged F={fd}: took the {took} path")
            rag[f"F={fd} {act} {took}"] = check_rel(
                f"fused_gemm_a2a ragged F={fd} {act} {took}", got,
                fused_gemm_a2a_ref(xr, wur, wgr, wdr, act), REL_F32)
    if {k_.split()[-1] for k_ in rag} != {"stream", "panel"}:
        raise AssertionError(f"the ragged shapes did not reach both paths: {list(rag)}")
    rag_chain = check_rel("fused_moe_chain ragged",
                          fused_moe_chain(xr, wur, wgr, wdr, chunks_per_rank=5),
                          fused_gemm_a2a_ref(fused_dispatch_a2a_ref(xr), wur, wgr, wdr, "silu"),
                          REL_F32)
    xo = randn(gen, (1, 2, 3, 5, 1001), bf16)     # odd rows: the kernel's element-wise path
    if not torch.equal(fused_dispatch_a2a(xo[:1], chunks_per_rank=5), xo[:1]):
        raise AssertionError("fused_dispatch_a2a ragged: differs from its plain version")
    say(7, f"MoE kernels vs plain at n_dev=1: dispatch [1,1,{E},{C},{D}] bf16 exact; "
           f"fused_gemm_a2a with dbrx-132b's expert weights [{E},{D},{Fd}] bf16 max abs/rel "
           f"err on the {ffn_path} path (gemm_a2a_path) {ffn_err[0]:.3g}/{ffn_err[1]:.3g}, "
           f"forced onto the panel path {ffn_panel_err[0]:.3g}/{ffn_panel_err[1]:.3g} (bound "
           f"{REL_BF16} rel), chain {chain_err[0]:.3g}/{chain_err[1]:.3g}; stream plan "
           f"{ffn_sp._asdict()}, clusters the card holds at splits 1-8: {ffn_caps}; ragged E=3 "
           f"C=5 D=1000 f32, each on the path gemm_a2a_path picks: "
           + ", ".join(f"{a} {e[0]:.3g}/{e[1]:.3g}" for a, e in rag.items())
           + f", chain (F=776, chunks_per_rank 5) {rag_chain[0]:.3g}/{rag_chain[1]:.3g} "
           f"(bound {REL_F32} rel); dispatch D=1001 bf16 exact")
    del xr, wur, wgr, wdr, xo

    # 8 ---------------------------------------------------------------
    n, e_loc = 4, 4
    w32 = [randn(gen, (n, e_loc, D, Fd), f32, 0.25) for _ in range(2)]
    w32.append(randn(gen, (n, e_loc, Fd, D), f32, 0.25))
    wbf = [t.to(bf16) for t in w32]
    cases, calls = [], 0
    for cap in (2, 8):
        for dtype, wire, rel in ((f32, "f32", REL_F32), (f32, "bf16", REL_WIRE_BF16),
                                 (bf16, "f32", REL_BF16)):
            ws = w32 if dtype == f32 else wbf
            xs = randn(gen, (n, n, 1, e_loc, cap, D), dtype)
            want_d = fused_dispatch_a2a_ref_ranks(xs, wire)
            want_f = fused_gemm_a2a_ref_ranks(xs, *ws, "silu", wire)
            want_c = fused_gemm_a2a_ref_ranks(want_d, *ws, "silu", wire)
            worst_f = worst_c = worst_p = 0.0
            for comm_aware in (True, False):
                for skew in (0, 1):
                    name = (f"C={cap} {str(dtype)[6:]}/wire={wire}/comm_aware={comm_aware}"
                            f"/skew={skew}")
                    kw = dict(comm_aware=comm_aware, skew=skew, wire=wire)
                    for i in range(3):   # back to back: 3 epochs on the same flag words
                        got, took = on_path(fused_gemm_a2a_ranks,
                                            lambda: fused_gemm_a2a_ranks(xs, *ws, **kw))
                        if took != "stream":
                            raise AssertionError(f"world ffn {name}: took the {took} path")
                        worst_f = max(worst_f, check_rel(f"world ffn {name} call {i}", got,
                                                         want_f, rel)[1])
                    # the panel path's protocol, kept beside the stream path's
                    for i in range(3):
                        got = fused_gemm_a2a_ranks(xs, *ws, **kw, _path="panel")
                        worst_p = max(worst_p, check_rel(f"world ffn panel {name} call {i}",
                                                         got, want_f, rel)[1])
                    for q in (1, 2):
                        for i in range(3):
                            got = fused_dispatch_a2a_ranks(xs, chunks_per_rank=q, **kw)
                            if not torch.equal(got, want_d):
                                raise AssertionError(f"world dispatch {name}/q={q} call {i}: "
                                                     f"differs from its plain version")
                            got = fused_gemm_a2a_ranks(
                                fused_dispatch_a2a_ranks(xs, chunks_per_rank=q, **kw), *ws,
                                **kw)
                            worst_c = max(worst_c, check_rel(f"world chain {name}/q={q} call {i}",
                                                             got, want_c, rel)[1])
                    calls += 3 + 3 + 2 * 3 * 3
            cases.append(f"C={cap} {str(dtype)[6:]}/wire={wire}: ffn {worst_f:.3g}, "
                         f"chain {worst_c:.3g}, panel path {worst_p:.3g}")
    del w32, wbf, xs, want_d, want_f, want_c
    torch.cuda.empty_cache()
    say(8, f"emulated {n}-rank world, E_loc={e_loc} D={D} F={Fd} per rank, both schedules, "
           f"skew 0/1, chunks_per_rank 1/2, 3 calls each ({calls} kernel launches; the expert "
           f"FFN on the stream path, and in every case also forced onto the panel path): "
           f"dispatch exact in every case; max rel err (of max |plain|): " + "; ".join(cases))

    # 9 ---------------------------------------------------------------
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)
    batch, n_req, max_new = 4, 4, 8

    def serve(decode, log=None):
        def step(tok, cache, pos):
            logits, cache = decode(params, tok, cache, pos)
            if log is not None:
                log.append((tok.clone(), pos.clone(), logits.clone()))
            return logits, cache
        return serve_requests(step, bundle, batch, n_req, max_new)

    log_k = []
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    reqs_k, _ = serve(dec_k, log_k)
    launches = {c.__name__: c.launches for c in counted_wrappers()}
    steps = len(log_k)
    launches["fused_gemm_a2a.stream"] = fused_gemm_a2a.path_launches["stream"]
    for name in ("fused_dispatch_a2a", "fused_gemm_a2a", "fused_gemm_a2a.stream"):
        if launches[name] != cfg.n_layers * steps:
            raise AssertionError(f"{name} launched {launches[name]} times in {steps} steps "
                                 f"of {cfg.n_layers} layers")
    if launches["fused_matmul_allreduce"]:
        raise AssertionError("an MoE model launched the dense FFN's kernel")
    reqs_b, _ = serve(dec_b)
    tf = teacher_forced_moe(bundle, params, ctx_k, ctx_b, log_k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    differing, flips = routed_flips(reqs_k, reqs_b, tf, cfg.vocab)
    say(9, f"dbrx-132b full width cut to {cfg.n_layers} of 40 layers (d{cfg.d_model}, "
           f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, d_ff {cfg.moe.d_ff}, "
           f"{n_params / 1e9:.2f}B params, {n_bytes / 1e9:.1f} GB {cfg.param_dtype}, init "
           f"{init_s:.1f}s, peak {peak_gb:.1f} GB), batch {batch}, {n_req} requests x {max_new} "
           f"tokens: {steps} decode steps, launches: dispatch {launches['fused_dispatch_a2a']}, "
           f"gemm_a2a {launches['fused_gemm_a2a']} (stream path "
           f"{launches['fused_gemm_a2a.stream']}) (each = {cfg.n_layers} x {steps}), "
           f"fused_matmul_allreduce "
           f"{launches['fused_matmul_allreduce']}; {tf['summary']}; kernel streams "
           f"{[r.tokens for r in reqs_k]}; bulk streams {[r.tokens for r in reqs_b]}; "
           f"differing tokens {differing}" + (f" ({'; '.join(flips)})" if flips else "")
           + f"; plans cached: {plan_counts()}")
    del tf

    # 10 --------------------------------------------------------------
    lp0 = params["layers"][0]["ffn"]          # dbrx's expert weights, main-path shapes
    wu, wg, wd = lp0["w_up"], lp0["w_gate"], lp0["w_down"]
    copy_to = torch.empty_like(xt)
    x0 = xt[0]                                 # the bulk path's [n_src, E, C, D]
    t_disp = time_ms(lambda: fused_dispatch_a2a(xt))
    t_disp_plain = time_ms(lambda: fused_dispatch_a2a_ref(xt))
    t_copy = time_ms(lambda: copy_to.copy_(xt))
    # the loop above times the host; split it: device time per launch and
    # host time per call, the kernel's beside Tensor.copy_'s
    disp_split = split_ms(lambda: fused_dispatch_a2a(xt))
    copy_split = split_ms(lambda: copy_to.copy_(xt))
    bulk = lambda: torch.einsum(
        "necf,efd->necd", F.silu(torch.einsum("necd,edf->necf", x0, wg))
        * torch.einsum("necd,edf->necf", x0, wu), wd)
    # both paths and the bulk einsums in turns: stream, panel, bulk, bulk,
    # panel, stream
    gemm_t = {"stream": [], "panel": [], "bulk": []}
    for which in ("stream", "panel", "bulk", "bulk", "panel", "stream"):
        fn = bulk if which == "bulk" else (lambda p_=which: fused_gemm_a2a(xt, wu, wg, wd,
                                                                         _path=p_))
        gemm_t[which].append(time_ms(fn, iters=20, warmup=3))
    t_gemm, t_gemm_panel, t_gemm_lib = (min(gemm_t[k_]) for k_ in ("stream", "panel", "bulk"))
    gemm_split = split_ms(lambda: fused_gemm_a2a(xt, wu, wg, wd), calls=200, prof_calls=50)
    split_t = ffn_split_times(xt, wu, wg, wd)
    bulk_split = split_ms(bulk, calls=200, prof_calls=50)
    t_gemm_plain = time_ms(lambda: fused_gemm_a2a_ref(xt, wu, wg, wd, "silu"), iters=20,
                           warmup=3)
    item = xt.element_size()
    disp_bound = 2 * xt.numel() * item / HBM_BYTES_PER_S * 1e3
    gemm_bytes = (2 * xt.numel() + wu.numel() + wg.numel() + wd.numel()) * item
    gemm_ops = 2 * 3 * E * C * D * Fd
    gemm_bound = max(gemm_bytes / HBM_BYTES_PER_S, gemm_ops / BF16_FLOPS) * 1e3
    gemm_by = "bytes" if gemm_bytes / HBM_BYTES_PER_S >= gemm_ops / BF16_FLOPS else "operations"
    prof_txt = profile_decode(dec_k, params, bundle.init_cache(batch, "cuda"), log_k[:4])
    decode_txt = timed_decode_runs(serve, dec_k, dec_b)
    say(10, f"on {card}: dispatch [1,1,{E},{C},{D}] bf16: kernel {t_disp:.4f} ms (loop), "
            f"device {disp_split[0]:.5f} ms per launch, host {disp_split[1]:.5f} ms per call; "
            f"plain {t_disp_plain:.4f} ms; Tensor.copy_ {t_copy:.4f} ms (loop), device "
            f"{copy_split[0]:.5f} ms, host {copy_split[1]:.5f} ms; bound {disp_bound:.5f} ms "
            f"(bytes); fused_gemm_a2a with [{E},{D},{Fd}] bf16 experts (turns stream, panel, "
            f"bulk, bulk, panel, stream): stream path "
            + ", ".join(f"{t_:.4f}" for t_ in gemm_t["stream"]) + " ms, panel path "
            + ", ".join(f"{t_:.4f}" for t_ in gemm_t["panel"]) + " ms, bulk einsums+silu "
            + ", ".join(f"{t_:.4f}" for t_ in gemm_t["bulk"])
            + f" ms (stream / bulk {t_gemm / t_gemm_lib:.3f}x); the stream path at each split "
            f"(CTAs a cluster: resident clusters, ms): "
            + ", ".join(f"{sp_}: {cl_}, {t_:.4f}" for sp_, (cl_, t_) in split_t.items())
            + "; stream path device "
            f"{gemm_split[0]:.4f} ms per call ({gemm_split[2]:.0f} kernels), host "
            f"{gemm_split[1]:.4f} ms; bulk device {bulk_split[0]:.4f} ms ({bulk_split[2]:.0f} "
            f"kernels), host {bulk_split[1]:.4f} ms; plain {t_gemm_plain:.4f} ms, bound "
            f"{gemm_bound:.4f} ms ({gemm_by}: {gemm_bytes / 1e9:.2f} GB, "
            f"{gemm_ops / 1e9:.1f} GFLOP); decode ({cfg.n_layers} layers, batch {batch}, "
            f"{n_req} requests x {max_new} tokens, host clock around the drain): {decode_txt}; "
            f"profile of kernel-mode decode: {prof_txt}")

    del copy_to
    torch.cuda.empty_cache()
    rows44 = moe_prefill_rows_phase(card, gen, params)
    rows45 = dbrx_prefill_phase(card, gen, bundle, params)
    del params
    torch.cuda.empty_cache()
    return [
        {"name": "fused_dispatch_a2a", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_dispatch_a2a.cu",
         "replaces": "src/repro/kernels/fused_dispatch_a2a/kernel.py:44",
         "launches": launches["fused_dispatch_a2a"], "max_abs_err": 0.0,
         "ms": t_disp, "plain_ms": t_disp_plain, "bound_ms": disp_bound, "bound_by": "bytes",
         "library_ms": t_copy, "device_ms": disp_split[0], "host_ms": disp_split[1],
         "library_device_ms": copy_split[0], "library_host_ms": copy_split[1],
         "prefill_launches": rows45["prefill_dispatch_launches"]},
        {"name": "fused_gemm_a2a", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fused_gemm_a2a.cu",
         "replaces": "src/repro/kernels/fused_gemm_a2a/kernel.py:67",
         "launches": launches["fused_gemm_a2a"], "max_abs_err": ffn_err[0],
         "ms": t_gemm, "plain_ms": t_gemm_plain, "bound_ms": gemm_bound, "bound_by": gemm_by,
         "library_ms": t_gemm_lib, "path": ffn_path,
         "path_launches": {"stream": launches["fused_gemm_a2a.stream"],
                           "tile": rows45["prefill_tile_launches"]},
         **rows44, "prefill_ms": rows45["prefill_ms"],
         "prefill_bulk_ms": rows45["prefill_bulk_ms"],
         "panel_ms": t_gemm_panel, "panel_max_abs_err": ffn_panel_err[0],
         "device_ms": gemm_split[0], "host_ms": gemm_split[1],
         "library_device_ms": bulk_split[0], "library_host_ms": bulk_split[1],
         "split_ms": {sp_: t_ for sp_, (_, t_) in split_t.items()}},
    ]


def dlrm_phases(card, gen) -> list[dict]:
    """Phases 11-14: the DLRM kernels at full width with 128 of the 512
    tables, their emulated world, the full-width DLRM forward through the
    registry's bundle, and times; returns the JSON rows of the two kernels."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.core.embedding_all_to_all import embedding_all_to_all
    from repro_torch.data.synthetic import DLRMBatches
    from repro_torch.kernels.embedding_pool.ops import embedding_pool, embedding_pool_tables
    from repro_torch.kernels.embedding_pool.plan import RING_BYTES, RING_SWEEP, bag_path, ring_fits
    from repro_torch.kernels.embedding_pool.ref import embedding_pool_ref, embedding_pool_tables_ref
    from repro_torch.kernels.fused_embedding_a2a.ops import (fused_embedding_a2a,
                                                             fused_embedding_a2a_ranks)
    from repro_torch.kernels.fused_embedding_a2a.ref import (fused_embedding_a2a_ref,
                                                             fused_embedding_a2a_ref_ranks)
    from repro_torch.models.dlrm import dlrm_forward
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bf16, f32 = torch.bfloat16, torch.float32
    bundle = get_arch("dlrm")
    bundle = dataclasses.replace(bundle, config=dataclasses.replace(
        bundle.config, n_tables=DLRM_TABLES))
    cfg = bundle.config
    T, V, D, L = cfg.n_tables, cfg.table_vocab, cfg.embed_dim, cfg.pooling
    B = bundle.shapes()["train_8k"]["batch"]
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    tables = params["tables"]
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in
             next(DLRMBatches(T, V, L, cfg.n_dense, B, seed=0)).items()}
    idx = batch["indices"]
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))

    # 11 --------------------------------------------------------------
    # the batch's indices with the first and last rows of every table in it;
    # the main shape on both paths, each against plain and the ring path
    # bit-identical to the warp path; ragged shapes on the path bag_path
    # chooses, and those the ring path takes forced onto it too
    edge = idx.clone()
    edge[0, :, 0], edge[-1, :, -1] = 0, V - 1
    main_path = bag_path(tables.dtype, D, tables.data_ptr() % 16 == 0, B * T)
    pooled, took = on_path(embedding_pool_tables, lambda: embedding_pool_tables(tables, edge))
    if took != main_path:
        raise AssertionError(f"embedding_pool main: took the {took} path, bag_path says {main_path}")
    pool_want = embedding_pool_tables_ref(tables, edge)
    pool_err = check_close(f"embedding_pool main {main_path}", pooled, pool_want, F32_TOL)
    other = "ring" if main_path == "warp" else "warp"
    pooled_other = embedding_pool_tables(tables, edge, _path=other)
    other_err = check_close(f"embedding_pool main {other}", pooled_other, pool_want, F32_TOL)
    if not torch.equal(pooled, pooled_other):
        raise AssertionError("embedding_pool main: the ring path is not bit-identical to the warp path")
    del pool_want, pooled_other
    past = sum(1 for t in range(T) if t * V * D >= 2 ** 31)
    rag = []
    for n_tab, v, d, b, nl, dt, off in (
            (3, 1000, 1, 13, 70, f32, 0), (3, 1000, 93, 13, 7, f32, 0),
            (2, 500, 257, 5, 33, f32, 0), (2, 500, 160, 5, 9, f32, 0),
            (3, 1000, 92, 13, 1, f32, 0), (3, 1000, 92, 13, 70, f32, 1),
            (2, 300, 256, 9, 70, f32, 0), (2, 300, 8, 21, 3, f32, 0),
            (3, 1000, 92, 13, 70, bf16, 0), (2, 1000, 64, 7, 9, bf16, 0),
            (3, 1000, 64, 37, 70, bf16, 0), (2, 300, 4, 9, 5, bf16, 0)):
        # off: the tables one element past a 16-byte boundary
        tab = randn(gen, (n_tab * v * d + off,), dt)[off:].view(n_tab, v, d)
        ix = torch.randint(0, v, (b, n_tab, nl), generator=gen, device="cuda", dtype=torch.int32)
        ix[0, :, 0], ix[-1, :, -1] = 0, v - 1
        name = f"T={n_tab} V={v} D={d} B={b} L={nl} {str(dt)[6:]}{' unaligned' if off else ''}"
        got, took = on_path(embedding_pool_tables, lambda: embedding_pool_tables(tab, ix))
        if took != bag_path(dt, d, off == 0, b * n_tab):
            raise AssertionError(f"embedding_pool {name}: took the {took} path")
        err = check_close(f"embedding_pool {name} {took}", got, embedding_pool_tables_ref(tab, ix),
                          F32_TOL if dt == f32 else BF16_TOL)
        same = ""
        if ring_fits(dt, d, off == 0, b * n_tab):
            if not torch.equal(got, embedding_pool_tables(tab, ix, _path="ring")):
                raise AssertionError(f"embedding_pool {name}: ring path not bit-identical to warp")
            same = ", ring path = warp path"
        rag.append(f"{name} {took} {err[0]:.3g}{same}")
    last = edge[:, T - 1].contiguous()
    one = check_close("embedding_pool one table", embedding_pool(tables[T - 1], last),
                      embedding_pool_ref(tables[T - 1], last), F32_TOL)
    say(11, f"embedding_pool vs plain: main [{T},{V},{D}] f32 tables (init {init_s:.1f}s, "
            f"{tables.numel() * 4 / 1e9:.1f} GB; {past} tables start past element 2^31), "
            f"B={B} L={L}, indices 0 and V-1 included: max abs/rel err on the {main_path} path "
            f"(bag_path's choice) {pool_err[0]:.3g}/{pool_err[1]:.3g}, forced onto the {other} "
            f"path {other_err[0]:.3g}/{other_err[1]:.3g}, the two bit-identical; single-table "
            f"entry (table {T - 1}) {one[0]:.3g}; ragged, on bag_path's path, max abs err: "
            + "; ".join(rag))

    # 12 --------------------------------------------------------------
    # each call on bag_path's path (the warp path at one rank, the ring path
    # in the full-width world), then forced onto the other
    n = 4
    tab_r = tables.view(n, T // n, V, D)
    idx_r = edge.view(B, n, T // n, L).permute(1, 0, 2, 3).contiguous()
    calls, rag3, took_world = 0, {}, set()
    rag_worlds = [(randn(gen, (3, 2, 300, d3), f32),
                   torch.randint(0, 300, (3, 15, 2, 7), generator=gen, device="cuda",
                                 dtype=torch.int32)) for d3 in (92, 93)]
    for force in (None, "ring", "warp"):
        got, took = on_path(fused_embedding_a2a,
                            lambda: fused_embedding_a2a(ctx_k, edge, tables, _path=force))
        if took != (force or main_path) or not torch.equal(got, pooled):
            raise AssertionError(f"fused_embedding_a2a n_dev=1 on the {took} path: not "
                                 f"bit-identical to embedding_pool")
        for comm_aware in (True, False):
            for i in range(3):   # back to back: 3 epochs on the same flag words
                got, took = on_path(fused_embedding_a2a_ranks, lambda: fused_embedding_a2a_ranks(
                    tab_r, idx_r, comm_aware=comm_aware, _path=force))
                calls += 1
                took_world.add(f"{force or 'chosen'}: {took}")
                if (force is None and took != bag_path(f32, D, True, B * T, n)) or \
                        not torch.equal(got.view(B, T, D), pooled):
                    raise AssertionError(f"emulated world on the {took} path comm_aware="
                                         f"{comm_aware} call {i}: not bit-identical to "
                                         f"embedding_pool's rows")
        for tab3, idx3 in rag_worlds:
            if force == "ring" and not ring_fits(f32, tab3.shape[-1]):
                continue
            want3 = fused_embedding_a2a_ref_ranks(tab3, idx3)
            for comm_aware in (True, False):
                for i in range(3):
                    got, took = on_path(fused_embedding_a2a_ranks, lambda: fused_embedding_a2a_ranks(
                        tab3, idx3, comm_aware=comm_aware, _path=force))
                    calls += 1
                    key = f"D={tab3.shape[-1]} {took}"
                    rag3[key] = max(rag3.get(key, 0.0), check_close(
                        f"ragged world {key} comm_aware={comm_aware} call {i}", got, want3,
                        F32_TOL)[0])
    del idx_r, got, rag_worlds
    say(12, f"fused_embedding_a2a on bag_path's path and forced onto each: n_dev=1 at "
            f"[{T},{V},{D}], B={B} bit-identical to embedding_pool on both paths; emulated "
            f"{n}-rank world at full width ([{n},{T // n},{V},{D}] tables, rank r's output = "
            f"rows r*{B // n}.. of embedding_pool's) bit-identical for both schedules, 3 calls "
            f"each, on the paths (" + ", ".join(sorted(took_world)) + "); ragged worlds n=3 "
            f"B=15 T_loc=2 L=7 vs plain, both schedules, 3 calls each, max abs err: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rag3.items()) + f" ({calls} world launches)")

    # 13 --------------------------------------------------------------
    logits_k, launches = counted_run(lambda: dlrm_forward(ctx_k, params, cfg, batch),
                                     {"embedding_pool_tables": 1,
                                      f"embedding_pool_tables.{main_path}": 1})
    loss_k = bundle.loss_fn(ctx_k)(params, batch)
    q4 = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel", granularity=4))
    embedding_pool_tables.launches = 0
    pooled_q4 = embedding_all_to_all(q4, idx, tables)
    if embedding_pool_tables.launches != 4:
        raise AssertionError(f"q=4 launched embedding_pool {embedding_pool_tables.launches} times")
    if not torch.equal(pooled_q4, embedding_all_to_all(ctx_k, idx, tables)):
        raise AssertionError("pooled output at chunks_per_rank=4 differs from q=1")
    del pooled_q4
    logits_b = dlrm_forward(ctx_b, params, cfg, batch)
    loss_b = bundle.loss_fn(ctx_b)(params, batch)
    logit_err = check_close("DLRM logits kernel vs bulk", logits_k, logits_b, F32_TOL)
    loss_err = check_close("DLRM loss kernel vs bulk", loss_k, loss_b, F32_TOL)
    if logits_k.shape != (B,):
        raise AssertionError(f"logits shape {tuple(logits_k.shape)}")
    say(13, f"DLRM forward, full width with {T} of 512 tables ({cfg.table_vocab} x {D} f32 "
            f"each, bottom {cfg.bottom_mlp}, top {cfg.top_mlp}, interaction "
            f"{params['top'][0]['w'].shape[0]} wide), batch {B} from DLRMBatches(seed=0): "
            f"kernel-mode launches at q=1 {launches['embedding_pool_tables']} (on the {main_path} "
            f"path {launches[f'embedding_pool_tables.{main_path}']}; all wrappers "
            f"{sum(v for k, v in launches.items() if '.' not in k)}), at q=4 4, pooled output "
            f"at q=4 bit-identical to q=1; "
            f"logits kernel vs bulk max abs/rel err {logit_err[0]:.3g}/{logit_err[1]:.3g} "
            f"(|logits| <= {logits_b.abs().max().item():.3g}); loss kernel {loss_k.item():.6f}, "
            f"bulk {loss_b.item():.6f}, err {loss_err[0]:.3g}")

    # 14 --------------------------------------------------------------
    say(14, f"on {card}: registers and occupancy of the bag kernels: "
            f"{bag_occupancy(ctx_k, tables, idx)}")
    offs = torch.arange(T, device="cuda", dtype=torch.int32)[None, :, None] * V
    flat_idx, flat_w = (idx + offs).reshape(B * T, L), tables.view(T * V, D)
    distinct = torch.unique(flat_idx).numel()
    del offs
    idx_r = idx.view(B, n, T // n, L).permute(1, 0, 2, 3).contiguous()
    calls = {"embedding_pool": lambda **kw: embedding_pool_tables(tables, idx, **kw),
             "fused_embedding_a2a": lambda **kw: fused_embedding_a2a(ctx_k, idx, tables, **kw),
             "world": lambda **kw: fused_embedding_a2a_ranks(tab_r, idx_r, **kw)}
    t_path = {}   # name -> path -> ms, in turns ring, warp, warp, ring
    for name, fn in calls.items():
        t_path[name] = {"ring": [], "warp": []}
        for p_ in ("ring", "warp", "warp", "ring"):
            t_path[name][p_].append(time_ms(lambda: fn(_path=p_), iters=10, warmup=2))
    sweep = {name: {rb: time_ms(lambda: calls[name](_path="ring", _ring_bytes=rb), iters=10,
                                warmup=2) for rb in RING_SWEEP} for name in calls}
    per_sm = {rb: ring_ctas_per_sm(rb, D) for rb in RING_SWEEP}
    t_plain = time_ms(lambda: embedding_pool_tables_ref(tables, idx), iters=3, warmup=1)
    t_lib = time_ms(lambda: F.embedding_bag(flat_idx, flat_w, mode="mean"), iters=10, warmup=2)
    t_fused_plain = time_ms(lambda: fused_embedding_a2a_ref(tables[None], idx[None]), iters=3,
                            warmup=1)
    t_world_plain = time_ms(lambda: fused_embedding_a2a_ref_ranks(tab_r, idx_r), iters=3,
                            warmup=1)
    del idx_r, flat_idx
    fwd = {"kernel": [], "bulk": []}
    for mode, ctx in (("kernel", ctx_k), ("bulk", ctx_b), ("bulk", ctx_b), ("kernel", ctx_k)):
        fwd[mode].append(time_ms(lambda: dlrm_forward(ctx, params, cfg, batch), iters=10,
                                 warmup=2))
    prof_k = profile_device(lambda i: dlrm_forward(ctx_k, params, cfg, batch), 3, "forward")
    prof_b = profile_device(lambda i: dlrm_forward(ctx_b, params, cfg, batch), 3, "forward")
    pool_bytes = distinct * D * 4 + idx.numel() * 4 + B * T * D * 4
    pool_ops = B * T * (L + 1) * D      # one add per lookup and element, one division
    t_bytes, t_ops = pool_bytes / HBM_BYTES_PER_S * 1e3, pool_ops / F32_FLOPS * 1e3
    bnd, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    # a gather in lookup order that reads every lookup's row from HBM: the
    # 32-byte sectors each row spans at its address, the indices, the output
    gathered = gathered_bytes(tables, idx)
    best = {k: min(min(v) for v in t_path[k].values()) for k in t_path}
    say(14, f"on {card}: pooling [{T},{V},{D}] f32, B={B} L={L} ({distinct} distinct rows of "
            f"{T * V}, {pool_bytes / 1e9:.2f} GB each read once, {idx.numel() * D * 4 / 1e9:.2f} "
            f"GB gathered, {gathered / 1e9:.2f} GB in the sectors of a gather in lookup order): "
            f"bound {bnd:.4f} ms ({bound_by}), gathered-bytes floor "
            f"{gathered / HBM_BYTES_PER_S * 1e3:.4f} ms; per path, in turns ring, warp, warp, "
            f"ring (ms): " + "; ".join(
                f"{k} " + ", ".join(f"{p_} " + "/".join(f"{t:.4f}" for t in v)
                                    for p_, v in t_path[k].items()) for k in t_path)
            + "; fused n_dev=1 over embedding_pool: "
            + ", ".join(f"{p_} path {min(t_path['fused_embedding_a2a'][p_]) / min(t_path['embedding_pool'][p_]):.4f}"
                        for p_ in ("ring", "warp"))
            + f"; plain: embedding_pool {t_plain:.4f} ms, fused_embedding_a2a n_dev=1 "
            f"{t_fused_plain:.4f} ms, emulated {n}-rank world {t_world_plain:.4f} ms; "
            f"F.embedding_bag over all {T} tables {t_lib:.4f} ms")
    say(14, f"on {card}: embedding_pool per path on other indices of the same shape, ms in "
            f"turns ring, warp, warp, ring: {gather_limits(tables, idx)}")
    say(14, f"on {card}: embedding_pool at bf16 rows of D = 64, per path, in turns: "
            f"{narrow_rows_times(gen)}")
    say(14, f"on {card}: ring sizes, ms on the ring path (CTAs an SM): " + "; ".join(
            f"{k} " + ", ".join(f"{rb // 1024} KB {t:.4f} ({per_sm[rb]})" for rb, t in v.items())
            for k, v in sweep.items())
            + f" (RING_BYTES = {RING_BYTES // 1024} KB)")
    say(14, f"on {card}: DLRM forward per batch of {B} (CUDA events, turns kernel, bulk, bulk, "
            f"kernel): " + "; ".join(f"{m} " + ", ".join(f"{v:.4f}" for v in vs) + " ms"
                                     for m, vs in fwd.items())
            + f"; profile of the kernel-mode forward: {prof_k}; of the bulk-mode forward: "
            f"{prof_b}")

    # fused_embedding_a2a is bit-identical to embedding_pool (phase 12), so
    # its error against the plain version is embedding_pool's
    row = {"route": "cuda", "max_abs_err": pool_err[0], "bound_ms": bnd, "bound_by": bound_by,
           "library_ms": t_lib, "path": main_path}
    return [
        {"name": "embedding_pool", **row,
         "source": "src/repro_torch/kernels/csrc/embedding_pool.cu",
         "replaces": "src/repro/kernels/embedding_pool/kernel.py:20",
         "launches": launches["embedding_pool_tables"],
         "ms": min(t_path["embedding_pool"][main_path]), "plain_ms": t_plain,
         "ring_ms": min(t_path["embedding_pool"]["ring"])},
        {"name": "fused_embedding_a2a", **row,
         "source": "src/repro_torch/kernels/csrc/fused_embedding_a2a.cu",
         "replaces": "src/repro/kernels/fused_embedding_a2a/kernel.py:33",
         "launches": launches["fused_embedding_a2a"], "main_path": False,
         "ms": min(t_path["fused_embedding_a2a"][main_path]), "plain_ms": t_fused_plain,
         "ring_ms": min(t_path["fused_embedding_a2a"]["ring"])},
    ]


def gathered_bytes(tables, idx) -> int:
    """Bytes a gather in lookup order moves when it reads every lookup's
    row from HBM: the 32-byte sectors each row spans at its address, the
    int32 indices, the output written once."""
    n_tab, v, d = tables.shape
    row = d * tables.element_size()
    base = tables.data_ptr() + torch.arange(n_tab, device=idx.device,
                                            dtype=torch.int64)[None, :, None] * v * row
    start = (idx.long() * row + base) % 32
    sectors = ((start + row + 31) // 32).sum().item()
    return sectors * 32 + idx.numel() * 4 + idx.shape[0] * n_tab * row


def ring_ctas_per_sm(ring_bytes, d, itemsize=4) -> int:
    """CTAs of embedding_pool's ring kernel an SM holds at a ring of
    ``ring_bytes`` on rows of ``d`` elements (cudaOccupancyMaxActive-
    BlocksPerMultiprocessor)."""
    import ctypes

    from repro_torch.kernels import check_launch, load_library
    from repro_torch.kernels.embedding_pool.plan import ring_slots, smem_bytes

    row = d * itemsize
    regs, ctas = ctypes.c_int(), ctypes.c_int()
    check_launch(load_library().lib.repro_embedding_pool_info(
        1, 0 if itemsize == 4 else 1, smem_bytes(ring_slots(row, ring_bytes), row),
        ctypes.byref(regs), ctypes.byref(ctas)), "embedding_pool info")
    return ctas.value


def ptxas_registers(log, kernel, flag=None) -> dict:
    """dtype ("f32", "bf16") -> (registers, spill stores in bytes) that
    ptxas reported for that instantiation of the kernel template ``kernel``
    (with its bool template argument ``flag``, where it has one) in a build
    log."""
    got = {}
    for m in re.finditer(r"Function properties for (\S+)\n.*?(\d+) bytes spill stores.*\n"
                         r".*Used (\d+) registers", log):
        name = m.group(1)
        if f"{kernel}I" in name and (flag is None or f"Lb{int(flag)}E" in name):
            got["bf16" if "bfloat16" in name else "f32"] = (int(m.group(3)), int(m.group(2)))
    return got


def bag_occupancy(ctx, tables, idx) -> str:
    """Registers per thread (from the runtime, and registers and spill
    stores from the build log) and CTAs resident on an SM of both bag
    kernels in f32 on both paths (the ring path at the plan's shared
    memory; the fused kernel at n = 1 and with the peer protocol).  The
    fused kernel at n = 1 on the warp path is timed on DLRM's tables.  (The
    scratch builds of the parent's fused kernel were cut for phases 44-48's
    time; PERF.md section 6 keeps their numbers.)"""
    import ctypes

    from repro_torch.kernels import check_launch, load_library
    from repro_torch.kernels.embedding_pool.plan import RING_BYTES, ring_slots, smem_bytes
    from repro_torch.kernels.fused_embedding_a2a import ops as fused_ops

    built = load_library()
    row = tables.shape[-1] * tables.element_size()
    ring_smem = smem_bytes(ring_slots(row, RING_BYTES), row)

    def info(lib, name, ring, log, peers=None):
        r, c = ctypes.c_int(), ctypes.c_int()
        fn = getattr(lib, f"repro_{name}_info")
        args = [ring, 0, ring_smem if ring else 0] + ([] if peers is None else [peers])
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)] * 2
        check_launch(fn(*args, ctypes.byref(r), ctypes.byref(c)), name)
        kernel = name + ("_ring_kernel" if ring else "_kernel")
        regs, spills = ptxas_registers(log, kernel, peers).get("f32", ("not in it", "?"))
        return (f"{name} {'ring' if ring else 'warp'} path"
                f"{'' if peers is None else ' with the protocol' if peers else ' at n = 1'} "
                f"{r.value} registers (build log: {regs}, {spills} bytes spilled), "
                f"{c.value} CTAs an SM")

    t_warp = [time_ms(lambda: fused_ops.fused_embedding_a2a(ctx, idx, tables, _path="warp"),
                      iters=10, warmup=2) for _ in range(2)]
    return ("; ".join([info(built.lib, "embedding_pool", ring, built.build_log)
                       for ring in (1, 0)]
                      + [info(built.lib, "fused_embedding_a2a", ring, built.build_log, peers)
                         for ring in (1, 0) for peers in (0, 1)]
                      + [f"ring at {ring_smem} B of shared memory"])
            + "; fused_embedding_a2a n_dev=1 on the warp path: "
            + "/".join(f"{t:.4f}" for t in t_warp) + " ms")


def gather_limits(tables, idx) -> str:
    """embedding_pool on both paths with the batch's shape but other rows,
    each bag's rows in sequence from row b * L: cycling over each table's
    first 256 rows (they stay in L2: what the path costs without HBM), and
    over all its rows (HBM read in order, each row once)."""
    from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables

    b, n_tab, L = idx.shape
    v = tables.shape[1]
    seq = (torch.arange(b, device=idx.device)[:, None, None] * L
           + torch.arange(L, device=idx.device)[None, None, :]).expand(b, n_tab, L)
    hot = min(256, v)
    out = []
    for name, ix in ((f"rows in L2 ({hot} a table, {n_tab * hot * tables.shape[2] * 4 / 1e6:.1f} "
                      f"MB)", seq % hot), ("rows in sequence", seq % v)):
        ix = ix.to(torch.int32).contiguous()
        t = {"ring": [], "warp": []}
        for p_ in ("ring", "warp", "warp", "ring"):
            t[p_].append(time_ms(lambda: embedding_pool_tables(tables, ix, _path=p_),
                                 iters=10, warmup=2))
        out.append(f"{name}: " + ", ".join(f"{p_} " + "/".join(f"{x:.4f}" for x in v_)
                                           for p_, v_ in t.items()))
    return "; ".join(out)


def narrow_rows_times(gen) -> str:
    """embedding_pool on each path at rows of 128 bytes (bf16, D = 64; 128
    tables of 200,000 rows, B = 8192, L = 70), where the warp path's
    16-byte loads keep 8 of a warp's 32 lanes busy."""
    from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables

    tab = randn(gen, (128, 200000, 64), torch.bfloat16)
    ix = torch.randint(0, 200000, (8192, 128, 70), generator=gen, device="cuda",
                       dtype=torch.int32)
    want = embedding_pool_tables(tab, ix, _path="warp")
    t = {"ring": [], "warp": []}
    for p_ in ("ring", "warp", "warp", "ring"):
        if not torch.equal(embedding_pool_tables(tab, ix, _path=p_), want):
            raise AssertionError(f"bf16 D=64 on the {p_} path: not bit-identical")
        t[p_].append(time_ms(lambda: embedding_pool_tables(tab, ix, _path=p_), iters=10,
                             warmup=2))
    return ", ".join(f"{k} " + "/".join(f"{x:.4f}" for x in v) + " ms" for k, v in t.items())


def rwkv6_phases(card, gen) -> tuple[dict, list[dict]]:
    """Phases 15-18: the WKV6 and GEMM kernels against their plain versions,
    full-width rwkv6-7b prefill and decode through the registry's bundle in
    kernel and bulk mode against an exact f32 evaluation, and times; returns
    the fused kernel's prefill-row numbers (for its JSON row) and the JSON
    rows of the two kernels."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.kernels.gemm.ops import gemm, gemm_path
    from repro_torch.kernels.gemm.ref import gemm_ref
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_ref
    from repro_torch.models import rwkv6 as rwkv6_model
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bf16, f32 = torch.bfloat16, torch.float32
    bundle = get_arch("rwkv6-7b")
    cfg = bundle.config
    L, H, N, C = cfg.n_layers, cfg.n_heads, cfg.head_size, cfg.chunk
    B, T = RWKV_B, RWKV_T

    # 15 --------------------------------------------------------------
    # WKV6 and its plain versions all run in f32: they differ in summation
    # order and in the exponentials' last bits, so REL_F32 bounds them
    r, k, v, w, u = wkv6_inputs(gen, B, T, H, N)
    o, s = wkv6(r, k, v, w, u, chunk=C)
    po, ps = plain_wkv6(r, k, v, w, u, chunk=C)
    o_err = check_rel("wkv6 main o", o, po, REL_F32)
    s_err = check_rel("wkv6 main state", s, ps, REL_F32)
    s_max = ps.abs().max().item()
    fold = lambda a: a.transpose(1, 2).reshape(B * H, T, N)
    lw = torch.log(torch.clamp(w, 1e-8, 1.0))
    scan = wkv6_ref(fold(r), fold(k), fold(v), fold(lw),
                    u[None].expand(B, H, N).reshape(B * H, 1, N))
    scan_err = check_rel("wkv6 main o vs the per-step scan", fold(o), scan, REL_F32)
    del po, ps, lw, scan
    edges = []
    # the six edge shapes, then two with more chunks than a cluster's 8 CTAs
    # (a CTA carries the state over its range; 20 is off the 8-step
    # sub-chunk), then B*H = 65600 heads, past the 65535 of a grid's y
    for b, t, h, n, ch in ((2, 64, 3, 64, 64), (2, 96, 3, 64, 16), (3, 64, 2, 32, 32),
                           (2, 40, 5, 16, 8), (2, 24, 4, 16, 64), (1, 512, 2, 32, 64),
                           (2, 1024, 3, 64, 64), (1, 200, 2, 16, 20), (1025, 16, 64, 16, 8)):
        ins = wkv6_inputs(gen, b, t, h, n)
        name = f"B={b} T={t} H={h} N={n} chunk={ch}"
        got, want = wkv6(*ins, chunk=ch), plain_wkv6(*ins, chunk=ch)
        e = max(check_rel(f"wkv6 {name} {part}", g, w_, REL_F32)[1]
                for part, g, w_ in zip(("o", "state"), got, want))
        edges.append(f"{name} {e:.3g}")
    for bad_n, bad_c in ((8, 8), (64, 128)):
        try:
            wkv6(*wkv6_inputs(gen, 1, 128, 2, bad_n), chunk=bad_c)
        except ValueError:
            continue
        raise AssertionError(f"wkv6 took N={bad_n}, chunk={bad_c}: the kernel takes neither")
    # gemm: ragged shapes off TMA's 16-byte rows (the CUDA-core kernel in
    # both dtypes), then shapes the bf16 tile path takes: the timed main
    # shape, ragged M/N/K, a single row, K of one stage
    gemm_cases = []
    for m, kk, n in ((1, 1, 1), (33, 1000, 4097), (4097, 33, 1000), (1000, 4097, 33),
                     (1, 4097, 1000), (4097, 1, 33), (2048, 4096, 4096), (1000, 4104, 1032),
                     (1, 64, 8), (4097, 64, 4096)):
        for dt, tol in ((f32, F32_TOL), (bf16, BF16_TOL)):
            x = randn(gen, (m, kk), dt)
            wg = randn(gen, (kk, n), dt, kk ** -0.5)
            name = f"[{m},{kk}]@[{kk},{n}] {str(dt)[6:]}"
            got, took = on_path(gemm, lambda: gemm(x, wg))
            if took != gemm_path(dt, kk, n):
                raise AssertionError(f"gemm {name} took the {took} path")
            err = check_close(f"gemm {name} {took}", got, gemm_ref(x, wg), tol)
            gemm_cases.append((f"{name} {took}", err[0]))
    del x, wg, got
    say(15, f"wkv6 vs plain chunked at the main path r,k,v,w [{B},{T},{H},{N}] f32, chunk {C}: "
            f"o max abs/rel err {o_err[0]:.3g}/{o_err[1]:.3g}, final state (max |state| "
            f"{s_max:.3g}) {s_err[0]:.3g}/{s_err[1]:.3g} (bound {REL_F32} rel); o vs the "
            f"per-step scan {scan_err[0]:.3g}/{scan_err[1]:.3g}; edge shapes max rel err: "
            + "; ".join(edges)
            + "; N=8 and chunk 128 raise; gemm vs plain max abs err: "
            + ", ".join(f"{n_} {e:.3g}" for n_, e in gemm_cases))
    del r, k, v, w, u, o, s

    # 16 --------------------------------------------------------------
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    mix = torch.Generator(device="cuda").manual_seed(2)
    for lp in params["layers"]:
        # the reference inits mu, w0 and u to zeros, which would hide the token
        # shift, the decay offset and the bonus: draw them (w0 spans the log-log
        # decays of a trained rwkv6, about [-6, 1])
        tm, cm = lp["tm"], lp["cm"]
        tm["mu"] = torch.rand(tm["mu"].shape, generator=mix, device="cuda")
        tm["w0"] = torch.rand(tm["w0"].shape, generator=mix, device="cuda") * 7.0 - 6.0
        tm["u"] = torch.randn(tm["u"].shape, generator=mix, device="cuda") * 0.5
        cm["mu"] = torch.rand(cm["mu"].shape, generator=mix, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t_.numel() for t_ in _leaves(params))
    n_bytes = sum(t_.numel() * t_.element_size() for t_ in _leaves(params))
    if not 7.3e9 < n_params < 7.4e9:
        raise AssertionError(f"rwkv6-7b has {n_params} parameters, not about 7.35e9")
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, T), generator=gen, device="cuda")}
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    pre_k, pre_b = bundle.prefill_fn(ctx_k), bundle.prefill_fn(ctx_b)
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = {**params, "layers": UpcastLayers(params["layers"])}

    def exact_prefill(b):
        with swapped(rwkv6_model, "wkv6", plain_wkv6):
            return exact.prefill_fn(ctx_b)(params_x, b)

    torch.cuda.reset_peak_memory_stats()
    (logits_k, state_k), launch_k = counted_run(
        lambda: pre_k(params, batch),
        {"wkv6": L, "fused_matmul_allreduce": 2 * L, "fused_matmul_allreduce.tile": 2 * L})
    layer_errs = []

    def spy(r_, k_, v_, w_, u_, *, chunk):
        """The kernel, then its plain version on the identical input."""
        got = wkv6(r_, k_, v_, w_, u_, chunk=chunk)
        want = plain_wkv6(r_, k_, v_, w_, u_, chunk=chunk)
        i = len(layer_errs)
        layer_errs.append(max(check_rel(f"prefill layer {i} wkv6 {part}", g, w2, REL_F32)[1]
                              for part, g, w2 in zip(("o", "state"), got, want)))
        return got

    with swapped(rwkv6_model, "wkv6", spy):
        (logits_b, state_b), launch_b = counted_run(lambda: pre_b(params, batch),
                                                          {"wkv6": L})
    logits_x, state_x = exact_prefill(batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for lg in (logits_k, logits_b, logits_x):
        if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"prefill logits: shape {tuple(lg.shape)} or non-finite")
    pre_errs = bounded_errors("prefill", {"logits": (logits_k, logits_b, logits_x),
                                          **{key: (state_k[key], state_b[key], state_x[key])
                                             for key in state_k}})
    say(16, f"rwkv6-7b full width ({L}L d{cfg.d_model}, {H} heads of {N}, d_ff {cfg.d_ff}, "
            f"vocab {cfg.vocab}, {n_params / 1e9:.3f}B params, {n_bytes / 1e9:.2f} GB "
            f"{cfg.param_dtype}, init {init_s:.1f}s, peak {peak_gb:.1f} GB), prefill of "
            f"{B}x{T} seeded tokens: launches in kernel mode wkv6 {launch_k['wkv6']}, fused GEMV "
            f"{launch_k['fused_matmul_allreduce']} (tile path "
            f"{launch_k['fused_matmul_allreduce.tile']}); in bulk mode wkv6 {launch_b['wkv6']}, fused "
            f"GEMV {launch_b['fused_matmul_allreduce']}; every layer's wkv6 (o, state) vs plain "
            f"on its input: max rel err {max(layer_errs):.3g} over {len(layer_errs)} layers "
            f"(bound {REL_F32}); max abs err (kernel vs exact f32, bulk vs exact f32, kernel vs "
            f"bulk; bound {LOGITS_TOL_FACTOR} x bulk's): {pre_errs}")

    # 17 --------------------------------------------------------------
    dec_k, dec_b, dec_x = (bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b),
                           exact.decode_fn(ctx_b))

    def greedy():
        st, tok, out = state_k, logits_k.argmax(-1), []
        for _ in range(RWKV_STEPS):
            lg, st = dec_k(params, tok, st, None)
            out.append((tok, lg))
            tok = lg.argmax(-1)
        return out

    dec_path = fused_path(bf16, B, cfg.d_model, cfg.d_model)
    if fused_path(bf16, B, cfg.d_ff, cfg.d_model) != dec_path:
        raise AssertionError("rwkv6's w_o and w_v at decode rows take different paths")
    steps, launch_d = counted_run(greedy, {"fused_matmul_allreduce": 2 * L * RWKV_STEPS,
                                           f"fused_matmul_allreduce.{dec_path}": 2 * L * RWKV_STEPS})
    st_b, st_x, lb_all, lx_all = state_b, state_x, [], []
    for tok, _ in steps:                      # teacher-forced on the kernel stream's tokens
        lb, st_b = dec_b(params, tok, st_b, None)
        lx, st_x = dec_x(params_x, tok, st_x, None)
        lb_all.append(lb)
        lx_all.append(lx)
    cat = lambda ls: torch.cat(ls, dim=1)
    lk = cat([lg for _, lg in steps])
    if lk.shape != (B, RWKV_STEPS, cfg.vocab) or not torch.isfinite(lk).all():
        raise AssertionError(f"decode logits: shape {tuple(lk.shape)} or non-finite")
    dec_errs = bounded_errors("decode", {"logits": (lk, cat(lb_all), cat(lx_all))})
    head = {"tokens": batch["tokens"][:, :RWKV_HANDOFF]}
    lp_, sp_ = pre_k(params, head)
    lpx, spx = exact_prefill(head)
    st = bundle.init_cache(B, "cuda")
    for i in range(RWKV_HANDOFF):
        ld, st = dec_k(params, head["tokens"][:, i:i + 1], st, None)
    handoff = []
    for key, got, pre, ex in (("logits", ld, lp_, lpx),
                              *((key, st[key], sp_[key], spx[key]) for key in st)):
        d_pd, d_px = errors(got, pre)[0], errors(pre, ex)[0]
        if d_pd > LOGITS_TOL_FACTOR * d_px:
            raise AssertionError(f"hand-off {key}: {RWKV_HANDOFF} decode steps are {d_pd:.3g} "
                                 f"from the prefill, above {LOGITS_TOL_FACTOR} x the prefill's "
                                 f"distance {d_px:.3g} from exact f32")
        handoff.append(f"{key} {d_pd:.3g} (bound {LOGITS_TOL_FACTOR * d_px:.3g})")
    say(17, f"rwkv6-7b decode, {RWKV_STEPS} greedy steps from the prefill states: launches wkv6 "
            f"{launch_d['wkv6']}, fused GEMV {launch_d['fused_matmul_allreduce']} (= 2 x {L} x "
            f"{RWKV_STEPS}, all on the {dec_path} path); teacher-forced {dec_errs}; kernel stream tokens "
            f"{[[int(t_) for t_ in tok[:, 0]] for tok, _ in steps]}; hand-off, kernel mode, "
            f"{RWKV_HANDOFF}-token prefill vs {RWKV_HANDOFF} decode steps from init_state, max "
            f"abs err (bound {LOGITS_TOL_FACTOR} x the prefill's distance from exact f32): "
            + ", ".join(handoff) + f"; plans cached: {plan_counts()}")
    del steps, st_b, st_x, lb_all, lx_all, lk, st, sp_, spx, state_x, logits_x

    # 18 --------------------------------------------------------------
    r, k, v, w, u = wkv6_inputs(gen, B, T, H, N)
    t_wkv = time_ms(lambda: wkv6(r, k, v, w, u, chunk=C), iters=20, warmup=3)
    t_wkv_plain = time_ms(lambda: plain_wkv6(r, k, v, w, u, chunk=C), iters=5, warmup=1)
    wkv_bnd, wkv_by, wkv_bytes, wkv_ops = wkv6_bound(B * H, T, N)
    exps = wkv6_exps(B * H, T, N, C)
    exp_rate = 16 * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_hz()
    del r, k, v, w, u
    gx = randn(gen, (2048, 4096), bf16)
    gw = randn(gen, (4096, 4096), bf16, 4096 ** -0.5)
    t_gemm = time_ms(lambda: gemm(gx, gw), iters=20, warmup=3)
    t_gemm_cc = time_ms(lambda: gemm(gx, gw, _path="cuda_core"), iters=10, warmup=2)
    t_gemm_plain = time_ms(lambda: gemm_ref(gx, gw), iters=10, warmup=2)
    t_gemm_lib = time_ms(lambda: torch.matmul(gx, gw), iters=20, warmup=3)
    gemm_bnd, gemm_by = bound_ms(2048, 4096, 4096, 2)
    gx32, gw32 = gx.float(), gw.float()
    t_gemm32 = time_ms(lambda: gemm(gx32, gw32), iters=10, warmup=2)
    t_gemm32_lib = time_ms(lambda: torch.matmul(gx32, gw32), iters=10, warmup=2)
    gemm32_bnd = max((3 * 2048 * 4096 + 4096 * 4096) * 4 / HBM_BYTES_PER_S,
                     2 * 2048 * 4096 * 4096 / F32_FLOPS) * 1e3
    del gx32, gw32
    # the fused kernel at rwkv6's prefill rows on layer 0's weights: the tile
    # path (the wrapper's choice) checked and timed, the stream path timed
    rows = {}
    for name, wt in (("w_o", params["layers"][0]["tm"]["w_o"]),
                     ("channel-mix w_v", params["layers"][0]["cm"]["w_v"])):
        x = randn(gen, (B * T, wt.shape[0]), bf16)
        got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, wt))
        if took != "tile":
            raise AssertionError(f"fused kernel at rwkv6's prefill {name}: took the {took} path")
        err = check_close(f"fused kernel at prefill rows, layer 0 {name}", got,
                          fused_matmul_allreduce_ref(x, wt), BF16_TOL)
        rows[name] = dict(
            shape=f"[{B * T},{wt.shape[0]}]@[{wt.shape[0]},{wt.shape[1]}]", err=err,
            same_as_lib=torch.equal(got, torch.matmul(x, wt)),
            tile=time_ms(lambda: fused_matmul_allreduce(x, wt), iters=20, warmup=3),
            stream=time_ms(lambda: fused_matmul_allreduce(x, wt, _path="stream"), iters=5,
                           warmup=1),
            lib=time_ms(lambda: torch.matmul(x, wt), iters=20, warmup=3),
            bound=bound_ms(B * T, wt.shape[0], wt.shape[1], 2))
    del x, got
    # the row sweep that sets TILE_ROWS: chatglm3-6b's w_down shape
    sw_k, sw_n = 13696, 4096
    sw_w = randn(gen, (sw_k, sw_n), bf16, sw_k ** -0.5)
    sweep = []
    for r_ in (1, 2, 4, 8, 9, 12, 16, 32, 64, 128, 256, 2048):
        sx = randn(gen, (r_, sw_k), bf16)
        sweep.append((r_, time_ms(lambda: fused_matmul_allreduce(sx, sw_w, _path="stream"),
                                  iters=5 if r_ >= 256 else 20, warmup=2),
                      time_ms(lambda: fused_matmul_allreduce(sx, sw_w, _path="tile")),
                      time_ms(lambda: torch.matmul(sx, sw_w))))
    del sw_w, sx
    pre_t = {"kernel": [], "bulk": []}
    for mode, fn in (("kernel", pre_k), ("bulk", pre_b), ("bulk", pre_b), ("kernel", pre_k)):
        pre_t[mode].append(time_ms(lambda: fn(params, batch), iters=2, warmup=1))
    tok = logits_k.argmax(-1)
    dec_t = {"kernel": [], "bulk": []}
    for mode, fn in (("kernel", dec_k), ("bulk", dec_b), ("bulk", dec_b), ("kernel", dec_k)):
        dec_t[mode].append(time_ms(lambda: fn(params, tok, state_k, None), iters=10, warmup=2))
    prof = {m: (profile_device(lambda i: fn(params, batch), 1, "prefill"),
                profile_device(lambda i: dfn(params, tok, state_k, None), 4, "step"))
            for m, fn, dfn in (("kernel", pre_k, dec_k), ("bulk", pre_b, dec_b))}
    times = lambda d: "; ".join(f"{m} " + ", ".join(f"{t_:.4f}" for t_ in ts) + " ms"
                                for m, ts in d.items())
    say(18, f"on {card}: wkv6 [{B},{T},{H},{N}] chunk {C}: kernel {t_wkv:.4f} ms, plain chunked "
            f"{t_wkv_plain:.4f} ms, no single PyTorch call computes it, bound {wkv_bnd:.4f} ms "
            f"({wkv_by}: {wkv_bytes / 1e6:.1f} MB, {wkv_ops / 1e9:.2f} G f32 operations); "
            f"exponentials: the reference's form {exps['reference'] / 1e6:.1f} M "
            f"({exps['reference'] / exp_rate * 1e3:.4f} ms), the kernel's factored form "
            f"{exps['kernel'] / 1e6:.1f} M ({exps['kernel'] / exp_rate * 1e3:.4f} ms) at 16 a "
            f"clock per SM and {max_sm_hz() / 1e6:.0f} MHz; gemm "
            f"[2048,4096]@[4096,4096] bf16: tile kernel {t_gemm:.4f} ms, CUDA-core kernel "
            f"{t_gemm_cc:.4f} ms, plain {t_gemm_plain:.4f} ms, "
            f"torch.matmul {t_gemm_lib:.4f} ms, bound {gemm_bnd:.4f} ms ({gemm_by}); f32: kernel "
            f"{t_gemm32:.4f} ms, torch.matmul {t_gemm32_lib:.4f} ms, bound {gemm32_bnd:.4f} ms "
            f"(operations at the f32 peak); fused kernel at prefill rows {B * T}: "
            + "; ".join(f"{n_} {r['shape']}: tile path vs plain max abs/rel err {r['err'][0]:.3g}/"
                        f"{r['err'][1]:.3g} (bit-identical to torch.matmul: {r['same_as_lib']}), "
                        f"tile path {r['tile']:.4f} ms, stream path "
                        f"{r['stream']:.4f} ms, torch.matmul {r['lib']:.4f} ms, bound "
                        f"{r['bound'][0]:.4f} ms ({r['bound'][1]})" for n_, r in rows.items())
            + f"; row sweep [rows,{sw_k}]@[{sw_k},{sw_n}] bf16 (stream path / tile path / "
              f"torch.matmul ms): "
            + ", ".join(f"{r_} {g:.4f}/{t_:.4f}/{lb:.4f}" for r_, g, t_, lb in sweep)
            + f"; prefill per batch of {B}x{T} (CUDA events, turns kernel, bulk, bulk, kernel): "
            + times(pre_t) + f"; decode per step at batch {B}: " + times(dec_t)
            + "; profiles: " + "; ".join(f"{m} prefill {p_[0]}; {m} decode {p_[1]}"
                                         for m, p_ in prof.items()))

    prefill = {n_: {"shape": f"{r['shape']} bf16", "ms": r["tile"], "stream_path_ms": r["stream"],
                    "bound_ms": r["bound"][0], "bound_by": r["bound"][1], "library_ms": r["lib"],
                    "max_abs_err": r["err"][0]} for n_, r in rows.items()}
    fused_extra = {"tile_path_prefill": {"launches": launch_k["fused_matmul_allreduce.tile"],
                                         **prefill},
                   "row_sweep": {"shape": f"[rows,{sw_k}]@[{sw_k},{sw_n}] bf16",
                                 "rows_stream_tile_library_ms": sweep}}
    return fused_extra, [
        {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
         "replaces": "src/repro/kernels/rwkv6/kernel.py:20", "launches": launch_k["wkv6"],
         "max_abs_err": o_err[0], "ms": t_wkv, "plain_ms": t_wkv_plain, "bound_ms": wkv_bnd,
         "bound_by": wkv_by, "library_ms": None},
        {"name": "gemm", "route": "cuda", "source": "src/repro_torch/kernels/csrc/gemm.cu",
         "replaces": "src/repro/kernels/gemm/kernel.py:19", "launches": launch_k["gemm"],
         "main_path": False, "max_abs_err": max(e for _, e in gemm_cases), "ms": t_gemm,
         "plain_ms": t_gemm_plain, "bound_ms": gemm_bnd, "bound_by": gemm_by,
         "library_ms": t_gemm_lib, "path": "tile", "shape": "[2048,4096]@[4096,4096] bf16",
         "cuda_core_ms": t_gemm_cc, "f32": {"ms": t_gemm32, "library_ms": t_gemm32_lib,
                                            "bound_ms": gemm32_bnd, "bound_by": "operations"}},
    ]


def flash_phase(gen) -> tuple:
    """Phase 19: the flash kernels against their plain version at the
    prefill's shape (chatglm3-6b: B 4, S 2048, 32 query heads over 2 kv
    heads of 128, bf16, causal) and at edge shapes, each on the path
    ``flash_path`` chooses and every bf16 d = 128 shape on the CUDA-core
    path too; unsupported calls must raise.  Returns the main shape's (max
    abs, rel) error on the tile path."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_plain,
                                                         flash_path)

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_arch("chatglm3-6b").config
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    errs = {}
    for name, b, s, h, g_kv, d, dt, causal in (
            ("main", GLM_B, GLM_S, hq, hkv, hd, bf16, True),
            ("non-causal", GLM_B, GLM_S, hq, hkv, hd, bf16, False),
            ("S=1", 2, 1, 4, 2, 128, bf16, True), ("S=37", 2, 37, 4, 2, 128, bf16, True),
            ("S=127", 2, 127, 4, 2, 128, bf16, True), ("S=128", 2, 128, 4, 2, 128, bf16, True),
            ("S=129", 2, 129, 4, 2, 128, bf16, True),
            ("S=255 non-causal", 1, 255, 4, 1, 128, bf16, False),
            ("S=255", 1, 255, 4, 1, 128, bf16, True),
            ("S=1000", 2, 1000, 8, 2, 128, bf16, True), ("S=2049", 1, 2049, 8, 2, 128, bf16, True),
            ("S=2049 non-causal", 1, 2049, 8, 2, 128, bf16, False),
            ("g=16 S=300", 1, 300, 32, 2, 128, bf16, True),
            ("hd=64 g=1", 2, 300, 4, 4, 64, bf16, True),
            ("f32 S=515 g=2", 2, 515, 6, 3, 128, f32, True),
            ("f32 hd=64 g=4 non-causal", 3, 129, 4, 1, 64, f32, False),
            ("f32 hd=64 g=1 S=1", 1, 1, 2, 2, 64, f32, True)):
        q = randn(gen, (b, s, h, d), dt)
        k, v = randn(gen, (b, s, g_kv, d), dt), randn(gen, (b, s, g_kv, d), dt)
        want = flash_attention_plain(q, k, v, causal=causal)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        chosen = flash_path(dt, d)
        got, took = on_path(flash_attention, lambda: flash_attention(q, k, v, causal=causal))
        if took != chosen:
            raise AssertionError(f"flash_attention {name}: took the {took} path, flash_path "
                                 f"says {chosen}")
        errs[name] = {took: check_close(f"flash_attention {name} ({took} path)", got, want, tol)}
        if chosen == "tile":
            got = flash_attention(q, k, v, causal=causal, _path="cuda_core")
            errs[name]["cuda_core"] = check_close(f"flash_attention {name} (cuda_core path)", got,
                                                  want, tol)
        del q, k, v, want, got
    x = randn(gen, (1, 8, 2, 96), bf16)
    y = x[..., :64].contiguous()
    z = randn(gen, (1, 8, 2, 128), f32)
    for what, call in (("hd 96", lambda: flash_attention(x, x, x)),
                       ("a window of 0", lambda: flash_attention(y, y, y, window=0)),
                       ("a softcap of 0", lambda: flash_attention(y, y, y, softcap=0.0)),
                       ("f32 on the tile path", lambda: flash_attention(z, z, z, _path="tile"))):
        try:
            call()
        except (ValueError, NotImplementedError):
            continue
        raise AssertionError(f"flash_attention took {what}: it must raise")
    say(19, f"flash_attention vs plain (bound: bf16 {BF16_TOL}, f32 {F32_TOL}), max abs/rel err "
            f"per path (the first is flash_path's choice): "
            + "; ".join(f"{n_} " + ", ".join(f"{p_} {e[0]:.3g}/{e[1]:.3g}" for p_, e in pe.items())
                        for n_, pe in errs.items())
            + f" (main: [{GLM_B},{GLM_S},{hq},{hd}] q over {hkv} kv heads, bf16, causal); "
              f"hd 96, a window or softcap of 0 and f32 forced onto the tile path raise (phase "
              f"32 computes windows and softcaps)")
    return errs["main"]["tile"]


def flash_bound(b, s, hq, hkv, d, itemsize, causal=True, window=None):
    """Least time for one flash call, (ms, bound_by, bytes, operations): q, k
    and v read once and o written once over HBM, or the two products over
    the key pairs the mask keeps (s (s + 1) / 2 per head when causal; with a
    window w, min(i + 1, w) keys for causal row i) at the inputs' peak
    (bf16 tensor cores, or f32)."""
    n_bytes = 2 * b * s * (hq + hkv) * d * itemsize
    w = min(window or s, s)
    pairs = w * (w + 1) // 2 + (s - w) * w if causal else sum(s - max(0, i - w + 1)
                                                              for i in range(s))
    ops = 4 * b * hq * d * pairs
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if itemsize == 2 else F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, ops


def chatglm_prefill_phases(card, gen) -> tuple[list[dict], dict]:
    """Phases 19-21: the flash kernel against its plain version, full-width
    chatglm3-6b prefill through the registry's bundle in kernel and bulk
    mode against an exact f32 evaluation, the hand-off to decode, and
    times; then phase 22 (the prefill at 32768 tokens) and phases 23-24
    (paged serving) on the same weights; returns the JSON row of the flash
    kernel and the fused kernel's numbers at the paged chunk's rows."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_path
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    main_err = flash_phase(gen)

    # 20 --------------------------------------------------------------
    bf16 = torch.bfloat16
    bundle = get_arch("chatglm3-6b")
    cfg = bundle.config
    L, Hq, Hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = GLM_B, GLM_S
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t_.numel() for t_ in _leaves(params))
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    batch = {"tokens": tokens}
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    pre_k, pre_b = bundle.prefill_fn(ctx_k), bundle.prefill_fn(ctx_b)
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = {**params, "layers": UpcastLayers(params["layers"])}

    def exact_prefill(b):
        """Bulk mode in exact f32 arithmetic (layers upcast one at a time)."""
        return exact.prefill_fn(ctx_b)(params_x, b)

    torch.cuda.reset_peak_memory_stats()
    layer_errs = []

    def spy(q, k, v, **kw):
        """The kernel, then its plain version on the identical input."""
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, scale=kw["scale"], causal=kw["causal"])
        layer_errs.append(check_close(f"prefill layer {len(layer_errs)} flash", got, want,
                                      BF16_TOL)[0])
        return got

    # kernel mode launches the flash kernel in every layer; bulk mode, the
    # yardstick, runs the reference's bulk computation (span_attention)
    with swapped(attention, "flash_attention", spy):
        (logits_k, cache_k), launch_k = counted_run(lambda: pre_k(params, batch), flash_on_tile(L))
    (logits_b, cache_b), launch_b = counted_run(lambda: pre_b(params, batch), {})
    logits_x, cache_x = exact_prefill(batch)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for lg in (logits_k, logits_b, logits_x):
        if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"prefill logits: shape {tuple(lg.shape)} or non-finite")
    for c in (cache_k, cache_b):
        if any(tuple(c[key].shape) != (L, B, S, Hkv, hd) for key in ("k", "v")):
            raise AssertionError(f"prefill cache: shapes {[tuple(t_.shape) for t_ in c.values()]}")
    errs_k = bounded_errors("prefill kernel mode", {
        "logits": (logits_k, logits_b, logits_x),
        **{key: (cache_k[key], cache_b[key], cache_x[key]) for key in ("k", "v")}})
    # phase 36's yardsticks, on the host
    GLM_PREFILL.update(layers=L, max_seq=cfg.max_seq, tokens=tokens.cpu(), exact=logits_x.cpu(),
                       err_bx=[errors(logits_b[b_], logits_x[b_])[0] for b_ in range(B)],
                       cache={key: cache_k[key].cpu() for key in ("k", "v")})
    del cache_x, logits_x
    say(20, f"chatglm3-6b full width ({L}L d{cfg.d_model}, {Hq}/{Hkv} heads of {hd}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab}, {n_params / 1e9:.3f}B params {cfg.param_dtype}, init "
            f"{init_s:.1f}s, peak {peak_gb:.1f} GB), prefill of {B}x{S} seeded tokens: launches in "
            f"kernel mode flash {launch_k['flash_attention']} (tile path "
            f"{launch_k['flash_attention.tile']}, CUDA-core path "
            f"{launch_k['flash_attention.cuda_core']}), fused GEMV "
            f"{launch_k['fused_matmul_allreduce']}; in bulk mode (span_attention) flash "
            f"{launch_b['flash_attention']}, fused GEMV {launch_b['fused_matmul_allreduce']}; "
            f"every layer's flash output vs plain on its input (kernel mode): max abs err "
            f"{max(layer_errs):.3g} over {len(layer_errs)} layers (bound {BF16_TOL}); max abs err "
            f"(kernel mode vs exact f32, bulk mode vs exact f32, kernel vs bulk mode; bound "
            f"{LOGITS_TOL_FACTOR} x bulk's): {errs_k}")

    # hand-off: the prefill cache in a decode cache of max_seq positions, then
    # greedy decode steps from position S
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)

    def decode_cache(c):
        dc = bundle.init_cache(B, "cuda")
        for key in dc:
            dc[key][:, :, :S] = c[key]
        return dc

    def greedy(dec, logits, c):
        dc, tok, out = decode_cache(c), logits.argmax(-1), []
        for i in range(GLM_STEPS):
            pos = torch.full((B,), S + i, dtype=torch.int32, device="cuda")
            lg, dc = dec(params, tok, dc, pos)
            out.append((tok, lg))
            tok = lg.argmax(-1)
        return out

    dec_path = fused_path(bf16, B, cfg.d_ff, cfg.d_model)
    steps_k, launch_d = counted_run(lambda: greedy(dec_k, logits_k, cache_k),
                                    {"fused_matmul_allreduce": L * GLM_STEPS,
                                     f"fused_matmul_allreduce.{dec_path}": L * GLM_STEPS})
    steps_b = greedy(dec_b, logits_b, cache_b)
    for _, lg in steps_k + steps_b:
        if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"decode logits: shape {tuple(lg.shape)} or non-finite")
    longer = {"tokens": torch.cat([tokens, steps_k[0][0]], dim=1)}
    logits_l = pre_k(params, longer)[0]
    logits_lx = exact_prefill(longer)[0]
    d_px = errors(logits_l, logits_lx)[0]
    d_pd = errors(steps_k[0][1], logits_l)[0]
    GLM_PREFILL["handoff"] = dict(token=steps_k[0][0].cpu(), logits=logits_l.cpu(), d_px=[
        errors(logits_l[b_], logits_lx[b_])[0] for b_ in range(B)])
    del logits_lx
    tol = LOGITS_TOL_FACTOR * d_px
    if d_pd > tol:
        raise AssertionError(f"hand-off: the first decode step's logits are {d_pd:.3g} from a "
                             f"prefill over {S + 1} tokens, above {LOGITS_TOL_FACTOR} x that "
                             f"prefill's distance {d_px:.3g} from exact f32")
    stream = lambda st: torch.cat([tok for tok, _ in st], dim=1)
    sk, sb = stream(steps_k), stream(steps_b)
    # the logits that chose token t of a slot: the prefill's for the first
    flips = near_tie_flips(sk.tolist(), sb.tolist(),
                           lambda s_, t_: (logits_b if t_ == 0 else steps_b[t_ - 1][1])[s_, 0],
                           tol)
    say(20, f"hand-off: {GLM_STEPS} greedy decode steps from position {S} in a {cfg.max_seq}-"
            f"position cache copied from the prefill's: launches fused GEMV "
            f"{launch_d['fused_matmul_allreduce']} (= {L} x {GLM_STEPS}, all on the {dec_path} "
            f"path), flash "
            f"{launch_d['flash_attention']}; first step's logits vs a kernel-mode prefill over "
            f"{S + 1} tokens max abs err {d_pd:.3g} (bound {tol:.3g} = {LOGITS_TOL_FACTOR} x that "
            f"prefill's distance from exact f32, {d_px:.3g}); kernel stream "
            f"{sk.tolist()}; bulk stream {sb.tolist()}; differing tokens "
            f"{int((sk != sb).sum())}" + (f" ({'; '.join(flips)})" if flips else ""))
    del steps_b, cache_b, logits_l

    # 21 --------------------------------------------------------------
    fl = flash_times(gen, B, S, Hq, Hkv, hd, iters=10, plain=True)
    t_flash = fl["tile"][-1]
    pre_t = {"kernel": [], "bulk": []}
    for mode, fn in (("kernel", pre_k), ("bulk", pre_b), ("bulk", pre_b), ("kernel", pre_k)):
        pre_t[mode].append(time_ms(lambda: fn(params, batch), iters=2, warmup=1))
    dc = decode_cache(cache_k)
    tok = logits_k.argmax(-1)
    pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
    dec_t = {"kernel": [], "bulk": []}
    for mode, fn in (("kernel", dec_k), ("bulk", dec_b), ("bulk", dec_b), ("kernel", dec_k)):
        dec_t[mode].append(time_ms(lambda: fn(params, tok, dc, pos), iters=10, warmup=2))
    prof = {m: profile_device(lambda i: fn(params, batch), 1, "prefill")
            for m, fn in (("kernel", pre_k), ("bulk", pre_b))}
    prof_dec = profile_device(lambda i: dec_k(params, tok, dc, pos), 4, "step")
    times = lambda d: "; ".join(f"{m} " + ", ".join(f"{t_:.4f}" for t_ in ts) + " ms"
                                for m, ts in d.items())
    say(21, f"on {card}: flash_attention (one prefill layer) {fl['line']}; prefill per batch of {B}x{S} (CUDA events, turns kernel, bulk, bulk, kernel; bulk "
            f"mode runs span_attention): "
            + times(pre_t) + f"; decode per step at batch {B} from position {S}: " + times(dec_t)
            + "; profiles: " + "; ".join(f"{m} prefill {p_}" for m, p_ in prof.items())
            + f"; kernel decode {prof_dec}")
    del dc, tok, pos, cache_k, logits_k
    torch.cuda.empty_cache()
    long_prefill_phase(card, gen, bundle, params, pre_k)
    torch.cuda.empty_cache()
    fused_paged = paged_phases(card, gen, bundle, params)

    return [
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:22",
         "launches": launch_k["flash_attention"], "max_abs_err": main_err[0], "ms": t_flash,
         "plain_ms": fl["plain"], "bound_ms": fl["bound"], "bound_by": fl["bound_by"],
         "library_ms": fl["sdpa"]},
    ], fused_paged


# ---------------------------------------------------------------------------
# phases 25-27: dense training of chatglm3-6b
# ---------------------------------------------------------------------------
def dense_attention(q, k, v, scale, window=None, cap=None):
    """Causal GQA attention in q's dtype, every score at once, with an
    optional sliding window and softcap (the exact evaluation of phases 25
    and 32: f32 for bf16 inputs, f64 for f32 ones)."""
    g = q.shape[2] // k.shape[2]
    kk, vv = (a.repeat_interleave(g, dim=2) for a in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    i = torch.arange(q.shape[1], device=q.device)
    keep = i[None, :] <= i[:, None]
    if window is not None:
        keep &= i[:, None] - i[None, :] < window
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vv)


def grads_of(fn, inputs, cot):
    """d(sum(fn(*inputs) * cot)) / d inputs, for leaves that require grad."""
    return torch.autograd.grad(fn(*inputs), inputs, cot)


def flash_train_phase(gen) -> dict:
    """Phase 25: the flash kernel's softmax statistics (m, l) against the
    plain version's, its output with statistics bit-identical to without,
    and the training gradient (the kernel's forward, the analytic backward)
    against bulk mode (autograd through span_attention), each measured from
    an exact evaluation; at the prefill's shape in bf16 (tile path) and at
    one f32 shape (CUDA-core path).  Then the backward's time beside
    SDPA's backward and its bound.  Returns the flash row's training
    numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models.attention import span_attention

    from repro_torch.configs.registry import get_arch

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_arch("chatglm3-6b").config
    lines, row = [], {}
    for name, b, s, hq, hkv, d, dt, path in (
            ("main", GLM_B, GLM_S, cfg.n_heads, cfg.n_kv_heads, cfg.hd, bf16, "tile"),
            ("f32", 2, 515, 6, 3, 128, f32, "cuda_core")):
        q = randn(gen, (b, s, hq, d), dt)
        k, v = randn(gen, (b, s, hkv, d), dt), randn(gen, (b, s, hkv, d), dt)
        do = randn(gen, (b, s, hq, d), dt)
        scale = d ** -0.5
        # (a) the statistics, and the output with and without them (direct
        # launches: comparisons, not the main path's)
        (o_s, m_k, l_k), took = flash_ops._launch(q, k, v, scale, True, None, None, None, True)
        o_n, _ = flash_ops._launch(q, k, v, scale, True, None, None, None, False)
        if took != path:
            raise AssertionError(f"flash stats {name}: took the {took} path, expected {path}")
        if not torch.equal(o_s, o_n):
            raise AssertionError(f"flash {name}: the output with statistics differs from without")
        _, m_p, l_p = flash_attention_plain(q, k, v, scale=scale, causal=True, stats=True)
        err_m = check_close(f"flash {name} m", m_k, m_p, F32_TOL)
        err_l = check_close(f"flash {name} l", l_k, l_p, F32_TOL)
        del o_s, o_n, m_k, l_k, m_p, l_p
        # (b) gradients, each from an exact evaluation
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        g_k = grads_of(lambda *a: flash_attention(*a, scale=scale, causal=True), leaves, do)
        g_b = grads_of(lambda *a: span_attention(*a, causal=True, window=None, scale=scale,
                                                  cap=None), leaves, do)
        wide = torch.float64 if dt == f32 else f32
        exact = [a.detach().to(wide).requires_grad_(True) for a in (q, k, v)]
        g_x = grads_of(lambda *a: dense_attention(*a, scale), exact, do.to(wide))
        del exact
        dists = []
        for gname, gk, gb, gx in zip(("dq", "dk", "dv"), g_k, g_b, g_x):
            dk_, db_ = errors(gk, gx)[0], errors(gb, gx)[0]
            if not (torch.isfinite(gk.float()).all() and dk_ <= LOGITS_TOL_FACTOR * db_):
                raise AssertionError(f"flash backward {name} {gname}: kernel mode {dk_:.3g} from "
                                     f"exact, above {LOGITS_TOL_FACTOR} x bulk mode's {db_:.3g}")
            dists.append(f"{gname} {dk_:.3g}/{db_:.3g}")
        del g_k, g_b, g_x
        lines.append(f"{name} [{b},{s},{hq}/{hkv},{d}] {str(dt)[6:]} on the {took} path: m err "
                     f"{err_m[0]:.3g}, l err {err_l[0]:.3g} (bound {F32_TOL}), output with stats "
                     f"bit-identical to without; grads' max abs err from exact "
                     f"{'f64' if dt == f32 else 'f32'}, kernel/bulk (bound "
                     f"{LOGITS_TOL_FACTOR} x bulk's): " + ", ".join(dists))
        if name != "main":
            continue
        # (c) times: the analytic backward (the flash op's), bulk mode's
        # autograd and SDPA's backward, each on its own forward's graph
        o_k = flash_attention(*leaves, scale=scale, causal=True)
        o_b = span_attention(*leaves, causal=True, window=None, scale=scale, cap=None)
        qt, kt, vt = (a.transpose(1, 2) for a in leaves)
        o_sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        bwd = lambda o, c: lambda: torch.autograd.grad(o, leaves, c, retain_graph=True)
        t_k = [time_ms(bwd(o_k, do), iters=3, warmup=1)]
        t_sd = [time_ms(bwd(o_sd, dot), iters=10, warmup=2)]
        t_b = time_ms(bwd(o_b, do), iters=2, warmup=1)
        t_sd.append(time_ms(bwd(o_sd, dot), iters=10, warmup=2))
        t_k.append(time_ms(bwd(o_k, do), iters=3, warmup=1))
        fwd_ms, _, n_bytes, ops = flash_bound(b, s, hq, hkv, d, 2)
        # read q, k, v, o, do, m, l once, write dq, dk, dv once; the backward
        # does 2.5 times the forward's products (5 of the forward's 2 kinds)
        b_bytes = n_bytes + 3 * b * s * hq * d * 2 + 2 * b * hq * s * 4 + b * s * (hq + 2 * hkv) * d * 2
        t_bytes, t_ops = b_bytes / HBM_BYTES_PER_S * 1e3, 2.5 * ops / BF16_FLOPS * 1e3
        row = {"backward_ms": min(t_k), "backward_bound_ms": max(t_bytes, t_ops),
               "backward_bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "sdpa_backward_ms": min(t_sd), "bulk_backward_ms": t_b}
        lines.append(f"backward at [{b},{s},{hq}/{hkv},{d}] bf16 causal (CUDA events, turns "
                     f"kernel, SDPA, bulk, SDPA, kernel): the flash op's analytic backward "
                     f"(plain PyTorch, _span_flash_bwd) " + ", ".join(f"{t_:.3f}" for t_ in t_k)
                     + f" ms; F.scaled_dot_product_attention's backward "
                     + ", ".join(f"{t_:.3f}" for t_ in t_sd) + f" ms; bulk mode's autograd "
                     f"through span_attention {t_b:.3f} ms; bound {row['backward_bound_ms']:.4f} "
                     f"ms ({row['backward_bound_by']}: {2.5 * ops / 1e9:.1f} GFLOP, "
                     f"{b_bytes / 1e6:.1f} MB); analytic backward at "
                     f"{min(t_k) / min(t_sd):.2f}x SDPA's")
        del o_k, o_b, o_sd, qt, kt, vt, dot
    say(25, "flash statistics and backward: " + "; ".join(lines))
    return row


def train_grad_phase(gen) -> None:
    """Phase 26: TRAIN_GRAD_LAYERS layers of full-width chatglm3-6b at
    TRAIN_B x TRAIN_S: every parameter's gradient in kernel and bulk mode,
    each against an exact f32 evaluation (f32 weights and arithmetic, bulk
    mode); kernel mode's largest error on every leaf within
    LOGITS_TOL_FACTOR x bulk mode's."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import LMBatches
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import tree_leaves, tree_map, tree_paths

    bundle = get_arch("chatglm3-6b")
    cfg = dataclasses.replace(bundle.config, n_layers=TRAIN_GRAD_LAYERS)
    bundle = dataclasses.replace(bundle, config=cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    batch = to_device(next(LMBatches(cfg.vocab, TRAIN_B, TRAIN_S, 0)), "cuda")
    out = {}
    for mode in ("kernel", "bulk"):
        ctx = ParallelContext(device="cuda", fusion=FusionConfig(mode=mode))
        want = flash_on_tile(2 * cfg.n_layers) if mode == "kernel" else {}
        (loss, grads), counts = counted_run(
            lambda: (lambda l_: (l_.detach(), torch.autograd.grad(l_, leaves)))(
                bundle.loss_fn(ctx)(params, batch)), want)
        out[mode] = (loss, grads)
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = tree_map(lambda t_: t_.detach().float().requires_grad_(True), params)
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    loss_x = exact.loss_fn(ctx_b)(params_x, batch)
    grads_x = torch.autograd.grad(loss_x, tree_leaves(params_x))
    worst, rows = 0.0, []
    names = [".".join(map(str, path)) for path, _ in tree_paths(params)]
    for name, gk, gb, gx in zip(names, out["kernel"][1], out["bulk"][1], grads_x):
        ek, eb = errors(gk, gx)[0], errors(gb, gx)[0]
        if not (torch.isfinite(gk.float()).all() and ek <= LOGITS_TOL_FACTOR * eb):
            raise AssertionError(f"gradient {name}: kernel mode {ek:.3g} from exact f32, above "
                                 f"{LOGITS_TOL_FACTOR} x bulk mode's {eb:.3g}")
        worst = max(worst, ek / eb)
        rows.append(f"{name} {ek:.3g}/{eb:.3g}")
    lk, lb, lx = out["kernel"][0].item(), out["bulk"][0].item(), loss_x.item()
    say(26, f"gradients of {cfg.n_layers} full-width chatglm3-6b layers at {TRAIN_B}x{TRAIN_S} "
            f"tokens (LMBatches seed 0, weights seed 0): loss kernel {lk:.6f}, bulk {lb:.6f}, "
            f"exact f32 {lx:.6f}; flash launches in kernel mode {2 * cfg.n_layers} (forward and "
            f"remat, tile path), 0 in bulk mode; each leaf's max abs err from exact f32, "
            f"kernel/bulk (bound {LOGITS_TOL_FACTOR} x bulk's; worst ratio {worst:.3g}): "
            + ", ".join(rows))


class StepClock:
    """``on_phase`` hook of the train step: a CUDA event as each part
    (forward, backward, optimizer) has been enqueued, the flash launches of
    each step, and a torch.profiler window over step ``profile_step``."""

    def __init__(self, profile_step):
        self.steps, self.launches, self.profile_step = [], [], profile_step
        self.busy = None

    def __call__(self, name):
        from repro_torch.kernels.flash_attention.ops import flash_attention

        if name == "start":
            self.steps.append({})
            self.flash0 = flash_attention.launches
            if len(self.steps) == self.profile_step:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CUDA])   # as profile_device
                self.prof.start()
                self.t0 = time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev
        if name == "optimizer":
            self.launches.append(flash_attention.launches - self.flash0)
            if len(self.steps) == self.profile_step:
                torch.cuda.synchronize()
                wall = (time.perf_counter() - self.t0) * 1e3
                self.prof.stop()
                dev = [e.time_range.elapsed_us() / 1e3 for e in self.prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
                if not dev:
                    raise AssertionError("torch.profiler recorded no device time in a train step")
                self.busy = (sum(dev), wall, len(dev))
                del self.prof

    def split(self):
        """Per step: (forward, backward, optimizer, whole) ms from the events."""
        torch.cuda.synchronize()
        ms = lambda a, b: a.elapsed_time(b)
        return [(ms(e["start"], e["forward"]), ms(e["forward"], e["backward"]),
                 ms(e["backward"], e["optimizer"]), ms(e["start"], e["optimizer"]))
                for e in self.steps]


def launch_run(argv, tokens):
    """``launch.train.main(argv)`` with every launch count set to 0 first and
    the peak memory reset; returns (losses, counts, StepClock, peak GB,
    summary) of the run."""
    from repro_torch.launch import train as launch_train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(profile_step=int(argv[argv.index("--steps") + 1]))
    reset_counts()
    losses = launch_train.main(argv, on_phase=clock)
    torch.cuda.synchronize()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(map(lambda x: x == x and abs(x) < float("inf"), losses)):
        raise AssertionError(f"launcher {argv}: non-finite losses {losses}")
    split = clock.split()
    later = split[1:]
    med = sorted(later, key=lambda r: r[3])[len(later) // 2]
    dev, wall, ops = clock.busy
    summary = (f"losses {', '.join(f'{x:.4f}' for x in losses)}; step (median of steps 2-"
               f"{len(split)}, CUDA events) {med[3]:.1f} ms = forward {med[0]:.1f} + backward "
               f"{med[1]:.1f} + optimizer {med[2]:.1f}, {tokens / med[3] * 1e3:.0f} tok/s "
               f"(steps: {', '.join(f'{r[3]:.1f}' for r in split)} ms); device busy "
               f"{100 * dev / wall:.1f}% of step {len(split)}'s {wall:.1f} ms under the profiler "
               f"({ops} device ops); peak {peak:.2f} GB; flash launches a step "
               f"{clock.launches}")
    return losses, counts, clock, peak, summary, med


def train_launcher_phase(card) -> dict:
    """Phase 27: the launcher (``launch.train.main``) at full width, all 28
    layers, TRAIN_STEPS steps at TRAIN_B x TRAIN_S in each mode from seed 0
    (gates: finite losses, the last below the first, step 1's kernel loss
    within LOGITS_TOL_FACTOR x bulk's distance from an exact f32 evaluation
    of that loss, later steps within TRAIN_LOSS_REL of bulk's, 56 flash
    launches a kernel-mode step and 0 in bulk mode); then TRAIN_LONG_STEPS
    kernel-mode steps at TRAIN_LONG_B x TRAIN_LONG_S on TRAIN_LONG_LAYERS
    layers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bundle = get_arch("chatglm3-6b")
    cfg = bundle.config
    L = cfg.n_layers
    # the exact f32 loss of step 1: the launcher's seed-0 weights and first batch
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = to_device(next(launch_train.make_batches(bundle, TRAIN_B, TRAIN_S)), "cuda")
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    with torch.no_grad():
        params_x = {"embed": {"table": params["embed"]["table"].float()},
                    "final_norm": params["final_norm"], "layers": UpcastLayers(params["layers"])}
        ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
        loss_x = exact.loss_fn(ctx_b)(params_x, batch).item()
    del params, params_x
    argv = ["--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--lr", TRAIN_LR, "--log-every", "1"]
    runs = {}
    for mode in ("kernel", "bulk"):
        runs[mode] = launch_run(argv + ["--fusion", mode], TRAIN_B * TRAIN_S)
        want = TRAIN_STEPS * 2 * L if mode == "kernel" else 0
        expect_counts(f"{mode} mode", runs[mode][1], flash_on_tile(want))
        if runs[mode][2].launches != [want // TRAIN_STEPS] * TRAIN_STEPS:
            raise AssertionError(f"{mode} mode: flash launches a step {runs[mode][2].launches}")
        losses = runs[mode][0]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{mode} mode: loss did not fall: {losses}")
    lk, lb = runs["kernel"][0], runs["bulk"][0]
    d_k, d_b = abs(lk[0] - loss_x), abs(lb[0] - loss_x)
    if d_k > LOGITS_TOL_FACTOR * d_b:
        raise AssertionError(f"step 1: kernel loss {lk[0]:.6f} is {d_k:.3g} from exact f32 "
                             f"{loss_x:.6f}, above {LOGITS_TOL_FACTOR} x bulk's {d_b:.3g}")
    rel = max(abs(a - b) / b for a, b in zip(lk[1:], lb[1:]))
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"steps 2-{TRAIN_STEPS}: kernel losses {lk} differ from bulk's {lb} "
                             f"by {rel:.3g} of bulk's, above {TRAIN_LOSS_REL}")
    say(27, f"on {card}: python -m repro_torch.launch.train --steps {TRAIN_STEPS} --lr "
            f"{TRAIN_LR} (full-width chatglm3-6b, {L} layers, {TRAIN_B}x{TRAIN_S} tokens, AdamW "
            f"with f32 moments, weights and batches from seed 0): kernel mode {runs['kernel'][4]}; bulk mode "
            f"{runs['bulk'][4]}; step 1 vs exact f32 {loss_x:.6f}: kernel {d_k:.3g}, bulk "
            f"{d_b:.3g} (bound {LOGITS_TOL_FACTOR} x bulk's); steps 2-{TRAIN_STEPS} kernel vs bulk "
            f"{rel:.3g} of bulk's loss (bound {TRAIN_LOSS_REL})")
    row = {"train_flash_launches_per_step": 2 * L, "train_step_ms": runs["kernel"][5][3],
           "train_step_ms_bulk": runs["bulk"][5][3],
           "train_tok_per_s": TRAIN_B * TRAIN_S / runs["kernel"][5][3] * 1e3,
           "train_peak_gb": runs["kernel"][3]}
    del runs
    # the prefill's 4 x 2048 tokens, kernel mode
    long_argv = ["--steps", str(TRAIN_LONG_STEPS), "--batch", str(TRAIN_LONG_B), "--seq",
                 str(TRAIN_LONG_S), "--lr", TRAIN_LR, "--log-every", "1", "--fusion", "kernel"]
    cut = dataclasses.replace(bundle, config=dataclasses.replace(cfg, n_layers=TRAIN_LONG_LAYERS))
    with swapped(launch_train, "get_arch", lambda name: cut):
        losses, counts, clock, peak, summary, med = launch_run(
            long_argv, TRAIN_LONG_B * TRAIN_LONG_S)
    expect_counts(f"{TRAIN_LONG_B}x{TRAIN_LONG_S}", counts,
                  flash_on_tile(TRAIN_LONG_STEPS * 2 * TRAIN_LONG_LAYERS))
    say(27, f"kernel mode at {TRAIN_LONG_B}x{TRAIN_LONG_S} tokens, {TRAIN_LONG_LAYERS} of {L} "
            f"layers{' (cut: the 28 do not fit)' if TRAIN_LONG_LAYERS < L else ''}, "
            f"{TRAIN_LONG_STEPS} steps: {summary}")
    return {**row, "train_long_step_ms": med[3], "train_long_peak_gb": peak}


def expect_counts(what, got, want):
    """counted_run's check on counts read after a run."""
    if any(got[n_] != want.get(n_, 0) for n_ in got if "." not in n_ or n_ in want):
        raise AssertionError(f"{what}: launches {got}, expected {want} and 0 elsewhere")


def train_phases(card, gen) -> dict:
    """Phases 25-27 (dense training of chatglm3-6b); returns the flash
    row's training numbers."""
    row = flash_train_phase(gen)
    torch.cuda.empty_cache()
    train_grad_phase(gen)
    torch.cuda.empty_cache()
    row.update(train_launcher_phase(card))
    return row


def flash_on_tile(n):
    """counted_run's expectation: n flash launches, every one on the tile path."""
    return {"flash_attention": n, "flash_attention.tile": n, "flash_attention.cuda_core": 0}


def flash_times(gen, b, s, hq, hkv, d, iters, plain,
                turns=("tile", "cuda_core", "cuda_core", "tile")):
    """CUDA-event times (means of ``iters`` launches) of the flash kernel at
    [b, s, hq, d] over hkv kv heads, bf16, causal, on both paths in
    ``turns`` (by default tile, CUDA core, CUDA core, tile), beside
    F.scaled_dot_product_attention, the plain version (if ``plain``) and
    flash_bound; the paths' outputs checked against SDPA's at BF16_TOL.
    Returns the times (ms) and a summary line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    bf16 = torch.bfloat16
    q = randn(gen, (b, s, hq, d), bf16)
    k, v = randn(gen, (b, s, hkv, d), bf16), randn(gen, (b, s, hkv, d), bf16)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    want = sdpa().transpose(1, 2)
    out = {"tile": [], "cuda_core": []}
    errs = {}
    for path in turns:
        run = lambda: flash_attention(q, k, v, _path=path)
        errs[path] = check_close(f"flash_attention {path} path vs SDPA [{b},{s},{hq},{d}]",
                                 run(), want, BF16_TOL)
        out[path].append(time_ms(run, iters=iters, warmup=1))
    del want
    out["sdpa"] = time_ms(sdpa, iters=2 * iters, warmup=2)
    out["plain"] = time_ms(lambda: flash_attention_plain(q, k, v), iters=2, warmup=1) if plain else None
    bnd, by, n_bytes, ops = flash_bound(b, s, hq, hkv, d, 2)
    out.update(bound=bnd, bound_by=by)
    ms = lambda ts: ", ".join(f"{t_:.4f}" for t_ in ts)
    out["line"] = (
        f"[{b},{s},{hq},{d}] over {hkv} kv heads bf16 causal: tile path {ms(out['tile'])} ms "
        f"({ops / min(out['tile']) / 1e9:.1f} TFLOP/s), CUDA-core path {ms(out['cuda_core'])} ms "
        f"({ops / min(out['cuda_core']) / 1e9:.1f} TFLOP/s), "
        + (f"plain {out['plain']:.4f} ms, " if plain else "")
        + f"F.scaled_dot_product_attention(is_causal, enable_gqa) {out['sdpa']:.4f} ms (max "
        f"abs/rel err vs it: tile {errs['tile'][0]:.3g}/{errs['tile'][1]:.3g}, CUDA core "
        f"{errs['cuda_core'][0]:.3g}/{errs['cuda_core'][1]:.3g}), bound {bnd:.4f} ms ({by}: "
        f"{ops / 1e9:.1f} GFLOP, {n_bytes / 1e6:.1f} MB); tile path at "
        f"{min(out['tile']) / out['sdpa']:.2f}x SDPA, "
        f"{min(out['cuda_core']) / min(out['tile']):.2f}x faster than the CUDA-core path")
    return out


def long_prefill_phase(card, gen, bundle, params, pre_k):
    """Phase 22: chatglm3-6b's prefill at the reference's prefill_32k length
    (32768 tokens), cut from batch 32 to LONG_B, in kernel mode: the flash
    kernel alone at [LONG_B, 32768, 32, 128] on both paths beside SDPA and
    its bound, its output for one query head per kv head in every batch row
    against the plain version on that head (at BF16_TOL and scaled to each
    row's size, check_rows), and the whole prefill's time, peak memory and
    each row's share of it, device busy share and launches (all 28 on the
    tile path).  Bulk mode and the exact f32 evaluation are not run at this
    length."""
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    cfg = bundle.config
    L, Hq, Hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = LONG_B, LONG_S
    # one turn a path (the CUDA-core path takes about a second a call here)
    fl = flash_times(gen, B, S, Hq, Hkv, hd, iters=1, plain=False, turns=("tile", "cuda_core"))
    bf16 = torch.bfloat16
    q = randn(gen, (B, S, Hq, hd), bf16)
    k, v = randn(gen, (B, S, Hkv, hd), bf16), randn(gen, (B, S, Hkv, hd), bf16)
    got = flash_attention(q, k, v)
    g = Hq // Hkv
    heads = range(0, Hq, g)    # one query head per kv head; plain scores are S^2 f32 a head
    head_errs = []
    for b in range(B):
        for h in heads:
            hk, name = h // g, f"flash_attention [{B},{S}] row {b} head {h} vs plain"
            want = flash_attention_plain(q[b:b + 1, :, h:h + 1], k[b:b + 1, :, hk:hk + 1],
                                         v[b:b + 1, :, hk:hk + 1])
            mine = got[b:b + 1, :, h:h + 1]
            head_errs.append(check_close(name, mine, want, BF16_TOL)
                             + check_rows(name, mine, want)
                             + (want.float().abs().mean().item(),))
            del want
    del q, k, v, got
    torch.cuda.empty_cache()

    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    batch = {"tokens": tokens}
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    (logits, cache), launch = counted_run(lambda: pre_k(params, batch), flash_on_tile(L))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    row_gb = (peak_gb - held_gb) / B
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    if logits.shape != (B, 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill_32k logits: shape {tuple(logits.shape)} or non-finite")
    if any(tuple(cache[key].shape) != (L, B, S, Hkv, hd) or not torch.isfinite(cache[key]).all()
           for key in ("k", "v")):
        raise AssertionError("prefill_32k cache: shapes or non-finite values")
    del logits, cache
    # the checked prefill above warmed the plans and the allocator
    t_pre = [time_ms(lambda: pre_k(params, batch), iters=1, warmup=0)]
    prof = profile_device(lambda i: pre_k(params, batch), 1, "prefill")
    say(22, f"on {card}: chatglm3-6b prefill at the reference's prefill_32k length, cut from "
            f"batch 32 to {B} (memory below): flash_attention {fl['line']}; "
            f"heads " + ", ".join(f"{h}" for h in heads) + f" (one per kv head) of every batch "
            f"row vs plain on that head: max abs/rel err, largest element's share of its "
            f"row-scaled bound ({ROW_REL:.4g} x the row's rms + {BF16_TOL['rtol']} x |want|), "
            f"largest row distance over the row's norm (bound {ROW_REL:.4g}), mean |want| "
            + ", ".join(f"{e[0]:.3g}/{e[1]:.3g}/{e[2]:.3g}/{e[3]:.3g}/{e[4]:.3g}" for e in head_errs)
            + f" (and {BF16_TOL}); kernel-mode prefill of {B}x{S} seeded tokens: launches flash "
            f"{launch['flash_attention']} (tile path {launch['flash_attention.tile']}), fused GEMV "
            f"{launch['fused_matmul_allreduce']}; logits [{B}, 1, {cfg.vocab}] finite; peak "
            f"{peak_gb:.2f} GB of the card's {card_gb:.2f} GB: {held_gb:.2f} GB held before "
            f"the prefill and {row_gb:.2f} GB per row of {S} tokens, so {B + 1} rows would need "
            f"{held_gb + (B + 1) * row_gb:.2f} GB (batch 32: {held_gb + 32 * row_gb:.1f} GB); "
            + ", ".join(f"{t_:.1f}" for t_ in t_pre)
            + f" ms per prefill (CUDA events; {L} x the tile path's {min(fl['tile']):.2f} ms is "
            f"{L * min(fl['tile']):.1f} ms of it); profile: {prof}; bulk mode and the exact f32 "
            f"evaluation are not run at this length")


# Paged serving (phases 23-24): the launcher's defaults (batch 4, block 16,
# chunk 8, a pool of half the dense B x S_max budget: 512 blocks); (b)'s
# prompts of 1, 37, 140 and 250 seeded tokens, 8 new tokens each; (c) the
# same traffic on 25 blocks (400 tokens).  The engine allocates a prompt's
# blocks whole at admission, so a request grows only while it decodes, a
# block per 16 tokens: on 25 blocks the 250-token prompt (16 blocks) waits
# until the short ones have finished (its admission is deferred), is then
# admitted beside the 140-token one (9), the pool fills, and the 140-token
# request's growth at position 144 preempts it (the engine's own schedule,
# checked on the CPU with a stand-in serve step: on 24 blocks nothing is
# preempted).  (The prompts were 300 and 500 tokens on 51 blocks until the
# script's time was cut, and 1000 tokens on 82 blocks before that: those
# chunk steps and their replays took 84 s of a 771 s run on one H100 80GB
# HBM3.)
PAGED_B, PAGED_BLOCK, PAGED_CHUNK = 4, 16, 8
PAGED_PROMPTS, PAGED_NEW, PAGED_TIGHT = (1, 37, 140, 250), 8, 25
# gemma2-27b (phases 32-34), full width: 46 layers, 54.5 GB of bf16 weights
# on one card.  A prefill of 1 x GEMMA_S seeded tokens, past the window of
# 4096 on its 23 local layers (at 2048 every layer would see every key),
# then GEMMA_STEPS greedy decode steps from position GEMMA_S in a cache of
# GEMMA_S + GEMMA_STEPS positions; decode and paged serving at the
# launcher's traffic, batch 4, GEMMA_REQS prompts x GEMMA_NEW new tokens.
GEMMA_S, GEMMA_STEPS, GEMMA_REQS, GEMMA_NEW = 8192, 8, 4, 8
# The teacher-forced bulk and exact f32 decode replays run on a cache of
# GEMMA_TF_SEQ positions (the requests end by position 13): the launcher's
# 4096-position cache in f32 would take 12.3 GB beside the weights.
GEMMA_TF_SEQ = 64
# q is scaled by FLASH_Q_SCALE in phase 32 so that gemma2's scores, (q . k)
# / 12 at head size 128, have a spread of about 19 and reach 2-3 times the
# cap of 50: the cap bends their tails
FLASH_Q_SCALE = 20.0
FLASH_LONG_S = 32768     # the reference's prefill_32k length, batch 1



def record(fn, log):
    """``fn`` (a serve step: params, tokens, pool, tables, pos, n_new) that
    appends each call's inputs, logits and launches per wrapper to ``log``
    (the counts are the host-side counters: no synchronisation)."""
    def run(p, tokens, pool, tables, pos, n_new):
        before = launch_counts()
        logits, pool = fn(p, tokens, pool, tables, pos, n_new)
        after = launch_counts()
        log.append({"in": (tokens.clone(), tables.clone(), pos.clone(), n_new.clone()),
                    "logits": logits.clone(),
                    "launches": {n_: after[n_] - before[n_] for n_ in after}})
        return logits, pool
    return run


def tracked_engine(log, where):
    """A PagedDecodeEngine class that notes which logged step (an index into
    ``log``, which its serve function appends to) and slot produced each
    generated token: ``where[(uid, k)] = (step, slot)`` for token k."""
    from repro_torch.serve.engine import PagedDecodeEngine

    class Tracked(PagedDecodeEngine):
        def _admit(self, finished):
            super()._admit(finished)
            self._seen = [(i, r, len(r.tokens)) for i, r in enumerate(self.slots) if r]

        def step(self):
            out = super().step()
            for i, r, n in self._seen:
                for k in range(n, len(r.tokens)):
                    where[(r.uid, k)] = (len(log) - 1, i)
            return out
    return Tracked


def recorded_launch(argv, params, log, where):
    """``launch.serve.main(argv)`` (a --paged serve) with ``params`` swapped
    in for the weights its init_params would draw (the same seed on the
    card: the same values), every serve step recorded in ``log``
    (:func:`record`) and each generated token's step and slot in ``where``
    (:func:`tracked_engine`); returns the finished requests."""
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch_serve

    real_fn = registry.ArchBundle.serve_step_fn
    with swapped(registry.ArchBundle, "init_params", lambda self, g, ctx=None: params), \
            swapped(registry.ArchBundle, "serve_step_fn",
                    lambda self, c: record(real_fn(self, c), log)), \
            swapped(launch_serve, "PagedDecodeEngine", tracked_engine(log, where)):
        return launch_serve.main(argv)


def check_step_launches(log, mode, L, d_ff, d_model) -> dict:
    """Every logged step launched the fused kernel once a layer (kernel
    mode), on the path fused_path picks for its B x C rows, and no other
    kernel; bulk mode launched nothing.  Returns steps by path."""
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_path

    by_path = {}
    for i, e in enumerate(log):
        rows = e["in"][0].numel()
        path = fused_path(torch.bfloat16, rows, d_ff, d_model)
        want = ({"fused_matmul_allreduce": L, f"fused_matmul_allreduce.{path}": L}
                if mode == "kernel" else {})
        got = e["launches"]
        if any(v != want.get(n_, 0) for n_, v in got.items() if "." not in n_ or n_ in want):
            raise AssertionError(f"{mode} step {i} ({rows} rows): launches {got}, expected "
                                 f"{want} and 0 elsewhere")
        key = f"{rows} rows/{path if mode == 'kernel' else 'no kernel'}"
        by_path[key] = by_path.get(key, 0) + 1
    return by_path


def replay(serve, params, log, new_pool):
    """Teacher-forced: ``log``'s inputs, in order, through ``serve`` on a
    fresh pool; returns the logits of each step."""
    pool, out = new_pool(), []
    for e in log:
        lg, pool = serve(params, e["in"][0], pool, *e["in"][1:])
        out.append(lg)
    return out


def live_err(log, a, b):
    """Max |a - b| over the live rows (n_new > 0) of every step of ``log``,
    for two lists of its steps' logits."""
    return max(((x - y)[e["in"][3] > 0].abs().max().item() for e, x, y in zip(log, a, b)),
               default=0.0)


def paged_phases(card, gen, bundle, params) -> dict:
    """Phases 23-24: full-width chatglm3-6b served through the paged engine
    (chunked prefill) on phases 20-22's weights, in kernel and bulk mode:
    (a) the launcher's own traffic through ``launch.serve.main(["--paged",
    ...])``, its weights swapped in for the ones its ``init_params`` would
    draw (the same seed on the card: the same values), kernel mode held to
    bulk mode teacher-forced; (b) prompts of 1-250 tokens, their first
    generated token's logits against a dense prefill; (c) (b)'s traffic on
    a pool that defers and preempts; (d) launches per step; (e) no host
    synchronisation inside ``serve_step``; (f) the fused kernel at the
    chunk's rows against its plain version; then the times.  Returns the
    fused kernel's numbers at the chunk's rows for its JSON row."""
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.launch import serve as launch_serve
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.serve.engine import DecodeEngine, PagedDecodeEngine, Request
    from repro_torch.serve.kv_cache import dense_cache_hbm_bytes, pool_hbm_bytes

    # 23 --------------------------------------------------------------
    bf16 = torch.bfloat16
    cfg = bundle.config
    L, B, D, F = cfg.n_layers, PAGED_B, cfg.d_model, cfg.d_ff
    ctx = {m: ParallelContext(device="cuda", fusion=FusionConfig(mode=m))
           for m in ("kernel", "bulk")}
    serve = {m: bundle.serve_step_fn(c) for m, c in ctx.items()}
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    serve_x = exact.serve_step_fn(ctx["bulk"])
    params32 = _map(params, lambda t_: t_.float())
    nb = B * cfg.max_seq // 2 // PAGED_BLOCK           # the launcher's default pool
    new_pool = lambda b_, n_: (lambda: b_.init_paged_pool(n_, PAGED_BLOCK, "cuda"))
    def launcher(mode, log, where):
        return recorded_launch(["--paged", "--fusion", mode, "--requests", "8", "--batch",
                                str(B), "--max-new", "16", "--block-size", str(PAGED_BLOCK),
                                "--chunk", str(PAGED_CHUNK)], params, log, where)

    def forced(name, log, ref_k, ref_b, ref_x, e_bx=None):
        """Kernel vs bulk teacher-forced, bound LOGITS_TOL_FACTOR x bulk's
        distance from exact f32 (``ref_x``'s, or ``e_bx`` given without it);
        returns the three distances (kernel vs exact None without ``ref_x``)."""
        e_kb = live_err(log, ref_k, ref_b)
        if ref_x is not None:
            e_bx = live_err(log, ref_b, ref_x)
        e_kx = None if ref_x is None else live_err(log, ref_k, ref_x)
        if not e_kb <= LOGITS_TOL_FACTOR * e_bx:
            raise AssertionError(f"{name}: teacher-forced logits kernel vs bulk {e_kb:.3g} > "
                                 f"{LOGITS_TOL_FACTOR} x bulk vs exact f32 {e_bx:.3g}")
        for lg in ref_k:
            if lg.shape != (B, cfg.vocab) or not torch.isfinite(lg).all():
                raise AssertionError(f"{name}: logits of shape {tuple(lg.shape)} or non-finite")
        return e_kb, e_bx, e_kx

    # (a) the launcher's traffic, kernel then bulk mode, each with its streams
    log_a, log_ab, where_a = [], [], {}
    fin_k = launcher("kernel", log_a, where_a)
    fin_b = launcher("bulk", log_ab, {})
    paths_a = check_step_launches(log_a, "kernel", L, F, D)
    check_step_launches(log_ab, "bulk", L, F, D)
    ref_a = replay(serve["bulk"], params, log_a, new_pool(bundle, nb))
    sk = {r.uid: r.tokens for r in fin_k}
    sb = {r.uid: r.tokens for r in fin_b}
    if sorted(sk) != list(range(8)) or any(len(v) != 16 for v in list(sk.values()) + list(
            sb.values())) or any(not 0 <= t_ < cfg.vocab for v in sk.values() for t_ in v):
        raise AssertionError(f"(a): streams {sk} / {sb}")
    differing = sum(a != b for u in sk for a, b in zip(sk[u], sb[u]))
    if any(int(log_a[s_]["logits"][slot].argmax()) != sk[u][k]
           for (u, k), (s_, slot) in where_a.items()) or len(where_a) != 8 * 16:
        raise AssertionError("(a): the kernel streams are not the logged steps' greedy tokens")
    # (a) is held to (b)'s exact f32 replay (one replay of the f32 copy, not
    # two), below

    # (b) long prompts: many chunk steps crossing blocks while others decode
    prompts = [torch.randint(0, cfg.vocab, (n_,), generator=gen, device="cuda").tolist()
               for n_ in PAGED_PROMPTS]

    def drive(num_blocks, log):
        """(b)'s requests through a kernel-mode PagedDecodeEngine of
        ``num_blocks`` blocks, its steps recorded in ``log``; returns the
        engine, the requests and, per request, the step and slot of its
        first generated token."""
        rec, where = record(serve["kernel"], log), {}
        eng = tracked_engine(log, where)(
            lambda t_, pl, tb, p_, n_: rec(params, t_, pl, tb, p_, n_),
            lambda n_, bs: bundle.init_paged_pool(n_, bs, "cuda"), B, num_blocks=num_blocks,
            block_size=PAGED_BLOCK, max_seq=cfg.max_seq, chunk=PAGED_CHUNK, device="cuda")
        reqs = [Request(uid=i, prompt=p_, max_new=PAGED_NEW) for i, p_ in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        if not eng.run_until_drained().drained or any(
                len(r.tokens) != PAGED_NEW or not r.done for r in reqs):
            raise AssertionError(f"paged engine: requests {[len(r.tokens) for r in reqs]}")
        return eng, reqs, {r.uid: where[(r.uid, 0)] for r in reqs}

    log_b = []
    eng_b, reqs_b, first = drive(nb, log_b)
    paths_b = check_step_launches(log_b, "kernel", L, F, D)
    ref_b = replay(serve["bulk"], params, log_b, new_pool(bundle, nb))
    ref_x = replay(serve_x, params32, log_b, new_pool(exact, nb))
    e_b = forced("(b)", log_b, [e["logits"] for e in log_b], ref_b, ref_x)
    pre_b = bundle.prefill_fn(ctx["bulk"])
    pre_x = exact.prefill_fn(ctx["bulk"])
    firsts = []
    for r in reqs_b:
        s_, slot = first[r.uid]
        batch = {"tokens": torch.tensor([r.prompt], device="cuda")}
        db, dx = pre_b(params, batch)[0][0, 0], pre_x(params32, batch)[0][0, 0]
        pb_, px_ = ref_b[s_][slot], ref_x[s_][slot]
        d = errors(pb_, db)[0]
        tol = LOGITS_TOL_FACTOR * max(errors(pb_, px_)[0], errors(db, dx)[0])
        if d > tol:
            raise AssertionError(f"(b) request {r.uid} ({len(r.prompt)} tokens): paged first-token "
                                 f"logits {d:.3g} from the dense prefill's, above {tol:.3g}")
        firsts.append(f"{len(r.prompt)} tokens {d:.3g} (bound {tol:.3g}; exact f32 paged vs "
                      f"dense {errors(px_, dx)[0]:.3g})")
    del ref_b, ref_x
    # (a): kernel vs bulk teacher-forced, bound LOGITS_TOL_FACTOR x (b)'s bulk
    # distance from exact f32 (the same weights and engine; (a)'s own exact
    # replay was cut for phases 44-48's time)
    e_a = forced("(a)", log_a, [e["logits"] for e in log_a], ref_a, None, e_b[1])
    # bulk mode teacher-forced on the kernel run's inputs, which match the
    # bulk run's for a request up to its first difference
    flips = near_tie_flips([sk[u] for u in sorted(sk)], [sb[u] for u in sorted(sk)],
                           lambda u, k: ref_a[where_a[(u, k)][0]][where_a[(u, k)][1]],
                           LOGITS_TOL_FACTOR * e_a[1])
    del ref_a
    say(23, f"(a) the launcher (--paged, batch {B}, 8 requests x 16 tokens, block "
            f"{PAGED_BLOCK}, chunk {PAGED_CHUNK}, default pool {nb} blocks): {len(log_a)} steps "
            f"by B x C rows and fused path {paths_a}; teacher-forced logits (live rows) max abs "
            f"err: kernel vs bulk {e_a[0]:.3g} (bound {LOGITS_TOL_FACTOR * e_a[1]:.3g}: "
            f"{LOGITS_TOL_FACTOR} x (b)'s bulk vs exact f32); kernel streams "
            f"{[sk[u] for u in sorted(sk)]}; bulk streams {[sb[u] for u in sorted(sb)]}; "
            f"differing tokens {differing}" + (f" ({'; '.join(flips)})" if flips else ""))
    say(23, f"(b) prompts of {list(PAGED_PROMPTS)} seeded tokens x {PAGED_NEW} new, batch {B}, "
            f"chunk {PAGED_CHUNK}, {nb} blocks: {len(log_b)} steps {paths_b}, peak "
            f"{eng_b.kv.peak_blocks} blocks; teacher-forced kernel vs bulk {e_b[0]:.3g} (bound "
            f"{LOGITS_TOL_FACTOR * e_b[1]:.3g}), bulk vs exact f32 {e_b[1]:.3g}, kernel vs exact "
            f"{e_b[2]:.3g}; first generated token's logits, paged (bulk) vs a dense prefill_forward "
            f"on the prompt (bulk), bound {LOGITS_TOL_FACTOR} x the larger of the two's distances "
            f"from their exact f32 evaluations: " + "; ".join(firsts))

    # (c) a pool that must defer admissions and preempt
    log_c = []
    eng_c, reqs_c, _ = drive(PAGED_TIGHT, log_c)
    check_step_launches(log_c, "kernel", L, F, D)
    if not (eng_c.deferred >= 1 and eng_c.preempted >= 1):
        raise AssertionError(f"(c): deferred {eng_c.deferred}, preempted {eng_c.preempted}")
    for e in log_c:
        if not torch.isfinite(e["logits"][e["in"][3] > 0]).all():
            raise AssertionError("(c): non-finite logits")
    say(23, f"(c) (b)'s traffic on {PAGED_TIGHT} blocks ({PAGED_TIGHT * PAGED_BLOCK} tokens): "
            f"{len(log_c)} steps, admissions deferred {eng_c.deferred} times, requests "
            f"preempted {eng_c.preempted} times, peak {eng_c.kv.peak_blocks} blocks; every request "
            f"drained with {PAGED_NEW} tokens and finite logits; kernel streams "
            f"{[r.tokens for r in reqs_c]} (without the squeeze: {[r.tokens for r in reqs_b]})")
    del log_c, eng_c

    # (d) launches per step, checked on every step above
    c1 = next(e for e in log_a if e["in"][0].shape[1] == 1)
    c8 = next(e for e in log_b if e["in"][0].shape[1] == PAGED_CHUNK and (e["in"][3] > 0).all())
    say(23, f"(d) launches per step in kernel mode, every step of (a), (b) and (c): "
            f"fused_matmul_allreduce {L} (tile path at {B * PAGED_CHUNK} rows: "
            f"{c8['launches']['fused_matmul_allreduce.tile']}, stream path at {B} rows: "
            f"{c1['launches']['fused_matmul_allreduce.stream']}), flash "
            f"{c8['launches']['flash_attention']}, gemv {c8['launches']['gemv']}; bulk mode 0")

    # (e) serve_step never synchronises with the host
    pool = eng_b.pool
    for e in (c1, c8):
        for m in ("kernel", "bulk"):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                serve[m](params, e["in"][0], pool, *e["in"][1:])
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    say(23, f"(e) serve_step at C = 1 and C = {PAGED_CHUNK}, kernel and bulk mode, under "
            f"torch.cuda.set_sync_debug_mode('error'): no call synchronised")

    # (f) the fused kernel at the chunk's rows against its plain version
    rows = B * PAGED_CHUNK
    w = params["layers"][0]["ffn"]["w_down"]
    x = randn(gen, (rows, F), bf16)
    path = fused_path(bf16, rows, F, D)
    got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, w))
    if took != path:
        raise AssertionError(f"fused [{rows},{F}]: took the {took} path, fused_path says {path}")
    err = check_close(f"fused [{rows},{F}]@[{F},{D}] {took} path", got,
                      fused_matmul_allreduce_ref(x, w), BF16_TOL)
    say(23, f"(f) fused_matmul_allreduce [{rows},{F}]@[{F},{D}] bf16 (layer 0's w_down) on the "
            f"{took} path vs plain: max abs/rel err {err[0]:.3g}/{err[1]:.3g} (bound {BF16_TOL})")

    # 24 --------------------------------------------------------------
    step_t = {}
    for name, e in (("C=1", c1), (f"C={PAGED_CHUNK}", c8)):
        step_t[name] = {"kernel": [], "bulk": []}
        for m in ("kernel", "bulk"):      # one turn each (turns cut for phases 44-48)
            step_t[name][m].append(time_ms(
                lambda: serve[m](params, e["in"][0], pool, *e["in"][1:]), iters=5, warmup=1))
    prof = {f"{m} {name}": profile_device(lambda i: serve[m](params, e["in"][0], pool,
                                                             *e["in"][1:]), 3, "step")
            for name, e in (("C=1", c1), (f"C={PAGED_CHUNK}", c8)) for m in ("kernel", "bulk")}

    def drain(paged):
        reqs = launch_serve.make_requests(8, cfg.vocab, 16)
        if paged:
            eng = PagedDecodeEngine(
                lambda t_, pl, tb, p_, n_: serve["kernel"](params, t_, pl, tb, p_, n_),
                lambda n_, bs: bundle.init_paged_pool(n_, bs, "cuda"), B, num_blocks=nb,
                block_size=PAGED_BLOCK, max_seq=cfg.max_seq, chunk=PAGED_CHUNK, device="cuda")
        else:
            dec = bundle.decode_fn(ctx["kernel"])
            eng = DecodeEngine(lambda t_, c_, p_: dec(params, t_, c_, p_),
                               lambda b_: bundle.init_cache(b_, "cuda"), B, device="cuda",
                               max_seq=cfg.max_seq)
        for r in reqs:
            eng.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fin = eng.run_until_drained()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not fin.drained:
            raise AssertionError("drain did not finish")
        return sum(len(r.tokens) for r in fin) / dt, dt

    tps = {"paged": [], "dense": []}
    for kind in ("paged", "dense"):       # one drain each (turns cut for phases 44-48)
        tps[kind].append(drain(kind == "paged"))
    t_path = {"tile": [], "stream": []}
    for p_ in ("tile", "stream", "stream", "tile"):
        t_path[p_].append(time_ms(lambda: fused_matmul_allreduce(x, w, _path=p_)))
    t_mm = time_ms(lambda: torch.matmul(x, w))
    t_plain = time_ms(lambda: fused_matmul_allreduce_ref(x, w), iters=10)
    bnd, bound_by = bound_ms(rows, F, D, 2)
    pool_b = pool_hbm_bytes(pool)
    dense_b = dense_cache_hbm_bytes(bundle.init_cache(B, "meta"))
    ms = lambda ts: ", ".join(f"{t_:.4f}" for t_ in ts)
    say(24, f"on {card}: serve_step per step (CUDA events, kernel then bulk): "
            + "; ".join(f"{name} " + ", ".join(f"{m} {ms(v)}" for m, v in d.items()) + " ms"
                        for name, d in step_t.items())
            + "; profiles: " + "; ".join(f"{n_} {p_}" for n_, p_ in prof.items())
            + f"; the launcher's traffic (8 requests x 16 tokens, batch {B}, kernel mode, host "
            f"clock around the drain, paged then dense): "
            + "; ".join(f"{k_} " + ", ".join(f"{v[0]:.1f} tok/s ({v[1]:.2f} s)" for v in vs)
                        for k_, vs in tps.items())
            + f"; fused_matmul_allreduce [{rows},{F}]@[{F},{D}] bf16: tile path {ms(t_path['tile'])}"
            f" ms, stream path {ms(t_path['stream'])} ms, torch.matmul {t_mm:.4f} ms, plain "
            f"{t_plain:.4f} ms, bound {bnd:.4f} ms ({bound_by}); pool {pool_b / 2**20:.1f} MiB "
            f"({nb} + 1 sink blocks of {PAGED_BLOCK} tokens) vs dense B x S_max cache "
            f"{dense_b / 2**20:.1f} MiB")
    return {"chunk_rows": {
        "shape": f"[{rows},{F}]@[{F},{D}] bf16", "path": took, "max_abs_err": err[0],
        "ms": min(t_path[took]), "path_ms": {k_: min(v) for k_, v in t_path.items()},
        "plain_ms": t_plain, "bound_ms": bnd, "bound_by": bound_by, "library_ms": t_mm,
        "launches_per_step": L, "launches": sum(e["launches"]["fused_matmul_allreduce"]
                                                for e in log_a)}}


def wkv6_inputs(gen, b, t, h, n):
    """r, k, v, w [b, t, h, n] f32 and u [h, n] on the card: decays
    exp(-exp(N(0, 1))) with 5 % below the 1e-8 clip and 5 % within 1e-6 of
    1, and a non-zero bonus."""
    shape = (b, t, h, n)
    r, v = randn(gen, shape, torch.float32), randn(gen, shape, torch.float32)
    k = randn(gen, shape, torch.float32, 0.3)
    w = torch.exp(-torch.exp(randn(gen, shape, torch.float32)))
    pick = torch.rand(shape, generator=gen, device="cuda")
    w = torch.where(pick < 0.05, 1e-12, torch.where(pick > 0.95, 1.0 - 1e-6, w))
    return r, k, v, w, randn(gen, (h, n), torch.float32, 0.5)


def plain_wkv6(r, k, v, w, u, *, chunk):
    """The WKV6 op's plain chunked version from a zero state: (o, state)."""
    from repro_torch.kernels.rwkv6.ref import wkv6_chunked

    b, _, h, n = r.shape
    zero = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    return wkv6_chunked(r.float(), k.float(), v.float(), w.float(), u.float(), zero,
                        min(chunk, r.shape[1]))


@contextlib.contextmanager
def swapped(module, name, fn):
    """The model module ``module`` calls ``fn`` in place of its kernel op
    ``name`` meanwhile (the op's plain version, or a spy)."""
    kept = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, kept)


class UpcastLayers:
    """A model's layer list read in f32 one layer at a time, as the layer
    loop reaches it: the exact f32 evaluation without an f32 copy of every
    layer.  A layer's copy is emptied when the loop asks for the next one
    (the loop's variable still names it then), so that one f32 layer is
    alive, not two (gemma2-27b's are 2.3 GB each).  So the loop must be done
    with a layer when it asks for the next: every prefill and decode loop
    is, and train_forward's at a layer pattern of one (a longer pattern's
    groups are not)."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        prev = {}
        for lp in self.layers:
            prev.clear()
            prev = _map(lp, lambda t: t.float())
            yield prev


def wkv6_bound(bh, t, n):
    """Least time for one WKV6 call, (ms, bound_by, bytes, operations): f32
    r, k, v, w read once, o and the final state written once, over HBM; or
    the f32 operations of the least work, the per-step recurrence, at the
    f32 peak.  Per step and (b, h): o = r S + (r u k) v, 2 n^2 + 5 n; S <-
    w S + k^T v, 3 n^2.  The chunked form does more (pairwise decays)."""
    n_bytes = 4 * (5 * bh * t * n + bh * n * n)
    ops = bh * t * (5 * n * n + 5 * n)
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, ops


def ffn_split_times(xt, wu, wg, wd) -> dict:
    """fused_gemm_a2a's stream path with the cluster forced to each split
    from 1 to 8 CTAs (the planner's capacity query answers 0 for every
    other split), in fresh plan caches: split -> (resident clusters, ms)."""
    from repro_torch.kernels import PlanCache
    from repro_torch.kernels.fused_gemm_a2a import ops as ffn_ops

    real = ffn_ops.cluster_capacity
    got = {}
    for split in range(1, 9):
        def forced(query, *args, name, split=split):
            cap = real(query, *args, name=name)
            return lambda s_, r_, ks_: cap(s_, r_, ks_) if s_ == split else 0
        cache = PlanCache()
        with swapped(ffn_ops, "cluster_capacity", forced), swapped(ffn_ops, "_PLANS", cache):
            t_ = time_ms(lambda: ffn_ops.fused_gemm_a2a(xt, wu, wg, wd), iters=20, warmup=3)
        (key, (plan, _)), = cache.plans.items()
        got[split] = (plan.stream_plan.clusters, t_)
        cache.drop(key)
    return got


def wkv6_exps(bh, t, n, c) -> dict:
    """Exponentials one WKV6 call evaluates over bh heads of t steps in
    chunks of c: the reference's form (a pairwise decay for each s < t of a
    chunk, and the decays of r, k and the state), and the kernel's
    (csrc/wkv6.cu: pairs only inside 8-step sub-chunks, the factors of the
    cross terms, the same decays of r, k and the state)."""
    from repro_torch.kernels.rwkv6.ref import SUB

    subs = [min(SUB, c - j) for j in range(0, c, SUB)]
    per_ref = c * (c - 1) // 2 * n + 2 * c * n + n
    per_kernel = (sum(q * (q - 1) // 2 for q in subs) * n       # pairs inside sub-chunks
                  + len(subs) * (len(subs) - 1) // 2 * n        # M
                  + (c - subs[0]) * n + c * n                   # r', k''
                  + 2 * c * n + n)                              # rdec, kdec, the state's
    chunks = bh * (t // c)
    return {"reference": chunks * per_ref, "kernel": chunks * per_kernel}


def max_sm_hz() -> float:
    """The card's highest SM clock, from nvidia-smi."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         check=True, capture_output=True, text=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def bounded_errors(what, triples, yard="bulk") -> str:
    """For each (kernel, yardstick, exact) triple: the kernel path's and the
    yardstick path's (bulk mode unless ``yard`` names another) distances
    from the exact f32 evaluation and from each other; the kernel path's
    must lie within LOGITS_TOL_FACTOR x the yardstick's."""
    out = []
    for key, (kern, bulk, ex) in triples.items():
        kx, bx, kb = errors(kern, ex)[0], errors(bulk, ex)[0], errors(kern, bulk)[0]
        if kx > LOGITS_TOL_FACTOR * bx or kb > LOGITS_TOL_FACTOR * bx:
            raise AssertionError(f"{what} {key}: kernel vs exact f32 {kx:.3g}, kernel vs {yard} "
                                 f"{kb:.3g}, above {LOGITS_TOL_FACTOR} x {yard} vs exact {bx:.3g}")
        out.append(f"{key} {kx:.3g}/{bx:.3g}/{kb:.3g}")
    return ", ".join(out)


def moe_routed(params, h, mcfg, gate_i):
    """Bulk-mode MoE layer with the experts of each token given
    (gate_i [T, K]) instead of chosen by its own router: the gate weights
    are this input's router probabilities at those experts."""
    from repro_torch.kernels.fused_gemm_a2a.ref import ACTS
    from repro_torch.models.moe import _capacity_slots, _dispatch_buf, _plus_shared, _unpermute

    toks = h.reshape(-1, mcfg.d_model)
    probs = torch.softmax(toks.float() @ params["router"].float(), dim=-1)
    gate_w = probs.gather(1, gate_i)
    if mcfg.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_w = gate_w * mcfg.router_scale
    e_clip, p_clip, valid, cap = _capacity_slots(mcfg, gate_i)
    buf = _dispatch_buf(mcfg, toks, e_clip, p_clip, valid, cap, h.dtype)
    g = torch.einsum("ecd,edf->ecf", buf, params["w_gate"])
    u = torch.einsum("ecd,edf->ecf", buf, params["w_up"])
    y = torch.einsum("ecf,efd->ecd", ACTS[mcfg.act](g) * u, params["w_down"])
    return _plus_shared(params, h, _unpermute(mcfg, y, gate_w, e_clip, p_clip, valid, h.shape,
                                              h.dtype), mcfg.act)


def teacher_forced_moe(bundle, params, ctx_k, ctx_b, log_k) -> dict:
    """Decode the kernel run's inputs again, step by step, in three streams
    with their own caches: kernel mode, bulk mode, and bulk mode in exact
    f32 (a layer's attention and dense FFN upcast while it runs, the routed
    experts one at a time through :func:`moe_exact`: an f32 copy of all the
    weights would not fit, and one of deepseek-v3's MoE layers alone is 45.1
    GB).

    A token whose router sits at a near tie may go to other experts in
    another mode, and from there the streams part for good.  So the bulk
    and exact streams are teacher-forced on routing too: their MoE layers
    take the experts the kernel stream chose (:func:`moe_routed`,
    :func:`moe_exact`), and the logits of all steps are compared as phase 5
    compares them.  Where a stream's own router would first choose other
    experts than the kernel stream's, the step, layer, token and router
    margin are reported, and kernel and bulk MoE inputs there must agree to
    ``H_DIVERGE_REL``.  At every MoE layer the kernel stream's input also
    goes through bulk mode, and the two outputs must agree to ``REL_BF16``
    of the largest.  The caches after the last step (dbrx's k and v,
    deepseek-v3's latents c and kr) are held as the logits are.  Returns the
    first route divergence's step (``s_kb``), the logits' bound, bulk mode's
    logits, the summary, and the kernel stream's input to its first MoE
    layer at the last step (the main path's expert-FFN input)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embedding_lookup, mlp_apply, rms_norm
    from repro_torch.models.moe import moe_apply

    cfg = bundle.config
    cfg_x = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    streams = {"kernel": (ctx_k, cfg), "bulk": (ctx_b, cfg), "exact": (ctx_b, cfg_x)}
    caches = {m: tfm.init_cache(c, len(log_k[0][0]), "cuda") for m, (_, c) in streams.items()}
    K = cfg.moe.top_k
    logits = {m: [] for m in streams}
    first = {"bulk": None, "exact": None}
    layer_rel, replay, h_moe = 0.0, 0.0, None
    upcast = lambda t: _map(t, lambda v: v.float())

    def probs(h, router):
        return torch.softmax(h.reshape(-1, cfg.d_model).float() @ router.float(), dim=-1)

    def margin(p, tok):
        top = p[tok].topk(K + 1).values
        return (top[K - 1] - top[K]).item()

    for s, (tok, pos, lk) in enumerate(log_k):
        x = {m: embedding_lookup(ctx, params["embed"], tok, seq_shard=False).to(c.cdtype)
             for m, (ctx, c) in streams.items()}
        for i, (lp, window) in enumerate(tfm.decoder_layers(params, cfg)):
            dense = "router" not in lp["ffn"]
            up = {"ln1": lp["ln1"].float(), "ln2": lp["ln2"].float(), "attn": upcast(lp["attn"])}
            if dense:
                up["ffn"] = upcast(lp["ffn"])
            lps = {"kernel": lp, "bulk": lp, "exact": up}
            h = {}
            for m, (ctx, c) in streams.items():
                lc = {k_: v_[i] for k_, v_ in caches[m].items()}
                x[m] = x[m] + tfm._attn_decode(ctx, c, lps[m], x[m], lc, pos, window)
                h[m] = rms_norm(x[m], lps[m]["ln2"], c.norm_eps, plus_one=c.norm_plus_one)
            if dense:
                for m, (ctx, c) in streams.items():
                    x[m] = x[m] + mlp_apply(ctx, lps[m]["ffn"], h[m], act=cfg.act,
                                            seq_sharded=False)
                del up, lps
                continue
            p = {m: probs(h[m], lp["ffn"]["router"]) for m in streams}
            chosen = p["kernel"].topk(K).indices.sort(dim=1).values
            f = moe_apply(ctx_k, lp["ffn"], h["kernel"], cfg.moe)
            layer_rel = max(layer_rel, check_rel(
                f"MoE layer {i} step {s}: kernel vs bulk on identical input", f,
                moe_apply(ctx_b, lp["ffn"], h["kernel"], cfg.moe), REL_BF16)[1])
            if s == len(log_k) - 1 and h_moe is None:
                h_moe = h["kernel"]
            x["kernel"] = x["kernel"] + f
            for m in ("bulk", "exact"):
                own = p[m].topk(K).indices.sort(dim=1).values
                if first[m] is None and not torch.equal(own, chosen):
                    t = int((own != chosen).any(dim=1).nonzero()[0, 0])
                    first[m] = dict(step=s, layer=i, token=t, h_rel=errors(h["kernel"], h[m])[1],
                                    margin_k=margin(p["kernel"], t), margin=margin(p[m], t))
            x["bulk"] = x["bulk"] + moe_routed(lp["ffn"], h["bulk"], cfg.moe, chosen)
            x["exact"] = x["exact"] + moe_exact(lp["ffn"], h["exact"], cfg.moe, chosen)
            del up, lps
        for m, (ctx, c) in streams.items():
            xf = rms_norm(x[m], params["final_norm"], c.norm_eps, plus_one=c.norm_plus_one)
            lg = tfm._lm_logits(params, c, xf)      # upcasts the table for the exact stream
            if lg.shape != lk.shape or not torch.isfinite(lg).all():
                raise AssertionError(f"{m} logits: shape {tuple(lg.shape)} or non-finite")
            logits[m].append(lg)
        replay = max(replay, (logits["kernel"][-1] - lk).abs().max().item())

    def err(a, b):
        return max((la - lb).abs().max().item() for la, lb in zip(logits[a], logits[b]))

    err_kb, err_bx, err_kx = err("kernel", "bulk"), err("bulk", "exact"), err("kernel", "exact")
    tol = LOGITS_TOL_FACTOR * err_bx
    if err_kb > tol or err_kx > tol:
        raise AssertionError(f"teacher-forced logits: kernel vs bulk {err_kb:.3g}, kernel vs "
                             f"exact {err_kx:.3g}, above {LOGITS_TOL_FACTOR} x bulk vs exact "
                             f"f32 {err_bx:.3g}")
    if first["bulk"] and first["bulk"]["h_rel"] > H_DIVERGE_REL:
        raise AssertionError(f"bulk mode's router parts from kernel mode's with MoE inputs "
                             f"{first['bulk']['h_rel']:.3g} apart (of max |h|), above "
                             f"{H_DIVERGE_REL:.3g}: {first['bulk']}")
    cache_txt = bounded_errors("decode cache", {
        k_: tuple(caches[m][k_] for m in ("kernel", "bulk", "exact")) for k_ in caches["kernel"]})

    def where(d):
        if d is None:
            return "never"
        return (f"step {d['step']} layer {d['layer']} token {d['token']} (MoE inputs "
                f"{d['h_rel']:.3g} apart of max |h|; router margin {d['margin_k']:.3g} in the "
                f"kernel stream, {d['margin']:.3g} in its own)")

    summary = (f"every MoE layer, kernel vs bulk on identical input: max rel err {layer_rel:.3g} "
               f"(bound {REL_BF16}); teacher-forced logits max abs err: kernel vs bulk "
               f"{err_kb:.3g}, kernel vs exact f32 {err_kx:.3g} (bound {tol:.3g}), bulk vs exact "
               f"{err_bx:.3g}; caches after the last step, kernel vs exact / bulk vs "
               f"exact / kernel vs bulk (bound {LOGITS_TOL_FACTOR} x the second): {cache_txt}; "
               f"the kernel stream replays the engine's logits to {replay:.3g}; the bulk "
               f"stream's own router first parts: {where(first['bulk'])}; the exact stream's: "
               f"{where(first['exact'])}")
    s_kb = first["bulk"]["step"] if first["bulk"] else None
    return {"s_kb": s_kb, "tol": tol, "logits_b": logits["bulk"], "summary": summary,
            "h_moe": h_moe}


def routed_flips(reqs_k, reqs_b, tf, vocab) -> tuple[int, list[str]]:
    """Kernel and bulk mode's streams of one drain (request i in slot i) may
    part only where the routes parted first (``tf["s_kb"]``, the step where
    bulk mode's own router first chose other experts) or at a near tie of
    bulk mode's teacher-forced logits (a top-2 gap of at most twice
    ``tf["tol"]``, each side within it).  Every token must lie in the
    vocabulary.  Returns the differing tokens' count and a note each."""
    differing, flips = 0, []
    for slot, (rk, rb) in enumerate(zip(reqs_k, reqs_b)):
        if not all(0 <= t < vocab for t in rk.tokens + rb.tokens):
            raise AssertionError(f"request {rk.uid}: token out of range")
        diff = [t for t, (a, b) in enumerate(zip(rk.tokens, rb.tokens)) if a != b]
        differing += len(diff)
        if not diff:
            continue
        st = len(rk.prompt) - 1 + diff[0]            # the step that sampled it
        if tf["s_kb"] is not None and st >= tf["s_kb"]:
            flips.append(f"req {rk.uid} token {diff[0]} (step {st}): after the first route "
                         f"divergence")
            continue
        top = tf["logits_b"][st][slot, 0].topk(2).values
        gap = (top[0] - top[1]).item()
        flips.append(f"req {rk.uid} token {diff[0]} (step {st}): top-2 gap {gap:.3g}")
        if gap > 2 * tf["tol"]:
            raise AssertionError(f"token streams differ beyond a near tie: {flips[-1]} "
                                 f"(allowed {2 * tf['tol']:.3g})")
    return differing, flips


def profile_decode(decode, params, cache, inputs) -> str:
    """Device time of a few decode steps by kernel (see :func:`profile_device`)."""
    decode(params, inputs[0][0], cache, inputs[0][1])       # warm
    return profile_device(lambda i: decode(params, inputs[i][0], cache, inputs[i][1]),
                          len(inputs), "step")


def profile_device(run, n, unit) -> str:
    """Device time of ``run(0) .. run(n - 1)`` by kernel, from torch.profiler:
    the device's busy share of the host-clock window and the top kernels,
    per ``unit`` (one call of ``run``).  The profiler records CUDA activity
    only: the host's operator events add nothing to the device ops and time
    and cost seconds a profile to record and process
    (``scripts/profile_cost.py`` measures both settings), and they slow the
    host window."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    if not by_name:
        return f"profiler recorded no device time (host {wall_ms / n:.2f} ms/{unit})"
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return (f"host {wall_ms / n:.2f} ms/{unit}, device busy {busy / n:.2f} ms/{unit} "
            f"({100 * busy / wall_ms:.1f}%), {launches / n:.0f} device ops/{unit}; top: "
            + ", ".join(f"{name[:60]} {ms / n:.3f} ms" for name, ms in top))


# ---------------------------------------------------------------------------
# phases 28-29: chatglm3-6b decode over a tensor-parallel world on one card
# ---------------------------------------------------------------------------
def tp_phases(card) -> None:
    """Phase 29: teacher-forced logits of a spawned tp = 4 world against
    phase 5's exact f32 evaluation, and the FFN down product over the
    world.  Needs phase 5's run (``GLM_DECODE``).  (Phase 28's launcher run
    at tp = 4 was cut for phases 44-48's time: phase 31 runs the same
    launcher at tp = 4 in fused mode, with auto knobs, under the same
    gates.)"""
    # the tp = 2 world (granularity 2) and the oblivious and bf16-wire
    # settings were cut for phases 44-48's time (tests/test_torch_tp.py
    # holds them on the CPU)
    settings = [("bulk", dict(mode="bulk")), ("fused", dict(mode="fused")),
                ("fused skew 1", dict(mode="fused", skew=1)),
                ("fused fp8 wire", dict(mode="fused", wire="fp8"))]
    for tp, sets in ((TP_WORLD, settings),):
        res = spawn_world(tp, sets)
        err_b = res["bulk"]["err"]
        bound = LOGITS_TOL_FACTOR * err_b
        bounds = {name: FP8_WIRE_FACTOR * bound if "fp8" in name else bound
                  for name, _ in sets if name != "bulk"}
        for name, b in bounds.items():
            if not res[name]["err"] <= b:
                raise AssertionError(f"tp={tp} {name}: logits {res[name]['err']:.4g} from exact "
                                     f"f32 > bound {b:.4g}")
        if not res["skew_equal"]:
            raise AssertionError(f"tp={tp}: skew 1's logits are not bit-identical to skew 0's")
        # the oblivious schedule adds the same values in the same order
        same_bits = {n: res[n]["digest"] == res["fused"]["digest"]
                     for n in ("fused oblivious",) if n in res}
        if not all(same_bits.values()):
            raise AssertionError(f"tp={tp}: oblivious logits are not comm_aware's bits")
        for mode in ("fused", "bulk"):
            op = res[f"op {mode}"]
            if not op["ok"]:
                raise AssertionError(f"tp={tp} matmul_allreduce {mode}: {op['msg']}")
        q = 1 if tp == TP_WORLD else TP_PAIR_Q
        say(29, f"[{TP_LABEL.format(tp)}] spawned tp = {tp} world, granularity {q}, teacher-forced on phase 5's "
                f"first {TP_STEPS} of {len(GLM_DECODE['inputs'])} decode steps, max abs logits "
                f"error from exact f32 "
                f"(bound): bulk {err_b:.4g} (tp 1 bulk: {GLM_DECODE['err_bx']:.4g}); "
                + "; ".join(f"{n} {res[n]['err']:.4g} ({b:.4g})" for n, b in bounds.items())
                + f"; skew 1 bit-identical to skew 0: {res['skew_equal']}"
                + "".join(f", {n} bit-identical to comm_aware: {v}" for n, v in same_bits.items())
                + f"; ms/step "
                + ", ".join(f"{n} {res[n]['ms']:.2f}" for n, _ in sets)
                + f"; every rank's logits equal; matmul_allreduce [{MAIN_B},{MAIN_K}]@[{MAIN_K},"
                f"{MAIN_N}] bf16 row-sharded vs torch.matmul of the whole in f32 (bound "
                f"{TP_OP_TOL}), max abs/rel err, ms a call: "
                + ", ".join(f"{m} {res[f'op {m}']['err']:.3g}/{res[f'op {m}']['rel']:.3g} "
                            f"{res[f'op {m}']['ms']:.3f}" for m in ("fused", "bulk"))
                + f"; an all-reduce of [{MAIN_B},{MAIN_N}] bf16 (the bulk FFN's), ms a call: "
                f"from the card (staged) {res['ar card']:.3f}, from host memory "
                f"{res['ar host']:.3f}; the product alone {res['product']:.4f}")


def near_tie_notes(label, streams) -> list[str]:
    """Checks the served ``streams`` (uid -> tokens) against phase 5's
    kernel-mode streams: every request served, tokens in range, and a
    first difference only at a near tie of phase 5's logits (each side
    within logits_tol: a top-2 gap of at most twice it).  Returns a note per
    differing request."""
    streams5 = GLM_DECODE["streams"]
    if sorted(streams) != list(range(len(streams5))):
        raise AssertionError(f"{label}: served requests {sorted(streams)}")
    for uid, want in enumerate(streams5):
        got = streams[uid]
        if not all(0 <= t_ < GLM_DECODE["vocab"] for t_ in got) or len(got) != len(want):
            raise AssertionError(f"{label} req {uid}: stream {got}")
    chose = lambda u, i: GLM_DECODE["kernel_logits"][GLM_DECODE["prompts"][u] - 1 + i][u, 0]
    return [f"{label} {n_}" for n_ in near_tie_flips(
        [streams[u] for u in range(len(streams5))], streams5, chose, GLM_DECODE["logits_tol"])]


def launcher_world_run(mode, extra=(), tp=TP_WORLD, dp=1) -> dict:
    """The serve launcher at (dp, tp) (dp * tp of the pool's processes) on
    the one card through its entry point, with the flags ``extra`` added."""
    world = dp * tp
    argv = ["--tp", str(tp), "--dp", str(dp), "--backend", "gloo", "--fusion", mode,
            "--requests", "4", "--batch", "4", "--max-new", "8", *extra]
    run = pool_launchers([("serve", argv, world)])[0]
    out = run["out"]
    served = re.search(r"\(([\d.]+) tok/s, (\d+) steps, ([\d.]+) ms/step", out)
    if served is None or f"all {world} ranks' token streams equal: True" not in out:
        print(out[-4000:], file=sys.stderr)
        raise AssertionError(f"launcher at dp={dp}, tp={tp} {mode}: no drain reported")
    streams = {int(u): json.loads(t_) for u, t_ in
               re.findall(r"req (\d+): prompt .* -> (\[.*\])", out)}
    return {"tok_s": float(served[1]), "steps": int(served[2]), "ms_step": float(served[3]),
            "streams": streams, "wall": run["wall"], "out": out}


def launcher_rank(rank, module, argv, out):
    """A pool process as one rank of a launcher's world (phases 31, 43 and
    48): ``repro_torch.launch.<module>.main(argv)``, which joins its world
    through ``--coordinator`` (``launch/distributed.py``: a process that
    torch.distributed.run did not start), from what a fresh process holds
    (no autotune decision, degradation policy or wire-fault hook).  Puts
    the rank's standard output on ``out``."""
    import contextlib
    import importlib
    import io

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import autotune
    from repro_torch.core.collectives import set_wire_fault_hook
    from repro_torch.core.degrade import set_degradation_policy

    autotune.clear_cache()
    set_wire_fault_hook(None)
    set_degradation_policy(None)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            importlib.import_module(f"repro_torch.launch.{module}").main(argv)
    except (Exception, SystemExit):    # the caller shows the rank's output and traceback
        out.put((rank, "err", buf.getvalue()[-4000:] + traceback.format_exc()))
        return
    out.put((rank, "ok", buf.getvalue()))


def pool_launchers(jobs) -> list[dict]:
    """Each ``(module, argv, ranks)`` of ``jobs`` as a launcher world of its
    own on ``ranks`` of the pool's processes (started here if it is not
    running), all at once, sharing the card; each world joins through its
    own ``--coordinator`` port.  Returns each world's standard output (its
    ranks' in rank order) and the seconds to its last rank's end.  The
    launchers run in processes that hold torch and a CUDA context already:
    no process start (what phases 31, 43 and 48 paid with
    torch.distributed.run)."""
    import socket

    if not POOL:
        start_pool()
    if sum(n for *_, n in jobs) > POOL_SIZE:
        raise ValueError(f"{jobs}: more ranks than the pool's {POOL_SIZE} processes")
    owner, first = {}, 0
    t0 = time.perf_counter()
    for j, (module, argv, n) in enumerate(jobs):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        for r in range(n):
            join = ["--coordinator", f"localhost:{port}", "--num-processes", str(n),
                    "--process-id", str(r)]
            POOL["tasks"][first + r].put((launcher_rank, (module, list(argv) + join)))
            owner[first + r] = (j, r)
        first += n
    texts, ends, idle = [dict() for _ in jobs], [0.0] * len(jobs), set()
    while len(idle) < first:
        prank, status, value = POOL["out"].get(timeout=600)
        if status == "idle":
            idle.add(prank)
            continue
        j, r = owner[prank]
        if status != "ok":
            raise AssertionError(f"the {jobs[j][0]} launcher {jobs[j][1]}, rank {r}:\n{value}")
        texts[j][r] = value
        ends[j] = time.perf_counter() - t0
    return [{"out": "".join(t_[r] for r in sorted(t_)), "wall": ends[j]}
            for j, t_ in enumerate(texts)]


# The rank processes of the spawned worlds (phases 29, 36-47 and 50) and of
# the launchers' worlds (phases 31, 43 and 48): started
# once and handed one world after another, so that a world pays no process
# start, torch import, CUDA context, kernel-library load or exit of its own
# (by difference, tens of seconds of each world on one H100 80GB HBM3 when
# each world spawned its own: phases 39 and 47 took 65.1 and 91.0 s so, and
# 10.5 and 35.3 s through the pool).  Between worlds a rank returns its
# cached device and pinned host memory.
POOL: dict = {}
POOL_SIZE = 4


def pool_rank(rank, tasks, out):
    """A rank process of the pool: runs each ``(target, args)`` handed to
    it on ``tasks`` (the target puts its own result on ``out``), then frees
    its caches and says so on ``out``; ends on ``None``."""
    import gc

    while True:
        job = tasks.get()
        if job is None:
            return
        target, args = job
        target(rank, *args, out)
        gc.collect()
        torch.cuda.empty_cache()
        host_empty = getattr(torch._C, "_host_emptyCache", None)
        if host_empty is not None and torch.cuda.is_initialized():
            host_empty()
        out.put((rank, "idle", None))


def start_pool() -> None:
    import torch.multiprocessing as mp

    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    spawn = mp.get_context("spawn")
    POOL.update(out=spawn.Queue(), tasks=[spawn.Queue() for _ in range(POOL_SIZE)])
    POOL["procs"] = [spawn.Process(target=pool_rank, args=(r, POOL["tasks"][r], POOL["out"]),
                                   daemon=True) for r in range(POOL_SIZE)]
    for p_ in POOL["procs"]:
        p_.start()


def stop_pool() -> None:
    """End the pool's processes (their CUDA contexts with them)."""
    if not POOL:
        return
    for q_ in POOL["tasks"]:
        q_.put(None)
    for p_ in POOL["procs"]:
        p_.join(timeout=60)
        if p_.is_alive():
            p_.kill()
            p_.join()
    POOL.clear()


def spawn_world(tp, settings, target=None, args=None) -> dict:
    """Run ``target(rank, tp, init, settings, *args, out)`` (by default
    ``tp_world_rank`` on phase 5's inputs) on ``tp`` of the pool's processes
    (started here if it is not running), sharing the card; rank 0's
    results, and every rank's under "ranks", after checking that every
    rank's logits are rank 0's."""
    import tempfile

    if not POOL:
        start_pool()
    out = POOL["out"]
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as rdv:
        if target is None:
            target = tp_world_rank
            args = (GLM_DECODE["inputs"][:TP_STEPS], GLM_DECODE["exact"][:TP_STEPS])
        for r in range(tp):
            POOL["tasks"][r].put((target, (tp, f"file://{rdv}/rdv", settings, *args)))
        got, idle = {}, set()
        # every rank's result, then every rank done with the world (its
        # process group closed, so the rendezvous file can go)
        while len(got) < tp or len(idle) < tp:
            rank, status, value = out.get(timeout=600)
            if status == "idle":
                idle.add(rank)
            elif status != "ok":
                raise AssertionError(f"tp={tp} world, rank {rank}:\n{value}")
            else:
                got[rank] = value
    for name, _ in settings:
        if len({got[r][name]["digest"] for r in range(tp)}) != 1:
            raise AssertionError(f"tp={tp} {name}: the ranks' logits differ")
        if not got[0][name]["finite"]:
            raise AssertionError(f"tp={tp} {name}: logits non-finite or misshapen")
    return {**got[0], "ranks": [got[r] for r in range(tp)]}


def tp_world_rank(rank, tp, init, settings, inputs, exact, out):
    """One rank of phase 29's world: this rank's shards of the seed-0 weights,
    each setting's teacher-forced decode on phase 5's inputs, and the FFN
    down product over the world."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.matmul_allreduce import matmul_allreduce
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        ctx = lambda **kw: ParallelContext(device=dev, tp=tp, fusion=FusionConfig(**kw))
        bundle = get_arch("chatglm3-6b")
        params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), ctx(mode="bulk"))
        res, kept = {}, {}
        for name, kw in settings:
            dec = bundle.decode_fn(ctx(**kw))
            cache = bundle.init_cache(inputs[0][0].shape[0], dev, tp)
            logits = []
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for tok, pos in inputs:
                lg, cache = dec(params, tok.to(dev), cache, pos.to(dev))
                logits.append(lg)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) / len(inputs) * 1e3
            res[name] = {
                "ms": ms, "err": max((g - e.to(dev)).abs().max().item()
                                     for g, e in zip(logits, exact)),
                "finite": all(g.shape == e.shape and torch.isfinite(g).all().item()
                              for g, e in zip(logits, exact)),
                "digest": hashlib.sha256(b"".join(g.cpu().numpy().tobytes()
                                                  for g in logits)).hexdigest()}
            if name in ("fused", "fused skew 1"):
                kept[name] = logits
            del cache, logits
        res["skew_equal"] = all(torch.equal(a, b) for a, b in
                                zip(kept["fused"], kept["fused skew 1"]))
        del kept, params
        g = torch.Generator(device=dev).manual_seed(5)
        x = torch.randn(MAIN_B, MAIN_K, generator=g, device=dev).bfloat16()
        w = (torch.randn(MAIN_K, MAIN_N, generator=g, device=dev) * MAIN_K ** -0.5).bfloat16()
        k = MAIN_K // tp
        xl, wl = x[:, rank * k:(rank + 1) * k].contiguous(), w[rank * k:(rank + 1) * k]
        want = x.float() @ w.float()
        for mode in ("fused", "bulk"):
            c = ctx(mode=mode)
            y = matmul_allreduce(c, xl, wl)
            try:
                check_close(f"matmul_allreduce {mode}", y, want, TP_OP_TOL)
                ok, msg = True, ""
            except AssertionError as e:
                ok, msg = False, str(e)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(20):
                matmul_allreduce(c, xl, wl)
            torch.cuda.synchronize(dev)
            e_abs, e_rel = errors(y, want)
            res[f"op {mode}"] = {"ok": ok, "msg": msg, "err": e_abs, "rel": e_rel,
                                 "ms": (time.perf_counter() - t0) / 20 * 1e3}
        # where a staged collective's time goes: the same all-reduce from the
        # card and from host memory, and the local product alone
        from repro_torch.core.collectives import all_reduce
        c = ctx(mode="bulk")
        y_card = torch.zeros(MAIN_B, MAIN_N, dtype=torch.bfloat16, device=dev)
        y_host = y_card.cpu()
        for name, fn in (("ar card", lambda: all_reduce(c, y_card)),
                         ("ar host", lambda: all_reduce(c, y_host)),
                         ("product", lambda: xl @ wl)):
            fn()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize(dev)
            res[name] = (time.perf_counter() - t0) / 20 * 1e3
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


# ---------------------------------------------------------------------------
# phases 30-31: the overlap autotuner, calibration and graceful degradation
# ---------------------------------------------------------------------------
# the FFN down's degradation key at decode: x [B, 1, F] @ w [F, D]
FFN_DOWN_KEY = ("matmul_allreduce", (MAIN_B, 1, MAIN_K, MAIN_N))
AUTO_LABEL = "one card, {} processes, wire staged through host: not NVLink"
RESOLVE_CALLS = 20000


def autotune_phases(card) -> None:
    """Phase 30 (tp = 1, kernel mode: the launcher with 'auto' granularity
    and wire, the FFN down's key quarantined and released, a cache-hit
    resolve's host time; phase 31, the launcher at tp = 4 with --calibrate,
    is :func:`autotune_world_phase`).  Needs phase 5 (``GLM_DECODE``)."""
    import io

    from repro_torch.configs.registry import get_arch
    from repro_torch.core import autotune
    from repro_torch.core.degrade import DegradationPolicy, set_degradation_policy
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_path
    from repro_torch.launch import serve as launch_serve
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    # 30 (a) ----------------------------------------------------------
    bundle = get_arch("chatglm3-6b")
    n_layers = bundle.config.n_layers
    path = fused_path(torch.bfloat16, MAIN_B, MAIN_K, MAIN_N)
    autotune.clear_cache()
    text = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(text):
        finished = launch_serve.main(["--fusion", "kernel", "--granularity", "auto", "--wire",
                                      "auto", "--requests", "4", "--batch", "4",
                                      "--max-new", "8"])
    torch.cuda.synchronize()
    launches = launch_counts()
    out = text.getvalue()
    print(out, file=sys.stderr)
    served = re.search(r"\(([\d.]+) tok/s, (\d+) steps, ([\d.]+) ms/step", out)
    steps = int(served[2])
    decisions = re.findall(r"decision: (.*)", out)
    fused_n = launches["fused_matmul_allreduce"]
    if (fused_n != n_layers * steps or launches[f"fused_matmul_allreduce.{path}"] != fused_n
            or len(decisions) != 1):
        raise AssertionError(f"auto launcher: {fused_n} fused launches in {steps} steps "
                             f"({launches}), decisions {decisions}")
    streams = {r.uid: list(r.tokens) for r in finished}
    notes = near_tie_notes("tp=1 auto", streams)
    same5 = [streams[u] for u in range(len(streams))] == GLM_DECODE["streams"]

    # 30 (b), (c) -----------------------------------------------------
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    ctx = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel", granularity="auto",
                                                             wire="auto"))
    decode = bundle.decode_fn(ctx)
    inputs, exact = GLM_DECODE["inputs"], GLM_DECODE["exact"]

    def forced():
        cache = bundle.init_cache(MAIN_B, "cuda")
        logits = []
        for tok, pos in inputs:
            lg, cache = decode(params, tok.cuda(), cache, pos.cuda())
            logits.append(lg)
        return logits

    def exact_err(logits):
        return max((g.float() - e.cuda()).abs().max().item() for g, e in zip(logits, exact))

    tol = GLM_DECODE["logits_tol"]
    pol = DegradationPolicy()
    prev = set_degradation_policy(pol)
    try:
        strikes = 0
        while not pol.quarantined(*FFN_DOWN_KEY):
            pol.record_failure(FFN_DOWN_KEY)
            strikes += 1
        jailed = pol.summary()
        demoted, _ = counted_run(forced, {})           # no kernel launches at all
        demotions = pol.demotions
        err_demoted = exact_err(demoted)
        if demotions != n_layers * len(inputs) or not err_demoted <= tol:
            raise AssertionError(f"quarantined: {demotions} demotions in {len(inputs)} steps, "
                                 f"logits {err_demoted:.4g} from exact f32 (bound {tol:.4g})")
        released = [k for _ in range(pol.cfg.cooldown) for k in pol.record_healthy()]
        if released != [FFN_DOWN_KEY] or pol.quarantined_keys():
            raise AssertionError(f"released {released}, still jailed {pol.quarantined_keys()}")
        back, counts = counted_run(forced, {"fused_matmul_allreduce": n_layers * len(inputs)})
        err_back = exact_err(back)
        if pol.demotions != demotions or not err_back <= tol:
            raise AssertionError(f"released: {pol.demotions} demotions, logits {err_back:.4g}")
        same_bits = all(torch.equal(a.cpu(), b) for a, b in zip(back, GLM_DECODE["kernel_logits"]))
    finally:
        set_degradation_policy(prev)
    del params, demoted, back

    # 30 (d) ----------------------------------------------------------
    pick = lambda fq, wr: autotune.tune_matmul_allreduce(
        MAIN_B, MAIN_K, MAIN_N, dtype_bytes=2, n_dev=1, chunk_dim=MAIN_B, hw=ctx.hw, wire=wr,
        fixed_q=fq, allow_fp8=False)
    resolve = lambda: autotune.resolve_overlap(None, "auto", None, "auto", pick, dim=MAIN_B,
                                               ring=1)
    keyed = lambda: autotune._choose_keyed(
        "matmul_allreduce", shape=(MAIN_B, MAIN_K, MAIN_N), dtype_bytes=2, n_dev=1,
        flops=2.0 * MAIN_B * MAIN_K * MAIN_N, hbm_bytes=float(MAIN_K * MAIN_N * 2),
        wire_bytes=float(MAIN_B * MAIN_N * 2 * 2), divisor_of=MAIN_B, divisor_ring=None,
        max_q=autotune.MAX_CHUNKS_PER_RANK, hw=ctx.hw, axis=None, skew=0, wire="auto",
        fixed_q=None, allow_fp8=False)
    if resolve() != keyed():
        raise AssertionError(f"the memo's decision {resolve()} is not the cache's {keyed()}")
    us = {}
    for name, fn in (("resolve_overlap (memo hit)", resolve), ("TuneKey hit", keyed)):
        t0 = time.perf_counter()
        for _ in range(RESOLVE_CALLS):
            fn()
        us[name] = (time.perf_counter() - t0) / RESOLVE_CALLS * 1e6
    say(30, f"chatglm3-6b full width, tp = 1, kernel mode: (a) launch.serve.main(--fusion kernel "
            f"--granularity auto --wire auto), 4 requests x 8 tokens at batch 4: decisions "
            f"{decisions} (link class H100 NVLink, provisional), {steps} steps, "
            f"{served[3]} ms/step, fused kernel launches {fused_n} (= {n_layers} x {steps}, "
            f"{path} path); streams = phase 5's kernel-mode streams: {same5}"
            + (f" ({'; '.join(notes)})" if notes else "")
            + f"; (b) {FFN_DOWN_KEY} quarantined after {strikes} record_failure calls "
            f"({jailed['quarantined']}), phase 5's {len(inputs)} teacher-forced steps: fused "
            f"kernel launches 0, demotions {demotions} (= {n_layers} x {len(inputs)}), logits "
            f"{err_demoted:.4g} from exact f32 (bound {tol:.4g}, bulk mode's {GLM_DECODE['err_bx']:.4g}); "
            f"(c) released after {pol.cfg.cooldown} record_healthy calls: launches "
            f"{counts['fused_matmul_allreduce']} (= {n_layers} x {len(inputs)}), logits "
            f"{err_back:.4g} from exact f32, bit-identical to phase 5's kernel logits: {same_bits}; "
            f"(d) host us a cache-hit call on {card}: "
            + ", ".join(f"{n_} {v:.3f}" for n_, v in us.items()))


def autotune_world_phase(card) -> None:
    """Phase 31: the serve launcher at tp = 4 in the pool's processes with
    --calibrate and a tune cache.  Needs phase 5 (``GLM_DECODE``)."""
    import tempfile

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        cache = f"{tmp}/tune.json"
        extra = ["--granularity", "auto", "--wire", "auto", "--calibrate", "--tune-cache", cache]
        runs = [launcher_world_run("fused", extra)]
        with open(cache) as f:
            entries = json.load(f)["entries"]
    from repro_torch.core.perfmodel import GLOO_HOST
    if [e["key"]["hw"] for e in entries] != [dataclasses.asdict(GLOO_HOST)] * len(entries):
        raise AssertionError(f"tune cache keys not under the gloo class: {entries}")
    summary = []
    for i, r in enumerate(runs):
        out = r["out"]
        per_rank = {k: sorted(re.findall(rf"calibrate \[rank {k}\]: (.*)", out))
                    for k in range(TP_WORLD)}
        if any(per_rank[k] != per_rank[0] for k in per_rank) or not per_rank[0]:
            raise AssertionError(f"run {i}: the ranks' calibration differs: {per_rank}")
        if f"all {TP_WORLD} ranks' autotune decisions equal: True" not in out:
            raise AssertionError(f"run {i}: decisions not checked equal")
        swept = re.search(r"calibrate \[rank 0\]: (\d+)/(\d+) newly traced", out)
        if not (int(swept[2]) >= 1 and swept[1] == swept[2]):
            raise AssertionError(f"run {i}: swept {swept[0]}")
        r["notes"] = near_tie_notes(f"tp={TP_WORLD} auto run {i}", r["streams"])
        r["decisions"] = re.findall(r"decision: (.*)", out)
        summary.append((swept[0].split(": ")[1], [ln for ln in per_rank[0] if "->" in ln]))
    say(31, f"[{AUTO_LABEL.format(TP_WORLD)}] launch.serve.main(--coordinator ... "
            f"--num-processes {TP_WORLD}) in {TP_WORLD} of the pool's processes, --tp {TP_WORLD} "
            f"--backend gloo --fusion fused "
            f"--granularity auto --wire auto --calibrate --tune-cache, full-width chatglm3-6b: "
            f"(a) {summary[0][0]}, every rank's calibration equal; "
            + "; ".join(summary[0][1]) + f"; decisions {runs[0]['decisions']} (link class gloo "
            f"host-staged, provisional; {len(entries)} cache entries under it); {runs[0]['ms_step']:.2f} "
            f"ms/step, {runs[0]['wall']:.1f} s with init and calibration (the pool's processes: "
            f"no process start); streams = phase "
            f"5's: {[runs[0]['streams'][u] for u in sorted(runs[0]['streams'])] == GLM_DECODE['streams']}"
            + (f" ({'; '.join(runs[0]['notes'])})" if runs[0]["notes"] else ""))


# ---------------------------------------------------------------------------
# phases 32-34: gemma2-27b serving, the flash kernel's window and softcap
# ---------------------------------------------------------------------------
def plain_by_heads(q, k, v, heads=4, **kw):
    """flash_attention_plain over groups of about ``heads`` query heads (and
    their kv heads), so that one call's scores are [B * heads, S, S] f32
    (at 8192 keys, 32 heads at once would hold 8.6 GB a temporary); with
    ``stats=True`` also m and l, [B, Hq, S] each."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain

    g = q.shape[2] // k.shape[2]
    heads = max(1, heads // g) * g
    parts = [flash_attention_plain(q[:, :, h:h + heads], k[:, :, h // g:(h + heads) // g],
                                   v[:, :, h // g:(h + heads) // g], **kw)
             for h in range(0, q.shape[2], heads)]
    if not kw.get("stats"):
        return torch.cat(parts, dim=2)
    return tuple(torch.cat([p_[i] for p_ in parts], dim=2 if i == 0 else 1) for i in range(3))


def flex_time(q, k, v, *, scale, causal, window, cap, want, iters) -> tuple:
    """The library column of a windowed, capped flash call:
    torch.nn.attention.flex_attention under torch.compile, a score_mod for
    the cap and a block_mask for the mask, held to ``want`` at BF16_TOL.
    Returns (ms or None, a note: its compile time, or why there is none)."""
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    except ImportError as e:
        return None, f"none: torch {torch.__version__} has no flex_attention ({e})"
    s = q.shape[1]

    def mask_mod(b, h, qi, ki):
        keep = (ki <= qi) if causal else (ki >= 0)
        return keep & (qi - ki < window) if window else keep

    score_mod = (lambda sc, b, h, qi, ki: cap * torch.tanh(sc / cap)) if cap else None
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    try:
        t0 = time.perf_counter()
        block_mask = create_block_mask(mask_mod, None, None, s, s, device=q.device)
        fn = torch.compile(flex_attention)
        run = lambda: fn(qt, kt, vt, score_mod=score_mod, block_mask=block_mask, scale=scale,
                         enable_gqa=True)
        got = run().transpose(1, 2)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
    except Exception as e:   # noqa: BLE001 (a yardstick only: say why there is none)
        return None, f"none: flex_attention did not compile here ({type(e).__name__}: " \
                     f"{str(e).splitlines()[0][:160] if str(e) else ''})"
    err = check_close("flex_attention", got, want, BF16_TOL)
    return time_ms(run, iters=iters, warmup=1), (f"flex_attention compiled in {compile_s:.1f} s, "
                                                 f"max abs err vs plain {err[0]:.3g}")


def flash_window_phase(card, gen) -> dict:
    """Phase 32: the flash kernel with gemma2's sliding window and softcap
    against its plain version, on both paths; its statistics and its
    gradient with both; times with and without each beside their bounds and
    flex_attention.  Returns the flash row's window/cap numbers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_path
    from repro_torch.models.attention import span_attention

    bf16, f32 = torch.bfloat16, torch.float32
    cfg = get_arch("gemma2-27b").config
    hq, hkv, hd, win, cap = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.window, cfg.attn_softcap
    scale = cfg.query_scale
    qs = FLASH_Q_SCALE
    inputs = lambda b, s, h, g_kv, d, dt, q_scale: (
        randn(gen, (b, s, h, d), dt, q_scale), randn(gen, (b, s, g_kv, d), dt),
        randn(gen, (b, s, g_kv, d), dt))
    # (a) each shape on the path flash_path chooses, bf16 d = 128 also on
    # the CUDA-core path: gemma2's shape with both, either and ragged edges
    errs, cap_txt = {}, ""
    for name, b, s, h, g_kv, d, dt, causal, w, c, q_scale in (
            ("window+cap", 1, GEMMA_S, hq, hkv, hd, bf16, True, win, cap, qs),
            ("window", 1, GEMMA_S, hq, hkv, hd, bf16, True, win, None, qs),
            ("cap", 1, GEMMA_S, hq, hkv, hd, bf16, True, None, cap, qs),
            ("window 1000 S=3001", 1, 3001, hq, hkv, hd, bf16, True, 1000, cap, qs),
            ("window 1000 S=3001 non-causal", 1, 3001, hq, hkv, hd, bf16, False, 1000, cap, qs),
            ("hd=64 window 300 cap 5", 2, 1000, 8, 2, 64, bf16, True, 300, 5.0, 3.0),
            ("f32 hd=64 window 300 cap 5", 2, 1000, 4, 2, 64, f32, True, 300, 5.0, 3.0),
            ("f32 hd=128 window 300 cap 5", 2, 1000, 4, 2, 128, f32, True, 300, 5.0, 3.0)):
        q, k, v = inputs(b, s, h, g_kv, d, dt, q_scale)
        kw = dict(scale=scale if h == hq else d ** -0.5, causal=causal, window=w, softcap=c)
        want = plain_by_heads(q, k, v, **kw)
        tol = BF16_TOL if dt == bf16 else F32_TOL
        chosen = flash_path(dt, d)
        got, took = on_path(flash_attention, lambda: flash_attention(q, k, v, **kw))
        if took != chosen:
            raise AssertionError(f"flash {name}: took the {took} path, flash_path says {chosen}")
        errs[name] = {took: check_close(f"flash {name} ({took} path)", got, want, tol)}
        if chosen == "tile":
            errs[name]["cuda_core"] = check_close(
                f"flash {name} (cuda_core path)",
                flash_attention(q, k, v, _path="cuda_core", **kw), want, tol)
        if name == "window+cap":
            # the cap at work: one head's scores before it
            sc = (q[0, :, 0].float() @ k[0, :, 0].float().T) * kw["scale"]
            cap_txt = (f"head 0's {sc.numel() / 1e6:.1f} M scores before the cap: max |s| "
                       f"{sc.abs().max().item():.1f} = {sc.abs().max().item() / c:.2f} x the cap, "
                       f"{100 * (sc.abs() > c / 2).float().mean().item():.1f}% with |s| > cap / 2")
            del sc
        del q, k, v, want, got
    say(32, f"(a) flash_attention with a window and/or softcap vs plain (bound: bf16 {BF16_TOL}, "
            f"f32 {F32_TOL}), max abs/rel err per path (the first is flash_path's choice; gemma2: "
            f"[1,{GEMMA_S},{hq}/{hkv},{hd}] bf16, scale 144^-0.5, window {win}, cap {cap}, q x "
            f"{qs}): " + "; ".join(
                f"{n_} " + ", ".join(f"{p_} {e[0]:.3g}/{e[1]:.3g}" for p_, e in pe.items())
                for n_, pe in errs.items()) + f"; {cap_txt}")

    # (b) the statistics (direct launches: comparisons, not the main path's)
    # and the gradient, each against an exact evaluation.  The gradient's
    # scores stay small (a cap of 2 on scores of spread 1, which it bends at
    # the tails): the analytic backward recomputes them in the inputs'
    # dtype, as the reference's does, and at gemma2's spread of 19 bf16's
    # rounding of a score (0.06 at 20) would move each probability by 6 %
    lines = []
    for name, b, s, h, g_kv, d, dt, w, c, q_scale, path in (
            ("bf16", 1, 2048, 8, 4, 128, bf16, 1000, cap, qs, "tile"),
            ("f32", 2, 1000, 4, 2, 64, f32, 300, 5.0, 3.0, "cuda_core")):
        q, k, v = inputs(b, s, h, g_kv, d, dt, q_scale)
        sc = d ** -0.5
        (_, m_k, l_k), took = flash_ops._launch(q, k, v, sc, True, w, c, None, True)
        if took != path:
            raise AssertionError(f"flash stats {name}: took the {took} path, expected {path}")
        _, m_p, l_p = plain_by_heads(q, k, v, scale=sc, causal=True, window=w, softcap=c,
                                     stats=True)
        err_m = check_close(f"flash {name} m (window {w}, cap {c})", m_k, m_p, F32_TOL)
        err_l = check_close(f"flash {name} l (window {w}, cap {c})", l_k, l_p, F32_TOL)
        del m_k, l_k, m_p, l_p
        lines.append(f"statistics {name} [{b},{s},{h}/{g_kv},{d}] window {w} cap {c} on the "
                     f"{took} path: m err {err_m[0]:.3g}, l err {err_l[0]:.3g} (bound {F32_TOL})")
    for name, b, s, h, g_kv, d, dt, w, c, q_scale in (
            ("bf16", 1, 1000, 8, 4, 128, bf16, 300, 2.0, 1.0),
            ("f32", 2, 515, 6, 3, 128, f32, 100, 2.0, 1.0)):
        q, k, v = inputs(b, s, h, g_kv, d, dt, q_scale)
        do = randn(gen, (b, s, h, d), dt)
        sc = d ** -0.5
        leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
        g_k = grads_of(lambda *a: flash_attention(*a, scale=sc, window=w, softcap=c), leaves, do)
        g_b = grads_of(lambda *a: span_attention(*a, causal=True, window=w, scale=sc, cap=c),
                       leaves, do)
        wide = torch.float64 if dt == f32 else f32
        exact = [a.detach().to(wide).requires_grad_(True) for a in (q, k, v)]
        g_x = grads_of(lambda *a: dense_attention(*a, sc, window=w, cap=c), exact, do.to(wide))
        dists = []
        for gname, gk, gb, gx in zip(("dq", "dk", "dv"), g_k, g_b, g_x):
            dk_, db_ = errors(gk, gx)[0], errors(gb, gx)[0]
            if not (torch.isfinite(gk.float()).all() and dk_ <= LOGITS_TOL_FACTOR * db_):
                raise AssertionError(f"flash backward {name} {gname} (window {w}, cap {c}): "
                                     f"kernel mode {dk_:.3g} from exact, above "
                                     f"{LOGITS_TOL_FACTOR} x bulk mode's {db_:.3g}")
            dists.append(f"{gname} {dk_:.3g}/{db_:.3g}")
        lines.append(f"gradient {name} [{b},{s},{h}/{g_kv},{d}] window {w} cap {c} (the op's "
                     f"forward on the {flash_path(dt, d)} path, its analytic backward) vs bulk "
                     f"mode's autograd through span_attention, max abs err from exact "
                     f"{'f64' if dt == f32 else 'f32'} kernel/bulk (bound {LOGITS_TOL_FACTOR} x "
                     f"bulk's): " + ", ".join(dists))
        del q, k, v, do, leaves, exact, g_k, g_b, g_x
    say(32, "(b) " + "; ".join(lines))

    # (d) times (CUDA events): the cap at the chatglm3 prefill's size, the
    # window at the reference's prefill_32k length, flex_attention beside
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain

    q, k, v = inputs(GLM_B, GLM_S, hq, hkv, hd, bf16, qs)
    runs = {"causal": lambda: flash_attention(q, k, v, scale=scale),
            "cap": lambda: flash_attention(q, k, v, scale=scale, softcap=cap)}
    t_short = {n_: [] for n_ in runs}
    for n_ in ("causal", "cap", "cap", "causal"):
        t_short[n_].append(time_ms(runs[n_], iters=20, warmup=2))
    b_short = flash_bound(GLM_B, GLM_S, hq, hkv, hd, 2)
    want = flash_attention_plain(q, k, v, scale=scale, softcap=cap)
    t_plain = time_ms(lambda: flash_attention_plain(q, k, v, scale=scale, softcap=cap), iters=2,
                      warmup=1)
    # the flex_attention yardsticks (32 s of compiles) were cut for phases
    # 44-48's time; PERF.md section 6 keeps their numbers
    flex_s, flex_s_txt = None, "not measured (cut)"
    del q, k, v, want
    q, k, v = inputs(1, FLASH_LONG_S, hq, hkv, hd, bf16, qs)
    kws = {"causal": {}, "window": {"window": win}, "window+cap": {"window": win, "softcap": cap}}
    t_long = {n_: [] for n_ in kws}
    for n_ in ("causal", "window", "window+cap", "window+cap", "window", "causal"):
        t_long[n_].append(time_ms(lambda: flash_attention(q, k, v, scale=scale, **kws[n_]),
                                  iters=3, warmup=1))
    b_long = {n_: flash_bound(1, FLASH_LONG_S, hq, hkv, hd, 2, window=kw_.get("window"))
              for n_, kw_ in kws.items()}
    want = flash_attention(q, k, v, scale=scale, window=win, softcap=cap)
    flex_l, flex_l_txt = None, "not measured (cut)"
    del q, k, v, want
    ms = lambda ts: ", ".join(f"{t_:.4f}" for t_ in ts)
    ratio = min(t_long["window"]) / min(t_long["causal"])
    say(32, f"(c) on {card}, tile path: [{GLM_B},{GLM_S},{hq}/{hkv},{hd}] bf16 causal without the "
            f"cap {ms(t_short['causal'])} ms, with cap {cap} {ms(t_short['cap'])} ms "
            f"({min(t_short['cap']) / min(t_short['causal']):.3f}x), bound {b_short[0]:.4f} ms "
            f"({b_short[1]}), plain (cap) {t_plain:.4f} ms, flex_attention (cap) "
            + (f"{flex_s:.4f} ms ({flex_s_txt})" if flex_s is not None else flex_s_txt)
            + f"; [1,{FLASH_LONG_S},{hq}/{hkv},{hd}] bf16: "
            + "; ".join(f"{n_} {ms(t_long[n_])} ms (bound {b_long[n_][0]:.4f} ms, "
                        f"{b_long[n_][1]}: {b_long[n_][3] / 1e9:.1f} GFLOP)" for n_ in kws)
            + f"; window {win} / causal {ratio:.3f} (the work: "
            f"{b_long['window'][3] / b_long['causal'][3]:.3f}); flex_attention (window + cap) "
            + (f"{flex_l:.4f} ms ({flex_l_txt})" if flex_l is not None else flex_l_txt))
    return {"window_cap": {
        "max_abs_err": errs["window+cap"]["tile"][0],
        "shape": f"[{GLM_B},{GLM_S},{hq}/{hkv},{hd}] bf16 causal",
        "ms": min(t_short["causal"]), "cap_ms": min(t_short["cap"]), "bound_ms": b_short[0],
        "plain_cap_ms": t_plain, "library_cap_ms": flex_s,
        "long_shape": f"[1,{FLASH_LONG_S},{hq}/{hkv},{hd}] bf16",
        "long_ms": {n_: min(t_) for n_, t_ in t_long.items()},
        "long_bound_ms": {n_: b_[0] for n_, b_ in b_long.items()},
        "long_library_ms": flex_l}}


def gemma2_phases(card, gen) -> tuple[dict, dict]:
    """Phases 33-34: full-width gemma2-27b (seed-0 weights) prefill of 1 x
    GEMMA_S tokens in kernel and bulk mode against an exact f32 evaluation,
    the hand-off to decode, then dense decode and paged serving at the
    launcher's traffic, and times.  Returns (the flash row's gemma2
    numbers, the fused row's)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    # 33 --------------------------------------------------------------
    bf16 = torch.bfloat16
    bundle = get_arch("gemma2-27b")
    cfg = bundle.config
    L, Hq, Hkv, hd, D, F = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model,
                            cfg.d_ff)
    S = GEMMA_S
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t_.numel() for t_ in _leaves(params))
    ctx = {m: ParallelContext(device="cuda", fusion=FusionConfig(mode=m))
           for m in ("kernel", "bulk")}
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = {**params, "layers": UpcastLayers(params["layers"])}
    pre = {m: bundle.prefill_fn(c) for m, c in ctx.items()}
    pre_x = exact.prefill_fn(ctx["bulk"])
    tokens = torch.randint(0, cfg.vocab, (1, S), generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    layer_errs, windows = [], []

    def spy(q, k, v, **kw):
        """The kernel, then its plain version on the identical input."""
        got = flash_attention(q, k, v, **kw)
        want = plain_by_heads(q, k, v, scale=kw["scale"], causal=kw["causal"],
                              window=kw["window"], softcap=kw["softcap"])
        layer_errs.append(check_close(f"gemma2 prefill layer {len(layer_errs)} flash", got, want,
                                      BF16_TOL)[0])
        windows.append((kw["window"], kw["softcap"]))
        return got

    # the hand-off: each mode's prefill cache in a decode cache of S +
    # GEMMA_STEPS positions, greedy steps from position S (the local layers'
    # window still masks: each sees its last 4096 positions); each cache
    # goes before the next run, so that the exact f32 run (about 22 GB
    # beside the weights, its own f32 cache among them) fits
    long_b = dataclasses.replace(bundle, config=dataclasses.replace(cfg, max_seq=S + GEMMA_STEPS))
    dec = {m: long_b.decode_fn(c) for m, c in ctx.items()}

    def greedy(mode, logits, c):
        if any(tuple(t_.shape) != (L, 1, S, Hkv, hd) for t_ in c.values()):
            raise AssertionError(f"gemma2 prefill cache shapes "
                                 f"{[tuple(t_.shape) for t_ in c.values()]}")
        dc = long_b.init_cache(1, "cuda")
        for key in dc:
            dc[key][:, :, :S] = c[key]
        c.clear()
        tok, out = logits.argmax(-1), []
        for i in range(GEMMA_STEPS):
            pos = torch.full((1,), S + i, dtype=torch.int32, device="cuda")
            lg, dc = dec[mode](params, tok, dc, pos)
            out.append((tok, lg))
            tok = lg.argmax(-1)
        return out

    with swapped(attention, "flash_attention", spy):
        (logits_k, cache_k), launch_k = counted_run(
            lambda: pre["kernel"](params, {"tokens": tokens}), flash_on_tile(L))
    peak_k = torch.cuda.max_memory_allocated() / 1e9
    dec_path = fused_path(bf16, 1, F, D)
    steps_k, launch_d = counted_run(lambda: greedy("kernel", logits_k, cache_k),
                                    {"fused_matmul_allreduce": L * GEMMA_STEPS,
                                     f"fused_matmul_allreduce.{dec_path}": L * GEMMA_STEPS})
    # bulk mode's one prefill, timed with CUDA events (a second, timed
    # alone, was cut for the script's time: it took 8.3 s)
    ev_b = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev_b[0].record()
    (logits_b, cache_b), launch_b = counted_run(lambda: pre["bulk"](params, {"tokens": tokens}),
                                                {})
    ev_b[1].record()
    torch.cuda.synchronize()
    bulk_ms = ev_b[0].elapsed_time(ev_b[1])
    steps_b = greedy("bulk", logits_b, cache_b)
    del cache_k, cache_b
    logits_x = pre_x(params_x, {"tokens": tokens})[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    local = [w for w, _ in windows if w is not None]
    if len(local) != L // 2 or set(local) != {cfg.window} or {c for _, c in windows} != {
            cfg.attn_softcap}:
        raise AssertionError(f"gemma2 prefill: flash windows and caps {windows}")
    for lg in (logits_k, logits_b, logits_x):
        if lg.shape != (1, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"gemma2 prefill logits: shape {tuple(lg.shape)} or non-finite")
    errs_k = bounded_errors("gemma2 prefill kernel mode", {"logits": (logits_k, logits_b,
                                                                      logits_x)})
    del logits_x
    say(33, f"gemma2-27b full width ({L}L d{D}, {Hq}/{Hkv} heads of {hd}, d_ff {F}, vocab "
            f"{cfg.vocab}, {n_params / 1e9:.3f}B params {cfg.param_dtype}, init {init_s:.1f}s), "
            f"prefill of 1x{S} seeded tokens: kernel mode flash launches "
            f"{launch_k['flash_attention']} (tile path {launch_k['flash_attention.tile']}, "
            f"CUDA-core path {launch_k['flash_attention.cuda_core']}), {len(local)} of them with "
            f"window {cfg.window}, all with softcap {cfg.attn_softcap}; fused GEMV "
            f"{launch_k['fused_matmul_allreduce']}; bulk mode (span_attention) flash "
            f"{launch_b['flash_attention']}; every layer's flash output vs plain on its input: "
            f"max abs err {max(layer_errs):.3g} over {len(layer_errs)} layers (bound {BF16_TOL}); "
            f"logits max abs err (kernel vs exact f32 / bulk vs exact f32 / kernel vs bulk; bound "
            f"{LOGITS_TOL_FACTOR} x bulk's): {errs_k}; peak {peak_k:.2f} GB through the "
            f"kernel-mode prefill, {peak_gb:.2f} GB through the exact f32 one")

    # times: kernel mode twice (bulk mode's is its checked prefill's), then
    # a profile of kernel mode
    pre_t = {"kernel": [], "bulk": [bulk_ms]}
    for m in ("kernel", "kernel"):
        pre_t[m].append(time_ms(lambda: pre[m](params, {"tokens": tokens}), iters=1, warmup=0))
    prof_pre = profile_device(lambda i: pre["kernel"](params, {"tokens": tokens}), 1, "prefill")
    # bound: the products of every layer's weights at S tokens at the bf16 peak
    layer_params = n_params - cfg.vocab * D
    pre_bound = 2 * layer_params * S / BF16_FLOPS * 1e3

    longer = {"tokens": torch.cat([tokens, steps_k[0][0]], dim=1)}
    logits_l = pre["kernel"](params, longer)[0]
    d_px = errors(logits_l, pre_x(params_x, longer)[0])[0]
    d_pd = errors(steps_k[0][1], logits_l)[0]
    tol = LOGITS_TOL_FACTOR * d_px
    if d_pd > tol:
        raise AssertionError(f"gemma2 hand-off: the first decode step's logits are {d_pd:.3g} "
                             f"from a prefill over {S + 1} tokens, above {LOGITS_TOL_FACTOR} x "
                             f"that prefill's distance {d_px:.3g} from exact f32")
    sk = [[int(t_) for t_, _ in steps_k]]
    sb = [[int(t_) for t_, _ in steps_b]]
    flips = near_tie_flips(sk, sb, lambda _, i: (logits_b if i == 0 else steps_b[i - 1][1])[0, 0],
                           tol)
    say(33, f"hand-off: {GEMMA_STEPS} greedy decode steps from position {S} in a "
            f"{S + GEMMA_STEPS}-position cache copied from the prefill's: launches fused GEMV "
            f"{launch_d['fused_matmul_allreduce']} (= {L} x {GEMMA_STEPS}, all on the {dec_path} "
            f"path), flash {launch_d['flash_attention']}; first step's logits vs a kernel-mode "
            f"prefill over {S + 1} tokens max abs err {d_pd:.3g} (bound {tol:.3g} = "
            f"{LOGITS_TOL_FACTOR} x that prefill's distance from exact f32, {d_px:.3g}); kernel "
            f"stream {sk[0]}; bulk stream {sb[0]}" + (f" ({'; '.join(flips)})" if flips else ""))
    del steps_k, steps_b, logits_l, logits_k, logits_b, dec
    torch.cuda.empty_cache()

    say(33, f"on {card}: prefill of 1x{S} per call (CUDA events; kernel mode twice, bulk "
            f"mode its checked prefill, after kernel mode's): "
            + "; ".join(f"{m} " + ", ".join(f"{t_:.1f}" for t_ in ts) + " ms"
                        for m, ts in pre_t.items())
            + f"; bound {pre_bound:.1f} ms (operations: 2 x {layer_params / 1e9:.2f} G layer "
            f"parameters x {S} tokens); kernel-mode profile: {prof_pre}")

    # 34 --------------------------------------------------------------
    # (a) dense decode through DecodeEngine at the launcher's traffic; the
    # teacher-forced bulk and exact f32 replays on a short cache (the
    # requests end before position GEMMA_TF_SEQ)
    B = PAGED_B
    dec_k, dec_b = (bundle.decode_fn(ctx[m]) for m in ("kernel", "bulk"))
    tf = dataclasses.replace(bundle, config=dataclasses.replace(cfg, max_seq=GEMMA_TF_SEQ))
    tf_x = dataclasses.replace(exact, config=dataclasses.replace(exact.config,
                                                                 max_seq=GEMMA_TF_SEQ))
    dec_tb, dec_tx = tf.decode_fn(ctx["bulk"]), tf_x.decode_fn(ctx["bulk"])

    def serve(decode, log=None):
        def step(tok, cache, pos):
            logits, cache = decode(params, tok, cache, pos)
            if log is not None:
                log.append((tok.clone(), pos.clone(), logits.clone()))
            return logits, cache
        return serve_requests(step, bundle, B, GEMMA_REQS, GEMMA_NEW)

    log_k = []
    reset_counts()
    reqs_k, _ = serve(dec_k, log_k)
    launches = launch_counts()
    steps = len(log_k)
    dpath = fused_path(bf16, B, F, D)
    if (launches["fused_matmul_allreduce"] != L * steps
            or launches[f"fused_matmul_allreduce.{dpath}"] != L * steps
            or launches["flash_attention"]):
        raise AssertionError(f"gemma2 decode: launches {launches} in {steps} steps of {L} layers")
    reqs_b, _ = serve(dec_b)
    if steps >= GEMMA_TF_SEQ:
        raise AssertionError(f"gemma2 decode: {steps} steps outrun the replay cache")
    cache_b, cache_x = tf.init_cache(B, "cuda"), tf_x.init_cache(B, "cuda")
    err_kb = err_bx = err_kx = 0.0
    logits_bt = []
    for tok, pos, lk in log_k:
        lb, cache_b = dec_tb(params, tok, cache_b, pos)
        lx, cache_x = dec_tx(params_x, tok, cache_x, pos)
        for t_ in (lk, lb, lx):
            if t_.shape != (B, 1, cfg.vocab) or not torch.isfinite(t_).all():
                raise AssertionError(f"gemma2 decode logits: shape {tuple(t_.shape)} or "
                                     f"non-finite")
        err_kb = max(err_kb, errors(lk, lb)[0])
        err_bx = max(err_bx, errors(lb, lx)[0])
        err_kx = max(err_kx, errors(lk, lx)[0])
        logits_bt.append(lb)
    del cache_b, cache_x
    logits_tol = LOGITS_TOL_FACTOR * err_bx
    if err_kb > logits_tol:
        raise AssertionError(f"gemma2 decode teacher-forced: kernel vs bulk {err_kb:.3g} > "
                             f"{LOGITS_TOL_FACTOR} x bulk vs exact f32 {err_bx:.3g}")
    if any(not 0 <= t_ < cfg.vocab or len(r.tokens) != GEMMA_NEW
           for r in reqs_k + reqs_b for t_ in r.tokens):
        raise AssertionError("gemma2 decode: streams of the wrong length or out of range")
    flips = near_tie_flips([r.tokens for r in reqs_k], [r.tokens for r in reqs_b],
                           lambda r, i: logits_bt[len(reqs_k[r].prompt) - 1 + i][r, 0],
                           logits_tol)
    say(34, f"(a) gemma2-27b dense decode (DecodeEngine, batch {B}, {GEMMA_REQS} requests x "
            f"{GEMMA_NEW} tokens, the launcher's seeded prompts): {steps} steps, fused kernel "
            f"launches {launches['fused_matmul_allreduce']} (= {L} x {steps}, all on the {dpath} "
            f"path), flash 0; teacher-forced logits max abs err: kernel vs bulk {err_kb:.3g} "
            f"(bound {logits_tol:.3g}), bulk vs exact f32 {err_bx:.3g}, kernel vs exact f32 "
            f"{err_kx:.3g}; kernel streams {[r.tokens for r in reqs_k]}; bulk streams "
            f"{[r.tokens for r in reqs_b]}" + (f" ({'; '.join(flips)})" if flips else ""))

    # (b) the launcher itself, --arch gemma2-27b --paged, in kernel and bulk
    # mode
    def launcher(mode, log, where):
        return recorded_launch(["--arch", "gemma2-27b", "--paged", "--fusion", mode,
                                "--requests", str(GEMMA_REQS), "--batch", str(B), "--max-new",
                                str(GEMMA_NEW), "--block-size", str(PAGED_BLOCK), "--chunk",
                                str(PAGED_CHUNK)], params, log, where)

    log_pk, log_pb, where = [], [], {}
    fin_k = launcher("kernel", log_pk, where)
    fin_b = launcher("bulk", log_pb, {})
    paths = check_step_launches(log_pk, "kernel", L, F, D)
    check_step_launches(log_pb, "bulk", L, F, D)
    nb = B * cfg.max_seq // 2 // PAGED_BLOCK           # the launcher's default pool
    serve_b, serve_x = bundle.serve_step_fn(ctx["bulk"]), exact.serve_step_fn(ctx["bulk"])
    got_k = [e["logits"] for e in log_pk]
    ref_b = replay(serve_b, params, log_pk, lambda: bundle.init_paged_pool(nb, PAGED_BLOCK, "cuda"))
    ref_x = replay(serve_x, params_x, log_pk,
                   lambda: exact.init_paged_pool(nb, PAGED_BLOCK, "cuda"))
    e_kb, e_bx, e_kx = (live_err(log_pk, a, b) for a, b in ((got_k, ref_b), (ref_b, ref_x),
                                                             (got_k, ref_x)))
    if not e_kb <= LOGITS_TOL_FACTOR * e_bx:
        raise AssertionError(f"gemma2 paged teacher-forced: kernel vs bulk {e_kb:.3g} > "
                             f"{LOGITS_TOL_FACTOR} x bulk vs exact f32 {e_bx:.3g}")
    sk = {r.uid: r.tokens for r in fin_k}
    sb = {r.uid: r.tokens for r in fin_b}
    if (sorted(sk) != list(range(GEMMA_REQS)) or sorted(sb) != sorted(sk)
            or any(len(v) != GEMMA_NEW for v in list(sk.values()) + list(sb.values()))
            or len(where) != GEMMA_REQS * GEMMA_NEW
            or any(int(log_pk[s_]["logits"][slot].argmax()) != sk[u][k]
                   for (u, k), (s_, slot) in where.items())):
        raise AssertionError(f"gemma2 paged: streams {sk} / {sb} are not the logged steps' "
                             f"greedy tokens")
    paged_flips = near_tie_flips([sk[u] for u in sorted(sk)], [sb[u] for u in sorted(sk)],
                                 lambda u, i: ref_b[where[(u, i)][0]][where[(u, i)][1]],
                                 LOGITS_TOL_FACTOR * e_bx)
    dense_same = [sk[u] for u in sorted(sk)] == [r.tokens for r in reqs_k]
    del ref_b, ref_x
    say(34, f"(b) the launcher, --arch gemma2-27b --paged (batch {B}, {GEMMA_REQS} requests x "
            f"{GEMMA_NEW} tokens, block {PAGED_BLOCK}, chunk {PAGED_CHUNK}, default pool {nb} "
            f"blocks): {len(log_pk)} steps by B x C rows and fused path {paths} ({L} launches a "
            f"step in kernel mode, 0 in bulk mode); teacher-forced logits (live rows) max abs "
            f"err: kernel vs bulk {e_kb:.3g} (bound {LOGITS_TOL_FACTOR * e_bx:.3g}), bulk vs "
            f"exact f32 {e_bx:.3g}, kernel vs exact f32 {e_kx:.3g}; kernel streams "
            f"{[sk[u] for u in sorted(sk)]}; bulk streams {[sb[u] for u in sorted(sb)]}"
            + (f" ({'; '.join(paged_flips)})" if paged_flips else "")
            + f"; kernel streams = (a)'s dense kernel streams: {dense_same}")

    # (c) times: decode and serve steps, profiles, the fused kernel at
    # decode's 4 rows and the paged chunk's 32
    decode_txt = timed_decode_runs(serve, dec_k, dec_b)
    prof_dec = profile_decode(dec_k, params, bundle.init_cache(B, "cuda"), log_k[:4])
    serve_k = bundle.serve_step_fn(ctx["kernel"])
    pool = bundle.init_paged_pool(nb, PAGED_BLOCK, "cuda")
    c1 = next(e for e in log_pk if e["in"][0].shape[1] == 1)
    c8 = next(e for e in log_pk if e["in"][0].shape[1] == PAGED_CHUNK)
    serves = {"kernel": serve_k, "bulk": serve_b}
    step_t = {}
    for name, e in (("C=1", c1), (f"C={PAGED_CHUNK}", c8)):
        step_t[name] = {"kernel": [], "bulk": []}
        for m in ("kernel", "bulk"):      # one turn each (turns cut for the script's time)
            step_t[name][m].append(time_ms(
                lambda: serves[m](params, e["in"][0], pool, *e["in"][1:]), iters=3, warmup=1))
    prof_srv = {f"C={PAGED_CHUNK}": profile_device(
        lambda i: serve_k(params, c8["in"][0], pool, *c8["in"][1:]), 3, "step")}
    del pool
    w = params["layers"][0]["ffn"]["w_down"]
    fused = {}
    for rows in (B, B * PAGED_CHUNK):
        x = randn(gen, (rows, F), bf16)
        got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, w))
        if took != fused_path(bf16, rows, F, D):
            raise AssertionError(f"fused [{rows},{F}]: took the {took} path")
        err = check_close(f"fused [{rows},{F}]@[{F},{D}] {took} path", got,
                          fused_matmul_allreduce_ref(x, w), BF16_TOL)
        t_k = [time_ms(lambda: fused_matmul_allreduce(x, w))]
        t_mm = time_ms(lambda: torch.matmul(x, w))
        t_k.append(time_ms(lambda: fused_matmul_allreduce(x, w)))
        bnd, by = bound_ms(rows, F, D, 2)
        fused[rows] = {"shape": f"[{rows},{F}]@[{F},{D}] bf16", "path": took,
                       "max_abs_err": err[0], "ms": min(t_k), "ms_turns": t_k,
                       "plain_ms": time_ms(lambda: fused_matmul_allreduce_ref(x, w), iters=10),
                       "bound_ms": bnd, "bound_by": by, "library_ms": t_mm}
    del x, got
    ms = lambda ts: ", ".join(f"{t_:.4f}" for t_ in ts)
    say(34, f"(c) on {card}: dense decode (host clock around the drain): {decode_txt}; profile "
            f"of kernel-mode decode: {prof_dec}; serve_step per step (CUDA events, kernel then "
            f"bulk): " + "; ".join(
                f"{name} " + ", ".join(f"{m} {ms(v)}" for m, v in d.items()) + " ms"
                for name, d in step_t.items())
            + "; kernel-mode profile: " + "; ".join(f"{n_} {p_}" for n_, p_ in prof_srv.items())
            + "; fused_matmul_allreduce (layer 0's w_down) vs plain, times in turns with "
            f"torch.matmul between: " + "; ".join(
                f"{v['shape']} {v['path']} path err {v['max_abs_err']:.3g}, {ms(v['ms_turns'])} "
                f"ms, torch.matmul {v['library_ms']:.4f} ms, plain {v['plain_ms']:.4f} ms, bound "
                f"{v['bound_ms']:.4f} ms ({v['bound_by']})" for v in fused.values()))
    del params, params_x, w
    torch.cuda.empty_cache()
    return ({"gemma2": {"launches": launch_k["flash_attention"], "windowed": len(local),
                        "max_abs_err": max(layer_errs), "prefill_ms": min(pre_t["kernel"]),
                        "prefill_bound_ms": pre_bound}},
            {"gemma2": {"launches": launches["fused_matmul_allreduce"],
                        "paged_launches": sum(e["launches"]["fused_matmul_allreduce"]
                                              for e in log_pk),
                        "decode": fused[B], "chunk_rows": fused[B * PAGED_CHUNK]}})


# ---------------------------------------------------------------------------
# phases 35-37: sequence-sharded prefill at tp > 1, the KV ring
# ---------------------------------------------------------------------------
# The hop of chatglm3-6b's KV ring at tp = 4 (each rank's 512 positions of
# phase 20's 4 x 2048 prompt) and of gemma2-27b's at tp = 4 and S = 8192
# (2048 positions a rank; its windowed layers stop at 2 of 3 hops)
RING_TP = 4
# gemma2-27b in phase 37 is cut to its first 4 layers (2 local, 2 global):
# 46 full-width layers on one card take 54.5 GB, and four processes would
# each draw every layer whole before keeping their shards
RING_GEMMA_LAYERS = 4
# phase 36's worlds: (tp, settings); skew 1 at 2 sub-chunks against skew 0
# (cut when phases 38-40 came, to keep the script under 900 s: fused mode's
# ring with one sub-chunk, whose code the sub-chunked ring runs, and the tp
# = 2 world, whose kernel-mode ring phase 38 runs at tp = 2)
RING_WORLDS = (
    (RING_TP, [("bulk", dict(mode="bulk")), ("kernel", dict(mode="kernel")),
               ("fused q2 bf16", dict(mode="fused", granularity=2, wire="bf16")),
               ("fused q2 bf16 skew 1", dict(mode="fused", granularity=2, wire="bf16",
                                             skew=1))]),)
# phase 36 prefills the first RING_B of phase 20's 4 rows (each setting's
# time is mostly its all-gathers through host memory, which grow with the
# rows; at all 4 the phase took 61.6 s of a 1052 s run on one H100 80GB HBM3)
RING_B = 1
GLM_PREFILL: dict = {}    # phase 20's run, which phase 36 is held to


def hop_bound(b, sq, sk, hq, hkv, d, itemsize, delta=0, causal=True, window=None):
    """Least time for one ring hop's flash call with its statistics, (ms,
    bound_by, bytes, operations): q, k and v read once, o, m and l written
    once, over HBM; or the two products over the (query, key) pairs this
    hop's mask keeps (counted from the mask at this ``delta``), at the
    inputs' peak."""
    i = torch.arange(sq)[:, None] + delta
    j = torch.arange(sk)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= i - j < window
    n_bytes = b * (2 * sq * hq + 2 * sk * hkv) * d * itemsize + 2 * b * hq * sq * 4
    ops = 4 * b * hq * d * int(keep.sum())
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (BF16_FLOPS if itemsize == 2 else F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), n_bytes, ops


def flash_ring_phase(card, gen) -> dict:
    """Phase 35: the flash kernel as a KV-ring hop's consumer against its
    plain version, on both paths: keys of their own length (Sk) at an offset
    (delta) from the queries, with statistics (stats=True): chatglm3-6b's
    hop at tp = 4 (the local causal span, a whole span of a lower rank, a
    sub-chunk of 256 keys at chunks_per_rank 2), gemma2-27b's windowed and
    capped hop at tp = 4 and S = 8192 (the window cuts through the span, its
    last row sees no key), and a span no row sees; the call with Sk = Sq and
    delta = 0 bit-identical to the call without them; times beside the
    bound and F.scaled_dot_product_attention on the same non-causal hop.
    Returns the flash row's hop numbers."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_plain,
                                                         flash_path)

    bf16 = torch.bfloat16
    cfg, gcfg = get_arch("chatglm3-6b").config, get_arch("gemma2-27b").config
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s, gs = GLM_S // RING_TP, GEMMA_S // RING_TP
    cases = (   # name, b, sq, sk, hq, hkv, delta, causal, window, cap, q scale
        ("local span", GLM_B, s, s, hq, hkv, 0, True, None, None, 1.0),
        ("hop of rank d-1", GLM_B, s, s, hq, hkv, s, True, None, None, 1.0),
        ("hop of rank d-3", GLM_B, s, s, hq, hkv, 3 * s, True, None, None, 1.0),
        ("second sub-chunk of rank d-1", GLM_B, s, s // 2, hq, hkv, s // 2, True, None, None,
         1.0),
        ("gemma2 windowed hop of rank d-2", 1, gs, gs, gcfg.n_heads, gcfg.n_kv_heads, 2 * gs,
         True, gcfg.window, gcfg.attn_softcap, FLASH_Q_SCALE),
        ("no key seen", 2, s, s // 2, hq, hkv, -s - 88, True, None, None, 1.0))
    lines, kept = [], {}
    for name, b, sq, sk, h, g_kv, delta, causal, window, cap, qs in cases:
        q = randn(gen, (b, sq, h, hd), bf16, qs)
        k, v = randn(gen, (b, sk, g_kv, hd), bf16), randn(gen, (b, sk, g_kv, hd), bf16)
        scale = gcfg.query_scale if cap else hd ** -0.5
        kw = dict(scale=scale, causal=causal, window=window, softcap=cap, delta=delta)
        want = plain_by_heads(q, k, v, stats=True, **kw)
        errs = []
        for path in ("tile", "cuda_core"):
            (o, m, l), took = on_path(flash_attention, lambda: flash_attention(
                q, k, v, stats=True, _path=path, **kw))
            e_o = check_close(f"flash hop {name} {took} o", o, want[0], BF16_TOL)
            e_m = check_close(f"flash hop {name} {took} m", m, want[1], F32_TOL)
            e_l = check_close(f"flash hop {name} {took} l", l, want[2], F32_TOL)
            errs.append(f"{took} o {e_o[0]:.3g}, m {e_m[0]:.3g}, l {e_l[0]:.3g}")
            if delta == 0 and sk == sq:
                same = torch.equal(o, flash_attention(q, k, v, scale=scale, causal=causal,
                                                      _path=path))
                if not same:
                    raise AssertionError(f"flash {took} path: delta 0 and Sk = Sq differ from "
                                         f"the call without them")
            if delta < -sq:
                if not (o.eq(0).all() and m.eq(-1e30).all() and l.eq(0).all()):
                    raise AssertionError(f"flash hop {name} {took}: a span no row sees must "
                                         f"give o = 0, m = -1e30, l = 0")
        empty = int(want[2].eq(0).any(dim=(0, 1)).sum())
        lines.append(f"{name} [{b},{sq},{h}/{g_kv},{hd}] x {sk} keys, delta {delta}"
                     + (f", window {window}, cap {cap}" if window else "")
                     + f" ({flash_path(bf16, hd)} chosen; rows that see no key: {empty}): "
                     + "; ".join(errs))
        if name in ("local span", "hop of rank d-1", "gemma2 windowed hop of rank d-2"):
            kept[name] = (q, k, v, kw)
        del want, o, m, l
    # times: the hop of rank d-1 (non-causal in effect) on both paths beside
    # SDPA without a mask, the local causal span, gemma2's windowed hop
    q, k, v, kw = kept["hop of rank d-1"]
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=False, enable_gqa=True)
    check_close("SDPA vs the hop", sdpa().transpose(1, 2), flash_attention(q, k, v, **kw),
                BF16_TOL)
    t = {"tile": [], "cuda_core": [], "sdpa": []}
    for path in ("tile", "sdpa", "cuda_core", "cuda_core", "sdpa", "tile"):
        run = sdpa if path == "sdpa" else (lambda: flash_attention(q, k, v, stats=True,
                                                                   _path=path, **kw))
        t[path].append(time_ms(run, iters=20, warmup=2))
    bnd = hop_bound(GLM_B, s, s, hq, hkv, hd, 2, delta=s)
    timed = {}
    for name in ("local span", "gemma2 windowed hop of rank d-2"):
        q, k, v, kw = kept[name]
        timed[name] = (time_ms(lambda: flash_attention(q, k, v, stats=True, **kw), iters=10,
                               warmup=2),
                       hop_bound(q.shape[0], q.shape[1], k.shape[1], q.shape[2], k.shape[2], hd,
                                 2, delta=kw["delta"], causal=kw["causal"],
                                 window=kw["window"]))
    del kept, q, k, v, qt, kt, vt
    ms = lambda ts: ", ".join(f"{t_:.4f}" for t_ in ts)
    say(35, f"flash_attention at KV-ring hop shapes vs plain (bound o {BF16_TOL}, m and l "
            f"{F32_TOL}), max abs err on both paths: " + "; ".join(lines)
            + f"; delta 0 with Sk = Sq bit-identical to the call without them on both paths; "
            f"the span no row sees gives o = 0, m = -1e30, l = 0 on both paths; on {card}, CUDA "
            f"events with statistics, the hop of rank d-1 [{GLM_B},{s},{hq}/{hkv},{hd}] x {s} "
            f"keys: tile path {ms(t['tile'])} ms, CUDA-core path {ms(t['cuda_core'])} ms, "
            f"F.scaled_dot_product_attention (no mask, enable_gqa) {ms(t['sdpa'])} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}: {bnd[3] / 1e9:.2f} GFLOP, {bnd[2] / 1e6:.1f} MB); "
            + "; ".join(f"{n_} {t_:.4f} ms (bound {b_[0]:.4f}, {b_[1]})"
                        for n_, (t_, b_) in timed.items()))
    return {"ring_hop": {"ms": min(t["tile"]), "cuda_core_ms": min(t["cuda_core"]),
                         "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": min(t["sdpa"]),
                         "local_ms": timed["local span"][0],
                         "gemma2_window_ms": timed["gemma2 windowed hop of rank d-2"][0]}}


def ring_prefill_phase(card) -> dict:
    """Phase 36: a spawned gloo world on the one card (tp = 4), every
    rank its shards of chatglm3-6b's seed-0 weights, prefilling phase 20's
    4 x 2048 tokens through ``prefill_fn`` in each setting of RING_WORLDS:
    logits against phase 20's exact f32 evaluation and each rank's cache
    chunk against the matching rows of phase 20's kernel-mode cache, both
    within LOGITS_TOL_FACTOR x bulk mode's own distance at that tp; every
    rank's logits equal; skew 1 bit-identical to skew 0; flash launches a
    rank 28 (1 + d) in kernel mode, 0 in bulk and fused mode; the hand-off
    (the chunks gathered into a tp = 4 decode cache, one fused-mode decode
    step from position 2048 against phase 20's prefill over 2049 tokens);
    ms a prefill.  The first RING_B of phase 20's rows, each held to its
    own rows there.  Needs phase 20's run (GLM_PREFILL).  Returns the flash
    row's prefill numbers."""
    L = GLM_PREFILL["layers"]
    rows = slice(0, RING_B)
    hand_in = GLM_PREFILL["handoff"]
    handoff = dict(token=hand_in["token"][rows].clone(), logits=hand_in["logits"][rows].clone())
    d_px = max(hand_in["d_px"][rows])
    row = {}
    for tp, settings in RING_WORLDS:
        res = spawn_world(tp, settings, target=prefill_world_rank, args=(dict(
            arch="chatglm3-6b", tokens=GLM_PREFILL["tokens"][rows].clone(),
            exact=GLM_PREFILL["exact"][rows].clone(),
            cache={k_: c_[:, rows].clone() for k_, c_ in GLM_PREFILL["cache"].items()},
            handoff=handoff if tp == RING_TP else None),))
        ranks = res["ranks"]
        err_b, cache_b = ranks[0]["bulk"]["err"], max(r["bulk"]["cache_err"] for r in ranks)
        bound, cache_bound = LOGITS_TOL_FACTOR * err_b, LOGITS_TOL_FACTOR * cache_b
        notes = []
        for name, kw in settings:
            mine = [r[name] for r in ranks]
            err, cerr = mine[0]["err"], max(m_["cache_err"] for m_ in mine)
            if not (err <= bound and cerr <= cache_bound):
                raise AssertionError(f"tp={tp} {name}: logits {err:.4g} from exact f32 (bound "
                                     f"{bound:.4g}), cache {cerr:.4g} from phase 20's kernel "
                                     f"mode (bound {cache_bound:.4g})")
            want = [L * (1 + d) if kw["mode"] == "kernel" else 0 for d in range(tp)]
            if [m_["launches"] for m_ in mine] != want:
                raise AssertionError(f"tp={tp} {name}: flash launches a rank "
                                     f"{[m_['launches'] for m_ in mine]}, expected {want}")
            notes.append(f"{name} logits {err:.4g}, cache {cerr:.4g}, flash launches a rank "
                         f"{want}, {mine[0]['ms']:.1f} ms")
        skew = ""
        if "fused q2 bf16 skew 1" in ranks[0]:
            same = ranks[0]["fused q2 bf16 skew 1"]["digest"] == ranks[0]["fused q2 bf16"]["digest"]
            if not same:
                raise AssertionError(f"tp={tp}: skew 1's logits are not skew 0's bits")
            skew = "; skew 1 bit-identical to skew 0 (2 sub-chunks, bf16 wire): True"
        hand = ""
        if tp == RING_TP:
            h = ranks[0]["kernel"]["handoff"]
            tol = LOGITS_TOL_FACTOR * d_px
            if not h["err"] <= tol:
                raise AssertionError(f"hand-off at tp={tp}: the decode step's logits are "
                                     f"{h['err']:.4g} from a prefill over {GLM_S + 1} tokens, "
                                     f"above {tol:.4g}")
            hand = (f"; hand-off (the kernel-mode chunks gathered with allgather_seq into a "
                    f"{GLM_PREFILL['max_seq']}-position tp = {tp} decode cache, one fused-mode "
                    f"decode_step from position {GLM_S}): logits {h['err']:.4g} from phase 20's "
                    f"prefill over {GLM_S + 1} tokens (bound {tol:.4g} = {LOGITS_TOL_FACTOR} x "
                    f"that prefill's distance from exact f32)")
            row = {"ring_prefill": {m_: ranks[0][m_]["ms"] for m_, _ in settings},
                   "ring_launches": [r["kernel"]["launches"] for r in ranks]}
        say(36, f"[{TP_LABEL.format(tp)}] chatglm3-6b full width, prefill of {RING_B}x{GLM_S} "
                f"(the first {RING_B} of phase 20's {GLM_B} rows) at tp = {tp} through "
                f"prefill_fn, {GLM_S // tp} positions a rank, every rank's logits equal; max abs "
                f"err of the logits from phase 20's exact f32 and of the ranks' cache chunks "
                f"from phase 20's kernel-mode cache, on those rows (bounds {bound:.4g} and "
                f"{cache_bound:.4g} = {LOGITS_TOL_FACTOR} x bulk's; tp 1 bulk's logits "
                f"{max(GLM_PREFILL['err_bx'][rows]):.4g}): " + "; ".join(notes) + skew + hand
                + f"; ms a prefill (host clock around the synchronised run, after a warm-up)")
    return row


def gemma2_ring_phase(card, gen) -> dict:
    """Phase 37: gemma2-27b at full width cut to its first RING_GEMMA_LAYERS
    layers (2 local, 2 global), prefill of 1 x GEMMA_S seeded tokens at tp =
    4 (spawned gloo world on the one card) in kernel and fused mode: logits
    against a tp = 1 kernel-mode prefill of the same layers and against its
    exact f32 evaluation (within LOGITS_TOL_FACTOR x the tp = 1 prefill's
    distance from it); the ring's hops a layer (2 on the windowed layers, 3
    on the global ones) and its sends; flash launches a rank; ms a prefill.
    Returns the flash row's gemma2 ring numbers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bundle = get_arch("gemma2-27b")
    cfg = dataclasses.replace(bundle.config, n_layers=RING_GEMMA_LAYERS)
    cut = dataclasses.replace(bundle, config=cfg)
    params = cut.init_params(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, GEMMA_S), generator=gen, device="cuda")
    ctx = {m: ParallelContext(device="cuda", fusion=FusionConfig(mode=m))
           for m in ("kernel", "bulk")}
    logits_1 = cut.prefill_fn(ctx["kernel"])(params, {"tokens": tokens})[0]
    exact = dataclasses.replace(cut, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    logits_x = exact.prefill_fn(ctx["bulk"])({**params, "layers": UpcastLayers(
        params["layers"])}, {"tokens": tokens})[0]
    d1 = errors(logits_1, logits_x)[0]
    inputs = dict(arch="gemma2-27b", layers=RING_GEMMA_LAYERS, tokens=tokens.cpu(),
                  exact=logits_x.cpu(), tp1=logits_1.cpu())
    del params, logits_1, logits_x
    torch.cuda.empty_cache()
    settings = [("kernel", dict(mode="kernel")), ("fused", dict(mode="fused"))]
    ranks = spawn_world(RING_TP, settings, target=prefill_world_rank, args=(inputs,))["ranks"]
    bound = LOGITS_TOL_FACTOR * d1
    windows = [cfg.layer_window(i) for i in range(cfg.n_layers)]
    s_loc = GEMMA_S // RING_TP
    want_hops = [RING_TP - 1 if w is None else min(RING_TP - 1, -(-w // s_loc)) for w in windows]
    notes = []
    for name, kw in settings:
        mine = [r[name] for r in ranks]
        if not mine[0]["err"] <= bound:
            raise AssertionError(f"gemma2 tp={RING_TP} {name}: logits {mine[0]['err']:.4g} from "
                                 f"exact f32, above {bound:.4g}")
        if any(m_["hops"] != want_hops or m_["sends"] != 2 * sum(want_hops) for m_ in mine):
            raise AssertionError(f"gemma2 tp={RING_TP} {name}: hops {mine[0]['hops']} and sends "
                                 f"{mine[0]['sends']}, expected {want_hops} and "
                                 f"{2 * sum(want_hops)}")
        notes.append(f"{name}: logits {mine[0]['err']:.4g} from exact f32, {mine[0]['err_tp1']:.4g}"
                     f" from the tp = 1 kernel-mode prefill; ring hops a layer {mine[0]['hops']}, "
                     f"sends a rank {mine[0]['sends']}; flash launches a rank "
                     f"{[m_['launches'] for m_ in mine]}; {mine[0]['ms']:.1f} ms a prefill")
    say(37, f"[{TP_LABEL.format(RING_TP)}] gemma2-27b full width cut to its first "
            f"{RING_GEMMA_LAYERS} of {bundle.config.n_layers} layers (windows {windows}), "
            f"prefill of 1x{GEMMA_S} seeded tokens at tp = {RING_TP} ({s_loc} positions a rank; "
            f"the windowed layers' ring stops at {want_hops[0]} of {RING_TP - 1} hops), every "
            f"rank's logits equal; bound {bound:.4g} = {LOGITS_TOL_FACTOR} x the tp = 1 "
            f"kernel-mode prefill's distance from exact f32 ({d1:.4g}): " + "; ".join(notes))
    return {"gemma2_ring": {m_: ranks[0][m_]["ms"] for m_, _ in settings},
            "gemma2_ring_launches": [r["kernel"]["launches"] for r in ranks]}


def prefill_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 36's or 37's world: this rank's shards of the
    seed-0 weights of ``inputs["arch"]`` (cut to ``inputs["layers"]``
    layers if given), each setting's prefill of ``inputs["tokens"]``
    (counted, timed and checked, after one warm-up prefill), and the
    hand-off where asked."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.allgather_matmul import allgather_seq
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.models import attention
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        ctx = lambda **kw: ParallelContext(device=dev, tp=tp, fusion=FusionConfig(**kw))
        bundle = get_arch(inputs["arch"])
        if inputs.get("layers"):
            bundle = dataclasses.replace(bundle, config=dataclasses.replace(
                bundle.config, n_layers=inputs["layers"]))
        params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), ctx(mode="bulk"))
        batch = {"tokens": inputs["tokens"].to(dev)}
        exact = inputs["exact"].to(dev)
        s_loc = batch["tokens"].shape[1] // tp
        rows = slice(rank * s_loc, (rank + 1) * s_loc)
        # a warm-up prefill (the world's first exchanges, cuBLAS's first
        # products) in the first setting that is not bulk mode's (bulk
        # mode's all-gathers take the longest through the host), untimed;
        # then each setting's one prefill is counted, timed and checked
        warm = next((kw for _, kw in settings if kw.get("mode") != "bulk"), settings[0][1])
        bundle.prefill_fn(ctx(**warm))(params, batch)
        res = {}
        for name, kw in settings:
            pre = bundle.prefill_fn(ctx(**kw))
            hops, sends = [], [0]
            ring, start = attention._ring_attention, attention.ring_permute_start

            def record(*a, **k_):
                hops.append(k_["hops"])
                return ring(*a, **k_)

            def count(*a, **k_):
                sends[0] += 1
                return start(*a, **k_)
            flash_attention.launches = 0
            attention._ring_attention, attention.ring_permute_start = record, count
            try:
                torch.cuda.synchronize(dev)
                t0 = time.perf_counter()
                logits, cache = pre(params, batch)
                torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                attention._ring_attention, attention.ring_permute_start = ring, start
            r = {"ms": ms, "launches": flash_attention.launches, "hops": hops, "sends": sends[0],
                 "err": (logits - exact).abs().max().item(),
                 "finite": bool(torch.isfinite(logits).all()) and logits.shape == exact.shape,
                 "digest": hashlib.sha256(logits.cpu().numpy().tobytes()).hexdigest()}
            if "tp1" in inputs:
                r["err_tp1"] = (logits - inputs["tp1"].to(dev)).abs().max().item()
            if "cache" in inputs:
                r["cache_err"] = max((cache[key] - inputs["cache"][key][:, :, rows].to(dev))
                                     .abs().max().item() for key in ("k", "v"))
            if kw["mode"] == "kernel" and inputs.get("handoff"):
                r_h = inputs["handoff"]
                dc = bundle.init_cache(batch["tokens"].shape[0], dev, tp)
                n_loc = dc["k"].shape[2]
                for key in dc:
                    whole = allgather_seq(ctx(mode="fused"), cache[key], axis_pos=2)
                    mine = whole[:, :, rank * n_loc:(rank + 1) * n_loc]
                    dc[key][:, :, :mine.shape[2]] = mine
                    del whole
                pos = torch.full((batch["tokens"].shape[0],), batch["tokens"].shape[1],
                                 dtype=torch.int32, device=dev)
                lg, _ = bundle.decode_fn(ctx(mode="fused"))(params, r_h["token"].to(dev), dc,
                                                            pos)
                r["handoff"] = {"err": (lg - r_h["logits"].to(dev)).abs().max().item()}
                del dc
            del logits, cache
            res[name] = r
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


# ---------------------------------------------------------------------------
# phases 38-40: training at tp > 1
# ---------------------------------------------------------------------------
# Phase 38's settings, in one spawned world of RING_TP ranks: (name, fusion
# settings and the setting's tp; tp = 2 runs on the pairs (0, 1) and (2, 3)),
# on TRAIN_GRAD_LAYERS full-width layers at phase 27's long batch
# (TRAIN_LONG_B x TRAIN_LONG_S: 512 positions a rank at tp = 4, phase 35's hop
# shapes); skew 1 at 2 sub-chunks against skew 0.  Bulk and plain fused mode
# at tp = 4 were cut when phases 41-43 came, for the script's time
TRAIN_TP_GRADS = [
    ("kernel", dict(mode="kernel")),
    ("fused q2 bf16", dict(mode="fused", granularity=2, wire="bf16")),
    ("fused q2 bf16 skew 1", dict(mode="fused", granularity=2, wire="bf16", skew=1)),
    ("tp 2 kernel", dict(mode="kernel", tp=2))]
# Phase 39: TRAIN_TP_STEPS AdamW steps at tp = 4 of the model cut to
# TRAIN_TP_LAYERS layers, at the same batch.  A rank at tp = 4 holds w_qkv and
# w_o whole (35.7 M parameters a layer), a quarter of the FFN (42.1 M) and of
# the table (66.6 M): with bf16 weights and gradients and f32 AdamW moments
# about 12 bytes a parameter, 4.5 GB a rank at 4 layers and 18 GB for the
# four, beside four CUDA contexts; at all 28 layers (2.25 G parameters a
# rank) four ranks do not fit one card.  Cut from 4 layers to 2 when phases
# 41-43 came, for the script's time (phase 39 took 82.6 s at 4)
TRAIN_TP_LAYERS, TRAIN_TP_STEPS = 2, 3
# kernel mode only: fused mode's steps were cut when phases 41-43 came (phase
# 38 holds fused mode's gradients)
TRAIN_TP_SETTINGS = [("kernel", dict(mode="kernel"))]
# Phase 40: the launcher at tp = 2 against tp = 1 on the same flags, full
# width cut to TRAIN_GRAD_LAYERS layers (the reduced model's heads of 16 are
# not a size the flash kernel takes), 3 steps (6 until the script's time was
# cut: each step of the tp = 2 launcher took 2.45 s on one H100 80GB HBM3)
TRAIN_EXACT: dict = {}    # phase 38's exact gradients, which phase 42 is held to
TRAIN_TP1: dict = {}      # phases 39-40's tp = 1 runs, which phases 42-43 are held to
TRAIN_TP_LAUNCH = ["--fusion", "kernel", "--layers", str(TRAIN_GRAD_LAYERS), "--steps", "3",
                   "--lr", TRAIN_LR, "--log-every", "1"]


def train_tp_phases(card) -> dict:
    """Phases 38-40; returns the flash row's numbers of training at tp > 1."""
    row = train_tp_grad_phase(card)
    torch.cuda.empty_cache()
    row.update(train_tp_step_phase(card))
    torch.cuda.empty_cache()
    row.update(train_tp_launcher_phase(card))
    return row


def _whole(specs):
    """Which leaves (in tree_leaves order) are whole on every rank."""
    from repro_torch.parallel.sharding import splits_over_tp

    return [not splits_over_tp(sp) for sp in specs]


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t_ in tensors:
        # the host copy's buffer itself (no bytes object copied from it)
        h.update(t_.detach().reshape(-1).contiguous().view(torch.uint8).cpu().numpy())
    return h.hexdigest()


def train_tp_grad_phase(card) -> dict:
    """Phase 38: the loss and every gradient of TRAIN_GRAD_LAYERS full-width
    chatglm3-6b layers at TRAIN_LONG_B x TRAIN_LONG_S (LMBatches seed 0,
    weights seed 0) over a spawned gloo world on the card (TRAIN_TP_GRADS),
    each rank's shard against the matching slice of one exact f32 tp = 1
    evaluation made here (bulk mode, f32 weights and arithmetic) and written
    to a file the ranks map: the loss and each leaf within LOGITS_TOL_FACTOR
    x tp = 1 bulk mode's distance on that leaf; every rank's loss equal, the
    whole leaves' gradients bit-identical across ranks (after the
    all-reduce), skew 1 bit-identical to skew 0, flash launches a rank 2 L (1
    + d) in kernel mode (the forward and the remat recompute), 0 otherwise;
    ms of the forward, the backward and the gradients' all-reduce."""
    import tempfile

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import LMBatches
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import tree_leaves, tree_map, tree_paths

    bundle = get_arch("chatglm3-6b")
    cfg = dataclasses.replace(bundle.config, n_layers=TRAIN_GRAD_LAYERS)
    cut = dataclasses.replace(bundle, config=cfg)
    L = cfg.n_layers
    batch_np = next(LMBatches(cfg.vocab, TRAIN_LONG_B, TRAIN_LONG_S, 0))
    batch = to_device(batch_np, "cuda")
    params = cut.init_params(torch.Generator(device="cuda").manual_seed(0))
    names = [".".join(map(str, p_)) for p_, _ in tree_paths(params)]
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    loss_b = cut.loss_fn(ctx_b)(params, batch)
    grads_b = torch.autograd.grad(loss_b, leaves)
    exact = dataclasses.replace(cut, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = tree_map(lambda t_: t_.detach().float().requires_grad_(True), params)
    del params, leaves
    loss_x = exact.loss_fn(ctx_b)(params_x, batch)
    grads_x = torch.autograd.grad(loss_x, tree_leaves(params_x))
    del params_x
    dist_b = [errors(gb, gx)[0] for gb, gx in zip(grads_b, grads_x)]
    lb, lx = loss_b.item(), loss_x.item()
    del grads_b, loss_b, loss_x
    (ROOT / "build").mkdir(exist_ok=True)
    notes, row = [], {}
    # the file stays for phase 42, which removes it
    path = Path(tempfile.mkdtemp(dir=ROOT / "build")) / "exact_grads.pt"
    torch.save({n_: g.cpu() for n_, g in zip(names, grads_x)}, path)
    del grads_x
    torch.cuda.empty_cache()
    TRAIN_EXACT.update(path=path, names=names, dist_b=dist_b, lb=lb, lx=lx, batch=batch_np)
    ranks = spawn_world(RING_TP, TRAIN_TP_GRADS, target=train_world_rank, args=(dict(
        kind="grads", layers=L, batch=batch_np, exact=str(path), loss=lx),))["ranks"]
    for name, kw in TRAIN_TP_GRADS:
        tp = kw.get("tp", RING_TP)
        mine = [r_[name] for r_ in ranks]
        loss_bound = LOGITS_TOL_FACTOR * abs(lb - lx)
        if not mine[0]["loss_err"] <= loss_bound:
            raise AssertionError(f"tp={tp} {name}: loss {mine[0]['loss']:.6f} is "
                                 f"{mine[0]['loss_err']:.3g} from exact f32 {lx:.6f}, above "
                                 f"{loss_bound:.3g}")
        worst = []
        for i, n_ in enumerate(names):
            e = max(m_["errs"][i] for m_ in mine)
            if not e <= LOGITS_TOL_FACTOR * dist_b[i]:
                raise AssertionError(f"tp={tp} {name} gradient {n_}: {e:.3g} from exact f32, "
                                     f"above {LOGITS_TOL_FACTOR} x tp = 1 bulk's {dist_b[i]:.3g}")
            worst.append(e / dist_b[i])
        worlds = [mine[w_:w_ + tp] for w_ in range(0, RING_TP, tp)]
        if any(len({m_["whole_digest"] for m_ in w_}) != 1 for w_ in worlds):
            raise AssertionError(f"tp={tp} {name}: the whole leaves' gradients differ across the "
                                 f"ranks")
        want = [2 * L * (1 + r_ % tp) if kw["mode"] == "kernel" else 0 for r_ in range(RING_TP)]
        if [m_["launches"] for m_ in mine] != want:
            raise AssertionError(f"tp={tp} {name}: flash launches a rank "
                                 f"{[m_['launches'] for m_ in mine]}, expected {want}")
        fwd, bwd, ar = (max(m_["ms"][i] for m_ in mine) for i in range(3))
        errs = ", ".join(f"{n_} {max(m_['errs'][i] for m_ in mine):.3g}"
                         for i, n_ in enumerate(names))
        notes.append(f"tp = {tp} {name}: loss {mine[0]['loss']:.6f} ({mine[0]['loss_err']:.3g} "
                     f"from exact), worst leaf at {max(worst):.3g} of its bulk distance, flash "
                     f"launches a rank {want[:tp]}; ms forward {fwd:.1f}, backward {bwd:.1f}, "
                     f"all-reduce {ar:.2f} (slowest rank)"
                     + (f"; each leaf's max abs err from exact f32 over the ranks: {errs}"
                        if kw["mode"] == "kernel" else ""))
        row.setdefault("train_tp_grad_ms", {})[name] = [fwd, bwd, ar]
    # compared bit for bit in each rank; the table's gradient is left out:
    # its rows gather scatter-adds (index_add_), whose order on the card is
    # the atomics'
    if not all(r_["fused q2 bf16 skew 1"]["skew_equal"] for r_ in ranks):
        raise AssertionError(f"tp={RING_TP}: skew 1's gradients are not skew 0's bits")
    row["train_tp_launches"] = [r_["kernel"]["launches"] for r_ in ranks]
    say(38, f"[{TP_LABEL.format(RING_TP)}] gradients of {L} full-width chatglm3-6b layers at "
            f"{TRAIN_LONG_B}x{TRAIN_LONG_S} tokens (LMBatches seed 0, weights seed 0) at tp = 4 "
            f"and 2 (the pairs of one world) through loss_fn: exact f32 loss {lx:.6f}, tp = 1 bulk "
            f"{lb:.6f}; every rank's loss equal, the whole leaves' gradients bit-identical across "
            f"the ranks, skew 1 bit-identical to skew 0 (2 sub-chunks, bf16 wire; every leaf but "
            f"the table); tp = 1 bulk's max abs err from exact f32 on each leaf (the bound is "
            f"{LOGITS_TOL_FACTOR} x it): "
            + ", ".join(f"{n_} {d_:.3g}" for n_, d_ in zip(names, dist_b)) + "; "
            + "; ".join(notes))
    return row


class EventClock:
    """``on_phase`` hook of the train step in a rank: a CUDA event as each
    part of a step has been enqueued."""

    def __init__(self):
        self.steps = []

    def __call__(self, name):
        if name == "start":
            self.steps.append({})
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.steps[-1][name] = ev

    def split(self):
        """Per step: (forward, backward, all-reduce, optimizer, whole) ms."""
        torch.cuda.synchronize()
        parts = ("start", "forward", "backward", "allreduce", "optimizer")
        return [tuple(e[a].elapsed_time(e[b]) for a, b in zip(parts, parts[1:]))
                + (e["start"].elapsed_time(e["optimizer"]),) for e in self.steps]


def train_steps(bundle, ctx, batches, on_phase=None):
    """TRAIN_TP_STEPS AdamW steps at lr TRAIN_LR (f32 moments) from the
    seed-0 weights (this rank's training shards in a world) on ``batches``, the second
    under torch.profiler (CUDA activity); returns (losses, state, (the
    second step's device ms, of which the flash kernel's))."""
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    gen = torch.Generator(device=ctx.device).manual_seed(0)
    params = (bundle.init_params(gen, ctx, training=True) if ctx.tp > 1 or ctx.dp > 1 else
              bundle.init_params(gen))
    tc = TrainConfig(optimizer=OptimizerConfig(lr=float(TRAIN_LR), warmup_steps=5,
                                               total_steps=TRAIN_TP_STEPS))
    step = build_train_step(bundle.loss_fn(ctx), tc, ctx=ctx,
                            param_specs=bundle.param_specs(params), on_phase=on_phase)
    state = init_train_state(tc, params)
    del params
    from torch.profiler import ProfilerActivity, profile

    losses, device = [], None
    for i, b_ in enumerate(batches):
        prof = None
        if i == 1:
            torch.cuda.synchronize(ctx.device)
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        state, metrics = step(state, b_)
        losses.append(metrics["loss"].item())
        if prof is not None:
            torch.cuda.synchronize(ctx.device)
            prof.stop()
            dev = [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
            if not dev:
                raise AssertionError("torch.profiler recorded no device time in a train step")
            device = (sum(t_ for _, t_ in dev), sum(t_ for n_, t_ in dev if "flash" in n_))
            del prof
    return losses, state, device


def train_tp_step_phase(card) -> dict:
    """Phase 39: TRAIN_TP_STEPS AdamW steps of full-width chatglm3-6b cut to
    TRAIN_TP_LAYERS layers at TRAIN_LONG_B x TRAIN_LONG_S (LMBatches seed 0)
    at tp = 4 in kernel mode (a spawned gloo world on the card),
    each rank from its shards of the seed-0 weights: the losses within
    TRAIN_LOSS_REL of TRAIN_TP_STEPS tp = 1 kernel-mode steps of the same
    layers made here, every whole parameter bit-identical across the ranks
    after the last step, ms a step split into forward, backward, all-reduce
    and optimizer, each rank's peak memory."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import LMBatches
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bundle = get_arch("chatglm3-6b")
    cfg = dataclasses.replace(bundle.config, n_layers=TRAIN_TP_LAYERS)
    cut = dataclasses.replace(bundle, config=cfg)
    it = LMBatches(cfg.vocab, TRAIN_LONG_B, TRAIN_LONG_S, 0)
    batches = [next(it) for _ in range(TRAIN_TP_STEPS)]
    torch.cuda.reset_peak_memory_stats()
    clock = EventClock()
    want, state, dev1 = train_steps(cut, ParallelContext(device="cuda", fusion=FusionConfig(
        mode="kernel")), [to_device(b_, "cuda") for b_ in batches], clock)
    split1 = clock.split()[-1]
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    TRAIN_TP1.update(losses=want, batches=batches, step_ms=split1[4], peak=peak1)
    del state
    torch.cuda.empty_cache()
    ranks = spawn_world(RING_TP, TRAIN_TP_SETTINGS, target=train_world_rank, args=(dict(
        kind="steps", layers=TRAIN_TP_LAYERS, batches=batches),))["ranks"]
    notes, row = [], {}
    for name, _ in TRAIN_TP_SETTINGS:
        mine = [r_[name] for r_ in ranks]
        got = mine[0]["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if any(m_["losses"] != got for m_ in mine) or not rel <= TRAIN_LOSS_REL:
            raise AssertionError(f"tp={RING_TP} {name}: losses {[m_['losses'] for m_ in mine]} "
                                 f"against tp = 1's {want} ({rel:.3g} of them, bound "
                                 f"{TRAIN_LOSS_REL})")
        if len({m_["whole_digest"] for m_ in mine}) != 1:
            raise AssertionError(f"tp={RING_TP} {name}: the whole parameters differ across the "
                                 f"ranks after step {TRAIN_TP_STEPS}")
        last = [max(m_["split"][-1][i] for m_ in mine) for i in range(5)]
        dev_ms, flash_ms = mine[0]["device"]
        notes.append(f"{name}: losses {', '.join(f'{x:.5f}' for x in got)} ({rel:.3g} of tp = "
                     f"1's at most), step {TRAIN_TP_STEPS} {last[4]:.1f} ms = forward "
                     f"{last[0]:.1f} + backward {last[1]:.1f} + all-reduce {last[2]:.1f} + "
                     f"optimizer {last[3]:.1f} (slowest rank each), flash launches a rank "
                     f"{[m_['launches'] for m_ in mine]}, rank 0's device time in step 2 "
                     f"(torch.profiler) {dev_ms:.1f} ms, the flash kernel's {flash_ms:.2f} ms "
                     f"({100 * flash_ms / dev_ms:.2f} %), peak a rank "
                     + ", ".join(f"{m_['peak']:.2f}" for m_ in mine) + " GB")
        row.setdefault("train_tp_step_ms", {})[name] = last
        row.setdefault("train_tp_flash_share", {})[name] = flash_ms / dev_ms
    say(39, f"[{TP_LABEL.format(RING_TP)}] {TRAIN_TP_STEPS} AdamW steps (lr {TRAIN_LR}, f32 "
            f"moments) of full-width chatglm3-6b cut to {TRAIN_TP_LAYERS} of "
            f"{bundle.config.n_layers} layers at {TRAIN_LONG_B}x{TRAIN_LONG_S} tokens at tp = "
            f"{RING_TP}; every whole parameter bit-identical across the ranks after the last "
            f"step; tp = 1 kernel mode: losses {', '.join(f'{x:.5f}' for x in want)}, step "
            f"{TRAIN_TP_STEPS} {split1[4]:.1f} ms (forward {split1[0]:.1f}, backward "
            f"{split1[1]:.1f}, optimizer {split1[3]:.1f}), device time in step 2 {dev1[0]:.1f} "
            f"ms, the flash kernel's {dev1[1]:.2f} ({100 * dev1[1] / dev1[0]:.2f} %), peak "
            f"{peak1:.2f} GB; "
            + "; ".join(notes) + " (CUDA events in each rank)")
    row["train_tp_step_ms_tp1"] = split1[4]
    return row


TP2_TRAIN_ARGV = ["--tp", "2", "--backend", "gloo", *TRAIN_TP_LAUNCH]


def train_tp_launcher_phase(card) -> dict:
    """Phase 40: the train launcher at tp = 1 on TRAIN_TP_LAUNCH in this
    process, the yardstick of ``python -m torch.distributed.run
    --nproc-per-node 2 -m repro_torch.launch.train --tp 2 --backend gloo``
    with the same flags, which runs beside phase 43's launchers
    (``tp2_train_check``: its processes' start overlaps theirs)."""
    from repro_torch.launch import train as launch_train

    t0 = time.perf_counter()
    want = launch_train.main(TRAIN_TP_LAUNCH)
    TRAIN_TP1["launcher_losses"] = want
    torch.cuda.empty_cache()
    say(40, f"python -m repro_torch.launch.train {' '.join(TRAIN_TP_LAUNCH)} in this process "
            f"(full-width chatglm3-6b, {TRAIN_GRAD_LAYERS} layers, 16x64 tokens): losses "
            f"{', '.join(f'{x:.4f}' for x in want)} in {time.perf_counter() - t0:.1f} s, the "
            f"yardstick of the launcher at --tp 2, which runs beside phase 43's")
    return {}


def tp2_train_check(out, wall) -> str:
    """Phase 40's launcher at --tp 2 (two of the pool's processes, run after
    phase 43's): it says every rank's losses are equal, and its losses are
    within TRAIN_LOSS_REL of the tp = 1 launcher's on the same flags.
    Returns its summary."""
    want = TRAIN_TP1["launcher_losses"]
    got = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", out)]
    if "all 2 ranks' losses equal: True" not in out:
        print(out[-4000:], file=sys.stderr)
        raise AssertionError("train launcher at tp=2: the ranks' losses not checked equal")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want)) if len(got) == len(want) else 1.0
    if not rel <= TRAIN_LOSS_REL:
        raise AssertionError(f"train launcher at tp=2: losses {got} against tp = 1's {want}")
    step_s = re.findall(r"\(([\d.]+)s/step\)", out)
    return (f"phase 40's launch.train.main(--tp 2 --backend gloo {' '.join(TRAIN_TP_LAUNCH)}) "
            f"in 2 of the pool's processes: all 2 ranks' losses equal; losses "
            f"{', '.join(f'{x:.4f}' for x in got)} against tp = 1's "
            f"{', '.join(f'{x:.4f}' for x in want)} ({rel:.3g} of them at most, bound "
            f"{TRAIN_LOSS_REL}); {step_s[-1] if step_s else '?'} s a step on the host clock "
            f"(rank 0's average over the run); {wall:.1f} s with init")


def _pair_params(bundle, ctx, dev):
    """This rank's shards of the seed-0 weights at ``ctx``'s tp, each leaf
    requiring a gradient."""
    from repro_torch.train.optimizer import tree_leaves

    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), ctx)
    for p_ in tree_leaves(params):
        p_.requires_grad_(True)
    return params


def train_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 38's or 39's world: this rank's shards of the
    seed-0 weights of full-width chatglm3-6b cut to ``inputs["layers"]``;
    phase 38 (``kind`` "grads"): each setting's loss and gradients
    (counted, timed and checked against the mapped exact f32 ones, after a
    warm-up); phase 39 ("steps"): each setting's AdamW steps."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext, shard_leaf
    from repro_torch.train.optimizer import spec_leaves, tree_leaves, tree_paths

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        ctx = lambda **kw: ParallelContext(device=dev, tp=tp, fusion=FusionConfig(**kw))
        bundle = get_arch("chatglm3-6b")
        bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_layers=inputs["layers"]))
        sync = lambda: torch.cuda.synchronize(dev)
        res = {}
        if inputs["kind"] == "steps":
            batches = [{k: torch.as_tensor(v).to(dev) for k, v in b_.items()}
                       for b_ in inputs["batches"]]
            for name, kw in settings:
                c = ctx(**kw)
                torch.cuda.reset_peak_memory_stats(dev)
                flash_attention.launches = 0
                clock = EventClock()
                losses, state, device = train_steps(bundle, c, batches, clock)
                specs = spec_leaves(bundle.param_specs(state["params"]))
                whole = [p_ for p_, w_ in zip(tree_leaves(state["params"]), _whole(specs)) if w_]
                res[name] = {"losses": losses, "split": clock.split(), "device": device,
                             "launches": flash_attention.launches,
                             "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
                             "whole_digest": _digest(whole),
                             "digest": _digest([torch.tensor(losses)]),
                             "finite": all(x == x and abs(x) < float("inf") for x in losses)}
                del state, whole
                torch.cuda.empty_cache()
            out.put((rank, "ok", res))
            return
        batch = {k: torch.as_tensor(v).to(dev) for k, v in inputs["batch"].items()}
        params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), ctx(mode="bulk"))
        names = [".".join(map(str, p_)) for p_, _ in tree_paths(params)]
        leaves = tree_leaves(params)
        for p_ in leaves:
            p_.requires_grad_(True)
        specs = spec_leaves(bundle.param_specs(params))
        # the pairs (0, 1) and (2, 3) for the settings at tp = 2 (every rank
        # makes both groups); the world's rank d is tp rank d % 2 there
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        world = {tp: dict(), 2: dict(group=pairs[rank // 2])}
        exact = torch.load(inputs["exact"], mmap=True)
        shards = {}     # this rank's slices of the exact gradients, a tp
        for t_ in {kw.get("tp", tp) for _, kw in settings}:
            c = ParallelContext(device=dev, tp=t_, **world[t_])
            shards[t_] = [shard_leaf(exact[n_], sp, c).to(dev) for n_, sp in zip(names, specs)]
        del exact
        c0 = ctx(**settings[0][1])      # a warm-up: the world's first exchanges, untimed
        torch.autograd.grad(bundle.loss_fn(c0)(params, batch), leaves)
        for name, kw in settings:
            kw = dict(kw)
            t_ = kw.pop("tp", tp)
            c = ParallelContext(device=dev, tp=t_, fusion=FusionConfig(**kw), **world[t_])
            p_t = params if t_ == tp else _pair_params(bundle, c, dev)
            lv = tree_leaves(p_t)
            flash_attention.launches = 0
            sync()
            t0 = time.perf_counter()
            loss = bundle.loss_fn(c)(p_t, batch)
            sync()
            t1 = time.perf_counter()
            grads = list(torch.autograd.grad(loss, lv))
            sync()
            t2 = time.perf_counter()
            all_reduce_grads(c, grads, specs)
            sync()
            t3 = time.perf_counter()
            errs = [(g.float() - w_).abs().max().item() for g, w_ in zip(grads, shards[t_])]
            res[name] = {"ms": ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3),
                         "launches": flash_attention.launches, "loss": loss.item(),
                         "loss_err": abs(loss.item() - inputs["loss"]), "errs": errs,
                         "digest": _digest([loss]),
                         "finite": bool(torch.isfinite(loss)) and all(
                             bool(torch.isfinite(g).all()) for g in grads),
                         "whole_digest": _digest([g for g, w_ in zip(grads, _whole(specs))
                                                  if w_])}
            mine = [g for g, n_ in zip(grads, names) if n_ != "embed.table"]
            if name == "fused q2 bf16":
                skew0 = mine
            elif name == "fused q2 bf16 skew 1":
                res[name]["skew_equal"] = all(torch.equal(a, b) for a, b in zip(skew0, mine))
                del skew0
            del loss, grads, p_t, lv, mine
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


# ---------------------------------------------------------------------------
# phases 41-43: paged serving at tp > 1, the data axis, the launchers there
# ---------------------------------------------------------------------------
# Phases 41-42 cut full-width chatglm3-6b to PAGED_TP_LAYERS layers (the
# worlds' steps pass every payload through host memory: at 28 layers phase
# 23's traffic takes minutes a setting); phase 42's decode and paged serving
# run at the same depth, its gradients at phase 38's TRAIN_GRAD_LAYERS and
# its AdamW steps at phase 39's TRAIN_TP_LAYERS (held to phase 39's tp = 1
# steps).  At 4 layers a (2, 2) step took 7.1-8.6 s on an H100,
# the fsdp gathers through host memory 5.2-5.7 s of it, and the whole script
# 1071.5 s of its 1200
PAGED_TP_LAYERS = DATA_LAYERS = 2
DATA_STEPS = 2           # of phase 39's 3 AdamW steps
PAGED_TP_SETTINGS = [("tp 4 fused", dict(mode="fused")), ("tp 4 bulk", dict(mode="bulk")),
                     ("tp 2 fused", dict(mode="fused", tp=2))]
PAGED_TP: dict = {}       # phase 41's tp = 1 run, which phase 42's paged serving is held to
DATA_DECODE_STEPS = 4
# phase 42's settings in one world of 4 ranks: (name, kind, (dp, tp), mode)
DATA_SETTINGS = [("(4, 1) kernel decode", dict(kind="decode", dp=4, tp=1, mode="kernel")),
                 ("(4, 1) kernel grads", dict(kind="grads", dp=4, tp=1, mode="kernel")),
                 ("(2, 2) fused grads", dict(kind="grads", dp=2, tp=2, mode="fused")),
                 ("(2, 2) fused decode", dict(kind="decode", dp=2, tp=2, mode="fused")),
                 ("(2, 2) bulk decode", dict(kind="decode", dp=2, tp=2, mode="bulk")),
                 ("(2, 2) fused paged", dict(kind="paged", dp=2, tp=2, mode="fused")),
                 ("(2, 2) bulk paged", dict(kind="paged", dp=2, tp=2, mode="bulk")),
                 ("(2, 2) fused steps", dict(kind="steps", dp=2, tp=2, mode="fused")),
                 ("(2, 2) bulk steps", dict(kind="steps", dp=2, tp=2, mode="bulk")),
                 ("(1, 2) fused steps", dict(kind="steps", dp=1, tp=2, mode="fused"))]


def cut_glm(layers):
    """Full-width chatglm3-6b cut to its first ``layers`` layers, and the
    same in f32 (the exact evaluation)."""
    from repro_torch.configs.registry import get_arch

    bundle = get_arch("chatglm3-6b")
    cfg = dataclasses.replace(bundle.config, n_layers=layers)
    return (dataclasses.replace(bundle, config=cfg), dataclasses.replace(bundle, config=(
        dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32"))))


def paged_drive(bundle, params, serve, prompts, dev, tp=1, stripes=None):
    """Phase 23(b)'s traffic (``prompts`` x PAGED_NEW, batch PAGED_B, chunk
    PAGED_CHUNK, the launcher's default pool striped over ``tp``) through a
    tracked PagedDecodeEngine: (streams, first generated tokens' logits,
    the log, where, the engine, host seconds).  ``stripes``, a list of tp
    zeros, gathers each stripe's peak of the blocks the tables name."""
    from repro_torch.serve.engine import Request

    cfg = bundle.config
    nb = PAGED_B * cfg.max_seq // 2 // PAGED_BLOCK
    log, where = [], {}
    rec = record(serve, log)

    def step(t_, pl, tb, p_, n_):
        if stripes is not None:
            held = torch.unique(tb)
            per = torch.bincount(held[held >= 0] // (nb // tp), minlength=tp).tolist()
            stripes[:] = [max(a, b) for a, b in zip(stripes, per)]
        return rec(params, t_, pl, tb, p_, n_)
    eng = tracked_engine(log, where)(
        step, lambda n_, bs: bundle.init_paged_pool(n_, bs, dev, tp), PAGED_B, num_blocks=nb,
        block_size=PAGED_BLOCK, max_seq=cfg.max_seq, chunk=PAGED_CHUNK, device=dev,
        n_stripes=tp)
    reqs = [Request(uid=i, prompt=list(p_), max_new=PAGED_NEW) for i, p_ in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    if not eng.run_until_drained().drained or any(len(r.tokens) != PAGED_NEW for r in reqs):
        raise AssertionError(f"paged engine at tp={tp}: requests {[len(r.tokens) for r in reqs]}")
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    firsts = [log[where[(r.uid, 0)][0]]["logits"][where[(r.uid, 0)][1]] for r in reqs]
    return [r.tokens for r in reqs], firsts, log, where, eng, wall


def step_ms(serve, params, log, pool, dev, sync_world=None) -> dict:
    """ms of one serve_step at C = 1 and C = PAGED_CHUNK on a logged step's
    inputs (the best of 5 on the host clock, synchronised; in a world the
    ranks call in lockstep)."""
    c1 = next(e for e in log if e["in"][0].shape[1] == 1)
    c8 = next(e for e in log if e["in"][0].shape[1] == PAGED_CHUNK and bool((e["in"][3] > 0).all()))
    out = {}
    for name, e in (("C=1", c1), (f"C={PAGED_CHUNK}", c8)):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize(dev)
            if sync_world is not None:
                sync_world()
            t0 = time.perf_counter()
            serve(params, e["in"][0], pool, *e["in"][1:])
            torch.cuda.synchronize(dev)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[name] = min(ts)
    return out


def paged_refs(bundle, exact, params) -> dict:
    """Phase 41's tp = 1 yardsticks on ``params``: a bulk paged run of the
    seeded prompts (its streams, log and first tokens), its exact f32
    replay, and a dense bulk and exact prefill of each prompt."""
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    cfg = bundle.config
    gen = torch.Generator(device="cuda").manual_seed(41)
    prompts = [torch.randint(0, cfg.vocab, (n_,), generator=gen, device="cuda").tolist()
               for n_ in PAGED_PROMPTS]
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    params32 = _map(params, lambda t_: t_.float())
    streams, firsts, log, where, eng, wall = paged_drive(bundle, params,
                                                         bundle.serve_step_fn(ctx_b), prompts,
                                                         "cuda")
    nb = eng.kv.num_blocks
    ref_x = replay(exact.serve_step_fn(ctx_b), params32, log,
                   lambda: exact.init_paged_pool(nb, PAGED_BLOCK, "cuda"))
    e_bx = live_err(log, [e["logits"] for e in log], ref_x)
    firsts_x = [ref_x[where[(u, 0)][0]][where[(u, 0)][1]] for u in range(len(prompts))]
    del ref_x
    pre_b, pre_x = bundle.prefill_fn(ctx_b), exact.prefill_fn(ctx_b)
    dense, bounds = [], []
    for u, p_ in enumerate(prompts):
        batch = {"tokens": torch.tensor([p_], device="cuda")}
        db, dx = pre_b(params, batch)[0][0, 0], pre_x(params32, batch)[0][0, 0]
        dense.append(db)
        bounds.append(LOGITS_TOL_FACTOR * max(errors(firsts[u], firsts_x[u])[0],
                                              errors(db, dx)[0]))
    del params32
    ms = step_ms(bundle.serve_step_fn(ctx_b), params, log, eng.pool, "cuda")
    first_err = [errors(f_, d_)[0] for f_, d_ in zip(firsts, dense)]
    return {"prompts": prompts, "streams": streams, "log": log, "where": where,
            "tie_tol": LOGITS_TOL_FACTOR * e_bx, "dense": dense, "bounds": bounds,
            "first_err": first_err, "ms": ms, "wall": wall, "steps": len(log), "nb": nb}


def check_paged_world(label, got, refs) -> str:
    """A world's paged run (every rank's streams equal: spawn_world checked
    their digests) against phase 41's tp = 1 yardsticks: the streams equal
    or apart first at a near tie, each first token's logits within its
    bound of the dense prefill's; returns the line's part."""
    chose = lambda u, k: refs["log"][refs["where"][(u, k)][0]]["logits"][refs["where"][(u, k)][1]]
    flips = near_tie_flips(got["streams"], refs["streams"], chose, refs["tie_tol"])
    errs = []
    for u, (f_, d_, b_) in enumerate(zip(got["firsts"], refs["dense"], refs["bounds"])):
        e = errors(torch.as_tensor(f_).to(d_.device), d_)[0]
        if not e <= b_:
            raise AssertionError(f"{label} request {u} ({len(refs['prompts'][u])} tokens): first "
                                 f"token's logits {e:.3g} from the dense prefill's, above {b_:.3g}")
        errs.append(f"{e:.3g}")
    return (f"{label}: streams = tp 1's {got['streams'] == refs['streams']}"
            + (f" ({'; '.join(flips)})" if flips else "")
            + f", first tokens from the dense prefill {', '.join(errs)}")


def paged_tp_phase(card) -> None:
    """Phase 41: paged serving at tp = 4 and 2 (see the module docstring)."""
    bundle, exact = cut_glm(PAGED_TP_LAYERS)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    refs = paged_refs(bundle, exact, params)
    del params
    torch.cuda.empty_cache()
    PAGED_TP.update(refs)
    ranks = spawn_world(RING_TP, PAGED_TP_SETTINGS, target=paged_world_rank, args=(dict(
        layers=PAGED_TP_LAYERS, prompts=refs["prompts"]),))["ranks"]
    notes = []
    for name, kw in PAGED_TP_SETTINGS:
        tp = kw.get("tp", RING_TP)
        mine = [r_[name] for r_ in ranks]
        part = check_paged_world(name, mine[0], refs)
        stripes = mine[0]["stripes"]
        if any(m_["stripes"] != stripes for m_ in mine) or not all(x > 0 for x in stripes):
            raise AssertionError(f"{name}: stripe peaks {[m_['stripes'] for m_ in mine]}")
        ms = {k_: max(m_["ms"][k_] for m_ in mine) for k_ in mine[0]["ms"]}
        notes.append(f"{part}; {mine[0]['steps']} steps in {max(m_['wall'] for m_ in mine):.2f} "
                     f"s, each stripe's peak blocks {stripes} (of {refs['nb'] // tp}); ms a "
                     f"serve_step " + ", ".join(f"{k_} {v:.2f}" for k_, v in ms.items()))
    say(41, f"[{TP_LABEL.format(RING_TP)}] paged serving of full-width chatglm3-6b cut to "
            f"{PAGED_TP_LAYERS} layers (seed-0 weights), prompts of {list(PAGED_PROMPTS)} seeded "
            f"tokens x {PAGED_NEW} new, batch {PAGED_B}, chunk {PAGED_CHUNK}, {refs['nb']} blocks "
            f"of {PAGED_BLOCK} striped over the ranks; every rank's streams equal; tp = 1 bulk: "
            f"{refs['steps']} steps in {refs['wall']:.2f} s, first tokens from the dense prefill "
            + ", ".join(f"{e:.3g}" for e in refs["first_err"]) + " (bounds "
            + ", ".join(f"{b_:.3g}" for b_ in refs["bounds"]) + "), ms a serve_step "
            + ", ".join(f"{k_} {v:.2f}" for k_, v in refs["ms"].items()) + "; "
            + "; ".join(notes))


def paged_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 41's world: each setting's paged run over its stripe
    (tp = 2 on the pairs of the world), timed steps."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        world = {tp: dict(), 2: dict(group=pairs[rank // 2])}
        bundle, _ = cut_glm(inputs["layers"])
        res = {}
        for name, kw in settings:
            kw = dict(kw)
            t_ = kw.pop("tp", tp)
            c = ParallelContext(device=dev, tp=t_, fusion=FusionConfig(**kw), **world[t_])
            params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), c)
            serve = bundle.serve_step_fn(c)
            stripes = [0] * t_
            streams, firsts, log, _, eng, wall = paged_drive(bundle, params, serve,
                                                             inputs["prompts"], dev, t_, stripes)
            group = world[t_].get("group")
            ms = step_ms(serve, params, log, eng.pool, dev, lambda: dist.barrier(group=group))
            # numpy, not tensors: a tensor would be handed over through this
            # process's file descriptors, which close when it ends
            res[name] = {"streams": streams, "firsts": [f_.float().cpu().numpy() for f_ in firsts],
                         "stripes": stripes, "steps": len(log), "wall": wall, "ms": ms,
                         "digest": _digest([torch.tensor(sum(streams, []))]),
                         "finite": all(bool(torch.isfinite(f_).all()) for f_ in firsts)}
            del params, log, eng
            torch.cuda.empty_cache()
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


def decode_refs(bundle, exact, params) -> dict:
    """Phase 42's decode yardsticks: DATA_DECODE_STEPS teacher-forced steps
    of seeded tokens at batch 4 (per-slot positions), tp = 1 bulk and exact
    f32 logits."""
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    cfg = bundle.config
    gen = torch.Generator(device="cuda").manual_seed(42)
    tokens = [torch.randint(0, cfg.vocab, (4, 1), generator=gen, device="cuda")
              for _ in range(DATA_DECODE_STEPS)]
    pos = [torch.arange(4, device="cuda", dtype=torch.int32) * 3 + s
           for s in range(DATA_DECODE_STEPS)]
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    out = {}
    for name, b_, p_ in (("bulk", bundle, params),
                         ("exact", exact, _map(params, lambda t_: t_.float()))):
        dec, cache, logits = b_.decode_fn(ctx_b), b_.init_cache(4, "cuda"), []
        for tk, ps in zip(tokens, pos):
            lg, cache = dec(p_, tk, cache, ps)
            logits.append(lg)
        out[name] = torch.stack(logits)
        del cache
    return {"tokens": [t_.cpu() for t_ in tokens], "pos": [p_.cpu() for p_ in pos],
            "exact": out["exact"], "err_bx": errors(out["bulk"], out["exact"])[0]}


def data_axis_phase(card) -> dict:
    """Phase 42: the data axis (see the module docstring); returns the flash
    and fused rows' numbers at (4, 1)."""
    import shutil

    bundle, exact = cut_glm(DATA_LAYERS)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    dec = decode_refs(bundle, exact, params)
    kern = replica_kernels(params)
    del params
    torch.cuda.empty_cache()
    # phase 39's first DATA_STEPS batches and its tp = 1 losses on them
    want_steps = TRAIN_TP1["losses"][:DATA_STEPS]
    tex = TRAIN_EXACT
    try:
        ranks = spawn_world(RING_TP, DATA_SETTINGS, target=data_world_rank, args=(dict(
            layers=DATA_LAYERS, grad_layers=TRAIN_GRAD_LAYERS, step_layers=TRAIN_TP_LAYERS,
            tokens=dec["tokens"], pos=dec["pos"], prompts=PAGED_TP["prompts"],
            exact=str(tex["path"]), loss=tex["lx"], batch=tex["batch"],
            batches=TRAIN_TP1["batches"][:DATA_STEPS]),))["ranks"]
    finally:
        shutil.rmtree(Path(tex["path"]).parent, ignore_errors=True)
    notes, row = [], {}
    bound_dec = LOGITS_TOL_FACTOR * dec["err_bx"]
    for name, kw in DATA_SETTINGS:
        mine = [r_[name] for r_ in ranks]
        if kw["kind"] == "decode":
            e = max(errors(torch.as_tensor(m_["logits"]).to(dec["exact"].device), dec["exact"])[0]
                    for m_ in mine)
            if not e <= bound_dec:
                raise AssertionError(f"{name}: logits {e:.4g} from exact f32, above {bound_dec:.4g}")
            part = f"{name}: logits {e:.4g} from exact f32"
            if kw["mode"] == "kernel":
                want = DATA_LAYERS * DATA_DECODE_STEPS
                got = [(m_["launches"], m_["stream"]) for m_ in mine]
                if got != [(want, want)] * RING_TP:
                    raise AssertionError(f"{name}: fused launches (all, stream path) a rank {got}, "
                                         f"expected {want} each on the stream path")
                row["dp_decode_launches"] = [g_[0] for g_ in got]
                part += (f", fused_matmul_allreduce launches a rank {[g_[0] for g_ in got]}, all "
                         f"on the stream path at 1 row")
        elif kw["kind"] == "grads":
            loss_bound = LOGITS_TOL_FACTOR * abs(tex["lb"] - tex["lx"])
            if not mine[0]["loss_err"] <= loss_bound:
                raise AssertionError(f"{name}: loss {mine[0]['loss']:.6f} {mine[0]['loss_err']:.3g} "
                                     f"from exact f32, above {loss_bound:.3g}")
            worst = 0.0
            for i, n_ in enumerate(tex["names"]):
                e = max(m_["errs"][i] for m_ in mine)
                if not e <= LOGITS_TOL_FACTOR * tex["dist_b"][i]:
                    raise AssertionError(f"{name} gradient {n_}: {e:.3g} from exact f32, above "
                                         f"{LOGITS_TOL_FACTOR} x tp = 1 bulk's {tex['dist_b'][i]:.3g}")
                worst = max(worst, e / tex["dist_b"][i])
            want = [2 * TRAIN_GRAD_LAYERS if kw["mode"] == "kernel" else 0] * RING_TP
            if [m_["launches"] for m_ in mine] != want:
                raise AssertionError(f"{name}: flash launches a rank "
                                     f"{[m_['launches'] for m_ in mine]}, expected {want}")
            if kw["mode"] == "kernel":
                row["dp_train_launches"] = want
            shared = check_placed(f"{name} gradients", [m_["placed"] for m_ in mine])
            fwd, bwd, ar = (max(m_["ms"][i] for m_ in mine) for i in range(3))
            part = (f"{name} ({TRAIN_GRAD_LAYERS} layers, {TRAIN_LONG_B}x{TRAIN_LONG_S}, "
                    f"{TRAIN_LONG_B // kw['dp']} rows a replica): loss {mine[0]['loss']:.6f} "
                    f"({mine[0]['loss_err']:.3g} from exact), every shard within {worst:.3g} of "
                    f"its tp = 1 bulk distance, {shared} leaves held by several ranks "
                    f"bit-identical on them, flash launches a rank {want}; ms forward "
                    f"{fwd:.1f}, backward {bwd:.1f}, all-reduce {ar:.2f}")
        elif kw["kind"] == "paged":
            part = check_paged_world(name, mine[0], PAGED_TP) + (
                f"; {mine[0]['steps']} steps in {max(m_['wall'] for m_ in mine):.2f} s")
        else:
            got, want = mine[0]["losses"], want_steps
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            if any(m_["losses"] != got for m_ in mine) or not rel <= TRAIN_LOSS_REL:
                raise AssertionError(f"{name}: losses {[m_['losses'] for m_ in mine]} against "
                                     f"tp = 1's {want} (bound {TRAIN_LOSS_REL})")
            shared = check_placed(f"{name} parameters", [m_["placed"] for m_ in mine])
            last = [max(m_["split"][-1][i] for m_ in mine) for i in range(5)]
            data_ms = max(m_["data_ms"][-1] for m_ in mine)
            peak = max(m_["peak"] for m_ in mine)
            row.setdefault("dp_step_ms", {})[name] = last
            row.setdefault("dp_peak_gb", {})[name] = peak
            part = (f"{name}: losses {', '.join(f'{x:.5f}' for x in got)} ({rel:.3g} of tp = 1's "
                    f"at most), step {DATA_STEPS} {last[4]:.1f} ms = forward {last[0]:.1f} + "
                    f"backward {last[1]:.1f} + all-reduce {last[2]:.1f} + optimizer "
                    f"{last[3]:.1f} (slowest rank each), of which the data-axis collectives "
                    f"{data_ms:.1f} ms on the host clock, peak a rank {peak:.2f} GB, "
                    f"parameters and moments {sum(mine[0]['state_bytes']) / 1e9:.3f} GB a rank; "
                    f"{shared} parameter leaves held by several ranks bit-identical on them")
        notes.append(part)
    split_note = check_fsdp_split([r_["(2, 2) fused steps"] for r_ in ranks],
                                  [r_["(1, 2) fused steps"] for r_ in ranks], row["dp_peak_gb"])
    say(42, f"[{TP_LABEL.format(RING_TP)}] the data axis, full-width chatglm3-6b cut to "
            f"{DATA_LAYERS} layers (seed-0 weights; the gradients at {TRAIN_GRAD_LAYERS}): "
            f"decode of {DATA_DECODE_STEPS} teacher-forced steps at batch 4, bound "
            f"{bound_dec:.4g} ({LOGITS_TOL_FACTOR} x tp = 1 bulk's {dec['err_bx']:.4g}); paged "
            f"serving as phase 41; {DATA_STEPS} AdamW steps of {TRAIN_TP_LAYERS} layers at "
            f"{TRAIN_LONG_B}x{TRAIN_LONG_S} against phase 39's tp = 1 losses "
            f"{', '.join(f'{x:.5f}' for x in want_steps)}; every rank's logits, streams and "
            f"losses equal in each setting; {kern['note']}; " + "; ".join(notes)
            + f"; {split_note}")
    row.update(kern["row"])
    return row


def check_placed(what, placed) -> int:
    """Each leaf's digest equal on every rank that holds the same part of it
    (``placed``: each rank's [(place, digest)] a leaf); returns how many
    leaves' parts were held by more than one rank."""
    held = {}
    for mine in placed:
        for i, (place, dg) in enumerate(mine):
            held.setdefault((i, tuple(place)), []).append(dg)
    bad = sorted({i for (i, _), dgs in held.items() if len(set(dgs)) != 1})
    if bad:
        raise AssertionError(f"{what}: leaves {bad} differ between ranks that hold the same part")
    return len({i for (i, _), dgs in held.items() if len(dgs) > 1})


def check_fsdp_split(split, whole, peaks) -> str:
    """The fsdp split on the card: each rank's parameter and AdamW moment
    bytes a leaf at (2, 2) are the (1, 2) rank's over dp = 2 where the
    leaf's spec splits over data and equal elsewhere; and the (2, 2) peak
    lies below the (1, 2) one by at least the bytes the split saves (its
    gradients and its rows a replica halve too, so the peak drops by more;
    the bytes check is the one that sees the split alone)."""
    for r, (a, b) in enumerate(zip(split, whole)):
        want = [w_ // 2 if over else w_ for w_, over in zip(b["state_bytes"], a["over_data"])]
        if a["state_bytes"] != want:
            raise AssertionError(f"rank {r}: (2, 2) parameter and moment bytes a leaf "
                                 f"{a['state_bytes']}, expected {want} (the fsdp split of (1, 2)'s)")
    saved = (sum(whole[0]["state_bytes"]) - sum(split[0]["state_bytes"])) / 1e9
    drop = peaks["(1, 2) fused steps"] - peaks["(2, 2) fused steps"]
    if not drop >= saved:
        raise AssertionError(f"the (2, 2) world's peak {peaks['(2, 2) fused steps']:.2f} GB is "
                             f"{drop:.2f} GB below the (1, 2) world's, under the "
                             f"{saved:.3f} GB the fsdp split saves")
    return (f"the fsdp split: every leaf's (2, 2) parameter and moment bytes the (1, 2) rank's "
            f"over 2 where it splits over data, {saved:.3f} GB a rank saved; peak a rank "
            f"{peaks['(2, 2) fused steps']:.2f} GB against (1, 2)'s "
            f"{peaks['(1, 2) fused steps']:.2f}, {drop:.2f} GB lower (bound {saved:.3f})")


def replica_kernels(params) -> dict:
    """The two kernels at the shapes a (4, 1) replica gives them, against
    their plain versions on the same inputs: the fused GEMV+AllReduce kernel
    on one decode row ([1, 13696] bf16 @ layer 0's w_down: the stream path
    at one row a block) at BF16_TOL, and flash with statistics on one
    training row (chatglm3-6b's 32 query and 2 kv heads of 128 over
    TRAIN_LONG_S causal positions: the tile path), o at BF16_TOL and m, l
    at F32_TOL as phase 35 holds a hop."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref

    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(43)
    w = params["layers"][0]["ffn"]["w_down"]
    F, D = w.shape
    x = randn(gen, (1, F), bf16)
    got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, w))
    if took != "stream":
        raise AssertionError(f"fused [1,{F}]@[{F},{D}]: took the {took} path, not stream")
    fused = check_close(f"fused [1,{F}]@[{F},{D}] stream path", got,
                        fused_matmul_allreduce_ref(x, w), BF16_TOL)
    cfg = get_arch("chatglm3-6b").config
    q = randn(gen, (1, TRAIN_LONG_S, cfg.n_heads, cfg.hd), bf16)
    k, v = (randn(gen, (1, TRAIN_LONG_S, cfg.n_kv_heads, cfg.hd), bf16) for _ in range(2))
    kw = dict(scale=cfg.hd ** -0.5, causal=True)
    want = plain_by_heads(q, k, v, stats=True, **kw)
    (o, m, l), took = on_path(flash_attention, lambda: flash_attention(q, k, v, stats=True, **kw))
    if took != "tile":
        raise AssertionError(f"flash {tuple(q.shape)}: took the {took} path, not tile")
    flash = [check_close(f"flash {tuple(q.shape)} {n_}", a, b, t_)[0] for n_, a, b, t_ in (
        ("o", o, want[0], BF16_TOL), ("m", m, want[1], F32_TOL), ("l", l, want[2], F32_TOL))]
    return {"row": {"dp_row_err": list(fused), "dp_flash_err": flash},
            "note": (f"at a (4, 1) replica's shapes against the plain versions: "
                     f"fused_matmul_allreduce [1,{F}]@[{F},{D}] bf16 (layer 0's w_down) on the "
                     f"stream path, max abs/rel err {fused[0]:.3g}/{fused[1]:.3g} (bound "
                     f"{BF16_TOL}); flash_attention with statistics [1,{TRAIN_LONG_S},"
                     f"{cfg.n_heads}/{cfg.n_kv_heads},{cfg.hd}] causal on the tile path, max abs "
                     f"err o {flash[0]:.3g} (bound {BF16_TOL}), m {flash[1]:.3g}, l "
                     f"{flash[2]:.3g} (bound {F32_TOL})")}


def data_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 42's world of 4: each setting at its (dp, tp), the
    groups made on every rank in the same order."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import collectives as col
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.parallel.sharding import (FusionConfig, ParallelContext, make_world_groups,
                                               shard_leaf, splits_over_data, splits_over_tp)
    from repro_torch.train.optimizer import spec_leaves, tree_leaves

    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
        make_world_groups(2, 2)
        sync = lambda: torch.cuda.synchronize(dev)

        def placed(c, tensors, specs):
            """Each leaf's digest beside the part of the whole it is: the
            world (the pairs are two), the tp rank where it splits over tp,
            the data rank where it splits over data."""
            world = rank // (c.dp * c.tp)
            return [((world, c.tp_rank if splits_over_tp(sp) else None,
                      c.dp_rank if c.dp > 1 and splits_over_data(sp) else None), _digest([t_]))
                    for t_, sp in zip(tensors, specs)]

        def ctx(kw):
            extra = dict(group=pairs[rank // 2]) if (kw["dp"], kw["tp"]) == (1, 2) else {}
            return ParallelContext(device=dev, tp=kw["tp"], dp=kw["dp"],
                                   fusion=FusionConfig(mode=kw["mode"]), **extra)
        bundle, _ = cut_glm(inputs["layers"])
        grad_bundle, _ = cut_glm(inputs["grad_layers"])
        step_bundle, _ = cut_glm(inputs["step_layers"])
        real_on_wire, spent = col._on_wire, [0.0]
        res = {}
        for name, kw in settings:
            c = ctx(kw)
            if kw["kind"] == "decode":
                params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), c)
                dec, cache = bundle.decode_fn(c), bundle.init_cache(4, dev, c.tp, c.dp)
                reset_counts()
                logits = []
                for tk, ps in zip(inputs["tokens"], inputs["pos"]):
                    lg, cache = dec(params, tk.to(dev), cache, ps.to(dev))
                    logits.append(lg)
                logits = torch.stack(logits)
                res[name] = {"logits": logits.float().cpu().numpy(), "digest": _digest([logits]),
                             "finite": bool(torch.isfinite(logits).all()),
                             "launches": fused_matmul_allreduce.launches,
                             "stream": fused_matmul_allreduce.path_launches.get("stream", 0)}
                del params, cache
            elif kw["kind"] == "paged":
                params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), c)
                streams, firsts, log, _, eng, wall = paged_drive(
                    bundle, params, bundle.serve_step_fn(c), inputs["prompts"], dev, c.tp)
                res[name] = {"streams": streams,
                             "firsts": [f_.float().cpu().numpy() for f_ in firsts],
                             "steps": len(log), "wall": wall,
                             "digest": _digest([torch.tensor(sum(streams, []))]),
                             "finite": all(bool(torch.isfinite(f_).all()) for f_ in firsts)}
                del params, log, eng
            elif kw["kind"] == "grads":
                batch = {k: torch.as_tensor(v).to(dev) for k, v in inputs["batch"].items()}
                params = grad_bundle.init_params(torch.Generator(device=dev).manual_seed(0), c,
                                                 training=True)
                leaves = tree_leaves(params)
                for p_ in leaves:
                    p_.requires_grad_(True)
                specs = spec_leaves(grad_bundle.param_specs(params))
                exact = torch.load(inputs["exact"], mmap=True)
                want = [shard_leaf(g, sp, c, training=True).to(dev)
                        for g, sp in zip(exact.values(), specs)]
                del exact
                loss_fn = grad_bundle.loss_fn(c)
                flash_attention.launches = 0
                sync()
                t0 = time.perf_counter()
                loss = loss_fn(params, batch)
                sync()
                t1 = time.perf_counter()
                grads = list(torch.autograd.grad(loss, leaves))
                sync()
                t2 = time.perf_counter()
                all_reduce_grads(c, grads, specs)
                sync()
                t3 = time.perf_counter()
                res[name] = {"ms": ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3),
                             "launches": flash_attention.launches, "loss": loss.item(),
                             "loss_err": abs(loss.item() - inputs["loss"]),
                             "errs": [(g.float() - w_).abs().max().item()
                                      for g, w_ in zip(grads, want)],
                             "placed": placed(c, grads, specs),
                             "digest": _digest([loss.detach()]),
                             "finite": bool(torch.isfinite(loss)) and all(
                                 bool(torch.isfinite(g).all()) for g in grads)}
                del params, leaves, grads, want, loss
            else:
                batches = [{k: torch.as_tensor(v).to(dev) for k, v in b_.items()}
                           for b_ in inputs["batches"]]
                clock, per_step = EventClock(), []
                data = c.data if c.dp > 1 else None

                def timed(cx, op, ins, outs_):
                    """_on_wire, the data group's exchanges timed on the host."""
                    if cx is not data:
                        return real_on_wire(cx, op, ins, outs_)
                    t0 = time.perf_counter()
                    fin = real_on_wire(cx, op, ins, outs_)

                    def finish():
                        got = fin()
                        sync()
                        spent[0] += time.perf_counter() - t0
                        return got
                    return finish

                def mark(name_):
                    if name_ == "start":
                        spent[0] = 0.0
                    elif name_ == "optimizer":
                        per_step.append(spent[0] * 1e3)
                    clock(name_)
                torch.cuda.reset_peak_memory_stats(dev)
                col._on_wire = timed
                try:
                    losses, state, _ = train_steps(step_bundle, c, batches, mark)
                finally:
                    col._on_wire = real_on_wire
                leaves = tree_leaves(state["params"])
                specs = spec_leaves(step_bundle.param_specs(state["params"]))
                moments = [tree_leaves(state["opt"][k_]) for k_ in ("mu", "nu")]
                res[name] = {"losses": losses, "split": clock.split(), "data_ms": per_step,
                             "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
                             "placed": placed(c, leaves, specs),
                             "state_bytes": [sum(t_.nbytes for t_ in ts)
                                             for ts in zip(leaves, *moments, strict=True)],
                             "over_data": [splits_over_data(sp) for sp in specs],
                             "digest": _digest([torch.tensor(losses)]),
                             "finite": all(x == x and abs(x) < float("inf") for x in losses)}
                del state, leaves, moments
            torch.cuda.empty_cache()
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


def data_launcher_phase(card) -> None:
    """Phase 43: both launchers at --dp 2 --tp 2, one after the other in the
    pool's 4 processes, then phase 40's train launcher at --tp 2 (see the
    module docstring)."""
    # phase 40's flags at 2 steps: the warm-up's 5 steps keep the lr, and so
    # the losses, of phase 40's first 2 steps
    argv = list(TRAIN_TP_LAUNCH)
    argv[argv.index("--steps") + 1] = "2"
    t0 = time.perf_counter()
    train = pool_launchers([("train", ["--dp", "2", "--tp", "2", "--backend", "gloo", *argv],
                             4)])[0]
    serve = launcher_world_run("fused", ["--paged"], tp=2, dp=2)
    tp2 = pool_launchers([("train", TP2_TRAIN_ARGV, 2)])[0]
    wall = time.perf_counter() - t0
    tp2_line = tp2_train_check(tp2["out"], tp2["wall"])
    out = train["out"]
    got = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", out)]
    want = TRAIN_TP1["launcher_losses"][:2]
    if "all 4 ranks' losses equal: True" not in out:
        print(out[-4000:], file=sys.stderr)
        raise AssertionError("train launcher at dp=2 tp=2: the ranks' losses not checked equal")
    rel = max(abs(a - b) / abs(b) for a, b in zip(got, want)) if len(got) == len(want) else 1.0
    if not rel <= TRAIN_LOSS_REL:
        raise AssertionError(f"train launcher at dp=2 tp=2: losses {got} against tp = 1's {want}")
    step_s = re.findall(r"\(([\d.]+)s/step\)", out)
    notes = near_tie_notes("dp=2 tp=2 paged", serve["streams"])
    say(43, f"[{TP_LABEL.format(4)}] launch.train.main(--dp 2 --tp 2 --backend gloo "
            f"{' '.join(argv)}) in the pool's 4 processes: all 4 ranks' losses equal; losses "
            f"{', '.join(f'{x:.4f}' for x in got)} against tp = 1's "
            f"{', '.join(f'{x:.4f}' for x in want)} ({rel:.3g} of them at most, bound "
            f"{TRAIN_LOSS_REL}); {step_s[-1] if step_s else '?'} s a step on the host clock; "
            f"{train['wall']:.1f} s with init; then launch.serve.main(--dp 2 --tp 2 --paged "
            f"--fusion fused) (full width, 4 requests x 8 tokens, batch 4): all 4 ranks' "
            f"streams equal, {serve['ms_step']:.2f} ms/step ({serve['steps']} steps, "
            f"{serve['wall']:.1f} s with init), streams "
            f"{[serve['streams'][u] for u in sorted(serve['streams'])]}; = tp 1 kernel mode "
            f"(phase 5): {[serve['streams'][u] for u in sorted(serve['streams'])] == GLM_DECODE['streams']}"
            + (f" ({'; '.join(notes)})" if notes else "") + f"; then {tp2_line}; "
            f"{wall:.1f} s in all, no process started")


# ---------------------------------------------------------------------------
# MoE beyond one-card decode (phases 44-48)
# ---------------------------------------------------------------------------
# dbrx-132b's prefill of 4 x 2048 tokens: C = ceil(8192 x 4 x 1.25 / 16) =
# 2560 per expert; a prefill of 2 x 2048 has C = 1280, and phase 46's
# training microbatch of 1 x 2048 C = 640
DBRX_PRE_B, DBRX_PRE_S, DBRX_PRE_STEPS = 4, 2048, 8
MOE_PREFILL_CS = (2560, 1280, 640)
# the emulated 4-rank world at a prefill row: a rank of phase 47's tp = 4
# world (2 x 1024 tokens) holds 2 x 256 positions, C = 512 x 4 x 1.25 / 16
MOE_WORLD_C = 160
# phase 46: 2 layers (14.3 GB of bf16 parameters); the gradients at phase
# 26's 16 x 64 tokens (C = 320: the tile path), the registry's Adafactor
# with 2 microbatches at 2 x 2048, on the same batch each step so that the
# loss falls at the small lr full width needs (TRAIN_LR).  At 4 x 2048 (a
# microbatch's C = 1280) the step ran out of the
# card's 80 GB: the parameters, their f32 accumulators and a microbatch's
# bf16 gradients hold 57 GB before any activation
DBRX_TRAIN_LAYERS, DBRX_STEPS = 2, 4
DBRX_STEP_B = 2        # x DBRX_PRE_S tokens a step: 2 microbatches of 1 x 2048 (C = 640)
# the MoE layers of kernel mode against bulk mode on identical input: the
# kernel keeps h and g in f32, the plain einsums round them to bf16
# (REL_BF16, 2 % of the largest |output|)


class GateLog:
    """``models/moe._gates`` recorded or replayed in call order: recording
    (no ``gates``) keeps each call's top-k choice (gate_i), replaying hands
    ``gates[pos * stride + offset]`` back at the pos-th call, the gate
    weights taken from the replaying run's own router probabilities at those
    experts (as :func:`moe_routed` takes them).  A stream replayed on
    another stream's choices is teacher-forced on routing: a token at a near
    tie of its router goes to the same experts in both.  A rank of a world
    replays its block of a run recorded block by block (:func:`moe_in_blocks`:
    ``stride`` blocks a call, its own at ``offset``)."""

    def __init__(self, gates=None, stride=1, offset=0):
        self.gates = [] if gates is None else list(gates)
        self.replaying = gates is not None
        self.stride, self.offset = stride, offset
        self.pos = 0

    @contextlib.contextmanager
    def active(self):
        from repro_torch.models import moe as moe_mod

        kept = moe_mod._gates

        def gates(cfg, toks, w_r):
            if not self.replaying:
                gw, gi = kept(cfg, toks, w_r)
                self.gates.append(gi)
                return gw, gi
            gi = self.gates[self.pos * self.stride + self.offset].to(toks.device)
            self.pos += 1
            probs = torch.softmax(toks.float() @ w_r.float(), dim=-1)
            gw = probs.gather(1, gi)
            if cfg.norm_topk_prob:
                gw = gw / gw.sum(-1, keepdim=True).clamp_min(1e-9)
            return gw * cfg.router_scale, gi

        moe_mod._gates = gates
        try:
            yield self
        finally:
            moe_mod._gates = kept


def moe_in_blocks(moe_apply, n):
    """``moe_apply`` run on each of the ``n`` equal blocks of x's sequence
    on its own: the MoE layer of a tp = n world on one rank.  Each rank of
    the world routes its own positions, with the capacity of its own
    tokens, and its tokens' outputs depend on nothing else; where an expert
    overflows, one rank over the whole sequence drops other tokens, so the
    world's yardsticks run the layer this way."""
    def blocks(ctx, ffn, h, mcfg, **kw):
        s = h.shape[1] // n
        return torch.cat([moe_apply(ctx, ffn, h[:, i * s:(i + 1) * s], mcfg, **kw)
                          for i in range(n)], dim=1)
    return blocks


def moe_exact(ffn, h, mcfg, gate_i):
    """The MoE layer in exact f32 on the experts ``gate_i`` [T, K] chose:
    the gate weights from this input's router probabilities, the expert
    FFN one expert at a time (each expert's weights upcast while it runs:
    an f32 copy of dbrx's 16 experts is 12.7 GB a layer, of deepseek-v3's
    256 45.1 GB), an expert no token reached skipped (its rows are zero),
    and a shared expert's SwiGLU in f32 added."""
    import torch.nn.functional as F

    from repro_torch.models.moe import _capacity_slots, _dispatch_buf, _plus_shared, _unpermute

    toks = h.reshape(-1, mcfg.d_model).float()
    probs = torch.softmax(toks @ ffn["router"].float(), dim=-1)
    gate_w = probs.gather(1, gate_i)
    if mcfg.norm_topk_prob:
        gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    gate_w = gate_w * mcfg.router_scale
    e_clip, p_clip, valid, cap = _capacity_slots(mcfg, gate_i)
    buf = _dispatch_buf(mcfg, toks, e_clip, p_clip, valid, cap, torch.float32)
    out = torch.zeros_like(buf)
    for e in torch.unique(e_clip[valid]).tolist():
        g = buf[e] @ ffn["w_gate"][e].float()
        u = buf[e] @ ffn["w_up"][e].float()
        out[e] = (F.silu(g) * u) @ ffn["w_down"][e].float()
    y = _unpermute(mcfg, out, gate_w, e_clip, p_clip, valid, h.shape, torch.float32)
    shared = {"shared": _map(ffn["shared"], lambda t: t.float())} if "shared" in ffn else {}
    return _plus_shared(shared, h.float(), y, mcfg.act)


def exact_prefill(params, cfg, tokens, gates):
    """Last-position logits [B, 1, V] and the cache of a prefill in exact
    f32 (bulk mode's arithmetic, weights upcast one layer's attention and
    dense FFN and one expert at a time), the MoE layers on the experts
    ``gates`` recorded (one entry a MoE layer, in order)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.layers import embedding_lookup, mlp_apply, rms_norm
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    cfg_x = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    ctx = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    x = embedding_lookup(ctx, {"table": params["embed"]["table"].float()}, tokens,
                         seq_shard=True)
    positions = tfm._positions_for(ctx, cfg, {"tokens": tokens})
    parts, routed = {}, iter(gates)
    for lp, window in tfm.decoder_layers(params, cfg):
        la = {"ln1": lp["ln1"].float(), "attn": _map(lp["attn"], lambda t: t.float())}
        a, kv = tfm._attn_train(ctx, cfg_x, la, x, positions, window, collect_kv=True)
        x = x + a
        for k_, v_ in kv.items():
            parts.setdefault(k_, []).append(v_)
        del la, a, kv
        h = rms_norm(x, lp["ln2"].float(), cfg.norm_eps, plus_one=cfg.norm_plus_one)
        if "router" in lp["ffn"]:
            x = x + moe_exact(lp["ffn"], h, cfg.moe, next(routed))
        else:
            x = x + mlp_apply(ctx, _map(lp["ffn"], lambda t: t.float()), h, act=cfg.act,
                              seq_sharded=True)
    x = rms_norm(x[:, -1:], params["final_norm"].float(), cfg.norm_eps,
                 plus_one=cfg.norm_plus_one)
    return tfm._lm_logits(params, cfg_x, x), {k_: torch.stack(v_) for k_, v_ in parts.items()}


def moe_prefill_rows_phase(card, gen, params) -> dict:
    """Phase 44: the MoE kernels at prefill rows on phase 9's weights (layer
    0's experts): the expert FFN's tile path at C = 2560, 1280 and 640 against
    its plain version (REL_BF16), launches counted by path; the emulated
    4-rank world on the tile path at C = MOE_WORLD_C (3 calls back to back);
    the dispatch's VJP bit-identical to the kernel on the cotangent at the
    prefill's [1, 1, 16, 2560, 6144]; the tile path's times beside its bound
    and bulk mode's three einsums (the library call) in turns.  Returns the
    two MoE rows' prefill numbers."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
    from repro_torch.kernels.fused_gemm_a2a.ops import (fused_gemm_a2a, fused_gemm_a2a_ranks,
                                                        gemm_a2a_path)
    from repro_torch.kernels.fused_gemm_a2a.ref import (fused_gemm_a2a_ref,
                                                        fused_gemm_a2a_ref_ranks)

    bf16 = torch.bfloat16
    lp0 = params["layers"][0]["ffn"]
    wu, wg, wd = lp0["w_up"], lp0["w_gate"], lp0["w_down"]
    E, D, Fd = wu.shape
    errs, times, row = {}, {}, {}
    for cap in MOE_PREFILL_CS:
        xt = randn(gen, (1, 1, E, cap, D), bf16)
        if gemm_a2a_path(bf16, 1, 1, E, cap, D, Fd) != "tile":
            raise AssertionError(f"gemm_a2a_path at C={cap}: not the tile path")
        got, took = on_path(fused_gemm_a2a, lambda: fused_gemm_a2a(xt, wu, wg, wd))
        if took != "tile":
            raise AssertionError(f"fused_gemm_a2a at C={cap}: took the {took} path")
        errs[cap] = check_rel(f"fused_gemm_a2a tile C={cap}", got,
                              fused_gemm_a2a_ref(xt, wu, wg, wd, "silu"), REL_BF16)
        del got
        x0 = xt[0]
        bulk = lambda: torch.einsum(
            "necf,efd->necd", F.silu(torch.einsum("necd,edf->necf", x0, wg))
            * torch.einsum("necd,edf->necf", x0, wu), wd)
        turns = {"tile": [], "bulk": []}
        for which in ("tile", "bulk", "bulk", "tile"):
            fn = bulk if which == "bulk" else (lambda: fused_gemm_a2a(xt, wu, wg, wd))
            turns[which].append(time_ms(fn, iters=5, warmup=1))
        plain = time_ms(lambda: fused_gemm_a2a_ref(xt, wu, wg, wd, "silu"), iters=3, warmup=1)
        ops = 2 * 3 * E * cap * D * Fd
        nbytes = (2 * xt.numel() + wu.numel() + wg.numel() + wd.numel()) * xt.element_size()
        bound = max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        by = "operations" if ops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        times[cap] = dict(tile=min(turns["tile"]), bulk=min(turns["bulk"]), plain=plain,
                          bound=bound, by=by, turns=turns)
        del xt, x0
        torch.cuda.empty_cache()
    # the emulated world: rank r holds experts [4 r, 4 r + 4), views of layer 0's
    n = 4
    ws = [w.view(n, E // n, *w.shape[1:]) for w in (wu, wg, wd)]
    xs = randn(gen, (n, n, 1, E // n, MOE_WORLD_C, D), bf16)
    want = fused_gemm_a2a_ref_ranks(xs, *ws, "silu")
    world_err = 0.0
    for i in range(3):
        got, took = on_path(fused_gemm_a2a_ranks, lambda: fused_gemm_a2a_ranks(xs, *ws))
        if took != "tile":
            raise AssertionError(f"the emulated world at C={MOE_WORLD_C}: took the {took} path")
        world_err = max(world_err, check_rel(f"world tile call {i}", got, want, REL_BF16)[1])
    del xs, want, got
    # the dispatch's VJP: the kernel on the cotangent
    cap = MOE_PREFILL_CS[0]
    xd = randn(gen, (1, 1, E, cap, D), bf16).requires_grad_(True)
    cot = randn(gen, (1, 1, E, cap, D), bf16)
    before = fused_dispatch_a2a.launches
    gx, = torch.autograd.grad(fused_dispatch_a2a(xd, chunks_per_rank=2), xd, cot)
    if fused_dispatch_a2a.launches - before != 2:
        raise AssertionError("the dispatch's forward and VJP did not launch the kernel twice")
    if not torch.equal(gx, fused_dispatch_a2a(cot, chunks_per_rank=2)):
        raise AssertionError("the dispatch's VJP differs from the kernel on the cotangent")
    del xd, cot, gx
    torch.cuda.empty_cache()
    t_ = times[MOE_PREFILL_CS[0]]
    say(44, f"on {card}: the expert FFN at prefill rows with dbrx-132b's layer-0 experts "
            f"[{E},{D},{Fd}] bf16 on the tile path (tensor cores, two launches) vs plain, max "
            f"abs/rel err: " + ", ".join(f"C={c} {e[0]:.3g}/{e[1]:.3g}" for c, e in errs.items())
            + f" (bound {REL_BF16} rel); the emulated {n}-rank world on the tile path at "
            f"C={MOE_WORLD_C}, 3 calls: max rel err {world_err:.3g}; the dispatch's VJP at "
            f"[1,1,{E},{cap},{D}] bit-identical to the kernel on the cotangent; times (turns "
            f"tile, bulk, bulk, tile; CUDA events): "
            + "; ".join(f"C={c}: tile {', '.join(f'{v:.3f}' for v in tm['turns']['tile'])} ms, "
                        f"bulk einsums {', '.join(f'{v:.3f}' for v in tm['turns']['bulk'])} ms, "
                        f"plain {tm['plain']:.3f} ms, bound {tm['bound']:.3f} ms ({tm['by']}), "
                        f"tile at {tm['bound'] / tm['tile']:.2f} of the bound"
                        for c, tm in times.items()))
    row.update(tile_ms=t_["tile"], tile_plain_ms=t_["plain"], tile_bound_ms=t_["bound"],
               tile_bound_by=t_["by"], tile_library_ms=t_["bulk"],
               tile_max_abs_err=errs[MOE_PREFILL_CS[0]][0],
               tile_c1280_ms=times[1280]["tile"], tile_c1280_library_ms=times[1280]["bulk"],
               tile_c1280_bound_ms=times[1280]["bound"], tile_c640_ms=times[640]["tile"],
               tile_c640_library_ms=times[640]["bulk"], tile_c640_bound_ms=times[640]["bound"],
               tile_world_rel_err=world_err)
    return row


def dbrx_prefill_phase(card, gen, bundle, params) -> dict:
    """Phase 45: dbrx-132b (phase 9's 8 layers and weights) prefill of
    DBRX_PRE_B x DBRX_PRE_S seeded tokens through prefill_fn in kernel and
    bulk mode, then DBRX_PRE_STEPS greedy decode steps from the prefill's
    cache.  Gates: launches (kernel mode: a dispatch, a tile-path expert FFN
    and a flash launch a layer; bulk mode none), a second kernel prefill
    building no plan; every MoE layer's kernel output against bulk mode on
    its identical input within REL_BF16; the logits of kernel mode within
    LOGITS_TOL_FACTOR x bulk mode's distance from an exact f32 evaluation,
    the bulk and exact runs teacher-forced on the kernel run's routing
    (GateLog); decode: a dispatch and a stream-path FFN launch a layer and
    step, finite logits, tokens in range."""
    from repro_torch.kernels.fused_gemm_a2a import ops as ffn_ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    cfg = bundle.config
    L, B, S = cfg.n_layers, DBRX_PRE_B, DBRX_PRE_S
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(45))
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    seen = []

    def spy(ctx, ffn, h, mcfg, **kw):
        out = moe_apply(ctx, ffn, h, mcfg, **kw)
        seen.append((h, out))
        return out

    log = GateLog()
    torch.cuda.reset_peak_memory_stats()
    with log.active(), swapped(tfm, "moe_apply", spy):
        (lk, cache_k), counts = counted_run(
            lambda: bundle.prefill_fn(ctx_k)(params, {"tokens": tokens}),
            {"fused_dispatch_a2a": L, "fused_gemm_a2a": L, "fused_gemm_a2a.tile": L,
             "flash_attention": L})
    peak = torch.cuda.max_memory_allocated() / 1e9
    layer_rel = 0.0
    for i, (h, f) in enumerate(seen):
        layer_rel = max(layer_rel, check_rel(f"prefill MoE layer {i}: kernel vs bulk", f,
                                             moe_apply(ctx_b, params["layers"][i]["ffn"], h,
                                                       cfg.moe), REL_BF16)[1])
    del seen
    plans = len(ffn_ops._PLANS)
    ms = {}
    for mode, ctx in (("kernel", ctx_k), ("bulk", ctx_b)):
        replay = GateLog(log.gates)
        with replay.active():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, cache = bundle.prefill_fn(ctx)(params, {"tokens": tokens})
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
        if mode == "kernel":
            if len(ffn_ops._PLANS) != plans:
                raise AssertionError("a second kernel-mode prefill built expert-FFN plans")
        else:
            lb, cache_b = lg, cache
    lx, _ = exact_prefill(params, cfg, tokens, log.gates)
    torch.cuda.empty_cache()
    d_kx, d_bx, d_kb = errors(lk, lx)[0], errors(lb, lx)[0], errors(lk, lb)[0]
    if not (torch.isfinite(lk).all() and d_kx <= LOGITS_TOL_FACTOR * d_bx):
        raise AssertionError(f"dbrx prefill logits: kernel {d_kx:.3g} from exact f32, above "
                             f"{LOGITS_TOL_FACTOR} x bulk's {d_bx:.3g}")
    # the hand-off: DBRX_PRE_STEPS greedy steps from position S in a cache of
    # max_seq rows, kernel mode; bulk mode teacher-forced on its tokens
    def decode_cache(c):
        full = bundle.init_cache(B, "cuda")
        for k_ in ("k", "v"):
            full[k_][:, :, :S] = c[k_]
        return full

    caches = {"kernel": decode_cache(cache_k), "bulk": decode_cache(cache_b)}
    del cache_k, cache_b
    tok = lk.argmax(-1).to(torch.int32)
    dec = {m: bundle.decode_fn(c) for m, c in (("kernel", ctx_k), ("bulk", ctx_b))}
    d_dec, steps_tok = 0.0, []
    reset_counts()
    for s in range(DBRX_PRE_STEPS):
        pos = torch.full((B,), S + s, dtype=torch.int32, device="cuda")
        gk, caches["kernel"] = dec["kernel"](params, tok, caches["kernel"], pos)
        counts_k = launch_counts()
        gb, caches["bulk"] = dec["bulk"](params, tok, caches["bulk"], pos)
        if launch_counts() != counts_k:
            raise AssertionError("bulk-mode decode launched a kernel")
        if not torch.isfinite(gk).all():
            raise AssertionError(f"decode step {s}: non-finite logits")
        d_dec = max(d_dec, errors(gk, gb)[0])
        tok = gk.argmax(-1).to(torch.int32)
        steps_tok.append(tok[:, 0].tolist())
    counts_d = launch_counts()
    want = L * DBRX_PRE_STEPS
    if (counts_d["fused_dispatch_a2a"], counts_d["fused_gemm_a2a.stream"]) != (want, want):
        raise AssertionError(f"decode from the prefill: launches {counts_d}, expected {want} "
                             f"dispatch and stream-path FFN launches")
    if not all(0 <= t_ < cfg.vocab for st in steps_tok for t_ in st):
        raise AssertionError("decode from the prefill: a token out of range")
    del caches
    torch.cuda.empty_cache()
    say(45, f"on {card}: dbrx-132b ({L} of 40 layers, phase 9's weights) prefill of {B}x{S} "
            f"seeded tokens through prefill_fn: kernel mode launches dispatch "
            f"{counts['fused_dispatch_a2a']}, expert FFN {counts['fused_gemm_a2a']} (tile path "
            f"{counts['fused_gemm_a2a.tile']}), flash {counts['flash_attention']}; a second "
            f"kernel prefill built no plan ({plans} expert-FFN plans held); every MoE layer, "
            f"kernel vs bulk on identical input: max rel err {layer_rel:.3g} (bound {REL_BF16}); "
            f"last-position logits max abs err (bulk and exact teacher-forced on the kernel "
            f"run's routing): kernel vs exact f32 {d_kx:.3g}, bulk vs exact {d_bx:.3g} (bound "
            f"{LOGITS_TOL_FACTOR} x it), kernel vs bulk {d_kb:.3g}; prefill ms (host clock, "
            f"synchronised, routing replayed): kernel {ms['kernel']:.1f}, bulk {ms['bulk']:.1f}; "
            f"peak {peak:.1f} GB; {DBRX_PRE_STEPS} greedy decode steps from position {S} "
            f"(kernel mode, bulk teacher-forced on its tokens): dispatch "
            f"{counts_d['fused_dispatch_a2a']} and stream-path FFN "
            f"{counts_d['fused_gemm_a2a.stream']} launches (= {L} x {DBRX_PRE_STEPS}), logits "
            f"kernel vs bulk max abs {d_dec:.3g}, tokens {steps_tok}")
    return {"prefill_tile_launches": counts["fused_gemm_a2a.tile"],
            "prefill_dispatch_launches": counts["fused_dispatch_a2a"],
            "prefill_ms": ms["kernel"], "prefill_bulk_ms": ms["bulk"]}


def dbrx_train_phase(card) -> dict:
    """Phase 46: dbrx-132b cut to DBRX_TRAIN_LAYERS layers at full width on
    one card.  (a) The loss and every gradient at TRAIN_B x TRAIN_S tokens
    (LMBatches seed 0, weights seed 0) through loss_fn in kernel and bulk
    mode, each against an exact f32 evaluation, the bulk and exact runs
    teacher-forced on the kernel run's routing (forward and remat recompute,
    GateLog); kernel mode within LOGITS_TOL_FACTOR x bulk's distance on every
    leaf; kernel mode's launches (a dispatch and a tile-path expert FFN a
    layer, forward and recompute, and the dispatch's VJP a layer).  (b)
    DBRX_STEPS steps of the registry's Adafactor with 2 microbatches at
    DBRX_STEP_B x DBRX_PRE_S, lr TRAIN_LR, on one batch, in kernel and bulk mode from the seed-0 weights: finite losses,
    the last below the first, steps 2 on within TRAIN_LOSS_REL of bulk's;
    launches a step; ms a step split; peak memory."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import LMBatches
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves, tree_map, tree_paths
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    bundle = get_arch("dbrx-132b")
    cfg = dataclasses.replace(bundle.config, n_layers=DBRX_TRAIN_LAYERS)
    bundle = dataclasses.replace(bundle, config=cfg)
    L = cfg.n_layers
    init = lambda: bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    params = init()
    n_bytes = sum(t_.numel() * t_.element_size() for t_ in _leaves(params))
    names = [".".join(map(str, path)) for path, _ in tree_paths(params)]
    batch = to_device(next(LMBatches(cfg.vocab, TRAIN_B, TRAIN_S, 0)), "cuda")
    ctx = {m: ParallelContext(device="cuda", fusion=FusionConfig(mode=m))
           for m in ("kernel", "bulk")}
    # exact f32 first, recording its routing; the kernel and bulk runs are
    # teacher-forced on it, and the exact gradients stay on the card
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = tree_map(lambda t_: t_.detach().float().requires_grad_(True), params)
    del params
    torch.cuda.empty_cache()
    log = GateLog()
    with log.active():
        loss_x = exact.loss_fn(ctx["bulk"])(params_x, batch)
        grads_x = torch.autograd.grad(loss_x, tree_leaves(params_x))
    lx = loss_x.item()
    del params_x, loss_x
    torch.cuda.empty_cache()
    params = init()
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    want = {"kernel": {"fused_dispatch_a2a": 3 * L, "fused_gemm_a2a": 2 * L,
                       "fused_gemm_a2a.tile": 2 * L,
                       "flash_attention": 2 * L}, "bulk": {}}
    losses, dist = {}, {}
    for mode in ("kernel", "bulk"):
        with GateLog(log.gates).active():
            (loss, grads), counts = counted_run(
                lambda: (lambda l_: (l_.detach(), torch.autograd.grad(l_, leaves)))(
                    bundle.loss_fn(ctx[mode])(params, batch)), want[mode])
        if mode == "kernel":
            counts_g = counts
        losses[mode] = loss.item()
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"dbrx gradients in {mode} mode: non-finite")
        dist[mode] = [errors(g, gx)[0] for g, gx in zip(grads, grads_x)]
        del loss, grads
    del params, leaves, grads_x
    torch.cuda.empty_cache()
    worst, rows = 0.0, []
    for name, ek, eb in zip(names, dist["kernel"], dist["bulk"]):
        if not ek <= LOGITS_TOL_FACTOR * eb:
            raise AssertionError(f"dbrx gradient {name}: kernel mode {ek:.3g} from exact f32, "
                                 f"above {LOGITS_TOL_FACTOR} x bulk mode's {eb:.3g}")
        worst = max(worst, ek / max(eb, 1e-30))
        rows.append(f"{name} {ek:.3g}/{eb:.3g}")
    lk, lb = losses["kernel"], losses["bulk"]
    say(46, f"(a) gradients of {L} full-width dbrx-132b layers ({n_bytes / 1e9:.1f} GB bf16) at "
            f"{TRAIN_B}x{TRAIN_S} tokens (LMBatches seed 0, weights seed 0; C = "
            f"{-(-TRAIN_B * TRAIN_S * cfg.moe.top_k * 5 // (4 * cfg.moe.n_experts))}, tile path): "
            f"loss kernel {lk:.6f}, bulk {lb:.6f}, exact f32 {lx:.6f}; kernel-mode launches "
            f"dispatch {counts_g['fused_dispatch_a2a']} (forward, recompute, VJP), expert FFN "
            f"{counts_g['fused_gemm_a2a']} (tile {counts_g['fused_gemm_a2a.tile']}), flash "
            f"{counts_g['flash_attention']}; each leaf's max abs err from exact f32, "
            f"kernel/bulk (both teacher-forced on the exact run's routing; bound "
            f"{LOGITS_TOL_FACTOR} x bulk's; worst ratio {worst:.3g}): " + ", ".join(rows))

    # (b) Adafactor steps, 2 microbatches, one batch
    step_batch = to_device(next(LMBatches(cfg.vocab, DBRX_STEP_B, DBRX_PRE_S, 0)), "cuda")
    tc = TrainConfig(optimizer=OptimizerConfig(name=bundle.optimizer, lr=float(TRAIN_LR),
                                               warmup_steps=5, total_steps=DBRX_STEPS),
                     microbatches=bundle.microbatches)
    runs = {}
    for mode in ("kernel", "bulk"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(tc, init())
        clock = StepClock(profile_step=DBRX_STEPS)
        step = build_train_step(bundle.loss_fn(ctx[mode]), tc, on_phase=clock)
        losses, per_step = [], []
        for _ in range(DBRX_STEPS):
            reset_counts()
            state, m = step(state, step_batch)
            losses.append(m["loss"].item())
            per_step.append(launch_counts())
        del state, step
        runs[mode] = dict(losses=losses, counts=per_step[-1], split=clock.split(),
                          busy=clock.busy, peak=torch.cuda.max_memory_allocated() / 1e9)
    k_, b_ = runs["kernel"], runs["bulk"]
    if not all(x == x and abs(x) < float("inf") for x in k_["losses"] + b_["losses"]):
        raise AssertionError(f"dbrx Adafactor steps: non-finite losses {k_['losses']}, "
                             f"{b_['losses']}")
    if not k_["losses"][-1] < k_["losses"][0]:
        raise AssertionError(f"dbrx Adafactor steps: the loss did not fall: {k_['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(k_["losses"][1:], b_["losses"][1:]))
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"dbrx Adafactor steps 2-{DBRX_STEPS}: kernel losses "
                             f"{k_['losses']} {rel:.3g} from bulk's {b_['losses']}")
    want = {"fused_dispatch_a2a": 6 * L, "fused_gemm_a2a.tile": 4 * L, "flash_attention": 4 * L}
    got = {n_: k_["counts"][n_] for n_ in want}
    if got != want or any(b_["counts"][n_] for n_ in want):
        raise AssertionError(f"dbrx Adafactor step launches: kernel {got}, expected {want}; bulk "
                             f"{ {n_: b_['counts'][n_] for n_ in want} }")
    tokens = DBRX_STEP_B * DBRX_PRE_S

    def summary(r):
        later = r["split"][1:]
        med = sorted(later, key=lambda x: x[3])[len(later) // 2]
        dev, wall, ops = r["busy"]
        return (f"losses {', '.join(f'{x:.5f}' for x in r['losses'])}; step (median of 2-"
                f"{DBRX_STEPS}) {med[3]:.1f} ms = forward {med[0]:.1f} + backward {med[1]:.1f} "
                f"+ optimizer {med[2]:.1f}, {tokens / med[3] * 1e3:.0f} tok/s; device busy "
                f"{100 * dev / wall:.1f}% of step {DBRX_STEPS}'s {wall:.1f} ms under the "
                f"profiler; peak {r['peak']:.1f} GB"), med
    sk, mk = summary(k_)
    sb, mb = summary(b_)
    micro_c = -(-(tokens // bundle.microbatches) * cfg.moe.top_k * 5 // (4 * cfg.moe.n_experts))
    say(46, f"(b) on {card}: {DBRX_STEPS} steps of {bundle.optimizer} with "
            f"{bundle.microbatches} microbatches (C = {micro_c} each) at {DBRX_STEP_B}x{DBRX_PRE_S} "
            f"tokens (one LMBatches batch, lr {TRAIN_LR}): kernel mode {sk}; bulk mode {sb}; "
            f"steps 2-{DBRX_STEPS} within {rel:.3g} of bulk's (bound {TRAIN_LOSS_REL}); "
            f"kernel-mode launches a step: dispatch {got['fused_dispatch_a2a']}, tile-path "
            f"expert FFN {got['fused_gemm_a2a.tile']}, flash {got['flash_attention']}")
    return {"train_tile_launches_per_step": got["fused_gemm_a2a.tile"],
            "train_dispatch_launches_per_step": got["fused_dispatch_a2a"],
            "train_step_ms": mk[3], "train_bulk_step_ms": mb[3]}


# Phase 47: dbrx-132b at full width cut to WORLD_LAYERS layers over gloo
# worlds of 4 processes on the one card: WORLD_B x WORLD_S tokens (a
# replica's row at (2, 2) is 1 x 1024), decode
# at batch WORLD_DEC_B.  The (2, 2) steps take one microbatch (two would
# keep an f32 gradient accumulator a rank beside the gathered experts: 4
# ranks x about 15 GB already); the tp = 1 yardstick steps take the same.
WORLD_LAYERS, WORLD_B, WORLD_S = 2, 2, 1024
WORLD_DEC_B, WORLD_DEC_STEPS, WORLD_STEPS = 4, 4, 1
# the (2, 2) Adafactor steps run on the first WORLD_STEP_LAYERS layers: at
# 2 layers a step took 37 s, at 1 layer 20 s (each rank gathers 3.2 GB of
# expert weights a layer over data through host memory, forward, recompute
# and backward); the loss after the last step is a forward's
WORLD_STEP_LAYERS = 1
GRAD_SAMPLES = 1 << 16     # elements of each gradient held to exact f32
WORLD_SETTINGS = [("tp 4 bulk", dict(mode="bulk")), ("tp 4 fused", dict(mode="fused")),
                  ("tp 4 fused skew 1", dict(mode="fused", skew=1))]


def sample_coords(shape, n, seed):
    """n seeded element coordinates [n, ndim] of a tensor of ``shape``."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randint(0, s, (n,), generator=g) for s in shape], dim=1)


def shard_sample(coords, shape, spec, place):
    """Which of the whole tensor's ``coords`` lie in the training shard of
    ``place`` (tp, tp_rank, dp, dp_rank) under ``spec``, and their
    coordinates in it: (mask [n], local coords [n, ndim])."""
    from repro_torch.parallel.sharding import split_dims

    mask = torch.ones(len(coords), dtype=torch.bool)
    local = coords.clone()
    for dim, n, r in split_dims(spec, place, training=True):
        size = shape[dim] // n
        mask &= (coords[:, dim] >= r * size) & (coords[:, dim] < (r + 1) * size)
        local[:, dim] -= r * size
    return mask, local


def dbrx_world_phase(card) -> dict:
    """Phase 47: the MoE All-to-Alls over worlds of gloo processes on the
    card, dbrx-132b cut to WORLD_LAYERS layers at full width.  Here first,
    at tp = 1 from the seed-0 weights: an exact f32 evaluation (prefill
    logits, the loss and WORLD_DEC_STEPS decode steps recording their
    routing, GRAD_SAMPLES seeded elements of every gradient) and bulk mode
    teacher-forced on that routing (its distances from exact f32 are the
    bounds' yardsticks), then WORLD_STEPS Adafactor step(s) in bulk mode
    (on WORLD_STEP_LAYERS layers) and a forward for the loss after them.
    Then one world of 4 ranks, every run teacher-forced on the exact run's
    routing (each rank its tokens' share): tp = 4 prefill and loss with
    gradients in bulk and fused mode (skew 0 and 1), (2, 2) decode EP and
    WORLD_STEPS Adafactor step(s) over shards and the forward after them
    (not forced).  Gates: the logits
    and every sampled gradient element within LOGITS_TOL_FACTOR x tp = 1
    bulk's distance from exact f32, the loss too; every rank's logits and
    loss equal, the whole leaves' gradients bit-identical across the ranks;
    skew 1 bit-identical to skew 0 (every leaf but the table, whose
    scatter-adds are atomics); decode EP's logits the same on every rank
    and within the bound; the (2, 2) losses within TRAIN_LOSS_REL of tp =
    1's, the loss falling."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import LMBatches
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves, tree_map, tree_paths
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state
    import numpy as np

    bundle = get_arch("dbrx-132b")
    cfg = dataclasses.replace(bundle.config, n_layers=WORLD_LAYERS)
    bundle = dataclasses.replace(bundle, config=cfg)
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    init = lambda: bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch_np = next(LMBatches(cfg.vocab, WORLD_B, WORLD_S, 0))
    batch = to_device(batch_np, "cuda")
    dec_np = np.random.default_rng(47).integers(0, cfg.vocab, (WORLD_DEC_STEPS, WORLD_DEC_B, 1))
    dec_tok = torch.as_tensor(dec_np, dtype=torch.int32, device="cuda")
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))

    def decode_run(b_, params, gates):
        dec, cache, out = b_.decode_fn(ctx_b), b_.init_cache(WORLD_DEC_B, "cuda"), []
        with gates.active():
            for s in range(WORLD_DEC_STEPS):
                pos = torch.full((WORLD_DEC_B,), s, dtype=torch.int32, device="cuda")
                lg, cache = dec(params, dec_tok[s], cache, pos)
                out.append(lg)
        return torch.stack(out)

    # exact f32, recording the routing
    params = init()
    names = [".".join(map(str, p_)) for p_, _ in tree_paths(params)]
    shapes = [tuple(t_.shape) for t_ in tree_leaves(params)]
    specs = [tuple(s_) for s_ in spec_leaves_of(bundle, params)]
    params_x = tree_map(lambda t_: t_.detach().float().requires_grad_(True), params)
    del params
    torch.cuda.empty_cache()
    g_pre, g_tr, g_dec = GateLog(), GateLog(), GateLog()
    # the prefill and the loss with the MoE layers of the tp = 4 world
    blocks = lambda: swapped(tfm, "moe_apply", moe_in_blocks(tfm.moe_apply, RING_TP))
    with torch.no_grad(), g_pre.active(), blocks():
        lx_pre = exact.prefill_fn(ctx_b)(params_x, {"tokens": batch["tokens"]})[0]
    with g_tr.active(), blocks():
        loss_x = exact.loss_fn(ctx_b)(params_x, batch)
        grads_x = torch.autograd.grad(loss_x, tree_leaves(params_x))
    coords = [sample_coords(sh, min(GRAD_SAMPLES, int(np.prod(sh))), i)
              for i, sh in enumerate(shapes)]
    vals_x = [g[tuple(c.cuda().T)].cpu() for g, c in zip(grads_x, coords)]
    del grads_x
    with torch.no_grad():
        lx_dec = decode_run(exact, params_x, g_dec)
    lx = loss_x.item()
    del params_x, loss_x
    torch.cuda.empty_cache()
    # tp = 1 bulk, teacher-forced
    params = init()
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    with torch.no_grad(), GateLog(g_pre.gates).active(), blocks():
        lb_pre = bundle.prefill_fn(ctx_b)(params, {"tokens": batch["tokens"]})[0]
    with GateLog(g_tr.gates).active(), blocks():
        loss_b = bundle.loss_fn(ctx_b)(params, batch)
        dist_b = [(g[tuple(c.cuda().T)].cpu().float() - v).abs().max().item()
                  for g, c, v in zip(torch.autograd.grad(loss_b, leaves), coords, vals_x)]
    with torch.no_grad():
        lb_dec = decode_run(bundle, params, GateLog(g_dec.gates))
    d_pre, d_dec = errors(lb_pre, lx_pre)[0], errors(lb_dec, lx_dec)[0]
    lb = loss_b.item()
    del params, leaves, loss_b
    torch.cuda.empty_cache()
    # tp = 1 bulk Adafactor steps, one microbatch, on WORLD_STEP_LAYERS layers
    step_bundle = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, n_layers=WORLD_STEP_LAYERS))
    tc = TrainConfig(optimizer=OptimizerConfig(name=bundle.optimizer, lr=float(TRAIN_LR),
                                               warmup_steps=5, total_steps=WORLD_STEPS))
    state = init_train_state(tc, step_bundle.init_params(
        torch.Generator(device="cuda").manual_seed(0)))
    step = build_train_step(step_bundle.loss_fn(ctx_b), tc)
    losses_1 = []
    for _ in range(WORLD_STEPS):
        state, m = step(state, batch)
        losses_1.append(m["loss"].item())
    with torch.no_grad():
        losses_1.append(step_bundle.loss_fn(ctx_b)(state["params"], batch).item())
    del state, step, batch
    torch.cuda.empty_cache()
    inputs = dict(layers=WORLD_LAYERS, step_layers=WORLD_STEP_LAYERS, batch=batch_np, dec=dec_np,
                  gates=[[g.cpu() for g in log_.gates] for log_ in (g_pre, g_tr, g_dec)],
                  exact_pre=lx_pre.cpu(), exact_dec=lx_dec.cpu(), loss_x=lx, coords=coords,
                  vals=vals_x, shapes=shapes, specs=specs, names=names)
    t0 = time.perf_counter()
    got = spawn_world(RING_TP, WORLD_SETTINGS + [("(2, 2) decode EP", {})],
                      target=dbrx_world_rank, args=(inputs,))
    wall = time.perf_counter() - t0
    ranks = got["ranks"]
    notes = []
    for name, _ in WORLD_SETTINGS:
        mine = [r_[name] for r_ in ranks]
        if mine[0]["pre_err"] > LOGITS_TOL_FACTOR * d_pre:
            raise AssertionError(f"{name}: prefill logits {mine[0]['pre_err']:.3g} from exact "
                                 f"f32, above {LOGITS_TOL_FACTOR} x tp = 1 bulk's {d_pre:.3g}")
        if mine[0]["loss_err"] > LOGITS_TOL_FACTOR * abs(lb - lx):
            raise AssertionError(f"{name}: loss {mine[0]['loss']:.6f} is "
                                 f"{mine[0]['loss_err']:.3g} from exact f32 {lx:.6f}")
        if len({m_["loss_digest"] for m_ in mine}) != 1:
            raise AssertionError(f"{name}: the ranks' losses differ")
        if len({m_["whole_digest"] for m_ in mine}) != 1:
            raise AssertionError(f"{name}: the whole leaves' gradients differ across the ranks")
        worst = 0.0
        for i, n_ in enumerate(names):
            e = max(m_["errs"][i] for m_ in mine)
            if not e <= LOGITS_TOL_FACTOR * dist_b[i]:
                raise AssertionError(f"{name} gradient {n_}: {e:.3g} from exact f32 (sampled), "
                                     f"above {LOGITS_TOL_FACTOR} x tp = 1 bulk's {dist_b[i]:.3g}")
            worst = max(worst, e / max(dist_b[i], 1e-30))
        notes.append(f"{name}: prefill logits {mine[0]['pre_err']:.3g} from exact, loss "
                     f"{mine[0]['loss']:.6f}, worst leaf at {worst:.3g} of its bulk distance, ms "
                     f"prefill {max(m_['ms'][0] for m_ in mine):.0f}, loss forward "
                     f"{max(m_['ms'][1] for m_ in mine):.0f}, backward "
                     f"{max(m_['ms'][2] for m_ in mine):.0f} (slowest rank)")
    # every leaf's gradient but the table's (its scatter-adds are atomics),
    # compared bit for bit in each rank
    for r_ in ranks:
        if not r_["tp 4 fused skew 1"]["skew_equal"]:
            raise AssertionError("tp = 4: skew 1's logits or gradients are not skew 0's bits")
    dec = [r_["(2, 2) decode EP"] for r_ in ranks]
    if dec[0]["dec_err"] > LOGITS_TOL_FACTOR * d_dec:
        raise AssertionError(f"(2, 2) decode EP: logits {dec[0]['dec_err']:.3g} from exact f32, "
                             f"above {LOGITS_TOL_FACTOR} x tp = 1 bulk's {d_dec:.3g}")
    if len({d_["digest"] for d_ in dec}) != 1:
        raise AssertionError("(2, 2) decode EP: the ranks' logits differ")
    losses = dec[0]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(losses, losses_1))
    if rel > TRAIN_LOSS_REL or any(d_["losses"] != losses for d_ in dec):
        raise AssertionError(f"(2, 2) Adafactor steps: losses {[d_['losses'] for d_ in dec]} "
                             f"against tp = 1's {losses_1}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(2, 2) Adafactor steps: the loss did not fall: {losses}")
    say(47, f"[{TP_LABEL.format(RING_TP)}] dbrx-132b ({WORLD_LAYERS} full-width layers, seed-0 "
            f"weights) at {WORLD_B}x{WORLD_S} tokens (LMBatches seed 0), teacher-forced on "
            f"the exact f32 run's routing: tp = 1 exact loss {lx:.6f}, bulk {lb:.6f}; tp = 1 "
            f"bulk's distances from exact f32 (the bounds are {LOGITS_TOL_FACTOR} x them): "
            f"prefill logits {d_pre:.3g}, decode logits {d_dec:.3g}, each leaf's "
            f"{GRAD_SAMPLES} sampled gradient elements "
            + ", ".join(f"{n_} {d_:.3g}" for n_, d_ in zip(names, dist_b)) + "; "
            + "; ".join(notes) + f"; skew 1 bit-identical to skew 0 (logits and every "
            f"gradient but the table's); (2, 2) decode EP "
            f"{WORLD_DEC_STEPS} steps at batch {WORLD_DEC_B}: logits {dec[0]['dec_err']:.3g} "
            f"from exact, every rank's equal, ms a step {max(d_['dec_ms'] for d_ in dec):.0f}; "
            f"(2, 2) {bundle.optimizer} over shards, {WORLD_STEPS} step(s) of "
            f"{WORLD_STEP_LAYERS} layer(s): losses (the last a forward after the last step) "
            f"{', '.join(f'{x:.5f}' for x in losses)} against tp = 1's "
            f"{', '.join(f'{x:.5f}' for x in losses_1)} ({rel:.3g} apart, bound "
            f"{TRAIN_LOSS_REL}), ms a step {max(max(d_['step_ms']) for d_ in dec):.0f}; peak a "
            f"rank {max(d_['peak'] for d_ in dec):.1f} GB; the world {wall:.0f} s")
    return {}


def spec_leaves_of(bundle, params):
    from repro_torch.train.optimizer import spec_leaves

    return spec_leaves(bundle.param_specs(params))


def dbrx_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 47's world of 4 (the tp = 4 world, and the (2, 2)
    world of the same processes)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext, make_world_groups
    from repro_torch.parallel.sharding import splits_over_tp
    from repro_torch.train.optimizer import OptimizerConfig, spec_leaves, tree_leaves
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        make_world_groups(2, 2)
        bundle = get_arch("dbrx-132b")
        bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_layers=inputs["layers"]))
        sync = lambda: torch.cuda.synchronize(dev)
        gen = lambda: torch.Generator(device=dev).manual_seed(0)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in inputs["batch"].items()}
        g_pre, g_tr, g_dec = inputs["gates"]
        res = {}
        c0 = ParallelContext(device=dev, tp=tp, fusion=FusionConfig(mode="bulk"))
        params = bundle.init_params(gen(), c0)
        leaves = tree_leaves(params)
        for p_ in leaves:
            p_.requires_grad_(True)
        specs = spec_leaves(bundle.param_specs(params))
        whole = [not splits_over_tp(sp) for sp in specs]
        where = [shard_sample(c_, sh, sp, c0) for c_, sh, sp in
                 zip(inputs["coords"], inputs["shapes"], inputs["specs"])]
        for name, kw in settings:
            if not name.startswith("tp 4"):
                continue
            c = ParallelContext(device=dev, tp=tp, fusion=FusionConfig(**kw))
            sync()
            t0 = time.perf_counter()
            with torch.no_grad(), GateLog(g_pre, tp, rank).active():
                logits = bundle.prefill_fn(c)(params, {"tokens": batch["tokens"]})[0]
            sync()
            t1 = time.perf_counter()
            with GateLog(g_tr, tp, rank).active():
                loss = bundle.loss_fn(c)(params, batch)
                sync()
                t2 = time.perf_counter()
                grads = list(torch.autograd.grad(loss, leaves))
            all_reduce_grads(c, grads, specs)
            sync()
            t3 = time.perf_counter()
            errs = []
            for g, (mask, loc), v in zip(grads, where, inputs["vals"]):
                idx = tuple(loc[mask].to(dev).T)
                errs.append((g[idx].float().cpu() - v[mask]).abs().max().item()
                            if mask.any() else 0.0)
            res[name] = {"ms": ((t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3),
                         "pre_err": errors(logits.cpu(), inputs["exact_pre"])[0],
                         "digest": _digest([logits]), "loss": loss.item(),
                         "loss_err": abs(loss.item() - inputs["loss_x"]),
                         "loss_digest": _digest([loss]), "errs": errs,
                         "whole_digest": _digest([g for g, w_ in zip(grads, whole) if w_]),
                         "finite": bool(torch.isfinite(logits).all())}
            # skew 1 against skew 0 on the card, bit for bit: the logits and
            # every gradient but the table's, whose rows gather scatter-adds
            # (index_add_) in the order of the card's atomics (hashing the
            # gradients on the host took seconds a setting)
            mine = [logits] + [g for g, n_ in zip(grads, inputs["names"]) if n_ != "embed.table"]
            if name == "tp 4 fused":
                skew0 = mine
            elif name == "tp 4 fused skew 1":
                res[name]["skew_equal"] = all(torch.equal(a, b) for a, b in zip(skew0, mine))
                del skew0
            del logits, loss, grads, mine
        del params, leaves
        torch.cuda.empty_cache()
        # (2, 2): decode EP on the serving shards, then Adafactor over the
        # training shards
        c22 = ParallelContext(device=dev, tp=2, dp=2, fusion=FusionConfig(mode="fused"))
        params = bundle.init_params(gen(), c22)
        dec, cache = bundle.decode_fn(c22), bundle.init_cache(len(inputs["dec"][0]), dev, 2, 2)
        logits, ms = [], []
        with torch.no_grad(), GateLog(g_dec).active():
            for s, tok in enumerate(inputs["dec"]):
                tok = torch.as_tensor(tok, dtype=torch.int32, device=dev)
                pos = torch.full((tok.shape[0],), s, dtype=torch.int32, device=dev)
                sync()
                t0 = time.perf_counter()
                lg, cache = dec(params, tok, cache, pos)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
                logits.append(lg)
        logits = torch.stack(logits)
        del params, cache
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        step_bundle = dataclasses.replace(bundle, config=dataclasses.replace(
            bundle.config, n_layers=inputs["step_layers"]))
        params = step_bundle.init_params(gen(), c22, training=True)
        tc = TrainConfig(optimizer=OptimizerConfig(name=bundle.optimizer, lr=float(TRAIN_LR),
                                                   warmup_steps=5, total_steps=WORLD_STEPS))
        step = build_train_step(step_bundle.loss_fn(c22), tc, ctx=c22,
                                param_specs=step_bundle.param_specs(params))
        state = init_train_state(tc, params)
        losses, step_ms = [], []
        for _ in range(WORLD_STEPS):
            sync()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(m["loss"].item())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        with torch.no_grad():
            losses.append(step_bundle.loss_fn(c22)(state["params"], batch).item())
        res["(2, 2) decode EP"] = {
            "dec_err": errors(logits.cpu(), inputs["exact_dec"])[0], "digest": _digest([logits]),
            "dec_ms": sorted(ms)[len(ms) // 2], "losses": losses, "step_ms": step_ms,
            "peak": torch.cuda.max_memory_allocated(dev) / 1e9,
            "finite": bool(torch.isfinite(logits).all())}
        del state, step, params
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


def dbrx_launcher_phase(card) -> None:
    """Phase 48: the launchers with dbrx-132b at tp = 2, each in 2 of the
    pool's processes, both at once (gloo, fused mode, full width cut to
    WORLD_LAYERS layers): train (1 step at 2 x 1024; every rank's loss
    equal, finite) and serve (4 requests x 8 tokens through decode EP; every
    rank's streams equal)."""
    common = ["--arch", "dbrx-132b", "--tp", "2", "--layers", str(WORLD_LAYERS), "--backend",
              "gloo", "--fusion", "fused"]
    train, serve = pool_launchers([
        ("train", common + ["--steps", "1", "--batch", "2", "--seq", "1024", "--lr", TRAIN_LR,
                            "--log-every", "1"], 2),
        ("serve", common + ["--requests", "4", "--batch", "4", "--max-new", "8"], 2)])
    for what, run, ok in (("train", train, "all 2 ranks' losses equal: True"),
                          ("serve", serve, "all 2 ranks' token streams equal: True")):
        if ok not in run["out"]:
            print(run["out"][-4000:], file=sys.stderr)
            raise AssertionError(f"the {what} launcher at --tp 2: {ok!r} not said")
    losses = [float(x) for x in re.findall(r"step +\d+ loss ([\d.]+)", train["out"])]
    if len(losses) != 1 or not all(x == x and abs(x) < float("inf") for x in losses):
        raise AssertionError(f"the train launcher's losses: {losses}")
    served = re.search(r"served .*", serve["out"])
    streams = re.findall(r"req \d+: prompt .* -> \[.*\]", serve["out"])
    say(48, f"[{TP_LABEL.format(2)}] the launchers with --arch dbrx-132b --tp 2 --layers "
            f"{WORLD_LAYERS} --backend gloo --fusion fused, each main() in 2 of the pool's "
            f"processes: train 1 step at 2x1024, loss {', '.join(f'{x:.4f}' for x in losses)}, "
            f"both ranks' equal ({train['wall']:.0f} s with init, both launchers at once); "
            f"serve (decode EP): {served[0] if served else '?'}, both ranks' streams equal, "
            f"{streams} ({serve['wall']:.0f} s with init)")


# DLRM training and its world (phases 49-51), at the paper's widths (tables of
# 1,000,000 x 92 f32, MLPs (512, 256, 92) and (682, 682, 682, 1), pooling 70,
# the reference's train_8k batch of 8192), only the table count cut: phase 49
# trains 32 of the 512 tables (11.78 GB, one rank's share of a 16-rank world;
# with the gradient and AdamW's two moments 47.1 GB before the optimizer's
# temporaries), phase 50's (2, 2) world holds 16 (4 a rank), phase 51's
# launcher 32.  DLRM_LR: at the launcher's default 3e-3 a reduced-vocabulary
# run's third step rose (its Adam steps move every MLP weight at once); the
# steps take 1e-3.
DLRM_TRAIN_TABLES, DLRM_WORLD_TABLES = 32, 16
DLRM_STEPS, DLRM_LR, DLRM_WORLD_Q = 3, "1e-3", 2
DLRM_WORLD_SETTINGS = [
    ("bulk", dict(mode="bulk")),
    ("fused q 2", dict(mode="fused", granularity=DLRM_WORLD_Q)),
    ("fused q 2 skew 1", dict(mode="fused", granularity=DLRM_WORLD_Q, skew_world=1)),
    ("fused q 2 bf16 wire", dict(mode="fused", granularity=DLRM_WORLD_Q, wire="bf16")),
    ("kernel q 2", dict(mode="kernel", granularity=DLRM_WORLD_Q)),
    ("grad bulk", dict(mode="bulk")),
    ("grad fused q 2", dict(mode="fused", granularity=DLRM_WORLD_Q)),
    ("grad fused q 2 skew 1", dict(mode="fused", granularity=DLRM_WORLD_Q, skew_world=1)),
    ("step fused", dict(mode="fused")),
]


class ReluLog:
    """The gate of every ReLU in DLRM's MLPs (``models/dlrm._mlp``), recorded
    in one run (no ``masks``) and replayed in others, as GateLog replays
    MoE routing.  A pre-activation within rounding of 0 takes one side in
    one run's arithmetic and the other in another's, which moves its row's
    gradient by the whole unit's share (on an H100 at (2, 2), rows of ranks
    0 and 2 moved the pooled cotangent by 3 % of its largest element and the
    tables' gradient by 17 % at a sampled element; PERF.md section 6): the
    gradients are held to the f64 evaluation on its own gates.  ``rows``:
    the (first, count) of the batch a rank holds."""

    def __init__(self, masks=None, rows=None):
        self.masks = [] if masks is None else masks
        self.replaying, self.rows, self.pos = masks is not None, rows, 0

    @contextlib.contextmanager
    def active(self):
        from repro_torch.models import dlrm

        def mlp(layers, x):
            for i, layer in enumerate(layers):
                x = torch.matmul(x, layer["w"]) + layer["b"]
                if i == len(layers) - 1:
                    break
                if not self.replaying:
                    self.masks.append((x > 0).cpu())
                    x = torch.relu(x)
                    continue
                m = self.masks[self.pos]
                self.pos += 1
                if self.rows is not None:
                    m = m[self.rows[0]:self.rows[0] + self.rows[1]]
                x = torch.where(m.to(x.device), x, torch.zeros_like(x))
            return x

        self.pos = 0
        with swapped(dlrm, "_mlp", mlp):
            yield self


def dlrm_bundle(n_tables):
    from repro_torch.configs.registry import get_arch

    bundle = get_arch("dlrm")
    return dataclasses.replace(bundle, config=dataclasses.replace(bundle.config,
                                                                  n_tables=n_tables))


def dlrm_batch(cfg):
    """The first DLRMBatches(seed=0) batch of the train_8k size, on the card."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.data.synthetic import DLRMBatches

    return to_device(next(DLRMBatches(cfg.n_tables, cfg.table_vocab, cfg.pooling, cfg.n_dense,
                                      8192, seed=0)), "cuda")


def dlrm_exact(params, batch, log):
    """An f64 evaluation of DLRM's loss on the f32 weights, its ReLU gates
    recorded in ``log`` (a recording ReluLog): (the loss, the pooled
    embeddings' cotangent [B, T, D] f64, the MLP leaves' gradients in tree
    order)."""
    from repro_torch.models import dlrm

    tables, idx = params["tables"].detach(), batch["indices"]
    with torch.no_grad():
        pooled = torch.stack([tables[t][idx[:, t]].double().mean(1)
                              for t in range(tables.shape[0])], dim=1)
    pooled.requires_grad_(True)
    layers = [{k: v.detach().double().requires_grad_(True) for k, v in layer.items()}
              for layer in params["bottom"] + params["top"]]
    nb = len(params["bottom"])
    with log.active():
        bottom = dlrm._mlp(layers[:nb], batch["dense"].double())
        z = dlrm._mlp(layers[nb:], dlrm._interaction(bottom, pooled))[:, 0]
    y = batch["labels"].double()
    loss = (torch.clamp_min(z, 0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
    grads = torch.autograd.grad(loss, [pooled] + [v for layer in layers for v in layer.values()])
    return loss.item(), grads[0], list(grads[1:])


def table_grad_samples(idx, g_pooled, coords, vocab):
    """The tables' f64 gradient at ``coords`` [n, 3] (table, row, column):
    table t's is each bag's pooled cotangent over L added to its L rows."""
    n_tab, L, d = g_pooled.shape[1], idx.shape[2], g_pooled.shape[2]
    out = torch.zeros(len(coords), dtype=torch.float64)
    for t in range(n_tab):
        sel = coords[:, 0] == t
        if not sel.any():
            continue
        g = torch.zeros((vocab, d), dtype=torch.float64, device=g_pooled.device)
        g.index_add_(0, idx[:, t].reshape(-1).long(),
                     (g_pooled[:, t] / L).repeat_interleave(L, dim=0))
        c = coords[sel].cuda()
        out[sel] = g[c[:, 1], c[:, 2]].cpu()
        del g
    return out


def dlrm_grad_errs(grads, coords, vals, mlp_x, where=None):
    """Each leaf's max abs distance from the f64 evaluation: the tables' at
    the sampled coordinates (``where``: the rank's (mask, local coords) of
    its world shard), the MLP leaves' whole."""
    g = grads[0]
    if where is None:
        tab = (g[tuple(coords.cuda().T)].double().cpu() - vals).abs().max().item()
    else:
        mask, loc = where
        tab = ((g[tuple(loc[mask].cuda().T)].double().cpu() - vals[mask]).abs().max().item()
               if mask.any() else 0.0)
    return [tab] + [(a.double() - b.to(a.device)).abs().max().item()
                    for a, b in zip(grads[1:], mlp_x)]


def dlrm_train_phase(card) -> dict:
    """Phase 49: DLRM training on one card, the paper's widths with
    DLRM_TRAIN_TABLES tables, the train_8k batch (DLRMBatches seed 0,
    weights seed 0).  (a) The loss and every gradient in bulk and fused mode
    against an f64 evaluation (GRAD_SAMPLES seeded elements of the tables'
    gradient, every MLP leaf whole; both modes on its ReLU gates, ReluLog):
    fused within LOGITS_TOL_FACTOR x bulk's distance on every leaf; kernel
    mode's gradient raises.  (b)
    DLRM_STEPS AdamW steps (lr DLRM_LR, f32 moments) on that batch in each
    mode: finite losses, fused within TRAIN_LOSS_REL of bulk's, the loss
    falling; ms a step split, device busy share, peak memory.  (c) The
    trained parameters scored in kernel mode (one pooling launch) against
    bulk mode's logits at F32_TOL (phase 13's bound)."""
    from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables
    from repro_torch.models.dlrm import dlrm_forward
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import OptimizerConfig, tree_leaves, tree_paths
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    bundle = dlrm_bundle(DLRM_TRAIN_TABLES)
    cfg = bundle.config
    ctx = {m: ParallelContext(device="cuda", fusion=FusionConfig(mode=m))
           for m in ("kernel", "fused", "bulk")}
    init = lambda: bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    batch = dlrm_batch(cfg)
    B = batch["dense"].shape[0]
    params = init()
    names = [".".join(map(str, p_)) for p_, _ in tree_paths(params)]
    n_bytes = sum(t_.numel() * t_.element_size() for t_ in tree_leaves(params))
    coords = sample_coords(params["tables"].shape, GRAD_SAMPLES, 49)
    relu = ReluLog()
    lx, g_pooled, mlp_x = dlrm_exact(params, batch, relu)
    vals = table_grad_samples(batch["indices"], g_pooled, coords, cfg.table_vocab)
    del g_pooled
    torch.cuda.empty_cache()
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    losses, dist, grads_b = {}, {}, None
    for mode in ("bulk", "fused"):
        with ReluLog(relu.masks).active():
            loss = bundle.loss_fn(ctx[mode])(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"DLRM gradients in {mode} mode: non-finite")
        losses[mode] = loss.item()
        dist[mode] = dlrm_grad_errs(grads, coords, vals, mlp_x)
        if mode == "bulk":
            grads_b = grads
        else:
            same = all(torch.equal(a, b) for a, b in zip(grads, grads_b))
        del loss, grads
    del grads_b
    for name, ef, eb in zip(names, dist["fused"], dist["bulk"]):
        if not ef <= LOGITS_TOL_FACTOR * eb:
            raise AssertionError(f"DLRM gradient {name}: fused mode {ef:.3g} from f64, above "
                                 f"{LOGITS_TOL_FACTOR} x bulk mode's {eb:.3g}")
    try:
        torch.autograd.grad(bundle.loss_fn(ctx["kernel"])(params, batch), leaves)
        raise AssertionError("DLRM: kernel mode's gradient did not raise")
    except NotImplementedError as e:
        refusal = str(e)
    del params, leaves
    torch.cuda.empty_cache()
    say(49, f"(a) DLRM at the paper's widths with {cfg.n_tables} of 512 tables "
            f"({n_bytes / 1e9:.2f} GB f32), batch {B} (DLRMBatches seed 0, weights seed 0): "
            f"loss bulk {losses['bulk']:.6f}, fused {losses['fused']:.6f}, f64 {lx:.6f}; each "
            f"leaf's max abs err from the f64 evaluation (tables: {GRAD_SAMPLES} sampled "
            f"elements), fused/bulk (bound {LOGITS_TOL_FACTOR} x bulk's): "
            + ", ".join(f"{n_} {a:.3g}/{b:.3g}" for n_, a, b in
                        zip(names, dist["fused"], dist["bulk"]))
            + f" (every run on the f64 run's ReLU gates, ReluLog); fused mode's gradients "
            f"bit-identical to bulk's: {same}; kernel mode's "
            f"gradient raises: {refusal!r}")

    # (b) AdamW steps on the batch, each mode from the seed-0 weights
    tc = TrainConfig(optimizer=OptimizerConfig(lr=float(DLRM_LR), warmup_steps=5,
                                               total_steps=DLRM_STEPS))
    runs = {}
    for mode in ("bulk", "fused"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_train_state(tc, init())
        clock = StepClock(profile_step=DLRM_STEPS)
        step = build_train_step(bundle.loss_fn(ctx[mode]), tc, on_phase=clock)
        step_losses = []
        for _ in range(DLRM_STEPS):
            state, m = step(state, batch)
            step_losses.append(m["loss"].item())
        runs[mode] = dict(losses=step_losses, split=clock.split(), busy=clock.busy,
                          peak=torch.cuda.max_memory_allocated() / 1e9)
        if mode == "fused":
            trained = state["params"]
        del state, step
    f_, b_ = runs["fused"], runs["bulk"]
    if not all(x == x and abs(x) < float("inf") for x in f_["losses"] + b_["losses"]):
        raise AssertionError(f"DLRM steps: non-finite losses {f_['losses']}, {b_['losses']}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(f_["losses"], b_["losses"]))
    if rel > TRAIN_LOSS_REL or not f_["losses"][-1] < f_["losses"][0]:
        raise AssertionError(f"DLRM steps: fused losses {f_['losses']} against bulk's "
                             f"{b_['losses']} ({rel:.3g} apart; the loss must fall)")

    def summary(r):
        later = r["split"][1:]
        med = sorted(later, key=lambda x: x[3])[len(later) // 2]
        dev, wall, ops = r["busy"]
        return (f"losses {', '.join(f'{x:.6f}' for x in r['losses'])}; step (median of 2-"
                f"{DLRM_STEPS}) {med[3]:.1f} ms = forward {med[0]:.1f} + backward {med[1]:.1f} "
                f"+ optimizer {med[2]:.1f} (steps: "
                f"{', '.join(f'{x[3]:.1f}' for x in r['split'])} ms), {B / med[3] * 1e3:.0f} "
                f"rows/s; device busy {100 * dev / wall:.1f}% of step {DLRM_STEPS}'s "
                f"{wall:.1f} ms under the profiler ({ops} device ops); peak "
                f"{r['peak']:.2f} GB"), med
    sf, mf = summary(f_)
    sb, mb = summary(b_)
    say(49, f"(b) on {card}: {DLRM_STEPS} AdamW steps (lr {DLRM_LR}, f32 moments) on the batch: "
            f"fused mode {sf}; bulk mode {sb}; fused within {rel:.3g} of bulk (bound "
            f"{TRAIN_LOSS_REL})")

    # (c) the trained parameters scored in kernel mode against bulk mode
    with torch.no_grad():
        logits_k, counts = counted_run(lambda: dlrm_forward(ctx["kernel"], trained, cfg, batch),
                                       {"embedding_pool_tables": 1,
                                        "embedding_pool_tables.warp": 1})
        logits_b = dlrm_forward(ctx["bulk"], trained, cfg, batch)
    err = check_close("DLRM trained logits kernel vs bulk", logits_k, logits_b, F32_TOL)
    del trained, logits_k, logits_b, batch
    torch.cuda.empty_cache()
    say(49, f"(c) the trained parameters scored in kernel mode: "
            f"{counts['embedding_pool_tables']} embedding_pool launch (warp path), logits "
            f"against bulk mode's max abs/rel err {err[0]:.3g}/{err[1]:.3g} (bound {F32_TOL})")
    return {"train_step_ms": mf[3], "train_bulk_step_ms": mb[3],
            "train_scoring_launches": counts["embedding_pool_tables"]}


def dlrm_world_phase(card) -> dict:
    """Phase 50: DLRM over a (dp, tp) = (2, 2) world of the pool's gloo
    processes on the card, the paper's widths with DLRM_WORLD_TABLES tables
    (4 a rank), the train_8k batch.  Here first, at tp = 1: bulk mode's
    logits, an f64 evaluation (the loss, GRAD_SAMPLES seeded elements of the
    tables' gradient, the MLP's gradients whole) and bulk mode's loss and
    gradients' distances from it.  Then each rank on its 4 tables and 2048
    rows: scoring in bulk, fused (q = DLRM_WORLD_Q at skew 0 and 1, f32 and
    bf16 wire) and kernel mode (the embedding_pool kernel a fragment, n q
    launches a rank, each against its plain version); every rank's rows
    against tp = 1 bulk's logits (F32_TOL, the bf16 wire WIRE_BF16_TOL),
    skew 1 bit-identical to skew 0; a loss with gradients in bulk and fused
    mode (skew 0 and 1), every run on the f64 run's ReLU gates (ReluLog,
    each rank its rows'): the loss and every shard within LOGITS_TOL_FACTOR x
    tp = 1 bulk's distance from f64, skew 1 bit-identical to skew 0 on every
    leaf (the tables' gradient is one embedding_bag backward over the whole
    batch, which sums without atomics in mean mode); one AdamW step, after
    which the MLP leaves are bit-identical on every rank."""
    from repro_torch.models.dlrm import dlrm_forward
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import tree_leaves, tree_paths

    bundle = dlrm_bundle(DLRM_WORLD_TABLES)
    cfg = bundle.config
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    batch = dlrm_batch(cfg)
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    names = [".".join(map(str, p_)) for p_, _ in tree_paths(params)]
    shape = tuple(params["tables"].shape)
    with torch.no_grad():
        logits_b = dlrm_forward(ctx_b, params, cfg, batch).cpu()
    coords = sample_coords(shape, GRAD_SAMPLES, 50)
    relu = ReluLog()
    lx, g_pooled, mlp_x = dlrm_exact(params, batch, relu)
    vals = table_grad_samples(batch["indices"], g_pooled, coords, cfg.table_vocab)
    del g_pooled
    leaves = tree_leaves(params)
    for p_ in leaves:
        p_.requires_grad_(True)
    with ReluLog(relu.masks).active():
        loss_b = bundle.loss_fn(ctx_b)(params, batch)
    dist_b = dlrm_grad_errs(torch.autograd.grad(loss_b, leaves), coords, vals, mlp_x)
    lb = loss_b.item()
    del params, leaves, loss_b
    torch.cuda.empty_cache()
    inputs = dict(tables=DLRM_WORLD_TABLES, batch={k: v.cpu().numpy() for k, v in batch.items()},
                  coords=coords, vals=vals, mlp_x=[g.cpu() for g in mlp_x], shape=shape,
                  relu=relu.masks)
    del batch, mlp_x
    t0 = time.perf_counter()
    got = spawn_world(4, DLRM_WORLD_SETTINGS, target=dlrm_world_rank, args=(inputs,))
    wall = time.perf_counter() - t0
    ranks = got["ranks"]
    notes = []
    for name, kw in DLRM_WORLD_SETTINGS:
        mine = [r_[name] for r_ in ranks]
        ms = max(m_["ms"] for m_ in mine)
        if name.startswith(("grad", "step")):
            loss_err = abs(mine[0]["loss"] - lx)
            if loss_err > LOGITS_TOL_FACTOR * abs(lb - lx) + 1e-7:
                raise AssertionError(f"(2, 2) {name}: loss {mine[0]['loss']:.8f} is "
                                     f"{loss_err:.3g} from f64 {lx:.8f}, tp = 1 bulk's {lb:.8f}")
        if name.startswith("grad"):
            worst = 0.0
            for i, n_ in enumerate(names):
                e = max(m_["errs"][i] for m_ in mine)
                if not e <= LOGITS_TOL_FACTOR * dist_b[i]:
                    raise AssertionError(f"(2, 2) {name} gradient {n_}: {e:.3g} from f64, above "
                                         f"{LOGITS_TOL_FACTOR} x tp = 1 bulk's {dist_b[i]:.3g}")
                worst = max(worst, e / max(dist_b[i], 1e-30))
            notes.append(f"{name}: loss {mine[0]['loss']:.8f}, worst leaf at {worst:.3g} of tp "
                         f"= 1 bulk's distance, {ms:.0f} ms (slowest rank)")
            continue
        if name.startswith("step"):
            notes.append(f"{name}: loss {mine[0]['loss']:.8f}, the MLP leaves bit-identical on "
                         f"every rank after the step, {ms:.0f} ms (slowest rank)")
            continue
        full = torch.from_numpy(mine[0]["logits"])
        tol = WIRE_BF16_TOL if kw.get("wire") == "bf16" else F32_TOL
        err = check_close(f"(2, 2) {name} logits vs tp = 1 bulk", full, logits_b, tol)
        notes.append(f"{name}: logits {err[0]:.3g}/{err[1]:.3g} from tp = 1 bulk's, "
                     f"{ms:.0f} ms (slowest rank)")
    for r_ in ranks:
        if not (r_["fused q 2 skew 1"]["skew_equal"] and r_["grad fused q 2 skew 1"]["skew_equal"]):
            raise AssertionError("(2, 2): skew 1 is not skew 0's bits (logits or gradients)")
    kern = [r_["kernel q 2"] for r_ in ranks]
    want = 4 * DLRM_WORLD_Q
    if any(k_["launches"] != want or k_["warp"] != want for k_ in kern):
        raise AssertionError(f"(2, 2) kernel mode: embedding_pool launches "
                             f"{[(k_['launches'], k_['warp']) for k_ in kern]}, expected {want} "
                             f"a rank on the warp path")
    frag_err = max(k_["frag_err"] for k_ in kern)
    same = all(r_["grad fused q 2"]["same_as_bulk"] for r_ in ranks)
    say(50, f"[{TP_LABEL.format(4)}] DLRM at (dp, tp) = (2, 2), the paper's widths with "
            f"{DLRM_WORLD_TABLES} of 512 tables ({DLRM_WORLD_TABLES // 4} a rank), batch 8192 "
            f"(2048 rows a rank): tp = 1 bulk loss {lb:.8f}, f64 {lx:.8f}; tp = 1 bulk's "
            f"distances from f64 (bounds {LOGITS_TOL_FACTOR} x them; tables at {GRAD_SAMPLES} "
            f"sampled elements): " + ", ".join(f"{n_} {d_:.3g}" for n_, d_ in zip(names, dist_b))
            + "; " + "; ".join(notes) + f"; skew 1 bit-identical to skew 0 (logits and every "
            f"gradient, the tables' too); fused mode's gradients bit-identical to bulk's on "
            f"every rank: {same}; kernel mode: {want} embedding_pool launches a rank (warp "
            f"path), each fragment against its plain version max abs err {frag_err:.3g} (bound "
            f"{F32_TOL}); peak a rank {max(r_['peak'] for r_ in ranks):.2f} GB; the world "
            f"{wall:.0f} s")
    return {"world_launches_per_rank": want, "world_fragment_err": frag_err}


def dlrm_world_rank(rank, tp, init, settings, inputs, out):
    """One rank of phase 50's (2, 2) world: its 4 tables and 2048 rows."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core import embedding_all_to_all as emb
    from repro_torch.core.collectives import all_reduce_grads
    from repro_torch.kernels.embedding_pool.ops import embedding_pool_tables
    from repro_torch.kernels.embedding_pool.ref import embedding_pool_tables_ref
    from repro_torch.launch.mesh import close_world, init_world
    from repro_torch.models.dlrm import dlrm_forward
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext, make_world_groups
    from repro_torch.train.optimizer import OptimizerConfig, spec_leaves, tree_leaves
    from repro_torch.train.step import TrainConfig, build_train_step, init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dev = init_world(tp, "gloo", "cuda", rank=rank, init_method=init)
        make_world_groups(2, 2)
        torch.cuda.reset_peak_memory_stats(dev)
        bundle = dlrm_bundle(inputs["tables"])
        cfg = bundle.config
        sync = lambda: torch.cuda.synchronize(dev)
        batch = {k: torch.as_tensor(v).to(dev) for k, v in inputs["batch"].items()}
        ctx = lambda kw: ParallelContext(device=dev, tp=2, dp=2, fusion=FusionConfig(**kw))
        c0 = ctx({})
        params = bundle.init_params(torch.Generator(device=dev).manual_seed(0), c0)
        leaves = tree_leaves(params)
        specs = spec_leaves(bundle.param_specs(params))
        mlp_x = [g.to(dev) for g in inputs["mlp_x"]]
        where = shard_sample(inputs["coords"], inputs["shape"], specs[0], c0)
        res, keep = {}, {}
        for name, kw in settings:
            c = ctx(kw)
            r = {}
            if name.startswith("grad"):
                for p_ in leaves:
                    p_.requires_grad_(True)
                sync()
                t0 = time.perf_counter()
                r_w = c.world.tp_rank
                rows = batch["dense"].shape[0] // 4
                with ReluLog(inputs["relu"], rows=(r_w * rows, rows)).active():
                    loss = bundle.loss_fn(c)(params, batch)
                grads = list(torch.autograd.grad(loss, leaves))
                all_reduce_grads(c, grads, specs)
                sync()
                r.update(ms=(time.perf_counter() - t0) * 1e3, loss=loss.item(),
                         digest=_digest([loss]), finite=bool(torch.isfinite(loss)),
                         errs=dlrm_grad_errs(grads, inputs["coords"], inputs["vals"], mlp_x,
                                             where))
                keep[name] = grads
                if name == "grad fused q 2":
                    r["same_as_bulk"] = all(torch.equal(a, b)
                                            for a, b in zip(grads, keep["grad bulk"]))
                if name == "grad fused q 2 skew 1":
                    r["skew_equal"] = all(torch.equal(a, b)
                                          for a, b in zip(grads, keep["grad fused q 2"]))
                    keep.clear()
                del loss, grads
            elif name.startswith("step"):
                tc = TrainConfig(optimizer=OptimizerConfig(lr=float(DLRM_LR), warmup_steps=5,
                                                           total_steps=1))
                state = init_train_state(tc, params)
                step = build_train_step(bundle.loss_fn(c), tc, ctx=c,
                                        param_specs=bundle.param_specs(params))
                sync()
                t0 = time.perf_counter()
                state, m = step(state, batch)
                sync()
                mlp = [p_ for p_, sp in zip(tree_leaves(state["params"]), specs) if sp[0] != "world"]
                r.update(ms=(time.perf_counter() - t0) * 1e3, loss=m["loss"].item(),
                         digest=_digest(mlp), finite=all(bool(torch.isfinite(p_).all())
                                                         for p_ in mlp))
                del state, step
            else:
                frags = []
                if kw["mode"] == "kernel":
                    def spy(tab, idx):
                        o = embedding_pool_tables(tab, idx)
                        frags.append((tab, idx, o))
                        return o
                    reset_counts()
                    real, emb.embedding_pool_tables = emb.embedding_pool_tables, spy
                try:
                    sync()
                    t0 = time.perf_counter()
                    with torch.no_grad():
                        logits = dlrm_forward(c, params, cfg, batch)
                    sync()
                    r["ms"] = (time.perf_counter() - t0) * 1e3
                finally:
                    if kw["mode"] == "kernel":
                        emb.embedding_pool_tables = real
                if kw["mode"] == "kernel":
                    r.update(launches=embedding_pool_tables.launches,
                             warp=embedding_pool_tables.path_launches["warp"],
                             frag_err=max(check_close(f"rank {rank} fragment", o,
                                                      embedding_pool_tables_ref(tab, idx),
                                                      F32_TOL)[0] for tab, idx, o in frags))
                    del frags
                every = [torch.empty_like(logits, device="cpu") for _ in range(4)]
                dist.all_gather(every, logits.cpu())
                full = torch.cat(every)
                r.update(logits=full.numpy(), digest=_digest([full]),
                         finite=bool(torch.isfinite(full).all()))
                if name == "fused q 2":
                    keep["logits"] = logits
                if name == "fused q 2 skew 1":
                    r["skew_equal"] = torch.equal(logits, keep.pop("logits"))
                del logits
            res[name] = r
        del params, leaves
        res["peak"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out.put((rank, "ok", res))
    except Exception:
        out.put((rank, "err", traceback.format_exc()))
    finally:
        close_world()


def dlrm_launcher_phase(card) -> None:
    """Phase 51: the train launcher in this process, ``launch.train.main``
    with --arch dlrm --tables DLRM_TRAIN_TABLES --fusion fused --batch 8192
    --steps DLRM_STEPS --lr DLRM_LR: finite losses that fall; ms a step
    split, the device's busy share, peak memory."""
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "dlrm", "--tables", str(DLRM_TRAIN_TABLES), "--fusion", "fused",
            "--batch", "8192", "--steps", str(DLRM_STEPS), "--lr", DLRM_LR, "--log-every", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    clock = StepClock(profile_step=DLRM_STEPS)
    t0 = time.perf_counter()
    losses = launch_train.main(argv, on_phase=clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(x == x and abs(x) < float("inf") for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the DLRM launcher's losses: {losses} (must be finite and fall)")
    split = clock.split()
    dev, busy_wall, ops = clock.busy
    say(51, f"on {card}: python -m repro_torch.launch.train {' '.join(argv)} in this process: "
            f"losses {', '.join(f'{x:.6f}' for x in losses)}; steps "
            + ", ".join(f"{r[3]:.1f} ms (forward {r[0]:.1f}, backward {r[1]:.1f}, optimizer "
                        f"{r[2]:.1f})" for r in split)
            + f"; device busy {100 * dev / busy_wall:.1f}% of the last step's {busy_wall:.1f} ms "
            f"({ops} device ops); peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
            f"{wall:.1f} s with init")


# Phases 52-54: the in-process runtime.  Phase 52 trains full-width
# chatglm3-6b cut to RUNTIME_LAYERS of its 28 layers (0.737 G parameters, a
# train state of about 7.4 GB with AdamW's f32 moments) in kernel mode at
# RUNTIME_B x RUNTIME_S tokens, RUNTIME_STEPS AdamW steps at TRAIN_LR (the
# launcher's warm-up of 5 steps, so steps 1-5 take the same lr at any
# --steps), under the supervisor with RUNTIME_PLAN, checkpoints every 2
# steps; phase 53 runs the train launcher on the same setup in two calls on
# one directory; phase 54 the paged serve launcher on RUNTIME_SERVE_LAYERS
# layers under RUNTIME_SERVE_PLAN.
RUNTIME_LAYERS, RUNTIME_B, RUNTIME_S, RUNTIME_STEPS = 1, 4, 512, 6
RUNTIME_PLAN = "at=1:slow_link+3:timeout+5:rank_fail,delay=0"
RUNTIME_SERVE_LAYERS = 2
RUNTIME_SERVE_PLAN = "at=1:timeout+2:nan_wire+3:slow_link,delay=0"
RUNTIME_ARGV = ["--layers", str(RUNTIME_LAYERS), "--batch", str(RUNTIME_B), "--seq",
                str(RUNTIME_S), "--lr", TRAIN_LR, "--fusion", "kernel", "--log-every", "100"]


def leaf_paths(tree, path=()):
    """[(path, leaf)] of a nested tree of dicts and lists."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in leaf_paths(v, path + (str(k),))]
    if isinstance(tree, list):
        return [pl for i, v in enumerate(tree) for pl in leaf_paths(v, path + (str(i),))]
    return [("/".join(path), tree)]


def runtime_setup():
    """Phase 52's training as the train launcher sets it up for
    RUNTIME_ARGV with --steps RUNTIME_STEPS: the cut bundle, the kernel-mode
    context, the TrainConfig, the first RUNTIME_STEPS seeded batches on the
    card, and a function drawing the seed-0 train state."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import TrainConfig, init_train_state

    bundle = get_arch("chatglm3-6b")
    bundle = dataclasses.replace(bundle, config=dataclasses.replace(
        bundle.config, n_layers=RUNTIME_LAYERS))
    ctx = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    tc = TrainConfig(optimizer=OptimizerConfig(
        name=bundle.optimizer, lr=float(TRAIN_LR), warmup_steps=max(RUNTIME_STEPS // 20, 5),
        total_steps=RUNTIME_STEPS), microbatches=bundle.microbatches)
    it = launch_train.make_batches(bundle, RUNTIME_B, RUNTIME_S)
    batches = [to_device(next(it), "cuda") for _ in range(RUNTIME_STEPS)]

    def fresh():
        return init_train_state(tc, bundle.init_params(
            torch.Generator(device="cuda").manual_seed(0)))
    return bundle, ctx, tc, batches, fresh


def supervised_train_phase(card) -> dict:
    """Phase 52: full-width chatglm3-6b, RUNTIME_LAYERS layer, kernel mode,
    RUNTIME_STEPS AdamW steps under ``TrainSupervisor`` with RUNTIME_PLAN
    (a slow link, a timeout and a rank failure: 2 restarts, each restoring
    the last checkpoint and replaying its batches), async checkpoints every
    2 steps (keep 2) into a directory under build/.  A plain loop runs the
    same steps twice first; gates: the supervisor's counts, every leaf of
    the final state the plain run's bits (where the two plain runs differ
    on a leaf, within their spread), the per-step losses likewise, the
    flash kernel's launches (2 a layer a step run, replays included, every
    one on the tile path).  Prints each save's and restore's seconds and
    GB/s.  Returns the plain losses and their spread for phase 53, and the
    flash row's numbers."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import Placement
    from repro_torch.runtime.chaos import parse_chaos_spec
    from repro_torch.runtime.fault_tolerance import SupervisorConfig, TrainSupervisor
    from repro_torch.train.step import build_train_step, train_state_specs

    bundle, ctx, tc, batches, fresh = runtime_setup()
    L = RUNTIME_LAYERS
    plain = []
    for _ in range(2):
        state = fresh()
        specs = bundle.param_specs(state["params"])
        step_fn = build_train_step(bundle.loss_fn(ctx), tc, ctx=ctx, param_specs=specs)
        losses = []
        for b in batches:
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
        plain.append((state, losses))
        del state, step_fn
    (sa, la), (sb, lb) = plain
    spread = {p_: (a - b).abs().max().item() if a.is_floating_point() else
              float((a != b).any())
              for (p_, a), (_, b) in zip(leaf_paths(sa), leaf_paths(sb))
              if not torch.equal(a, b)}
    loss_spread = max(abs(x - y) for x, y in zip(la, lb))
    del sb
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = fresh()
    specs = bundle.param_specs(state["params"])
    base = build_train_step(bundle.loss_fn(ctx), tc, ctx=ctx, param_specs=specs)
    runs = [0]

    def step_fn(st, b):
        runs[0] += 1
        return base(st, b)

    plan = parse_chaos_spec(RUNTIME_PLAN, num_steps=RUNTIME_STEPS)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="phase52_", dir=ROOT / "build")
    got_losses = {}
    try:
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_dir=ckpt_dir, checkpoint_every=2, keep=2), step_fn,
            state_shardings=Placement(ctx, train_state_specs(tc, specs), training=True),
            fault_plan=plan)
        reset_counts()
        t0 = time.perf_counter()
        state, step = sup.run(state, batches, RUNTIME_STEPS,
                              on_metrics=lambda s_, m: got_losses.__setitem__(s_, float(m["loss"])))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launch_counts()
        on_disk = sup.manager.all_steps()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if (step, sup.restarts, sup.faults_injected, sup.rank_losses) != (RUNTIME_STEPS, 2, 3, 0) \
            or sup.failures != [(3, "CollectiveTimeout"), (5, "CollectiveTimeout")]:
        raise AssertionError(f"supervisor: step {step}, restarts {sup.restarts}, injected "
                             f"{sup.faults_injected}, failures {sup.failures}")
    if runs[0] != RUNTIME_STEPS + 2:
        raise AssertionError(f"{runs[0]} step runs, expected {RUNTIME_STEPS} + 2 replays")
    expect_counts("phase 52", counts, flash_on_tile(2 * L * runs[0]))
    worst = {}
    for (p_, got), (_, want) in zip(leaf_paths(state), leaf_paths(sa)):
        if torch.equal(got, want):
            continue
        d = (got.float() - want.float()).abs().max().item()
        if p_ not in spread or d > spread[p_]:
            raise AssertionError(f"leaf {p_}: {d:.3g} from the plain run's, whose two runs "
                                 f"differ there by {spread.get(p_, 0.0):.3g}")
        worst[p_] = d
    got_l = [got_losses[s_] for s_ in range(1, RUNTIME_STEPS + 1)]
    d_loss = max(abs(x - y) for x, y in zip(got_l, la))
    if d_loss > loss_spread:
        raise AssertionError(f"losses {got_l} vs the plain run's {la} (spread {loss_spread:.3g})")
    saves = "; ".join(f"step {h['step']}: {h['bytes'] / 1e9:.2f} GB, held the loop "
                      f"{h['block_s']:.3f} s, on disk after {h['total_s']:.2f} s "
                      f"({h['bytes'] / h['total_s'] / 1e9:.2f} GB/s)" for h in sup.manager.history)
    restores = "; ".join(f"step {r['step']}: {r['seconds']:.2f} s "
                         f"({r['bytes'] / r['seconds'] / 1e9:.2f} GB/s)" for r in sup.manager.stats)
    same = "same bits" if d_loss == 0 else f"within {d_loss:.3g}"
    say(52, f"on {card}: chatglm3-6b, {L} of 28 layers at full width, kernel mode, "
            f"{RUNTIME_B}x{RUNTIME_S} tokens, {RUNTIME_STEPS} AdamW steps at lr {TRAIN_LR} under "
            f"TrainSupervisor with --chaos {RUNTIME_PLAN}: restarts {sup.restarts} "
            f"({sup.failures}), {runs[0]} step runs, flash launches {counts['flash_attention']} "
            f"(2 a layer a run, replays included, all on the tile path); final state: "
            f"{len(leaf_paths(state)) - len(worst)} of {len(leaf_paths(state))} leaves the plain "
            f"run's bits"
            + (f", the others within the two plain runs' spread: {worst}" if worst else "")
            + f" (the two plain runs differ on {len(spread)} leaves: {sorted(spread)}); losses "
            f"{', '.join(f'{x:.6f}' for x in got_l)} (the plain run's: {same}); "
            f"saves: {saves}; restores: {restores}; checkpoints left {on_disk}; "
            f"{wall:.1f} s under the supervisor, peak {peak:.2f} GB")
    del state, sa, plain
    torch.cuda.empty_cache()
    return {"plain_losses": la, "loss_spread": loss_spread,
            "row": {"supervised_flash_launches": counts["flash_attention"],
                    "supervised_step_runs": runs[0]}}


def train_resume_phase(card, plain_losses, loss_spread) -> None:
    """Phase 53: ``launch.train.main`` in this process, twice on one
    --ckpt-dir (--ckpt-every 4): --steps 4, then --steps 6, which resumes at
    step 4 and runs on.  Gates: the first call's losses are phase 52's plain
    steps 1-4 and the second call's its steps 5-6 (the lr of steps 1-5 does
    not depend on --steps), within the plain runs' spread; 2 flash launches
    a layer a step."""
    import shutil
    import tempfile

    from repro_torch.launch import train as launch_train

    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="phase53_", dir=ROOT / "build")
    argv = RUNTIME_ARGV + ["--ckpt-dir", ckpt_dir, "--ckpt-every", "4"]
    out = []
    try:
        for steps in (4, RUNTIME_STEPS):
            reset_counts()
            t0 = time.perf_counter()
            losses = launch_train.main(argv + ["--steps", str(steps)])
            torch.cuda.synchronize()
            out.append((losses, launch_counts(), time.perf_counter() - t0,
                        sorted(os.listdir(ckpt_dir))))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    (l1, c1, t1, d1), (l2, c2, t2, d2) = out
    want = (plain_losses[:4], plain_losses[4:])
    for i, (got, w) in enumerate(zip((l1, l2), want)):
        if len(got) != len(w) or max(abs(x - y) for x, y in zip(got, w)) > loss_spread:
            raise AssertionError(f"call {i + 1}: losses {got}, phase 52's plain steps {w}")
    expect_counts("phase 53 call 1", c1, flash_on_tile(2 * RUNTIME_LAYERS * 4))
    expect_counts("phase 53 call 2", c2, flash_on_tile(2 * RUNTIME_LAYERS * (RUNTIME_STEPS - 4)))
    say(53, f"on {card}: python -m repro_torch.launch.train {' '.join(RUNTIME_ARGV)} --ckpt-dir "
            f"D --ckpt-every 4 in this process: --steps 4: losses "
            f"{', '.join(f'{x:.6f}' for x in l1)}, {t1:.1f} s with init, D holds {d1}; then "
            f"--steps {RUNTIME_STEPS} resumed at step 4: losses "
            f"{', '.join(f'{x:.6f}' for x in l2)}, {t2:.1f} s, D holds {d2}; both phase 52's "
            f"plain steps ({'same bits' if loss_spread == 0 else f'within {loss_spread:.3g}'}); "
            f"flash launches {c1['flash_attention']} and {c2['flash_attention']}")


def serve_chaos_phase(card) -> None:
    """Phase 54: ``launch.serve.main`` in this process, the paged engine
    over full-width chatglm3-6b cut to RUNTIME_SERVE_LAYERS layers, kernel
    mode: a clean drain, then --chaos RUNTIME_SERVE_PLAN (2 ticks dropped,
    one slow link): every request's tokens the clean drain's, as many fused
    GEMV + AllReduce launches (a dropped tick runs nothing); then
    --chaos at=2:rank_loss, which at one rank raises as the reference's
    shrink does."""
    import io

    from repro_torch.launch import serve as launch_serve

    argv = ["--paged", "--layers", str(RUNTIME_SERVE_LAYERS), "--requests", "4", "--max-new",
            "8", "--fusion", "kernel"]
    runs = {}
    for name, extra in (("clean", []), ("chaos", ["--chaos", RUNTIME_SERVE_PLAN])):
        buf = io.StringIO()
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            fin = launch_serve.main(argv + extra)
        torch.cuda.synchronize()
        runs[name] = ({r.uid: r.tokens for r in fin}, launch_counts(), buf.getvalue(),
                      time.perf_counter() - t0)
    (tc_, cc, _, t_c), (tx, cx, out_x, t_x) = runs["clean"], runs["chaos"]
    if tx != tc_ or len(tc_) != 4:
        raise AssertionError(f"chaos tokens {tx} differ from the clean drain's {tc_}")
    line = next((l_ for l_ in out_x.splitlines() if l_.startswith("chaos:")), "")
    if "dropped 2, reshards 0, drained True" not in line:
        raise AssertionError(f"serve under chaos: {line!r}")
    n = cc["fused_matmul_allreduce"]
    if n == 0 or cx["fused_matmul_allreduce"] != n:
        raise AssertionError(f"fused launches: clean {n}, chaos {cx['fused_matmul_allreduce']}")
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            launch_serve.main(argv + ["--chaos", "at=2:rank_loss"])
    except ValueError as e:
        raised = str(e)
    else:
        raise AssertionError("a rank loss at one rank did not raise")
    if "no mesh axis divisible" not in raised:
        raise AssertionError(f"a rank loss at one rank raised {raised!r}")
    say(54, f"on {card}: python -m repro_torch.launch.serve {' '.join(argv)} in this process: "
            f"clean {t_c:.1f} s, --chaos {RUNTIME_SERVE_PLAN} {t_x:.1f} s: {line}; every "
            f"request's tokens the clean drain's; fused GEMV + AllReduce launches {n} in each "
            f"drain; --chaos at=2:rank_loss at one rank raised ValueError: {raised}")


def runtime_phases(card) -> dict:
    """Phases 52-54; returns the flash row's numbers under the supervisor."""
    got = supervised_train_phase(card)
    train_resume_phase(card, got["plain_losses"], got["loss_spread"])
    torch.cuda.empty_cache()
    serve_chaos_phase(card)
    torch.cuda.empty_cache()
    return got["row"]


# Phases 55-56: the respawn protocol (runtime/multiprocess.py).  The workers
# are the launchers themselves, started by MultiprocessDriver as processes
# sharing the one card in a gloo world (NCCL refuses two ranks on one
# card): no time here is an NVLink time.  A heartbeat older than
# RESPAWN_STALL_S marks a peer stalled or lost: room for a first save's
# pinning (1.1-1.3 s in phase 52) and a gloo world's start on a loaded host.
RESPAWN_STALL_S = 5.0
RESPAWN_KILL_STEP = 3
RESPAWN_SERVE = ["--layers", str(RUNTIME_SERVE_LAYERS), "--requests", "8", "--batch", "4",
                 "--max-new", "32", "--fusion", "kernel"]
RESPAWN_KILL_TICK = 10
DRILL_LABEL = "one card, 2 gloo processes, wire staged through host memory: not NVLink"


def respawn_driver(argv, workdir):
    """A MultiprocessDriver of 2 workers running ``python -m <argv>``, with
    the liveness flags, under ``workdir``."""
    from repro_torch.runtime.multiprocess import MultiprocessDriver

    flags = ["--backend", "gloo", "--heartbeat-dir", "{heartbeat_dir}", "--stall-after",
             str(RESPAWN_STALL_S)]
    return MultiprocessDriver(["-m", *argv, *flags], 2, workdir=str(workdir),
                              env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                              hang_grace_s=30.0)


def drill_logs(driver, report) -> dict:
    """(generation, rank) -> the worker's log, for every worker started."""
    logs = {}
    for g in report.generations:
        for r in range(g.world):
            with open(os.path.join(driver.workdir, "logs", f"g{g.generation}_r{r}.log")) as f:
                logs[(g.generation, r)] = f.read()
    return logs


def drill_times(driver, report, killed) -> str:
    """The drill's seconds: the kill to rank 0's exit (detection), the kill to
    generation 1's first step or tick (respawn), each generation's wall time."""
    g0 = report.generations[0]
    return (f"detection {g0.exit_times[0] - killed['t']:.2f} s (kill to rank 0's exit), respawn "
            f"{killed['first'] - killed['t']:.2f} s (kill to generation 1's first "
            f"{killed['unit']}), generations "
            + ", ".join(f"{g.generation}: {g.duration_s:.1f} s" for g in report.generations))


def drill_report(driver, report, killed, what) -> dict:
    """The drill's gates common to both launchers: generation 0 ends {0: 17,
    1: -9} through liveness, generation 1 is a world of one that ends 0,
    one kill and no other break.  Returns the logs."""
    logs = drill_logs(driver, report)
    codes = [g.codes for g in report.generations]
    if (not report.completed or codes != [{0: 17, 1: -9}, {0: 0}]
            or len(report.events("kill")) != 1 or report.generations[1].world != 1):
        for k_, v in logs.items():
            print(f"--- {what} g{k_[0]} r{k_[1]}\n{v[-3000:]}", file=sys.stderr)
        raise AssertionError(f"{what}: generations {codes}, kills {report.events('kill')}")
    if "liveness:" not in logs[(0, 0)] or "RankLost from liveness" not in logs[(0, 0)]:
        raise AssertionError(f"{what}: rank 0 left without liveness's verdict:\n"
                             f"{logs[(0, 0)][-3000:]}")
    if "world size 1: (dp, tp) = (1, 1), shrunk from --dp 2 --tp 1" not in logs[(1, 0)]:
        raise AssertionError(f"{what}: generation 1 did not shrink to (1, 1)")
    return logs


def killer(rank, step, unit):
    """A fault for run_elastic: SIGKILL ``rank`` once its heartbeat reports
    ``step``, then note when generation 1's rank 0 beats its first step or
    tick; the times land in the returned dict."""
    killed = {"unit": unit}

    def fault(d):
        killed["t"] = d.kill_at_step(rank, step)

    def first(d):
        d.wait_for_step(0, 1, timeout_s=600)
        killed["first"] = time.time()
    return killed, {0: fault, 1: first}


def same_bits(x, y) -> bool:
    """Two host arrays (memory maps included) of one dtype and shape, equal
    byte for byte, compared without a copy of either."""
    import numpy as np

    return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
        np.ascontiguousarray(x).reshape(-1).view(np.uint8),
        np.ascontiguousarray(y).reshape(-1).view(np.uint8))


def checkpoint_leaves(d) -> dict:
    """path -> a memory map of the leaf's file, for checkpoint directory ``d``."""
    import numpy as np

    with open(os.path.join(d, "manifest.json")) as f:
        return {e["path"]: np.load(os.path.join(d, e["file"]), mmap_mode="r")
                for e in json.load(f)["leaves"]}


def same_checkpoint(a, b) -> int:
    """Every leaf of checkpoint directories ``a`` and ``b`` equal bit for bit
    (dtype, shape, bytes); returns the leaf count."""
    x, y = checkpoint_leaves(a), checkpoint_leaves(b)
    if sorted(x) != sorted(y):
        raise AssertionError(f"checkpoints {a} and {b} hold different leaves")
    for p_ in x:
        if not same_bits(x[p_], y[p_]):
            raise AssertionError(f"checkpoints {a} and {b} differ at {p_}")
    return len(x)


def train_respawn_phase(card) -> dict:
    """Phase 55: the train launcher on phase 52's setup (chatglm3-6b, 1 of
    28 layers at full width, kernel mode, 4 x 512 tokens, lr 3e-5, 6 steps,
    --ckpt-every 2) at --dp 2 as the workers of MultiprocessDriver; rank 1
    SIGKILLed once its heartbeat reports step 3 (never rank 0: it holds the
    rendezvous store).  Gates: drill_report's; generation 1 resumes at a
    step > 0; a copy of the checkpoint directory taken at generation 0's
    end gives, through the launcher in this process at (1, 1), the same
    final checkpoint on every leaf's bits and the same losses' bits, and,
    restored in this process and stepped to the end under the counted
    wrappers, the same again with 2 flash launches a layer a step, every
    one on the tile path.  Returns the flash row's numbers."""
    import io
    import shutil
    import tempfile

    from repro_torch.checkpoint.checkpointer import restore_checkpoint
    from repro_torch.launch import train as launch_train
    from repro_torch.train.step import build_train_step

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase55_", dir=ROOT / "build")
    ck, twin, mine = (os.path.join(work, n_) for n_ in ("ck", "twin", "mine"))
    argv = RUNTIME_ARGV + ["--steps", str(RUNTIME_STEPS), "--ckpt-every", "2"]
    try:
        driver = respawn_driver(["repro_torch.launch.train", *argv, "--dp", "2", "--ckpt-dir",
                                 ck, "--log-every", "1"], os.path.join(work, "run"))
        killed, faults = killer(1, RESPAWN_KILL_STEP, "step")

        def snapshot(d, result):
            # hard links: a checkpoint's files are written once (to a .tmp
            # directory, then renamed) and never changed, so the copies
            # cost no 4.7 GB of writing each
            if result.generation == 0:
                shutil.copytree(ck, twin, copy_function=os.link)
                shutil.copytree(ck, mine, copy_function=os.link)
        report = driver.run_elastic(max_generations=3, gen_timeout_s=600, faults=faults,
                                    on_generation_end=snapshot)
        logs = drill_report(driver, report, killed, "train drill")
        log1 = logs[(1, 0)]
        step_s = re.findall(r"\(([\d.]+)s/step\)", logs[(0, 0)])
        start = int(re.search(r"^resumed at step (\d+)$", log1, re.M)[1])
        losses = json.loads(re.search(r"^losses (\[.*\])$", log1, re.M)[1])
        restored = re.search(r"^restored step .*$", log1, re.M)[0]
        if not 0 < start < RUNTIME_STEPS or len(losses) != RUNTIME_STEPS - start:
            raise AssertionError(f"generation 1 resumed at {start} with losses {losses}")
        final = os.path.join(ck, f"step_{RUNTIME_STEPS:08d}")

        # the fault-free (1, 1) launcher from the first copy, in this process
        reset_counts()
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            twin_losses = launch_train.main(argv + ["--ckpt-dir", twin])
        torch.cuda.synchronize()
        twin_s, twin_counts = time.perf_counter() - t0, launch_counts()
        if twin_losses != losses:
            raise AssertionError(f"the fault-free launcher's losses {twin_losses}, generation "
                                 f"1's {losses}")
        if f"resumed at step {start}" not in buf.getvalue():
            raise AssertionError(f"the fault-free launcher did not resume at {start}")
        n_leaves = same_checkpoint(final, os.path.join(twin, f"step_{RUNTIME_STEPS:08d}"))
        expect_counts("phase 55 twin", twin_counts,
                      flash_on_tile(2 * RUNTIME_LAYERS * (RUNTIME_STEPS - start)))

        # the second copy restored here and stepped to the end, counted
        t0 = time.perf_counter()
        bundle, ctx, tc, batches, fresh = runtime_setup()
        state = fresh()
        state, at = restore_checkpoint(os.path.join(mine, f"step_{start:08d}"), state)
        step_fn = build_train_step(bundle.loss_fn(ctx), tc, ctx=ctx,
                                   param_specs=bundle.param_specs(state["params"]))
        reset_counts()
        mine_losses = []
        for b in batches[at:]:
            state, m = step_fn(state, b)
            mine_losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        mine_s, counts = time.perf_counter() - t0, launch_counts()
        expect_counts("phase 55 in process", counts,
                      flash_on_tile(2 * RUNTIME_LAYERS * (RUNTIME_STEPS - at)))
        if mine_losses != losses:
            raise AssertionError(f"in-process losses {mine_losses}, generation 1's {losses}")
        on_disk = checkpoint_leaves(final)
        for p_, leaf in leaf_paths(state):
            y = leaf.detach().cpu()
            y = y.view(torch.int16).numpy().view(on_disk[p_].dtype) \
                if y.dtype == torch.bfloat16 else y.numpy()
            if not same_bits(on_disk[p_], y):
                raise AssertionError(f"in-process state differs from generation 1's at {p_}")
        del state, step_fn, batches
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    say(55, f"[{DRILL_LABEL}] on {card}: MultiprocessDriver over python -m "
            f"repro_torch.launch.train {' '.join(argv)} --dp 2 --backend gloo --ckpt-dir D "
            f"--heartbeat-dir H --stall-after {RESPAWN_STALL_S}, rank 1 SIGKILLed at step "
            f"{RESPAWN_KILL_STEP}: generations {[g.codes for g in report.generations]}, rank 0 "
            f"through liveness ({re.search(r'liveness failure .*', logs[(0, 0)])[0]}); "
            f"generation 0 at {step_s[-1] if step_s else '?'} s a step (rank 0's host clock from "
            f"the loop's start, its first save included); generation 1 a world of one at (1, 1), resumed at step {start} "
            f"({restored}); "
            f"{drill_times(driver, report, killed)}; losses "
            f"{', '.join(f'{x:.6f}' for x in losses)}: the fault-free (1, 1) launcher's from a "
            f"copy of D ({twin_s:.1f} s in this process, {twin_counts['flash_attention']} flash "
            f"launches) and an in-process kernel-mode run's from another "
            f"({counts['flash_attention']} flash launches, tile path; {mine_s:.1f} s with "
            f"init and restore), bit for bit; the final "
            f"checkpoint's {n_leaves} leaves the fault-free launcher's and the in-process "
            f"run's bits")
    return {"respawn_flash_launches": counts["flash_attention"],
            "respawn_twin_flash_launches": twin_counts["flash_attention"]}


def serve_respawn_phase(card) -> dict:
    """Phase 56: the dense serve launcher over full-width chatglm3-6b cut to
    RUNTIME_SERVE_LAYERS layers, kernel mode, 8 requests x 32 tokens at batch
    4, --dp 2 with --journal J, as the workers of MultiprocessDriver; rank 1
    SIGKILLed at tick 10.  Gates: drill_report's; rank 0 journals a
    non-empty set of unfinished requests; generation 1 resubmits it and
    drains; every request finishes once across the generations; the merged
    tokens are an uninterrupted drain's at one rank in this process (its
    fused GEMV + AllReduce launches counted, all on the stream path), a
    difference passing only at a near tie of that drain's logits (phase
    43's rule: phase 5's logits_tol).  Returns the fused row's numbers."""
    import io
    import shutil
    import tempfile

    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.engine import DecodeEngine

    (ROOT / "build").mkdir(exist_ok=True)
    work = tempfile.mkdtemp(prefix="phase56_", dir=ROOT / "build")
    journal = os.path.join(work, "journal.json")
    try:
        driver = respawn_driver(["repro_torch.launch.serve", *RESPAWN_SERVE, "--dp", "2",
                                 "--journal", journal], os.path.join(work, "run"))
        killed, faults = killer(1, RESPAWN_KILL_TICK, "tick")
        report = driver.run_elastic(max_generations=3, gen_timeout_s=600, faults=faults)
        logs = drill_report(driver, report, killed, "serve drill")
        with open(journal) as f:
            journaled = json.load(f)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    n = int(re.search(r"journal: persisted (\d+) unfinished", logs[(0, 0)])[1])
    if not journaled or len(journaled) != n or \
            f"journal: resubmitted {n} unfinished requests" not in logs[(1, 0)]:
        raise AssertionError(f"serve drill: journal of {len(journaled)} requests, logs say {n}")
    streams = [{int(u): json.loads(t_) for u, t_ in
                re.findall(r"req (\d+): prompt .* -> (\[.*\])", logs[(g, 0)])} for g in (0, 1)]
    if set(streams[0]) & set(streams[1]):
        raise AssertionError(f"requests finished twice: {set(streams[0]) & set(streams[1])}")
    merged = {**streams[0], **streams[1]}
    n_req = int(RESPAWN_SERVE[RESPAWN_SERVE.index("--requests") + 1])
    if sorted(merged) != list(range(n_req)):
        raise AssertionError(f"serve drill: requests served {sorted(merged)}")

    # the uninterrupted drain at one rank, its choosing logits kept
    chose = {}
    greedy = DecodeEngine._greedy

    def spy(self, logits):
        for i, req in enumerate(self.slots):
            if req is not None and req.consumed >= len(req.prefix):
                chose[(req.uid, len(req.tokens))] = logits[i].float().cpu()
        return greedy(self, logits)
    DecodeEngine._greedy = spy
    reset_counts()
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            want = {r.uid: r.tokens for r in launch_serve.main(RESPAWN_SERVE)}
    finally:
        DecodeEngine._greedy = greedy
    torch.cuda.synchronize()
    counts = launch_counts()
    fused = counts["fused_matmul_allreduce"]
    if fused == 0 or counts["fused_matmul_allreduce.stream"] != fused:
        raise AssertionError(f"the uninterrupted drain's fused launches: {counts}")
    uids = sorted(want)
    notes = []
    if merged != want:
        if "logits_tol" not in GLM_DECODE:
            raise AssertionError("the drill's tokens differ from the uninterrupted drain's and "
                                 "phase 5's logits_tol is not there to judge a near tie")
        notes = near_tie_flips([merged[u] for u in uids], [want[u] for u in uids],
                               lambda k_, i: chose[(uids[k_], i)], GLM_DECODE["logits_tol"])
    say(56, f"[{DRILL_LABEL}] on {card}: MultiprocessDriver over python -m "
            f"repro_torch.launch.serve {' '.join(RESPAWN_SERVE)} --dp 2 --backend gloo --journal "
            f"J --heartbeat-dir H --stall-after {RESPAWN_STALL_S}, rank 1 SIGKILLed at tick "
            f"{RESPAWN_KILL_TICK}: generations {[g.codes for g in report.generations]}; rank 0 "
            f"journaled {n} unfinished requests ({len(streams[0])} finished before the kill), "
            f"generation 1 (a world of one) resubmitted and drained them; "
            f"{drill_times(driver, report, killed)}; every request once; the merged tokens "
            + ("the uninterrupted drain's" if merged == want else
               f"differ from the uninterrupted drain's only at near ties ({'; '.join(notes)})")
            + f" ({fused} fused GEMV + AllReduce launches in that drain, all on the stream path)")
    return {"respawn_drain_fused_launches": fused}


def respawn_phases(card) -> tuple[dict, dict]:
    """Phases 55-56; returns the flash and fused rows' numbers."""
    flash = train_respawn_phase(card)
    torch.cuda.empty_cache()
    fused = serve_respawn_phase(card)
    torch.cuda.empty_cache()
    return flash, fused


# ---------------------------------------------------------------------------
# deepseek-v3-671b serving (phases 57-58)
# ---------------------------------------------------------------------------
# 5 of its 61 layers: the 3 dense-prefix layers (MLA 0.37 GB and a SwiGLU of
# d_ff 18432, 0.79 GB, each) and 2 MoE layers (256 routed experts of d_ff
# 2048, 22.55 GB, a shared expert, 0.09 GB, and MLA), with the tied table
# (1.85 GB): 51.4 GB of bf16 weights.  A prefill of 4 x 2048 (C = ceil(8192
# x 8 x 1.25 / 256) = 320: the expert FFN's tile path), then 8 decode steps
# at batch 4 (C = 1: its stream path); the engine's drain of the launcher's
# 4 seeded requests x 8 tokens
DSV3_LAYERS = 5
DSV3_B, DSV3_S, DSV3_STEPS = 4, 2048, 8
DSV3_REQ, DSV3_NEW = 4, 8


def deepseek_bundle():
    from repro_torch.configs.registry import get_arch

    b = get_arch("deepseek-v3-671b")
    return dataclasses.replace(b, config=dataclasses.replace(b.config, n_layers=DSV3_LAYERS))


def ffn_bound(buf, w, valid_slots=None):
    """Least time of the expert FFN on the dispatch buffer ``buf`` [1, 1, E,
    C, D] with experts ``w`` (w_up, w_gate, w_down), counting what this
    input needs: the weights of the experts that hold a token (a slot that
    is not all zero), read once, the buffer read and the output written
    once; or the bf16 operations of its token slots (``valid_slots``, else
    every nonzero slot) at the tensor-core peak.  Returns (ms, bound_by,
    experts used, the bound with every expert's weights)."""
    E, C, D = buf.shape[2:]
    Fd = w[0].shape[2]
    live = buf[0, 0].abs().amax(-1) > 0                           # [E, C]
    used = int(live.any(-1).sum())
    slots = int(live.sum()) if valid_slots is None else valid_slots
    item = buf.element_size()
    per_expert = 3 * D * Fd * item
    t_bytes = (2 * buf.numel() * item + used * per_expert) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * 3 * slots * D * Fd / BF16_FLOPS * 1e3
    t_all = max((2 * buf.numel() * item + E * per_expert) / HBM_BYTES_PER_S * 1e3, t_ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), used, t_all


def main_path_buffer(ffn, h, mcfg):
    """The dispatch buffer [1, 1, E, C, D] the MoE layer builds from its
    input h at one rank (``models/moe.py``'s routing), and its valid slots."""
    from repro_torch.models.moe import _dispatch_buf, _route

    toks = h.reshape(-1, mcfg.d_model)
    _, e_clip, p_clip, valid, cap = _route(mcfg, toks, ffn["router"])
    buf = _dispatch_buf(mcfg, toks, e_clip, p_clip, valid, cap, h.dtype)
    return buf[None, None], int(valid.sum())


def serve_launcher_run(argv, n_req, want_counts, what) -> dict:
    """The serve launcher in this process on ``argv``, drawing its own
    weights (freed when it returns): it must serve ``n_req`` requests, and
    its launches must be ``want_counts(steps)`` (every launch counted on
    its path)."""
    import io

    from repro_torch.launch import serve as launch_serve

    out = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        fin = launch_serve.main(argv)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    text = out.getvalue()
    served = re.search(r"served (\d+) requests, (\d+) tokens in [\d.]+s \(([\d.]+) tok/s, "
                       r"(\d+) steps, ([\d.]+) ms/step", text)
    if served is None or int(served[1]) != n_req or len(fin) != n_req:
        raise AssertionError(f"the launcher did not serve {n_req} requests:\n{text}")
    steps = int(served[4])
    expect_counts(what, counts, want_counts(steps))
    streams = {r.uid: (list(r.prompt), list(r.tokens)) for r in fin}
    del fin
    torch.cuda.empty_cache()
    return {"argv": " ".join(argv), "steps": steps, "tok_s": float(served[3]),
            "ms_step": float(served[5]), "wall": wall, "counts": counts, "streams": streams}


def deepseek_launcher_run() -> dict:
    """Phase 57(a): the serve launcher in this process at --arch
    deepseek-v3-671b --layers DSV3_LAYERS --fusion kernel."""
    argv = ["--arch", "deepseek-v3-671b", "--layers", str(DSV3_LAYERS), "--fusion", "kernel",
            "--requests", str(DSV3_REQ), "--max-new", str(DSV3_NEW)]
    cfg = deepseek_bundle().config
    run = serve_launcher_run(argv, DSV3_REQ, lambda steps: deepseek_decode_counts(steps, cfg),
                             "phase 57 launcher")
    moe = cfg.n_layers - cfg.dense_prefix
    return {**run, "per_step": f"{moe}, {moe}, {cfg.dense_prefix} and 0"}


def deepseek_decode_counts(steps, cfg):
    """The launches of ``steps`` kernel-mode decode steps of ``cfg``: per MoE
    layer a dispatch and a stream-path expert FFN, per dense-prefix layer a
    fused GEMV + AllReduce on its stream path, no flash (MLA runs
    _span_flash)."""
    n, f = (cfg.n_layers - cfg.dense_prefix) * steps, cfg.dense_prefix * steps
    return {"fused_dispatch_a2a": n, "fused_gemm_a2a": n, "fused_gemm_a2a.stream": n,
            "fused_matmul_allreduce": f, "fused_matmul_allreduce.stream": f}


def deepseek_phases(card) -> dict:
    """Phases 57-58: full-width deepseek-v3-671b cut to DSV3_LAYERS of its 61
    layers (its 3 dense-prefix layers and 2 MoE layers) on one card, kernel
    mode against bulk mode.  Returns the three path kernels' rows' numbers
    at deepseek-v3's shapes."""
    import torch.nn.functional as F

    from repro_torch.kernels.fused_dispatch_a2a.ops import fused_dispatch_a2a
    from repro_torch.kernels.fused_dispatch_a2a.ref import fused_dispatch_a2a_ref
    from repro_torch.kernels.fused_gemm_a2a.ops import fused_gemm_a2a, gemm_a2a_path
    from repro_torch.kernels.fused_gemm_a2a.ref import fused_gemm_a2a_ref
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.models import mla as mla_mod
    from repro_torch.models import transformer as tfm
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    bf16 = torch.bfloat16
    # 57(a) -------------------------------------------------------------
    lr = deepseek_launcher_run()
    say(57, f"(a) on {card}: python -m repro_torch.launch.serve {lr['argv']} in this process: "
            f"{DSV3_REQ} requests served, {lr['steps']} steps, {lr['ms_step']:.2f} ms/step, "
            f"{lr['tok_s']:.1f} tok/s, {lr['wall']:.1f} s with its weights' draw; launches "
            f"dispatch {lr['counts']['fused_dispatch_a2a']}, expert FFN "
            f"{lr['counts']['fused_gemm_a2a']} (stream path), fused GEMV "
            f"{lr['counts']['fused_matmul_allreduce']} (stream path), flash "
            f"{lr['counts']['flash_attention']} ({lr['per_step']} a step)")

    # 57(b) -------------------------------------------------------------
    bundle = deepseek_bundle()
    cfg, mcfg = bundle.config, bundle.config.moe
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(57)
    ffn0 = params["layers"][0]["ffn"]
    wu, wg, wd = ffn0["w_up"], ffn0["w_gate"], ffn0["w_down"]
    E, D, Fd = wu.shape
    w_pre = params["prefix"][0]["ffn"]["w_down"]                # [18432, 7168]
    kern = {}
    for cap in (1, 320):
        xt = randn(gen, (1, 1, E, cap, D), bf16)
        if not torch.equal(fused_dispatch_a2a(xt), fused_dispatch_a2a_ref(xt)):
            raise AssertionError(f"fused_dispatch_a2a at C={cap}: differs from its plain version")
        want_path = gemm_a2a_path(bf16, 1, 1, E, cap, D, Fd)
        got, took = on_path(fused_gemm_a2a, lambda: fused_gemm_a2a(xt, wu, wg, wd))
        if took != want_path or took != ("stream" if cap == 1 else "tile"):
            raise AssertionError(f"fused_gemm_a2a at C={cap}: took the {took} path, "
                                 f"gemm_a2a_path says {want_path}")
        kern[cap] = check_rel(f"fused_gemm_a2a C={cap} {took}", got,
                              fused_gemm_a2a_ref(xt, wu, wg, wd, "silu"), REL_BF16)
        del xt, got
    xg = randn(gen, (DSV3_B, w_pre.shape[0]), bf16)
    gemv_path_want = fused_path(bf16, DSV3_B, *w_pre.shape)
    got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(xg, w_pre))
    if took != gemv_path_want or took != "stream":
        raise AssertionError(f"fused_matmul_allreduce [{DSV3_B},{w_pre.shape[0]}]: took the "
                             f"{took} path, fused_path says {gemv_path_want}")
    gemv_err = check_close("fused_matmul_allreduce deepseek prefix w_down", got,
                           fused_matmul_allreduce_ref(xg, w_pre), BF16_TOL)
    torch.cuda.empty_cache()
    say(57, f"(b) deepseek-v3-671b full width cut to {cfg.n_layers} of 61 layers ({cfg.dense_prefix} "
            f"dense prefix, d{cfg.d_model}, MLA {cfg.mla.n_heads} heads kv_lora "
            f"{cfg.mla.kv_lora_rank} rope {cfg.mla.qk_rope_dim}, {mcfg.n_experts} experts top-"
            f"{mcfg.top_k} d_ff {mcfg.d_ff} + {mcfg.n_shared_experts} shared, {n_params / 1e9:.2f}B "
            f"params, {n_bytes / 1e9:.1f} GB {cfg.param_dtype}, init {init_s:.1f}s); the path's "
            f"kernels vs plain on layer 3's experts and layer 0's FFN down: dispatch "
            f"[1,1,{E},1,{D}] and [1,1,{E},320,{D}] bf16 exact; fused_gemm_a2a max abs/rel err "
            f"C=1 stream path {kern[1][0]:.3g}/{kern[1][1]:.3g}, C=320 tile path "
            f"{kern[320][0]:.3g}/{kern[320][1]:.3g} (bound {REL_BF16} rel); "
            f"fused_matmul_allreduce [{DSV3_B},{w_pre.shape[0]}]@{list(w_pre.shape)} stream "
            f"path {gemv_err[0]:.3g}/{gemv_err[1]:.3g} (bound {BF16_TOL})")

    # 57(c) -------------------------------------------------------------
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)

    def serve(decode, log=None):
        def step(tok, cache, pos):
            logits, cache = decode(params, tok, cache, pos)
            if log is not None:
                log.append((tok.clone(), pos.clone(), logits.clone()))
            return logits, cache
        return serve_requests(step, bundle, DSV3_B, DSV3_REQ, DSV3_NEW)

    log_k = []
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    reqs_k, _ = serve(dec_k, log_k)
    steps = len(log_k)
    expect_counts("phase 57 drain", launch_counts(), deepseek_decode_counts(steps, cfg))
    reqs_b, _ = serve(dec_b)
    tf = teacher_forced_moe(bundle, params, ctx_k, ctx_b, log_k)
    differing, flips = routed_flips(reqs_k, reqs_b, tf, cfg.vocab)
    peak_c = torch.cuda.max_memory_allocated() / 1e9
    want_c = deepseek_decode_counts(steps, cfg)
    say(57, f"(c) DecodeEngine, batch {DSV3_B}, {DSV3_REQ} requests x {DSV3_NEW} tokens: "
            f"{steps} decode steps, launches dispatch {want_c['fused_dispatch_a2a']}, expert FFN "
            f"{want_c['fused_gemm_a2a']} (stream path), fused GEMV "
            f"{want_c['fused_matmul_allreduce']} (stream path), flash 0; {tf['summary']}; "
            f"kernel streams {[r.tokens for r in reqs_k]}; bulk streams "
            f"{[r.tokens for r in reqs_b]}; differing tokens {differing}"
            + (f" ({'; '.join(flips)})" if flips else "") + f"; peak {peak_c:.1f} GB")

    # 57(d) -------------------------------------------------------------
    L, B, S = cfg.n_layers, DSV3_B, DSV3_S
    tokens = torch.randint(0, cfg.vocab, (B, S), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(57))
    seen = []

    def spy(ctx, ffn, h, m_cfg, **kw):
        out = moe_apply(ctx, ffn, h, m_cfg, **kw)
        seen.append((ffn, h, out))
        return out

    log = GateLog()
    moe_layers = L - cfg.dense_prefix
    torch.cuda.reset_peak_memory_stats()
    with log.active(), swapped(tfm, "moe_apply", spy):
        (lk, cache_k), pre_counts = counted_run(
            lambda: bundle.prefill_fn(ctx_k)(params, {"tokens": tokens}),
            {"fused_dispatch_a2a": moe_layers, "fused_gemm_a2a": moe_layers,
             "fused_gemm_a2a.tile": moe_layers})
    peak_d = torch.cuda.max_memory_allocated() / 1e9
    pre_rel = 0.0
    for i, (ffn, h, f) in enumerate(seen):
        pre_rel = max(pre_rel, check_rel(f"prefill MoE layer {i}: kernel vs bulk", f,
                                         moe_apply(ctx_b, ffn, h, mcfg), REL_BF16)[1])
    h_pre = seen[0][1]
    del seen
    with GateLog(log.gates).active():
        lb, cache_b = bundle.prefill_fn(ctx_b)(params, {"tokens": tokens})
    lx, cache_x = exact_prefill(params, cfg, tokens, log.gates)
    torch.cuda.empty_cache()
    pre_txt = bounded_errors("prefill", {"logits": (lk, lb, lx),
                                         **{k_: (cache_k[k_], cache_b[k_], cache_x[k_])
                                            for k_ in ("c", "kr")}})
    del cache_x

    def decode_cache(c):
        full = bundle.init_cache(B, "cuda")
        for k_ in full:
            full[k_][:, :, :S] = c[k_]
        return full

    caches = {"kernel": decode_cache(cache_k), "bulk": decode_cache(cache_b)}
    del cache_k, cache_b
    tok = lk.argmax(-1).to(torch.int32)
    d_dec, steps_tok = 0.0, []
    reset_counts()
    for s in range(DSV3_STEPS):
        pos = torch.full((B,), S + s, dtype=torch.int32, device="cuda")
        gk, caches["kernel"] = dec_k(params, tok, caches["kernel"], pos)
        counts_k = launch_counts()
        gb, caches["bulk"] = dec_b(params, tok, caches["bulk"], pos)
        if launch_counts() != counts_k:
            raise AssertionError("bulk-mode decode launched a kernel")
        if not torch.isfinite(gk).all():
            raise AssertionError(f"decode step {s}: non-finite logits")
        d_dec = max(d_dec, errors(gk, gb)[0])
        tok = gk.argmax(-1).to(torch.int32)
        steps_tok.append(tok[:, 0].tolist())
    expect_counts("phase 57 decode from the prefill", launch_counts(),
                  deepseek_decode_counts(DSV3_STEPS, cfg))
    if not all(0 <= t_ < cfg.vocab for st in steps_tok for t_ in st):
        raise AssertionError("decode from the prefill: a token out of range")
    del caches
    torch.cuda.empty_cache()
    say(57, f"(d) prefill of {B}x{S} seeded tokens through prefill_fn: kernel mode launches "
            f"dispatch {pre_counts['fused_dispatch_a2a']}, expert FFN "
            f"{pre_counts['fused_gemm_a2a']} (tile path {pre_counts['fused_gemm_a2a.tile']}), "
            f"fused GEMV {pre_counts['fused_matmul_allreduce']}, flash "
            f"{pre_counts['flash_attention']}; every MoE layer, kernel vs bulk on identical "
            f"input: max rel err {pre_rel:.3g} (bound {REL_BF16}); bulk and exact f32 "
            f"teacher-forced on the kernel run's routing, kernel vs exact / bulk vs exact / "
            f"kernel vs bulk max abs err (bound {LOGITS_TOL_FACTOR} x the second): {pre_txt}; "
            f"peak {peak_d:.1f} GB; {DSV3_STEPS} greedy decode steps from position {S} (bulk "
            f"teacher-forced on the kernel run's tokens): launches as the drain's a step, logits "
            f"kernel vs bulk max abs {d_dec:.3g}, tokens {steps_tok}")

    # 58 ----------------------------------------------------------------
    prof = {}
    for mode, ctx in (("kernel", ctx_k), ("bulk", ctx_b)):
        fn = bundle.prefill_fn(ctx)
        prof[f"prefill {mode}"] = profile_device(lambda i: fn(params, {"tokens": tokens}), 1,
                                                 "prefill")
    for mode, dec in (("kernel", dec_k), ("bulk", dec_b)):
        prof[f"decode {mode}"] = profile_decode(dec, params, bundle.init_cache(B, "cuda"),
                                                log_k[:4])
    # the expert FFN on the main path's own buffers: the decode's (C = 1: the
    # stream path, each expert's weights streamed, only those of the experts
    # holding a token needed) and the prefill's (C = 320: the tile path)
    rows = {}
    for name, h, iters in (("stream", tf["h_moe"], 20), ("tile", h_pre, 5)):
        buf, n_valid = main_path_buffer(ffn0, h, mcfg)
        x0 = buf[0]
        bulk = lambda: torch.einsum(
            "necf,efd->necd", F.silu(torch.einsum("necd,edf->necf", x0, wg))
            * torch.einsum("necd,edf->necf", x0, wu), wd)
        got, took = on_path(fused_gemm_a2a, lambda: fused_gemm_a2a(buf, wu, wg, wd))
        if took != name:
            raise AssertionError(f"fused_gemm_a2a on the main path's C={buf.shape[3]} buffer: "
                                 f"took the {took} path")
        err = check_rel(f"fused_gemm_a2a main-path C={buf.shape[3]}", got,
                        fused_gemm_a2a_ref(buf, wu, wg, wd, "silu"), REL_BF16)
        turns = {name: [], "bulk": []}
        for which in (name, "bulk", "bulk", name):
            fn = bulk if which == "bulk" else (lambda: fused_gemm_a2a(buf, wu, wg, wd))
            turns[which].append(time_ms(fn, iters=iters, warmup=2))
        plain = time_ms(lambda: fused_gemm_a2a_ref(buf, wu, wg, wd, "silu"), iters=3, warmup=1)
        bound, by, used, bound_all = ffn_bound(buf, (wu, wg, wd),
                                               None if name == "stream" else n_valid)
        disp = time_ms(lambda: fused_dispatch_a2a(buf), iters=50)
        copy_to = torch.empty_like(buf)
        rows[name] = dict(C=buf.shape[3], err=err, turns=turns, ms=min(turns[name]),
                          lib=min(turns["bulk"]), plain=plain, bound=bound, by=by, used=used,
                          bound_all=bound_all, slots=n_valid, disp=disp,
                          disp_plain=time_ms(lambda: fused_dispatch_a2a_ref(buf), iters=20),
                          copy=time_ms(lambda: copy_to.copy_(buf), iters=50),
                          disp_bound=2 * buf.numel() * buf.element_size() / HBM_BYTES_PER_S * 1e3)
        del buf, x0, got, copy_to
        torch.cuda.empty_cache()
    gemv_t = {"kernel": [], "matmul": []}
    for which in ("kernel", "matmul", "matmul", "kernel"):
        fn = ((lambda: fused_matmul_allreduce(xg, w_pre)) if which == "kernel"
              else (lambda: torch.matmul(xg, w_pre)))
        gemv_t[which].append(time_ms(fn, iters=200))
    gemv_plain = time_ms(lambda: fused_matmul_allreduce_ref(xg, w_pre), iters=20)
    gemv_bound, gemv_by = bound_ms(DSV3_B, w_pre.shape[0], w_pre.shape[1], 2)
    attn0 = params["prefix"][0]["attn"]
    h_attn = randn(gen, (B, S, cfg.d_model), bf16)
    mla_ms = time_ms(lambda: mla_mod.mla_context_attention(ctx_b, attn0, cfg.mla, h_attn),
                     iters=3, warmup=1)
    st, ti = rows["stream"], rows["tile"]
    say(58, f"on {card}, CUDA events: prefill of {B}x{S} and decode steps (profiles): "
            + "; ".join(f"{k_}: {v_}" for k_, v_ in prof.items())
            + f"; fused_gemm_a2a on the main path's buffers (turns kernel, bulk, bulk, kernel): "
            f"C=1 stream path {', '.join(f'{v:.4f}' for v in st['turns']['stream'])} ms, bulk "
            f"einsums {', '.join(f'{v:.4f}' for v in st['turns']['bulk'])} ms, plain "
            f"{st['plain']:.4f} ms, bound {st['bound']:.4f} ms ({st['by']}: the {st['used']} of "
            f"{E} experts holding a token; every expert's weights {st['bound_all']:.4f} ms), "
            f"max abs err {st['err'][0]:.3g}; C=320 tile path "
            f"{', '.join(f'{v:.3f}' for v in ti['turns']['tile'])} ms, bulk einsums "
            f"{', '.join(f'{v:.3f}' for v in ti['turns']['bulk'])} ms, plain {ti['plain']:.3f} ms, "
            f"bound {ti['bound']:.3f} ms ({ti['by']}: {ti['slots']} routed slots of {E * 320}; all "
            f"slots {ti['bound_all']:.3f} ms), {ti['used']} experts used, max abs err "
            f"{ti['err'][0]:.3g}; dispatch C=1 {st['disp']:.4f} ms (plain {st['disp_plain']:.4f}, "
            f"Tensor.copy_ {st['copy']:.4f}, bound {st['disp_bound']:.5f}), C=320 "
            f"{ti['disp']:.4f} ms (plain {ti['disp_plain']:.4f}, Tensor.copy_ {ti['copy']:.4f}, "
            f"bound {ti['disp_bound']:.4f}); fused GEMV [{B},{w_pre.shape[0]}]@"
            f"{list(w_pre.shape)} (turns kernel, matmul, matmul, kernel) "
            f"{', '.join(f'{v:.4f}' for v in gemv_t['kernel'])} ms, torch.matmul "
            f"{', '.join(f'{v:.4f}' for v in gemv_t['matmul'])} ms, plain {gemv_plain:.4f} ms, "
            f"bound {gemv_bound:.4f} ms ({gemv_by}); MLA's plain prefill attention (bulk, "
            f"_span_flash) a layer at {B}x{S}: {mla_ms:.1f} ms")
    del params, h_attn, tf, log_k, h_pre
    torch.cuda.empty_cache()
    return {
        "fused_dispatch_a2a": {
            "deepseek_launches_per_decode_step": moe_layers,
            "deepseek_prefill_launches": moe_layers,
            "deepseek_ms": st["disp"], "deepseek_plain_ms": st["disp_plain"],
            "deepseek_bound_ms": st["disp_bound"], "deepseek_library_ms": st["copy"],
            "deepseek_prefill_ms": ti["disp"], "deepseek_prefill_bound_ms": ti["disp_bound"],
            "deepseek_prefill_library_ms": ti["copy"]},
        "fused_gemm_a2a": {
            "deepseek_launches_per_decode_step": moe_layers,
            "deepseek_prefill_tile_launches": moe_layers,
            "deepseek_stream_ms": st["ms"], "deepseek_stream_plain_ms": st["plain"],
            "deepseek_stream_bound_ms": st["bound"], "deepseek_stream_bound_by": st["by"],
            "deepseek_stream_bound_all_experts_ms": st["bound_all"],
            "deepseek_stream_library_ms": st["lib"], "deepseek_stream_max_abs_err": st["err"][0],
            "deepseek_tile_ms": ti["ms"], "deepseek_tile_plain_ms": ti["plain"],
            "deepseek_tile_bound_ms": ti["bound"], "deepseek_tile_bound_by": ti["by"],
            "deepseek_tile_library_ms": ti["lib"], "deepseek_tile_max_abs_err": ti["err"][0]},
        "fused_matmul_allreduce": {
            "deepseek_launches_per_decode_step": cfg.dense_prefix,
            "deepseek_ms": min(gemv_t["kernel"]),
            "deepseek_plain_ms": gemv_plain, "deepseek_bound_ms": gemv_bound,
            "deepseek_library_ms": min(gemv_t["matmul"]), "deepseek_max_abs_err": gemv_err[0]},
    }


# zamba2-7b (phases 59-60): its published widths at full depth, 81 Mamba-2
# blocks (6.98 G parameters, 13.95 GB bf16; the dense cache at batch 4 and
# max_seq 4096 6.7 GB): no cut.  A prefill of 4 x 2048 (the flash kernel's
# main shape at head size 224: [4, 2048, 32, 224]), 8 greedy decode steps
# from it, the hand-off at 64 tokens (56 prefilled, 8 decoded: a prompt
# longer than the SSD chunk of 64 must be a multiple of it), and the serve
# launcher's drain of 8 requests x 8 tokens at batch 4
ZAMBA_B, ZAMBA_S, ZAMBA_STEPS = 4, 2048, 8
ZAMBA_REQ, ZAMBA_NEW = 8, 8
ZAMBA_HANDOFF = 64


def zamba2_decode_counts(steps, cfg):
    """The launches of ``steps`` kernel-mode zamba2 decode steps: a
    stream-path fused GEMV + AllReduce per Mamba block's w_out and per
    group's shared-MLP down, no flash (decode attention is plain)."""
    n = (cfg.n_layers + cfg.n_groups) * steps
    return {"fused_matmul_allreduce": n, "fused_matmul_allreduce.stream": n}


def zamba2_launcher_run() -> dict:
    """Phase 59(a): the serve launcher in this process at --arch zamba2-7b
    --batch ZAMBA_B --fusion kernel over ZAMBA_REQ requests."""
    from repro_torch.configs.registry import get_arch

    argv = ["--arch", "zamba2-7b", "--batch", str(ZAMBA_B), "--requests", str(ZAMBA_REQ),
            "--max-new", str(ZAMBA_NEW), "--fusion", "kernel"]
    cfg = get_arch("zamba2-7b").config
    return serve_launcher_run(argv, ZAMBA_REQ, lambda steps: zamba2_decode_counts(steps, cfg),
                              "phase 59 launcher")


def zamba2_exact_params(params):
    """zamba2's parameters read in f32: the embedding and the shared block
    upcast whole (2.6 GB), the groups and the tail one at a time as the
    model's loops reach them (UpcastLayers)."""
    return {"embed": {"table": params["embed"]["table"].float()},
            "final_norm": params["final_norm"],
            "shared": _map(params["shared"], lambda t: t.float()),
            "groups": UpcastLayers(params["groups"]), "tail": UpcastLayers(params["tail"])}


def zamba2_decode_cache(cache, cfg, rows):
    """A decode cache of ``rows`` positions holding a prefill's ``cache``:
    its SSM and conv states, its k and v in rows [0, S)."""
    from repro_torch.models import zamba2 as zamba2_model

    dc = zamba2_model.init_cache(dataclasses.replace(cfg, max_seq=rows),
                                 cache["attn"]["k"].shape[1], "cuda")
    for grp in ("mamba", "tail"):
        for k_ in dc[grp]:
            dc[grp][k_].copy_(cache[grp][k_])
    for k_ in ("k", "v"):
        dc["attn"][k_][:, :, :cache["attn"][k_].shape[2]] = cache["attn"][k_]
    return dc


def zamba2_leaves(cache, rows=None):
    """A zamba2 cache's leaves by name (k and v cut to ``rows`` rows)."""
    out = {f"{grp} {k_}": v_ for grp in ("mamba", "tail") for k_, v_ in cache[grp].items()}
    out.update({f"attn {k_}": v_[:, :, :rows] for k_, v_ in cache["attn"].items()})
    return out


def zamba2_phases(card) -> dict:
    """Phases 59-60: zamba2-7b at its published widths and full depth on one
    card, kernel mode against bulk mode and an exact f32 evaluation.
    Returns the flash and fused kernels' rows' numbers at zamba2's shapes."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import (flash_attention, flash_attention_plain,
                                                         flash_path)
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref
    from repro_torch.models import attention
    from repro_torch.models import mamba2 as mamba2_model
    from repro_torch.models import zamba2 as zamba2_model
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.serve.engine import DecodeEngine, Request

    bf16, f32 = torch.bfloat16, torch.float32
    # 59(a) -------------------------------------------------------------
    lr = zamba2_launcher_run()
    bundle = get_arch("zamba2-7b")
    cfg = bundle.config
    per_step = cfg.n_layers + cfg.n_groups
    say(59, f"(a) on {card}: python -m repro_torch.launch.serve {lr['argv']} in this process: "
            f"{ZAMBA_REQ} requests served, {lr['steps']} steps, {lr['ms_step']:.2f} ms/step, "
            f"{lr['tok_s']:.1f} tok/s, {lr['wall']:.1f} s with its weights' draw; launches fused "
            f"GEMV {lr['counts']['fused_matmul_allreduce']} (stream path "
            f"{lr['counts']['fused_matmul_allreduce.stream']}: {per_step} a step), flash "
            f"{lr['counts']['flash_attention']}")

    # 59(b) -------------------------------------------------------------
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t_.numel() for t_ in _leaves(params))
    n_bytes = sum(t_.numel() * t_.element_size() for t_ in _leaves(params))
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)
    # the second wave: the requests that took a reused slot, on a fresh
    # engine (every slot new) with the same seed-0 weights
    second = sorted(lr["streams"])[ZAMBA_B:]
    eng = DecodeEngine(lambda tk, c, p: dec_k(params, tk, c, p),
                       lambda b: bundle.init_cache(b, "cuda"), ZAMBA_B, device="cuda",
                       max_seq=cfg.max_seq, reset_slot_fn=bundle.reset_slot_fn())
    for u in second:
        eng.submit(Request(uid=u, prompt=lr["streams"][u][0], max_new=ZAMBA_NEW))
    fresh = {r.uid: r.tokens for r in eng.run_until_drained()}
    del eng
    torch.cuda.empty_cache()
    if any(fresh[u] != lr["streams"][u][1] for u in second):
        raise AssertionError(f"the launcher's reused slots {[lr['streams'][u][1] for u in second]}"
                             f" differ from a fresh engine's {[fresh[u] for u in second]}")

    gen = torch.Generator(device="cuda").manual_seed(59)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = ZAMBA_B, ZAMBA_S
    flash_errs = {}
    for name, b, sq, sk, delta, h, g_kv, dt, causal in (
            ("main", B, S, S, 0, Hq, Hkv, bf16, True),
            ("f32 S=300", 1, 300, 300, 0, 4, 4, f32, True),
            ("f32 non-causal g=4 S=129", 2, 129, 129, 0, 8, 2, f32, False),
            ("S=37", 2, 37, 37, 0, 4, 4, bf16, True), ("S=1", 2, 1, 1, 0, 4, 4, bf16, True),
            ("ragged Sk=1000 delta=900 stats", 2, 100, 1000, 900, 4, 4, bf16, True),
            ("f32 ragged Sk=1000 delta=900 stats", 2, 100, 1000, 900, 4, 2, f32, True)):
        q = randn(gen, (b, sq, h, hd), dt)
        k, v = randn(gen, (b, sk, g_kv, hd), dt), randn(gen, (b, sk, g_kv, hd), dt)
        stats = sk != sq
        want = flash_attention_plain(q, k, v, causal=causal, delta=delta, stats=stats)
        got, took = on_path(flash_attention, lambda: flash_attention(
            q, k, v, causal=causal, delta=delta, stats=stats))
        if took != flash_path(dt, hd) or took != "cuda_core":
            raise AssertionError(f"flash_attention d={hd} {name}: took the {took} path")
        tol = BF16_TOL if dt == bf16 else F32_TOL
        if stats:
            flash_errs[name] = [check_close(f"flash d={hd} {name} {part}", g_, w_,
                                            tol if part == "o" else F32_TOL)
                                for part, g_, w_ in zip("oml", got, want)]
        else:
            flash_errs[name] = [check_close(f"flash d={hd} {name}", got, want, tol)]
        del q, k, v, want, got
    torch.cuda.empty_cache()
    w_out = params["groups"][0]["mamba"][0]["m"]["w_out"]          # [7168, 3584]
    w_mlp = params["shared"]["mlp"]["w_down"]                       # [14336, 7168]
    gemv_shapes = {"w_out decode": (B, w_out), "w_out prefill": (B * S, w_out),
                   "shared MLP down decode": (B, w_mlp)}
    gemv = {}
    for name, (rows, w_) in gemv_shapes.items():
        x_ = randn(gen, (rows, w_.shape[0]), bf16)
        want_path = "tile" if rows > B else "stream"
        got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x_, w_))
        if took != want_path or took != fused_path(bf16, rows, *w_.shape):
            raise AssertionError(f"fused_matmul_allreduce zamba2 {name}: took the {took} path")
        gemv[name] = dict(x=x_, w=w_, path=took, err=check_close(
            f"fused_matmul_allreduce zamba2 {name}", got, fused_matmul_allreduce_ref(x_, w_),
            BF16_TOL))
        del got
    say(59, f"(b) zamba2-7b full width and depth ({cfg.n_layers} Mamba-2 blocks: {cfg.n_groups} "
            f"groups of {cfg.attn_every} + {cfg.n_tail}, d{cfg.d_model}, {cfg.mamba.n_heads} SSM "
            f"heads of {cfg.mamba.head_dim}, state {cfg.d_state}; shared attention {Hq}/{Hkv} "
            f"heads of {hd} on {cfg.d_attn}, LoRA {cfg.lora_r}, d_ff {cfg.d_ff}; "
            f"{n_params / 1e9:.3f}B params, {n_bytes / 1e9:.2f} GB {cfg.param_dtype}, init "
            f"{init_s:.1f}s); the launcher's reused slots ({second}) equal a fresh engine's "
            f"streams: {[fresh[u] for u in second]}; flash_attention at d={hd} vs plain on the "
            f"cuda_core path (bound: bf16 {BF16_TOL}, f32 {F32_TOL}; m and l {F32_TOL}), max "
            f"abs/rel err: " + "; ".join(f"{n_} " + ", ".join(f"{e[0]:.3g}/{e[1]:.3g}" for e in es)
                                        for n_, es in flash_errs.items())
            + f" (main [{B},{S},{Hq},{hd}] over {Hkv} kv heads bf16 causal; stats: o, m, l); "
            f"fused_matmul_allreduce vs plain (bound {BF16_TOL}): "
            + "; ".join(f"{n_} [{g_['x'].shape[0]},{g_['w'].shape[0]}]@{list(g_['w'].shape)} "
                        f"{g_['path']} path {g_['err'][0]:.3g}/{g_['err'][1]:.3g}"
                        for n_, g_ in gemv.items()))

    # 59(c) -------------------------------------------------------------
    tokens = torch.randint(0, cfg.vocab, (B, S + ZAMBA_STEPS), device="cuda", generator=gen)
    batch = {"tokens": tokens[:, :S]}
    pre_k, pre_b = bundle.prefill_fn(ctx_k), bundle.prefill_fn(ctx_b)
    cfg_x = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params_x = zamba2_exact_params(params)
    pre_x = lambda b_: zamba2_model.prefill_forward(ctx_b, params_x, cfg_x, b_)
    layer_errs = []

    def spy(q, k, v, **kw):
        """The kernel, then its plain version on the identical input."""
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, scale=kw["scale"], causal=kw["causal"])
        layer_errs.append(check_close(f"prefill group {len(layer_errs)} flash", got, want,
                                      BF16_TOL)[0])
        return got

    torch.cuda.reset_peak_memory_stats()
    pre_want = {"fused_matmul_allreduce": cfg.n_layers,
                "fused_matmul_allreduce.tile": cfg.n_layers,
                "flash_attention": cfg.n_groups, "flash_attention.cuda_core": cfg.n_groups}
    with swapped(attention, "flash_attention", spy):
        (lk, ck), pre_counts = counted_run(lambda: pre_k(params, batch), pre_want)
    (lb, cb), _ = counted_run(lambda: pre_b(params, batch), {})
    lx, cx = pre_x(batch)
    peak_c = torch.cuda.max_memory_allocated() / 1e9
    for lg in (lk, lb, lx):
        if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"prefill logits: shape {tuple(lg.shape)} or non-finite")
    leaves_k, leaves_b, leaves_x = zamba2_leaves(ck), zamba2_leaves(cb), zamba2_leaves(cx)
    pre_txt = bounded_errors("prefill", {"logits": (lk, lb, lx), **{
        k_: (leaves_k[k_], leaves_b[k_], leaves_x[k_]) for k_ in leaves_k}})
    say(59, f"(c) prefill of {B}x{S} seeded tokens through prefill_fn: kernel mode launches "
            f"fused GEMV {pre_counts['fused_matmul_allreduce']} (tile path "
            f"{pre_counts['fused_matmul_allreduce.tile']}), flash {pre_counts['flash_attention']} "
            f"(cuda_core path {pre_counts['flash_attention.cuda_core']}); bulk mode none; every "
            f"group's flash output vs plain on its input: max abs err {max(layer_errs):.3g} over "
            f"{len(layer_errs)} groups (bound {BF16_TOL}); kernel vs exact / bulk vs exact / "
            f"kernel vs bulk max abs err (bound {LOGITS_TOL_FACTOR} x the second): {pre_txt}; "
            f"peak {peak_c:.1f} GB")

    # 59(d) -------------------------------------------------------------
    rows_x = S + ZAMBA_STEPS
    caches = {"kernel": zamba2_decode_cache(ck, cfg, cfg.max_seq)}
    del ck, leaves_k
    caches["bulk"] = zamba2_decode_cache(cb, cfg, cfg.max_seq)
    del cb, leaves_b
    caches["exact"] = zamba2_decode_cache(cx, cfg_x, rows_x)
    del cx, leaves_x
    torch.cuda.empty_cache()
    tok, logits, log_k = lk.argmax(-1).to(torch.int32), {m_: [] for m_ in caches}, []
    steps_tok = []
    reset_counts()
    for s_ in range(ZAMBA_STEPS):
        pos = torch.full((B,), S + s_, dtype=torch.int32, device="cuda")
        log_k.append((tok, pos))
        gk, caches["kernel"] = dec_k(params, tok, caches["kernel"], pos)
        logits["kernel"].append(gk)
        tok = gk.argmax(-1).to(torch.int32)
        steps_tok.append(tok[:, 0].tolist())
    torch.cuda.synchronize()
    expect_counts("phase 59 decode from the prefill", launch_counts(),
                  zamba2_decode_counts(ZAMBA_STEPS, cfg))
    for tok_, pos in log_k:                      # teacher-forced on the kernel run's tokens
        gb, caches["bulk"] = dec_b(params, tok_, caches["bulk"], pos)
        gx, caches["exact"] = zamba2_model.decode_step(ctx_b, params_x, cfg_x, tok_,
                                                       caches["exact"], pos)
        logits["bulk"].append(gb)
        logits["exact"].append(gx)
    cat = {m_: torch.cat(v_, dim=1) for m_, v_ in logits.items()}
    if not torch.isfinite(cat["kernel"]).all():
        raise AssertionError("decode from the prefill: non-finite logits")
    fin = {m_: zamba2_leaves(c_, rows_x) for m_, c_ in caches.items()}
    dec_txt = bounded_errors("decode", {"logits": (cat["kernel"], cat["bulk"], cat["exact"]), **{
        k_: tuple(fin[m_][k_][:, :, S:] if k_.startswith("attn") else fin[m_][k_]
                  for m_ in ("kernel", "bulk", "exact")) for k_ in fin["kernel"]}})
    del caches, fin, logits, cat
    torch.cuda.empty_cache()
    # the hand-off: a prefill of ZAMBA_HANDOFF tokens against a prefill of 8
    # fewer and 8 decode steps over the rest, in kernel mode
    head = tokens[:, :ZAMBA_HANDOFF]
    lp, cp = pre_k(params, {"tokens": head})
    lpx, cpx = pre_x({"tokens": head})
    cut = ZAMBA_HANDOFF - ZAMBA_STEPS
    _, cs = pre_k(params, {"tokens": head[:, :cut]})
    st = zamba2_decode_cache(cs, cfg, ZAMBA_HANDOFF)
    for i in range(cut, ZAMBA_HANDOFF):
        ld, st = dec_k(params, head[:, i:i + 1], st,
                       torch.full((B,), i, dtype=torch.int32, device="cuda"))
    handoff = []
    got_l, pre_l, ex_l = zamba2_leaves(st), zamba2_leaves(cp), zamba2_leaves(cpx)
    for key, got, pre, ex in (("logits", ld, lp, lpx),
                              *((k_, got_l[k_], pre_l[k_], ex_l[k_]) for k_ in got_l)):
        d_pd, d_px = errors(got, pre)[0], errors(pre, ex)[0]
        if d_pd > LOGITS_TOL_FACTOR * d_px:
            raise AssertionError(f"hand-off {key}: {cut} prefilled and {ZAMBA_STEPS} decoded are "
                                 f"{d_pd:.3g} from a {ZAMBA_HANDOFF}-token prefill, above "
                                 f"{LOGITS_TOL_FACTOR} x its distance {d_px:.3g} from exact f32")
        handoff.append(f"{key} {d_pd:.3g} (bound {LOGITS_TOL_FACTOR * d_px:.3g})")
    del st, cp, cpx, cs
    say(59, f"(d) {ZAMBA_STEPS} greedy decode steps from position {S} (k and v in rows [0, {S}) "
            f"of a {cfg.max_seq}-row cache): launches fused GEMV {ZAMBA_STEPS * per_step} "
            f"(stream path, {per_step} a step), flash 0; bulk and exact f32 teacher-forced on the "
            f"kernel run's tokens, max abs err kernel vs exact / bulk vs exact / kernel vs bulk "
            f"(bound {LOGITS_TOL_FACTOR} x the second; k and v the decoded rows): {dec_txt}; "
            f"tokens {steps_tok}; hand-off, kernel mode, {cut} prefilled + {ZAMBA_STEPS} decoded "
            f"vs a {ZAMBA_HANDOFF}-token prefill, max abs err (bound {LOGITS_TOL_FACTOR} x the "
            f"prefill's distance from exact f32): " + ", ".join(handoff))

    # 60 ----------------------------------------------------------------
    prof = {}
    for mode, ctx in (("kernel", ctx_k), ("bulk", ctx_b)):
        fn = bundle.prefill_fn(ctx)
        prof[f"prefill {mode}"] = profile_device(lambda i: fn(params, batch), 1, "prefill")
    for mode, dec in (("kernel", dec_k), ("bulk", dec_b)):
        prof[f"decode {mode}"] = profile_decode(dec, params, bundle.init_cache(B, "cuda"),
                                                log_k[:4])
    torch.cuda.empty_cache()
    # the SSD scan alone (plain PyTorch, as in the reference) at one block's
    # prefill shape: a share of the prefill a kernel could take
    mc_ = cfg.mamba
    ssd_in = (randn(gen, (B, S, mc_.n_heads, mc_.head_dim), f32),
              torch.rand((B, S, mc_.n_heads), generator=gen, device="cuda"),
              torch.zeros(mc_.n_heads, device="cuda"),
              randn(gen, (B, S, mc_.d_state), f32), randn(gen, (B, S, mc_.d_state), f32),
              torch.zeros((B, mc_.n_heads, mc_.d_state, mc_.head_dim), device="cuda"))
    ssd_ms = time_ms(lambda: mamba2_model.ssd_chunked(*ssd_in, mc_.chunk), iters=5, warmup=1)
    del ssd_in
    q = randn(gen, (B, S, Hq, hd), bf16)
    k, v = randn(gen, (B, S, Hkv, hd), bf16), randn(gen, (B, S, Hkv, hd), bf16)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_err = check_close("flash d=224 vs SDPA", flash_attention(q, k, v),
                           sdpa().transpose(1, 2), BF16_TOL)
    fl_t = {"kernel": [], "sdpa": []}
    for which in ("kernel", "sdpa", "sdpa", "kernel"):
        fn = (lambda: flash_attention(q, k, v)) if which == "kernel" else sdpa
        fl_t[which].append(time_ms(fn, iters=5 if which == "kernel" else 20, warmup=1))
    fl_plain = time_ms(lambda: flash_attention_plain(q, k, v), iters=2, warmup=1)
    fl_bound, fl_by, fl_bytes, fl_ops = flash_bound(B, S, Hq, Hkv, hd, 2)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    for name, g_ in gemv.items():
        x_, w_ = g_["x"], g_["w"]
        turns = {"kernel": [], "matmul": []}
        iters = 200 if g_["path"] == "stream" else 20
        for which in ("kernel", "matmul", "matmul", "kernel"):
            fn = ((lambda: fused_matmul_allreduce(x_, w_)) if which == "kernel"
                  else (lambda: torch.matmul(x_, w_)))
            turns[which].append(time_ms(fn, iters=iters))
        g_.update(turns=turns, plain=time_ms(lambda: fused_matmul_allreduce_ref(x_, w_),
                                             iters=5 if g_["path"] == "tile" else 20))
        g_["bound"], g_["by"] = bound_ms(x_.shape[0], *w_.shape, 2)
    ms = lambda ts, f="{:.4f}": ", ".join(f.format(t_) for t_ in ts)
    say(60, f"on {card}, CUDA events: prefill of {B}x{S} and decode steps (profiles): "
            + "; ".join(f"{k_}: {v_}" for k_, v_ in prof.items())
            + f"; the SSD scan (ssd_chunked, plain) at one block's [{B},{S},{mc_.n_heads},"
            f"{mc_.head_dim}] state {mc_.d_state} chunk {mc_.chunk}: {ssd_ms:.3f} ms, x "
            f"{cfg.n_layers} blocks {ssd_ms * cfg.n_layers:.1f} ms a prefill"
            + f"; flash_attention [{B},{S},{Hq},{hd}] over {Hkv} kv heads bf16 causal (turns "
            f"kernel, SDPA, SDPA, kernel): cuda_core path {ms(fl_t['kernel'], '{:.3f}')} ms "
            f"({fl_ops / min(fl_t['kernel']) / 1e9:.1f} TFLOP/s), "
            f"F.scaled_dot_product_attention(is_causal) {ms(fl_t['sdpa'])} ms (max abs/rel err vs "
            f"it {sdpa_err[0]:.3g}/{sdpa_err[1]:.3g}), plain {fl_plain:.3f} ms, bound "
            f"{fl_bound:.4f} ms ({fl_by}: {fl_ops / 1e9:.1f} GFLOP, {fl_bytes / 1e6:.1f} MB); "
            f"fused GEMV (turns kernel, matmul, matmul, kernel): "
            + "; ".join(f"{n_} [{g_['x'].shape[0]},{g_['w'].shape[0]}]@{list(g_['w'].shape)} "
                        f"{g_['path']} path {ms(g_['turns']['kernel'])} ms, torch.matmul "
                        f"{ms(g_['turns']['matmul'])} ms, plain {g_['plain']:.4f} ms, bound "
                        f"{g_['bound']:.4f} ms ({g_['by']})" for n_, g_ in gemv.items()))
    key = {"w_out decode": "w_out_decode", "w_out prefill": "w_out_prefill",
           "shared MLP down decode": "mlp_down_decode"}
    fused_row = {"zamba2_launches_per_decode_step": per_step,
                 "zamba2_prefill_tile_launches": cfg.n_layers}
    for name, g_ in gemv.items():
        fused_row.update({f"zamba2_{key[name]}_ms": min(g_["turns"]["kernel"]),
                          f"zamba2_{key[name]}_plain_ms": g_["plain"],
                          f"zamba2_{key[name]}_bound_ms": g_["bound"],
                          f"zamba2_{key[name]}_bound_by": g_["by"],
                          f"zamba2_{key[name]}_library_ms": min(g_["turns"]["matmul"]),
                          f"zamba2_{key[name]}_max_abs_err": g_["err"][0]})
    del params, params_x, gemv, log_k, batch, tokens
    torch.cuda.empty_cache()
    return {
        "flash_attention": {
            "zamba2_prefill_launches": cfg.n_groups, "zamba2_ms": min(fl_t["kernel"]),
            "zamba2_plain_ms": fl_plain, "zamba2_bound_ms": fl_bound, "zamba2_bound_by": fl_by,
            "zamba2_library_ms": min(fl_t["sdpa"]),
            "zamba2_max_abs_err": flash_errs["main"][0][0]},
        "fused_matmul_allreduce": fused_row,
    }


# zamba2-7b training (phase 63): its published widths, depth cut to
# ZAMBA_TRAIN_LAYERS Mamba-2 blocks, two groups of 6 (each with the shared
# block and its LoRA) and a tail of 1, the reduced model's structure (1.67 G
# parameters; with the gradient and AdamW's f32 moments about 20 GB: all 81
# blocks would need about 80 GB).  A loss with every gradient at
# ZAMBA_TRAIN_B x ZAMBA_TRAIN_S in kernel and bulk mode against an exact f32
# evaluation, then the train launcher's ZAMBA_TRAIN_STEPS AdamW steps in
# each mode at lr TRAIN_LR (the reference's fields: AdamW, one microbatch)
ZAMBA_TRAIN_LAYERS, ZAMBA_TRAIN_B, ZAMBA_TRAIN_S, ZAMBA_TRAIN_STEPS = 13, 4, 2048, 3


def zamba2_train_counts(cfg, steps=1):
    """The launches of ``steps`` kernel-mode zamba2 training steps: a flash
    launch (CUDA cores, head size 224) a group in the forward and again in
    its remat recompute; a tile-path fused GEMM a Mamba block's ``w_out`` in
    the forward and again for each group's blocks in the recompute (the
    backward of both is plain)."""
    flash = 2 * cfg.n_groups * steps
    fused = (cfg.n_layers + cfg.n_groups * cfg.attn_every) * steps
    return {"flash_attention": flash, "flash_attention.cuda_core": flash,
            "flash_attention.tile": 0, "fused_matmul_allreduce": fused,
            "fused_matmul_allreduce.tile": fused}


def zamba2_train_phase(card) -> dict:
    """Phase 63: zamba2-7b training on one card (see ZAMBA_TRAIN_LAYERS).
    (a) the loss and every gradient in kernel and bulk mode against an
    exact f32 evaluation (f32 weights and arithmetic, bulk mode): each
    leaf's largest error in kernel mode within LOGITS_TOL_FACTOR x bulk
    mode's, the loss within LOGITS_TOL_FACTOR x bulk's distance or
    LOSS_FLOOR's, the launches as ``zamba2_train_counts``; (b) the
    launcher's steps in each mode (losses falling, every step's within
    TRAIN_LOSS_REL of bulk's, the launches of every step); (c) the flash
    op's analytic backward at the shared block's shape beside SDPA's
    backward, and the SSD scan's forward and backward at a block's shape
    with its peak.
    Returns the flash and fused rows' numbers of zamba2's training.  The
    backward's gradients are held to an exact f32 evaluation within
    LOGITS_TOL_FACTOR x bulk mode's (autograd through span_attention)."""
    import torch.nn.functional as F

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import to_device
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.launch import train as launch_train
    from repro_torch.models import mamba2 as mamba2_model
    from repro_torch.models.attention import span_attention
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext
    from repro_torch.train.optimizer import tree_leaves, tree_map, tree_paths

    full = get_arch("zamba2-7b")
    cfg = dataclasses.replace(full.config, n_layers=ZAMBA_TRAIN_LAYERS)
    bundle = dataclasses.replace(full, config=cfg)
    B, S, L = ZAMBA_TRAIN_B, ZAMBA_TRAIN_S, cfg.n_layers
    # (a) ---------------------------------------------------------------
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    leaves = tree_leaves(params)
    n_params = sum(t_.numel() for t_ in leaves)
    for p_ in leaves:
        p_.requires_grad_(True)
    batch = to_device(next(launch_train.make_batches(bundle, B, S)), "cuda")
    out, peaks = {}, {}
    for mode in ("kernel", "bulk"):
        ctx = ParallelContext(device="cuda", fusion=FusionConfig(mode=mode))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        want = zamba2_train_counts(cfg) if mode == "kernel" else {}
        (loss, grads), _ = counted_run(
            lambda: (lambda l_: (l_.detach(), torch.autograd.grad(l_, leaves)))(
                bundle.loss_fn(ctx)(params, batch)), want)
        peaks[mode] = torch.cuda.max_memory_allocated() / 1e9
        out[mode] = (loss, grads)
    exact = dataclasses.replace(bundle, config=dataclasses.replace(
        cfg, param_dtype="float32", compute_dtype="float32"))
    params_x = tree_map(lambda t_: t_.detach().float().requires_grad_(True), params)
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    loss_x = exact.loss_fn(ctx_b)(params_x, batch)
    grads_x = torch.autograd.grad(loss_x, tree_leaves(params_x))
    del params_x
    # every leaf on its own, as phase 26 holds chatglm3's
    rows, bad, worst = [], [], 0.0
    for (path, _), gk, gb, gx in zip(tree_paths(params), out["kernel"][1], out["bulk"][1],
                                     grads_x):
        name = ".".join(map(str, path))
        ek, eb = errors(gk, gx)[0], errors(gb, gx)[0]
        if not (torch.isfinite(gk.float()).all() and ek <= LOGITS_TOL_FACTOR * eb):
            bad.append(f"{name} {ek:.3g} (bulk {eb:.3g})")
        worst = max(worst, ek / eb)
        rows.append(f"{name} {ek:.3g}/{eb:.3g}")
    lk, lb, lx = out["kernel"][0].item(), out["bulk"][0].item(), loss_x.item()
    loss_bound = LOGITS_TOL_FACTOR * max(abs(lb - lx), LOSS_FLOOR * abs(lx) / (B * S) ** 0.5)
    del out, grads_x
    torch.cuda.empty_cache()
    say(63, f"(a) on {card}: zamba2-7b full width cut to {L} Mamba-2 blocks ({cfg.n_groups} "
            f"groups of {cfg.attn_every} with the shared block, a tail of {cfg.n_tail}; "
            f"{n_params / 1e9:.3f}B params {cfg.param_dtype}), every gradient of a loss at "
            f"{B}x{S} tokens (the launcher's first batch, weights seed 0): loss kernel {lk:.6f} "
            f"({abs(lk - lx):.3g} from exact f32, bound {loss_bound:.3g}), bulk {lb:.6f} "
            f"({abs(lb - lx):.3g}), exact f32 {lx:.6f}; kernel mode's launches flash "
            f"{2 * cfg.n_groups} (cuda_core path, d {cfg.hd}: forward and remat), fused GEMM "
            f"{L + cfg.n_groups * cfg.attn_every} (tile path: {L} w_out forward, "
            f"{cfg.n_groups * cfg.attn_every} recompute), bulk mode none; peak kernel "
            f"{peaks['kernel']:.2f} GB, bulk {peaks['bulk']:.2f} GB; each of the {len(leaves)} "
            f"leaves' max abs err from exact f32, kernel/bulk (bound {LOGITS_TOL_FACTOR} x "
            f"bulk's; worst ratio {worst:.3g}): " + ", ".join(rows))
    if bad:
        raise AssertionError(f"zamba2 gradients of kernel mode non-finite or above "
                             f"{LOGITS_TOL_FACTOR} x bulk mode's distance from exact f32: "
                             + ", ".join(bad))
    if not abs(lk - lx) <= loss_bound:
        raise AssertionError(f"zamba2 loss: kernel mode {lk:.6f} is {abs(lk - lx):.3g} from exact "
                             f"f32 {lx:.6f}, above {loss_bound:.3g}")
    del params, leaves, batch
    torch.cuda.empty_cache()

    # (b) ---------------------------------------------------------------
    argv = ["--arch", "zamba2-7b", "--layers", str(L), "--steps", str(ZAMBA_TRAIN_STEPS),
            "--batch", str(B), "--seq", str(S), "--lr", TRAIN_LR, "--log-every", "1"]
    runs = {}
    per_step = zamba2_train_counts(cfg)
    for mode in ("kernel", "bulk"):
        runs[mode] = launch_run(argv + ["--fusion", mode], B * S)
        want = zamba2_train_counts(cfg, ZAMBA_TRAIN_STEPS) if mode == "kernel" else {}
        expect_counts(f"phase 63 launcher {mode} mode", runs[mode][1], want)
        flash_step = per_step["flash_attention"] if mode == "kernel" else 0
        if runs[mode][2].launches != [flash_step] * ZAMBA_TRAIN_STEPS:
            raise AssertionError(f"{mode} mode: flash launches a step {runs[mode][2].launches}")
        losses = runs[mode][0]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{mode} mode: loss did not fall: {losses}")
    # step 1's loss is (a)'s, which (a) held to the exact f32 evaluation
    lk_, lb_ = runs["kernel"][0], runs["bulk"][0]
    d_k, d_b = abs(lk_[0] - lx), abs(lb_[0] - lx)
    rel = max(abs(a - b) / b for a, b in zip(lk_, lb_))
    if rel > TRAIN_LOSS_REL:
        raise AssertionError(f"steps 1-{ZAMBA_TRAIN_STEPS}: kernel losses {lk_} differ from "
                             f"bulk's {lb_} by {rel:.3g} of bulk's, above {TRAIN_LOSS_REL}")
    say(63, f"(b) python -m repro_torch.launch.train {' '.join(argv)} (AdamW with f32 moments, "
            f"one microbatch, the reference's fields): kernel mode {runs['kernel'][4]}; bulk "
            f"mode {runs['bulk'][4]}; launches a kernel-mode step: flash "
            f"{per_step['flash_attention']} (cuda_core), fused GEMM "
            f"{per_step['fused_matmul_allreduce']} (tile); step 1 vs exact f32 {lx:.6f}: kernel "
            f"{d_k:.3g}, bulk {d_b:.3g}; steps 1-{ZAMBA_TRAIN_STEPS} kernel vs bulk {rel:.3g} "
            f"of bulk's loss (bound {TRAIN_LOSS_REL})")
    row_k, row_b = runs["kernel"], runs["bulk"]
    del runs
    torch.cuda.empty_cache()

    # (c) ---------------------------------------------------------------
    gen = torch.Generator(device="cuda").manual_seed(63)
    Hq, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    bf16, f32 = torch.bfloat16, torch.float32
    leaves = [randn(gen, (B, S, h, hd), bf16).requires_grad_(True) for h in (Hq, Hkv, Hkv)]
    do = randn(gen, (B, S, Hq, hd), bf16)
    scale = hd ** -0.5
    o_k = flash_attention(*leaves, scale=scale, causal=True)
    qt, kt, vt = (a.transpose(1, 2) for a in leaves)
    o_sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    g_k = torch.autograd.grad(o_k, leaves, do, retain_graph=True)
    g_b = grads_of(lambda *a: span_attention(*a, causal=True, window=None, scale=scale,
                                              cap=None), leaves, do)
    exact = [a.detach().float().requires_grad_(True) for a in leaves]
    g_x = grads_of(lambda *a: dense_attention(*a, scale), exact, do.float())
    del exact
    bwd_err = []
    for n_, gk, gb, gx in zip(("dq", "dk", "dv"), g_k, g_b, g_x):
        ek, eb = errors(gk, gx)[0], errors(gb, gx)[0]
        if not (torch.isfinite(gk.float()).all() and ek <= LOGITS_TOL_FACTOR * eb):
            raise AssertionError(f"flash backward d={hd} {n_}: {ek:.3g} from exact f32, above "
                                 f"{LOGITS_TOL_FACTOR} x bulk mode's {eb:.3g}")
        bwd_err.append((ek, eb))
    del g_k, g_b, g_x
    bwd = lambda o, c: lambda: torch.autograd.grad(o, leaves, c, retain_graph=True)
    t_k, t_sd = [], []
    for which in ("kernel", "sdpa", "sdpa", "kernel"):
        if which == "kernel":
            t_k.append(time_ms(bwd(o_k, do), iters=2, warmup=1))
        else:
            t_sd.append(time_ms(bwd(o_sd, dot), iters=10, warmup=2))
    _, _, n_bytes, ops = flash_bound(B, S, Hq, Hkv, hd, 2)
    b_bytes = n_bytes + 3 * B * S * Hq * hd * 2 + 2 * B * Hq * S * 4 + B * S * (Hq + 2 * Hkv) * hd * 2
    t_bytes, t_ops = b_bytes / HBM_BYTES_PER_S * 1e3, 2.5 * ops / BF16_FLOPS * 1e3
    bwd_bound = max(t_bytes, t_ops)
    bwd_by = "bytes" if t_bytes >= t_ops else "operations"
    del o_k, o_sd, qt, kt, vt, dot, do, leaves
    torch.cuda.empty_cache()
    mc_ = cfg.mamba
    ssd_in = [randn(gen, (B, S, mc_.n_heads, mc_.head_dim), f32),
              torch.rand((B, S, mc_.n_heads), generator=gen, device="cuda"),
              torch.zeros(mc_.n_heads, device="cuda"),
              randn(gen, (B, S, mc_.d_state), f32), randn(gen, (B, S, mc_.d_state), f32)]
    ssd_in = [a.requires_grad_(True) for a in ssd_in]
    state0 = torch.zeros((B, mc_.n_heads, mc_.d_state, mc_.head_dim), device="cuda")
    gy = randn(gen, (B, S, mc_.n_heads, mc_.head_dim), f32)

    def ssd_fwd_bwd():
        y, _ = mamba2_model.ssd_chunked(*ssd_in, state0, mc_.chunk)
        return torch.autograd.grad(y, ssd_in, gy)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ssd_fwd_bwd()
    torch.cuda.synchronize()
    ssd_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    ssd_ms = time_ms(ssd_fwd_bwd, iters=3, warmup=1)
    ssd_fwd_ms = time_ms(lambda: mamba2_model.ssd_chunked(*ssd_in, state0, mc_.chunk),
                         iters=3, warmup=1)
    del ssd_in, state0, gy
    torch.cuda.empty_cache()
    say(63, f"(c) on {card}, CUDA events: the flash op's analytic backward (flash_backward, "
            f"plain PyTorch) at [{B},{S},{Hq}/{Hkv},{hd}] bf16 causal (turns kernel, SDPA, SDPA, "
            f"kernel) {', '.join(f'{t_:.3f}' for t_ in t_k)} ms; "
            f"F.scaled_dot_product_attention's backward {', '.join(f'{t_:.3f}' for t_ in t_sd)} "
            f"ms ({min(t_k) / min(t_sd):.1f}x); dq, dk, dv max abs err from exact f32, the "
            f"analytic backward/bulk mode's autograd through span_attention (bound "
            f"{LOGITS_TOL_FACTOR} x bulk's): "
            + ", ".join(f"{e[0]:.3g}/{e[1]:.3g}" for e in bwd_err) + f"; bound "
            f"{bwd_bound:.4f} ms ({bwd_by}: {2.5 * ops / 1e9:.1f} GFLOP, {b_bytes / 1e6:.1f} "
            f"MB); the SSD scan (ssd_chunked, autograd) at one block's [{B},{S},{mc_.n_heads},"
            f"{mc_.head_dim}] state {mc_.d_state} chunk {mc_.chunk}: forward {ssd_fwd_ms:.3f} "
            f"ms, forward + backward {ssd_ms:.3f} ms, peak {ssd_peak:.2f} GB above its inputs")
    return {
        "flash_attention": {
            "zamba2_train_launches_per_step": per_step["flash_attention"],
            "zamba2_backward_ms": min(t_k), "zamba2_backward_bound_ms": bwd_bound,
            "zamba2_backward_bound_by": bwd_by, "zamba2_sdpa_backward_ms": min(t_sd),
            "zamba2_train_step_ms": row_k[5][3], "zamba2_train_step_ms_bulk": row_b[5][3],
            "zamba2_train_peak_gb": row_k[3]},
        "fused_matmul_allreduce": {
            "zamba2_train_launches_per_step": per_step["fused_matmul_allreduce"]},
    }


# ---------------------------------------------------------------------------
# the front ends and M-RoPE: qwen2-vl-2b (phase 61), musicgen-medium (phase 62)
# ---------------------------------------------------------------------------
# Both at their published widths and full depth, no cut: qwen2-vl-2b's 28
# layers with its tied table (1.54 G parameters, 3.1 GB bf16), musicgen-
# medium's 48 (1.81 G, 3.6 GB).  (a) the serve launcher's drain of FE_REQ
# requests x FE_NEW tokens at batch FE_B in kernel and bulk mode (the text
# phase: M-RoPE on three equal streams); (b) a prefill of FE_B x FE_S with
# the front end's inputs (qwen2-vl: patch embeddings on the first FE_PATCHES
# positions and mrope_positions' streams on a grid of 16; musicgen: frame
# embeddings on every position), then FE_STEPS greedy decode steps from its
# cache; (c) qwen2-vl's paged serve_step at C = FE_CHUNK and C = 1; (d)
# FE_TRAIN_STEPS AdamW steps of the train launcher in kernel mode at
# FE_TRAIN's batch x seq with the launcher's front-end extras, at lr TRAIN_LR
FE_B, FE_S, FE_STEPS, FE_PATCHES = 4, 2048, 8, 256
FE_REQ, FE_NEW = 8, 8
FE_CHUNK, FE_BLOCK, FE_BLOCKS = 8, 16, 64
FE_TRAIN = {"qwen2-vl-2b": (4, 2048), "musicgen-medium": (16, 64)}
FE_TRAIN_STEPS = 3
FE_KEY = {"qwen2-vl-2b": "qwen2vl", "musicgen-medium": "musicgen"}   # the kernel rows' keys


def fe_decode_counts(steps, cfg):
    """The launches of ``steps`` kernel-mode decode steps of a dense
    transformer: the stream-path fused GEMV + AllReduce a layer (its FFN
    down), no flash (decode attention is plain)."""
    n = cfg.n_layers * steps
    return {"fused_matmul_allreduce": n, "fused_matmul_allreduce.stream": n}


def fe_flash_counts(cfg, n):
    """counted_run's expectation: n flash launches, every one on the path
    flash_path chooses for the config's head size in bf16."""
    from repro_torch.kernels.flash_attention.ops import PATHS, flash_path

    took = flash_path(torch.bfloat16, cfg.hd)
    return {"flash_attention": n, **{f"flash_attention.{p_}": n if p_ == took else 0
                                     for p_ in PATHS}}


def fe_batch(cfg, gen, tokens):
    """The prefill's batch: the tokens and the front end's inputs, drawn on
    the card (``models/frontends.py``)."""
    from repro_torch.models import frontends

    B, S = tokens.shape
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        emb, mask = frontends.vision_patch_embeddings(gen, B, S, cfg.d_model, FE_PATCHES)
        batch.update(vision_embeds=emb, vision_mask=mask,
                     positions_thw=frontends.mrope_positions(B, S, FE_PATCHES, device="cuda"))
    else:
        batch["frame_embeds"] = frontends.audio_frame_embeddings(gen, B, S, cfg.d_model)
    return batch


def fe_decode_cache(cfg, cache, rows):
    """A decode cache of ``rows`` positions holding a prefill's k and v in
    rows [0, S)."""
    from repro_torch.models import transformer as tfm

    dc = tfm.init_cache(dataclasses.replace(cfg, max_seq=rows), cache["k"].shape[1], "cuda")
    for k_ in dc:
        dc[k_][:, :, :cache[k_].shape[2]] = cache[k_]
    return dc


def flash_turns(gen, b, s, hq, hkv, d):
    """The flash kernel at [b, s, hq, d] over hkv kv heads, bf16 causal, on
    its path (turns kernel, SDPA, SDPA, kernel), beside
    F.scaled_dot_product_attention, its plain version and flash_bound; its
    output checked against SDPA's and against plain."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain

    bf16 = torch.bfloat16
    q = randn(gen, (b, s, hq, d), bf16)
    k, v = randn(gen, (b, s, hkv, d), bf16), randn(gen, (b, s, hkv, d), bf16)
    qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=hkv != hq)
    got, took = on_path(flash_attention, lambda: flash_attention(q, k, v))
    err = check_close(f"flash [{b},{s},{hq}/{hkv},{d}] vs plain", got,
                      flash_attention_plain(q, k, v), BF16_TOL)
    sdpa_err = check_close(f"flash [{b},{s},{hq}/{hkv},{d}] vs SDPA", got,
                           sdpa().transpose(1, 2), BF16_TOL)
    del got
    t_ = {"kernel": [], "sdpa": []}
    for which in ("kernel", "sdpa", "sdpa", "kernel"):
        fn = (lambda: flash_attention(q, k, v)) if which == "kernel" else sdpa
        t_[which].append(time_ms(fn, iters=10 if which == "kernel" else 20, warmup=2))
    plain = time_ms(lambda: flash_attention_plain(q, k, v), iters=2, warmup=1)
    bound, by, n_bytes, ops = flash_bound(b, s, hq, hkv, d, 2)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return dict(path=took, err=err, sdpa_err=sdpa_err, turns=t_, ms=min(t_["kernel"]),
                sdpa=min(t_["sdpa"]), plain=plain, bound=bound, by=by, ops=ops, bytes=n_bytes,
                shape=f"[{b},{s},{hq}/{hkv},{d}]")


def gemv_turns(gen, rows, w, name):
    """The fused GEMV at x [rows, K] @ w on the path fused_path chooses,
    against its plain version, then timed (turns kernel, matmul, matmul,
    kernel) beside torch.matmul, the plain version and bound_ms."""
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_matmul_allreduce, fused_path
    from repro_torch.kernels.fused_gemv_allreduce.ref import fused_matmul_allreduce_ref

    bf16 = torch.bfloat16
    x = randn(gen, (rows, w.shape[0]), bf16)
    got, took = on_path(fused_matmul_allreduce, lambda: fused_matmul_allreduce(x, w))
    if took != fused_path(bf16, rows, *w.shape):
        raise AssertionError(f"fused_matmul_allreduce {name}: took the {took} path")
    err = check_close(f"fused_matmul_allreduce {name}", got, fused_matmul_allreduce_ref(x, w),
                      BF16_TOL)
    t_ = {"kernel": [], "matmul": []}
    iters = 200 if took == "stream" else 50
    for which in ("kernel", "matmul", "matmul", "kernel"):
        fn = ((lambda: fused_matmul_allreduce(x, w)) if which == "kernel"
              else (lambda: torch.matmul(x, w)))
        t_[which].append(time_ms(fn, iters=iters))
    plain = time_ms(lambda: fused_matmul_allreduce_ref(x, w), iters=20)
    bound, by = bound_ms(rows, *w.shape, 2)
    return dict(path=took, err=err, turns=t_, ms=min(t_["kernel"]), lib=min(t_["matmul"]),
                plain=plain, bound=bound, by=by, shape=f"[{rows},{w.shape[0]}]@{list(w.shape)}")


def fe_paged_phase(bundle, params, params_x, cfg_x, ctx_k, ctx_b) -> str:
    """Phase 61(c): serve_step at C = FE_CHUNK (every slot a chunk from
    position 0) then C = 1 (each slot decodes at FE_CHUNK), kernel and bulk
    mode against an exact f32 step on a pool of its own; then each step
    again under set_sync_debug_mode("error")."""
    from repro_torch.kernels.fused_gemv_allreduce.ops import fused_path
    from repro_torch.models import transformer as tfm

    cfg = bundle.config
    B, L = FE_B, cfg.n_layers
    gen = torch.Generator(device="cuda").manual_seed(611)
    per_slot = FE_BLOCKS // B
    tables = torch.arange(FE_BLOCKS, dtype=torch.int32, device="cuda").view(B, per_slot)
    steps = [(torch.randint(0, cfg.vocab, (B, FE_CHUNK), generator=gen, device="cuda"),
              torch.zeros(B, dtype=torch.int32, device="cuda"),
              torch.full((B,), FE_CHUNK, dtype=torch.int32, device="cuda")),
             (torch.randint(0, cfg.vocab, (B, 1), generator=gen, device="cuda"),
              torch.full((B,), FE_CHUNK, dtype=torch.int32, device="cuda"),
              torch.ones(B, dtype=torch.int32, device="cuda"))]
    pools = {"kernel": bundle.init_paged_pool(FE_BLOCKS, FE_BLOCK, "cuda"),
             "bulk": bundle.init_paged_pool(FE_BLOCKS, FE_BLOCK, "cuda"),
             "exact": tfm.init_paged_pool(cfg_x, FE_BLOCKS, FE_BLOCK, "cuda")}
    serve = {"kernel": bundle.serve_step_fn(ctx_k), "bulk": bundle.serve_step_fn(ctx_b)}
    exact = lambda tk, pool, *rest: tfm.serve_step(ctx_b, params_x, cfg_x, tk, pool, tables, *rest)
    texts, paths = [], []
    for tk, pos, n_new in steps:
        rows = B * tk.shape[1]
        path = fused_path(torch.bfloat16, rows, cfg.d_ff, cfg.d_model)
        paths.append(f"C = {tk.shape[1]}: {L} {path}-path launches")
        (lk, _), _ = counted_run(lambda: serve["kernel"](params, tk, pools["kernel"], tables, pos,
                                                         n_new),
                                 {"fused_matmul_allreduce": L, f"fused_matmul_allreduce.{path}": L})
        (lb, _), _ = counted_run(lambda: serve["bulk"](params, tk, pools["bulk"], tables, pos,
                                                       n_new), {})
        lx, _ = exact(tk, pools["exact"], pos, n_new)
        texts.append(f"C = {tk.shape[1]} " + bounded_errors(
            f"paged C={tk.shape[1]}", {"logits": (lk, lb, lx)}))
    for tk, pos, n_new in steps:
        for m in ("kernel", "bulk"):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                serve[m](params, tk, pools[m], tables, pos, n_new)
            finally:
                torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del pools
    torch.cuda.empty_cache()
    return (f"(c) serve_step on a pool of {FE_BLOCKS} x {FE_BLOCK}-token blocks, batch {B}: "
            f"{'; '.join(paths)} (the text phase: M-RoPE on three equal streams); kernel vs "
            f"exact / bulk vs exact / kernel vs bulk max abs err (bound {LOGITS_TOL_FACTOR} x the "
            f"second): {'; '.join(texts)}; each step again in kernel and bulk mode under "
            f"torch.cuda.set_sync_debug_mode('error'): no call synchronised")


def fe_phase(card, arch, n) -> dict:
    """Phase ``n`` (61: qwen2-vl-2b, 62: musicgen-medium) at its published
    widths and full depth on one card, kernel mode against bulk mode and an
    exact f32 evaluation.  Returns the flash and fused kernels' rows'
    numbers at its shapes."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.flash_attention.ops import flash_attention, flash_attention_plain
    from repro_torch.models import attention
    from repro_torch.models import transformer as tfm
    from repro_torch.parallel.sharding import FusionConfig, ParallelContext

    key = FE_KEY[arch]
    bundle = get_arch(arch)
    cfg = bundle.config
    L, Hq, Hkv, hd = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = FE_B, FE_S
    # (a) ---------------------------------------------------------------
    argv = ["--arch", arch, "--batch", str(B), "--requests", str(FE_REQ), "--max-new",
            str(FE_NEW)]
    runs = {m: serve_launcher_run(argv + ["--fusion", m], FE_REQ,
                                  (lambda st: fe_decode_counts(st, cfg)) if m == "kernel"
                                  else (lambda st: {}), f"phase {n} launcher {m} mode")
            for m in ("kernel", "bulk")}
    sk, sb = runs["kernel"]["streams"], runs["bulk"]["streams"]
    differing = sum(a != b for u in sk for a, b in zip(sk[u][1], sb[u][1]))
    say(n, f"(a) on {card}: python -m repro_torch.launch.serve {runs['kernel']['argv']} in this "
           f"process: {FE_REQ} requests served, " + "; ".join(
               f"{m} mode {r['steps']} steps, {r['ms_step']:.2f} ms/step, {r['tok_s']:.1f} tok/s, "
               f"{r['wall']:.1f} s with its weights' draw, launches fused GEMV "
               f"{r['counts']['fused_matmul_allreduce']} (stream path "
               f"{r['counts']['fused_matmul_allreduce.stream']}), flash "
               f"{r['counts']['flash_attention']}" for m, r in runs.items())
           + f"; kernel streams {[sk[u][1] for u in sorted(sk)]}; bulk streams "
           f"{[sb[u][1] for u in sorted(sb)]}; differing tokens {differing}")
    del runs

    # (b) ---------------------------------------------------------------
    t0 = time.perf_counter()
    params = bundle.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t_.numel() for t_ in _leaves(params))
    n_bytes = sum(t_.numel() * t_.element_size() for t_ in _leaves(params))
    gen = torch.Generator(device="cuda").manual_seed(n)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device="cuda")
    batch = fe_batch(cfg, gen, tokens)
    ctx_k = ParallelContext(device="cuda", fusion=FusionConfig(mode="kernel"))
    ctx_b = ParallelContext(device="cuda", fusion=FusionConfig(mode="bulk"))
    pre_k, pre_b = bundle.prefill_fn(ctx_k), bundle.prefill_fn(ctx_b)
    dec_k, dec_b = bundle.decode_fn(ctx_k), bundle.decode_fn(ctx_b)
    cfg_x = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    params_x = {**params, "layers": UpcastLayers(params["layers"])}
    layer_errs = []

    def spy(q, k, v, **kw):
        """The kernel, then its plain version on the identical input."""
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, scale=kw["scale"], causal=kw["causal"])
        layer_errs.append(check_close(f"prefill layer {len(layer_errs)} flash", got, want,
                                      BF16_TOL)[0])
        return got

    torch.cuda.reset_peak_memory_stats()
    with swapped(attention, "flash_attention", spy):
        (lk, ck), pre_counts = counted_run(lambda: pre_k(params, batch), fe_flash_counts(cfg, L))
    (lb, cb), _ = counted_run(lambda: pre_b(params, batch), {})
    lx, cx = tfm.prefill_forward(ctx_b, params_x, cfg_x, batch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    for lg in (lk, lb, lx):
        if lg.shape != (B, 1, cfg.vocab) or not torch.isfinite(lg).all():
            raise AssertionError(f"prefill logits: shape {tuple(lg.shape)} or non-finite")
    if any(tuple(c_[k_].shape) != (L, B, S, Hkv, hd) for c_ in (ck, cb) for k_ in ("k", "v")):
        raise AssertionError(f"prefill cache: shapes {[tuple(t_.shape) for t_ in ck.values()]}")
    pre_txt = bounded_errors("prefill", {"logits": (lk, lb, lx),
                                         **{k_: (ck[k_], cb[k_], cx[k_]) for k_ in ("k", "v")}})
    # FE_STEPS greedy steps from the prefill's cache; bulk and exact f32
    # teacher-forced on the kernel run's tokens
    rows_x = S + FE_STEPS
    caches = {"kernel": fe_decode_cache(cfg, ck, cfg.max_seq),
              "bulk": fe_decode_cache(cfg, cb, cfg.max_seq),
              "exact": fe_decode_cache(cfg_x, cx, rows_x)}
    del ck, cb, cx
    torch.cuda.empty_cache()
    tok, logits, log_k, steps_tok = lk.argmax(-1).to(torch.int32), {m: [] for m in caches}, [], []
    reset_counts()
    for s_ in range(FE_STEPS):
        pos = torch.full((B,), S + s_, dtype=torch.int32, device="cuda")
        log_k.append((tok, pos))
        gk, caches["kernel"] = dec_k(params, tok, caches["kernel"], pos)
        logits["kernel"].append(gk)
        tok = gk.argmax(-1).to(torch.int32)
        steps_tok.append(tok[:, 0].tolist())
    torch.cuda.synchronize()
    expect_counts(f"phase {n} decode from the prefill", launch_counts(),
                  fe_decode_counts(FE_STEPS, cfg))
    for tok_, pos in log_k:
        gb, caches["bulk"] = dec_b(params, tok_, caches["bulk"], pos)
        gx, caches["exact"] = tfm.decode_step(ctx_b, params_x, cfg_x, tok_, caches["exact"], pos)
        logits["bulk"].append(gb)
        logits["exact"].append(gx)
    cat = {m: torch.cat(v_, dim=1) for m, v_ in logits.items()}
    if not torch.isfinite(cat["kernel"]).all():
        raise AssertionError("decode from the prefill: non-finite logits")
    dec_txt = bounded_errors("decode", {"logits": (cat["kernel"], cat["bulk"], cat["exact"]), **{
        k_: tuple(caches[m][k_][:, :, S:rows_x] for m in ("kernel", "bulk", "exact"))
        for k_ in ("k", "v")}})
    del caches, logits, cat
    torch.cuda.empty_cache()
    front = (f"patch embeddings on the first {FE_PATCHES} positions, M-RoPE sections "
             f"{cfg.mrope_sections} at theta {cfg.rope_theta:g} on mrope_positions' streams "
             f"(text from position {int(batch['positions_thw'][0, 0, FE_PATCHES])})"
             if cfg.frontend == "vision" else "frame embeddings on every position")
    say(n, f"(b) {arch} full width and depth ({L} layers, d{cfg.d_model}, {Hq}/{Hkv} heads of "
           f"{hd}, d_ff {cfg.d_ff} {cfg.act}, vocab {cfg.vocab}; {n_params / 1e9:.3f}B params, "
           f"{n_bytes / 1e9:.2f} GB {cfg.param_dtype}, init {init_s:.1f}s): a prefill of {B}x{S} "
           f"seeded tokens with {front} through prefill_fn: kernel mode launches flash "
           f"{pre_counts['flash_attention']} (tile path {pre_counts['flash_attention.tile']}, "
           f"cuda_core path {pre_counts['flash_attention.cuda_core']}), bulk mode none; every "
           f"layer's flash output vs plain on its input: max abs err {max(layer_errs):.3g} "
           f"(bound {BF16_TOL}); kernel vs exact / bulk vs exact / kernel vs bulk max abs err "
           f"(bound {LOGITS_TOL_FACTOR} x the second): {pre_txt}; peak {peak:.1f} GB; "
           f"{FE_STEPS} greedy decode steps from position {S} (launches fused GEMV "
           f"{FE_STEPS * L}, stream path, flash 0; bulk and exact f32 teacher-forced on the "
           f"kernel run's tokens; k and v the decoded rows): {dec_txt}; tokens {steps_tok}")

    # (c) ---------------------------------------------------------------
    if cfg.frontend == "vision":
        say(n, fe_paged_phase(bundle, params, params_x, cfg_x, ctx_k, ctx_b))

    # times -------------------------------------------------------------
    prof = {}
    for mode, ctx in (("kernel", ctx_k), ("bulk", ctx_b)):
        fn = bundle.prefill_fn(ctx)
        fn(params, batch)       # warm: the allocator's segments, emptied after (b), mapped again
        prof[f"prefill {mode}"] = profile_device(lambda i: fn(params, batch), 1, "prefill")
    for mode, dec in (("kernel", dec_k), ("bulk", dec_b)):
        prof[f"decode {mode}"] = profile_decode(dec, params, bundle.init_cache(B, "cuda"),
                                                log_k[:4])
    del batch, log_k
    torch.cuda.empty_cache()
    fl = flash_turns(gen, B, S, Hq, Hkv, hd)
    w_down = params["layers"][0]["ffn"]["w_down"]
    gemv = {"decode": gemv_turns(gen, B, w_down, f"{arch} FFN down decode")}
    if cfg.frontend == "vision":
        gemv["paged chunk"] = gemv_turns(gen, B * FE_CHUNK, w_down, f"{arch} FFN down chunk")
    del params, params_x, w_down
    torch.cuda.empty_cache()
    ms = lambda ts, f="{:.4f}": ", ".join(f.format(t_) for t_ in ts)
    say(n, f"on {card}, CUDA events: prefill of {B}x{S} and decode steps (profiles): "
           + "; ".join(f"{k_}: {v_}" for k_, v_ in prof.items())
           + f"; flash_attention {fl['shape']} bf16 causal (turns kernel, SDPA, SDPA, kernel): "
           f"{fl['path']} path {ms(fl['turns']['kernel'])} ms ({fl['ops'] / fl['ms'] / 1e9:.1f} "
           f"TFLOP/s), F.scaled_dot_product_attention(is_causal) {ms(fl['turns']['sdpa'])} ms "
           f"({fl['ms'] / fl['sdpa']:.2f}x SDPA; max abs/rel err vs it {fl['sdpa_err'][0]:.3g}/"
           f"{fl['sdpa_err'][1]:.3g}, vs plain {fl['err'][0]:.3g}), plain {fl['plain']:.3f} ms, "
           f"bound {fl['bound']:.4f} ms ({fl['by']}: {fl['ops'] / 1e9:.1f} GFLOP, "
           f"{fl['bytes'] / 1e6:.1f} MB); fused GEMV vs plain (bound {BF16_TOL}), turns kernel, "
           f"matmul, matmul, kernel: " + "; ".join(
               f"{n_} {g_['shape']} {g_['path']} path {ms(g_['turns']['kernel'])} ms, "
               f"torch.matmul {ms(g_['turns']['matmul'])} ms, plain {g_['plain']:.4f} ms, bound "
               f"{g_['bound']:.4f} ms ({g_['by']}), max abs/rel err {g_['err'][0]:.3g}/"
               f"{g_['err'][1]:.3g}" for n_, g_ in gemv.items()))

    # (d) ---------------------------------------------------------------
    tb, ts = FE_TRAIN[arch]
    train_argv = ["--arch", arch, "--steps", str(FE_TRAIN_STEPS), "--batch", str(tb), "--seq",
                  str(ts), "--lr", TRAIN_LR, "--log-every", "1", "--fusion", "kernel"]
    losses, counts, clock, tpeak, summary, med = launch_run(train_argv, tb * ts)
    expect_counts(f"phase {n} train launcher", counts,
                  fe_flash_counts(cfg, FE_TRAIN_STEPS * 2 * L))
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase {n} train launcher: loss did not fall: {losses}")
    say(n, f"(d) on {card}: python -m repro_torch.launch.train {' '.join(train_argv)} ({arch} "
           f"full width and depth, {tb}x{ts} tokens with the launcher's "
           f"{cfg.frontend} extras, AdamW with f32 moments, weights and batches from seed 0): "
           f"{summary}")
    torch.cuda.empty_cache()
    return {
        "flash_attention": {
            f"{key}_prefill_launches": L, f"{key}_train_launches_per_step": 2 * L,
            f"{key}_path": fl["path"], f"{key}_ms": fl["ms"], f"{key}_plain_ms": fl["plain"],
            f"{key}_bound_ms": fl["bound"], f"{key}_bound_by": fl["by"],
            f"{key}_library_ms": fl["sdpa"], f"{key}_max_abs_err": fl["err"][0]},
        "fused_matmul_allreduce": {
            f"{key}_launches_per_decode_step": L, **{
                f"{key}_{n_.replace(' ', '_')}_{k_}": g_[v_] for n_, g_ in gemv.items()
                for k_, v_ in (("ms", "ms"), ("plain_ms", "plain"), ("bound_ms", "bound"),
                               ("bound_by", "by"), ("library_ms", "lib"))},
            **{f"{key}_{n_.replace(' ', '_')}_max_abs_err": g_["err"][0]
               for n_, g_ in gemv.items()}},
    }


def frontend_phases(card) -> dict:
    """Phases 61-62; returns each kernel row's numbers at their shapes."""
    rows = {"flash_attention": {}, "fused_matmul_allreduce": {}}
    for arch, n in (("qwen2-vl-2b", 61), ("musicgen-medium", 62)):
        for name, extra in fe_phase(card, arch, n).items():
            rows[name].update(extra)
    return rows


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_pool()
    sys.exit(code)
