#!/usr/bin/env python3
"""GPU smoke test of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py [--seed 0]
        [--phases build,parity,transfer,serve,serve_int8,oracles,models,
                  obs,async,contract,mesh,tied,train,calibrate]

Run from the repository root on a machine with one NVIDIA H100.  Phases,
each printing one line (``phase=...``) and failing the run on any error:

1. build  — compile the CUDA kernels from ``src/repro_torch/csrc`` (one
   nvcc per source, all at once; an unchanged source is reused from the
   build directory) and print the build seconds and ptxas's registers
   (and, for flash_prefill and sparse_decode_attention, its spill lines).
2. parity — hold each kernel against its plain PyTorch version on the card
   in bf16, at qwen2-0.5b shapes (Hq 14, Hkv 2, D 64) and llama3-8b shapes
   (Hq 32, Hkv 8, D 128), with bs 32, K 64, NB 256, B 8, scatter in both
   of its modes (batched rows with a float32 payload, as a restore; one row
   with a bf16 payload, as a drop); time kernel, plain version and bound.
   zero_blocks_hkv over a round of items spanning two layers' K and V
   pools and several rows, bit-exact (untouched blocks unchanged), timed
   beside index_fill_ of the same blocks on one pool; score_select with a
   cur_len at a block edge, held tie-aware (below), and two planted faults
   (the kernel given cur_len - 1, so it counts the cache without the
   step's +1; the recent-block forcing left out) must fail that check.
   Tolerances: gather, scatter and zero-fill bit-exact; block_score
   |err| <= 1e-3 + 1e-4 |ref| (float32 sums in another order);
   score_select per (request, kv-head): sel_valid counts equal, the plain
   version's select scores of the selected blocks equal as sorted lists
   (block_score's tolerance; +inf and the masked score exactly), no block
   twice, and the id sets equal wherever the plain K-th and (K+1)-th
   scores differ by more than the tolerance;
   sparse_decode_attention |err| <= 2e-3 + 1e-2 |ref| (both accumulate in
   float32 and round once to bf16, whose step is <= 2^-7 relative).  Two
   planted faults (cur_len one block short; one live selection's valid
   flag cleared) must fail that tolerance.  flash_prefill at the serve
   prefill's shape (q_offset 0, 4096 tokens) and as a chunk continuation
   (1000 queries after 1000 context keys, neither a whole 128-row tile),
   held per output element to |err| <= 1.25 * 2^-8 W + 2^-7 |ref|, where
   W = sum_j p_j |v_j| / sum_j p_j is the plain version run on |v| (the
   kernel rounds each weight p_j to bf16 before P V, <= 2^-8 W on that
   element, bf16's unit roundoff being 2^-8; both sides round the output
   once to bf16, one step <= 2^-7 |ref|); three planted faults (q_offset one too large; the last key
   dropped; one interior key tile hidden from the queries of the window's
   second half) must fail it.  The quant trio bit-exact (an all-zero
   block included), and the int8 tier's block moves: gather from a pinned
   int8 pool and from its float32 scale plane, write_blocks_hkv back into
   both.  quant_save_blocks, the int8 save, bit-exact on pinned pools of
   4 requests (decode tokens, fresh blocks, a prefill stripe of whole
   blocks, a stripe over three blocks, two stripes on one block), and two
   planted faults (the stripe written one token late; the scale taken
   before the overlay) must fail it.  The decode kernels also at the
   shapes they take since they serve any GQA group and more than 4096
   blocks: sparse_decode_attention and score_select at granite-20b's
   group (Hq 48 over one kv head, D 128, B 4: three group tiles of 16
   rows), the attention with two more planted faults (the last group
   tile reading each query row one row late; its rows left unwritten),
   and score_select at llama3-8b's heads with NB 4097 and 8193, each with
   its two planted faults.  And at MLA's shapes (minicpm3-4b, since the
   kernels were widened for it): sparse_decode_attention with 40 query
   heads over one latent head of D = Dv = 288 (three group tiles), the
   pool passed as both k and v, scale 1 / sqrt(96), with all four
   planted attention faults; score_select over the 288-wide latent
   metadata at NB 256 and 1025, each with its two planted faults; and
   flash_prefill at q/k depth 96 and v width 64, 40 heads over 40, 4096
   tokens, with its three planted faults.  And at the MoE family's
   attention: sparse_decode_attention and score_select at kimi-k2's
   (Hq 64 over 8, D 112) and arctic-480b's (Hq 56 over 8, D 128) decode
   steps (B 4, NB 448), each with its two planted faults; flash_prefill
   at D = Dv = 112 (kimi-k2's heads, 64 over 8), 4096 tokens and a chunk
   continuation, each with the three planted faults and a fourth, a
   store spilling 16 columns into the next head (its first 16 columns
   zeroed), and a guard band: launched into a buffer with 64 sentinel
   elements after its output, every output element must be written and
   the band untouched.  And at the frontend families': the decode
   kernels at internvl2-2b's (Hq 16 over 8, D 128: G 2) and
   whisper-small's (12 over 12, D 64: G 1) steps (B 4, NB 264), each
   with its two planted faults; flash_prefill's non-causal mode (every
   query over every key j < Sk) at whisper-small's encoder (Sq = Sk =
   1500), its cross-attention from a 256-token window and from one
   decode token per row (Sk 1500, not a multiple of the 128-key tile),
   and at D 128 with Hq 16 over 8 (Sk 1000) and 32 over 8 (Sq 1), with
   the causal mode's tolerance and three planted faults (the causal mask
   applied, the last key dropped, the ragged last tile dropped), SDPA
   (is_causal=False) timed beside it.  And Mamba's selective_scan (no
   Pallas kernel: the reference's lax.scan) at jamba-v0.1-52b's widths
   (d_inner 8192, d_state 16), bf16 x, B and C, float32 dt, A, D and a
   non-zero h0: a prefill window of 4 right-padded rows over 1000 tokens
   (dt = 0 past each row's length), one row over 4096 tokens and the
   decode step (S = 1), y and the
   final state held to |err| <= 1e-5 + 1e-4 |ref| (float32 on both sides:
   the 16-state sum in another order, expf against torch's exp and fused
   multiply-adds move each by a few float32 steps, and |dA| <= 1 keeps
   errors from growing along the tokens); four planted faults (h0
   ignored, the skip term D x dropped, the last state left out of y's
   sum, the second staged 64-token chunk's B and C read one token late)
   must fail it on the padded window and on the one row; its bound
   counts 8 float32 operations per (token, channel, state) at the
   float32 rate (67 TFLOP/s) against its bytes.  And
   RWKV6's wkv6 (no Pallas kernel: the reference's lax.scan of
   _wkv_step) at rwkv6-1.6b's 32 heads of 64, bf16 r, k and v, float32
   w, u and state: a 1000-token window from a zero state, the decode
   step, a window of 4 right-padded rows (k = 0, w = 1 past each
   length) and one row over 4096 tokens from a carried state (the last
   two in the kernel's time chunks, ops.wkv6_chunk), y and the final
   state held per element to |err| <= 2^-14 W + 1e-6, W the plain
   version on the inputs' magnitudes (WKV_RTOL); five planted faults (the
   bonus u dropped, the state not carried, the state read with i and j
   swapped, the decay applied after the add, the decay of the first
   token of the second time chunk dropped) must fail it on those two;
   its bound counts the 5 float32
   operations per (token, head, i, j) that the function needs (the
   bonus term is a scalar per token) at 67 TFLOP/s.  And score_select's
   other scorings (the reference's score_blocks: InfLLM's mean metadata,
   the sum over the GQA group, both) at qwen2-0.5b's serve shape,
   tie-aware, each with three planted faults (the two above and the
   group reduced the other way); their records are score_select:mean
   and score_select:sum.
   score_select's lines also time
   the unfused pair it replaces (block_score's kernel, then the plain
   select), where block_score takes the width (D <= 128).  A
   move from or to pinned memory is also bounded by the PCIe link: a
   contiguous pinned-to-device copy of the same bytes is timed beside it
   (device-to-pinned for a write back or a save).
3. transfer — the flat FlashH2D gather (gather_blocks) and FlashD2H
   scatter (scatter_blocks) at benchmarks/bench_transfer.py's shape, a
   (512, 32, 128) float32 pool and 64 distinct ids: driven once from and
   into a pinned host pool (the launch counts of their JSON records; no
   serve path calls them), then held byte for byte against their plain
   versions from (into) a pinned host pool and a device pool, each timed
   beside 64 per-block copy_ calls for the same blocks (the paper's
   FlashH2D comparison), the link copy of the same bytes and the library
   call on a device-resident pool (index_select, index_copy_).
4. serve  — the port's ServingEngine, default config, on qwen2-0.5b at
   full width (24 layers, bf16, random weights from --seed): 4 requests of
   4096 prompt tokens and 32 new tokens, wall-clock charging.  Asserts
   every request finished with finite logits, that each kernel of the fp
   path (the decode kernels: score_select, sparse_decode_attention, the
   restore's gather and scatter and the drop rounds' zero-fill; and
   flash_prefill) was launched, that H2D restores and D2H saves happened,
   that no drop went through scatter_blocks_hkv, that zero_blocks_hkv
   launched at most once per drop round and score_select at most twice per
   attention launch.  The inputs of the first
   flash_prefill launch and of one launch of each other kernel (and of
   each scatter mode) from the decode step halfway through the run, when
   all 4 requests decode together, are kept.  Then the same run with
   flash_prefill's plain version in the kernel's place, for the TTFT
   before the kernel (the kernel is replaced by an explicit patch of
   this script, not by the port).
5. serve_int8 — the same model, width and submissions with
   offload_quant="int8".  Asserts finished requests with finite logits,
   that flash_prefill, dequantize_scatter_blocks and quant_save_blocks
   launched, quant_save_blocks at most once per layer save, that no save
   went through quantize_blocks, dequantize_blocks, write_blocks_hkv or a
   flush's gather_blocks_hkv, and that the wire bytes per moved block are
   >= 1.8x smaller than the fp serve's; prints the first 8 tokens of each
   request beside the fp run's.  Its first prefill save and its restores,
   int8 gathers and a decode save from the middle decode step are kept.
6. mainpath — the kept launches of both serves replayed: each kernel
   against its plain version at the serve paths' own shapes, modes and
   data, with the tolerances of phase 2.  The kernels' JSON record takes
   its times and bounds from here.
7. oracles — the engine's oracle paths on the serve's model, width and
   submissions: mixed (the default), hybrid_plane "split",
   decode_plane "persistent" and "stacked", batched_decode False,
   prefill_exec "legacy", prefill_mode "chunked", and mixed, split and
   persistent with offload_quant "int8".  Per path one line: TTFT, mean
   TBT and tok/s on the wall clock, the launches of each kernel (each
   path's kernels must launch), H2D/D2H calls and bytes, the device's
   peak memory, prefill_hbm_peak_tokens and the agreement with the path
   it is held against.  split == mixed token for token on both tiers and
   persistent == mixed on the fp tier (same kernels at the same shapes);
   the paths that change GEMM or attention shapes are held by their
   logits at the first step where they differ (ORACLE_PATHS,
   ORACLE_REL_L2).  Then split == mixed token for token at MLA
   (minicpm3-4b at full width and depth, 8 new tokens, the fp tier).
   Its launch counts join the kernels' JSON record
   (``launches_by_path``).
8. models — the paper's models and workload at full width, bf16 random
   weights from --seed, the default EngineConfig with wall-clock
   charging, smallest weights first, each engine and its weights freed
   before the next (MODEL_RUNS): qwen2-0.5b with InfLLM's mean block
   metadata (MODEL_VARIANTS; score_select's mean mode must launch),
   whisper-small (encoder-decoder, each
   request with 1500 synthesized frames; prompts capped at 4096, past
   its 448-token decoder context: a stress of the serving path, said on
   its lines), rwkv6-1.6b (attention-free, all 24 layers: wkv6 must
   launch, a decode step runs no host stage), internvl2-2b (each request with 256 synthesized patch
   embeddings ahead of its prompt), qwen2.5-3b, minicpm3-4b (MLA), lwm-7b,
   kimi-k2-1t-a32b (MoE, 384 experts top-8, 1 of its 61 layers), granite-20b,
   jamba-v0.1-52b (the hybrid: Mamba layers through selective_scan, one
   attention layer in 8, MoE 16 experts top-2 on every odd layer; 16 of
   its 32 layers, on the fp tier and again on the int8 tier from the same
   weights and submissions) and arctic-480b (MoE, 128 experts top-2 with
   a dense residual, 2 of its 35 layers; MODEL_LAYERS: one card holds no
   more, each layer at full width, ``reduced=num_layers:<n>/<published>``
   on their lines) on the port's LongBench-shaped trace (generate_trace,
   2.0 req/s, 4 requests, prompts capped at 8192, 4096, 32768, 32768,
   32768, 32768, 4096, 32768, 8192, 32768 and 32768, 32 new tokens), and
   llama3-8b with one 131,072-token prompt, 8 new tokens, on the int8
   tier; minicpm3-4b and kimi-k2-1t-a32b are served on the int8 tier too,
   from the same weights and submissions (their lines give the tokens'
   digest, TTFT, TBT and wire bytes per moved block of each tier).  Algorithm 1's HBM budget stays the default 1 GiB unless the
   largest working set one request can claim (a VLM's patches counted
   in its prompt) exceeds it (minicpm3-4b,
   whose geometry counts its latent over 40 heads, lwm-7b, llama3-8b);
   then it is the device memory left after the weights.
   Asserts that every request was admitted and finished with finite
   logits, that every kernel of each config's path launched, and that at
   least one trace-driven config ran an iteration with prefill and
   decode rows together (the engine's mixed_iter_log).  Prints per
   config TTFT, mean and p99 TBT, tok/s, iterations and mixed ones, peak
   device memory, pinned host bytes, the HBM budget and launches by
   kernel, with the card's name and power limit; for the MoE configs the
   per-expert count read-backs (one per MoE call) per iteration and the
   experts a decode step touches per layer, and it asserts that no pair
   was dropped; for jamba-v0.1-52b and rwkv6-1.6b the scans launched
   and the host stages of a decode step, which must run at jamba's 2
   attention layers only, and at none of rwkv6-1.6b's.  One launch of each
   kernel at a shape only these configs give is kept and replayed, with
   the weights freed, against its plain version (phase_mainpath), each
   replay with its device ms per call under torch.profiler and from CUDA
   events over 10 back-to-back calls:
   sparse_decode_attention and score_select at NB 4104 (llama3-8b), G 48
   (granite-20b), G 40 over one 288-wide latent head (minicpm3-4b), G 8
   at D 112 (kimi-k2), G 7 at D 128 (arctic-480b), G 2 at D 128
   (internvl2-2b) and G 1 at D 64 (whisper-small); flash_prefill's
   non-causal mode at whisper-small's encoder, prefill cross-attention
   and decode cross-attention launches; and flash_prefill at
   D 128 over 32 kv heads (lwm-7b) and one (granite-20b), at D 96 with
   Dv 64 over 40 heads (minicpm3-4b), and at D = Dv = 112 over 8 kv heads
   (kimi-k2), and selective_scan at jamba-v0.1-52b's first prefill
   launch and a decode launch of the middle decode step, wkv6 at
   rwkv6-1.6b's first prefill launch and its widest decode launch, and
   score_select's mean mode at qwen2-0.5b-mean's decode step.
   Its launch counts join the kernels' JSON record.
9. obs    — the obs layer on the card (EngineConfig(obs=True): the
   reference's host wall-clock spans and metrics registry).  After a
   warm-up serve, the serve phase's run five times with obs off and five
   with it on, in turns (OBS_ORDER): the greedy tokens of all identical,
   the obs layer's own host work on each obs-on run (the trace events it
   emitted times their per-call cost, timed in this process after the
   serves) within 10% of that run's wall time (OBS_HOST_SHARE), obs-on's
   best wall time over obs-off's printed on a line of its own (it moves
   with the host's load across serves, so it holds nothing), and on each
   obs-on run iteration spans on the engine's
   lane, select / host-stage / attend spans, worker spans on a lane of
   their own overlapping iterations, and the trace's overlap within
   max(0.02, 0.1 x measured) of the counters' (stage_overlap_from_trace
   against stage_overlap_measured).  Prints one ``obs_breakdown`` JSON
   line: per span name its count, total host ms, ms per decode iteration
   and share of the summed iteration wall time over the decode-only
   iterations, and the wall no top-level span covers (admission, embed,
   logits, sampling, the worker's drain, the wall-clock charge's sync).  Then
   qwen2.5-3b at full width on the first 2 requests of the models phase's
   trace with obs on: prefill-group spans must sit inside mixed
   iterations beside decode select and attend spans; its obs_breakdown
   covers every iteration.  Writes both traces under chiprun_out/.
10. async — the same submissions at full width and 4 layers with
   stage_dispatch "async" and "sync", fp and int8: greedy tokens and
   transfer counters must be identical.
10a. mesh — the port's multi-rank bodies over torch.distributed at full
   width, depth cut (each line says so): the context-parallel decode
   (decode_step(plane_mesh=...), each rank a block shard of every
   attention layer's pools) of llama3-8b (4 of 32 layers) and
   minicpm3-4b (MLA, 2 of 62), B 2, prompts of 16,384 tokens, a pool of
   514 blocks of 32 (257 a rank at world 2), K 64, 8 steps fed the same
   seeded tokens; the sequence-parallel prefill layer of llama3-8b (1
   layer, B 1, an 8,191-token window, which 2 ranks pad); the
   expert-parallel MoE of one jamba-v0.1-52b MoE layer (16 experts, top
   2, 8 a rank at world 2; 2 x 4,096 tokens, drop-free).  Each body runs
   over NCCL at world 1 (this process, whose rank 0 also runs the
   single-device path on the same weights and inputs: the oracle) and
   over gloo at world 2 with both ranks on cuda:0 (two spawned
   processes, the collectives staged through host memory), and over
   NCCL at world 2 only where the machine has two cards.  Every rank
   builds the same full weights from the seed and keeps its shard.
   Bars, per run: logits within relative L2 ORACLE_REL_L2 (2^-5) of the
   oracle's, the prefill layer's x, k and v and the MoE's output within
   MESH_LAYER_REL_L2 (2^-10); each step's greedy token the
   oracle's, but where the oracle's top-2 gap is under 2^-5 of its
   logits' rms (reported); each step's and layer's selected blocks
   those of the single-device select stage (score_select) on the same q
   and the whole pool's metadata (the shards gathered after the run),
   tie-aware (select_agrees), and its merged attention output within
   relative L2 MESH_ATTEND_REL_L2 (2^-8) of the single-device
   sparse_decode_attention on the same q and ids over the whole pools
   (gathered after the run); the selected blocks at each step's first
   attention layer, where both runs see the same inputs, the oracle
   run's (deeper, the
   earlier layers' bf16 outputs differ: the count is reported); the
   routing of every token the oracle's on every rank; what a body hands
   back the same on every rank (digests); and each rank's launches of
   sparse_decode_attention:partial, block_score (block_score:wide at
   MLA's 288-wide latent) and flash_prefill above 0 in its bodies.  At
   most MESH_BUDGET_S (120 s), spawns included.  No time here is a
   multi-GPU figure: gloo ranks share one card.
10b. tied — tied embeddings (no registry config ties them, so
   qwen2-0.5b with tie_embeddings=True by dataclasses.replace, said on
   every line) at full width and depth, beside its untied twin (the
   same weights with lm_head = embed.T, a contiguous copy): the engine
   serves TIED_REQUESTS x 4096-token prompts TIED_NEW tokens each with
   the head h @ embed.T over the full vocabulary, then the twin serves
   them fed the tied run's tokens; every step's logits within relative
   L2 TIED_LOGITS_REL_L2 (2^-8) of the twin's and every greedy token
   the twin's argmax, but where the twin's top-2 gap is under 2^-5 of
   its logits' rms (reported).  Then training at B 2 x 4096 in float32:
   step 1's loss and every gradient within TIED_GRAD_REL_L2 (1e-4) of
   the twin's, the tied embed's against the twin's embed + lm_head.T
   (its embed's alone must fall outside the bar: the head's share of
   the gradient shows), and two AdamW steps through the trainer's
   make_train_step, the first's loss step 1's and the second's lower.
11. train — training's attention kernels, then dense GQA training at
   full width.  flash_prefill_bwd (csrc/flash_prefill_bwd.cu: Delta, dK
   and dV over chunks of the GQA group, dQ, the chunks' sum) and the
   forward with its lse output against their plain versions on the same
   bf16 inputs, at qwen2-0.5b's heads over a ragged 1000 tokens (B 2),
   llama3-8b's over 2048 (B 1) and the training run's own shape (B 2,
   S 4096, 14 over 2 heads of 64): each gradient within 2e-2 of its max
   |grad| with a cosine >= 0.999, two launches bit-equal, a planted fault
   (the last chunk's partial dK and dV left out of the group's sum) outside
   that bar, lse within 1e-3, the output bit for bit the serve launch's;
   timed beside the plain versions, their FLOP bound (five products), the
   design's seven-product floor and SDPA's backward (and forward +
   backward).  Then qwen2-0.5b at full width and all 24 layers,
   float32 weights, gradients and AdamW moments, trained 8 steps at B 2,
   S 4096 with remat on, on one fixed TokenStream batch: the loss of step
   8 below step 1's, step 1's loss within 1e-3 relative and its grad norm
   within 2% of the same step with the plain attention (float32, patched
   in by this script; the trainer has no such option), flash_prefill
   launched 48 times a step (the forward and remat's rerun of 24 layers,
   all with lse) and flash_prefill_bwd 24; ms per step, tokens per
   second, peak device memory; then a checkpoint of the params saved
   and restored equal.  The same kernels' training instances beyond
   dense GQA, at the runs' shapes (TRAIN_CASES, with the same bars):
   MLA's (96, 64) heads (B 1, S 4096, 40 over 40; records
   flash_prefill:lse_mla, flash_prefill_bwd:mla), internvl2-2b's causal
   (128, 128) heads (B 2, S 4096, 16 over 8) and whisper-small's decoder
   self-attention (B 8, S 448, 12 over 12 of 64) under the records of
   qwen2-0.5b's instance, and the non-causal mode over Sq != Sk (records
   flash_prefill:lse_noncausal, flash_prefill_bwd:noncausal) at
   whisper-small's encoder (B 8, 1500 x 1500), its cross-attention (448
   x 1500) and the launcher's 16 frames, with one more planted fault
   (the ragged last key tile left out of dQ).  Then minicpm3-4b (MLA),
   internvl2-2b (256 patch embeddings ahead of 3,840 tokens, B 2) and
   whisper-small (B 8, 1500 frames, 448 tokens) at full width and depth
   (TRAIN_RUNS), 3 AdamW steps each, held as qwen2-0.5b's: step 1
   against the plain attention, the loss falling, every attention's
   launches by instance (``_want_launches``) and by shape.  Each
   path=train case gets the runs' launches at its own shape (a record's
   ``launches`` stays the phase's count of its name); a shape that the
   runs launch without a parity line fails the phase.  And RWKV6's
   training kernels (WKV_TRAIN_CASES): wkv6's float32 instance that keeps
   each time chunk's incoming state (kernel A, csrc/wkv6.cu, record
   wkv6:train) against the plain forward walked chunk by chunk, y, the
   final state and every S_in[c] within wkv6's WKV_RTOL bar, and its
   gradient (kernel B, csrc/wkv6_bwd.cu, record wkv6_bwd) against
   ref.wkv6_bwd, each of the six gradients within 2^-12 of its max |grad|
   with a cosine >= 0.99999 (WKV_GRAD_ERR, WKV_GRAD_COS), two launches
   bit-equal, and four planted faults rejected (u's term dropped from
   dk, lam's carry into chunk 0 dropped, the decay sum's carry into chunk
   0 dropped, a_end left out of every chunk's suffix by a build with
   that fault planted), at the rwkv6-1.6b run's shape (B 2 x 4,096, 32
   heads of 64), at a ragged B 2 x 1,000 and at the models phase's 14,211-token
   prefill window, timed with CUDA events beside the plain versions (no
   PyTorch call computes either).  Then rwkv6-1.6b at full width and all
   24 layers trained 3 steps at B 2 x 4,096, step 1 held against the
   plain wkv6 and wkv6_bwd patched in, wkv6:train launched 48 times a
   step and wkv6_bwd 24, by shape as the attention's.  And the hybrid's
   training kernels (SCAN_TRAIN_CASES): the selective scan's float32
   instance that stores the state before each 64-token chunk (kernel C,
   csrc/selective_scan.cu, record selective_scan:train) against the plain
   scan, y, the final state and every checkpoint within the serve's
   scan bar, and its gradient (kernel D, csrc/selective_scan_bwd.cu,
   record selective_scan_bwd) against ref.selective_scan_bwd, each of the
   seven gradients within 2^-12 of its max |grad| with a cosine >=
   0.99999 (SCAN_GRAD_ERR, SCAN_GRAD_COS), two launches bit-equal and
   three planted faults rejected (the final state's gradient ignored,
   chunk 1's checkpoint zeroed, the last 32-channel group's share of dB
   and dC left out), at jamba-v0.1-52b's train shape (B 1 x 4,096,
   d_inner 8192), a ragged B 2 x 1,000 and the models phase's
   14,211-token window, from a non-zero h0 with a non-zero final state's
   gradient.  Then jamba-v0.1-52b at full width and 2 of its 32 layers
   (TRAIN_LAYERS: a Mamba layer with the dense FFN, one with the
   16-expert MoE; ``reduced=num_layers:2/32`` on its lines) trained 3
   steps at B 1 x 4,096 with the reference's capacity drops and aux loss,
   step 1 held against the plain scan and backward patched in (the
   routing decisions of the two steps compared), selective_scan:train
   launched 4 times a step and selective_scan_bwd 2, the MoE's pairs and
   drops, and the forwards without a gradient (float32 through the
   training scan, the eval step in bfloat16 through the serve's) against
   the plain float32 loss.  And
   kimi-k2's (112, 112) heads (B 1, S 4,096, 64 over 8, causal): the lse
   forward and the backward against their plain versions under the
   attention's bars, SDPA's times beside them (records
   flash_prefill:lse_d112, flash_prefill_bwd:d112; no run on one card
   trains kimi-k2, so they launch 0 times on the runs).
12. calibrate — the cost model's H100_80G against this card: a 1 GiB
   pinned-to-device copy, 4096 copy_ calls of one 8 KiB block from
   pinned memory and 2000 one-block gather_blocks_hkv launches (each the
   best of 5 passes), the fused gather at the fp serve's shape, the
   device's and the host's memory; each beside its H100_80G field,
   failing beyond 2x.
13. profile, profile_int8 (only when named in --phases) — the serve
   (serve_int8) run again under torch.profiler: device busy time, idle
   share, the count of device operations (kernels, copies, memsets),
   largest device consumers, and the port's kernels (``port_kernel=``
   lines: device ms over calls is a kernel's device time per launch).
14. precision (only when named in --phases) — rwkv6-1.6b's step-1
   gradient at full width and depth (the train run's weights and batch)
   through the kernels and through the plain wkv6 and wkv6_bwd, in
   float32, each against the same step in float64: the global norms and
   each layer's relative L2 error (``phase=precision`` lines).

Before the last line it prints the kernels' JSON record and the card's
name and power limit; the last line is the device JSON.  Without CUDA, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import gc
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (data sheet)
BF16_OPS_PER_S = 989e12              # H100 SXM dense bf16 tensor peak
F32_OPS_PER_S = 67e12                # H100 SXM float32 outside the tensor
                                     # cores (selective_scan's and wkv6's
                                     # arithmetic)
PHASES = ("build", "parity", "transfer", "serve", "serve_int8", "oracles",
          "models", "obs", "async", "contract", "mesh", "tied", "train",
          "calibrate")

KERNELS = {   # name -> (source in this repo, the TPU kernel it replaces)
    "sparse_decode_attention": (
        "src/repro_torch/csrc/sparse_decode_attention.cu",
        "src/repro/kernels/sparse_decode_attention.py:76"),
    "block_score": ("src/repro_torch/csrc/block_score.cu",
                    "src/repro/kernels/block_score.py:34"),
    "block_score:wide": ("src/repro_torch/csrc/block_score.cu",
                         "src/repro/kernels/block_score.py:34"),
    "sparse_decode_attention:partial": (
        "src/repro_torch/csrc/sparse_decode_attention.cu",
        "src/repro/kernels/sparse_decode_attention.py:76"),
    "gather_blocks_hkv": ("src/repro_torch/csrc/gather_blocks.cu",
                          "src/repro/kernels/gather_blocks.py:57"),
    "scatter_blocks_hkv": ("src/repro_torch/csrc/scatter_blocks.cu",
                           "src/repro/kernels/scatter_blocks.py:61"),
    # scatter_blocks_hkv's drop use (a zero payload), a whole eviction
    # round per launch
    "zero_blocks_hkv": ("src/repro_torch/csrc/scatter_blocks.cu",
                        "src/repro/kernels/scatter_blocks.py:61"),
    # block_score fused with the reference's select_blocks
    "score_select": ("src/repro_torch/csrc/block_score.cu",
                     "src/repro/kernels/block_score.py:34"),
    # the byte-for-byte instance of scatter_blocks_hkv, into pinned memory
    "write_blocks_hkv": ("src/repro_torch/csrc/scatter_blocks.cu",
                         "src/repro/kernels/scatter_blocks.py:61"),
    "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                      "src/repro/kernels/flash_prefill.py:71"),
    "quantize_blocks": ("src/repro_torch/csrc/quant_blocks.cu",
                        "src/repro/kernels/quant_blocks.py:51"),
    "dequantize_blocks": ("src/repro_torch/csrc/quant_blocks.cu",
                          "src/repro/kernels/quant_blocks.py:86"),
    "dequantize_scatter_blocks": ("src/repro_torch/csrc/quant_blocks.cu",
                                  "src/repro/kernels/quant_blocks.py:117"),
    # the int8 save: quantize_blocks (:51) and dequantize_blocks (:86) as
    # the reference's HostPool.flush runs them, fused into one launch per
    # layer save
    "quant_save_blocks": ("src/repro_torch/csrc/quant_blocks.cu",
                          "src/repro/kernels/quant_blocks.py:51"),
    "gather_blocks": ("src/repro_torch/csrc/gather_blocks.cu",
                      "src/repro/kernels/gather_blocks.py:31"),
    "scatter_blocks": ("src/repro_torch/csrc/scatter_blocks.cu",
                       "src/repro/kernels/scatter_blocks.py:29"),
    # no Pallas kernel: the reference's Mamba recurrence is a lax.scan
    "selective_scan": ("src/repro_torch/csrc/selective_scan.cu",
                       "src/repro/models/mamba.py:60 (jax.lax.scan)"),
    # score_select's other scorings, the reference's score_blocks: InfLLM's
    # mean metadata (max over the group), and the sum over the group
    "score_select:mean": ("src/repro_torch/csrc/block_score.cu",
                          "src/repro/kernels/block_score.py:34"),
    "score_select:sum": ("src/repro_torch/csrc/block_score.cu",
                         "src/repro/kernels/block_score.py:34"),
    # no Pallas kernel: the reference's RWKV6 recurrence is a lax.scan
    "wkv6": ("src/repro_torch/csrc/wkv6.cu",
             "src/repro/models/rwkv6.py:135 (jax.lax.scan)"),
    # training's forward: flash_prefill with each row's log-sum-exp
    "flash_prefill:lse": ("src/repro_torch/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill.py:71"),
    "flash_prefill_bwd": (
        "src/repro_torch/csrc/flash_prefill_bwd.cu",
        "no TPU kernel: the gradient of flash_attention_jnp "
        "(src/repro/models/attention.py:90)"),
    # training's instances at MLA's (96, 64) heads (minicpm3-4b) and in the
    # non-causal mode over Sq != Sk (whisper-small's encoder and
    # cross-attention): the forward with lse, then the backward
    "flash_prefill:lse_mla": ("src/repro_torch/csrc/flash_prefill.cu",
                              "src/repro/kernels/flash_prefill.py:71"),
    "flash_prefill:lse_noncausal": ("src/repro_torch/csrc/flash_prefill.cu",
                                    "src/repro/kernels/flash_prefill.py:71"),
    "flash_prefill_bwd:mla": (
        "src/repro_torch/csrc/flash_prefill_bwd.cu",
        "no TPU kernel: the gradient of flash_attention_jnp "
        "(src/repro/models/attention.py:90)"),
    "flash_prefill_bwd:noncausal": (
        "src/repro_torch/csrc/flash_prefill_bwd.cu",
        "no TPU kernel: the gradient of flash_attention_jnp "
        "(src/repro/models/attention.py:90)"),
    # RWKV6's training: wkv6's float32 instance that keeps each chunk's
    # incoming state (kernel A), and its gradient (kernel B)
    "wkv6:train": ("src/repro_torch/csrc/wkv6.cu",
                   "src/repro/models/rwkv6.py:135 (jax.lax.scan)"),
    "wkv6_bwd": ("src/repro_torch/csrc/wkv6_bwd.cu",
                 "no TPU kernel: the gradient of the jax.lax.scan of "
                 "_wkv_step (src/repro/models/rwkv6.py:93, :135-140)"),
    # the hybrid's training: the selective scan's float32 instance that
    # stores each chunk's incoming state (kernel C), and its gradient
    # (kernel D)
    "selective_scan:train": ("src/repro_torch/csrc/selective_scan.cu",
                             "src/repro/models/mamba.py:60 (jax.lax.scan)"),
    "selective_scan_bwd": ("src/repro_torch/csrc/selective_scan_bwd.cu",
                           "no TPU kernel: the gradient of the jax.lax.scan "
                           "of _ssm_scan (src/repro/models/mamba.py:60-80)"),
    # training's instances at kimi-k2's (112, 112) heads
    "flash_prefill:lse_d112": ("src/repro_torch/csrc/flash_prefill.cu",
                               "src/repro/kernels/flash_prefill.py:71"),
    "flash_prefill_bwd:d112": (
        "src/repro_torch/csrc/flash_prefill_bwd.cu",
        "no TPU kernel: the gradient of flash_attention_jnp "
        "(src/repro/models/attention.py:90)"),
}
# the serve path whose launches a kernel's record counts, where it is not
# the fp serve (the transfer phase's and the int8 tier's are below)
OWNERS = {"selective_scan": "models_jamba-v0.1-52b",
          "wkv6": "models_rwkv6-1.6b",
          "score_select:mean": "models_qwen2-0.5b-mean",
          "flash_prefill:lse": "train", "flash_prefill_bwd": "train",
          "flash_prefill:lse_mla": "train",
          "flash_prefill:lse_noncausal": "train",
          "flash_prefill_bwd:mla": "train",
          "flash_prefill_bwd:noncausal": "train",
          "wkv6:train": "train", "wkv6_bwd": "train",
          "selective_scan:train": "train", "selective_scan_bwd": "train",
          "flash_prefill:lse_d112": "train",
          "flash_prefill_bwd:d112": "train",
          "block_score": "mesh", "block_score:wide": "mesh",
          "sparse_decode_attention:partial": "mesh"}
# the flat FlashH2D / FlashD2H pair: no serve path calls them (in the
# reference only benchmarks/bench_transfer.py does); the transfer phase
# drives them
TRANSFER_PATH = ("gather_blocks", "scatter_blocks")
# the kernels whose registers and spills the build phase prints
REGISTER_WATCH = ("flash_prefill", "sparse_decode_attention",
                  "flash_prefill_bwd", "wkv6_bwd", "selective_scan_bwd")
# the kernels each serve path must launch (the int8 tier restores through
# dequantize_scatter_blocks, not scatter_blocks_hkv, and saves through
# quant_save_blocks)
DECODE_PATH = ("sparse_decode_attention", "score_select", "gather_blocks_hkv",
               "zero_blocks_hkv", "flash_prefill")
FP_PATH = DECODE_PATH + ("scatter_blocks_hkv",)
INT8_ONLY = ("quant_save_blocks", "dequantize_scatter_blocks")
INT8_PATH = DECODE_PATH + INT8_ONLY
# the int8 save before quant_save_blocks: none of them may launch on a
# serve (nor gather_blocks_hkv from a flush)
OLD_SAVE = ("quantize_blocks", "dequantize_blocks", "write_blocks_hkv")
# the __global__ functions of src/repro_torch/csrc (the profile's names)
PORT_KERNEL_FNS = ("split_kernel", "merge_kernel", "block_score_kernel",
                   "block_score_wide_kernel",
                   "score_select_kernel", "gather_blocks_kernel",
                   "scatter_blocks_kernel", "zero_blocks_kernel",
                   "write_blocks_kernel", "flash_prefill_kernel",
                   "quantize_blocks_kernel", "dequantize_blocks_kernel",
                   "dequantize_scatter_blocks_kernel",
                   "quant_save_blocks_kernel", "selective_scan_kernel",
                   "wkv6_local_kernel", "wkv6_carry_kernel",
                   "wkv6_emit_kernel", "wkv6_step_kernel",
                   "flash_bwd_delta_kernel", "flash_bwd_dkdv_kernel",
                   "flash_bwd_dq_kernel", "flash_bwd_reduce_kernel",
                   "wkv6_bwd_fwd_kernel", "wkv6_bwd_carry_kernel",
                   "wkv6_bwd_bwd_kernel", "wkv6_bwd_du_kernel",
                   "selective_scan_bwd_kernel",
                   "selective_scan_bwd_sum_kernel")
# one PyTorch call computing the same function, where there is one; else
# why not (printed, and null in the JSON record)
NO_LIBRARY = {
    "sparse_decode_attention": "block-sparse attention over selected ids",
    "block_score": "the interleaved cuboid bound",
    "block_score:wide": "the interleaved cuboid bound",
    "sparse_decode_attention:partial": "unnormalised flash partials over "
                                       "a block shard's selected ids",
    "score_select": "a cuboid bound fused with a masked, forced top-k",
    "gather_blocks_hkv": "a gather from pinned host memory in place",
    "scatter_blocks_hkv": "a cast-and-scatter into a paged pool",
    "write_blocks_hkv": "a block scatter into pinned memory in place",
    "quantize_blocks": "per-block amax, scale and round in one call",
    "dequantize_scatter_blocks": "a dequantize-and-scatter into a pool",
    "quant_save_blocks": "a dequantize, overlay and requantize of blocks in "
                         "pinned memory in place",
    "selective_scan": "no PyTorch call computes a selective scan",
    "score_select:mean": "a block mean's score fused with a masked, forced "
                         "top-k",
    "score_select:sum": "a group-summed block score fused with a masked, "
                        "forced top-k",
    "wkv6": "no PyTorch call computes the WKV recurrence",
    "flash_prefill_bwd": "SDPA refused the shape",
    "flash_prefill_bwd:mla": "SDPA refused the shape",
    "flash_prefill_bwd:noncausal": "SDPA refused the shape",
    "wkv6:train": "no PyTorch call computes the WKV recurrence",
    "wkv6_bwd": "no PyTorch call computes the WKV recurrence's gradient",
    "selective_scan:train": "no PyTorch call computes a selective scan",
    "selective_scan_bwd": "no PyTorch call computes a selective scan's "
                          "gradient",
    "flash_prefill_bwd:d112": "SDPA refused the shape",
}
SHAPES = {"qwen2-0.5b": dict(Hq=14, Hkv=2, D=64),
          "llama3-8b": dict(Hq=32, Hkv=8, D=128)}
B, BS, K, NB = 8, 32, 64, 256
# the decode kernels at a GQA group of several tiles (granite-20b: 48
# query heads over one kv head), and score_select past 4096 blocks
# (llama3-8b's heads; 8193 blocks hold its 262,144-token context)
GROUP_SHAPE = dict(arch="granite-20b", Hq=48, Hkv=1, D=128)
GROUP_B, LONG_B, LONG_NB = 4, 2, (4097, 8193)
# MLA (minicpm3-4b): the decode kernels over one latent head of D = Dv =
# 288 (kv_lora 256 + rope 32) under its 40 absorbed query heads (group
# tiles of 16, 16 and 8 rows), the pool passed as both k and v, scale
# 1 / sqrt(qk = 96); score_select at NB 256 (rank-all) and 1025 (the radix
# path; 1025 blocks hold the trace's 32,768-token cap); flash_prefill at
# q/k depth 96 and v width 64, 40 heads over 40
MLA_SHAPE = dict(arch="minicpm3-4b", Hq=40, Hkv=1, D=288, qk=96, v=64)
MLA_B, MLA_NB = 4, ((256, 4), (1025, 2))
# the MoE family's attention: kimi-k2 (d_model 7168 over 64 heads: D = Dv =
# 112, flash_prefill's fourth instantiation; G 8) and arctic-480b (56 heads
# over 8 at D 128: G 7), the decode kernels at B 4, NB 448 (the trace's
# 14,211-token prompt); flash_prefill at kimi-k2's heads, a 4096-token
# prompt and a chunk continuation
MOE_SHAPES = {"kimi-k2-1t-a32b": dict(Hq=64, Hkv=8, D=112),
              "arctic-480b": dict(Hq=56, Hkv=8, D=128)}
MOE_B, MOE_NB = 4, 448
# the frontend families' decode shapes: internvl2-2b (16 query heads over
# 8 at D 128: G 2) and whisper-small (12 over 12 at D 64: G 1), B 4, NB
# 264; flash_prefill's non-causal mode (Whisper's encoder, its
# cross-attention from a prompt window and from one decode token per row,
# over the 1500 encoder positions, and at D 128 with G 2 over a ragged
# Sk): (label, B, Sq, Sk, Hq, Hkv, D)
FRONTEND_SHAPES = {"internvl2-2b": dict(Hq=16, Hkv=8, D=128),
                   "whisper-small": dict(Hq=12, Hkv=12, D=64)}
FRONTEND_B, FRONTEND_NB = 4, 264
NONCAUSAL_CASES = (("whisper_encoder", 1, 1500, 1500, 12, 12, 64),
                   ("whisper_cross_prefill", 4, 256, 1500, 12, 12, 64),
                   ("whisper_cross_decode", 4, 1, 1500, 12, 12, 64),
                   ("gqa_d128", 2, 300, 1000, 16, 8, 128),
                   ("gqa_d128_decode", 4, 1, 700, 32, 8, 128))
# Mamba's selective scan at jamba-v0.1-52b's widths (d_inner 8192, d_state
# 16): a prefill window of 4 right-padded rows (dt = 0 past each row's
# length), the decode step, and one row over 4096 tokens (as a one-row
# prefill window runs: 256 CTAs), all from a non-zero h0: (label, B, S,
# row lengths)
SCAN_DI, SCAN_DS = 8192, 16
SCAN_CASES = (("prefill", 4, 1000, (1000, 777, 130, 1)),
              ("decode", 4, 1, (1, 1, 1, 1)),
              ("long_row", 1, 4096, (4096,)))
# float32 on both sides: the 16-state sum in another order, expf against
# torch's exp and the compiler's fused multiply-adds each move y and h by
# a few float32 steps (2^-24 relative) of the terms, and |dA| <= 1 keeps
# an error from growing along the tokens
SCAN_ATOL, SCAN_RTOL = 1e-5, 1e-4
# RWKV6's WKV recurrence at rwkv6-1.6b's heads (32 of 64): a prefill
# window of 4 rows over 1000 tokens from a zero state, the decode step
# (S = 1) from a carried one, a window of 4 right-padded rows (k = 0 and
# w = 1 past each row's length, as the time-mix masks them) from a
# carried one, and one row over 4096 tokens from a carried one (the
# kernel's time chunks at a one-row window): (label, B, S, row lengths,
# carried state)
WKV_H, WKV_HD = 32, 64
WKV_CASES = (("prefill", 4, 1000, (1000,) * 4, False),
             ("decode", 4, 1, (1,) * 4, True),
             ("masked", 4, 1000, (1000, 777, 130, 1), True),
             ("long_row", 1, 4096, (4096,), True))
# float32 on both sides, held per element to |err| <= WKV_RTOL * W +
# WKV_ATOL, W the plain version run on |r|, |k|, |v|, w, |u| and |S0|
# (every term's magnitude, so a y that cancels to near 0 keeps its
# scale): y sums 64 products in another order (and in four partial sums),
# with fused multiply-adds, <= 64 float32 steps (2^-24) of W; the state
# adds one rounding per token, decayed by w < 1 on every later token, so
# its error stays within a few steps of W too.  In time chunks the state
# carried into a chunk is W[c] S_in + S_loc: the decay product W[c] has
# the token walk's L roundings of the same factors, and the add one more
# per chunk, each damped by every later decay, so the carries keep the
# state within a few steps of W.  2^-14 leaves a margin of 16 over 64
# steps.
WKV_RTOL, WKV_ATOL = 2.0 ** -14, 1e-6
# score_select's other scorings at qwen2-0.5b's serve shape (the serve
# phase's decode step: B 4, Hkv 2, G 7, D 64, 136 blocks of its 4096 +
# 32 tokens plus one), ties planted: (label, metadata, group reduction)
SELECT_MODE_B, SELECT_MODE_NB = 4, 136
SELECT_MODES = (("mean_max", "mean", "max"), ("cuboid_sum", "cuboid", "sum"),
                ("mean_sum", "mean", "sum"))
# a sentinel no output of the kernel takes, in the guard band after its
# output (flash_guard)
FLASH_GUARD, FLASH_SENTINEL = 64, 1000.0
ATTN_ATOL, ATTN_RTOL = 2e-3, 1e-2
# flash_prefill, per output element: FLASH_WEIGHT_TOL * W + FLASH_RTOL *
# |ref|, W = sum_j p_j |v_j| / sum_j p_j (the plain version run on |v|)
FLASH_WEIGHT_TOL, FLASH_RTOL = 1.25 * 2.0 ** -8, 2.0 ** -7
SCORE_ATOL, SCORE_RTOL = 1e-3, 1e-4
SPIN_CYCLES = 200_000                # ~0.1 ms of device clock (Timer)
# Timer: a call whose 20 launches would take over TIMER_BUDGET_S seconds
# (only the plain versions' token walks at long windows, up to 3 s a call;
# every kernel takes under 10 ms) is timed TIMER_MIN_REPS times, and one
# whose TIMER_MIN_REPS would too (the plain WKV and scan walks over the
# 14,211-token window) once
TIMER_BUDGET_S, TIMER_MIN_REPS = 5.0, 3
SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 4096, 32
# the oracles phase: path -> (EngineConfig values, kernels that must
# launch, the path it is held against, the step whose logits are held
# against that path's, None where the tokens must be identical).  The
# persistent plane keeps evicted blocks (no drops); the stacked and
# sequential paths never restore into device slots; the others decode on
# the staged plane.  int8 persistent is not int8 staged (staged attends
# over blocks restored from int8; persistent keeps the device copy for
# the step that selected a block), but its restores land after the
# forward, so its first decode step is fp persistent's.
PERSISTENT_PATH = tuple(n for n in FP_PATH if n != "zero_blocks_hkv")
UNRESTORED_PATH = ("sparse_decode_attention", "score_select",
                   "gather_blocks_hkv", "flash_prefill")
ORACLE_PATHS = {
    "mixed": ({}, FP_PATH, "mixed", None),
    "split": ({"hybrid_plane": "split"}, FP_PATH, "mixed", None),
    "persistent": ({"decode_plane": "persistent"}, PERSISTENT_PATH,
                   "mixed", None),
    "stacked": ({"decode_plane": "stacked"}, UNRESTORED_PATH, "mixed", 1),
    "sequential": ({"batched_decode": False}, UNRESTORED_PATH, "mixed", 1),
    "legacy": ({"prefill_exec": "legacy"}, FP_PATH, "mixed", 0),
    "chunked": ({"prefill_mode": "chunked"}, FP_PATH, "mixed", 0),
    "mixed_int8": ({"offload_quant": "int8"}, INT8_PATH, "mixed_int8",
                   None),
    "split_int8": ({"hybrid_plane": "split", "offload_quant": "int8"},
                   INT8_PATH, "mixed_int8", None),
    "persistent_int8": ({"decode_plane": "persistent",
                         "offload_quant": "int8"},
                        tuple(n for n in INT8_PATH
                              if n != "zero_blocks_hkv"), "persistent", 1),
}
# the kernels whose launches an oracle path gives at shapes no serve does,
# kept for phase_mainpath: B = 1 decode (sequential), a stacked pool of
# the batch's largest block count (stacked), B = 1 prefill with the
# prompt's layout (legacy), a chunk attending over its context (chunked)
ORACLE_KEEP = {
    "stacked": ("sparse_decode_attention", "score_select"),
    "sequential": ("sparse_decode_attention", "score_select"),
    "legacy": ("flash_prefill",),
    "chunked": ("flash_prefill:context",),
}
# the fp paths run again fed the mixed run's tokens (their logits held
# at every step), and the paths whose prefilled decode pools are held
# against the mixed prefill's (recorded from "mixed", which runs first)
FORCED_PATHS = ("stacked", "sequential", "legacy", "chunked")
# split == mixed at MLA too (its one latent head through both planes), at
# full width and depth with fewer new tokens than the serve's
ORACLE_MLA_ARCH, ORACLE_MLA_NEW = "minicpm3-4b", 8
POOL_PATHS = ("mixed", "split", "legacy", "chunked")
# Two bf16 forwards of the same 24-layer model whose GEMM or attention
# shapes differ round differently: each layer's two residual adds round
# to bf16 (unit roundoff 2^-8), so 48 roundings that differ independently
# give a relative error of about sqrt(48) * 2^-8 = 0.027 on the last hidden
# state, under 2^-5; the lm head adds one more rounding of 2^-8.
ORACLE_REL_L2 = 2.0 ** -5
# the mesh phase (module docstring, 10a): (arch, layers kept) of the
# context-parallel decode bodies, their batch, prompt and steps; the
# sequence-parallel prefill layer's (arch, B, window); the expert-parallel
# MoE layer's (arch, B, S); the gloo world on one card; the phase's budget
MESH_CP = (("llama3-8b", 4), ("minicpm3-4b", 2))
MESH_B, MESH_PROMPT, MESH_STEPS = 2, 16384, 8
MESH_SP = ("llama3-8b", 1, 8191)
MESH_EP = ("jamba-v0.1-52b", 2, 4096)
MESH_WORLD = 2
MESH_BUDGET_S = 120.0
# the sequence-parallel layer's and the expert-parallel MoE's bar,
# tightened from ORACLE_REL_L2 after their first runs came out bit-equal
# to the oracle at both worlds (each query row's attention and each
# token's two expert shares are the oracle's own arithmetic)
MESH_LAYER_REL_L2 = 2.0 ** -10
# each step's and layer's merged context-parallel attention output (bf16)
# against the single-device sparse_decode_attention on the same q, ids
# and whole pools: both sum in float32 and round once to bf16, so they
# differ by at most a bf16 step where the two float32 sums straddle a
# rounding boundary
MESH_ATTEND_REL_L2 = 2.0 ** -8
# the tied phase (module docstring, 10b): its serve's requests and new
# tokens; the logits' bar (the same kernels and weights as the untied
# twin, only the head's GEMM reading embed transposed in place of its
# copy: both round the logits once to bf16) and the float32 step 1's
TIED_ARCH, TIED_REQUESTS, TIED_NEW = "qwen2-0.5b", 2, 16
TIED_LOGITS_REL_L2 = 2.0 ** -8
TIED_GRAD_REL_L2 = 1e-4
# the partial decode attention's tolerance (float32 sums over the splits
# in another order than the plain version): per tensor |err| <= 1e-4 of
# its scale + 1e-4 |ref|, m exactly -1e30 where no position is valid
PARTIAL_TOL = 1e-4
# the models phase, smallest weights first: arch -> (offload tier, trace
# (requests, max_prompt_len, max_new_tokens) from the port's
# generate_trace at MODEL_RATE req/s, or None for one request of
# LONG_PROMPT tokens arriving at 0.0, the kernels whose launches are kept
# for phase_mainpath at the shapes only that config gives them: the
# decode kernels at NB > 4096 (llama3-8b) and at G = 48 (granite-20b),
# flash_prefill at D 128 with 32 kv heads (lwm-7b) and one (granite-20b);
# all three at MLA's shapes (minicpm3-4b: G = 40 over one 288-wide latent
# head, flash_prefill at D 96 with Dv 64), and at the MoE family's
# (kimi-k2: G 8 at D 112, flash_prefill at D = Dv = 112; arctic-480b: G 7
# at D 128))
MODEL_RUNS = {
    "qwen2-0.5b-mean": ("none", (4, 8192, 32), ("score_select:mean",)),
    "whisper-small": ("none", (4, 4096, 32), (
        "sparse_decode_attention", "score_select", "flash_prefill:encoder",
        "flash_prefill:cross_prefill", "flash_prefill:cross_decode")),
    "rwkv6-1.6b": ("none", (4, 32768, 32), ("wkv6:prefill",
                                            "wkv6:decode")),
    "internvl2-2b": ("none", (4, 32768, 32), (
        "sparse_decode_attention", "score_select")),
    "qwen2.5-3b": ("none", (4, 32768, 32), ()),
    "minicpm3-4b": (("none", "int8"), (4, 32768, 32), (
        "sparse_decode_attention", "score_select", "flash_prefill")),
    "lwm-7b": ("none", (4, 4096, 32), ("flash_prefill",)),
    "llama3-8b": ("int8", None, ("sparse_decode_attention",
                                 "score_select")),
    "kimi-k2-1t-a32b": (("none", "int8"), (4, 32768, 32), (
        "sparse_decode_attention", "score_select", "flash_prefill")),
    "granite-20b": ("none", (4, 8192, 32), (
        "sparse_decode_attention", "score_select", "flash_prefill")),
    "jamba-v0.1-52b": (("none", "int8"), (4, 32768, 32), (
        "selective_scan:prefill", "selective_scan:decode")),
    "arctic-480b": (("none", "int8"), (4, 32768, 32), (
        "sparse_decode_attention", "score_select")),
}
# the configs served with fewer layers than published, each layer at full
# width: one card holds kimi-k2's embedding, head and 1 of its 61 layers
# (38.8 GB; 33.8 GB of it the layer's 384 experts), arctic-480b's and 2 of
# its 35 (55.4 GB); every layer of both is an MoE layer; jamba-v0.1-52b's
# and 16 of its 32 layers, two whole 8-layer periods (52.0 GB: 2 attention
# layers, 14 Mamba layers, 8 MoE layers).  minicpm3-4b, kimi-k2,
# jamba-v0.1-52b and arctic-480b are served on both tiers (the tuples in
# MODEL_RUNS), each from one set of weights.
MODEL_LAYERS = {"kimi-k2-1t-a32b": 1, "arctic-480b": 2,
                "jamba-v0.1-52b": 16}
# a MODEL_RUNS name that is a registry config with fields replaced:
# qwen2-0.5b with InfLLM's mean block metadata (score_select's mean mode
# on the decode path)
MODEL_VARIANTS = {"qwen2-0.5b-mean": ("qwen2-0.5b", {"metadata": "mean"})}
# whisper-small's decoder context is 448 tokens: prompts of up to 4096
# stress the serving path (a decoder KV past the DSA budget, so selection
# and restores do real work); no deployment sends them.  Printed on every
# line of its serve.
MODEL_NOTES = {"whisper-small": " stress=prompts_past_the_448_token_"
                                "decoder_context"}
MODEL_RATE = 2.0
LONG_PROMPT, LONG_NEW = 131072, 8
# the oracle paths the CPU tests hold against the JAX engine at each
# family beyond qwen2-0.5b (read from tests/test_torch_mla.py,
# test_torch_moe.py, test_torch_jamba_paths.py, test_torch_rwkv_engine.py,
# test_torch_vlm_paths.py, test_torch_whisper_paths.py and
# test_torch_whisper_oracles.py; MLA's chunked baseline raises), run on
# the card after the family's models-phase serve, on its weights, at full
# width and the depth given: arch -> (layers, paths).  Jamba's 8 layers
# are one whole period (attention at layer 4, MoE at the odd layers);
# kimi-k2 and arctic-480b keep their MODEL_LAYERS.  FAMILY_REQUESTS
# requests of FAMILY_PROMPT tokens, all arriving at 0.0: at DSA block 32
# and K = 64, 4,096 tokens are 128 blocks, so selection and restores do
# real work
FAMILY_ORACLES = {
    "whisper-small": (2, ("stacked", "sequential", "legacy", "chunked")),
    "rwkv6-1.6b": (2, ("split", "persistent", "stacked", "sequential",
                       "legacy", "chunked")),
    "internvl2-2b": (2, ("stacked", "sequential", "legacy", "chunked")),
    "minicpm3-4b": (2, ("persistent", "stacked", "sequential", "legacy",
                        "chunked")),
    "kimi-k2-1t-a32b": (1, ("split", "persistent", "stacked", "legacy",
                            "chunked")),
    "jamba-v0.1-52b": (8, ("split", "persistent", "stacked", "sequential",
                           "legacy", "chunked")),
    "arctic-480b": (2, ("split", "persistent", "stacked", "legacy",
                        "chunked")),
}
FAMILY_REQUESTS, FAMILY_PROMPT, FAMILY_NEW = 2, 4096, 8
# the contract phase's guarded serve: qwen2-0.5b at full width and
# CONTRACT_LAYERS layers, CONTRACT_REQUESTS x CONTRACT_PROMPT tokens (past
# the DSA budget, so selection, restores and drops run) in prefill chunks
# of CONTRACT_CHUNK tokens (prefill and decode rows share iterations)
CONTRACT_LAYERS, CONTRACT_REQUESTS, CONTRACT_PROMPT = 4, 3, 3000
CONTRACT_NEW, CONTRACT_CHUNK = 6, 1024
# the obs phase: the obs layer's own host work on an obs-on serve within
# this share of that serve's wall time (the serve's TBT spreads ~2x
# between calls, so the tighter 5% bar stays with the CPU test).  The
# work is the trace events the serve emitted, each kind times its
# per-call cost timed in this process right after the serves
# (OBS_COST_CALLS calls a pass, the median of OBS_COST_PASSES passes):
# the metrics registry's updates run whether obs is on or off, so the
# tracer's emissions are all that obs-on adds.  A ratio of best walls
# across serves moved with the host's load instead: on one H100 80GB HBM3
# at 700 W it read obs-on's best 1.157x obs-off's with no serve or obs
# code changed (PERF.md §6)
OBS_HOST_SHARE = 0.10
OBS_COST_CALLS, OBS_COST_PASSES = 20_000, 5
# five serves each way, balanced in time (off, on, on, off, ...); the best
# of each side's walls is printed beside the host-work bar
OBS_ORDER = (False, True, True, False) * 2 + (False, True)
OBS_TRACE_ARCH, OBS_TRACE_REQUESTS = "qwen2.5-3b", 2
OBS_TOP_SPANS = ("select", "idx-sync", "host-stage", "attend",
                 "prefill-group")
# benchmarks/bench_transfer.py's real_gather_microbench: a (512, 32, 128)
# float32 pool, 64 distinct block ids
XFER_NB, XFER_BS, XFER_D, XFER_K = 512, 32, 128, 64
# the train phase: qwen2-0.5b at full width and all 24 layers, float32
# weights, gradients and moments, TRAIN_STEPS AdamW steps on one fixed
# TokenStream batch of TRAIN_B x TRAIN_S tokens with remat on;
# flash_prefill_bwd's parity shapes beside the run's own: (label, B, S,
# Hq, Hkv, D), qwen2-0.5b's heads over a ragged length and llama3-8b's
TRAIN_ARCH, TRAIN_B, TRAIN_S, TRAIN_STEPS = "qwen2-0.5b", 2, 4096, 8
BWD_CASES = (("qwen2-0.5b_ragged", 2, 1000, 14, 2, 64),
             ("llama3-8b", 1, 2048, 32, 8, 128))
# each gradient within BWD_ERR of its max |grad| with a cosine >= BWD_COS
# (P and dS rounded to bf16 before their products: 2^-8 relative on each
# term); lse in float32 from exp2 and float32 sums, within LSE_ATOL
BWD_ERR, BWD_COS, LSE_ATOL = 2e-2, 0.999, 1e-3
# step 1 through the kernels against the same step with the plain float32
# attention: the kernels' bf16 inputs (2^-8 relative on q, k, v) move the
# loss by far less than 1e-3 of it and the gradient norm by under 2%
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL = 1e-3, 0.02
# the training runs' other attention shapes against their plain
# versions: MLA's (96, 64) heads, causal, at minicpm3-4b's run (40 over
# 40 heads); internvl2-2b's causal (128, 128) heads over 256 patches and
# 3,840 tokens (16 over 8); whisper-small's decoder self-attention,
# causal (64, 64) over its 448 tokens, and the non-causal mode at its
# encoder (Sq = Sk = 1500) and cross-attention (448 decoder tokens over
# 1500 frames), and over the launcher's 16 frames: (label, B, Sq, Sk,
# Hq, Hkv, D, Dv, causal); "path=train" marks the shapes the runs below
# launch, each of which gets the runs' launches at its shape
TRAIN_CASES = (("path=train mla", 1, 4096, 4096, 40, 40, 96, 64, True),
               ("path=train internvl2-2b", 2, 4096, 4096, 16, 8, 128, 128,
                True),
               ("path=train decoder", 8, 448, 448, 12, 12, 64, 64, True),
               ("path=train encoder", 8, 1500, 1500, 12, 12, 64, 64, False),
               ("path=train cross", 8, 448, 1500, 12, 12, 64, 64, False),
               ("case=launcher_frames", 2, 448, 16, 12, 12, 64, 64, False),
               ("case=kimi-k2", 1, 4096, 4096, 64, 8, 112, 112, True))
# the MLA and frontend families trained at full width after qwen2-0.5b,
# smallest state first, each TRAIN_RUN_STEPS AdamW steps on one fixed
# TokenStream batch from the seed, remat on, float32 weights, gradients
# and moments, every layer: arch -> (B, text tokens, encoder frames).
# whisper-small: 1500 frames (its encoder_seq_len, as the serve uses) and
# 448 tokens (its published text context, arXiv:2212.04356);
# internvl2-2b: 256 patch embeddings ahead of 3,840 tokens; minicpm3-4b:
# ~68.2 GB of weights, gradients and moments (4.26 B parameters x 16
# bytes) at all 62 layers; rwkv6-1.6b: all 24 layers at d_model 2,048
# (~1.58 B parameters, ~25 GB of float32 state), after the others, whose
# memory it then leaves as they had it.  The frontends' inputs are float32
# normals x 0.02 from the seed, as the serve's.
TRAIN_RUNS = {"whisper-small": (8, 448, 1500),
              "internvl2-2b": (2, 3840, 0),
              "minicpm3-4b": (1, 4096, 0),
              "rwkv6-1.6b": (2, 4096, 0),
              "jamba-v0.1-52b": (1, 4096, 0)}
# the runs cut in depth, each layer at full width: jamba-v0.1-52b's first
# 2 of its 32 layers (a Mamba layer with the dense FFN, a Mamba layer
# with the 16-expert MoE) are 3.742 B parameters, 59.9 GB of float32
# weights, gradients and AdamW moments; a third layer (Mamba, dense FFN)
# would bring 64.4 GB and leave too little of the card for the
# activations, the logits and the eval step's bf16 copy
TRAIN_LAYERS = {"jamba-v0.1-52b": 2}
# their peak learning rate.  Through the kernels, on the fixed batch, the
# loss rose at the third step above it: at qwen2-0.5b's 1e-3
# minicpm3-4b's went 11.80 -> 10.08 -> 22.46, at 1e-4 internvl2-2b's
# 11.79 -> 11.35 -> 14.13 (PERF.md §6, on one H100).  internvl2-2b's
# rise at 1e-4 came with the plain float32 attention too; minicpm3-4b's
# has no such run behind it (PERF.md §7).  At 1e-5 all three fall every
# step
TRAIN_RUN_STEPS, TRAIN_RUN_LR = 3, 1e-5
# RWKV6's training kernels against their plain versions (ref.wkv6 and
# ref.wkv6_bwd) on the same float32 inputs: at the rwkv6-1.6b run's own
# shape (B 2 x 4,096, 32 heads of 64; its record gets the run's launches),
# at a ragged B 2 x 1,000 (one row padded from 777) and at the models
# phase's 14,211-token prefill window (B 1): (label, B, S, row lengths)
WKV_TRAIN_CASES = (("path=train", 2, 4096, (4096, 4096)),
                   ("case=ragged", 2, 1000, (1000, 777)),
                   ("case=prefill_window", 1, 14211, (14211,)))
# kernel B's bar, stated before its first run: each gradient within
# 2^-12 of its max |grad| with a cosine >= 0.99999.  Both sides are
# float32; the kernel reorders only the chunk carries (one rounding per
# (chunk, i, j), damped by the decays after it, as in the forward) and
# the decay's suffix sum (up to 4,096 terms of P - Q, each rounded once:
# a random walk of ~64 float32 steps of a term, against 2^-12 = 4,096
# steps of the largest gradient).  Kernel A's y, final state and S_in[c]
# are held to the forward's WKV_RTOL / WKV_ATOL.
WKV_GRAD_ERR, WKV_GRAD_COS = 2.0 ** -12, 0.99999
# kernel B where whole channels decay near 0 (the first WKV_NEAR_ZERO of
# every head's 64, w = exp(-exp(N(2, 0.5))), about 1e-3 and far below):
# dlogw there is a difference of suffix sums far larger than itself, so
# each channel's dlogw is held against the float64 reverse loop on its own
# scale, a relative L2 over its tokens within WKV_DLOGW_REL (the bar
# stated before the case's first run; the float32 CPU mirror of the
# kernel's algebra reads ~1e-4 there, tests/test_torch_scan_chunks.py)
WKV_NEAR_ZERO, WKV_DLOGW_REL = 16, 2.0 ** -8
# rwkv6-1.6b's step 1: float32 does not determine its gradient at full
# depth.  Against the same step in float64 (the precision phase, PR 28)
# the plain float32 path's per-layer gradients are 1.3% off at layer 23,
# 20-50% at layers 13-4 and 30-60% at layers 2-0, the kernels' about as
# far, so the two float32 grad norms differ by ~8% (2,645.2 and 2,865.7;
# float64 1,977.6) while the losses agree to 1.5e-6.  So the grad norm is
# held against the plain step's at WKV_STEP1_LAYERS layers (full width),
# where the two agree to ~1e-6, and each of the full-depth step's WKV
# backward calls numbered in WKV_STEP1_CALLS (the last, a middle and the
# first layer) against the plain backward on its own inputs
WKV_STEP1_LAYERS = 2
WKV_STEP1_CALLS = (0, 11, 23)
# the hybrid's training kernels against their plain versions
# (ref.selective_scan and ref.selective_scan_bwd) on the same float32
# inputs at jamba-v0.1-52b's widths (d_inner 8192, d_state 16): at the
# jamba run's own shape (B 1 x 4,096; its record gets the run's
# launches), at a ragged B 2 x 1,000 (one row padded with dt = 0 from
# 777) and at the models phase's 14,211-token prefill window (B 1):
# (label, B, S, row lengths)
SCAN_TRAIN_CASES = (("path=train", 1, 4096, (4096,)),
                    ("case=ragged", 2, 1000, (1000, 777)),
                    ("case=prefill_window", 1, 14211, (14211,)))
# kernel D's bar, stated before its first run: each gradient within
# 2^-12 of its max |grad| with a cosine >= 0.99999.  Both sides are
# float32 and walk the same recurrences (the kernel reruns each chunk
# from kernel C's checkpoint with the forward's own arithmetic, so its
# states are the forward's); they differ in the order of the sums: over
# 8,192 channels for dB and dC (a random walk of ~90 float32 steps of a
# term, against 2^-12 = 4,096 steps of the largest gradient), over up to
# 14,211 tokens for dA and dD, and over 16 states for dx and ddt.
# Kernel C's y, final state and checkpoints are held to the serve's
# SCAN_ATOL / SCAN_RTOL.
SCAN_GRAD_ERR, SCAN_GRAD_COS = 2.0 ** -12, 0.99999
# the hybrid's eval step in bfloat16 (its products and residual adds
# rounded to 2^-8 relative) against the float32 forward's loss: 7x the
# 1.36e-4 that jamba-v0.1-52b's 2 layers read in two runs on one H100
# 80GB HBM3 at 700 W (PERF.md §6, PR 29).  A float32 leaf put in bf16
# (the router, dt_bias, A_log, D) raises instead of moving the loss: the
# router's float32 product and the serve's scan take float32 only
EVAL_RTOL = 1e-3
# the calibrate phase: a 1 GiB link copy; 4096 copy_ calls of one fp-tier
# block of one head (32 x 64 float32); 2000 one-block gather launches; the
# fused gather at the fp serve's shape, (H, NB, bs, D, K) float32
CAL_LINK_BYTES = 1 << 30
CAL_COPIES, CAL_COPY_BYTES, CAL_LAUNCHES = 4096, 8192, 2000
CAL_GATHER = (2, 1024, 32, 64, 64)
CAL_PASSES, CAL_RATIO = 5, 2.0


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, ops) -> tuple:
    """The least time of a call: its bytes over the HBM rate or its
    operations over their peak rate, the larger.  ``ops``: a count of bf16
    tensor-core operations, or (count, rate) for another type."""
    count, rate = ops if isinstance(ops, tuple) else (ops, BF16_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = count / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median time of one call, each launch timed alone with CUDA events
    after a 256 MB write that evicts the 50 MB L2 (the serving path finds
    its inputs cold).  A spin of ~0.1 ms on the stream after that write
    lets the host enqueue the start event and the call before the device
    reaches them, so a call that is short on the device is timed on the
    device and not by the host's launch overhead (``spin=False`` leaves the
    spin out).  A call slow enough that ``reps`` launches would take over
    TIMER_BUDGET_S, by the host's clock on a warm call, is timed
    TIMER_MIN_REPS times instead, and once where those would still take
    over TIMER_BUDGET_S."""

    def __init__(self, torch, spin: bool = True):
        self.torch = torch
        self.spin = spin
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn, reps: int = 20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        if call_s * reps > TIMER_BUDGET_S:
            reps = 1 if call_s * TIMER_MIN_REPS > TIMER_BUDGET_S else (
                TIMER_MIN_REPS)
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if self.spin:
                torch.cuda._sleep(SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


# --- one case per kernel: kernel against plain version on given inputs ---
# Each returns (max_abs_err, ok, kernel fn, plain fn, bytes, ops, shape).

def _attn_close(out, want) -> tuple:
    err = (out.float() - want.float()).abs()
    return (err.max().item(),
            bool((err <= ATTN_ATOL + ATTN_RTOL * want.float().abs()).all()))


def case_attention(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len,
                   scale=None):
    args = (q, k_pool, v_pool, idx, valid, cur_len, scale)
    out = ops.sparse_decode_attention(*args)
    want = ref.sparse_decode_attention(*args)
    torch.cuda.synchronize()
    err, ok = _attn_close(out, want)
    B, Hq, _ = q.shape
    _, Hkv, NB, bs, D = k_pool.shape
    Dv = v_pool.shape[-1]
    # blocks the kernel must read: valid selections starting below cur_len
    live = int((valid & (idx * bs < cur_len[:, None, None])).sum().item())
    # one pool passed as both (MLA's latent) is read once
    read = D + (Dv if v_pool.data_ptr() != k_pool.data_ptr() else 0)
    nbytes = (q.numel() * 2 + live * bs * read * 2 + idx.numel() * 5
              + cur_len.numel() * 4 + out.numel() * 2)
    nops = live * (Hq // Hkv) * bs * 2 * (D + Dv)
    shape = (f"B={B} Hq={Hq} Hkv={Hkv} NB={NB} K={idx.shape[-1]} bs={bs} "
             f"D={D} " + (f"Dv={Dv} " if Dv != D else "")
             + (f"scale={scale:.6f} " if scale is not None else "")
             + f"live_blocks={live}")
    return (err, ok, lambda: ops.sparse_decode_attention(*args),
            lambda: ref.sparse_decode_attention(*args), nbytes, nops, shape)


def case_score(torch, ops, ref, q, meta):
    out = ops.block_score(q, meta)
    want = ref.block_score(q, meta)
    torch.cuda.synchronize()
    err = (out - want).abs()
    ok = bool((err <= SCORE_ATOL + SCORE_RTOL * want.abs()).all())
    B, Hq, D = q.shape
    _, Hkv, NB, _, _ = meta.shape
    return (err.max().item(), ok, lambda: ops.block_score(q, meta),
            lambda: ref.block_score(q, meta),
            q.numel() * 2 + meta.numel() * 4 + out.numel() * 4,
            B * Hkv * NB * (Hq // Hkv) * 4 * D,
            f"B={B} Hq={Hq} Hkv={Hkv} NB={NB} D={D}")


def _select_close(torch, a, b):
    """Equal, or both finite and within block_score's tolerance."""
    return (a == b) | (torch.isfinite(a) & torch.isfinite(b) & (
        (a - b).abs() <= SCORE_ATOL + SCORE_RTOL * b.abs()))


def select_agrees(torch, got, want, s_ref) -> tuple:
    """Tie-aware agreement of a selection with the plain version's, per
    (request, kv-head): sel_valid counts equal, the plain select scores
    ``s_ref`` of the selected blocks equal as sorted lists, no block
    selected twice, and the id sets equal wherever the plain K-th and
    (K+1)-th scores are not close.  Returns (ok, the largest difference
    of the sorted selected scores where both are finite)."""
    (idx, valid), (w_idx, w_valid) = got, want
    picked = [torch.gather(s_ref, -1, i.long()).masked_fill(
        ~v, float("-inf")).sort(-1, descending=True).values
        for i, v in ((idx, valid), (w_idx, w_valid))]
    both = torch.isfinite(picked[0]) & torch.isfinite(picked[1])
    err = ((picked[0] - picked[1]).abs()[both].max().item()
           if bool(both.any()) else 0.0)
    counts = [torch.zeros(s_ref.shape, dtype=torch.int32,
                          device=s_ref.device).scatter_add_(
        -1, i.long(), v.int()) for i, v in ((idx, valid), (w_idx, w_valid))]
    ok = (torch.equal(valid.sum(-1), w_valid.sum(-1))
          and bool(_select_close(torch, *picked).all())
          and int(counts[0].max()) <= 1)
    K, NB = idx.shape[-1], s_ref.shape[-1]
    if ok and K < NB:
        top = s_ref.sort(-1, descending=True).values
        gap = ~_select_close(torch, top[..., K - 1], top[..., K])
        ok = bool((counts[0] == counts[1])[gap].all())
    return ok, err


def case_select(torch, ops, ref, q, meta, cur_len, **kw):
    """score_select against its plain version (block_score, then the
    select over cur_len + 1 tokens), held tie-aware.  Its last field is
    the unfused pair it replaces, block_score's kernel then the plain
    select (torch.topk), timed beside it by run_case."""
    got = ops.score_select(q, meta, cur_len, **kw)
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = _select_scores(ref, q, meta, cur_len, kw)
    torch.cuda.synchronize()
    ok, err = select_agrees(torch, got, want, s_ref)
    B, Hq, D = q.shape
    Hkv, NB = meta.shape[1], meta.shape[2]
    K = got[0].shape[-1]
    sel = {k: v for k, v in kw.items()
           if k in ("top_k", "sink_blocks", "recent_blocks")}
    scoring = (kw.get("metadata", "cuboid"), kw.get("group_reduce", "max"))
    mean = scoring[0] == "mean"

    def unfused():
        return ref.select_blocks(ops.block_score(q, meta), cur_len + 1,
                                 block_size=kw["block_size"], **sel)
    return (err, ok, lambda: ops.score_select(q, meta, cur_len, **kw),
            lambda: ref.score_select(q, meta, cur_len, **kw),
            q.numel() * 2 + meta.numel() * 4 + B * 4 + B * Hkv * K * 5,
            B * Hkv * NB * (Hq // Hkv) * (2 if mean else 4) * D,
            f"B={B} Hq={Hq} Hkv={Hkv} NB={NB} D={D} K={K} "
            f"bs={kw['block_size']} sink={kw['sink_blocks']} "
            f"recent={kw['recent_blocks']}"
            + ("" if scoring == ("cuboid", "max")
               else f" metadata={scoring[0]} group_reduce={scoring[1]}"),
            None, None,
            # block_score (cuboid, max) keeps D <= 128: no unfused pair
            # at MLA's width or for the other scorings
            unfused if D <= 128 and scoring == ("cuboid", "max") else None)


def _select_scores(ref, q, meta, cur_len, kw):
    return ref.select_scores(
        ref.block_score(q, meta, kw.get("metadata", "cuboid"),
                        kw.get("group_reduce", "max")),
        cur_len + 1, block_size=kw["block_size"],
        sink_blocks=kw["sink_blocks"], recent_blocks=kw["recent_blocks"])


def select_faults(torch, ops, ref, q, meta, cur_len, kw, arch) -> None:
    """The tie-aware select check must reject a kernel that counts the
    cache without the step's +1 (run on cur_len - 1) or leaves the recent
    blocks unforced (run with recent_blocks 0), and for score_select's
    other scorings (``group_reduce`` in ``kw``) one that reduces the GQA
    group the other way (max for sum, sum for max): each runs through the
    kernel and is held against the plain version on the true inputs."""
    want = ref.score_select(q, meta, cur_len, **kw)
    s_ref = _select_scores(ref, q, meta, cur_len, kw)
    faults = [("n_without_plus_one", cur_len - 1, kw),
              ("recent_forcing_left_out", cur_len,
               dict(kw, recent_blocks=0))]
    if "group_reduce" in kw:
        # the other scorings add a third: the group reduced the other way
        other = "max" if kw["group_reduce"] == "sum" else "sum"
        faults.append((f"group_reduced_by_{other}", cur_len,
                       dict(kw, group_reduce=other)))
    for label, c, k in faults:
        ok, err = select_agrees(torch, ops.score_select(q, meta, c, **k),
                                want, s_ref)
        log(f"phase=parity arch={arch} planted_fault={label} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {label} passed the select "
                                 f"check at {arch} shapes")


def case_gather(torch, ops, ref, pool, idx):
    """pool on the card or pinned on the host; idx on the card.  From a
    pinned pool the blocks cross the PCIe link: the case carries a
    host-to-device link bound for them."""
    idx_p = idx.to(pool.device)
    out = ops.gather_blocks_hkv(pool, idx)
    want = ref.gather_blocks_hkv(pool, idx_p).to(idx.device)
    torch.cuda.synchronize()
    H, NB, bs, D = pool.shape
    K = idx.shape[0]
    moved = H * K * bs * D * pool.element_size()
    on_host = pool.device.type == "cpu"
    return ((out.float() - want.float()).abs().max().item(),
            bool(torch.equal(out, want)),
            lambda: ops.gather_blocks_hkv(pool, idx),
            lambda: ref.gather_blocks_hkv(pool, idx_p).to(
                idx.device, non_blocking=True),
            2 * moved + K * 4, 0,
            f"pool=({H},{NB},{bs},{D}) {str(pool.dtype)[6:]} "
            f"{'pinned host' if on_host else 'device'} K={K}",
            None, ("h2d", moved) if on_host else None)


def case_scatter(torch, ops, ref, pool, payload, dest, rows=None):
    """Ids host-held on the serve path are moved to the card first, so the
    kernel is timed without their upload, as before."""
    dest = _dev_ids(torch, dest, payload.device)
    rows = _dev_ids(torch, rows, payload.device)
    got = ops.scatter_blocks_hkv(pool.clone(), payload, dest, rows)
    want = ref.scatter_blocks_hkv(pool.clone(), payload, dest, rows)
    torch.cuda.synchronize()
    pool_k, pool_p = pool.clone(), pool.clone()
    H, K, bs, D = payload.shape
    return ((got.float() - want.float()).abs().max().item(),
            bool(torch.equal(got, want)),
            lambda: ops.scatter_blocks_hkv(pool_k, payload, dest, rows),
            lambda: ref.scatter_blocks_hkv(pool_p, payload, dest, rows),
            H * K * bs * D * (payload.element_size() + pool.element_size())
            + K * 4 * (1 if rows is None else 2), 0,
            f"pool={tuple(pool.shape)} payload=({H},{K},{bs},{D}) "
            f"{str(payload.dtype)[6:]} rows={'none' if rows is None else K}")


def _dev_ids(torch, ids, dev):
    """Host-held ids (a list) as an int32 tensor on ``dev``."""
    if ids is None or isinstance(ids, torch.Tensor):
        return ids
    return torch.tensor(ids, dtype=torch.int32, device=dev)


def case_zero(torch, ops, ref, pools, which, rows, blocks):
    """zero_blocks_hkv of an eviction round (host-held numpy ids, as the
    plane passes them: the wrapper's id check and one upload are timed
    with the launch) against its plain version, bit-exact over every pool;
    the library call zeroes the same number of blocks, the round's (row,
    head, block) triples, in one pool with index_fill_."""
    import numpy as np
    which, rows, blocks = (np.asarray(a, np.int64)
                           for a in (which, rows, blocks))
    got = [p.clone() for p in pools]
    want = [p.clone() for p in pools]
    ops.zero_blocks_hkv(got, which, rows, blocks)
    ids = [torch.tensor(a, device=pools[0].device)
           for a in (which, rows, blocks)]
    ref.zero_blocks_hkv(want, *ids)
    torch.cuda.synchronize()
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    ok = all(torch.equal(g, w) for g, w in zip(got, want))
    B, H, NB, bs, D = pools[0].shape
    table = ops.PoolTable([p.clone() for p in pools])
    pools_p = [p.clone() for p in pools]
    flat = table.pools[0].view(B * H * NB, bs * D)
    r, b = ids[1].long(), ids[2].long()
    heads = torch.arange(H, device=r.device)
    fill_idx = ((r[:, None] * H + heads) * NB + b[:, None]).reshape(-1)
    N = len(which)
    return (err, ok,
            lambda: ops.zero_blocks_hkv(table, which, rows, blocks),
            lambda: ref.zero_blocks_hkv(pools_p, *ids),
            N * H * bs * D * pools[0].element_size() + N * 12
            + len(pools) * 8, 0,
            f"pools={len(pools)}x{tuple(pools[0].shape)} items={N} "
            f"layers={len(np.unique(which // 2))} "
            f"rows={len(np.unique(rows))}",
            lambda: flat.index_fill_(0, fill_idx, 0))


def case_write(torch, ops, ref, pool, payload, dest):
    """write_blocks_hkv of a device payload into a pinned host pool (the
    int8 tier's write back); the blocks cross the PCIe link."""
    got = pool.clone().pin_memory()
    ops.write_blocks_hkv(got, payload, dest)
    torch.cuda.synchronize()
    want = ref.write_blocks_hkv(pool.clone(), payload.cpu(), dest.cpu())
    pool_k = pool.clone().pin_memory()
    pool_p = pool.clone()
    H, K, bs, D = payload.shape
    moved = H * K * bs * D * payload.element_size()
    return ((got.float() - want.float()).abs().max().item(),
            bool(torch.equal(got, want)),
            lambda: ops.write_blocks_hkv(pool_k, payload, dest),
            lambda: ref.write_blocks_hkv(pool_p, payload.cpu(), dest.cpu()),
            2 * moved + K * 4, 0,
            f"pool=({H},{pool.shape[1]},{bs},{D}) {str(pool.dtype)[6:]} "
            f"pinned host payload=({H},{K},{bs},{D})",
            None, ("d2h", moved))


def _abs_weight(ref, q, k, v, **kw):
    """W = sum_j p_j |v_j| / sum_j p_j for every output element, float32:
    the plain version on |v| (the same weights p)."""
    return ref.flash_prefill(q.float(), k.float(), v.float().abs(), **kw)


def _flash_close(out, want, weight) -> tuple:
    """Per output element, |err| <= FLASH_WEIGHT_TOL * W + FLASH_RTOL *
    |ref|: rounding each weight to bf16 (unit roundoff 2^-8) moves the
    element by <= 2^-8 W, the float32 scores, exponentials and sums by
    far less (budgeted at 2^-10 W), and rounding both outputs to bf16 by
    <= 2^-7 |ref| (one step, 2^-8 to 2^-7 of the value) plus 2^-8 of the
    rest."""
    err = (out.float() - want.float()).abs()
    bound = FLASH_WEIGHT_TOL * weight + FLASH_RTOL * want.float().abs()
    return err.max().item(), bool((err <= bound).all()), err / bound


def _visible_pairs(Sq: int, Sk: int, q_offset: int) -> int:
    """(query, key) pairs a causal prefill attends: sum_i min(Sk,
    q_offset + i + 1)."""
    return sum(min(Sk, q_offset + i + 1) for i in range(Sq))


def case_flash(torch, ops, ref, q, k, v, *, scale, causal=True,
               q_offset=0):
    kw = dict(scale=scale, causal=causal, q_offset=q_offset)
    out = ops.flash_prefill(q, k, v, **kw)
    want = ref.flash_prefill(q, k, v, **kw)
    weight = _abs_weight(ref, q, k, v, **kw)
    err, ok, ratio = _flash_close(out, want, weight)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    at = torch.unravel_index(ratio.argmax(), ratio.shape)
    log(f"flash_prefill B={B} Sq={Sq} Sk={Sk} Hq={Hq} D={D} "
        f"causal={causal} q_offset={int(q_offset)} largest err/bound="
        f"{ratio[at].item():.4f} at query {int(at[1])} (|ref| "
        f"{want[at].float().abs().item():.4g}, W {weight[at].item():.4g})")
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2
    pairs = (_visible_pairs(Sq, Sk, int(q_offset)) if causal
             else Sq * Sk)
    nops = 2 * B * Hq * (D + Dv) * pairs
    import torch.nn.functional as F
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if not causal:
        lib = lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=False, scale=scale, enable_gqa=True)
    else:
        if int(q_offset) == 0 and Sk == Sq:
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)
        else:
            # query i sees keys j <= q_offset + i: the mask, made once
            mask = torch.ones((Sq, Sk), dtype=torch.bool,
                              device=q.device).tril(int(q_offset))
            lib = lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)
        if D != Dv:
            # v narrower than q and k (MLA): not every SDPA backend takes it
            try:
                lib()
                torch.cuda.synchronize()
            except RuntimeError as e:
                log(f"flash_prefill library: SDPA refuses D {D} with Dv "
                    f"{Dv}: {str(e).splitlines()[0][:200]}")
                lib = None
    return (err, ok, lambda: ops.flash_prefill(q, k, v, **kw),
            lambda: ref.flash_prefill(q, k, v, **kw), nbytes, nops,
            f"B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} "
            + (f"Dv={Dv} " if Dv != D else "")
            + (f"q_offset={int(q_offset)}" if causal else "causal=False"),
            lib)


def case_quantize(torch, ops, ref, blocks):
    q, s = ops.quantize_blocks(blocks)
    q_r, s_r = ref.quantize_blocks(blocks)
    torch.cuda.synchronize()
    err = max((q.float() - q_r.float()).abs().max().item(),
              (s - s_r).abs().max().item())
    H, K, bs, D = blocks.shape
    return (err, bool(torch.equal(q, q_r) and torch.equal(s, s_r)),
            lambda: ops.quantize_blocks(blocks),
            lambda: ref.quantize_blocks(blocks),
            blocks.numel() * (blocks.element_size() + 1) + H * K * 4, 0,
            f"blocks=({H},{K},{bs},{D}) {str(blocks.dtype)[6:]}")


def case_dequantize(torch, ops, ref, q, scales):
    out = ops.dequantize_blocks(q, scales)
    want = ref.dequantize_blocks(q, scales)
    torch.cuda.synchronize()
    H, K, bs, D = q.shape
    s4 = scales[..., None, None]
    return ((out - want).abs().max().item(), bool(torch.equal(out, want)),
            lambda: ops.dequantize_blocks(q, scales),
            lambda: ref.dequantize_blocks(q, scales),
            q.numel() * 5 + H * K * 4, 0, f"q=({H},{K},{bs},{D})",
            lambda: torch.mul(q, s4))


def case_dequant_scatter(torch, ops, ref, pool, q, scales, dest,
                         rows=None):
    got = ops.dequantize_scatter_blocks(pool.clone(), q, scales, dest, rows)
    want = ref.dequantize_scatter_blocks(pool.clone(), q, scales, dest,
                                         rows)
    torch.cuda.synchronize()
    pool_k, pool_p = pool.clone(), pool.clone()
    H, K, bs, D = q.shape
    return ((got.float() - want.float()).abs().max().item(),
            bool(torch.equal(got, want)),
            lambda: ops.dequantize_scatter_blocks(pool_k, q, scales, dest,
                                                  rows),
            lambda: ref.dequantize_scatter_blocks(pool_p, q, scales, dest,
                                                  rows),
            q.numel() * (1 + pool.element_size()) + H * K * 4
            + K * 4 * (1 if rows is None else 2), 0,
            f"pool={tuple(pool.shape)} q=({H},{K},{bs},{D}) "
            f"rows={'none' if rows is None else K}")


def _save_copies(torch, ops, saves, pinned: bool) -> tuple:
    """The saves on copies of their pools and scale planes, one copy per
    tensor, pinned (for the kernel) or in plain host memory (for the plain
    version): (the saves, {original data pointer: copy})."""
    copies = {}

    def cp(t):
        if t.data_ptr() not in copies:
            c = t.cpu().clone()
            copies[t.data_ptr()] = c.pin_memory() if pinned else c
        return copies[t.data_ptr()]
    pools = {}
    for sv in saves:
        if id(sv.pool) not in pools:
            pools[id(sv.pool)] = ops.QuantPool(cp(sv.pool.q),
                                               cp(sv.pool.scales))
    return ([sv._replace(pool=pools[id(sv.pool)]) for sv in saves],
            copies)


def _save_traffic(saves) -> tuple:
    """(items, whole-block items, bytes the save must read from the pools,
    bytes it must write to them, stripe bytes): a segment that covers its
    block reads nothing from the pool."""
    items = whole = read = write = stripe = 0
    for sv in saves:
        _, H, _, bs, D = sv.pool.q.shape
        t, T = 0, sv.stripe.shape[1]
        while t < T:
            n = min(bs - (sv.start + t) % bs, T - t)
            items += 1
            whole += n == bs
            read += 0 if n == bs else H * (bs * D + 4)
            write += H * (bs * D + 4)
            stripe += H * n * D * sv.stripe.element_size()
            t += n
    return items, whole, read, write, stripe


def case_quant_save(torch, ops, ref, saves):
    """quant_save_blocks on pinned copies of the saves' pools against its
    plain version on host copies, bit-exact over every pool and scale
    plane.  The pools cross the PCIe link both ways: the case carries a
    link bound, a device-to-pinned copy of the bytes the save writes."""
    got_saves, got = _save_copies(torch, ops, saves, True)
    want_saves, want = _save_copies(torch, ops, saves, False)
    ops.quant_save_blocks(got_saves)
    torch.cuda.synchronize()
    ref.quant_save_blocks(want_saves)
    err = max((got[k].float() - want[k].float()).abs().max().item()
              for k in got)
    ok = all(torch.equal(got[k], want[k]) for k in got)
    k_saves, _ = _save_copies(torch, ops, saves, True)
    p_saves, _ = _save_copies(torch, ops, saves, False)
    items, whole, read, write, stripe = _save_traffic(saves)
    _, H, _, bs, D = saves[0].pool.q.shape
    dtypes = sorted({str(sv.stripe.dtype)[6:] for sv in saves})
    return (err, ok, lambda: ops.quant_save_blocks(k_saves),
            lambda: ref.quant_save_blocks(p_saves),
            read + write + stripe + 64 * items, 0,
            f"stripes={len(saves)} items={items} whole={whole} H={H} "
            f"bs={bs} D={D} stripe_dtypes={','.join(dtypes)} "
            f"pool_read_B={read} pool_write_B={write}",
            None, ("d2h", write))


def _scale_before_overlay(torch, ref, saves) -> None:
    """A faulty save: each block requantized with the scale of the block
    as it was before the stripe's tokens were written into it."""
    for qp, layer, start, stripe in saves:
        pool, scales = qp.q, qp.scales
        bs = pool.shape[3]
        t0, T = 0, stripe.shape[1]
        while t0 < T:
            blk, off = divmod(start + t0, bs)
            n = min(bs - off, T - t0)
            cur = ref.dequantize_blocks(pool[layer, :, blk, None],
                                        scales[layer, :, blk, None])
            _, sc = ref.quantize_blocks(cur)
            cur[:, 0, off:off + n] = stripe[:, t0:t0 + n].to(cur.device,
                                                             torch.float32)
            one = torch.ones_like(sc)
            inv = torch.where(sc > 0, one / torch.where(sc > 0, sc, one), one)
            q = torch.round(cur * inv[..., None, None]).clamp(-127.0, 127.0)
            pool[layer, :, blk] = q[:, 0].to(torch.int8)
            scales[layer, :, blk] = sc[:, 0]
            t0 += n


def quant_save_faults(torch, ops, ref, saves, label: str) -> None:
    """Bit-exactness must reject a save that writes the stripe one token
    late (the kernel given start + 1) or takes the scale before the
    overlay (a plain emulation), each held against the plain version on
    the true inputs."""
    want_saves, want = _save_copies(torch, ops, saves, False)
    ref.quant_save_blocks(want_saves)
    late_saves, late = _save_copies(torch, ops, saves, True)
    ops.quant_save_blocks([sv._replace(start=sv.start + 1)
                           for sv in late_saves])
    torch.cuda.synchronize()
    early_saves, early = _save_copies(torch, ops, saves, False)
    _scale_before_overlay(torch, ref, early_saves)
    for fault, got in (("overlay_one_token_late", late),
                       ("scale_before_overlay", early)):
        diff = sum(int((got[k] != want[k]).sum()) for k in want)
        log(f"phase=parity {label} planted_fault={fault} "
            f"differing_elements={diff} rejected={diff > 0}")
        if diff == 0:
            raise AssertionError(f"planted fault {fault} passed the "
                                 f"quant_save_blocks check ({label})")


def _scan_close(got, want) -> tuple:
    """(max abs err, ok) of selective_scan's (y, h) against the plain
    version's: |err| <= SCAN_ATOL + SCAN_RTOL |ref| everywhere."""
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok = all(bool(((g - w).abs() <= SCAN_ATOL + SCAN_RTOL * w.abs()).all())
             for g, w in zip(got, want))
    return err, ok


def case_scan(torch, ops, ref, x, dt, B, C, A, D, h0):
    """selective_scan against its plain version on the same inputs.  The
    bound counts each input read once and each output written once, and
    8 float32 operations per (token, channel, state) (dt A, its exp, dt
    B, times x, dA h, the add, h C and its sum) at the float32 rate; the
    scan's data decides nothing (a padded position costs what a real one
    does)."""
    got = ops.selective_scan(x, dt, B, C, A, D, h0)
    torch.cuda.synchronize()
    want = ref.selective_scan(x, dt, B, C, A, D, h0)
    err, ok = _scan_close(got, want)
    Bn, S, di = x.shape
    ds = B.shape[-1]
    nbytes = (x.numel() * x.element_size() + dt.numel() * 4
              + 2 * B.numel() * B.element_size() + A.numel() * 4
              + D.numel() * 4 + 2 * h0.numel() * 4 + Bn * S * di * 4)
    return (err, ok, lambda: ops.selective_scan(x, dt, B, C, A, D, h0),
            lambda: ref.selective_scan(x, dt, B, C, A, D, h0), nbytes,
            (8 * Bn * S * di * ds, F32_OPS_PER_S),
            f"B={Bn} S={S} di={di} ds={ds} x={str(x.dtype)[6:]}")


def _scan_inputs(torch, gen, Bn: int, S: int, lens) -> tuple:
    """selective_scan's inputs as a Mamba layer hands them over: x, B and
    C bf16, dt = softplus(N(-2, 1)) float32 zeroed past each row's length
    (right padding), A = -exp(A_log) with A_log = log(1..16) + N(0, 0.1^2)
    per channel, D = 1 + N(0, 0.1^2), h0 ~ N(0, 1) float32."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    x = randn(Bn, S, SCAN_DI).bfloat16()
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
    dt = torch.nn.functional.softplus(randn(Bn, S, SCAN_DI) - 2) \
        * mask[..., None]
    B, C = randn(Bn, S, SCAN_DS).bfloat16(), randn(Bn, S, SCAN_DS).bfloat16()
    a_log = (torch.arange(1, SCAN_DS + 1, device=dev).float().log()
             + 0.1 * randn(SCAN_DI, SCAN_DS))
    return (x, dt.contiguous(), B, C, -torch.exp(a_log),
            1 + 0.1 * randn(SCAN_DI), randn(Bn, SCAN_DI, SCAN_DS))


def scan_faults(torch, ops, ref, x, dt, B, C, A, D, h0, label) -> None:
    """The scan's tolerance must reject a kernel that ignores h0, drops
    the skip term D x, leaves the last state out of y's sum, or reads the
    second shared-memory chunk's B and C one token late: each runs through
    the kernel on inputs that make it so and is held against the plain
    version on the true ones."""
    want = ref.selective_scan(x, dt, B, C, A, D, h0)
    c_short = C.clone()
    c_short[..., -1] = 0
    t0, t1 = ops.SCAN_CHUNK, 2 * ops.SCAN_CHUNK
    b_late, c_late = B.clone(), C.clone()
    b_late[:, t0:t1] = B[:, t0 + 1:t1 + 1]
    c_late[:, t0:t1] = C[:, t0 + 1:t1 + 1]
    for fault, args in (
            ("h0_ignored", (x, dt, B, C, A, D, torch.zeros_like(h0))),
            ("skip_term_dropped", (x, dt, B, C, A, torch.zeros_like(D),
                                   h0)),
            ("last_state_left_out", (x, dt, B, c_short, A, D, h0)),
            ("second_chunk_bc_one_token_late",
             (x, dt, b_late, c_late, A, D, h0))):
        err, ok = _scan_close(ops.selective_scan(*args), want)
        log(f"phase=parity {label} planted_fault={fault} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {fault} passed the scan "
                                 f"tolerance ({label})")


def parity_scan_shapes(torch, ops, ref, gen) -> list:
    """selective_scan at jamba-v0.1-52b's widths (SCAN_CASES): a padded
    prefill window, with the four planted faults, and the decode step.
    Returns (kernel, label, case) triples for run_case."""
    out = []
    for mode, Bn, S, lens in SCAN_CASES:
        args = _scan_inputs(torch, gen, Bn, S, lens)
        label = f"arch=jamba-v0.1-52b mode={mode}"
        out.append(("selective_scan", label,
                    case_scan(torch, ops, ref, *args)))
        if S > 2 * ops.SCAN_CHUNK:
            scan_faults(torch, ops, ref, *args, label)
    return out


def _wkv_close(torch, ref, got, want, args) -> tuple:
    """(max abs err, ok) of wkv6's (y, S) against the plain version's:
    |err| <= WKV_RTOL W + WKV_ATOL per element, W the plain version on
    the inputs' magnitudes (WKV_RTOL's note)."""
    r, k, v, w, u, S0 = args
    weight = ref.wkv6(r.abs(), k.abs(), v.abs(), w, u.abs(), S0.abs())
    err = max((g - x).abs().max().item() for g, x in zip(got, want))
    ok = all(bool(((g - x).abs() <= WKV_RTOL * m + WKV_ATOL).all())
             for g, x, m in zip(got, want, weight))
    return err, ok


def case_wkv(torch, ops, ref, r, k, v, w, u, S0):
    """wkv6 against its plain version on the same inputs.  The bound
    counts each input read once and each output written once, and the
    float32 operations the function needs at the float32 rate: 5 per
    (token, head, i, j), a multiply-add for r S and a multiply and a
    multiply-add for w S + k v, since the bonus term is a scalar per
    token, y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, which costs 5 per
    (token, head, channel) (r u k and its sum, then v times it added to
    y); padding costs what a real token does (the kernel runs it)."""
    args = (r, k, v, w, u, S0)
    got = ops.wkv6(*args)
    torch.cuda.synchronize()
    want = ref.wkv6(*args)
    err, ok = _wkv_close(torch, ref, got, want, args)
    Bn, S, H, hd = r.shape
    nbytes = ((r.element_size() * 3 + 4 * 2) * r.numel() + u.numel() * 4
              + 2 * S0.numel() * 4)
    return (err, ok, lambda: ops.wkv6(*args), lambda: ref.wkv6(*args),
            nbytes, (5 * Bn * S * H * hd * (hd + 1), F32_OPS_PER_S),
            f"B={Bn} S={S} H={H} hd={hd} rkv={str(r.dtype)[6:]}")


def _wkv_inputs(torch, gen, Bn: int, S: int, lens, carried: bool) -> tuple:
    """wkv6's inputs as the time-mix hands them over: r, k, v bf16 ~ N(0,
    1) (projections of a normalised x), w = exp(-exp(N(-2, 1))) float32
    (the decay around the init's base -2), u = 0.1 N(0, 1) float32 (the
    init's bonus), S0 ~ N(0, 1) float32 when ``carried``, else 0; past
    each row's length k = 0 and w = 1, as the time-mix masks padding."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])[..., None, None]
    r, v = (randn(Bn, S, WKV_H, WKV_HD).bfloat16() for _ in range(2))
    k = (randn(Bn, S, WKV_H, WKV_HD).bfloat16() * mask).contiguous()
    w = torch.where(mask, torch.exp(-torch.exp(
        randn(Bn, S, WKV_H, WKV_HD) - 2)), 1.0).contiguous()
    S0 = (randn(Bn, WKV_H, WKV_HD, WKV_HD) if carried
          else torch.zeros((Bn, WKV_H, WKV_HD, WKV_HD), device=dev))
    return r, k, v, w, 0.1 * randn(WKV_H, WKV_HD), S0


def _wkv_decay_after_add(torch, r, k, v, w, u, S0):
    """The recurrence with the decay applied after the add, S_ij = w_i
    (S_ij + k_i v_j), in the plain version's order otherwise."""
    r, k, v = r.float(), k.float(), v.float()
    S, ys = S0.clone(), []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhij,bhi->bhj",
                               S + u[None, :, :, None] * kv, r[:, t]))
        S = w[:, t, :, :, None] * (S + kv)
    return torch.stack(ys, dim=1), S


def wkv_faults(torch, ops, ref, args, label) -> None:
    """wkv6's tolerance must reject a kernel that drops the bonus u (run
    with u = 0), does not carry the state in (S0 = 0), reads the state
    with i and j swapped (S0 transposed), applies the decay after the
    add (that recurrence computed in plain PyTorch) or drops a chunk
    carry's decay (w = 1 at the first token of the kernel's second time
    chunk, ops.wkv6_chunk): each held against the plain version on the
    true inputs."""
    r, k, v, w, u, S0 = args
    want = ref.wkv6(*args)
    Bn, S, H, _ = r.shape
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(r.device))
    if S <= L:
        raise AssertionError(f"wkv6 faults at {label}: S {S} is one chunk")
    w_edge = w.clone()
    w_edge[:, L] = 1.0
    for fault, got in (
            ("bonus_u_dropped",
             ops.wkv6(r, k, v, w, torch.zeros_like(u), S0)),
            ("state_not_carried",
             ops.wkv6(r, k, v, w, u, torch.zeros_like(S0))),
            ("i_and_j_swapped",
             ops.wkv6(r, k, v, w, u, S0.transpose(-1, -2).contiguous())),
            ("decay_after_add", _wkv_decay_after_add(torch, *args)),
            ("chunk_edge_decay_dropped",
             ops.wkv6(r, k, v, w_edge, u, S0))):
        err, ok = _wkv_close(torch, ref, got, want, args)
        log(f"phase=parity {label} planted_fault={fault} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {fault} passed the wkv6 "
                                 f"tolerance ({label})")


def parity_wkv6_shapes(torch, ops, ref, gen) -> list:
    """wkv6 at rwkv6-1.6b's heads (WKV_CASES), the four planted faults on
    the padded window from a carried state.  Returns (kernel, label,
    case) triples for run_case."""
    out = []
    for mode, Bn, S, lens, carried in WKV_CASES:
        args = _wkv_inputs(torch, gen, Bn, S, lens, carried)
        label = f"arch=rwkv6-1.6b mode={mode}"
        out.append(("wkv6", label, case_wkv(torch, ops, ref, *args)))
        if mode in ("masked", "long_row"):
            wkv_faults(torch, ops, ref, args, label)
    return out


def parity_select_modes(torch, ops, ref, gen) -> list:
    """score_select's other scorings (SELECT_MODES: mean metadata, the
    sum over the group, both) at qwen2-0.5b's serve shape, ties planted
    (mean rows 5-8 equal to row 4; the cuboid's as _select_inputs plants
    them) and request 1 at a block edge, each with its three planted
    faults.  Returns (kernel, label, case) triples for run_case."""
    dev = torch.device("cuda")
    sh = SHAPES["qwen2-0.5b"]
    Hq, Hkv, D = sh["Hq"], sh["Hkv"], sh["D"]
    q = torch.randn((SELECT_MODE_B, Hq, D), generator=gen,
                    device=dev).bfloat16()
    cur_len = torch.tensor([SELECT_MODE_NB * BS - 1, 0, 70 * BS + 5,
                            SELECT_MODE_NB * BS - 40], dtype=torch.int32,
                           device=dev)
    _, tie_meta, sel_len = _select_inputs(torch, gen, cur_len, Hkv, D,
                                          SELECT_MODE_NB)
    mean = torch.randn((SELECT_MODE_B, Hkv, SELECT_MODE_NB, D),
                       generator=gen, device=dev)
    mean[:, :, 5:9] = mean[:, :, 4:5]
    out = []
    for label, metadata, reduce in SELECT_MODES:
        meta = mean if metadata == "mean" else tie_meta
        kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2,
                  metadata=metadata, group_reduce=reduce)
        arch = f"qwen2-0.5b mode={label}"
        select_faults(torch, ops, ref, q, meta, sel_len, kw, arch)
        out.append(("score_select:mean" if metadata == "mean"
                    and reduce == "max" else "score_select:sum",
                    f"arch={arch}",
                    case_select(torch, ops, ref, q, meta, sel_len, **kw)))
    return out


def _save_inputs(torch, ops, gen, dev, Hkv: int, D: int) -> list:
    """quant_save_blocks items shaped as the int8 serve makes them, over
    4 requests' pools (2 layers, 12 blocks of BS tokens; blocks 8-11
    fresh, scale 0): a decode token per request, float32, as strided views
    of a (4, Hkv, D) tensor (two of them into fresh blocks, one at a fresh
    block's last slot); a prefill stripe of 100 tokens from a block edge,
    a (T, Hkv, D) buffer seen as (Hkv, T, D) (three whole blocks, then 4
    tokens), in bfloat16 (the serve ships float32; the kernel takes both);
    a float32 stripe of 70 tokens from the middle of block 1 over three
    blocks; and a second decode token into request 0's block, which must
    wait for the first (two rounds)."""
    L, nb = 2, 12
    pools = []
    for _ in range(4):
        pair = []
        for _ in range(2):
            q = torch.randint(-127, 128, (L, Hkv, nb, BS, D), generator=gen,
                              dtype=torch.int8)
            sc = torch.rand((L, Hkv, nb), generator=gen) * 0.05
            q[:, :, 8:] = 0
            sc[:, :, 8:] = 0
            pair.append(ops.QuantPool(q, sc))
        pools.append(pair)
    kd = torch.randn((4, 2, Hkv, D), generator=gen).to(dev)
    pos = (37, 100, 8 * BS, 9 * BS + BS - 1)
    saves = [ops.QuantSave(pools[i][kv], 1, pos[i], kd[i, kv][:, None, :])
             for i in range(4) for kv in (0, 1)]
    pre = torch.randn((100, Hkv, D), generator=gen).to(dev, torch.bfloat16)
    mid = torch.randn((Hkv, 70, D), generator=gen).to(dev) * 3
    saves += [ops.QuantSave(pools[0][0], 0, 2 * BS, pre.permute(1, 0, 2)),
              ops.QuantSave(pools[1][1], 0, 40, mid),
              ops.QuantSave(pools[0][0], 1, pos[0] + 1,
                            kd[3, 1][:, None, :] * 4)]
    return saves


def link_copy(torch, direction: str, nbytes: int):
    """A contiguous copy of ``nbytes`` over the PCIe link, pinned host to
    device ("h2d") or device to pinned host ("d2h")."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    if direction == "h2d":
        return lambda: dev.copy_(host, non_blocking=True)
    return lambda: host.copy_(dev, non_blocking=True)


def device_ms(torch, fn, reps: int = 10, by_kernel: str = ""):
    """Device time of one call of ``fn``: the summed device-side events
    (kernels, copies, memsets) of ``reps`` calls under torch.profiler,
    over ``reps``; free of the Timer's ~6 us floor.  With ``by_kernel``:
    instead {kernel: ms per call} for the device kernels whose name holds
    that prefix."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split, total = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)) / reps / 1e3
        total += ms
        m = re.search(by_kernel + r"\w*", e.key) if by_kernel else None
        if m:
            split[m.group(0)] = round(split.get(m.group(0), 0.0) + ms, 5)
    return split if by_kernel else total


def events_ms(torch, fn, reps: int = 10) -> float:
    """Time of one call of ``fn`` from CUDA events around ``reps`` calls
    made back to back (no flush, no spin): a second device-side reading
    beside ``device_ms``, for a kernel long enough that launch gaps do
    not count."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def run_case(phase: str, label: str, name: str, case: tuple,
             timer, device: bool = False) -> dict:
    """Time one case, print its line, fail on disagreement.  A case is
    (max_abs_err, ok, kernel fn, plain fn, bytes, ops, shape[, library fn
    or None[, (link direction, bytes) or None]]).  ``device``: also the
    kernel's device ms per call under torch.profiler (``device_ms``) and
    from CUDA events over back-to-back calls (``events_ms``)."""
    err, ok, kfn, pfn, nbytes, nops, shape, *extra = case
    lib_fn = extra[0] if extra else None
    link = extra[1] if len(extra) > 1 else None
    unfused = extra[2] if len(extra) > 2 else None
    k_ms, p_ms = timer(kfn), timer(pfn)
    lib_ms = timer(lib_fn) if lib_fn is not None else None
    b_ms, b_by = bound_ms(nbytes, nops)
    res = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
           "shape": shape}
    if device:
        res["device_ms"] = device_ms(timer.torch, kfn)
        res["events_ms"] = events_ms(timer.torch, kfn)
    if unfused is not None:
        res["unfused_ms"] = timer(unfused)
    line = (f"phase={phase} {label} kernel={name} ok={ok} "
            f"max_abs_err={err:.3e} kernel_ms={k_ms:.4f} "
            f"plain_ms={p_ms:.4f} library_ms="
            + (f"{lib_ms:.4f}" if lib_ms is not None
               else f"None({NO_LIBRARY.get(name, 'no single call')})")
            + f" bound_ms={b_ms:.4f} bound_by={b_by}")
    if unfused is not None:
        line += (f" unfused_ms={res['unfused_ms']:.4f} (block_score kernel, "
                 f"then the plain select)")
    if device:
        line += (f" device_ms={res['device_ms']:.5f} "
                 f"events_ms={res['events_ms']:.5f}")
    if link is not None:
        res["link_bound_ms"] = timer(link_copy(timer.torch, *link))
        res["binds"] = "link" if res["link_bound_ms"] > b_ms else "hbm"
        line += (f" link_bound_ms={res['link_bound_ms']:.4f} "
                 f"({link[0]} copy of {link[1]} B) binds={res['binds']}")
    log(line + f" shape=[{shape}]")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({phase} {label}, max abs err {err})")
    return res


def planted_faults(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len,
                   arch: str, scale=None) -> None:
    """The attention tolerance must reject a kernel that masks one block
    wrong: run the kernel on inputs with a planted fault and hold it
    against the plain version on the true inputs."""
    want = ref.sparse_decode_attention(q, k_pool, v_pool, idx, valid,
                                       cur_len, scale)
    bs = k_pool.shape[3]
    flipped = valid.clone()
    flipped[1, 0, 1] = False           # a whole live block (the one
    #                                    before the block of cur_len - 1)
    for label, args in (
            ("cur_len_one_block_short",
             (q, k_pool, v_pool, idx, valid, cur_len - bs)),
            ("one_valid_flag_cleared",
             (q, k_pool, v_pool, idx, flipped, cur_len))):
        err, ok = _attn_close(ops.sparse_decode_attention(*args, scale),
                              want)
        log(f"phase=parity arch={arch} planted_fault={label} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {label} passed the "
                                 f"attention tolerance at {arch} shapes")


def _probe(q, k, v, qi: int, kj: int, scale: float) -> tuple:
    """Plant key ``kj`` so that query row ``qi`` (the first head of each
    GQA group) puts nearly all its weight on it (score 30), with value 8:
    a kernel that shows that key to that query, or hides it, wrongly moves
    the output by O(1)."""
    k, v = k.clone(), v.clone()
    G = q.shape[2] // k.shape[2]
    qh = q[:, qi, ::G].float()                          # (B, Hkv, D)
    k[:, kj] = (qh * (30.0 / (scale * (qh * qh).sum(-1, keepdim=True)))
                ).to(k.dtype)
    v[:, kj] = 8.0
    return k, v


def _late_tile_dropped(torch, ops, q, k, v, kw, q_offset: int):
    """The kernel's output with the key tile [k0, k0 + 64) hidden from the
    queries of the window's second half only (the heavy query tiles, each
    of which sees all of that tile): a fault in a few late rows' long
    sums, which moves each such row by ~64 / n of its values' spread."""
    Sq = q.shape[1]
    h = Sq // 2 // 64 * 64
    k0 = (q_offset + h) // 2 // 64 * 64
    assert k0 + 64 <= q_offset + h, "every late query must see the tile"

    def cut(x):
        return torch.cat([x[:, :k0], x[:, k0 + 64:]], dim=1).contiguous()
    out = ops.flash_prefill(q, k, v, q_offset=q_offset, **kw)
    # among the cut keys, the query at position p sees those up to p - 64
    out[:, h:] = ops.flash_prefill(q[:, h:].contiguous(), cut(k), cut(v),
                                   q_offset=q_offset + h - 64, **kw)
    return out


def flash_faults(torch, ops, ref, q, k, v, scale, q_offset, label) -> None:
    """The flash tolerance must reject a kernel that places the window one
    position late (query 0 then sees the key after its own), drops the
    last key (which only the last query sees), or skips one interior key
    tile for the late query tiles only: each runs through the kernel on
    probed or cut inputs and is held against the plain version on the
    true ones."""
    Sq, Sk = q.shape[1], k.shape[1]
    kw = dict(scale=scale, causal=True)
    faults = []
    kp, vp = _probe(q, k, v, 0, q_offset + 1, scale)
    faults.append(("q_offset_plus_one",
                   ops.flash_prefill(q, kp, vp, q_offset=q_offset + 1, **kw),
                   (q, kp, vp)))
    kp, vp = _probe(q, k, v, Sq - 1, Sk - 1, scale)
    faults.append(("last_key_dropped",
                   ops.flash_prefill(q, kp[:, :-1].contiguous(),
                                     vp[:, :-1].contiguous(),
                                     q_offset=q_offset, **kw),
                   (q, kp, vp)))
    faults.append(("late_tile_dropped",
                   _late_tile_dropped(torch, ops, q, k, v, kw, q_offset),
                   (q, k, v)))
    for fault, out, true in faults:
        want = ref.flash_prefill(*true, q_offset=q_offset, **kw)
        err, ok, ratio = _flash_close(out, want, _abs_weight(
            ref, *true, q_offset=q_offset, **kw))
        log(f"phase=parity {label} planted_fault={fault} "
            f"max_abs_err={err:.3e} largest_err/bound="
            f"{ratio.max().item():.3f} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {fault} passed the flash "
                                 f"tolerance ({label})")


def _partial_close(torch, got, want) -> tuple:
    """(max abs err, ok) of the partial decode attention's (acc, m, l)
    against the plain version's, PARTIAL_TOL: m exactly -1e30 where the
    plain one's is (no valid position), elsewhere per tensor |err| <=
    PARTIAL_TOL of its scale + PARTIAL_TOL |ref|."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        empty = w <= -1e29
        ok &= bool(torch.equal(g[empty], w[empty]))
        g, w = g[~empty], w[~empty]
        if not w.numel():
            continue
        d = (g - w).abs()
        err = max(err, d.max().item())
        ok &= bool((d <= PARTIAL_TOL * w.abs().max()
                    + PARTIAL_TOL * w.abs()).all())
    return err, ok


def case_partial(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len,
                 offset: int, scale=None):
    """The partial decode attention (the context-parallel decode's, a
    rank's block shard from global block ``offset`` on) against its
    plain version; the kernel given the offset one block off must fail
    the tolerance.  Its bound reads each live block once (the latent
    once where it is k and v) and writes the float32 partials."""
    args = (q, k_pool, v_pool, idx, valid, cur_len, offset, scale)
    got = ops.sparse_decode_attention_partial(*args)
    want = ref.sparse_decode_attention_partial(*args)
    torch.cuda.synchronize()
    err, ok = _partial_close(torch, got, want)
    off = ops.sparse_decode_attention_partial(q, k_pool, v_pool, idx, valid,
                                              cur_len, offset + 1, scale)
    torch.cuda.synchronize()
    if _partial_close(torch, off, want)[1]:
        raise AssertionError("partial decode attention: the offset one "
                             "block off passes the tolerance")
    B, Hq, _ = q.shape
    _, Hkv, NB, bs, D = k_pool.shape
    Dv = v_pool.shape[-1]
    live = int((valid & ((idx + offset) * bs < cur_len[:, None, None])
                ).sum().item())
    read = D + (Dv if v_pool.data_ptr() != k_pool.data_ptr() else 0)
    nbytes = (q.numel() * 2 + live * bs * read * 2 + idx.numel() * 5
              + cur_len.numel() * 4 + (B * Hq * Dv + 2 * B * Hq) * 4)
    nops = live * (Hq // Hkv) * bs * 2 * (D + Dv)
    shape = (f"B={B} Hq={Hq} Hkv={Hkv} NB_loc={NB} offset={offset} "
             f"K={idx.shape[-1]} bs={bs} D={D} "
             + (f"Dv={Dv} " if Dv != D else "")
             + (f"scale={scale:.6f} " if scale is not None else "")
             + f"live_blocks={live}")
    return (err, ok, lambda: ops.sparse_decode_attention_partial(*args),
            lambda: ref.sparse_decode_attention_partial(*args), nbytes,
            nops, shape)


def parity_mesh_shapes(torch, ops, ref, gen) -> list:
    """The kernels at the shapes the mesh phase's context-parallel decode
    gives them (rank 1 of 2: NB_loc 257 of a 514-block pool, offset 257,
    B 2, K 64): the partial decode attention at llama3-8b's heads (32
    over 8, D 128) and at minicpm3-4b's latent (40 over one head of D =
    Dv = 288, the pool as k and v, scale 1 / sqrt(96)), each with its
    planted fault (the offset one block off); block_score at both, the
    latent through its wide instance; flash_prefill at each rank's query
    slice of the sequence-parallel layer's padded window (MESH_SP)
    against its keys.  Returns (kernel, label, case) triples for
    run_case, which times the mesh cases also by the profiler and by
    CUDA events."""
    per = _mesh_blocks(BS) // MESH_WORLD
    offset = per
    out = []
    for arch, Hq, Hkv, D, scale in (
            ("llama3-8b", 32, 8, 128, None),
            (MLA_SHAPE["arch"], MLA_SHAPE["Hq"], MLA_SHAPE["Hkv"],
             MLA_SHAPE["D"], MLA_SHAPE["qk"] ** -0.5)):
        q, kp, vp, idx, valid, _ = _attention_inputs(torch, gen, MESH_B, Hq,
                                                     Hkv, D, per)
        if scale is not None:
            vp = kp                      # MLA: the latent is k and v
        # global lengths past the shard's start, one at the prompt's end;
        # the shard's blocks holding each row's last two positions
        # selected (valid), as DSA's recent blocks are, so a validity
        # taken at the wrong global positions shows
        cur_len = torch.tensor([MESH_PROMPT + 1, (offset + per // 2) * BS
                                + 7], dtype=torch.int32, device=q.device)
        last = ((cur_len.long() - 1) // BS - offset).clamp(0, per - 1)
        pick = torch.rand((MESH_B, Hkv, per), generator=gen,
                          device=q.device)
        pick.scatter_(2, last[:, None, None].expand(MESH_B, Hkv, 1), 3.0)
        pick.scatter_(2, (last - 1).clamp(min=0)[:, None, None].expand(
            MESH_B, Hkv, 1), 2.0)
        idx = pick.argsort(dim=-1, descending=True)[..., :K].to(
            torch.int32).contiguous()
        valid[..., :2] = True
        label = f"arch={arch} path=mesh rank=1/{MESH_WORLD}"
        out.append(("sparse_decode_attention:partial", label, case_partial(
            torch, ops, ref, q, kp, vp, idx, valid, cur_len, offset,
            scale)))
        meta, _, _ = _select_inputs(torch, gen, cur_len, Hkv, D, per)
        out.append(("block_score:wide" if D > ops.SCORE_NARROW_D
                    else "block_score", label,
                    case_score(torch, ops, ref, q, meta)))
    # the sequence-parallel prefill layer's flash_prefill: each rank's
    # query slice of the padded window against all its keys
    arch, Bn, T = MESH_SP
    sh = SHAPES[arch]
    T_pad = -(-T // MESH_WORLD) * MESH_WORLD
    T_loc = T_pad // MESH_WORLD
    k = torch.randn((Bn, T_pad, sh["Hkv"], sh["D"]), generator=gen,
                    device="cuda").bfloat16()
    v = torch.randn(k.shape, generator=gen, device="cuda").bfloat16()
    q = torch.randn((Bn, T_pad, sh["Hq"], sh["D"]), generator=gen,
                    device="cuda").bfloat16()
    for r in range(MESH_WORLD):
        out.append(("flash_prefill", f"arch={arch} path=mesh mode=sp "
                    f"rank={r}/{MESH_WORLD}", case_flash(
                        torch, ops, ref,
                        q[:, r * T_loc:(r + 1) * T_loc].contiguous(), k, v,
                        scale=sh["D"] ** -0.5, q_offset=r * T_loc)))
    return out


def phase_parity(torch, ops, ref, timer, seed: int) -> dict:
    """Each kernel against its plain version at both shape sets, and the
    decode kernels at the shapes of parity_new_shapes; returns {kernel:
    {case label: result}}."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    results = {}
    for arch, sh in SHAPES.items():
        Hq, Hkv, D = sh["Hq"], sh["Hkv"], sh["D"]

        def randn(*shape, dtype=bf):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        attn = _attention_inputs(torch, gen, B, Hq, Hkv, D, NB)
        q, cur_len = attn[0], attn[-1]
        cases = [("sparse_decode_attention", "",
                  case_attention(torch, ops, ref, *attn))]
        planted_faults(torch, ops, ref, *attn, arch)

        # block_score (meta in the pool's interleaved layout), then
        # score_select on the same q, ties planted
        meta, tie_meta, sel_len = _select_inputs(torch, gen, cur_len, Hkv,
                                                 D, NB)
        cases.append(("block_score", "", case_score(torch, ops, ref, q,
                                                     meta)))
        kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2)
        cases.append(("score_select", "", case_select(
            torch, ops, ref, q, tie_meta, sel_len, **kw)))
        select_faults(torch, ops, ref, q, tie_meta, sel_len, kw, arch)

        # gather_blocks_hkv: pinned float32 host pool -> device
        cpu_gen = torch.Generator().manual_seed(seed)
        host_pool = torch.randn((Hkv, NB, BS, D),
                                generator=cpu_gen).pin_memory()
        gidx = torch.randperm(NB, generator=cpu_gen)[:K].to(torch.int32)
        cases.append(("gather_blocks_hkv", "", case_gather(
            torch, ops, ref, host_pool, gidx.to(dev))))

        # scatter_blocks_hkv: a restore (float32 payload, batched rows) and
        # a drop (bf16 payload into one row's pool)
        pool = randn(B, Hkv, NB, BS, D)
        dest = torch.randperm(NB, generator=gen, device=dev)[:K].to(
            torch.int32)
        rows = torch.randint(0, B, (K,), generator=gen, device=dev,
                             dtype=torch.int32)
        cases.append(("scatter_blocks_hkv", "mode=rows", case_scatter(
            torch, ops, ref, pool, randn(Hkv, K, BS, D, dtype=torch.float32),
            dest, rows)))
        cases.append(("scatter_blocks_hkv", "mode=drop", case_scatter(
            torch, ops, ref, pool[3].clone(), randn(Hkv, K, BS, D), dest)))

        # zero_blocks_hkv: a round of 150 (layer, row, block) drops over
        # two layers' K and V pools, as the plane lists them
        layers = [randn(B, Hkv, NB, BS, D) for _ in range(4)]
        pick = torch.randint(0, 2 * B * NB, (150,), generator=gen,
                             device=dev).tolist()
        which = [2 * (t // (B * NB)) + kv for t in pick for kv in (0, 1)]
        zrows = [t // NB % B for t in pick for _ in (0, 1)]
        zblocks = [t % NB for t in pick for _ in (0, 1)]
        cases.append(("zero_blocks_hkv", "", case_zero(
            torch, ops, ref, layers, which, zrows, zblocks)))

        # flash_prefill: the serve prefill's shape (q_offset 0), and a
        # chunk continuation after 1000 context keys, 1000 queries (no
        # whole 64-row tile)
        scale = D ** -0.5
        for mode, (Bf, Sq, q_off) in (
                ("q_offset=0", (4 if arch == "qwen2-0.5b" else 1,
                                SERVE_PROMPT, 0)),
                ("ctx", (2, 1000, 1000))):
            fq = randn(Bf, Sq, Hq, D)
            fk, fv = randn(Bf, q_off + Sq, Hkv, D), randn(Bf, q_off + Sq,
                                                          Hkv, D)
            cases.append(("flash_prefill", f"mode={mode}", case_flash(
                torch, ops, ref, fq, fk, fv, scale=scale, q_offset=q_off)))
            flash_faults(torch, ops, ref, fq, fk, fv, scale, q_off,
                         f"arch={arch} mode={mode}")

        # the int8 tier: the quant trio (one all-zero block), then its
        # block moves between the pinned int8 pool (and its float32 scale
        # plane) and the card
        x = (randn(Hkv, K, BS, D, dtype=torch.float32)
             * torch.rand((Hkv, K, 1, 1), generator=gen, device=dev) * 4)
        x[0, 5] = 0
        cases.append(("quantize_blocks", "mode=f32",
                      case_quantize(torch, ops, ref, x)))
        cases.append(("quantize_blocks", "mode=bf16",
                      case_quantize(torch, ops, ref, x.to(bf))))
        xq, xs = ops.quantize_blocks(x)
        cases.append(("dequantize_blocks", "",
                      case_dequantize(torch, ops, ref, xq, xs)))
        cases.append(("dequantize_scatter_blocks", "mode=rows",
                      case_dequant_scatter(torch, ops, ref, pool, xq, xs,
                                           dest, rows)))
        host_q = torch.randint(-127, 128, (Hkv, NB, BS, D), generator=cpu_gen,
                               dtype=torch.int8).pin_memory()
        host_s = torch.rand((Hkv, NB, 1, 1), generator=cpu_gen).pin_memory()
        cases.append(("gather_blocks_hkv", "mode=int8", case_gather(
            torch, ops, ref, host_q, gidx.to(dev))))
        cases.append(("gather_blocks_hkv", "mode=scales", case_gather(
            torch, ops, ref, host_s, gidx.to(dev))))
        cases.append(("write_blocks_hkv", "mode=int8",
                      case_write(torch, ops, ref, host_q, xq, dest)))
        cases.append(("write_blocks_hkv", "mode=scales",
                      case_write(torch, ops, ref, host_s,
                                 xs.view(Hkv, K, 1, 1), dest)))
        # the int8 save: every request's stripes of a layer in one call
        saves = _save_inputs(torch, ops, cpu_gen, dev, Hkv, D)
        cases.append(("quant_save_blocks", "",
                      case_quant_save(torch, ops, ref, saves)))
        quant_save_faults(torch, ops, ref, saves, f"arch={arch}")

        for name, mode, case in cases:
            label = f"arch={arch} {mode}".strip()
            results.setdefault(name, {})[label] = run_case(
                "parity", label, name, case, timer)
    for name, label, case in (parity_new_shapes(torch, ops, ref, gen)
                              + parity_mla_shapes(torch, ops, ref, gen)
                              + parity_moe_shapes(torch, ops, ref, gen)
                              + parity_frontend_shapes(torch, ops, ref,
                                                       gen)
                              + parity_scan_shapes(torch, ops, ref, gen)
                              + parity_select_modes(torch, ops, ref, gen)
                              + parity_wkv6_shapes(torch, ops, ref, gen)
                              + parity_mesh_shapes(torch, ops, ref, gen)):
        results.setdefault(name, {})[label] = run_case(
            "parity", label, name, case, timer, device="path=mesh" in label)
    return results


def _attention_inputs(torch, gen, Bn: int, Hq: int, Hkv: int, D: int,
                      nb: int) -> tuple:
    """sparse_decode_attention's inputs: random selections, about 60% of
    them skipped (invalid or past cur_len), plus the two blocks holding
    the last BS positions before cur_len, which DSA always selects, and a
    row (request 0, kv-head 0) with no valid position."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    q = randn(Bn, Hq, D)
    k_pool, v_pool = randn(Bn, Hkv, nb, BS, D), randn(Bn, Hkv, nb, BS, D)
    cur_len = torch.randint(K * BS // 2, nb * BS + 1, (Bn,), generator=gen,
                            device=dev, dtype=torch.int32)
    pick = torch.rand((Bn, Hkv, nb), generator=gen, device=dev)
    last = ((cur_len.long() - 1) // BS)[:, None, None]
    pick.scatter_(2, last.expand(Bn, Hkv, 1), 3.0)
    pick.scatter_(2, (last - 1).expand(Bn, Hkv, 1), 2.0)
    idx = pick.argsort(dim=-1, descending=True)[..., :K].to(
        torch.int32).contiguous()
    valid = torch.rand((Bn, Hkv, K), generator=gen, device=dev) > 0.1
    valid[..., :2] = True
    valid[0, 0] = False                  # a row with no valid position
    return q, k_pool, v_pool, idx, valid, cur_len


def _select_inputs(torch, gen, cur_len, Hkv: int, D: int, nb: int) -> tuple:
    """(meta, tie_meta, sel_len): block metadata in the pool's
    interleaved layout; the same with blocks 5-8 tied with block 4; and
    cur_len with request 1's at a block edge, so the step's +1 opens a
    new block."""
    dev = torch.device("cuda")
    Bn = cur_len.shape[0]
    mn = torch.randn((Bn, Hkv, nb, D), generator=gen, device=dev)
    mx = mn + torch.rand((Bn, Hkv, nb, D), generator=gen, device=dev)
    meta = torch.stack([mn, mx], dim=3).contiguous()
    mn[:, :, 5:9], mx[:, :, 5:9] = mn[:, :, 4:5], mx[:, :, 4:5]
    tie_meta = torch.stack([mn, mx], dim=3).contiguous()
    sel_len = cur_len.clone()
    sel_len[min(1, Bn - 1)] = (nb // 2) * BS
    return meta, tie_meta, sel_len


def group_faults(torch, ops, ref, q, k_pool, v_pool, idx, valid, cur_len,
                 arch: str, scale=None) -> None:
    """At a GQA group of several tiles, the attention tolerance must
    reject a kernel whose last group tile reads each query row one row
    late, or leaves that tile's rows unwritten (zero): the first runs
    through the kernel on q with those rows shifted, the second is the
    kernel's output with those rows cleared; both are held against the
    plain version on the true inputs."""
    want = ref.sparse_decode_attention(q, k_pool, v_pool, idx, valid,
                                       cur_len, scale)
    Bn, Hq, D = q.shape
    Hkv = k_pool.shape[1]
    G = Hq // Hkv
    g0 = (ops.decode_group_tiles(G) - 1) * ops.DECODE_TILE_G
    assert g0 > 0 and G - g0 >= 2, "needs a last tile of two rows or more"
    late = q.view(Bn, Hkv, G, D).clone()
    late[:, :, g0:G - 1] = q.view(Bn, Hkv, G, D)[:, :, g0 + 1:]
    rest = (k_pool, v_pool, idx, valid, cur_len, scale)
    cleared = ops.sparse_decode_attention(q, *rest).view(Bn, Hkv, G, -1)
    cleared[:, :, g0:] = 0
    for label, out in (
            ("last_tile_rows_one_late", ops.sparse_decode_attention(
                late.view(Bn, Hq, D), *rest)),
            ("last_tile_unwritten", cleared.view(Bn, Hq, -1))):
        err, ok = _attn_close(out, want)
        log(f"phase=parity arch={arch} planted_fault={label} "
            f"max_abs_err={err:.3e} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {label} passed the "
                                 f"attention tolerance at {arch} shapes")


def parity_new_shapes(torch, ops, ref, gen) -> list:
    """The shapes the decode kernels take since they serve any GQA group
    and more than 4096 blocks: sparse_decode_attention and score_select at
    granite-20b's group (48 query heads over one kv head, D 128; three
    group tiles), with the attention's four planted faults and the
    select's two; score_select at llama3-8b's heads at NB 4097 and 8193
    (the radix-select path; 8193 blocks hold its config's 262,144-token
    context) with its two planted faults.  Returns (kernel, label, case)
    triples for run_case."""
    sh = GROUP_SHAPE
    out = []
    attn = _attention_inputs(torch, gen, GROUP_B, sh["Hq"], sh["Hkv"],
                             sh["D"], NB)
    label = f"arch={sh['arch']}"
    out.append(("sparse_decode_attention", label,
                case_attention(torch, ops, ref, *attn)))
    planted_faults(torch, ops, ref, *attn, sh["arch"])
    group_faults(torch, ops, ref, *attn, sh["arch"])
    kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2)
    _, tie_meta, sel_len = _select_inputs(torch, gen, attn[-1], sh["Hkv"],
                                          sh["D"], NB)
    out.append(("score_select", label, case_select(
        torch, ops, ref, attn[0], tie_meta, sel_len, **kw)))
    select_faults(torch, ops, ref, attn[0], tie_meta, sel_len, kw,
                  sh["arch"])
    ll = SHAPES["llama3-8b"]
    for nb in LONG_NB:
        q = torch.randn((LONG_B, ll["Hq"], ll["D"]), generator=gen,
                        device="cuda").bfloat16()
        cur_len = torch.randint(nb * BS // 2, nb * BS, (LONG_B,),
                                generator=gen, device="cuda",
                                dtype=torch.int32)
        _, tie_meta, sel_len = _select_inputs(torch, gen, cur_len,
                                              ll["Hkv"], ll["D"], nb)
        label = f"arch=llama3-8b nb={nb}"
        out.append(("score_select", label, case_select(
            torch, ops, ref, q, tie_meta, sel_len, **kw)))
        select_faults(torch, ops, ref, q, tie_meta, sel_len, kw,
                      f"llama3-8b nb={nb}")
    return out


def parity_mla_shapes(torch, ops, ref, gen) -> list:
    """The three kernels at the MLA shapes they take since minicpm3-4b is
    served (MLA_SHAPE): sparse_decode_attention with G = 40 over one
    latent head of D = Dv = 288, the same pool as k and v, scale
    1 / sqrt(96), with the attention's four planted faults; score_select
    over the 288-wide latent metadata at NB 256 and 1025, each with its
    two planted faults; flash_prefill at q/k depth 96 and v width 64, 40
    heads over 40, 4096 tokens, with its three planted faults.  Returns
    (kernel, label, case) triples for run_case."""
    sh = MLA_SHAPE
    dev = torch.device("cuda")
    scale = sh["qk"] ** -0.5
    label = f"arch={sh['arch']}"
    q, pool, _, idx, valid, cur_len = _attention_inputs(
        torch, gen, MLA_B, sh["Hq"], sh["Hkv"], sh["D"], NB)
    attn = (q, pool, pool, idx, valid, cur_len)
    out = [("sparse_decode_attention", label,
            case_attention(torch, ops, ref, *attn, scale=scale))]
    planted_faults(torch, ops, ref, *attn, sh["arch"], scale=scale)
    group_faults(torch, ops, ref, *attn, sh["arch"], scale=scale)
    kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2)
    for nb, bn in MLA_NB:
        qs = torch.randn((bn, sh["Hq"], sh["D"]), generator=gen,
                         device=dev).bfloat16()
        cl = torch.randint(nb * BS // 2, nb * BS, (bn,), generator=gen,
                           device=dev, dtype=torch.int32)
        _, tie_meta, sel_len = _select_inputs(torch, gen, cl, sh["Hkv"],
                                              sh["D"], nb)
        out.append(("score_select", f"{label} nb={nb}", case_select(
            torch, ops, ref, qs, tie_meta, sel_len, **kw)))
        select_faults(torch, ops, ref, qs, tie_meta, sel_len, kw,
                      f"{sh['arch']} nb={nb}")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    H = sh["Hq"]
    fq, fk = randn(1, SERVE_PROMPT, H, sh["qk"]), randn(1, SERVE_PROMPT, H,
                                                         sh["qk"])
    fv = randn(1, SERVE_PROMPT, H, sh["v"])
    out.append(("flash_prefill", f"{label} mode=q_offset=0", case_flash(
        torch, ops, ref, fq, fk, fv, scale=scale)))
    flash_faults(torch, ops, ref, fq, fk, fv, scale, 0,
                 f"{label} mode=q_offset=0")
    return out


def flash_spill_fault(torch, ops, ref, q, k, v, scale, q_offset,
                      label) -> None:
    """The flash tolerance must reject a store that spills past a head's
    Dv columns into the next head's: the kernel's output with each head
    after the first given, over its first 16 columns, what a spilled
    store of the 128-column accumulator writes there (its columns
    112-127, zero, as V's zero-filled columns make them)."""
    kw = dict(scale=scale, causal=True, q_offset=q_offset)
    out = ops.flash_prefill(q, k, v, **kw)
    out[:, :, 1:, :16] = 0
    want = ref.flash_prefill(q, k, v, **kw)
    err, ok, ratio = _flash_close(out, want, _abs_weight(ref, q, k, v,
                                                         **kw))
    log(f"phase=parity {label} planted_fault=spill_into_next_head "
        f"max_abs_err={err:.3e} largest_err/bound="
        f"{ratio.max().item():.3f} rejected={not ok}")
    if ok:
        raise AssertionError(f"planted fault spill_into_next_head passed "
                             f"the flash tolerance ({label})")


def flash_guard(torch, ops, ref, q, k, v, scale, q_offset, label) -> None:
    """The kernel launched (through its library, as the wrapper does) into
    a buffer that holds its (B, Sq, Hq, Dv) output and FLASH_GUARD
    elements after it, all FLASH_SENTINEL: every output element must be
    written and within the tolerance, and the guard band, where a store
    past the last head's Dv columns would land, untouched."""
    from repro_torch.kernels.build import LIBS
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, Dv = v.shape
    n = B * Sq * Hq * Dv
    buf = torch.full((n + FLASH_GUARD,), FLASH_SENTINEL,
                     dtype=torch.bfloat16, device=q.device)
    rc = LIBS.fn("flash_prefill")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(), None, B,
        Sq, Sk, Hq, Hkv, D, Dv, q_offset, 1, float(scale),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    out = buf[:n].view(B, Sq, Hq, Dv)
    kw = dict(scale=scale, causal=True, q_offset=q_offset)
    err, ok, _ = _flash_close(out, ref.flash_prefill(q, k, v, **kw),
                              _abs_weight(ref, q, k, v, **kw))
    unwritten = int((out == FLASH_SENTINEL).sum())
    guard_hit = int((buf[n:] != FLASH_SENTINEL).sum())
    log(f"phase=parity {label} flash_guard rc={rc} unwritten={unwritten} "
        f"guard_elements_written={guard_hit} of {FLASH_GUARD} "
        f"max_abs_err={err:.3e} ok={ok}")
    if rc != 0 or unwritten or guard_hit or not ok:
        raise AssertionError(f"flash_prefill wrote outside its output or "
                             f"left some of it unwritten ({label})")


def parity_moe_shapes(torch, ops, ref, gen) -> list:
    """The MoE family's attention shapes (MOE_SHAPES): at kimi-k2's (G 8,
    D 112) and arctic-480b's (G 7, D 128) decode steps,
    sparse_decode_attention with its two planted faults and score_select
    with its two; flash_prefill at D = Dv = 112 over kimi-k2's 64 heads
    over 8, a 4096-token prompt (q_offset 0) and a chunk continuation
    (1000 queries after 1000 context keys), each with the three planted
    flash faults, the spill into the next head (flash_spill_fault) and
    the guard band (flash_guard).  Returns (kernel, label, case) triples
    for run_case."""
    dev = torch.device("cuda")
    kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2)
    out = []
    for arch, sh in MOE_SHAPES.items():
        attn = _attention_inputs(torch, gen, MOE_B, sh["Hq"], sh["Hkv"],
                                 sh["D"], MOE_NB)
        label = f"arch={arch}"
        out.append(("sparse_decode_attention", label,
                    case_attention(torch, ops, ref, *attn)))
        planted_faults(torch, ops, ref, *attn, arch)
        _, tie_meta, sel_len = _select_inputs(torch, gen, attn[-1],
                                              sh["Hkv"], sh["D"], MOE_NB)
        out.append(("score_select", label, case_select(
            torch, ops, ref, attn[0], tie_meta, sel_len, **kw)))
        select_faults(torch, ops, ref, attn[0], tie_meta, sel_len, kw, arch)

    sh = MOE_SHAPES["kimi-k2-1t-a32b"]
    scale = sh["D"] ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    for mode, (Sq, q_off) in (("q_offset=0", (SERVE_PROMPT, 0)),
                              ("ctx", (1000, 1000))):
        fq = randn(1, Sq, sh["Hq"], sh["D"])
        fk, fv = (randn(1, q_off + Sq, sh["Hkv"], sh["D"]) for _ in range(2))
        label = f"arch=kimi-k2-1t-a32b mode={mode}"
        out.append(("flash_prefill", label, case_flash(
            torch, ops, ref, fq, fk, fv, scale=scale, q_offset=q_off)))
        flash_faults(torch, ops, ref, fq, fk, fv, scale, q_off, label)
        flash_spill_fault(torch, ops, ref, fq, fk, fv, scale, q_off, label)
        flash_guard(torch, ops, ref, fq, fk, fv, scale, q_off, label)
    return out


def noncausal_faults(torch, ops, ref, q, k, v, scale, label) -> None:
    """The flash tolerance must reject a non-causal kernel that applies
    the causal mask (query 0 then sees key 0 only), drops the last key,
    or drops the ragged last key tile (1500 = 11 x 128 + 92): each runs
    through the kernel on probed or cut inputs, query 0 putting its
    weight on key Sk - 1, and is held against the plain version on the
    true ones."""
    Sk = k.shape[1]
    kw = dict(scale=scale, causal=False)
    kp, vp = _probe(q, k, v, 0, Sk - 1, scale)
    whole = Sk // 128 * 128 if Sk % 128 else Sk - 128
    faults = (
        ("causal_mask", ops.flash_prefill(q, kp, vp, scale=scale,
                                          causal=True)),
        ("last_key_dropped", ops.flash_prefill(
            q, kp[:, :-1].contiguous(), vp[:, :-1].contiguous(), **kw)),
        ("ragged_tile_dropped", ops.flash_prefill(
            q, kp[:, :whole].contiguous(), vp[:, :whole].contiguous(),
            **kw)))
    want = ref.flash_prefill(q, kp, vp, **kw)
    weight = _abs_weight(ref, q, kp, vp, **kw)
    for fault, out in faults:
        err, ok, ratio = _flash_close(out, want, weight)
        log(f"phase=parity {label} planted_fault={fault} "
            f"max_abs_err={err:.3e} largest_err/bound="
            f"{ratio.max().item():.3f} rejected={not ok}")
        if ok:
            raise AssertionError(f"planted fault {fault} passed the flash "
                                 f"tolerance ({label})")


def parity_frontend_shapes(torch, ops, ref, gen) -> list:
    """The frontend families' kernels (FRONTEND_SHAPES): at
    internvl2-2b's (G 2, D 128) and whisper-small's (G 1, D 64) decode
    steps, sparse_decode_attention with its two planted faults and
    score_select with its two; flash_prefill's non-causal mode at each of
    NONCAUSAL_CASES (Sk not a multiple of 128, Sq = 1, Hq > Hkv, D 64 and
    128) with its three planted non-causal faults.  Returns (kernel,
    label, case) triples for run_case."""
    dev = torch.device("cuda")
    kw = dict(block_size=BS, top_k=K, sink_blocks=1, recent_blocks=2)
    out = []
    for arch, sh in FRONTEND_SHAPES.items():
        attn = _attention_inputs(torch, gen, FRONTEND_B, sh["Hq"],
                                 sh["Hkv"], sh["D"], FRONTEND_NB)
        label = f"arch={arch}"
        out.append(("sparse_decode_attention", label,
                    case_attention(torch, ops, ref, *attn)))
        planted_faults(torch, ops, ref, *attn, arch)
        _, tie_meta, sel_len = _select_inputs(torch, gen, attn[-1],
                                              sh["Hkv"], sh["D"],
                                              FRONTEND_NB)
        out.append(("score_select", label, case_select(
            torch, ops, ref, attn[0], tie_meta, sel_len, **kw)))
        select_faults(torch, ops, ref, attn[0], tie_meta, sel_len, kw, arch)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()
    for name, Bn, Sq, Sk, Hq, Hkv, D in NONCAUSAL_CASES:
        q, k, v = randn(Bn, Sq, Hq, D), randn(Bn, Sk, Hkv, D), randn(
            Bn, Sk, Hkv, D)
        label = f"noncausal={name}"
        out.append(("flash_prefill", label, case_flash(
            torch, ops, ref, q, k, v, scale=D ** -0.5, causal=False)))
        noncausal_faults(torch, ops, ref, q, k, v, D ** -0.5, label)
    return out


def case_flat_gather(torch, ops, ref, pool, idx, lib_pool):
    """gather_blocks from ``pool`` (pinned host or device) with idx on the
    card; the library call is index_select on the device-resident
    ``lib_pool``, and from a pinned pool the blocks cross the link."""
    idx_h = idx.cpu()
    out = ops.gather_blocks(pool, idx)
    want = ref.gather_blocks(pool, idx.to(pool.device)).to(idx.device)
    torch.cuda.synchronize()
    NB, bs, D = pool.shape
    K = idx.shape[0]
    moved = K * bs * D * pool.element_size()
    on_host = pool.device.type == "cpu"
    return ((out.float() - want.float()).abs().max().item(),
            bool(torch.equal(out, want)),
            lambda: ops.gather_blocks(pool, idx),
            lambda: ref.gather_blocks(pool, idx_h if on_host else idx).to(
                idx.device, non_blocking=True),
            2 * moved + K * 4, 0,
            f"pool=({NB},{bs},{D}) {str(pool.dtype)[6:]} "
            f"{'pinned host' if on_host else 'device'} K={K}",
            lambda: torch.index_select(lib_pool, 0, idx),
            ("h2d", moved) if on_host else None)


def case_flat_scatter(torch, ops, ref, pool, new_kv, dest, lib_pool):
    """scatter_blocks of a device new_kv into ``pool`` (pinned host or
    device); the library call is index_copy_ into the device-resident
    ``lib_pool``, and into a pinned pool the blocks cross the link."""
    NB, bs, D = pool.shape
    n = dest.shape[0]
    on_host = pool.device.type == "cpu"
    got = pool.clone()
    got = got.pin_memory() if on_host else got
    ops.scatter_blocks(got, new_kv, dest)
    torch.cuda.synchronize()
    want = ref.scatter_blocks(pool.clone(), new_kv.to(pool.device),
                              dest.to(pool.device))
    pool_k = pool.clone().pin_memory() if on_host else pool.clone()
    pool_p = pool.clone()
    blocks = new_kv.view(n, bs, D)
    moved = n * bs * D * pool.element_size()
    return ((got.float() - want.float()).abs().max().item(),
            bool(torch.equal(got, want)),
            lambda: ops.scatter_blocks(pool_k, new_kv, dest),
            # the plain version takes new_kv to the pool's side first
            lambda: ref.scatter_blocks(pool_p, new_kv.to(pool.device),
                                       dest.to(pool.device)),
            2 * moved + n * 4, 0,
            f"pool=({NB},{bs},{D}) {str(pool.dtype)[6:]} "
            f"{'pinned host' if on_host else 'device'} n_new={n}",
            lambda: lib_pool.index_copy_(0, dest.long(), blocks),
            ("d2h", moved) if on_host else None)


def phase_transfer(torch, ops, ref, timer, seed: int) -> tuple:
    """The flat FlashH2D gather and FlashD2H scatter at bench_transfer's
    shape: driven once from and into a pinned host pool with the launch
    counts set to 0 just before and read just after, then each held byte
    for byte against its plain version from (into) a pinned host pool and
    a device pool, and timed beside 64 per-block copy_ calls for the same
    blocks, the link copy of the same bytes and the library call on a
    device-resident pool.  Returns ({kernel: {case: result}}, counts)."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    NB, bs, D, K = XFER_NB, XFER_BS, XFER_D, XFER_K
    pool = torch.randn((NB, bs, D), generator=gen)
    host = pool.clone().pin_memory()
    on_dev = pool.to(dev)
    ids = torch.randperm(NB, generator=gen)[:K].to(torch.int32)
    dest = torch.randperm(NB, generator=gen)[:K].to(torch.int32)
    new_kv = torch.randn((K * bs, D), generator=gen).to(dev)
    ids_d, dest_d = ids.to(dev), dest.to(dev)

    ops.launches.reset()
    got = ops.gather_blocks(host, ids_d)
    sink = host.clone().pin_memory()
    ops.scatter_blocks(sink, new_kv, dest_d)
    torch.cuda.synchronize()
    counts = ops.launches.snapshot()
    missing = [k for k in TRANSFER_PATH if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the transfer path: "
                             f"{missing}")
    if not (torch.equal(got.cpu(), pool[ids.long()])
            and torch.equal(sink[dest.long()],
                            new_kv.cpu().view(K, bs, D))):
        raise AssertionError("transfer: the driven gather or scatter moved "
                             "the wrong bytes")

    ids_l, dest_l = ids.tolist(), dest.tolist()
    out = torch.empty((K, bs, D), device=dev)
    blocks = new_kv.view(K, bs, D)
    host_k = host.clone().pin_memory()

    def per_block_gather():
        for i, b in enumerate(ids_l):
            out[i].copy_(host[b], non_blocking=True)

    def per_block_scatter():
        for i, b in enumerate(dest_l):
            host_k[b].copy_(blocks[i], non_blocking=True)

    results = {}
    for name, mode, case, per_block in (
            ("gather_blocks", "pinned", case_flat_gather(
                torch, ops, ref, host, ids_d, on_dev), per_block_gather),
            ("gather_blocks", "device", case_flat_gather(
                torch, ops, ref, on_dev, ids_d, on_dev), None),
            ("scatter_blocks", "pinned", case_flat_scatter(
                torch, ops, ref, pool, new_kv, dest_d, on_dev.clone()),
             per_block_scatter),
            ("scatter_blocks", "device", case_flat_scatter(
                torch, ops, ref, on_dev, new_kv, dest_d, on_dev.clone()),
             None)):
        label = f"path=transfer mode={mode}"
        res = run_case("transfer", label, name, case, timer)
        if per_block is not None:
            res["per_block_copies_ms"] = timer(per_block)
            res["launches"] = counts[name]
            log(f"phase=transfer kernel={name} mode={mode} "
                f"fused_ms={res['ms']:.4f} per_block_copies_ms="
                f"{res['per_block_copies_ms']:.4f} ({K} copy_ calls) "
                f"link_bound_ms={res['link_bound_ms']:.4f} "
                f"library_ms={res['library_ms']:.4f} "
                f"fused_vs_per_block="
                f"{res['per_block_copies_ms'] / res['ms']:.2f}x")
        results.setdefault(name, {})[label] = res
    log("phase=transfer launches " + json.dumps(
        {k: counts[k] for k in TRANSFER_PATH}))
    return results, counts


class MainPathCapture:
    """While active, wraps the kernel wrappers of ``ops`` to count their
    calls per case (scatter splits into its restore mode ``rows`` and its
    drop mode ``drop``, which the planes no longer call: their drop rounds
    are ``zero_blocks_hkv:drop``, one launch a round, whose pool table is
    kept as clones of its pools; ``score_select`` is one case, the decode
    select stage; the int8 tier's write backs into ``int8`` payloads
    and ``scales``; gather into the fp tier's blocks and the int8 tier's
    payloads and scales, each by its call site: ``restore``, the FlashH2D
    gather of ``HostPool.gather``, or ``flush``, the save's read of the
    resident blocks) and to keep a copy of the inputs of one launch per
    case: the first
    flash_prefill launch of each case (``context``: a chunk over earlier
    chunks; Whisper's non-causal ``encoder`` and ``cross_prefill``; its
    ``cross_decode`` is a decode-step case, kept as below) and the first
    prefill save (``quant_save_blocks`` splits into ``prefill`` and ``decode``; of
    each save, the layer of each pool it writes is kept), and for every
    other case the first made from attention launch ``from_attn`` on
    (one attention launch per layer and decode step; the first decode
    steps run fewer requests, as prefills finish one after another),
    except a drop round: the largest of those
    made before attention launch ``from_attn + layers`` (the rounds of one
    decode step vary in size, and the first may hold a few blocks).
    ``keep`` limits the kept cases; a pinned host pool is kept by
    reference."""

    WIDEST = ("zero_blocks_hkv:drop",)
    # kept from the decode step with the most rows, whenever it comes (an
    # attention-free model launches no attention to count steps by)
    WIDEST_ROWS = ("wkv6:decode",)

    def __init__(self, torch, ops, from_attn: int, keep=None,
                 layers: int = 1):
        self.torch, self.ops = torch, ops
        self.from_attn = from_attn
        self.until_attn = from_attn + layers
        self.keep = keep
        self.orig = {}
        self.calls = {}
        self.inputs = {}
        # the recurrences' launches by (B, S): {kernel: {"BxS": count}}
        self.shapes = {}

    def __enter__(self):
        for name in self.ops.launches.NAMES:
            self.orig[name] = getattr(self.ops, name)
            setattr(self.ops, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)

    def _keep(self, a, memo: dict):
        if isinstance(a, self.torch.Tensor) and not a.is_pinned():
            # one clone of a tensor passed twice, so the replay aliases
            # as the launch did (MLA's latent pool as k and v)
            if id(a) not in memo:
                memo[id(a)] = a.clone()
            return memo[id(a)]
        if isinstance(a, self.ops.PoolTable):
            return [p.clone() for p in a.pools]
        if isinstance(a, list) and a and isinstance(a[0], self.ops.QuantSave):
            # a save's layer of each pool, as it was before the save
            return [sv._replace(pool=self.ops.QuantPool(
                sv.pool.q[sv.layer:sv.layer + 1].clone(),
                sv.pool.scales[sv.layer:sv.layer + 1].clone()), layer=0,
                stripe=sv.stripe.clone()) for sv in a]
        return a

    def _key(self, name, args, kw, caller: str):
        torch = self.torch
        if name == "flash_prefill":
            if not kw.get("causal", True):
                # Whisper: the encoder's self-attention, or the decoder's
                # cross-attention from a prompt window or a decode token
                if caller != "cross_attention":
                    return f"{name}:encoder"
                return (f"{name}:cross_"
                        + ("decode" if args[0].shape[1] == 1 else "prefill"))
            # a chunk after the first attends over the chunks before it
            return (f"{name}:context" if int(kw.get("q_offset", 0)) > 0
                    else name)
        if name == "gather_blocks_hkv":
            pool = args[0]
            if pool.dtype == torch.int8:
                kind = "int8"
            elif pool.shape[-1] == 1:
                kind = "scales"
            else:
                return name
            site = "flush" if "flush" in caller else "restore"
            return f"{name}:{kind}_{site}"
        if name == "write_blocks_hkv":
            kind = "int8" if args[1].dtype == torch.int8 else "scales"
            return f"{name}:{kind}"
        if name == "scatter_blocks_hkv":
            rows = args[3] if len(args) > 3 else None
            return f"{name}:{'drop' if rows is None else 'rows'}"
        if name == "zero_blocks_hkv":
            return f"{name}:drop"
        if name == "quant_save_blocks":
            T = max(sv.stripe.shape[1] for sv in args[0])
            return f"{name}:{'prefill' if T > 1 else 'decode'}"
        if name in ("selective_scan", "wkv6"):
            return f"{name}:{'prefill' if args[0].shape[1] > 1 else 'decode'}"
        if name == "score_select":
            scoring = (kw.get("metadata", "cuboid"),
                       kw.get("group_reduce", "max"))
            return (name if scoring == ("cuboid", "max")
                    else f"{name}:mean" if scoring == ("mean", "max")
                    else f"{name}:sum")
        return name            # the rest: one case each

    def _wrap(self, name, fn):
        def wrapped(*args, **kw):
            # the wrapper's caller names the call site
            key = self._key(name, args, kw, sys._getframe(1).f_code.co_name)
            self.calls[key] = self.calls.get(key, 0) + 1
            if name in ("selective_scan", "wkv6"):
                by = self.shapes.setdefault(name, {})
                shape = f"{args[0].shape[0]}x{args[0].shape[1]}"
                by[shape] = by.get(shape, 0) + 1
            attn = self.calls.get("sparse_decode_attention", 0)
            # a decode token's cross-attention is kept from the middle
            # decode step, as the decode kernels are
            due = ((name == "flash_prefill"
                    and key != "flash_prefill:cross_decode")
                   or attn >= self.from_attn
                   or key in ("quant_save_blocks:prefill",
                              "selective_scan:prefill", "wkv6:prefill"))
            wider = (key in self.inputs
                     and ((key in self.WIDEST and attn < self.until_attn)
                          or key in self.WIDEST_ROWS)
                     and len(args[1]) > len(self.inputs[key][0][1]))
            if (due and (key not in self.inputs or wider)
                    and (self.keep is None or key in self.keep)):
                memo = {}
                self.inputs[key] = (
                    tuple(self._keep(a, memo) for a in args),
                    {k: self._keep(v, memo) for k, v in kw.items()})
            return fn(*args, **kw)
        return wrapped


def phase_mainpath(torch, ops, ref, timer, caps: dict,
                   device: bool = False) -> dict:
    """Replay the kept main-path launches of each serve path ({path:
    MainPathCapture}): {kernel: {case: result}}; ``device``: with each
    kernel's device ms per call (``run_case``)."""
    makers = {"sparse_decode_attention": case_attention,
              "block_score": case_score,
              "gather_blocks_hkv": case_gather,
              "scatter_blocks_hkv": case_scatter,
              "zero_blocks_hkv": case_zero,
              "score_select": case_select,
              "write_blocks_hkv": case_write,
              "flash_prefill": case_flash,
              "quantize_blocks": case_quantize,
              "dequantize_blocks": case_dequantize,
              "dequantize_scatter_blocks": case_dequant_scatter,
              "quant_save_blocks": case_quant_save,
              "selective_scan": case_scan,
              "wkv6": case_wkv}
    results = {}
    for path, cap in caps.items():
        for key, (args, kw) in sorted(cap.inputs.items()):
            name = key.split(":")[0]
            mode = key.split(":")[1] if ":" in key else ""
            label = f"path={path}" + (f" mode={mode}" if mode else "")
            # score_select's other scorings keep records of their own
            rec = key if key in KERNELS else name
            res = run_case("mainpath", label, rec,
                           makers[name](torch, ops, ref, *args, **kw), timer,
                           device=device)
            res["launches"] = cap.calls[key]
            results.setdefault(rec, {})[label] = res
            if key == "score_select" and args[0].shape[-1] <= 128:
                # block_score, no longer on the serve path, on the same
                # kept inputs: the redesigned scoring at the serve's shape
                # (it keeps D <= 128: not at MLA's latent width)
                res = run_case("mainpath", label + " mode=select_inputs",
                               "block_score",
                               case_score(torch, ops, ref, *args[:2]),
                               timer)
                res["launches"] = cap.calls.get("block_score", 0)
                results.setdefault("block_score", {})[
                    label + " mode=select_inputs"] = res
        missing = (set(FP_PATH) - {k.split(":")[0] for k in cap.inputs}
                   if cap.keep is None else set(cap.keep) - set(cap.inputs))
        if missing:
            raise AssertionError(f"{path}: no launch kept for {missing}")
    return results


def kernel_records(parity: dict, mainpath: dict, counts: dict) -> list:
    """The kernels' JSON record: times and bounds from the main-path
    replay of the path that owns the kernel (for a kernel with several
    cases there, the one with the most launches; every case is listed
    under "cases"), else from the qwen2-0.5b parity case; max_abs_err
    over every case.  ``counts``:
    {path: launches by kernel}; a kernel's ``launches`` come from the
    path that owns it (the int8 serve for INT8_ONLY, the quant trio and
    write_blocks_hkv; the transfer phase for the flat gather and scatter;
    the models phase's serve named in OWNERS for selective_scan, wkv6 and
    score_select's mean mode; the mesh phase's NCCL run at world 1 for
    block_score, its wide instance and the partial decode attention; the
    fp serve for the rest, score_select's sum mode included: it launches
    0 times there, and its times come from its parity lines)."""
    records = []
    for name in KERNELS:
        cases = mainpath.get(name) or parity.get(name, {})
        if not cases:
            continue
        owner = (OWNERS.get(name)
                 or ("transfer" if name in TRANSFER_PATH else "serve_int8"
                     if name in INT8_ONLY else "serve"))
        own = {label: r for label, r in {**parity.get(name, {}),
                                         **cases}.items()
               if f"path={owner}" in label.split()} or cases
        lead = max(own.values(), key=lambda r: r.get("launches", 0))
        every = list(parity.get(name, {}).values()) + list(
            mainpath.get(name, {}).values())
        rec = {
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            "launches": counts.get(owner, {}).get(name, 0),
            "max_abs_err": max(r["max_abs_err"] for r in every),
            "ms": lead["ms"], "plain_ms": lead["plain_ms"],
            "bound_ms": lead["bound_ms"], "bound_by": lead["bound_by"],
            "library_ms": lead["library_ms"],
            "launches_by_path": {path: c.get(name, 0)
                                 for path, c in counts.items()},
            "cases": {label: {k: r[k] for k in (
                "shape", "ms", "device_ms", "events_ms", "plain_ms",
                "bound_ms",
                "library_ms", "unfused_ms", "link_bound_ms", "binds",
                "per_block_copies_ms", "launches") if k in r}
                for label, r in {**cases, **own}.items()}}
        for key in ("link_bound_ms", "per_block_copies_ms"):
            if key in lead:
                rec[key] = lead[key]
        records.append(rec)
    return records


def _submit_all(eng, Request, cfg, np, seed: int, n: int, prompt: int,
                gen: int) -> list:
    """``n`` requests of ``prompt`` tokens from ``seed``, all arriving at
    0.0, each with the launcher's synthesized frontend tensors (none for
    a decoder-only config)."""
    from repro_torch.launch.serve import frontend_inputs
    rng = np.random.default_rng(seed)
    ids = []
    for _ in range(n):
        r = Request(prompt_len=prompt, max_new_tokens=gen, arrival_time=0.0)
        eng.submit(r, tokens=rng.integers(4, cfg.vocab_size, prompt)
                   .astype(np.int32), **frontend_inputs(cfg, rng))
        ids.append(r.req_id)
    return ids


def _serve_qwen2(torch, np, seed: int, n=None, gen_tokens=None,
                 **engine_kw):
    """The port's engine on qwen2-0.5b at full width, ``n`` (default 4) x
    4096-token prompts, ``gen_tokens`` (default 32) new tokens each,
    submitted (not yet run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    eng = ServingEngine(params, cfg, EngineConfig(seed=seed, **engine_kw))
    ids = _submit_all(eng, Request, cfg, np, seed, n or SERVE_REQUESTS,
                      SERVE_PROMPT, gen_tokens or SERVE_NEW)
    torch.cuda.synchronize()
    return eng, ids


def _serve_layers() -> int:
    from repro_torch.configs import get_config
    return get_config("qwen2-0.5b").num_layers


def _mid_decode_attn() -> int:
    """The attention launch that opens the serve's middle decode step
    (one launch per layer and step)."""
    return _serve_layers() * SERVE_NEW // 2


def _run_serve(torch, np, ops, seed: int, path: str, want: tuple,
               cap=None, inspect=None, **engine_kw) -> dict:
    """One full-width qwen2-0.5b serve (wall-clock charging), the launch
    counts set to 0 just before it and read just after; checks that every
    request finished with finite logits, that H2D restores and D2H saves
    happened, that every kernel of ``want`` launched, that the drop rounds
    (the engine's ``_drop_pending_evictions`` calls, counted here) took at
    most one zero_blocks_hkv launch each, that the decode select took at
    most two launches per attention launch and, with a capture, that no
    drop went through scatter_blocks_hkv; that quant_save_blocks launched
    at most once per layer save (the engine's ``flush_fused`` calls,
    counted here) and that no save went through the entries it replaced
    (OLD_SAVE, and with a capture gather_blocks_hkv from a flush).
    ``inspect(engine)`` runs last, before the engine closes.  Returns a
    summary."""
    eng, ids = _serve_qwen2(torch, np, seed, charge_real_time=True,
                            **engine_kw)
    drop_rounds = [0]
    drop = eng._drop_pending_evictions

    def counted_drop(*a, **kw):
        drop_rounds[0] += 1
        return drop(*a, **kw)
    eng._drop_pending_evictions = counted_drop
    layer_saves = [0]
    flush = eng.kv_mgr.flush_fused

    def counted_flush(*a, **kw):
        layer_saves[0] += 1
        return flush(*a, **kw)
    eng.kv_mgr.flush_fused = counted_flush
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    t0 = time.perf_counter()
    if cap is not None:
        with cap:
            m = eng.run()
    else:
        m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches.snapshot()
    for rid in ids:
        st = eng.states[rid]
        if len(st.out_tokens) != SERVE_NEW:
            raise AssertionError(f"{rid}: {len(st.out_tokens)} tokens")
        if not bool(torch.isfinite(st.last_logits).all()):
            raise AssertionError(f"{rid}: non-finite logits")
    missing = [k for k in want if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {path} path: "
                             f"{missing}")
    scatter_drops = None if cap is None else cap.calls.get(
        "scatter_blocks_hkv:drop", 0)
    log(f"phase={path} drop_rounds={drop_rounds[0]} zero_blocks_hkv="
        f"{counts['zero_blocks_hkv']} scatter_blocks_hkv:drop="
        f"{scatter_drops} score_select={counts['score_select']} "
        f"sparse_decode_attention={counts['sparse_decode_attention']}")
    if (counts["zero_blocks_hkv"] > drop_rounds[0] or scatter_drops
            or counts["score_select"]
            > 2 * counts["sparse_decode_attention"]):
        raise AssertionError(f"{path}: more drop or select launches than "
                             f"rounds or layer steps allow")
    old_save = {k: counts[k] for k in OLD_SAVE}
    if cap is not None:
        old_save.update({k: v for k, v in cap.calls.items()
                         if k.endswith("_flush")})
    log(f"phase={path} layer_saves={layer_saves[0]} quant_save_blocks="
        f"{counts['quant_save_blocks']} old_save_launches="
        + json.dumps(old_save))
    if (counts["quant_save_blocks"] > layer_saves[0]
            or any(old_save.values())):
        raise AssertionError(f"{path}: more quant_save_blocks launches than "
                             f"layer saves, or a save through the old "
                             f"entries")
    s = eng.metrics_snapshot()
    if s["kv.h2d_calls"] <= 0 or s["kv.d2h_calls"] <= 0:
        raise AssertionError(f"{path}: no H2D restore or no D2H save")
    wire = ((s["kv.h2d_bytes"] + s["kv.d2h_bytes"])
            / (s["kv.h2d_blocks"] + s["kv.d2h_blocks"]))
    log(f"phase={path} model=qwen2-0.5b layers={eng.cfg.num_layers} "
        f"requests={len(ids)} prompt={SERVE_PROMPT} new={SERVE_NEW} "
        f"finished={m.num_finished} wall_s={wall:.3f} "
        f"mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
        f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} "
        f"p99_tbt_ms={(m.p99_tbt or 0.0) * 1e3:.3f} "
        f"tok_per_s={m.token_throughput:.1f} iterations={eng.iterations} "
        f"wire_bytes_per_block={wire:.1f}")
    log(f"phase={path} transfer " + " ".join(
        f"{k}={v:.0f}" for k, v in s.items()
        if k.startswith(("kv.", "plane."))))
    log(f"phase={path} launches " + json.dumps(counts)
        + ("" if cap is None else " by case " + json.dumps(cap.calls)))
    log(f"phase={path} peak_mem_gb="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
    out = {"counts": counts, "ttft": m.mean_ttft, "wire": wire,
           "wall": wall, "tokens": [eng.states[r].out_tokens for r in ids],
           "contract": _contract_line(f"phase={path}", eng)}
    if inspect is not None:
        inspect(eng)
    eng.close()
    return out


def phase_serve(torch, np, ops, ref, seed: int) -> tuple:
    """The fp serve (kept launches in the returned MainPathCapture), and
    the TTFT before and after the flash_prefill kernel: after a short
    warm-up serve (one request, 2 new tokens), the same run with
    flash_prefill's plain version patched in, the kernel run (the main
    path, captured), the kernel run again, the plain run again.  Returns
    (the main run's summary, its capture)."""
    warm, _ = _serve_qwen2(torch, np, seed, n=1, gen_tokens=2,
                           charge_real_time=True)
    warm.run()
    torch.cuda.synchronize()
    del warm                    # its weights would count in the peaks
    kernel = ops.flash_prefill
    plain_want = tuple(n for n in FP_PATH if n != "flash_prefill")

    def run_plain(tag):
        ops.flash_prefill = lambda q, k, v, **kw: ref.flash_prefill(
            q, k, v, **kw)
        try:
            return _run_serve(torch, np, ops, seed, tag, plain_want)
        finally:
            ops.flash_prefill = kernel
    cap = MainPathCapture(torch, ops, _mid_decode_attn(),
                          layers=_serve_layers())
    plain = [run_plain("serve_plain_prefill_1")]
    fp = _run_serve(torch, np, ops, seed, "serve", FP_PATH, cap)
    again = _run_serve(torch, np, ops, seed, "serve_again", FP_PATH)
    plain.append(run_plain("serve_plain_prefill_2"))
    k_ttft = [fp["ttft"], again["ttft"]]
    p_ttft = [r["ttft"] for r in plain]
    log("phase=serve ttft_ms_kernel_prefill=" + ",".join(
        f"{t * 1e3:.2f}" for t in k_ttft)
        + " ttft_ms_plain_prefill=" + ",".join(
            f"{t * 1e3:.2f}" for t in p_ttft)
        + f" order=plain,kernel,kernel,plain "
        f"mean_kernel_ms={sum(k_ttft) / 2e-3:.2f} "
        f"mean_plain_ms={sum(p_ttft) / 2e-3:.2f}")
    return fp, cap


def phase_serve_int8(torch, np, ops, seed: int, fp: dict) -> tuple:
    """The same serve with offload_quant="int8" (kept saves, restores and
    int8 gathers in the returned MainPathCapture); its wire bytes per
    moved block must be >= 1.8x smaller than the fp serve's (``fp``'s)."""
    cap = MainPathCapture(torch, ops, _mid_decode_attn(), keep={
        "quant_save_blocks:decode", "quant_save_blocks:prefill",
        "dequantize_scatter_blocks", "gather_blocks_hkv:int8_restore",
        "gather_blocks_hkv:scales_restore"})
    q8 = _run_serve(torch, np, ops, seed, "serve_int8", INT8_PATH, cap,
                    offload_quant="int8")
    shrink = fp["wire"] / q8["wire"]
    log(f"phase=serve_int8 wire_bytes_per_block fp={fp['wire']:.1f} "
        f"int8={q8['wire']:.1f} shrink={shrink:.3f}")
    for i, (a, b) in enumerate(zip(fp["tokens"], q8["tokens"])):
        log(f"phase=serve_int8 request={i} first8_fp={a[:8]} "
            f"first8_int8={b[:8]}")
    if shrink < 1.8:
        raise AssertionError(f"int8 tier moved only {shrink:.3f}x fewer "
                             f"wire bytes per block than fp (needs 1.8x)")
    return q8, cap


def phase_profile(torch, np, seed: int, tier: str = "none") -> None:
    """The serve phase's run again under ``torch.profiler`` (``tier``
    "int8": the serve_int8 phase's run, its lines under
    ``phase=profile_int8``): device busy time (the sum of the device-side
    events' times; the port runs one stream) against the wall clock gives
    the device's idle share; the largest device consumers follow.  Not
    part of the default phases: the profiler slows the host, so its wall
    clock is not the serve phase's."""
    from torch.profiler import ProfilerActivity, profile
    tag = "profile" if tier == "none" else f"profile_{tier}"
    eng, ids = _serve_qwen2(torch, np, seed, charge_real_time=True,
                            offload_quant=tier)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # device-side events only (kernels, copies, memsets): a CPU op's
        # device time repeats that of the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((dev_us, e.count, e.key))
    busy = sum(r[0] for r in rows) / 1e6
    log(f"phase={tag} wall_s={wall:.3f} device_busy_s={busy:.3f} "
        f"idle_share={1.0 - busy / wall:.3f} "
        f"device_ops={sum(r[1] for r in rows)}")
    for dev_us, count, key in sorted(rows, reverse=True)[:12]:
        log(f"phase={tag} device_ms={dev_us / 1e3:.2f} calls={count} "
            f"kernel={key[:90]}")
    # the port's own kernels (the __global__ functions of csrc/)
    for dev_us, count, key in sorted(rows, reverse=True):
        name = key.split("(anonymous namespace)::")[-1].split("(")[0]
        if name.split("<")[0] in PORT_KERNEL_FNS:
            log(f"phase={tag} port_kernel={name} device_ms="
                f"{dev_us / 1e3:.2f} calls={count} "
                f"share_of_busy={dev_us / 1e6 / busy:.4f}")
    # what the run served, to compare two trees' serves in one call
    m = eng.metrics_snapshot()
    tokens = json.dumps([eng.states[r].out_tokens for r in ids])
    wire = ((m["kv.h2d_bytes"] + m["kv.d2h_bytes"])
            / (m["kv.h2d_blocks"] + m["kv.d2h_blocks"]))
    log(f"phase={tag} tokens_sha1="
        f"{hashlib.sha1(tokens.encode()).hexdigest()[:16]} "
        f"wire_bytes_per_block={wire:.1f}")
    eng.close()


def phase_async(torch, np, seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=4)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    for tier in ("none", "int8"):
        out = {}
        for mode in ("async", "sync"):
            eng = ServingEngine(params, cfg, EngineConfig(
                stage_dispatch=mode, seed=seed, offload_quant=tier))
            ids = _submit_all(eng, Request, cfg, np, seed, SERVE_REQUESTS,
                              SERVE_PROMPT, SERVE_NEW)
            eng.run()
            out[mode] = ([eng.states[r].out_tokens for r in ids],
                         dataclasses.asdict(eng.transfer_stats()))
        same = out["async"] == out["sync"]
        log(f"phase=async layers=4 offload_quant={tier} "
            f"tokens_identical={same} "
            f"h2d_calls={out['async'][1]['h2d_calls']} "
            f"d2h_calls={out['async'][1]['d2h_calls']} "
            f"h2d_bytes={out['async'][1]['h2d_bytes']}")
        if not same:
            raise AssertionError(f"async and sync engines disagree "
                                 f"(offload_quant={tier})")


def contract_mismatches(eng) -> list:
    """An engine's run against the plane contract
    (``repro_torch.core.plane_contract``): every mixed iteration's stage
    launches and fused transfers, and every decode plane's host syncs and
    stripe read-back.  Returns what differs (empty when the run meets
    it)."""
    from repro_torch.core import plane_contract as pc
    bad = (pc.mixed_launch_mismatches(eng.cfg, eng.mixed_iter_log,
                                      eng.eng.decode_write_back)
           if eng.hybrid is not None else [])
    planes = list(eng.planes.values())
    for plane in planes:
        bad.append(pc.host_sync_mismatch(eng.cfg, plane.host_syncs,
                                         plane.steps))
        if len(planes) == 1 and eng.eng.decode_write_back:
            bad.append(pc.stripe_readback_mismatch(plane, eng.decode_tokens))
    return [b for b in bad if b]


def _contract_line(tag: str, eng) -> dict:
    """The launch, host-sync and read-back budgets of a serve, checked
    and printed on one line; raises on a mismatch."""
    from repro_torch.core import plane_contract as pc
    from repro_torch.device import GUARD
    bad = contract_mismatches(eng)
    log_ = eng.mixed_iter_log
    out = {"mixed_iterations": len(log_),
           "launches": sum(e["launches"] for e in log_),
           "budget": sum(pc.mixed_launches_per_iteration(
               eng.cfg, e["decode_planes"], e["groups"], e["finalize"])
               for e in log_),
           "host_syncs": sum(p.host_syncs for p in eng.planes.values()),
           "steps": sum(p.steps for p in eng.planes.values()),
           "d2h_readback_bytes": sum(p.d2h_readback_bytes
                                     for p in eng.planes.values()),
           "guard": GUARD.snapshot(), "mismatches": len(bad)}
    log(f"{tag} contract " + json.dumps(out))
    if bad:
        raise AssertionError(f"{tag}: the run breaks the plane contract: "
                             f"{bad[:3]}")
    return out


def _sync_probe(torch) -> dict:
    """Which calls the dispatch window's guard flags on this card (the
    sync debug mode's "warn"): {call: flagged}."""
    from repro_torch.device import SyncInDispatchWindow, dispatch_window
    dev = torch.device("cuda")
    x = torch.ones(1 << 10, device=dev)
    pinned = torch.ones(1 << 10).pin_memory()
    pageable = torch.ones(1 << 10)
    ev = torch.cuda.Event()
    calls = {
        "item": lambda: x.sum().item(),
        "cpu": lambda: x.cpu(),
        "tolist": lambda: x[:4].tolist(),
        "nonzero": lambda: torch.nonzero(x),
        "pageable_h2d_copy_": lambda: x.copy_(pageable),
        "pinned_h2d_copy_non_blocking": lambda: x.copy_(
            pinned, non_blocking=True),
        "pinned_d2h_copy_non_blocking": lambda: pinned.copy_(
            x, non_blocking=True),
        "event_synchronize": lambda: (ev.record(), ev.synchronize()),
        "stream_synchronize": lambda: torch.cuda.current_stream()
        .synchronize(),
        "torch_cuda_synchronize": torch.cuda.synchronize,
    }
    out = {}
    for name, fn in calls.items():
        try:
            with dispatch_window(dev):
                fn()
            out[name] = False
        except SyncInDispatchWindow:
            out[name] = True
    torch.cuda.synchronize()
    return out


def phase_contract(torch, np, seed: int) -> None:
    """The plane contract on the card: the static pass over the port's
    tree exits 0 and flags each fixture by exactly its own rule; every
    guarded window of the run so far flagged no unwaived sync; a probe of
    which calls the guard flags; a short guarded serve (qwen2-0.5b at
    full width, CONTRACT_LAYERS layers) meets the launch, host-sync and
    read-back budgets; and two planted faults are each rejected by the
    check meant for it: a ``.item()`` in the dispatch window (the serve
    raises SyncInDispatchWindow) and one extra stage launch per iteration
    (the launch budget reports it).  Prints one JSON record."""
    import os
    from repro_torch.analysis.fixtures import FIXTURES
    from repro_torch.analysis.run import analyze
    from repro_torch.configs import get_config
    from repro_torch.core import plane_contract as pc
    from repro_torch.device import GUARD, SyncInDispatchWindow
    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    t0 = time.perf_counter()
    rec = {}
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.run"],
        capture_output=True, text=True, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    found = analyze(pc.DEFAULT_TARGET)
    rec["static"] = {"exit": cli.returncode, "findings": len(found),
                     "waived": sum(f.waived for f in found)}
    rec["fixtures"] = {name: sorted({f.rule for f in analyze(target)})
                       for name, (target, _) in FIXTURES.items()}
    wrong = [name for name, (_, rule) in FIXTURES.items()
             if rec["fixtures"][name] != ([rule] if rule else [])]
    rec["guard_so_far"] = GUARD.snapshot()
    rec["probe"] = _sync_probe(torch)
    cfg = dataclasses.replace(get_config("qwen2-0.5b"),
                              num_layers=CONTRACT_LAYERS)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed + 5), torch.bfloat16, "cuda")

    def serve(plant=None):
        eng = ServingEngine(params, cfg, EngineConfig(
            seed=seed, prefill_max_tokens_per_step=CONTRACT_CHUNK))
        _submit_all(eng, Request, cfg, np, seed, CONTRACT_REQUESTS,
                    CONTRACT_PROMPT, CONTRACT_NEW)
        if plant is not None:
            plant(eng)
        try:
            eng.run()
        finally:
            eng.close()
        return eng
    GUARD.reset()
    rec["serve"] = _contract_line("phase=contract", serve())
    rec["serve_guard"] = GUARD.snapshot()

    def plant_item(eng):
        stage = eng._stage_decode_layer

        def with_item(*a, **kw):
            torch.ones(1, device="cuda").sum().item()      # the fault
            return stage(*a, **kw)
        eng._stage_decode_layer = with_item

    def plant_launch(eng):
        walk = eng.hybrid.run_iteration

        def with_launch(params_, decode_jobs, prefill_jobs, layer_cb=None):
            res = walk(params_, decode_jobs, prefill_jobs, layer_cb)
            for job in decode_jobs[:1]:
                tokens, _ = job.plane.batch_inputs(job.token_by_req)
                M.decode_embed(params_, cfg, tokens)       # the fault
                job.plane.stage_launches += 1
            return res
        eng.hybrid.run_iteration = with_launch
    planted = {}
    try:
        serve(plant_item)
        planted["item_in_window"] = "not rejected"
    except SyncInDispatchWindow as e:
        planted["item_in_window"] = f"rejected: {str(e)[:80]}"
    try:
        _contract_line("phase=contract planted=extra_stage_launch",
                       serve(plant_launch))
        planted["extra_stage_launch"] = "not rejected"
    except AssertionError as e:
        planted["extra_stage_launch"] = f"rejected: {str(e)[:80]}"
    rec["planted"] = planted
    rec["seconds"] = round(time.perf_counter() - t0, 1)
    log("phase=contract " + json.dumps(rec) + f" card=[{_card()}]")
    if (cli.returncode or wrong or rec["guard_so_far"]["flagged"]
            or rec["serve_guard"]["flagged"]
            or not rec["serve_guard"]["windows"]
            or not rec["probe"]["item"]
            or any(not v.startswith("rejected") for v in planted.values())):
        raise AssertionError(f"contract: the static pass failed "
                             f"({cli.stdout[-300:]}), fixtures {wrong} "
                             f"flagged by other rules, a "
                             f"guarded window flagged a sync, or a planted "
                             f"fault was not rejected")


def _oracle_run(torch, np, ops, params, cfg, seed: int, gen: int,
                cap=None, force=None, pools=None, n: int = SERVE_REQUESTS,
                prompt: int = SERVE_PROMPT, **engine_kw) -> dict:
    """One oracle path at full width (wall-clock charging): the launch
    counts set to 0 and the device's peak memory reset just before the
    run, both read just after (the memory allocated before it, the
    weights once earlier engines are collected, is reported beside the
    peak); every request must finish with finite logits.  Keeps each
    request's logits at every sampled step (step 0: the prefill's token)
    and the batch of the decode attention that made them (the rows of its
    query, parked plane rows included; 0 at step 0).  ``cap``: a
    MainPathCapture active during the run.  ``force``: each request's
    tokens to feed in
    place of its own samples (teacher forcing: the logits of every step
    then compare with the run that made the tokens).  ``pools``: the
    decode pools each request's prefill built, as the decode plane admits
    them, per layer (K, V) over the prompt's tokens: recorded into an
    empty dict, else compared against it (the summary under
    ``pools_vs``).  ``n`` requests of ``prompt`` tokens."""
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    eng = ServingEngine(params, cfg, EngineConfig(
        seed=seed, charge_real_time=True, **engine_kw))
    ids = _submit_all(eng, Request, cfg, np, seed, n, prompt, gen)
    index = {rid: i for i, rid in enumerate(ids)}
    logits = {rid: [] for rid in ids}
    batches = {rid: [] for rid in ids}
    sample = eng._sample
    attn, attn_rows = ops.sparse_decode_attention, [0]

    def attn_counted(q, *a, **kw):
        attn_rows[0] = q.shape[0]
        return attn(q, *a, **kw)

    def recorded(st):
        rid = st.req.req_id
        logits[rid].append(st.last_logits[0].clone())
        batches[rid].append(attn_rows[0] if st.out_tokens else 0)
        if force is not None:
            return force[index[rid]][len(st.out_tokens)]
        return sample(st)
    eng._sample = recorded
    diffs = []
    if pools is not None:
        admit = eng.plane.admit
        record = not pools

        def admitted(rid, state):
            cur = int(state["cur_len"][0])
            kv = [tuple(c[n][0].flatten(1, 2)[:, :cur] for n in ("k", "v"))
                  for c in state["caches"]]
            if record:
                pools[index[rid]] = [(k.clone(), v.clone()) for k, v in kv]
            else:
                for (k, v), (k0, v0) in zip(kv, pools[index[rid]]):
                    got, want = torch.stack([k, v]), torch.stack([k0, v0])
                    diffs.append((torch.equal(got, want),
                                  _rel_l2(torch, got.float(), want.float()),
                                  float((got.float() - want.float())
                                        .abs().max())))
            return admit(rid, state)
        eng.plane.admit = admitted
    gc.collect()          # engines of earlier phases, kept by their cycles
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    ops.sparse_decode_attention = attn_counted
    try:
        if cap is not None:
            with cap:
                m = eng.run()
        else:
            m = eng.run()
    finally:
        ops.sparse_decode_attention = attn
    torch.cuda.synchronize()
    counts = ops.launches.snapshot()
    peak = torch.cuda.max_memory_allocated()
    # the wrappers' cycles would keep the pools alive
    del eng._sample
    eng.plane.__dict__.pop("admit", None)
    for rid in ids:
        st = eng.states[rid]
        if len(st.out_tokens) != gen or not bool(
                torch.isfinite(st.last_logits).all()):
            raise AssertionError(f"{engine_kw}: {rid} did not finish with "
                                 f"finite logits")
    out = {"eng": eng.eng, "metrics": m, "counts": counts,
           "stats": dataclasses.asdict(eng.transfer_stats()),
           "tokens": [eng.states[r].out_tokens for r in ids],
           "logits": [logits[r] for r in ids],
           "batches": [batches[r] for r in ids], "peak": peak,
           "base": base,
           "prefill_hbm_peak_tokens": eng.prefill_hbm_peak_tokens,
           "stack_calls": eng.stack_calls,
           "decode_step_calls": eng.decode_step_calls}
    if diffs:
        out["pools_vs"] = (sum(d[0] for d in diffs), len(diffs),
                           max(d[1] for d in diffs), max(d[2] for d in diffs))
    eng.close()
    return out


def _rel_l2(torch, got, want) -> float:
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want))


def _gemm_rows(torch, params) -> dict:
    """Does row 0 of a bf16 GEMM x[:n] @ W come out bit-identical to x[:1]
    @ W?  For each of the model's weight shapes (layer 0, lm head) and the
    decode batches n = 2..4: {weight: [n where it does not]}."""
    lay = params["layers"][0]
    ws = dict(lay["attn"], **lay["ffn"], lm_head=params["lm_head"])
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for name, w in ws.items():
        if w.dim() != 2:
            continue
        x = torch.randn((4, w.shape[0]), generator=gen, device="cuda",
                        dtype=w.dtype)
        one = x[:1] @ w
        out[name] = [n for n in (2, 3, 4) if not torch.equal(
            (x[:n] @ w)[:1], one)]
    return out


def _forced_check(torch, ops, path: str, r: dict, ref: dict, cfg) -> None:
    """A teacher-forced run ``r`` (fed ``ref``'s tokens) against ``ref``:
    the relative L2 of the logits at every step and, for each request, the
    first step that differs, with the decode attention's batch at that
    step in both runs and its split-K splits at those batches, which must
    differ there: rounding enters only where the attention's splits do."""
    errs = [[_rel_l2(torch, g, w) for g, w in zip(gs, ws)]
            for gs, ws in zip(r["logits"], ref["logits"])]
    top1 = sum(int(g.argmax()) == int(w.argmax())
               for gs, ws in zip(r["logits"], ref["logits"])
               for g, w in zip(gs, ws))
    steps = max(len(e) for e in errs)
    by_step = [max(e[t] for e in errs if t < len(e)) for t in range(steps)]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    first = []
    for i, e in enumerate(errs):
        t = next((t for t, x in enumerate(e) if x > 0), None)
        if t is None:
            first.append(None)
            continue
        bats = [r["batches"][i][t], ref["batches"][i][t]]
        first.append({"step": t, "rel_l2": float(f"{e[t]:.3e}"),
                      "batch": bats, "splits": [
                          ops.decode_splits(b, cfg.num_kv_heads,
                                            cfg.dsa.top_k_blocks, sms)
                          if b else None for b in bats]})
    log(f"phase=oracles path={path} forced=mixed_tokens "
        f"max_rel_l2={max(by_step):.3e} "
        f"top1_agree={top1}/{sum(len(e) for e in errs)} "
        f"first_differing_step_by_request(batch,splits: {path},mixed)="
        + json.dumps(first))
    log(f"phase=oracles path={path} forced=mixed_tokens "
        f"rel_l2_by_step=" + ",".join(f"{x:.2e}" for x in by_step))
    if any(f is not None and f["splits"][0] == f["splits"][1]
           for f in first):
        raise AssertionError(f"oracles: {path} fed mixed's tokens first "
                             f"differs from mixed at a step whose "
                             f"attention splits are mixed's")


def _pinned_check(torch, np, ops, params, cfg, seed: int) -> None:
    """The paths of FORCED_PATHS and mixed again with the split-K
    attention's splits pinned to those of SERVE_REQUESTS rows, whatever
    the batch: each must then give mixed's tokens and mixed's logits bit
    for bit at every step, so the state each path carries from step to
    step is mixed's, and the split count is all that parts them."""
    splits = ops.decode_splits
    pinned = splits(SERVE_REQUESTS, cfg.num_kv_heads, cfg.dsa.top_k_blocks,
                    torch.cuda.get_device_properties(0).multi_processor_count)
    ops.decode_splits = lambda B, Hkv, K, sms, tiles=1: pinned
    try:
        want = None
        for path in ("mixed",) + FORCED_PATHS:
            kw = ORACLE_PATHS[path][0]
            r = _oracle_run(torch, np, ops, params, cfg, seed, SERVE_NEW,
                            **kw)
            if want is None:
                want = r
                continue
            same = [sum(torch.equal(g, w) for g, w in zip(gs, ws))
                    for gs, ws in zip(r["logits"], want["logits"])]
            log(f"phase=oracles path={path} pinned_splits={pinned} "
                f"tokens_identical_to_mixed={r['tokens'] == want['tokens']} "
                f"bit_identical_logit_steps={sum(same)}/"
                f"{sum(len(x) for x in want['logits'])}")
            if r["tokens"] != want["tokens"] or sum(same) != sum(
                    len(x) for x in want["logits"]):
                raise AssertionError(f"oracles: with the attention's splits "
                                     f"pinned, {path} is not mixed bit for "
                                     f"bit")
    finally:
        ops.decode_splits = splits


def phase_oracles(torch, np, ops, seed: int) -> tuple:
    """The engine's oracle paths (ORACLE_PATHS) at qwen2-0.5b's full width,
    the serve phase's submissions on bf16 weights from ``seed``.  Asserts
    split == mixed token for token on both tiers and persistent == mixed
    (the staged plane) on the fp tier: the same kernels at the same shapes
    with all requests arriving at 0.0.  Every other path changes GEMM or
    attention shapes (B = 1 prefill or decode, the stacked pool's block
    count, the chunked attention split), so its logits are held against
    the mixed run's at the first step whose computation differs (step 0,
    the first token, for the prefill paths; step 1, the first decode step,
    for the decode paths, whose first tokens equal mixed's by
    construction) to a relative L2 error of ORACLE_REL_L2, and that
    tolerance must be under half the distance between two requests'
    logits.  The fp paths of FORCED_PATHS run again fed the mixed run's
    tokens (``_forced_check``: where each request's logits first part from
    mixed's, which must be a step where the attention's split count
    differs), and again with that split count pinned (``_pinned_check``:
    mixed's tokens and logits bit for bit at every step), so a fault in
    the state a path carries from step to step cannot hide behind its
    first step's agreement.  The decode pools
    that the split, legacy and chunked prefills build are compared with
    the mixed prefill's.  Each path must launch its ORACLE_WANT kernels.
    Prints one line per path; returns ({path: launches by kernel},
    {path: MainPathCapture of the kernels at shapes no serve gives them,
    for phase_mainpath})."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    cfg = get_config("qwen2-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    log("phase=oracles gemm_row0_differs_from_B1_at_batches="
        + json.dumps(_gemm_rows(torch, params)))
    _oracle_run(torch, np, ops, params, cfg, seed, 2)     # warm-up
    runs, counts, caps, pools = {}, {}, {}, {}
    t_phase = time.perf_counter()
    for path, (kw, want, ref_path, step) in ORACLE_PATHS.items():
        t0 = time.perf_counter()
        keep = ORACLE_KEEP.get(path)
        cap = None if keep is None else MainPathCapture(
            torch, ops, _mid_decode_attn(), keep=set(keep),
            layers=_serve_layers())
        r = runs[path] = _oracle_run(
            torch, np, ops, params, cfg, seed, SERVE_NEW, cap=cap,
            pools=pools if path in POOL_PATHS else None, **kw)
        if cap is not None:
            caps[f"oracles_{path}"] = cap
        counts[f"oracles_{path}"] = r["counts"]
        ref = runs[ref_path]
        agree = sum(a == b[:len(a)] for a, b in zip(r["tokens"],
                                                    ref["tokens"]))
        m, s = r["metrics"], r["stats"]
        log(f"phase=oracles path={path} "
            f"config={json.dumps({k: v for k, v in kw.items()})} "
            f"resolved=hybrid_plane:{r['eng'].hybrid_plane},drop:"
            f"{r['eng'].drop_evicted_device_blocks} new={SERVE_NEW} "
            f"wall_s={time.perf_counter() - t0:.3f} "
            f"mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
            f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} "
            f"tok_per_s={m.token_throughput:.1f} "
            f"h2d_calls={s['h2d_calls']} h2d_bytes={s['h2d_bytes']} "
            f"d2h_calls={s['d2h_calls']} d2h_bytes={s['d2h_bytes']} "
            f"peak_mem_gb={r['peak'] / 1e9:.3f} "
            f"weights_gb={r['base'] / 1e9:.3f} "
            f"prefill_hbm_peak_tokens={r['prefill_hbm_peak_tokens']} "
            f"stack_calls={r['stack_calls']} "
            f"decode_step_calls={r['decode_step_calls']} "
            f"requests_agreeing_with_{ref_path}={agree}/{len(r['tokens'])}"
            f" first8={[t[:8] for t in r['tokens']]}")
        log(f"phase=oracles path={path} launches " + json.dumps(r["counts"]))
        missing = [k for k in want if r["counts"][k] == 0]
        if missing:
            raise AssertionError(f"oracles: kernels not launched on the "
                                 f"{path} path: {missing}")
        if "pools_vs" in r:
            same, n, rel, mx = r["pools_vs"]
            log(f"phase=oracles path={path} decode_pools_vs_mixed "
                f"identical_layers={same}/{n} max_rel_l2={rel:.3e} "
                f"max_abs={mx:.3e}")
            if rel > ORACLE_REL_L2:
                raise AssertionError(f"oracles: {path} prefill built decode "
                                     f"pools outside the tolerance")
        if path in FORCED_PATHS:
            forced = _oracle_run(torch, np, ops, params, cfg, seed,
                                 SERVE_NEW, force=runs["mixed"]["tokens"],
                                 **kw)
            _forced_check(torch, ops, path, forced, runs["mixed"], cfg)
        if step is None:
            if path != ref_path and r["tokens"] != ref["tokens"]:
                raise AssertionError(f"oracles: {path} tokens differ from "
                                     f"{ref_path}'s")
            continue
        errs = [_rel_l2(torch, got[step], want_[step])
                for got, want_ in zip(r["logits"], ref["logits"])]
        sep = min(_rel_l2(torch, ref["logits"][i][step],
                          ref["logits"][(i + 1) % len(errs)][step])
                  for i in range(len(errs)))
        top1 = sum(int(g[step].argmax()) == int(w[step].argmax())
                   for g, w in zip(r["logits"], ref["logits"]))
        max_abs = max(float((g[step] - w[step]).abs().max())
                      for g, w in zip(r["logits"], ref["logits"]))
        log(f"phase=oracles path={path} logits_step={step} "
            f"rel_l2={','.join(f'{e:.3e}' for e in errs)} "
            f"max_abs={max_abs:.3e} tol={ORACLE_REL_L2:.3e} "
            f"min_rel_l2_between_requests={sep:.3e} "
            f"top1_agree={top1}/{len(errs)}")
        if max(errs) > ORACLE_REL_L2 or sep <= 2 * ORACLE_REL_L2:
            raise AssertionError(f"oracles: {path} logits outside the "
                                 f"tolerance, or a tolerance that does not "
                                 f"tell requests apart")
    _pinned_check(torch, np, ops, params, cfg, seed)
    del params, runs, pools
    _oracle_mla(torch, np, ops, seed, counts)
    log(f"phase=oracles seconds={time.perf_counter() - t_phase:.1f}")
    return counts, caps


def _oracle_mla(torch, np, ops, seed: int, counts: dict) -> None:
    """split == mixed token for token at MLA: ORACLE_MLA_ARCH at full
    width and depth, bf16 weights from ``seed``, the serve phase's
    submissions with ORACLE_MLA_NEW new tokens, the fp tier; the HBM
    budget the device memory left after the weights (the default cannot
    admit one of its requests: its geometry counts the latent over 40
    heads, _hbm_budget).  Both paths must launch FP_PATH's kernels."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    _free_memory(torch)
    cfg = get_config(ORACLE_MLA_ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    budget = int(torch.cuda.mem_get_info()[0])
    runs = {}
    for path, kw in (("mixed", {}), ("split", {"hybrid_plane": "split"})):
        t0 = time.perf_counter()
        r = runs[path] = _oracle_run(torch, np, ops, params, cfg, seed,
                                     ORACLE_MLA_NEW,
                                     hbm_budget_bytes=budget, **kw)
        counts[f"oracles_{ORACLE_MLA_ARCH}_{path}"] = r["counts"]
        m = r["metrics"]
        log(f"phase=oracles arch={ORACLE_MLA_ARCH} path={path} "
            f"layers={cfg.num_layers} new={ORACLE_MLA_NEW} "
            f"wall_s={time.perf_counter() - t0:.3f} "
            f"mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
            f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} "
            f"first8={[t[:8] for t in r['tokens']]} card=[{_card()}]")
        log(f"phase=oracles arch={ORACLE_MLA_ARCH} path={path} launches "
            + json.dumps(r["counts"]))
        missing = [k for k in FP_PATH if r["counts"][k] == 0]
        if missing:
            raise AssertionError(f"oracles: kernels not launched on "
                                 f"{ORACLE_MLA_ARCH}'s {path} path: "
                                 f"{missing}")
    agree = sum(a == b for a, b in zip(runs["split"]["tokens"],
                                       runs["mixed"]["tokens"]))
    log(f"phase=oracles arch={ORACLE_MLA_ARCH} split_vs_mixed "
        f"requests_agreeing={agree}/{len(runs['mixed']['tokens'])}")
    if runs["split"]["tokens"] != runs["mixed"]["tokens"]:
        raise AssertionError(f"oracles: {ORACLE_MLA_ARCH}'s split tokens "
                             f"differ from mixed's")
    del params, runs
    _free_memory(torch)


def _logits_bar(torch, path: str, ref_path: str, r: dict, ref: dict,
                step: int, tag: str) -> None:
    """``r``'s logits at ``step`` against ``ref``'s, request by request,
    within a tolerance under half the distance between two requests'
    logits of ``ref``: ORACLE_REL_L2, halved until it is (a random model
    can give every request nearly the same logits, whisper-small's past
    its 448-token context; the bar then only tightens).  Prints one
    line."""
    errs = [_rel_l2(torch, got[step], want[step])
            for got, want in zip(r["logits"], ref["logits"])]
    sep = min(_rel_l2(torch, ref["logits"][i][step],
                      ref["logits"][(i + 1) % len(errs)][step])
              for i in range(len(errs)))
    tol = ORACLE_REL_L2
    while sep <= 2 * tol and tol > 0.0:
        tol /= 2
    top1 = sum(int(g[step].argmax()) == int(w[step].argmax())
               for g, w in zip(r["logits"], ref["logits"]))
    max_abs = max(float((g[step] - w[step]).abs().max())
                  for g, w in zip(r["logits"], ref["logits"]))
    log(f"{tag} path={path} vs={ref_path} logits_step={step} "
        f"rel_l2={','.join(f'{e:.3e}' for e in errs)} "
        f"max_abs={max_abs:.3e} tol={tol:.3e} "
        f"min_rel_l2_between_requests={sep:.3e} "
        f"top1_agree={top1}/{len(errs)}")
    if max(errs) > tol:
        raise AssertionError(f"{tag}: {path} logits outside the tolerance "
                             f"against {ref_path}")


def _family_oracles(torch, np, ops, ref, arch: str, cfg, params,
                    seed: int) -> dict:
    """The oracle paths FAMILY_ORACLES names for ``arch``, at full width on
    the models phase's weights cut to the table's depth, FAMILY_REQUESTS
    requests of FAMILY_PROMPT tokens and FAMILY_NEW new tokens, all
    arriving at 0.0 (the launch counts set to 0 before each run, read
    after), each held as phase_oracles holds the path at qwen2-0.5b:
    split and persistent give mixed's tokens; stacked and sequential
    mixed's logits at step 1, legacy and chunked at step 0, within
    ORACLE_REL_L2, tightened where the requests' logits lie close
    (_logits_bar); each path launches its ORACLE_PATHS kernels (wkv6
    alone for RWKV6, selective_scan besides for the hybrid).  MLA's
    chunked baseline must raise NotImplementedError, as the reference's
    does.  A frontend config's chunked baseline embeds the prompt tokens
    alone and runs no cross-attention (the reference's), so its logits
    are held against the same path with ``ops.flash_prefill`` replaced by
    its plain version (ref.flash_prefill, float32 inside).  Returns
    {path: launches by kernel}."""
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    layers, paths = FAMILY_ORACLES[arch]
    tag = f"phase=models arch={arch} oracle"
    published = get_config(MODEL_VARIANTS.get(arch, (arch,))[0]).num_layers
    red = (MODEL_NOTES.get(arch, "")
           + f" reduced=num_layers:{layers}/{published}")
    cfg = dataclasses.replace(cfg, num_layers=layers)
    params = dict(params, layers=params["layers"][:layers])
    subs = [(Request(prompt_len=FAMILY_PROMPT, max_new_tokens=FAMILY_NEW),
             None, None)] * FAMILY_REQUESTS
    budget, _ = _hbm_budget(torch, cfg, subs, EngineConfig().hbm_budget_bytes)
    runs, counts = {}, {}
    base = ("wkv6",) if cfg.attention_type == "none" else ()
    for path in ("mixed",) + paths:
        kw, want, ref_path, step = ORACLE_PATHS[path]
        if path == "chunked" and cfg.attention_type == "mla":
            try:
                ServingEngine(params, cfg, EngineConfig(**kw))
            except NotImplementedError as e:
                log(f"{tag} path=chunked raises NotImplementedError as the "
                    f"reference does: {e}" + red)
                continue
            raise AssertionError(f"{tag}: MLA's chunked baseline ran")
        t0 = time.perf_counter()
        r = runs[path] = _oracle_run(
            torch, np, ops, params, cfg, seed, FAMILY_NEW,
            n=FAMILY_REQUESTS, prompt=FAMILY_PROMPT,
            hbm_budget_bytes=budget, **kw)
        counts[f"models_{arch}_oracle_{path}"] = r["counts"]
        m = r["metrics"]
        log(f"{tag} path={path} config={json.dumps(kw)} layers={layers} "
            f"requests={FAMILY_REQUESTS} prompt={FAMILY_PROMPT} "
            f"new={FAMILY_NEW} wall_s={time.perf_counter() - t0:.3f} "
            f"mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
            f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} "
            f"h2d_calls={r['stats']['h2d_calls']} "
            f"d2h_calls={r['stats']['d2h_calls']} "
            f"first8={[t[:8] for t in r['tokens']]} card=[{_card()}]" + red)
        log(f"{tag} path={path} launches " + json.dumps(r["counts"]))
        need = base or (want + (("selective_scan",)
                                if cfg.arch_type == "hybrid" else ()))
        missing = [k for k in need if r["counts"].get(k, 0) == 0]
        if missing:
            raise AssertionError(f"{tag}: kernels not launched on the "
                                 f"{path} path: {missing}")
        if path == "mixed":
            continue
        if path == "chunked" and (cfg.frontend != "none"
                                  or cfg.is_encoder_decoder):
            flash = ops.flash_prefill
            ops.flash_prefill = ref.flash_prefill
            try:
                plain = _oracle_run(
                    torch, np, ops, params, cfg, seed, FAMILY_NEW,
                    n=FAMILY_REQUESTS, prompt=FAMILY_PROMPT,
                    hbm_budget_bytes=budget, **kw)
            finally:
                ops.flash_prefill = flash
            _logits_bar(torch, path, "chunked_plain_attention", r, plain, 0,
                        tag)
            continue
        if step is None:
            same = r["tokens"] == runs[ref_path]["tokens"]
            log(f"{tag} path={path} tokens_identical_to_{ref_path}={same}"
                + red)
            if not same:
                raise AssertionError(f"{tag}: {path} tokens differ from "
                                     f"{ref_path}'s")
            continue
        _logits_bar(torch, path, ref_path, r, runs[ref_path], step, tag)
    return counts


def _card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
            else f"nvidia-smi failed: {smi.stderr.strip()}")


def _free_memory(torch) -> None:
    """Return what the last engine held: device memory to the card, and
    the pinned host pools cached by PyTorch's host allocator (where the
    build has the call) to the host."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    getattr(torch._C, "_host_emptyCache", lambda: None)()


def _model_submissions(np, Request, cfg, arch: str, seed: int) -> list:
    """(Request, prompt token ids, frontend tensors) of the models phase
    for ``arch``: the port's LongBench-shaped trace (MODEL_RATE req/s,
    Poisson arrivals, the config's caps), or the one long request at
    arrival 0.0; the frontend tensors are the launcher's synthesized ones
    (internvl2-2b's 256 patch embeddings, whisper-small's 1500 frames,
    float32 from the seed), {} for a decoder-only config."""
    from repro_torch.launch.serve import frontend_inputs
    from repro_torch.serving.trace import TraceConfig, generate_trace
    spec = MODEL_RUNS[arch][1]
    if spec is None:
        reqs = [Request(prompt_len=LONG_PROMPT, max_new_tokens=LONG_NEW,
                        arrival_time=0.0)]
    else:
        n, cap, new = spec
        reqs = generate_trace(TraceConfig(
            request_rate=MODEL_RATE, num_requests=n, max_prompt_len=cap,
            max_new_tokens=new, seed=seed))
    rng = np.random.default_rng(seed)
    return [(r, rng.integers(4, cfg.vocab_size, r.prompt_len)
             .astype(np.int32), frontend_inputs(cfg, rng)) for r in reqs]


def _hbm_budget(torch, cfg, subs, default: int) -> tuple:
    """Algorithm 1's HBM budget for one config: the default unless the
    largest working set one request can claim exceeds it: its
    layer-segmented prefill (one layer of its prompt, a VLM's patches
    counted in) or a decode window's
    union (the scheduler's 12 steps of top-k blocks, at most every block,
    in every layer), bf16 K and V (MLA: the latent, counted over
    max(num_kv_heads, 1) heads as the engine's geometry counts it).  Then
    a request the default could never admit gets the device memory left
    after the weights.  Returns (budget, that largest working set)."""
    from repro_torch.core.kv_cache import KVGeometry
    geom = KVGeometry.of_model(cfg)
    bs = geom.block_size
    per_block_layer = geom.block_bytes_per_head * geom.num_kv_heads
    worst = 0
    patches = cfg.num_patches if cfg.frontend == "vit_patch_stub" else 0
    for r, _, _ in subs:
        prompt = r.prompt_len + patches
        nb = -(-(prompt + r.max_new_tokens) // bs) + 1
        # in every attention layer (a hybrid's Mamba layers hold no KV)
        worst = max(worst, prompt * per_block_layer // bs,
                    min(nb, 12 * cfg.dsa.top_k_blocks) * geom.num_layers
                    * per_block_layer)
    if worst <= default:
        return default, worst
    return int(torch.cuda.mem_get_info()[0]), worst


def _serve_model(torch, np, ops, arch: str, seed: int, caps: dict,
                 requests=None, tag: str = "models", inspect=None,
                 obs: bool = False, family=None) -> dict:
    """One models-phase serve of ``arch`` at full width (MODEL_RUNS; its
    first ``requests`` submissions when given, obs on with ``obs``),
    bf16 random weights from ``seed``, the default EngineConfig with
    wall-clock charging (the budget of _hbm_budget where the default
    cannot admit a request), the launch counts set to 0 just before the
    run and read just after; on each tier MODEL_RUNS names, from the same
    weights and submissions.  Asserts that every request was admitted and
    finished with finite logits and that every kernel of the config's
    path launched (for a hybrid also selective_scan, and that the host
    stage of a decode-only iteration ran at the attention layers only);
    keeps one launch of each MODEL_RUNS kernel of the first tier for
    phase_mainpath (into ``caps``); ``inspect(engine)`` runs last,
    before the engine closes.  With ``family`` (the plain versions'
    module, ``ref``) the config's FAMILY_ORACLES paths run last on the
    same weights (_family_oracles).  Returns a summary ({"counts",
    "mixed"} of the first tier; "counts_<tier>" of any other; "family":
    the oracle paths' launches)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    tiers, _, keep = MODEL_RUNS[arch]
    tiers = (tiers,) if isinstance(tiers, str) else tiers
    base, dsa = MODEL_VARIANTS.get(arch, (arch, {}))
    cfg = get_config(base)
    if dsa:
        cfg = dataclasses.replace(cfg, dsa=dataclasses.replace(cfg.dsa,
                                                               **dsa))
    red = MODEL_NOTES.get(arch, "")
    if arch in MODEL_LAYERS:
        red += f" reduced=num_layers:{MODEL_LAYERS[arch]}/{cfg.num_layers}"
        cfg = dataclasses.replace(cfg, num_layers=MODEL_LAYERS[arch])
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda")
                           .manual_seed(seed), torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated()
    out = {}
    for tier in tiers:
        out.update(_serve_tier(torch, np, ops, arch, cfg, params, tier,
                               tier == tiers[0], seed, caps, requests, tag,
                               inspect, obs, weights, t0, red, keep))
        t0 = time.perf_counter()
    if family is not None and arch in FAMILY_ORACLES:
        out["family"] = _family_oracles(torch, np, ops, family, arch, cfg,
                                        params, seed)
    return out


def _serve_tier(torch, np, ops, arch, cfg, params, tier, first, seed, caps,
                requests, tag, inspect, obs, weights, t0, red, keep) -> dict:
    """One tier's serve of _serve_model (``first``: keep its launches
    for phase_mainpath)."""
    from repro_torch.models import ffn
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.request import Request
    subs = _model_submissions(np, Request, cfg, arch, seed)[:requests]
    default = EngineConfig().hbm_budget_bytes
    budget, worst = _hbm_budget(torch, cfg, subs, default)
    eng = ServingEngine(params, cfg, EngineConfig(
        seed=seed, charge_real_time=True, offload_quant=tier,
        hbm_budget_bytes=budget, obs=obs))
    for r, toks, extra in subs:
        eng.submit(r, tokens=toks, **extra)
    pinned = sum(t.numel() * t.element_size()
                 for pool in eng.kv_mgr.pools.values()
                 for t in (pool.k, pool.v, pool.k_scale, pool.v_scale)
                 if t is not None)
    setup_s = time.perf_counter() - t0
    new = max(r.max_new_tokens for r, _, _ in subs)
    n_attn = cfg.num_attention_layers()
    cap = MainPathCapture(torch, ops, n_attn * (new // 2),
                          keep=set(keep) if first else set(), layers=n_attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    ffn.moe_stats.reset()
    t0 = time.perf_counter()
    with cap:
        m = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launches.snapshot()
    moe = ffn.moe_stats.snapshot()
    peak = torch.cuda.max_memory_allocated()
    unfinished = [r.req_id for r, _, _ in subs if r.finish_time is None]
    if unfinished:
        raise AssertionError(f"{tag}: {arch}: requests never admitted or "
                             f"not finished: {unfinished} (HBM budget "
                             f"{budget}, largest working set {worst})")
    for r, _, _ in subs:
        st = eng.states[r.req_id]
        if (len(st.out_tokens) != r.max_new_tokens
                or not bool(torch.isfinite(st.last_logits).all())):
            raise AssertionError(f"{tag}: {arch}: {r.req_id} gave "
                                 f"{len(st.out_tokens)} tokens or "
                                 f"non-finite logits")
    if cfg.attention_type == "none":
        want = ("wkv6",)                     # RWKV6: no attention layer
    else:
        want = (INT8_PATH if tier == "int8" else FP_PATH) + (
            ("selective_scan",) if cfg.arch_type == "hybrid" else ()) + (
            ("score_select:mean",) if cfg.dsa.metadata == "mean" else ())
    missing = [k for k in want if counts.get(k, 0) == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels not launched on {arch}'s "
                             f"path: {missing}")
    mixed = sum(1 for e in eng.mixed_iter_log
                if e["decode_rows"] and e["prefill_rows"])
    s = eng.metrics_snapshot()
    moved = s["kv.h2d_blocks"] + s["kv.d2h_blocks"]
    wire = (f"{(s['kv.h2d_bytes'] + s['kv.d2h_bytes']) / moved:.1f}"
            if moved else "n/a(no_block_moved)")
    p99 = m.p99_tbt
    log(f"phase={tag} arch={arch} layers={cfg.num_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        + (f"attention=mla latent={cfg.kv_cache_dim} "
           f"qk={cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim} "
           f"v={cfg.mla.v_head_dim} " if cfg.attention_type == "mla"
           else f"attention=none rwkv_heads={cfg.d_model // cfg.rwkv_head_dim}"
           f"x{cfg.rwkv_head_dim} d_ff={cfg.d_ff} "
           if cfg.attention_type == "none"
           else f"head_dim={cfg.head_dim} ")
        + (f"dsa_metadata={cfg.dsa.metadata} "
           if cfg.dsa.metadata != "cuboid" else "")
        + (f"experts={cfg.num_experts} top_k={cfg.top_k_experts} "
           f"d_ff={cfg.d_ff} dense_residual={cfg.moe_dense_residual} "
           if cfg.num_experts else "")
        + (f"frontend={cfg.frontend} patches={cfg.num_patches} "
           if cfg.frontend == "vit_patch_stub" else "")
        + (f"encoder_layers={cfg.encoder_layers} "
           f"frames={cfg.encoder_seq_len} decode_planes={len(eng.planes)} "
           f"prefill_planes={len(eng.prefill_planes)} "
           if cfg.is_encoder_decoder else "")
        + f"offload_quant={tier} "
        f"requests={len(subs)} "
        f"prompts={[r.prompt_len for r, _, _ in subs]} "
        f"new={[r.max_new_tokens for r, _, _ in subs]} "
        f"arrivals_s={[round(r.arrival_time, 4) for r, _, _ in subs]} "
        f"finished={m.num_finished} setup_s={setup_s:.1f} wall_s={wall:.3f}"
        + red)
    log(f"phase={tag} arch={arch} mean_ttft_ms={m.mean_ttft * 1e3:.2f} "
        f"mean_tbt_ms={m.mean_tbt * 1e3:.3f} p99_tbt_ms="
        + (f"{p99 * 1e3:.3f}" if p99 is not None else "n/a(<10 samples)")
        + f" tok_per_s={m.token_throughput:.2f} "
        f"iterations={eng.iterations} mixed_iterations={mixed} "
        f"weights_gb={weights / 1e9:.3f} peak_mem_gb={peak / 1e9:.3f} "
        f"pinned_host_gb={pinned / 1e9:.3f} hbm_budget_bytes={budget} "
        f"(default {default}, largest working set {worst}) "
        f"h2d_bytes={s['kv.h2d_bytes']:.0f} d2h_bytes={s['kv.d2h_bytes']:.0f}"
        f" wire_bytes_per_block={wire} offload_quant={tier}"
        f" hits={s['kv.hits']:.0f} misses={s['kv.misses']:.0f} card="
        f"[{_card()}]" + red)
    log(f"phase={tag} arch={arch} launches " + json.dumps(counts)
        + " by case " + json.dumps(cap.calls) + red)
    # the greedy tokens served, in submission order, to compare two trees
    tokens = json.dumps([eng.states[r.req_id].out_tokens for r, _, _ in subs])
    log(f"phase={tag} arch={arch} offload_quant={tier} tokens_sha1="
        f"{hashlib.sha1(tokens.encode()).hexdigest()[:16]}" + red)
    if cfg.num_experts:
        _moe_check(tag, arch, cfg, eng, moe, red)
    if cfg.arch_type == "hybrid" or cfg.attention_type == "none":
        _recurrent_check(tag, arch, cfg, eng, counts, red, cap.shapes)
    if first:
        caps[f"{tag}_{arch}"] = cap
    if inspect is not None:
        inspect(eng)
    eng.close()
    if first:
        return {"counts": counts, "mixed": mixed}
    return {f"counts_{tier}": counts}


def _recurrent_check(tag: str, arch: str, cfg, eng, counts: dict,
                     red: str, shapes: dict) -> None:
    """A recurrent serve's own numbers (a hybrid's Mamba layers, RWKV6's
    every layer): the recurrent layers' scans (a prefill group's or a
    decode step's, one selective_scan or wkv6 launch each, counted by
    (B, S) and written to chiprun_out/launch_shapes_<tag>_<arch>.json for
    ``ab_kernels.py --shapes``) and the host stages.  A decode-only
    iteration's host stage must run at the attention layers only (one
    per attention layer: no select, no idx copy and no host stage at a
    recurrent layer; none at all for RWKV6)."""
    attn = sorted(i for i in range(cfg.num_layers)
                  if cfg.is_attention_layer(i))
    scan = "wkv6" if cfg.attention_type == "none" else "selective_scan"
    decode_only = [e for e in eng.mixed_iter_log
                   if e["decode_rows"] and not e["prefill_rows"]]
    stages = sorted({len(e["layers"]) for e in decode_only})
    log(f"phase={tag} arch={arch} recurrent attention_layers={attn} "
        f"recurrent_layers={cfg.num_layers - len(attn)} "
        f"{scan}_launches={counts[scan]} "
        f"{scan}_launch_shapes={json.dumps(shapes.get(scan, {}))} "
        f"decode_only_iterations={len(decode_only)} "
        f"host_stages_per_decode_step={stages} "
        f"host_syncs={sum(p.host_syncs for p in eng.planes.values())}"
        + red)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"launch_shapes_{tag}_{arch}.json").write_text(json.dumps(
        {"kernel": scan, "arch": arch, "shapes": shapes.get(scan, {})}))
    bad = [e["layers"] for e in decode_only if sorted(e["layers"]) != attn]
    if bad or not decode_only:
        raise AssertionError(f"{tag}: {arch}: a decode step's host stage "
                             f"ran off the attention layers {attn} (or no "
                             f"decode-only iteration ran): {bad[:2]}")


def _moe_check(tag: str, arch: str, cfg, eng, moe: dict, red: str) -> None:
    """The MoE's own numbers of a serve: its per-expert count read-backs
    (one per MoE call: per engine iteration, one per layer and prefill
    group or decode walk), the (token, slot) pairs routed, and the experts
    a decode step's MoE touches per layer (at most min(E, rows * k)).
    Every serving path runs drop-free: no pair may be dropped."""
    n = max(moe["decode_calls"], 1)
    log(f"phase={tag} arch={arch} moe readbacks={moe['readbacks']} "
        f"readbacks_per_iteration={moe['readbacks'] / eng.iterations:.2f} "
        f"pairs={moe['pairs']} dropped={moe['dropped']} "
        f"decode_calls={moe['decode_calls']} "
        f"decode_experts_per_layer_mean={moe['decode_touched'] / n:.2f} "
        f"max={moe['decode_touched_max']} of {cfg.num_experts} (4 rows x "
        f"top-{cfg.top_k_experts} = {4 * cfg.top_k_experts} pairs at most)"
        + red)
    if moe["dropped"] or not moe["decode_calls"]:
        raise AssertionError(f"{tag}: {arch}: the serve dropped "
                             f"{moe['dropped']} MoE pairs or ran no decode "
                             f"MoE call")


def phase_models(torch, np, ops, ref, timer, seed: int) -> tuple:
    """Serve each config of MODEL_RUNS at full width in turn, smallest
    weights first, everything of the one before freed first; after each,
    with its weights freed, replay its kept launches against the plain
    versions (phase_mainpath).  At least one trace-driven config must run
    an iteration with prefill and decode rows together.  Returns ({path:
    launches by kernel}, {kernel: {case: replay result}})."""
    counts, replays, mixed = {}, {}, {}
    t_phase = time.perf_counter()
    for arch in MODEL_RUNS:
        _free_memory(torch)
        caps = {}
        r = _serve_model(torch, np, ops, arch, seed, caps, family=ref)
        counts[f"models_{arch}"] = r["counts"]
        counts.update(r.get("family", {}))
        for key, c in r.items():
            if key.startswith("counts_"):       # a second tier
                counts[f"models_{arch}_{key[len('counts_'):]}"] = c
        mixed[arch] = r["mixed"]
        _free_memory(torch)
        for name, cases in phase_mainpath(torch, ops, ref, timer, caps,
                                          device=True).items():
            replays.setdefault(name, {}).update(cases)
        caps.clear()
    log(f"phase=models mixed_iterations={json.dumps(mixed)} "
        f"seconds={time.perf_counter() - t_phase:.1f}")
    if not any(mixed[a] for a, run in MODEL_RUNS.items()
               if run[1] is not None):
        raise AssertionError("models: no trace-driven config ran an "
                             "iteration with prefill and decode together")
    return counts, replays


def _obs_breakdown(events: list, scope: str) -> dict:
    """The host-time split of the engine's iterations from a trace: per
    span name (the worker lane's as ``worker:<name>``), its count, total
    host ms, ms per iteration and share of the summed iteration wall time,
    over the iterations of ``scope`` ("decode": decode rows only; "all").
    A span belongs to the iteration its start falls in.  ``uncovered`` is
    the iteration wall that no top-level dispatch span (OBS_TOP_SPANS)
    covers: admission, embed, logits, sampling, the epilogue's drops,
    the worker's drain and the wall-clock charge's device sync (the
    scheduler runs before the iteration span starts)."""
    xs = [e for e in events if e["ph"] == "X"]
    iters = sorted((e for e in xs if e["name"] == "iteration"
                    and (scope == "all" or (e["args"]["decode_rows"]
                                            and not e["args"]
                                            ["prefill_rows"]))),
                   key=lambda e: e["ts"])
    if not iters:
        raise AssertionError(f"obs: no {scope} iteration span")
    lane = iters[0]["tid"]
    starts = [e["ts"] for e in iters]
    wall = sum(e["dur"] for e in iters) / 1e3
    spans, top = {}, 0.0
    for e in xs:
        if e["name"] == "iteration":
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i < 0 or e["ts"] > iters[i]["ts"] + iters[i]["dur"]:
            continue
        name = e["name"] if e["tid"] == lane else f"worker:{e['name']}"
        rec = spans.setdefault(name, {"count": 0, "ms": 0.0})
        rec["count"] += 1
        rec["ms"] += e["dur"] / 1e3
        if e["tid"] == lane and e["name"] in OBS_TOP_SPANS:
            top += e["dur"] / 1e3
    for rec in spans.values():
        rec["ms_per_iter"] = rec["ms"] / len(iters)
        rec["share"] = rec["ms"] / wall
    return {"scope": scope, "iterations": len(iters), "iteration_ms": wall,
            "ms_per_iter": wall / len(iters),
            "spans": dict(sorted(spans.items(),
                                 key=lambda kv: -kv[1]["ms"])),
            "uncovered": {"ms": wall - top,
                          "ms_per_iter": (wall - top) / len(iters),
                          "share": (wall - top) / wall}}


def _obs_trace_checks(tag: str, eng) -> None:
    """The trace of an obs-on run: iteration spans on the engine's lane,
    select / host-stage / attend spans, worker spans on a lane of their
    own overlapping iteration spans, and the two overlap instruments
    within max(0.02, 0.1 x measured)."""
    xs = [e for e in eng.tracer.events() if e["ph"] == "X"]
    iters = [e for e in xs if e["name"] == "iteration"]
    names = {e["name"] for e in xs}
    worker = [e for e in xs if e["cat"] == "host-stage-worker"]
    lanes = {e["tid"] for e in iters}
    if (len(iters) != eng.iterations or len(lanes) != 1
            or not {"select", "host-stage", "attend"} <= names):
        raise AssertionError(f"obs: {tag}: {len(iters)} iteration spans "
                             f"for {eng.iterations} iterations on lanes "
                             f"{lanes}; span names {sorted(names)}")
    if not worker or {e["tid"] for e in worker} & lanes or not any(
            it["ts"] < w["ts"] + w["dur"] and w["ts"] < it["ts"] + it["dur"]
            for w in worker for it in iters):
        raise AssertionError(f"obs: {tag}: no worker span on its own lane "
                             f"overlapping an iteration")
    measured = eng.stage_overlap_measured()
    traced = eng.stage_overlap_from_trace()
    log(f"phase=obs run={tag} stage_overlap_measured={measured} "
        f"stage_overlap_from_trace={traced} events={len(xs)}")
    if (measured is None or traced is None
            or abs(traced - measured) > max(0.02, 0.1 * measured)):
        raise AssertionError(f"obs: {tag}: overlap instruments disagree: "
                             f"measured {measured}, trace {traced}")


def _obs_emit_costs() -> tuple:
    """Host seconds of one call of each of the obs layer's emissions, timed
    here on a fresh Tracer (the median of OBS_COST_PASSES passes of
    OBS_COST_CALLS calls): a complete ("X") span opened by ``begin`` and
    closed by ``end`` with one argument, as the stages emit them (a
    ``complete_at`` from timings the stage takes anyway costs less), and
    an instant ("i") event."""
    from repro_torch.obs.tracing import Tracer
    span, instant = [], []
    for _ in range(OBS_COST_PASSES):
        tr = Tracer()
        t0 = time.perf_counter()
        for i in range(OBS_COST_CALLS):
            tr.end("select", "stage", tr.begin(), layer=i)
        t1 = time.perf_counter()
        for i in range(OBS_COST_CALLS):
            tr.instant("admit", "engine", layer=i)
        t2 = time.perf_counter()
        span.append((t1 - t0) / OBS_COST_CALLS)
        instant.append((t2 - t1) / OBS_COST_CALLS)
    return statistics.median(span), statistics.median(instant)


def phase_obs(torch, np, ops, seed: int) -> None:
    """The obs layer on the card.  After a warm-up serve, the serve phase's
    run (_run_serve) with obs in OBS_ORDER: identical greedy tokens, the
    obs layer's own host work on each obs-on run (its emitted events
    times their per-call cost, ``_obs_emit_costs``) within
    OBS_HOST_SHARE of that run's wall, obs-on's best wall over obs-off's
    printed, the trace checks of _obs_trace_checks on every obs-on run,
    and the first one's host-time split of a decode step
    (``obs_breakdown``, decode-only iterations).  Then the first OBS_TRACE_REQUESTS requests of
    OBS_TRACE_ARCH's models trace with obs on (_serve_model): prefill-group
    spans inside mixed iterations beside decode select and attend spans,
    and its split over every iteration.  Both traces go to chiprun_out/."""
    t_phase = time.perf_counter()
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    card = _card()
    warm, _ = _serve_qwen2(torch, np, seed, n=1, gen_tokens=2,
                           charge_real_time=True)
    warm.run()
    torch.cuda.synchronize()
    del warm
    runs, breakdown, emitted = [], [], []

    def inspect(eng):
        _obs_trace_checks(f"obs_{len(runs)}", eng)
        phs = [e["ph"] for e in eng.tracer.events()]
        emitted.append((phs.count("X"), phs.count("i")))
        if not breakdown:
            breakdown.append(_obs_breakdown(eng.tracer.events(), "decode"))
            n = eng.dump_trace(str(out_dir / "obs_qwen2-0.5b.trace.json"))
            log(f"phase=obs trace=chiprun_out/obs_qwen2-0.5b.trace.json "
                f"events={n}")
    for obs in OBS_ORDER:
        _free_memory(torch)
        runs.append((obs, _run_serve(
            torch, np, ops, seed, f"obs_{len(runs)}", FP_PATH,
            inspect=inspect if obs else None, obs=obs)))
    if any(r["tokens"] != runs[0][1]["tokens"] for _, r in runs):
        raise AssertionError("obs: greedy tokens differ between obs off "
                             "and on")
    walls = {o: [r["wall"] for obs, r in runs if obs == o]
             for o in (False, True)}
    ratio = min(walls[True]) / min(walls[False])
    log(f"phase=obs wall_s_off={walls[False]} wall_s_on={walls[True]} "
        f"order="
        f"{','.join('on' if o else 'off' for o in OBS_ORDER)} "
        f"tokens_identical=True card=[{card}]")
    log(f"phase=obs best_on_over_best_off={ratio:.4f} (the host's "
        f"load moves it across serves; not a bar) card=[{card}]")
    span_s, instant_s = _obs_emit_costs()
    shares = [(nx * span_s + ni * instant_s) / wall
              for (nx, ni), wall in zip(emitted, walls[True])]
    log(f"phase=obs host_work spans_per_run={[n for n, _ in emitted]} "
        f"instants_per_run={[n for _, n in emitted]} span_us="
        f"{span_s * 1e6:.3f} instant_us={instant_s * 1e6:.3f} "
        f"share_of_wall={[round(x, 6) for x in shares]} (bar "
        f"{OBS_HOST_SHARE}) card=[{card}]")
    log(json.dumps({"obs_breakdown": dict(
        arch="qwen2-0.5b", card=card, **breakdown[0])}))
    if len(shares) != OBS_ORDER.count(True) or max(shares) > OBS_HOST_SHARE:
        raise AssertionError(f"obs: the obs layer's host work is "
                             f"{max(shares, default=0):.4f} of an obs-on "
                             f"serve's wall (limit {OBS_HOST_SHARE})")

    def inspect_trace(eng):
        _obs_trace_checks(OBS_TRACE_ARCH, eng)
        xs = [e for e in eng.tracer.events() if e["ph"] == "X"]
        mixed = [e for e in xs if e["name"] == "iteration"
                 and e["args"]["decode_rows"] and e["args"]["prefill_rows"]]
        beside = [it for it in mixed if all(any(
            e["name"] == n and e["tid"] == it["tid"]
            and it["ts"] <= e["ts"] <= it["ts"] + it["dur"] for e in xs)
            for n in ("prefill-group", "select", "attend"))]
        path = f"chiprun_out/obs_{OBS_TRACE_ARCH}.trace.json"
        n = eng.dump_trace(str(REPO / path))
        log(f"phase=obs arch={OBS_TRACE_ARCH} mixed_iterations={len(mixed)} "
            f"mixed_with_prefill_group_select_attend={len(beside)} "
            f"trace={path} events={n}")
        log(json.dumps({"obs_breakdown": dict(
            arch=OBS_TRACE_ARCH, card=card, mixed_iterations=len(mixed),
            **_obs_breakdown(eng.tracer.events(), "all"))}))
        if not beside:
            raise AssertionError(f"obs: {OBS_TRACE_ARCH}: no mixed "
                                 f"iteration holds prefill-group spans "
                                 f"beside decode select and attend spans")
    _free_memory(torch)
    _serve_model(torch, np, ops, OBS_TRACE_ARCH, seed, {},
                 requests=OBS_TRACE_REQUESTS, tag="obs",
                 inspect=inspect_trace, obs=True)
    _free_memory(torch)
    log(f"phase=obs seconds={time.perf_counter() - t_phase:.1f}")


# --- the train phase: flash_prefill's backward and dense GQA training ---

def _visible(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs the attention sees over whole sequences."""
    return _visible_pairs(Sq, Sk, 0) if causal else Sq * Sk


def _sdpa(torch, q, k, v, scale, causal):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          scale=scale, enable_gqa=True)


def _attn_shape(q, k, v, causal: bool) -> str:
    """A training attention call's shape, as its parity line and the
    train runs' launches by shape name it."""
    B_, Sq, Hq, D = q.shape
    return (f"B={B_} Sq={Sq} Sk={k.shape[1]} Hq={Hq} Hkv={k.shape[2]} "
            f"D={D} Dv={v.shape[3]} causal={causal}")


def case_flash_bwd(torch, ops, ref, q, k, v, do, scale,
                   causal: bool = True) -> tuple:
    """flash_prefill_bwd against the plain backward on the same bf16
    inputs (o and lse from the kernel's forward, handed to both): per
    gradient, max |err| <= BWD_ERR x max |grad| and a cosine >= BWD_COS
    (the kernels round P and dS to bf16 before their products, as the
    forward rounds P); two launches give the same bits.  Its library call
    is SDPA's backward at the same shape (the graph of one forward kept,
    its gradient taken again each call), where SDPA takes it."""
    kw = dict(scale=scale, causal=causal)
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, **kw)
    got = ops.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do, scale, causal)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs, coss = [], []
    for g, w in zip(got, want):
        errs.append((g - w).abs().max().item() / w.abs().max().item())
        coss.append(torch.nn.functional.cosine_similarity(
            g.flatten(), w.flatten(), dim=0).item())
    ok = same and max(errs) <= BWD_ERR and min(coss) >= BWD_COS
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    B_, Sq, Hq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    shape = _attn_shape(q, k, v, causal)
    log(f"flash_prefill_bwd {shape} "
        f"err/max|grad| dq={errs[0]:.3e} dk={errs[1]:.3e} dv={errs[2]:.3e} "
        f"cosine dq={coss[0]:.6f} dk={coss[1]:.6f} dv={coss[2]:.6f} "
        f"repeat_bit_equal={same} (bar {BWD_ERR}, cosine >= {BWD_COS})")
    ok = _bwd_planted_chunk(torch, ops, q, k, v, o, lse, do, kw,
                            want) and ok
    ok = _bwd_planted_tile(torch, ref, q, k, v, o, lse, do, scale,
                           causal, got) and ok
    # 5 products per visible (query, key) pair and query head: S and dQ
    # and dK of 2 D flops, dP and dV of 2 Dv
    nops = 2 * (3 * D + 2 * Dv) * _visible(Sq, Sk, causal) * Hq * B_
    nbytes = ((q.numel() + 2 * o.numel() + k.numel() + v.numel()) * 2
              + lse.numel() * 4 + (q.numel() + k.numel() + v.numel()) * 4)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    lib = None
    try:
        out = _sdpa(torch, qt, kt, vt, scale, causal)
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                          retain_graph=True)
        lib()
        torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"flash_prefill_bwd library: SDPA refuses the shape: "
            f"{str(e).splitlines()[0][:200]}")
        lib = None
    return (err, ok, lambda: ops.flash_prefill_bwd(q, k, v, o, lse, do,
                                                   **kw),
            lambda: ref.flash_prefill_bwd(q, k, v, o, lse, do, scale,
                                          causal),
            nbytes, nops, shape, lib)


def _bwd_planted_chunk(torch, ops, q, k, v, o, lse, do, kw, want) -> bool:
    """A planted fault for the backward's chunked dK-dV (a chunk is one
    query head of each GQA group): the last chunk's partial dK and dV left
    out of the group's sum (the kernels' own result with that head's dO
    zeroed, which zeroes its P^T dO and dS^T Q) must fail BWD_ERR /
    BWD_COS.  Prints one line; True when the fault is caught, or when the
    group is one head."""
    B_, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    head = (f"flash_prefill_bwd B={B_} S={S} Hq={Hq} Hkv={Hkv} D={D} "
            f"chunks={G}")
    if G == 1:
        log(f"{head} planted_fault=none (the group is one chunk)")
        return True
    drop = do.clone()
    drop[:, :, G - 1::G] = 0
    _, dk, dv = ops.flash_prefill_bwd(q, k, v, o, lse, drop, **kw)
    passed = True
    for g, w in ((dk, want[1]), (dv, want[2])):
        err = (g - w).abs().max().item() / w.abs().max().item()
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), w.flatten(), dim=0).item()
        passed = passed and err <= BWD_ERR and cos >= BWD_COS
    log(f"{head} planted_fault=\"chunk {G - 1} left out\" "
        f"caught={not passed}")
    return not passed


def _bwd_planted_tile(torch, ref, q, k, v, o, lse, do, scale, causal,
                      got) -> bool:
    """A planted fault for the non-causal mode's ragged key tile: dq of a
    backward that left the keys of the last 128-key tile out (the plain
    one over the keys before it) must fail BWD_ERR / BWD_COS against the
    kernels' dq.  Prints one line; True when caught, or when there is no
    ragged tile of 16 keys or more to leave out (causal, or Sk a multiple
    of 128 or at most 128)."""
    Sk = k.shape[1]
    head = f"flash_prefill_bwd Sk={Sk} causal={causal}"
    if causal or Sk <= 128 or Sk % 128 < 16:
        log(f"{head} planted_fault=none (no ragged key tile to drop)")
        return True
    cut = Sk // 128 * 128
    short = ref.flash_prefill_bwd(q, k[:, :cut].contiguous(),
                                  v[:, :cut].contiguous(), o, lse, do,
                                  scale, causal=False)[0]
    err = (got[0] - short).abs().max().item() / short.abs().max().item()
    cos = torch.nn.functional.cosine_similarity(
        got[0].flatten(), short.flatten(), dim=0).item()
    caught = not (err <= BWD_ERR and cos >= BWD_COS)
    log(f"{head} planted_fault=\"keys {cut}-{Sk - 1} left out\" "
        f"caught={caught}")
    return caught


def case_flash_lse(torch, ops, ref, q, k, v, scale,
                   causal: bool = True) -> tuple:
    """The forward with its lse output against the plain version: the
    output within case_flash's tolerance, lse within LSE_ATOL (natural
    log; the kernel's exp2 and its sums in float32)."""
    kw = dict(scale=scale, causal=causal)
    out, lse = ops.flash_prefill_fwd_lse(q, k, v, **kw)
    want, want_lse = ref.flash_prefill_fwd_lse(q, k, v, **kw)
    torch.cuda.synchronize()
    err, ok, _ = _flash_close(out, want, _abs_weight(ref, q, k, v, **kw))
    lse_err = (lse - want_lse).abs().max().item()
    serve_bits = torch.equal(out, ops.flash_prefill(q, k, v, **kw))
    B_, Sq, Hq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    shape = _attn_shape(q, k, v, causal)
    log(f"flash_prefill:lse {shape} out_max_abs_err="
        f"{err:.3e} ok={ok} lse_max_abs_err={lse_err:.3e} (bar {LSE_ATOL}) "
        f"out_bit_equal_to_the_serve_launch={serve_bits}")
    ok = ok and lse_err <= LSE_ATOL and serve_bits
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * 2 + \
        lse.numel() * 4
    nops = 2 * B_ * Hq * (D + Dv) * _visible(Sq, Sk, causal)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return (max(err, lse_err), ok,
            lambda: ops.flash_prefill_fwd_lse(q, k, v, **kw),
            lambda: ref.flash_prefill_fwd_lse(q, k, v, **kw),
            nbytes, nops, shape,
            lambda: _sdpa(torch, qt, kt, vt, scale, causal))


def _fwd_bwd_line(torch, ops, timer, label, q, k, v, do, results,
                  card, names=("flash_prefill_bwd", "flash_prefill:lse"),
                  causal: bool = True) -> None:
    """One line per train case: the backward's timer and device ms
    against its FLOP bound and SDPA's backward, and a training step's
    attention, forward (with lse) and backward, timed beside SDPA's
    forward and backward at the same shape (where SDPA takes it)."""
    bwd, fwd = results[names[0]][label], results[names[1]][label]
    kw = dict(scale=q.shape[-1] ** -0.5, causal=causal)

    def ours():
        o, lse = ops.flash_prefill_fwd_lse(q, k, v, **kw)
        return ops.flash_prefill_bwd(q, k, v, o, lse, do, **kw)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))

    def sdpa():
        out = _sdpa(torch, qt, kt, vt, kw["scale"], causal)
        return torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    sdpa_ms = timer(sdpa) if bwd["library_ms"] is not None else None
    o, lse = ops.flash_prefill_fwd_lse(q, k, v, **kw)
    split = device_ms(torch, lambda: ops.flash_prefill_bwd(
        q, k, v, o, lse, do, **kw), by_kernel="flash_bwd_")
    B_, Sq, Hq, D = q.shape
    Sk, Dv = k.shape[1], v.shape[3]
    # the design's own floor: seven products (dQ's kernel recomputes S and
    # dP) per visible pair and query head
    floor7 = (2 * (4 * D + 3 * Dv) * _visible(Sq, Sk, causal) * Hq * B_
              / BF16_OPS_PER_S * 1e3)
    line = (f"phase=train {label} kernel={names[0]} "
            f"device_ms_by_kernel={json.dumps(split)} "
            f"bwd_ms={bwd['ms']:.4f} device_ms={bwd['device_ms']:.5f} "
            f"events_ms={bwd['events_ms']:.4f} "
            f"bound_ms={bwd['bound_ms']:.4f} ({bwd['bound_by']}; the FLOP "
            f"count of five products) seven_product_floor_ms={floor7:.4f} "
            f"sdpa_bwd_ms=" + (f"{bwd['library_ms']:.4f}"
                               if bwd["library_ms"] is not None else "None")
            + f" fwd_lse_ms={fwd['ms']:.4f} fwd_lse_events_ms="
            f"{fwd['events_ms']:.4f} sdpa_fwd_ms="
            + (f"{fwd['library_ms']:.4f}" if fwd["library_ms"] is not None
               else "None")
            + f" fwd_plus_bwd_ms={timer(ours):.4f} sdpa_fwd_plus_bwd_ms="
            + (f"{sdpa_ms:.4f}" if sdpa_ms is not None else "None")
            + f" card=[{card}]")
    log(line)


def _wkv_shape(r) -> str:
    """A WKV training launch's shape, as its parity line and the train
    run's launches by shape name it."""
    B_, S, H, hd = r.shape
    return f"B={B_} S={S} H={H} hd={hd}"


def _wkv_train_inputs(torch, gen, Bn: int, S: int, lens) -> tuple:
    """Kernel A's and B's operands as RWKV6's training hands them over:
    r, k, v float32 ~ N(0, 1), w = exp(-exp(N(-2, 1))), u = 0.1 N(0, 1),
    S0 ~ N(0, 1), and dy, dS ~ N(0, 1); past each row's length k = 0 and
    w = 1, as the time-mix masks padding."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    shape = (Bn, S, WKV_H, WKV_HD)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])[..., None, None]
    r, k, v = randn(*shape), randn(*shape) * mask, randn(*shape)
    w = torch.where(mask, torch.exp(-torch.exp(randn(*shape) - 2)), 1.0)
    u = 0.1 * randn(WKV_H, WKV_HD)
    S0 = randn(Bn, WKV_H, WKV_HD, WKV_HD)
    return (r, k.contiguous(), v, w.contiguous(), u, S0, randn(*shape),
            randn(*S0.shape))


def _wkv_plain_chunks(torch, ref, r, k, v, w, u, S0, L: int, nc: int):
    """The plain forward walked chunk by chunk (the token walk's
    arithmetic): y, the final state and the state before each of the nc
    chunks of L tokens."""
    ys, states = [], [S0]
    for c in range(nc):
        sl = slice(c * L, (c + 1) * L if c < nc - 1 else r.shape[1])
        y, st = ref.wkv6(r[:, sl], k[:, sl], v[:, sl], w[:, sl], u,
                         states[-1])
        ys.append(y)
        states.append(st)
    return torch.cat(ys, dim=1), states[-1], torch.stack(states[:-1], dim=2)


def case_wkv_train(torch, ops, ref, r, k, v, w, u, S0) -> tuple:
    """Kernel A (wkv6's float32 training instance) against the plain
    chunked forward on the same inputs: y, the final state and each
    chunk's S_in[c], per element within WKV_RTOL W + WKV_ATOL (W the
    plain version on the inputs' magnitudes).  Its bound: r, k, v and w
    read and y written (1,280 bytes a (token, head)), S0 and u read, the
    final state and S_in written, against the 5 float32 operations a
    (token, head, i, j) that the function needs."""
    Bn, S, H, hd = r.shape
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(r.device))
    nc = -(-S // L) if S > L else 1
    got = ops.wkv6_train(r, k, v, w, u, S0)
    torch.cuda.synchronize()
    want = _wkv_plain_chunks(torch, ref, r, k, v, w, u, S0, L, nc)
    weight = _wkv_plain_chunks(torch, ref, r.abs(), k.abs(), v.abs(), w,
                               u.abs(), S0.abs(), L, nc)
    err = max((g - x).abs().max().item() for g, x in zip(got, want))
    ok = all(bool(((g - x).abs() <= WKV_RTOL * m + WKV_ATOL).all())
             for g, x, m in zip(got, want, weight))
    log(f"wkv6:train {_wkv_shape(r)} L={L} chunks={nc} y, final state and "
        f"S_in max_abs_err={err:.3e} ok={ok} (bar {WKV_RTOL:.3e} W + "
        f"{WKV_ATOL})")
    nbytes = 4 * (5 * r.numel() + u.numel() + 2 * S0.numel()
                  + (got[2].numel() if nc > 1 else 0))
    return (err, ok, lambda: ops.wkv6_train(r, k, v, w, u, S0),
            lambda: ref.wkv6(r, k, v, w, u, S0), nbytes,
            (5 * Bn * S * H * hd * (hd + 1), F32_OPS_PER_S), _wkv_shape(r))


def _wkv_grad_errs(torch, got, want) -> tuple:
    """Per gradient: max |err| over the plain version's max |grad|, and
    the cosine."""
    errs = [(g - x).abs().max().item() / x.abs().max().item()
            for g, x in zip(got, want)]
    coss = [torch.nn.functional.cosine_similarity(
        g.flatten(), x.flatten(), dim=0).item() for g, x in zip(got, want)]
    return errs, coss


def _wkv_grads_ok(torch, got, want) -> bool:
    errs, coss = _wkv_grad_errs(torch, got, want)
    return max(errs) <= WKV_GRAD_ERR and min(coss) >= WKV_GRAD_COS


def wkv_bwd_faults(torch, ops, args, S_in, got, want, label) -> bool:
    """Kernel B's planted faults, each held against the plain version
    under WKV_GRAD_ERR / WKV_GRAD_COS, which must reject it: u's term
    dropped from dk (the kernel's dk less r u (dy . v)); lam's carry into
    chunk 0 dropped (the kernels on chunk 0's tokens alone, from a zero
    gradient at their end, spliced in); the decay sum's carry into chunk
    0 dropped (its <lam, S> at chunk 0's end, lam there from the kernels
    on the tokens after it, taken out of chunk 0's dlogw); a_end left out
    of every chunk's suffix (the kernel built with
    -DWKV_BWD_FAULT_NO_AEND: K's suffix from 0, R's and K's a_end unread).
    Prints one line a fault; True when every one is caught."""
    r, k, v, w, u, S0, dy, dS = args
    Bn, S, H, _ = r.shape
    L = ops.wkv6_chunk(Bn, S, H, ops._sm_count(r.device))
    if S <= L:
        raise AssertionError(f"wkv6_bwd faults at {label}: one chunk")
    u_dropped = list(got)
    u_dropped[1] = got[1] - r * u * (dy * v).sum(-1, keepdim=True)
    head = tuple(t[:, :L].contiguous() for t in (r, k, v, w))
    _, _, s_head = ops.wkv6_train(*head, u, S0)
    g_head = ops.wkv6_bwd(*head, u, s_head, dy[:, :L].contiguous(),
                          torch.zeros_like(dS))
    lam_dropped = [t.clone() for t in got]
    for i in (1, 2, 3):
        lam_dropped[i][:, :L] = g_head[i]
    lam_dropped[5] = g_head[5]
    tail = tuple(t[:, L:].contiguous() for t in (r, k, v, w))
    s1 = S_in[:, :, 1].contiguous()
    _, _, s_tail = ops.wkv6_train(*tail, u, s1)
    lam1 = ops.wkv6_bwd(*tail, u, s_tail, dy[:, L:].contiguous(), dS)[5]
    sum_dropped = list(got)
    sum_dropped[3] = got[3].clone()
    sum_dropped[3][:, :L] -= (lam1 * s1).sum(-1)[:, None]
    with ops.LIBS.planted("wkv6_bwd:no_aend"):
        no_aend = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    caught = True
    for fault, bad in (("u_term_dropped_from_dk", u_dropped),
                       ("lam_carry_into_chunk_0_dropped", lam_dropped),
                       ("decay_sum_carry_into_chunk_0_dropped",
                        sum_dropped),
                       ("a_end_left_out_of_the_suffix", no_aend)):
        errs, coss = _wkv_grad_errs(torch, bad, want)
        ok = max(errs) <= WKV_GRAD_ERR and min(coss) >= WKV_GRAD_COS
        log(f"phase=train {label} kernel=wkv6_bwd planted_fault={fault} "
            f"max_err/max|grad|={max(errs):.3e} min_cosine="
            f"{min(coss):.6f} rejected={not ok}")
        caught = caught and not ok
    return caught


def case_wkv_bwd(torch, ops, ref, r, k, v, w, u, S0, dy, dS,
                 label: str, faults: bool = True) -> tuple:
    """Kernel B (wkv6_bwd) against ref.wkv6_bwd on the same float32
    inputs, S_in from kernel A: each of dr, dk, dv, dlogw, du and dS0
    within WKV_GRAD_ERR of its max |grad| with a cosine >= WKV_GRAD_COS,
    two launches bit-equal, and (with ``faults``) the planted faults
    rejected.  Its bound:
    r, k, v, w and dy read and dr, dk, dv and dlogw written (2,304 bytes
    a (token, head)), S_in, dS and u read, dS0 and du written, against 9
    float32 operations a (token, head, i, j)."""
    args = (r, k, v, w, u, S0, dy, dS)
    _, _, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    got = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    again = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    want = ref.wkv6_bwd(r, k, v, w, u, S0, dy, dS)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    errs, coss = _wkv_grad_errs(torch, got, want)
    ok = same and max(errs) <= WKV_GRAD_ERR and min(coss) >= WKV_GRAD_COS
    log(f"wkv6_bwd {_wkv_shape(r)} chunks={S_in.shape[2]} err/max|grad| "
        + " ".join(f"{n}={e:.3e}" for n, e in zip(
            ("dr", "dk", "dv", "dlogw", "du", "dS0"), errs))
        + f" min_cosine={min(coss):.7f} repeat_bit_equal={same} (bar "
        f"{WKV_GRAD_ERR:.3e}, cosine >= {WKV_GRAD_COS})")
    if faults:
        ok = wkv_bwd_faults(torch, ops, args, S_in, got, want, label) and ok
    err = max((g - x).abs().max().item() for g, x in zip(got, want))
    Bn, S, H, hd = r.shape
    nbytes = 4 * (9 * r.numel() + S_in.numel() + 2 * dS.numel()
                  + 2 * u.numel())
    return (err, ok, lambda: ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS),
            lambda: ref.wkv6_bwd(r, k, v, w, u, S0, dy, dS), nbytes,
            (9 * Bn * S * H * hd * hd, F32_OPS_PER_S), _wkv_shape(r))


def _wkv_near_zero_decays(torch, ops, ref, seed: int) -> None:
    """Kernel B at the train shape where whole channels decay near 0
    (WKV_NEAR_ZERO channels of every head, w = exp(-exp(N(2, 0.5))))
    beside channels drawn as usual: each channel's dlogw against the
    float64 reverse loop on its own scale (relative L2 over its tokens,
    within WKV_DLOGW_REL), the other gradients under kernel B's bar
    against the same float64 truth."""
    label, Bn, S, lens = WKV_TRAIN_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(seed + 250)
    r, k, v, w, u, S0, dy, dS = _wkv_train_inputs(torch, gen, Bn, S, lens)
    n = WKV_NEAR_ZERO
    w[..., :n] = torch.exp(-torch.exp(2.0 + 0.5 * torch.randn(
        w[..., :n].shape, generator=gen, device="cuda")))
    _, _, S_in = ops.wkv6_train(r, k, v, w, u, S0)
    got = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
    want = ref.wkv6_bwd(*(t.double() for t in (r, k, v, w, u, S0, dy, dS)))
    rel = (((got[3].double() - want[3]) ** 2).sum((0, 1)).sqrt()
           / (want[3] ** 2).sum((0, 1)).sqrt())
    errs, coss = _wkv_grad_errs(torch, [g.double() for i, g in enumerate(got)
                                        if i != 3],
                                [x for i, x in enumerate(want) if i != 3])
    scale = (float(want[3][..., :n].abs().mean()),
             float(want[3][..., n:].abs().mean()))
    ok = (float(rel.max()) <= WKV_DLOGW_REL and max(errs) <= WKV_GRAD_ERR
          and min(coss) >= WKV_GRAD_COS)
    log(f"phase=train case=near_zero_decays kernel=wkv6_bwd "
        f"{_wkv_shape(r)} near_zero_channels={n}/{WKV_HD} per_head "
        f"w_max_there={float(w[..., :n].max()):.3e} mean|dlogw| "
        f"near_zero={scale[0]:.3e} others={scale[1]:.3e} dlogw_rel_l2_by_"
        f"channel max near_zero={float(rel[:, :n].max()):.3e} "
        f"others={float(rel[:, n:].max()):.3e} (bar {WKV_DLOGW_REL:.3e}) "
        f"other_grads err/max|grad|={max(errs):.3e} min_cosine="
        f"{min(coss):.7f} (vs float64) ok={ok} card=[{_card()}]")
    if not ok or scale[0] >= 1e-2 * scale[1]:
        raise AssertionError("train: kernel B outside its bar where whole "
                             "channels decay near 0 (or the case did not "
                             "reach that regime)")


def _scan_shape(x) -> str:
    """A selective-scan training launch's shape, as its parity line and
    the train run's launches by shape name it."""
    B_, S, di = x.shape
    return f"B={B_} S={S} di={di}"


def _scan_train_inputs(torch, gen, Bn: int, S: int, lens) -> tuple:
    """Kernel C's and D's float32 operands as the Mamba layer's training
    hands them over, at jamba-v0.1-52b's widths: x, B, C ~ N(0, 1), dt =
    softplus(N(-2, 1)) zeroed past each row's length, A = -exp(A_log),
    A_log = log(1..16) + N(0, 0.1^2), D = 1 + N(0, 0.1^2), and h0, dy, dh
    ~ N(0, 1)."""
    dev = torch.device("cuda")

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    mask = (torch.arange(S, device=dev)[None, :]
            < torch.tensor(lens, device=dev)[:, None])
    dt = (torch.nn.functional.softplus(randn(Bn, S, SCAN_DI) - 2)
          * mask[..., None]).contiguous()
    a_log = (torch.arange(1, SCAN_DS + 1, device=dev).float().log()
             + 0.1 * randn(SCAN_DI, SCAN_DS))
    return (randn(Bn, S, SCAN_DI), dt, randn(Bn, S, SCAN_DS),
            randn(Bn, S, SCAN_DS), -torch.exp(a_log),
            1 + 0.1 * randn(SCAN_DI), randn(Bn, SCAN_DI, SCAN_DS),
            randn(Bn, S, SCAN_DI), randn(Bn, SCAN_DI, SCAN_DS))


def _plain_scan_chunks(torch, ref, x, dt, B, C, A, D, h0, L: int):
    """The plain scan walked chunk by chunk of L tokens (the token walk's
    arithmetic): y, the final state and the state before each chunk."""
    ys, states = [], [h0]
    for t0 in range(0, x.shape[1], L):
        sl = slice(t0, t0 + L)
        y, h = ref.selective_scan(x[:, sl], dt[:, sl], B[:, sl], C[:, sl],
                                  A, D, states[-1])
        ys.append(y)
        states.append(h)
    return torch.cat(ys, dim=1), states[-1], torch.stack(states[:-1], dim=1)


def case_scan_train(torch, ops, ref, x, dt, B, C, A, D, h0) -> tuple:
    """Kernel C (the selective scan's float32 training instance) against
    the plain scan walked in its chunks on the same inputs: y, the final
    state and each chunk's checkpoint within SCAN_ATOL + SCAN_RTOL |ref|.
    Its bound: x and dt read and y written (12 bytes a (token, channel)),
    B, C, A, D and h0 read, the final state and the checkpoints written,
    against 8 float32 operations a (token, channel, state)."""
    Bn, S, di = x.shape
    got = ops.selective_scan_train(x, dt, B, C, A, D, h0)
    torch.cuda.synchronize()
    want = _plain_scan_chunks(torch, ref, x, dt, B, C, A, D, h0,
                              ops.SCAN_CHUNK)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    ok = all(bool(((g - w).abs() <= SCAN_ATOL + SCAN_RTOL * w.abs()).all())
             for g, w in zip(got, want))
    log(f"selective_scan:train {_scan_shape(x)} chunks={got[2].shape[1]} "
        f"y, final state and checkpoints max_abs_err={err:.3e} ok={ok} "
        f"(bar {SCAN_ATOL} + {SCAN_RTOL} |ref|)")
    nbytes = 4 * (3 * x.numel() + 2 * B.numel() + A.numel() + D.numel()
                  + 2 * h0.numel() + got[2].numel())
    return (err, ok, lambda: ops.selective_scan_train(x, dt, B, C, A, D, h0),
            lambda: ref.selective_scan(x, dt, B, C, A, D, h0), nbytes,
            (8 * x.numel() * SCAN_DS, F32_OPS_PER_S), _scan_shape(x))


SCAN_GRADS = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")


def _scan_grads_ok(torch, got, want) -> tuple:
    """(ok, per-gradient err / max |grad|, min cosine) under SCAN_GRAD_ERR
    and SCAN_GRAD_COS."""
    errs, coss = _wkv_grad_errs(torch, got, want)
    return (max(errs) <= SCAN_GRAD_ERR and min(coss) >= SCAN_GRAD_COS,
            errs, min(coss))


def scan_bwd_faults(torch, ops, args, ckpt, got, want, label) -> bool:
    """Kernel D's planted faults, each held against the plain version
    under SCAN_GRAD_ERR / SCAN_GRAD_COS, which must reject it: the final
    state's gradient ignored (the kernel given a zero dh); chunk 1 rerun
    from a zero state (its checkpoint zeroed); the last 32-channel
    group's share of dB and dC left out (the kernel's dB and dC less the
    kernel's own on inputs whose other channels' dy and dt are zero, so
    only that group contributes).  Prints one line a fault; True when
    every one is caught."""
    x, dt, B, C, A, D, h0, dy, dh = args
    if ckpt.shape[1] < 2:
        raise AssertionError(f"selective_scan_bwd faults at {label}: one "
                             f"chunk")
    no_dh = ops.selective_scan_bwd(x, dt, B, C, A, D, ckpt, dy,
                                   torch.zeros_like(dh))
    zeroed = ckpt.clone()
    zeroed[:, 1] = 0
    no_ckpt = ops.selective_scan_bwd(x, dt, B, C, A, D, zeroed, dy, dh)
    keep = torch.zeros_like(dt[0, 0])
    keep[-32:] = 1
    only = ops.selective_scan_bwd(x, (dt * keep).contiguous(), B, C, A, D,
                                  ckpt, (dy * keep).contiguous(), dh)
    group_dropped = list(got)
    group_dropped[2] = got[2] - only[2]
    group_dropped[3] = got[3] - only[3]
    caught = True
    for fault, bad in (("final_state_gradient_ignored", no_dh),
                       ("chunk_1_rerun_from_zero", no_ckpt),
                       ("last_channel_group_left_out_of_dB_dC",
                        group_dropped)):
        ok, errs, cos = _scan_grads_ok(torch, bad, want)
        log(f"phase=train {label} kernel=selective_scan_bwd planted_fault="
            f"{fault} max_err/max|grad|={max(errs):.3e} min_cosine="
            f"{cos:.6f} rejected={not ok}")
        caught = caught and not ok
    return caught


def case_scan_bwd(torch, ops, ref, x, dt, B, C, A, D, h0, dy, dh,
                  label: str, faults: bool = True) -> tuple:
    """Kernel D (selective_scan_bwd) against ref.selective_scan_bwd on the
    same float32 inputs, checkpoints from kernel C: each of dx, ddt, dB,
    dC, dA, dD and dh0 within SCAN_GRAD_ERR of its max |grad| with a
    cosine >= SCAN_GRAD_COS, two launches bit-equal, and (with ``faults``)
    the planted faults rejected.  Its bound: x, dt and dy read and dx and
    ddt written (20 bytes a (token, channel)), B, C, A, D, the
    checkpoints and dh read, dB, dC, dA, dD and dh0 written, against 18
    float32 operations a (token, channel, state); the partials' round
    trip is not counted."""
    args = (x, dt, B, C, A, D, h0, dy, dh)
    _, _, ckpt = ops.selective_scan_train(x, dt, B, C, A, D, h0)
    got = ops.selective_scan_bwd(x, dt, B, C, A, D, ckpt, dy, dh)
    again = ops.selective_scan_bwd(x, dt, B, C, A, D, ckpt, dy, dh)
    want = ref.selective_scan_bwd(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    ok, errs, cos = _scan_grads_ok(torch, got, want)
    ok = ok and same
    log(f"selective_scan_bwd {_scan_shape(x)} chunks={ckpt.shape[1]} "
        f"err/max|grad| " + " ".join(f"{n}={e:.3e}" for n, e in zip(
            SCAN_GRADS, errs))
        + f" min_cosine={cos:.7f} repeat_bit_equal={same} (bar "
        f"{SCAN_GRAD_ERR:.3e}, cosine >= {SCAN_GRAD_COS})")
    if faults:
        ok = scan_bwd_faults(torch, ops, args, ckpt, got, want, label) and ok
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    nbytes = 4 * (5 * x.numel() + 4 * B.numel() + 2 * A.numel()
                  + 2 * D.numel() + 2 * dh.numel() + ckpt.numel())
    del again
    return (err, ok,
            lambda: ops.selective_scan_bwd(x, dt, B, C, A, D, ckpt, dy, dh),
            lambda: ref.selective_scan_bwd(*args), nbytes,
            (18 * x.numel() * SCAN_DS, F32_OPS_PER_S), _scan_shape(x))


def _plain_scan(torch, ref):
    """``ops.SelectiveScanFn``'s stand-in for the train phase's check: the
    plain scan and the plain backward as an autograd Function, float32
    on the card.  Only this script patches it in."""
    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, B, C, A, D, h0):
            ctx.save_for_backward(x, dt, B, C, A, D, h0)
            return ref.selective_scan(x, dt, B, C, A, D, h0)

        @staticmethod
        def backward(ctx, dy, dh):
            return ref.selective_scan_bwd(*ctx.saved_tensors, dy, dh)
    return PlainScan


def _plain_wkv(torch, ref):
    """``ops.Wkv6Fn``'s stand-in for the train phase's check: the plain
    forward and the plain backward as an autograd Function, float32 on
    the card.  Only this script patches it in."""
    class PlainWkv6(torch.autograd.Function):
        @staticmethod
        def forward(ctx, r, k, v, logw, u, S0):
            w = torch.exp(logw)
            ctx.save_for_backward(r, k, v, w, u, S0)
            return ref.wkv6(r, k, v, w, u, S0)

        @staticmethod
        def backward(ctx, dy, dS):
            return ref.wkv6_bwd(*ctx.saved_tensors, dy, dS)
    return PlainWkv6


def _plain_attention(torch, ref):
    """``ops.flash_prefill``'s stand-in for the train phase's check: the
    plain forward (with lse) and plain backward as an autograd Function,
    float32 on the card, causal or not.  Only this script patches it in;
    the trainer has no such option."""
    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, scale, causal):
            o, lse = ref.flash_prefill_fwd_lse(q, k, v, scale=scale,
                                               causal=causal)
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.scale, ctx.causal = scale, causal
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return ref.flash_prefill_bwd(q, k, v, o, lse, do, ctx.scale,
                                         ctx.causal) + (None, None)

    def flash(q, k, v, *, scale, causal=True, q_offset=0):
        if int(q_offset):
            raise AssertionError("train: the plain stand-in takes whole "
                                 "sequences only")
        return PlainFlash.apply(q, k, v, float(scale), bool(causal))
    return flash


class _WkvCapture:
    """While entered, the inputs of the ``ops.wkv6_bwd`` calls numbered
    in ``keep`` (in call order: the backward reaches the last layer
    first), kept on the card: {call: (r, k, v, w, u, S_in, dy, dS)}."""

    def __init__(self, ops, keep):
        self.ops, self.keep, self.calls, self.n = ops, set(keep), {}, 0

    def __enter__(self):
        self.saved = self.ops.wkv6_bwd

        def call(*args):
            if self.n in self.keep:
                self.calls[self.n] = tuple(t.detach().clone() for t in args)
            self.n += 1
            return self.saved(*args)
        if self.keep:
            self.ops.wkv6_bwd = call
        return self

    def __exit__(self, *exc):
        self.ops.wkv6_bwd = self.saved


def _wkv_captured_check(torch, ops, ref, arch, captured, layers: int,
                        card) -> None:
    """Each captured WKV backward of the full-depth step 1 (kernel B on
    the run's own inputs; call n is layer ``layers`` - 1 - n's) against
    ref.wkv6_bwd on the same inputs, under WKV_GRAD_ERR / WKV_GRAD_COS.
    Prints one line a call."""
    if set(captured) != set(WKV_STEP1_CALLS):
        raise AssertionError(f"train {arch}: captured WKV calls "
                             f"{sorted(captured)}, not {WKV_STEP1_CALLS}")
    for n, (r, k, v, w, u, S_in, dy, dS) in sorted(captured.items()):
        got = ops.wkv6_bwd(r, k, v, w, u, S_in, dy, dS)
        want = ref.wkv6_bwd(r, k, v, w, u, S_in[:, :, 0], dy, dS)
        errs, coss = _wkv_grad_errs(torch, got, want)
        ok = max(errs) <= WKV_GRAD_ERR and min(coss) >= WKV_GRAD_COS
        log(f"phase=train arch={arch} step1 wkv6_bwd call={n} (layer "
            f"{layers - 1 - n}) on the run's inputs err/max|grad| "
            f"max={max(errs):.3e} "
            f"min_cosine={min(coss):.7f} ok={ok} (bar {WKV_GRAD_ERR:.3e}, "
            f"cosine >= {WKV_GRAD_COS}) card=[{card}]")
        if not ok:
            raise AssertionError(f"train {arch}: wkv6_bwd call {n} "
                                 f"disagrees with the plain backward")
        del got, want


def _wkv_shallow_step1(torch, ops, ref, arch, Bn, S, seed, card) -> None:
    """Step 1 of ``arch`` at full width and WKV_STEP1_LAYERS layers (its
    first layers' weights from the seed), through the kernels and through
    the plain wkv6 and wkv6_bwd: the loss within TRAIN_LOSS_RTOL and the
    grad norm within TRAIN_GNORM_RTOL of the plain step's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.training import trainer as T
    from repro_torch.training.optimizer import global_norm
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config(arch), num_layers=WKV_STEP1_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.trainable(M.init_params(cfg, gen, torch.float32, dev))
    batch = T.batch_to(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=Bn,
        seed=seed)).batch(), dev)
    out = []
    for plain in (False, True):
        kernel_wkv = ops.Wkv6Fn
        if plain:
            ops.Wkv6Fn = _plain_wkv(torch, ref)
        try:
            loss, grads = T.loss_and_grads(params, cfg, batch, remat=True)
            out.append((loss.item(), global_norm(grads).item()))
        finally:
            ops.Wkv6Fn = kernel_wkv
        del grads
    (kl, kg), (pl, pg) = out
    loss_rel, gn_rel = abs(kl - pl) / abs(pl), abs(kg - pg) / abs(pg)
    log(f"phase=train arch={arch} step1 reduced=num_layers:"
        f"{WKV_STEP1_LAYERS}/{get_config(arch).num_layers} (full width) "
        f"kernel_loss={kl:.6f} plain_loss={pl:.6f} rel={loss_rel:.3e} (bar "
        f"{TRAIN_LOSS_RTOL}) kernel_grad_norm={kg:.6f} plain_grad_norm="
        f"{pg:.6f} rel={gn_rel:.3e} (bar {TRAIN_GNORM_RTOL}) card=[{card}]")
    if loss_rel > TRAIN_LOSS_RTOL or gn_rel > TRAIN_GNORM_RTOL:
        raise AssertionError(f"train {arch}: step 1 at {WKV_STEP1_LAYERS} "
                             f"layers disagrees with the plain WKV's")
    del params
    _free_memory(torch)


def phase_precision(torch, ops, ref, seed: int) -> None:
    """Only when named in --phases: how well float32 determines
    rwkv6-1.6b's step-1 gradient at full width and depth (B 2 x 4,096,
    the train run's batch and weights).  The gradient through the
    kernels and through the plain wkv6 and wkv6_bwd, in float32, each
    against the plain step with every operation in float64 (the weights
    widened; ``torch.Tensor.float`` patched to float64 for that step, so
    the model's float32 casts widen too).  Prints the global norms and,
    per layer (and the embedding and head), the float64 gradient's norm
    and each float32 gradient's relative L2 error."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.training import trainer as T
    from repro_torch.training.optimizer import global_norm, tree_leaves
    card = _card()
    dev = torch.device("cuda")
    arch = "rwkv6-1.6b"
    cfg = get_config(arch)
    Bn, S, _ = TRAIN_RUNS[arch]
    params = T.trainable(M.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), torch.float32,
        dev))
    batch = T.batch_to(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=Bn,
        seed=seed)).batch(), dev)

    def names(t, pre=""):
        if isinstance(t, dict):
            for k, v in t.items():
                yield from names(v, f"{pre}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                yield from names(v, f"{pre}/{i}")
        else:
            yield pre
    keys = [m.group(1) if (m := re.match(r"/layers/(\d+)/", n)) else n
            for n in names(params)]
    runs = {}
    kernel_wkv = ops.Wkv6Fn
    for tag in ("kernels", "plain", "float64"):
        float32 = torch.Tensor.float
        if tag != "kernels":
            ops.Wkv6Fn = _plain_wkv(torch, ref)
        if tag == "float64":
            torch.Tensor.float = lambda self: self.double()
            for t in tree_leaves(params):
                t.data = t.data.double()
        try:
            loss, grads = T.loss_and_grads(params, cfg, batch, remat=True)
        finally:
            ops.Wkv6Fn, torch.Tensor.float = kernel_wkv, float32
        runs[tag] = (loss.item(), global_norm(grads).item(),
                     [g.double().cpu() for g in grads])
        del grads
        _free_memory(torch)
    del params
    _free_memory(torch)
    log(f"phase=precision arch={arch} B={Bn} S={S} losses kernels="
        f"{runs['kernels'][0]:.9f} plain={runs['plain'][0]:.9f} float64="
        f"{runs['float64'][0]:.9f} grad_norms kernels={runs['kernels'][1]:.6f}"
        f" plain={runs['plain'][1]:.6f} float64={runs['float64'][1]:.6f} "
        f"card=[{card}]")
    per = {}
    for key, gk, gp, g64 in zip(keys, runs["kernels"][2], runs["plain"][2],
                                runs["float64"][2]):
        d = per.setdefault(key, [0.0, 0.0, 0.0])
        d[0] += g64.norm().item() ** 2
        d[1] += (gk - g64).norm().item() ** 2
        d[2] += (gp - g64).norm().item() ** 2
    log(f"phase=precision arch={arch} per_layer " + json.dumps({
        key: {"norm64": round(n2 ** 0.5, 6),
              "rel_l2_kernels": round((ek / n2) ** 0.5, 6),
              "rel_l2_plain": round((ep / n2) ** 0.5, 6)}
        for key, (n2, ek, ep) in per.items()}) + f" card=[{card}]")


def _want_launches(cfg, steps: int) -> dict:
    """Each training kernel's launches over ``steps`` steps of ``cfg``
    with remat on: every decoder attention layer's self-attention forward
    twice (the step and remat's rerun) and backward once, and Whisper's
    cross-attention the same; the encoder's (not checkpointed) once
    each.  Every forward is the lse instance.  RWKV6's and the hybrid's
    recurrent layers run their recurrence instead, forward (kernel A or
    C) twice and backward (kernel B or D) once."""
    from repro_torch.models.model import layer_kind
    kinds = [layer_kind(cfg, i) for i in range(cfg.num_layers)]
    R, Mb, L = (kinds.count(k) for k in ("rwkv", "mamba", "attn"))
    E = cfg.encoder_layers if cfg.is_encoder_decoder else 0
    X = L if cfg.is_encoder_decoder else 0        # cross-attentions
    heads = {"mla": cfg.attention_type == "mla",
             "d112": (cfg.attention_type == "gqa"
                      and cfg.head_dim == 112)}
    want = {"flash_prefill": 2 * L + E + 2 * X,
            "flash_prefill:lse": 2 * L + E + 2 * X,
            "flash_prefill_bwd": L + E + X,
            "flash_prefill:lse_noncausal": E + 2 * X,
            "flash_prefill_bwd:noncausal": E + X,
            "wkv6": 2 * R, "wkv6:train": 2 * R, "wkv6_bwd": R,
            "selective_scan": 2 * Mb, "selective_scan:train": 2 * Mb,
            "selective_scan_bwd": Mb}
    for mode, on in heads.items():
        want[f"flash_prefill:lse_{mode}"] = 2 * L if on else 0
        want[f"flash_prefill_bwd:{mode}"] = L if on else 0
    return {k: n * steps for k, n in want.items()}


class _ShapeTally:
    """While entered, the launches of training's forward (with lse) and
    backward counted by ``_attn_shape``, and of the WKV recurrence's and
    the selective scan's by ``_wkv_shape`` and ``_scan_shape``, beside
    the wrappers' own counts: {key: {shape: calls}}, a key for each
    wrapper of ``WRAPPERS``.  The wrappers are patched in ``ops``, whose
    FlashPrefillFn, Wkv6Fn and SelectiveScanFn call them."""

    # record key -> ops wrapper
    WRAPPERS = {"flash_prefill:lse": "flash_prefill_fwd_lse",
                "flash_prefill_bwd": "flash_prefill_bwd",
                "wkv6:train": "wkv6_train", "wkv6_bwd": "wkv6_bwd",
                "selective_scan:train": "selective_scan_train",
                "selective_scan_bwd": "selective_scan_bwd"}

    def __init__(self, ops):
        self.ops = ops
        self.calls = {key: {} for key in self.WRAPPERS}

    def _count(self, key, shape):
        self.calls[key][shape] = self.calls[key].get(shape, 0) + 1

    def _wrap(self, key, fn):
        if key.startswith(("wkv6", "selective_scan")):
            shape = _wkv_shape if key.startswith("wkv6") else _scan_shape

            def call(x, *args):
                self._count(key, shape(x))
                return fn(x, *args)
            return call

        def call(q, k, v, *args, causal=True, **kw):
            self._count(key, _attn_shape(q, k, v, causal))
            return fn(q, k, v, *args, causal=causal, **kw)
        return call

    def __enter__(self):
        self.saved = {key: getattr(self.ops, fn)
                      for key, fn in self.WRAPPERS.items()}
        for key, fn in self.WRAPPERS.items():
            setattr(self.ops, fn, self._wrap(key, self.saved[key]))
        return self

    def __exit__(self, *exc):
        for key, fn in self.WRAPPERS.items():
            setattr(self.ops, fn, self.saved[key])


def _train_run(torch, np, ops, ref, arch: str, Bn: int, S: int, frames: int,
               steps: int, lr: float, seed: int, card: str) -> tuple:
    """``arch`` at full width trained ``steps`` AdamW steps (peak ``lr``,
    one warm-up step, cosine) at B ``Bn`` x ``S`` text tokens with remat on,
    on one fixed TokenStream batch from ``seed`` (Whisper's ``frames``
    encoder frames and a VLM's patch embeddings, float32 normals x 0.02,
    beside it): step 1's loss and grad norm first with the plain float32
    attention patched in (before the optimizer's moments exist, so that
    it fits beside the weights and gradients), then every step through
    the kernels; the loss of the last step below the first's; each
    training kernel's launches counted over the steps and held to
    ``_want_launches`` and by shape (``_ShapeTally``).  An arch of
    TRAIN_LAYERS runs its first layers only, ``reduced=`` on its lines.
    With MoE layers, the routing decisions of step 1 on the two paths
    compared and the steps' pairs and drops (``moe_stats``); a hybrid's
    forwards without a gradient on the initial weights (``_eval_check``:
    float32, and the eval step in bfloat16) against the plain step 1's
    float32 loss.  Prints four lines and more.  Returns (params, opt
    state, launches, launches by shape)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.training import trainer as T
    from repro_torch.training.optimizer import (AdamWConfig, global_norm,
                                                init_opt_state)
    from repro_torch.models import ffn as F
    dev = torch.device("cuda")
    cfg = get_config(arch)
    red = ""
    if arch in TRAIN_LAYERS:
        red = f" reduced=num_layers:{TRAIN_LAYERS[arch]}/{cfg.num_layers}"
        cfg = dataclasses.replace(cfg, num_layers=TRAIN_LAYERS[arch])
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.trainable(M.init_params(cfg, gen, torch.float32, dev))
    batch = T.batch_to(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=Bn,
        seed=seed)).batch(), dev)
    routes = {"plain": [], "kernels": []}
    moe_route = F.moe_route

    def recorded(path):
        def route(p, cfg_, xf):
            out = moe_route(p, cfg_, xf)
            routes[path].append(out[1].detach().clone())
            return out
        return route
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.randn((Bn, frames, cfg.d_model),
                                      generator=gen, device=dev) * 0.02
    if cfg.frontend == "vit_patch_stub":
        batch["patch_embeds"] = torch.randn(
            (Bn, cfg.num_patches, cfg.d_model), generator=gen,
            device=dev) * 0.02
    positions = Bn * (S + (cfg.num_patches
                           if cfg.frontend == "vit_patch_stub" else 0))
    # step 1 with the plain attention and WKV recurrence, then the same
    # weights through the kernels (the trainer's only route)
    # (RWKV6: the loss alone, its forward; its grad norm is held at
    # WKV_STEP1_LAYERS layers, _wkv_shallow_step1)
    wkv = cfg.attention_type == "none"
    kernels = (ops.flash_prefill, ops.Wkv6Fn, ops.SelectiveScanFn)
    ops.flash_prefill = _plain_attention(torch, ref)
    ops.Wkv6Fn = _plain_wkv(torch, ref)
    ops.SelectiveScanFn = _plain_scan(torch, ref)
    F.moe_route = recorded("plain")
    try:
        t0 = time.perf_counter()
        if wkv:
            plain = (M.forward_train(params, cfg, batch)[0].item(), None)
        else:
            loss, grads = T.loss_and_grads(params, cfg, batch, remat=True)
            plain = (loss.item(), global_norm(grads).item())
            del loss, grads
        plain_s = time.perf_counter() - t0
    finally:
        ops.flash_prefill, ops.Wkv6Fn, ops.SelectiveScanFn = kernels
        F.moe_route = moe_route
    _free_memory(torch)
    if cfg.arch_type == "hybrid":
        _eval_check(torch, ops, T, M, arch, red, cfg, params, batch,
                    plain[0], card)
    step = T.make_train_step(cfg, AdamWConfig(
        lr=lr, warmup_steps=1, total_steps=steps), remat=True)
    opt = init_opt_state(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    F.moe_stats.reset()
    losses, gnorms, times = [], [], []
    with _ShapeTally(ops) as tally:
        for i in range(steps):
            t0 = time.perf_counter()
            F.moe_route = recorded("kernels") if i == 0 else moe_route
            try:
                with _WkvCapture(ops, WKV_STEP1_CALLS if i == 0 else ()
                                 ) as cap:
                    params, opt, m = step(params, opt, batch)
                    torch.cuda.synchronize()
            finally:
                F.moe_route = moe_route
            times.append(time.perf_counter() - t0)
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            if i == 0:
                captured = cap.calls
    counts = ops.launches.snapshot()
    moe = F.moe_stats.snapshot()
    peak = torch.cuda.max_memory_allocated()
    losses = [x.item() for x in losses]
    gnorms = [x.item() for x in gnorms]
    steady = statistics.mean(times[1:])
    want = _want_launches(cfg, steps)
    frontend = (f" frames={frames}" if cfg.is_encoder_decoder else
                f" patches={cfg.num_patches}"
                if cfg.frontend == "vit_patch_stub" else "")
    log(f"phase=train arch={arch}{red} layers={cfg.num_layers} "
        f"d_model={cfg.d_model} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        f"vocab={cfg.vocab_size} B={Bn} S={S}{frontend} steps={steps} "
        f"lr={lr:g} remat=True losses={[round(x, 5) for x in losses]} "
        f"grad_norms={[round(x, 5) for x in gnorms]} card=[{card}]")
    log(f"phase=train arch={arch}{red} step1_ms={times[0] * 1e3:.1f} "
        f"ms_per_step={steady * 1e3:.1f} (steps 2-{steps}) "
        f"tokens_per_s={Bn * S / steady:.1f} (text tokens; "
        f"{positions / steady:.1f} decoder positions) "
        f"peak_mem_gb={peak / 1e9:.3f} launches_per_step "
        + " ".join(f"{k}={counts.get(k, 0) / steps:g}" for k in want)
        + f" card=[{card}]")
    log(f"phase=train arch={arch}{red} launches_per_step_by_shape "
        + json.dumps({k: {sh: n / steps for sh, n in c.items()}
                      for k, c in tally.calls.items()})
        + f" card=[{card}]")
    if moe["readbacks"]:
        # each path routes in the forward and again in remat's rerun
        diff = sum(int((a != b).sum()) for a, b in zip(routes["plain"],
                                                       routes["kernels"]))
        total = sum(a.numel() for a in routes["plain"])
        log(f"phase=train arch={arch}{red} moe pairs_per_step="
            f"{moe['pairs'] / steps:g} dropped_per_step="
            f"{moe['dropped'] / steps:g} readbacks_per_step="
            f"{moe['readbacks'] / steps:g} step1_routing_decisions="
            f"{total} differing_kernels_vs_plain={diff} (calls "
            f"{len(routes['plain'])} and {len(routes['kernels'])}) "
            f"card=[{card}]")
        if len(routes["plain"]) != len(routes["kernels"]) or not total:
            raise AssertionError(f"train {arch}: the two step 1s routed "
                                 f"{len(routes['plain'])} and "
                                 f"{len(routes['kernels'])} times")
    del routes
    loss_rel = abs(losses[0] - plain[0]) / abs(plain[0])
    gn_rel = (0.0 if wkv else abs(gnorms[0] - plain[1]) / abs(plain[1]))
    log(f"phase=train arch={arch}{red} step1 kernel_loss={losses[0]:.6f} "
        f"plain_loss={plain[0]:.6f} rel={loss_rel:.3e} (bar "
        f"{TRAIN_LOSS_RTOL}) kernel_grad_norm={gnorms[0]:.6f} "
        + (f"plain_grad_norm=None (held at {WKV_STEP1_LAYERS} layers: "
           f"float32 does not determine this gradient at full depth)"
           if wkv else f"plain_grad_norm={plain[1]:.6f} rel={gn_rel:.3e} "
           f"(bar {TRAIN_GNORM_RTOL})")
        + f" plain_{'forward' if wkv else 'step'}_s={plain_s:.2f} "
        f"card=[{card}]")
    if any(counts.get(k, 0) != n for k, n in want.items()):
        raise AssertionError(f"train {arch}: launches {counts} are not "
                             f"{want}")
    if not all(np.isfinite(losses + gnorms)) or losses[-1] >= losses[0]:
        raise AssertionError(f"train {arch}: the loss did not fall: "
                             f"{losses}")
    # RWKV6's float32 gradient at full depth is ill-conditioned (PERF.md
    # §6, PR 28; the precision phase): its grad norm is held at
    # WKV_STEP1_LAYERS layers instead, and each captured WKV backward
    # of the full-depth step against the plain one on its own inputs
    if loss_rel > TRAIN_LOSS_RTOL or gn_rel > TRAIN_GNORM_RTOL:
        raise AssertionError(f"train {arch}: step 1 disagrees with the "
                             f"plain attention's")
    if wkv:
        _wkv_captured_check(torch, ops, ref, arch, captured,
                            cfg.num_layers, card)
        del captured
        _free_memory(torch)
        _wkv_shallow_step1(torch, ops, ref, arch, Bn, S, seed, card)
    return params, opt, counts, tally.calls


def _eval_check(torch, ops, T, M, arch, red, cfg, params, batch,
                plain: float, card) -> None:
    """A hybrid's forward without a gradient on the card, both ways the
    trainer runs one: in float32 (the training scan, kernel C, once a
    Mamba layer, and never the serve's bf16-only scan) against ``plain``,
    the plain step 1's float32 loss of the same params, within
    TRAIN_LOSS_RTOL; and the trainer's eval step (the layers cast to
    bfloat16 one at a time, the float32 leaves kept; the serve's scan
    once a Mamba layer, the training scan never) against that float32
    loss within EVAL_RTOL.  Prints the device memory the eval step adds
    over the weights beside the largest layer's bfloat16 copy and the
    whole model's (a copy of every layer at once would add the
    latter)."""
    n = sum(M.layer_kind(cfg, i) == "mamba" for i in range(cfg.num_layers))
    ops.launches.reset()
    with torch.no_grad():
        want = M.forward_train(params, cfg, batch, remat=False)[0].item()
    f32_counts = dict(ops.launches.counts)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.launches.reset()
    got = T.make_eval_step(cfg)(params, batch).item()
    added = torch.cuda.max_memory_allocated() - base
    bf16_counts = dict(ops.launches.counts)
    sizes = [sum(t.numel() for t in T.tree_leaves(layer)) * 2
             for layer in params["layers"]]
    f32_rel = abs(want - plain) / abs(plain)
    rel = abs(got - want) / abs(want)
    scans = {k: (c.get("selective_scan", 0), c.get("selective_scan:train", 0))
             for k, c in (("float32", f32_counts), ("bf16", bf16_counts))}
    log(f"phase=train arch={arch}{red} no_grad_float32_loss={want:.6f} "
        f"plain_step1_loss={plain:.6f} rel={f32_rel:.3e} (bar "
        f"{TRAIN_LOSS_RTOL}) eval_step_loss={got:.6f} rel={rel:.3e} (bar "
        f"{EVAL_RTOL}) scan_launches_(all,train)={json.dumps(scans)} "
        f"eval_added_gb={added / 1e9:.3f} largest_layer_bf16_gb="
        f"{max(sizes) / 1e9:.3f} all_layers_bf16_gb={sum(sizes) / 1e9:.3f} "
        f"card=[{card}]")
    if scans != {"float32": (n, n), "bf16": (n, 0)}:
        raise AssertionError(f"train {arch}: the forwards without a "
                             f"gradient launched the scans {scans}, not "
                             f"the training scan in float32 and the "
                             f"serve's in bf16, {n} each")
    if not f32_rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train {arch}: the float32 forward's loss "
                             f"{want} is not the plain step's {plain}")
    if not rel <= EVAL_RTOL:
        raise AssertionError(f"train {arch}: the eval step's loss {got} is "
                             f"not the float32 forward's {want}")


def phase_train(torch, np, ops, ref, timer, seed: int) -> tuple:
    """flash_prefill_bwd and the forward's lse against their plain
    versions at BWD_CASES, at the qwen2-0.5b training run's shape and at
    TRAIN_CASES (timed beside SDPA), then qwen2-0.5b at full width and
    depth trained TRAIN_STEPS AdamW steps (B TRAIN_B, S TRAIN_S) and a
    checkpoint's save and restore, then each of TRAIN_RUNS trained
    TRAIN_RUN_STEPS steps (``_train_run``: step 1 held against the plain
    attention, the loss falling, every attention's launches counted).
    Each "path=train" case's record gets the runs' launches at its shape,
    and every shape the runs launch must have such a case.  Returns
    ({kernel: {case: result}}, launches of the runs summed)."""
    from repro_torch.configs import get_config
    from repro_torch.training import trainer as T
    from repro_torch.training.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    t_phase = time.perf_counter()
    card = _card()
    dev = torch.device("cuda")
    results = {}
    cfg = get_config(TRAIN_ARCH)
    train_shape = ("path=train", TRAIN_B, TRAIN_S, cfg.num_heads,
                   cfg.num_kv_heads, cfg.head_dim)
    cases = [(label if label == "path=train" else f"case={label}", Bn, S,
              S, Hq, Hkv, D, D, True)
             for label, Bn, S, Hq, Hkv, D in BWD_CASES + (train_shape,)]
    for i, (label, Bn, Sq, Sk, Hq, Hkv, D, Dv, causal) in enumerate(
            cases + list(TRAIN_CASES)):
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + i)
        q, do = (torch.randn((Bn, Sq, Hq, d), generator=gen,
                             device=dev).to(torch.bfloat16) for d in (D, Dv))
        k, v = (torch.randn((Bn, Sk, Hkv, d), generator=gen,
                            device=dev).to(torch.bfloat16) for d in (D, Dv))
        mode = ("mla" if (D, Dv) == (96, 64) else
                "d112" if (D, Dv) == (112, 112) else
                "noncausal" if not causal else None)
        names = ((f"flash_prefill_bwd:{mode}", f"flash_prefill:lse_{mode}")
                 if mode else ("flash_prefill_bwd", "flash_prefill:lse"))
        for name, case in (
                (names[0], case_flash_bwd(torch, ops, ref, q, k, v, do,
                                          D ** -0.5, causal)),
                (names[1], case_flash_lse(torch, ops, ref, q, k, v,
                                          D ** -0.5, causal))):
            res = run_case("train", label, name, case, timer, device=True)
            results.setdefault(name, {})[label] = res
        _fwd_bwd_line(torch, ops, timer, label, q, k, v, do, results, card,
                      names, causal)
        del q, k, v, do
    _free_memory(torch)
    for i, (label, Bn, S, lens) in enumerate(WKV_TRAIN_CASES):
        gen = torch.Generator(device=dev).manual_seed(seed + 200 + i)
        args = _wkv_train_inputs(torch, gen, Bn, S, lens)
        for name, case in (
                ("wkv6:train", case_wkv_train(torch, ops, ref, *args[:6])),
                ("wkv6_bwd", case_wkv_bwd(torch, ops, ref, *args,
                                          label))):
            results.setdefault(name, {})[label] = run_case(
                "train", label, name, case, timer, device=True)
        del args
        _free_memory(torch)
    _wkv_near_zero_decays(torch, ops, ref, seed)
    for i, (label, Bn, S, lens) in enumerate(SCAN_TRAIN_CASES):
        gen = torch.Generator(device=dev).manual_seed(seed + 300 + i)
        args = _scan_train_inputs(torch, gen, Bn, S, lens)
        for name, make in (
                ("selective_scan:train",
                 lambda: case_scan_train(torch, ops, ref, *args[:7])),
                ("selective_scan_bwd",
                 lambda: case_scan_bwd(torch, ops, ref, *args, label))):
            results.setdefault(name, {})[label] = run_case(
                "train", label, name, make(), timer, device=True)
            _free_memory(torch)
        del args
        _free_memory(torch)

    totals: dict = {}
    by_shape = {key: {} for key in _ShapeTally.WRAPPERS}
    runs = [(TRAIN_ARCH, TRAIN_B, TRAIN_S, 0, TRAIN_STEPS, 1e-3)] + [
        (arch, Bn, S, frames, TRAIN_RUN_STEPS, TRAIN_RUN_LR)
        for arch, (Bn, S, frames) in TRAIN_RUNS.items()]
    for arch, Bn, S, frames, steps, lr in runs:
        params, opt, counts, calls = _train_run(
            torch, np, ops, ref, arch, Bn, S, frames, steps, lr, seed, card)
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        for k, c in calls.items():
            for shape, n in c.items():
                by_shape[k][shape] = by_shape[k].get(shape, 0) + n
        if arch == TRAIN_ARCH:
            _checkpoint_check(torch, T, params, save_checkpoint,
                              restore_checkpoint, card)
        del params, opt
        _free_memory(torch)
    # each path=train record's launches: the runs' at its shape; the
    # tally's sum must be the wrappers' count, every shape the runs
    # launched must have a parity line, and every such line a launch
    for key, calls in by_shape.items():
        recs = [r for name, cases in results.items() if name.startswith(key)
                for label, r in cases.items()
                if label.split()[0] == "path=train"]
        for r in recs:
            r["launches"] = calls.get(r["shape"], 0)
        if (sum(calls.values()) != totals.get(key, 0)
                or set(calls) - {r["shape"] for r in recs}
                or not all(r["launches"] for r in recs)):
            raise AssertionError(
                f"train: {key} launched {calls} ({totals.get(key, 0)} "
                f"counted) against the parity lines at "
                f"{sorted(r['shape'] for r in recs)}")
    log(f"phase=train seconds={time.perf_counter() - t_phase:.1f} "
        f"card=[{card}]")
    return results, totals


def _checkpoint_check(torch, T, params, save_checkpoint, restore_checkpoint,
                      card: str) -> None:
    """A checkpoint of the params saved and restored equal."""
    ck_dir = REPO / "src" / "repro_torch" / "_build" / "train_ckpt"
    ck_dir.mkdir(parents=True, exist_ok=True)
    ck = ck_dir / "ckpt.npz"
    t0 = time.perf_counter()
    try:
        save_checkpoint(str(ck), {"params": params}, TRAIN_STEPS)
        back, at = restore_checkpoint(str(ck), {"params": params})
        same = at == TRAIN_STEPS and all(
            torch.equal(a, b) for a, b in zip(
                T.tree_leaves(params), T.tree_leaves(back["params"])))
        size = ck.stat().st_size
    finally:
        ck.unlink(missing_ok=True)
    log(f"phase=train checkpoint bytes={size} restored_equal={same} "
        f"seconds={time.perf_counter() - t0:.1f} card=[{card}]")
    if not same:
        raise AssertionError("train: the restored params differ")
    del back


# --- the calibrate phase: H100_80G's measured fields ---

def phase_calibrate(torch, ops) -> None:
    """The cost model's transfer and launch fields on this card, each
    printed beside H100_80G's (serving/costmodel.py): a CAL_LINK_BYTES
    pinned-to-device copy (host_link_bw), CAL_COPIES copy_ calls of one
    CAL_COPY_BYTES block each from pinned memory, their views made before
    (per_copy_overhead: a call's time beyond its bytes at that rate),
    CAL_LAUNCHES gather_blocks_hkv launches of one block, back to back
    (what one fused launch costs the wall clock: kernel_launch_overhead),
    these two host-timed ones the best of CAL_PASSES passes (the host's
    own cost, the least disturbed by the machine's other work), the fused
    gather_blocks_hkv at the fp serve's shape (its rate over the link's:
    link_eff_fused), the device's and the host's memory.  Fails where one
    is off by more than CAL_RATIO (a wrong unit, not noise)."""
    import os
    from repro_torch.serving.costmodel import H100_80G as hw
    card = _card()
    dev = torch.device("cuda")
    host = torch.empty(CAL_LINK_BYTES, dtype=torch.uint8, pin_memory=True)
    buf = torch.empty(CAL_LINK_BYTES, dtype=torch.uint8, device=dev)
    link_ms = events_ms(torch, lambda: buf.copy_(host, non_blocking=True),
                        reps=5)
    link = CAL_LINK_BYTES / (link_ms * 1e-3)
    del host, buf
    n = CAL_COPY_BYTES // 4
    src = torch.randn((CAL_COPIES, n)).pin_memory()
    dst = torch.empty((CAL_COPIES, n), device=dev)
    pairs = list(zip(dst.unbind(0), src.unbind(0)))   # views made once

    def copies() -> float:
        t0 = time.perf_counter()
        for d, s_ in pairs:
            d.copy_(s_, non_blocking=True)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / CAL_COPIES
    copies()
    per_copy = min(copies() for _ in range(CAL_PASSES))
    overhead = per_copy - CAL_COPY_BYTES / link
    H, NB, bs, D, K = CAL_GATHER
    gen = torch.Generator().manual_seed(0)
    pool = torch.randn((H, NB, bs, D), generator=gen).pin_memory()
    idx = torch.randperm(NB, generator=gen)[:K].to(torch.int32).to(dev)
    one = idx[:1].contiguous()
    def launches() -> float:
        t0 = time.perf_counter()
        for _ in range(CAL_LAUNCHES):
            ops.gather_blocks_hkv(pool, one)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / CAL_LAUNCHES
    launches()
    launch = min(launches() for _ in range(CAL_PASSES))
    g_ms = events_ms(torch, lambda: ops.gather_blocks_hkv(pool, idx),
                     reps=50)
    g_bytes = H * K * bs * D * 4
    eff = g_bytes / (g_ms * 1e-3) / link
    measured = {
        "hbm_capacity": float(torch.cuda.get_device_properties(0)
                              .total_memory),
        "host_capacity": float(os.sysconf("SC_PAGE_SIZE")
                               * os.sysconf("SC_PHYS_PAGES")),
        "host_link_bw": link, "per_copy_overhead": overhead,
        "kernel_launch_overhead": launch, "link_eff_fused": eff}
    log(f"phase=calibrate link_copy_bytes={CAL_LINK_BYTES} link_ms="
        f"{link_ms:.4f} copies={CAL_COPIES}x{CAL_COPY_BYTES}B "
        f"per_copy_us={per_copy * 1e6:.3f} launches={CAL_LAUNCHES} "
        f"gather H={H} K={K} bs={bs} D={D} float32 bytes={g_bytes} "
        f"gather_ms={g_ms:.5f} gather_gb_per_s={g_bytes / g_ms / 1e6:.3f} "
        f"card=[{card}]")
    bad = []
    for field, value in measured.items():
        spec = getattr(hw, field)
        ratio = value / spec
        log(f"phase=calibrate field={field} measured={value:.6g} "
            f"H100_80G={spec:.6g} ratio={ratio:.3f} card=[{card}]")
        if not 1 / CAL_RATIO <= ratio <= CAL_RATIO:
            bad.append(field)
    if bad:
        raise AssertionError(f"calibrate: H100_80G's {bad} off by more "
                             f"than {CAL_RATIO}x from this card")


# --- the mesh phase: the port's multi-rank bodies over torch.distributed --

def _mesh_blocks(bs: int) -> int:
    """The context-parallel decode's pool, in blocks of ``bs``: the
    prompt and every step's token, rounded up to MESH_WORLD (the same
    pool at every world size)."""
    nb = -(-(MESH_PROMPT + MESH_STEPS) // bs)
    return -(-nb // MESH_WORLD) * MESH_WORLD


def _digest(torch, t) -> str:
    """sha1 of a tensor's bytes (on the host), 16 hex digits."""
    t = t.detach().contiguous().cpu()
    return hashlib.sha1(t.view(torch.uint8).numpy().tobytes()).hexdigest()[
        :16]


def _mesh_decode(torch, ref, M, dsa_mod, params, cfg, feed, state, pm):
    """MESH_STEPS decode steps fed ``feed`` (steps, B): the single-device
    path (``pm`` None; each attention layer's selection from
    ``dsa.score_and_select``) or the context-parallel one (from
    ``dsa.select_blocks`` on the gathered scores, with their plain select
    scores; and per layer the q and local metadata ``dsa.score_blocks``
    scored, the tokens in the cache, the merged attention output and its
    scale, kept on the card for ``_mesh_exact``).  Returns {"logits":
    (steps, B, V) float32 on the host, "sel": per step, per attention
    layer (ids, valid, select scores or None) on the host, "scored": per
    step and layer [q, local meta, tokens in the cache, o, scale],
    "step_ms": host ms a step with these captures, synchronised}."""
    spies, layer_sels, scored = {}, [], []

    def spy_select(*args, **kw):
        idx, valid = spies["select"](*args, **kw)
        s_ref = None
        if pm is not None:
            scores, dcfg, n_tokens = args
            s_ref = ref.select_scores(scores, n_tokens,
                                      block_size=dcfg.block_size,
                                      sink_blocks=dcfg.sink_blocks,
                                      recent_blocks=dcfg.recent_blocks)
            scored[-1].append(n_tokens.clone())
        layer_sels.append((idx, valid, s_ref))
        return idx, valid

    def spy_score(q, meta, *args, **kw):
        scored.append([q.clone(), meta.clone()])
        return spies["score"](q, meta, *args, **kw)

    def spy_attend(*args):
        o, idx = spies["attend"](*args)
        scored[-1] += [o.clone(), args[-1]]
        return o, idx
    names = {"select": (dsa_mod, "score_and_select" if pm is None
                        else "select_blocks")}
    if pm is not None:
        names["score"] = (dsa_mod, "score_blocks")
        names["attend"] = (M.attn, "_cp_select_attend")
    spy = {"select": spy_select, "score": spy_score, "attend": spy_attend}
    for key, (mod, name) in names.items():
        spies[key] = getattr(mod, name)
        setattr(mod, name, spy[key])
    logits, sels = [], []
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(MESH_STEPS):
            lg, state = M.decode_step(params, cfg, feed[step], state,
                                      plane_mesh=pm)
            logits.append(lg.float().cpu())
            sels.append([tuple(None if t is None else t.cpu() for t in x)
                         for x in layer_sels])
            layer_sels.clear()
        step_ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
    finally:
        for key, (mod, name) in names.items():
            setattr(mod, name, spies[key])
    return {"logits": torch.stack(logits), "sel": sels, "scored": scored,
            "step_ms": step_ms}


def _mesh_exact(torch, ops, ref, mesh_mod, cfg, pm, run, caches) -> tuple:
    """Each step's and layer's select and attention of the
    context-parallel run against the single-device stages on the same
    inputs.  The select: the q it scored and the whole pool's metadata
    (its shards gathered) through ``score_select``, held tie-aware
    (select_agrees) against the plain select scores of that metadata.
    The attention: the merged output against ``sparse_decode_attention``
    over the whole pools (each layer's shards of ``caches`` gathered after
    the run: a step reads only positions below its length, which later
    appends do not touch) on the same q, ids and validity, by relative
    L2 (MESH_ATTEND_REL_L2).  Made after the run's launches are read.
    Returns (select agreeing, compared, largest score difference,
    largest attention relative L2)."""
    d = cfg.dsa
    kw = dict(block_size=d.block_size, top_k=d.top_k_blocks,
              sink_blocks=d.sink_blocks, recent_blocks=d.recent_blocks)
    n_layer = len(run["sel"][0])
    flat = [sel for step in run["sel"] for sel in step]
    agree, err, rel = 0, 0.0, 0.0
    for layer in range(n_layer):
        full = {key: mesh_mod.all_gather(caches[layer][key], 2,
                                         pm.model_group)
                for key in ("k", "v") if key in caches[layer]}
        for i in range(layer, len(flat), n_layer):
            q, meta, n_tokens, o, scale = run["scored"][i]
            idx, valid, _ = flat[i]
            full_meta = mesh_mod.all_gather(meta, 2, pm.model_group)
            want = ops.score_select(q, full_meta, n_tokens - 1, **kw)
            s_ref = ref.select_scores(ref.block_score(q, full_meta),
                                      n_tokens, block_size=d.block_size,
                                      sink_blocks=d.sink_blocks,
                                      recent_blocks=d.recent_blocks)
            idx, valid = idx.to(q.device), valid.to(q.device)
            ok, e = select_agrees(torch, (idx, valid), want, s_ref)
            agree += ok
            err = max(err, e)
            single = ops.sparse_decode_attention(
                q, full["k"], full.get("v", full["k"]), idx, valid,
                n_tokens, scale=scale)
            rel = max(rel, _rel_l2(torch, o.float(), single.float()))
        del full
    run.pop("scored")
    return agree, len(flat), err, rel


def _mesh_cp(torch, pm, arch: str, layers: int, seed: int, oracle: bool,
             keep: bool) -> dict:
    """The context-parallel decode body at ``arch``'s full width and
    ``layers`` of its layers: full weights and prompts from the seed,
    the plain prefill's pools (bf16, _mesh_blocks blocks), this rank's
    shard of them, MESH_STEPS steps over it; with ``oracle`` the
    single-device decode first, on the same weights, pools and tokens.
    ``keep``: return the logits and selections (else their digests)."""
    from repro_torch.configs import get_config
    from repro_torch.core import dsa as dsa_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import sharding
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(cfg, gen)
    toks = torch.randint(4, cfg.vocab_size, (MESH_B, MESH_PROMPT),
                         generator=gen, device=dev, dtype=torch.int32)
    feed = torch.randint(4, cfg.vocab_size, (MESH_STEPS, MESH_B),
                         generator=gen, device=dev, dtype=torch.int32)
    nb = _mesh_blocks(cfg.dsa.block_size)
    res = {"weights": _digest(torch, params["layers"][0]["attn_norm"])
           + _digest(torch, params["embed"][:64]), "nb": nb}
    with torch.no_grad():
        _, state = M.prefill(params, cfg, {"tokens": toks}, nb)
        shard = sharding.decode_state_shard(state, pm)
        res["nb_loc"] = int(shard["caches"][0]["k"].shape[2])
        if oracle:
            res["oracle"] = _mesh_decode(torch, ref, M, dsa_mod, params, cfg,
                                         feed, state, None)
            res["oracle"].pop("scored")
        del state
        ops.launches.reset()
        run = _mesh_decode(torch, ref, M, dsa_mod, params, cfg, feed, shard,
                           pm)
        torch.cuda.synchronize()
        res["launches"] = ops.launches.snapshot()
        res["exact"] = _mesh_exact(torch, ops, ref, mesh_mod, cfg, pm, run,
                                   shard["caches"])
    res["digest"] = _digest(torch, run["logits"])
    res["step_ms"] = run["step_ms"]
    if keep:
        res["run"] = run
    return res


def _mesh_sp(torch, pm, seed: int, oracle: bool, keep: bool) -> dict:
    """The sequence-parallel prefill layer (MESH_SP) on a window of
    random bf16 hidden states; with ``oracle`` the replicated layer
    first."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    arch, Bn, T = MESH_SP
    cfg = dataclasses.replace(get_config(arch), num_layers=1)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    p = M.init_params(cfg, gen)["layers"][0]
    h = torch.randn((Bn, T, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    pos = torch.arange(T, dtype=torch.int32, device=dev).expand(Bn, T)
    tmask = torch.ones((Bn, T), dtype=torch.bool, device=dev)
    smask = torch.ones((Bn,), dtype=torch.bool, device=dev)
    res = {}
    with torch.no_grad():
        if oracle:
            x, (k, v) = M.prefill_attn_layer_batched(p, cfg, h, pos, tmask,
                                                     smask)
            res["oracle"] = {"x": x.cpu(), "k": k.cpu(), "v": v.cpu()}
        ops.launches.reset()
        x, (k, v) = M.prefill_attn_layer_batched(p, cfg, h, pos, tmask,
                                                 smask, plane_mesh=pm)
        torch.cuda.synchronize()
        res["launches"] = ops.launches.snapshot()
    res["digest"] = _digest(torch, x) + _digest(torch, k)
    if keep:
        res["run"] = {"x": x.cpu(), "k": k.cpu(), "v": v.cpu()}
    return res


def _mesh_ep(torch, pm, seed: int, oracle: bool, keep: bool) -> dict:
    """The expert-parallel MoE layer (MESH_EP), drop-free as the serve
    runs it: full weights from the seed, this rank's experts and rows;
    with ``oracle`` the single-device ``moe_apply`` and routing first."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding
    from repro_torch.models import ffn
    arch, Bn, S = MESH_EP
    cfg = get_config(arch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    p = ffn.init_moe_params(cfg, gen, torch.bfloat16, dev)
    x = torch.randn((Bn, S, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    res = {}
    with torch.no_grad():
        if oracle:
            y, aux = ffn.moe_apply(p, cfg, x, drop_free=True)
            gates, experts, _ = ffn.moe_route(p, cfg, x.reshape(-1,
                                                                cfg.d_model))
            res["oracle"] = {"y": y.cpu(), "aux": float(aux),
                             "routing": _digest(torch, experts)
                             + _digest(torch, gates)}
        local = sharding.expert_shard(p, pm)
        del p
        torch.cuda.empty_cache()
        y, aux, (gates, experts) = ffn.moe_apply_ep(
            local, cfg, sharding.shard_rows(x, pm), pm=pm, drop_free=True,
            return_routing=True)
        torch.cuda.synchronize()
    res.update(digest=_digest(torch, y), aux=float(aux),
               routing=_digest(torch, experts) + _digest(torch, gates),
               experts_local=int(local["w_gate"].shape[0]))
    if keep:
        res["run"] = {"y": y.cpu()}
    return res


def _mesh_collective_ms(torch, mesh_mod, pm, reps: int = 10) -> dict:
    """Host ms a call of each collective the bodies run, on the model
    group, over 4 MB of float32 on the card (synchronised after each
    call; on gloo the tensors are staged through host memory)."""
    x = torch.ones((1 << 20,), device="cuda")
    calls = {"all_reduce_sum": lambda: mesh_mod.all_reduce_sum(
                 x.clone(), pm.model_group),
             "all_reduce_max": lambda: mesh_mod.all_reduce_max(
                 x.clone(), pm.model_group),
             "all_gather": lambda: mesh_mod.all_gather(x, 0, pm.model_group)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        out[name] = round((time.perf_counter() - t0) / reps * 1e3, 4)
    return out


def _mesh_rank(rank: int, world: int, backend: str, workdir: str,
               seed: int, oracle: bool = False) -> None:
    """One rank of the mesh phase (this process, or one spawned by it):
    join the ``backend`` group of ``world`` ranks (a file store in
    ``workdir``), lay it out as (1, world), run every body, write the
    results to ``workdir``.  gloo's ranks share cuda:0; NCCL's rank r
    drives cuda:r."""
    import torch
    if str(REPO / "src") not in sys.path:
        sys.path.insert(0, str(REPO / "src"))
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch.plane_mesh import PlaneMesh
    torch.cuda.set_device(rank if backend == "nccl" else 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = f"{backend}{world}"
    pm = PlaneMesh(mesh_mod.init_local(
        rank, world, backend, f"file://{workdir}/store_{tag}", model=world,
        timeout_s=MESH_BUDGET_S))
    keep = rank == 0
    out = {"device": str(torch.cuda.current_device()),
           "collective_ms": _mesh_collective_ms(torch, mesh_mod, pm)}
    try:
        for arch, layers in MESH_CP:
            out[f"cp {arch}"] = _mesh_cp(torch, pm, arch, layers, seed,
                                         oracle, keep)
            _free_memory(torch)
        out["sp"] = _mesh_sp(torch, pm, seed, oracle, keep)
        _free_memory(torch)
        out["ep"] = _mesh_ep(torch, pm, seed, oracle, keep)
        _free_memory(torch)
    finally:
        mesh_mod.close()
    torch.save(out, f"{workdir}/{tag}_rank{rank}.pt")


def _mesh_launch_check(tag: str, body: str, ranks: list, want: tuple) -> list:
    """Each rank's launches of ``want`` in a body; fails where one is 0."""
    got = [{k: r[body]["launches"].get(k, 0) for k in want} for r in ranks]
    zero = [(i, k) for i, c in enumerate(got) for k, n in c.items() if not n]
    if zero:
        raise AssertionError(f"mesh {tag} {body}: kernels not launched by "
                             f"(rank, kernel) {zero}: {got}")
    return got


def _mesh_cp_check(torch, tag: str, arch: str, layers: int, ranks: list,
                   oracle: dict) -> None:
    """A run's context-parallel decode against the oracle (bars in the
    module docstring, 10a)."""
    from repro_torch.configs import get_config
    body = f"cp {arch}"
    lead = ranks[0][body]
    kinds = ("sparse_decode_attention:partial", "block_score") + (
        ("block_score:wide",) if get_config(arch).attention_type == "mla"
        else ())
    launches = _mesh_launch_check(tag, body, ranks, kinds)
    replicated = len({r[body]["digest"] for r in ranks}) == 1
    run, ref_run = lead["run"], oracle["oracle"]
    rel = [_rel_l2(torch, run["logits"][s], ref_run["logits"][s])
           for s in range(MESH_STEPS)]
    got_tok = run["logits"].argmax(-1)
    o = ref_run["logits"]
    top2 = o.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]) / o.pow(2).mean(-1).sqrt()
    differ = got_tok != o.argmax(-1)
    excused = [(s, b) for s, b in differ.nonzero().tolist()
               if gap[s, b] < ORACLE_REL_L2]
    # against the oracle's selections: at each step's first attention
    # layer both runs score the same q and pools; deeper, the earlier
    # layers' bf16 outputs differ, and so do q and the new keys
    first = ora = 0
    for s_ in range(MESH_STEPS):
        for layer, ((idx, valid, s_ref), (o_idx, o_valid, _)) in enumerate(
                zip(run["sel"][s_], ref_run["sel"][s_])):
            ok = select_agrees(torch, (idx, valid), (o_idx, o_valid),
                               s_ref)[0]
            ora += ok
            first += ok and layer == 0
    n_layer = len(run["sel"][0])
    exact = [r[body]["exact"] for r in ranks]
    log(f"phase=mesh body=cp arch={arch} {tag} reduced=num_layers:{layers}/"
        f"{get_config(arch).num_layers} B={MESH_B} prompt={MESH_PROMPT} "
        f"nb={lead['nb']} nb_loc={lead['nb_loc']} "
        f"K={get_config(arch).dsa.top_k_blocks} steps={MESH_STEPS} "
        f"logits_rel_l2_max={max(rel):.3e} bar={ORACLE_REL_L2:.5f} "
        f"greedy_equal={int((~differ).sum())}/{differ.numel()} "
        f"excused_steps={excused} select_exact_by_rank="
        f"{[f'{a}/{n}' for a, n, _, _ in exact]} select_score_err="
        f"{max(x[2] for x in exact):.3e} attend_rel_l2_max="
        f"{max(x[3] for x in exact):.3e} attend_bar="
        f"{MESH_ATTEND_REL_L2:.6f} oracle_select_first_layer="
        f"{first}/{MESH_STEPS} oracle_select_all_layers={ora}/"
        f"{MESH_STEPS * n_layer} replicated={replicated} "
        f"step_ms_with_captures="
        f"{[round(r[body]['step_ms'], 3) for r in ranks]} "
        f"launches_by_rank={json.dumps(launches)}")
    if max(rel) > ORACLE_REL_L2 or len(excused) < int(differ.sum()) or \
            any(a < n or r > MESH_ATTEND_REL_L2 for a, n, _, r in exact) \
            or first < MESH_STEPS or not replicated:
        raise AssertionError(f"mesh {tag} cp {arch}: outside its bars")


def _mesh_body_checks(torch, tag: str, ranks: list, oracle: dict) -> None:
    """A run's sequence-parallel prefill layer and expert-parallel MoE
    against the oracle."""
    sp, sp_o = ranks[0]["sp"]["run"], oracle["sp"]["oracle"]
    rel = {k: _rel_l2(torch, sp[k].float(), sp_o[k].float())
           for k in ("x", "k", "v")}
    launches = _mesh_launch_check(tag, "sp", ranks, ("flash_prefill",))
    replicated = len({r["sp"]["digest"] for r in ranks}) == 1
    arch, Bn, T = MESH_SP
    log(f"phase=mesh body=sp arch={arch} {tag} reduced=num_layers:1 B={Bn} "
        f"window={T} pad={(-T) % len(ranks)} rel_l2="
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} "
        f"bar={MESH_LAYER_REL_L2:.6f} replicated={replicated} "
        f"launches_by_rank={json.dumps(launches)}")
    if max(rel.values()) > MESH_LAYER_REL_L2 or not replicated:
        raise AssertionError(f"mesh {tag} sp: outside its bars")
    ep, ep_o = ranks[0]["ep"], oracle["ep"]["oracle"]
    rel_y = _rel_l2(torch, ep["run"]["y"].float(), ep_o["y"].float())
    routing = {r["ep"]["routing"] for r in ranks} == {ep_o["routing"]}
    replicated = len({r["ep"]["digest"] for r in ranks}) == 1
    aux_err = abs(ep["aux"] - ep_o["aux"])
    arch, Bn, S = MESH_EP
    log(f"phase=mesh body=ep arch={arch} {tag} reduced=one_moe_layer "
        f"tokens={Bn}x{S} experts_a_rank={ep['experts_local']} "
        f"drop_free=True rel_l2={rel_y:.3e} bar={MESH_LAYER_REL_L2:.6f} "
        f"routing_identical={routing} replicated={replicated} "
        f"aux={ep['aux']:.6f} aux_err={aux_err:.3e}")
    if rel_y > MESH_LAYER_REL_L2 or not routing or not replicated or \
            aux_err > 1e-5 * max(1.0, abs(ep_o["aux"])):
        raise AssertionError(f"mesh {tag} ep: outside its bars")


def phase_mesh(torch, seed: int) -> dict:
    """The mesh phase (module docstring, 10a).  Returns this process's
    launches (NCCL at world 1) summed over its bodies."""
    import shutil
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    _free_memory(torch)
    runs = [("gloo", MESH_WORLD)]
    if torch.cuda.device_count() >= 2:
        runs.append(("nccl", 2))
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    ctx = mp.get_context("spawn")
    procs = []
    try:
        for backend, world in runs:      # the spawned ranks start first
            for r in range(world):
                procs.append(ctx.Process(target=_mesh_rank, args=(
                    r, world, backend, work, seed)))
                procs[-1].start()
        _mesh_rank(0, 1, "nccl", work, seed, oracle=True)
        for proc in procs:
            proc.join(max(1.0, t0 + MESH_BUDGET_S - time.perf_counter()))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise AssertionError(f"mesh: spawned ranks exited {codes}")
        load = {f"{b}{w}": [torch.load(f"{work}/{b}{w}_rank{r}.pt",
                                       weights_only=False)
                            for r in range(w)]
                for b, w in [("nccl", 1)] + runs}
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        shutil.rmtree(work, ignore_errors=True)
    oracle = load["nccl1"][0]
    for key, ranks in load.items():
        backend, world = key[:-1], int(key[-1])
        where = ("cuda:0 (this process)" if world == 1 else
                 "cuda:0 (both ranks)" if backend == "gloo" else
                 "cuda:0,cuda:1")
        tag = f"backend={backend} world={world} ranks_on=[{where}]"
        for arch, layers in MESH_CP:
            if {r[f"cp {arch}"]["weights"] for r in ranks} != {
                    oracle[f"cp {arch}"]["weights"]}:
                raise AssertionError(f"mesh {tag}: ranks built other "
                                     f"weights")
            _mesh_cp_check(torch, tag, arch, layers, ranks,
                           oracle[f"cp {arch}"])
        _mesh_body_checks(torch, tag, ranks, oracle)
    counts: dict = {}
    for body in [f"cp {a}" for a, _ in MESH_CP] + ["sp"]:
        for k, n in oracle[body]["launches"].items():
            counts[k] = counts.get(k, 0) + n
    wall = time.perf_counter() - t0
    ran = ", ".join(f"{k[:-1]} world {k[-1]}" for k in load)
    log("phase=mesh collective_ms_4MB_by_run="
        + json.dumps({k: [r["collective_ms"] for r in ranks]
                      for k, ranks in load.items()}))
    log(f"phase=mesh wall_s={wall:.1f} budget_s={MESH_BUDGET_S:.0f} "
        f"ran=[{ran}] nccl_world2="
        + ("ran" if len(runs) > 1 else
           f"not run ({torch.cuda.device_count()} card)")
        + " (no time here is a multi-GPU figure: gloo's ranks share one "
        f"card) card=[{_card()}]")
    if wall > MESH_BUDGET_S:
        raise AssertionError(f"mesh: {wall:.1f} s past its "
                             f"{MESH_BUDGET_S:.0f} s budget")
    return counts


def _tied_serve(torch, np, ops, seed: int, cfg, twin_cfg, tag: str
                ) -> dict:
    """The tied serve against its untied twin fed its tokens (module
    docstring, 10b); returns the tied run's launches."""
    from repro_torch.models import model as M
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = M.init_params(cfg, gen, torch.bfloat16, "cuda")
    if "lm_head" in params:
        raise AssertionError("tied: init_params made an lm_head leaf")
    twin = dict(params, lm_head=params["embed"].T.contiguous())
    t0 = time.perf_counter()
    tied = _oracle_run(torch, np, ops, params, cfg, seed, TIED_NEW,
                       n=TIED_REQUESTS)
    wall = time.perf_counter() - t0
    ref_run = _oracle_run(torch, np, ops, twin, twin_cfg, seed, TIED_NEW,
                          n=TIED_REQUESTS, force=tied["tokens"])
    rel, excused, equal, n = 0.0, [], 0, 0
    for i, (got, want) in enumerate(zip(tied["logits"], ref_run["logits"])):
        for step, (g, w) in enumerate(zip(got, want)):
            rel = max(rel, _rel_l2(torch, g.float(), w.float()))
            top2 = w.float().topk(2).values
            gap = float((top2[0] - top2[1]) / w.float().pow(2).mean().sqrt())
            n += 1
            if tied["tokens"][i][step] == int(w.argmax()):
                equal += 1
            elif gap < ORACLE_REL_L2:
                excused.append((i, step))
    want_k = ("flash_prefill", "score_select", "sparse_decode_attention")
    zero = [k for k in want_k if not tied["counts"].get(k)]
    log(f"{tag} path=serve requests={TIED_REQUESTS} prompt={SERVE_PROMPT} "
        f"new={TIED_NEW} vs=untied_twin(lm_head=embed.T copy, fed the tied "
        f"tokens) logits_rel_l2_max={rel:.3e} bar={TIED_LOGITS_REL_L2:.6f} "
        f"greedy_equal={equal}/{n} excused_steps={excused} "
        f"wall_s={wall:.3f} "
        f"launches={json.dumps({k: tied['counts'].get(k, 0) for k in want_k})}")
    if rel > TIED_LOGITS_REL_L2 or equal + len(excused) < n or zero:
        raise AssertionError(f"tied serve: outside its bars (kernels not "
                             f"launched: {zero})")
    return tied["counts"]


def _tied_train(torch, seed: int, cfg, twin_cfg, tag: str) -> None:
    """Training step 1 of the tied model against its untied twin, then
    two AdamW steps (module docstring, 10b)."""
    from repro_torch.data.pipeline import DataConfig, TokenStream
    from repro_torch.models import model as M
    from repro_torch.training import trainer as T
    from repro_torch.training.optimizer import (AdamWConfig, global_norm,
                                                init_opt_state)
    dev = torch.device("cuda")
    batch = T.batch_to(TokenStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_S, global_batch=TRAIN_B,
        seed=seed)).batch(), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.trainable(M.init_params(cfg, gen, torch.float32, dev))
    t0 = time.perf_counter()
    loss, grads = T.loss_and_grads(params, cfg, batch, remat=True)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    twin = dict(params, lm_head=params["embed"].detach().T.clone()
                .requires_grad_(True))
    loss_u, g_u = T.loss_and_grads(twin, twin_cfg, batch, remat=True)
    del twin
    # leaves in sorted-key order: the twin's are the tied ones + lm_head
    head = g_u.pop().T
    embed_only = _rel_l2(torch, grads[0], g_u[0])
    g_u[0] = g_u[0] + head
    rel = [_rel_l2(torch, g, w) for g, w in zip(grads, g_u)]
    loss_rel = abs(loss.item() - loss_u.item()) / abs(loss_u.item())
    norm, norm_u = global_norm(grads).item(), global_norm(g_u).item()
    del grads, g_u, head
    _free_memory(torch)
    opt = init_opt_state(params)
    step = T.make_train_step(cfg, AdamWConfig(lr=1e-3))
    losses = []
    for _ in range(2):      # the second step's loss: the first one's effect
        params, opt, m = step(params, opt, batch)
        losses.append(m["loss"].item())
    log(f"{tag} path=train B={TRAIN_B} S={TRAIN_S} float32 remat=True "
        f"vs=untied_twin(lm_head=embed.T copy) loss={loss.item():.6f} "
        f"loss_rel_err={loss_rel:.3e} grad_norm={norm:.6f} "
        f"twin_grad_norm={norm_u:.6f} grad_rel_l2_max={max(rel):.3e} "
        f"embed_grad_rel_l2={rel[0]:.3e} bar={TIED_GRAD_REL_L2:.0e} "
        f"twin_embed_alone_rel_l2={embed_only:.3e} step1_s={step_s:.2f} "
        f"adamw_losses={[round(x, 6) for x in losses]}")
    if (max(rel) > TIED_GRAD_REL_L2 or loss_rel > TIED_GRAD_REL_L2
            or embed_only <= TIED_GRAD_REL_L2
            or abs(losses[0] - loss.item()) > TIED_GRAD_REL_L2
            * abs(loss.item()) or not losses[1] < losses[0]):
        raise AssertionError("tied train: outside its bars")


def phase_tied(torch, np, ops, seed: int) -> dict:
    """Tied embeddings at qwen2-0.5b's full width and depth, served and
    trained against the untied twin (module docstring, 10b).  Returns the
    tied serve's launches."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    twin_cfg = get_config(TIED_ARCH)
    cfg = dataclasses.replace(twin_cfg, tie_embeddings=True)
    tag = (f"phase=tied arch={TIED_ARCH} tie_embeddings=True(by "
           f"dataclasses.replace: no registry config ties them) "
           f"layers={cfg.num_layers} vocab={cfg.vocab_size}")
    counts = _tied_serve(torch, np, ops, seed, cfg, twin_cfg, tag)
    _free_memory(torch)
    _tied_train(torch, seed, cfg, twin_cfg, tag)
    _free_memory(torch)
    log(f"phase=tied seconds={time.perf_counter() - t0:.1f} "
        f"card=[{_card()}]")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of build,parity,transfer,"
                         "serve,serve_int8,oracles,models,obs,async,"
                         "contract,mesh,tied,train,calibrate (serve "
                         "and serve_int8 include their mainpath replays; "
                         "serve_int8 needs serve) plus the optional "
                         "profile, profile_int8 and precision")
    args = ap.parse_args()
    phases = args.phases.split(",")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (REPO / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO / "src"))
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.build import LIBS
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    secs = LIBS.build()
    regs = {k: " | ".join(line.split("ptxas info    : ")[-1]
                          for line in v.splitlines() if "registers" in line)
            for k, v in LIBS.ptxas_info.items()}
    log(f"phase=build seconds={secs:.1f} rebuilt={LIBS.rebuilt} "
        f"ptxas={json.dumps(regs)}")
    for name in REGISTER_WATCH:
        for line in LIBS.ptxas_info[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"phase=build kernel={name} ptxas: "
                    + line.split("ptxas info    : ")[-1].strip())
    timer = Timer(torch)
    parity, mainpath, counts, caps = {}, {}, {}, {}
    t_start, marks = time.perf_counter(), {"build": secs}

    def mark(name: str, t0: float) -> None:
        marks[name] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    if "parity" in phases:
        parity = phase_parity(torch, ops, ref, timer, args.seed)
        mark("parity", t0)
    t0 = time.perf_counter()
    if "transfer" in phases:
        mainpath, counts["transfer"] = phase_transfer(torch, ops, ref, timer,
                                                      args.seed)
        mark("transfer", t0)
    t0 = time.perf_counter()
    if "serve" in phases:
        fp, caps["serve"] = phase_serve(torch, np, ops, ref, args.seed)
        counts["serve"] = fp["counts"]
        if "serve_int8" in phases:
            q8, caps["serve_int8"] = phase_serve_int8(torch, np, ops,
                                                      args.seed, fp)
            counts["serve_int8"] = q8["counts"]
        mainpath.update(phase_mainpath(torch, ops, ref, timer, caps))
        caps.clear()
        mark("serve", t0)
    t0 = time.perf_counter()
    if "oracles" in phases:
        o_counts, caps = phase_oracles(torch, np, ops, args.seed)
        counts.update(o_counts)
        for name, cases in phase_mainpath(torch, ops, ref, timer,
                                          caps).items():
            mainpath.setdefault(name, {}).update(cases)
        caps.clear()
        mark("oracles", t0)
    t0 = time.perf_counter()
    if "models" in phases:
        m_counts, m_replays = phase_models(torch, np, ops, ref, timer,
                                           args.seed)
        counts.update(m_counts)
        for name, cases in m_replays.items():
            mainpath.setdefault(name, {}).update(cases)
        mark("models", t0)
    t0 = time.perf_counter()
    if "obs" in phases:
        phase_obs(torch, np, ops, args.seed)
        mark("obs", t0)
    t0 = time.perf_counter()
    if "async" in phases:
        phase_async(torch, np, args.seed)
        mark("async", t0)
    t0 = time.perf_counter()
    if "contract" in phases:
        # after every guarded serve of the run, whose windows it reads
        phase_contract(torch, np, args.seed)
        mark("contract", t0)
    t0 = time.perf_counter()
    if "mesh" in phases:
        counts["mesh"] = phase_mesh(torch, args.seed)
        mark("mesh", t0)
    t0 = time.perf_counter()
    if "tied" in phases:
        counts["tied"] = phase_tied(torch, np, ops, args.seed)
        mark("tied", t0)
    t0 = time.perf_counter()
    # after the serves whose host times it could disturb (its 2.5 GB
    # checkpoint write, the 1 GiB pinned buffer of calibrate)
    if "train" in phases:
        t_results, counts["train"] = phase_train(torch, np, ops, ref, timer,
                                                 args.seed)
        for name, cases in t_results.items():
            mainpath.setdefault(name, {}).update(cases)
        mark("train", t0)
    t0 = time.perf_counter()
    if "calibrate" in phases:
        phase_calibrate(torch, ops)
        mark("calibrate", t0)
    records = kernel_records(parity, mainpath, counts)
    if "precision" in phases:
        phase_precision(torch, ops, ref, args.seed)
    if "profile" in phases:
        phase_profile(torch, np, args.seed)
    if "profile_int8" in phases:
        phase_profile(torch, np, args.seed, "int8")
    log(f"phase=timing seconds_by_phase={json.dumps(marks)} after_build="
        f"{time.perf_counter() - t_start:.1f} card=[{_card()}]")
    log(json.dumps({"kernels": records}))
    log(_card())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
