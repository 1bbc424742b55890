#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and hold its kernels to their
plain versions.

Run from the repository root on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device — the card, the software versions, the ``nvcc`` build of
   every kernel from ``src/repro_torch/kernels/csrc``, each kernel's
   registers and spills (``ptxas``) and its tensor-core instructions
   (``HMMA``, ``HGMMA`` in ``cuobjdump -sass``), which the bf16 forms of
   B1-B8 must have (``HMMA`` for B1, B2, and B4, B6 and B7 on bf16 and on
   int8 caches, in each of their forms; ``HGMMA`` for B3, B5 and B8);
2. fp32 checks — each kernel against its plain version in fp32 on small
   ragged shapes (padding, kv tails, a sliding window, ragged decode; for
   the paged kernels shuffled page tables, kv_len 0, 1 and mid-page, a
   later chunk's q_offset, a ragged last chunk, GQA group 2; for B7
   ragged candidate rows, a block straddling a tile, one ending at the
   table's capacity), and the int8 branches of B4-B7 on int8 caches; B8
   (the SSD intra-chunk step) on whole and ragged chunks and the chunked
   scan with an initial state and a ragged length, each output row
   within 1e-4 of its norm;
3. kernels — each kernel against its plain version at the shapes the main
   paths give it (internlm2-1.8b widths, bf16 queries; decode also through
   ``ops.decode_attention`` at each wave's kv_len, as the model calls it;
   paged decode over a batch of 8 whose kv_lens spread over 1-3600 of a
   4096-token budget, paged prefill of 512-row chunks at q_offset 0 and
   3072 (and, checked but not timed, at q_offset 1000 with kv_len 1400
   ending mid-page), paged verify of 4 candidate rows a slot ending at
   those kv_lens,
   on pools of 2049 pages), on bf16 caches and again on int8 caches with
   their scales, B8 at the 4 x 2048 mamba2-130m wave's 768 cells, and
   B3 and B4 at head dim 256 at the hybrid wave's shapes (B3 on the 1 x
   8000 prompt under the 2048-token window, B4 on 4 sequences over a
   full ring of 2048 rows, bf16 and int8, with their registers, spills
   and tensor-core instructions; B3 again as a split rank calls it,
   8192 Q rows at q_offset 2047 after a 2047-row window halo,
   ``flash_e256_halo``),
   every output row within about one bf16 rounding of its norm, with its
   time, the plain version's, the bound for its work on the card, and
   one PyTorch call computing the same function (timed as a yardstick
   only; int8 caches are dequantized first; none computes B8's); B2 also
   at 1 x 4096 (blk_q 8, its transposed form), and B1-B3, B5 and B8 with
   their achieved TFLOP/s (B8's row also with its registers, spills and
   tensor-core instructions); each B1, B2 and B3 row also carries
   ``tune_attention``'s choice and estimate (``est_ms``, the
   max-of-streams model at the card's published peaks) for its call,
   whose route must be ``ops.resolve_method``'s. Paged prefill takes its
   (q_offset, kv_len) as an int32 pair on the device. A kernel's and its
   yardstick's ``ms`` and ``library_ms`` are the back-to-back loop's mean
   time, which holds the host's dispatch wherever the card runs faster
   than the host enqueues; beside them, device time (``device_ms``,
   ``library_device_ms``: each call timed by CUDA events behind a
   device-side wait that hides the host's enqueueing) and how many calls
   it had to repeat or drop (``device_retries``, ``device_dropped``); B4,
   B6 and B7 state their split (``n_split``, ``tiles_per_split``);
4. main path (waves) — full-width internlm2-1.8b (random weights from a
   seed) served by the port's ``ServingEngine`` in three waves whose
   prompts the shared-memory policy routes to the resident MAS, streamed
   MAS and flash kernels; every kernel's launch count must rise, and each
   wave's prefill logits are held to the plain attention path;
5. int8 wave — the 4 x 2048 wave again with ``kv_dtype="int8"``, decode
   through B4's int8 branch; token agreement with the bf16 wave;
6. continuous — the same model served by ``ContinuousBatchingEngine``
   (batch 8, 4096-token budget, 16-token pages, 512-token chunks, the
   default pool of 2049 pages): 16 requests of 32 tokens with prompts of
   32-3500 tokens must all finish through the paged prefill and decode
   kernels, two first-token logits are held to the plain attention path,
   the same requests are served again under an injected pool-exhaustion
   burst with a pool auditor (a preemption, no failure, no leaked page),
   and at full width with 2 layers in fp32 the continuous engine on the
   kernels, on plain attention, under the burst, and the wave engine must
   emit the same greedy tokens. It prints TTFT and inter-token gaps,
   tokens/s, steps by kind, peak memory and launches. Then calibration:
   the first 8 requests served again with an enabled ``Tracer``, the
   trace checked by ``validate_chrome_trace`` and its step spans joined
   (``compare_report``) with the simulator's ``serving_phase_workloads``
   of the same prompts on the paper's edge NPU (``EDGE_HW``), whose
   ``decode`` and ``prefill_chunk`` ratios must be finite;
7. int8 continuous — the same 16 requests on int8 pools (half the bytes
   of the bf16 pools), two first-token logits held to the bf16 pools',
   and a faulted rerun under the auditor;
8. shared prefix — the continuous engine with ``prefix_cache=True`` at
   the same settings: 16 requests of 32 new tokens, all at once, a
   publisher (a 2008-token shared system prompt and 992 tokens of its
   own), two prompts resident whole in its pages (2500 tokens, ending
   mid-page, and 2400, on a page boundary: each must be admitted by a
   copy-on-write page copy and decode at once), eleven that share the
   system prompt and add 16-1500 tokens (each must map at least 2000
   tokens from cache and prefill from q_offset 2000) and two cold ones;
   the peak pages must fall below the same requests' with the cache off,
   and every hit's first-token logits, caught on the device as the engine
   draws the token, lie within the continuous phase's limit of the cold
   serve's; then under the exhaustion burst with a pool auditor (a
   preemption, no failure, a drained pool holding retained prefixes
   only), on int8 pools (the hits' first-token logits, the copied scales
   among their inputs, held to the bf16 cold serve's as in phase 7), and
   at full width with 2 layers in fp32, where prefix on, off and under a
   burst emit the same greedy tokens. It prints TTFT from admission for
   hits and misses, tokens/s, ``prefix_stats``, peak pages and peak
   memory with the cache on and off;
9. speculative — 16 requests with ``spec_depth=4`` whose prompts repeat
   one random 64-token span to the continuous phase's lengths, on bf16
   and on int8 pools, each beside the plain serve of the same prompts:
   acceptance, tokens a verify step, verify step time, tokens/s, B7
   launches;
10. fp32 speculative parity — at full width with 2 layers in fp32,
   speculative tokens equal plain continuous tokens on fp32 pools, on
   int8 pools and under an exhaustion burst;
11. sharded — the same model served by ``ShardedContinuousBatchingEngine``
   with its KV heads split over ranks, one process a rank
   (``torch.multiprocessing`` spawn; NCCL with a card a rank where the
   machine has as many cards, else gloo with every rank on card 0, whose
   CUDA all-gather and broadcast are probed first): degree 2 on bf16 and
   int8 pools and speculative (``spec_depth=4``, both pools), degree 4 on
   bf16 pools, the continuous (or speculative) phase's 16 requests and
   settings, at full depth with a card a rank and at SHARD_SHARED_LAYERS
   (2 of 24) where the ranks share one card. Each rank builds the
   weights from seed 0 (their checksum must equal the parent's), and its
   tokens must equal the single-card serve's at the same depth bit for
   bit, no step's result may differ from rank 0's and
   its B5/B6/B7 launch counts must rise. One line a run: backend, cards,
   degree, gathered bytes, mismatches, peak memory and wall a rank. The
   kernels phase adds B5, B6 and B7 (bf16 and int8 pools) on 4 and 2 of
   the 8 KV heads, the rows the sharded path launches: a head slice's
   call with the model's split plan equals the full call's slice bit for
   bit, with its own plan the difference is recorded. Then the
   head-block ring (``chunk_route="ring"``, ``distributed/paged.
   ring_paged_prefill``: every chunk's Q rows split over the ranks, each
   rank's heads' pages gathered into a slab that passes round the ring,
   a hop of B5 on each slab for its head slot) on the continuous phase's
   16 requests at 2 of the 24 layers (RING_LAYERS): degree 2 on bf16 and
   int8 pools, degree 4 on bf16, and degree 2 at FP32_LAYERS in fp32;
   the tokens must equal the single-card serve's at that depth bit for
   bit where the B5_ring rows (below) found a hop's rows the single
   card's B5 rows bit for bit (else the first-token logits are held to
   the bf16 single card's within LOGITS_RTOL, int8 INT8_LOGITS_RTOL, and
   the differing tokens counted), the fp32 tokens always; each rank's
   passes and slab bytes must be the shapes', and its B5 launches n per
   layer a chunk. The kernels phase adds the B5_ring rows
   (``paged_prefill_ring``, bf16 and int8 pools): a hop of the last rank
   of two, every head slot in turn on a slab of 4 heads with an identity
   table, held to its plain version, the rank's assembled rows beside two
   planted faults (hops writing each other's head slots, a skipped hop)
   the rows limit must reject, and each hop against the single card's B5
   rows (the bitwise verdict). ``python3 chip_smoke.py --only sharded``
   runs the build, these rows and this phase alone;
11b. seq_sharded — the reference's sequence-sharding serving policy
   (``distributed/ctx.sharding_policy``, sp_rep for a small dense
   prefill, tp_sp otherwise), one process a rank as in phase 11, sp_rep
   weights whole on every rank but the MoE experts, tp_sp weights the
   rank's split of every leaf (``local_params(policy="tp_sp")``, each
   layer all-gathered whole just before its use): internlm2-1.8b at
   degrees 2 and 4 through ``launch/dryrun.run_cell`` — prefill_32k (1 x
   32768, its batch of 32 cut to 1; sp_rep; ``ring_attention``) and 16
   decode steps of seeded tokens on the split cache of 32784 rows
   (blocks of 16392 or 8196 rows against prompt rows of 16384 or 8192),
   decode_32k (tp_sp, on split weights; batch 8, its 128 cut; a cache of
   32768 rows holding 32766 seeded rows; 2 steps of
   ``sharded_decode_attention``, 8 before the weights were split) — each
   step's logits within LOGITS_RTOL of the single card's (kernel route)
   and layer 0's attention rows within BF16_ROW_RTOL of the single
   card's, a planted fault (the last rank skips rank 0's block on the
   ring; rank 0's decode partial left out of the combine) rejected by
   the rows limit, the logits gate's verdict on it recorded, no
   attention kernel launched and the ring's or combine's bytes counted;
   decode_32k's split logits bitwise those of the same cell on whole
   weights, its weight gathers the bytes the shapes give; an fp32 run at
   2 layers, a 4096-token prompt, whose greedy tokens equal the single
   card's plain route's; then deepseek-moe-16b at full width at degree
   2 (full depth with a card a rank, SEQ_MOE_SHARED_LAYERS of its 28
   layers where the ranks share one card), each rank holding 32 of the 64 experts and its split of
   the dense leaves (drawn whole in turn from seed 0, so two ranks fit
   one card), 4 x 2048 and 4 decode steps (16 before its dense weights
   were split), against the single card's plain route in the same token
   groups (``ctx.grouped_as``): each layer's dropped assignments of the
   rank's group within 2·top_k per differing route of the single
   card's (the routes that differ counted), the logits within
   LOGITS_RTOL; then deepseek-coder-33b decode_32k at full width at
   degree 4: whole weights at a batch of 2, cut in place to each rank's
   split, the same cell again (bitwise logits), then 16 sequences
   (decode_32k's 128 cut), at full depth with a card a rank and at the
   depth ``coder_plan`` fits (at most 2 layers: the gathers go through
   host memory) with four ranks on one card, stated in the line; then
   the recurrent stacks, whose layers exchange boundary rows (``halo``:
   a conv's 3 input rows, a window's K/V) and scan carries (``carry``)
   and decode on states split by channel and head: mamba2-130m at full
   width and depth, a 1 x 524288 prompt (long_500k's length) at degree 4
   and 1 x 32768 at degree 2, B8 on each rank's chunks, with 16 decode
   steps after each, then decode_32k (its full batch of 128) and
   long_500k from seeded states at degree 4; recurrentgemma-9b
   prefill_32k at batch 1 (32 cut) at degrees 2 and 4, B3 at head dim 256
   on each rank's rows after a window halo, decode_32k at batch 8 (128
   cut) and long_500k at degree 4, at full depth on split weights with a
   card a rank and at SEQ_HYBRID_SHARED_LAYERS on whole weights when four
   ranks share one card; each against the single card's kernel route
   (``recurrent_yardsticks``, whose 1 x 524288 prefill's peak memory is
   recorded): first-token and step logits within LOGITS_RTOL, the first
   layer of each kind's rows within BF16_ROW_RTOL of the single card's
   rows at the same positions (``split_rows_gate``) with three planted
   faults (the last rank's carry zeroed, the conv halo zeroed, the window
   halo dropped; ``planted_split_fault``, on the first layers) rejected,
   every rank's logits the same bits, each cache leaf its
   ``cache_specs`` block, mamba2's split decode bitwise the single
   card's; an fp32 run of each (2 and 3 layers, a 4096-token prompt):
   tokens equal, first-token logits within SEQ_FP32_RTOL; then the
   frontend archs (``seq_frontend_runs``): whisper-large-v3 and
   internvl2-2b prefill_32k at batch 1 (32 cut) at degrees 2 and 4 (one
   clip of 1500 frames, each rank encoding its 1500 / n frames with B2
   over the K/V gathered whole, and 32768 tokens whose cross blocks run
   B2 over the memory gathered whole; 256 patch rows and 32512 tokens,
   the patch rows in the row split), 16 decode steps after each (the
   cross partials combined across ranks), decode_32k at batch 8 (128
   cut) from a seeded cache (whisper's memories 1500 rows) on split
   weights and again on whole, full depth with a card a rank and
   SEQ_FRONTEND_SHARED_LAYERS layers on one card; each against the
   single card's kernel route (``frontend_yardsticks``): logits within
   LOGITS_RTOL, whisper's encoder layer-0 rows, layer-0 cross rows and
   first decode step's cross rows and internvl2's layer-0 rows (patch
   rows included) within BF16_ROW_RTOL with the four FRONTEND_FAULTS
   (an encoder that attends its own frames, a cross block over its own
   memory block, rank 0's cross partial dropped, unshifted patch rows;
   ``planted_frontend_fault``, on the first decoder layer) rejected, B2
   once an encoder layer and once a cross block a rank, the cache leaves
   (memories too) and the bytes by kind the shapes', split-weight logits
   bitwise the whole weights'; an fp32 run of each at 2 layers (whisper:
   and 2 encoder layers): tokens equal, logits within SEQ_FP32_RTOL. Per
   run and rank: peak memory, prefill and decode-step device ms and
   wall, bytes sent by collective (ring, combine, a2a, gather, bcast,
   weights, halo, carry) and the bytes staged through host buffers.
   Last in the same spawn, the pipeline (``distributed/pipeline.py``,
   the reference's GPipe pipeline): deepseek-coder-33b at full width,
   bf16, seed-0 weights, 8 of its 62 layers (PIPE_LAYERS; the same with
   a card a rank), 2 a stage over the four ranks, drawn in turn; the
   embedded rows of 8 seeded sequences of 2048 tokens in 8 microbatches
   of 1, each block the full-sequence layer (``transformer._layer_
   train``, B2 at GQA group 7): a run with every B2 call held to its
   plain version beside a zeroed V tile (``attention_gate``), then a
   timed run with the launch counts and bytes set to 0 just before and
   read just after, then a run a planted fault (a stage that keeps its
   previous buffer at one tick; the stages holding their blocks in
   reverse order). Gates: every microbatch bit for bit the single card's
   ``sequential_apply`` of the same layers on it (computed here first),
   each fault failing that, the bytes by kind ``pipeline_bytes``' (11
   microbatches each way a rank, kind ``pipe``; the last stage's outputs
   broadcast, ``bcast``), B2 launched once a block. One ``{"phase":
   "pipeline", ...}`` line: per rank the device ms, wall, peak, the
   largest difference from ``sequential_apply`` of the whole batch
   (not gated), the stages' busy device ms and bubble share with a card
   a rank ("not measured" where the stages share one card), the card's
   name and power limit.
   ``python3 chip_smoke.py --only seq_sharded`` runs the build, the B3
   halo row, the B2 rank rows and this phase alone, ``--only
   seq_recurrent`` the same with the recurrent runs only (the halo row),
   ``--only seq_frontend`` with the frontend runs only (the B2 rank
   rows), ``--only seq_pipeline`` with the pipeline only;
12. moe — full-width, full-depth deepseek-moe-16b (28 layers, 64
   routed experts top-6 and 2 shared, capacity factor 1.25; bf16, random
   weights from seed 0 with the experts' down projections scaled by 1/16,
   since the MoE FFN takes the un-normalised residual and at the init's
   scale the residual overflows bf16 within 28 layers; ~33.3 GB) served
   by ``ServingEngine`` in waves of
   4 x 256 (B1) and 4 x 2048 (B2), 16 new tokens each (B4 at GQA group
   1), then by ``ContinuousBatchingEngine`` on the continuous phase's 16
   requests at its settings (B5, B6); every launch count must rise. Off
   the serves: each call kind's expert capacity and share of dropped
   (token, k) assignments from ``moe_route`` on each layer's inputs (a
   traced prefill and decode step a kind); on each wave's first prompt
   every B1/B2 call of the prefill and B4 call of a decode step, and every
   B5 call of one continuous request's chunks, held to the plain version
   on the same inputs (rows within BF16_ROW_RTOL) beside a zeroed V tile
   or page it must reject; the first-token logits held to the plain
   route at LOGITS_RTOL only where no (token, layer) pair's top-k experts
   differ between the routes, else recorded with that count; and at 2
   layers in fp32, at a capacity no call can overflow, the continuous
   engine on the kernels and on plain attention and the wave engine emit
   the same greedy tokens. It prints TTFT, tokens/s, step times, peak
   memory, ``init_s``, capacities and drop shares;
13. dense archs — phi4-mini-3.8b (GQA group 3) in waves of 4 x 256 and
   4 x 2048 and 8 continuous requests (B1, B2, B4, B5, B6), then
   deepseek-coder-33b (group 7, untied embeddings, ~66.7 GB) in a 1 x
   2048 wave (B2, B4), full width, each freed before the next; the 33B
   runs at full depth where ``torch.cuda.mem_get_info()`` shows room for
   its weights, its cache and 4 GiB, else at the depth that fits, stated
   as ``reduced``, then qwen3-1.7b (qk-norm, GQA group 2, a 151,936-entry
   vocabulary) as phi4-mini; each wave's first-token logits within
   LOGITS_RTOL of the plain route's;
14. ssm wave — full-width mamba2-130m (random weights from a seed)
   served by ``ServingEngine`` in three waves, 4 x 2048, 1 x 32768 and
   4 x 1000 (a ragged tail padded to a whole chunk), 16 new tokens each:
   24 B8 launches a wave, TTFT, tokens/s, decode step time and peak
   memory; on each wave's first prompt every B8 call of the prefill held
   to the plain version on its own inputs (rows within 1e-4) and each
   SSD layer, fed the plain route's input for it, held to the plain
   route (the chunked scan's fp32 rows within one bf16 rounding, 4e-3),
   each check beside a zeroed X tile it must reject; the bf16 first-token logits against the plain
   route are recorded, not held (a bf16 mamba2 with random weights moves
   them by a large part of any useful limit under fp32-rounding-size
   changes of B8), and must be finite; and at 2 layers in fp32 the
   kernel route's tokens equal the plain route's;
15. hybrid wave — full-width, full-depth recurrentgemma-9b (38 layers:
   26 RG-LRU blocks and 12 MQA attention layers of 16 heads of 256 over
   a 2048-token window, whose decode caches are rings of 2048 rows;
   bf16, random weights from seed 0; 7,483,486,208 parameters) served by
   ``ServingEngine`` in waves of 4 x 2048 (the ring filled exactly),
   1 x 8000 (rolled into the ring by 1856 slots) and 1 x 32768, and the
   4 x 2048 wave again on int8 caches, 16 new tokens each: B3's
   head-dim-256 form once an attention layer a prefill, B4's (bf16 or
   int8 caches) a decode step; TTFT, decode step, peak memory, and the
   ring slot the first decode row lands in (read back: 0, 1856, 0); on
   each wave's first prompt every B3 call of the prefill and B4 call of
   a decode step (bf16 and, on the first wave, int8) held to its plain
   version (B3's tiled plain version, which skips outside the window, in
   place of the dense oracle), each beside a zeroed V tile; the 4 x 2048
   and 1 x 8000 first-token logits within LOGITS_RTOL of the plain
   route's, the int8 ring's first decode logits within INT8_LOGITS_RTOL
   of the bf16 ring's; at full width with one unit and the tail (5
   layers) in fp32 the kernel route's tokens equal the plain route's;
16. encdec — full-width, full-depth whisper-large-v3 (32 encoder and 32
   decoder layers, d_model 1280, 20/20 heads of 64, vocab 51866; bf16,
   random weights from seed 0; 1,534,602,240 parameters) driven through
   the model API, as the engines take no frames: random stub frames (B,
   1500, 1280) from a numpy seed through ``encode`` (B2 non-causal at
   blk_q 32, Q rows padded to 1504, 1500 keys to 1536 under kv_len),
   then ``prefill`` (B1 causal self-attention, B2 cross-attention) and
   greedy ``decode_step``s (B4 at head dim 64 and group 1, and each
   layer's cross-attention on B2: one query row padded to blk_q 8 over
   the 1500 memory rows), for 4 clips with 4-token prompts and 1 clip
   with a 224-token prompt, 32 new tokens each, and the 4 clips again on
   an int8 self-attention cache (cross memories in bf16). Per wave:
   encode, prefill and decode-step times (host clock, and device time by
   CUDA events around each), peak memory and launches; B2's share of a
   decode step's device time (the step and its 32 B2 calls each timed
   behind a device-side wait). One gated encode, prefill and decode step
   (bf16 and int8) hold every B1, B2 and B4 call to its plain version on
   the model's inputs (rows within BF16_ROW_RTOL) beside a zeroed V tile
   of the (cross) memory and, for every non-causal call over a padded
   memory, a plain version that ignores kv_len and attends the zero rows
   of the padding; the first-token logits of both prompts within
   LOGITS_RTOL of the plain route's, the int8 cache's first decode
   logits within INT8_LOGITS_RTOL of bf16's; at 2 encoder and 2 decoder
   layers in fp32 the kernel route's tokens equal the plain route's;
17. vlm — full-width, full-depth internvl2-2b (24 layers, d_model 2048,
   16/8 heads of 128, vocab 92553; bf16, random weights from seed 0;
   1,699,598,336 parameters): 256 random stub patch embeddings before
   each prompt through ``prefill(frontend_embeds=)`` and ``decode_step``
   at positions 256 + i, waves of 4 x (256 + 256) and 4 x (256 + 2048)
   (B2), 16 new tokens each (B4 at group 2): TTFT, decode step, peak
   memory; each wave's first prompt's prefill and a decode step gated
   call by call as above, its first-token logits within LOGITS_RTOL of
   the plain route's; at 2 layers in fp32 the kernel route's tokens
   equal the plain route's;
18. launcher — ``repro_torch.launch.serve.main`` (the documented entry
   point) at full width, internlm2-1.8b, 8 requests on ``cuda``: each
   returns ``--max-new`` tokens in the vocabulary (run after phase 11,
   once internlm2's bf16 weights are freed); then the dry-run command
   line ``repro_torch.launch.dryrun.main``: its abstract mode over every
   cell at degree 4 (a record a cell, ok or skipped, each printing a
   rank's argument bytes and whether they fit the card), and ``--run``
   of mamba2-130m decode_32k at 8 sequences (its 128 cut) at degree 1 on
   ``cuda`` and at degree 2 (NCCL with two cards, else gloo on card 0),
   each with finite logits;
19. train (last, after every serving model is freed) — internlm2-1.8b
   at full width and depth trained by ``launch/steps.make_train_step``:
   fp32 master weights, bf16 compute, attention ``"chunked"`` (the
   kernels have no backward) in Q chunks of 1024 rows with each chunk and
   each layer rematerialised, AdamW with int8 gradient compression, 6
   steps of ``SyntheticLMData(seed=17)`` at train_4k's sequence of 4096
   and a global batch of 4 as two microbatches (train_4k's 256 cut to
   fit one card): per step the loss, grad norm, lr, wall, device ms
   (CUDA events) and peak memory; every loss and grad norm finite and the
   last loss below the first; a roofline line of the median step
   (``mfu``) and one more step under ``torch.profiler`` (busy share, the
   kernels that took longest). The trained weights then serve through
   the kernels under ``torch.no_grad()``: prefill logits of a 256- and a
   2048-token prompt (B1, B2) within BF16_ROW_RTOL of the ``"chunked"``
   route's rows, and a ServingEngine wave (B4) whose token agreement
   with the chunked route is recorded. At FP32_LAYERS full-width layers
   in fp32 (sequence 1024 in chunks of 384, the last padded):
   ``"chunked"`` with remat against ``"plain"`` without, every gradient
   leaf within 1e-4 of its norm; a ``"kernel"``
   forward on parameters that require grad raises and launches nothing;
   a checkpoint round trip (bf16 compute, int8 compression): an async
   save after step 2 restores parameters, moments and error feedback bit
   for bit, and the step after it gives the uninterrupted run's loss
   within 1e-3;
20. train_sharded (after train) — the train phase's model and settings
   trained across ranks under the reference's fsdp policy
   (``sharding_policy(shard, "fsdp")``), one process a rank: NCCL with a
   card a rank where the machine has four cards (full depth, a global
   batch of 8), else gloo with the four ranks on card 0 (2 of 24 layers,
   a global batch of 4; every gather and reduce-scatter through host
   memory). Each rank holds dim 0 of every matrix cut in n blocks, with
   its AdamW moments and int8 error feedback, and draws its own
   ``SyntheticLMData(seed=17)`` slice; degree 4 (grad_accum 1) and 2
   (grad_accum 2), 4 steps each, are held to the port's one-card
   ``make_train_step`` at the same depth on the ranks' batches
   concatenated (computed here first): each step's loss, grad norm and
   lr, every trained leaf over all ranks' blocks (bands
   TRAIN_SHARDED_RTOL, TRAIN_SHARDED_LEAF_RTOL), every rank's losses the
   same bits, each step's bytes by kind equal to ``fsdp_bytes``'s
   arithmetic; device ms, wall and peak memory a step and a rank, and a
   roofline line (``mfu``) of each degree. At FP32_LAYERS layers in fp32
   at degree 4, with labels masked unevenly over the ranks, without
   compression and with int8, each clean run within its bands
   (TRAIN_SHARDED_GATES: 1e-4, the grad norm 1e-5; with int8 the leaves
   2e-3), and each of FSDP_FAULTS planted (a layer's gradient left
   unreduced on a rank, whole leaves counted n times in the norm, int8
   scales from a rank's blocks, a per-rank loss mean) rejected. The
   degree-4 run's async sharded checkpoint after step 2 restores at
   degrees 2 and 3 and on one card bit for bit (each
   leaf's ``state_digest``), the next step at degree 2 and on one card
   within 1e-3 of the uninterrupted loss; its trained weights, saved
   sharded and restored whole, serve through B1/B2 (prefill logits within
   BF16_ROW_RTOL of the chunked route's rows) and a wave on B4, with the
   launch counts set to 0 just before and read just after.
21. train_tp_sp (after train_sharded) — deepseek-moe-16b at full width
   trained across ranks under the reference's tp_sp policy
   (``sharding_policy(shard, "tp_sp")``), one process a rank: NCCL with a
   card a rank where the machine has four cards (8 of 28 layers, a global
   batch of 2), else gloo with the four ranks on card 0 (2 layers, a
   global batch of 1). Every rank draws the whole batch (train_4k's 4096
   rows, ``SyntheticLMData(seed=17)``) and trains its rows of the
   sequence on its ``tp_sp`` split (its own experts) with its AdamW state
   and int8 error feedback, at degrees 4 and 2 (TRAIN_TP_SP_PLANS'
   steps): every loss and grad norm finite, every rank's losses the same
   bits, each step's bytes by kind equal to ``tp_sp_bytes``' arithmetic
   (the remat recompute's second gathers and exchanges counted); device
   ms, wall and peak a step and a rank, and a roofline line of each
   degree. In fp32 at degree 4 (TRAIN_TP_SP_FP32: 2 layers, 1 × 512) the
   same steps on one card under ``ctx.grouped_as(4)`` (the same MoE
   groups) hold loss, grad norm, lr and every leaf within
   TRAIN_TP_SP_GATES, the assignments routed apart from one card on the
   first batch counted, and each of TP_SP_FAULTS planted (expert
   gradients all-reduced as if whole, the router's left unreduced, the
   aux loss counted n times, a split leaf's gradient left unreduced on a
   rank) is rejected; internlm2-1.8b's odd batch (TRAIN_TP_SP_DENSE: 4
   layers, 3 × 512, degree 2) against one card likewise. The degree-4
   bf16 run's trained weights, saved sharded and restored whole, serve
   through B1/B2 (prefill logits within LOGITS_RTOL of the chunked
   route's where no (token, layer) routes apart) and a wave on B4, with
   the launch counts set to 0 just before and read just after: every
   B1/B2 call of each prefill, B4 call of a decode step and kernel call
   of the wave held to the plain version on the same inputs beside a
   planted zeroed V tile (``attention_gate``), and the wave's tokens
   equal to the chunked route's. Then the other stacks at full width
   (TRAIN_TP_SP_STACKS: mamba2-130m at full depth, recurrentgemma-9b's
   one (rec, rec, attn) period, whisper-large-v3 at 2 + 2 layers and
   internvl2-2b at 2 where the ranks share one card; a global batch of
   1, no compression),
   each at degree 4 in bf16 (finite losses, every rank the same bits,
   bytes by kind as ``tp_sp_bytes`` gives them, the halo and carry kinds
   and their backwards, whisper's encoder and memory gathers included;
   device ms, peak and a roofline line) and in fp32 against one card
   (TRAIN_TP_SP_STACK_FP32; the first batch's gradients too, mamba2's
   also under each of RECURRENT_FAULTS, a dropped halo or carry
   gradient, which that gate must reject by FAULT_MARGIN times); and
   internlm2-1.8b at a sequence degree 4 does not divide
   (TRAIN_TP_SP_ODD: 3 x 510, the rows whole on every rank). Each
   stack's trained weights, restored whole, serve through its kernels:
   every B8 call of a prefill (``b8_gate``), every B3 (head dim 256)
   call of recurrentgemma's prefill and B4 call of its decode step,
   whisper's B2 calls of the encoder and of the cross blocks and its B1,
   B2 and B4 calls, internvl2's prefill and B4 calls, each held to its
   plain version beside its planted fault.

Roofline lines: inside the phases that build each full-width model
(internlm2-1.8b in phase 4, qwen3-1.7b, phi4-mini-3.8b and
deepseek-coder-33b in 13, deepseek-moe-16b in 12, mamba2-130m in 14,
recurrentgemma-9b in 15, whisper-large-v3 in 16 with its encode,
internvl2-2b in 17), one prefill of a wave's prompts (4 x 2048; 1 x 2048
for deepseek-coder-33b; whisper's 4 clips; internvl2's 4 x (256 + 2048))
and 3 decode steps after it through the model API, each between CUDA
events, and the calibration serve's median decode-only step (internlm2's
continuous decode step), each print one ``{"phase": "roofline", ...}``
line from ``repro_torch.analysis.roofline.cell_roofline``: model flops
(causal) and least bytes at the card's peaks against the measured time,
as ``mfu`` and ``roofline_share``, each of which must lie in (0, 1.05].

Each serving path runs with the kernels' launch counts set to 0 just
before it and read just after, and fails unless its kernels launched.
The last three lines are the kernel table (B1-B8, the int8 branches of
B4-B7 and the head-dim-256 forms of B3 and B4, each with the launches of
its own paths: B1, B2 and B4 add the moe and dense-arch phases' to the
waves' (B2 also the pipeline's timed run's), B5 and B6 the shared-prefix, moe and dense-arch phases' to the
continuous phase's, the head-dim-256 forms the hybrid wave's, B1, B2 and
B4 also the encdec and vlm phases' and the train phases' trained
weights'; ``mas_streamed_cross``, B2 at a
whisper decode step's cross-attention shape, counts the B2 launches of
the encdec phase's decode steps; ``mas_streamed_enc_rank`` and
``mas_streamed_cross_rank``, B2 at a split whisper rank's encoder and
cross shapes (checked and timed in the kernels phase at both degrees),
count the B2 launches inside the seq_sharded phase's split encoders and
cross blocks; the ``*_shard`` rows of B5-B7 at a
rank's heads count every rank's launches of their kernel in the sharded
phase's local-route runs, the B5_ring rows every rank's B5 launches in
its ring runs), the card's
name and power limit, and the result. TF32 is switched off for matrix products and
convolutions so fp32 comparisons see fp32 arithmetic. The script exits
non-zero, printing no result, when there is no CUDA device or no port
beside it, or when any phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

ARCH = "internlm2-1.8b"
BATCH = 4
NEW_TOKENS = 16
MAX_LEN = 8256
# Prompt lengths the shared-memory policy routes to each prefill kernel
# at E = 128 in bf16 (core/policy.py): <= 320 resident, <= 6528 streamed.
WAVES = (("mas_resident", 256, BATCH), ("mas_streamed", 2048, BATCH),
         ("flash", 8192, 1))
DECODE_KV_LENS = (1, 300, 2060, 8207)   # a ragged decode batch
WAVE_KERNELS = ("mas_resident", "mas_streamed", "flash", "decode")
INT8_WAVE = 1            # the wave (4 x 2048) served again on an int8 cache

# The continuous engine's configuration and traffic.
CONT = dict(batch_size=8, max_len=4096, page_size=16, chunk_size=512)
CONT_REQUESTS = 16
CONT_NEW_TOKENS = 32
PROMPT_LENS = (32, 3500)            # drawn from default_rng(0), inclusive
BURST = frozenset({40, 41, 42, 43})  # appends that report exhaustion
FP32_LAYERS = 2
# Shared-prefix traffic, all at once with CONT_NEW_TOKENS each, in this
# order: a publisher (the shared system prompt, then its own tokens), two
# prompts resident whole in the publisher's pages (full hits: one ending
# mid-page, one on a page boundary), requests that share the system prompt
# and add suffixes (partial hits: 125 pages map, the prompt's last 8 shared
# tokens and the suffix prefill again from q_offset 2000), cold prompts.
PREFIX_SHARED = 2008
PREFIX_PUBLISHER = 3000
PREFIX_FULL_HITS = (2500, 2400)
PREFIX_SUFFIX_REQUESTS = 11
PREFIX_SUFFIX_LENS = (16, 1500)     # drawn from default_rng(5), inclusive
PREFIX_COLD_REQUESTS = 2
PREFIX_FP32_BURST = frozenset({5, 6, 7})
FP32_REQUESTS = 6
FP32_NEW_TOKENS = 16
FP32_PROMPT_MAX = 1500     # several 512-token chunks, three kernel routes
# Paged kernel shapes on the main path: 8 sequences over 2049 pages.
PAGED_DECODE_KV_LENS = (1, 17, 300, 1000, 1777, 2500, 3100, 3600)
# (q_offset, kv_len, timed) of 512-row chunks: the first, a later one that
# starts off the 64-row block grid and ends mid-page, and a late one
PAGED_PREFILL = ((0, 512, True), (1000, 1400, False), (3072, 3584, True))
# Speculative decoding: depth k, and the random span whose repetitions
# make the speculative phase's prompts (text that quotes its own context).
SPEC_DEPTH = 4
SPEC_SPAN = 64
# mamba2-130m through the wave engine: (prompt length, batch) of each
# wave: the main-path shape, the repo's prefill_32k length (the long
# context users run an SSM for) and a ragged length (1000 rows: three
# 256-row chunks and a tail padded to a whole chunk, ROADMAP C5).
SSM_ARCH = "mamba2-130m"
SSM_WAVES = ((2048, 4), (32768, 1), (1000, 4))
SSM_NEW_TOKENS = 16
SSM_MAX_LEN = 32768 + SSM_NEW_TOKENS
SSM_PARITY_WAVES = (0, 2)   # served again at fp32 by both routes
# deepseek-moe-16b at full width and depth (64 routed experts top-6, 2
# shared, capacity factor 1.25): waves at the two prompt lengths the
# policy routes to B1 and B2 (GQA group 1), then the continuous phase's
# traffic at its settings.
MOE_ARCH = "deepseek-moe-16b"
MOE_WAVES = (("mas_resident", 256, BATCH), ("mas_streamed", 2048, BATCH))
MOE_MAX_LEN = 2048 + NEW_TOKENS
# The MoE FFN takes the un-normalised residual stream (ROADMAP C11), so at
# the init's scale its output grows as the square of its input: 28
# random layers overflow bf16, and first tokens' logits come out
# non-finite. Every expert's down projection (routed and shared) is
# scaled by this, under which the 28 layers' logits stay finite (the
# phase holds every request to finishing, which a non-finite first token
# fails).
MOE_DOWN_SCALE = 1 / 16
# The dense archs left, full width: (arch, waves, continuous requests).
# phi4-mini-3.8b runs GQA group 3; deepseek-coder-33b group 7 with untied
# embeddings, ~66.7 GB of bf16 weights, its depth cut only where the card
# cannot hold them, its cache and DENSE_HEADROOM; qwen3-1.7b (qk-norm,
# group 2) last.
DENSE_ARCH_TRAFFIC = (
    ("phi4-mini-3.8b", (("mas_resident", 256, BATCH),
                        ("mas_streamed", 2048, BATCH)), 8),
    ("deepseek-coder-33b", (("mas_streamed", 2048, 1),), 0),
    ("qwen3-1.7b", (("mas_resident", 256, BATCH),
                    ("mas_streamed", 2048, BATCH)), 8))
DENSE_HEADROOM = 4 << 30
# recurrentgemma-9b at full width and depth (38 layers: 26 RG-LRU, 12
# MQA attention layers of 16 heads of 256 over a 2048-token window)
# through the wave engine: (prompt length, batch) of each wave: the ring
# filled exactly (the first decode row overwrites slot 0), a prompt that
# rolls into the ring by 8000 % 2048 = 1856 slots while B3 skips whole
# tiles outside the window, and the repo's prefill_32k length, the long
# context users pick a sub-quadratic model for; then the first wave again
# on int8 caches.
HYBRID_ARCH = "recurrentgemma-9b"
HYBRID_WAVES = ((2048, 4), (8000, 1), (32768, 1))
HYBRID_NEW_TOKENS = 16
HYBRID_MAX_LEN = 32768 + HYBRID_NEW_TOKENS
HYBRID_LOGIT_WAVES = (0, 1)   # first-token logits held to the plain route
# B3's row at a split rank's shape: 8192 Q rows (prefill_32k over 4 ranks)
# after a halo of window - 1 rows
HALO_ROWS = 8192
# fp32 kernel-vs-plain token parity at full width: one (rec, rec, attn)
# unit and the (rec, rec) tail
HYBRID_FP32_LAYERS = 5
# whisper-large-v3 at full width and depth through the model API (the
# engines take no frames): (clips, decoder prompt tokens) of each wave,
# within whisper's 448-token text context: short prompts, and one
# 224-token previous-text prompt (B1 at blk_q 32, the cross-attention at
# blk_q 32); the first wave again on an int8 self-attention cache.
ENCDEC_ARCH = "whisper-large-v3"
ENCDEC_WAVES = ((4, 4), (1, 224))
ENCDEC_NEW_TOKENS = 32
ENCDEC_FP32_LAYERS = 2      # encoder and decoder layers each
# internvl2-2b: (text tokens, batch) of each wave, after the 256 stub
# patch embeddings of each prompt
VLM_ARCH = "internvl2-2b"
VLM_WAVES = ((256, 4), (2048, 4))
VLM_FP32_LAYERS = 2
# Sharded serving (the sharded phase): internlm2-1.8b with its KV heads
# split over ranks, one process a rank, the continuous phase's requests
# and settings. Each run names the single-card path whose tokens it must
# equal bit for bit and whose kernels it must launch.
SHARD_RUNS = (  # (single-card path, degree, kv_dtype, spec_depth)
    ("continuous", 2, None, None),
    ("int8_continuous", 2, "int8", None),
    ("speculative", 2, None, SPEC_DEPTH),
    ("speculative_int8", 2, "int8", SPEC_DEPTH),
    ("continuous", 4, None, None),
)
SHARD_HEADS = (4, 2)   # a rank's KV heads of internlm2-1.8b at degrees 2, 4
# The head-block ring (``chunk_route="ring"``, the reference's chunk step
# on KV-head-sharded pools): (single-card path, degree, kv_dtype), the
# continuous phase's requests and settings, internlm2 at full width and
# RING_LAYERS of its 24 layers (every pass a layer goes through host
# memory under gloo: at 24 layers the four runs took 280 s on one H100);
# "fp32" is internlm2 at full width, FP32_LAYERS layers, in fp32. The
# ring's kernel rows take RING_DEGREE.
SHARD_RING_RUNS = (
    ("continuous", 2, None),
    ("int8_continuous", 2, "int8"),
    ("continuous", 4, None),
    ("fp32", 2, None),
)
RING_LAYERS = 2
RING_DEGREE = 2
# The SHARD_RUNS' depth where the ranks share one card (gloo: every step's
# output all-gathers and broadcasts through host memory; at 24 layers the
# phase took 229 s on one H100, at 6 166 s): the ring's, whose bf16 and
# int8 single-card serves they share as yardsticks. Full depth with a
# card a rank.
SHARD_SHARED_LAYERS = RING_LAYERS
# A 1024-token table (64 pages): at batch 8 a rank's own split plan for
# B6 and B7 differs there from the model's, (8, 2) or (16, 1) against
# (4, 4); at the 4096-token table all three are (16, 4).
SHARD_SHORT_PAGES = 64
# Sequence-sharded prefill and decode (the seq_sharded phase): the
# reference's sp_rep/tp_sp serving policy, one process a rank; sp_rep
# weights whole on every rank but the MoE experts, tp_sp weights the
# rank's split. internlm2-1.8b at full width and depth at degrees 2 and
# 4: prefill_32k (sp_rep; its batch of 32 cut to 1) and SEQ_PREFILL_NEW
# decode steps after it on the split cache; decode_32k (tp_sp; its batch
# of 128 cut to 8) on a cache of seeded rows; an fp32 run at
# SEQ_FP32_LAYERS layers. deepseek-moe-16b at full width and depth at
# degree 2, experts and dense leaves split, on the moe phase's 4 x 2048.
SEQ_DEGREES = (2, 4)
SEQ_PREFILL_BATCH = 1
SEQ_PREFILL_NEW = 8     # the whole script has 1,200 s on one card
SEQ_DECODE_BATCH = 8
# 8 steps before the weights were split; each step's gathers go through
# host memory under gloo (4-11 s a step on one H100), so the split runs
# take 2
SEQ_DECODE_STEPS = 2
SEQ_FP32_LAYERS = 2
SEQ_FP32_PROMPT = 4096
SEQ_FP32_NEW = 16
SEQ_MOE_DEGREE = 2
SEQ_MOE_WAVE = (4, 2048)
# where the two ranks share one card (gloo), 8 of its 28 layers: each rank
# draws the whole model in turn and keeps its cut, and every layer's
# gathers and all-to-alls pass through host memory
SEQ_MOE_SHARED_LAYERS = 8
# likewise internlm2-1.8b's prefill_32k and decode_32k runs, 8 of its 24
# layers where the ranks share one card (its ring passes, combines and
# weight gathers through host memory)
SEQ_DENSE_SHARED_LAYERS = 8
SEQ_MOE_NEW = 4       # 16 before its dense weights were split (3 s a step
                      # on one H100 over gloo, the gathers through host
                      # memory)
# deepseek-coder-33b decode_32k (tp_sp) at full width at degree 4 on the
# ranks' split weights: a whole-weight run at SEQ_CODER_CHECK_BATCH (the
# batch whose whole weights fit a rank) that the split run's logits must
# equal bit for bit, then SEQ_CODER_BATCH sequences (decode_32k's 128
# cut). Full depth where the ranks have a card each; four ranks on one
# card take the depth that fits (``coder_plan``), at most
# SEQ_CODER_SHARED_LAYERS (gloo gathers the weights through host memory).
SEQ_CODER_ARCH = "deepseek-coder-33b"
SEQ_CODER_DEGREE = 4
SEQ_CODER_BATCH = 16
SEQ_CODER_CHECK_BATCH = 2
SEQ_CODER_STEPS = 2     # 1 on a shared card (13 s a step at 4 layers, H100)
SEQ_CODER_SHARED_LAYERS = 2
SEQ_CODER_RANK_OVERHEAD = 1 << 30   # a rank's context and NCCL buffers
# The recurrent stacks split by sequence (the seq_sharded phase). mamba2-130m
# at full width and depth: a 1 x 524288 prompt (long_500k's length, reached
# by a real prefill) at degree 4 and 1 x 32768 at degree 2 (sp_rep), each
# followed by SEQ_PREFILL_NEW decode steps on the split states (tp_sp);
# decode_32k at its full batch of 128 and long_500k (tp_sp, seeded states,
# the last step at position 524287) at degree 4. recurrentgemma-9b at full
# width: prefill_32k at batch 1 (its 32 cut) at degrees 2 and 4 with
# decode steps after, decode_32k at batch 8 (its 128 cut) and long_500k at
# degree 4; full depth with a card a rank, SEQ_HYBRID_SHARED_LAYERS (one
# (rec, rec, attn) unit and the tail) on whole weights where four ranks
# share one card (gloo would move a tp_sp pass's 11 GB of gathered leaves
# a rank through host memory). An fp32 run of each at
# SEQ_RECURRENT_FP32_LAYERS layers (recurrentgemma's: one unit, no tail)
# with a SEQ_RECURRENT_FP32_PROMPT prompt, past the 2048-token window.
SEQ_SSM_PREFILLS = ((4, 524288), (2, 32768))    # (degree, prompt rows)
SEQ_HYBRID_SHARED_LAYERS = 5
SEQ_RECURRENT_DECODE_BATCH = {SSM_ARCH: 128, HYBRID_ARCH: 8}
SEQ_RECURRENT_FP32_LAYERS = {SSM_ARCH: 2, HYBRID_ARCH: 3}
SEQ_RECURRENT_FP32_PROMPT = 4096
# An fp32 split run's first-token logits against the single card's: the
# carry is composed across ranks in another order than the single card's
# decay matrix (stated in PERF.md before the first run).
SEQ_FP32_RTOL = 1e-4
SEQ_WARM_ROWS = 256     # a rank's rows of the untimed warm-up prefill
# whisper-large-v3 and internvl2-2b split by sequence (the seq_sharded
# phase; ``--only seq_frontend``), full width, bf16, seed-0 weights:
# prefill_32k at batch 1 (its 32 cut) at each degree of SEQ_DEGREES
# (whisper: one clip of 1500 frames, each rank encoding its block of
# them, and 32768 tokens; internvl2: 256 patch rows and 32512 tokens,
# split with them), SEQ_PREFILL_NEW decode steps after each; decode_32k
# at SEQ_DECODE_BATCH (its 128 cut) at degree 4 from a seeded cache
# (whisper's memories 1500 rows), on split weights and again on whole;
# an fp32 run at SEQ_FRONTEND_FP32_LAYERS layers (whisper: as many
# encoder layers) on a SEQ_FRONTEND_FP32_PROMPT-token prompt. Full depth
# with a card a rank; SEQ_FRONTEND_SHARED_LAYERS layers where four ranks
# share one card over gloo (ring passes, gathers and the split decode's
# weight gathers through host memory).
FRONTEND_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
SEQ_FRONTEND_SHARED_LAYERS = 2
SEQ_FRONTEND_FP32_LAYERS = 2
SEQ_FRONTEND_FP32_PROMPT = 1024
# The pipeline part of the seq_sharded spawn (``distributed/pipeline.py``,
# the reference's GPipe pipeline): deepseek-coder-33b, the depth-dominant
# model the reference names, at full width, bf16, seed-0 weights,
# PIPE_LAYERS of its 62 layers (four gloo ranks share one card; the same 8
# with a card a rank), PIPE_LAYERS / PIPE_DEGREE a stage, on the embedded
# rows of PIPE_BATCH sequences of PIPE_SEQ seeded tokens in
# PIPE_MICROBATCHES microbatches. A block is the full-sequence layer
# (``transformer._layer_train``): B2 at 1 x 2048, GQA group 7.
PIPE_ARCH = SEQ_CODER_ARCH
PIPE_DEGREE = 4
PIPE_LAYERS = 8
PIPE_BATCH = 8
PIPE_SEQ = 2048
PIPE_MICROBATCHES = 8
PIPE_TOKEN_SEED = 11
# Faults the pipeline gate must reject: a stage that keeps its previous
# buffer at one tick (a dropped hop), and the stages holding their layer
# blocks in reverse order.
PIPE_FAULTS = ("dropped_hop", "reversed_blocks")
# Each path of the port, the kernels it must launch, and the path whose
# launch count each row of the kernel line reports.
PATH_KERNELS = {
    "waves": WAVE_KERNELS,
    "int8_wave": ("mas_streamed", "decode_int8"),
    "continuous": ("paged_prefill", "paged_decode"),
    "int8_continuous": ("paged_prefill_int8", "paged_decode_int8"),
    "shared_prefix": ("paged_prefill", "paged_decode"),
    "shared_prefix_int8": ("paged_prefill_int8", "paged_decode_int8"),
    "speculative": ("paged_verify", "paged_prefill"),
    "speculative_int8": ("paged_verify_int8", "paged_prefill_int8"),
    "ssm_wave": ("ssd_intra_chunk",),
    "moe": ("mas_resident", "mas_streamed", "decode", "paged_prefill",
            "paged_decode"),
    "dense_archs": ("mas_resident", "mas_streamed", "decode",
                    "paged_prefill", "paged_decode"),
    "hybrid_wave": ("flash_e256", "decode_e256", "decode_e256_int8"),
    "encdec": ("mas_resident", "mas_streamed", "decode", "decode_int8"),
    "vlm": ("mas_streamed", "decode"),
    "launcher": ("mas_resident", "decode"),
    "train": ("mas_resident", "mas_streamed", "decode"),
    "train_sharded": ("mas_resident", "mas_streamed", "decode"),
    "train_tp_sp": ("mas_resident", "mas_streamed", "decode",
                    "ssd_intra_chunk", "flash_e256", "decode_e256"),
    "sharded": ("paged_prefill", "paged_decode", "paged_verify",
                "paged_prefill_int8", "paged_decode_int8",
                "paged_verify_int8"),
    "seq_sharded": ("ssd_intra_chunk", "flash_e256", "mas_streamed"),
    "pipeline": ("mas_streamed",),
}
ROW_PATH = {"mas_resident": ("waves", "moe", "dense_archs", "encdec",
                             "launcher", "train", "train_sharded",
                             "train_tp_sp"),
            "mas_streamed": ("waves", "moe", "dense_archs", "encdec",
                             "vlm", "train", "train_sharded", "train_tp_sp",
                             "pipeline"),
            "mas_streamed_cross": ("encdec",),
            "flash": ("waves",),
            "decode": ("waves", "moe", "dense_archs", "encdec", "vlm",
                       "launcher", "train", "train_sharded", "train_tp_sp"),
            "decode_int8": ("int8_wave", "encdec"),
            "paged_decode": ("continuous", "shared_prefix", "moe",
                             "dense_archs"),
            "paged_prefill": ("continuous", "shared_prefix", "moe",
                              "dense_archs"),
            "paged_decode_int8": ("int8_continuous", "shared_prefix_int8"),
            "paged_prefill_int8": ("int8_continuous", "shared_prefix_int8"),
            "paged_verify": ("speculative",),
            "paged_verify_int8": ("speculative_int8",),
            "ssd_intra_chunk": ("ssm_wave", "seq_sharded", "train_tp_sp"),
            "flash_e256": ("hybrid_wave", "train_tp_sp"),
            "decode_e256": ("hybrid_wave", "train_tp_sp"),
            "flash_e256_halo": ("seq_sharded",),
            "mas_streamed_enc_rank": ("seq_sharded",),
            "mas_streamed_cross_rank": ("seq_sharded",),
            "decode_e256_int8": ("hybrid_wave",),
            **{name + "_shard": ("sharded",) for name in (
                "paged_decode", "paged_decode_int8", "paged_prefill",
                "paged_prefill_int8", "paged_verify", "paged_verify_int8")},
            "paged_prefill_ring": ("sharded_ring",),
            "paged_prefill_ring_int8": ("sharded_ring",)}
# The launch counter of a kernel row whose name is not one: the rows of
# B5-B7 at a rank's heads count their kernels' launches on the sharded
# path's local-route runs, the B5_ring rows B5's on its ring runs, the B3
# halo row B3's at head dim 256 on the split hybrid's prefills. (The B2
# rank rows count B2's launches inside the split encoder and the cross
# blocks of the seq_sharded whisper prefills, under their own names.)
ROW_COUNTER = {**{name + "_shard": name for name in (
    "paged_decode", "paged_decode_int8", "paged_prefill",
    "paged_prefill_int8", "paged_verify", "paged_verify_int8")},
    "paged_prefill_ring": "paged_prefill",
    "paged_prefill_ring_int8": "paged_prefill_int8",
    "flash_e256_halo": "flash_e256"}

# bf16 kernels against their plain versions: both sum in fp32 and round
# once to bf16, so a row differs by at most about one bf16 rounding
# (2^-8) of its L2 norm. The limit is relative to each row because an
# attention output shrinks as its row sees more keys (|o| ~ 1/sqrt(keys)
# for random v): an absolute limit sized for the early rows would pass a
# late row that lost a KV tile. Every check also plants that fault (one V
# tile zeroed) and fails unless the limit rejects it.
BF16_ROW_RTOL = 4e-3
FP32_ATOL = 3e-5     # fp32 sums taken in another order
# B8 and the chunked SSD scan at fp32 against their plain versions: each
# output row within 1e-4 of its L2 norm (fp32 sums in another order; the
# scan also takes its prefix sums in another order; stated in PERF.md
# before the first run). Rows, not an absolute limit: y grows with the
# rows a decay lets through.
SSD_FP32_ROW_RTOL = 1e-4
# Prefill logits of the kernel path vs the plain attention path: bf16
# activations through 24 layers; the two paths round attention outputs
# at the same points, so they differ by a few bf16 ulps of the logits.
LOGITS_RTOL = 5e-2
# First-token logits of the int8 pools against the bf16 pools: int8 keys
# and values carry ~0.4% of their page's absmax of rounding each, through
# 24 layers (the limit stated in PERF.md before the first run).
INT8_LOGITS_RTOL = 0.1
# Roofline lines: model flops and least bytes of a step, at the card's
# peaks, against its CUDA-event time. Each share must lie in (0, 1.05]:
# the counts read every input once and do only the useful work, so a
# step that beats them by more than timing noise means a wrong count.
ROOFLINE_MAX = 1.05
ROOFLINE_STEPS = 3          # decode steps timed after the probe's prefill
# The calibration serve: the continuous phase's first requests, traced.
CALIBRATION_REQUESTS = 8
# The dry-run command line (``repro_torch.launch.dryrun.main``) in the
# launcher phase: its abstract records at degree 4, and DRYRUN_RUN run at
# degrees 1 and 2, its batch of 128 cut to DRYRUN_BATCH.
DRYRUN_DEGREE = 4
DRYRUN_RUN = ("mamba2-130m", "decode_32k")
DRYRUN_BATCH = 8
# The serving launcher at full width: requests through
# ``repro_torch.launch.serve.main``, its other flags at their defaults.
LAUNCHER_ARCH = ARCH
LAUNCHER_REQUESTS = 8
LAUNCHER_NEW_TOKENS = 8
# Training (the train phase): internlm2-1.8b at full width and depth,
# fp32 master weights, bf16 compute, attention "chunked" (the kernels
# have no backward) in Q chunks of 1024 rows with remat, AdamW with int8
# gradient compression. train_4k's sequence of 4096; its global batch of
# 256 cut to 4 (two microbatches of 2) to fit one card.
TRAIN_SEQ = 4096
TRAIN_BATCH = 4
TRAIN_ACCUM = 2
TRAIN_STEPS = 6
TRAIN_LR = 3e-3             # the train launcher's default
TRAIN_CHUNK = 1024
TRAIN_FP32_SEQ = 1024       # the fp32 gradient and checkpoint checks
# the fp32 check's chunk: three chunks over 1024 rows, the last padded
# (at TRAIN_CHUNK one chunk would hold every row)
TRAIN_FP32_CHUNK = 384
TRAIN_GRAD_RTOL = 1e-4      # "chunked" + remat vs "plain", each leaf (L2)
# The loss of a step after a restore against the uninterrupted run's:
# the same state bit for bit, but CUDA's index_add backward (the
# embedding's gradient) sums in no fixed order.
TRAIN_RESUME_ATOL = 1e-3
TRAIN_PROMPTS = (256, 2048)  # the trained weights' prefill: B1, B2
TRAIN_NEW_TOKENS = 8
# Training across ranks (the train_sharded phase): the train phase's
# model and settings under fsdp, degree 4 first (its checkpoint restores
# at 2, 3 and on one card). Four cards (NCCL): full depth, a global batch
# of 8 (2 sequences a rank at degree 4, grad_accum 2 at 2), 4 steps, the
# fp32 runs 2. One card (gloo, the ranks sharing it, every gather and
# reduce-scatter through host memory: a degree-2 step of 4 layers at
# grad_accum 2 took 17-22 s on an H100): 2 of 24 layers (4 before the
# tp_sp phase grew; the whole script has 1,200 s), a global batch of 4
# (1 sequence a rank at degree 4, 2 at 2 in one microbatch), 3 steps, the
# fp32 runs without compression 1 (each fault planted there shows at
# step 0; a rank-local int8 scale moves the leaves from the first update
# on, so the int8 runs keep 2).
TRAIN_SHARDED_DEGREES = (4, 2)
TRAIN_SHARDED_PLANS = {
    "nccl": {"layers": 24, "batch": 8, "accum": {4: 1, 2: 2},
             "steps": 4, "fp32_steps": {"fp32": 2, "fp32_int8": 2},
             "reduced": "train_4k's global batch of 256 cut to 8"},
    "gloo": {"layers": 2, "batch": 4, "accum": {4: 1, 2: 1},
             "steps": 3, "fp32_steps": {"fp32": 1, "fp32_int8": 2},
             "reduced": "2 of 24 layers, 3 steps, the fp32 runs without "
                        "compression 1 (the "
                        "ranks share one card; their gathers pass "
                        "through host memory); train_4k's global batch "
                        "of 256 cut to 4"}}
TRAIN_SHARDED_SAVE_AT = 2
# The runs (compute dtype, compression) by kind: the main runs in bf16
# with int8, and at degree 4 in fp32 (FP32_LAYERS layers, sequences of
# TRAIN_SHARDED_FP32_SEQ, labels masked unevenly over the ranks) without
# compression and with int8, each clean and with the planted faults
# FAULT_KIND gives it. The one-card yardstick takes the plan's
# microbatch, a rank's (bf16), or the whole batch (fp32).
TRAIN_SHARDED_KINDS = {"bf16": ("bf16", "int8"), "fp32": ("fp32", None),
                       "fp32_int8": ("fp32", "int8")}
FAULT_KIND = {"unreduced_layer": "fp32", "whole_norm_n_times": "fp32",
              "shard_int8_scale": "fp32_int8", "rank_loss_mean": "fp32"}
TRAIN_SHARDED_FP32_SEQ = 256
TRAIN_SHARDED_FP32_BATCH = 4
# Bands against the one-card yardstick by kind: (step limits, leaf
# limit), stated in PERF.md. bf16: the yardstick takes a rank's
# microbatches, so their bf16 gradients round alike; the ranks' partial
# gradients are then summed in fp32 in another order, and int8 codes near
# a rounding edge and the updates they drive may differ; lr is exact.
# fp32 without compression: test_torch_train_step.py's STEP_RTOL, the
# grad norm at 1e-5 (the whole leaves, the norms, hold ~3e-5 of a
# full-width gradient's squares: counted n times they move the norm
# ~4.5e-5 at degree 4). fp32 with int8: a gradient element within ~1e-7
# of a code's rounding edge takes the other code, and at full width
# enough do that the leaves moved 1.5e-4-4.8e-4 on an H100, so 2e-3.
TRAIN_SHARDED_GATES = {
    "bf16": ({"loss": 2e-3, "grad_norm": 2e-2, "lr": 1e-6}, 5e-2),
    "fp32": ({"loss": 1e-4, "grad_norm": 1e-5, "lr": 1e-6}, 1e-4),
    "fp32_int8": ({"loss": 1e-4, "grad_norm": 1e-4, "lr": 1e-6}, 2e-3)}
# Training across ranks under tp_sp (the train_tp_sp phase, after
# train_sharded): deepseek-moe-16b at full width (587.9 M parameters a
# layer, 553.6 M of them experts, and a tied 209.7 M embedding), fp32
# master weights, bf16 compute, chunked attention with remat, int8
# compression, train_4k's sequence of 4096 split over the ranks, every
# rank the whole batch, its experts its own. Four cards (NCCL): 8 of 28
# layers, a global batch of 2, 4 steps at degrees 4 and 2 (a rank's
# state 1/n of 20 B a parameter: ~25 and ~49 GB). One card (gloo, the
# ranks sharing it): 2 layers, a global batch of 1, 3 steps.
TRAIN_TP_SP_DEGREES = (4, 2)
# The MoE weights are ``bounded_moe``'s (the down projections × 1/16, C11)
# and AdamW's rate is OptConfig's default 3e-4: at the launcher's 3e-3 the
# first update, a step of ~lr on every element, is twice a scaled down
# projection's elements, and at 8 layers (2 × 4096) the second step's
# loss was NaN on an H100 at both degrees.
TRAIN_TP_SP_LR = 3e-4
TRAIN_TP_SP_PLANS = {
    "nccl": {"layers": 8, "batch": 2, "steps": 4,
             "reduced": "8 of 28 layers; train_4k's global batch of 256 "
                        "cut to 2"},
    "gloo": {"layers": 2, "batch": 1, "steps": 2,
             "reduced": "2 of 28 layers, 2 steps (the ranks share one "
                        "card); train_4k's global batch of 256 cut to 1"}}
# The fp32 gates at degree 4: 2 full-width layers, a sequence of 512, 2
# steps, against the same step on one card under ``ctx.grouped_as(4)``
# (the same MoE groups), clean and with each of TP_SP_FAULTS; and the
# dense odd-batch cell: internlm2-1.8b at 4 layers, a global batch of 3,
# degree 2, against one card. Bands (steps, leaves), stated in PERF.md
# before the first run: fp32 sums in another order (a rank's partial
# gradients summed over the ranks); an MoE assignment whose router
# scores tie within that order's noise may route to another expert, and
# Adam's second update turns a near-zero gradient's rounding into a sign,
# so the MoE leaves take 1e-3; the dense leaves 1e-4 (1.03e-5 on an H100
# at TRAIN_TP_SP_LR).
TRAIN_TP_SP_FP32 = {"layers": 2, "seq": 512, "batch": 1, "steps": 2,
                    "degree": 4}
TRAIN_TP_SP_DENSE = {"layers": 4, "seq": 512, "batch": 3, "steps": 1,
                     "degree": 2}
TRAIN_TP_SP_GATES = {
    "fp32": ({"loss": 1e-4, "grad_norm": 1e-4, "lr": 1e-6}, 1e-3),
    "dense_fp32": ({"loss": 1e-4, "grad_norm": 1e-5, "lr": 1e-6}, 1e-4)}
# The other stacks under tp_sp (the same phase, after the MoE and dense
# runs): mamba2-130m, recurrentgemma-9b, whisper-large-v3 and
# internvl2-2b at full width, chunked attention with remat, fp32 master
# weights from seed 0, bf16 compute, no compression, a global batch of 1
# (train_4k's 256 cut), TRAIN_TP_SP_STACK_STEPS steps at degree 4, every
# rank the whole batch and its rows of the sequence (internvl2: of its
# 256 patch rows and the tokens; whisper: its block of the 1500 frames
# through the encoder too). The depth and sequence a run takes by backend
# (one card: the four ranks share it over gloo; four cards: NCCL):
# mamba2 at full depth; recurrentgemma one (rec, rec, attn) period (no
# tail), so that its trained weights serve through B3 and B4 at head dim
# 256, and
# on one card 512 of train_4k's 4096 rows (four ranks' whole tied
# 256000-row embeddings and their gradients, 2.1 GB bf16 and 4.2 GB fp32
# each, share the card: a step of 1024 rows took 13.2-14.6 s on one H100);
# whisper 4 of its 32 decoder and encoder layers and internvl2 4 of 24
# (one card: 2 of each).
TRAIN_TP_SP_STACKS = {
    "gloo": {SSM_ARCH: {"layers": 24, "seq": 4096},
             HYBRID_ARCH: {"layers": 3, "pattern_tail": (), "seq": 512},
             ENCDEC_ARCH: {"layers": 2, "encoder_layers": 2, "seq": 4096},
             VLM_ARCH: {"layers": 2, "seq": 4096}},
    "nccl": {SSM_ARCH: {"layers": 24, "seq": 4096},
             HYBRID_ARCH: {"layers": 3, "pattern_tail": (), "seq": 4096},
             ENCDEC_ARCH: {"layers": 4, "encoder_layers": 4, "seq": 4096},
             VLM_ARCH: {"layers": 4, "seq": 4096}}}
TRAIN_TP_SP_STACK_STEPS = 2
TRAIN_TP_SP_STACK_DEGREE = 4
# Their fp32 gates at degree 4 (recurrentgemma's at 2: four ranks' whole
# fp32 256000-row embeddings and their gradients, 4.2 GB each, do not fit
# one card beside their states): TRAIN_TP_SP_STACK_FP32's layers
# (whisper: as many encoder layers), 1 x 512 tokens, one step (the first
# batch's gradients are held too; a second step of recurrentgemma's took
# 17 s over gloo on one H100), against the same step on one card (an SSD
# scan at the chunk a rank's 128 rows run on both), at
# TRAIN_TP_SP_GATES["fp32"]; mamba2's first-batch gradients also under
# each of RECURRENT_FAULTS, in the same run (recurrentgemma's too took 30 s
# more on one H100; tests/test_torch_tp_sp_train.py plants them in the
# hybrid on the CPU). And a
# sequence the degree does not divide (TRAIN_TP_SP_ODD: internlm2-1.8b, 2
# layers, 3 x 510 at degree 4: every rank the whole rows, its loss a share
# of the label columns) at TRAIN_TP_SP_GATES["dense_fp32"].
TRAIN_TP_SP_STACK_FP32 = {"seq": 512, "batch": 1, "steps": 1,
                          "degree": {SSM_ARCH: 4, HYBRID_ARCH: 2,
                                     ENCDEC_ARCH: 4, VLM_ARCH: 4},
                          "layers": {SSM_ARCH: 2, HYBRID_ARCH: 3,
                                     ENCDEC_ARCH: 2, VLM_ARCH: 2}}
TRAIN_TP_SP_ODD = {"layers": 2, "seq": 510, "batch": 3, "steps": 1,
                   "degree": 4}
TRAIN_TP_SP_GATES.update(stack_fp32=TRAIN_TP_SP_GATES["fp32"],
                         odd_fp32=TRAIN_TP_SP_GATES["dense_fp32"])
# Those runs also hold the first batch's gradient, before any update,
# leaf by leaf (the rank's blocks) to one card's within this of its norm
# (the gradient gate): a dropped halo or carry gradient leaves the loss
# and the first update's signs as they were, but not the gradients of the
# layers whose rows it joins (fp32 sums in another order:
# tests/test_torch_tp_sp_train.py holds the smoke stacks at 1e-5)
TRAIN_TP_SP_GRAD_RTOL = 1e-4
GRAD_GATED = ("stack_fp32", "odd_fp32")
# The stacks' trained weights through their kernels: a prompt of this
# many tokens (whisper: after one 1500-frame clip; internvl2: after its
# 256 patch rows) and one decode step
TRAIN_TP_SP_STACK_PROMPT = 1024


def emit(obj) -> None:
    """Print one JSON line; a dict gets ``unix_s``, the host clock when it
    is printed, so the log shows each phase's share of the run's wall."""
    if isinstance(obj, dict):
        obj = {**obj, "unix_s": round(time.time(), 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_SLEEP_CYCLES_PER_MS: list[float] = []
DEVICE_TRIES = 4        # waits of 1, 4, 16 and 64 times the first


def hidden_ms(torch, fn, iters: int) -> tuple[float | None, int, int]:
    """Device time of one call of ``fn``, averaged over ``iters`` calls
    after one warm-up call: each call is enqueued behind a device-side
    wait (``torch.cuda._sleep``) long enough for the host to enqueue the
    whole call, between CUDA events, so the events see the call's work
    run back to back on the device and not the host's dispatch. Checked
    for each call: if the start event has run by the time the call is
    enqueued, the call is repeated behind a four times longer wait, and
    dropped after ``DEVICE_TRIES`` tries. Returns (mean ms over the kept
    calls, or None if none was kept; repeats; drops). ``fn`` must not
    wait on the device. (Not ``torch.profiler``: its sessions leave the
    host's later launches slower, and so the serving phases after
    them.)"""
    if not _SLEEP_CYCLES_PER_MS:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10_000_000)
        b.record()
        torch.cuda.synchronize()
        _SLEEP_CYCLES_PER_MS.append(10_000_000 / a.elapsed_time(b))
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    total, kept, retries = 0.0, 0, 0
    for _ in range(iters):
        wait_ms = 3 * host_ms + 0.2
        for _ in range(DEVICE_TRIES):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(_SLEEP_CYCLES_PER_MS[0] * wait_ms))
            start.record()
            fn()
            hidden = not start.query()
            end.record()
            torch.cuda.synchronize()
            if hidden:
                total += start.elapsed_time(end)
                kept += 1
                break
            retries += 1
            wait_ms *= 4
    return (total / kept if kept else None), retries, iters - kept


def graph_ms(torch, fn, iters: int) -> float:
    """Device time of one call of ``fn``, captured once in a CUDA graph
    and replayed ``iters`` times back to back between CUDA events: its
    kernels' time without the host's dispatch between them. For a call of
    more launches than the device's queue holds (about a thousand), which
    ``hidden_ms`` cannot hide: the host blocks on the full queue while the
    device waits. ``fn`` must be capturable: no host sync, no host-to-
    device copy."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # warm-up off the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = cuda_ms(torch, graph.replay, iters)
    del graph
    return ms


def device_times(torch, kern, lib, iters: int) -> dict:
    """Device time of a kernel's call and of its yardstick's (``lib``, or
    None) by ``hidden_ms``, with the calls both repeated and dropped."""
    ms, retries, dropped = hidden_ms(torch, kern, iters)
    lib_ms = None
    if lib is not None:
        lib_ms, lib_retries, lib_dropped = hidden_ms(torch, lib, iters)
        retries, dropped = retries + lib_retries, dropped + lib_dropped
    return {"device_ms": ms, "library_device_ms": lib_ms,
            "device_retries": retries, "device_dropped": dropped}


def device_span(torch, q_offset: int, kv_len: int):
    """B5's (q_offset, kv_len) int32 pair on the device."""
    return torch.tensor([q_offset, kv_len], dtype=torch.int32, device="cuda")


def chunk_span(torch, q_offset: int, chunk_len: int):
    """What ``prefill_chunk`` takes on the device, as the continuous
    engine packs it: (q_offset, kv_len, last live row) int32."""
    return torch.tensor([q_offset, q_offset + chunk_len, chunk_len - 1],
                        dtype=torch.int32, device="cuda")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def row_rel_err(got, want) -> float:
    """Largest L2 error of an output row (last axis), relative to that row
    of ``want``."""
    got, want = got.float(), want.float()
    err = (got - want).norm(dim=-1)
    return float((err / want.norm(dim=-1).clamp_min(1e-30)).max())


def drop_v_tile(v, tile: int, blk_kv: int = 64):
    """``v`` with KV tile ``tile`` zeroed along its row axis (dim -2): what
    a kernel that skipped that tile's P·V product would compute with."""
    out = v.clone()
    out[..., tile * blk_kv:(tile + 1) * blk_kv, :] = 0
    return out


def drop_v_page(v_pages, page: int):
    """``v_pages`` (Hkv, P, page, E) with physical page ``page`` zeroed:
    what a paged kernel that skipped that page's P·V product would
    compute with."""
    out = v_pages.clone()
    out[:, page] = 0
    return out


def drop_scale_tile(scales, tile: int, blk_kv: int = 64):
    """Per-row scales (..., rows) with KV tile ``tile`` zeroed: an int8
    kernel that lost that tile's V scales would compute with these."""
    out = scales.clone()
    out[..., tile * blk_kv:(tile + 1) * blk_kv] = 0
    return out


def drop_scale_page(scales, page: int):
    """Per-page scales (Hkv, P) with physical page ``page`` zeroed."""
    out = scales.clone()
    out[:, page] = 0
    return out


def held_to_plain(got, want, faulty) -> dict:
    """``got`` against ``want`` within BF16_ROW_RTOL, and the planted fault
    ``faulty`` outside it."""
    check = {"max_abs_err": max_err(got, want),
             "row_rel_err": row_rel_err(got, want),
             "fault_row_rel_err": row_rel_err(faulty, want)}
    require(check["fault_row_rel_err"] > BF16_ROW_RTOL,
            f"a skipped KV tile passes the limit: {check}")
    return check


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(ms, what binds) of ``flops`` and ``nbytes`` at the card's peaks
    (``repro_torch.analysis.roofline``)."""
    from repro_torch.analysis.roofline import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S

    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def library_call(torch, q, k, v, *, causal: bool, mask=None, k_scale=None,
                 v_scale=None):
    """One SDPA call on the same inputs, after dequantizing int8 caches to
    the query's dtype (``k_scale``/``v_scale``: one scale per row)."""
    F = torch.nn.functional
    rep = q.shape[1] // k.shape[1]

    def call():
        kk, vv = k, v
        if k_scale is not None:
            kk = (k.float() * k_scale[..., None]).to(q.dtype)
            vv = (v.float() * v_scale[..., None]).to(q.dtype)
        try:
            return F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, is_causal=causal, enable_gqa=True)
        except TypeError:   # no enable_gqa: expand the kv heads
            kk, vv = kk.repeat_interleave(rep, 1), vv.repeat_interleave(rep, 1)
            return F.scaled_dot_product_attention(
                q, kk, vv, attn_mask=mask, is_causal=causal)

    return call


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v``
    log, by kernel (demangled by ``c++filt`` where it is installed)."""
    report, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            report[name] = {}
            continue
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        if name and regs:
            report[name]["registers"] = int(regs.group(1))
        if name and spill:
            report[name]["spill_bytes"] = int(spill.group(1))
    return demangled(report)


def sass_report(listing: str) -> dict:
    """Tensor-core instructions of each kernel in a ``cuobjdump -sass``
    listing: ``HMMA`` (``mma.sync``) and ``HGMMA`` (``wgmma``), by kernel
    (demangled by ``c++filt`` where it is installed)."""
    report, name = {}, None
    for ln in listing.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            report[name] = {"hmma": 0, "hgmma": 0}
        elif name:
            report[name]["hmma"] += len(re.findall(r"\bHMMA\.", ln))
            report[name]["hgmma"] += len(re.findall(r"\bHGMMA\.", ln))
    return demangled(report)


def demangled(report: dict) -> dict:
    """``report`` keyed by demangled kernel names, where ``c++filt`` is
    installed: the function's name and template arguments, no parameters."""
    names = list(report)
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        short = [d.replace("(anonymous namespace)::", "").split("(")[0]
                 .removeprefix("void ")
                 for d in out.stdout.splitlines()]
        if len(short) == len(names):
            return dict(zip(short, report.values()))
    return report


def phase_device(torch, build) -> dict:
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: ptxas_report(build.build_log(name))
             for name in build.SOURCES}
    sass = {name: sass_report(build.sass(name)) for name in build.SOURCES}
    info = {
        "phase": "device",
        "nvidia_smi": nvidia_smi(),
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "python": sys.version.split()[0],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "build_s": build_s,
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
        "tf32_cudnn": torch.backends.cudnn.allow_tf32,
        "ptxas": ptxas,
        "tensor_core_instructions": sass,
    }
    emit(info)
    # the bf16 forms of B1-B8 must run on the tensor cores
    for lib, kernel, kind in (
            ("mas_attention", "mas_resident_bf16_kernel", "hmma"),
            ("mas_attention", "mas_streamed_bf16_kernel", "hmma"),
            ("flash_attention", "flash_bf16_kernel", "hgmma"),
            ("decode_attention", "decode_bf16_kernel", "hmma"),
            ("paged_prefill_attention", "paged_prefill_bf16_kernel",
             "hgmma"),
            ("paged_verify_attention", "paged_verify_bf16_kernel", "hmma"),
            ("paged_decode_attention", "paged_decode_bf16_kernel", "hmma"),
            ("ssd_scan", "ssd_chunk_bf16_kernel", "hgmma")):
        found = {k: c for k, c in sass[lib].items() if kernel in k}
        require(bool(found) and all(c[kind] > 0 for c in found.values()),
                f"{kernel}: no {kind.upper()} instruction in {found}")
    # the tensor-core forms of B3 (head dims 64, 128 and 256), of B4 (the
    # same) and B6 (64 and 128) on bf16 and int8 caches, and B7's also at
    # one and two m16 tiles of rows
    for lib, kernel, n_forms in (
            ("flash_attention", "flash_bf16_kernel", 3),
            ("decode_attention", "decode_bf16_kernel", 6),
            ("paged_decode_attention", "paged_decode_bf16_kernel", 4),
            ("paged_verify_attention", "paged_verify_bf16_kernel", 8)):
        forms = [k for k in sass[lib] if kernel in k]
        require(len(forms) == n_forms, f"{kernel}: forms {forms}")
    return info


def phase_fp32(torch) -> dict:
    """Every kernel against its plain version in fp32 on ragged shapes."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre
    from repro_torch.kernels import paged_verify_attention as pver
    from repro_torch.kernels.common import quantize_q8

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    errs = {}
    # (B·Hq, Nq, E) x (B·Hkv, Nkv, E): group 2, kv tail at 200 of 256
    q, k, v = rnd(8, 224, 64), rnd(4, 256, 64), rnd(4, 256, 64)
    for causal in (False, True):
        for resident in (True, False):
            name = f"{'mas_resident' if resident else 'mas_streamed'}" \
                   f"{'_causal' if causal else ''}"
            out = mas.mas_attention_flat(q, k, v, blk_q=32, causal=causal,
                                         kv_resident=resident, kv_len=200)
            ref = mas.mas_attention_plain(q, k, v, blk_q=32, blk_kv=64,
                                          causal=causal, kv_len=200)
            errs[name] = max_err(out, ref)
        out = fl.flash_attention_flat(q, k, v, blk_q=16, causal=causal,
                                      kv_len=200)
        ref = fl.flash_attention_plain(q, k, v, blk_q=16, blk_kv=64,
                                       causal=causal, kv_len=200)
        errs[f"flash{'_causal' if causal else ''}"] = max_err(out, ref)
    out = fl.flash_attention_flat(q, k, v, blk_q=32, causal=True, window=70,
                                  q_offset=16, kv_len=200)
    ref = fl.flash_attention_plain(q, k, v, blk_q=32, blk_kv=64, causal=True,
                                   window=70, q_offset=16, kv_len=200)
    errs["flash_window"] = max_err(out, ref)
    qd, kd, vd = rnd(6, 4, 64), rnd(6, 333, 64), rnd(6, 333, 64)
    lens = torch.tensor([0, 1, 63, 64, 200, 333], dtype=torch.int32,
                        device=dev)
    out = dec.decode_attention_flat(qd, kd, vd, lens)
    n_split, tps = dec.decode_split_plan(qd.dtype, 6, 333)
    ref = dec.decode_attention_plain(qd, kd, vd, lens, n_split=n_split,
                                     tiles_per_split=tps)
    errs["decode"] = max_err(out, ref)
    (kq, ks), (vq, vs) = quantize_q8(kd, -1), quantize_q8(vd, -1)
    out = dec.decode_attention_flat(qd, kq, vq, lens, k_scale=ks, v_scale=vs)
    n_split, tps = dec.decode_split_plan(qd.dtype, 6, 333)
    ref = dec.decode_attention_plain(qd, kq, vq, lens, n_split=n_split,
                                     tiles_per_split=tps, k_scale=ks,
                                     v_scale=vs)
    errs["decode_int8"] = max_err(out, ref)

    # paged: 6 sequences of up to 10 pages of 16 rows on shuffled pages of
    # a 64-page pool, GQA group 2; table entries past a sequence's live
    # rows point at other sequences' pages, which masking must keep out
    kp, vp = rnd(2, 64, 16, 64), rnd(2, 64, 16, 64)
    table = (torch.randperm(63, generator=g, device=dev) + 1)[:60].view(
        6, 10).to(torch.int32).contiguous()
    lens = torch.tensor([0, 1, 9, 16, 100, 160], dtype=torch.int32,
                        device=dev)
    qd = rnd(6, 2, 2, 64)
    out = pdec.paged_decode_attention_flat(qd, kp, vp, table, lens)
    n_split, tps = dec.decode_split_plan(qd.dtype, 12, 160)
    ref = pdec.paged_decode_attention_plain(qd, kp, vp, table, lens,
                                            n_split=n_split,
                                            tiles_per_split=tps)
    errs["paged_decode"] = max_err(out, ref)
    # prefill chunks: the first, a later one ending mid-page (ragged, 86
    # live rows of 96), and one live row
    for q0, kv_len, chunk in ((0, 64, 64), (64, 150, 96), (0, 1, 32)):
        qp = rnd(4, chunk, 64)
        span = device_span(torch, q0, kv_len)
        out = ppre.paged_prefill_attention_flat(qp, kp, vp, table[5], span,
                                                blk_q=32)
        ref = ppre.paged_prefill_attention_plain(qp, kp, vp, table[5], span,
                                                 blk_q=32)
        errs[f"paged_prefill_{q0}_{kv_len}"] = max_err(out, ref)

    # the int8 branches of B5 and B6 on the same pools quantized per page
    (kp8, kps), (vp8, vps) = quantize_q8(kp, (-2, -1)), quantize_q8(vp,
                                                                   (-2, -1))
    q8 = dict(k_scales=kps, v_scales=vps)
    out = pdec.paged_decode_attention_flat(qd, kp8, vp8, table, lens, **q8)
    n_split, tps = dec.decode_split_plan(qd.dtype, 12, 160)
    ref = pdec.paged_decode_attention_plain(qd, kp8, vp8, table, lens,
                                            n_split=n_split,
                                            tiles_per_split=tps, **q8)
    errs["paged_decode_int8"] = max_err(out, ref)
    for q0, kv_len, chunk in ((0, 64, 64), (64, 150, 96)):
        qp = rnd(4, chunk, 64)
        kw = dict(blk_q=32, **q8)
        span = device_span(torch, q0, kv_len)
        out = ppre.paged_prefill_attention_flat(qp, kp8, vp8, table[5], span,
                                                **kw)
        ref = ppre.paged_prefill_attention_plain(qp, kp8, vp8, table[5], span,
                                                 **kw)
        errs[f"paged_prefill_int8_{q0}_{kv_len}"] = max_err(out, ref)
    # B7, both branches: ragged candidate rows (k, 1, 0, k, 2, k), a start
    # mid-page, a block straddling a 64-row tile, kv_len 0, a block ending
    # at the table's capacity
    starts = torch.tensor([5, 63, 0, 62, 100, 156], dtype=torch.int32,
                          device=dev)
    rows = torch.tensor([4, 1, 0, 4, 2, 4], dtype=torch.int32, device=dev)
    lens = starts + rows
    qv = rnd(6, 2, 4 * 2, 64)
    for name, pools, kw in (("paged_verify", (kp, vp), {}),
                            ("paged_verify_int8", (kp8, vp8), q8)):
        out = pver.paged_verify_attention_flat(qv, *pools, table, lens,
                                               starts, spec=4, **kw)
        n_split, tps = dec.decode_split_plan(qv.dtype, 12, 160)
        ref = pver.paged_verify_attention_plain(
            qv, *pools, table, lens, starts, spec=4, n_split=n_split,
            tiles_per_split=tps, **kw)
        errs[name] = max_err(out, ref)
        require(float(out[2].abs().max()) == 0.0,
                f"{name}: kv_len 0 does not give zeros")
    ssd_errs = ssd_fp32_checks(torch)
    torch.cuda.synchronize()
    report = {"phase": "fp32", "atol": FP32_ATOL, "max_abs_err": errs,
              "ssd_row_rtol": SSD_FP32_ROW_RTOL, "ssd_row_rel_err": ssd_errs}
    emit(report)
    for name, err in errs.items():
        require(err <= FP32_ATOL, f"fp32 {name}: {err} > {FP32_ATOL}")
    for name, err in ssd_errs.items():
        require(err <= SSD_FP32_ROW_RTOL,
                f"fp32 {name}: row error {err} > {SSD_FP32_ROW_RTOL}")
    return report


def phase_kernels(torch, device: dict) -> list[dict]:
    """Each kernel vs its plain version at the main path's shapes (bf16);
    ``device`` is the device phase's report (registers, spills and
    tensor-core instructions by kernel)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops

    cfg = get_arch(ARCH)
    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = hq // hkv
    bf16 = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(bf16)

    rows = []
    for method, n, b in WAVES:
        kind, bq = ops.resolve_method(n, n, e, 2)
        require(kind == method, f"policy routes N={n} to {kind}, not {method}")
        q, k, v = rnd(b * hq, n, e), rnd(b * hkv, n, e), rnd(b * hkv, n, e)
        if method == "flash":
            kern = lambda: fl.flash_attention_flat(  # noqa: E731
                q, k, v, blk_q=bq, causal=True)
            plain = lambda v=v: fl.flash_attention_plain(  # noqa: E731
                q, k, v, blk_q=bq, blk_kv=KV_TILE, causal=True)
            source = "src/repro_torch/kernels/csrc/flash_attention.cu"
            replaces = "src/repro/kernels/flash_attention.py:25"
        else:
            resident = method == "mas_resident"
            kern = lambda: mas.mas_attention_flat(  # noqa: E731
                q, k, v, blk_q=bq, causal=True, kv_resident=resident)
            plain = lambda v=v: mas.mas_attention_plain(  # noqa: E731
                q, k, v, blk_q=bq, blk_kv=KV_TILE, causal=True)
            source = "src/repro_torch/kernels/csrc/mas_attention.cu"
            replaces = ("src/repro/kernels/mas_attention.py:"
                        + ("55" if resident else "121"))
        # the fault: the second-last KV tile skipped, seen by late rows only
        check = held_to_plain(kern(), plain(),
                              plain(drop_v_tile(v, n // KV_TILE - 2)))
        lib = library_call(torch, q.view(b, hq, n, e), k.view(b, hkv, n, e),
                           v.view(b, hkv, n, e), causal=True)
        pairs = n * (n + 1) // 2          # causal (query, key) pairs a head
        flops = 4.0 * e * pairs * b * hq
        nbytes = 2.0 * (2 * b * hq * n * e + 2 * b * hkv * n * e)
        bms, by = bound(flops, nbytes)
        ms = cuda_ms(torch, kern, 20)
        rows.append({
            "name": method, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, **check,
            "ms": ms, "plain_ms": cuda_ms(torch, plain, 2),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(torch, lib, 20),
            **device_times(torch, kern, lib, 20),
            "tflops": flops / ms / 1e9,
            "tune_attention": tuned(kind, b_h=b * hq, n_q=n, n_kv=n, e=e,
                                    causal=True),
            "shape": {"b": b, "hq": hq, "hkv": hkv, "n": n, "e": e,
                      "blk_q": bq, "causal": True, "dtype": "bf16"},
        })
        if method == "mas_streamed":
            rows[-1]["blk_q8"] = streamed_at_blk_q8(torch, rnd, hq, hkv, e)

    rows.append(cross_row(torch, rnd, device))
    rows += rank_b2_rows(torch, rnd, device)
    for quantized in (False, True):
        rows.append(decode_row(torch, rnd, cfg, quantized))
        rows += paged_rows(torch, rnd, cfg, quantized)
    rows.append(ssd_row(torch, device))
    rows += hybrid_rows(torch, rnd, device)
    for quantized in (False, True):
        rows += shard_rows(torch, rnd, cfg, quantized)
    rows += [ring_rows(torch, rnd, cfg, quantized)
             for quantized in (False, True)]
    emit({"phase": "kernels", "row_rtol": BF16_ROW_RTOL, "kernels": rows})
    for row in rows + [r["blk_q8"] for r in rows if "blk_q8" in r]:
        require(row["row_rel_err"] <= BF16_ROW_RTOL,
                f"{row['name']}: row_rel_err {row['row_rel_err']} > "
                f"{BF16_ROW_RTOL}")
    return rows


def tuned(kind: str, *, b_h: int, n_q: int, n_kv: int, e: int,
          causal: bool) -> dict:
    """``tune_attention``'s choice and estimate for a bf16 attention call
    that ``ops.resolve_method`` routes to ``kind``; fails unless the tuner
    routes it the same way."""
    from repro_torch.core.autotune import tune_attention

    c = tune_attention(b_h=b_h, n_q=n_q, n_kv=n_kv, e=e, itemsize=2,
                       causal=causal)
    require(c.method == kind, f"tune_attention routes {b_h} x {n_q} x "
                              f"{n_kv} to {c.method}, ops to {kind}")
    return {"route": c.method, "blk_q": c.blk_q, "blk_kv": c.blk_kv,
            "est_ms": c.est_seconds * 1e3, "mma_ms": c.mma_s * 1e3,
            "hbm_ms": c.hbm_s * 1e3, "elementwise_ms": c.elementwise_s * 1e3}


def streamed_at_blk_q8(torch, rnd, hq: int, hkv: int, e: int) -> dict:
    """B2 at 1 x 4096, where the policy takes blk_q 8 and the bf16 kernel
    its transposed form, against its plain version per row."""
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops

    n = 4096
    kind, bq = ops.resolve_method(n, n, e, 2)
    require((kind, bq) == ("mas_streamed", 8),
            f"policy routes N={n} to {kind} at blk_q {bq}")
    q, k, v = rnd(hq, n, e), rnd(hkv, n, e), rnd(hkv, n, e)

    def kern():
        return mas.mas_attention_flat(q, k, v, blk_q=bq, causal=True,
                                      kv_resident=False)

    def plain(v=v):
        return mas.mas_attention_plain(q, k, v, blk_q=bq, blk_kv=KV_TILE,
                                       causal=True)

    check = held_to_plain(kern(), plain(),
                          plain(drop_v_tile(v, n // KV_TILE - 2)))
    ms = cuda_ms(torch, kern, 10)
    flops = 4.0 * e * (n * (n + 1) // 2) * hq
    return {"name": "mas_streamed_blk_q8", **check, "ms": ms,
            "tflops": flops / ms / 1e9,
            "tune_attention": tuned(kind, b_h=hq, n_q=n, n_kv=n, e=e,
                                    causal=True),
            "shape": {"b": 1, "hq": hq, "hkv": hkv, "n": n, "e": e,
                      "blk_q": bq, "causal": True, "dtype": "bf16"}}


def cross_row(torch, rnd, device: dict) -> dict:
    """B2 at a whisper-large-v3 decode step's cross-attention: one query
    row (padded to blk_q 8) over the 1500 memory rows (padded to 1536,
    masked at kv_len), 20 heads of 64 on 20 kv heads, batch 4,
    non-causal, on the operands ``ops.attention`` gives the wrapper;
    checked (untimed) also at the encoder's shape, 1500 frames at blk_q
    32 (Q rows padded to 1504). Faults: a zeroed V tile, and the plain
    version without the kv_len mask, which attends the 36 zero rows of the
    padding. Yardstick: SDPA on the unpadded memory."""
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops

    cfg = get_arch(ENCDEC_ARCH)
    b, h, e = ENCDEC_WAVES[0][0], cfg.num_heads, cfg.hd
    n = cfg.num_frontend_tokens
    checks, timed = [], None
    for nq in (1, n):
        kind, bq = ops.resolve_method(nq, n, e, 2)
        require((kind, bq) == ("mas_streamed", 8 if nq == 1 else 32),
                f"policy routes {nq} x {n} at E {e} to {kind}, blk_q {bq}")
        q, k, v = rnd(b, h, nq, e), rnd(b, h, n, e), rnd(b, h, n, e)
        qf = ops._pad_rows(q.reshape(b * h, nq, e), bq)
        kf, vf = (ops._pad_rows(x.reshape(b * h, n, e), KV_TILE)
                  for x in (k, v))

        def kern(qf=qf, kf=kf, vf=vf, bq=bq, nq=nq):
            return mas.mas_attention_flat(qf, kf, vf, blk_q=bq,
                                          kv_resident=False,
                                          kv_len=n)[:, :nq]

        def plain(vf=vf, kv_len=n, qf=qf, kf=kf, bq=bq, nq=nq):
            return mas.mas_attention_plain(qf, kf, vf, blk_q=bq,
                                           blk_kv=KV_TILE,
                                           kv_len=kv_len)[:, :nq]

        want = plain()
        check = held_to_plain(kern(), want,
                              plain(drop_v_tile(vf, n // KV_TILE - 2)))
        check["kv_tail_fault_row_rel_err"] = row_rel_err(plain(kv_len=None),
                                                         want)
        require(check["kv_tail_fault_row_rel_err"] > BF16_ROW_RTOL,
                f"an unmasked kv tail passes the limit: {check}")
        checks.append({"nq": nq, "blk_q": bq, "q_rows": qf.shape[1],
                       "kv_rows": kf.shape[1], **check})
        if nq == 1:
            timed = (q, k, v, kern, plain, bq)
    q, k, v, kern, plain, bq = timed
    lib = library_call(torch, q, k, v, causal=False)
    flops = 4.0 * e * n * b * h
    nbytes = 2.0 * (2 * b * h * e + 2 * b * h * n * e)
    bms, by = bound(flops, nbytes)
    return {
        "name": "mas_streamed_cross", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mas_attention.cu",
        "replaces": "src/repro/kernels/mas_attention.py:121",
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "row_rel_err": max(c["row_rel_err"] for c in checks),
        "fault_row_rel_err": min(c["fault_row_rel_err"] for c in checks),
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 50),
        **device_times(torch, kern, lib, 50),
        **kernel_report(device, "mas_attention", "mas_streamed_bf16"),
        "tune_attention": tuned("mas_streamed", b_h=b * h, n_q=1, n_kv=n,
                                e=e, causal=False),
        "shape": {"b": b, "hq": h, "hkv": h, "nq": 1, "n": n, "e": e,
                  "blk_q": bq, "causal": False, "dtype": "bf16"},
        "checks": checks,
    }


def rank_b2_rows(torch, rnd, device: dict) -> list[dict]:
    """B2 (non-causal) at the shapes a rank of the split whisper-large-v3
    prefill gives it, batch 1 (prefill_32k's 32 cut), 20 heads of 64 on 20
    kv heads: ``mas_streamed_enc_rank``, an encoder layer's F / n Q rows
    over the 1500 gathered K/V rows (padded to 1536, masked at kv_len),
    and ``mas_streamed_cross_rank``, a rank's S / n decoder rows over the
    1500 memory rows, each at every degree of SEQ_DEGREES, on the
    operands ``ops.attention`` gives the wrapper. Each shape held to B2's
    plain version beside a zeroed V tile and timed with its bound and
    SDPA's time on the unpadded memory; the row's own numbers are the
    largest degree's."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops

    cfg = get_arch(ENCDEC_ARCH)
    h, e, f = cfg.num_heads, cfg.hd, cfg.num_frontend_tokens
    s = SHAPES["prefill_32k"].seq_len
    out = []
    for name, whole in (("mas_streamed_enc_rank", f),
                        ("mas_streamed_cross_rank", s)):
        shapes = []
        for n in SEQ_DEGREES:
            nq = whole // n
            kind, bq = ops.resolve_method(nq, f, e, 2)
            require(kind == "mas_streamed",
                    f"policy routes {nq} x {f} at E {e} to {kind}")
            q, k, v = rnd(1, h, nq, e), rnd(1, h, f, e), rnd(1, h, f, e)
            qf = ops._pad_rows(q.reshape(h, nq, e), bq)
            kf, vf = (ops._pad_rows(x.reshape(h, f, e), KV_TILE)
                      for x in (k, v))

            def kern(qf=qf, kf=kf, vf=vf, bq=bq, nq=nq):
                return mas.mas_attention_flat(qf, kf, vf, blk_q=bq,
                                              kv_resident=False,
                                              kv_len=f)[:, :nq]

            def plain(vf=vf, qf=qf, kf=kf, bq=bq, nq=nq):
                return mas.mas_attention_plain(qf, kf, vf, blk_q=bq,
                                               blk_kv=KV_TILE,
                                               kv_len=f)[:, :nq]

            check = held_to_plain(kern(), plain(),
                                  plain(drop_v_tile(vf, f // KV_TILE - 2)))
            lib = library_call(torch, q, k, v, causal=False)
            flops = 4.0 * e * nq * f * h
            nbytes = 2.0 * (2 * h * nq * e + 2 * h * f * e)
            bms, by = bound(flops, nbytes)
            ms = cuda_ms(torch, kern, 20)
            shapes.append({
                "degree": n, "nq": nq, "blk_q": bq, **check, "ms": ms,
                "plain_ms": cuda_ms(torch, plain, 2), "bound_ms": bms,
                "bound_by": by, "library_ms": cuda_ms(torch, lib, 20),
                **device_times(torch, kern, lib, 20),
                "tflops": flops / ms / 1e9})
        top = shapes[-1]
        out.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mas_attention.cu",
            "replaces": "src/repro/kernels/mas_attention.py:121",
            "launches": 0,
            **{k: top[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms",
                                   "device_ms", "library_device_ms",
                                   "tflops")},
            "row_rel_err": max(c["row_rel_err"] for c in shapes),
            "fault_row_rel_err": min(c["fault_row_rel_err"]
                                     for c in shapes),
            **kernel_report(device, "mas_attention", "mas_streamed_bf16"),
            "shape": {"b": 1, "hq": h, "hkv": h, "n_kv": f, "e": e,
                      "causal": False, "dtype": "bf16",
                      "nq_by_degree": {c["degree"]: c["nq"]
                                       for c in shapes}},
            "by_degree": shapes})
    return out


def paged_library_call(torch, q, k_pages, v_pages, table, mask,
                       k_scales=None, v_scales=None):
    """The yardstick of a paged kernel: the pages gathered dense through
    ``table`` (one indexing op each for K and V; int8 pools then
    dequantized with their per-page scales), then one
    ``scaled_dot_product_attention`` call. q: (B, Hq, Nq, E)."""
    from repro_torch.kernels.common import gather_pages, page_scales

    page = k_pages.shape[2]

    def call():
        k, v = gather_pages(k_pages, table), gather_pages(v_pages, table)
        ks = vs = None
        if k_scales is not None:
            ks = page_scales(k_scales, table, page)
            vs = page_scales(v_scales, table, page)
        if k.dim() == 3:
            k, v = k[None], v[None]
            ks, vs = (None, None) if ks is None else (ks[None], vs[None])
        return library_call(torch, q, k, v, causal=False, mask=mask,
                            k_scale=ks, v_scale=vs)()

    return call


def quantized_rows(x, dims):
    """``x`` quantized with its scales, or ``x`` and None for bf16."""
    from repro_torch.kernels.common import quantize_q8

    return quantize_q8(x, dims) if dims is not None else (x, None)


def decode_row(torch, rnd, cfg, quantized: bool) -> dict:
    """B4 (bf16 or int8 cache, per-row scales) against its plain version:
    through ``ops.decode_attention`` at each wave's first and last decode
    step, as the model calls it, and on a ragged batch against the whole
    dense cache. The fault: a V tile zeroed, or its V scales."""
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = hq // hkv
    dims = -1 if quantized else None
    checks = []
    for _, n, b in WAVES:
        qd = rnd(b, hq, e)
        kc, ks = quantized_rows(rnd(b, hkv, MAX_LEN, e), dims)
        vc, vs = quantized_rows(rnd(b, hkv, MAX_LEN, e), dims)
        sc = dict(k_scale=ks, v_scale=vs)
        for kv_len in (n + 1, n + NEW_TOKENS - 1):
            n_split, tps = dec.decode_split_plan(qd.dtype, b * hkv, kv_len)
            lens = torch.full((b * hkv,), kv_len, dtype=torch.int32,
                              device="cuda")

            def plain(vc=vc, vs=vs):
                flat = {k: None if t is None else t.view(b * hkv, MAX_LEN)
                        for k, t in (("k_scale", ks), ("v_scale", vs))}
                return dec.decode_attention_plain(
                    qd.view(b * hkv, grp, e), kc.view(b * hkv, MAX_LEN, e),
                    vc.view(b * hkv, MAX_LEN, e), lens, n_split=n_split,
                    tiles_per_split=tps, **flat).view(b, hq, e)

            tile = (kv_len - 1) // KV_TILE - 1
            faulty = (plain(vs=drop_scale_tile(vs, tile)) if quantized
                      else plain(vc=drop_v_tile(vc, tile)))
            check = held_to_plain(
                ops.decode_attention(qd, kc, vc, kv_len, **sc), plain(),
                faulty)
            checks.append({"b": b, "kv_len": kv_len, "n_split": n_split,
                           "tiles_per_split": tps, **check})

    # a ragged batch against the whole dense cache
    b = len(DECODE_KV_LENS)
    q = rnd(b * hkv, grp, e)
    k, ks = quantized_rows(rnd(b * hkv, MAX_LEN, e), dims)
    v, vs = quantized_rows(rnd(b * hkv, MAX_LEN, e), dims)
    kv = torch.tensor(DECODE_KV_LENS, dtype=torch.int32, device="cuda")
    lens = kv.repeat_interleave(hkv)
    n_split, tps = dec.decode_split_plan(q.dtype, b * hkv, MAX_LEN)
    kern = lambda: dec.decode_attention_flat(  # noqa: E731
        q, k, v, lens, k_scale=ks, v_scale=vs)

    def plain(v=v, vs=vs):
        return dec.decode_attention_plain(q, k, v, lens, n_split=n_split,
                                          tiles_per_split=tps, k_scale=ks,
                                          v_scale=vs)

    tile = max(DECODE_KV_LENS) // KV_TILE - 1
    faulty = (plain(vs=drop_scale_tile(vs, tile)) if quantized
              else plain(v=drop_v_tile(v, tile)))
    check = held_to_plain(kern(), plain(), faulty)
    checks.append({"b": b, "kv_lens": list(DECODE_KV_LENS),
                   "n_split": n_split, "tiles_per_split": tps, **check})
    mask = (torch.arange(MAX_LEN, device="cuda")[None, :]
            < kv[:, None]).view(b, 1, 1, MAX_LEN)

    def per_seq(t):
        return None if t is None else t.view(b, hkv, MAX_LEN)

    lib = library_call(torch, q.view(b, hq, 1, e),
                       k.view(b, hkv, MAX_LEN, e), v.view(b, hkv, MAX_LEN, e),
                       causal=False, mask=mask, k_scale=per_seq(ks),
                       v_scale=per_seq(vs))
    live = float(sum(DECODE_KV_LENS))
    flops = 4.0 * e * hq * live
    # live K and V rows (int8: one byte an element plus the row's fp32
    # scale), Q and O once
    row_bytes = (e + 4) if quantized else 2 * e
    nbytes = 2.0 * hkv * live * row_bytes + 2.0 * 2 * b * hq * e
    bms, by = bound(flops, nbytes)
    return {
        "name": "decode_int8" if quantized else "decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": ("src/repro/kernels/decode_attention.py:"
                     + ("59" if quantized else "32")),
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "row_rel_err": max(c["row_rel_err"] for c in checks),
        "fault_row_rel_err": min(c["fault_row_rel_err"] for c in checks),
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 50),
        **device_times(torch, kern, lib, 50),
        "shape": {"b": b, "hq": hq, "hkv": hkv, "s": MAX_LEN, "e": e,
                  "kv_lens": list(DECODE_KV_LENS), "n_split": n_split,
                  "tiles_per_split": tps, "dtype": "bf16",
                  "cache": "int8" if quantized else "bf16"},
        "checks": checks,
    }


def paged_rows(torch, rnd, cfg, quantized: bool) -> list[dict]:
    """B6, B5 and B7 (bf16 pools, or int8 pools with per-page scales)
    against their plain versions at the continuous engine's shapes: pools
    of 2049 pages of 16 rows, 8 sequences on shuffled pages (256 pages
    each, 4096 tokens of budget). The fault: a V page zeroed, or its V
    scale."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre
    from repro_torch.kernels import paged_verify_attention as pver

    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = hq // hkv
    page, b = CONT["page_size"], CONT["batch_size"]
    max_pages = CONT["max_len"] // page
    n_pages = b * max_pages + 1
    dims = (-2, -1) if quantized else None
    kp, kps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    vp, vps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    sc = dict(k_scales=kps, v_scales=vps)
    gen = torch.Generator(device="cuda").manual_seed(3)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).view(b, max_pages).to(torch.int32).contiguous()
    suffix = "_int8" if quantized else ""

    def kv_bytes(kv_lens):
        """Bytes of the live K and V rows of sequences of ``kv_lens``
        tokens: bf16, or one byte an element plus one fp32 scale for each
        page they touch."""
        rows = sum(kv_lens)
        if not quantized:
            return 2.0 * hkv * rows * 2 * e
        pages = sum(-(-n // page) for n in kv_lens)
        return 2.0 * hkv * (rows * e + 4 * pages)
    shape = {"b": b, "hq": hq, "hkv": hkv, "pages": n_pages, "page": page,
             "max_pages": max_pages, "e": e, "dtype": "bf16",
             "pool": "int8" if quantized else "bf16"}

    def faulty(plain, fault_page):
        if quantized:
            return plain(vps=drop_scale_page(vps, fault_page))
        return plain(vp=drop_v_page(vp, fault_page))

    rows = []
    # B6: one decode step of the batch
    lens = torch.tensor(PAGED_DECODE_KV_LENS, dtype=torch.int32,
                        device="cuda")
    qd = rnd(b, hq, e)
    n_split, tps = dec.decode_split_plan(qd.dtype, b * hkv, max_pages * page)
    kern = lambda: ops.paged_decode_attention(  # noqa: E731
        qd, kp, vp, table, lens, **sc)

    def plain(vp=vp, vps=vps):
        return pdec.paged_decode_attention_plain(
            qd.view(b, hkv, grp, e), kp, vp, table, lens, n_split=n_split,
            tiles_per_split=tps, k_scales=kps, v_scales=vps).view(b, hq, e)

    longest = max(range(b), key=lambda i: PAGED_DECODE_KV_LENS[i])
    fault_page = int(table[longest, (PAGED_DECODE_KV_LENS[longest] - 1)
                           // page - 1])
    check = held_to_plain(kern(), plain(), faulty(plain, fault_page))
    live = float(sum(PAGED_DECODE_KV_LENS))
    bms, by = bound(4.0 * e * hq * live,
                    kv_bytes(PAGED_DECODE_KV_LENS) + 2.0 * 2 * b * hq * e)
    mask = (torch.arange(max_pages * page, device="cuda")[None, :]
            < lens[:, None].long()).view(b, 1, 1, -1)
    lib = paged_library_call(torch, qd.view(b, hq, 1, e), kp, vp, table,
                             mask, **sc)
    rows.append({
        "name": "paged_decode" + suffix, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "replaces": ("src/repro/kernels/paged_decode_attention.py:"
                     + ("72" if quantized else "43")),
        "launches": 0, **check,
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 20),
        **device_times(torch, kern, lib, 50),
        "shape": {**shape, "kv_lens": list(PAGED_DECODE_KV_LENS),
                  "n_split": n_split, "tiles_per_split": tps},
    })

    # B5: 512-row chunks of the longest sequence, first, off the block
    # grid (checked only) and late
    chunk = CONT["chunk_size"]
    bq = ops.paged_prefill_blk_q(chunk, torch.bfloat16)
    seq_table = table[longest]
    checks = []
    for q0, kv_len, timed in PAGED_PREFILL:
        qp = rnd(hq, chunk, e)
        span = device_span(torch, q0, kv_len)
        kern = lambda qp=qp, span=span: (  # noqa: E731
            ops.paged_prefill_attention(qp, kp, vp, seq_table, span, **sc))

        def plain(vp=vp, vps=vps, qp=qp, span=span):
            return ppre.paged_prefill_attention_plain(
                qp, kp, vp, seq_table, span, blk_q=bq, k_scales=kps,
                v_scales=vps)

        fault_page = int(seq_table[kv_len // page - 2])
        check = held_to_plain(kern(), plain(), faulty(plain, fault_page))
        checks.append({"q_offset": q0, "kv_len": kv_len, **check})
        if not timed:
            continue
        # visible (query, key) pairs: row i sees min(q0 + i + 1, kv_len)
        pairs = float(sum(min(q0 + i + 1, kv_len) for i in range(chunk)))
        flops = 4.0 * e * hq * pairs
        bms, by = bound(flops, kv_bytes([kv_len]) + 2.0 * 2 * hq * chunk * e)
        cols = torch.arange(max_pages * page, device="cuda")
        mask = ((cols[None, :] <= q0 + torch.arange(chunk, device="cuda")
                 [:, None]) & (cols[None, :] < kv_len)).view(1, 1, chunk, -1)
        lib = paged_library_call(torch, qp[None], kp, vp, seq_table, mask,
                                 **sc)
        ms = cuda_ms(torch, kern, 20)
        checks[-1].update({"ms": ms, "plain_ms": cuda_ms(torch, plain, 2),
                           "bound_ms": bms, "bound_by": by,
                           "library_ms": cuda_ms(torch, lib, 20),
                           **device_times(torch, kern, lib, 20),
                           "tflops": flops / ms / 1e9})
    late = checks[-1]
    rows.append({
        "name": "paged_prefill" + suffix, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": ("src/repro/kernels/paged_prefill_attention.py:"
                     + ("85" if quantized else "52")),
        "launches": 0,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "row_rel_err": max(c["row_rel_err"] for c in checks),
        "fault_row_rel_err": min(c["fault_row_rel_err"] for c in checks),
        **{key: late[key] for key in (
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms", "device_retries",
            "device_dropped", "tflops")},
        "shape": {**shape, "chunk": chunk, "blk_q": bq,
                  "q_offset": late["q_offset"], "kv_len": late["kv_len"]},
        "checks": checks,
    })

    # B7: one verify step of the batch, SPEC_DEPTH candidate rows a slot
    # ending at PAGED_DECODE_KV_LENS (fewer where a sequence is shorter)
    spec = SPEC_DEPTH
    n_rows = lens.clamp(max=spec)
    starts = (lens - n_rows).contiguous()
    qv = rnd(b, hkv, spec * grp, e)           # position-major rows
    n_split, tps = dec.decode_split_plan(qv.dtype, b * hkv, max_pages * page)
    kern = lambda: pver.paged_verify_attention_flat(  # noqa: E731
        qv, kp, vp, table, lens, starts, spec=spec, **sc)

    def plain(vp=vp, vps=vps):
        return pver.paged_verify_attention_plain(
            qv, kp, vp, table, lens, starts, spec=spec, n_split=n_split,
            tiles_per_split=tps, k_scales=kps, v_scales=vps)

    fault_page = int(table[longest, (PAGED_DECODE_KV_LENS[longest] - 1)
                           // page - 1])
    check = held_to_plain(kern(), plain(), faulty(plain, fault_page))
    # each (slot, kv head) row r sees min(start + r // G + 1, kv_len) keys
    pairs = float(sum(min(int(s0) + r // grp + 1, int(n))
                      for s0, n in zip(starts.tolist(), lens.tolist())
                      for r in range(spec * grp)))
    bms, by = bound(4.0 * e * hkv * pairs,
                    kv_bytes(PAGED_DECODE_KV_LENS)
                    + 2.0 * 2 * b * spec * hq * e)
    pos = starts[:, None].long() + torch.arange(spec, device="cuda")
    cols = torch.arange(max_pages * page, device="cuda")
    mask = ((cols[None, None, :] <= pos[:, :, None])
            & (cols[None, None, :] < lens[:, None, None].long())
            ).view(b, 1, spec, -1)
    qlib = qv.view(b, hkv, spec, grp, e).permute(0, 1, 3, 2, 4).reshape(
        b, hq, spec, e)
    lib = paged_library_call(torch, qlib, kp, vp, table, mask, **sc)
    rows.append({
        "name": "paged_verify" + suffix, "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_verify_attention.cu",
        "replaces": ("src/repro/kernels/paged_verify_attention.py:"
                     + ("89" if quantized else "55")),
        "launches": 0, **check,
        "ms": cuda_ms(torch, kern, 50), "plain_ms": cuda_ms(torch, plain, 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 20),
        **device_times(torch, kern, lib, 50),
        "shape": {**shape, "spec": spec, "group": grp,
                  "kv_lens": list(PAGED_DECODE_KV_LENS),
                  "n_rows": n_rows.tolist(), "n_split": n_split,
                  "tiles_per_split": tps},
    })
    return rows


def shard_rows(torch, rnd, cfg, quantized: bool) -> list[dict]:
    """B6, B5 and B7 (bf16 pools, or int8 pools with per-page scales) on a
    rank's KV heads, the shapes the sharded phase gives them: the paged
    rows' batch and pools, cut to the last rank's SHARD_HEADS heads of
    internlm2's 8 (rank 1 of 2, rank 3 of 4). A head slice's call with
    the model's split plan (``plan_kv_heads``) must equal the full-head
    call's slice bit for bit (B5 has no split: its slice call as it is);
    with the slice's own plan the largest difference is recorded, also
    on a table of SHARD_SHORT_PAGES pages, where the plans differ. Each
    slice call is held to its plain version beside a zeroed V page (or V
    scale), and timed at the first SHARD_HEADS entry (degree 2)."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_decode_attention as pdec
    from repro_torch.kernels import paged_prefill_attention as ppre
    from repro_torch.kernels import paged_verify_attention as pver

    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    grp = hq // hkv
    page, b = CONT["page_size"], CONT["batch_size"]
    max_pages = CONT["max_len"] // page
    n_pages = b * max_pages + 1
    n_kv = max_pages * page
    dims = (-2, -1) if quantized else None
    kp, kps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    vp, vps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    gen = torch.Generator(device="cuda").manual_seed(5)
    table = (torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
             ).view(b, max_pages).to(torch.int32).contiguous()
    suffix = "_int8" if quantized else ""
    lens = torch.tensor(PAGED_DECODE_KV_LENS, dtype=torch.int32,
                        device="cuda")
    longest = max(range(b), key=lambda i: PAGED_DECODE_KV_LENS[i])
    seq_table = table[longest]
    chunk = CONT["chunk_size"]
    bq = ops.paged_prefill_blk_q(chunk, torch.bfloat16)
    q0, kv_len, _ = PAGED_PREFILL[-1]          # the late chunk
    span = device_span(torch, q0, kv_len)
    spec = SPEC_DEPTH
    n_rows = lens.clamp(max=spec)
    starts = (lens - n_rows).contiguous()
    qd, qp = rnd(b, hq, e), rnd(hq, chunk, e)
    qv = rnd(b, hkv, spec * grp, e)            # position-major rows
    model_plan = dec.decode_split_plan(torch.bfloat16, b * hkv, n_kv)

    def kv_bytes(kv_lens, h):
        rows = sum(kv_lens)
        if not quantized:
            return 2.0 * h * rows * 2 * e
        pages = sum(-(-n // page) for n in kv_lens)
        return 2.0 * h * (rows * e + 4 * pages)

    def pools(h, r):
        """The rank's K, V and scales (None for bf16): views of its heads."""
        return [None if t is None else t[r * h:(r + 1) * h]
                for t in (kp, vp, kps, vps)]

    decode_mask = (torch.arange(n_kv, device="cuda")[None, :]
                   < lens[:, None].long()).view(b, 1, 1, -1)
    decode_fault = int(table[longest, (PAGED_DECODE_KV_LENS[longest] - 1)
                             // page - 1])

    def b6(h, r):
        k, v, ks, vs = pools(h, r)
        q = qd[:, r * h * grp:(r + 1) * h * grp]
        return {
            "call": lambda plan=None: ops.paged_decode_attention(
                q, k, v, table, lens, k_scales=ks, v_scales=vs,
                plan_kv_heads=plan),
            "plain": lambda v=v, vs=vs: pdec.paged_decode_attention_plain(
                q.reshape(b, h, grp, e), k, v, table, lens,
                n_split=model_plan[0], tiles_per_split=model_plan[1],
                k_scales=ks, v_scales=vs).view(b, h * grp, e),
            "lib": paged_library_call(torch, q.reshape(b, h * grp, 1, e), k,
                                      v, table, decode_mask, k_scales=ks,
                                      v_scales=vs),
            "part": lambda o: o[:, r * h * grp:(r + 1) * h * grp],
            "flops": 4.0 * e * h * grp * sum(PAGED_DECODE_KV_LENS),
            "nbytes": (kv_bytes(PAGED_DECODE_KV_LENS, h)
                       + 2.0 * 2 * b * h * grp * e),
            "fault": decode_fault, "v": v, "vs": vs,
            "local_plan": dec.decode_split_plan(q.dtype, b * h, n_kv)}

    cols = torch.arange(n_kv, device="cuda")
    prefill_mask = ((cols[None, :] <= q0 + torch.arange(chunk, device="cuda")
                     [:, None]) & (cols[None, :] < kv_len)).view(1, 1, chunk,
                                                                 -1)

    def b5(h, r):
        k, v, ks, vs = pools(h, r)
        q = qp[r * h * grp:(r + 1) * h * grp]
        pairs = float(sum(min(q0 + i + 1, kv_len) for i in range(chunk)))
        return {
            "call": lambda plan=None: ops.paged_prefill_attention(
                q, k, v, seq_table, span, k_scales=ks, v_scales=vs),
            "plain": lambda v=v, vs=vs: ppre.paged_prefill_attention_plain(
                q, k, v, seq_table, span, blk_q=bq, k_scales=ks,
                v_scales=vs),
            "lib": paged_library_call(torch, q[None], k, v, seq_table,
                                      prefill_mask, k_scales=ks, v_scales=vs),
            "part": lambda o: o[r * h * grp:(r + 1) * h * grp],
            "flops": 4.0 * e * h * grp * pairs,
            "nbytes": kv_bytes([kv_len], h) + 2.0 * 2 * h * grp * chunk * e,
            "fault": int(seq_table[kv_len // page - 2]), "v": v, "vs": vs,
            "local_plan": None}

    pos = starts[:, None].long() + torch.arange(spec, device="cuda")
    verify_mask = ((cols[None, None, :] <= pos[:, :, None])
                   & (cols[None, None, :] < lens[:, None, None].long())
                   ).view(b, 1, spec, -1)

    def b7(h, r):
        k, v, ks, vs = pools(h, r)
        q = qv[:, r * h:(r + 1) * h].contiguous()
        pairs = float(sum(min(int(s0) + i // grp + 1, int(n))
                          for s0, n in zip(starts.tolist(), lens.tolist())
                          for i in range(spec * grp)))
        qlib = q.view(b, h, spec, grp, e).permute(0, 1, 3, 2, 4).reshape(
            b, h * grp, spec, e)
        return {
            "call": lambda plan=None: pver.paged_verify_attention_flat(
                q, k, v, table, lens, starts, spec=spec, k_scales=ks,
                v_scales=vs, plan_kv_heads=plan),
            "plain": lambda v=v, vs=vs: pver.paged_verify_attention_plain(
                q, k, v, table, lens, starts, spec=spec,
                n_split=model_plan[0], tiles_per_split=model_plan[1],
                k_scales=ks, v_scales=vs),
            "lib": paged_library_call(torch, qlib, k, v, table, verify_mask,
                                      k_scales=ks, v_scales=vs),
            "part": lambda o: o[:, r * h:(r + 1) * h],
            "flops": 4.0 * e * h * pairs,
            "nbytes": (kv_bytes(PAGED_DECODE_KV_LENS, h)
                       + 2.0 * 2 * b * spec * h * grp * e),
            "fault": decode_fault, "v": v, "vs": vs,
            "local_plan": dec.decode_split_plan(q.dtype, b * h, n_kv)}

    def short_table(name, h, r):
        """B6 or B7 on the first SHARD_SHORT_PAGES pages of the table: the
        slice call with the model's plan is the full call's slice bit for
        bit; the difference with the slice's own plan is recorded."""
        tab = table[:, :SHARD_SHORT_PAGES].contiguous()
        kl = lens.clamp(max=SHARD_SHORT_PAGES * page)
        k, v, ks, vs = pools(h, r)
        if name == "paged_decode":
            want = ops.paged_decode_attention(
                qd, kp, vp, tab, kl, k_scales=kps,
                v_scales=vps)[:, r * h * grp:(r + 1) * h * grp]
            q = qd[:, r * h * grp:(r + 1) * h * grp]

            def call(plan=None):
                return ops.paged_decode_attention(
                    q, k, v, tab, kl, k_scales=ks, v_scales=vs,
                    plan_kv_heads=plan)
        else:
            st = (kl - kl.clamp(max=spec)).contiguous()
            want = pver.paged_verify_attention_flat(
                qv, kp, vp, tab, kl, st, spec=spec, k_scales=kps,
                v_scales=vps)[:, r * h:(r + 1) * h]
            q = qv[:, r * h:(r + 1) * h].contiguous()

            def call(plan=None):
                return pver.paged_verify_attention_flat(
                    q, k, v, tab, kl, st, spec=spec, k_scales=ks,
                    v_scales=vs, plan_kv_heads=plan)
        require(torch.equal(call(hkv), want),
                f"{name}{suffix} on {SHARD_SHORT_PAGES} pages: heads with "
                f"the model's plan differ from the full call's")
        n_kv_short = SHARD_SHORT_PAGES * page
        return {"pages": SHARD_SHORT_PAGES, "bitwise_with_model_plan": True,
                "model_plan": list(dec.decode_split_plan(
                    torch.bfloat16, b * hkv, n_kv_short)),
                "local_plan": list(dec.decode_split_plan(
                    torch.bfloat16, b * h, n_kv_short)),
                "local_plan_max_abs_diff": max_err(call(), want)}

    rows = []
    for name, make, replaces in (
            ("paged_decode", b6, ("72", "43")),
            ("paged_prefill", b5, ("85", "52")),
            ("paged_verify", b7, ("89", "55"))):
        planned = name != "paged_prefill"
        plan = hkv if planned else None
        whole = make(hkv, 0)["call"]()
        heads = {}
        for h in SHARD_HEADS:
            r = hkv // h - 1
            c = make(h, r)
            got = c["call"](plan)
            want = c["part"](whole)
            require(torch.equal(got, want),
                    f"{name}{suffix}: heads {r * h}-{(r + 1) * h - 1} with "
                    f"the model's plan differ from the full call's")
            faulty = (c["plain"](vs=drop_scale_page(c["vs"], c["fault"]))
                      if quantized else
                      c["plain"](v=drop_v_page(c["v"], c["fault"])))
            check = held_to_plain(got, c["plain"](), faulty)
            require(check["row_rel_err"] <= BF16_ROW_RTOL,
                    f"{name}{suffix} at {h} heads: {check}")
            heads[h] = {"rank": r, "degree": hkv // h,
                        "bitwise_with_model_plan": True, **check}
            if planned:
                heads[h].update({
                    "local_plan": list(c["local_plan"]),
                    "local_plan_max_abs_diff": max_err(c["call"](), want),
                    "short_table": short_table(name, h, r)})
        h = SHARD_HEADS[0]
        c = make(h, hkv // h - 1)
        kern = lambda c=c: c["call"](plan)  # noqa: E731
        bms, by = bound(c["flops"], c["nbytes"])
        ms = cuda_ms(torch, kern, 50)
        rows.append({
            "name": f"{name}{suffix}_shard", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}_attention.cu",
            "replaces": (f"src/repro/kernels/{name}_attention.py:"
                         + replaces[0 if quantized else 1]),
            "launches": 0,
            **{k: heads[h][k] for k in ("max_abs_err", "row_rel_err",
                                        "fault_row_rel_err")},
            "ms": ms, "plain_ms": cuda_ms(torch, c["plain"], 3),
            "bound_ms": bms, "bound_by": by,
            "library_ms": cuda_ms(torch, c["lib"], 20),
            **device_times(torch, kern, c["lib"], 50),
            "shape": {"b": b, "hq": h * grp, "hkv": h, "model_hkv": hkv,
                      "pages": n_pages, "page": page, "e": e,
                      "pool": "int8" if quantized else "bf16",
                      "model_plan": list(model_plan) if planned else None},
            "heads": heads,
        })
        if name == "paged_prefill":
            rows[-1]["tflops"] = c["flops"] / ms / 1e9
    return rows


def ring_rows(torch, rnd, cfg, quantized: bool) -> dict:
    """B5 as a hop of the head-block ring (``distributed/paged.
    ring_paged_prefill``, the sharded phase's ``chunk_route="ring"``) at
    that phase's shapes: the last rank of RING_DEGREE, its 1/n of the
    late chunk's rows (PAGED_PREFILL[-1]) with every query head, and in
    turn the slab of each head shard (SHARD_HEADS[0] of internlm2's 8 KV
    heads, the longest sequence's table gathered from the paged rows'
    2049-page pools: a pool of max_pages pages), an identity table on
    the device and the span moved to the rank's first row, bf16 pools or
    int8 pools with their scales. Each hop is held to its plain version
    and the rank's assembled rows to the plain hops', rows within
    BF16_ROW_RTOL, beside two planted faults the limit must reject: hops
    that write each other's head slots, and a skipped hop (its slot left
    zero). Each hop's rows against the same slot of the single card's
    B5 call: bit for bit or not, recorded (it sets the sharded phase's
    token gate). Timed at one hop."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_prefill_attention as ppre

    hq, hkv, e = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    n, h = RING_DEGREE, SHARD_HEADS[0]
    require(hkv // h == n, f"{h} heads a rank is not degree {n}")
    grp, r = hq // hkv, n - 1
    page, b = CONT["page_size"], CONT["batch_size"]
    max_pages = CONT["max_len"] // page
    n_pages = b * max_pages + 1
    chunk = CONT["chunk_size"]
    rows = chunk // n
    dims = (-2, -1) if quantized else None
    kp, kps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    vp, vps = quantized_rows(rnd(hkv, n_pages, page, e), dims)
    gen = torch.Generator(device="cuda").manual_seed(5)
    seq_table = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
                 + 1)[:max_pages].to(torch.int32).contiguous()
    ids = seq_table.long()
    q0, kv_len, _ = PAGED_PREFILL[-1]
    span = device_span(torch, q0, kv_len)
    qp = rnd(hq, chunk, e)
    q_loc = qp[:, r * rows:(r + 1) * rows]
    identity = torch.arange(max_pages, dtype=torch.int32, device="cuda")
    hop_span = span.clone()
    hop_span[0].add_(r * rows)
    bq = ops.paged_prefill_blk_q(rows, torch.bfloat16)
    suffix = "_int8" if quantized else ""

    def slab(src):
        heads = slice(src * h, (src + 1) * h)
        out = [kp[heads][:, ids], vp[heads][:, ids]]
        if quantized:
            out += [kps[heads][:, ids], vps[heads][:, ids]]
        else:
            out += [None, None]
        return out

    def hop(src, plain=False):
        k, v, ks, vs = slab(src)
        q = q_loc[src * h * grp:(src + 1) * h * grp]
        if plain:
            return ppre.paged_prefill_attention_plain(
                q, k, v, identity, hop_span, blk_q=bq, k_scales=ks,
                v_scales=vs)
        return ops.paged_prefill_attention(q, k, v, identity, hop_span,
                                           k_scales=ks, v_scales=vs)

    whole = ops.paged_prefill_attention(qp, kp, vp, seq_table, span,
                                        k_scales=kps, v_scales=vps)
    order = [(r - t) % n for t in range(n)]      # the ring's hop order
    got = {src: hop(src) for src in order}
    plain = {src: hop(src, plain=True) for src in order}
    slot = h * grp
    hops, bitwise = [], True
    for src in order:
        check = {"src": src,
                 "max_abs_err": max_err(got[src], plain[src]),
                 "row_rel_err": row_rel_err(got[src], plain[src])}
        one = whole[src * slot:(src + 1) * slot, r * rows:(r + 1) * rows]
        check["bitwise_vs_one_card"] = bool(torch.equal(got[src], one))
        check["max_abs_diff_vs_one_card"] = max_err(got[src], one)
        bitwise &= check["bitwise_vs_one_card"]
        require(check["row_rel_err"] <= BF16_ROW_RTOL,
                f"paged_prefill_ring{suffix} hop of head shard {src}: "
                f"{check}")
        hops.append(check)

    def assemble(fault=None):
        out = torch.zeros_like(q_loc)
        for t, src in enumerate(order):
            if fault == "skipped" and t == 1:
                continue
            # the planted slot fault: every hop writes the next one's slot
            dst = order[(t + 1) % n] if fault == "wrong_slot" else src
            out[dst * slot:(dst + 1) * slot] = got[src]
        return out

    want = assemble()
    for src in order:
        want[src * slot:(src + 1) * slot] = plain[src]
    check = {"max_abs_err": max_err(assemble(), want),
             "row_rel_err": row_rel_err(assemble(), want),
             "fault_wrong_slot_row_rel_err": row_rel_err(
                 assemble("wrong_slot"), want),
             "fault_skipped_hop_row_rel_err": row_rel_err(
                 assemble("skipped"), want)}
    require(check["row_rel_err"] <= BF16_ROW_RTOL,
            f"paged_prefill_ring{suffix}: the rank's rows {check}")
    for fault in ("wrong_slot", "skipped_hop"):
        require(check[f"fault_{fault}_row_rel_err"] > BF16_ROW_RTOL,
                f"paged_prefill_ring{suffix}: a planted {fault} passes the "
                f"rows limit: {check}")
    src = order[0]
    k, v, ks, vs = slab(src)
    cols = torch.arange(max_pages * page, device="cuda")
    pos = q0 + r * rows + torch.arange(rows, device="cuda")
    mask = ((cols[None, :] <= pos[:, None]) & (cols[None, :] < kv_len)
            ).view(1, 1, rows, -1)
    lib = paged_library_call(torch, q_loc[src * slot:(src + 1) * slot][None],
                             k, v, identity, mask, k_scales=ks, v_scales=vs)
    pairs = float(sum(min(int(p) + 1, kv_len) for p in pos.tolist()))
    flops = 4.0 * e * slot * pairs
    kv_bytes = (2.0 * h * kv_len * e * (1 if quantized else 2)
                + (2.0 * h * -(-kv_len // page) * 4 if quantized else 0))
    nbytes = kv_bytes + 2.0 * 2 * slot * rows * e
    bms, by = bound(flops, nbytes)
    kern = lambda: hop(src)  # noqa: E731
    ms = cuda_ms(torch, kern, 50)
    return {
        "name": f"paged_prefill_ring{suffix}", "label": f"B5_ring{suffix}",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_prefill_attention.cu",
        "replaces": ("src/repro/kernels/paged_prefill_attention.py:"
                     + ("85" if quantized else "52")),
        "ring_of": "src/repro/distributed/paged.py:61",
        "launches": 0, **check,
        "ms": ms, "plain_ms": cuda_ms(torch, lambda: hop(src, True), 3),
        "bound_ms": bms, "bound_by": by,
        "library_ms": cuda_ms(torch, lib, 20),
        **device_times(torch, kern, lib, 50),
        "tflops": flops / ms / 1e9,
        "bitwise_vs_one_card": bitwise, "hops": hops,
        "shape": {"degree": n, "rank": r, "rows": rows, "hq": slot,
                  "hkv": h, "slab_pages": max_pages, "page": page, "e": e,
                  "blk_q": bq, "q_offset": q0 + r * rows, "kv_len": kv_len,
                  "one_card_chunk": chunk,
                  "pool": "int8" if quantized else "bf16"},
    }


def tensors_of(tree) -> list:
    """The tensors of a params tree (dicts and lists of tensors)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tensors_of(v)]
    return [tree]


def full_width_model(torch, arch: str = ARCH, cfg=None) -> dict:
    """Full-width ``arch`` (or ``cfg``) in bf16 with random weights from
    seed 0."""
    from repro_torch.configs import get_arch
    from repro_torch.models.api import build_model

    cfg = cfg or get_arch(arch)
    require(cfg.attn_impl == "kernel", "the main path runs the kernels")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device="cuda", dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tensors_of(params))
    require(n_params == cfg.param_count(),
            f"{cfg.name}: {n_params} parameters drawn, "
            f"{cfg.param_count()} counted")
    return {"model": model, "params": params,
            "init_s": time.perf_counter() - t0, "n_params": n_params}


def ssd_inputs(torch, gen, batch: int, heads: int, nc: int, q: int, p: int,
               n: int, dtype, a_scale: float = 1.0):
    """B8's inputs (B·H, NC, Q, F) as the model makes them: x, b and c
    ~ N(0, 1) in ``dtype``; a = -a_scale · softplus(N(0, 1)) · A_h in
    fp32, with the init's A_h = linspace(1, 16, H) for head h = cell % H
    (at a_scale 1, a·dt of about -0.7 to -11 a step, so a_cum reaches
    about -2000 within a 256-row chunk)."""
    F = torch.nn.functional
    bh = batch * heads

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    x, b, c = rnd(bh, nc, q, p), rnd(bh, nc, q, n), rnd(bh, nc, q, n)
    a_h = torch.linspace(1.0, 16.0, heads, device="cuda").repeat(batch)
    a = -a_scale * F.softplus(rnd(bh, nc, q)) * a_h[:, None, None]
    return x.to(dtype), a, b.to(dtype), c.to(dtype)


def drop_x_tile(x, cell: tuple[int, int], tile: int, rows: int = 64):
    """``x`` (B·H, NC, Q, P) with rows [tile·64, tile·64 + 64) of one
    (B·H, chunk) cell zeroed: what a kernel that skipped that X tile would
    compute with (its rows' y, and the cell's state)."""
    out = x.clone()
    out[cell[0], cell[1], tile * rows:(tile + 1) * rows] = 0
    return out


def x_tile_at(x) -> tuple[tuple[int, int], int]:
    """Where the B8 checks plant a zeroed X tile in ``x`` (B·H, NC, Q, P):
    the middle (B·H) row's last chunk, its last 64-row tile."""
    return (x.shape[0] // 2, x.shape[1] - 1), (x.shape[2] - 1) // 64


def b8_scaled(base, eps: float):
    """``base`` (a B8: the kernel or its plain version) with its output,
    y and states, times 1 + eps."""
    def b8(x, a, b, c):
        y, states = base(x, a, b, c)
        return y * (1 + eps), states * (1 + eps)
    return b8


def b8_faults(base) -> dict:
    """Wrong B8s built on ``base`` that the ssm wave's checks must reject:
    its output times 1 + 1e-3; one cell's last X tile zeroed (``x_tile_at``);
    that cell's last diagonal tile of (C Bᵀ ⊙ L) X skipped; L without its
    diagonal (j < i); the state without its decay."""
    import torch

    from repro_torch.kernels import ssd_scan as ssd

    def zeroed_x_tile(x, a, b, c):
        return base(drop_x_tile(x, *x_tile_at(x)), a, b, c)

    def skipped_diagonal_tile(x, a, b, c):
        y, states = base(x, a, b, c)
        (k, ch), tile = x_tile_at(x)
        rows = slice(tile * 64, min(tile * 64 + 64, x.shape[2]))
        a_cum = ssd.cumsum_sequential(a[k, ch, rows])
        diff = a_cum[:, None] - a_cum[None, :]
        lmat = torch.where(torch.ones_like(diff, dtype=torch.bool).tril(),
                           torch.exp(diff), 0.0)
        s = c[k, ch, rows].float() @ b[k, ch, rows].float().T
        y = y.clone()
        y[k, ch, rows] -= (s * lmat) @ x[k, ch, rows].float()
        return y, states

    def dropped_l_diagonal(x, a, b, c):
        y, states = base(x, a, b, c)
        s_ii = (c.float() * b.float()).sum(-1, keepdim=True)   # L_ii = 1
        return y - s_ii * x.float(), states

    def undecayed_state(x, a, b, c):
        y, _ = base(x, a, b, c)
        return y, b.float().transpose(-1, -2) @ x.float()

    return {"scaled_1e-3": b8_scaled(base, 1e-3),
            "zeroed_x_tile": zeroed_x_tile,
            "skipped_diagonal_tile": skipped_diagonal_tile,
            "dropped_l_diagonal": dropped_l_diagonal,
            "undecayed_state": undecayed_state}


def b8_call_check(got, x, a, b, c, plant: bool = True) -> dict:
    """One B8 call's output ``got`` (y, states) against the plain version
    on the same inputs: the larger row error of y and states, and (with
    ``plant``) the smaller of the planted fault's, the plain version on a
    zeroed X tile (``b8_faults``), which must exceed SSD_FP32_ROW_RTOL."""
    from repro_torch.kernels import ssd_scan as ssd

    plain = ssd.ssd_intra_chunk_plain
    want = plain(x, a, b, c)
    check = {"row_rel_err": max(row_rel_err(g, w)
                                for g, w in zip(got, want))}
    if plant:
        faulty = b8_faults(plain)["zeroed_x_tile"](x, a, b, c)
        check["fault_row_rel_err"] = min(row_rel_err(f, w)
                                         for f, w in zip(faulty, want))
    return check


def b8_gate(model, params, prompt, b8=None, plant: bool = True):
    """Gate 1 of the ssm wave: the kernel route's prefill of ``prompt``
    (1, L) with every call of ``ssd_intra_chunk`` (``b8``, or the wrapper
    itself: the kernel on a CUDA tensor) held to the plain version on the
    same inputs as it returns (``b8_call_check``), so that no call's
    inputs outlive it. Returns (logits, {calls, largest row error,
    smallest planted fault error, limit})."""
    from repro_torch.kernels import ssd_scan as ssd

    real = ssd.ssd_intra_chunk
    calls = []

    def watched(x, a, b, c):
        got = (b8 or real)(x, a, b, c)
        calls.append(b8_call_check(got, x, a, b, c, plant))
        return got

    ssd.ssd_intra_chunk = watched
    try:
        logits, _ = model.prefill(params, model.cfg, prompt,
                                  prompt.shape[1])
    finally:
        ssd.ssd_intra_chunk = real
    gate = {"calls": len(calls), "limit": SSD_FP32_ROW_RTOL,
            "row_rel_err": max(c["row_rel_err"] for c in calls)}
    if plant:
        gate["fault_row_rel_err"] = min(c["fault_row_rel_err"]
                                        for c in calls)
    return logits, gate


def ssd_layer_gate(model, plain_model, params, prompt, b8=None,
                   plant: bool = True):
    """Gate 2 of the ssm wave: the plain route's prefill of ``prompt``,
    and at each SSD layer ``ssm.ssd_block`` on that layer's input once
    more through the kernel route (``ssd_intra_chunk`` replaced by ``b8``
    where given) and, with ``plant``, through the kernel route with the
    zeroed X tile of ``b8_faults`` planted in its B8 call. Held within
    BF16_ROW_RTOL: the rows of each route's chunked scan (y and the final
    state) in fp32, before the scan rounds y to bf16, which takes in the
    padding, the recurrence across chunks and the carried-in state's
    decay around B8. The block's bf16 output rows are recorded beside
    them, not held: the bf16 roundings after the scan turn the routes'
    fp32 difference (3e-4 of a row, mostly a_cum summed in another order
    by the plain scan) into 4e-3-7e-3 with the same B8 on both routes.
    Returns (the plain route's logits, {layers, largest row errors,
    smallest planted fault error, limit})."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm

    real_block, real_b8 = ssm.ssd_block, ssd.ssd_intra_chunk
    real_plain, real_kernel = ssm.ssd_chunked, ops.ssd_chunked
    faulty = b8_faults(real_b8)["zeroed_x_tile"]
    scans, errs = [], {"y": [], "state": [], "block": [], "fault": []}

    def plain_scan(x, a, b, c, chunk, initial_state=None):
        # the plain scan sums in fp32 whatever its inputs' type: the same
        # arithmetic on fp32 copies, y not rounded
        y, state = real_plain(x.float(), a, b.float(), c.float(), chunk,
                              initial_state=initial_state)
        scans.append((y, state))
        return y.to(x.dtype), state

    def kernel_scan(x, a, b, c, chunk, initial_state=None):
        y, state = real_kernel(x, a, b, c, chunk,
                               initial_state=initial_state,
                               out_dtype=torch.float32)
        scans.append((y, state))
        return y.to(x.dtype), state

    def route(layer, x, cfg, b8_fn, **kw):
        ssm.ssd_chunked, ops.ssd_chunked = plain_scan, kernel_scan
        ssd.ssd_intra_chunk = b8_fn
        try:
            out = real_block(layer, x, cfg, **kw)
        finally:
            ssm.ssd_chunked, ops.ssd_chunked = real_plain, real_kernel
            ssd.ssd_intra_chunk = real_b8
        return out, scans.pop()

    def teacher_forced(layer, x, cfg, **kw):
        want, want_scan = route(layer, x, cfg, real_b8, **kw)
        got, got_scan = route(layer, x, model.cfg, b8 or real_b8)
        errs["y"].append(row_rel_err(got_scan[0], want_scan[0]))
        errs["state"].append(row_rel_err(got_scan[1], want_scan[1]))
        errs["block"].append(row_rel_err(got[0], want[0]))
        if plant:
            bad_scan = route(layer, x, model.cfg, faulty)[1]
            errs["fault"].append(min(row_rel_err(b, w)
                                     for b, w in zip(bad_scan, want_scan)))
        return want

    ssm.ssd_block = teacher_forced
    try:
        logits, _ = plain_model.prefill(params, plain_model.cfg, prompt,
                                        prompt.shape[1])
    finally:
        ssm.ssd_block = real_block
    gate = {"layers": len(errs["y"]), "limit": BF16_ROW_RTOL,
            "row_rel_err": max(errs["y"] + errs["state"]),
            "y_row_rel_err": max(errs["y"]),
            "state_row_rel_err": max(errs["state"]),
            "block_bf16_row_rel_err": max(errs["block"])}
    if plant:
        gate["fault_row_rel_err"] = min(errs["fault"])
    return logits, gate


def ssd_fp32_checks(torch) -> dict:
    """Row-relative L2 errors in fp32: B8 against its plain version on
    whole 256-row chunks and on a 100-row chunk (a prompt shorter than the
    chunk, not a multiple of 64), and ``ssd_chunked_kernel`` with an
    initial state and a ragged length (600 rows: two chunks and an 88-row
    tail) against the plain oracle ``models.ssm.ssd_chunked``. a is scaled
    to 1% of the model's so the decays span exp(0) to about exp(-30) and
    every off-diagonal tile and the carried state count."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.models import ssm

    gen = torch.Generator(device="cuda").manual_seed(7)
    f32 = torch.float32
    errs = {}
    for name, dims in (("ssd_intra_chunk", (2, 3, 2, 256, 64, 128)),
                       ("ssd_intra_chunk_q100", (1, 3, 1, 100, 16, 16))):
        x, a, b, c = ssd_inputs(torch, gen, *dims, f32, a_scale=0.01)
        got, want = ssd.ssd_intra_chunk(x, a, b, c), \
            ssd.ssd_intra_chunk_plain(x, a, b, c)
        errs[name] = max(row_rel_err(got[0], want[0]),
                         row_rel_err(got[1], want[1]))
    bsz, length, h, p, n, chunk = 2, 600, 4, 64, 128, 256
    x, a, b, c = ssd_inputs(torch, gen, bsz, h, 1, length, p, n, f32,
                            a_scale=0.01)
    # (B·H, 1, L, F) -> (B, L, H, F), the scan's layout
    seq = [t.view(bsz, h, length, -1).transpose(1, 2).contiguous()
           for t in (x, b, c)]
    a = a.view(bsz, h, length).transpose(1, 2).contiguous()
    s0 = 0.1 * torch.randn((bsz, h, p, n), generator=gen, device="cuda")
    got = ssd.ssd_chunked_kernel(seq[0], a, seq[1], seq[2], chunk,
                                 initial_state=s0)
    want = ssm.ssd_chunked(seq[0], a, seq[1], seq[2], chunk,
                           initial_state=s0)
    errs["ssd_chunked_kernel_ragged"] = max(row_rel_err(got[0], want[0]),
                                            row_rel_err(got[1], want[1]))
    return errs


def ssd_row(torch, device: dict) -> dict:
    """B8 against its plain version at the main path's shape: the 4 x
    2048 wave of full-width mamba2-130m (96 heads of 8 chunks of 256
    rows, head_dim 64, d_state 128), bf16 x, b, c and fp32 a as the model
    makes them; with its TFLOP/s over the visible pairs, and from the
    device phase its registers, spills and tensor-core instructions."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ssd_scan as ssd

    cfg = get_arch(SSM_ARCH)
    s = cfg.ssm
    n_tok, batch = SSM_WAVES[0]
    heads = s.expand * cfg.d_model // s.head_dim
    nc, q, p, n = n_tok // s.chunk, s.chunk, s.head_dim, s.d_state
    gen = torch.Generator(device="cuda").manual_seed(6)
    x, a, b, c = ssd_inputs(torch, gen, batch, heads, nc, q, p, n,
                            torch.bfloat16)
    kern = lambda: ssd.ssd_intra_chunk(x, a, b, c)  # noqa: E731
    plain = lambda x=x: ssd.ssd_intra_chunk_plain(x, a, b, c)  # noqa: E731
    got, want = kern(), plain()
    # the fault: the last X tile of one cell zeroed
    faulty = plain(drop_x_tile(x, (x.shape[0] // 2, nc - 1), (q - 1) // 64))
    y, st = (held_to_plain(got[i], want[i], faulty[i]) for i in (0, 1))
    cells = batch * heads * nc
    pairs = q * (q + 1) // 2            # visible (row, column) pairs a cell
    flops = 2.0 * cells * (pairs * (n + p) + q * n * p)
    # bf16 x, b, c and fp32 a read once; fp32 y and states written once
    nbytes = cells * (q * (2 * p + 2 * 2 * n + 4 + 4 * p) + 4 * n * p)
    bms, by = bound(flops, nbytes)
    ms = cuda_ms(torch, kern, 20)
    dev = device_times(torch, kern, None, 20)
    return {
        "name": "ssd_intra_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:28", "launches": 0,
        "max_abs_err": max(y["max_abs_err"], st["max_abs_err"]),
        "row_rel_err": max(y["row_rel_err"], st["row_rel_err"]),
        "fault_row_rel_err": min(y["fault_row_rel_err"],
                                 st["fault_row_rel_err"]),
        "y": y, "states": st,
        "ms": ms, "plain_ms": cuda_ms(torch, plain, 2),
        "bound_ms": bms, "bound_by": by, "library_ms": None, **dev,
        "tflops": flops / ms / 1e9,
        "device_tflops": (flops / dev["device_ms"] / 1e9
                          if dev["device_ms"] else None),
        "ptxas": device["ptxas"]["ssd_scan"],
        "tensor_core_instructions": device["tensor_core_instructions"][
            "ssd_scan"],
        "shape": {"cells": cells, "bh": batch * heads, "nc": nc, "q": q,
                  "p": p, "n": n, "dtype": "bf16", "flops": flops,
                  "bytes": nbytes},
    }


def phase_ssm_wave(torch) -> dict:
    """Full-width mamba2-130m (bf16, random weights from seed 0) served by
    the wave ``ServingEngine`` in three waves: 4 x 2048, 1 x 32768 (the
    repo's prefill_32k length) and 4 x 1000 (ragged: three chunks and a
    232-row tail, padded to a whole chunk). Each wave's prefill launches
    B8 once a layer; decode runs the one-token recurrence in PyTorch.
    On each wave's first prompt, gate 1 (``b8_gate``) holds every B8 call
    of the kernel route's prefill to the plain version on the same inputs
    and gate 2 (``ssd_layer_gate``) each SSD layer, fed the plain route's
    input, to the plain route, each beside a planted zeroed X tile that
    it must reject; the first-token logits of both routes are recorded,
    not gated (ROADMAP C8), and must be finite. At 2 layers in fp32 the
    kernel route serves two waves with the plain route's tokens."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    full = full_width_model(torch, SSM_ARCH)
    model, params = full["model"], full["params"]
    n_params, init_s = full["n_params"], full["init_s"]
    cfg = model.cfg
    layers = cfg.num_layers
    engines = {b: ServingEngine(model, params, max_len=SSM_MAX_LEN,
                                batch_size=b, device="cuda")
               for _, b in SSM_WAVES}
    rng = np.random.default_rng(5)

    def prompts(n: int, b: int) -> list:
        return [rng.integers(3, cfg.vocab_size, size=(n,)).astype(np.int32)
                for _ in range(b)]

    # warm-up: cuBLAS handles, B8's first load, a padded tail
    engines[4].serve(make_requests(prompts(300, 4), 2))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    waves, wave_prompts = [], []
    for n, b in SSM_WAVES:
        eng = engines[b]
        wave_prompts.append(prompts(n, b))
        reqs = make_requests(wave_prompts[-1], SSM_NEW_TOKENS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        before = ops.launch_counts()["ssd_intra_chunk"]
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = ops.launch_counts()["ssd_intra_chunk"] - before
        check_served(eng, reqs, out, SSM_NEW_TOKENS, cfg.vocab_size)
        require(launched == layers,
                f"wave {b} x {n}: {launched} B8 launches, not {layers}")
        stamps = eng.token_walltimes
        step = eng.metrics.histogram("engine.step_s.wave_decode").summary()
        tokens = sum(len(out[r.rid]) for r in reqs)
        waves.append({
            "prompt_len": n, "batch": b, "chunks": -(-n // cfg.ssm.chunk),
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": max(stamps[r.rid][0] - eng.serve_t0 for r in reqs),
            "decode_step_s": {"count": step["count"], "mean": step["mean"],
                              "p50": step["p50"]},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "resident_before_bytes": resident,
            "ssd_intra_chunk_launches": launched,
        })
    counts = ops.launch_counts()

    # per wave, on its first prompt: gate 1 (every B8 call of the kernel
    # route's prefill against the plain version on its inputs) and gate 2
    # (each SSD layer, fed the plain route's input, kernel route against
    # plain route), each with its planted fault; the first-token logits
    # of the two prefills are recorded only (C8)
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    b8_gates, layer_gates, logits_check = [], [], []
    for (n, _), ps in zip(SSM_WAVES, wave_prompts):
        prompt = torch.from_numpy(ps[0][None].astype(np.int64)).to("cuda")
        got, gate = b8_gate(model, params, prompt)
        b8_gates.append({"prompt_len": n, **gate})
        want, gate = ssd_layer_gate(model, plain_model, params, prompt)
        layer_gates.append({"prompt_len": n, **gate})
        got, want = got.float(), want.float()
        scale = float(want.abs().max())
        logits_check.append({
            "prompt_len": n, "finite": bool(torch.isfinite(got).all()),
            "max_abs_err": max_err(got, want), "max_abs_logit": scale,
            "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all()),
            "gate": False,
        })
    roofline_probe(torch, SSM_ARCH, model, params, torch.from_numpy(
        np.stack(wave_prompts[0]).astype(np.int64)).cuda())
    del full, params, engines

    # fp32, FP32_LAYERS layers: the kernel route's tokens are the plain
    # route's
    cfg32, m32, p32 = fp32_model(torch, cfg)
    plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain"))
    parity = []
    for i in SSM_PARITY_WAVES:
        n, b = SSM_WAVES[i]
        outs = [ServingEngine(m, p32, max_len=SSM_MAX_LEN, batch_size=b,
                              device="cuda").serve(
                    make_requests(wave_prompts[i], SSM_NEW_TOKENS))
                for m in (m32, plain32)]
        parity.append({"prompt_len": n, "batch": b,
                       "mismatched_rids": [rid for rid in outs[1] if not
                                           np.array_equal(outs[0][rid],
                                                          outs[1][rid])],
                       "distinct_tokens": len({int(t) for v in
                                               outs[0].values()
                                               for t in v})})
    report = {
        "phase": "ssm_wave", "arch": SSM_ARCH, "params": n_params,
        "init_s": init_s, "layers": layers, "dtype": "bf16",
        "new_tokens": SSM_NEW_TOKENS, "waves": waves, "launches": counts,
        "b8_on_model_inputs": b8_gates,
        "ssd_layers_teacher_forced": layer_gates,
        "prefill_vs_plain": logits_check,
        "prefill_vs_plain_not_a_gate": (
            "ROADMAP C8: B8's output times 1 + 1e-7 moves these bf16 "
            "logits by up to 62% of the limit, so they cannot tell a "
            "right B8 from a wrong one; only their finiteness is gated"),
        "fp32_parity": parity,
    }
    emit(report)
    for check in logits_check:
        require(check["finite"],
                f"ssm prefill {check['prompt_len']}: logits not finite")
    for gate in b8_gates:
        require(gate["calls"] == layers,
                f"ssm {gate['prompt_len']}: {gate['calls']} B8 calls held "
                f"to plain, not {layers}")
    for gate in b8_gates + layer_gates:
        require(gate["row_rel_err"] <= gate["limit"] <
                gate["fault_row_rel_err"],
                f"ssm {gate['prompt_len']}: gate {gate}")
    for gate in layer_gates:
        require(gate["layers"] == layers,
                f"ssm {gate['prompt_len']}: {gate['layers']} layers held "
                f"to plain, not {layers}")
    for check in parity:
        require(not check["mismatched_rids"],
                f"fp32 ssm {check['prompt_len']}: kernel tokens differ from "
                f"plain for rids {check['mismatched_rids']}")
    return report


def flash_plain(q, k, v, *, causal: bool = True, window=None, **_):
    """B3's plain version (``flash_attention_plain``) on the layout
    ``ops.attention`` gives the kernel: q (B, Hq, Nq, E), k and v (B, Hkv,
    Nkv, E) flattened, Q rows padded to the block ``ops.resolve_method``
    takes, KV rows to the tile under kv_len. It computes a tile only for
    the Q blocks that run it, so a long windowed call costs the window's
    work where the dense oracle would hold the whole score matrix (at 1 x
    32768 and 16 heads, 68.7 GB in fp32). Takes ``models.attention.
    attention``'s keywords."""
    import torch

    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops

    b, hq, nq, e = q.shape
    _, hkv, nkv, _ = k.shape
    _, bq = ops.resolve_method(nq, nkv, e, q.element_size(), window=window)

    def padded(x, rows, multiple):
        flat = x.reshape(-1, rows, e)
        return torch.nn.functional.pad(flat, (0, 0, 0, (-rows) % multiple))

    kf, vf = padded(k, nkv, KV_TILE), padded(v, nkv, KV_TILE)
    out = fl.flash_attention_plain(
        padded(q, nq, bq), kf, vf, blk_q=bq, blk_kv=KV_TILE, causal=causal,
        window=window, kv_len=nkv if kf.shape[1] != nkv else None)
    return out[:, :nq].reshape(b, hq, nq, e)


def kernel_report(device: dict, lib: str, marker: str) -> dict:
    """Registers, spills and tensor-core instructions of the kernels of
    ``lib`` whose names hold ``marker``, from the device phase."""
    return {"ptxas": {k: v for k, v in device["ptxas"][lib].items()
                      if marker in k},
            "tensor_core_instructions": {
                k: v for k, v in device["tensor_core_instructions"][lib]
                .items() if marker in k}}


def hybrid_rows(torch, rnd, device: dict) -> list[dict]:
    """B3 and B4 at head dim 256 against their plain versions at the
    hybrid wave's shapes (recurrentgemma-9b: 16 query heads on one kv
    head): B3 on the 1 x 8000 prompt under the 2048-token window (whole
    tiles outside it skipped), B4 on 4 sequences over a full ring of 2048
    rows, bf16 and int8 (per-row scales). Faults: a V tile zeroed, or its
    V scales. Yardsticks: SDPA with the window's boolean mask, and SDPA on
    the ring's rows (int8 dequantized first)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops

    cfg = get_arch(HYBRID_ARCH)
    hq, hkv, e, window = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.window
    grp = hq // hkv
    rows = []
    n = HYBRID_WAVES[1][0]
    q, k, v = rnd(hq, n, e), rnd(hkv, n, e), rnd(hkv, n, e)
    kind, bq = ops.resolve_method(n, n, e, 2, window=window)
    require((kind, bq) == ("flash", 64), f"policy routes {n} to {kind}")
    kern = lambda: fl.flash_attention_flat(  # noqa: E731
        q, k, v, blk_q=bq, causal=True, window=window)

    def plain(v=v):
        return fl.flash_attention_plain(q, k, v, blk_q=bq, blk_kv=KV_TILE,
                                        causal=True, window=window)

    # the fault: the second-last KV tile skipped, seen by the last rows
    check = held_to_plain(kern(), plain(), plain(drop_v_tile(v, n // 64 - 2)))
    pos = torch.arange(n, device="cuda")
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    lib = library_call(torch, q.view(1, hq, n, e), k.view(1, hkv, n, e),
                       v.view(1, hkv, n, e), causal=False, mask=mask)
    pairs = sum(min(i + 1, window) for i in range(n))   # visible pairs a head
    flops = 4.0 * e * pairs * hq
    nbytes = 2.0 * (2 * hq * n * e + 2 * hkv * n * e)
    bms, by = bound(flops, nbytes)
    ms = cuda_ms(torch, kern, 20)
    rows.append({
        "name": "flash_e256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": 0, **check, "ms": ms, "plain_ms": cuda_ms(torch, plain, 2),
        "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(torch, lib, 20),
        **device_times(torch, kern, lib, 20), "tflops": flops / ms / 1e9,
        **kernel_report(device, "flash_attention", "<256>"),
        "shape": {"b": 1, "hq": hq, "hkv": hkv, "n": n, "e": e, "blk_q": bq,
                  "window": window, "causal": True, "dtype": "bf16",
                  "visible_pairs_a_head": pairs},
    })

    rows.append(halo_row(torch, rnd, cfg))
    b, c = HYBRID_WAVES[0][1], window
    for quantized in (False, True):
        dims = -1 if quantized else None
        qd = rnd(b, hq, e)
        kc, ks = quantized_rows(rnd(b, hkv, c, e), dims)
        vc, vs = quantized_rows(rnd(b, hkv, c, e), dims)
        sc = dict(k_scale=ks, v_scale=vs)
        n_split, tps = dec.decode_split_plan(qd.dtype, b * hkv, c)
        lens = torch.full((b * hkv,), c, dtype=torch.int32, device="cuda")

        def kern(qd=qd, kc=kc, vc=vc, sc=sc):
            return ops.decode_attention(qd, kc, vc, c, **sc)

        def plain(vc=vc, vs=vs, qd=qd, kc=kc, ks=ks):
            flat = {key: None if t is None else t.view(b * hkv, c)
                    for key, t in (("k_scale", ks), ("v_scale", vs))}
            return dec.decode_attention_plain(
                qd.view(b * hkv, grp, e), kc.view(b * hkv, c, e),
                vc.view(b * hkv, c, e), lens, n_split=n_split,
                tiles_per_split=tps, **flat).view(b, hq, e)

        tile = c // KV_TILE - 2
        faulty = (plain(vs=drop_scale_tile(vs, tile)) if quantized
                  else plain(vc=drop_v_tile(vc, tile)))
        check = held_to_plain(kern(), plain(), faulty)
        lib = library_call(torch, qd.view(b, hq, 1, e), kc, vc, causal=False,
                           k_scale=ks, v_scale=vs)
        flops = 4.0 * e * hq * b * c
        row_bytes = (e + 4) if quantized else 2 * e
        nbytes = 2.0 * hkv * b * c * row_bytes + 2.0 * 2 * b * hq * e
        bms, by = bound(flops, nbytes)
        name = "decode_e256_int8" if quantized else "decode_e256"
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": ("src/repro/kernels/decode_attention.py:"
                         + ("59" if quantized else "32")),
            "launches": 0, **check, "ms": cuda_ms(torch, kern, 50),
            "plain_ms": cuda_ms(torch, plain, 3), "bound_ms": bms,
            "bound_by": by, "library_ms": cuda_ms(torch, lib, 50),
            **device_times(torch, kern, lib, 50),
            **kernel_report(device, "decode_attention", "<256"),
            "shape": {"b": b, "hq": hq, "hkv": hkv, "ring": c, "kv_len": c,
                      "e": e, "n_split": n_split, "tiles_per_split": tps,
                      "dtype": "bf16",
                      "cache": "int8" if quantized else "bf16"},
        })
    return rows


def halo_row(torch, rnd, cfg) -> dict:
    """B3 at head dim 256 as a rank of the split hybrid calls it
    (``transformer._seq_window``): HALO_ROWS Q rows of one sequence at
    ``q_offset`` = the window's halo of W - 1 rows, over (halo + rows)
    keys, K/V padded to the 64-row tile under kv_len, causal under the
    window. Fault: a V tile zeroed. Yardstick: SDPA with the window's
    boolean mask."""
    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import flash_attention as fl
    from repro_torch.kernels import ops

    hq, hkv, e, window = cfg.num_heads, cfg.num_kv_heads, cfg.hd, cfg.window
    n, h = HALO_ROWS, window - 1
    nkv = h + n
    pad = (-nkv) % KV_TILE
    q = rnd(hq, n, e)
    k, v = (torch.nn.functional.pad(rnd(hkv, nkv, e), (0, 0, 0, pad))
            for _ in range(2))
    kind, bq = ops.resolve_method(n, nkv, e, 2, window=window)
    require((kind, bq) == ("flash", 64), f"policy routes the halo to {kind}")
    kw = dict(blk_q=bq, causal=True, window=window, q_offset=h, kv_len=nkv)
    kern = lambda: fl.flash_attention_flat(q, k, v, **kw)  # noqa: E731

    def plain(v=v):
        return fl.flash_attention_plain(q, k, v, blk_kv=KV_TILE, **kw)

    # the fault: the second-last real KV tile skipped, seen by the last rows
    check = held_to_plain(kern(), plain(),
                          plain(drop_v_tile(v, nkv // KV_TILE - 1)))
    rows_at = h + torch.arange(n, device="cuda")
    cols = torch.arange(nkv, device="cuda")
    mask = (cols[None, :] <= rows_at[:, None]) & (
        cols[None, :] > rows_at[:, None] - window)
    lib = library_call(torch, q.view(1, hq, n, e),
                       k[:, :nkv].reshape(1, hkv, nkv, e),
                       v[:, :nkv].reshape(1, hkv, nkv, e), causal=False,
                       mask=mask)
    pairs = int(mask.sum())                 # visible pairs a head
    flops = 4.0 * e * pairs * hq
    nbytes = 2.0 * (2 * hq * n * e + 2 * hkv * nkv * e)
    bms, by = bound(flops, nbytes)
    ms = cuda_ms(torch, kern, 20)
    return {
        "name": "flash_e256_halo", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:25",
        "launches": 0, **check, "ms": ms, "plain_ms": cuda_ms(torch, plain, 2),
        "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(torch, lib, 20),
        **device_times(torch, kern, lib, 20), "tflops": flops / ms / 1e9,
        "shape": {"b": 1, "hq": hq, "hkv": hkv, "n": n, "halo": h,
                  "q_offset": h, "kv_len": nkv, "e": e, "blk_q": bq,
                  "window": window, "causal": True, "dtype": "bf16",
                  "visible_pairs_a_head": pairs},
    }


def ring_slot_written(torch, model, params, prompt, kv_dtype=None) -> int:
    """The ring slot the first decode step of ``prompt`` (1, L) writes in
    the first attention layer's cache: the one row whose K changed."""
    cfg = model.cfg
    _, cache = model.prefill(params, cfg, prompt, HYBRID_MAX_LEN,
                             kv_dtype=kv_dtype)
    layer = cfg.layer_kinds.index("attn")
    before = cache["layers"][layer]["k"].clone()
    tok = torch.ones((1, 1), dtype=torch.long, device="cuda")
    model.decode_step(params, cfg, tok, cache, prompt.shape[1])
    changed = (cache["layers"][layer]["k"] != before).any(-1)  # (B, Hkv, C)
    slots = torch.nonzero(changed[0, 0]).view(-1).tolist()
    require(len(slots) == 1, f"the first decode step changed slots {slots}")
    return slots[0]


def phase_hybrid_wave(torch) -> dict:
    """Full-width, full-depth recurrentgemma-9b (bf16, random weights from
    seed 0; 26 RG-LRU and 12 local-attention layers, 16 query heads and
    one kv head of 256, window 2048) served by the wave ``ServingEngine``
    in waves of 4 x 2048, 1 x 8000 and 1 x 32768 and the 4 x 2048 wave
    again on int8 caches, 16 new tokens each: each prefill launches B3's
    head-dim-256 form once an attention layer, each decode step B4's.
    Per wave: TTFT, the decode step's wall, peak memory, and the ring
    slot the first decode row lands in (read back from the cache). On
    each wave's first prompt every B3 call of the prefill and B4 call of
    a decode step held to its plain version on the same inputs (rows
    within BF16_ROW_RTOL, beside a zeroed V tile; B3 against
    ``flash_plain``, which tiles and skips outside the window); the
    first-token logits of the 4 x 2048 and 1 x 8000 waves held to the
    plain route's within LOGITS_RTOL of the largest, and the int8 cache's
    first decode logits within INT8_LOGITS_RTOL of the bf16 cache's; at
    full width and HYBRID_FP32_LAYERS layers in fp32 the kernel route
    serves the 4 x 2048 wave with the plain route's tokens."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine

    full = full_width_model(torch, HYBRID_ARCH)
    model, params = full["model"], full["params"]
    cfg = model.cfg
    attn_layers = cfg.layer_kinds.count("attn")
    c = min(HYBRID_MAX_LEN, cfg.window)
    engines = {(b, kv): ServingEngine(model, params, max_len=HYBRID_MAX_LEN,
                                      batch_size=b, kv_dtype=kv,
                                      device="cuda")
               for b, kv in {(b, None) for _, b in HYBRID_WAVES}
               | {(HYBRID_WAVES[0][1], "int8")}}
    rng = np.random.default_rng(7)
    wave_prompts = [[rng.integers(3, cfg.vocab_size, size=(n,))
                     .astype(np.int32) for _ in range(b)]
                    for n, b in HYBRID_WAVES]
    # warm-up: cuBLAS handles and the kernels' first loads
    for (b, _), eng in engines.items():
        eng.serve(make_requests([p[:300] for p in wave_prompts[0][:1]] * b,
                                2))
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    waves = []
    runs = [(n, b, None, ps) for (n, b), ps in zip(HYBRID_WAVES,
                                                   wave_prompts)]
    runs.append((*HYBRID_WAVES[0], "int8", wave_prompts[0]))
    served = {}
    for n, b, kv, ps in runs:
        eng = engines[(b, kv)]
        reqs = make_requests(ps, HYBRID_NEW_TOKENS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = ops.launch_counts()
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        launched = {k: after[k] - before[k] for k in after
                    if after[k] > before[k]}
        check_served(eng, reqs, out, HYBRID_NEW_TOKENS, cfg.vocab_size)
        decode_key = "decode_e256_int8" if kv else "decode_e256"
        require(launched == {"flash_e256": attn_layers,
                             decode_key: attn_layers
                             * (HYBRID_NEW_TOKENS - 1)},
                f"hybrid wave {b} x {n} {kv}: launches {launched}")
        served[(n, kv)] = out
        stamps = eng.token_walltimes
        step = eng.metrics.histogram("engine.step_s.wave_decode").summary()
        tokens = sum(len(out[r.rid]) for r in reqs)
        waves.append({
            "prompt_len": n, "batch": b, "kv_dtype": kv or "bf16",
            "tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": max(stamps[r.rid][0] - eng.serve_t0 for r in reqs),
            "decode_step_s": {"count": step["count"], "mean": step["mean"],
                              "p50": step["p50"]},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "ring_slots": c, "rolled_by": n % c if n >= c else 0,
            "launches": launched,
        })
    counts = ops.launch_counts()
    int8_n = HYBRID_WAVES[0][0]
    agree = agreement(served[(int8_n, "int8")], served[(int8_n, None)])
    del engines

    # per wave, on its first prompt: the ring slot of the first decode
    # row, every B3 call of the prefill and B4 call of a decode step held
    # to its plain version, and (two waves) the first-token logits
    # against the plain route
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    gates, logits_check = [], []
    for i, ((n, _), ps) in enumerate(zip(HYBRID_WAVES, wave_prompts)):
        prompt = torch.from_numpy(ps[0][None].astype(np.int64)).cuda()
        slot = ring_slot_written(torch, model, params, prompt)
        require(slot == n % c, f"hybrid {n}: the first decode row landed in "
                               f"slot {slot}, not {n % c}")
        (got, cache), gate = attention_gate(
            lambda: model.prefill(params, cfg, prompt, HYBRID_MAX_LEN),
            plain_fns={"attention": flash_plain})
        tok = got[:, -1].argmax(-1, keepdim=True)
        _, dgate = attention_gate(
            lambda: model.decode_step(params, cfg, tok, cache, n))
        del cache
        require(gate["kernels"] == {"flash_e256": attn_layers},
                f"hybrid prefill {n}: {gate['kernels']}")
        require(dgate["kernels"] == {"decode_e256": attn_layers},
                f"hybrid decode {n}: {dgate['kernels']}")
        entry = {"prompt_len": n, "first_decode_slot": slot,
                 "prefill": gate, "decode": dgate}
        if i == 0:      # the int8 ring's decode step, and its logits
            _, cache8 = model.prefill(params, cfg, prompt, HYBRID_MAX_LEN,
                                      kv_dtype="int8")
            got8, gate8 = attention_gate(
                lambda: model.decode_step(params, cfg, tok, cache8, n)[0])
            require(gate8["kernels"] == {"decode_e256_int8": attn_layers},
                    f"hybrid int8 decode {n}: {gate8['kernels']}")
            _, cache = model.prefill(params, cfg, prompt, HYBRID_MAX_LEN)
            want8, _ = model.decode_step(params, cfg, tok, cache, n)
            del cache, cache8
            scale = float(want8.float().abs().max())
            err = max_err(got8, want8)
            entry["int8_decode"] = gate8
            entry["int8_vs_bf16_decode_logits"] = {
                "max_abs_err": err, "max_abs_logit": scale,
                "tol": INT8_LOGITS_RTOL * max(1.0, scale)}
            require(err <= INT8_LOGITS_RTOL * max(1.0, scale),
                    f"hybrid int8 decode logits: {err} vs bf16")
        gates.append(entry)
        if i in HYBRID_LOGIT_WAVES:
            want, _ = plain_model.prefill(params, plain_model.cfg, prompt, n)
            check = {"prompt_len": n, **prefill_vs_plain(got, want)}
            logits_check.append(check)
            require(check["finite"] and check["max_abs_err"] <= check["tol"],
                    f"hybrid prefill {n} logits: {check}")
        else:
            require(bool(got.isfinite().all()),
                    f"hybrid prefill {n}: logits not finite")
    roofline_probe(torch, HYBRID_ARCH, model, params, torch.from_numpy(
        np.stack(wave_prompts[0]).astype(np.int64)).cuda())
    init_s, n_params = full["init_s"], full["n_params"]
    del full, params, model, plain_model
    torch.cuda.empty_cache()

    # fp32, one unit and the tail: the kernel route's tokens are the plain
    # route's on the 4 x 2048 wave
    cfg32, m32, p32 = fp32_model(torch, cfg, HYBRID_FP32_LAYERS)
    plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain"))
    n, b = HYBRID_WAVES[0]
    outs = [ServingEngine(m, p32, max_len=HYBRID_MAX_LEN, batch_size=b,
                          device="cuda").serve(
                make_requests(wave_prompts[0], HYBRID_NEW_TOKENS))
            for m in (m32, plain32)]
    parity = {"layers": HYBRID_FP32_LAYERS, "kinds": list(cfg32.layer_kinds),
              "prompt_len": n, "batch": b,
              "mismatched_rids": [rid for rid in outs[1] if not
                                  np.array_equal(outs[0][rid], outs[1][rid])],
              "distinct_tokens": len({int(t) for v in outs[0].values()
                                      for t in v})}
    del m32, p32, plain32
    torch.cuda.empty_cache()
    report = {
        "phase": "hybrid_wave", "arch": HYBRID_ARCH, "params": n_params,
        "init_s": init_s, "layers": cfg.num_layers,
        "rec_layers": cfg.layer_kinds.count("rec"),
        "attn_layers": attn_layers, "window": cfg.window, "dtype": "bf16",
        "new_tokens": HYBRID_NEW_TOKENS, "max_len": HYBRID_MAX_LEN,
        "waves": waves, "launches": counts,
        "int8_tokens_agreeing_with_bf16": agree,
        "attention_gates": gates, "prefill_vs_plain": logits_check,
        "fp32_parity": parity,
    }
    emit(report)
    require(not parity["mismatched_rids"],
            f"fp32 hybrid: kernel tokens differ from plain for rids "
            f"{parity['mismatched_rids']}")
    return report


def phase_main_path(torch, full: dict) -> dict:
    """Full-width internlm2-1.8b served in three waves on the card."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request, RequestState

    model, params = full["model"], full["params"]
    cfg = model.cfg
    engines = {b: ServingEngine(model, params, max_len=MAX_LEN, batch_size=b,
                                device="cuda") for b in {BATCH, 1}}
    rng = np.random.default_rng(0)

    def requests(n: int, b: int, rid0: int) -> list:
        return [Request(rid=rid0 + i,
                        prompt=rng.integers(3, cfg.vocab_size, size=(n,))
                        .astype(np.int32),
                        max_new_tokens=NEW_TOKENS, eos_id=-1)
                for i in range(b)]

    # warm-up: cuBLAS handles and the kernels' first loads, then reset
    engines[BATCH].serve(requests(32, BATCH, 1000))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    waves = []
    for i, (method, n, b) in enumerate(WAVES):
        reqs = requests(n, b, 100 * i)
        eng = engines[b]
        before = ops.launch_counts()
        t_wave = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_wave
        after = ops.launch_counts()
        stamps = eng.token_walltimes
        ttft = [stamps[r.rid][0] - eng.serve_t0 for r in reqs]
        tokens = sum(len(out[r.rid]) for r in reqs)
        for r in reqs:
            toks = out[r.rid]
            require(len(toks) == NEW_TOKENS,
                    f"rid {r.rid}: {len(toks)} tokens")
            require(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
                    f"rid {r.rid}: token out of range")
            require(eng.results[r.rid].state is RequestState.FINISHED,
                    f"rid {r.rid}: {eng.results[r.rid].state}")
        if i == INT8_WAVE:        # served again on an int8 cache
            full["int8_wave"] = ([r.prompt for r in reqs], out)
        waves.append({
            "route": method, "prompt_len": n, "batch": b, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": max(ttft),
            "launches": {k: after[k] - before[k] for k in after},
        })
        require(after[method] > before[method],
                f"wave {n}: the {method} kernel was not launched")
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name in WAVE_KERNELS:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the wave path")

    # prefill logits: kernel path vs plain attention, one request a wave
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    logits_check = []
    for method, n, _ in WAVES:
        prompt = torch.from_numpy(
            rng.integers(3, cfg.vocab_size, size=(1, n))).to("cuda")
        got, _ = model.prefill(params, cfg, prompt, n)
        want, _ = plain_model.prefill(params, plain_model.cfg, prompt, n)
        got, want = got.float(), want.float()
        require(bool(torch.isfinite(got).all()),
                f"{method}: logits not finite")
        scale = float(want.abs().max())
        err = max_err(got, want)
        logits_check.append({
            "route": method, "prompt_len": n, "max_abs_err": err,
            "max_abs_logit": scale, "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all()),
        })
        require(err <= LOGITS_RTOL * max(1.0, scale),
                f"{method} prefill logits: {err} vs plain")
    _, n, b = WAVES[INT8_WAVE]                   # the 4 x 2048 wave
    roofline_probe(torch, ARCH, model, params, torch.from_numpy(
        rng.integers(3, cfg.vocab_size, size=(b, n))).to("cuda"))
    report = {
        "phase": "main_path", "arch": ARCH, "params": full["n_params"],
        "layers": cfg.num_layers, "dtype": "bf16", "init_s": full["init_s"],
        "max_len": MAX_LEN, "new_tokens": NEW_TOKENS, "waves": waves,
        "launches": counts, "peak_mem_bytes": peak,
        "prefill_vs_plain": logits_check,
    }
    emit(report)
    return report


def phase_int8_wave(torch, full: dict) -> dict:
    """The 4 x 2048 wave served again with ``kv_dtype="int8"``: prefill
    quantizes each prompt row, decode reads the cache through B4's int8
    branch. Token agreement with the bf16 wave is reported, not limited:
    int8 keys and values round away from bf16's, and greedy argmax may
    part at a near tie."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request, RequestState

    prompts, bf16_out = full["int8_wave"]
    _, n, b = WAVES[INT8_WAVE]
    eng = ServingEngine(full["model"], full["params"], max_len=MAX_LEN,
                        batch_size=b, kv_dtype="int8", device="cuda")
    reqs = [Request(rid=100 * INT8_WAVE + i, prompt=p,
                    max_new_tokens=NEW_TOKENS, eos_id=-1)
            for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for r in reqs:
        require(eng.results[r.rid].state is RequestState.FINISHED
                and len(out[r.rid]) == NEW_TOKENS, f"int8 rid {r.rid}")
    for name in PATH_KERNELS["int8_wave"]:
        require(counts[name] > 0, f"kernel {name} not launched on the int8 "
                                  f"wave")
    require(counts["decode"] == 0, "the int8 wave ran the bf16 decode")
    stamps = eng.token_walltimes
    tokens = sum(len(out[r.rid]) for r in reqs)
    agree = sum(int((out[r.rid] == bf16_out[r.rid]).sum()) for r in reqs)
    report = {
        "phase": "int8_wave", "prompt_len": n, "batch": b,
        "kv_dtype": "int8", "tokens": tokens, "wall_s": wall,
        "tokens_per_s": tokens / wall,
        "ttft_s": max(stamps[r.rid][0] - eng.serve_t0 for r in reqs),
        "tokens_agreeing_with_bf16": agree / tokens,
        "first_tokens_agreeing": sum(int(out[r.rid][0] == bf16_out[r.rid][0])
                                     for r in reqs) / len(reqs),
        "peak_mem_bytes": peak, "launches": counts,
    }
    emit(report)
    return report


def make_requests(prompts, new: int) -> list:
    from repro_torch.serving import Request

    return [Request(rid=i, prompt=p, max_new_tokens=new, eos_id=-1)
            for i, p in enumerate(prompts)]


def check_served(eng, reqs, out, new: int, vocab: int) -> None:
    """Every request finished with ``new`` tokens in the vocabulary."""
    from repro_torch.serving import RequestState

    for r in reqs:
        toks = out[r.rid]
        require(eng.results[r.rid].state is RequestState.FINISHED,
                f"rid {r.rid}: {eng.results[r.rid].state}")
        require(len(toks) == new, f"rid {r.rid}: {len(toks)} tokens")
        require(bool(((toks >= 0) & (toks < vocab)).all()),
                f"rid {r.rid}: token out of range")


def fp32_model(torch, cfg, layers: int = FP32_LAYERS, **overrides):
    """Full width, ``layers`` layers (and ``overrides`` of other fields),
    fp32, random weights from seed 0 with norm scales (an SSD block's gate
    norm, an encoder's layers and final norm too) from N(0, 4), so that
    greedy tokens vary."""
    from repro_torch.models.api import build_model

    cfg32 = dataclasses.replace(cfg, num_layers=layers,
                                compute_dtype=torch.float32, **overrides)
    m32 = build_model(cfg32)
    p32 = m32.init(seed=0, device="cuda", dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    stack = p32["layers"] + p32.get("encoder", [])
    for blk in [p32] + [b for layer in stack for b in layer.values()]:
        for key in ("norm", "final_norm", "gate_norm", "enc_final_norm"):
            if key in blk:
                blk[key] = 2.0 * torch.randn(blk[key].shape, generator=gen,
                                             device="cuda")
    return cfg32, m32, p32


def spec_prompts(vocab: int, lens, seed: int) -> list:
    """Prompts that repeat one random SPEC_SPAN-token span to ``lens``:
    text that quotes its own context, where the drafter finds matches."""
    import numpy as np

    rng = np.random.default_rng(seed)
    span = rng.integers(3, vocab, size=(SPEC_SPAN,))
    return [np.resize(span, int(n)).astype(np.int32) for n in lens]


def serve_path(torch, eng, reqs, path: str):
    """Serve ``reqs`` with every launch count set to 0 just before and
    read just after; fail unless the path's kernels were launched.
    Returns (out, wall seconds, counts, peak device memory)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name in PATH_KERNELS[path]:
        require(counts[name] > 0, f"kernel {name} not launched on the "
                                  f"{path} path")
    return out, wall, counts, torch.cuda.max_memory_allocated()


def serve_summary(eng, reqs, out, wall: float) -> dict:
    import numpy as np

    stamps = eng.token_walltimes
    tokens = sum(len(out[r.rid]) for r in reqs)
    steps = {}
    for kind in ("decode", "chunk", "chunk+decode", "verify"):
        h = eng.metrics.histogram(f"engine.step_s.{kind}").summary()
        if h["count"]:
            steps[kind] = {"count": h["count"], "mean_s": h["mean"],
                           "p50_s": h["p50"], "p95_s": h["p95"]}
    return {
        "wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
        "ttft_s": percentiles([stamps[r.rid][0] - eng.serve_t0
                               for r in reqs]),
        "itl_s": percentiles([g for r in reqs
                              for g in np.diff(stamps[r.rid])]),
        "steps": steps,
    }


def agreement(out, ref) -> float:
    """Share of tokens equal, position by position, to ``ref``'s."""
    same = sum(int((out[rid] == ref[rid]).sum()) for rid in ref)
    return same / sum(len(ref[rid]) for rid in ref)


def phase_int8_continuous(torch, full: dict) -> dict:
    """The continuous phase's 16 requests on int8 pools (B5 and B6 through
    their int8 branches), against the bf16 serve, then a faulted rerun."""
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        PoolAuditor,
        RequestState,
        ScriptedFaults,
    )

    model, params = full["model"], full["params"]
    cfg = model.cfg
    prompts, bf16_out = full["continuous"]
    eng = ContinuousBatchingEngine(model, params, device="cuda",
                                   kv_dtype="int8", **CONT)
    reqs = make_requests(prompts, CONT_NEW_TOKENS)
    out, wall, counts, peak = serve_path(torch, eng, reqs, "int8_continuous")
    check_served(eng, reqs, out, CONT_NEW_TOKENS, cfg.vocab_size)
    full.setdefault("one_card", {})["int8_continuous"] = one_card_record(
        eng, prompts, out, wall)
    for name in ("paged_prefill", "paged_decode"):
        require(counts[name] == 0, f"int8 pools ran the bf16 {name}")
    bf16_eng = ContinuousBatchingEngine(model, params, device="cuda", **CONT)

    # first-token logits of two requests: int8 pools against bf16 pools,
    # the same chunked prefill
    page, chunk = CONT["page_size"], CONT["chunk_size"]
    logits_check = []
    for rid in (0, 1):
        p = prompts[rid]
        n = len(p)
        n_pg = -(-n // page)
        table = torch.arange(1, n_pg + 1, dtype=torch.int32, device="cuda")
        got = {}
        for kv_dtype in (None, "int8"):
            cache = model.make_cache(1, n, device="cuda", cache_layout="paged",
                                     page_size=page, kv_dtype=kv_dtype)
            for q0 in range(0, n, chunk):
                clen = min(chunk, n - q0)
                toks = torch.ones((1, chunk), dtype=torch.long, device="cuda")
                toks[0, :clen] = torch.from_numpy(p[q0:q0 + clen]).cuda()
                cpages = torch.tensor(
                    [j + 1 if j < n_pg else 0
                     for j in range(q0 // page, (q0 + chunk) // page)],
                    dtype=torch.int32, device="cuda")
                logits, cache = model.prefill_chunk(
                    params, cfg, toks, cache, table, cpages,
                    chunk_span(torch, q0, clen))
            got[kv_dtype] = logits.float()
            del cache
        want, q8 = got[None], got["int8"]
        require(bool(torch.isfinite(q8).all()), f"rid {rid}: int8 logits")
        scale = float(want.abs().max())
        err = max_err(q8, want)
        logits_check.append({
            "rid": rid, "prompt_len": n, "max_abs_err": err,
            "max_abs_logit": scale, "tol": INT8_LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(q8.argmax(-1).eq(want.argmax(-1)).all()),
            "engine_first_token_equal": int(q8.argmax()) == int(out[rid][0]),
        })
        require(err <= INT8_LOGITS_RTOL * max(1.0, scale),
                f"rid {rid} int8 first-token logits: {err} vs bf16")

    # the same requests on a hot int8 pool, under the exhaustion burst
    hot = ContinuousBatchingEngine(model, params, device="cuda",
                                   kv_dtype="int8", decode_reserve_frac=0.5,
                                   **CONT)
    auditor = PoolAuditor()
    hot.injector = ScriptedFaults(exhaust_at_appends=BURST)
    hot.auditor = auditor     # final_check raises on a leaked page
    freqs = make_requests(prompts, CONT_NEW_TOKENS)
    t0 = time.perf_counter()
    fout = hot.serve(freqs)
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    failed = sum(r.state is RequestState.FAILED for r in hot.results.values())
    check_served(hot, freqs, fout, CONT_NEW_TOKENS, cfg.vocab_size)
    require(hot.preemption_count >= 1, "the int8 burst preempted nothing")
    require(hot._mgr.pages_used == 0, "pages leaked")
    report = {
        "phase": "int8_continuous", "arch": ARCH, "layers": cfg.num_layers,
        "dtype": "bf16", "kv_dtype": "int8", **CONT,
        "num_pages": eng.num_pages,
        "pool_bytes": eng.num_pages * eng.kv_bytes_per_page(),
        "bf16_pool_bytes": bf16_eng.num_pages * bf16_eng.kv_bytes_per_page(),
        **serve_summary(eng, reqs, out, wall),
        "peak_mem_bytes": peak, "bf16_peak_mem_bytes": full["cont_peak"],
        "tokens_agreeing_with_bf16": agreement(out, bf16_out),
        "first_token_vs_bf16": logits_check, "launches": counts,
        "faulted": {
            "decode_reserve_frac": 0.5, "burst_appends": sorted(BURST),
            "preemptions": hot.preemption_count,
            "recompute_tokens": hot.recompute_tokens, "failed": failed,
            "pages_leaked": hot._mgr.pages_used,
            "steps_audited": auditor.steps_checked, "wall_s": fwall,
            "tokens_agreeing": agreement(fout, out),
        },
    }
    emit(report)
    return report


def shared_prefix_prompts(vocab: int) -> list:
    """The shared-prefix phase's 16 prompts (PREFIX_* above), from
    ``default_rng(5)``."""
    import numpy as np

    rng = np.random.default_rng(5)

    def draw(n):
        return rng.integers(3, vocab, size=(int(n),)).astype(np.int32)

    shared = draw(PREFIX_SHARED)
    publisher = np.concatenate([shared,
                                draw(PREFIX_PUBLISHER - PREFIX_SHARED)])
    suffixes = rng.integers(PREFIX_SUFFIX_LENS[0], PREFIX_SUFFIX_LENS[1] + 1,
                            size=PREFIX_SUFFIX_REQUESTS)
    colds = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                         size=PREFIX_COLD_REQUESTS)
    return ([publisher] + [publisher[:n] for n in PREFIX_FULL_HITS]
            + [np.concatenate([shared, draw(n)]) for n in suffixes]
            + [draw(n) for n in colds])


def watch_first_logits(model, eng, prompts: dict, full_hits=()):
    """Keep, on the device, the logits each request of ``prompts`` (rid ->
    prompt) draws its first token from while ``eng`` serves it: the row of
    the chunk step whose chunk ends the prompt, or, for a rid of
    ``full_hits`` (a prompt resident whole), the decode row that feeds the
    prompt's last token at position len - 1. Wraps the engine's step, to
    read its host array, and the model's ``prefill_chunk`` and
    ``paged_decode_step``, which the engine calls; adds no device-to-host
    copy. Returns rid -> (V,) fp32 logits, filled as the engine serves."""
    import numpy as np

    B, MP, CS = eng.batch_size, eng.max_pages, eng.chunk_size
    by_len, full_by_len = {}, {}
    for rid, p in prompts.items():
        by_len.setdefault(len(p), []).append((rid, p))
        if rid in full_hits:
            full_by_len.setdefault(len(p), []).append((rid, p))
    got, now = {}, {}
    step = eng._step

    def watched_step(cache, host, decode, prefill):
        now["host"], now["decode"], now["prefill"] = host, decode, prefill
        return step(cache, host, decode, prefill)

    def chunk(*args):
        logits, cache = model.prefill_chunk(*args)
        host = now["host"]
        q0, kv_len = int(host[-3]), int(host[-2])
        off = 2 * B + B * MP if now["decode"] else 0
        toks = host[off:off + kv_len - q0]
        for rid, p in by_len.get(kv_len, ()):
            if rid not in got and np.array_equal(toks, p[q0:]):
                got[rid] = logits[0].float().clone()
        return logits, cache

    def decode_step(*args):
        logits, cache = model.paged_decode_step(*args)
        host = now["host"]
        for s in range(B):
            for rid, p in full_by_len.get(int(host[B + s]) + 1, ()):
                if rid not in got and int(host[s]) == int(p[-1]):
                    got[rid] = logits[s, -1].float().clone()
        return logits, cache

    eng.model = dataclasses.replace(model, prefill_chunk=chunk,
                                    paged_decode_step=decode_step)
    eng._step = watched_step
    return got


def logits_vs(got: dict, want: dict, rids, rtol: float) -> list:
    """Each rid's first-token logits against ``want``'s, within ``rtol`` of
    the largest logit of ``want`` (at least 1)."""
    rows = []
    for rid in rids:
        require(rid in got and rid in want, f"rid {rid}: no first-token "
                                            f"logits captured")
        g, w = got[rid], want[rid]
        require(bool(g.isfinite().all()), f"rid {rid}: logits not finite")
        scale = float(w.abs().max())
        err = max_err(g, w)
        rows.append({"rid": rid, "max_abs_err": err, "max_abs_logit": scale,
                     "tol": rtol * max(1.0, scale),
                     "argmax_equal": int(g.argmax()) == int(w.argmax())})
        require(err <= rtol * max(1.0, scale),
                f"rid {rid} first-token logits: {err} vs the cold serve")
    return rows


def prefix_summary(eng, reqs, out, wall: float) -> dict:
    """TTFT from admission (the first token's stamp minus the admission
    stamp, so the queue wait both groups pay cancels), split by whether
    the admission mapped a resident prefix; tokens/s, ``prefix_stats``
    and the pool's peak pages."""
    admits = eng.metrics.series("admit_walltime_s").by_key
    stamps = eng.token_walltimes
    hit, miss = [], []
    for r in reqs:
        ttft = stamps[r.rid][0] - admits[r.rid][0]
        (hit if eng.results[r.rid].prefix_hit_tokens else miss).append(ttft)
    tokens = sum(len(out[r.rid]) for r in reqs)
    return {"wall_s": wall, "tokens": tokens, "tokens_per_s": tokens / wall,
            "ttft_from_admission_s": {
                "hit": percentiles(hit) if hit else None,
                "miss": percentiles(miss) if miss else None},
            "prefix_stats": eng.prefix_stats,
            "peak_pages": eng._mgr.peak_pages_used}


def phase_shared_prefix(torch, full: dict) -> dict:
    """Shared-prefix traffic (PREFIX_* above) through the continuous
    engine with ``prefix_cache=True`` at the continuous phase's settings,
    beside the same requests with the cache off; then under the exhaustion
    burst with a pool auditor, on int8 pools, and at FP32_LAYERS layers in
    fp32 (prefix on, off and under a burst: identical greedy tokens)."""
    import numpy as np

    from repro_torch.serving import (
        ContinuousBatchingEngine,
        PoolAuditor,
        RequestState,
        ScriptedFaults,
    )

    model, params = full["model"], full["params"]
    cfg = model.cfg
    prompts = shared_prefix_prompts(cfg.vocab_size)
    n_full = len(PREFIX_FULL_HITS)
    full_rids = list(range(1, 1 + n_full))
    suffix_rids = list(range(1 + n_full, 1 + n_full + PREFIX_SUFFIX_REQUESTS))
    hit_rids = full_rids + suffix_rids
    by_rid = dict(enumerate(prompts))

    def engine(m=model, p=params, **kw):
        return ContinuousBatchingEngine(m, p, device="cuda",
                                        **dict(CONT, **kw))

    def served(eng, reqs, out, new=CONT_NEW_TOKENS):
        check_served(eng, reqs, out, new, cfg.vocab_size)

    # prefix cache on, then off: the same requests, first-token logits kept
    on = engine(prefix_cache=True)
    on_logits = watch_first_logits(model, on, by_rid, full_rids)
    reqs = make_requests(prompts, CONT_NEW_TOKENS)
    out, wall, counts, peak = serve_path(torch, on, reqs, "shared_prefix")
    served(on, reqs, out)
    summary = prefix_summary(on, reqs, out, wall)
    st = on.prefix_stats
    for rid, n in zip(full_rids, PREFIX_FULL_HITS):
        require(on.results[rid].prefix_hit_tokens == n,
                f"rid {rid}: {on.results[rid].prefix_hit_tokens} of its {n} "
                f"prompt tokens from cache: not a full hit")
    require(st["cow_copies"] >= n_full,
            f"{st['cow_copies']} copy-on-write copies for {n_full} full hits")
    hit_tokens = [on.results[rid].prefix_hit_tokens for rid in by_rid]
    num_pages = on.num_pages
    shared_full = PREFIX_SHARED // CONT["page_size"] * CONT["page_size"]
    short = [rid for rid in suffix_rids
             if on.results[rid].prefix_hit_tokens < shared_full]
    require(not short, f"suffix requests mapped fewer than {shared_full} "
                       f"tokens: {short}")
    off = engine()
    off_logits = watch_first_logits(model, off, by_rid)
    reqs_off = make_requests(prompts, CONT_NEW_TOKENS)
    out_off, wall_off, counts_off, peak_off = serve_path(
        torch, off, reqs_off, "continuous")
    served(off, reqs_off, out_off)
    summary_off = prefix_summary(off, reqs_off, out_off, wall_off)
    require(summary["peak_pages"] < summary_off["peak_pages"],
            f"peak pages {summary['peak_pages']} with the prefix cache, "
            f"{summary_off['peak_pages']} without")
    first_logits = logits_vs(on_logits, off_logits, hit_rids, LOGITS_RTOL)
    del on, off

    # the same requests on a hot pool, under the exhaustion burst; the
    # auditor's final_check (inside serve) allows retained prefixes only
    hot = engine(prefix_cache=True, decode_reserve_frac=0.5)
    auditor = PoolAuditor()
    hot.injector = ScriptedFaults(exhaust_at_appends=BURST)
    hot.auditor = auditor
    breqs = make_requests(prompts, CONT_NEW_TOKENS)
    t0 = time.perf_counter()
    bout = hot.serve(breqs)
    torch.cuda.synchronize()
    bwall = time.perf_counter() - t0
    failed = sum(r.state is RequestState.FAILED for r in hot.results.values())
    served(hot, breqs, bout)
    require(hot.preemption_count >= 1, "the burst preempted nothing")
    require(failed == 0, f"{failed} requests failed under the burst")
    burst = {"decode_reserve_frac": 0.5, "burst_appends": sorted(BURST),
             "preemptions": hot.preemption_count,
             "recompute_tokens": hot.recompute_tokens, "failed": failed,
             "steps_audited": auditor.steps_checked,
             "retained_prefix_pages": len(hot._mgr.cached_pages()),
             "reserve_pages": hot._mgr.reserve_pages,
             "prefix_stats": hot.prefix_stats, "wall_s": bwall,
             "tokens_agreeing": agreement(bout, out)}
    del hot

    # int8 pools: the hits' first-token logits (the copied page's scales
    # among their inputs) against the bf16 cold serve's, as the int8
    # continuous phase holds its own
    q8 = engine(prefix_cache=True, kv_dtype="int8")
    q8_logits = watch_first_logits(model, q8, by_rid, full_rids)
    qreqs = make_requests(prompts, CONT_NEW_TOKENS)
    qout, qwall, qcounts, qpeak = serve_path(torch, q8, qreqs,
                                             "shared_prefix_int8")
    served(q8, qreqs, qout)
    for name in ("paged_prefill", "paged_decode"):
        require(qcounts[name] == 0, f"int8 pools ran the bf16 {name}")
    require(q8.prefix_stats["cow_copies"] >= n_full,
            "int8: the full hits made no copy")
    int8 = {**prefix_summary(q8, qreqs, qout, qwall),
            "peak_mem_bytes": qpeak, "launches": qcounts,
            "tokens_agreeing_with_bf16": agreement(qout, out),
            "first_token_vs_bf16_cold": logits_vs(
                q8_logits, off_logits, hit_rids, INT8_LOGITS_RTOL)}
    del q8, on_logits, off_logits, q8_logits
    torch.cuda.empty_cache()

    # fp32 at full width, FP32_LAYERS layers: prefix on, off and under a
    # burst give the same greedy tokens
    _, m32, p32 = fp32_model(torch, cfg)
    runs, stats32 = {}, {}
    for name, kw in (("prefix_on", dict(prefix_cache=True)),
                     ("prefix_off", {}),
                     ("prefix_on_burst", dict(prefix_cache=True,
                                              decode_reserve_frac=0.5))):
        eng = engine(m32, p32, **kw)
        if name == "prefix_on_burst":
            eng.injector = ScriptedFaults(exhaust_at_appends=PREFIX_FP32_BURST)
            eng.auditor = PoolAuditor()
        runs[name] = eng.serve(make_requests(prompts, FP32_NEW_TOKENS))
        stats32[name] = {**eng.prefix_stats,
                         "preemptions": eng.preemption_count}
        del eng
    require(stats32["prefix_on_burst"]["preemptions"] >= 1,
            "the fp32 burst preempted nothing")
    ref = runs["prefix_off"]
    mismatch = {name: [rid for rid in ref
                       if not np.array_equal(run[rid], ref[rid])]
                for name, run in runs.items()}
    report = {
        "phase": "shared_prefix", "arch": ARCH, "layers": cfg.num_layers,
        "dtype": "bf16", **CONT, "num_pages": num_pages,
        "requests": len(prompts), "new_tokens": CONT_NEW_TOKENS,
        "prompt_lens": [len(p) for p in prompts],
        "shared_tokens": PREFIX_SHARED, "full_hit_rids": full_rids,
        "suffix_rids": suffix_rids, "prefix_hit_tokens": hit_tokens,
        **summary, "peak_mem_bytes": peak, "launches": counts,
        "prefix_off": {**summary_off, "peak_mem_bytes": peak_off,
                       "launches": counts_off},
        "tokens_agreeing_with_prefix_off": agreement(out, out_off),
        "first_token_vs_cold": first_logits, "burst": burst, "int8": int8,
        "fp32_parity": {"layers": FP32_LAYERS, "new_tokens": FP32_NEW_TOKENS,
                        "burst_appends": sorted(PREFIX_FP32_BURST),
                        "stats": stats32, "mismatched_rids": mismatch},
    }
    emit(report)
    for name, rids in mismatch.items():
        require(not rids, f"fp32 {name}: tokens differ for rids {rids}")
    return report


def spec_summary(eng, reqs, out) -> dict:
    """Acceptance and the tokens a verify step emits. Every token after a
    request's first comes from a decode-carrying step; a step with a
    prompt chunk emits one token a live slot, so the rest came out of
    verify steps."""
    log = eng.step_log
    chunk_decode = sum(e["live_decode"] for e in log
                       if e["prefill_in_flight"])
    verify_steps = [e["live_decode"] for e in log
                    if not e["prefill_in_flight"]]
    decoded = sum(len(out[r.rid]) - 1 for r in reqs)
    from_verify = decoded - chunk_decode
    return {**eng.spec_stats, "verify_steps": len(verify_steps),
            "tokens_from_verify": from_verify,
            "tokens_per_verify_step": from_verify / max(1, len(verify_steps)),
            "tokens_per_slot_verify": from_verify / max(1, sum(verify_steps))}


def phase_speculative(torch, full: dict) -> dict:
    """Full-width speculative decoding (k = SPEC_DEPTH) of 16 requests
    whose prompts tile one random span to the continuous phase's lengths,
    on bf16 and on int8 pools, each beside the plain serve of the same
    prompts."""
    from repro_torch.serving import ContinuousBatchingEngine

    model, params = full["model"], full["params"]
    cfg = model.cfg
    prompts = spec_prompts(cfg.vocab_size, [len(p) for p in
                                            full["continuous"][0]], seed=2)
    runs = {}
    for kv_dtype, path in ((None, "speculative"),
                           ("int8", "speculative_int8")):
        name = kv_dtype or "bf16"
        plain = ContinuousBatchingEngine(model, params, device="cuda",
                                         kv_dtype=kv_dtype, **CONT)
        preqs = make_requests(prompts, CONT_NEW_TOKENS)
        t0 = time.perf_counter()
        pout = plain.serve(preqs)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
        eng = ContinuousBatchingEngine(model, params, device="cuda",
                                       kv_dtype=kv_dtype,
                                       spec_depth=SPEC_DEPTH, **CONT)
        reqs = make_requests(prompts, CONT_NEW_TOKENS)
        out, wall, counts, peak = serve_path(torch, eng, reqs, path)
        check_served(eng, reqs, out, CONT_NEW_TOKENS, cfg.vocab_size)
        full[path] = counts
        full.setdefault("one_card", {})[path] = one_card_record(
            eng, prompts, out, wall)
        runs[name] = {
            **serve_summary(eng, reqs, out, wall),
            **spec_summary(eng, reqs, out),
            "plain_wall_s": pwall,
            "plain_tokens_per_s": sum(len(v) for v in pout.values()) / pwall,
            # bf16 verifies k rows in one pass where plain decode takes k
            # steps, so a near tie may round the other way: reported, no
            # limit (fp32 equality is held below, at 2 layers)
            "tokens_agreeing_with_plain": agreement(out, pout),
            "peak_mem_bytes": peak, "launches": counts,
        }
    report = {"phase": "speculative", "arch": ARCH, "layers": cfg.num_layers,
              "dtype": "bf16", **CONT, "spec_depth": SPEC_DEPTH,
              "span": SPEC_SPAN, "requests": len(prompts),
              "new_tokens": CONT_NEW_TOKENS, "runs": runs}
    emit(report)
    return report


def phase_spec_parity(torch, full: dict) -> dict:
    """fp32 at full width, FP32_LAYERS layers: speculative tokens equal
    plain continuous tokens on fp32 and on int8 pools, and under an
    exhaustion burst on fp32 pools."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        PoolAuditor,
        ScriptedFaults,
    )

    cfg = full["model"].cfg
    _, m32, p32 = fp32_model(torch, cfg)
    lens = np.random.default_rng(3).integers(PROMPT_LENS[0], FP32_PROMPT_MAX,
                                             size=FP32_REQUESTS)
    prompts = spec_prompts(cfg.vocab_size, lens, seed=4)

    def serve(**kw):
        eng = ContinuousBatchingEngine(m32, p32, device="cuda",
                                       **dict(CONT, **kw))
        return eng, eng.serve(make_requests(prompts, FP32_NEW_TOKENS))

    checks, stats = {}, {}
    ops.reset_launch_counts()
    for kv_dtype in (None, "int8"):
        name = kv_dtype or "fp32"
        _, plain = serve(kv_dtype=kv_dtype)
        eng, spec = serve(kv_dtype=kv_dtype, spec_depth=SPEC_DEPTH)
        checks[name] = [rid for rid in plain
                        if not np.array_equal(spec[rid], plain[rid])]
        stats[name] = eng.spec_stats
        if kv_dtype is None:
            burst = ContinuousBatchingEngine(
                m32, p32, device="cuda", decode_reserve_frac=0.5,
                spec_depth=SPEC_DEPTH, **CONT)
            burst.injector = ScriptedFaults(
                exhaust_at_appends=frozenset({5, 6, 7}))
            burst.auditor = PoolAuditor()
            bout = burst.serve(make_requests(prompts, FP32_NEW_TOKENS))
            require(burst.preemption_count >= 1,
                    "the fp32 speculative burst preempted nothing")
            checks["fp32_burst"] = [rid for rid in plain if not
                                    np.array_equal(bout[rid], plain[rid])]
            stats["fp32_burst"] = {**burst.spec_stats,
                                   "preemptions": burst.preemption_count}
    counts = ops.launch_counts()
    report = {"phase": "spec_fp32_parity", "layers": FP32_LAYERS,
              "requests": FP32_REQUESTS, "prompt_lens": [int(n) for n in lens],
              "new_tokens": FP32_NEW_TOKENS, "spec_depth": SPEC_DEPTH,
              "mismatched_rids": checks, "spec_stats": stats,
              "launches": counts}
    emit(report)
    for name, rids in checks.items():
        require(not rids, f"fp32 speculative {name}: tokens differ from "
                          f"plain for rids {rids}")
    for name in ("paged_verify", "paged_verify_int8"):
        require(counts[name] > 0, f"fp32: kernel {name} not launched")
    return report


def continuous_prompts(vocab: int) -> list:
    """The continuous phase's CONT_REQUESTS prompts: lengths in
    PROMPT_LENS, then tokens, drawn from default_rng(0)."""
    import numpy as np

    rng = np.random.default_rng(0)
    plens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1,
                         size=CONT_REQUESTS)
    return [rng.integers(3, vocab, size=(int(n),)).astype(np.int32)
            for n in plens]


def chunked_prefill(torch, model, params, prompt):
    """``prompt`` prefilled alone through ``prefill_chunk`` in the
    continuous engine's chunks on a fresh paged cache, pages 1.. in
    order; returns the last chunk's logits (the first token's)."""
    page, chunk = CONT["page_size"], CONT["chunk_size"]
    n = len(prompt)
    cfg = model.cfg
    cache = model.make_cache(1, n, device="cuda", cache_layout="paged",
                             page_size=page)
    n_pg = -(-n // page)
    table = torch.arange(1, n_pg + 1, dtype=torch.int32, device="cuda")
    for q0 in range(0, n, chunk):
        clen = min(chunk, n - q0)
        toks = torch.ones((1, chunk), dtype=torch.long, device="cuda")
        toks[0, :clen] = torch.from_numpy(prompt[q0:q0 + clen]).cuda()
        cpages = torch.tensor(
            [j + 1 if j < n_pg else 0
             for j in range(q0 // page, (q0 + chunk) // page)],
            dtype=torch.int32, device="cuda")
        logits, cache = model.prefill_chunk(params, cfg, toks, cache, table,
                                            cpages,
                                            chunk_span(torch, q0, clen))
    return logits


def percentiles(values) -> dict:
    import numpy as np

    v = np.asarray(values, dtype=np.float64)
    return {"p50": float(np.percentile(v, 50)),
            "p95": float(np.percentile(v, 95)), "n": int(v.size)}


def phase_continuous(torch, full: dict) -> dict:
    """Full-width internlm2-1.8b served by the continuous engine on the page
    pool, then under an exhaustion burst, then fp32 token parity."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving import (
        ContinuousBatchingEngine,
        PoolAuditor,
        RequestState,
        ScriptedFaults,
        ServingEngine,
    )

    model, params = full["model"], full["params"]
    cfg = model.cfg
    prompts = continuous_prompts(cfg.vocab_size)
    plens = [len(p) for p in prompts]

    def requests(ps=prompts, new=CONT_NEW_TOKENS) -> list:
        return make_requests(ps, new)

    def served(eng, reqs, out, new=CONT_NEW_TOKENS) -> None:
        check_served(eng, reqs, out, new, cfg.vocab_size)

    eng = ContinuousBatchingEngine(model, params, device="cuda", **CONT)
    # warm-up: cuBLAS handles and the kernels' first loads
    eng.serve(warm_up_requests(prompts))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    reqs = requests()
    t0 = time.perf_counter()
    out = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    served(eng, reqs, out)
    for name in PATH_KERNELS["continuous"]:
        require(counts[name] > 0,
                f"kernel {name} was not launched on the continuous path")
    full["continuous"], full["cont_peak"] = (prompts, out), peak
    full.setdefault("one_card", {})["continuous"] = one_card_record(
        eng, prompts, out, wall)
    num_pages = eng.num_pages
    stamps = eng.token_walltimes
    ttft = [stamps[r.rid][0] - eng.serve_t0 for r in reqs]
    gaps = [g for r in reqs for g in np.diff(stamps[r.rid])]
    tokens = sum(len(out[r.rid]) for r in reqs)
    steps = {k: eng.metrics.histogram(f"engine.step_s.{k}").summary()
             for k in ("decode", "chunk", "chunk+decode")}

    # first-token logits: the kernel path's chunked prefill vs the plain
    # attention path's monolithic prefill, two requests
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    logits_check = []
    for rid in (0, 1):
        p = prompts[rid]
        n = len(p)
        got = chunked_prefill(torch, model, params, p)
        want, _ = plain_model.prefill(
            params, plain_model.cfg,
            torch.from_numpy(p[None].astype(np.int64)).cuda(), n)
        got, want = got.float(), want[:, 0].float()
        require(bool(torch.isfinite(got).all()), f"rid {rid}: logits")
        scale = float(want.abs().max())
        err = max_err(got, want)
        logits_check.append({
            "rid": rid, "prompt_len": n, "max_abs_err": err,
            "max_abs_logit": scale, "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all()),
            "engine_first_token_equal": int(got.argmax()) == int(out[rid][0]),
        })
        require(err <= LOGITS_RTOL * max(1.0, scale),
                f"rid {rid} first-token logits: {err} vs plain")

    # the same requests on a hot pool, under an exhaustion burst
    hot = ContinuousBatchingEngine(model, params, device="cuda",
                                   decode_reserve_frac=0.5, **CONT)
    auditor = PoolAuditor()
    hot.injector = ScriptedFaults(exhaust_at_appends=BURST)
    hot.auditor = auditor     # final_check raises on a leaked page
    t0 = time.perf_counter()
    fout = hot.serve(requests())
    torch.cuda.synchronize()
    fwall = time.perf_counter() - t0
    failed = sum(r.state is RequestState.FAILED for r in hot.results.values())
    served(hot, reqs, fout)
    require(hot.preemption_count >= 1, "the burst preempted nothing")
    require(failed == 0, f"{failed} requests failed under the burst")
    require(hot._mgr.pages_used == 0, "pages leaked")
    agree = sum(int((fout[r.rid] == out[r.rid]).sum()) for r in reqs)
    faulted = {
        "decode_reserve_frac": 0.5, "burst_appends": sorted(BURST),
        "preemptions": hot.preemption_count,
        "recompute_tokens": hot.recompute_tokens, "failed": failed,
        "pages_leaked": hot._mgr.pages_used,
        "steps_audited": auditor.steps_checked, "wall_s": fwall,
        "tokens_agreeing": agree / tokens,
    }
    del eng, hot

    # fp32 parity at full width, 2 layers: kernels, plain attention, the
    # wave engine and the burst give the same greedy tokens
    cfg32, m32, p32 = fp32_model(torch, cfg)
    rng32 = np.random.default_rng(1)
    ps32 = [rng32.integers(3, cfg.vocab_size, size=(int(n),)).astype(np.int32)
            for n in rng32.integers(PROMPT_LENS[0], FP32_PROMPT_MAX,
                                    size=FP32_REQUESTS)]

    def reqs32():
        return requests(ps32, FP32_NEW_TOKENS)

    runs = {}
    ops.reset_launch_counts()
    runs["continuous_kernel"] = ContinuousBatchingEngine(
        m32, p32, device="cuda", **CONT).serve(reqs32())
    fp32_counts = ops.launch_counts()
    runs["continuous_plain"] = ContinuousBatchingEngine(
        build_model(dataclasses.replace(cfg32, attn_impl="plain")), p32,
        device="cuda", **CONT).serve(reqs32())
    runs["wave_kernel"] = ServingEngine(
        m32, p32, max_len=CONT["max_len"], batch_size=1,
        device="cuda").serve(reqs32())
    burst = ContinuousBatchingEngine(m32, p32, device="cuda",
                                     decode_reserve_frac=0.5, **CONT)
    burst.injector = ScriptedFaults(exhaust_at_appends=frozenset({5, 6, 7}))
    burst.auditor = PoolAuditor()
    runs["continuous_burst"] = burst.serve(reqs32())
    require(burst.preemption_count >= 1, "the fp32 burst preempted nothing")
    ref = runs["continuous_kernel"]
    require(all(len(ref[rid]) == FP32_NEW_TOKENS for rid in ref),
            "fp32: a request did not get all its tokens")
    mismatch = {name: [rid for rid in ref
                       if not np.array_equal(run[rid], ref[rid])]
                for name, run in runs.items()}
    fp32 = {"layers": FP32_LAYERS, "requests": FP32_REQUESTS,
            "prompt_lens": [len(p) for p in ps32],
            "new_tokens": FP32_NEW_TOKENS,
            "distinct_tokens": len({t for v in ref.values() for t in v}),
            "burst_preemptions": burst.preemption_count,
            "launches": fp32_counts, "mismatched_rids": mismatch}
    for name, rids in mismatch.items():
        require(not rids, f"fp32 {name}: tokens differ for rids {rids}")
    for name in PATH_KERNELS["continuous"]:
        require(fp32_counts[name] > 0, f"fp32: kernel {name} not launched")

    report = {
        "phase": "continuous", "arch": ARCH, "layers": cfg.num_layers,
        "dtype": "bf16", **CONT, "num_pages": num_pages,
        "requests": CONT_REQUESTS, "new_tokens": CONT_NEW_TOKENS,
        "prompt_lens": [int(n) for n in plens], "wall_s": wall,
        "tokens": tokens, "tokens_per_s": tokens / wall,
        "ttft_s": percentiles(ttft), "itl_s": percentiles(gaps),
        "steps": {k: {"count": v["count"], "mean_s": v["mean"],
                      "p50_s": v["p50"], "p95_s": v["p95"]}
                  for k, v in steps.items()},
        "peak_mem_bytes": peak, "launches": counts,
        "first_token_vs_plain": logits_check, "faulted": faulted,
        "fp32_parity": fp32,
    }
    emit(report)
    return {**report, "tokens": out}


def weights_checksum(torch, params) -> int:
    """An exact checksum of a params tree: each tensor's bits read as
    integers and summed, weighted by the tensor's place in the tree."""
    total = 0
    for i, t in enumerate(tensors_of(params), 1):
        bits = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        total += i * int(bits.sum(dtype=torch.int64))
    return total


def warm_up_requests(prompts) -> list:
    """Two short requests off the first two prompts (rids 100, 101)."""
    from repro_torch.serving import Request

    return [Request(rid=100 + i, prompt=prompts[i][:40], max_new_tokens=2,
                    eos_id=-1) for i in range(2)]


def step_split(eng) -> dict:
    """A serve's mean step wall by kind and its total wait for the step
    results (the host sync), from the engine's metrics."""
    m = eng.metrics
    means = {}
    for kind in ("decode", "chunk", "chunk+decode", "verify"):
        h = m.histogram(f"engine.step_s.{kind}")
        if h.count:
            means[kind] = h.summary()["mean"]
    return {"step_mean_s": means,
            "host_sync_s": m.histogram("engine.host_sync_s").sum}


def one_card_record(eng, prompts, out, wall: float) -> dict:
    """What the sharded phase holds a run to: a single-card serve's
    prompts and tokens, and its wall and step split beside the ranks'."""
    return {"prompts": prompts, "tokens": out, "wall_s": wall,
            **step_split(eng)}


def shard_yardstick(torch, full: dict, path: str,
                    layers: int | None = None) -> dict:
    """The ``one_card_record`` of the single-card serve of ``path`` (at
    ``layers`` of the model's layers: default all): the one its phase
    recorded, else served here at the same settings (when the sharded
    phase runs alone, or at a cut depth)."""
    from repro_torch.serving import ContinuousBatchingEngine

    tokens = full.setdefault("one_card", {})
    key = path if layers is None else f"{path} at {layers} layers"
    if key not in tokens:
        model, params = (full["model"], full["params"]) if layers is None \
            else cut_depth(full, layers)
        vocab = model.cfg.vocab_size
        prompts = continuous_prompts(vocab)
        if not tokens:
            # warm-up, as the continuous phase's: cuBLAS handles and the
            # kernels' first loads
            ContinuousBatchingEngine(model, params, device="cuda",
                                     **CONT).serve(warm_up_requests(prompts))
        spec = path.startswith("speculative")
        if spec:
            prompts = spec_prompts(vocab, [len(p) for p in prompts], seed=2)
        eng = ContinuousBatchingEngine(
            model, params, device="cuda",
            kv_dtype="int8" if path.endswith("int8") else None,
            spec_depth=SPEC_DEPTH if spec else None, **CONT)
        reqs = make_requests(prompts, CONT_NEW_TOKENS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.serve(reqs)
        torch.cuda.synchronize()
        tokens[key] = one_card_record(eng, prompts, out,
                                      time.perf_counter() - t0)
    return tokens[key]


def collective_probe(torch, dist, dev, rank: int, degree: int,
                     shard=None) -> dict:
    """One all-gather and one broadcast of CUDA tensors on this group's
    backend, their values checked; with ``shard`` (a ``SeqShard`` of the
    whole group) also its reduce-scatter and its all-reduces (sum, max),
    which over gloo stage CUDA tensors through host buffers."""
    x = torch.full((3,), float(rank), device=dev)
    parts = [torch.empty_like(x) for _ in range(degree)]
    dist.all_gather(parts, x)
    y = torch.tensor([rank + 7], dtype=torch.int32, device=dev)
    dist.broadcast(y, src=0)
    got = [float(p[0]) for p in parts]
    require(got == [float(r) for r in range(degree)] and int(y) == 7,
            f"rank {rank}: all_gather gave {got}, broadcast {int(y)}")
    out = {"all_gather": got, "broadcast": int(y)}
    if shard is None:
        return out
    z = torch.arange(2.0 * degree, device=dev) * (rank + 1)
    total = degree * (degree + 1) / 2
    mine = shard.reduce_scatter(z)
    want = [total * (2 * rank + i) for i in range(2)]
    amax = shard.all_reduce(z, op="max")
    summed = shard.all_reduce(z)
    require(mine.tolist() == want
            and amax.tolist() == (torch.arange(2.0 * degree) * degree)
            .tolist() and summed.tolist() == (torch.arange(2.0 * degree)
                                              * total).tolist(),
            f"rank {rank}: reduce_scatter {mine.tolist()} (want {want}), "
            f"all_reduce max {amax.tolist()}, sum {summed.tolist()}")
    shard.reset_counts()
    return {**out, "reduce_scatter": mine.tolist(),
            "all_reduce_staged": shard._staged(z)}


def ring_counts(cfg, eng, degree: int, kv_dtype) -> tuple[int, int]:
    """(passes, slab bytes received) of a rank's head-block ring over a
    serve of ``eng``, from the shapes: n - 1 passes a layer a chunk step,
    each of the rank's K and V slabs of max_pages pages of Hkv/n heads
    (int8: with their fp32 scales)."""
    chunks = sum(1 for step in eng.step_log if step["prefill_in_flight"])
    hops = chunks * cfg.num_layers * (degree - 1)
    heads, pages = cfg.num_kv_heads // degree, eng.max_pages
    row = CONT["page_size"] * cfg.hd
    if kv_dtype == "int8":
        slab = 2 * heads * pages * (row + 4)
    else:
        slab = 2 * heads * pages * row * cfg.compute_dtype.itemsize
    return hops, hops * slab


def sharded_rank(rank: int, degree: int, backend: str, store: str,
                 out_dir: str, runs: list, checksum: int) -> None:
    """One rank of the sharded phase (a process of its own): join the
    group, build internlm2-1.8b from seed 0, check its weights against the
    parent's, and serve each run through ``ShardedContinuousBatchingEngine``
    on its chunk route with the launch counts set to 0 just before and
    read just after. A ring run also keeps its first-token logits
    (``watch_first_logits``), and its passes, slab bytes and B5 launches
    are held to the shapes. Writes its report to ``out_dir``, then fails
    on any gate."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import ops
    from repro_torch.serving import ShardedContinuousBatchingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=degree)
    try:
        probe = collective_probe(torch, dist, dev, rank, degree)
        full = full_width_model(torch)
        mine = weights_checksum(torch, full["params"])
        print(json.dumps({"phase": "sharded", "rank": rank, "degree": degree,
                          "weights_checksum": mine}), flush=True)
        report = {"rank": rank, "device": str(dev), "probe": probe,
                  "weights_checksum": mine, "runs": []}
        failures = [] if mine == checksum else [
            f"rank {rank}: weights checksum {mine} != the parent's "
            f"{checksum}"]
        ShardedContinuousBatchingEngine(
            *cut_depth(full, runs[0]["layers"]), shard=degree, device=dev,
            **CONT).serve(warm_up_requests(
                [np.asarray(p, np.int32) for p in runs[0]["prompts"]]))
        fp32 = None
        for run in runs:
            path, kv_dtype, route = run["path"], run["kv_dtype"], run["route"]
            if path == "fp32":
                if fp32 is None:
                    fp32 = fp32_model(torch, full["model"].cfg)[1:]
                model, params = fp32
            else:
                model, params = cut_depth(full, run["layers"])
            eng = ShardedContinuousBatchingEngine(
                model, params, shard=degree, device=dev, kv_dtype=kv_dtype,
                spec_depth=run["spec"], chunk_route=route, **CONT)
            prompts = [np.asarray(p, np.int32) for p in run["prompts"]]
            reqs = make_requests(prompts, CONT_NEW_TOKENS)
            first = (watch_first_logits(model, eng, dict(enumerate(prompts)))
                     if run["first_logits"] is not None else None)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = eng.serve(reqs)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            differ = [r.rid for r in reqs
                      if out[r.rid].tolist() != run["want"][r.rid]]
            stats = eng.shard_stats
            rec = {
                "path": path, "kv_dtype": kv_dtype, "spec_depth": run["spec"],
                "chunk_route": route, "wall_s": wall,
                "rids_differing": differ,
                "tokens_differing": sum(
                    int(np.sum(out[r.rid] != np.asarray(run["want"][r.rid])))
                    for r in reqs if r.rid in differ),
                **stats, **step_split(eng),
                "steps": len(eng.step_log),
                "tokens": sum(len(v) for v in out.values()),
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "launches": counts}
            tag = f"rank {rank} {path} ({route})"
            if route == "ring":
                hops, ring_bytes = ring_counts(model.cfg, eng, degree,
                                               kv_dtype)
                b5 = "paged_prefill_int8" if kv_dtype else "paged_prefill"
                rec.update(ring_hops_from_shapes=hops,
                           ring_bytes_from_shapes=ring_bytes,
                           b5_launches=counts[b5])
                failures += [f"{tag}: ring passes {stats['ring_hops']} / "
                             f"{stats['ring_bytes']} B, the shapes give "
                             f"{hops} / {ring_bytes}"] if (
                    stats["ring_hops"], stats["ring_bytes"]) != (
                    hops, ring_bytes) or not hops else []
                # n launches of B5 a layer a chunk: n - 1 passes and the
                # rank's own slab
                failures += [f"{tag}: {counts[b5]} B5 launches, the ring's "
                             f"{hops} passes give {hops * degree // (degree - 1)}"
                             ] if counts[b5] != hops * degree // (degree - 1) \
                    else []
            if first is not None:
                rec["first_token_logits"] = logits_vs(
                    {rid: x.cpu() for rid, x in first.items()},
                    run["first_logits"], range(len(prompts)),
                    run["logits_rtol"] or float("inf"))
            if run["tokens_gate"]:
                failures += [f"{tag}: tokens differ from one card's for "
                             f"rids {differ}"] if differ else []
            failures += [f"{tag}: {stats['result_mismatch']} results differ "
                         f"from rank 0's"] if stats["result_mismatch"] else []
            failures += [f"{tag}: kernel {name} not launched"
                         for name in PATH_KERNELS[path if path != "fp32"
                                                  else "continuous"]
                         if not counts[name]]
            report["runs"].append(rec)
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
        require(not failures, "; ".join(failures))
    finally:
        dist.destroy_process_group()


def cut_depth(full: dict, layers: int) -> tuple:
    """(model, params) of ``full``'s first ``layers`` layers: the same
    tensors, no copy."""
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(full["model"].cfg, num_layers=layers)
    return build_model(cfg), dict(full["params"],
                                  layers=full["params"]["layers"][:layers])


def ring_yardsticks(torch, full: dict) -> dict:
    """The single-card serves the ring runs are held to, each a
    ``one_card_record`` by path: the continuous phase's requests at
    RING_LAYERS layers on bf16 pools, with their first-token logits
    (``watch_first_logits``, CPU tensors), and on int8 pools; and at
    FP32_LAYERS layers in fp32."""
    from repro_torch.serving import ContinuousBatchingEngine

    prompts = continuous_prompts(full["model"].cfg.vocab_size)
    model, params = cut_depth(full, RING_LAYERS)
    out = {}
    for path, kv_dtype in (("continuous", None), ("int8_continuous", "int8"),
                           ("fp32", None)):
        if path == "fp32":
            _, model, params = fp32_model(torch, full["model"].cfg)
        eng = ContinuousBatchingEngine(model, params, device="cuda",
                                       kv_dtype=kv_dtype, **CONT)
        first = (watch_first_logits(model, eng, dict(enumerate(prompts)))
                 if path == "continuous" else None)
        t0 = time.perf_counter()
        tokens = eng.serve(make_requests(prompts, CONT_NEW_TOKENS))
        torch.cuda.synchronize()
        out[path] = one_card_record(eng, prompts, tokens,
                                    time.perf_counter() - t0)
        if first is not None:
            out["first_logits"] = {rid: x.cpu() for rid, x in first.items()}
    return out


def phase_sharded(torch, full: dict, ring_bitwise: dict) -> dict:
    """KV-head-sharded continuous serving of full-width internlm2-1.8b
    over 2 and 4 ranks, each rank a process: NCCL with a card a rank where
    the machine has as many cards, else gloo with every rank on card 0.
    Each rank's tokens must equal the single-card serve's bit for bit
    (SHARD_RUNS), no step's result may differ from rank 0's, and each
    rank's B5, B6 and B7 launch counts must rise. Then SHARD_RING_RUNS on
    the head-block ring: the same gates but for the tokens, which must
    equal the single card's where ``ring_bitwise`` (pool -> the B5_ring
    rows' verdict) says a hop's rows are the single card's B5 rows bit
    for bit, and else are recorded beside the first-token logits held to
    the bf16 single card's within LOGITS_RTOL (int8 pools:
    INT8_LOGITS_RTOL); fp32 tokens always equal; passes, slab bytes and
    B5 launches as the shapes give. A rank's failure fails the phase:
    ``mp.spawn`` raises it here."""
    import tempfile

    import torch.multiprocessing as mp

    checksum = weights_checksum(torch, full["params"])
    launches = dict.fromkeys(PATH_KERNELS["sharded"], 0)
    ring_launches = dict.fromkeys(PATH_KERNELS["sharded"], 0)
    ring_yard = ring_yardsticks(torch, full)
    one_card = {}
    torch.cuda.empty_cache()        # the ranks share this card under gloo
    lines = []
    degrees = sorted({d for _, d, _, _ in SHARD_RUNS}
                     | {d for _, d, _ in SHARD_RING_RUNS})
    depth = full["model"].cfg.num_layers
    for degree in degrees:
        runs = []
        cards = torch.cuda.device_count()
        backend = "nccl" if cards >= degree else "gloo"
        local = depth if backend == "nccl" else SHARD_SHARED_LAYERS
        todo = [(path, kv_dtype, spec, "local")
                for path, d, kv_dtype, spec in SHARD_RUNS if d == degree]
        todo += [(path, kv_dtype, None, "ring")
                 for path, d, kv_dtype in SHARD_RING_RUNS if d == degree]
        for path, kv_dtype, spec, route in todo:
            if route == "ring":
                rec = ring_yard[path]
            elif local == RING_LAYERS and path in ring_yard:
                rec = ring_yard[path]
            else:
                rec = shard_yardstick(torch, full, path,
                                      None if local == depth else local)
            layers = (FP32_LAYERS if path == "fp32" else RING_LAYERS
                      if route == "ring" else local)
            one_card[path, route] = {k: rec[k] for k in (
                "wall_s", "step_mean_s", "host_sync_s")}
            ring = route == "ring" and path != "fp32"
            tokens_gate = not ring or ring_bitwise["int8" if kv_dtype
                                                   else "bf16"]
            runs.append({
                "path": path, "kv_dtype": kv_dtype, "spec": spec,
                "route": route, "layers": layers,
                "prompts": [p.tolist() for p in rec["prompts"]],
                "want": [rec["tokens"][rid].tolist()
                         for rid in range(len(rec["prompts"]))],
                "tokens_gate": tokens_gate,
                "first_logits": ring_yard["first_logits"] if ring else None,
                "logits_rtol": (None if tokens_gate else INT8_LOGITS_RTOL
                                if kv_dtype else LOGITS_RTOL)})
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(sharded_rank,
                     args=(degree, backend, str(Path(tmp) / "store"), tmp,
                           runs, checksum), nprocs=degree, join=True)
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(degree)]
        spawn_s = time.perf_counter() - t0
        for i, run in enumerate(runs):
            per = [rk["runs"][i] for rk in ranks]
            route = run["route"]
            for rk in per:
                for name in launches:
                    (launches if route == "local" else ring_launches)[
                        name] += rk["launches"][name]
            line = {
                "phase": "sharded", "path": run["path"], "backend": backend,
                "cards": degree if backend == "nccl" else 1,
                "degree": degree, "kv_dtype": run["kv_dtype"],
                "spec_depth": run["spec"], "chunk_route": route,
                "arch": ARCH, **CONT, "requests": CONT_REQUESTS,
                "new_tokens": CONT_NEW_TOKENS,
                "tokens_equal_one_card": all(not rk["rids_differing"]
                                             for rk in per),
                "tokens_gate": run["tokens_gate"],
                "tokens_differing": [rk["tokens_differing"] for rk in per],
                "allgather_bytes": [rk["allgather_bytes"] for rk in per],
                "result_mismatch": [rk["result_mismatch"] for rk in per],
                "ring_hops": [rk["ring_hops"] for rk in per],
                "ring_bytes": [rk["ring_bytes"] for rk in per],
                "peak_gb": [rk["peak_mem_bytes"] / 1e9 for rk in per],
                "wall_s": [rk["wall_s"] for rk in per],
                "step_mean_s": [rk["step_mean_s"] for rk in per],
                "host_sync_s": [rk["host_sync_s"] for rk in per],
                "one_card": one_card[run["path"], route],
                "layers": run["layers"],
                "steps": per[0]["steps"], "tokens": per[0]["tokens"],
                "launches": [{k: v for k, v in rk["launches"].items() if v}
                             for rk in per],
                "weights_checksum": checksum,
                "probe": ranks[0]["probe"], "spawn_s": spawn_s,
            }
            if route == "ring":
                line.update({k: [rk[k] for rk in per] for k in (
                    "ring_hops_from_shapes", "ring_bytes_from_shapes",
                    "b5_launches")})
                if "first_token_logits" in per[0]:
                    line["first_token_logits_max_abs_err"] = [
                        max(x["max_abs_err"] for x in rk["first_token_logits"])
                        for rk in per]
                    line["first_token_argmax_equal"] = [
                        sum(x["argmax_equal"] for x in rk[
                            "first_token_logits"]) for rk in per]
            emit(line)
            lines.append(line)
    return {"phase": "sharded", "runs": lines, "launches": launches,
            "ring_launches": ring_launches}


def first_output(module, name: str, run):
    """``run()`` with the output of the first call of ``module.name``
    kept: (run's result, that output)."""
    result, seen = first_outputs([(module, name)], run)
    return result, seen[name]


def seq_logits(got, want) -> dict:
    """Logits against ``want``'s within LOGITS_RTOL of the largest of
    ``want`` (at least 1): the dense limit."""
    got, want = got.float().cpu(), want.float().cpu()
    tol = LOGITS_RTOL * max(1.0, float(want.abs().max()))
    err = max_err(got, want)
    finite = bool(got.isfinite().all())
    return {"max_abs_err": err, "tol": tol, "finite": finite,
            "ok": finite and err <= tol,
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all())}


def seq_moe_cfg(layers: int | None = None):
    """deepseek-moe-16b at full width, at ``layers`` layers (default
    all)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(MOE_ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          num_layers=layers)


def seq_yardsticks(torch, full: dict, path, moe_layers=None,
                   dense_layers=None) -> dict:
    """The single-card port's results the seq_sharded ranks are held to,
    saved to ``path`` (CPU tensors): internlm2-1.8b's (``dense_layers``
    of its layers, default all) prefill_32k on the
    kernel route (first-token logits, layer 0's attention output, the
    logits of SEQ_PREFILL_NEW decode steps of seeded tokens after it),
    decode_32k's SEQ_DECODE_STEPS steps on the same seeded cache (logits,
    layer 0's attention output at step 0), the fp32 run's greedy tokens
    on the plain route, and deepseek-moe-16b's (``moe_layers`` of its
    layers, default all) 4 x 2048 prefill and decode steps on the plain
    route in the ranks' token groups
    (``ctx.grouped_as``), with each layer's routes. Seeds as
    ``launch/dryrun.run_cell``'s at seed 0. Returns the single card's
    times."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed import ctx
    from repro_torch.launch.dryrun import cell_tokens, decode_steps
    from repro_torch.launch.dryrun import seeded_cache
    from repro_torch.models import attention as attn_mod
    from repro_torch.models.api import build_model

    dev = torch.device("cuda")
    model, params = ((full["model"], full["params"]) if dense_layers is None
                     else cut_depth(full, dense_layers))
    cfg = model.cfg
    s = SHAPES["prefill_32k"].seq_len
    d = SHAPES["decode_32k"].seq_len
    yard, times = {}, {}
    with torch.no_grad():
        tokens = cell_tokens(cfg, SEQ_PREFILL_BATCH, s, seed=1, device=dev)
        ((logits, cache), host, ms), attn0 = first_output(
            attn_mod, "attention", lambda: timed_call(torch, lambda: (
                model.prefill(params, cfg, tokens, s + SEQ_PREFILL_NEW))))
        steps = cell_tokens(cfg, SEQ_PREFILL_BATCH, SEQ_PREFILL_NEW, seed=4,
                            device=dev)
        step_logits, step_ms, _ = decode_steps(model, params, cache, steps,
                                               s, dev)
        yard["prefill"] = {"logits": logits[:, 0].float().cpu(),
                           "attn0": attn0.cpu(),
                           "steps": step_logits.float().cpu()}
        times["prefill_32k"] = {"prefill_ms": ms, "prefill_s": host,
                                "decode_step_ms": step_ms}
        del cache, logits, attn0
        torch.cuda.empty_cache()

        cache = seeded_cache(cfg, SEQ_DECODE_BATCH, d, d - SEQ_DECODE_STEPS,
                             seed=2, device=dev)
        tokens = cell_tokens(cfg, SEQ_DECODE_BATCH, SEQ_DECODE_STEPS, seed=3,
                             device=dev)
        (logits, ms, _), attn0 = first_output(
            attn_mod, "decode_attention", lambda: decode_steps(
                model, params, cache, tokens, d - SEQ_DECODE_STEPS, dev))
        yard["decode"] = {"logits": logits.float().cpu(),
                          "attn0": attn0.cpu()}
        times["decode_32k"] = {"decode_step_ms": ms}
        del cache
        torch.cuda.empty_cache()

        cfg32, m32, p32 = fp32_model(torch, cfg, SEQ_FP32_LAYERS)
        plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain"))
        prompt = cell_tokens(cfg, 1, SEQ_FP32_PROMPT, seed=5, device=dev)
        yard["fp32"] = {"tokens": generate(
            torch, plain32, p32, prompt, SEQ_FP32_NEW, start=SEQ_FP32_PROMPT,
            max_len=SEQ_FP32_PROMPT + SEQ_FP32_NEW)["tokens"].cpu()}
        del m32, p32, plain32

        moe = full_width_model(torch, cfg=seq_moe_cfg(moe_layers))
        mcfg = dataclasses.replace(moe["model"].cfg, attn_impl="plain")
        mmodel, mparams = build_model(mcfg), bounded_moe(moe["params"])
        b, n = SEQ_MOE_WAVE
        prompts = cell_tokens(mcfg, b, n, seed=6, device=dev)
        with ctx.grouped_as(SEQ_MOE_DEGREE):
            ((logits, cache), host, ms), routes = moe_routes(
                lambda: timed_call(torch, lambda: mmodel.prefill(
                    mparams, mcfg, prompts, n + SEQ_MOE_NEW)))
        steps = cell_tokens(mcfg, b, SEQ_MOE_NEW, seed=7, device=dev)
        (step_logits, step_ms, _), droutes = moe_routes(
            lambda: decode_steps(mmodel, mparams, cache, steps, n, dev))
        yard["moe"] = {
            "logits": logits[:, 0].float().cpu(),
            "steps": step_logits.float().cpu(),
            "ids": [r.expert_ids.cpu() for r in routes],
            "keep": [r.keep.cpu() for r in routes],
            "decode_ids": [r.expert_ids.cpu() for r in droutes],
            "capacity": routes[0].capacity, "init_s": moe["init_s"]}
        times["moe"] = {"prefill_ms": ms, "prefill_s": host,
                        "decode_step_ms": step_ms}
        del moe, mparams, mmodel, cache, logits
        torch.cuda.empty_cache()
    torch.save(yard, path)
    return times


def seq_rows_check(got, want, fault=None) -> dict:
    """An attention output's rows against the single card's within
    BF16_ROW_RTOL; with ``fault``, the planted fault's rows outside it."""
    check = {"row_rel_err": row_rel_err(got.cpu(), want)}
    if fault is not None:
        check["fault_row_rel_err"] = row_rel_err(fault.cpu(), want)
    return check


SPLIT_FAULTS = ("carry_zeroed", "conv_halo_zeroed", "window_halo_dropped")


@contextlib.contextmanager
def planted_split_fault(fault: str):
    """Plant ``fault`` (SPLIT_FAULTS) in this process's boundary exchanges
    of a split prefill (``distributed/ctx.SeqShard``): ``carry_zeroed``,
    the state carried into the last rank's rows zeroed; ``conv_halo_zeroed``,
    the conv input rows before each rank's block zeroed (what a rank that
    took no halo computes); ``window_halo_dropped``, no K/V rows before
    each rank's block (its first rows attend only their own block)."""
    from repro_torch.distributed.ctx import SeqShard

    if fault not in SPLIT_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    real_halo, real_carry = SeqShard.halo, SeqShard.carry

    def halo(self, x, rows, dim=1):
        before, tail = real_halo(self, x, rows, dim)
        if fault == "conv_halo_zeroed" and dim == 1:
            before = before.new_zeros(before.shape)
        if fault == "window_halo_dropped" and dim == 3:
            before = before.narrow(dim, 0, 0)
        return before, tail

    def carry(self, final, log_decay):
        s_in, s_end = real_carry(self, final, log_decay)
        if fault == "carry_zeroed" and self.rank == self.degree - 1:
            s_in = s_in.new_zeros(s_in.shape)
        return s_in, s_end

    SeqShard.halo, SeqShard.carry = halo, carry
    try:
        yield
    finally:
        SeqShard.halo, SeqShard.carry = real_halo, real_carry


# The frontend archs' faults (``planted_frontend_fault``): an encoder
# layer that attends only the rank's own frames; a prefill cross block
# over the rank's own memory block only; rank 0's decode cross partial
# left out of the combine; the token rows placed without the patch rows'
# offset (each rank embeds the tokens F further along).
FRONTEND_FAULTS = ("encoder_own_frames", "cross_own_memory",
                   "cross_partial_dropped", "patch_rows_unshifted")


@contextlib.contextmanager
def planted_frontend_fault(fault: str):
    """Plant ``fault`` (FRONTEND_FAULTS) in this process's split encoder,
    cross blocks or input rows (``models/transformer.py``): each replaces
    one function of the policy's route by its faulty form for the
    duration."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import transformer as tfm

    if fault not in FRONTEND_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    name = {"encoder_own_frames": "attn_block",
            "cross_own_memory": "cross_attn_block",
            "cross_partial_dropped": "cross_attn_decode",
            "patch_rows_unshifted": "_input_rows"}[fault]
    real = getattr(tfm, name)

    def own_frames(*args, kv_rows=None, **kw):
        return real(*args, **kw)

    def own_memory(*args, mem_rows=None, **kw):
        return real(*args, **kw)

    def partial_dropped(params, x, cfg, *, mem_k, mem_v):
        # cross_attn_decode with rank 0's partial left out of the combine
        shard = tfm.seq_shard_state()
        q = tfm._cross_q(params, x, cfg)[:, :, 0]
        c = mem_k.shape[2]
        part = attn_mod.decode_partial(q, mem_k, mem_v, c * shard.degree,
                                       shard.rank * c)
        parts = shard.all_gather(part, "combine")
        o = attn_mod.combine_partials(parts[1:]).reshape(q.shape)
        return o.to(x.dtype).reshape(x.shape[0], 1, -1) \
            @ params["wo"].to(x.dtype)

    def unshifted(tokens, frontend_embeds, rows):
        f = 0 if frontend_embeds is None else frontend_embeds.shape[1]
        return real(tokens.roll(-f, 1), frontend_embeds, rows)

    setattr(tfm, name, {"attn_block": own_frames,
                        "cross_attn_block": own_memory,
                        "cross_attn_decode": partial_dropped,
                        "_input_rows": unshifted}[name])
    try:
        yield
    finally:
        setattr(tfm, name, real)


def fault_touches(fault: str, rank: int, degree: int) -> bool:
    """Whether planted ``fault`` changes rank ``rank``'s rows: the zeroed
    carry the last rank's, a halo fault every rank's but the first (rank
    0 has no rows before it), a frontend fault every rank's (each misses
    the other ranks' frames, memory rows or partial, or embeds shifted
    tokens; a rank holding patch rows only is not planted on)."""
    if fault == "carry_zeroed":
        return rank == degree - 1
    if fault in FRONTEND_FAULTS:
        return True
    return rank > 0


def split_rows_gate(got, want, faulty: dict) -> dict:
    """The layer rows gate of a split prefill: a rank's rows of a layer's
    output against the single card's rows at the same positions
    (``seq_rows_check``), within BF16_ROW_RTOL, and each planted fault's
    rows (``faulty``: fault -> the rank's rows under it; a fault that
    leaves this rank's rows alone, as the zeroed carry on every rank but
    the last, maps to None) outside it. ``ok`` when the rows pass and
    every fault on the rank is rejected."""
    check = seq_rows_check(got, want)
    check["faults"] = {
        name: None if rows is None else row_rel_err(rows.cpu(), want)
        for name, rows in faulty.items()}
    check["ok"] = check["row_rel_err"] <= BF16_ROW_RTOL and all(
        err > BF16_ROW_RTOL for err in check["faults"].values()
        if err is not None)
    return check


def seq_dense_runs(torch, model, params, shard, yard: dict, failures: list
                   ) -> list:
    """internlm2-1.8b on this rank of ``shard``'s group: prefill_32k and
    SEQ_PREFILL_NEW decode steps after it, the planted skipped ring hop,
    decode_32k and its planted dropped partial, and the fp32 run. Appends
    what fails its gate to ``failures``; returns one record a run."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed import ring_attention as ring_mod
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.distributed.sharding import local_params
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import cell_tokens, decode_steps, run_cell
    from repro_torch.models import attention as attn_mod

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    n, r = shard.degree, shard.rank
    s = SHAPES["prefill_32k"].seq_len
    d = SHAPES["decode_32k"].seq_len
    tag = f"rank {r} of {n}"
    runs = []

    def gate(ok: bool, what: str) -> None:
        if not ok:
            failures.append(f"{tag}: {what}")

    # prefill_32k, then decode steps on the split cache
    ops.reset_launch_counts()
    (rec, out), attn0 = first_output(attn_mod, "attention", lambda: run_cell(
        cfg, "prefill_32k", shard, batch=SEQ_PREFILL_BATCH, params=params,
        max_len=s + SEQ_PREFILL_NEW, device=dev))
    launches = launched_kernels(ops.launch_counts())
    rows = slice(r * s // n, (r + 1) * s // n)
    want0 = yard["prefill"]["attn0"][:, :, rows]
    first = seq_logits(out["logits"][:, 0], yard["prefill"]["logits"])
    steps = cell_tokens(cfg, SEQ_PREFILL_BATCH, SEQ_PREFILL_NEW, seed=4,
                        device=dev)
    shard.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        step_logits, step_ms, step_wall = decode_steps(
            model, params, out["cache"], steps, s, dev)
    decode_bytes = dict(shard.sent)
    decode_peak = torch.cuda.max_memory_allocated(dev)
    step_checks = [seq_logits(g, w) for g, w in
                   zip(step_logits, yard["prefill"]["steps"])]
    del out

    # the planted fault: the last rank skips rank 0's block on every layer
    real_hop = ring_mod.attend_hop

    def skip_block0(q, k, v, carry, *, col0, **kw):
        if r == n - 1 and col0 == 0:
            return
        real_hop(q, k, v, carry, col0=col0, **kw)

    tokens = cell_tokens(cfg, SEQ_PREFILL_BATCH, s, seed=1, device=dev)
    ring_mod.attend_hop = skip_block0
    try:
        with torch.no_grad(), sharding_policy(shard, rec["policy"]):
            (flogits, fcache), fattn0 = first_output(
                attn_mod, "attention",
                lambda: model.prefill(params, cfg, tokens, s))
        del fcache              # not to outlive the fault's check
    finally:
        ring_mod.attend_hop = real_hop
    rows_check = seq_rows_check(attn0, want0,
                                fattn0 if r == n - 1 else None)
    fault_logits = seq_logits(flogits[:, 0], yard["prefill"]["logits"])
    gate(first["ok"], f"prefill_32k first-token logits {first}")
    gate(all(c["ok"] for c in step_checks), "prefill_32k decode-step logits "
         f"{[c for c in step_checks if not c['ok']]}")
    gate(rows_check["row_rel_err"] <= BF16_ROW_RTOL,
         f"prefill_32k layer 0 attention rows {rows_check}")
    if r == n - 1:
        gate(rows_check["fault_row_rel_err"] > BF16_ROW_RTOL,
             f"a skipped ring hop passes the rows limit: {rows_check}")
    gate(rec["sent_bytes"]["ring"] > 0 and not launches,
         f"prefill_32k did not take the ring: {rec['sent_bytes']}, "
         f"kernels {launches}")
    runs.append({"run": "prefill_32k", **rec,
                 "first_token_logits": first, "attn0_rows": rows_check,
                 "fault_skipped_hop": {"logits": fault_logits,
                                       "rejected_by_logits":
                                           not fault_logits["ok"]},
                 "decode_steps": len(step_checks),
                 "decode_step_device_ms": step_ms,
                 "decode_step_wall_s": step_wall,
                 "decode_max_abs_err": max(c["max_abs_err"]
                                           for c in step_checks),
                 "decode_sent_bytes": decode_bytes,
                 "decode_peak_mem_bytes": decode_peak,
                 "kernel_launches": launches})
    torch.cuda.empty_cache()

    # decode_32k on a cache of seeded rows, on the rank's tp_sp split of
    # the weights (each layer gathered whole on use), then the dropped
    # partial, then the same cell on whole weights: the same logits bit
    # for bit
    split = local_params(params, rank=r, degree=n, policy="tp_sp")
    ops.reset_launch_counts()
    (rec, out), attn0 = first_output(
        attn_mod, "decode_attention", lambda: run_cell(
            cfg, "decode_32k", shard, batch=SEQ_DECODE_BATCH, params=split,
            steps=SEQ_DECODE_STEPS, device=dev))
    launches = launched_kernels(ops.launch_counts())
    checks = [seq_logits(g, w) for g, w in
              zip(out["logits"], yard["decode"]["logits"])]
    tok0 = cell_tokens(cfg, SEQ_DECODE_BATCH, SEQ_DECODE_STEPS, seed=3,
                       device=dev)[:, :1]
    real_combine = attn_mod.combine_partials
    attn_mod.combine_partials = lambda parts: real_combine(parts[1:])
    try:
        with torch.no_grad(), sharding_policy(shard, rec["policy"]):
            (flogits, fcache), fattn0 = first_output(
                attn_mod, "decode_attention", lambda: model.decode_step(
                    split, cfg, tok0, out["cache"], d - SEQ_DECODE_STEPS))
        del fcache              # the split run's cache: freed below
    finally:
        attn_mod.combine_partials = real_combine
    rows_check = seq_rows_check(attn0, yard["decode"]["attn0"], fattn0)
    fault_logits = seq_logits(flogits[:, 0], yard["decode"]["logits"][0])
    split_logits = out["logits"]
    at_rest = [sum(t.numel() * t.element_size() for t in tensors_of(tree))
               for tree in (split, params)]
    del out, split
    torch.cuda.empty_cache()
    whole, wout = run_cell(cfg, "decode_32k", shard, batch=SEQ_DECODE_BATCH,
                           params=params, steps=SEQ_DECODE_STEPS, device=dev)
    same = bool(torch.equal(split_logits, wout["logits"]))
    weights = SEQ_DECODE_STEPS * weights_gather_bytes(cfg, params, n)
    del wout
    gate(all(c["ok"] for c in checks), "decode_32k step logits "
         f"{[c for c in checks if not c['ok']]}")
    gate(rows_check["row_rel_err"] <= BF16_ROW_RTOL,
         f"decode_32k layer 0 attention rows {rows_check}")
    gate(rows_check["fault_row_rel_err"] > BF16_ROW_RTOL,
         f"a dropped partial passes the rows limit: {rows_check}")
    gate(rec["sent_bytes"]["combine"] > 0 and not launches,
         f"decode_32k did not combine across ranks: {rec['sent_bytes']}, "
         f"kernels {launches}")
    gate(same, "decode_32k logits on split weights differ from the whole "
               "weights'")
    gate(rec["received_bytes"]["weights"] == weights
         and whole["received_bytes"]["weights"] == 0,
         f"decode_32k weight gathers {rec['received_bytes']['weights']} B "
         f"(whole weights {whole['received_bytes']['weights']}), the shapes "
         f"give {weights}")
    runs.append({"run": "decode_32k", **rec, "attn0_rows": rows_check,
                 "max_abs_err": max(c["max_abs_err"] for c in checks),
                 "tol": checks[0]["tol"],
                 "fault_dropped_partial": {"logits": fault_logits,
                                           "rejected_by_logits":
                                               not fault_logits["ok"]},
                 "kernel_launches": launches,
                 "weights": "tp_sp split, gathered a layer at a time; the "
                            "rank keeps its whole tree beside it for the "
                            "phase's other runs, so the peak holds both",
                 "weights_at_rest_bytes": at_rest[0],
                 "weights_bytes_a_step": weights // SEQ_DECODE_STEPS,
                 "whole_weights": {
                     "logits_equal_split": same,
                     "weights_at_rest_bytes": at_rest[1],
                     "peak_mem_bytes": whole["peak_mem_bytes"],
                     "step_device_ms": whole["step_device_ms"],
                     "step_wall_s": whole["step_wall_s"]}})
    torch.cuda.empty_cache()

    # fp32: greedy tokens equal the single card's plain route
    cfg32, m32, p32 = fp32_model(torch, cfg, SEQ_FP32_LAYERS)
    prompt = cell_tokens(cfg, 1, SEQ_FP32_PROMPT, seed=5, device=dev)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        got = generate(torch, m32, p32, prompt, SEQ_FP32_NEW,
                       start=SEQ_FP32_PROMPT,
                       max_len=SEQ_FP32_PROMPT + SEQ_FP32_NEW)["tokens"].cpu()
    same = bool(torch.equal(got, yard["fp32"]["tokens"]))
    gate(same, f"fp32 tokens {got.tolist()} != one card's "
               f"{yard['fp32']['tokens'].tolist()}")
    runs.append({"run": "fp32", "degree": n, "rank": r,
                 "layers": SEQ_FP32_LAYERS, "prompt": SEQ_FP32_PROMPT,
                 "new_tokens": SEQ_FP32_NEW, "tokens_equal_one_card": same,
                 "distinct_tokens": int(got.unique().numel())})
    del m32, p32
    torch.cuda.empty_cache()
    return runs


def weights_gather_bytes(cfg, params, n: int, encoder: bool = True) -> int:
    """Bytes a rank's gathers receive to rebuild ``params``' whole weights
    once from its tp_sp split over ``n`` ranks: (n - 1) / n of every leaf
    ``param_specs`` splits but the routed experts, the embedding twice
    when tied (embedding and unembedding); an encoder's leaves only with
    ``encoder`` (a decode step does not run the encoder)."""
    from repro_torch.distributed.sharding import param_specs
    from repro_torch.tree import leaves_with_paths

    specs = dict(leaves_with_paths(param_specs(params, policy="tp_sp",
                                               degree=n)))
    total = 0
    for path, leaf in leaves_with_paths(params):
        if specs[path] is None or (leaf.ndim == 3 and "ffn/w_" in path):
            continue
        if not encoder and path.startswith("encoder/"):
            continue
        per = leaf.numel() * leaf.element_size() * (n - 1) // n
        total += per * (2 if path == "embed" and cfg.tie_embeddings else 1)
    return total


def seq_moe_run(torch, shard, yard: dict, failures: list,
                layers: int | None = None) -> dict:
    """deepseek-moe-16b on this rank of a degree-SEQ_MOE_DEGREE group, its
    experts and its dense leaves split (``local_params(policy="tp_sp")``;
    the dense leaves gathered whole a layer at a time on use): each rank
    in turn draws the whole model from seed 0 (``layers`` of its
    layers: all, or SEQ_MOE_SHARED_LAYERS where the ranks share a card)
    and keeps its cut; the 4 x 2048 prefill and SEQ_MOE_NEW decode
    steps of seeded tokens, held to the single card's grouped run: each
    layer's dropped assignments in the rank's group within 2·top_k of the
    single card's per token whose top-k set differs (equal where none
    does), and the logits within LOGITS_RTOL. The (token, layer) routes
    that differ are counted: the ring's fp32 softmax and the plain
    route's round the attention output apart, which flips near-tied
    sixth choices of the router."""
    import torch.distributed as dist

    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.distributed.sharding import local_params
    from repro_torch.launch.dryrun import cell_tokens, decode_steps
    from repro_torch.models.api import build_model

    n, r = shard.degree, shard.rank
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = seq_moe_cfg(layers)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = None
    for turn in range(n):
        if turn == r:
            full = full_width_model(torch, cfg=cfg)
            params = local_params(bounded_moe(full["params"]), rank=r,
                                  degree=n, policy="tp_sp")
            del full
            torch.cuda.empty_cache()
        dist.barrier(group=shard.group)
    init_s = time.perf_counter() - t0
    b, s = SEQ_MOE_WAVE
    k = cfg.moe.top_k
    prompts = cell_tokens(cfg, b, s, seed=6, device=dev)
    steps = cell_tokens(cfg, b, SEQ_MOE_NEW, seed=7, device=dev)
    shard.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        ((logits, cache), host, ms), routes = moe_routes(
            lambda: timed_call(torch, lambda: model.prefill(
                params, cfg, prompts, s + SEQ_MOE_NEW)))
        prefill_bytes = dict(shard.sent)
        staged = shard.staged_bytes
        shard.reset_counts()
        (step_logits, step_ms, step_wall), droutes = moe_routes(
            lambda: decode_steps(model, params, cache, steps, s, dev))
    peak = torch.cuda.max_memory_allocated(dev)
    differ, drops, bound_ok = 0, [], True
    for mine, ids, keep in zip(routes, yard["moe"]["ids"],
                               yard["moe"]["keep"], strict=True):
        want_ids = ids[r]
        got_ids = mine.expert_ids.cpu()
        diff = int((got_ids.sort(-1).values
                    != want_ids.sort(-1).values).any(-1).sum())
        got_drop = int((~mine.keep).sum())
        want_drop = int((~keep[r]).sum())
        bound_ok &= abs(got_drop - want_drop) <= 2 * k * diff
        differ += diff
        drops.append((got_drop, want_drop))
    ddiffer = sum(int((a.cpu().sort(-1).values != w.sort(-1).values)
                      .any(-1).sum())
                  for a, w in zip((x.expert_ids for x in droutes),
                                  yard["moe"]["decode_ids"], strict=True))
    first = seq_logits(logits[:, 0], yard["moe"]["logits"])
    checks = [seq_logits(g, w) for g, w in
              zip(step_logits, yard["moe"]["steps"])]
    assignments = b * s // n * k * len(routes)
    tag = f"moe rank {r} of {n}"
    if not bound_ok:
        failures.append(f"{tag}: dropped assignments by layer {drops} "
                        f"beyond 2·top_k of {differ} differing routes")
    if not first["ok"]:
        failures.append(f"{tag}: first-token logits {first}")
    if not all(c["ok"] for c in checks):
        failures.append(f"{tag}: decode-step logits "
                        f"{[c for c in checks if not c['ok']]}")
    return {"run": "moe", "arch": cfg.name, "degree": n, "rank": r,
            "batch": b, "seq_len": s, "new_tokens": SEQ_MOE_NEW,
            "experts_held": cfg.moe.num_experts // n, "init_s": init_s,
            "capacity": routes[0].capacity,
            "one_card_capacity": yard["moe"]["capacity"],
            "dropped_share_group": sum(g for g, _ in drops) / assignments,
            "one_card_dropped_share_group":
                sum(w for _, w in drops) / assignments,
            "routing_differences": differ,
            "decode_routing_differences": ddiffer,
            "first_token_logits": first,
            "decode_max_abs_err": max(c["max_abs_err"] for c in checks),
            "prefill_device_ms": ms, "prefill_wall_s": host,
            "decode_step_device_ms": step_ms,
            "decode_step_wall_s": step_wall,
            "peak_mem_bytes": peak, "prefill_sent_bytes": prefill_bytes,
            "decode_sent_bytes": dict(shard.sent),
            "prefill_staged_bytes": staged}


def coder_plan(torch, ranks_per_card: int) -> dict:
    """The depth and batches of the deepseek-coder-33b run: the most
    layers (up to the arch's 62) at which ``ranks_per_card`` ranks fit the
    free memory of card 0, whole weights at SEQ_CODER_CHECK_BATCH and the
    split weights at SEQ_CODER_BATCH, each with its cache block, a seeded
    layer's draw (fp32 and bf16 rows), a step's two gathered layers, the
    embeddings and the decode partial's fp32 copies, and
    SEQ_CODER_RANK_OVERHEAD, with DENSE_HEADROOM to spare; on a shared
    card at most SEQ_CODER_SHARED_LAYERS."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.models.transformer import init

    cfg = get_arch(SEQ_CODER_ARCH)
    n, s = SEQ_CODER_DEGREE, SHAPES["decode_32k"].seq_len
    shapes = init(cfg, device="meta", dtype=torch.bfloat16)
    size = torch.bfloat16.itemsize

    def nbytes(tree):
        return sum(t.numel() for t in tensors_of(tree)) * size

    layer = nbytes(shapes["layers"][0])
    ends = nbytes({k: v for k, v in shapes.items() if k != "layers"})
    kv_token = 2 * cfg.num_kv_heads * cfg.hd * cfg.compute_dtype.itemsize

    def need(layers: int, batch: int, split: bool) -> int:
        weights = (layers * layer + ends) // (n if split else 1)
        cache = batch * s * layers * kv_token // n
        draw = batch * cfg.num_kv_heads * s * cfg.hd * 6
        step = (2 * layer + ends + batch * cfg.num_kv_heads * (s // n)
                * cfg.hd * 8) if split else 0
        return weights + cache + draw + step + SEQ_CODER_RANK_OVERHEAD

    free = torch.cuda.mem_get_info()[0]
    fits = [depth for depth in range(cfg.num_layers, 0, -1)
            if ranks_per_card * max(
                need(depth, SEQ_CODER_CHECK_BATCH, False),
                need(depth, SEQ_CODER_BATCH, True)) + DENSE_HEADROOM <= free]
    require(bool(fits), f"{SEQ_CODER_ARCH} does not fit {ranks_per_card} "
                        f"ranks in {free} free bytes")
    layers = fits[0]
    if ranks_per_card > 1:
        layers = min(layers, SEQ_CODER_SHARED_LAYERS)
    return {"layers": layers, "fitted_layers": fits[0],
            "full_layers": cfg.num_layers, "batch": SEQ_CODER_BATCH,
            "check_batch": SEQ_CODER_CHECK_BATCH,
            "steps": SEQ_CODER_STEPS if ranks_per_card == 1 else 1,
            "free_bytes": free, "ranks_per_card": ranks_per_card,
            "predicted_peak_bytes": need(layers, SEQ_CODER_BATCH, True),
            "predicted_whole_peak_bytes": need(layers, SEQ_CODER_CHECK_BATCH,
                                               False)}


def seq_coder_run(torch, shard, plan: dict, failures: list) -> dict:
    """deepseek-coder-33b decode_32k at full width on this rank of a
    degree-SEQ_CODER_DEGREE group, ``plan``'s depth (``coder_plan``):
    draw the whole bf16 weights from seed 0, run the cell at the check batch
    on them, cut them in place to the rank's tp_sp split, run it again
    (the logits must be bitwise the whole run's), then at the full batch
    on the split (finite logits). Records each run's peak memory,
    decode-step device ms and bytes by kind."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.sharding import local_params
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.models.api import build_model

    n, r = shard.degree, shard.rank
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dataclasses.replace(get_arch(SEQ_CODER_ARCH),
                              num_layers=plan["layers"])
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    weights = plan["steps"] * weights_gather_bytes(cfg, params, n)

    def cell(batch: int):
        rec, out = run_cell(cfg, "decode_32k", shard, batch=batch,
                            params=params, steps=plan["steps"], device=dev)
        logits = out["logits"]
        del out
        torch.cuda.empty_cache()
        keep = ("peak_mem_bytes", "step_device_ms", "step_wall_s",
                "sent_bytes", "received_bytes", "staged_bytes", "policy")
        return {k: rec[k] for k in keep}, logits

    whole, whole_logits = cell(plan["check_batch"])
    local_params(params, rank=r, degree=n, policy="tp_sp", in_place=True)
    torch.cuda.empty_cache()
    at_rest = sum(t.numel() * t.element_size() for t in tensors_of(params))
    check, check_logits = cell(plan["check_batch"])
    same = bool(torch.equal(check_logits, whole_logits))
    big, logits = cell(plan["batch"])
    finite = bool(logits.isfinite().all())
    tag = f"coder rank {r} of {n}"
    if not same:
        failures.append(f"{tag}: split-weight logits differ from the whole "
                        f"weights' (max {max_err(check_logits, whole_logits)})")
    if not finite:
        failures.append(f"{tag}: logits not finite")
    for name, rec in (("check", check), ("batch", big)):
        if rec["received_bytes"]["weights"] != weights:
            failures.append(f"{tag} {name}: weight gathers "
                            f"{rec['received_bytes']['weights']} B, the "
                            f"shapes give {weights}")
    del params
    torch.cuda.empty_cache()
    return {"run": "coder_decode_32k", "arch": cfg.name, "degree": n,
            "rank": r, **plan,
            "reduced": (None if plan["layers"] == plan["full_layers"] else
                        f"{plan['layers']} of {plan['full_layers']} layers"),
            "init_s": init_s, "weights_at_rest_bytes": at_rest,
            "logits_equal_whole": same, "finite": finite,
            "weights_bytes_a_step": weights // plan["steps"],
            "whole_check": whole, "split_check": check, "split": big}


def first_outputs(targets, run):
    """``run()`` with the first output of each of ``targets`` ((module,
    function name) pairs) kept, the first element of a tuple output:
    (run's result, {function name: that output})."""
    reals, seen = {}, {}

    def wrap(name, real):
        def call(*args, **kw):
            out = real(*args, **kw)
            if name not in seen:
                rows = out[0] if isinstance(out, tuple) else out
                seen[name] = rows.detach().clone()
            return out
        return call

    for module, name in targets:
        reals[module, name] = getattr(module, name)
        setattr(module, name, wrap(name, reals[module, name]))
    try:
        return run(), seen
    finally:
        for (module, name), real in reals.items():
            setattr(module, name, real)


def layer_targets(split: bool) -> list:
    """The functions whose first call gives the first layer of each kind's
    output: the SSD and RG-LRU blocks, and the windowed attention layer
    (``transformer._seq_window`` on the split route, ``attn_block`` on
    one card), keyed ``ssd``, ``rec``, ``attn``."""
    from repro_torch.models import rglru, ssm
    from repro_torch.models import transformer as tfm

    return [(ssm, "ssd_block"), (rglru, "rglru_block"),
            (tfm, "_seq_window" if split else "attn_block")]


LAYER_KEYS = {"ssd_block": "ssd", "rglru_block": "rec", "_seq_window": "attn",
              "attn_block": "attn"}


def keyed(rows: dict) -> dict:
    return {LAYER_KEYS[name]: t for name, t in rows.items()}



def digest(t) -> str:
    """A tensor's values, hashed (fp32 holds a bf16 or fp32 value exactly):
    the same on every rank, or not."""
    import hashlib

    return hashlib.sha256(t.detach().float().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def spec_shapes(cfg, batch: int, max_len: int, degree: int,
                mem_len: int = 0) -> list:
    """Each layer's cache leaf shapes a rank holds by ``cache_specs``
    (dense layout, fitted to ``degree``; an encoder-decoder's memories of
    ``mem_len`` rows too)."""
    from repro_torch.distributed.sharding import cache_specs
    from repro_torch.models.transformer import make_cache

    meta = make_cache(cfg, batch, max_len, device="meta", mem_len=mem_len)
    specs = cache_specs(meta, layout="dense", degree=degree)
    out = []
    for blk, spec in zip(meta["layers"], specs["layers"]):
        shapes = {}
        for name, t in blk.items():
            shape = list(t.shape)
            if spec[name] is not None:
                shape[spec[name]] //= degree
            shapes[name] = tuple(shape)
        out.append(shapes)
    return out


def recurrent_model(torch, arch: str, layers: int | None = None):
    """(cfg, model, params) of ``arch`` at full width, bf16, seed 0, at
    ``layers`` layers (default all): the first layers of the full model's
    draw."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    if layers is not None and layers != cfg.num_layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    full = full_width_model(torch, cfg=cfg)
    return cfg, full["model"], full["params"]


def unit_cut(cfg, params, n_layers: int):
    """(cfg, model, params) of the first ``n_layers`` layers of ``params``
    as a stack of their own kinds (no tail): the planted faults' model."""
    from repro_torch.models.api import build_model

    cut = dataclasses.replace(cfg, num_layers=n_layers, pattern_tail=())
    require(cut.layer_kinds == cfg.layer_kinds[:n_layers],
            f"{cfg.name}: a cut of {n_layers} layers changes their kinds")
    return cut, build_model(cut), dict(params,
                                       layers=params["layers"][:n_layers])


def fault_layers(cfg) -> int:
    """Layers that hold the first of each kind: one SSD layer, or the
    hybrid's (rec, rec, attn)."""
    kinds = cfg.layer_kinds
    return max(kinds.index(k) for k in set(kinds)) + 1


def recurrent_plan(backend: str) -> dict:
    """Depth and weights of the recurrent runs: recurrentgemma-9b at full
    depth on tp_sp split weights with a card a rank; SEQ_HYBRID_SHARED_LAYERS
    on weights held whole where the ranks share one card (gloo gathers
    through host memory: a tp_sp pass of the full model moves 11 GB a
    rank). mamba2-130m at full depth always."""
    from repro_torch.configs import get_arch

    shared = backend != "nccl"
    full = get_arch(HYBRID_ARCH).num_layers
    layers = SEQ_HYBRID_SHARED_LAYERS if shared else full
    return {SSM_ARCH: {"layers": get_arch(SSM_ARCH).num_layers,
                       "split_weights": True, "reduced": None},
            HYBRID_ARCH: {"layers": layers, "split_weights": not shared,
                          "reduced": (f"{layers} of {full} layers: four "
                                      f"ranks share one card over gloo"
                                      if shared else None)}}


def recurrent_yardsticks(torch, path, plan: dict) -> dict:
    """The single card's results the recurrent runs are held to, saved to
    ``path`` (CPU tensors) by arch: each split prefill's first-token
    logits, its first layer of each kind's output, and the logits of
    SEQ_PREFILL_NEW decode steps of seeded tokens after it (mamba2-130m
    at each prompt of SEQ_SSM_PREFILLS, recurrentgemma-9b at prefill_32k
    at ``plan``'s depth), the peak memory of each prefill, decode_32k and
    long_500k from seeded caches (run_cell's seeds at seed 0), and an fp32
    run's greedy tokens and first-token logits at
    SEQ_RECURRENT_FP32_LAYERS layers. Returns the single card's times."""
    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.launch.dryrun import (
        cell_tokens,
        decode_steps,
        seeded_cache,
    )

    dev = torch.device("cuda")
    yard, times = {}, {}
    for arch in (SSM_ARCH, HYBRID_ARCH):
        cfg, model, params = recurrent_model(torch, arch,
                                             plan[arch]["layers"])
        mine, t = {"prefill": {}}, {}
        prompts = ([s for _, s in SEQ_SSM_PREFILLS] if arch == SSM_ARCH
                   else [SHAPES["prefill_32k"].seq_len])
        with torch.no_grad():
            for s in prompts:
                tokens = cell_tokens(cfg, 1, s, seed=1, device=dev)
                torch.cuda.reset_peak_memory_stats(dev)
                ((logits, cache), host, ms), rows = first_outputs(
                    layer_targets(False), lambda: timed_call(
                        torch, lambda: model.prefill(
                            params, cfg, tokens, s + SEQ_PREFILL_NEW)))
                peak = torch.cuda.max_memory_allocated(dev)
                steps = cell_tokens(cfg, 1, SEQ_PREFILL_NEW, seed=4,
                                    device=dev)
                step_logits, step_ms, _ = decode_steps(model, params, cache,
                                                       steps, s, dev)
                mine["prefill"][s] = {
                    "logits": logits[:, 0].float().cpu(),
                    "steps": step_logits.float().cpu(),
                    "rows": {k: v.cpu() for k, v in keyed(rows).items()}}
                t[f"prefill {s}"] = {"prefill_ms": ms, "prefill_s": host,
                                     "peak_mem_bytes": peak,
                                     "decode_step_ms": step_ms}
                del cache, logits, rows
                torch.cuda.empty_cache()
            for name, batch, steps in (
                    ("decode_32k", SEQ_RECURRENT_DECODE_BATCH[arch],
                     SEQ_DECODE_STEPS), ("long_500k", 1, 1)):
                d = SHAPES[name].seq_len
                cache = seeded_cache(cfg, batch, d, d - steps, seed=2,
                                     device=dev)
                tokens = cell_tokens(cfg, batch, steps, seed=3, device=dev)
                logits, ms, _ = decode_steps(model, params, cache, tokens,
                                             d - steps, dev)
                mine[name] = logits.float().cpu()
                t[name] = {"decode_step_ms": ms}
                del cache
                torch.cuda.empty_cache()
            del params, model
            torch.cuda.empty_cache()
            layers = SEQ_RECURRENT_FP32_LAYERS[arch]
            _, m32, p32 = fp32_model(torch, get_arch(arch), layers,
                                     **({"pattern_tail": ()}
                                        if arch == HYBRID_ARCH else {}))
            prompt = cell_tokens(cfg, 1, SEQ_RECURRENT_FP32_PROMPT, seed=5,
                                 device=dev)
            got = generate(torch, m32, p32, prompt, SEQ_FP32_NEW,
                           start=SEQ_RECURRENT_FP32_PROMPT,
                           max_len=SEQ_RECURRENT_FP32_PROMPT + SEQ_FP32_NEW)
            mine["fp32"] = {"tokens": got["tokens"].cpu(),
                            "first_logits": got["first_logits"].cpu()}
            del m32, p32, got
            torch.cuda.empty_cache()
        yard[arch] = mine
        times[arch] = t
    torch.save(yard, path)
    return times


def seq_recurrent_prefill(torch, model, params, shard, s: int, want: dict,
                          fault_cut, failures: list) -> dict:
    """One split prefill of ``s`` seeded tokens (run_cell, batch 1) on this
    rank and SEQ_PREFILL_NEW decode steps of seeded tokens on its split
    states (tp_sp), held to the single card's ``want``: first-token and
    step logits within LOGITS_RTOL, the first layer of each kind's rows
    (``split_rows_gate``; every kind the stack has must be seen) with
    each planted fault of SPLIT_FAULTS that the stack has, run on
    ``fault_cut``'s first layers, rejected; the cache leaves the
    ``cache_specs`` blocks; B8 or B3 launched."""
    from repro_torch.configs import ShapeCell
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import cell_tokens, decode_steps, run_cell

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    n, r = shard.degree, shard.rank
    per = s // n
    tag = f"{cfg.name} {s} rank {r} of {n}"
    cell = ShapeCell(f"prefill_{s}", s, 1, "prefill")
    max_len = s + SEQ_PREFILL_NEW
    ops.reset_launch_counts()
    (rec, out), rows = first_outputs(layer_targets(True), lambda: run_cell(
        cfg, cell, shard, batch=1, params=params, max_len=max_len,
        device=dev))
    launches = dict(ops.launch_counts())
    shapes = [{k: tuple(t.shape) for k, t in blk.items()}
              for blk in out["cache"]["layers"]]
    steps = cell_tokens(cfg, 1, SEQ_PREFILL_NEW, seed=4, device=dev)
    shard.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        step_logits, step_ms, step_wall = decode_steps(
            model, params, out["cache"], steps, s, dev)
    decode_launches = dict(ops.launch_counts())
    decode_bytes = dict(shard.sent)
    decode_peak = torch.cuda.max_memory_allocated(dev)
    first = seq_logits(out["logits"][:, 0], want["logits"])
    checks = [seq_logits(g, w) for g, w in zip(step_logits, want["steps"])]
    logits_digest = digest(torch.cat([out["logits"][:, 0].float(),
                                      step_logits[:, 0].float()]))
    del out
    torch.cuda.empty_cache()

    cut_cfg, cut_model, cut_params = fault_cut
    tokens = cell_tokens(cfg, 1, s, seed=1, device=dev)
    faulty = {}
    kinds = set(cut_cfg.layer_kinds)
    for fault in SPLIT_FAULTS:
        if fault == "window_halo_dropped" and "attn" not in kinds:
            continue
        with torch.no_grad(), sharding_policy(shard, rec["policy"]), \
                planted_split_fault(fault):
            (_, fcache), frows = first_outputs(
                layer_targets(True), lambda: cut_model.prefill(
                    cut_params, cut_cfg, tokens, max_len))
        del fcache
        faulty[fault] = {k: v.cpu() for k, v in keyed(frows).items()}
    gates = {}
    kinds_run = set(cfg.layer_kinds)       # keys of ``keyed``: one a kind
    rows = keyed(rows)
    for fault, frows in faulty.items():
        if not set(frows) >= kinds_run:
            failures.append(f"{tag}: fault {fault} kept rows of "
                            f"{sorted(frows)}, not of {sorted(kinds_run)}")
    for kind, got in rows.items():
        mine = want["rows"][kind][:, r * per:(r + 1) * per]
        on_kind = {f: rows_[kind] if fault_touches(f, r, n) else None
                   for f, rows_ in faulty.items()
                   if (f == "window_halo_dropped") == (kind == "attn")}
        gates[kind] = split_rows_gate(got.cpu(), mine, on_kind)
    kernel = "ssd_intra_chunk" if cfg.family == "ssm" else "flash_e256"
    want_shapes = spec_shapes(cfg, 1, max_len, n)

    def gate(ok: bool, what: str) -> None:
        if not ok:
            failures.append(f"{tag}: {what}")

    gate(set(gates) == kinds_run, f"layer rows kept of {sorted(gates)}, "
                                  f"not of every kind {sorted(kinds_run)}")
    gate(first["ok"], f"first-token logits {first}")
    gate(all(c["ok"] for c in checks), "decode-step logits "
         f"{[c for c in checks if not c['ok']]}")
    for kind, check in gates.items():
        gate(check["ok"], f"layer rows of the first {kind} layer {check}")
    gate(launches.get(kernel, 0) > 0,
         f"{kernel} not launched on the split prefill: {launches}")
    gate(shapes == want_shapes, f"cache leaves {shapes} are not the "
                                f"cache_specs blocks {want_shapes}")
    gate(rec["sent_bytes"]["halo"] > 0 and rec["sent_bytes"]["carry"] > 0,
         f"no halo or carry exchanged: {rec['sent_bytes']}")
    return {"run": f"{cfg.name} prefill {s}", "arch": cfg.name, **rec,
            "layers": cfg.num_layers, "rows_a_rank": per,
            "first_token_logits": first, "layer_rows": gates,
            "decode_steps": len(checks),
            "decode_max_abs_err": max(c["max_abs_err"] for c in checks),
            "decode_argmax_equal": all(c["argmax_equal"] for c in checks),
            "decode_step_device_ms": step_ms, "decode_step_wall_s": step_wall,
            "decode_sent_bytes": decode_bytes,
            "decode_peak_mem_bytes": decode_peak,
            "kernel_launches": launched_kernels(launches),
            "decode_kernel_launches": launched_kernels(decode_launches),
            "cache_leaves": shapes[:fault_layers(cfg)],
            "logits_digest": logits_digest}


def seq_recurrent_decode(torch, model, params, shard, name: str, batch: int,
                         steps: int, want, failures: list) -> dict:
    """Cell ``name`` (decode_32k or long_500k) through run_cell on this
    rank from seeded states (each rank's leaves cut from the whole seeded
    cache) against the single card's decode of the same cache: bit for
    bit for mamba2-130m (every value one rank's arithmetic, gathered),
    within LOGITS_RTOL for recurrentgemma-9b (its windowed layers combine
    the ranks' ring slots in another order than B4), the bitwise verdict
    recorded either way."""
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    ops.reset_launch_counts()
    rec, out = run_cell(cfg, name, shard, batch=batch, params=params,
                        steps=steps, device=dev)
    launches = launched_kernels(ops.launch_counts())
    logits = out["logits"].float().cpu()
    del out
    torch.cuda.empty_cache()
    check = seq_logits(logits, want)
    bitwise = bool(torch.equal(logits, want))
    tag = f"{cfg.name} {name} rank {shard.rank} of {shard.degree}"
    if cfg.family == "ssm" and not bitwise:
        failures.append(f"{tag}: split decode not bitwise the single "
                        f"card's ({check})")
    if not check["ok"]:
        failures.append(f"{tag}: logits {check}")
    kind = "gather" if cfg.family == "ssm" else "combine"
    if not rec["sent_bytes"][kind]:
        failures.append(f"{tag}: no {kind} bytes: {rec['sent_bytes']}")
    return {"run": f"{cfg.name} {name}", "arch": cfg.name, **rec,
            "layers": cfg.num_layers, "logits": check,
            "bitwise_one_card": bitwise, "kernel_launches": launches,
            "logits_digest": digest(logits)}


def seq_recurrent_fp32(torch, arch: str, shard, want: dict,
                       failures: list) -> dict:
    """An fp32 run at SEQ_RECURRENT_FP32_LAYERS layers (norm scales drawn
    so that tokens vary): greedy tokens of a SEQ_RECURRENT_FP32_PROMPT
    prompt split over the ranks equal the single card's, first-token
    logits within SEQ_FP32_RTOL of its largest."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.launch.dryrun import cell_tokens

    dev = torch.device("cuda", torch.cuda.current_device())
    layers = SEQ_RECURRENT_FP32_LAYERS[arch]
    cfg32, m32, p32 = fp32_model(torch, get_arch(arch), layers,
                                 **({"pattern_tail": ()}
                                    if arch == HYBRID_ARCH else {}))
    prompt = cell_tokens(cfg32, 1, SEQ_RECURRENT_FP32_PROMPT, seed=5,
                         device=dev)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        got = generate(torch, m32, p32, prompt, SEQ_FP32_NEW,
                       start=SEQ_RECURRENT_FP32_PROMPT,
                       max_len=SEQ_RECURRENT_FP32_PROMPT + SEQ_FP32_NEW)
    tokens = got["tokens"].cpu()
    first = got["first_logits"].cpu()
    err = max_err(first, want["first_logits"])
    tol = SEQ_FP32_RTOL * max(1.0, float(want["first_logits"].abs().max()))
    same = bool(torch.equal(tokens, want["tokens"]))
    tag = f"{arch} fp32 rank {shard.rank} of {shard.degree}"
    if not same:
        failures.append(f"{tag}: tokens {tokens.tolist()} != one card's "
                        f"{want['tokens'].tolist()}")
    if not err <= tol:
        failures.append(f"{tag}: first-token logits {err} > {tol}")
    del m32, p32, got
    torch.cuda.empty_cache()
    return {"run": f"{arch} fp32", "arch": arch, "degree": shard.degree,
            "rank": shard.rank, "layers": layers,
            "prompt": SEQ_RECURRENT_FP32_PROMPT, "new_tokens": SEQ_FP32_NEW,
            "tokens_equal_one_card": same, "first_logits_max_abs_err": err,
            "tol": tol, "distinct_tokens": int(tokens.unique().numel()),
            "logits_digest": digest(first)}


def seq_warm_up(torch, model, params, shard) -> None:
    """A short split prefill (SEQ_WARM_ROWS a rank), untimed, so that the
    group's first collectives (NCCL builds a communicator on its first
    use), cuBLAS and the kernels' libraries start outside the timed
    runs."""
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.launch.dryrun import cell_tokens

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = cell_tokens(cfg, 1, SEQ_WARM_ROWS * shard.degree, seed=9,
                         device=dev)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        model.prefill(params, cfg, tokens, tokens.shape[1])
    torch.cuda.synchronize(dev)
    shard.reset_counts()


def seq_recurrent_runs(torch, arch: str, groups: dict, yard: dict,
                       plan: dict, failures: list) -> tuple[list, dict]:
    """``arch`` split by sequence on this rank: each split prefill of its
    prompts (mamba2-130m: SEQ_SSM_PREFILLS; recurrentgemma-9b:
    prefill_32k at each degree of SEQ_DEGREES) with its decode steps,
    then decode_32k and long_500k at the largest degree and the fp32 run
    at each degree. tp_sp cells take the rank's split of the weights
    where ``plan`` says so (each degree's cut from the rank's whole
    draw). Returns (one record a run, the kernels' launches on the split
    runs)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, ShapeCell
    from repro_torch.distributed.sharding import local_params
    from repro_torch.launch.steps import choose_policy

    cfg, model, whole = recurrent_model(torch, arch, plan[arch]["layers"])
    split_weights = plan[arch]["split_weights"]
    prompts = (SEQ_SSM_PREFILLS if arch == SSM_ARCH else
               tuple((n, SHAPES["prefill_32k"].seq_len) for n in SEQ_DEGREES))
    runs, launches = [], {"ssd_intra_chunk": 0, "flash_e256": 0}

    def weights(shard, cell):
        """The rank's tree for ``cell`` and what it is."""
        if split_weights and choose_policy(cfg, cell) == "tp_sp":
            return local_params(whole, rank=shard.rank, degree=shard.degree,
                                policy="tp_sp"), "tp_sp split"
        return whole, "whole"

    for n, s in prompts:
        shard = groups[n]
        if shard is not None:
            params, held = weights(shard, ShapeCell("p", s, 1, "prefill"))
            seq_warm_up(torch, model, params, shard)
            cut = unit_cut(cfg, params, fault_layers(cfg))
            run = seq_recurrent_prefill(torch, model, params, shard, s,
                                        yard["prefill"][s], cut, failures)
            for k in launches:
                launches[k] += run["kernel_launches"].get(k, 0)
            runs.append({**run, "weights": held,
                         "reduced": plan[arch]["reduced"]})
            del params, cut
            torch.cuda.empty_cache()
        dist.barrier()
    shard = groups[max(SEQ_DEGREES)]
    if shard is not None:
        for name, batch, steps in (
                ("decode_32k", SEQ_RECURRENT_DECODE_BATCH[arch],
                 SEQ_DECODE_STEPS), ("long_500k", 1, 1)):
            params, held = weights(shard, SHAPES[name])
            runs.append({**seq_recurrent_decode(
                torch, model, params, shard, name, batch, steps, yard[name],
                failures), "weights": held,
                "reduced": plan[arch]["reduced"]})
            del params
            torch.cuda.empty_cache()
    dist.barrier()
    del whole
    torch.cuda.empty_cache()
    for n in SEQ_DEGREES:
        if groups[n] is not None:
            runs.append(seq_recurrent_fp32(torch, arch, groups[n],
                                           yard["fp32"], failures))
        dist.barrier()
    return runs, launches


def frontend_plan(backend: str) -> dict:
    """Depth of the frontend runs by arch: full with a card a rank;
    SEQ_FRONTEND_SHARED_LAYERS (whisper: as many encoder layers) where
    four ranks share one card over gloo (the ring's passes, the gathers
    and the split decode's weight gathers go through host memory)."""
    from repro_torch.configs import get_arch

    out = {}
    for arch in FRONTEND_ARCHS:
        cfg = get_arch(arch)
        shared = backend != "nccl"
        layers = SEQ_FRONTEND_SHARED_LAYERS if shared else cfg.num_layers
        enc = " (and encoder layers)" if cfg.encoder_layers else ""
        out[arch] = {"layers": layers, "reduced": (
            f"{layers} of {cfg.num_layers} layers{enc}: four ranks share one "
            f"card over gloo" if shared else None)}
    return out


def frontend_model(torch, arch: str, layers: int):
    """(cfg, model, params) of ``arch`` at full width, bf16, seed 0, at
    ``layers`` layers (an encoder-decoder: as many encoder layers)."""
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    cut = {"num_layers": layers}
    if cfg.encoder_layers:
        cut["encoder_layers"] = layers
    cfg = dataclasses.replace(cfg, **cut)
    full = full_width_model(torch, cfg=cfg)
    return cfg, full["model"], full["params"]


def frontend_cut(cfg, params):
    """(cfg, model, params) of the first decoder layer of ``params`` (an
    encoder-decoder keeps its whole encoder, whose output the cross
    blocks read): the planted faults' model."""
    from repro_torch.models.api import build_model

    cut = dataclasses.replace(cfg, num_layers=1)
    return cut, build_model(cut), dict(params, layers=params["layers"][:1])


def frontend_batch(cfg, s: int, dev) -> dict:
    """A prefill cell's batch of length ``s`` as ``run_cell`` draws it at
    seed 0 and batch SEQ_PREFILL_BATCH: fp32 frames or patches (seed 4)
    and the tokens (seed 1; a vision cell's s - F)."""
    from repro_torch.launch.dryrun import cell_frames, cell_tokens

    f = cfg.num_frontend_tokens if cfg.frontend == "vision" else 0
    return {"frontend": cell_frames(cfg, SEQ_PREFILL_BATCH, seed=4,
                                    device=dev),
            "tokens": cell_tokens(cfg, SEQ_PREFILL_BATCH, s - f, seed=1,
                                  device=dev)}


def frontend_targets() -> list:
    """The first ``attn_block`` output of a prefill (whisper: encoder
    layer 0, which ``encode`` runs first; internvl2: layer 0, patch rows
    included) and the first ``cross_attn_block`` output (whisper's layer
    0 cross block)."""
    from repro_torch.models import transformer as tfm

    return [(tfm, "attn_block"), (tfm, "cross_attn_block")]


def launches_inside(module, name: str, counter: str, run):
    """``run()`` with the launches of kernel ``counter`` made inside the
    calls of ``module.name`` summed: (run's result, that sum)."""
    from repro_torch.kernels import ops

    real, inside = getattr(module, name), [0]

    def call(*args, **kw):
        before = ops.launch_counts()[counter]
        try:
            return real(*args, **kw)
        finally:
            inside[0] += ops.launch_counts()[counter] - before

    setattr(module, name, call)
    try:
        return run(), inside[0]
    finally:
        setattr(module, name, real)


def frontend_fp32_inputs(cfg, model, params, dev) -> tuple:
    """The fp32 run's prompt (SEQ_FRONTEND_FP32_PROMPT tokens, seed 5),
    ``prefill``'s keyword arguments (whisper: ``encode`` of seeded frames;
    internvl2: seeded patches before the prompt) and the prompt's rows."""
    from repro_torch.launch.dryrun import cell_frames, cell_tokens

    prompt = cell_tokens(cfg, 1, SEQ_FRONTEND_FP32_PROMPT, seed=5,
                         device=dev)
    frames = cell_frames(cfg, 1, seed=6, device=dev)
    if cfg.encoder_layers:
        return prompt, {"encoder_out": model.encode(params, frames)}, \
            SEQ_FRONTEND_FP32_PROMPT
    return prompt, {"frontend_embeds": frames}, \
        SEQ_FRONTEND_FP32_PROMPT + frames.shape[1]


def frontend_fp32_model(torch, arch: str):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch)
    extra = ({"encoder_layers": SEQ_FRONTEND_FP32_LAYERS}
             if cfg.encoder_layers else {})
    return fp32_model(torch, cfg, SEQ_FRONTEND_FP32_LAYERS, **extra)


def frontend_yardsticks(torch, path, plan: dict) -> dict:
    """The single card's results the frontend runs are held to, saved to
    ``path`` (CPU tensors) by arch, at ``plan``'s depth on the kernel
    route: prefill_32k's first-token logits, its ``frontend_targets``
    rows, the logits of SEQ_PREFILL_NEW decode steps of seeded tokens
    after it and the first decode step's layer-0 cross output (whisper);
    decode_32k's SEQ_DECODE_STEPS steps from the seeded cache (run_cell's
    seeds at seed 0); and the fp32 run's greedy tokens and first-token
    logits on the plain route. Returns the single card's times."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import (
        cell_tokens,
        decode_steps,
        seeded_cache,
    )
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm
    from repro_torch.models.api import build_model

    dev = torch.device("cuda")
    s, d = SHAPES["prefill_32k"].seq_len, SHAPES["decode_32k"].seq_len
    yard, times = {}, {}
    for arch in FRONTEND_ARCHS:
        cfg, model, params = frontend_model(torch, arch, plan[arch]["layers"])
        with torch.no_grad():
            batch = frontend_batch(cfg, s, dev)
            step = make_prefill_step(model, s + SEQ_PREFILL_NEW)
            torch.cuda.reset_peak_memory_stats(dev)
            ((logits, cache), host, ms), rows = first_outputs(
                frontend_targets(), lambda: timed_call(
                    torch, lambda: step(params, batch)))
            peak = torch.cuda.max_memory_allocated(dev)
            steps = cell_tokens(cfg, 1, SEQ_PREFILL_NEW, seed=4, device=dev)
            (step_logits, step_ms, _), drows = first_outputs(
                [(tfm, "cross_attn_block")], lambda: decode_steps(
                    model, params, cache, steps, s, dev))
            mine = {"logits": logits[:, 0].float().cpu(),
                    "steps": step_logits.float().cpu(),
                    "rows": {k: v.cpu() for k, v in rows.items()},
                    "cross_dec": {k: v.cpu() for k, v in drows.items()}}
            t = {"prefill_ms": ms, "prefill_s": host, "peak_mem_bytes": peak,
                 "decode_step_ms": step_ms}
            del cache, logits, rows, drows
            torch.cuda.empty_cache()
            cache = seeded_cache(cfg, SEQ_DECODE_BATCH, d,
                                 d - SEQ_DECODE_STEPS, seed=2, device=dev)
            tokens = cell_tokens(cfg, SEQ_DECODE_BATCH, SEQ_DECODE_STEPS,
                                 seed=3, device=dev)
            logits, ms, _ = decode_steps(model, params, cache, tokens,
                                         d - SEQ_DECODE_STEPS, dev)
            mine["decode_32k"] = logits.float().cpu()
            t["decode_32k_step_ms"] = ms
            del cache, params, model
            torch.cuda.empty_cache()
            cfg32, m32, p32 = frontend_fp32_model(torch, arch)
            plain32 = build_model(dataclasses.replace(cfg32,
                                                      attn_impl="plain"))
            prompt, inputs, start = frontend_fp32_inputs(cfg32, plain32,
                                                         p32, dev)
            got = generate(torch, plain32, p32, prompt, SEQ_FP32_NEW,
                           start=start, max_len=start + SEQ_FP32_NEW,
                           **inputs)
            mine["fp32"] = {"tokens": got["tokens"].cpu(),
                            "first_logits": got["first_logits"].cpu()}
            del m32, p32, plain32, got, inputs
            torch.cuda.empty_cache()
        yard[arch] = mine
        times[arch] = t
    torch.save(yard, path)
    return times


def frontend_bytes(cfg, n: int, rank: int, *, batch: int, s: int,
                   max_len: int, steps: int) -> tuple[dict, dict]:
    """(prefill, decode steps) bytes a rank of ``n`` sends by kind, from
    the shapes, counted as ``SeqShard`` counts them (a rank's part times
    n - 1; bf16 activations, fp32 partials): the ring's K/V blocks a
    decoder layer and the last row's logits from their owner where n
    divides the prompt's S rows (patch rows included); each encoder
    layer's K/V and each cross block's memories gathered whole where n
    divides the F frames; a decode step's self-attention partials where
    n divides ``max_len``, and its cross partials where it divides F."""
    from repro_torch.distributed.ctx import KINDS

    pre, dec = dict.fromkeys(KINDS, 0), dict.fromkeys(KINDS, 0)
    hkv, e, bf16, f32 = cfg.num_kv_heads, cfg.hd, 2, 4
    if s % n == 0:
        pre["ring"] = (cfg.num_layers * (n - 1) * 2 * batch * hkv
                       * (s // n) * e * bf16)
        if rank == n - 1:
            pre["bcast"] = (n - 1) * batch * cfg.vocab_size * bf16
    f = cfg.num_frontend_tokens
    mem = cfg.encoder_layers and f % n == 0
    if mem:
        pre["gather"] = ((cfg.encoder_layers + cfg.num_layers) * (n - 1)
                         * 2 * batch * hkv * (f // n) * e * bf16)
    combine = steps * (n - 1) * batch * cfg.num_heads * (e + 2) * f32
    dec["combine"] = cfg.num_layers * combine * (
        (max_len % n == 0) + bool(mem))
    return pre, dec


def seq_frontend_prefill(torch, model, params, shard, want: dict, cut,
                         failures: list) -> dict:
    """prefill_32k (run_cell, batch SEQ_PREFILL_BATCH: whisper's 1500
    frames encoded on each rank's block, internvl2's 256 patch rows in the
    row split) on this rank and SEQ_PREFILL_NEW decode steps of seeded
    tokens on its split cache (tp_sp), held to the single card's
    ``want``: first-token and step logits within LOGITS_RTOL; the
    ``frontend_targets`` rows and the first decode step's layer-0 cross
    output (``split_rows_gate``) with the planted FRONTEND_FAULTS of the
    arch, run on ``cut``, rejected; the cache leaves the ``cache_specs``
    blocks (memories included); the bytes by kind the shapes'; B2 once an
    encoder layer and once a cross block on whisper, no kernel on
    internvl2 (its decoder rows take the ring)."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import cell_tokens, decode_steps, run_cell
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    n, r = shard.degree, shard.rank
    s = SHAPES["prefill_32k"].seq_len
    max_len = s + SEQ_PREFILL_NEW
    f = cfg.num_frontend_tokens
    tag = f"{cfg.name} prefill_32k rank {r} of {n}"
    ops.reset_launch_counts()
    ((rec, out), enc_launches), rows = first_outputs(
        frontend_targets(), lambda: launches_inside(
            tfm, "encode", "mas_streamed", lambda: run_cell(
                cfg, "prefill_32k", shard, batch=SEQ_PREFILL_BATCH,
                params=params, max_len=max_len, device=dev)))
    launches = launched_kernels(ops.launch_counts())
    shapes = [{k: tuple(t.shape) for k, t in blk.items()}
              for blk in out["cache"]["layers"]]
    steps = cell_tokens(cfg, 1, SEQ_PREFILL_NEW, seed=4, device=dev)
    shard.reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        (step_logits, step_ms, step_wall), drows = first_outputs(
            [(tfm, "cross_attn_decode")], lambda: decode_steps(
                model, params, out["cache"], steps, s, dev))
    decode_launches = launched_kernels(ops.launch_counts())
    decode_bytes = dict(shard.sent)
    decode_peak = torch.cuda.max_memory_allocated(dev)
    first = seq_logits(out["logits"][:, 0], want["logits"])
    checks = [seq_logits(g, w) for g, w in zip(step_logits, want["steps"])]
    logits_digest = digest(torch.cat([out["logits"][:, 0].float(),
                                      step_logits[:, 0].float()]))
    del out
    torch.cuda.empty_cache()

    # the planted faults, on the first decoder layer (and, whisper, the
    # whole encoder)
    cut_cfg, cut_model, cut_params = cut
    batch = frontend_batch(cfg, s, dev)
    faults = (("encoder_own_frames", "cross_own_memory",
               "cross_partial_dropped") if cfg.encoder_layers
              else ("patch_rows_unshifted",))
    step = make_prefill_step(cut_model, max_len)
    faulty = {}
    for fault in faults:
        with torch.no_grad(), sharding_policy(shard, rec["policy"]), \
                planted_frontend_fault(fault):
            (_, fcache), frows = first_outputs(
                frontend_targets(), lambda: step(cut_params, batch))
            if fault == "cross_partial_dropped":
                (_, fcache), frows = first_outputs(
                    [(tfm, "cross_attn_decode")],
                    lambda: cut_model.decode_step(
                        cut_params, cut_cfg, steps[:, :1], fcache, s))
        del fcache
        faulty[fault] = {k: v.cpu() for k, v in frows.items()}
    torch.cuda.empty_cache()
    per, mem = s // n, f // n
    at = {"attn_block": slice(r * mem, (r + 1) * mem) if cfg.encoder_layers
          else slice(r * per, (r + 1) * per),
          "cross_attn_block": slice(r * per, (r + 1) * per)}
    on = {"attn_block": ("encoder_own_frames", "patch_rows_unshifted"),
          "cross_attn_block": ("cross_own_memory",),
          "cross_attn_decode": ("cross_partial_dropped",)}
    gates = {}
    for name, got in rows.items():
        gates[name] = split_rows_gate(
            got.cpu(), want["rows"][name][:, at[name]],
            {fl: faulty[fl].get(name) for fl in on[name] if fl in faulty})
    if cfg.encoder_layers:
        gates["cross_attn_decode"] = split_rows_gate(
            drows["cross_attn_decode"].cpu(),
            want["cross_dec"]["cross_attn_block"],
            {"cross_partial_dropped":
             faulty["cross_partial_dropped"]["cross_attn_decode"]})
    want_rows = ({"attn_block", "cross_attn_block", "cross_attn_decode"}
                 if cfg.encoder_layers else {"attn_block"})
    pre, dec = frontend_bytes(cfg, n, r, batch=SEQ_PREFILL_BATCH, s=s,
                              max_len=max_len, steps=SEQ_PREFILL_NEW)
    mem_len = f if cfg.encoder_layers else 0
    want_shapes = spec_shapes(cfg, SEQ_PREFILL_BATCH, max_len, n, mem_len)
    want_launches = ({"mas_streamed": cfg.encoder_layers + cfg.num_layers}
                     if cfg.encoder_layers else {})

    def gate(ok: bool, what: str) -> None:
        if not ok:
            failures.append(f"{tag}: {what}")

    gate(set(gates) == want_rows, f"rows kept of {sorted(gates)}, not of "
                                  f"{sorted(want_rows)}")
    gate(first["ok"], f"first-token logits {first}")
    gate(all(c["ok"] for c in checks), "decode-step logits "
         f"{[c for c in checks if not c['ok']]}")
    for name, check in gates.items():
        gate(check["ok"], f"rows of {name} {check}")
    gate(launches == want_launches
         and enc_launches == (cfg.encoder_layers or 0),
         f"kernels {launches} ({enc_launches} in the encoder), the path "
         f"gives {want_launches}")
    gate(not decode_launches, f"decode steps launched {decode_launches}")
    gate(shapes == want_shapes, f"cache leaves {shapes} are not the "
                                f"cache_specs blocks {want_shapes}")
    gate(rec["sent_bytes"] == pre, f"prefill bytes {rec['sent_bytes']}, "
                                   f"the shapes give {pre}")
    gate(decode_bytes == dec, f"decode bytes {decode_bytes}, the shapes "
                              f"give {dec}")
    return {"run": f"{cfg.name} prefill_32k", "arch": cfg.name, **rec,
            "layers": cfg.num_layers, "encoder_layers": cfg.encoder_layers,
            "rows_a_rank": per, "frames_a_rank": mem if mem_len else None,
            "first_token_logits": first, "layer_rows": gates,
            "decode_steps": len(checks),
            "decode_max_abs_err": max(c["max_abs_err"] for c in checks),
            "decode_argmax_equal": all(c["argmax_equal"] for c in checks),
            "decode_step_device_ms": step_ms, "decode_step_wall_s": step_wall,
            "decode_sent_bytes": decode_bytes,
            "decode_peak_mem_bytes": decode_peak,
            "kernel_launches": launches,
            "b2_launches": {"mas_streamed_enc_rank": enc_launches,
                            "mas_streamed_cross_rank":
                                launches.get("mas_streamed", 0)
                                - enc_launches},
            "cache_leaves": shapes[:1], "logits_digest": logits_digest}


def seq_frontend_decode(torch, model, whole, shard, want, failures: list
                        ) -> dict:
    """decode_32k (run_cell, batch SEQ_DECODE_BATCH, SEQ_DECODE_STEPS
    steps from a seeded cache: whisper's holds each rank's block of the
    1500 memory rows) on the rank's tp_sp split of ``whole``, then on
    ``whole``: logits within LOGITS_RTOL of the single card's, bitwise
    between the two, the combine's and the weight gathers' bytes the
    shapes'."""
    from repro_torch.configs import SHAPES
    from repro_torch.distributed.sharding import local_params
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import run_cell

    cfg = model.cfg
    dev = torch.device("cuda", torch.cuda.current_device())
    n, r = shard.degree, shard.rank
    d = SHAPES["decode_32k"].seq_len
    tag = f"{cfg.name} decode_32k rank {r} of {n}"
    split = local_params(whole, rank=r, degree=n, policy="tp_sp")
    ops.reset_launch_counts()
    rec, out = run_cell(cfg, "decode_32k", shard, batch=SEQ_DECODE_BATCH,
                        params=split, steps=SEQ_DECODE_STEPS, device=dev)
    launches = launched_kernels(ops.launch_counts())
    logits = out["logits"].float().cpu()
    del out, split
    torch.cuda.empty_cache()
    wrec, wout = run_cell(cfg, "decode_32k", shard, batch=SEQ_DECODE_BATCH,
                          params=whole, steps=SEQ_DECODE_STEPS, device=dev)
    same = bool(torch.equal(logits, wout["logits"].float().cpu()))
    del wout
    torch.cuda.empty_cache()
    check = seq_logits(logits, want)
    _, dec = frontend_bytes(cfg, n, r, batch=SEQ_DECODE_BATCH, s=d,
                            max_len=d, steps=SEQ_DECODE_STEPS)
    dec["weights"] = SEQ_DECODE_STEPS * weights_gather_bytes(
        cfg, whole, n, encoder=False)
    for ok, what in (
            (check["ok"], f"logits {check}"),
            (same, "split-weight logits differ from the whole weights'"),
            (not launches, f"kernels launched {launches}"),
            (rec["sent_bytes"] == dec, f"bytes {rec['sent_bytes']}, the "
                                       f"shapes give {dec}"),
            (wrec["sent_bytes"] == dict(dec, weights=0),
             f"whole-weight bytes {wrec['sent_bytes']}")):
        if not ok:
            failures.append(f"{tag}: {what}")
    return {"run": f"{cfg.name} decode_32k", "arch": cfg.name, **rec,
            "layers": cfg.num_layers, "logits": check,
            "logits_equal_whole": same,
            "whole_weights": {k: wrec[k] for k in (
                "peak_mem_bytes", "step_device_ms", "step_wall_s")},
            "kernel_launches": launches, "logits_digest": digest(logits)}


def seq_frontend_fp32(torch, arch: str, shard, want: dict,
                      failures: list) -> dict:
    """The fp32 run at SEQ_FRONTEND_FP32_LAYERS layers (whisper: as many
    encoder layers) on this rank: greedy tokens equal the single card's
    plain route, first-token logits within SEQ_FP32_RTOL of its
    largest."""
    from repro_torch.distributed.ctx import sharding_policy

    dev = torch.device("cuda", torch.cuda.current_device())
    cfg32, m32, p32 = frontend_fp32_model(torch, arch)
    with torch.no_grad(), sharding_policy(shard, "tp_sp"):
        prompt, inputs, start = frontend_fp32_inputs(cfg32, m32, p32, dev)
        got = generate(torch, m32, p32, prompt, SEQ_FP32_NEW, start=start,
                       max_len=start + SEQ_FP32_NEW, **inputs)
    tokens, first = got["tokens"].cpu(), got["first_logits"].cpu()
    err = max_err(first, want["first_logits"])
    tol = SEQ_FP32_RTOL * max(1.0, float(want["first_logits"].abs().max()))
    same = bool(torch.equal(tokens, want["tokens"]))
    tag = f"{arch} fp32 rank {shard.rank} of {shard.degree}"
    if not same:
        failures.append(f"{tag}: tokens {tokens.tolist()} != one card's "
                        f"{want['tokens'].tolist()}")
    if not err <= tol:
        failures.append(f"{tag}: first-token logits {err} > {tol}")
    del m32, p32, got, inputs
    torch.cuda.empty_cache()
    return {"run": f"{arch} fp32", "arch": arch, "degree": shard.degree,
            "rank": shard.rank, "layers": SEQ_FRONTEND_FP32_LAYERS,
            "prompt_rows": start, "new_tokens": SEQ_FP32_NEW,
            "tokens_equal_one_card": same, "first_logits_max_abs_err": err,
            "tol": tol, "distinct_tokens": int(tokens.unique().numel()),
            "logits_digest": digest(first)}


def seq_frontend_runs(torch, arch: str, groups: dict, yard: dict,
                      plan: dict, failures: list) -> tuple[list, dict]:
    """``arch`` (whisper-large-v3 or internvl2-2b) split by sequence on
    this rank at ``plan``'s depth: prefill_32k at each degree of
    SEQ_DEGREES with its decode steps (whole weights; a short untimed
    split prefill first), decode_32k at the largest degree on split and
    whole weights, the fp32 run at each degree. Returns (one record a
    run, B2's launches on the split prefills: all, and those inside the
    encoder and the cross blocks)."""
    import torch.distributed as dist

    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.launch.dryrun import cell_frames, cell_tokens

    cfg, model, params = frontend_model(torch, arch, plan[arch]["layers"])
    cut = frontend_cut(cfg, params)
    dev = torch.device("cuda", torch.cuda.current_device())
    runs = []
    launches = {"mas_streamed": 0, "mas_streamed_enc_rank": 0,
                "mas_streamed_cross_rank": 0}
    for n in SEQ_DEGREES:
        shard = groups[n]
        if shard is not None:
            # untimed warm-up: the group's first collectives, cuBLAS, B2
            kw = {"frontend_embeds": cell_frames(cfg, 1, seed=9, device=dev)}
            if cfg.encoder_layers:
                with torch.no_grad(), sharding_policy(shard, "sp_rep"):
                    kw = {"encoder_out": model.encode(
                        params, kw["frontend_embeds"])}
            tokens = cell_tokens(cfg, 1, SEQ_WARM_ROWS * n, seed=9,
                                 device=dev)
            with torch.no_grad(), sharding_policy(shard, "sp_rep"):
                model.prefill(params, cfg, tokens, 2 * SEQ_WARM_ROWS * n
                              + cfg.num_frontend_tokens, **kw)
            del kw
            torch.cuda.synchronize(dev)
            shard.reset_counts()
            run = seq_frontend_prefill(torch, model, params, shard, yard,
                                       cut, failures)
            launches["mas_streamed"] += run["kernel_launches"].get(
                "mas_streamed", 0)
            for k, v in run["b2_launches"].items():
                launches[k] += v
            runs.append({**run, "reduced": plan[arch]["reduced"]})
            torch.cuda.empty_cache()
        dist.barrier()
    shard = groups[max(SEQ_DEGREES)]
    if shard is not None:
        runs.append({**seq_frontend_decode(torch, model, params, shard,
                                           yard["decode_32k"], failures),
                     "reduced": plan[arch]["reduced"]})
    dist.barrier()
    del params, cut, model
    torch.cuda.empty_cache()
    for n in SEQ_DEGREES:
        if groups[n] is not None:
            runs.append(seq_frontend_fp32(torch, arch, groups[n],
                                          yard["fp32"], failures))
        dist.barrier()
    return runs, launches


def seq_dense_part(torch, rank: int, groups: dict, yard_path: str,
                   checksum: int, plan: dict, failures: list,
                   report: dict) -> None:
    """The dense stacks of the seq_sharded phase on this rank: build
    internlm2-1.8b from seed 0 (its checksum the parent's), run
    ``seq_dense_runs`` (at ``plan["dense_layers"]`` of its layers, where
    given) at each degree of SEQ_DEGREES (ranks past a degree wait), then ranks 0..SEQ_MOE_DEGREE-1 run ``seq_moe_run`` and the
    coder group ``seq_coder_run``. Adds its runs to ``report``."""
    import torch.distributed as dist

    yard = torch.load(yard_path)
    full = full_width_model(torch)
    mine = weights_checksum(torch, full["params"])
    if mine != checksum:
        failures.append(f"rank {rank}: weights checksum {mine} != the "
                        f"parent's {checksum}")
    report["weights_checksum"] = mine
    model, params = ((full["model"], full["params"])
                     if plan.get("dense_layers") is None
                     else cut_depth(full, plan["dense_layers"]))
    for degree in SEQ_DEGREES:
        if groups[degree] is not None:
            report["runs"] += seq_dense_runs(torch, model, params,
                                             groups[degree], yard, failures)
        dist.barrier()
    del model, params
    full.clear()
    torch.cuda.empty_cache()
    if groups[SEQ_MOE_DEGREE] is not None:
        report["runs"].append(seq_moe_run(torch, groups[SEQ_MOE_DEGREE],
                                          yard, failures,
                                          plan.get("moe_layers")))
    dist.barrier()
    torch.cuda.empty_cache()
    if groups[SEQ_CODER_DEGREE] is not None:
        report["runs"].append(seq_coder_run(
            torch, groups[SEQ_CODER_DEGREE], plan, failures))
    dist.barrier()


def pipe_cfg():
    """PIPE_ARCH at full width, PIPE_LAYERS layers, on the kernels."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(PIPE_ARCH), num_layers=PIPE_LAYERS)


def pipe_body(cfg, positions):
    """A pipeline stage's block: ``transformer._layer_train`` on the full
    sequence (the reference's ``apply_block_train``)."""
    from repro_torch.models.transformer import _layer_train

    def body(layer, h):
        return _layer_train(layer, h, cfg, positions, None)[0]
    return body


def pipeline_yardstick(torch, path: str) -> dict:
    """The pipeline part's one-card yardstick, saved to ``path``: ``x``,
    the embedded rows (PIPE_BATCH, PIPE_SEQ, D) of seeded tokens through
    PIPE_LAYERS seed-0 layers' embedding; ``micro``, ``sequential_apply``
    of the layers on each microbatch alone; ``whole``, on the whole
    batch. Returns the two's device ms and the init's seconds."""
    from repro_torch.distributed.pipeline import sequential_apply
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import _embed

    cfg = pipe_cfg()
    t0 = time.perf_counter()
    params = build_model(cfg).init(seed=0, device="cuda",
                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(PIPE_TOKEN_SEED)
    tokens = torch.randint(0, cfg.vocab_size, (PIPE_BATCH, PIPE_SEQ),
                           device="cuda", generator=gen)
    body = pipe_body(cfg, torch.arange(PIPE_SEQ, device="cuda"))
    per = PIPE_BATCH // PIPE_MICROBATCHES
    with torch.no_grad():
        x = _embed(params, tokens, cfg)
        micro, _, micro_ms = timed_call(torch, lambda: torch.stack([
            sequential_apply(params["layers"], x[i * per:(i + 1) * per],
                             body) for i in range(PIPE_MICROBATCHES)]))
        whole, _, whole_ms = timed_call(
            torch, lambda: sequential_apply(params["layers"], x, body))
    torch.save({"x": x, "micro": micro, "whole": whole}, path)
    del params
    torch.cuda.empty_cache()
    return {"init_s": init_s, "microbatches_device_ms": micro_ms,
            "whole_batch_device_ms": whole_ms}


class DroppedHop:
    """``shard`` (a ``SeqShard``) but that on rank ``rank`` its ring pass
    at tick ``tick`` hands back the buffer of the tick before (the bytes
    still move): a pipeline stage that dropped a hop."""

    def __init__(self, shard, rank: int, tick: int):
        self.shard, self.faulty, self.tick = shard, rank, tick
        self.calls, self.prev = 0, None

    def __getattr__(self, name):
        return getattr(self.shard, name)

    def ring_pass(self, tensors, kind="ring"):
        got = self.shard.ring_pass(tensors, kind)()
        if self.calls == self.tick and self.shard.rank == self.faulty:
            got = self.prev
        self.calls += 1
        self.prev = got
        return lambda: got


def pipeline_bytes(x, rank: int, degree: int) -> dict:
    """The bytes by kind a rank of the pipeline sends and receives, from
    the shapes: (M + S - 1) microbatches each way (``pipe``), and the
    last stage's outputs, the size of ``x``, sent to every other rank
    (``bcast``); kinds it does not use left out."""
    whole = x.numel() * x.element_size()
    pipe = (PIPE_MICROBATCHES + degree - 1) * whole // PIPE_MICROBATCHES
    if rank == degree - 1:
        return {"sent": {"pipe": pipe, "bcast": whole * (degree - 1)},
                "received": {"pipe": pipe}}
    return {"sent": {"pipe": pipe}, "received": {"pipe": pipe,
                                                 "bcast": whole}}


def pipeline_rank(torch, shard, path: str, backend: str,
                  failures: list) -> tuple[dict, dict]:
    """This rank's stage of the pipeline part: draw the PIPE_LAYERS
    layers from seed 0 in turn (one whole draw on the card at a time) and
    keep its block (``stage_layers``) and, for a planted fault, the block
    of the stage opposite; then ``pipelined_apply`` on the yardstick's
    ``x``: a run with every attention call held to its plain version
    (``attention_gate``; untimed, also the warm-up), a timed run with the
    launch counts and bytes set to 0 just before and read just after, and
    one run a fault of PIPE_FAULTS. Gates: each microbatch's output bit
    for bit the one-card ``sequential_apply``'s, the bytes by kind
    ``pipeline_bytes``', B2 launched 2 a block, each fault failing the
    first gate. Returns (its record, the timed run's launches)."""
    import types

    import torch.distributed as dist

    from repro_torch.distributed.pipeline import pipelined_apply, stage_layers
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    n, r = shard.degree, shard.rank
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = pipe_cfg()
    mine = opposite = None
    for turn in range(n):
        if turn == r:
            layers = build_model(cfg).init(seed=0, device=dev,
                                           dtype=torch.bfloat16)["layers"]
            mine = stage_layers(layers, shard)
            opposite = stage_layers(layers, types.SimpleNamespace(
                rank=n - 1 - r, degree=n))
            del layers
            torch.cuda.empty_cache()
        dist.barrier(group=shard.group)
    yard = torch.load(path, map_location=dev)
    x = yard["x"]
    want = yard["micro"].reshape(x.shape)
    body = pipe_body(cfg, torch.arange(PIPE_SEQ, device=dev))
    per = PIPE_BATCH // PIPE_MICROBATCHES
    busy = []

    def timed_body(layer, h):           # each block between CUDA events
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = body(layer, h)
        z.record()
        busy.append((a, z))
        return out

    def run(layers, sh=shard, fn=body):
        with torch.no_grad():
            return pipelined_apply(layers, x, fn, sh,
                                   num_microbatches=PIPE_MICROBATCHES)

    def equal_microbatches(y) -> int:
        return sum(bool(torch.equal(y[i * per:(i + 1) * per],
                                    want[i * per:(i + 1) * per]))
                   for i in range(PIPE_MICROBATCHES))

    tag = f"pipeline rank {r} of {n}"
    gated, gate = attention_gate(lambda: run(mine))
    shard.reset_counts()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    measure = backend == "nccl"         # on one card the stages share it
    y, wall, ms = timed_call(torch, lambda: run(
        mine, fn=timed_body if measure else body))
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    sent = {k: v for k, v in shard.sent.items() if v}
    received = {k: v for k, v in shard.received.items() if v}
    predicted = pipeline_bytes(x, r, n)
    equal = equal_microbatches(y)
    if equal != PIPE_MICROBATCHES or not torch.equal(y, gated):
        failures.append(f"{tag}: {equal} of {PIPE_MICROBATCHES} "
                        "microbatches bit for bit the one card's")
    if (sent, received) != (predicted["sent"], predicted["received"]):
        failures.append(f"{tag}: bytes {sent} / {received}, the shapes "
                        f"give {predicted}")
    blocks = len(mine) * PIPE_MICROBATCHES
    if counts["mas_streamed"] != blocks:
        failures.append(f"{tag}: B2 launched {counts['mas_streamed']} "
                        f"times, {blocks} blocks")
    faults = {}
    for fault in PIPE_FAULTS:
        yf = (run(mine, DroppedHop(shard, 1, 1)) if fault == "dropped_hop"
              else run(opposite))
        faults[fault] = {"equal_microbatches": equal_microbatches(yf),
                         "max_abs_err": max_err(yf, want)}
        if faults[fault]["equal_microbatches"] == PIPE_MICROBATCHES:
            failures.append(f"{tag}: the gate passes the fault {fault}")
    stage_ms = (sum(a.elapsed_time(z) for a, z in busy) if measure
                else "not measured")
    rec = {"rank": r, "device": str(dev), "stage_layers": len(mine),
           "equal_microbatches": equal, "bytes_sent": sent,
           "bytes_received": received, "bytes_from_shapes": predicted,
           "device_ms": ms, "wall_s": wall, "peak_mem_bytes": peak,
           "busy_device_ms": stage_ms,
           "bubble_share": ("not measured" if not measure
                            else 1.0 - stage_ms / ms),
           "whole_batch_max_abs_err": max_err(y, yard["whole"]),
           "attention_gate": gate, "faults": faults,
           "launches": launched_kernels(counts)}
    del mine, opposite, yard, x, want, y, gated
    torch.cuda.empty_cache()
    return rec, counts


def pipeline_line(ranks: list, backend: str, one_card: dict) -> dict:
    """The pipeline part's ``{"phase": "pipeline", ...}`` line from each
    rank's record."""
    from repro_torch.configs import get_arch

    s, m = PIPE_DEGREE, PIPE_MICROBATCHES
    full = get_arch(PIPE_ARCH).num_layers
    line = {"phase": "pipeline", "arch": PIPE_ARCH, "degree": s,
            "backend": backend, "cards": s if backend == "nccl" else 1,
            "layers": PIPE_LAYERS, "reduced": f"{PIPE_LAYERS} of {full} "
            f"layers, {PIPE_LAYERS // s} a stage",
            "batch": PIPE_BATCH, "seq": PIPE_SEQ, "microbatches": m,
            "bubble_share_theory": (s - 1) / (m + s - 1),
            "one_card": one_card, "ranks": ranks, "card": nvidia_smi()}
    emit(line)
    return line


# the seq_sharded phase's launch counters: its kernels, and B2's launches
# inside the split encoder and inside the cross blocks
SEQ_COUNTERS = PATH_KERNELS["seq_sharded"] + ("mas_streamed_enc_rank",
                                              "mas_streamed_cross_rank")
# the counters each part of the phase must raise
PART_COUNTERS = {"dense": (), "recurrent": ("ssd_intra_chunk", "flash_e256"),
                 "frontend": ("mas_streamed", "mas_streamed_enc_rank",
                              "mas_streamed_cross_rank"),
                 "pipeline": ()}     # its own count (``pipeline_rank``)


def seq_rank(rank: int, world: int, backend: str, store: str, out_dir: str,
             yard_path: str, checksum: int, plan: dict, rec_path: str,
             rec_plan: dict, front_path: str, front_plan: dict,
             pipe_path: str) -> None:
    """One rank of the seq_sharded phase (a process of its own): join the
    group, run the dense stacks (``seq_dense_part``), then
    ``seq_recurrent_runs`` of mamba2-130m and recurrentgemma-9b
    (``rec_plan``'s depth and weights), then ``seq_frontend_runs`` of
    whisper-large-v3 and internvl2-2b (``front_plan``'s depth), then its
    stage of the pipeline (``pipeline_rank``); a part whose yardsticks'
    path is None is skipped. Writes its report to ``out_dir``, then fails
    on any gate."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import seq_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        groups = {d: seq_group(d) for d in sorted(
            set(SEQ_DEGREES) | {SEQ_MOE_DEGREE, SEQ_CODER_DEGREE,
                                PIPE_DEGREE})}
        failures = []
        report = {"rank": rank, "device": str(dev), "backend": backend,
                  "runs": [], "launches": dict.fromkeys(SEQ_COUNTERS, 0)}
        if yard_path is not None:
            seq_dense_part(torch, rank, groups, yard_path, checksum, plan,
                           failures, report)
        for path, archs, run in (
                (rec_path, (SSM_ARCH, HYBRID_ARCH),
                 lambda arch, y: seq_recurrent_runs(
                     torch, arch, groups, y, rec_plan, failures)),
                (front_path, FRONTEND_ARCHS,
                 lambda arch, y: seq_frontend_runs(
                     torch, arch, groups, y, front_plan, failures))):
            if path is None:
                continue
            yard = torch.load(path)
            for arch in archs:
                runs, counts = run(arch, yard.pop(arch))
                report["runs"] += runs
                for name, count in counts.items():
                    report["launches"][name] += count
                torch.cuda.empty_cache()
                dist.barrier()
        if pipe_path is not None and groups[PIPE_DEGREE] is not None:
            report["pipeline"], counts = pipeline_rank(
                torch, groups[PIPE_DEGREE], pipe_path, backend, failures)
            report["pipeline_launches"] = counts
        report["failures"] = failures
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
        require(not failures, "; ".join(failures))
    finally:
        dist.destroy_process_group()


SEQ_PARTS = ("dense", "recurrent", "frontend", "pipeline")


def phase_seq_sharded(torch, full: dict | None,
                      parts: tuple = SEQ_PARTS) -> dict:
    """Sequence-sharded prefill and decode (the reference's sp_rep/tp_sp
    serving policy) over 2 and 4 ranks, each a process: NCCL with a card
    a rank where the machine has as many cards, else gloo with every rank
    on card 0 (point-to-point sends and all-to-alls through host buffers).
    The single card's results are computed here first
    (``seq_yardsticks``, ``recurrent_yardsticks``,
    ``frontend_yardsticks``); a rank's failure fails the phase
    (``mp.spawn`` raises it here), and so do ranks whose logits differ.
    One line a run and rank group: logits and layer rows against the
    single card, the planted faults' verdicts, device ms and wall of the
    prefill and of a decode step, peak memory and bytes by collective a
    rank. ``parts`` (SEQ_PARTS) picks the dense stacks (internlm2, the
    MoE, the coder: ``full`` is internlm2's model), the recurrent stacks
    and the frontend archs. Returns the launches of B8 and B3 on the
    split recurrent runs and of B2 on the split whisper prefills (inside
    the encoder and the cross blocks too), summed over the ranks."""
    import tempfile

    import torch.multiprocessing as mp

    world = max(SEQ_DEGREES)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    moe_layers = None if backend == "nccl" else SEQ_MOE_SHARED_LAYERS
    dense_layers = None if backend == "nccl" else SEQ_DENSE_SHARED_LAYERS
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        yard_path = checksum = plan = rec_path = rec_plan = None
        front_path = front_plan = pipe_path = None
        t0 = time.perf_counter()
        one_card = {}
        if "dense" in parts:
            checksum = weights_checksum(torch, full["params"])
            yard_path = str(Path(tmp) / "yard.pt")
            one_card = seq_yardsticks(torch, full, yard_path, moe_layers,
                                      dense_layers)
            torch.cuda.empty_cache()
        if "recurrent" in parts:
            rec_path, rec_plan = str(Path(tmp) / "recurrent.pt"), \
                recurrent_plan(backend)
            for arch, times in recurrent_yardsticks(torch, rec_path,
                                                    rec_plan).items():
                one_card.update({f"{arch} {key}": t
                                 for key, t in times.items()})
        if "frontend" in parts:
            front_path, front_plan = str(Path(tmp) / "frontend.pt"), \
                frontend_plan(backend)
            for arch, times in frontend_yardsticks(torch, front_path,
                                                   front_plan).items():
                one_card[f"{arch} prefill_32k"] = times
        if "pipeline" in parts:
            pipe_path = str(Path(tmp) / "pipeline.pt")
            one_card["pipeline"] = pipeline_yardstick(torch, pipe_path)
        yard_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        if "dense" in parts:
            plan = dict(coder_plan(torch, 1 if backend == "nccl"
                                   else SEQ_CODER_DEGREE),
                        moe_layers=moe_layers, dense_layers=dense_layers)
        t0 = time.perf_counter()
        mp.spawn(seq_rank, args=(world, backend, str(Path(tmp) / "store"),
                                 tmp, yard_path, checksum, plan, rec_path,
                                 rec_plan, front_path, front_plan,
                                 pipe_path),
                 nprocs=world, join=True)
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
    lines = []
    keys = sorted({(run["run"], run["degree"]) for rk in ranks
                   for run in rk["runs"]}, key=lambda x: (x[1], x[0]))
    for name, degree in keys:
        per = [run for rk in ranks for run in rk["runs"]
               if (run["run"], run["degree"]) == (name, degree)]
        digests = {run["logits_digest"] for run in per
                   if "logits_digest" in run}
        require(len(digests) <= 1, f"seq_sharded {name} at degree {degree}: "
                                   f"the ranks' logits differ ({digests})")
        line = {"phase": "seq_sharded", "run": name, "degree": degree,
                "backend": backend,
                "cards": degree if backend == "nccl" else 1,
                "ranks": per, "one_card": one_card.get(name)}
        emit(line)
        lines.append(line)
    launches = {name: sum(rk["launches"][name] for rk in ranks)
                for name in SEQ_COUNTERS}
    for part in parts:
        for name in PART_COUNTERS[part]:
            require(launches[name] > 0, f"kernel {name} not launched on "
                                        f"the split {part} runs")
    pipe_launches = dict.fromkeys(PATH_KERNELS["pipeline"], 0)
    if "pipeline" in parts:
        pipeline_line([rk["pipeline"] for rk in ranks], backend,
                      one_card.pop("pipeline"))
        pipe_launches = {name: sum(rk["pipeline_launches"][name]
                                   for rk in ranks) for name in pipe_launches}
        for name, count in pipe_launches.items():
            require(count > 0, f"kernel {name} not launched on the "
                               "pipeline")
    emit({"phase": "seq_sharded", "parts": list(parts),
          "yardsticks_s": yard_s, "spawn_s": spawn_s, "launches": launches,
          "recurrent_plan": rec_plan, "frontend_plan": front_plan,
          "moe_layers": moe_layers or seq_moe_cfg().num_layers,
          "dense_layers": dense_layers})
    return {"phase": "seq_sharded", "runs": lines, "launches": launches,
            "pipeline_launches": pipe_launches}


def decode_step_events(torch, eng) -> list:
    """Wrap the continuous engine ``eng``'s ``_step``: CUDA events around
    each decode-only step, with the step's positions (the host array's
    second B entries; an idle slot's is 0). Returns the list it fills
    with (start event, end event, positions)."""
    real, steps = eng._step, []
    b = eng.batch_size

    def step(cache, host, decode, prefill):
        if not decode or prefill:
            return real(cache, host, decode, prefill)
        a = torch.cuda.Event(enable_timing=True)
        z = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real(cache, host, decode, prefill)
        z.record()
        steps.append((a, z, host[b:2 * b].copy()))
        return out

    eng._step = step
    return steps


def sim_step_cycles(phases: dict, chunk: int) -> tuple[dict, dict]:
    """Simulated cycles of one step of each serving phase on the paper's
    edge NPU (``EDGE_HW``): the best tiling of the sim's own space at the
    pool's native KV width (bf16), by total cycles. A prompt's admission
    is divided by the steps the engine takes for it at ``chunk`` tokens a
    step (the edge device's 5 MB L1 schedules chunks of at most 128).
    Returns (cycles by phase, tiling by phase)."""
    from repro_torch.sim import EDGE_HW, build_schedule, simulate
    from repro_torch.sim.schedules import tiling_space

    methods = {"decode": "paged_decode", "prefill_chunk": "chunked_prefill"}
    cycles, tilings = {}, {}
    for phase, w in phases.items():
        best = None
        for t in tiling_space(w, EDGE_HW):
            if t.kv_bpe not in (None, EDGE_HW.bytes_per_elem):
                continue
            tasks = build_schedule(methods[phase], w, t, EDGE_HW)
            if tasks is None:
                continue
            r = simulate(tasks, EDGE_HW)
            if best is None or r.cycles < best[0].cycles:
                best = (r, t)
        require(best is not None, f"sim: no tiling schedules {phase}")
        r, t = best
        steps = w.n_chunks(chunk) if phase == "prefill_chunk" else 1
        cycles[phase] = r.cycles / steps
        tilings[phase] = {**dataclasses.asdict(t), "steps": steps}
    return cycles, tilings


def phase_calibration(torch, full: dict) -> dict:
    """The continuous phase's serve once more, its first
    CALIBRATION_REQUESTS requests at its settings, with an enabled
    ``Tracer``: the trace must pass ``validate_chrome_trace``; its step
    spans by kind (``measured_phase_stats``) are joined with the sim's
    ``serving_phase_workloads`` of the same prompts on ``EDGE_HW``
    (``compare_report``: the attention of every layer, one layer's
    simulated step times the depth, against the engine's whole step, host
    clock), whose ``decode`` and ``prefill_chunk`` ratios must be finite;
    and the roofline line of the serve's median decode-only step (CUDA
    events around it; its cell: the live slots and their mean keys)."""
    import math

    import numpy as np

    from repro_torch.configs import ShapeCell
    from repro_torch.obs import (
        Tracer,
        compare_report,
        measured_phase_stats,
        validate_chrome_trace,
    )
    from repro_torch.serving import ContinuousBatchingEngine
    from repro_torch.sim import EDGE_HW
    from repro_torch.sim.workload import serving_phase_workloads

    model, params = full["model"], full["params"]
    cfg = model.cfg
    prompts = continuous_prompts(cfg.vocab_size)[:CALIBRATION_REQUESTS]
    tracer = Tracer()
    eng = ContinuousBatchingEngine(model, params, device="cuda",
                                   tracer=tracer, **CONT)
    steps = decode_step_events(torch, eng)
    reqs = make_requests(prompts, CONT_NEW_TOKENS)
    out, wall, counts, peak = serve_path(torch, eng, reqs, "continuous")
    check_served(eng, reqs, out, CONT_NEW_TOKENS, cfg.vocab_size)
    trace = tracer.export()
    errors = validate_chrome_trace(trace)
    require(not errors, f"calibration trace: {errors[:5]}")

    t0 = time.perf_counter()
    phases = serving_phase_workloads(
        cfg.name, [len(p) for p in prompts], CONT_NEW_TOKENS,
        heads=cfg.num_kv_heads, emb=cfg.hd,
        group=cfg.num_heads // cfg.num_kv_heads, batch=CONT["batch_size"])
    cycles, tilings = sim_step_cycles(phases, CONT["chunk_size"])
    sim_s = time.perf_counter() - t0
    report = compare_report(
        measured_phase_stats(trace),
        {p: c * cfg.num_layers for p, c in cycles.items()},
        EDGE_HW.freq_ghz, meta={
            "arch": ARCH, "requests": CALIBRATION_REQUESTS,
            "new_tokens": CONT_NEW_TOKENS, **CONT,
            "measured": "engine step spans (host clock, whole model)",
            "simulated": (f"one layer's attention step on EDGE_HW x "
                          f"{cfg.num_layers} layers"),
            "sim_cycles_per_layer": cycles, "sim_tilings": tilings})
    for phase in ("decode", "prefill_chunk"):
        ratio = report["phases"].get(phase, {}).get("measured_over_sim_mean")
        require(ratio is not None and math.isfinite(ratio),
                f"calibration {phase}: ratio {ratio}")

    require(len(steps) > 0, "calibration: no decode-only step")
    timed = sorted((a.elapsed_time(z), pos) for a, z, pos in steps)
    ms, pos = timed[len(timed) // 2]
    keys = pos[pos > 0].astype(np.int64) + 1
    line = roofline_line(
        ARCH, ShapeCell(f"continuous decode {len(keys)} slots",
                        int(keys.sum()) // len(keys), len(keys), "decode"),
        ms, peak, layers=cfg.num_layers,
        timing=f"CUDA events, median of {len(timed)} decode-only steps "
               "of the traced serve",
        kv_lens=keys.tolist())
    summary = {"phase": "calibration", "requests": CALIBRATION_REQUESTS,
               "wall_s": wall, "trace_events": len(trace["traceEvents"]),
               "trace_errors": len(errors), "sim_s": sim_s,
               "decode_steps_timed": len(timed),
               "launches": launched_kernels(counts), "compare": report,
               "continuous_decode_roofline_share": line["roofline_share"]}
    emit(summary)
    return summary


def phase_launcher(torch) -> dict:
    """``repro_torch.launch.serve.main`` at full width: LAUNCHER_ARCH,
    LAUNCHER_REQUESTS requests of LAUNCHER_NEW_TOKENS (``--max-new``) on
    ``cuda`` (its own init from seed 0, its default prompt length, batch
    and max_len); every request must return ``--max-new`` tokens below
    the vocabulary size, and the wave path's kernels must launch."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    new = LAUNCHER_NEW_TOKENS
    argv = ["--arch", LAUNCHER_ARCH, "--requests", str(LAUNCHER_REQUESTS),
            "--max-new", str(new), "--device", "cuda"]
    vocab = get_arch(LAUNCHER_ARCH).vocab_size
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    require(sorted(out) == list(range(LAUNCHER_REQUESTS)),
            f"launcher: requests {sorted(out)}")
    for rid, toks in out.items():
        require(len(toks) == new and bool(((toks >= 0) & (toks < vocab))
                                          .all()),
                f"launcher rid {rid}: tokens {toks.tolist()}")
    for name in PATH_KERNELS["launcher"]:
        require(counts[name] > 0, f"launcher: kernel {name} not launched")
    report = {"phase": "launcher", "argv": argv, "wall_s": wall,
              "tokens": sum(len(t) for t in out.values()),
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "launches": launched_kernels(counts),
              "dryrun": launcher_dryrun(torch)}
    emit(report)
    return {**report, "launches": counts}


def launcher_dryrun(torch) -> dict:
    """``repro_torch.launch.dryrun.main``, the dry-run command line: its
    abstract mode over every cell at degree DRYRUN_DEGREE (each cell's
    argument bytes a rank and whether they fit the card, printed by the
    command), then ``--run`` of DRYRUN_RUN (cut to DRYRUN_BATCH
    sequences) at degree 1 on ``cuda`` and at degree 2 (NCCL where two
    cards exist, else gloo on card 0). Every cell must have a record, ok
    or skipped, and the runs must succeed with finite logits."""
    import tempfile

    from repro_torch.configs import all_cells
    from repro_torch.launch import dryrun

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rc = dryrun.main(["--degree", str(DRYRUN_DEGREE), "--out", tmp])
        records = {p.stem: json.loads(p.read_text())
                   for p in (Path(tmp) / f"deg{DRYRUN_DEGREE}").glob("*")}
        require(rc == 0 and len(records) == len(list(all_cells()))
                and all(r["ok"] or r.get("skipped")
                        for r in records.values()),
                f"dryrun --abstract: exit {rc}, {len(records)} records")
        out["abstract"] = {
            "wall_s": time.perf_counter() - t0, "cells": len(records),
            "skipped": sum(bool(r.get("skipped")) for r in records.values()),
            "fit": sum(r.get("fits_device_memory") is True
                       for r in records.values())}
        arch, shape = DRYRUN_RUN
        for degree in (1, 2):
            t0 = time.perf_counter()
            rc = dryrun.main(["--run", "--device", "cuda", "--arch", arch,
                              "--shape", shape, "--degree", str(degree),
                              "--batch", str(DRYRUN_BATCH), "--out", tmp])
            rec = json.loads((Path(tmp) / f"deg{degree}"
                              / f"{arch}__{shape}.json").read_text())
            require(rc == 0 and rec["ok"],
                    f"dryrun --run at degree {degree}: exit {rc}, {rec}")
            out[f"run_deg{degree}"] = {
                "wall_s": time.perf_counter() - t0,
                "backend": rec.get("backend"), "policy": rec["policy"],
                "reduced": rec["reduced"],
                "step_device_ms": rec["step_device_ms"],
                "peak_mem_bytes": rec["peak_mem_bytes"],
                "sent_bytes": {k: v for k, v in rec["sent_bytes"].items()
                               if v}}
    return out


def loss_and_grads(torch, model, params, batch):
    """(loss, grads) of ``model.loss_fn`` by ``backward`` on fresh leaf
    copies of ``params``."""
    from repro_torch.tree import tree_map

    params = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                      params)
    loss = model.loss_fn(params, batch)
    loss.backward()
    return float(loss.detach()), tree_map(lambda p: p.grad, params)


def leaf_rel_errs(got, want) -> dict:
    """Each leaf's L2 error against ``want``'s leaf, relative to its
    norm, by path."""
    from repro_torch.tree import leaves_with_paths

    want = dict(leaves_with_paths(want))
    return {path: float((g.double() - want[path].double()).norm()
                        / want[path].double().norm().clamp_min(1e-30))
            for path, g in leaves_with_paths(got)}


def busy_share(torch, fn) -> dict:
    """``fn()`` once under ``torch.profiler`` (CUDA activity): the summed
    device time of its kernels against the call's wall, and the kernels
    that took the most. Run last: a profiler session slows the host's
    later launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if busy_ms == 0:
        return {"busy_share": "not measured", "wall_ms": wall * 1e3}
    return {"wall_ms": wall * 1e3, "kernel_ms": busy_ms,
            "busy_share": busy_ms / (wall * 1e3),
            "top_kernels": [{"name": name[:120], "ms": ms, "calls": n}
                            for ms, name, n in rows[:12]]}


def phase_train(torch) -> dict:
    """Training on the card (see the module docstring, phase 19): the
    full-width, full-depth run, the fp32 gradient check, the kernels'
    refusal, a checkpoint round trip and the trained weights served
    through the kernels."""
    import math
    import tempfile

    import numpy as np

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeCell, get_arch
    from repro_torch.data import SyntheticLMData
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request
    from repro_torch.tree import leaves_with_paths, tree_map

    base = get_arch(ARCH)
    cfg = dataclasses.replace(base, attn_impl="chunked",
                              attn_chunk=TRAIN_CHUNK, remat=True)
    model = build_model(cfg)
    report = {"phase": "train", "arch": ARCH, "layers": cfg.num_layers,
              "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
              "grad_accum": TRAIN_ACCUM, "attn_impl": "chunked",
              "attn_chunk": TRAIN_CHUNK, "remat": True,
              "compression": "int8", "param_dtype": "fp32",
              "compute_dtype": "bf16",
              "reduced": "train_4k's global batch of 256 cut to 4 (2 "
                         "microbatches of 2) to fit one card"}

    # full width and depth
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(seed=0, device="cuda", dtype=torch.float32)
    opt = adamw_init(params)
    opt["err"] = init_error_feedback(params)
    step_fn = make_train_step(
        model, OptConfig(lr=TRAIN_LR, warmup_steps=0,
                         total_steps=TRAIN_STEPS), "int8", TRAIN_ACCUM)
    data = SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                           global_batch=TRAIN_BATCH, seed=17)
    steps = []
    for step in range(TRAIN_STEPS):
        batch = batch_on(data.batch_at(step), "cuda")
        (params, opt, m), wall, ms = timed_call(
            torch, lambda: step_fn(params, opt, batch))
        steps.append({"step": step, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"]), "wall_s": wall, "device_ms": ms,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()})
        print(json.dumps({"phase": "train_step", **steps[-1]}), flush=True)
    losses = [s["loss"] for s in steps]
    require(all(math.isfinite(s["loss"]) and math.isfinite(s["grad_norm"])
                for s in steps), f"train: a loss or grad norm not finite "
                                 f"{steps}")
    require(losses[-1] < losses[0],
            f"train: the last loss {losses[-1]} is not below the first "
            f"{losses[0]}")
    peak = torch.cuda.max_memory_allocated()
    ms_sorted = sorted(s["device_ms"] for s in steps[1:])
    median_ms = ms_sorted[len(ms_sorted) // 2]
    report.update(steps=steps, peak_mem_bytes=peak,
                  step_device_ms_median=median_ms)
    report["mfu"] = roofline_line(
        ARCH, ShapeCell(f"train {TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ,
                        TRAIN_BATCH, "train"), median_ms, peak,
        timing=f"CUDA events, median of steps 1-{TRAIN_STEPS - 1}")["mfu"]
    # one more step under the profiler (no later phase is timed)
    report["busy"] = busy_share(torch, lambda: step_fn(
        params, opt, batch_on(data.batch_at(TRAIN_STEPS), "cuda")))

    # the trained weights through the kernels, under no_grad
    del opt
    torch.cuda.empty_cache()
    kernel_model = build_model(dataclasses.replace(cfg, attn_impl="kernel"))
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(1, n)))
               .to("cuda") for n in TRAIN_PROMPTS]
    ops.reset_launch_counts()
    served = []
    with torch.no_grad():
        for prompt in prompts:
            n = prompt.shape[1]
            got, _ = kernel_model.prefill(params, kernel_model.cfg, prompt, n)
            want, _ = model.prefill(params, cfg, prompt, n)
            require(bool(torch.isfinite(got).all()),
                    f"train: kernel logits at {n} not finite")
            err = row_rel_err(got, want)
            served.append({"prompt_len": n, "row_rel_err": err,
                           "max_abs_err": max_err(got, want),
                           "argmax_equal": bool(got.argmax(-1).eq(
                               want.argmax(-1)).all())})
            require(err <= BF16_ROW_RTOL,
                    f"train: kernel prefill logits at {n}: row error {err}")
        reqs = [Request(rid=i, prompt=rng.integers(
                    3, cfg.vocab_size, size=(TRAIN_PROMPTS[0],))
                    .astype(np.int32), max_new_tokens=TRAIN_NEW_TOKENS,
                    eos_id=-1) for i in range(BATCH)]
        outs = {}
        for name, m_ in (("kernel", kernel_model), ("chunked", model)):
            eng = ServingEngine(m_, params, max_len=TRAIN_PROMPTS[0]
                                + TRAIN_NEW_TOKENS, batch_size=BATCH,
                                device="cuda")
            outs[name] = eng.serve(reqs)
            if name == "kernel":
                counts = ops.launch_counts()
    for r in reqs:
        require(len(outs["kernel"][r.rid]) == TRAIN_NEW_TOKENS,
                f"train: rid {r.rid} served {len(outs['kernel'][r.rid])}")
    for name in PATH_KERNELS["train"]:
        require(counts[name] > 0, f"train: kernel {name} not launched")
    report["trained_through_kernels"] = {
        "prefill_vs_chunked": served, "limit": BF16_ROW_RTOL,
        "serve_token_agreement": agreement(outs["kernel"], outs["chunked"]),
        "launches": launched_kernels(counts)}
    del params, kernel_model, prompts
    torch.cuda.empty_cache()

    # fp32 gradients: "chunked" + remat vs "plain" without it
    cfg32, _, p32 = fp32_model(torch, base)
    chunked32 = build_model(dataclasses.replace(
        cfg32, attn_impl="chunked", attn_chunk=TRAIN_FP32_CHUNK,
        remat=True))
    plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain",
                                              remat=False))
    data32 = SyntheticLMData(vocab_size=cfg.vocab_size,
                             seq_len=TRAIN_FP32_SEQ, global_batch=2,
                             seed=17)
    b32 = batch_on(data32.batch_at(0), "cuda")
    loss_c, g_c = loss_and_grads(torch, chunked32, p32, b32)
    loss_p, g_p = loss_and_grads(torch, plain32, p32, b32)
    errs = leaf_rel_errs(g_c, g_p)
    worst = max(errs, key=errs.get)
    report["fp32_grads"] = {"layers": FP32_LAYERS, "seq": TRAIN_FP32_SEQ,
                            "chunk": TRAIN_FP32_CHUNK,
                            "loss_chunked": loss_c, "loss_plain": loss_p,
                            "worst_leaf": worst,
                            "worst_leaf_rel_err": errs[worst],
                            "limit": TRAIN_GRAD_RTOL}
    require(errs[worst] <= TRAIN_GRAD_RTOL,
            f"train: fp32 gradient of {worst}: {errs[worst]}")
    del g_c, g_p

    # the kernels refuse to be differentiated
    kernel32 = build_model(dataclasses.replace(cfg32, attn_impl="kernel"))
    leaves = tree_map(lambda p: p.detach().clone().requires_grad_(True), p32)
    ops.reset_launch_counts()
    try:
        kernel32.loss_fn(leaves, b32)
        refused = None
    except RuntimeError as exc:
        refused = str(exc)
    require(refused is not None and 'attn_impl="chunked"' in refused,
            f"train: a kernel forward under grad ran ({refused})")
    require(sum(ops.launch_counts().values()) == 0,
            "train: a kernel launched under grad")
    report["refusal"] = refused
    del leaves, kernel32

    # a checkpoint round trip at FP32_LAYERS depth (bf16 compute)
    cfg2 = dataclasses.replace(cfg, num_layers=FP32_LAYERS)
    model2 = build_model(cfg2)
    p2 = model2.init(seed=0, device="cuda", dtype=torch.float32)
    opt2 = adamw_init(p2)
    opt2["err"] = init_error_feedback(p2)
    step2 = make_train_step(model2, OptConfig(lr=TRAIN_LR, warmup_steps=0,
                                              total_steps=TRAIN_STEPS),
                            "int8", TRAIN_ACCUM)
    data2 = SyntheticLMData(vocab_size=cfg.vocab_size,
                            seq_len=TRAIN_FP32_SEQ, global_batch=TRAIN_BATCH,
                            seed=17)
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, keep=2)
        for step in range(2):
            p2, opt2, _ = step2(p2, opt2, batch_on(data2.batch_at(step),
                                                   "cuda"))
        state = {"params": p2, "opt": opt2}
        snapshot = tree_map(lambda t: t.detach().clone(), state)
        t0 = time.perf_counter()
        mgr.save(2, state, blocking=False)
        save_call_s = time.perf_counter() - t0
        p2, opt2, m = step2(p2, opt2, batch_on(data2.batch_at(2), "cuda"))
        want_loss = float(m["loss"])
        t0 = time.perf_counter()
        mgr.wait()
        wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step_found, restored = mgr.restore_latest(state, device="cuda")
        restore_s = time.perf_counter() - t0
        require(step_found == 2, f"train: restored step {step_found}")
        want = dict(leaves_with_paths(snapshot))
        for path, got in leaves_with_paths(restored):
            require(got.dtype == want[path].dtype
                    and torch.equal(got, want[path]),
                    f"train: restored {path} differs")
        _, _, m = step2(restored["params"], restored["opt"],
                        batch_on(data2.batch_at(2), "cuda"))
        resumed_loss = float(m["loss"])
        n_bytes = sum(t.numel() * t.element_size()
                      for _, t in leaves_with_paths(snapshot))
    require(abs(resumed_loss - want_loss) <= TRAIN_RESUME_ATOL,
            f"train: resumed loss {resumed_loss} vs {want_loss}")
    report["checkpoint"] = {
        "layers": FP32_LAYERS, "seq": TRAIN_FP32_SEQ, "bytes": n_bytes,
        "save_call_s": save_call_s, "write_wait_s": wait_s,
        "restore_s": restore_s, "loss_uninterrupted": want_loss,
        "loss_resumed": resumed_loss, "bit_for_bit": True}
    emit(report)
    return {**report, "launches": counts}


# ---------------------------------------------------------------------------
# train_sharded: training across ranks under fsdp
# ---------------------------------------------------------------------------

# the planted faults the fsdp gates must reject (``planted_fsdp_fault``)
FSDP_FAULTS = ("unreduced_layer", "whole_norm_n_times", "shard_int8_scale",
               "rank_loss_mean")
# a checksum's modulus (``state_digest``)
DIGEST_MOD = 2147483647


@contextlib.contextmanager
def planted_fsdp_fault(fault: str, rank: int = 1, layer_leaves: int = 0):
    """Plant one fault of FSDP_FAULTS into the port for the context's
    duration (this process's modules; every collective still runs):
    ``unreduced_layer`` rank ``rank`` keeps its own, unsummed block of
    the gradients of the first layer the backward reaches (its
    ``layer_leaves`` reduce-scatters after the unembedding's, once);
    ``whole_norm_n_times`` the clipping norm all-reduces the whole
    leaves' squares with the split ones' (each counted n times);
    ``shard_int8_scale`` int8 scales from the rank's blocks only;
    ``rank_loss_mean`` each rank divides by its own count of labels."""
    from repro_torch.distributed import compression, ctx
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    if fault not in FSDP_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    saved = []

    def patch(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    if fault == "unreduced_layer":
        real = ctx.GatherLeaf.backward
        calls = {"n": 0}

        def backward(ctx_, grad):
            out = real(ctx_, grad)
            calls["n"] += 1
            shard = ctx_.shard
            if shard.rank == rank and 2 <= calls["n"] <= layer_leaves + 1:
                per = grad.shape[0] // shard.degree
                return (grad.float()[rank * per:(rank + 1) * per],
                        *out[1:])
            return out

        patch(ctx.GatherLeaf, "backward", staticmethod(backward))
    elif fault == "whole_norm_n_times":
        def global_norm(tree, *, shard=None, split=None):
            sq = sum(x.float().square().sum() for x in tensors_of(tree))
            return sq.sqrt() if shard is None else \
                shard.all_reduce(sq, "all_reduce").sqrt()

        patch(adamw, "global_norm", global_norm)
    elif fault == "shard_int8_scale":
        patch(compression, "global_absmax", lambda amax, shard: amax)
    else:
        def token_denominators(labels, grad_accum, shard):
            import torch

            b = labels.shape[0]
            mb = torch.arange(b, device=labels.device) // (b // grad_accum)
            counts = (labels >= 0).sum(-1).float()
            per_mb = counts.new_zeros(grad_accum).index_add_(0, mb, counts)
            return per_mb.clamp(min=1.0)[mb]

        patch(steps, "token_denominators", token_denominators)
    try:
        yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def fsdp_step_gate(got: list, want: list, rtol) -> dict:
    """Each step's loss, grad norm and lr (``got``, ``want``: dicts a
    step) against the one-card run's, relative: the worst of each and
    the failures past ``rtol`` (a number, or one a key)."""
    limits = rtol if isinstance(rtol, dict) else dict.fromkeys(
        ("loss", "grad_norm", "lr"), rtol)
    out = {"limits": limits, "failures": []}
    for key, limit in limits.items():
        errs = [abs(g[key] - w[key]) / max(abs(w[key]), 1e-30)
                for g, w in zip(got, want, strict=True)]
        out[key] = max(errs)
        out["failures"] += [f"step {i} {key} {g[key]} vs {w[key]}"
                            for i, (g, w, e) in enumerate(
                                zip(got, want, errs)) if not e <= limit]
    return out


def fsdp_leaf_errs(torch, params, want, shard) -> dict:
    """Each leaf's L2 error against ``want``'s whole leaf (on the host)
    relative to its norm, over every rank's block: the rank's (err²,
    norm²) of its block of a split leaf (along the dim where its shape
    differs: dim 0 under fsdp, the leaf's own under tp_sp), rank 0's of a
    whole one, summed over the group in one all-reduce -> {path:
    relative error}."""
    from repro_torch.tree import leaves_with_paths

    want = dict(leaves_with_paths(want))
    paths, sums = [], []
    for path, got in leaves_with_paths(params):
        w = want[path]
        mine = shard.rank == 0
        if got.shape != w.shape:       # the rank's block
            dim = next(d for d in range(w.dim())
                       if got.shape[d] != w.shape[d])
            w = w.narrow(dim, shard.rank * got.shape[dim], got.shape[dim])
            mine = True
        w = w.to(got.device).double()
        d = got.detach().double() - w
        sums.append(torch.stack([d.square().sum(), w.square().sum()])
                    * float(mine))
        paths.append(path)
    tot = torch.stack(sums)
    if shard.degree > 1:
        tot = shard.all_reduce(tot, "all_reduce")
    return {p: float(tot[i, 0].sqrt() / tot[i, 1].sqrt().clamp_min(1e-30))
            for i, p in enumerate(paths)}


def gate_margin(step_gate: dict, leaf_gate: dict,
                grad_gate: dict | None = None) -> float:
    """How far a run is past its gates: the largest of its worst step
    metric's, its worst leaf's and (given) its worst gradient leaf's
    error over their limits."""
    return max([step_gate[k] / v for k, v in step_gate["limits"].items()]
               + [g["worst"] / g["limit"] for g in (leaf_gate, grad_gate)
                  if g is not None])


def fsdp_leaves_gate(errs: dict, rtol: float) -> dict:
    worst = max(errs, key=errs.get)
    return {"limit": rtol, "worst_leaf": worst, "worst": errs[worst],
            "failures": [f"leaf {p}: {e}" for p, e in errs.items()
                         if not e <= rtol]}


def fsdp_bytes(cfg, n: int, grad_accum: int, *, int8: bool) -> dict:
    """One train step's bytes a rank sends (and receives) by kind under
    fsdp at degree ``n``, from the shapes (``SeqShard``'s counting): per
    microbatch each split leaf's block gathered in the compute dtype
    once (a layer twice under remat: again in the backward) and
    reduce-scattered in fp32 once, each counting its block × (n - 1);
    per step the all-reduces of the microbatches' label
    counts, of the whole leaves' fp32 gradients, of the loss and of the
    squared norm (2 (n - 1) / n of each, rounded down), and int8's
    absmax of each scale group."""
    from repro_torch.distributed.sharding import split_specs
    from repro_torch.models.transformer import init
    from repro_torch.tree import leaves_with_paths
    from repro_torch.weights import reference_leaf

    out = dict.fromkeys(("weights", "reduce_scatter", "all_reduce",
                         "all_reduce_max"), 0)
    if n == 1:
        return out
    shapes = dict(leaves_with_paths(init(cfg, device="meta")))
    specs = dict(leaves_with_paths(split_specs(cfg, n, "fsdp")))
    gather = scatter = whole = 0
    for path, leaf in shapes.items():
        if specs[path] is None:
            whole += leaf.numel()
            continue
        block = leaf.numel() // n
        stacked = path.startswith(("layers/", "encoder/"))
        gather += (2 if stacked and cfg.remat else 1) * block
        scatter += block
    dt = cfg.compute_dtype.itemsize
    out["weights"] = grad_accum * gather * dt * (n - 1)
    out["reduce_scatter"] = grad_accum * scatter * 4 * (n - 1)

    def ar(nbytes: int) -> int:
        return 2 * nbytes * (n - 1) // n

    out["all_reduce"] = (ar(4 * grad_accum) + (ar(4 * whole) if whole else 0)
                         + ar(4) + ar(4))
    if int8:
        groups = {reference_leaf(p, cfg) for p in shapes}
        out["all_reduce_max"] = ar(4 * len(groups))
    return out


def state_digest(torch, tree, blocks=None, shard=None) -> dict:
    """An exact checksum of each leaf of ``tree``, the same whatever the
    degree it is split at: each element's bits times a weight of its
    index in the whole leaf (row-major), summed mod DIGEST_MOD. With
    ``shard`` a leaf ``blocks`` marks (dim 0, rank, degree) is the rank's
    block of dim 0, whose part is summed over the group."""
    from repro_torch.tree import leaves_with_paths

    blocks = {} if blocks is None else dict(leaves_with_paths(blocks))
    paths, parts, split = [], [], []
    for path, t in leaves_with_paths(tree):
        t = t.detach().contiguous().reshape(-1)
        is_split = (shard is not None and shard.degree > 1
                    and blocks.get(path) is not None)
        start = shard.rank * t.numel() if is_split else 0
        bits = t.view(torch.int32 if t.element_size() == 4
                      else torch.int16).long() & 0xFFFFFFFF
        total = torch.zeros((), dtype=torch.int64, device=t.device)
        step = 1 << 24
        for at in range(0, bits.numel(), step):
            chunk = bits[at:at + step]
            idx = torch.arange(start + at, start + at + chunk.numel(),
                               device=t.device)
            w = (idx * 2654435761) % 65521 + 1
            total += ((chunk * w) % DIGEST_MOD).sum()
        paths.append(path)
        parts.append(total % DIGEST_MOD)
        split.append(is_split)
    vec = torch.stack(parts)
    if any(split):
        mask = torch.tensor(split, device=vec.device)
        vec = torch.where(mask, shard.all_reduce(torch.where(mask, vec, 0),
                                                 "all_reduce"), vec)
    return {p: int(v) % DIGEST_MOD for p, v in zip(paths, vec.tolist())}


# the planted faults the tp_sp gates must reject (``planted_tp_sp_fault``):
# the MoE stack's, then the split recurrent layers', which an MoE stack
# cannot show (RECURRENT_FAULTS: planted into the recurrent stacks' runs,
# each rejected by at least FAULT_MARGIN times a gate's limit; on the card
# the gradient gate of mamba2's fp32 run)
RECURRENT_FAULTS = ("halo_grad_dropped", "carry_grad_dropped")
TP_SP_FAULTS = ("experts_all_reduced", "router_unreduced", "aux_n_times",
                "split_leaf_unreduced") + RECURRENT_FAULTS
FAULT_MARGIN = 10.0


@contextlib.contextmanager
def planted_tp_sp_fault(fault: str, cfg, rank: int = 1):
    """Plant one fault of TP_SP_FAULTS into the port's tp_sp training for
    the context's duration (this process's modules; every collective
    still runs): ``experts_all_reduced`` the rank's experts' gradients
    all-reduced as if every rank held them whole; ``router_unreduced``
    each rank keeps its own part of the router's gradient;
    ``aux_n_times`` each rank adds the group's aux loss (n times its
    term); ``split_leaf_unreduced`` rank ``rank`` keeps its own, unsummed
    block of the first split leaf's gradient the backward reaches;
    ``halo_grad_dropped`` / ``carry_grad_dropped`` every rank drops the
    gradient its halo rows / its scan's carry (final state and log decay)
    got from the other ranks' use of them (the reduce-scatter still
    runs)."""
    from repro_torch.distributed import ctx
    from repro_torch.launch import steps
    from repro_torch.models import moe

    if fault not in TP_SP_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    saved = []

    def patch(module, name, value):
        saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    if fault in ("experts_all_reduced", "router_unreduced"):
        real_sum = steps._sum_whole_grads
        router = (cfg.d_model, cfg.moe.num_experts)

        def sum_whole(leaves, split, shard):
            if fault == "experts_all_reduced":     # the 3-D expert stacks
                split = [s and p.dim() != 3 for p, s in zip(leaves, split)]
            else:
                split = [s or tuple(p.shape) == router
                         for p, s in zip(leaves, split)]
            return real_sum(leaves, split, shard)

        patch(steps, "_sum_whole_grads", sum_whole)
    elif fault == "aux_n_times":
        real_aux = moe.rank_aux_term
        patch(moe, "rank_aux_term",
              lambda r, shard: real_aux(r, shard) * shard.degree)
    elif fault in RECURRENT_FAULTS:
        real = ctx.GatherLeaf.backward
        dropped = fault.split("_")[0]

        def backward(ctx_, grad):
            out = real(ctx_, grad)
            if ctx_.kind != dropped:
                return out
            return (out[0].new_zeros(out[0].shape), *out[1:])

        patch(ctx.GatherLeaf, "backward", staticmethod(backward))
    else:
        real = ctx.GatherLeaf.backward
        calls = {}

        def backward(ctx_, grad):
            out = real(ctx_, grad)
            shard = ctx_.shard
            if ctx_.kind != "weights" or shard.rank != rank:
                return out
            calls[rank] = calls.get(rank, 0) + 1
            if calls[rank] != 1:
                return out
            per = grad.shape[ctx_.dim] // shard.degree
            return (grad.float().narrow(ctx_.dim, rank * per, per)
                    .to(ctx_.dtype), *out[1:])

        patch(ctx.GatherLeaf, "backward", staticmethod(backward))
    try:
        yield
    finally:
        for module, name, value in reversed(saved):
            setattr(module, name, value)


def tp_sp_bytes(cfg, n: int, batch: int, seq: int, *, int8: bool,
                grad_accum: int = 1) -> dict:
    """One train step's bytes a rank sends (and receives) by kind under
    tp_sp at degree ``n`` on a global batch of ``batch`` sequences of
    ``seq`` tokens, from the shapes (``SeqShard``'s counting). The rows
    are the F + ``seq`` of a vision input (F patch rows), else ``seq``,
    split in blocks of L = rows / n where n divides them (else whole on
    every rank, and no row moves); each exchange below counts (n - 1)
    times its per-rank part, a layer's forward exchanges twice under
    remat (again in the backward's recompute), and each backward
    reduce-scatters an fp32 gradient of the gathered shape. Per
    microbatch of b = batch / grad_accum sequences: each split leaf's
    block gathered in the compute dtype (``weights``; a decoder or
    encoder layer's twice under remat) and its fp32 gradient
    reduce-scattered once (``reduce_scatter``). With the rows split: a
    full attention layer's K/V rows (2·b·Hkv·L·E) gathered (``gather``)
    and their gradient reduce-scattered; a windowed layer's K/V halo of
    min(W, L) rows a rank (``halo``, ``halo_grad``); an SSD layer's conv
    halo of min(K - 1, L) rows of its conv channels and its scan carry,
    the final state and log decay of each head (``carry``,
    ``carry_grad``); an RG-LRU layer's halo of min(3, L) rows of its
    width and its carry, state and log decay of each channel; an MoE
    layer's (E, C, D) buffers exchanged twice forward and twice backward
    (``a2a``, (n - 1) / n of each), C = max(4, int(cf · b·L · k / E)),
    and its first-choice density all-reduced. With the rows whole an MoE
    layer gathers its experts' (E/n, C, D) outputs instead (``gather``),
    C from b·rows. An encoder-decoder's encoder layers gather their K/V
    over blocks of F / n frames, and each decoder layer its cross
    memories, (2·b·Hkv·F/n·E), where n divides F. Per step the
    all-reduces of the whole leaves' fp32 gradients, of the loss and of
    the squared norm (2 (n - 1) / n of each, rounded down), and int8's
    absmax of each scale group."""
    from repro_torch.distributed.sharding import (
        split_specs,
        tp_sp_blocks,
        whole_shapes,
    )
    from repro_torch.models.transformer import init
    from repro_torch.tree import leaves_with_paths
    from repro_torch.weights import reference_leaf

    out = dict.fromkeys(("weights", "reduce_scatter", "gather", "a2a",
                         "halo", "halo_grad", "carry", "carry_grad",
                         "all_reduce", "all_reduce_max"), 0)
    if n == 1:
        return out
    shapes = whole_shapes(cfg)
    specs = dict(leaves_with_paths(split_specs(cfg, n)))
    held = dict(leaves_with_paths(tp_sp_blocks(init(cfg, device="meta"),
                                               rank=0, degree=n)))
    again = 2 if cfg.remat else 1
    gather = scatter = whole = 0
    for path, shape in shapes.items():
        numel = 1
        for d in shape:
            numel *= d
        if held[path] is None:
            whole += numel
        if specs[path] is None:
            continue
        stacked = path.startswith(("layers/", "encoder/"))
        gather += (again if stacked else 1) * (numel // n)
        scatter += numel // n
    dt = cfg.compute_dtype.itemsize
    b = batch // grad_accum
    rows = seq + (cfg.num_frontend_tokens if cfg.frontend == "vision" else 0)
    split = rows % n == 0
    per = rows // n
    # elements a rank sends forward (each counted ``again`` times) and
    # gathers whose fp32 gradient it reduce-scatters, by kind
    fwd = dict.fromkeys(("gather", "halo", "carry"), 0)
    kv = 2 * b * cfg.num_kv_heads * cfg.hd
    f = cfg.num_frontend_tokens
    if cfg.encoder_layers and f % n == 0:
        fwd["gather"] += (cfg.encoder_layers + cfg.num_layers) * kv * (f // n)
    m = cfg.moe
    for kind in cfg.layer_kinds:
        if kind == "ssd":
            sc = cfg.ssm
            di = sc.expand * cfg.d_model
            heads = di // sc.head_dim
            if split:
                fwd["halo"] += b * min(sc.conv_width - 1, per) * (
                    di + 2 * sc.n_groups * sc.d_state)
                fwd["carry"] += b * heads * (sc.head_dim * sc.d_state + 1)
        elif kind == "rec":
            w = cfg.lru_width or cfg.d_model
            if split:
                fwd["halo"] += b * min(3, per) * w
                fwd["carry"] += 2 * b * w
        elif split and cfg.attn_window is not None:
            fwd["halo"] += kv * min(cfg.attn_window, per)
        elif split:
            fwd["gather"] += kv * per
        if kind == "attn" and m is not None and not split:
            cap = max(4, int(m.capacity_factor * b * rows * m.top_k
                             / m.num_experts))
            fwd["gather"] += m.num_experts // n * cap * cfg.d_model
    carried = fwd["carry"] * 4          # the carry goes in fp32
    out["weights"] = grad_accum * gather * dt * (n - 1)
    out["reduce_scatter"] = grad_accum * (scatter + fwd["gather"]) * 4 * (
        n - 1)
    out["gather"] = grad_accum * again * fwd["gather"] * dt * (n - 1)
    out["halo"] = grad_accum * again * fwd["halo"] * dt * (n - 1)
    out["halo_grad"] = grad_accum * fwd["halo"] * 4 * (n - 1)
    out["carry"] = grad_accum * again * carried * (n - 1)
    out["carry_grad"] = grad_accum * carried * (n - 1)

    def ar(nbytes: int) -> int:
        return 2 * nbytes * (n - 1) // n

    out["all_reduce"] = ar(4 * whole) + ar(4) + ar(4)
    if m is not None and split:
        cap = max(4, int(m.capacity_factor * (b * per) * m.top_k
                         / m.num_experts))
        buf = m.num_experts * cap * cfg.d_model * dt * (n - 1) // n
        out["a2a"] = grad_accum * cfg.num_layers * (2 * again + 2) * buf
        out["all_reduce"] += grad_accum * cfg.num_layers * again * ar(
            4 * m.num_experts)
    if int8:
        groups = {reference_leaf(p, cfg) for p in shapes}
        out["all_reduce_max"] = ar(4 * len(groups))
    return out


def uneven_labels(batch: dict, rank: int, degree: int) -> dict:
    """``batch`` (a rank's rows, numpy) with, on the last rank, the second
    half of every row's labels masked (-1): unmasked labels lie unevenly
    over the ranks, so a per-rank mean is not the global one."""
    if rank != degree - 1:
        return batch
    labels = batch["labels"].copy()
    labels[:, labels.shape[1] // 2:] = -1
    return {**batch, "labels": labels}


def sharded_batches(data_of, degree: int, step: int, uneven: bool) -> list:
    """The ranks' batches of ``step`` (``data_of(rank)``: a rank's
    ``SyntheticLMData``), as numpy dicts in rank order, labels planted
    unevenly where asked (``uneven_labels``)."""
    out = []
    for r in range(degree):
        b = data_of(r).batch_at(step)
        out.append(uneven_labels(b, r, degree) if uneven else b)
    return out


def concat_batches(parts: list) -> dict:
    import numpy as np

    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def train_sharded_cfg(plan: dict, kind: str = "bf16"):
    """The phase's model config: internlm2-1.8b at full width, ``plan``'s
    depth (fp32 kinds: FP32_LAYERS layers and fp32 compute, through
    ``fp32_model``'s config), chunked attention with remat."""
    from repro_torch.configs import get_arch

    base = get_arch(ARCH)
    if kind != "bf16":
        import torch

        return dataclasses.replace(
            base, num_layers=FP32_LAYERS, compute_dtype=torch.float32,
            attn_impl="chunked", attn_chunk=TRAIN_FP32_CHUNK, remat=True)
    return dataclasses.replace(base, num_layers=plan["layers"],
                               attn_impl="chunked", attn_chunk=TRAIN_CHUNK,
                               remat=True)


def train_sharded_data(cfg, seq: int, batch: int, degree: int):
    """rank -> its ``SyntheticLMData(seed=17)`` of a ``batch`` global
    batch over ``degree`` ranks."""
    from repro_torch.data import SyntheticLMData

    return lambda r: SyntheticLMData(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=17,
        process_index=r, process_count=degree)


def train_sharded_params(torch, cfg, kind: str):
    """fp32 master weights from seed 0 on the current card: the train
    phase's draw (bf16), or ``fp32_model``'s (norm scales from N(0,
    4))."""
    from repro_torch.models.api import build_model

    if kind != "bf16":
        return fp32_model(torch, cfg, FP32_LAYERS)[2]
    return build_model(cfg).init(seed=0, device="cuda", dtype=torch.float32)


def train_sharded_yardstick(torch, plan: dict, kind: str, degree: int,
                            path: str) -> list:
    """The one-card run a sharded run of ``kind`` is held to: the port's
    ``make_train_step`` at the same depth, from the same seed, on the
    ranks' batches concatenated (fp32 kinds: uneven labels), in a rank's
    microbatches (bf16: the same rows a microbatch, so that their bf16
    gradients round alike), or whole (fp32). Saves its
    metrics a step and its trained weights (host) to ``path``; returns
    the metrics."""
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    cfg = train_sharded_cfg(plan, kind)
    seq, batch, steps = train_sharded_run_shape(plan, kind)
    compression = TRAIN_SHARDED_KINDS[kind][1]
    params = train_sharded_params(torch, cfg, kind)
    opt = adamw_init(params)
    if compression == "int8":
        opt["err"] = init_error_feedback(params)
    step_fn = make_train_step(build_model(cfg), train_sharded_opt(steps),
                              compression, 1 if kind != "bf16" else
                              degree * plan["accum"][degree])
    data_of = train_sharded_data(cfg, seq, batch, degree)
    metrics = []
    for step in range(steps):
        b = batch_on(concat_batches(sharded_batches(
            data_of, degree, step, kind != "bf16")), "cuda")
        params, opt, m = step_fn(params, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"metrics": metrics,
                "params": tree_map(lambda t: t.detach().cpu(), params)},
               path)
    del params, opt
    torch.cuda.empty_cache()
    return metrics


def train_sharded_opt(steps: int):
    from repro_torch.optim import OptConfig

    return OptConfig(lr=TRAIN_LR, warmup_steps=0, total_steps=steps)


def train_sharded_run_shape(plan: dict, kind: str) -> tuple:
    """(sequence, global batch, steps) of a run of ``kind``."""
    if kind != "bf16":
        return TRAIN_SHARDED_FP32_SEQ, TRAIN_SHARDED_FP32_BATCH, \
            plan["fp32_steps"][kind]
    return TRAIN_SEQ, plan["batch"], plan["steps"]


def train_sharded_state(cfg, rank: int, degree: int) -> tuple:
    """(the saved state's tree of paths, each leaf's fsdp block on rank
    ``rank`` of ``degree``), from the shapes on the meta device."""
    from repro_torch.launch.train import state_blocks
    from repro_torch.models.transformer import init

    shapes = init(cfg, device="meta")
    blocks = state_blocks(cfg, "int8", rank, degree)
    import torch

    opt = {"mu": shapes, "nu": shapes, "err": shapes,
           "step": torch.zeros((), dtype=torch.int32, device="meta")}
    return {"params": shapes, "opt": opt}, blocks


def sharded_run(torch, plan: dict, shard, dev, kind: str, yard: dict,
                *, fault: str | None = None, ckpt_dir: str | None = None,
                final_dir: str | None = None) -> dict:
    """One fsdp training run of ``kind`` (TRAIN_SHARDED_KINDS) on this rank
    of ``shard``'s group: fp32 master weights from seed 0 cut to the
    rank's blocks, AdamW with the kind's compression, the rank's
    ``SyntheticLMData`` slice a step (``grad_accum`` the plan's at the
    degree; fp32 kinds: uneven labels, whole), under
    ``planted_fsdp_fault(fault)`` where given.
    Each step: loss, grad norm, lr, device ms (CUDA events), wall, peak
    memory, bytes by kind; with ``ckpt_dir`` an async sharded save after
    step TRAIN_SHARDED_SAVE_AT (and the saved state's digest), with
    ``final_dir`` a sharded save of the trained weights. The gates: the
    steps against ``yard``'s metrics (fsdp_step_gate) and every leaf
    against its trained weights (fsdp_leaf_errs)."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.distributed.sharding import local_params
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw_init

    cfg = train_sharded_cfg(plan, kind)
    seq, batch, steps = train_sharded_run_shape(plan, kind)
    compression = TRAIN_SHARDED_KINDS[kind][1]
    n = shard.degree
    accum = 1 if kind != "bf16" else plan["accum"][n]
    params = local_params(train_sharded_params(torch, cfg, kind),
                          rank=shard.rank, degree=n, policy="fsdp",
                          in_place=True)
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    if compression == "int8":
        opt["err"] = init_error_feedback(params)
    step_fn = make_train_step(build_model(cfg), train_sharded_opt(steps),
                              compression, accum)
    data = train_sharded_data(cfg, seq, batch, n)(shard.rank)
    blocks = train_sharded_state(cfg, shard.rank, n)[1]
    ckpt = final = None
    if ckpt_dir is not None:
        # every rank opens the directories before any rank saves
        ckpt = CheckpointManager(ckpt_dir, keep=2, rank=shard.rank,
                                 degree=n)
        final = CheckpointManager(final_dir, keep=1, rank=shard.rank,
                                  degree=n)
        dist.barrier(group=shard.group)
    rec = {"degree": n, "rank": shard.rank, "kind": kind, "fault": fault,
           "layers": cfg.num_layers, "seq": seq, "global_batch": batch,
           "grad_accum": accum, "steps": []}
    fault_ctx = (planted_fsdp_fault(fault, layer_leaves=layer_split_leaves(
        cfg, n)) if fault else contextlib.nullcontext())
    with sharding_policy(shard, "fsdp"), fault_ctx:
        for step in range(steps):
            b = data.batch_at(step)
            if kind != "bf16":
                b = uneven_labels(b, shard.rank, n)
            b = batch_on(b, dev)
            shard.reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            (params, opt, m), wall, ms = timed_call(
                torch, lambda: step_fn(params, opt, b))
            rec["steps"].append({
                **{k: float(v) for k, v in m.items()}, "wall_s": wall,
                "device_ms": ms,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "sent": dict(shard.sent), "received": dict(shard.received),
                "staged_bytes": shard.staged_bytes})
            if ckpt is not None and step + 1 == TRAIN_SHARDED_SAVE_AT:
                state = {"params": params, "opt": opt}
                rec["saved_digest"] = state_digest(torch, state, blocks,
                                                   shard)
                t0 = time.perf_counter()
                ckpt.save(step + 1, state, blocking=False, shardings=blocks)
                rec["save_call_s"] = time.perf_counter() - t0
        if ckpt is not None:
            t0 = time.perf_counter()
            ckpt.wait()
            rec["write_wait_s"] = time.perf_counter() - t0
            final.save(steps, {"params": params},
                       shardings={"params": blocks["params"]})
    want = torch.load(yard["path"], mmap=True)
    steps_limit, leaf_limit = TRAIN_SHARDED_GATES[kind]
    rec["step_gate"] = fsdp_step_gate(rec["steps"], want["metrics"],
                                      steps_limit)
    rec["leaf_gate"] = fsdp_leaves_gate(
        fsdp_leaf_errs(torch, params, want["params"], shard), leaf_limit)
    rec["bytes_from_shapes"] = fsdp_bytes(cfg, n, accum,
                                          int8=compression == "int8")
    del params, opt, want
    torch.cuda.empty_cache()
    return rec


def layer_split_leaves(cfg, n: int) -> int:
    """How many leaves of a decoder layer fsdp splits at degree ``n``."""
    from repro_torch.distributed.sharding import split_specs
    from repro_torch.tree import tree_leaves

    return sum(s is not None for s in tree_leaves(
        split_specs(cfg, n, "fsdp")["layers"][0]))


def restore_check(torch, plan: dict, shard, dev, ckpt_dir: str,
                  saved: dict, want_loss: float | None) -> dict:
    """The degree-4 run's step-TRAIN_SHARDED_SAVE_AT checkpoint restored
    on this rank of ``shard``'s group (or on one card with ``shard``
    None): every leaf's digest against the saved one (bit for bit), and,
    where ``want_loss`` is given, the next step's loss on the degree-4
    ranks' batches of that step, concatenated and cut over this group,
    within TRAIN_RESUME_ATOL of the uninterrupted run's."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model

    cfg = train_sharded_cfg(plan)
    n, rank = (1, 0) if shard is None else (shard.degree, shard.rank)
    paths, blocks = train_sharded_state(cfg, rank, n)
    t0 = time.perf_counter()
    state = CheckpointManager(ckpt_dir, rank=rank, degree=n).restore(
        TRAIN_SHARDED_SAVE_AT, paths, device=dev,
        shardings=blocks if n > 1 else None)
    rec = {"degree": n, "rank": rank,
           "restore_s": time.perf_counter() - t0}
    got = state_digest(torch, state, blocks if n > 1 else None, shard)
    rec["bit_for_bit"] = got == saved
    rec["leaves_differing"] = sorted(p for p in saved if got[p] != saved[p])
    if want_loss is not None:
        _, batch, steps = train_sharded_run_shape(plan, "bf16")
        parts = sharded_batches(train_sharded_data(cfg, TRAIN_SEQ, batch,
                                                   4), 4,
                                TRAIN_SHARDED_SAVE_AT, False)
        per = 4 // n
        mine = concat_batches(parts[rank * per:(rank + 1) * per])
        rows = mine["tokens"].shape[0]
        micro = batch // 4 // plan["accum"][4]    # the degree-4 run's
        step_fn = make_train_step(build_model(cfg), train_sharded_opt(steps),
                                  "int8", rows // micro)
        policy = (contextlib.nullcontext() if shard is None
                  else sharding_policy(shard, "fsdp"))
        with policy:
            _, _, m = step_fn(state["params"], state["opt"],
                              batch_on(mine, dev))
        rec.update(loss_resumed=float(m["loss"]),
                   loss_uninterrupted=want_loss)
        rec["resume_ok"] = abs(float(m["loss"]) - want_loss) \
            <= TRAIN_RESUME_ATOL
    del state
    torch.cuda.empty_cache()
    return rec


def train_sharded_rank(rank: int, world: int, backend: str, store: str,
                       out_dir: str, plan: dict, yards: dict) -> None:
    """One rank of the train_sharded phase (a process of its own): join
    the group, probe its collectives, train at degree 4 (its checkpoint
    after step TRAIN_SHARDED_SAVE_AT, its trained weights saved sharded)
    and at 2, restore the checkpoint at 2 and 3 (the next step's loss at
    2), then at degree 4 the fp32 kinds' clean runs and each planted
    fault (FSDP_FAULTS, on its FAULT_KIND), each of which the gates must
    reject. Rank 0 prints a line a run. Writes its report to
    ``out_dir``, then fails on any gate."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import seq_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        groups = {d: seq_group(d) for d in (2, 3, 4)}
        report = {"rank": rank, "device": str(dev), "backend": backend,
                  "probe": collective_probe(torch, dist, dev, rank, world,
                                            groups[world]),
                  "runs": [], "restores": []}
        failures = []
        ckpt_dir = str(Path(out_dir) / "ckpt")
        final_dir = str(Path(out_dir) / "final")
        uninterrupted = None
        for degree in TRAIN_SHARDED_DEGREES:
            shard = groups[degree]
            if shard is not None:
                four = degree == 4
                rec = sharded_run(
                    torch, plan, shard, dev, "bf16", yards[degree],
                    ckpt_dir=ckpt_dir if four else None,
                    final_dir=final_dir if four else None)
                if four:
                    uninterrupted = rec["steps"][TRAIN_SHARDED_SAVE_AT][
                        "loss"]
                    report["saved_digest"] = rec["saved_digest"]
                failures += train_sharded_failures(rec, f"rank {rank}")
                report["runs"].append(rec)
                run_line(rec)
            dist.barrier()
        for degree in (2, 3):
            shard = groups[degree]
            if shard is not None:
                rec = restore_check(torch, plan, shard, dev, ckpt_dir,
                                    report["saved_digest"],
                                    uninterrupted if degree == 2 else None)
                report["restores"].append(rec)
                failures += [f"rank {rank}: restored at {degree}, leaves "
                             f"{rec['leaves_differing'][:4]} differ"] \
                    if not rec["bit_for_bit"] else []
                failures += [f"rank {rank}: resumed loss "
                             f"{rec['loss_resumed']} vs {uninterrupted}"] \
                    if not rec.get("resume_ok", True) else []
            dist.barrier()
        shard = groups[4]
        for kind in ("fp32", "fp32_int8"):
            for fault in (None,) + tuple(f for f in FSDP_FAULTS
                                         if FAULT_KIND[f] == kind):
                rec = sharded_run(torch, plan, shard, dev, kind,
                                  yards[kind], fault=fault)
                report["runs"].append(rec)
                rejected = bool(rec["step_gate"]["failures"]
                                or rec["leaf_gate"]["failures"])
                rec["rejected"] = rejected
                if fault is None:
                    failures += train_sharded_failures(rec, f"rank {rank}")
                elif not rejected:
                    failures.append(f"rank {rank}: the gates passed the "
                                    f"planted fault {fault}")
                run_line(rec)
        dist.barrier()
        report["failures"] = failures
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
        require(not failures, "; ".join(failures))
    finally:
        dist.destroy_process_group()


def run_line(rec: dict) -> None:
    """Rank 0 prints a run's summary as it ends: its gates and each step's
    wall and device ms."""
    if rec["rank"] == 0:
        emit({"phase": "train_sharded_run", **{
            k: rec[k] for k in ("degree", "kind", "fault")},
            "rejected": rec.get("rejected"),
            "step_gate": rec["step_gate"],
            "leaf_gate": {k: v for k, v in rec["leaf_gate"].items()
                          if k != "failures"},
            "leaf_failures": len(rec["leaf_gate"]["failures"]),
            "wall_s": [s["wall_s"] for s in rec["steps"]],
            "device_ms": [s["device_ms"] for s in rec["steps"]]})


def train_sharded_failures(rec: dict, tag: str) -> list:
    """A run's failed gates: its steps and leaves against the one-card
    run, and its bytes by kind against the shapes' arithmetic, every
    step."""
    tag = f"{tag} degree {rec['degree']} {rec['kind']}"
    out = [f"{tag}: {f}" for f in rec["step_gate"]["failures"]
           + rec["leaf_gate"]["failures"]]
    want = rec["bytes_from_shapes"]
    for i, step in enumerate(rec["steps"]):
        got = {k: step["sent"][k] for k in want}
        out += [f"{tag} step {i}: bytes {got}, the shapes give {want}"] \
            if got != want or got != {k: step["received"][k]
                                      for k in want} else []
    return out


def phase_train_sharded(torch) -> dict:
    """Training across ranks under the reference's fsdp policy (see the
    module docstring, phase 20), one process a rank: NCCL with a card a
    rank where the machine has four cards, else gloo with every rank on
    card 0. The one-card yardsticks are computed here first; a rank's
    failure fails the phase (``mp.spawn`` raises it here). Then the
    degree-4 checkpoint restored on this one card (bit for bit, the next
    loss), and the degree-4 run's trained weights, restored whole, served
    through the kernels as in the train phase."""
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request

    world = max(TRAIN_SHARDED_DEGREES)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    plan = TRAIN_SHARDED_PLANS[backend]
    cfg = train_sharded_cfg(plan)
    torch.cuda.empty_cache()
    report = {"phase": "train_sharded", "arch": ARCH, "backend": backend,
              "cards": world if backend == "nccl" else 1,
              "layers": plan["layers"], "seq": TRAIN_SEQ,
              "global_batch": plan["batch"], "steps": plan["steps"],
              "grad_accum": plan["accum"],
              "compression": "int8", "param_dtype": "fp32",
              "compute_dtype": "bf16", "reduced": plan["reduced"]}
    with tempfile.TemporaryDirectory() as tmp:
        # on disk: two yardsticks' weights, the checkpoint (weights, two
        # moments, error feedback) and the trained weights, fp32
        need = 8 * 4 * cfg.param_count()
        report["disk_free_bytes"] = shutil.disk_usage(tmp).free
        require(report["disk_free_bytes"] > need,
                f"train_sharded: {report['disk_free_bytes']} bytes free under "
                f"{tmp}, {need} needed")
        t0 = time.perf_counter()
        yards = {}
        for degree in TRAIN_SHARDED_DEGREES:
            path = str(Path(tmp) / f"yard{degree}.pt")
            yards[degree] = {"path": path, "metrics": train_sharded_yardstick(
                torch, plan, "bf16", degree, path)}
        for kind in ("fp32", "fp32_int8"):
            path = str(Path(tmp) / f"yard_{kind}.pt")
            yards[kind] = {"path": path, "metrics": train_sharded_yardstick(
                torch, plan, kind, 4, path)}
        report["yardsticks_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.spawn(train_sharded_rank,
                 args=(world, backend, str(Path(tmp) / "store"), tmp, plan,
                       yards),
                 nprocs=world, join=True)
        report["spawn_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
        uninterrupted = next(run["steps"][TRAIN_SHARDED_SAVE_AT]["loss"]
                             for run in ranks[0]["runs"]
                             if run["degree"] == 4 and run["kind"] == "bf16")
        one = restore_check(torch, plan, None, torch.device("cuda"),
                            str(Path(tmp) / "ckpt"),
                            ranks[0]["saved_digest"], uninterrupted)
        require(one["bit_for_bit"], f"train_sharded: restored on one card, "
                                    f"leaves {one['leaves_differing'][:4]} "
                                    f"differ")
        require(one["resume_ok"], f"train_sharded: resumed loss on one card "
                                  f"{one['loss_resumed']} vs {uninterrupted}")
        params = CheckpointManager(str(Path(tmp) / "final")).restore(
            plan["steps"], {"params": init(cfg, device="meta")},
            device="cuda")["params"]
    for degree in TRAIN_SHARDED_DEGREES:
        runs = [run for rk in ranks for run in rk["runs"]
                if run["degree"] == degree and run["kind"] == "bf16"]
        losses = {json.dumps([s["loss"] for s in run["steps"]])
                  for run in runs}
        require(len(losses) == 1, f"train_sharded degree {degree}: the "
                                  f"ranks' losses differ ({losses})")
        ms = sorted(s["device_ms"] for s in runs[0]["steps"][1:])
        line = {"phase": "train_sharded", "run": f"degree {degree}",
                "backend": backend, "one_card": yards[degree]["metrics"],
                "ranks": [{k: v for k, v in run.items()
                           if k != "saved_digest"} for run in runs]}
        line["mfu"] = roofline_line(
            ARCH, ShapeCell(f"train {plan['batch']}x{TRAIN_SEQ}", TRAIN_SEQ,
                            plan["batch"], "train"), ms[len(ms) // 2],
            max(s["peak_mem_bytes"] for run in runs for s in run["steps"]),
            layers=plan["layers"], timing=f"CUDA events, rank 0's median "
            f"of steps 1-{plan['steps'] - 1}, degree {degree}")["mfu"]
        emit(line)
    fp32 = {f"{run['kind']} {run['fault'] or 'clean'}": {
        "rejected": run["rejected"], "step_gate": run["step_gate"],
        "leaf_gate": {k: v for k, v in run["leaf_gate"].items()
                      if k != "failures"}}
        for run in ranks[0]["runs"] if run["kind"] != "bf16"}
    emit({"phase": "train_sharded", "run": "fp32 and planted faults",
          "degree": 4, "layers": FP32_LAYERS, "seq": TRAIN_SHARDED_FP32_SEQ,
          "one_card": {k: yards[k]["metrics"] for k in ("fp32", "fp32_int8")},
          "runs": fp32})
    emit({"phase": "train_sharded", "run": "checkpoint",
          "restores": [r for rk in ranks for r in rk["restores"]] + [one],
          "probe": [rk["probe"] for rk in ranks]})

    # the trained weights, gathered whole, through the kernels
    kernel_model = build_model(dataclasses.replace(cfg, attn_impl="kernel"))
    model = build_model(cfg)
    rng = np.random.default_rng(7)
    prompts = [torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(1, n)))
               .to("cuda") for n in TRAIN_PROMPTS]
    ops.reset_launch_counts()
    served = []
    with torch.no_grad():
        for prompt in prompts:
            n = prompt.shape[1]
            got, _ = kernel_model.prefill(params, kernel_model.cfg, prompt, n)
            want, _ = model.prefill(params, cfg, prompt, n)
            require(bool(torch.isfinite(got).all()),
                    f"train_sharded: kernel logits at {n} not finite")
            err = row_rel_err(got, want)
            served.append({"prompt_len": n, "row_rel_err": err,
                           "max_abs_err": max_err(got, want)})
            require(err <= BF16_ROW_RTOL, f"train_sharded: kernel prefill "
                                          f"logits at {n}: row error {err}")
        reqs = [Request(rid=i, prompt=rng.integers(
                    3, cfg.vocab_size, size=(TRAIN_PROMPTS[0],))
                    .astype(np.int32), max_new_tokens=TRAIN_NEW_TOKENS,
                    eos_id=-1) for i in range(BATCH)]
        outs = {}
        for name, m_ in (("kernel", kernel_model), ("chunked", model)):
            eng = ServingEngine(m_, params, max_len=TRAIN_PROMPTS[0]
                                + TRAIN_NEW_TOKENS, batch_size=BATCH,
                                device="cuda")
            outs[name] = eng.serve(reqs)
            if name == "kernel":
                counts = ops.launch_counts()
    for name in PATH_KERNELS["train_sharded"]:
        require(counts[name] > 0, f"train_sharded: kernel {name} not "
                                  f"launched")
    report.update(trained_through_kernels={
                      "prefill_vs_chunked": served, "limit": BF16_ROW_RTOL,
                      "serve_token_agreement": agreement(outs["kernel"],
                                                         outs["chunked"]),
                      "launches": launched_kernels(counts)})
    emit(report)
    del params, kernel_model
    torch.cuda.empty_cache()
    return {**report, "launches": counts}


# ---------------------------------------------------------------------------
# train_tp_sp: training across ranks under the tp_sp policy
# ---------------------------------------------------------------------------


def train_tp_sp_cfg(layers: int):
    """The bf16 runs' config: deepseek-moe-16b at full width and
    ``layers`` layers, chunked attention with remat."""
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(MOE_ARCH), num_layers=layers,
                               attn_impl="chunked", attn_chunk=TRAIN_CHUNK,
                               remat=True)


def tp_sp_stack_cfg(arch: str, backend: str):
    """A stack's bf16 run config: full width at TRAIN_TP_SP_STACKS' depth,
    chunked attention with remat."""
    from repro_torch.configs import get_arch

    plan = TRAIN_TP_SP_STACKS[backend][arch]
    extra = {k: plan[k] for k in ("encoder_layers", "pattern_tail")
             if k in plan}
    return dataclasses.replace(get_arch(arch), num_layers=plan["layers"],
                               attn_impl="chunked", attn_chunk=TRAIN_CHUNK,
                               remat=True, **extra)


def tp_sp_total_rows(cfg, seq: int) -> int:
    """The rows a sequence of ``seq`` tokens takes: a vision input's patch
    rows too."""
    return seq + (cfg.num_frontend_tokens if cfg.frontend == "vision"
                  else 0)


def tp_sp_fp32(torch, kind: str, arch: str | None = None):
    """(cfg, model, whole fp32 weights on the current card, the run's
    shape) of an fp32 gate run: ``fp32`` deepseek-moe-16b at
    TRAIN_TP_SP_FP32, ``dense_fp32`` internlm2-1.8b at TRAIN_TP_SP_DENSE,
    ``odd_fp32`` internlm2-1.8b at TRAIN_TP_SP_ODD, ``stack_fp32``
    ``arch`` at TRAIN_TP_SP_STACK_FP32 (an SSD scan's chunk the rows a
    rank runs); ``fp32_model``'s draw, chunked attention with remat."""
    from repro_torch.configs import get_arch

    run = {"fp32": TRAIN_TP_SP_FP32, "dense_fp32": TRAIN_TP_SP_DENSE,
           "odd_fp32": TRAIN_TP_SP_ODD,
           "stack_fp32": TRAIN_TP_SP_STACK_FP32}[kind]
    arch = {"fp32": MOE_ARCH, "stack_fp32": arch}.get(kind, ARCH)
    base = get_arch(arch)
    layers = run["layers"]
    extra = {}
    if kind == "stack_fp32":
        layers = layers[arch]
        run = dict(run, degree=run["degree"][arch], layers=layers)
        if base.encoder_layers:
            extra["encoder_layers"] = layers
        if base.block_pattern is not None:        # one period, no tail
            extra["pattern_tail"] = ()
        if base.ssm is not None:
            extra["ssm"] = dataclasses.replace(base.ssm, chunk=min(
                base.ssm.chunk, run["seq"] // run["degree"]))
    cfg, model, params = fp32_model(torch, base, layers, attn_impl="chunked",
                                    attn_chunk=TRAIN_FP32_CHUNK, remat=True,
                                    **extra)
    if cfg.moe is not None:
        bounded_moe(params)
    return cfg, model, params, run


def tp_sp_opt(steps: int, lr: float = TRAIN_TP_SP_LR):
    from repro_torch.optim import OptConfig

    return OptConfig(lr=lr, warmup_steps=0, total_steps=steps)


def tp_sp_data(cfg, seq: int, batch: int):
    """The whole batch every rank draws: ``SyntheticLMData(seed=17)``, a
    frontend stack's with its stub frames or patch embeddings."""
    from repro_torch.data import SyntheticLMData

    return SyntheticLMData(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=17,
                           frontend_tokens=cfg.num_frontend_tokens
                           if cfg.frontend else 0, d_model=cfg.d_model)


def expert_ids(torch, model, params, batch) -> list:
    """Each MoE layer's expert ids of a no-grad loss of ``batch``
    (``moe_routes``), on the host."""
    with torch.no_grad():
        _, routes = moe_routes(lambda: model.loss_fn(params, batch))
    return [r.expert_ids.cpu() for r in routes]


def assignments_apart(got: list, want: list) -> int:
    """Assignments (token, expert) of ``got`` (each layer's (T, K) ids)
    that ``want`` (the same tokens' ids) does not make."""
    return sum(int((~(g[..., :, None] == w[..., None, :]).any(-1)).sum())
               for g, w in zip(got, want, strict=True))


def tp_sp_yardstick(torch, kind: str, path: str,
                    arch: str | None = None) -> list:
    """The one-card run an fp32 gate run of ``kind`` (and ``arch``) is
    held to: the port's ``make_train_step`` on the same draw and
    batches, its MoE tokens in the degree's groups (``ctx.grouped_as``),
    and the expert ids of a no-grad loss of the first batch. Saves the
    metrics a step, the trained weights (host) and the ids to ``path``;
    returns the metrics."""
    from repro_torch.distributed import ctx
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.optim import adamw_init
    from repro_torch.tree import tree_map

    cfg, model, params, run = tp_sp_fp32(torch, kind, arch)
    opt = adamw_init(params)
    step_fn = make_train_step(model, tp_sp_opt(run["steps"]))
    data = tp_sp_data(cfg, run["seq"], run["batch"])
    metrics, grads = [], None
    with ctx.grouped_as(run["degree"]):
        ids = (expert_ids(torch, model, params,
                          batch_on(data.batch_at(0), "cuda"))
               if cfg.moe is not None else None)
        if kind in GRAD_GATED:
            grads = first_grads(torch, model, params,
                                batch_on(data.batch_at(0), "cuda"),
                                host=True)
        for step in range(run["steps"]):
            params, opt, m = step_fn(params, opt,
                                     batch_on(data.batch_at(step), "cuda"))
            metrics.append({k: float(v) for k, v in m.items()})
    torch.save({"metrics": metrics, "expert_ids": ids, "grads": grads,
                "params": tree_map(lambda t: t.detach().cpu(), params)},
               path)
    del params, opt
    torch.cuda.empty_cache()
    return metrics


def first_grads(torch, model, params, batch, host: bool = False) -> dict:
    """The gradients of ``batch``'s loss before any update
    (``make_loss_and_grads``; under a training policy the rank's reduced
    blocks), copies on the device (``host``: on the host); the parameters'
    ``.grad`` cleared."""
    from repro_torch.launch.steps import make_loss_and_grads
    from repro_torch.tree import tree_leaves, tree_map

    _, grads = make_loss_and_grads(model)(params, batch)
    out = tree_map(lambda g: (g.detach().cpu() if host else g.detach())
                   .clone(), grads)
    for p in tree_leaves(params):
        p.grad = None
    return out


def tp_sp_run(torch, plan: dict, shard, dev, kind: str, yard: dict | None,
              *, fault: str | None = None, final_dir: str | None = None,
              arch: str | None = None, backend: str = "gloo",
              grad_faults: tuple = ()) -> dict:
    """One tp_sp training run of ``kind`` on this rank of ``shard``'s
    group, every rank on the whole batch of each step: ``bf16`` the
    plan's deepseek-moe-16b at TRAIN_SEQ, fp32 master weights from seed
    0 (``bounded_moe`` unless the plan's ``bounded`` is false), int8
    compression, at the plan's ``lr`` (TRAIN_TP_SP_LR by default), or
    with ``arch`` that stack at its TRAIN_TP_SP_STACKS plan for
    ``backend``, no compression, TRAIN_TP_SP_STACK_STEPS steps;
    ``fp32`` / ``dense_fp32`` / ``odd_fp32`` / ``stack_fp32``
    ``tp_sp_fp32``'s model, no compression, clean or under a planted
    fault (``planted_tp_sp_fault``); ``stack_fp32`` and ``odd_fp32`` first
    hold the first batch's gradients to one card's (the gradient gate),
    clean and under each of ``grad_faults``. The rank holds its
    ``local_params(policy="tp_sp")`` split and its AdamW state. Each
    step: loss, grad norm, lr, device ms (CUDA events), wall, peak
    memory, bytes by kind; with ``final_dir`` a sharded save of the
    trained weights. bf16: the bytes against ``tp_sp_bytes``; fp32: the
    steps and every leaf against ``yard``'s one-card run, and (clean
    MoE) the assignments routed apart from it on the first batch."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.distributed.ctx import sharding_policy
    from repro_torch.distributed.sharding import local_params, tp_sp_blocks
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_on
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import init
    from repro_torch.optim import adamw_init

    n = shard.degree
    lr = TRAIN_TP_SP_LR
    if kind == "bf16" and arch is not None:
        cfg = tp_sp_stack_cfg(arch, backend)
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda", dtype=torch.float32)
        seq = TRAIN_TP_SP_STACKS[backend][arch]["seq"]
        batch, steps, compression = 1, TRAIN_TP_SP_STACK_STEPS, None
    elif kind == "bf16":
        cfg = train_tp_sp_cfg(plan["layers"])
        model = build_model(cfg)
        params = model.init(seed=0, device="cuda", dtype=torch.float32)
        if plan.get("bounded", True):
            bounded_moe(params)
        seq, batch, steps = TRAIN_SEQ, plan["batch"], plan["steps"]
        compression, lr = "int8", plan.get("lr", lr)
    else:
        cfg, model, params, run = tp_sp_fp32(torch, kind, arch)
        seq, batch, steps = run["seq"], run["batch"], run["steps"]
        compression = None
    params = local_params(params, rank=shard.rank, degree=n,
                          policy="tp_sp", in_place=True)
    torch.cuda.empty_cache()
    opt = adamw_init(params)
    if compression == "int8":
        opt["err"] = init_error_feedback(params)
    step_fn = make_train_step(model, tp_sp_opt(steps, lr), compression)
    data = tp_sp_data(cfg, seq, batch)
    final = None
    if final_dir is not None:
        # every rank opens the directory before any rank saves
        final = CheckpointManager(final_dir, keep=1, rank=shard.rank,
                                  degree=n)
        dist.barrier(group=shard.group)
    rec = {"degree": n, "rank": shard.rank, "kind": kind, "fault": fault,
           "arch": cfg.name, "layers": cfg.num_layers,
           "encoder_layers": cfg.encoder_layers,
           "pattern_tail": list(cfg.pattern_tail), "seq": seq,
           "rows": tp_sp_total_rows(cfg, seq), "global_batch": batch,
           "compression": compression, "steps": []}
    fault_ctx = (planted_tp_sp_fault(fault, cfg) if fault
                 else contextlib.nullcontext())
    with sharding_policy(shard, "tp_sp"), fault_ctx:
        if kind == "fp32" and fault is None:
            got = expert_ids(torch, model, params,
                             batch_on(data.batch_at(0), dev))
            want = torch.load(yard["path"], mmap=True)["expert_ids"]
            rec["assignments_routed_apart"] = assignments_apart(
                got, [w[shard.rank] for w in want])
            rec["assignments"] = sum(g.numel() for g in got)
        if kind in GRAD_GATED:
            want = torch.load(yard["path"], mmap=True)["grads"]
            b0 = batch_on(data.batch_at(0), dev)
            rec["grad_gate"] = fsdp_leaves_gate(fsdp_leaf_errs(
                torch, first_grads(torch, model, params, b0), want, shard),
                TRAIN_TP_SP_GRAD_RTOL)
            rec["fault_gates"] = {}
            for planted in grad_faults:
                with planted_tp_sp_fault(planted, cfg):
                    gate = fsdp_leaves_gate(fsdp_leaf_errs(
                        torch, first_grads(torch, model, params, b0), want,
                        shard), TRAIN_TP_SP_GRAD_RTOL)
                rec["fault_gates"][planted] = {
                    "rejected": bool(gate["failures"]),
                    "margin": gate["worst"] / gate["limit"],
                    **{k: gate[k] for k in ("worst_leaf", "worst")}}
            del want
        for step in range(steps):
            b = batch_on(data.batch_at(step), dev)
            shard.reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            (params, opt, m), wall, ms = timed_call(
                torch, lambda: step_fn(params, opt, b))
            rec["steps"].append({
                **{k: float(v) for k, v in m.items()}, "wall_s": wall,
                "device_ms": ms,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "sent": dict(shard.sent), "received": dict(shard.received),
                "staged_bytes": shard.staged_bytes})
        if final is not None:
            final.save(steps, {"params": params}, shardings={
                "params": tp_sp_blocks(init(cfg, device="meta"),
                                       rank=shard.rank, degree=n)})
    if kind == "bf16":
        rec["bytes_from_shapes"] = tp_sp_bytes(cfg, n, batch, seq,
                                               int8=compression == "int8")
    else:
        want = torch.load(yard["path"], mmap=True)
        steps_limit, leaf_limit = TRAIN_TP_SP_GATES[kind]
        rec["step_gate"] = fsdp_step_gate(rec["steps"], want["metrics"],
                                          steps_limit)
        rec["leaf_gate"] = fsdp_leaves_gate(
            fsdp_leaf_errs(torch, params, want["params"], shard), leaf_limit)
        grad_gate = rec.get("grad_gate", {"failures": []})
        rec["rejected"] = bool(rec["step_gate"]["failures"]
                               or rec["leaf_gate"]["failures"]
                               or grad_gate["failures"])
        rec["margin"] = gate_margin(rec["step_gate"], rec["leaf_gate"],
                                    rec.get("grad_gate"))
        del want
    del params, opt
    torch.cuda.empty_cache()
    return rec


def tp_sp_failures(rec: dict, tag: str) -> list:
    """A clean run's failed gates: bf16, a loss or grad norm not finite,
    or a step's bytes by kind apart from the shapes' arithmetic; fp32,
    the steps or leaves outside their bands."""
    import math

    tag = f"{tag} degree {rec['degree']} {rec['kind']} {rec['arch']}"
    if rec["kind"] != "bf16":
        return [f"{tag}: {f}" for f in rec["step_gate"]["failures"]
                + rec["leaf_gate"]["failures"]
                + rec.get("grad_gate", {"failures": []})["failures"]]
    out = []
    want = rec["bytes_from_shapes"]
    for i, step in enumerate(rec["steps"]):
        if not (math.isfinite(step["loss"])
                and math.isfinite(step["grad_norm"])):
            out.append(f"{tag} step {i}: loss {step['loss']}, grad norm "
                       f"{step['grad_norm']}")
        got = {k: step["sent"][k] for k in want}
        if got != want or got != {k: step["received"][k] for k in want}:
            out.append(f"{tag} step {i}: bytes {got}, the shapes give "
                       f"{want}")
    return out


def tp_sp_line(rec: dict) -> None:
    """Rank 0 prints a run's summary as it ends."""
    if rec["rank"] != 0:
        return
    line = {"phase": "train_tp_sp_run", **{
        k: rec.get(k) for k in ("degree", "kind", "fault", "arch", "rejected",
                                "margin", "assignments_routed_apart",
                                "assignments")},
        "loss": [s["loss"] for s in rec["steps"]],
        "wall_s": [s["wall_s"] for s in rec["steps"]],
        "device_ms": [s["device_ms"] for s in rec["steps"]]}
    if rec["kind"] != "bf16":
        line["step_gate"] = rec["step_gate"]
        line["leaf_gate"] = {k: v for k, v in rec["leaf_gate"].items()
                             if k != "failures"}
        line["leaf_failures"] = len(rec["leaf_gate"]["failures"])
        if "grad_gate" in rec:
            line["grad_gate"] = {k: v for k, v in rec["grad_gate"].items()
                                 if k != "failures"}
            line["grad_failures"] = len(rec["grad_gate"]["failures"])
            line["fault_gates"] = rec["fault_gates"]
    emit(line)


def train_tp_sp_rank(rank: int, world: int, backend: str, store: str,
                     out_dir: str, plan: dict, yards: dict) -> None:
    """One rank of the train_tp_sp phase (a process of its own): join the
    group, probe its collectives, train the bf16 runs at degrees 4 (its
    trained weights saved sharded) and 2, then at degree 4 the MoE fp32
    run clean and with each of its TP_SP_FAULTS, which the gates must
    reject, and at degree 2 the dense fp32 run; then each of
    TRAIN_TP_SP_STACKS' bf16 run at degree 4 (saved sharded) and its fp32
    run, mamba2's gradient gate also under each of RECURRENT_FAULTS, which
    it must reject by FAULT_MARGIN; then the dense run at a sequence the
    degree does not divide. Writes its report to
    ``out_dir``, then fails on any gate."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(SRC))
    from repro_torch.launch.mesh import seq_group

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        groups = {d: seq_group(d) for d in (2, 4)}
        report = {"rank": rank, "device": str(dev), "backend": backend,
                  "probe": collective_probe(torch, dist, dev, rank, world,
                                            groups[world]),
                  "runs": []}
        failures = []

        def run(degree, kind, arch=None, **kw):
            shard = groups[degree]
            if shard is not None:
                t0 = time.perf_counter()
                rec = tp_sp_run(torch, plan, shard, dev, kind,
                                yards.get(f"{kind} {arch}"), arch=arch,
                                backend=backend, **kw)
                rec["run_s"] = time.perf_counter() - t0
                report["runs"].append(rec)
                fault = kw.get("fault")
                if fault is None:
                    failures.extend(tp_sp_failures(rec, f"rank {rank}"))
                elif not rec["rejected"]:
                    failures.append(f"rank {rank}: the gates passed the "
                                    f"planted fault {fault} ({arch})")
                for planted, gate in rec.get("fault_gates", {}).items():
                    if not gate["rejected"] or gate["margin"] < FAULT_MARGIN:
                        failures.append(
                            f"rank {rank}: the gradient gate took the "
                            f"planted fault {planted} ({arch}) by "
                            f"{gate['margin']} times its limit, under "
                            f"{FAULT_MARGIN}")
                tp_sp_line(rec)
            release_host_buffers(torch)
            dist.barrier()

        for degree in TRAIN_TP_SP_DEGREES:
            run(degree, "bf16", final_dir=str(Path(out_dir) / "final")
                if degree == 4 else None)
        moe_faults = [f for f in TP_SP_FAULTS if f not in RECURRENT_FAULTS]
        for fault in [None] + moe_faults:
            run(TRAIN_TP_SP_FP32["degree"], "fp32", fault=fault)
        run(TRAIN_TP_SP_DENSE["degree"], "dense_fp32")
        for arch in TRAIN_TP_SP_STACKS[backend]:
            run(TRAIN_TP_SP_STACK_DEGREE, "bf16", arch,
                final_dir=str(Path(out_dir) / f"final_{arch}"))
            run(TRAIN_TP_SP_STACK_FP32["degree"][arch], "stack_fp32", arch,
                grad_faults=RECURRENT_FAULTS if arch == SSM_ARCH else ())
        run(TRAIN_TP_SP_ODD["degree"], "odd_fp32")
        report["failures"] = failures
        with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
            json.dump(report, f)
        require(not failures, "; ".join(failures))
    finally:
        dist.destroy_process_group()


def release_host_buffers(torch) -> None:
    """Return the pinned host blocks the CUDA host allocator keeps after
    gloo's staged collectives (four ranks' gathers of a 256000-row fp32
    embedding would otherwise keep ~5 GB each past their run)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def serve_trained_stack(torch, arch: str, cfg, params) -> dict:
    """A stack's trained weights (restored whole) through its kernels, no
    grad: a TRAIN_TP_SP_STACK_PROMPT-token prompt and one decode step
    after it, every kernel call held to its plain version on the same
    inputs beside its planted fault: mamba2's B8 calls of the prefill
    (``b8_gate``); recurrentgemma's B3 (head dim 256, windowed) calls of
    the prefill and B4 calls of the decode step (``attention_gate``);
    whisper's B2 calls of the encoder over one 1500-frame clip, its
    self- and cross-attention calls of the prefill and its B4 and cross
    calls of the decode step; internvl2's prefill after its 256 patch rows
    and its B4 calls. -> {gates by call}."""
    import numpy as np

    from repro_torch.models.api import build_model

    kcfg = dataclasses.replace(cfg, attn_impl="kernel")
    model = build_model(kcfg)
    rng = np.random.default_rng(11)
    n = TRAIN_TP_SP_STACK_PROMPT
    prompt = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(1, n))
                              ).to("cuda")
    attn_layers = sum(k == "attn" for k in cfg.layer_kinds)
    out = {}
    with torch.no_grad():
        if arch == SSM_ARCH:
            logits, gate = b8_gate(model, params, prompt)
            require(gate["calls"] > 0 and gate["row_rel_err"]
                    <= gate["limit"] < gate["fault_row_rel_err"],
                    f"train_tp_sp {arch}: B8 gate {gate}")
            out["prefill_b8"] = gate
        else:
            kw, start = {}, 0
            if cfg.frontend == "vision":
                kw["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                    (1, cfg.num_frontend_tokens, cfg.d_model))
                    .astype(np.float32)).to("cuda")
                start = cfg.num_frontend_tokens
            if cfg.encoder_layers:
                frames = torch.from_numpy(rng.standard_normal(
                    (1, cfg.num_frontend_tokens, cfg.d_model))
                    .astype(np.float32)).to("cuda")
                kw["encoder_out"], out["encode"] = attention_gate(
                    lambda: model.encode(params, frames))
                require(out["encode"]["kernels"].get("mas_streamed", 0)
                        == cfg.encoder_layers,
                        f"train_tp_sp {arch}: encode {out['encode']}")
            plain = ({"attention": flash_plain} if cfg.attn_window
                     else None)
            (logits, cache), out["prefill"] = attention_gate(
                lambda: model.prefill(params, kcfg, prompt, start + n + 1,
                                      **kw), plain_fns=plain)
            tok = logits[:, -1].argmax(-1, keepdim=True)
            _, out["decode"] = attention_gate(
                lambda: model.decode_step(params, kcfg, tok, cache,
                                          start + n))
            del cache
            want = ({"flash_e256"} if cfg.attn_window else
                    {"mas_resident", "mas_streamed"})
            require(set(out["prefill"]["kernels"]) <= want
                    and sum(out["prefill"]["kernels"].values())
                    >= attn_layers * (2 if cfg.encoder_layers else 1),
                    f"train_tp_sp {arch}: prefill {out['prefill']}")
            dec = "decode_e256" if cfg.attn_window else "decode"
            require(out["decode"]["kernels"].get(dec, 0) == attn_layers,
                    f"train_tp_sp {arch}: decode {out['decode']}")
        require(bool(torch.isfinite(logits).all()),
                f"train_tp_sp {arch}: kernel logits not finite")
    del model
    return out


def phase_train_tp_sp(torch) -> dict:
    """Training across ranks under the reference's tp_sp policy (see the
    module docstring, phase 21), one process a rank: NCCL with a card a
    rank where the machine has four cards, else gloo with every rank on
    card 0. The fp32 yardsticks are computed here first; a rank's failure
    fails the phase (``mp.spawn`` raises it here). Then the degree-4 bf16
    runs' trained weights, restored whole, serve through the kernels."""
    import tempfile

    import numpy as np
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.transformer import init
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.lifecycle import Request

    world = max(TRAIN_TP_SP_DEGREES)
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    plan = TRAIN_TP_SP_PLANS[backend]
    stacks = TRAIN_TP_SP_STACKS[backend]
    cfg = train_tp_sp_cfg(plan["layers"])
    torch.cuda.empty_cache()
    report = {"phase": "train_tp_sp", "arch": MOE_ARCH, "backend": backend,
              "cards": world if backend == "nccl" else 1,
              "layers": plan["layers"], "seq": TRAIN_SEQ,
              "global_batch": plan["batch"], "steps": plan["steps"],
              "compression": "int8", "param_dtype": "fp32",
              "compute_dtype": "bf16", "reduced": plan["reduced"]}
    gates = [("fp32", None), ("dense_fp32", None), ("odd_fp32", None)] + [
        ("stack_fp32", arch) for arch in stacks]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        yards = {}
        for kind, arch in gates:
            path = str(Path(tmp) / f"yard_{kind}_{arch}.pt")
            yards[f"{kind} {arch}"] = {
                "path": path, "metrics": tp_sp_yardstick(torch, kind, path,
                                                         arch)}
        report["yardsticks_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        mp.spawn(train_tp_sp_rank,
                 args=(world, backend, str(Path(tmp) / "store"), tmp, plan,
                       yards),
                 nprocs=world, join=True)
        report["spawn_s"] = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                 for r in range(world)]
        for yard in yards.values():         # the serves below need none
            Path(yard["path"]).unlink()
        params = CheckpointManager(str(Path(tmp) / "final")).restore(
            plan["steps"], {"params": init(cfg, device="meta")},
            device="cuda")["params"]
        trained = {}
        for arch in stacks:
            scfg = tp_sp_stack_cfg(arch, backend)
            trained[arch] = (scfg, str(Path(tmp) / f"final_{arch}"))
        report["runs_s"] = {f"{run['kind']} {run['arch']} "
                            f"{run['fault'] or 'clean'} {run['degree']}":
                            run["run_s"] for run in ranks[0]["runs"]}
        for degree, arch in [(d, None) for d in TRAIN_TP_SP_DEGREES] + [
                (TRAIN_TP_SP_STACK_DEGREE, a) for a in stacks]:
            runs = [run for rk in ranks for run in rk["runs"]
                    if run["degree"] == degree and run["kind"] == "bf16"
                    and (run["arch"] == cfg.name if arch is None else
                         run["arch"] == trained[arch][0].name)]
            losses = {json.dumps([s["loss"] for s in run["steps"]])
                      for run in runs}
            name = arch or MOE_ARCH
            require(len(losses) == 1, f"train_tp_sp {name} degree {degree}: "
                                      f"the ranks' losses differ ({losses})")
            ms = sorted(s["device_ms"] for s in runs[0]["steps"][1:])
            first = runs[0]
            line = {"phase": "train_tp_sp", "run": f"degree {degree}",
                    "arch": name, "backend": backend,
                    "layers": first["layers"],
                    "encoder_layers": first["encoder_layers"],
                    "seq": first["seq"], "rows": first["rows"],
                    "global_batch": first["global_batch"],
                    "compression": first["compression"],
                    "losses": json.loads(losses.pop()),
                    "grad_norms": [s["grad_norm"] for s in first["steps"]],
                    "bytes_a_rank_a_step": first["bytes_from_shapes"],
                    "staged_bytes": first["steps"][-1]["staged_bytes"],
                    "ranks": [{"rank": run["rank"], **{k: [s[k] for s in run[
                        "steps"]] for k in ("device_ms", "wall_s",
                                            "peak_mem_bytes")}}
                              for run in runs]}
            line["mfu"] = roofline_line(
                name, ShapeCell(f"train {first['global_batch']}x"
                                f"{first['rows']}", first["rows"],
                                first["global_batch"], "train"),
                ms[len(ms) // 2],
                max(s["peak_mem_bytes"] for run in runs for s in run["steps"]),
                layers=first["layers"],
                encoder_layers=first["encoder_layers"] or None,
                pattern_tail=(tuple(first["pattern_tail"])
                              if arch == HYBRID_ARCH else None),
                timing=f"CUDA events, rank 0's median of steps 1-"
                f"{len(first['steps']) - 1}, degree {degree}")["mfu"]
            emit(line)
        fp32 = {f"{run['kind']} {run['arch']} {run['fault'] or 'clean'}": {
            k: run.get(k) for k in ("rejected", "margin", "step_gate",
                                    "leaf_gate", "grad_gate", "fault_gates")}
            for run in ranks[0]["runs"] if run["kind"] != "bf16"}
        clean = [run for rk in ranks for run in rk["runs"]
                 if run["kind"] == "fp32" and run["fault"] is None]
        fp32[f"fp32 {cfg.name} clean"].update({k: sum(
            run[k] for run in clean) for k in ("assignments_routed_apart",
                                               "assignments")})
        emit({"phase": "train_tp_sp", "run": "fp32 and planted faults",
              "moe": TRAIN_TP_SP_FP32, "dense": {"arch": ARCH,
                                                  **TRAIN_TP_SP_DENSE},
              "odd": {"arch": ARCH, **TRAIN_TP_SP_ODD},
              "stacks": TRAIN_TP_SP_STACK_FP32,
              "one_card": {k: yards[k]["metrics"] for k in yards},
              "runs": fp32, "probe": [rk["probe"] for rk in ranks]})

        # the trained weights, gathered whole, through the kernels
        kernel_model = build_model(dataclasses.replace(cfg,
                                                       attn_impl="kernel"))
        model = build_model(cfg)
        rng = np.random.default_rng(7)
        prompts = [torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                                 size=(1, n))).to("cuda")
                   for n in TRAIN_PROMPTS]
        # every B1/B2 call of a prefill, B4 call of a decode step and kernel
        # call of the wave serve held to the plain version on the same
        # inputs beside its planted fault (``attention_gate``); the logits
        # held to the chunked route's where no (token, layer) routes apart
        # (a bf16 rounding can flip a token's sixth expert), and the served
        # tokens; then each stack's trained weights through its kernels
        # (``serve_trained_stack``)
        ops.reset_launch_counts()
        served = []
        with torch.no_grad():
            for prompt in prompts:
                n = prompt.shape[1]
                ((got, cache), got_routes), gate = attention_gate(
                    lambda: moe_routes(lambda: kernel_model.prefill(
                        params, kernel_model.cfg, prompt, n + 1)))
                tok = got[:, -1].argmax(-1, keepdim=True)
                _, dgate = attention_gate(lambda: kernel_model.decode_step(
                    params, kernel_model.cfg, tok, cache, n))
                del cache
                (want, _), want_routes = moe_routes(lambda: model.prefill(
                    params, cfg, prompt, n + 1))
                require(bool(torch.isfinite(got).all()),
                        f"train_tp_sp: kernel logits at {n} not finite")
                prefills = sum(gate["kernels"].get(k, 0)
                               for k in ("mas_resident", "mas_streamed"))
                require(prefills == cfg.num_layers,
                        f"train_tp_sp: prefill at {n}: {gate['kernels']}")
                require(dgate["kernels"].get("decode", 0) == cfg.num_layers,
                        f"train_tp_sp: decode at {n}: {dgate['kernels']}")
                apart = routing_differences(got_routes, want_routes)
                err = row_rel_err(got, want)
                served.append({"prompt_len": n, "row_rel_err": err,
                               "max_abs_err": max_err(got, want),
                               "routes_apart": apart, "prefill_gate": gate,
                               "decode_gate": dgate})
                require(apart or err <= LOGITS_RTOL,
                        f"train_tp_sp: kernel prefill logits at {n}: row "
                        f"error {err}")
            reqs = [Request(rid=i, prompt=rng.integers(
                        3, cfg.vocab_size, size=(TRAIN_PROMPTS[0],))
                        .astype(np.int32), max_new_tokens=TRAIN_NEW_TOKENS,
                        eos_id=-1) for i in range(BATCH)]
            outs = {}
            for name, m_ in (("kernel", kernel_model), ("chunked", model)):
                eng = ServingEngine(m_, params, max_len=TRAIN_PROMPTS[0]
                                    + TRAIN_NEW_TOKENS, batch_size=BATCH,
                                    device="cuda")
                if name == "kernel":
                    outs[name], serve_gate = attention_gate(
                        lambda: eng.serve(reqs))
                else:
                    outs[name] = eng.serve(reqs)
        del params, kernel_model, model, eng
        torch.cuda.empty_cache()
        stack_gates = {}
        for arch, (scfg, path) in trained.items():
            sparams = CheckpointManager(path).restore(
                TRAIN_TP_SP_STACK_STEPS, {"params": init(scfg,
                                                         device="meta")},
                device="cuda")["params"]
            stack_gates[arch] = serve_trained_stack(torch, arch, scfg,
                                                    sparams)
            del sparams
            shutil.rmtree(path)
            torch.cuda.empty_cache()
        counts = ops.launch_counts()
    for name in PATH_KERNELS["train_tp_sp"]:
        require(counts[name] > 0, f"train_tp_sp: kernel {name} not "
                                  f"launched")
    token_agreement = agreement(outs["kernel"], outs["chunked"])
    report.update(trained_through_kernels={
                      "prefill_vs_chunked": served, "limit": LOGITS_RTOL,
                      "serve_gate": serve_gate,
                      "serve_token_agreement": token_agreement,
                      "stacks": stack_gates,
                      "launches": launched_kernels(counts)},
                  stacks={arch: {**TRAIN_TP_SP_STACKS[backend][arch],
                                 "degree": TRAIN_TP_SP_STACK_DEGREE,
                                 "steps": TRAIN_TP_SP_STACK_STEPS,
                                 "global_batch": 1}
                          for arch in stacks})
    require(token_agreement == 1.0,
            f"train_tp_sp: the kernel serve's tokens agree {token_agreement} "
            f"with the chunked route's")
    emit(report)
    return {**report, "launches": counts}


def moe_routes(run):
    """``run()`` with every ``moe.moe_route`` call recorded: returns
    (run's result, [Route of each call in order])."""
    from repro_torch.models import moe

    real, calls = moe.moe_route, []

    def recorded(params, tokens, cfg):
        calls.append(real(params, tokens, cfg))
        return calls[-1]

    moe.moe_route = recorded
    try:
        return run(), calls
    finally:
        moe.moe_route = real


def bounded_moe(params) -> dict:
    """``params`` with every expert's down projection scaled by
    MOE_DOWN_SCALE in place (see there)."""
    for layer in params["layers"]:
        ffn = layer["ffn"]
        for blk in (ffn, ffn.get("shared", {})):
            if "w_down" in blk:
                blk["w_down"].mul_(MOE_DOWN_SCALE)
    return params


def drop_summary(routes) -> dict:
    """Rows, capacity and the share of (token, k) assignments dropped over
    the calls of one kind (one call a layer)."""
    dropped = sum(int((~r.keep).sum()) for r in routes)
    total = sum(r.keep.numel() for r in routes)
    return {"rows": int(routes[0].expert_ids.shape[0]),
            "capacity": routes[0].capacity, "calls": len(routes),
            "assignments": total, "dropped": dropped,
            "dropped_share": dropped / total}


def routing_differences(a, b) -> int:
    """(token, layer) pairs whose top-k expert sets differ between two
    runs' routes of the same tokens."""
    return sum(int((ra.expert_ids.sort(-1).values
                    != rb.expert_ids.sort(-1).values).any(-1).sum())
               for ra, rb in zip(a, b, strict=True))


def attention_gate(run, plain_fns=None):
    """``run()`` (a kernel-route prefill, decode step or prompt chunk) with
    every attention call of the model (``models/attention.py``: full
    sequence, dense decode, paged prefill) held to the plain version on
    the same inputs as it returns, beside its planted fault: the plain
    version with V tile 0 (the paged form: the table's first page)
    zeroed, which every row sees (under a window, every row of the
    window's first positions). ``plain_fns`` names a plain version to use
    in place of the function's ``impl="plain"``, by function name, called
    with the same arguments (``flash_plain``: a long windowed call whose
    dense oracle would not fit). A non-causal full-sequence call over keys
    that the kernel route pads to a whole tile (an encoder's, a cross
    block's) is also held beside a second fault: the plain version over
    the zero-padded keys and values, without the kv_len mask. Returns
    (run's result, {kernels launched: calls, largest row error, smallest
    planted fault error, limit, the padded calls and their smallest fault
    error})."""
    import torch

    from repro_torch.core.policy import KV_TILE
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am

    def zero_padded_keys(args):
        q, k, v, *rest = args
        pad = (0, 0, 0, (-k.shape[2]) % KV_TILE)
        return (q, torch.nn.functional.pad(k, pad),
                torch.nn.functional.pad(v, pad), *rest)

    def zero_first_page(args):
        q, k_pages, v_pages, table, *rest = args
        return (q, k_pages, drop_v_page(v_pages, int(table.reshape(-1)[0])),
                table, *rest)

    def zero_first_tile(args):
        q, k, v, *rest = args
        return (q, k, drop_v_tile(v, 0), *rest)

    faults = {"attention": zero_first_tile,
              "decode_attention": zero_first_tile,
              "paged_prefill_attention": zero_first_page}
    real = {name: getattr(am, name) for name in faults}
    kernels, errs, fault_errs, tail_errs = {}, [], [], []

    def watched(name):
        fn = real[name]
        plain_fn = (plain_fns or {}).get(name)

        def reference(*args, **kw):
            if plain_fn is not None:
                return plain_fn(*args, **kw)
            return fn(*args, **dict(kw, impl="plain"))

        def call(*args, **kw):
            before = ops.launch_counts()
            got = fn(*args, **kw)
            after = ops.launch_counts()
            for k in after:
                kernels[k] = kernels.get(k, 0) + after[k] - before[k]
            want = reference(*args, **kw)
            errs.append(row_rel_err(got, want))
            fault_errs.append(row_rel_err(reference(*faults[name](args),
                                                    **kw), want))
            if (name == "attention" and not kw.get("causal", True)
                    and args[1].shape[2] % KV_TILE):
                tail_errs.append(row_rel_err(
                    reference(*zero_padded_keys(args), **kw), want))
            return got
        return call

    for name in faults:
        setattr(am, name, watched(name))
    try:
        out = run()
    finally:
        for name, fn in real.items():
            setattr(am, name, fn)
    gate = {"kernels": {k: n for k, n in kernels.items() if n},
            "calls": len(errs), "limit": BF16_ROW_RTOL,
            "row_rel_err": max(errs), "fault_row_rel_err": min(fault_errs),
            "kv_tail_calls": len(tail_errs),
            "kv_tail_fault_row_rel_err": min(tail_errs, default=None)}
    require(gate["row_rel_err"] <= BF16_ROW_RTOL < gate["fault_row_rel_err"],
            f"attention gate: {gate}")
    require(not tail_errs or min(tail_errs) > BF16_ROW_RTOL,
            f"attention gate: an unmasked kv tail passes: {gate}")
    return out, gate


def prefill_vs_plain(got, want) -> dict:
    """First-token logits of the kernel route against the plain route's,
    with the dense limit (LOGITS_RTOL of the largest plain logit)."""
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    return {"finite": bool(got.isfinite().all()),
            "max_abs_err": max_err(got, want), "max_abs_logit": scale,
            "tol": LOGITS_RTOL * max(1.0, scale),
            "argmax_equal": bool(got.argmax(-1).eq(want.argmax(-1)).all())}


def serve_waves(torch, engines: dict, waves, prompts) -> list:
    """Serve each wave ``(route, prompt length, batch)`` of ``prompts``
    (one list a wave) through ``engines[batch]``; every request must
    finish with NEW_TOKENS tokens and each wave launch its route's
    kernel. Returns one summary a wave."""
    from repro_torch.kernels import ops

    out = []
    for (route, n, b), ps in zip(waves, prompts, strict=True):
        eng = engines[b]
        reqs = make_requests(ps, NEW_TOKENS)
        before = ops.launch_counts()
        t0 = time.perf_counter()
        served = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        after = ops.launch_counts()
        check_served(eng, reqs, served, NEW_TOKENS, eng.cfg.vocab_size)
        require(after[route] > before[route],
                f"wave {b} x {n}: the {route} kernel was not launched")
        stamps = eng.token_walltimes
        step = eng.metrics.histogram("engine.step_s.wave_decode").summary()
        tokens = sum(len(served[r.rid]) for r in reqs)
        out.append({
            "route": route, "prompt_len": n, "batch": b, "tokens": tokens,
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "ttft_s": max(stamps[r.rid][0] - eng.serve_t0 for r in reqs),
            "decode_step_s": {"count": step["count"], "mean": step["mean"],
                              "p50": step["p50"]},
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] > before[k]}})
    return out


def phase_moe(torch) -> dict:
    """Full-width, full-depth deepseek-moe-16b (bf16, random weights from
    seed 0, the experts' down projections scaled by MOE_DOWN_SCALE; 64
    routed experts top-6 and 2 shared, capacity factor 1.25):
    the wave engine on 4 x 256 (B1) and 4 x 2048 (B2), 16 new tokens each
    (B4 at GQA group 1), then the continuous phase's 16 requests at its
    settings (B5, B6). Then, off the serves: each call kind's expert
    capacity and share of dropped (token, k) assignments from
    ``moe_route`` on each layer's inputs; on each wave's first prompt
    every B1/B2 call of the prefill and B4 call of one decode step held
    to the plain version on the same inputs (``attention_gate``), and the
    first-token logits against the plain route, held at LOGITS_RTOL only
    where no (token, layer) pair's top-k experts differ between the
    routes (routing is discontinuous: a bf16 rounding can flip a token's
    sixth expert); every B5 call of one continuous request's chunks held
    the same way; and at FP32_LAYERS layers in fp32, at a capacity that
    drops nothing, the continuous engine on the kernels and on plain
    attention and the wave engine emit the same greedy tokens."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving import ContinuousBatchingEngine, ServingEngine

    full = full_width_model(torch, MOE_ARCH)
    model, params = full["model"], bounded_moe(full["params"])
    cfg = model.cfg
    m = cfg.moe
    vocab = cfg.vocab_size
    rng = np.random.default_rng(0)
    wave_prompts = [[rng.integers(3, vocab, size=(n,)).astype(np.int32)
                     for _ in range(b)] for _, n, b in MOE_WAVES]
    cont_prompts = continuous_prompts(vocab)
    engines = {BATCH: ServingEngine(model, params, max_len=MOE_MAX_LEN,
                                    batch_size=BATCH, device="cuda")}
    cont = ContinuousBatchingEngine(model, params, device="cuda", **CONT)
    # warm-up: cuBLAS handles and the kernels' first loads
    engines[BATCH].serve(make_requests([p[:32] for p in wave_prompts[0]],
                                       2))
    cont.serve(make_requests([p[:40] for p in cont_prompts[:2]], 2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    waves = serve_waves(torch, engines, MOE_WAVES, wave_prompts)
    reqs = make_requests(cont_prompts, CONT_NEW_TOKENS)
    t0 = time.perf_counter()
    out = cont.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check_served(cont, reqs, out, CONT_NEW_TOKENS, vocab)
    for name in PATH_KERNELS["moe"]:
        require(counts[name] > 0, f"kernel {name} not launched on the moe "
                                  f"path")
    continuous = {"requests": CONT_REQUESTS, "new_tokens": CONT_NEW_TOKENS,
                  "num_pages": cont.num_pages,
                  **serve_summary(cont, reqs, out, wall)}
    del engines, cont

    # off the serves: drops by call kind, the per-call attention gates and
    # the first-token logits against the plain route
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    drops, gates, logits_check = {}, [], []
    for (route, n, b), ps in zip(MOE_WAVES, wave_prompts):
        batch = torch.from_numpy(np.stack(ps).astype(np.int64)).cuda()
        (_, cache), routes = moe_routes(
            lambda: model.prefill(params, cfg, batch, n + 1))
        drops[f"wave_{b}x{n}"] = drop_summary(routes)
        if n == MOE_WAVES[-1][1]:
            tok = torch.ones((b, 1), dtype=torch.long, device="cuda")
            _, routes = moe_routes(
                lambda: model.decode_step(params, cfg, tok, cache, n))
            drops[f"wave_decode_{b}"] = drop_summary(routes)
        del cache
        prompt = batch[:1]
        ((got, cache), kroutes), gate = attention_gate(
            lambda: moe_routes(
                lambda: model.prefill(params, cfg, prompt, n + 1)))
        tok = got[:, -1].argmax(-1, keepdim=True)
        _, dgate = attention_gate(
            lambda: model.decode_step(params, cfg, tok, cache, n))
        del cache
        (want, _), proutes = moe_routes(
            lambda: plain_model.prefill(params, plain_model.cfg, prompt, n))
        differ = routing_differences(kroutes, proutes)
        check = {"route": route, "prompt_len": n,
                 "topk_differs_token_layers": differ,
                 "gate": differ == 0, **prefill_vs_plain(got, want)}
        logits_check.append(check)
        gates.append({"prompt_len": n, "prefill": gate, "decode": dgate})
        require(check["finite"], f"moe prefill {n}: logits not finite")
        if check["gate"]:
            require(check["max_abs_err"] <= check["tol"],
                    f"moe prefill {n} logits: {check}")
        require(gate["kernels"].get(route, 0) == cfg.num_layers,
                f"moe prefill {n}: {gate['kernels']}")
        require(dgate["kernels"].get("decode", 0) == cfg.num_layers,
                f"moe decode {n}: {dgate['kernels']}")
    # decode at the continuous engine's batch (T = 8): the first wave's
    # prompts and the second's cut to their length
    n0 = MOE_WAVES[0][1]
    batch = torch.from_numpy(np.stack(
        wave_prompts[0] + [p[:n0] for p in wave_prompts[1]]).astype(
        np.int64)).cuda()
    _, cache = model.prefill(params, cfg, batch, n0 + 1)
    tok = torch.ones((batch.shape[0], 1), dtype=torch.long, device="cuda")
    _, routes = moe_routes(
        lambda: model.decode_step(params, cfg, tok, cache, n0))
    drops[f"decode_{batch.shape[0]}"] = drop_summary(routes)
    del cache
    # one continuous request's chunks, as the engine pads them
    long = next(p for p in cont_prompts if len(p) > 2 * CONT["chunk_size"])
    (_, routes), cgate = attention_gate(
        lambda: moe_routes(
            lambda: chunked_prefill(torch, model, params, long)))
    drops[f"chunk_{CONT['chunk_size']}"] = drop_summary(routes)
    cgate["prompt_len"] = len(long)
    gates.append({"prompt_len": len(long), "chunks": cgate})
    require(cgate["kernels"].get("paged_prefill", 0)
            == cfg.num_layers * -(-len(long) // CONT["chunk_size"]),
            f"moe chunks: {cgate['kernels']}")
    roofline_probe(torch, MOE_ARCH, model, params, torch.from_numpy(
        np.stack(wave_prompts[-1]).astype(np.int64)).cuda())
    init_s = full["init_s"]
    del full, params, model, plain_model

    # fp32, FP32_LAYERS layers, a capacity no call can overflow: the
    # engines' batchings must then give the same tokens
    cf32 = m.num_experts / m.top_k + 1
    cfg32, m32, p32 = fp32_model(torch, dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=cf32)))
    bounded_moe(p32)
    plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain"))
    rng32 = np.random.default_rng(1)
    ps32 = [rng32.integers(3, vocab, size=(int(n),)).astype(np.int32)
            for n in rng32.integers(PROMPT_LENS[0], FP32_PROMPT_MAX,
                                    size=FP32_REQUESTS)]
    runs, routes32 = {}, []
    for name, serve in (
            ("continuous_kernel", lambda: ContinuousBatchingEngine(
                m32, p32, device="cuda", **CONT)),
            ("continuous_plain", lambda: ContinuousBatchingEngine(
                plain32, p32, device="cuda", **CONT)),
            ("wave_kernel", lambda: ServingEngine(
                m32, p32, max_len=CONT["max_len"], batch_size=1,
                device="cuda"))):
        runs[name], routes = moe_routes(
            lambda: serve().serve(make_requests(ps32, FP32_NEW_TOKENS)))
        routes32 += routes
    ref = runs["continuous_kernel"]
    fp32 = {"layers": FP32_LAYERS, "requests": FP32_REQUESTS,
            "prompt_lens": [len(p) for p in ps32],
            "new_tokens": FP32_NEW_TOKENS, "capacity_factor": cf32,
            "capacities": sorted({r.capacity for r in routes32}),
            "dropped": sum(int((~r.keep).sum()) for r in routes32),
            "distinct_tokens": len({int(t) for v in ref.values()
                                    for t in v}),
            "mismatched_rids": {name: [rid for rid in ref if not
                                       np.array_equal(run[rid], ref[rid])]
                                for name, run in runs.items()}}
    report = {
        "phase": "moe", "arch": MOE_ARCH, "params": cfg.param_count(),
        "expert_down_scale": MOE_DOWN_SCALE,
        "active_params": cfg.active_param_count(), "init_s": init_s,
        "layers": cfg.num_layers, "dtype": "bf16",
        "experts": m.num_experts, "top_k": m.top_k, "shared": m.num_shared,
        "capacity_factor": m.capacity_factor, "max_len": MOE_MAX_LEN,
        "new_tokens": NEW_TOKENS, "waves": waves, "continuous": continuous,
        "peak_mem_bytes": peak, "launches": counts,
        "capacity_by_call": {k: v["capacity"] for k, v in drops.items()},
        "drops": drops, "attention_gates": gates,
        "prefill_vs_plain": logits_check,
        "prefill_vs_plain_not_a_gate": (
            "held at LOGITS_RTOL only where no (token, layer) pair's top-k "
            "experts differ between the kernel and plain routes: a bf16 "
            "rounding that flips a token's sixth expert changes its FFN "
            "output by a whole expert's share"),
        "fp32_parity": fp32,
    }
    emit(report)
    require(fp32["dropped"] == 0, "fp32 moe: an assignment was dropped")
    for name, rids in fp32["mismatched_rids"].items():
        require(not rids, f"fp32 moe {name}: tokens differ for rids {rids}")
    return report


def fitted_depth(torch, cfg, cache_bytes_per_layer: int) -> int:
    """Layers of ``cfg`` whose bf16 weights and caches fit in the card's
    free memory with DENSE_HEADROOM bytes to spare (all of them if they
    fit)."""
    free, _ = torch.cuda.mem_get_info()
    fixed = dataclasses.replace(cfg, num_layers=0).param_count()
    per_layer = (2 * (cfg.param_count() - fixed) // cfg.num_layers
                 + cache_bytes_per_layer)
    return min(cfg.num_layers,
               (free - 2 * fixed - DENSE_HEADROOM) // per_layer)


def phase_dense_archs(torch) -> dict:
    """The dense archs beside internlm2, full width, each built, served
    and freed before the next: phi4-mini-3.8b (GQA group 3) in waves of 4
    x 256 and 4 x 2048 and 8 continuous requests (B1, B2, B4, B5, B6),
    deepseek-coder-33b (group 7, untied embeddings) in a 1 x 2048 wave
    (B2, B4), at full depth where the card holds its weights, its cache
    and DENSE_HEADROOM (else cut, and said so), and qwen3-1.7b (qk-norm,
    group 2, vocab 151936) as phi4-mini. 16 new tokens a wave;
    each wave's first-token logits held to the plain route within
    LOGITS_RTOL; every launch count of each arch's path must rise."""
    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.serving import ContinuousBatchingEngine, ServingEngine

    archs, launches = [], {}
    for arch, waves, n_cont in DENSE_ARCH_TRAFFIC:
        cfg = get_arch(arch)
        max_len = max(n for _, n, _ in waves) + NEW_TOKENS
        cache_per_layer = max(
            2 * b * cfg.num_kv_heads * max_len * cfg.hd * 2
            for _, _, b in waves)
        if n_cont:
            cache_per_layer += 2 * cfg.num_kv_heads * (
                CONT["batch_size"] * CONT["max_len"] + CONT["page_size"]
            ) * cfg.hd * 2
        layers = fitted_depth(torch, cfg, cache_per_layer)
        require(layers > 0, f"{arch}: no layer fits the card")
        cfg = dataclasses.replace(cfg, num_layers=layers)
        full = full_width_model(torch, cfg=cfg)
        model, params = full["model"], full["params"]
        vocab = cfg.vocab_size
        rng = np.random.default_rng(0)
        prompts = [[rng.integers(3, vocab, size=(n,)).astype(np.int32)
                    for _ in range(b)] for _, n, b in waves]
        engines = {b: ServingEngine(model, params, max_len=max_len,
                                    batch_size=b, device="cuda")
                   for _, _, b in waves}
        for b in engines:                           # warm-up
            engines[b].serve(make_requests(
                [p[:32] for p in prompts[0][:1]] * b, 2))
        cont = None
        if n_cont:
            cont_ps = continuous_prompts(vocab)[:n_cont]
            cont = ContinuousBatchingEngine(model, params, device="cuda",
                                            **CONT)
            cont.serve(make_requests([p[:40] for p in cont_ps[:2]], 2))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        served = serve_waves(torch, engines, waves, prompts)
        summary = None
        if cont is not None:
            reqs = make_requests(cont_ps, CONT_NEW_TOKENS)
            t0 = time.perf_counter()
            out = cont.serve(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check_served(cont, reqs, out, CONT_NEW_TOKENS, vocab)
            summary = {"requests": n_cont, "new_tokens": CONT_NEW_TOKENS,
                       **serve_summary(cont, reqs, out, wall)}
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        need = {route for route, _, _ in waves} | {"decode"}
        if n_cont:
            need |= {"paged_prefill", "paged_decode"}
        for name in need:
            require(counts[name] > 0, f"{arch}: kernel {name} not launched")
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
        del engines, cont
        plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
        logits_check = []
        for (route, n, _), ps in zip(waves, prompts):
            prompt = torch.from_numpy(ps[0][None].astype(np.int64)).cuda()
            # no name keeps an engine or a cache past the arch: the next
            # arch's depth is fitted to the free memory
            got = model.prefill(params, cfg, prompt, n)[0]
            want = plain_model.prefill(params, plain_model.cfg, prompt, n)[0]
            check = {"route": route, "prompt_len": n,
                     **prefill_vs_plain(got, want)}
            logits_check.append(check)
            require(check["finite"] and check["max_abs_err"] <= check["tol"],
                    f"{arch} prefill {n} logits: {check}")
        roofline_probe(torch, arch, model, params, torch.from_numpy(
            np.stack(prompts[-1]).astype(np.int64)).cuda())
        archs.append({
            "arch": arch, "params": full["n_params"],
            "init_s": full["init_s"], "layers": layers,
            "reduced": (None if layers == get_arch(arch).num_layers else
                        f"num_layers {get_arch(arch).num_layers} -> "
                        f"{layers}: the weights, caches and "
                        f"{DENSE_HEADROOM >> 30} GiB did not fit"),
            "group": cfg.num_heads // cfg.num_kv_heads,
            "tie_embeddings": cfg.tie_embeddings, "dtype": "bf16",
            "waves": served, "continuous": summary, "peak_mem_bytes": peak,
            "launches": counts, "prefill_vs_plain": logits_check})
        del full, params, model, plain_model
        torch.cuda.empty_cache()
    report = {"phase": "dense_archs", "archs": archs, "launches": launches}
    emit(report)
    return report


def timed_call(torch, fn):
    """(fn(), host seconds, event ms): CUDA events around the call, which
    ends in a synchronize; the events count the device's elapsed time,
    idle gaps while the host enqueues included."""
    a = torch.cuda.Event(enable_timing=True)
    z = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a.record()
    out = fn()
    z.record()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, a.elapsed_time(z)


def roofline_line(arch: str, cell, ms: float, peak: int, *,
                  layers: int | None = None,
                  encoder_layers: int | None = None,
                  pattern_tail: tuple | None = None, **extra) -> dict:
    """Print one ``{"phase": "roofline", ...}`` line: ``cell_roofline`` of
    a step that took ``ms`` on the card (CUDA events) at ``peak`` bytes of
    device memory (``layers``, ``encoder_layers``, ``pattern_tail``: the
    depth run, where cut); fail unless 0 < roofline_share <= ROOFLINE_MAX and 0 < mfu <=
    ROOFLINE_MAX (a count that reads above it is wrong)."""
    from repro_torch.analysis.roofline import cell_roofline

    line = {"phase": "roofline", **cell_roofline({
        "arch": arch, "cell": cell, "device_s": ms / 1e3,
        "peak_memory_bytes": peak, "layers": layers,
        "encoder_layers": encoder_layers, "pattern_tail": pattern_tail}),
        **extra}
    emit(line)
    for key in ("roofline_share", "mfu"):
        require(0 < line[key] <= ROOFLINE_MAX,
                f"{arch} {line['cell']['name']}: {key} {line[key]}")
    return line


def roofline_probe(torch, arch: str, model, params, prompt, *,
                   frames=None, patches=None) -> list[dict]:
    """One prefill of ``prompt`` (B, S) (after ``encode`` of ``frames``,
    with ``patches`` before the prompt, where given) and ROOFLINE_STEPS
    decode steps after it through the model API, each between CUDA events
    (``timed_call``: the device's elapsed time, idle gaps while the host
    enqueues included), and the roofline lines of the prefill and of the
    median decode step. The decode cell counts the keys of the first
    step, the fewest."""
    from repro_torch.configs import ShapeCell

    cfg = model.cfg
    b, s = prompt.shape
    start = s + (0 if patches is None else patches.shape[1])

    def prefill():
        inputs = {}
        if frames is not None:
            inputs["encoder_out"] = model.encode(params, frames)
        if patches is not None:
            inputs["frontend_embeds"] = patches
        return model.prefill(params, cfg, prompt, start + ROOFLINE_STEPS,
                             **inputs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (logits, cache), _, prefill_ms = timed_call(torch, prefill)
    prefill_peak = torch.cuda.max_memory_allocated()
    tok = logits[:, -1].argmax(-1, keepdim=True)
    steps = []
    for i in range(ROOFLINE_STEPS):
        (logits, cache), _, ms = timed_call(
            torch, lambda: model.decode_step(params, cfg, tok, cache,
                                             start + i))
        tok = logits[:, -1].argmax(-1, keepdim=True)
        steps.append(ms)
    decode_peak = torch.cuda.max_memory_allocated()
    del cache, logits
    layers = cfg.num_layers
    what = "encode + prefill" if frames is not None else "prefill"
    return [
        roofline_line(arch, ShapeCell(f"{what} {b}x{start}", start, b,
                                      "prefill"),
                      prefill_ms, prefill_peak, layers=layers,
                      timing="CUDA events around one call"),
        roofline_line(arch, ShapeCell(f"decode {b}x{start + 1}", start + 1,
                                      b, "decode"),
                      sorted(steps)[ROOFLINE_STEPS // 2], decode_peak,
                      layers=layers, step_ms=steps,
                      timing=f"CUDA events, median of {ROOFLINE_STEPS} "
                             "steps")]


def generate(torch, model, params, prompt, new: int, *, start: int,
             max_len: int, kv_dtype=None, **inputs) -> dict:
    """Greedy generation through the model API: ``prefill`` of ``prompt``
    (B, S) with ``inputs`` (``encoder_out=`` or ``frontend_embeds=``) into
    a cache of ``max_len`` rows, then ``new - 1`` ``decode_step``s at
    positions ``start`` onwards. Returns the tokens (B, new), the first
    token's logits (B, V) fp32, the last token and the cache, the launch
    counts after the prefill, and the prefill's and each decode step's
    (host seconds, event ms) by ``timed_call``."""
    from repro_torch.kernels import ops

    cfg = model.cfg
    (logits, cache), *prefill = timed_call(torch, lambda: model.prefill(
        params, cfg, prompt, max_len, kv_dtype=kv_dtype, **inputs))
    first_logits = logits[:, -1].float()
    prefill_counts = ops.launch_counts()
    toks = [logits[:, -1].argmax(-1, keepdim=True)]
    steps = []
    for i in range(new - 1):
        (logits, cache), *step = timed_call(
            torch, lambda i=i: model.decode_step(params, cfg, toks[-1],
                                                 cache, start + i))
        toks.append(logits[:, -1].argmax(-1, keepdim=True))
        steps.append(step)
    return {"tokens": torch.cat(toks, 1), "first_logits": first_logits,
            "cache": cache, "prefill_counts": prefill_counts,
            "prefill": prefill, "steps": steps}


def step_summary(steps) -> dict:
    """Decode steps' host seconds and event ms: count, mean, p50."""
    import numpy as np

    host, ev = np.array([s for s, _ in steps]), np.array([m for _, m in steps])
    return {"count": len(steps), "mean_s": float(host.mean()),
            "p50_s": float(np.median(host)),
            "events_mean_ms": float(ev.mean())}


def launched_kernels(counts: dict) -> dict:
    """The kernels of ``counts`` that launched."""
    return {k: n for k, n in counts.items() if n}


def recorded_calls(module, name: str, run, keep):
    """``run()`` with the calls of ``module.name`` that ``keep`` accepts
    recorded: returns (run's result, [(args, kwargs), ...])."""
    real, calls = getattr(module, name), []

    def call(*args, **kw):
        if keep(*args, **kw):
            calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, name, call)
    try:
        return run(), calls
    finally:
        setattr(module, name, real)


def fp32_token_parity(torch, cfg, prompt, new: int, *, start: int,
                      max_len: int, layers: int, frames=None, patches=None,
                      **overrides) -> dict:
    """At full width, ``layers`` layers (``overrides`` of more fields) in
    fp32: the kernel route's greedy tokens (``generate``) against the
    plain route's on ``prompt``, after each route's ``encode`` of
    ``frames`` or with ``patches`` before the prompt, where given. Returns
    the layers, the mismatched rows and the distinct tokens."""
    from repro_torch.models.api import build_model

    cfg32, m32, p32 = fp32_model(torch, cfg, layers, **overrides)
    plain32 = build_model(dataclasses.replace(cfg32, attn_impl="plain"))
    outs = []
    for m in (m32, plain32):
        inputs = {}
        if frames is not None:
            inputs["encoder_out"] = m.encode(p32, frames.float())
        if patches is not None:
            inputs["frontend_embeds"] = patches.float()
        outs.append(generate(torch, m, p32, prompt, new, start=start,
                             max_len=max_len, **inputs)["tokens"])
    same = (outs[0] == outs[1]).all(-1)
    del m32, p32, plain32
    torch.cuda.empty_cache()
    return {"layers": layers, **overrides,
            "mismatched_rows": [i for i, ok in enumerate(same.tolist())
                                if not ok],
            "distinct_tokens": int(outs[0].unique().numel())}


def phase_encdec(torch) -> dict:
    """Full-width, full-depth whisper-large-v3 (bf16, random weights from
    seed 0) through ``encode``, ``prefill`` and greedy ``decode_step``s
    (the engines take no frames): stub frames (B, 1500, 1280) from
    ``numpy.random.default_rng(11)``; waves of ENCDEC_WAVES (clips,
    decoder prompt tokens), ENCDEC_NEW_TOKENS each, and the first wave
    again on an int8 self-attention cache. Each wave launches B2 once an
    encoder layer, B1 and B2 once a decoder layer in the prefill, and B4
    and B2 once a decoder layer a decode step, exactly. Per wave: encode,
    prefill and decode-step host seconds and event ms, peak memory,
    launches. B2's share of a decode step's device time: the step's
    device time from a CUDA graph of it (``graph_ms``: its ~1,900
    launches overflow the queue that ``hidden_ms`` fills), its 32 B2
    launches and its cross-attention calls through ``ops.attention``
    (their padding copies included) each behind a device-side wait
    (``hidden_ms``). On the first wave's inputs one encode, prefill and
    decode step (bf16 and int8) held call by call to the plain versions
    (``attention_gate``, with its kv-tail fault on every non-causal call);
    the first-token logits of every bf16 wave within LOGITS_RTOL of the
    plain route's, the int8 cache's first decode logits within
    INT8_LOGITS_RTOL of bf16's; and at ENCDEC_FP32_LAYERS encoder and
    decoder layers in fp32 the kernel route's tokens equal the plain
    route's."""
    import numpy as np

    from repro_torch.kernels import mas_attention as mas
    from repro_torch.kernels import ops
    from repro_torch.models import attention as am
    from repro_torch.models.api import build_model

    full = full_width_model(torch, ENCDEC_ARCH)
    model, params = full["model"], full["params"]
    cfg = model.cfg
    n_dec, n_enc, new = cfg.num_layers, cfg.encoder_layers, ENCDEC_NEW_TOKENS
    rng = np.random.default_rng(11)
    inputs = [(torch.from_numpy(rng.standard_normal(
                   (clips, cfg.num_frontend_tokens, cfg.d_model))
                   .astype(np.float32)).to("cuda", torch.bfloat16),
               torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                             size=(clips, n))).cuda())
              for clips, n in ENCDEC_WAVES]
    # warm-up: cuBLAS handles and the kernels' first loads
    for kv in (None, "int8"):
        frames, prompt = inputs[0]
        generate(torch, model, params, prompt, 2, start=prompt.shape[1],
                 max_len=prompt.shape[1] + 2, kv_dtype=kv,
                 encoder_out=model.encode(params, frames))

    runs = [(i, None) for i in range(len(ENCDEC_WAVES))] + [(0, "int8")]
    waves, served, counts, cross_launches = [], {}, {}, 0
    for i, kv in runs:
        (clips, n), (frames, prompt) = ENCDEC_WAVES[i], inputs[i]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        enc, enc_s, enc_ms = timed_call(torch,
                                        lambda: model.encode(params, frames))
        enc_counts = ops.launch_counts()
        out = generate(torch, model, params, prompt, new, start=n,
                       max_len=n + new, kv_dtype=kv, encoder_out=enc)
        after = ops.launch_counts()
        decode_key = "decode_int8" if kv else "decode"
        launched = launched_kernels(after)
        require(launched_kernels(enc_counts) == {"mas_streamed": n_enc},
                f"encdec encode {clips} x {frames.shape[1]}: {enc_counts}")
        require(launched == {"mas_streamed": n_enc + n_dec * new,
                             "mas_resident": n_dec,
                             decode_key: n_dec * (new - 1)},
                f"encdec wave {clips} x {n} {kv}: launches {launched}")
        for k, c in after.items():
            counts[k] = counts.get(k, 0) + c
        cross = after["mas_streamed"] - out["prefill_counts"]["mas_streamed"]
        cross_launches += cross
        toks = out["tokens"]
        require(toks.shape == (clips, new) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"encdec wave {clips} x {n}: tokens {tuple(toks.shape)}")
        require(bool(out["first_logits"].isfinite().all()),
                f"encdec wave {clips} x {n}: first logits not finite")
        served[(i, kv)] = out
        prefill_s, prefill_ms = out["prefill"]
        steps = step_summary(out["steps"])
        waves.append({
            "clips": clips, "prompt_len": n, "frames": frames.shape[1],
            "kv_dtype": kv or "bf16", "new_tokens": new,
            "encode_s": enc_s, "encode_events_ms": enc_ms,
            "prefill_s": prefill_s, "prefill_events_ms": prefill_ms,
            "ttft_s": enc_s + prefill_s, "decode_step": steps,
            "tokens_per_s": clips * new / (enc_s + prefill_s + sum(
                s for s, _ in out["steps"])),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": launched, "decode_b2_launches": cross})
    counts["mas_streamed_cross"] = cross_launches
    agree = float((served[(0, "int8")]["tokens"]
                   == served[(0, None)]["tokens"]).float().mean())

    # B2's share of a decode step's device time, on the first wave's cache
    last = served[(0, None)]
    n = ENCDEC_WAVES[0][1]
    tok, cache, pos = last["tokens"][:, -1:], last["cache"], n + new - 1

    def step():
        return model.decode_step(params, cfg, tok, cache, pos)

    _, b2_calls = recorded_calls(
        mas, "mas_attention_flat", step,
        lambda *a, kv_resident=True, **kw: not kv_resident)
    _, cross_calls = recorded_calls(
        am, "attention", step, lambda *a, causal=True, **kw: not causal)
    require(len(b2_calls) == len(cross_calls) == n_dec,
            f"a decode step's B2 calls {len(b2_calls)}, cross-attention "
            f"calls {len(cross_calls)}")
    step_ms = graph_ms(torch, step, 10)
    b2_ms, r2, d2 = hidden_ms(
        torch, lambda: [mas.mas_attention_flat(*a, **kw)
                        for a, kw in b2_calls], 5)
    cross_ms, r3, d3 = hidden_ms(
        torch, lambda: [am.attention(*a, **kw) for a, kw in cross_calls], 5)
    share = {"clips": ENCDEC_WAVES[0][0], "position": pos,
             "decode_step_device_ms": step_ms, "b2_calls": len(b2_calls),
             "b2_device_ms": b2_ms,
             "cross_attention_device_ms": cross_ms,
             "b2_share": None if b2_ms is None else b2_ms / step_ms,
             "cross_attention_share": None if cross_ms is None
             else cross_ms / step_ms,
             "device_retries": r2 + r3, "device_dropped": d2 + d3}
    del served, last, cache, b2_calls, cross_calls

    # one gated encode, prefill and decode step (bf16 and int8) on the
    # first wave's inputs, and every bf16 wave's first-token logits
    # against the plain route
    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    frames, prompt = inputs[0]
    n = prompt.shape[1]
    enc, egate = attention_gate(lambda: model.encode(params, frames))
    (got, cache), pgate = attention_gate(lambda: model.prefill(
        params, cfg, prompt, n + new, encoder_out=enc))
    tok = got[:, -1].argmax(-1, keepdim=True)
    (want8, _), dgate = attention_gate(
        lambda: model.decode_step(params, cfg, tok, cache, n))
    _, cache8 = model.prefill(params, cfg, prompt, n + new, encoder_out=enc,
                              kv_dtype="int8")
    (got8, _), gate8 = attention_gate(
        lambda: model.decode_step(params, cfg, tok, cache8, n))
    del cache, cache8
    for gate, want in ((egate, {"mas_streamed": n_enc}),
                       (pgate, {"mas_resident": n_dec,
                                "mas_streamed": n_dec}),
                       (dgate, {"decode": n_dec, "mas_streamed": n_dec}),
                       (gate8, {"decode_int8": n_dec,
                                "mas_streamed": n_dec})):
        require(gate["kernels"] == want and gate["kv_tail_calls"] ==
                want["mas_streamed"], f"encdec gate: {gate}")
    scale = float(want8.float().abs().max())
    int8_check = {"max_abs_err": max_err(got8, want8), "max_abs_logit": scale,
                  "tol": INT8_LOGITS_RTOL * max(1.0, scale)}
    require(int8_check["max_abs_err"] <= int8_check["tol"],
            f"encdec int8 decode logits: {int8_check}")
    logits_check = []
    for i, (frames, prompt) in enumerate(inputs):
        n = prompt.shape[1]
        got, _ = model.prefill(params, cfg, prompt, n,
                               encoder_out=model.encode(params, frames))
        want, _ = plain_model.prefill(
            params, plain_model.cfg, prompt, n,
            encoder_out=plain_model.encode(params, frames))
        check = {"clips": prompt.shape[0], "prompt_len": n,
                 **prefill_vs_plain(got, want)}
        logits_check.append(check)
        require(check["finite"] and check["max_abs_err"] <= check["tol"],
                f"encdec prefill {n} logits: {check}")
    roofline_probe(torch, ENCDEC_ARCH, model, params, inputs[0][1],
                   frames=inputs[0][0])
    init_s, n_params = full["init_s"], full["n_params"]
    del full, params, model, plain_model, enc
    torch.cuda.empty_cache()

    frames, prompt = inputs[0]
    n = prompt.shape[1]
    parity = fp32_token_parity(
        torch, cfg, prompt, new, start=n, max_len=n + new,
        frames=frames, layers=ENCDEC_FP32_LAYERS,
        encoder_layers=ENCDEC_FP32_LAYERS)
    report = {
        "phase": "encdec", "arch": ENCDEC_ARCH, "params": n_params,
        "init_s": init_s, "layers": n_dec, "encoder_layers": n_enc,
        "frames": cfg.num_frontend_tokens, "dtype": "bf16", "waves": waves,
        "b2_share_of_decode_step": share, "launches": counts,
        "int8_tokens_agreeing_with_bf16": agree,
        "attention_gates": {"encode": egate, "prefill": pgate,
                            "decode": dgate, "int8_decode": gate8},
        "int8_vs_bf16_decode_logits": int8_check,
        "prefill_vs_plain": logits_check, "fp32_parity": parity,
    }
    emit(report)
    require(not parity["mismatched_rows"],
            f"fp32 encdec: kernel tokens differ from plain: {parity}")
    return report


def phase_vlm(torch) -> dict:
    """Full-width, full-depth internvl2-2b (bf16, random weights from seed
    0) through ``prefill(frontend_embeds=)`` and greedy ``decode_step``s
    at positions 256 + i: 256 stub patch embeddings from
    ``numpy.random.default_rng(12)`` before each prompt, waves of
    VLM_WAVES (text tokens, batch), NEW_TOKENS each; B2 once a layer a
    prefill and B4 once a layer a decode step, exactly. Per wave: TTFT,
    decode step, peak memory, launches; on each wave's first prompt the
    prefill and a decode step held call by call to the plain versions and
    the first-token logits within LOGITS_RTOL of the plain route's; at
    VLM_FP32_LAYERS layers in fp32 the kernel route's tokens equal the
    plain route's."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    full = full_width_model(torch, VLM_ARCH)
    model, params = full["model"], full["params"]
    cfg = model.cfg
    layers, extra, new = cfg.num_layers, cfg.num_frontend_tokens, NEW_TOKENS
    rng = np.random.default_rng(12)
    inputs = [(torch.from_numpy(rng.standard_normal((b, extra, cfg.d_model))
                                .astype(np.float32)).to("cuda",
                                                        torch.bfloat16),
               torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                             size=(b, n))).cuda())
              for n, b in VLM_WAVES]
    patches, prompt = inputs[0]
    generate(torch, model, params, prompt[:, :32], 2, start=extra + 32,
             max_len=extra + 34, frontend_embeds=patches)      # warm-up
    waves, counts = [], {}
    for (n, b), (patches, prompt) in zip(VLM_WAVES, inputs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(torch, model, params, prompt, new, start=extra + n,
                       max_len=extra + n + new, frontend_embeds=patches)
        wall = time.perf_counter() - t0
        launched = launched_kernels(ops.launch_counts())
        require(launched == {"mas_streamed": layers,
                             "decode": layers * (new - 1)},
                f"vlm wave {b} x ({extra} + {n}): launches {launched}")
        for k, c in launched.items():
            counts[k] = counts.get(k, 0) + c
        toks = out["tokens"]
        require(toks.shape == (b, new) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"vlm wave {b} x {n}: tokens {tuple(toks.shape)}")
        prefill_s, prefill_ms = out["prefill"]
        waves.append({
            "batch": b, "patches": extra, "prompt_len": n,
            "new_tokens": new, "ttft_s": prefill_s,
            "prefill_events_ms": prefill_ms,
            "decode_step": step_summary(out["steps"]), "wall_s": wall,
            "tokens_per_s": b * new / wall,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "launches": launched})
        del out

    plain_model = build_model(dataclasses.replace(cfg, attn_impl="plain"))
    gates, logits_check = [], []
    for (n, _), (patches, prompt) in zip(VLM_WAVES, inputs):
        one, p1 = prompt[:1], patches[:1]
        (got, cache), pgate = attention_gate(lambda: model.prefill(
            params, cfg, one, extra + n + 1, frontend_embeds=p1))
        tok = got[:, -1].argmax(-1, keepdim=True)
        _, dgate = attention_gate(
            lambda: model.decode_step(params, cfg, tok, cache, extra + n))
        del cache
        require(pgate["kernels"] == {"mas_streamed": layers},
                f"vlm prefill {n}: {pgate}")
        require(dgate["kernels"] == {"decode": layers},
                f"vlm decode {n}: {dgate}")
        gates.append({"prompt_len": n, "prefill": pgate, "decode": dgate})
        want, _ = plain_model.prefill(params, plain_model.cfg, one, extra + n,
                                      frontend_embeds=p1)
        check = {"prompt_len": n, **prefill_vs_plain(got, want)}
        logits_check.append(check)
        require(check["finite"] and check["max_abs_err"] <= check["tol"],
                f"vlm prefill {n} logits: {check}")
    patches, prompt = inputs[-1]                 # 4 x (256 + 2048)
    roofline_probe(torch, VLM_ARCH, model, params, prompt, patches=patches)
    init_s, n_params = full["init_s"], full["n_params"]
    del full, params, model, plain_model
    torch.cuda.empty_cache()

    patches, prompt = inputs[0]
    n = prompt.shape[1]
    parity = fp32_token_parity(torch, cfg, prompt, new, start=extra + n,
                               max_len=extra + n + new, patches=patches,
                               layers=VLM_FP32_LAYERS)
    report = {"phase": "vlm", "arch": VLM_ARCH, "params": n_params,
              "init_s": init_s, "layers": layers, "patches": extra,
              "dtype": "bf16", "waves": waves, "launches": counts,
              "attention_gates": gates, "prefill_vs_plain": logits_check,
              "fp32_parity": parity}
    emit(report)
    require(not parity["mismatched_rows"],
            f"fp32 vlm: kernel tokens differ from plain: {parity}")
    return report


def ring_verdicts(rows) -> dict:
    """pool ("bf16", "int8") -> whether the B5_ring rows found every hop's
    rows the single card's B5 rows bit for bit."""
    return {row["shape"]["pool"]: row["bitwise_vs_one_card"] for row in rows
            if row["name"].startswith("paged_prefill_ring")}


def sharded_alone(torch) -> int:
    """``--only sharded``: the kernel rows at a rank's heads and the
    sharded phase, after the device phase's build; the single-card tokens
    each run must equal are served here. Prints the same last three lines
    for these rows."""
    from repro_torch.configs import get_arch

    cfg = get_arch(ARCH)
    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    rows = [row for quantized in (False, True)
            for row in shard_rows(torch, rnd, cfg, quantized)
            + [ring_rows(torch, rnd, cfg, quantized)]]
    emit({"phase": "kernels", "row_rtol": BF16_ROW_RTOL, "kernels": rows})
    report = phase_sharded(torch, full_width_model(torch), ring_verdicts(rows))
    launches = {"sharded": report["launches"],
                "sharded_ring": report["ring_launches"]}
    for row in rows:
        row["launches"] = sum(launches[path][ROW_COUNTER[row["name"]]]
                              for path in ROW_PATH[row["name"]])
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ``--only`` choices of the seq_sharded phase: the parts each runs
SEQ_ONLY = {"seq_sharded": SEQ_PARTS, "seq_recurrent": ("recurrent",),
            "seq_frontend": ("frontend",), "seq_pipeline": ("pipeline",)}


def seq_sharded_alone(torch, device: dict, parts: tuple) -> int:
    """``--only seq_sharded`` (``seq_recurrent``, ``seq_frontend``): the
    kernel rows of the parts' split shapes (B3's halo row for the
    recurrent stacks, the B2 rank rows for the frontend archs) and the
    seq_sharded phase with those parts, after the device phase's build.
    Prints the same last three lines for those rows."""
    from repro_torch.configs import get_arch

    g = torch.Generator(device="cuda").manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16)

    rows = []
    if "recurrent" in parts:
        rows.append(halo_row(torch, rnd, get_arch(HYBRID_ARCH)))
    if "frontend" in parts:
        rows += rank_b2_rows(torch, rnd, device)
    emit({"phase": "kernels", "row_rtol": BF16_ROW_RTOL, "kernels": rows})
    report = phase_seq_sharded(
        torch, full_width_model(torch) if "dense" in parts else None, parts)
    launches = {"seq_sharded": report["launches"],
                "pipeline": report["pipeline_launches"]}
    for row in rows:
        counter = ROW_COUNTER.get(row["name"], row["name"])
        row["launches"] = sum(launches[path][counter]
                              for path in ROW_PATH[row["name"]])
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def train_sharded_alone(torch, name: str = "train_sharded") -> int:
    """``--only train_sharded`` (``train_tp_sp``): that phase alone, after
    the device phase's build. Prints the same last three lines, its
    kernel line holding the launches of B1, B2 and B4 on the trained
    weights."""
    phase = {"train_sharded": phase_train_sharded,
             "train_tp_sp": phase_train_tp_sp}[name]
    counts = phase(torch)["launches"]
    print(json.dumps({"kernels": [], f"{name}_launches": {
        k: counts[k] for k in PATH_KERNELS[name]}}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv not in (["--only", "sharded"],
                             ["--only", "train_sharded"],
                             ["--only", "train_tp_sp"],
                             *(["--only", k] for k in SEQ_ONLY)):
        print("usage: chip_smoke.py [--only sharded|seq_sharded|"
              "seq_recurrent|seq_frontend|seq_pipeline|train_sharded|"
              "train_tp_sp]",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"error: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build as build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = phase_device(torch, build)
    if argv == ["--only", "sharded"]:
        return sharded_alone(torch)
    if argv[1:] and argv[1] in ("train_sharded", "train_tp_sp"):
        return train_sharded_alone(torch, argv[1])
    if argv:
        return seq_sharded_alone(torch, device, SEQ_ONLY[argv[1]])
    phase_fp32(torch)
    rows = phase_kernels(torch, device)
    full = full_width_model(torch)
    # each path runs with the launch counts set to 0 just before it and
    # read just after; the kernel line reports each row's own path
    launches = {"waves": phase_main_path(torch, full)["launches"]}
    launches["int8_wave"] = phase_int8_wave(torch, full)["launches"]
    launches["continuous"] = phase_continuous(torch, full)["launches"]
    phase_calibration(torch, full)
    launches["int8_continuous"] = phase_int8_continuous(torch,
                                                        full)["launches"]
    report = phase_shared_prefix(torch, full)
    launches["shared_prefix"] = report["launches"]
    launches["shared_prefix_int8"] = report["int8"]["launches"]
    phase_speculative(torch, full)
    launches["speculative"] = full["speculative"]
    launches["speculative_int8"] = full["speculative_int8"]
    phase_spec_parity(torch, full)
    report = phase_sharded(torch, full, ring_verdicts(rows))
    launches["sharded"] = report["launches"]
    launches["sharded_ring"] = report["ring_launches"]
    report = phase_seq_sharded(torch, full)
    launches["seq_sharded"] = report["launches"]
    launches["pipeline"] = report["pipeline_launches"]
    full.clear()              # internlm2's weights out of the later peaks
    torch.cuda.empty_cache()
    launches["launcher"] = phase_launcher(torch)["launches"]
    torch.cuda.empty_cache()
    launches["moe"] = phase_moe(torch)["launches"]
    torch.cuda.empty_cache()
    launches["dense_archs"] = phase_dense_archs(torch)["launches"]
    torch.cuda.empty_cache()
    launches["ssm_wave"] = phase_ssm_wave(torch)["launches"]
    torch.cuda.empty_cache()
    launches["hybrid_wave"] = phase_hybrid_wave(torch)["launches"]
    torch.cuda.empty_cache()
    launches["encdec"] = phase_encdec(torch)["launches"]
    torch.cuda.empty_cache()
    launches["vlm"] = phase_vlm(torch)["launches"]
    torch.cuda.empty_cache()
    launches["train"] = phase_train(torch)["launches"]
    torch.cuda.empty_cache()
    launches["train_sharded"] = phase_train_sharded(torch)["launches"]
    torch.cuda.empty_cache()
    launches["train_tp_sp"] = phase_train_tp_sp(torch)["launches"]
    for row in rows:
        counter = ROW_COUNTER.get(row["name"], row["name"])
        row["launches"] = sum(launches[path][counter]
                              for path in ROW_PATH[row["name"]])
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
