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
   and tensor-core instructions),
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
11. moe — full-width, full-depth deepseek-moe-16b (28 layers, 64
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
12. dense archs — phi4-mini-3.8b (GQA group 3) in waves of 4 x 256 and
   4 x 2048 and 8 continuous requests (B1, B2, B4, B5, B6), then
   deepseek-coder-33b (group 7, untied embeddings, ~66.7 GB) in a 1 x
   2048 wave (B2, B4), full width, each freed before the next; the 33B
   runs at full depth where ``torch.cuda.mem_get_info()`` shows room for
   its weights, its cache and 4 GiB, else at the depth that fits, stated
   as ``reduced``, then qwen3-1.7b (qk-norm, GQA group 2, a 151,936-entry
   vocabulary) as phi4-mini; each wave's first-token logits within
   LOGITS_RTOL of the plain route's;
13. ssm wave — full-width mamba2-130m (random weights from a seed)
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
14. hybrid wave — full-width, full-depth recurrentgemma-9b (38 layers:
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
15. encdec — full-width, full-depth whisper-large-v3 (32 encoder and 32
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
16. vlm — full-width, full-depth internvl2-2b (24 layers, d_model 2048,
   16/8 heads of 128, vocab 92553; bf16, random weights from seed 0;
   1,699,598,336 parameters): 256 random stub patch embeddings before
   each prompt through ``prefill(frontend_embeds=)`` and ``decode_step``
   at positions 256 + i, waves of 4 x (256 + 256) and 4 x (256 + 2048)
   (B2), 16 new tokens each (B4 at group 2): TTFT, decode step, peak
   memory; each wave's first prompt's prefill and a decode step gated
   call by call as above, its first-token logits within LOGITS_RTOL of
   the plain route's; at 2 layers in fp32 the kernel route's tokens
   equal the plain route's;
17. launcher — ``repro_torch.launch.serve.main`` (the documented entry
   point) at full width, internlm2-1.8b, 8 requests on ``cuda``: each
   returns ``--max-new`` tokens in the vocabulary (run after phase 10,
   once internlm2's bf16 weights are freed).

Roofline lines: inside the phases that build each full-width model
(internlm2-1.8b in phase 4, qwen3-1.7b, phi4-mini-3.8b and
deepseek-coder-33b in 12, deepseek-moe-16b in 11, mamba2-130m in 13,
recurrentgemma-9b in 14, whisper-large-v3 in 15 with its encode,
internvl2-2b in 16), one prefill of a wave's prompts (4 x 2048; 1 x 2048
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
waves', B5 and B6 the shared-prefix, moe and dense-arch phases' to the
continuous phase's, the head-dim-256 forms the hybrid wave's, B1, B2 and
B4 also the encdec and vlm phases'; ``mas_streamed_cross``, B2 at a
whisper decode step's cross-attention shape, counts the B2 launches of
the encdec phase's decode steps), the card's
name and power limit, and the result. TF32 is switched off for matrix products and
convolutions so fp32 comparisons see fp32 arithmetic. The script exits
non-zero, printing no result, when there is no CUDA device or no port
beside it, or when any phase fails.
"""

from __future__ import annotations

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
}
ROW_PATH = {"mas_resident": ("waves", "moe", "dense_archs", "encdec",
                             "launcher"),
            "mas_streamed": ("waves", "moe", "dense_archs", "encdec",
                             "vlm"),
            "mas_streamed_cross": ("encdec",),
            "flash": ("waves",),
            "decode": ("waves", "moe", "dense_archs", "encdec", "vlm",
                       "launcher"),
            "decode_int8": ("int8_wave", "encdec"),
            "paged_decode": ("continuous", "shared_prefix", "moe",
                             "dense_archs"),
            "paged_prefill": ("continuous", "shared_prefix", "moe",
                              "dense_archs"),
            "paged_decode_int8": ("int8_continuous", "shared_prefix_int8"),
            "paged_prefill_int8": ("int8_continuous", "shared_prefix_int8"),
            "paged_verify": ("speculative",),
            "paged_verify_int8": ("speculative_int8",),
            "ssd_intra_chunk": ("ssm_wave",),
            "flash_e256": ("hybrid_wave",), "decode_e256": ("hybrid_wave",),
            "decode_e256_int8": ("hybrid_wave",)}

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
# The serving launcher at full width: requests through
# ``repro_torch.launch.serve.main``, its other flags at their defaults.
LAUNCHER_ARCH = ARCH
LAUNCHER_REQUESTS = 8
LAUNCHER_NEW_TOKENS = 8


def emit(obj) -> None:
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
    for quantized in (False, True):
        rows.append(decode_row(torch, rnd, cfg, quantized))
        rows += paged_rows(torch, rnd, cfg, quantized)
    rows.append(ssd_row(torch, device))
    rows += hybrid_rows(torch, rnd, device)
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
        Request,
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
    eng.serve([Request(rid=100 + i, prompt=prompts[i][:40], max_new_tokens=2,
                       eos_id=-1) for i in range(2)])
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
    return report


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
              "launches": launched_kernels(counts)}
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
                  layers: int | None = None, **extra) -> dict:
    """Print one ``{"phase": "roofline", ...}`` line: ``cell_roofline`` of
    a step that took ``ms`` on the card (CUDA events) at ``peak`` bytes of
    device memory; fail unless 0 < roofline_share <= ROOFLINE_MAX and
    0 < mfu <= ROOFLINE_MAX (a count that reads above it is wrong)."""
    from repro_torch.analysis.roofline import cell_roofline

    line = {"phase": "roofline", **cell_roofline({
        "arch": arch, "cell": cell, "device_s": ms / 1e3,
        "peak_memory_bytes": peak, "layers": layers}), **extra}
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


def main() -> int:
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
    for row in rows:
        row["launches"] = sum(launches[path][row["name"]]
                              for path in ROW_PATH[row["name"]])
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
