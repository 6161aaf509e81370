"""Chip smoke test for the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases, each of which must pass (any failure exits non-zero):

1. build    — compile every CUDA kernel source from the repository (flash
              attention, STREAM, dpa_matmul: one nvcc per source, all in
              parallel).
2. kernels  — hold each kernel against its plain PyTorch version on the card
              (and the flash kernel's autograd Function at the train
              shapes, granite-20b's q [4,48,512,128] causal, gemma3-27b's
              [1,32,1024,128] with the 1024 window, zamba2-1.2b's
              [4,32,512,64], whisper-small's encoder [4,12,1500,64]
              non-causal and decoder [4,12,448,64]: its forward equal to
              the bare kernel's bitwise, dq/dk/dv against the plain
              version's own autograd in f32):
              flash attention (D 16/64/128, Hkv = H, 8 and 1, ragged S and
              T, S = 1, T below 64, causal with and without q_offset, a
              window with and without a prefix, 64-row tiles crossing a
              head boundary, bf16 and f32; gemma3-27b's S 2048 and 1500
              prefills with the 1024 window and without, at B 1 and 4,
              a 64-key window at S 2048, qwen3-32b's and
              deepseek-coder-33b's heads, whisper-small's encoder (D 64,
              12:12, non-causal, T 1500) and a decoder chunk, zamba2-1.2b's
              cold 256-token chunk and one at q_offset 256 (32:32)) on the route and tile its plan
              picks (counted by route) and on every route and tile that
              takes the inputs, each by max|err| and by its mask margin
              (nearer the f32 plain version on its own mask than on the
              window or the diagonal one key off), and bf16 views that
              start off a 16-byte boundary (planned onto ffma); the
              six STREAM kernels in f32 and bf16 at the reference tests'
              shapes and every shape the benches give them (read at
              block_rows 8, 16 and 256) and on views off a 16-byte
              boundary; dpa_matmul in its three variants
              at the reference tests' shapes, 512^3, 4096^3 and shapes at
              the edges of its routes (ragged against the tile and the
              stage, M below 64, rows TMA cannot describe), on the
              route and tile its plan picks (dpa4 exactly), every tile of
              the wgmma and FFMA routes at those edges (dpa4's own: K a
              multiple of 16), a forced wgmma launch TMA cannot describe
              (it must raise), dpa4's int8 transpose alone (equal to
              b.t()), and lower-precision controls that its limit must
              reject; the int8 quantized linear against its plain
              composition.
3. bench    — the paper's measurement path: the port's bench_bandwidth,
              bench_peak and bench_launch_latency on the card, three times,
              plus the bandwidth bench's read/write rows, and the
              checkpoint I/O bench (64 MB) once. The launch
              counts are zeroed just before and read just after; every
              STREAM and dpa_matmul kernel must have run, every dpa4
              launch on the wgmma route with its transpose.
4. small    — the smoke models in f32 on the card agree with the same
              weights on the host (plain versions), logits and tokens:
              granite-20b's two-chunk prefill, gemma3-27b's prefill into
              its window rings and a decode past the window. Their prefill
              attention is the f32 path of the flash kernel: the ffma
              route's launches (windowed on gemma3's local layers) are
              zeroed before and read after. Then 3 f32 train steps of
              each family's smoke model (granite-20b, gemma3-27b,
              zamba2-1.2b, whisper-small with frames, xlstm-1.3b,
              deepseek-moe-16b, internvl2-76b with patches) on the card
              against 3 on the host (losses, grad norms, parameters; flash
              launched as the family's remat sites give,
              train_flash_launches: every checkpointed layer twice a step,
              windowed on gemma3's local layers), and step 3 again from a
              checkpoint of step 2, bitwise (at 4096 tokens: after the
              train phase, 11).
5. serve    — granite-20b at its published width (bf16 weights made on the
              card from a seed) through ContinuousEngine: 8 requests, batch
              4, max_seq 512, 32 new tokens each, four sharing a 128-token
              prefix. The flash launch counts are zeroed just before and
              read just after: every prefill layer on the wgmma route,
              none on ffma. Record: right after the serve, its telemetry
              (the windows and the event log that split its joules) goes
              to build/record/serve_granite.dkt through
              tracestore.record_engine; replay_attribution, run twice,
              must give every request its live joules to 1e-6 J and
              equal itself, and replay with the replay CLI's three
              admission policies (baseline, strict-1slot, a 400 W cap on
              the H100_SXM power model), run twice, must give equal
              reports, each policy at or below the trace's joules. Then
              the sharded serve step (serve.step.ShardedServeStep) on a
              one-rank NCCL mesh: a prefill of 4 rows x 256 tokens and 8
              decode steps at per-row positions equal to the model's own
              bit for bit (logits and tokens), one flash launch a layer on
              wgmma.
6. profile  — where the time goes in one full-width decode step and one
              256-token prefill: host time, device-busy time, kernel count.
7. serve_window — granite freed, gemma3-27b at its published width (62
              layers, 52 local with the 1024 window) through
              ContinuousEngine on the window rings: 8 requests, batch 4,
              max_seq 2048, 32 new tokens each; two prompts longer than
              the window, two whose decode crosses it. Flash counted as in
              5: every prefill layer on wgmma, 52 of 62 windowed, at the
              shapes the prompts' buckets give. Recorded and replayed as
              in 5 (build/record/serve_gemma3.dkt: the window-ring
              adapter's slots in its events). Then its profile (a decode
              step, a 2048-token prefill) and the static ServeEngine on the
              same weights (the four long requests in one batch of 4, 16
              tokens each). With gemma3 freed, the planned flash call is
              held as in 2 at every shape the two serves gave it.
8. dense    — qwen3-32b and deepseek-coder-33b at their published widths
              and depths (64 and 62 layers, 65.5 and 66.7 GB of bf16
              weights): a short continuous serve each on the paged path
              (qk_norm and their GQA heads on the card), a flash launch
              a layer a prefill.
8b. serve_long — the reference grid's 32k cells, whole models at max_seq
              32768 (prefill_32k's length, decode at decode_32k's
              positions; batches cut to 4), each freed before the next,
              4 prompts of 32736 tokens and 32 new tokens from numpy seed
              0. First the dry-run's counts (meta device) of each: its
              decode step at batch 4 x 32768 and a one-row 32768-token
              prefill (zamba2's largest chunk too); a model serves at
              batch 4 where the count leaves 5 % of 80 GB free, else at
              batch 2. (a) granite-20b on the paged path, requests 1-3
              sharing request 0's first 16384 tokens: 3 prefix hits, each
              tail in the 16384 bucket at q_offset 16384; gates as 5 (52
              flash launches a prefill on wgmma at the cold bucket's and
              the tails' shapes); then the profile of one cold
              32768-token prefill (kernels only) and the dry-run's count
              of a decode step at position 32767 on a contiguous cache of
              4 x 32768 against the card's (FLOPs equal, peak within 10 %
              of max_memory_allocated). (b) gemma3-27b on its window rings
              (no prefix cache), gates as 7 (62 launches a prefill, 52
              windowed, at the shapes the buckets give). (c) zamba2-1.2b
              through the recurrent-state adapter, 10 pow2 chunks a
              prompt: gates as 9b (signatures within the pow2 sizes, 6
              flash launches a chunk of S >= 2, a second serve on a fresh
              engine the same tokens). Then two f32 holds (TF32 off,
              weights from seed 0): granite-20b at 2 of 52 layers, the
              four requests through the paged engine (prefix hits and
              all) against each prompt through the contiguous path (a cold
              prefill of the whole prompt on a flat cache, then 8 decode
              steps fed the engine's tokens); zamba2-1.2b up to its first
              shared-attention site (6 layers), one prompt's pow2 chunks
              and 8 decode steps against the same prompt in 1024-token
              chunks then its pow2 remainder: logits within 1e-3 of
              max|logit|, a greedy choice differing only under that
              margin.
9. serve_moe — deepseek-moe-16b at its published width and depth (28
              layers: one dense, 27 with 64 routed experts top-6 and 2
              shared; 16.38 B bf16 params made on the card from a seed)
              through ContinuousEngine on the paged path: the serve
              phase's 8 requests at batch 4 (4 routing groups, capacity 1
              a decode step), checked as in 5 with 28 flash launches a
              prefill (MHA 16:16, D 128); the same requests again on a
              fresh engine must emit the same tokens. Then a short serve at
              batch 3 (one routing group of 3 rows, capacity 1: the rows
              compete for experts), its dropped choices counted on the
              device. Then its profile (a decode step, a 256-token
              prefill), and the first MoE layer, cast to f32, on the card
              against the host (TF32 off) for a 256-token prefill group
              (capacity 30) and a 3-token decode group: expert ids, slots
              and keep equal (a token routed differently is allowed only
              where its router probabilities at the top-k cut differ by
              less than 1e-5), the output within 1e-4 of max|y|. With the
              model freed, flash is held as in 2 at every shape the serve
              gave it. Then moonshot-v1-16b-a3b at its published width and
              depth (48 layers, 64 routed experts top-6 + 2 shared, vocab
              163840; 28.39 B bf16 params) serves the same 8 requests
              twice with the same gates (48 flash launches a prefill), and
              is freed; flash is held at its shapes.
9b. serve_recurrent — the card freed, xlstm-1.3b (48 layers: 42 mLSTM,
              6 sLSTM; 3.71 B params), zamba2-1.2b (38 layers: 32 mamba2,
              one shared attention block at 6 sites, 32:32 heads of 64)
              and whisper-small (12 encoder layers over 1500 frames, 12
              decoder layers; 12:12 heads of 64) at their published widths
              and full depth, bf16 weights from seed 0, one after the
              other, through ContinuousEngine on the recurrent-state
              adapter: 8 requests of 100-300 tokens (every other one odd,
              so it ends in a 1-token chunk) at batch 4, 32 new tokens
              each, max_seq 512 (whisper's frames [1500, 768] from a numpy
              seed). Gates: every request at its budget, one decode
              signature, prefill signatures within the pow2 chunk sizes
              (plus the frames variant), host syncs == prefills + decode
              steps, joules to 1e-6 J, a second serve on a fresh engine the
              same tokens, flash launches == attention sites x chunks of S
              >= 2 (+ whisper's 12 encoder launches a request) all on
              wgmma; then 3 requests decoded one at a time and fed the same
              tokens at batch 3, in bf16 (a reading) and with the weights
              cast to f32 (logits within 1e-3 of max|logit|, no greedy
              choice differing above that margin), and each
              family's profile (a decode step, a cold 256-token first
              chunk; xlstm's sLSTM layer over 256 tokens alone); zamba2-1.2b
              also through the sharded serve step on a one-rank NCCL mesh
              (a prefill and 8 decode steps bitwise the model's own, 6
              flash launches on wgmma). With the last model freed, flash is
              held as in 2 at every shape the three serves gave it.
10. vlm     — internvl2-76b at its published width (d_model 8192, 64 q /
              8 kv heads, d_ff 28672), the depth cut to 32 of 80 layers:
              forward over 256 patch embeddings and 256 tokens (logits
              finite, 32 flash launches on wgmma at q [1,64,512,128]), then
              a short text-only serve on the paged path.
11. train   — the card freed, granite-20b at its published width with the
              depth cut to 4 of 52 layers (f32 master weights made on the
              card from a seed, bf16 compute): batch 8 x 512 in 2
              microbatches, 6 steps through train.loop.run. Step 1's
              gradients are read once before the loop (every leaf
              nonzero); flash counts and host syncs are zeroed just before
              the loop and read just after: one compile, one sync a step,
              the joules partitioned by tag, 4 x 2 x 6 x 2 flash launches
              all on wgmma. Then a profiled step. Then, one after the
              other and each freed before the next, the other families at
              their published widths through the same loop and gates
              (TRAIN_FAMILIES; flash launches as train_flash_launches
              derives them from each family's remat sites, a profiled step
              each; an MoE's step-1 gradients read twice, bitwise the
              same): zamba2-1.2b whole (38 layers, 8 x 512, 4 steps),
              whisper-small whole (12 + 12 layers, 8 x 448 tokens over
              1500 frames), xlstm-1.3b whole (48 layers: the dry-run's
              count fits 80 GB; 2 steps, no profiled step), deepseek-moe-16b
              cut to 4 of 28 layers and internvl2-76b to 1 of 80 (4 x 256
              patches + 256 tokens). After its 512 run and profile, each
              of granite-20b, zamba2-1.2b, whisper-small and
              deepseek-moe-16b trains at train_4k's sequence (TRAIN_4K:
              batch 2 x 4096 in 2 microbatches, one row a microbatch, 3
              steps) from the same masters, its AdamW moments zeroed:
              first the dry-run's count of one such step at its depth
              (the train_4k_card cell, counted in a worker process from
              serve_long on) must leave 5 % of 80 GB free, then
              the same gates through its own step, tracer and loop, the
              loop's max_memory_allocated within 10 % of the count and
              under 76 GB, the flash launches at exactly the 4096 shapes
              (whisper's encoder over its frames beside them), and
              deepseek-moe-16b's routing one group of the row's 4096
              tokens with 480 slots an expert in every MoE layer of
              every microbatch; a profiled 4096 step of granite-20b and
              of deepseek-moe-16b. Then the small phase's case at 4096:
              for those four families one f32 step of the smoke model at
              2 x 4096 tokens in 2 microbatches on the card against the
              host (zamba2's SSD over 16 chunks, the flash Function's
              backward over 8 query blocks, whisper's decoder past 448
              positions; the host's half computed in the worker process
              while the card's phases ran), with the small phase's gates
              and the step again from a checkpoint of the initial state.
11b. parallel — the port's parallel layer at one NCCL rank (a one-rank
              process group on a file:// store under build/,
              make_host_mesh(1, 1, 1, "cuda")): the train phase's
              configuration for 3 steps unsharded and, rebuilt from the
              seed, through ShardedTrainStep (losses, grad norms and every
              parameter's f64 sum and bit hash equal; the sharded run's
              flash launches zeroed before and read after: 4 x 2 x 3 x 2,
              all wgmma; one host sync a step); deepseek-moe-16b's MoE
              layer at full width in f32 through expert parallelism
              against the grouped path on that mesh (routing equal, y
              within 1e-5 of max|y|); compress_grads_over_pod on a full
              granite-20b layer's gradients twice (error feedback), card
              against host bitwise, timed by events; tp_layer: the
              sharded step's tensor-parallel algebra at full width on the
              one card, granite-20b's and qwen3-32b's layer 0 (model axis
              16, x [1, 4096, d_model]): each rank's forward on its
              blocks with the all-reduce left out, the 16 partial
              outputs summed, against the unsharded layer in f32 (flash
              on ffma; 1e-4 of max|y|) and bf16 (flash on wgmma at q
              [1,3,4096,128] over one KV head, and qwen3's [1,4,4096,128]
              over the KV head its heads read; 4e-2 of max|y|), flash
              launches by route and shape; tp_serve: the serve cells'
              layout at full width, layer 0 as 16 model ranks against the
              unsharded layer (f32 1e-4, bf16 4e-2 of max|y|): (a)
              granite-20b decode on a 32768-position cache split over
              sequence, 8 rows (three with no valid key past the first
              rank's block), the ranks as threads whose collectives meet
              (query heads gathered, the blocks' partial softmaxes
              combined, wo and the MLP summed), every rank's cache block
              bitwise the unsharded cache's slice; (b) qwen3-32b prefill,
              2 rows, 4 query heads a rank over one KV head on flash
              (bf16 at S 32768 on wgmma, f32 at S 4096 on ffma; 16 rank
              launches and one unsharded), the cache blocks bitwise; (c)
              deepseek-moe-16b's first MoE layer in f32, 4 experts a rank
              summed against the grouped path, routed alike, 1e-5 of
              max|y|; tp_recurrent: the recurrent families' layout at full
              width as 16 model ranks against the unsharded layer (f32
              1e-4, bf16 4e-2 of max|y|): (a) zamba2-1.2b's Mamba2 layer
              0, a decode step of 8 rows and a 256-token chunk, (b)
              xlstm-1.3b's mLSTM layer 0 decode and its first sLSTM layer
              over 64 tokens, (c) whisper-small's decoder layer 0 decode on
              a 4096-position self cache split over sequence (its blocks
              bitwise), each with the ranks as threads, (d) zamba2's shared
              attention decode at long_500k on [1,524288,32,64] bf16 caches
              split over 16 sequence ranks (blocks bitwise), (e) its shared
              attention and MLP prefill as 16 ranks of 2 heads at [1,4096]
              (f32 on ffma, bf16 on wgmma) and [2,32768] (bf16), 16 rank
              launches at q [B,2,S,64] each.
11c. dryrun — the port's dry-run (launch.dryrun: one rank's step on the
              meta device, counted by perf.op_cost) held against the
              card (the counted step's flash launches are the kernels
              line's dryrun_launches of the train row): (a) the train
              phase's configuration through ShardedTrainStep on a
              one-device RankMesh, counted on meta and for one step on
              the card under the same counter: FLOPs equal, 4 x 2 x 2
              flash launches on wgmma, the dry-run's peak within 10 % of
              max_memory_allocated; (b) (in the serve
              phase, before granite is freed, and again in serve_long)
              granite-20b's decode_step at full depth on a contiguous
              cache of batch 4 x 512 at position 511 and of 4 x 32768 at
              position 32767: FLOPs equal on meta and on the card, the
              dry-run's peak within 10 % of max_memory_allocated, the
              memory term beside the profile's device-busy time; (c) the
              depth cuts of PERF.md §4
              against 80 GB (granite-20b trains at 4 layers, not at 52;
              internvl2-76b serves at 32 layers, not at 80; deepseek-moe-16b
              whole; qwen3-32b and deepseek-coder-33b whole at the serve
              phase's shape; serve_long's decode step at 4 x 32768 for
              granite-20b, gemma3-27b and zamba2-1.2b; qwen3-32b's
              one-row 32768-token prefill does not fit;
              the train phase's other families: zamba2-1.2b,
              whisper-small and xlstm-1.3b whole, deepseek-moe-16b at 4
              layers, not 28, internvl2-76b at 1, not 2 or 80); (d) one
              production cell of each family on the 16 x 16
              mesh, each completing, granite-20b's train_4k fitting 80 GB
              a rank with useful >= 0.5, granite-20b's prefill_32k and
              decode_32k and deepseek-moe-16b's decode_32k (the sharded
              serve step) fitting 80 GB a rank ((c) and (d) are counted
              in a worker process from serve_long on); (e)
              (after record_cli) the
              port's linter (repro_torch.analysis --project --baseline
              over its default paths, on the host: rc 0, each rule's
              count and the seconds logged), then the port's regression
              gate on the bench phase's rows, the two replay reports and
              the linter's --gate-json rows: rc 0, 1 (a compiles raised),
              1 (a row slowed 20 %), 0, 0 (the linter's rows against
              themselves), 1 (one rule's findings raised by 1).
12. timing  — each kernel held against its plain version and timed beside
              it, a PyTorch library call computing the same function, and
              its bound on the card: flash at the serve phase's prefill
              shapes on both routes (CUDA events over back-to-back calls,
              and the device time of one call under the profiler for each
              route and tile and for sdpa with a mask and, at q_offset 0,
              with is_causal), at gemma3-27b's S 2048 with the window and
              without, at the train phase's microbatch (B 4, S 512), at
              granite-20b's train_4k tensor-parallel rank (q
              [1,3,4096,128], kv [1,1,4096,128], causal), at qwen3-32b's
              prefill_32k rank (q [2,4,32768,128], kv [2,1,32768,128],
              causal), and
              zamba2-1.2b's train_4k and prefill_32k tensor-parallel ranks
              (q and kv [1,2,4096,64] and [2,2,32768,64], causal),
              deepseek-moe-16b's largest serve prefill (q [1,16,256,128]
              over the 512-position cache view) and internvl2-76b's forward
              (q [1,64,512,128], kv [1,8,512,128]), moonshot-v1-16b-a3b's
              largest serve prefill, whisper-small's
              encoder (non-causal, q and kv [1,12,1500,64], sdpa with no
              mask) and zamba2-1.2b's cold 256-token chunk (q
              [1,32,256,64], kv [1,32,512,64]), every shape the train
              phase's other families gave flash under the gradient, at one
              microbatch (zamba2 [4,32,512,64], whisper's encoder
              [4,12,1500,64] and decoder [4,12,448,64], deepseek-moe
              [4,16,512,128], internvl2 [2,64,512,128] over 8 KV heads;
              the train_4k runs' granite [1,48,4096,128] over one KV head,
              zamba2 [1,32,4096,64], whisper's decoder [1,12,4096,64] and
              deepseek-moe [1,16,4096,128], causal),
              serve_long's shapes over 32768 positions (granite-20b's cold
              q [1,48,32768,128] and its tail [1,48,16384,128] at
              q_offset 16384 over one KV head, gemma3-27b's global and
              local layers at S 32768, zamba2-1.2b's first and last chunk
              [1,32,16384,64] and [1,32,32,64] at q_offset 32704; the
              plain version as many query rows at a time as keep its f32
              scores within 4 GiB; each bf16 query row also held on its
              own scale, a check that must fail the plain version with
              one 64-key V tile zeroed), the ffma route at the
              f32 smoke model's prefill shape, STREAM at 128 MiB f32, dpa_matmul at 512^3
              and 4096^3, dpa4's transpose at 4096^2 on four inputs in
              turn, so that each call reads and writes past the L2 (with
              each kernel's device time under the profiler beside the
              library call's and the names of the kernels it launched, at
              512^3 that of every tile of the wgmma and FFMA routes, and
              for dpa4 the mma route's and the transpose's share). At
              every flash shape the op torch.ops.repro_torch.flash_fwd
              is timed beside its CUDA implementation called directly
              (alternated, the medians of 5 rounds): the host cost of
              the dispatcher.
13. cli     — `python -m repro_torch.launch.serve --arch granite-20b
              --smoke`, `--arch gemma3-27b --smoke --engine static
              --trace-out ...`, `python -m repro_torch.launch.train
              --arch granite-20b --smoke --steps 4 --trace-out ...` (and
              the same for zamba2-1.2b, whisper-small and
              deepseek-moe-16b) and
              `python -m repro_torch.benchmarks.run --only serving` (the
              port's bench_serving) on the card, side by side; each trace
              must validate and partition its run's joules.
14. record_cli — on the host: `python -m repro_torch.launch.record --nodes
              2 --duration 0.5` (a 2-node trace of the paper's topology
              under build/record), then `python -m
              repro_torch.launch.replay <that trace> --ttl 0.3 --cap 150
              --check-determinism` beside `python -m
              repro_torch.benchmarks.run --only energy` (and `elastic`,
              `scheduler`), once each; every one must exit 0.

The line before the last is the kernels JSON, the one before it the card's
name and power limit; the last line is the device JSON.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import time
import types
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32
# without them, HBM3 bandwidth
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12

SERVE = dict(batch=4, max_seq=512, max_new=32, n_shared=4, shared_len=128,
             tails=(20, 90), n_random=4, random_lens=(30, 200), seed=0)


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def card_limit(free_share):
    """The bytes a run on the card may count or peak at: all but
    ``free_share`` of the dry-run's 80 GB card."""
    from repro_torch.launch import dryrun
    return (1 - free_share) * dryrun.H100_SXM.mem_gb * 1e9


def alloc_counts():
    """(segments the caching allocator has taken from the driver, its
    retries after a failed cudaMalloc) so far: a change across a timed
    loop means the loop paid a synchronising cudaMalloc or cache flush."""
    import torch
    stats = torch.cuda.memory_stats()
    return (stats.get("segment.all.allocated", 0),
            stats.get("num_alloc_retries", 0))


def cuda_timed(fn, iters=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


# ---------------------------------------------------------------------------
# phases


def phase_build():
    from repro_torch.kernels import build
    sources = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        paths = list(pool.map(build.build, sources))
    for name in sources:
        build.load(name)
    log(f"[build] {len(sources)} kernel source(s) {sources} built in "
        f"{time.perf_counter() - t0:.1f} s: {[p.name for p in paths]}")
    from repro_torch.kernels.flash_attention import ops as fops
    import torch
    for route, tiles in fops.TILES.items():
        for bm in tiles:
            for dt in ((torch.bfloat16,) if route == "wgmma" else
                       (torch.bfloat16, torch.float32)):
                for d in (64, 128):
                    log(f"[build] flash {route} tile {bm} D{d} "
                        f"{str(dt)[6:]}: "
                        f"{fops.kernel_attributes(route, bm, d, dt)}")
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    for variant, routes in dk.ROUTES.items():
        for route in routes:
            for bm, bn in dk.TILES[route]:
                log(f"[build] dpa_matmul {variant} route {route} tile "
                    f"{bm}x{bn}: {dk.kernel_attributes(variant, route, bm, bn)}")
    return sources


FLASH_CASES = [
    # (B, H, Hkv, S, T, D, causal, window, q_offset)
    (1, 8, 8, 48, 48, 16, True, None, 0),
    (2, 8, 1, 37, 53, 16, True, None, 16),
    (1, 8, 8, 70, 70, 16, False, None, 0),
    (1, 4, 4, 100, 100, 16, True, 24, 0),
    (1, 48, 1, 200, 512, 128, True, None, 128),
    (1, 48, 1, 23, 40, 128, True, None, 17),
    (1, 48, 48, 64, 64, 128, True, None, 0),
    (1, 48, 1, 96, 96, 128, True, 32, 0),
    (1, 48, 1, 33, 77, 128, False, None, 0),
    # the serve phase's prefills at full width: bucket S, T = max_seq, cold
    # (q_offset 0) and after the 128-token prefix hit
    (1, 48, 1, 64, 512, 128, True, None, 0),
    (1, 48, 1, 256, 512, 128, True, None, 0),
    (1, 48, 1, 128, 512, 128, True, None, 128),
    # the wgmma route's edges: 64-row tiles across a head boundary (S 200
    # cold; S 100, S 130), S = 1, T below and not a multiple of the 64-key
    # tile, a window after a prefix, Hkv 8 (g = 6), D 64
    (1, 48, 1, 200, 200, 128, True, None, 0),
    (1, 48, 1, 1, 300, 128, True, None, 299),
    (1, 8, 2, 20, 40, 64, True, None, 20),
    (1, 48, 1, 100, 130, 128, True, None, 30),
    (1, 48, 1, 96, 512, 128, True, 80, 200),
    (1, 48, 8, 130, 300, 128, True, None, 100),
    (2, 48, 8, 77, 77, 64, True, None, 0),
    # gemma3-27b at full width (32 q / 16 kv heads, D 128): a local layer's
    # prefill at S 2048 (packed 64-row tiles of g*S = 4096 rows, window
    # 1024), a global layer's (no window), S 1500 (a window start inside a
    # key tile) and the static engine's batch of 4; qwen3-32b's 64 / 8 and
    # deepseek-coder-33b's 56 / 8 heads
    (1, 32, 16, 2048, 2048, 128, True, 1024, 0),
    (1, 32, 16, 2048, 2048, 128, True, None, 0),
    (1, 32, 16, 1500, 1500, 128, True, 1024, 0),
    (4, 32, 16, 2048, 2048, 128, True, 1024, 0),
    (1, 64, 8, 256, 512, 128, True, None, 0),
    (1, 56, 8, 130, 512, 128, True, None, 128),
    # a 64-key window at S 2048: each visible key weighs about 1/64, so a
    # window edge one key off moves outputs well past the bf16 tolerance
    (1, 32, 16, 2048, 2048, 128, True, 64, 0),
    # the recurrent families' attention at full width, D 64 with g = 1
    # (MHA): whisper-small's encoder (12:12, non-causal, T 1500 = 23 x 64 +
    # 28), a decoder chunk after 128 tokens over its 512-position cache
    # row; zamba2-1.2b's shared attention (32:32), a cold 256-token chunk
    # and a 64-token chunk at q_offset 256
    (1, 12, 12, 1500, 1500, 64, False, None, 0),
    (1, 12, 12, 128, 512, 64, True, None, 128),
    (1, 32, 32, 256, 512, 64, True, None, 0),
    (1, 32, 32, 64, 512, 64, True, None, 256),
]
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the timing rows also hold each bf16 query row on its own scale: max|got -
# want| over a row within this share of the row's max|want|. One bf16 ulp
# of an output is at most 2^-7 (7.8e-3) of it, so a kernel a rounding off
# passes; past a few thousand keys a row's outputs are far under the
# absolute tolerance (about N(0, e/n) over n keys), and this still fails
# a kernel that drops one 64-key tile of V (``planted_tile``)
FLASH_ROW_TOL = 1e-2
FLASH_TILE = 64
# the largest ratio ref.mask_margin may read (a mask one key off reads ~1)
MASK_MARGIN = 0.25


def flash_routes(dt, d):
    """Every (route, tile) of the flash kernel that takes these inputs."""
    from repro_torch.kernels.flash_attention import ops
    return [(r, bm) for r, tiles in ops.TILES.items() for bm in tiles
            if r == "ffma" or (dt == "bfloat16" and d in ops.WGMMA_HEAD_DIMS)]


def phase_kernels():
    """Each FLASH_CASES entry in f32 and bf16: the planned call (its route
    read from the launch counts) and every route and tile that takes the
    inputs, against ``ref.attention``. Returns the largest error of each
    route."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    errs = {}
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        tol = FLASH_TOL[dname]
        for (b, h, hkv, s, t, d, causal, win, off) in FLASH_CASES:
            q = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
            k = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            v = torch.randn(b, hkv, t, d, device="cuda", generator=g).to(dt)
            want = ref.attention(q, k, v, causal=causal, window=win,
                                 q_offset=off).float()
            planned = ops.plan(b, h, hkv, s, t, d, dt, sms)
            before = dict(ops.route_launches)
            got = ops.flash_attention(q, k, v, causal=causal, window=win,
                                      q_offset=off)
            taken = {r: c - before[r] for r, c in ops.route_launches.items()
                     if c != before[r]}
            if taken != {planned[0]: 1}:
                raise AssertionError(f"flash planned {planned}, took "
                                     f"{taken}")
            by_tile = {}
            for route, bm in flash_routes(dname, d):
                out = got if (route, bm) == planned else ops.launch(
                    q, k, v, causal=causal, window=win, q_offset=off,
                    route=route, block_m=bm)
                torch.cuda.synchronize()
                err = (out.float() - want).abs().max().item()
                margin = ref.mask_margin(out, q, k, v, causal=causal,
                                         window=win, q_offset=off)
                by_tile[(route, bm)] = (err, margin)
                errs[route] = max(errs.get(route, 0.0), err)
                if not (err <= tol and margin <= MASK_MARGIN
                        and out.dtype == dt):
                    raise AssertionError(
                        f"flash {route} tile {bm} disagrees at B{b} H{h} "
                        f"Hkv{hkv} S{s} T{t} D{d} {dname}: max|err| {err} "
                        f"(tol {tol}), mask margin {margin} (limit "
                        f"{MASK_MARGIN})")
            log(f"[kernels] flash {dname} B{b} H{h} Hkv{hkv} S{s} T{t} D{d} "
                f"causal={causal} window={win} q_offset={off} (plan "
                f"{planned[0]} tile {planned[1]}): max|err| and mask margin "
                f"by route and tile " + ", ".join(
                    f"{r}/{bm} {e:.3e} {m:.3e}" for (r, bm), (e, m) in
                    by_tile.items()) + f" (tol {tol:g}, margin limit "
                f"{MASK_MARGIN:g})")
    # bf16 at the serve's largest prefill, one of q, k, v a contiguous view
    # that starts one element past a 16-byte boundary: TMA cannot read it,
    # so the plan sends it to ffma
    tol = FLASH_TOL["bfloat16"]
    for which in range(3):
        x = []
        for i, shape in enumerate(((1, 48, 256, 128), (1, 1, 512, 128),
                                   (1, 1, 512, 128))):
            shift = int(i == which)
            x.append(torch.randn(shift + math.prod(shape), device="cuda",
                                 generator=g).to(torch.bfloat16)[shift:]
                     .view(shape))
        before = dict(ops.route_launches)
        got = ops.flash_attention(*x)
        taken = {r: c - before[r] for r, c in ops.route_launches.items()
                 if c != before[r]}
        err = (got.float() - ref.attention(*x).float()).abs().max().item()
        errs["ffma"] = max(errs["ffma"], err)
        log(f"[kernels] flash bf16 with {'qkv'[which]} off a 16-byte "
            f"boundary: took {taken}, max|err| {err:.3e} (tol {tol:g})")
        if taken != {"ffma": 1} or not err <= tol:
            raise AssertionError("an unaligned bf16 view was not planned "
                                 "onto ffma, or disagrees")
    return errs


# the flash kernel under a gradient at the train phase's shape (granite-20b,
# batch 8 in two microbatches of 4, seq 512: causal), at gemma3-27b's (a
# local layer at S 1024 with its 1024 window) and at the recurrent
# families' head dim 64 with MHA: zamba2-1.2b's shared attention (32:32,
# S 512), whisper-small's encoder (12:12, non-causal, S 1500: no multiple
# of the 64-row tile) and its decoder (S 448):
# (B, H, Hkv, S, D, window, causal)
GRAD_CASES = [(4, 48, 1, 512, 128, None, True),
              (1, 32, 16, 1024, 128, 1024, True),
              (4, 32, 32, 512, 64, None, True),
              (4, 12, 12, 1500, 64, None, False),
              (4, 12, 12, 448, 64, None, True)]
# dq, dk, dv of the Function (bf16: the plain f32 recompute, each gradient
# rounded to bf16 once, 2^-9 relative) against the f32 plain autograd on
# the same values: max|err| within this share of max|want|
GRAD_TOL = 1e-2


def hold_flash_function():
    """``ops.FlashAttention`` at GRAD_CASES in bf16: its forward equal to
    the bare kernel's bitwise, its dq, dk, dv against the plain version's
    own autograd in f32 on the same inputs. Returns the largest relative
    error."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(17)
    worst = 0.0
    for (b, h, hkv, s, d, win, causal) in GRAD_CASES:
        q, k, v, do = (torch.randn(b, n, s, d, device="cuda", generator=g)
                       .to(torch.bfloat16) for n in (h, hkv, hkv, h))
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        before = dict(ops.route_launches)
        out = ops.flash_attention(*leaves, window=win, causal=causal)
        taken = {r: c - before[r] for r, c in ops.route_launches.items()
                 if c != before[r]}
        bare = ops.flash_attention(q, k, v, window=win, causal=causal)
        out.backward(do)
        want = [x.float().requires_grad_() for x in (q, k, v)]
        ref.attention(*want, window=win, causal=causal).backward(
            do.float())
        errs = [((x.grad.float() - w.grad).abs().max()
                 / w.grad.abs().max()).item() for x, w in zip(leaves, want)]
        same = torch.equal(out, bare)
        worst = max(worst, *errs)
        log(f"[kernels] flash Function bf16 q[{b},{h},{s},{d}] "
            f"kv[{b},{hkv},{s},{d}] window {win}"
            + ("" if causal else ", non-causal")
            + f": forward on {taken}, equal "
            f"to the bare kernel bitwise {same}; dq, dk, dv max|err| / "
            f"max|want| " + ", ".join(f"{e:.3e}" for e in errs)
            + f" (tol {GRAD_TOL:g}; the f32 plain autograd)")
        if not (same and taken == {"wgmma": 1}
                and all(e <= GRAD_TOL for e in errs)):
            raise AssertionError(f"the flash Function disagrees at B{b} H{h} "
                                 f"Hkv{hkv} S{s} window {win}")
    return worst


# the reference tests' shapes, the bandwidth bench's 64 KB, 1 MB, 16 MB
# and 128 MB, and the launch-latency bench's 8x8 copy
STREAM_SHAPES = [(64, 128), (256, 128), (128, 512), (16, 1024), (256, 1024),
                 (4096, 1024), (32768, 1024), (8, 8)]
STREAM_X = 1.7
# STREAM read sums in another order: held to ref.read_limit per row block
# (1e-5 of sum(|a|), plus one bf16 ulp of the sum where the output is bf16)
READ_BLOCK_ROWS = (8, 16, 256)
# (M, K, N): the reference tests' shapes, the bench's 512^3, 4096^3, then
# the routes' edges: ragged against the wgmma tile and its 64-deep stage,
# M below 64, A or B rows of 200 bytes, which TMA cannot describe, and K
# and N odd (fma_f32's rows not 16-byte aligned: its 4-byte copies)
DPA_SHAPES = [(128, 256, 128), (256, 512, 128), (64, 128, 64),
              (512, 512, 512), (4096, 4096, 4096), (96, 200, 640),
              (8, 128, 64), (64, 100, 64), (64, 64, 100), (72, 99, 117)]
# every tile of the wgmma and FFMA routes is held at these: one 64^3
# tile, the edges above, a shape ragged every way, and 4096^3
DPA_TILE_SHAPES = [(64, 64, 64), (96, 200, 640), (8, 128, 64),
                   (300, 1000, 520), (4096, 4096, 4096)]
# dpa4 on wgmma takes K % 16 == 0 and any M and N: one 64^3 tile, M and N
# ragged against both tiles (K 16 x 63), M below 64 (K 16 x 13), K 16 x 7
# with M and N odd (the transpose's byte loads, the epilogue's single
# stores), and 4096^3
DPA4_TILE_SHAPES = [(64, 64, 64), (300, 1008, 520), (8, 208, 72),
                    (72, 112, 117), (4096, 4096, 4096)]
DPA_NEW_ROUTES = (("dpa2", "wgmma"), ("fma_f32", "ffma"), ("dpa4", "wgmma"))
# (K, N) of dpa4's transpose alone: ragged against its 128 x 128 tile, N
# not a multiple of 16, and 4096^2; the last also from an offset view
TRANSPOSE_SHAPES = [(16, 1), (112, 117), (208, 72), (1008, 520),
                    (4096, 4096)]
DPA_IN = {"fma_f32": "float32", "dpa2": "bfloat16", "dpa4": "int8"}
# the line of each STREAM function that reaches pl.pallas_call
STREAM_REPLACES = {"stream_copy": 53, "stream_scale": 61, "stream_add": 72,
                   "stream_triad": 80, "stream_write": 91, "stream_read": 103}
DPA_NAMES = tuple(f"dpa_matmul/{v}" for v in DPA_IN)
TRANSPOSE_NAME = "dpa_matmul/dpa4_transpose"


def _max_err(got, want) -> float:
    return (got.double() - want.double()).abs().max().item()


def stream_held(a, b, errs):
    """Each STREAM kernel against its plain version on (a, b); copy,
    scale, add, triad and write must be equal (the kernel rounds after each
    operation as eager PyTorch does), read within ``ref.read_limit`` per
    row block at each of READ_BLOCK_ROWS."""
    import torch
    from repro_torch.kernels.stream import ref, stream as sk
    x, shape, dt = STREAM_X, tuple(a.shape), a.dtype
    pairs = {
        "stream_copy": (sk.stream_copy(a), ref.copy(a)),
        "stream_scale": (sk.stream_scale(a, x), ref.scale(a, x)),
        "stream_add": (sk.stream_add(a, b), ref.add(a, b)),
        "stream_triad": (sk.stream_triad(a, b, x), ref.triad(a, b, x)),
        "stream_write": (sk.stream_write(shape, x, dt),
                         ref.write(shape, x, dt, "cuda")),
    }
    dname = str(dt).replace("torch.", "")
    read_err = 0.0
    for name, (got, want) in pairs.items():
        err = _max_err(got, want)
        errs[name] = max(errs.get(name, 0.0), err)
        if not (got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(got, want)):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"at {shape} {dname}: max|err| {err}")
    for br in READ_BLOCK_ROWS:
        got, want = sk.stream_read(a, block_rows=br), ref.read(a, br)
        err = _max_err(got, want)
        read_err = max(read_err, err)
        errs["stream_read"] = max(errs.get("stream_read", 0.0), err)
        ok = bool(((got.float() - want.float()).abs()
                   <= ref.read_limit(a, want, br)).all().item())
        if not (ok and got.shape == want.shape and got.dtype == want.dtype):
            raise AssertionError(f"stream_read disagrees at {shape} {dname} "
                                 f"block_rows {br}: max|err| {err}")
    log(f"[kernels] stream {dname} {shape}: copy/scale/add/triad/write "
        f"equal to plain; read max|err| {read_err:.3e} (within "
        f"ref.read_limit at block_rows {READ_BLOCK_ROWS})")


def dpa_inputs(m, k, n, variant, g):
    import torch
    if variant == "dpa4":
        return (torch.randint(-127, 128, (m, k), device="cuda", generator=g,
                              dtype=torch.int8),
                torch.randint(-127, 128, (k, n), device="cuda", generator=g,
                              dtype=torch.int8))
    dt = getattr(torch, DPA_IN[variant])
    return (torch.randn(m, k, device="cuda", generator=g).to(dt),
            torch.randn(k, n, device="cuda", generator=g).to(dt))


def dpa_limit(a, b, want):
    """The largest |got - want| allowed for fma_f32 and dpa2: the reference
    test's atol 4e-5 + rtol (1e-5*sqrt(k) + 1e-6) times max(|want|,
    (|a| @ |b|) / sqrt(k)). Only the f32 summation order differs; the
    second term of the max is the typical size of a sum of k terms of
    random sign, which |want| falls below where the sum cancels (at
    k = 4096 that is where the reference's own rule is too tight)."""
    import torch
    k = a.shape[1]
    scale = torch.maximum(want.abs(),
                          (a.float().abs() @ b.float().abs()) / k ** 0.5)
    return 4e-5 + (1e-5 * k ** 0.5 + 1e-6) * scale


def dpa_held(a, b, variant, errs, tile=None):
    """The kernel against its plain version: dpa4 equal; fma_f32 and dpa2
    within ``dpa_limit``. ``tile`` (route, bm, bn) launches that plan in
    place of the one ``dpa_matmul`` picks."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    got = (dk.launch(a, b, variant, *tile) if tile else
           dk.dpa_matmul(a, b, variant=variant))
    want = ref.matmul(a, b, variant)
    err = _max_err(got, want)
    name = f"dpa_matmul/{variant}"
    errs[name] = max(errs.get(name, 0.0), err)
    if variant == "dpa4":
        ok = got.dtype == torch.int32 and torch.equal(got, want)
    else:
        ok = got.dtype == torch.float32 and bool(
            ((got - want).abs() <= dpa_limit(a, b, want)).all().item())
    if not ok:
        raise AssertionError(f"{name} disagrees at {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}: max|err| {err}")
    return err


def dpa_controls(g):
    """``dpa_limit`` must reject a result of lower precision than the
    kernel's: fma_f32 against torch.mm with TF32 on (10-bit mantissa
    inputs), dpa2 against its own output rounded to bf16. Each control must
    exceed the limit somewhere, or the limit is too loose to catch it."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    for size in (512, 4096):
        for variant in ("fma_f32", "dpa2"):
            a, b = dpa_inputs(size, size, size, variant, g)
            want = ref.matmul(a, b, variant)
            got = dk.dpa_matmul(a, b, variant=variant)
            if variant == "fma_f32":
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    low = torch.mm(a, b)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
                what = "torch.mm with TF32"
            else:
                low = got.bfloat16().float()
                what = "the kernel's output rounded to bf16"
            limit = dpa_limit(a, b, want)
            over = ((low - want).abs() > limit).float().mean().item()
            log(f"[kernels] dpa_matmul {variant} {size}^3 control ({what}): "
                f"max|err| {_max_err(low, want):.3e}, {over:.1%} of entries "
                f"over the limit; the kernel: max|err| "
                f"{_max_err(got, want):.3e}; limit {limit.min().item():.3e}"
                f"-{limit.max().item():.3e}")
            if not over > 0:
                raise AssertionError(f"dpa_limit lets {what} through at "
                                     f"{size}^3")


def transpose_held(g, errs):
    """dpa4's int8 transpose alone against ``b.t().contiguous()``, bitwise,
    at TRANSPOSE_SHAPES and on a view of the last one off a 16-byte
    boundary (its byte loads)."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    cases = [(k, n, 0) for k, n in TRANSPOSE_SHAPES]
    cases.append(TRANSPOSE_SHAPES[-1] + (1,))
    for k, n, shift in cases:
        b = torch.randint(-128, 128, (shift + k * n,), device="cuda",
                          generator=g, dtype=torch.int8)[shift:].view(k, n)
        got, want = dk.transpose_int8(b), b.t().contiguous()
        if not torch.equal(got, want):
            raise AssertionError(f"the int8 transpose disagrees at K {k} "
                                 f"N {n} (offset {shift})")
    errs[TRANSPOSE_NAME] = 0.0
    log(f"[kernels] dpa4 transpose (K, N, offset) {cases}: equal to "
        f"b.t().contiguous()")


def phase_kernels_measurement():
    """STREAM, dpa_matmul and the quantized linear against their plain
    versions; returns the largest error of each kernel."""
    import torch
    from repro_torch.kernels.dpa_matmul import (dpa_matmul as dk, ops as
                                                dpa_ops, ref as dpa_ref)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    errs = {}
    for dname in ("float32", "bfloat16"):
        for shape in STREAM_SHAPES:
            a = torch.randn(shape, device="cuda", generator=g).to(
                getattr(torch, dname))
            b = torch.randn(shape, device="cuda", generator=g).to(a.dtype)
            stream_held(a, b, errs)
        # contiguous views one element past a 16-byte boundary: the
        # kernels' single-element path
        for which in range(2):
            a, b = (torch.randn(int(i == which) + 64 * 1000, device="cuda",
                                generator=g).to(getattr(torch, dname))
                    [int(i == which):].view(64, 1000) for i in range(2))
            log(f"[kernels] stream {dname}: {'ab'[which]} off a 16-byte "
                f"boundary")
            stream_held(a, b, errs)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for variant in DPA_IN:
        for m, k, n in DPA_SHAPES:
            a, b = dpa_inputs(m, k, n, variant, g)
            err = dpa_held(a, b, variant, errs)
            route, bm, bn = dk.plan(m, n, k, variant, sms)
            log(f"[kernels] dpa_matmul {variant} {m}x{k}x{n} (route {route}, "
                f"tile {bm}x{bn}, {-(-m // bm) * -(-n // bn)} blocks): "
                f"max|err| {err:.3e}" + (
                    " (exact required)" if variant == "dpa4" else
                    f" (atol 4e-5, rtol {1e-5 * k ** 0.5 + 1e-6:.2e} of "
                    f"max(|want|, |a|@|b|/sqrt(k)))"))
    for variant, route in DPA_NEW_ROUTES:
        # odd K and N only where the route takes rows of any alignment
        shapes = (DPA4_TILE_SHAPES if variant == "dpa4" else
                  DPA_TILE_SHAPES + ([(72, 99, 117)] if route == "ffma"
                                     else []))
        for bm, bn in dk.TILES[route]:
            worst = max(dpa_held(*dpa_inputs(m, k, n, variant, g), variant,
                                 errs, tile=(route, bm, bn))
                        for m, k, n in shapes)
            log(f"[kernels] dpa_matmul {variant} route {route} tile "
                f"{bm}x{bn} at {shapes}: max|err| {worst:.3e} "
                + ("(exact required)" if variant == "dpa4" else
                   "(within dpa_limit)"))
    for variant, (m, k, n) in (("dpa2", (64, 100, 64)),
                               ("dpa2", (64, 64, 100)),
                               ("dpa4", (64, 200, 64))):
        a, b = dpa_inputs(m, k, n, variant, g)
        try:
            dk.launch(a, b, variant, "wgmma", 64, 64)
        except RuntimeError as e:
            log(f"[kernels] dpa_matmul {variant} wgmma refuses "
                f"{m}x{k}x{n}: {e}")
        else:
            raise AssertionError(f"the {variant} wgmma route took "
                                 f"{m}x{k}x{n}, whose rows TMA cannot "
                                 f"describe")
    transpose_held(g, errs)
    dpa_controls(g)
    for m, k, n in ((64, 128, 64), (512, 4096, 4096)):
        x = torch.randn(m, k, device="cuda", generator=g)
        w = torch.randn(k, n, device="cuda", generator=g) / k ** 0.5
        before = dict(dk.route_launches)
        got = dpa_ops.quantized_linear(x, w)
        taken = {r: c - before[r] for r, c in dk.route_launches.items()
                 if c != before[r]}
        xq, xs = dpa_ops.quantize_int8(x, axis=1)
        wq, ws = dpa_ops.quantize_int8(w, axis=0)
        want = dpa_ref.matmul(xq, wq, "dpa4").float() * xs * ws
        ok = torch.equal(got, want) and taken == {"dpa4/wgmma": 1}
        log(f"[kernels] quantized_linear {m}x{k}x{n} (route {taken}): "
            f"equal to its plain composition {torch.equal(got, want)}")
        if not ok:
            raise AssertionError("quantized_linear disagrees with its plain "
                                 "composition or left the wgmma route")
    torch.cuda.synchronize()
    return errs


BENCH_REPEATS = 3
# the regression gate's inputs: the bench phase's rows and the record_cli
# phase's two replay reports
GATE_DIR = ROOT / "build" / "gate"


def phase_bench():
    """The paper's measurement path on the card: the port's three benches
    (each BENCH_REPEATS times), then the bandwidth bench's read and write
    rows (its docstring names them; the reference's code emits
    copy/scale/add/triad only). Launch counts: zeroed before, read after."""
    import functools
    import torch
    from repro_torch.benchmarks import (bench_bandwidth,
                                        bench_checkpoint_io,
                                        bench_launch_latency, bench_peak)
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    from repro_torch.kernels.stream import stream as sk
    readings, first = {}, {}
    for name in sk.launches:
        sk.launches[name] = 0                 # the bench path starts here
    for name in dk.launches:
        dk.launches[name] = 0
    for name in dk.route_launches:
        dk.route_launches[name] = 0
    dk.transposes["launches"] = 0
    t0 = time.perf_counter()
    for rep in range(BENCH_REPEATS):
        for bench in (bench_bandwidth.run, bench_peak.run,
                      bench_launch_latency.run,
                      functools.partial(bench_bandwidth.run,
                                        ops=("read", "write"))):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rows = bench()
            for line in buf.getvalue().splitlines():
                log(f"[bench] run {rep}: {line}")
            for name, row in rows.rows.items():
                readings.setdefault(name, []).append(row)
            if rep == 0:
                first.update(rows.rows)
    torch.cuda.synchronize()
    # the first run's rows, as ``--json`` writes them: the dryrun phase's
    # regression gate reads them
    GATE_DIR.mkdir(parents=True, exist_ok=True)
    (GATE_DIR / "bench_rows.json").write_text(json.dumps(first, indent=2))
    launches = {name: sk.launches[name] for name in STREAM_REPLACES}
    launches.update({f"dpa_matmul/{v}": dk.launches[v] for v in DPA_IN})
    routes = dict(dk.route_launches)
    launches[TRANSPOSE_NAME] = dk.transposes["launches"]
    # ... and ends here
    log(f"[bench] {BENCH_REPEATS} runs in {time.perf_counter() - t0:.1f} s; "
        f"launches on the bench path: {launches}; dpa_matmul by route: "
        f"{routes}")
    for name, rows in readings.items():
        us = sorted(r["us_per_call"] for r in rows)
        log(f"[bench] spread {name}: us_per_call min {us[0]:.1f} median "
            f"{us[len(us) // 2]:.1f} max {us[-1]:.1f} over {len(us)} runs; "
            f"derived {[r['derived'] for r in rows]}")
    missing = [n for n, c in {**launches, "dpa_matmul/dpa2/wgmma":
                              routes["dpa2/wgmma"]}.items() if c <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the bench path: "
                             f"{missing}")
    # every dpa4 launch on wgmma, each with its transpose
    if not (routes["dpa4/mma"] == 0
            and routes["dpa4/wgmma"] == launches["dpa_matmul/dpa4"]
            == launches[TRANSPOSE_NAME]):
        raise AssertionError(f"dpa4 on the bench path: routes {routes}, "
                             f"transposes {launches[TRANSPOSE_NAME]}")
    # paper Fig. 9: checkpoint I/O of a 64 MB leaf and 256 small ones held
    # on the card, once (no kernel of the port runs in it)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rows = bench_checkpoint_io.run()
    for line in buf.getvalue().splitlines():
        log(f"[bench] checkpoint I/O: {line}")
    if len(rows.rows) != 4:
        raise AssertionError(f"bench_checkpoint_io gave rows {rows.rows}")
    return launches


def phase_small():
    """Smoke models, f32: the card (flash kernel) against the host (plain
    versions) on the same weights and tokens. granite-20b's prefills a
    prompt in two chunks (the second after a 29-token prefix); gemma3-27b's
    (window 32, max_seq 64) prefills 40 tokens into its rings and decodes
    12 greedy steps past the window. The prefill attention is the f32 path
    of the flash kernel, windowed on gemma3's local layers: the launch
    counts are zeroed before and read after."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_smoke("granite-20b").replace(dtype="float32")
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(1), "cpu")
    gpu = _to_cuda(cpu)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 37))
    out = {}
    zero_flash_counts()                            # the f32 path starts here
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        caches = model.init_cache(1, 64, torch.float32, device=dev)
        t = torch.as_tensor(toks, device=dev)
        logits, caches = model.prefill(params, {"tokens": t[:, :29]}, caches)
        logits2, caches = model.prefill(params, {"tokens": t[:, 29:]}, caches,
                                        start_pos=29)
        out[name] = (logits.cpu(), logits2.cpu())
    err = max((a - b).abs().max().item()
              for a, b in zip(out["cpu"], out["cuda"]))
    same_tok = all(torch.equal(a.argmax(-1), b.argmax(-1))
                   for a, b in zip(out["cpu"], out["cuda"]))
    finite = all(torch.isfinite(x).all().item() for x in out["cuda"])
    routes = dict(flash_ops.route_launches)
    log(f"[small] {cfg.name} f32 card vs host: max|logit err| {err:.3e} "
        f"(tol 1e-4), same argmax {same_tok}, finite {finite}; flash "
        f"launches by route {routes}")
    if not (err <= 1e-4 and same_tok and finite):
        raise AssertionError("card and host disagree on the smoke model")
    # two prefills of each layer, all f32: the ffma route only
    if routes != {"ffma": 2 * cfg.num_layers, "wgmma": 0}:
        raise AssertionError(f"the f32 path took flash routes {routes}")

    wcfg = configs.get_smoke("gemma3-27b").replace(dtype="float32")
    wmodel = build_model(wcfg)
    cpu = wmodel.init(torch.Generator().manual_seed(2), "cpu")
    gpu = _to_cuda(cpu)
    prompt = np.random.default_rng(2).integers(0, wcfg.vocab_size, (1, 40))
    out = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        caches = wmodel.init_cache(1, 64, torch.float32, device=dev)
        logits, caches = wmodel.prefill(
            params, {"tokens": torch.as_tensor(prompt, device=dev)}, caches)
        steps = [logits.cpu()]
        tok = logits.argmax(-1)
        for i in range(12):
            logits, caches = wmodel.decode_step(
                params, tok, torch.full((1,), 40 + i, device=dev), caches)
            steps.append(logits.cpu())
            tok = logits.argmax(-1)
        out[name] = steps
    werr = max((a - b).abs().max().item()
               for a, b in zip(out["cpu"], out["cuda"]))
    wsame = [int(a.argmax()) for a in out["cpu"]] == \
        [int(b.argmax()) for b in out["cuda"]]
    wfinite = all(torch.isfinite(x).all().item() for x in out["cuda"])
    wroutes = dict(flash_ops.route_launches)       # ... and ends here
    windowed = flash_ops.window_launches
    n_local = int((~layer_flags(wcfg)).sum())
    log(f"[small] {wcfg.name} f32 (window {wcfg.sliding_window}) card vs "
        f"host, prefill of 40 and 12 decode steps to position 52: max|logit "
        f"err| {werr:.3e} (tol 1e-4), same tokens {wsame}, finite "
        f"{wfinite}; flash launches by route {wroutes} (the phase), "
        f"windowed {windowed}")
    if not (werr <= 1e-4 and wsame and wfinite):
        raise AssertionError("card and host disagree on the window model")
    if (wroutes != {"ffma": routes["ffma"] + wcfg.num_layers, "wgmma": 0}
            or windowed != n_local):
        raise AssertionError(f"the gemma3 f32 prefill took flash routes "
                             f"{wroutes}, {windowed} windowed")
    n_f32 = wroutes["ffma"]
    for arch in SMALL_TRAIN_ARCHS:
        small_train(arch, SMALL_TRAIN, small_host_steps(arch, SMALL_TRAIN))
    # the first granite prefill's flash shape: q [1,H,29,D], kv [1,Hkv,64,D]
    return n_f32, (cfg.num_heads, cfg.num_kv_heads, 29, 64, cfg.head_dim)


SMALL_TRAIN = dict(steps=3, batch=4, seq=48, micro=1, seed=3,
                   opt=dict(lr=1e-3, warmup_steps=2, total_steps=10))
# the same at train_4k's sequence for TRAIN_4K's families: one step of 2
# rows x 4096 in 2 microbatches (zamba2's SSD over 16 chunks, the flash
# Function's backward over 8 query blocks, whisper's decoder past 448
# positions); the checkpoint is then the initial state's. The host's half
# (100-140 s of the card machine's host at 4 or more threads) runs in the
# worker process (``start_host_work``) with ``host_threads`` threads, few,
# beside the card's phases, and the card's half after the train phase
SMALL_TRAIN_4K = dict(SMALL_TRAIN, steps=1, batch=2, seq=4096, micro=2,
                      host_threads=2)
# every family's smoke model: the dense two, the recurrent three, the MoE
# and the VLM
SMALL_TRAIN_ARCHS = ("granite-20b", "gemma3-27b", "zamba2-1.2b",
                     "whisper-small", "xlstm-1.3b", "deepseek-moe-16b",
                     "internvl2-76b")
# 3 f32 train steps, the card against the host: losses and grad norms
# within 1e-4 relative; parameters: all but 1e-4 of the elements within
# 2e-5 and every one within twice the summed learning rate (an AdamW step
# moves an element by about lr whatever its gradient's size, so an element
# whose gradient is near zero may step the other way when the two sides'
# f32 sums differ in the last bits; the host tests hold the port against
# the reference by the same rule)
SMALL_TRAIN_TOL = dict(rtol=1e-4, atol=2e-5, share=1e-4)


def small_setup(arch, c):
    """(cfg, model, f32 params on the host made from ``c``'s seed, the
    train step, the batches) of ``small_train``'s smoke model."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.step import StepConfig, make_train_step
    cfg = configs.get_smoke(arch).replace(dtype="float32")
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(c["seed"]), "cpu",
                      dtype=torch.float32)
    step = make_train_step(model, OptConfig(**c["opt"]),
                           StepConfig(num_microbatches=c["micro"]))
    data = SyntheticTokens(DataConfig(seed=c["seed"],
                                      vocab_size=cfg.vocab_size,
                                      seq_len=c["seq"],
                                      global_batch=c["batch"]), cfg)
    return cfg, model, host, step, [data.batch(i) for i in range(c["steps"])]


def small_host_steps(arch, c):
    """The host's half of ``small_train``: ([(loss, grad norm)] a step,
    the parameters after the last step, seconds). Device-free, so it may
    run in the worker process (``start_host_work``), with
    ``c["host_threads"]`` intra-op threads where ``c`` names them."""
    import torch
    from repro_torch.data.pipeline import batch_to_device
    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.step import TrainState
    if "host_threads" in c:
        torch.set_num_threads(c["host_threads"])
    t0 = time.perf_counter()
    _, _, params, step, batches = small_setup(arch, c)
    state = TrainState(params, init_opt_state(params))
    hist = []
    for b in batches:
        state, m = step(state, batch_to_device(b, "cpu"))
        hist.append((float(m["loss"]), float(m["grad_norm"])))
    return hist, state.params, time.perf_counter() - t0


def small_train(arch, c, host):
    """The smoke model in f32, ``c``'s train steps on the card and on the
    host from the same weights and batches (gemma3's local layers take the
    flash kernel's window mode under the gradient; whisper's batches carry
    frames, the VLM's patches); then a checkpoint of the card's state
    written before the last step and restored gives the same last step.
    ``host``: the host's half, what ``small_host_steps`` returned."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.checkpoint import ckpt
    from repro_torch.data.pipeline import batch_to_device
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             lr_schedule, tree_leaves)
    from repro_torch.train.step import TrainState
    tol = SMALL_TRAIN_TOL
    cfg, model, params, step, batches = small_setup(arch, c)
    card = _to_cuda(params)
    del params
    with tempfile.TemporaryDirectory() as tmp:
        state = TrainState(card, init_opt_state(card))
        zero_flash_counts()                      # the card's steps start
        ch = []
        for i, b in enumerate(batches):
            if i == c["steps"] - 1:
                ckpt.save(state, tmp, i)
            state, m = step(state, batch_to_device(b, "cuda"))
            ch.append((float(m["loss"]), float(m["grad_norm"])))
        n, routes, windowed = flash_counts()      # ... and end here
        like = TrainState(card, init_opt_state(card))
        restored, manifest = ckpt.restore(like, tmp)
        again, m = step(restored, batch_to_device(batches[-1], "cuda"))
    hh, host_params, host_s = host
    hist_err = max(abs(a - b) / max(abs(a), 1e-30)
                   for x, y in zip(hh, ch) for a, b in zip(x, y))
    diffs = torch.cat([(a.cpu() - b).abs().flatten() for a, b in zip(
        tree_leaves(state.params), tree_leaves(host_params))])
    lr_sum = sum(float(lr_schedule(OptConfig(**c["opt"]), torch.tensor(i)))
                 for i in range(1, c["steps"] + 1))
    over = (diffs > tol["atol"]).float().mean().item()
    replay = [float(m["loss"]), float(m["grad_norm"])]
    replay_same = replay == list(ch[-1]) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(again.params),
                                          tree_leaves(state.params)))
    n_local = int((~layer_flags(cfg)).sum())
    want_flash = train_flash_launches(cfg, model, c["micro"], c["steps"])
    last = c["steps"]
    what = arch if c is SMALL_TRAIN else (
        f"{arch} at {c['batch']} x {c['seq']} in {c['micro']} microbatches")
    log(f"[small] {cfg.name} f32, {c['steps']} train steps at "
        f"{c['batch']} x {c['seq']} in {c['micro']} microbatches, card vs "
        f"host: losses / grad norms card {ch}, host {hh}: max rel err "
        f"{hist_err:.3e} (tol {tol['rtol']:g}); params max|err| "
        f"{diffs.max().item():.3e} (all within {2 * lr_sum:.3e}), share "
        f"over {tol['atol']:g} {over:.2e} (limit {tol['share']:g}); "
        f"flash launches {n} by route {routes}, windowed {windowed}; step "
        f"{last} after restoring the step-{last - 1} checkpoint (manifest "
        f"step {manifest['step']}) {replay}: the same bitwise {replay_same}; "
        f"the host's steps in {host_s:.1f} s"
        + (f" at {c['host_threads']} threads" if "host_threads" in c
           else ""))
    check_all("small", {
        f"{what}: train losses and grad norms, card == host (1e-4)": (
            hist_err <= tol["rtol"]
            and all(np.isfinite(x) for r in ch for x in r)),
        f"{what}: train params, card == host": (
            diffs.max().item() <= 2 * lr_sum and over <= tol["share"]),
        f"{what}: flash launches == {want_flash} (train_flash_launches: "
        f"{cfg.family}, {c['steps']} steps), all ffma": (
            n == want_flash and routes == {"ffma": n, "wgmma": 0}),
        f"{what}: windowed launches == local layers x microbatches x "
        f"steps x 2": (windowed == n_local * c["micro"] * c["steps"] * 2),
        f"{what}: step {last} from the step-{last - 1} checkpoint == step "
        f"{last}": replay_same,
    })


def zero_flash_counts():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    flash_ops.launches = 0
    flash_ops.window_launches = 0
    for route in flash_ops.route_launches:
        flash_ops.route_launches[route] = 0


def flash_counts():
    """(launches, by route, windowed) of the flash kernel since the last
    ``zero_flash_counts``."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    return (flash_ops.launches, dict(flash_ops.route_launches),
            flash_ops.window_launches)


@contextlib.contextmanager
def flash_shapes():
    """A Counter of the flash kernel's launches inside the block at each
    (B, H, Hkv, S, T, D, causal, window, q_offset)."""
    import collections
    from repro_torch.kernels.flash_attention import ops as flash_ops
    seen = collections.Counter()
    launch = flash_ops._launch

    def spy(q, k, v, causal, window, q_offset, route, block_m):
        b, h, s, d = q.shape
        seen[(b, h, k.shape[1], s, k.shape[2], d, bool(causal), window,
              int(q_offset))] += 1
        return launch(q, k, v, causal, window, q_offset, route, block_m)

    flash_ops._launch = spy
    try:
        yield seen
    finally:
        flash_ops._launch = launch


def window_shapes(cfg, batch, buckets, lens, max_seq):
    """The flash shapes a gemma3 prefill of a batch right-padded to the
    bucket of each length gives the kernel: the local layers attend over
    their own keys with the window, the global ones over the cache row of
    ``max_seq`` with none."""
    from repro_torch.serve.step import bucket_for
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    out = set()
    for n in lens:
        s = bucket_for(n, buckets)
        out.add((batch, h, hkv, s, s, d, True, cfg.sliding_window, 0))
        out.add((batch, h, hkv, s, max_seq, d, True, None, 0))
    return out


def layer_flags(cfg):
    from repro_torch.models.transformer import layer_flags as flags
    return flags(cfg)


def serve_requests(vocab):
    import numpy as np
    from repro_torch.serve.engine import Request
    c = SERVE
    rng = np.random.default_rng(c["seed"])
    shared = rng.integers(0, vocab, c["shared_len"]).astype(np.int32)
    reqs = []
    for i in range(c["n_shared"]):
        tail = rng.integers(0, vocab, int(rng.integers(*c["tails"]))
                            ).astype(np.int32)
        reqs.append(np.concatenate([shared, tail]))
    for _ in range(c["n_random"]):
        reqs.append(rng.integers(0, vocab, int(rng.integers(
            *c["random_lens"]))).astype(np.int32))
    return [Request(i, p, max_new_tokens=c["max_new"])
            for i, p in enumerate(reqs)]


def counted_path(fn):
    """Run ``fn`` with the flash counts zeroed just before and read just
    after, counting the host syncs (a serve's designed ones are one per
    prefill, the first token, and one per decode step, the [B, 1] token
    fetch; the train loop's one per step, its metrics) and logging where
    each came from. Returns (fn's result, wall s, host syncs, flash
    counts)."""
    import collections
    import traceback
    import torch
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        # where each sync came from: the last frames of this package's
        # (and the port's) code on the stack when it warned
        if "synchronizing CUDA operation" in str(message):
            frames = [f for f in traceback.extract_stack()[:-1]
                      if "warnings" not in f.filename]
            sites[" < ".join(f"{pathlib.Path(f.filename).name}:{f.lineno}"
                             for f in frames[-4:])] += 1

    zero_flash_counts()                          # the main path starts here
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = flash_counts()                      # ... and ends here
    n_syncs = sum(sites.values())
    log(f"[syncs] {n_syncs} host syncs by site (innermost last): "
        + "; ".join(f"{n} x {site}" for site, n in sites.most_common(4)))
    return out, wall, n_syncs, counts


def joule_partition_error(eng, reqs) -> float:
    """|sum of the requests' joules - the slot tags' energy| of a run."""
    import numpy as np
    slot_tags = {eng.tel.slot_tag(i) for i in range(eng.batch_size)}
    slot_j = 0.0
    for blk in eng.tel.session.blocks():
        m = np.zeros(blk.n, bool)
        for tag in slot_tags:
            m |= blk.tag_mask(tag)
        slot_j += float((blk.watts * blk.dt)[m].sum())
    return abs(sum(r.energy_j for r in reqs) - slot_j)


def check_all(label, checks):
    for name, ok in checks.items():
        log(f"[{label}] check {name}: {'ok' if ok else 'FAILED'}")
    if not all(checks.values()):
        raise AssertionError(f"{label} checks failed: "
                             f"{[n for n, ok in checks.items() if not ok]}")


# the record phase: a full-width serve's telemetry (the windows and the
# event log that partitioned its joules) to a .dkt trace, replayed offline
RECORD_DIR = ROOT / "build" / "record"
RECORD_TOL_J = 1e-6
RECORD_CAP_W = 400.0


def record_serve(label, eng, reqs, name, policies=False):
    """Record ``eng``'s telemetry to ``build/record/<name>.dkt`` right
    after its serve (before anything else samples on the engine: the
    trace holds the very windows that partitioned the joules), replay
    every request's joules from it twice (``replay_attribution``), and,
    with ``policies``, replay the trace through the replay CLI's three
    admission policies twice (``replay``)."""
    from repro_torch.launch.replay import _policies
    from repro_torch.tracestore import (ReplayRequest, TraceReader,
                                        record_engine, replay,
                                        replay_attribution)
    RECORD_DIR.mkdir(parents=True, exist_ok=True)
    path = RECORD_DIR / f"{name}.dkt"
    t0 = time.perf_counter()
    record_engine(eng.tel, path, meta={"arch": eng.model.cfg.name})
    t_record = time.perf_counter() - t0
    t0 = time.perf_counter()
    replays = []
    for _ in range(2):
        with TraceReader(path) as r:
            replays.append(replay_attribution(r))
    t_attr = time.perf_counter() - t0
    with TraceReader(path) as r:
        (sid,) = r.stream_ids()
        n_chunks, n_samples = len(r.chunks(sid)), r.n_samples(sid)
        t_first, t_last = r.time_range(sid)
        trace_j = r.read(sid).energy_j()
    live = {r.req_id: r.energy_j for r in reqs}
    err = max(abs(replays[0].get(rid, 0.0) - j) for rid, j in live.items())
    log(f"[{label}] {path.relative_to(ROOT)}: {n_chunks} windows "
        f"({len(eng.tel.events)} events), {n_samples} samples at "
        f"{eng.tel.session.grid_sps:.0f} SPS over [{t_first:.3f}, "
        f"{t_last:.3f}] s, {path.stat().st_size} bytes, "
        f"{trace_j:.3f} J; record {t_record:.3f} s, two attribution replays "
        f"{t_attr:.3f} s; max |replayed - live| {err:.3e} J over "
        f"{len(live)} requests")
    checks = {
        "one window a telemetry event": (
            n_chunks == eng.tel.session.n_windows == len(eng.tel.events)),
        "replayed requests == those with joules": (
            set(replays[0]) == {rid for rid, j in live.items() if j > 0}),
        f"replayed joules within {RECORD_TOL_J} J of live": (
            err <= RECORD_TOL_J),
        "two attribution replays equal": replays[0] == replays[1],
    }
    if policies:
        wl = [ReplayRequest(r.req_id, max_new_tokens=len(r.output),
                            prompt_tokens=len(r.prompt)) for r in reqs]
        t0 = time.perf_counter()
        # the replay CLI's own policies, fresh for each run (they keep
        # stats): work-conserving, one slot, and the cap on the H100_SXM
        # power model of this model's size
        cli = types.SimpleNamespace(cap=RECORD_CAP_W,
                                    cap_params=eng.pm.n_params)
        reports = [replay(path, workload=wl, policies=_policies(cli),
                          batch_size=eng.batch_size) for _ in range(2)]
        t_policy = time.perf_counter() - t0
        for res in reports[0].results:
            log(f"[{label}] replay {res.policy}: {res.attributed_j:.3f} J "
                f"attributed of {res.energy_j:.3f} J over "
                f"{res.duration_s:.2f} s, completed {res.completed}, shed "
                f"{res.shed}, {res.j_per_token:.4f} J/token"
                + (f", f {res.dvfs_f_ghz:.3f} GHz" if res.dvfs_f_ghz
                   else ""))
        log(f"[{label}] three policies replayed twice in {t_policy:.3f} s")
        checks["two policy replays equal"] = reports[0] == reports[1]
        checks["each policy's joules <= the trace's"] = all(
            res.attributed_j <= trace_j + 1e-9
            for res in reports[0].results)
    check_all(label, checks)


def log_serve(label, stats, wall, reqs, card):
    import torch
    n_tok = stats["tokens_decoded"]
    energy = stats["energy_j"]
    log(f"[{label}] {stats['completed']} completed, {stats['shed']} shed, "
        f"{stats['prefills']} prefills, {stats['decode_steps']} decode steps, "
        f"prefill_compiles {stats['prefill_compiles']}, decode_compiles "
        f"{stats['decode_compiles']}, adapter {stats['adapter']}, prefix "
        f"cache {stats.get('prefix_cache')}")
    log(f"[{label}] wall {wall:.3f} s; {n_tok / wall:.2f} tok/s over the "
        f"wall (all tokens over all time); prefill {stats['prefill_s']:.3f} "
        f"s; decode {stats['decode_s']:.3f} s at "
        f"{stats['decode_tok_per_s']:.2f} tok/s (decode only); {n_tok} "
        f"tokens; "
        f"modeled energy {energy:.2f} J = {energy / n_tok:.4f} J/token "
        f"(H100_SXM power model over measured windows); peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; card: {card}")
    for r in reqs:
        log(f"[{label}]   req {r.req_id}: prompt {len(r.prompt)} "
            f"(cached {r.cached_prompt_tokens}) -> {len(r.output)} tokens "
            f"[{r.finish_reason}] {r.energy_j:.3f} J")


def make_model(name, seed, num_layers=None, dtype=None):
    """(cfg, model, params): ``name`` at its published width, weights made
    on the card from ``seed`` in ``dtype`` (None: the config's, bf16);
    ``num_layers`` cuts the depth."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get(name)
    if num_layers is not None:
        cfg = cfg.replace(num_layers=num_layers)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    params = model.init(gen, "cuda", dtype=dtype)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"[model] {cfg.name}: {cfg.num_layers} layers"
        + (" (depth cut)" if num_layers is not None else "")
        + f", d_model {cfg.d_model}, {cfg.num_heads} q heads / "
        f"{cfg.num_kv_heads} kv, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"qk_norm {cfg.qk_norm}"
        + (f", window {cfg.sliding_window} on all layers but every "
           f"{cfg.local_global_period}th" if cfg.local_global_period else "")
        + (f", {cfg.num_experts} routed experts top-{cfg.experts_per_token}"
           f" (d_ff {cfg.moe_d_ff}) + {cfg.num_shared_experts} shared, "
           f"first {cfg.first_k_dense} dense" if cfg.is_moe else "")
        + (", patch_proj" if cfg.family == "vlm" else "")
        + f": {n_params / 1e9:.2f} B params in "
        f"{str(dtype)[6:] if dtype is not None else cfg.dtype} made on the card "
        f"in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB allocated")
    return cfg, model, params


def warm_up(model, params, reqs, **kw):
    """A pass over the same prompts, 2 tokens each: the first call of each
    shape pays one-time costs (cuBLAS heuristics, module loading) that the
    measured pass must not carry."""
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    t0 = time.perf_counter()
    for r in reqs:
        r.max_new_tokens = 2
    ContinuousEngine(model, params, telemetry=False, **kw).serve(reqs)
    torch.cuda.synchronize()
    log(f"[warm-up] {len(reqs)} requests x 2 tokens in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_serve(card):
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.step import bucket_for
    cfg, model, params = make_model("granite-20b", SERVE["seed"])
    kw = dict(batch_size=SERVE["batch"], max_seq=SERVE["max_seq"])
    warm_up(model, params, serve_requests(cfg.vocab_size), **kw)
    eng = ContinuousEngine(model, params, **kw)
    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
        lambda: eng.serve(reqs))
    launches = {"flash_attention": n_flash,
                "flash_attention/wgmma": routes["wgmma"]}
    log(f"[serve] flash launches by route: {routes}, windowed {windowed}")
    log_serve("serve", stats, wall, reqs, card)
    check_all("serve", {
        "all 8 complete": stats["completed"] == len(reqs) == 8,
        "every request at its budget": all(
            len(r.output) == SERVE["max_new"] for r in reqs),
        "decode_compiles == 1": stats["decode_compiles"] == 1,
        "host syncs == prefills + decode steps": (
            n_syncs == stats["prefills"] + stats["decode_steps"]),
        "prefix hit rate > 0": stats["prefix_cache"]["hit_rate"] > 0,
        "flash launches == layers x prefills": (
            n_flash == cfg.num_layers * stats["prefills"] > 0),
        "flash wgmma launches == layers x prefills, ffma 0": (
            routes == {"wgmma": cfg.num_layers * stats["prefills"],
                       "ffma": 0} and windowed == 0),
        "every request has energy > 0": all(r.energy_j > 0 for r in reqs),
        "joule partition (1e-6 J)": joule_partition_error(eng, reqs) <= 1e-6,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.output),
    })
    record_serve("record", eng, reqs, "serve_granite", policies=True)
    # the prefill shapes the path gave the kernel: (S bucket, q_offset)
    shapes = sorted({(bucket_for(len(r.prompt) - r.cached_prompt_tokens,
                                 eng.buckets), r.cached_prompt_tokens)
                     for r in reqs})
    return cfg, eng, launches, shapes


# the serve phase's one-rank check of the sharded serve step: a prefill of
# 4 rows of 256 tokens from the seed into a contiguous cache of 512
# positions, then 8 greedy decode steps at per-row positions
SERVE_SHARDED = dict(rows=4, prompt=256, steps=8, seed=0,
                     pos=(256, 200, 256, 100))


def serve_sharded_one_rank(model, params, card, label="serve",
                           max_seq=SERVE["max_seq"], flash=None):
    """``model`` at full width on its served weights ``params``
    (granite-20b's in the serve phase, zamba2-1.2b's in serve_recurrent):
    a prefill and ``SERVE_SHARDED["steps"]`` decode steps through the
    model, then the same through ``ShardedServeStep`` on a one-rank NCCL
    mesh (the serve cell's rules for the batch): logits and greedy tokens
    equal bit for bit (one rank: every split is a no-op), the sharded
    run's flash launches (zeroed before, read after) ``flash`` (default:
    one a layer) on wgmma, those of the prefill."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.step import ShardedServeStep, cell_rules
    from repro_torch.train.optimizer import tree_map
    c = SERVE_SHARDED
    cfg = model.cfg
    flash = cfg.num_layers if flash is None else flash
    g = torch.Generator(device="cuda")
    g.manual_seed(c["seed"])
    tokens = torch.randint(0, cfg.vocab_size, (c["rows"], c["prompt"]),
                           generator=g, device="cuda")
    pos = torch.tensor(c["pos"], device="cuda")

    def serve(prefill, decode, caches):
        with torch.no_grad():
            lg, caches = prefill({"tokens": tokens}, caches)
            logits, toks = [lg], [lg.argmax(-1)]
            for i in range(c["steps"]):
                lg, caches = decode(toks[-1], pos + i, caches)
                logits.append(lg)
                toks.append(lg.argmax(-1))
        torch.cuda.synchronize()
        return logits, toks

    want, want_tok = serve(
        lambda b, cc: model.prefill(params, b, cc),
        lambda t, q, cc: model.decode_step(params, t, q, cc),
        model.init_cache(c["rows"], max_seq, device="cuda"))
    store = ROOT / "build" / "serve_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(1, 1, 1, "cuda")
        smodel = build_model(cfg, mesh, shd_rules=cell_rules(
            cfg, c["rows"], mesh))
        step = ShardedServeStep(smodel, mesh, c["rows"], max_seq)
        blocks = step.layout(tree_map(lambda t: t, params))
        caches = step.layout_cache(smodel.init_cache(c["rows"], max_seq,
                                                     device="cuda"))
        zero_flash_counts()
        got, got_tok = serve(
            lambda b, cc: step.prefill(blocks, b, cc),
            lambda t, q, cc: step.decode(blocks, t, q, cc), caches)
        n_flash, routes, windowed = flash_counts()
    finally:
        dist.destroy_process_group()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    same_tok = all(torch.equal(a, b) for a, b in zip(got_tok, want_tok))
    log(f"[{label}] sharded serve step on a one-rank NCCL mesh: "
        f"{cfg.name}, {c['rows']} rows x {c['prompt']} tokens, "
        f"{c['steps']} decode steps at positions {list(c['pos'])} + i: "
        f"logits equal bitwise {same}, tokens equal {same_tok} (step 1 "
        f"{want_tok[1][:, 0].tolist()}); flash {n_flash} launches by route "
        f"{routes}, windowed {windowed}; card: {card}")
    check_all(label, {
        "sharded serve step at one rank: logits equal bitwise": same,
        "sharded serve step at one rank: tokens equal": same_tok,
        f"sharded serve step: flash launches == {flash}, all wgmma": (
            n_flash == flash and routes == {
                "wgmma": n_flash, "ffma": 0} and windowed == 0),
    })
    return n_flash


# gemma3-27b at its published width on the window rings: the reference's
# default serve path. Two prompts longer than the 1024 window, two whose
# decode crosses position 1024 (the ring wraps), four short ones
SERVE_WINDOW = dict(batch=4, max_seq=2048, max_new=32, seed=0,
                    lens=((1100, 1900), (1100, 1900), (1000, 1020),
                          (1000, 1020), (30, 200), (30, 200), (30, 200),
                          (30, 200)),
                    static_new=16)


def window_requests(vocab):
    import numpy as np
    from repro_torch.serve.engine import Request
    c = SERVE_WINDOW
    rng = np.random.default_rng(c["seed"])
    return [Request(i, rng.integers(0, vocab, int(rng.integers(lo, hi + 1)))
                    .astype(np.int32), max_new_tokens=c["max_new"])
            for i, (lo, hi) in enumerate(c["lens"])]


def phase_serve_window(card):
    """gemma3-27b through ContinuousEngine on WindowRingAdapter: 8
    requests, batch 4, max_seq 2048, 32 new tokens each. Every prefill
    layer on flash's wgmma route, the 52 local ones with the window."""
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    cfg, model, params = make_model("gemma3-27b", SERVE_WINDOW["seed"])
    kw = dict(batch_size=SERVE_WINDOW["batch"],
              max_seq=SERVE_WINDOW["max_seq"])
    warm_up(model, params, window_requests(cfg.vocab_size), **kw)
    eng = ContinuousEngine(model, params, **kw)
    reqs = window_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    with flash_shapes() as shapes:
        stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
            lambda: eng.serve(reqs))
    want_shapes = window_shapes(cfg, 1, eng.buckets,
                                [len(r.prompt) for r in reqs],
                                SERVE_WINDOW["max_seq"])
    n_local = int((~layer_flags(cfg)).sum())
    n_pre = stats["prefills"]
    log(f"[serve_window] flash shapes (B, H, Hkv, S, T, D, causal, window, "
        f"q_offset): {sorted(shapes, key=str)}")
    log(f"[serve_window] flash launches {n_flash} by route {routes}, "
        f"windowed {windowed} ({n_local} local and "
        f"{cfg.num_layers - n_local} global layers x {n_pre} prefills)")
    log_serve("serve_window", stats, wall, reqs, card)
    w = cfg.sliding_window
    check_all("serve_window", {
        "all 8 complete": stats["completed"] == len(reqs) == 8,
        "every request at its budget": all(
            len(r.output) == SERVE_WINDOW["max_new"] for r in reqs),
        "a prompt longer than the window": max(
            len(r.prompt) for r in reqs) > w,
        "a decode that crosses the window": any(
            len(r.prompt) <= w < len(r.prompt) + len(r.output)
            for r in reqs),
        "adapter window-ring": stats["adapter"] == "window-ring",
        "decode_compiles == 1": stats["decode_compiles"] == 1,
        "host syncs == prefills + decode steps": (
            n_syncs == n_pre + stats["decode_steps"]),
        "flash launches == 62 x prefills, all wgmma": (
            n_flash == cfg.num_layers * n_pre > 0
            and routes == {"wgmma": n_flash, "ffma": 0}),
        "windowed launches == 52 x prefills": windowed == n_local * n_pre,
        "flash shapes == those the prompts' buckets give": (
            set(shapes) == want_shapes),
        "every request has energy > 0": all(r.energy_j > 0 for r in reqs),
        "joule partition (1e-6 J)": joule_partition_error(eng, reqs) <= 1e-6,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.output),
    })
    record_serve("record_window", eng, reqs, "serve_gemma3")
    launches = {"window": windowed, "global": n_flash - windowed}
    return cfg, model, params, eng, launches, shapes


def phase_static_window(cfg, model, params):
    """ServeEngine on the same gemma3-27b weights: one batch of the four
    long requests (left-padded to the longest, right-padded to the 2048
    bucket), 16 tokens each; every flash launch at B 4."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    reqs = [r for r in window_requests(cfg.vocab_size)
            if len(r.prompt) > 512]
    for r in reqs:
        r.max_new_tokens = SERVE_WINDOW["static_new"]
    eng = ServeEngine(model, params, batch_size=4,
                      max_seq=SERVE_WINDOW["max_seq"])
    with flash_shapes() as shapes:
        stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
            lambda: eng.serve(reqs))
    # the batch is left-padded to its longest prompt, then bucketed
    want_shapes = window_shapes(cfg, 4, eng.buckets,
                                [max(len(r.prompt) for r in reqs)],
                                SERVE_WINDOW["max_seq"])
    n_tok = stats["tokens_decoded"]
    log(f"[static] {len(reqs)} requests (prompts "
        f"{[len(r.prompt) for r in reqs]}) in one batch: wall {wall:.3f} s, "
        f"prefill {stats['prefill_s']:.3f} s, decode {stats['decode_s']:.3f}"
        f" s over {stats['decode_steps']} steps, {n_tok / wall:.2f} tok/s "
        f"over the wall; {stats['energy_j']:.2f} J; flash launches "
        f"{n_flash} by route {routes}, windowed {windowed}, shapes "
        f"{sorted(shapes, key=str)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    n_local = int((~layer_flags(cfg)).sum())
    check_all("static", {
        "every request complete at its budget": all(
            r.done and len(r.output) == SERVE_WINDOW["static_new"]
            for r in reqs),
        "decode_compiles == 1": stats["decode_compiles"] == 1,
        "host syncs == 1 + decode steps": n_syncs == 1 + stats["decode_steps"],
        "flash: one prefill, every layer on wgmma at B 4": (
            n_flash == cfg.num_layers and routes == {"wgmma": n_flash,
                                                     "ffma": 0}
            and windowed == n_local and set(shapes) == want_shapes),
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.output),
    })
    return shapes


def hold_window_shapes(shapes, label="hold_window"):
    """The planned flash call (wgmma) at every shape a serve gave the
    kernel (gemma3's continuous and static serves; deepseek-moe-16b's),
    bf16 randn inputs, against ``ref.attention``: max|err| at the bf16
    tolerance and ``ref.mask_margin`` (the window and the diagonal, each
    one key either way) under its limit. Returns the largest max|err|."""
    import torch
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    tol = FLASH_TOL["bfloat16"]
    worst = 0.0
    for (b, h, hkv, s, t, d, causal, win, off) in sorted(shapes, key=str):
        q, k, v = (torch.randn(b, n, m, d, device="cuda", generator=g,
                               dtype=torch.bfloat16)
                   for n, m in ((h, s), (hkv, t), (hkv, t)))
        before = dict(ops.route_launches)
        got = ops.flash_attention(q, k, v, causal=causal, window=win,
                                  q_offset=off)
        taken = {r: c - before[r] for r, c in ops.route_launches.items()
                 if c != before[r]}
        err = (got.float() - ref.attention(
            q, k, v, causal=causal, window=win, q_offset=off).float()
        ).abs().max().item()
        margin = ref.mask_margin(got, q, k, v, causal=causal, window=win,
                                 q_offset=off)
        worst = max(worst, err)
        log(f"[{label}] flash B{b} H{h} Hkv{hkv} S{s} T{t} D{d} "
            f"window={win} q_offset={off}: took {taken}, max|err| "
            f"{err:.3e} (tol {tol:g}), mask margin {margin:.3e} (limit "
            f"{MASK_MARGIN:g})")
        if not (taken == {"wgmma": 1} and err <= tol
                and margin <= MASK_MARGIN):
            raise AssertionError(
                f"[{label}] flash at the serve shape B{b} S{s} T{t} window "
                f"{win} took {taken} or disagrees")
        del q, k, v, got
    return worst


# qwen3-32b (qk_norm, 64 layers, 64 / 8 heads; 65.5 GB in bf16) and
# deepseek-coder-33b (62 layers, 56 / 8; 66.7 GB) at their published
# widths and depths: each fits one card whole (the dryrun phase's (c))
DENSE = dict(batch=4, max_seq=512, max_new=8, seed=0, lens=(30, 300), n=4)


def phase_serve_dense(card):
    """A short continuous serve of each, whole, on the paged path: qk_norm
    and their GQA shapes on the flash kernel, a launch a layer a
    prefill."""
    c = DENSE
    for name in ("qwen3-32b", "deepseek-coder-33b"):
        cfg, model, params = make_model(name, c["seed"])
        short_serve("dense", cfg, model, params, card, c)
        del params, model
        free_card()


def short_serve(label, cfg, model, params, card, c, reqs=None, flash=None,
                warm=0, watch=None):
    """``reqs`` (None: ``c["n"]`` requests of ``c["lens"]`` tokens from
    seed ``c["seed"]``, ``c["max_new"]`` new each) through ContinuousEngine
    at batch ``c["batch"]`` x ``c["max_seq"]`` (with ``c["max_chunk"]``
    where given), the flash counts and shapes
    read around the serve, the peak memory reset before it: every request
    complete at its budget, one decode compile, one host sync a prefill and
    a decode step, every prefill launch on flash's wgmma route (``flash``:
    stats -> (launches, windowed), None: a launch a layer a prefill, none
    windowed), joules partitioned, every request's energy above 0, tokens
    in vocab. ``warm``: first serve each request's first ``warm`` prompt
    tokens (2 new) on an engine of the same shape, freed before the serve.
    ``watch``: a context manager entered around the serve alone (not the
    warm one), what it yields returned as ``watched``. Returns dict(eng,
    stats, syncs, flash, routes, windowed, shapes, peak, watched)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.serve.engine import ContinuousEngine, Request
    name = cfg.name
    if reqs is None:
        rng = np.random.default_rng(c["seed"])
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(
            rng.integers(*c["lens"]))).astype(np.int32),
            max_new_tokens=c["max_new"]) for i in range(c["n"])]
    kw = dict(batch_size=c["batch"], max_seq=c["max_seq"])
    if c.get("max_chunk"):
        kw["max_chunk"] = c["max_chunk"]
    if warm:
        ContinuousEngine(model, params, telemetry=False, **kw).serve([
            Request(r.req_id, r.prompt[:warm].copy(), max_new_tokens=2)
            for r in reqs])
        free_card()
    eng = ContinuousEngine(model, params, **kw)
    torch.cuda.reset_peak_memory_stats()
    with flash_shapes() as shapes, (watch or contextlib.nullcontext)() as \
            watched:
        stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
            lambda: eng.serve(reqs))
    peak = torch.cuda.max_memory_allocated()
    want, want_windowed = (flash or (lambda st: (
        cfg.num_layers * st["prefills"], 0)))(stats)
    log(f"[{label}] {name} ({cfg.num_layers} of "
        f"{configs.get(name).num_layers} layers, batch {c['batch']} x "
        f"{c['max_seq']}): flash launches {n_flash} by route {routes}, "
        f"windowed {windowed}; shapes (B, H, Hkv, S, T, D, causal, window, "
        f"q_offset): {sorted(shapes.items(), key=str)}")
    log_serve(label, stats, wall, reqs, card)
    check_all(label, {
        f"{name}: every request complete at its budget": (
            stats["completed"] == len(reqs) and all(
                len(r.output) == r.max_new_tokens for r in reqs)),
        f"{name}: decode_compiles == 1": stats["decode_compiles"] == 1,
        f"{name}: host syncs == prefills + decode steps": (
            n_syncs == stats["prefills"] + stats["decode_steps"]),
        f"{name}: flash launches == {want}, {want_windowed} windowed, all "
        f"wgmma": (n_flash == want > 0
                   and routes == {"wgmma": n_flash, "ffma": 0}
                   and windowed == want_windowed),
        f"{name}: joule partition (1e-6 J)": (
            joule_partition_error(eng, reqs) <= 1e-6),
        f"{name}: every request's energy > 0": all(
            r.energy_j > 0 for r in reqs),
        f"{name}: tokens in vocab": all(
            0 <= t < cfg.vocab_size for r in reqs for t in r.output),
    })
    return dict(eng=eng, stats=stats, syncs=n_syncs, flash=n_flash,
                routes=routes, windowed=windowed, shapes=dict(shapes),
                peak=peak, watched=watched)


# the reference grid's 32k cells served whole on the card
# (``configs.base.SHAPES``): prefills at prefill_32k's sequence length, its
# batch of 32 cut to 4, and decode at decode_32k's positions (32736 to
# 32767), its batch of 128 cut to 4. 4 prompts of 32736 tokens and 32 new
# tokens each from numpy seed 0; on granite-20b's paged path requests 1-3
# share request 0's first 16384 tokens: 3 prefix hits, each tail 16352
# tokens in the 16384 bucket at q_offset 16384, so the bucket ends on the
# view's last position and no bucketed tail runs past it. gemma3-27b (at
# batch 2 by its count) serves the first ``gemma3_n`` prompts, one wave:
# the script's time budget
SERVE_LONG = dict(max_seq=32768, prompt=32736, shared=16384, n=4,
                  max_new=32, batch=4, seed=0, warm=64, gemma3_n=2,
                  # the dry-run's count must leave this share of 80 GB free
                  # for a serve at batch 4 (else batch 2)
                  free_share=0.05,
                  # the f32 holds: granite-20b at 2 of 52 layers and
                  # zamba2-1.2b up to its first shared-attention site, 8
                  # teacher-forced decode steps, the reference path's chunk
                  hold=dict(layers=2, steps=8, chunk=1024))
# the f32 holds' tolerance: max|logit diff| within this share of max|logit|
LONG_LOGIT_TOL = 1e-3


def long_requests(vocab, shared=0):
    """``SERVE_LONG``'s 4 requests; with ``shared`` requests 1-3 begin
    with request 0's first ``shared`` tokens."""
    import numpy as np
    from repro_torch.serve.engine import Request
    c = SERVE_LONG
    rng = np.random.default_rng(c["seed"])
    prompts = [rng.integers(0, vocab, c["prompt"]).astype(np.int32)
               for _ in range(c["n"])]
    for p in prompts[1:]:
        p[:shared] = prompts[0][:shared]
    return [Request(i, p, max_new_tokens=c["max_new"])
            for i, p in enumerate(prompts)]


def long_counts(arch):
    """The dry-run's counts (one device, the meta device) of ``arch``'s 32k
    serve and the batch they allow: a flat family's by
    ``dryrun.long_serve_count`` (the decode step at batch b over 32768
    positions and a one-row 32768-token prefill with b - 1 more rows of
    cache beside it; the largest of 4, 2 and 1 that leaves
    ``free_share`` of 80 GB free, None where none does), beside the
    paged adapter's own count at that batch (``dryrun.paged_serve_count``:
    its decode step and its cold prefill with the pool live) where it
    serves on the paged path. zamba2-1.2b's serve is counted as its
    adapter runs it (``dryrun.recurrent_serve_count``: the batch's rows
    and the adapter's working state live, its largest chunk, 16384
    tokens, and the decode step), batch 4 where that fits, else 2.
    Returns (batch, {count: peak bytes}): "serve" the count at the batch
    taken (at 4 where none fits), "paged" the paged adapter's (its peak
    of the two) where it was counted."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.models.registry import serving_caps
    c = SERVE_LONG
    cfg = configs.get(arch)
    limit = card_limit(c["free_share"])
    if arch == "zamba2-1.2b":
        n = dryrun.recurrent_serve_count(
            cfg, batch=c["batch"], max_seq=c["max_seq"], prompt=c["prompt"])
        peaks = {"long_decode": n["decode"], "serve": n["serve"][None]}
        batch = 4 if peaks["serve"] <= limit else 2
        log(f"[serve_long] {arch} dry-run count of the adapter's serve at "
            f"batch 4 x {c['max_seq']}: decode step {n['decode'] / 1e9:.2f} "
            f"GB, the serve (its largest chunk, 16384 tokens) "
            f"{peaks['serve'] / 1e9:.2f} GB with {n['state'] / 1e9:.3f} "
            f"GB of state (4 rows and the working tree) against "
            f"{limit / 1e9:.1f} GB: batch {batch}")
        return batch, peaks
    n = dryrun.long_serve_count(cfg, max_seq=c["max_seq"], limit=limit)
    batch = n["batch"]
    peaks = {"long_prefill": n["prefill"], "row": n["row"],
             "serve": n["serve"][batch or 4]}
    peaks |= {f"long_decode_b{b}": v for b, v in n["decode"].items()}
    peaks |= {f"serve_b{b}": v for b, v in n["serve"].items()}
    paged = ""
    if batch and serving_caps(cfg).paged_kv:
        pn = dryrun.paged_serve_count(cfg, batch=batch, max_seq=c["max_seq"],
                                      prompt=c["prompt"])
        peaks |= {"paged_decode": pn["decode"], "paged_prefill": pn["prefill"],
                  "paged": pn["serve"]}
        paged = (f"; the paged adapter's own count at batch {batch}: decode "
                 f"step {pn['decode'] / 1e9:.2f} GB, cold prefill "
                 f"{pn['prefill'] / 1e9:.2f} GB, pool {pn['pool'] / 1e9:.2f}"
                 f" GB")
    log(f"[serve_long] {arch} dry-run counts at max_seq {c['max_seq']}: "
        f"one-row prefill {n['prefill'] / 1e9:.2f} GB, a row of cache "
        f"{n['row'] / 1e9:.3f} GB; " + ", ".join(
            f"batch {b}: decode step {n['decode'][b] / 1e9:.2f} GB, serve "
            f"{n['serve'][b] / 1e9:.2f} GB" for b in n["serve"])
        + f" against {limit / 1e9:.1f} GB (80 GB less "
        f"{c['free_share']:.0%}): "
        + (f"batch {batch}" if batch else "does not fit at one row")
        + paged)
    return batch, peaks


def paged_peak_checks(arch, peak, peaks):
    """A paged 32k serve's peak max_memory_allocated within
    ``SERVE_LONG_MOE["peak_rel"]`` of the paged adapter's own count
    (``long_counts``' "paged")."""
    rel = SERVE_LONG_MOE["peak_rel"]
    return {f"{arch}: peak within {rel:.0%} of the paged adapter's count "
            f"({peaks['paged'] / 1e9:.2f} GB)":
            abs(peak - peaks["paged"]) <= rel * peak}


def serve_long_granite(card, batch):
    """(a) granite-20b whole on the paged path with the shared 16k prefix,
    then the profile of one cold 32768-token prefill (kernels only) and
    the dry-run's count of a decode step at position 32767 held against
    the card's."""
    import torch
    c = SERVE_LONG
    cfg, model, params = make_model("granite-20b", c["seed"])
    reqs = long_requests(cfg.vocab_size, c["shared"])
    r = short_serve("serve_long_granite", cfg, model, params, card,
                    dict(c, batch=batch), reqs, warm=c["warm"])
    eng = r["eng"]
    check_all("serve_long_granite", prefix_checks(cfg, reqs, r))
    r["profile"] = profile_cold_prefill("profile_long", eng, torch.zeros(
        (1, c["max_seq"]), dtype=torch.int32, device="cuda"), card)
    del eng
    r.pop("eng")
    free_card()
    r["dryrun"] = dryrun_decode(model, params, card, c["max_seq"],
                                c["batch"])
    del model, params
    free_card()
    return r


def prefix_checks(cfg, reqs, r):
    """serve_long's gates of a paged serve ``r`` (``short_serve``'s) of
    ``long_requests(..., shared)``: a prefix hit for each request past
    the first, each served ``shared`` prompt tokens from the cache, and
    flash launched at exactly the cold bucket's shape and the tails' (at
    q_offset ``shared``, each over the whole cache view)."""
    from repro_torch.serve.step import bucket_for
    c, n = SERVE_LONG, len(reqs)
    want_shapes = {(1, cfg.num_heads, cfg.num_kv_heads,
                    bucket_for(len(q.prompt) - q.cached_prompt_tokens,
                               r["eng"].buckets), c["max_seq"],
                    cfg.head_dim, True, None, q.cached_prompt_tokens)
                   for q in reqs}
    return {
        f"prefix hits == {n - 1}": r["stats"]["prefix_cache"]["hits"]
        == n - 1,
        f"requests 1-{n - 1} served {c['shared']} prompt tokens from the "
        f"prefix cache": ([q.cached_prompt_tokens for q in reqs]
                          == [0] + [c["shared"]] * (n - 1)),
        f"flash shapes == the cold bucket's and the tails' (q_offset "
        f"{c['shared']})": set(r["shapes"]) == want_shapes,
    }


def profile_cold_prefill(label, eng, tokens, card):
    """One cold prefill of ``tokens`` ([1, S] on the card, every position
    real) through ``eng``'s paged slot-prefill step into the row of null
    blocks (every slot is free after the serve), kernels only, by class,
    with flash's share of the device time."""
    import torch
    ad = eng.adapter
    n = tokens.shape[1]
    null_row = torch.zeros(ad.n_slot_blocks, dtype=torch.int32,
                           device=ad.device)
    what = f"prefill ({n} tokens, cold)"
    prof = profile_steps(label, {what: lambda: ad._prefill_slot(
        ad.params, tokens, n, 0, null_row, ad.caches)}, n=1, warm=False)
    p = prof[what]
    log(f"[{label}] flash {p['flash_ms']:.3f} of {p['device_ms']:.3f} "
        f"device ms: {p['flash_ms'] / p['device_ms']:.1%} of the cold "
        f"{n}-token prefill; card: {card}")
    return prof


def serve_long_gemma3(card, batch):
    """(b) gemma3-27b whole on its window rings (no prefix cache: rings
    cannot resume mid-stream), the first ``gemma3_n`` of the prompts,
    unshared (one wave at batch 2: the script's time budget)."""
    from repro_torch.models.transformer import layer_flags as flags
    c = SERVE_LONG
    cfg, model, params = make_model("gemma3-27b", c["seed"])
    reqs = long_requests(cfg.vocab_size)[:c["gemma3_n"]]
    n_local = int((~flags(cfg)).sum())
    # 62 launches a prefill, the 52 local layers' windowed
    r = short_serve("serve_long_gemma3", cfg, model, params, card,
                    dict(c, batch=batch), reqs, warm=c["warm"],
                    flash=lambda st: (cfg.num_layers * st["prefills"],
                                      n_local * st["prefills"]))
    stats, eng = r["stats"], r["eng"]
    check_all("serve_long_gemma3", {
        "adapter window-ring": stats["adapter"] == "window-ring",
        "every prompt past the window, every decode on a wrapped ring": all(
            len(q.prompt) > cfg.sliding_window for q in reqs),
        "flash shapes == those the prompts' buckets give": (
            set(r["shapes"]) == window_shapes(
                cfg, 1, eng.buckets, [len(q.prompt) for q in reqs],
                c["max_seq"])),
    })
    del eng, model, params
    r.pop("eng")
    free_card()
    return r


def serve_long_zamba2(card, batch):
    """(c) zamba2-1.2b whole through the recurrent-state adapter: each
    32736-token prompt in 10 pow2 chunks (16384 down to 32). Two serves'
    tokens are held equal in serve_recurrent (512 positions), not here:
    the script's time budget."""
    from repro_torch.serve.step import pow2_chunks
    c = SERVE_LONG
    cfg, model, params = make_model("zamba2-1.2b", c["seed"])
    reqs = long_requests(cfg.vocab_size)
    chunks = [pow2_chunks(len(q.prompt)) for q in reqs]
    bound = len({x for ch in chunks for x in ch})
    sites, _ = recurrent_flash_sites(model)
    # a launch a shared-attention site a chunk of 2 tokens or more
    want_flash = sites * sum(x >= 2 for ch in chunks for x in ch)
    r = short_serve("serve_long_zamba2", cfg, model, params, card,
                    dict(c, batch=batch), reqs, warm=c["warm"],
                    flash=lambda st: (want_flash, 0))
    stats = r["stats"]
    del r["eng"]
    log(f"[serve_long_zamba2] pow2 chunks {chunks[0]}; flash launches "
        f"{r['flash']} (want {want_flash}); signatures {stats['compiles']}")
    check_all("serve_long_zamba2", {
        "adapter recurrent": stats["adapter"] == "recurrent",
        "each prompt 10 pow2 chunks": all(len(ch) == 10 for ch in chunks),
        f"prefill signatures <= {bound} (pow2 chunk sizes)": (
            0 < stats["prefill_compiles"] <= bound),
        "state_scatter signatures == 1": (
            stats["compiles"].get("state_scatter") == 1),
    })
    del model, params
    free_card()
    return r


# the reference grid's long_500k cell (``configs.base.SHAPES``: decode at
# 524288 positions, batch 1) served whole on zamba2-1.2b (38 layers, 6
# shared-attention sites, 32:32 heads of 64, 1.02 B bf16 params): one
# prompt of 524256 tokens from numpy seed 0 and 32 new tokens, so the
# decode steps run at positions 524256-524287. The prefill's chunk cap is
# the largest power of two whose dry-run count leaves ``free_share`` of
# 80 GB free; the peak must read within ``peak_rel`` of that count
SERVE_500K = dict(arch="zamba2-1.2b", max_seq=524288, prompt=524256,
                  max_new=32, batch=1, seed=0, free_share=0.05,
                  peak_rel=0.10)


def serve_long500k_zamba2(card):
    """(d) zamba2-1.2b's long_500k cell through ContinuousEngine and the
    recurrent-state adapter at batch 1 x 524288: the dry-run's count
    first (``dryrun.recurrent_serve_count``: the uncapped chunking, then
    caps halving until the serve fits), then the serve with the cap it
    chose and every gate of (c), the peak within ``peak_rel`` of the
    count, then the profile of one decode step at position 524287
    (kernels only)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.serve.engine import Request
    from repro_torch.serve.step import capped_chunks
    c = SERVE_500K
    limit = card_limit(c["free_share"])
    t0 = time.perf_counter()
    count = dryrun.recurrent_serve_count(
        configs.get(c["arch"]), batch=c["batch"], max_seq=c["max_seq"],
        prompt=c["prompt"], limit=limit)
    cap = count["cap"]
    log(f"[serve_long500k] {c['arch']} dry-run counts at batch "
        f"{c['batch']} x {c['max_seq']} (in {time.perf_counter() - t0:.1f} "
        f"s): decode step {count['decode'] / 1e9:.2f} GB; the serve by "
        f"chunk cap " + ", ".join(
            f"{k or 'none (pow2)'} {v / 1e9:.2f} GB"
            for k, v in count["serve"].items())
        + f"; state {count['state'] / 1e9:.3f} GB (a row and the working "
        f"tree); against {limit / 1e9:.1f} GB: cap {cap}")
    cfg, model, params = make_model(c["arch"], c["seed"])
    rng = np.random.default_rng(c["seed"])
    reqs = [Request(0, rng.integers(0, cfg.vocab_size, c["prompt"]).astype(
        np.int32), max_new_tokens=c["max_new"])]
    chunks = capped_chunks(c["prompt"], cap)
    sites, _ = recurrent_flash_sites(model)
    want_flash = sites * sum(x >= 2 for x in chunks)
    r = short_serve("serve_long500k_zamba2", cfg, model, params, card,
                    dict(c, max_chunk=cap), reqs,
                    flash=lambda st: (want_flash, 0))
    stats, eng = r["stats"], r["eng"]
    want_peak = count["serve"][cap]
    sizes = {sh[3] for sh in r["shapes"]}
    log(f"[serve_long500k_zamba2] chunks (cap {cap}): {chunks}; flash "
        f"launches {r['flash']} (want {want_flash}); signatures "
        f"{stats['compiles']}; peak max_memory_allocated "
        f"{r['peak'] / 1e9:.2f} GB against the count's "
        f"{want_peak / 1e9:.2f} GB ({r['peak'] / want_peak - 1:+.2%}); "
        f"card: {card}")
    check_all("serve_long500k_zamba2", {
        "adapter recurrent": stats["adapter"] == "recurrent",
        f"the prompt in {len(chunks)} chunks of at most {cap}": (
            sizes == {x for x in chunks if x >= 2}
            and all(sh[4] == c["max_seq"] for sh in r["shapes"])),
        f"prefill signatures <= {len(set(chunks))} (the chunk sizes)": (
            0 < stats["prefill_compiles"] <= len(set(chunks))),
        "state_scatter signatures == 1": (
            stats["compiles"].get("state_scatter") == 1),
        f"peak within {c['peak_rel']:.0%} of the count": (
            abs(r["peak"] - want_peak) <= c["peak_rel"] * r["peak"]),
        f"peak under {limit / 1e9:.0f} GB": r["peak"] <= limit,
    })
    # slot 0 is free after the serve: a decode step at the cell's last
    # position over the whole 524288-position cache row
    ad = eng.adapter
    tokens = torch.zeros((1, 1), dtype=torch.int32, device=ad.device)
    pos = torch.full((1,), c["max_seq"] - 1, dtype=torch.int32,
                     device=ad.device)
    r["profile"] = profile_steps("profile_long500k", {
        f"decode step (1 row at {c['max_seq'] - 1})":
            lambda: ad.decode_step(tokens, pos)})
    r["count"], r["chunks"] = count, chunks
    del eng, ad, tokens, pos, model, params
    r.pop("eng")
    free_card()
    return r


def logit_hold(label, pairs):
    """(got, want) logit vectors in f32: max|got - want| within
    LONG_LOGIT_TOL of max|want| each, and a greedy choice that differs
    only where want's top-2 margin is under that share (as
    ``teacher_forced_check`` rules). Returns (worst share, choices under
    the margin, choices that differ above it)."""
    worst, under, differ = 0.0, 0, 0
    for got, want in pairs:
        scale = want.abs().max().item()
        worst = max(worst, (got - want).abs().max().item() / scale)
        top2 = want.topk(2).values
        if (top2[0] - top2[1]).item() / scale <= LONG_LOGIT_TOL:
            under += 1
        elif int(got.argmax()) != int(want.argmax()):
            differ += 1
    log(f"[{label}] {len(pairs)} logit vectors: max|logit diff| "
        f"{worst:.3e} of max|logit| (tol {LONG_LOGIT_TOL:g}); {under} with "
        f"a top-2 margin under the tolerance; greedy choices that differ "
        f"above it: {differ}")
    check_all(label, {
        f"logits within {LONG_LOGIT_TOL:g} of max|logit|":
            worst <= LONG_LOGIT_TOL,
        "no greedy choice differs above the margin": differ == 0})
    return worst, under, differ


def f32_model(arch, layers):
    """(cfg, model, params): ``arch`` at its published width cut to
    ``layers``, computing in f32 on f32 weights made on the card from
    ``SERVE_LONG``'s seed."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model
    cfg = configs.get(arch).replace(num_layers=layers, dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SERVE_LONG["seed"])
    return cfg, model, model.init(gen, "cuda")


def hold_long_paged(card, arch, label, same_chunks=False):
    """``arch`` at 2 layers in f32 (``f32_model``; an MoE model's dense
    first layer and its first MoE layer): the four requests of (a)
    through the paged engine (prefix hits and all; its prefill and first
    decode logits kept), then each prompt through the contiguous path
    (``model.prefill`` on a flat cache, then ``make_decode_step`` fed the
    engine's first 8 tokens): with ``same_chunks`` False the whole prompt
    cold; with it the engine's own chunks, as an MoE layer's group-local
    routing needs (a group's tokens compete for capacity): the prompt's
    uncached tail right-padded to its bucket at start_pos
    ``cached_prompt_tokens``, over request 0's cache below it."""
    import torch
    from repro_torch import configs
    from repro_torch.models.common import mask_cache_tail
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.step import make_decode_step, pad_to_bucket
    c, h = SERVE_LONG, SERVE_LONG["hold"]
    cfg, model, params = f32_model(arch, h["layers"])
    dev = params["embedding"].device
    reqs = long_requests(cfg.vocab_size, c["shared"])
    eng = ContinuousEngine(model, params, batch_size=c["batch"],
                           max_seq=c["max_seq"], telemetry=False)
    ad, buckets = eng.adapter, eng.buckets
    slots, first, steps, kept = {}, {}, [], []
    prefill, prefill_step, decode = ad.prefill, ad._prefill_slot, ad._decode

    def on_prefill(slot_index, req):
        out = prefill(slot_index, req)
        slots[req.req_id], first[req.req_id] = slot_index, kept.pop()
        return out

    def on_prefill_step(*args):
        out = prefill_step(*args)
        kept.append(out[1][0, 0].float().clone())
        return out

    def on_decode(*args):
        out = decode(*args)
        if len(steps) < h["steps"]:
            steps.append(out[1][:, 0].float().clone())
        return out

    ad.prefill, ad._prefill_slot, ad._decode = (on_prefill, on_prefill_step,
                                                on_decode)
    zero_flash_counts()
    with torch.no_grad():
        stats = eng.serve(reqs)
    paged_flash = flash_counts()
    del eng, ad
    free_card()
    decode_c = make_decode_step(model)
    pairs, base = [], None
    for q in reqs:
        cache = model.init_cache(1, c["max_seq"], device=dev)
        start = q.cached_prompt_tokens if same_chunks else 0
        tokens, n = (pad_to_bucket(q.prompt[start:], buckets) if same_chunks
                     else (q.prompt, len(q.prompt)))
        with torch.no_grad():
            if start:
                for got, was in zip(cache, base):
                    got[:, :, :start] = was[:, :, :start]
            lg, cache = model.prefill(
                params, {"tokens": torch.as_tensor(tokens[None], device=dev)},
                cache, true_len=n if same_chunks else None,
                start_pos=start or None)
            mask_cache_tail(cache, start + n)
            pairs.append((first[q.req_id], lg[0, 0].float()))
            for j in range(h["steps"]):
                tok = torch.tensor([[q.output[j]]], dtype=torch.int32,
                                   device=dev)
                _, lg, cache = decode_c(params, tok, len(q.prompt) + j,
                                        cache)
                pairs.append((steps[j][slots[q.req_id]], lg[0, 0].float()))
        if base is None:
            base = cache
        del cache
    log(f"[{label}] {cfg.name} at {cfg.num_layers} of "
        f"{configs.get(arch).num_layers} layers in f32: the paged serve's prefix "
        f"hits {stats['prefix_cache']['hits']}, cached "
        f"{[q.cached_prompt_tokens for q in reqs]}, flash {paged_flash}; "
        f"against the contiguous path ("
        + ("the engine's chunks" if same_chunks else "each prompt cold")
        + f"), each prefill's last position and {h['steps']} "
        f"teacher-forced decode steps; card: {card}")
    check_all(label, {
        "the paged serve took 3 prefix hits": (
            stats["prefix_cache"]["hits"] == 3),
        "every request decoded 8 steps in the first 8 batches": (
            stats["completed"] == 4 and len(steps) == h["steps"]
            and len(slots) == len(first) == 4)})
    out = logit_hold(label, pairs)
    del model, params, pairs, first, steps, base
    free_card()
    return out


def hold_long_zamba2(card):
    """zamba2-1.2b cut to its layers up to and including its first
    shared-attention site, in f32: the engine's pow2-chunked prefill of one
    32736-token prompt (``RecurrentStateAdapter``) and 8 greedy decode
    steps, against the same prompt fed as 1024-token chunks and then its
    pow2 remainder, decoded teacher-forced on the engine's tokens."""
    import torch
    from repro_torch import configs
    from repro_torch.serve.state import make_adapter
    from repro_torch.serve.step import pow2_chunks
    c, h = SERVE_LONG, SERVE_LONG["hold"]
    cfg, model, params = f32_model("zamba2-1.2b",
                                   configs.get("zamba2-1.2b").attn_every)
    req = long_requests(cfg.vocab_size)[0]
    n = len(req.prompt)

    def adapter():
        ad = make_adapter(model, params, batch_size=1, max_seq=c["max_seq"])
        ad.ensure_ready()
        return ad

    def step(ad, tok, pos):
        tok_t = torch.tensor([[tok]], dtype=torch.int32, device=ad.device)
        pos_t = torch.tensor([pos], dtype=torch.int32, device=ad.device)
        nxt, logits, ad.caches = ad._decode(ad.params, tok_t, pos_t,
                                            ad.caches)
        return int(nxt[0, 0]), logits[0, 0].float()

    with torch.no_grad():
        ad = adapter()
        chunk, last = ad._chunk, []

        def kept(*args):
            out = chunk(*args)
            last[:] = [out[1][0, 0].float()]
            return out

        ad._chunk = kept
        tok = ad.prefill(0, req).first_token
        got, toks = list(last), []
        for j in range(h["steps"]):
            toks.append(tok)
            tok, lg = step(ad, tok, n + j)
            got.append(lg)
        del ad, last
        # a fresh adapter's working tree holds init_cache's values
        ref = adapter()
        sizes = [h["chunk"]] * (n // h["chunk"]) + pow2_chunks(n % h["chunk"])
        tokens = torch.as_tensor(req.prompt[None], device="cuda")
        off = 0
        for size in sizes:
            _, lg, _ = ref._chunk(ref.params, tokens[:, off:off + size], None,
                                  off, ref._work)
            off += size
        ref.caches = ref._scatter(ref.caches, ref._work, 0)
        want = [lg[0, 0].float()]
        for j in range(h["steps"]):
            want.append(step(ref, toks[j], n + j)[1])
        del ref
    log(f"[hold_long_zamba2] {cfg.name} at {cfg.num_layers} layers (sites "
        f"{model.attn_sites}) in f32: a {n}-token prompt in pow2 chunks "
        f"{pow2_chunks(n)} against {len(sizes)} chunks ({n // h['chunk']} x "
        f"{h['chunk']}, then {pow2_chunks(n % h['chunk'])}), "
        f"{h['steps']} decode steps; card: {card}")
    out = logit_hold("hold_long_zamba2", list(zip(got, want)))
    del model, params, got, want
    free_card()
    return out


def phase_serve_long(card):
    """The 32k cells: the dry-run's counts first, then granite-20b,
    gemma3-27b and zamba2-1.2b whole at max_seq 32768, each freed before
    the next, zamba2-1.2b's long_500k cell, then the f32 holds."""
    import torch
    out = {}
    for arch, part in (("granite-20b", serve_long_granite),
                       ("gemma3-27b", serve_long_gemma3),
                       ("zamba2-1.2b", serve_long_zamba2)):
        batch, peaks = long_counts(arch)
        out[arch] = part(card, batch)
        out[arch]["counts"] = peaks
        log(f"[serve_long] {arch}: peak max_memory_allocated "
            f"{out[arch]['peak'] / 1e9:.2f} GB at batch {batch} (the count "
            f"{peaks['serve'] / 1e9:.2f} GB); card: {card}")
        if "paged" in peaks:
            check_all("serve_long", paged_peak_checks(arch, out[arch]["peak"],
                                                      peaks))
    out["zamba2-1.2b-500k"] = serve_long500k_zamba2(card)
    # the f32 holds run with TF32 off, as ``main`` sets it for every phase
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("serve_long's f32 holds need TF32 off")
    out["hold"] = {
        "granite-20b": hold_long_paged(card, "granite-20b",
                                       "hold_long_granite"),
        "zamba2-1.2b": hold_long_zamba2(card)}
    return out


# deepseek-moe-16b at its published width and depth (28 layers: the first
# dense, 27 with 64 routed experts top-6 and 2 shared; 16.38 B bf16
# params, 32.75 GB): the serve phase's 8 requests at batch 4 (4 routing
# groups of one row, capacity 1 a decode step), the same requests again
# on a fresh engine (the same tokens), and a short serve at batch 3 (one
# group of 3 rows, capacity 1: the rows compete for experts and drop)
SERVE_MOE = dict(arch="deepseek-moe-16b", seed=0)
# the MoE serve phase's second model, after deepseek-moe-16b is freed:
# moonshot-v1-16b-a3b at its published width and depth (48 layers, 64
# routed experts top-6 + 2 shared, vocab 163840; 28.39 B params, 56.8 GB
# in bf16)
SERVE_MOONSHOT = dict(arch="moonshot-v1-16b-a3b", seed=0)
MOE_B3 = dict(batch=3, max_seq=512, max_new=8, seed=1, lens=(30, 300), n=4)
# one full-width MoE layer held on the card against the host in f32: a
# 256-token prefill group (capacity 30), a 3-token decode group (capacity
# 1), and serve_long's two prefill groups: a cold 32768-token bucket
# (capacity 3840) and a prefix hit's 16384-token tail (capacity 1920); a
# routing disagreement is allowed only at a token whose router
# probabilities at the top-k cut differ by less than MOE_MARGIN. The
# output is held at every group but ``route_only``: the host's expert
# products at 32768 tokens took 14.9 s of a whole run that read 1,137 s
# against the 1,050 s it keeps (an NVIDIA H100 80GB HBM3 at 700 W)
MOE_HOLD = dict(groups=((1, 256), (3, 1), (1, 32768), (1, 16384)),
                route_only=((1, 32768),), seed=0)
# serve_long's MoE cells on the MoE phase's served weights: how many of
# ``long_requests(vocab, shared)`` each model serves at the batch its
# count allows (moonshot-v1-16b-a3b the first 2, one prefix hit: the
# script's time budget; a decode step of it took 159-213 ms of wall at
# 512 positions on an NVIDIA H100 80GB HBM3 at 700 W), and how near the
# count the serve's peak must read
SERVE_LONG_MOE = dict(n={"deepseek-moe-16b": 4, "moonshot-v1-16b-a3b": 2},
                      peak_rel=0.10)
MOE_MARGIN = 1e-5
MOE_REL_TOL = 1e-4


@contextlib.contextmanager
def moe_drops():
    """Count, on the device, the (token, expert) choices that
    ``moe.route`` routed and dropped inside the block, by routing shape
    (G, T, capacity); read once after the block."""
    from repro_torch.models import moe
    route = moe.route
    seen = {}

    def spy(xg, logits, cfg, capacity):
        out = route(xg, logits, cfg, capacity)
        key = (xg.shape[0], xg.shape[1], capacity)
        n, dropped = seen.get(key, (0, 0))
        seen[key] = (n + out[3].numel(), dropped + (~out[3]).sum())
        return out

    moe.route = spy
    try:
        yield seen
    finally:
        moe.route = route


def serve_moe_model(arch, seed, card, label="serve_moe"):
    """``arch`` (an MoE at its published width and depth) through
    ContinuousEngine on the paged path: the serve phase's requests at
    batch 4, twice on fresh engines (the same tokens), every prefill layer
    on flash's wgmma route. Returns (cfg, model, params, engine, flash
    launches, flash shapes)."""
    import torch
    from repro_torch.serve.engine import ContinuousEngine
    cfg, model, params = make_model(arch, seed)
    kw = dict(batch_size=SERVE["batch"], max_seq=SERVE["max_seq"])
    warm_up(model, params, serve_requests(cfg.vocab_size), **kw)
    eng = ContinuousEngine(model, params, **kw)
    reqs = serve_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    with flash_shapes() as shapes:
        stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
            lambda: eng.serve(reqs))
    log(f"[{label}] flash launches {n_flash} by route {routes}, shapes "
        f"(B, H, Hkv, S, T, D, causal, window, q_offset): "
        f"{sorted(shapes, key=str)}")
    log_serve(label, stats, wall, reqs, card)
    again = serve_requests(cfg.vocab_size)
    ContinuousEngine(model, params, telemetry=False, **kw).serve(again)
    same = [a.output == b.output for a, b in zip(reqs, again)]
    log(f"[{label}] a second serve of the same requests on a fresh "
        f"engine: {sum(same)} of {len(same)} requests emit the same tokens")
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    check_all(label, {
        "all 8 complete": stats["completed"] == len(reqs) == 8,
        "every request at its budget": all(
            len(r.output) == SERVE["max_new"] for r in reqs),
        "decode_compiles == 1": stats["decode_compiles"] == 1,
        "host syncs == prefills + decode steps": (
            n_syncs == stats["prefills"] + stats["decode_steps"]),
        "prefix hit rate > 0": stats["prefix_cache"]["hit_rate"] > 0,
        f"flash launches == {cfg.num_layers} x prefills, all wgmma": (
            n_flash == cfg.num_layers * stats["prefills"] > 0
            and routes == {"wgmma": n_flash, "ffma": 0} and windowed == 0),
        f"flash at MHA {h}:{hkv}, D {d}": all(
            sh[1:3] == (h, hkv) and sh[5] == d for sh in shapes),
        "every request has energy > 0": all(r.energy_j > 0 for r in reqs),
        "joule partition (1e-6 J)": joule_partition_error(eng, reqs) <= 1e-6,
        "tokens in vocab": all(0 <= t < cfg.vocab_size
                               for r in reqs for t in r.output),
        "two serves emit the same tokens": all(same),
    })
    return cfg, model, params, eng, n_flash, shapes


def phase_serve_moe(card):
    """deepseek-moe-16b through ContinuousEngine on the paged path at full
    width and depth: the serve phase's requests at batch 4 (twice, on
    fresh engines: the same tokens), then a short serve at batch 3 with
    the expert drops counted. Every prefill layer on flash's wgmma route
    (MHA 16:16, D 128)."""
    cfg, model, params, eng, n_flash, shapes = serve_moe_model(
        SERVE_MOE["arch"], SERVE_MOE["seed"], card)
    with moe_drops() as seen:
        b3_stats = short_serve("serve_moe_b3", cfg, model, params, card,
                               MOE_B3)["stats"]
    drops = {key: (n, int(d)) for key, (n, d) in seen.items()}
    log("[serve_moe_b3] routed and dropped (token, expert) choices by "
        "routing shape (groups, tokens a group, capacity): " + "; ".join(
            f"{key}: {d} of {n} dropped" for key, (n, d) in
            sorted(drops.items())))
    check_all("serve_moe_b3", {
        "decode steps route one group of 3 with capacity 1": (1, 3, 1)
        in drops,
        "the batch-3 decode steps drop experts": drops.get(
            (1, 3, 1), (0, 0))[1] > 0,
        "every layer routed a decode step": drops.get((1, 3, 1), (0, 0))[0]
        == b3_stats["decode_steps"] * (cfg.num_layers - cfg.first_k_dense)
        * 3 * cfg.experts_per_token,
    })
    return cfg, model, params, eng, n_flash, shapes


def hold_moe_layer(cfg, params):
    """The first MoE layer of the served weights, cast to f32, on the card
    and on the host (TF32 off): ``moe.route``'s expert ids, slots and keep
    mask equal for each of ``MOE_HOLD``'s groups (a token whose ids differ
    is reported with its router-probability margin at the top-k cut,
    allowed only below MOE_MARGIN), and at every group but ``route_only``
    ``moe_apply``'s output within MOE_REL_TOL of max|host| on the tokens
    routed alike; each side's seconds logged. Returns the largest
    relative error."""
    import torch
    from repro_torch.models import moe
    k, d = cfg.experts_per_token, cfg.d_model

    def layer0(tree):
        if isinstance(tree, dict):
            return {n: layer0(v) for n, v in tree.items()}
        return tree[0].float()

    dev = layer0(params["layers"]["moe"])
    host = {n: (v.cpu() if not isinstance(v, dict) else
                {m: u.cpu() for m, u in v.items()}) for n, v in dev.items()}
    g = torch.Generator().manual_seed(MOE_HOLD["seed"])
    worst = 0.0
    for b, s in MOE_HOLD["groups"]:
        x = torch.randn(b, s, d, generator=g)
        groups = moe.n_groups(b)
        tg = b * s // groups
        cap = moe.capacity_for(cfg, tg)
        sides, secs = {}, {}
        held_y = (b, s) not in MOE_HOLD["route_only"]
        for side, p, xs in (("card", dev, x.cuda()), ("host", host, x)):
            t0 = time.perf_counter()
            xf = xs.reshape(groups, tg, d)
            logits = xf @ p["router"]
            probs = torch.softmax(logits, dim=-1)
            _, ids = moe.top_k(probs, k)
            _, (slot, tok, order), _, keep, aux = moe.route(xf, logits, cfg,
                                                            cap)
            kept = torch.empty_like(keep).scatter_(1, order, keep)
            y = moe.moe_apply(xs, p, cfg)[0] if held_y else xs
            sides[side] = [v.cpu() for v in (probs, ids, slot, keep, kept, y)]
            secs[side] = time.perf_counter() - t0
        (_, ids_c, slot_c, keep_c, kept_c, y_c) = sides["card"]
        (probs_h, ids_h, slot_h, keep_h, kept_h, y_h) = sides["host"]
        # a token routed alike: the same experts, each kept or dropped alike
        alike = ((ids_c == ids_h).all(-1)
                 & (kept_c.reshape(groups, tg, k)
                    == kept_h.reshape(groups, tg, k)).all(-1))
        top = probs_h.sort(dim=-1, descending=True).values
        margin = top[..., k - 1] - top[..., k]
        differ = ~(ids_c == ids_h).all(-1)
        margins = margin[differ].tolist()
        rows = alike.reshape(b, s)
        err = (y_c - y_h).abs()[rows].max().item() if rows.any() else 0.0
        rel = err / y_h.abs().max().item() if held_y else 0.0
        worst = max(worst, rel)
        n_drop = int((~keep_h).sum())
        log(f"[hold_moe] {cfg.name} layer 1 (first MoE) f32, x [{b},{s},"
            f"{d}]: {groups} group(s) of {tg} tokens, capacity {cap}, "
            f"{n_drop} of {keep_h.numel()} choices dropped on the host; "
            f"ids equal {bool((ids_c == ids_h).all())}, slots equal "
            f"{bool((slot_c == slot_h).all())}, keep equal "
            f"{bool((keep_c == keep_h).all())}; tokens routed differently "
            f"{int(differ.sum())} (their router-probability margins "
            f"{margins}, limit {MOE_MARGIN:g}); "
            + (f"max|y card - y host| {err:.3e} over {int(rows.sum())} "
               f"tokens routed alike, {rel:.3e} of max|y| (tol "
               f"{MOE_REL_TOL:g})" if held_y else "routing only")
            + f"; card {secs['card']:.1f} s, host {secs['host']:.1f} s")
        routing_equal = bool((ids_c == ids_h).all() and (slot_c == slot_h)
                             .all() and (keep_c == keep_h).all())
        checks = {
            f"[{b},{s}]: routing equal, or differs only below the margin": (
                routing_equal or all(m < MOE_MARGIN for m in margins))}
        if held_y:
            checks[f"[{b},{s}]: output within {MOE_REL_TOL:g} relative"] = (
                rel <= MOE_REL_TOL and bool(torch.isfinite(y_c).all()))
        check_all("hold_moe", checks)
    del dev, host
    return worst


def serve_long_moe(card, cfg, model, params, label, profile=False):
    """(e), (f): an MoE model at its published width and depth, on the
    weights the MoE phase served, through serve_long's 32k cell on the
    paged path. The dry-run's count first (``long_counts``: the largest of
    batch 4, 2 and 1 that leaves ``free_share`` free); a model it finds
    no batch for does not serve, and is gated as the count reads it. Then
    ``SERVE_LONG_MOE["n"]`` of ``long_requests(vocab, shared)`` through
    ``short_serve`` at that batch with (a)'s gates and the routing watched
    (``moe_drops``): one group a prefill of its bucket's tokens (the cold
    32768 with capacity 3840, a tail's 16384 with 1920) and b groups of
    one token a decode step (capacity 1), every MoE layer routing each;
    the peak within ``peak_rel`` of the count and under the limit. With
    ``profile``: one cold 32768-token prefill of request 0's bucket and
    a decode step at position 32767 (kernels only, by class), then the
    dry-run's count of a decode step
    at position 32767 on a contiguous cache of b x 32768 against the
    card's. Returns ``short_serve``'s dict without the engine, with
    ``batch``, ``counts`` and ``routing`` ({(G, T, capacity): (choices,
    dropped)}); dict(batch=None, counts) where the count fits no
    batch."""
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.models import moe
    from repro_torch.serve.step import bucket_for, pad_to_bucket
    c, m = SERVE_LONG, SERVE_LONG_MOE
    limit = card_limit(c["free_share"])
    batch, peaks = long_counts(cfg.name)
    if batch is None:
        check_all(label, {
            f"{cfg.name}: the count fits no batch (one row: "
            f"{peaks['serve_b1'] / 1e9:.2f} GB)": peaks["serve_b1"] > limit})
        return dict(batch=None, counts=peaks)
    reqs = long_requests(cfg.vocab_size, c["shared"])[:m["n"][cfg.name]]
    r = short_serve(label, cfg, model, params, card, dict(c, batch=batch),
                    reqs, warm=c["warm"], watch=moe_drops)
    stats, eng = r["stats"], r["eng"]
    seen = {key: (n, int(dropped))
            for key, (n, dropped) in r.pop("watched").items()}
    buckets = {bucket_for(len(q.prompt) - q.cached_prompt_tokens,
                          eng.buckets) for q in reqs}
    step_key = (moe.n_groups(batch), batch // moe.n_groups(batch),
                moe.capacity_for(cfg, batch // moe.n_groups(batch)))
    want = {(1, t, moe.capacity_for(cfg, t)) for t in buckets} | {step_key}
    routed = (cfg.num_layers - cfg.first_k_dense) * cfg.experts_per_token
    log(f"[{label}] routed and dropped (token, expert) choices by routing "
        f"shape (groups, tokens a group, capacity): " + "; ".join(
            f"{key}: {d} of {n} dropped ({d / n:.1%})"
            for key, (n, d) in sorted(seen.items()))
        + f"; peak max_memory_allocated {r['peak'] / 1e9:.2f} GB against the "
        f"count's {peaks['serve'] / 1e9:.2f} GB at batch {batch} "
        f"({r['peak'] / peaks['serve'] - 1:+.2%}); card: {card}")
    check_all(label, prefix_checks(cfg, reqs, r) | {
        f"routing shapes == {sorted(want)}": set(seen) == want,
        "every MoE layer routed every decode row": seen.get(
            step_key, (0, 0))[0] == stats["decode_steps"] * batch * routed,
        "every MoE layer routed every prefill's bucket": sum(
            n for key, (n, _) in seen.items() if key != step_key)
        == routed * sum(bucket_for(len(q.prompt) - q.cached_prompt_tokens,
                                   eng.buckets) for q in reqs),
        f"peak within {m['peak_rel']:.0%} of the count": (
            abs(r["peak"] - peaks["serve"]) <= m["peak_rel"] * r["peak"]),
        f"peak under {limit / 1e9:.0f} GB": r["peak"] <= limit,
    } | paged_peak_checks(cfg.name, r["peak"], peaks))
    if profile:
        padded, _ = pad_to_bucket(reqs[0].prompt, eng.buckets)
        r["profile"] = profile_cold_prefill(
            f"profile_{label}", eng,
            torch.as_tensor(padded[None], device="cuda"), card)
        # every slot is free: a decode step of the batch's null rows at
        # the cell's last position, over whole 32768-position views
        tokens = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
        pos = torch.full((batch,), c["max_seq"] - 1, dtype=torch.int32,
                         device="cuda")
        r["profile"] |= profile_steps(f"profile_{label}", {
            f"decode step ({batch} rows at {c['max_seq'] - 1})":
                lambda: eng.adapter.decode_step(tokens, pos)})
        del tokens, pos
    del eng
    r.pop("eng")
    free_card()
    if profile:
        r["dryrun"] = dryrun_decode(model, params, card, c["max_seq"], batch)
    r.update(batch=batch, counts=peaks, routing=seen)
    return r


def phase_serve_long_moe(card):
    """serve_long's MoE part alone, as ``main`` runs it on the MoE phase's
    served weights but with each model made here from seed 0 and freed
    before the next: deepseek-moe-16b's first MoE layer held card
    against host (``hold_moe_layer``), its 32k serve (e) with the
    profile and the dry-run's decode count, its f32 hold at 2 layers,
    moonshot-v1-16b-a3b's 32k serve (f), then the two flash rows at their
    shapes (``timing_long``). Returns ({arch: serve, "hold": ...}, rows)."""
    c = SERVE_LONG
    cfg, model, params = make_model(SERVE_MOE["arch"], c["seed"])
    hold_moe_layer(cfg, params)
    free_card()
    out = {cfg.name: serve_long_moe(card, cfg, model, params,
                                    "serve_long_moe", profile=True)}
    del model, params
    free_card()
    out["hold"] = hold_long_paged(card, cfg.name, "hold_long_moe",
                                  same_chunks=True)
    cfg, model, params = make_model(SERVE_MOONSHOT["arch"], c["seed"])
    out[cfg.name] = serve_long_moe(card, cfg, model, params,
                                   "serve_long_moonshot", profile=True)
    del model, params
    free_card()
    return out, time_long_rows(out, moe_long_specs())


# the recurrent families at their published widths and full depth, bf16
# weights from seed 0: xlstm-1.3b (48 layers, 42 mLSTM with C [4,1024,1024]
# a row and a layer, 6 sLSTM), zamba2-1.2b (32 mamba2 layers, one shared
# attention block at 6 sites, 32:32 heads of 64) and whisper-small (12
# encoder layers over 1500 frames, non-causal; 12 decoder layers). Prompts
# of 100-300 tokens, every other one odd (it ends in a 1-token chunk);
# whisper's frames [1500, 768] from a numpy seed
SERVE_RECURRENT = dict(archs=("xlstm-1.3b", "zamba2-1.2b", "whisper-small"),
                       batch=4, n=8, lens=(100, 301), max_new=32,
                       max_seq=512, seed=0,
                       # batched against sequential, teacher-forced
                       check=dict(batch=3, n=3, steps=8))
# batch-3 decode logits against batch-1 ones fed the same tokens, with the
# served weights cast to f32 (TF32 off): max|diff| within this share of
# max|logit|. cuBLAS may take another kernel for 3 rows than for 1; in f32
# that moves logits by ~1e-5 of max|logit| a step, and the recurrent
# state carries it forward (xlstm-1.3b on an NVIDIA H100 80GB HBM3 at
# 700 W: 1.1e-5 at the first step, 1.5e-4 by the 8th). In bf16 the same
# rounding difference compounds to 6 % at the first step and 39 % by the
# 8th there, so the bf16 run is a reading, not a gate
RECURRENT_LOGIT_TOL = 1e-3


def recurrent_requests(cfg, c):
    """``c["n"]`` requests of ``c["lens"]`` tokens from seed ``c["seed"]``
    (every other length made odd), with frames for whisper."""
    import numpy as np
    from repro_torch.models.registry import serving_caps
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(c["seed"])
    lens = rng.integers(*c["lens"], c["n"])
    lens[::2] |= 1
    frames = serving_caps(cfg).needs_frames
    return [Request(i, rng.integers(0, cfg.vocab_size, int(n)).astype(
        np.int32), max_new_tokens=c["max_new"],
        frames=(rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(
            np.float32) if frames else None))
        for i, n in enumerate(lens)]


def recurrent_flash_sites(model):
    """Attention layers a prefill chunk of S >= 2 runs on the flash kernel
    (zamba2's shared-attention sites, whisper's decoder layers), and the
    flash launches an encoded request adds (whisper's encoder layers)."""
    cfg = model.cfg
    if cfg.family == "hybrid":
        return len(model.attn_sites), 0
    if cfg.family == "audio":
        return cfg.num_layers, cfg.enc_layers
    return 0, 0


def teacher_forced_check(label, model, params, reqs, c, gate=True):
    """Batched against sequential decode on the card: ``c["n"]`` requests
    decoded one at a time (batch-1 adapters, greedy), then fed the same
    tokens through one batch-``c["batch"]`` adapter. The prefills (batch 1
    on both sides) must give the same first tokens; with ``gate`` each
    decode step's logits must agree within RECURRENT_LOGIT_TOL of
    max|logit|, and greedy choices may differ only at steps whose top-2
    margin is under that tolerance (without it those two are logged
    only). Returns (max share, steps under the margin, greedy
    differences above it)."""
    import torch
    from repro_torch.serve.state import make_adapter
    reqs = reqs[:c["n"]]
    kw = dict(max_seq=SERVE_RECURRENT["max_seq"])

    def step(ad, toks, pos):
        tok_t = torch.tensor(toks, dtype=torch.int32,
                             device=ad.device)[:, None]
        pos_t = torch.tensor(pos, dtype=torch.int32, device=ad.device)
        nxt, logits, ad.caches = ad._decode(ad.params, tok_t, pos_t,
                                            ad.caches)
        return nxt[:, 0].tolist(), logits[:, 0].float()

    seq = []                           # per request: (first, [(tok, logits)])
    for r in reqs:
        ad = make_adapter(model, params, batch_size=1, **kw)
        ad.ensure_ready()
        tok = ad.prefill(0, r).first_token
        first, fed = tok, []
        for t in range(c["steps"]):
            (nxt,), logits = step(ad, [tok], [len(r.prompt) + t])
            fed.append((tok, logits[0]))
            tok = nxt
        seq.append((first, fed))
        del ad
    ad = make_adapter(model, params, batch_size=c["batch"], **kw)
    ad.ensure_ready()
    firsts = [ad.prefill(i, r).first_token for i, r in enumerate(reqs)]
    worst, under, differ = 0.0, 0, 0
    by_step = []
    for t in range(c["steps"]):
        _, logits = step(ad, [f[t][0] for _, f in seq],
                         [len(r.prompt) + t for r in reqs])
        by_step.append(0.0)
        for i, (_, fed) in enumerate(seq):
            want = fed[t][1]
            scale = want.abs().max().item()
            share = (logits[i] - want).abs().max().item() / scale
            by_step[-1] = max(by_step[-1], share)
            worst = max(worst, share)
            top2 = want.topk(2).values
            margin = (top2[0] - top2[1]).item() / scale
            same = int(logits[i].argmax()) == int(want.argmax())
            if margin <= RECURRENT_LOGIT_TOL:
                under += 1
            elif not same:
                differ += 1
    del ad
    n = len(reqs) * c["steps"]
    log(f"[{label}] batched (batch {c['batch']}) against sequential, "
        f"{len(reqs)} requests x {c['steps']} teacher-forced decode steps: "
        f"first tokens equal {firsts == [f for f, _ in seq]}; max|logit "
        f"diff| {worst:.3e} of max|logit| (tol {RECURRENT_LOGIT_TOL:g}); "
        f"{under} of {n} steps with a top-2 margin under the tolerance; "
        f"greedy choices that differ above it: {differ}; max|logit diff| "
        f"share by step {[float(f'{x:.2e}') for x in by_step]}")
    checks = {"first tokens equal (batch-1 prefills on both sides)":
              firsts == [f for f, _ in seq]}
    if gate:
        checks.update({
            f"decode logits within {RECURRENT_LOGIT_TOL:g} of max|logit|":
                worst <= RECURRENT_LOGIT_TOL,
            "no greedy choice differs above the margin": differ == 0})
    check_all(label, checks)
    return worst, under, differ


def phase_serve_recurrent(card):
    """xlstm-1.3b, zamba2-1.2b and whisper-small at full width and depth
    through ContinuousEngine on the recurrent-state adapter, one after the
    other (each freed before the next): 8 requests at batch 4 (every slot
    reused), 32 new tokens each, max_seq 512. Gates: every request at its
    budget, one decode signature, prefill signatures within the distinct
    pow2 chunk sizes (plus the frames variant), one host sync a prefill and
    a decode step, joules partitioned, a second serve on a fresh engine
    the same tokens, the batched-against-sequential check at batch 3, and
    flash launches == attention sites x chunks of S >= 2 (+ whisper's
    encoder layers a request), all on wgmma. Then each family's profile (a
    decode step of 4 rows, a cold 256-token first chunk; xlstm's sLSTM
    layer over 256 tokens alone). Returns {arch: (flash launches, shapes,
    stats)}."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import serving_caps
    from repro_torch.models.xlstm import slstm_block
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.step import pow2_chunks
    c = SERVE_RECURRENT
    out = {}
    for arch in c["archs"]:
        label = f"serve_{arch.split('-')[0]}"
        cfg, model, params = make_model(arch, c["seed"])
        kw = dict(batch_size=c["batch"], max_seq=c["max_seq"])
        warm_up(model, params, recurrent_requests(cfg, c), **kw)
        eng = ContinuousEngine(model, params, **kw)
        reqs = recurrent_requests(cfg, c)
        torch.cuda.reset_peak_memory_stats()
        with flash_shapes() as shapes:
            stats, wall, n_syncs, (n_flash, routes, windowed) = counted_path(
                lambda: eng.serve(reqs))
        chunks = [pow2_chunks(len(r.prompt)) for r in reqs]
        if serving_caps(cfg).needs_frames:
            bound = (len({ch[0] for ch in chunks})
                     + len({x for ch in chunks for x in ch[1:]}))
        else:
            bound = len({x for ch in chunks for x in ch})
        sites, per_request = recurrent_flash_sites(model)
        want_flash = (sites * sum(x >= 2 for ch in chunks for x in ch)
                      + per_request * len(reqs))
        log(f"[{label}] prompts {[len(r.prompt) for r in reqs]}, pow2 "
            f"chunks {chunks}; flash launches {n_flash} (want {want_flash}) "
            f"by route {routes}, shapes (B, H, Hkv, S, T, D, causal, "
            f"window, q_offset): {sorted(shapes, key=str)}; signatures "
            f"{stats['compiles']}")
        log_serve(label, stats, wall, reqs, card)
        again = recurrent_requests(cfg, c)
        ContinuousEngine(model, params, telemetry=False, **kw).serve(again)
        same = [a.output == b.output for a, b in zip(reqs, again)]
        log(f"[{label}] a second serve of the same requests on a fresh "
            f"engine: {sum(same)} of {len(same)} requests emit the same "
            f"tokens")
        check_all(label, {
            "all 8 complete": stats["completed"] == len(reqs) == c["n"],
            "every request at its budget": all(
                len(r.output) == c["max_new"] for r in reqs),
            "adapter recurrent": stats["adapter"] == "recurrent",
            "decode_compiles == 1": stats["decode_compiles"] == 1,
            f"prefill signatures <= {bound} (pow2 chunk sizes)": (
                0 < stats["prefill_compiles"] <= bound),
            "state_scatter signatures == 1": (
                stats["compiles"].get("state_scatter") == 1),
            "some prompt ends in a 1-token chunk": any(
                ch[-1] == 1 for ch in chunks),
            "host syncs == prefills + decode steps": (
                n_syncs == stats["prefills"] + stats["decode_steps"]),
            "flash launches == sites x chunks of S >= 2 (+ encoder), all "
            "wgmma": (n_flash == want_flash
                      and routes == {"wgmma": n_flash, "ffma": 0}
                      and windowed == 0),
            "every request has energy > 0": all(r.energy_j > 0
                                                for r in reqs),
            "joule partition (1e-6 J)": (
                joule_partition_error(eng, reqs) <= 1e-6),
            "tokens in vocab": all(0 <= t < cfg.vocab_size
                                   for r in reqs for t in r.output),
            "two serves emit the same tokens": all(same),
        })
        if cfg.family == "hybrid":
            # the sharded serve step (its compute split over model) at one
            # NCCL rank: the model's own steps bit for bit
            serve_sharded_one_rank(model, params, card, label,
                                   c["max_seq"], len(model.attn_sites))
        # batched against sequential: the served bf16 weights (a reading),
        # then the same weights in f32 (the gate)
        b3 = {"bf16": teacher_forced_check(f"{label}_b3_bf16", model, params,
                                           reqs, c["check"], gate=False)}
        params32 = tree_map(lambda t: t.float(), params)
        b3["f32"] = teacher_forced_check(
            f"{label}_b3_f32", build_model(cfg.replace(dtype="float32")),
            params32, reqs, c["check"])
        del params32
        # the profile: every slot is free after the serve
        ad = eng.adapter
        b = eng.batch_size
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=ad.device)
        pos = torch.full((b,), min(300, c["max_seq"] - 1),
                         dtype=torch.int32, device=ad.device)
        n = min(256, c["max_seq"] // 2)
        prompt = torch.zeros((1, n), dtype=torch.int32, device=ad.device)
        frames = (torch.randn(1, cfg.enc_seq, cfg.d_model, device=ad.device)
                  if serving_caps(cfg).needs_frames else None)
        steps = {
            "prefill chunk (256 tokens, first)": lambda: ad._chunk(
                ad.params, prompt, frames, 0, ad._work)}
        if cfg.family == "ssm":
            x = torch.randn(1, n, cfg.d_model, device=ad.device,
                            dtype=torch.bfloat16)
            st = ad._work["slstm_0"]
            steps["sLSTM layer (256 tokens)"] = lambda: slstm_block(
                x, params["slstm_0"], cfg, st)
        # xlstm's chunk launches ~44k kernels: one call a profile
        label_p = f"profile_{arch.split('-')[0]}"
        prof = profile_steps(label_p, {
            "decode step (4 rows)": lambda: ad.decode_step(tokens, pos)})
        prof.update(profile_steps(label_p, steps, n=1))
        out[arch] = dict(launches=n_flash, shapes=shapes, stats=stats,
                         profile=prof, model=model.cfg, b3=b3)
        del eng, ad, params, model, steps
        free_card()
    return out


# internvl2-76b at its published width (d_model 8192, 64 q / 8 kv heads,
# d_ff 28672, vocab 128256), the depth cut to 32 of 80 layers (1.711 GB a
# layer in bf16, 141 GB at full depth): forward over 256 patch embeddings
# and 256 tokens, then a short text-only serve (serving is text only, as in
# the reference)
VLM = dict(arch="internvl2-76b", layers=32, patches=256, tokens=256, seed=0,
           serve=dict(batch=4, max_seq=512, max_new=8, seed=0,
                      lens=(30, 300), n=4))


def phase_vlm(card):
    """internvl2-76b's forward with its patch prefix on the card: logits
    finite, every layer's flash on wgmma at S 512 (64:8 heads, D 128);
    then its text serve. Returns (flash launches, the forward's flash
    shape)."""
    import torch
    c = VLM
    cfg, model, params = make_model(c["arch"], c["seed"], c["layers"])
    g = torch.Generator(device="cuda")
    g.manual_seed(c["seed"])
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, c["tokens"]),
                                     device="cuda", generator=g),
             "patch_embeddings": torch.randn(
                 1, c["patches"], cfg.d_model, device="cuda", generator=g,
                 dtype=torch.bfloat16)}
    with torch.no_grad(), flash_shapes() as shapes:
        (logits, aux), wall, n_syncs, (n_flash, routes, windowed) = \
            counted_path(lambda: model.forward(params, batch))
    s = c["patches"] + c["tokens"]
    finite = bool(torch.isfinite(logits).all())
    log(f"[vlm] {cfg.name} forward, {c['patches']} patch embeddings + "
        f"{c['tokens']} tokens: logits {tuple(logits.shape)} "
        f"{str(logits.dtype)[6:]}, finite {finite}, max|logit| "
        f"{logits.float().abs().max().item():.3f}; {wall * 1e3:.1f} ms "
        f"wall, {n_syncs} host syncs; flash launches {n_flash} by route "
        f"{routes}, shapes {sorted(shapes, key=str)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    want_shape = (1, cfg.num_heads, cfg.num_kv_heads, s, s, cfg.head_dim,
                  True, None, 0)
    check_all("vlm", {
        "logits [1, 512, vocab], finite": (
            tuple(logits.shape) == (1, s, cfg.vocab_size) and finite),
        "aux 0.0 (no MoE layers)": aux == 0.0,
        "flash launches == 32, all wgmma": (
            n_flash == cfg.num_layers and routes == {"wgmma": n_flash,
                                                     "ffma": 0}),
        "flash at q [1,64,512,128], kv [1,8,512,128]": set(shapes) == {want_shape},
    })
    del logits, batch
    n_serve = short_serve("vlm_serve", cfg, model, params, card,
                          c["serve"])["flash"]
    del params, model
    return n_flash + n_serve, want_shape


# granite-20b at its published width with the depth cut to 4 of 52 layers
# (f32 master, gradient and AdamW moments are 16 bytes a parameter: 451 GB
# at full depth), bf16 compute: batch 8 x 512 tokens in 2 microbatches,
# 6 steps through train.loop.run
TRAIN = dict(arch="granite-20b", layers=4, batch=8, seq=512, micro=2,
             steps=6, lr=3e-4, seed=0, profile=True)
# the train phase's other configurations, after granite-20b's and in this
# order: each family at its published width through the same loop and
# gates, f32 masters made on the card from the seed; the depth cut (layers,
# None: whole) where the dry-run's count (DRYRUN["cuts"]) says the whole
# model's train state does not fit 80 GB: deepseek-moe-16b is 262 GB of
# state whole, internvl2-76b 62.1 GB at 2 layers before its activations.
# whisper-small trains on its released models' 448-token text context over
# 1500 frames a row, internvl2-76b on 256 patches + 256 tokens a row.
# xlstm-1.3b takes 2 steps (the median reads step 2) and no profiled step:
# its step is 14-18 s of sLSTM token loop, and its profile (560k kernels,
# PERF.md §5) stands while models/xlstm.py is unchanged; the script's time
# budget, for the train_4k runs
TRAIN_FAMILIES = (
    dict(TRAIN, arch="zamba2-1.2b", layers=None, steps=4),
    dict(TRAIN, arch="whisper-small", layers=None, seq=448, steps=4),
    dict(TRAIN, arch="xlstm-1.3b", layers=None, steps=2, profile=False),
    dict(TRAIN, arch="deepseek-moe-16b", layers=4, steps=4),
    dict(TRAIN, arch="internvl2-76b", layers=1, batch=4, seq=256, steps=4),
)
# train_4k's sequence on the card (configs/base.py SHAPES: 256 rows x 4096
# tokens in 16 microbatches, the batch cut to 2 x 4096 in 2 microbatches,
# one row a microbatch), 3 steps from the masters the family's run above
# left (its AdamW moments zeroed), for these families at their train
# phase's depth (granite-20b at 4 of 52 layers, deepseek-moe-16b at 4 of
# 28, the other two whole; xlstm-1.3b waits on its sLSTM token loop,
# internvl2-76b's one layer is the dense decoder granite's run covers).
# Each is first counted on the meta device (the train_4k_card cell), and
# runs only where the count leaves 5 % of 80 GB free; its loop's peak
# must read within DRYRUN["peak_rel"] of that count. A profiled step for
# ``profiled``
TRAIN_4K = dict(batch=2, seq=4096, micro=2, steps=3, lr=3e-4, seed=0,
                free_share=0.05,
                archs=("granite-20b", "zamba2-1.2b", "whisper-small",
                       "deepseek-moe-16b"),
                profiled=("granite-20b", "deepseek-moe-16b"))


def train_flash_launches(cfg, model, micro, steps):
    """The flash launches ``steps`` train steps of ``micro`` microbatches
    give, from where each family runs attention under its remat: a layer
    inside a checkpoint launches twice a microbatch (the forward and the
    backward's recompute; the Function's own backward is the plain
    version). The decoder LMs checkpoint every layer (the dense prefix
    too); whisper each encoder and decoder layer (``models/whisper.py``
    ``_remat``; its cross attention is not on flash); zamba2's shared
    attention runs outside the checkpoint (``models/mamba2.py`` ``_stack``),
    once a site; xlstm has no attention."""
    if cfg.family == "ssm":
        per = 0
    elif cfg.family == "hybrid":
        per = len(model.attn_sites)
    elif cfg.family == "audio":
        per = 2 * (cfg.enc_layers + cfg.num_layers)
    else:
        per = 2 * cfg.num_layers
    return per * micro * steps


def train_model_flop(cfg, params, c):
    """(model FLOP a step, what it counts): 6·N over every position the
    model runs, the remat recompute not counted. N is every parameter,
    the embedding with it, but for an MoE only the active ones (the
    shared experts and top-k of the routed: ``perf.roofline.
    active_params``); a VLM's backbone runs over its patches too;
    whisper's encoder counts over its frames, the rest over the tokens."""
    from repro_torch.perf import roofline
    n = sum(p.numel() for p in _leaves(params))
    rows, seq = c["batch"], c["seq"]
    if cfg.family == "audio":
        n_enc = sum(p.numel() for p in _leaves(
            {k: params[k] for k in ("encoder", "enc_final_norm")}))
        return (6 * rows * (n_enc * cfg.enc_seq + (n - n_enc) * seq),
                f"6·N·positions: the encoder's {n_enc / 1e9:.3f} B params "
                f"over {cfg.enc_seq} frames a row, the other "
                f"{(n - n_enc) / 1e9:.3f} B over {seq} tokens")
    n_act = roofline.active_params(cfg, n)
    pos = seq + (cfg.stub_prefix_len if cfg.family == "vlm" else 0)
    what = (f"6·N·positions, N the {n_act / 1e9:.3f} B active params "
            f"(the {cfg.num_shared_experts} shared experts and "
            f"{cfg.experts_per_token} routed of {cfg.num_experts}) of "
            f"{n / 1e9:.3f} B" if cfg.is_moe else
            "6·N·tokens (N with the embedding" + (
                f"; {cfg.stub_prefix_len} patches + {seq} tokens a row"
                if cfg.family == "vlm" else "") + ")")
    return 6 * n_act * rows * pos, what


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def count_train_4k(arch, layers):
    """The dry-run's count of one step of ``arch`` cut to ``layers`` (None:
    whole) at train_4k's sequence (the ``train_4k_card`` cell:
    ``TRAIN_4K``'s batch in its microbatches) on a one-device mesh, on the
    meta device: {peak, arguments, params, layers, seconds}. Device-free."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    cfg = configs.get(arch)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    rec, _ = dryrun.analyze_cell(arch, phase_cells()["train_4k_card"],
                                 ONE_DEVICE, {"n_micro": TRAIN_4K["micro"]},
                                 cfg)
    return dict(peak=rec["analysis"]["peak_bytes"],
                arguments=rec["analysis"]["memory"]["argument_bytes"],
                params=rec["n_params"], layers=cfg.num_layers,
                seconds=time.perf_counter() - t0)


def count_train_4k_runs():
    """{arch: ``count_train_4k``'s record} for each run of
    ``TRAIN_4K["archs"]`` at its train phase's depth."""
    return {c["arch"]: count_train_4k(c["arch"], c["layers"])
            for c in (TRAIN, *TRAIN_FAMILIES)
            if c["arch"] in TRAIN_4K["archs"]}


def start_host_work():
    """(pool, counts, {arch: host steps}, sizes): the script's device-free
    work as futures of one spawned worker process (no CUDA there), so that
    it overlaps the card's device-bound phases: first the dry-run's count
    of each train_4k run (``count_train_4k_runs``, 40-60 s of the card
    machine's host, zamba2-1.2b's SSD loop the most), then the host's half
    of each 4096 smoke step (``small_host_steps`` with
    ``SMALL_TRAIN_4K["host_threads"]`` threads, 100-140 s at 4), then the
    dryrun phase's (c) and (d) (``dryrun_size_records``, 80-105 s). The
    caller starts it after the phases whose readings are host-bound and
    shuts the pool down."""
    import multiprocessing
    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    counts = pool.submit(count_train_4k_runs)
    hosts = {arch: pool.submit(small_host_steps, arch, SMALL_TRAIN_4K)
             for arch in TRAIN_4K["archs"]}
    return pool, counts, hosts, pool.submit(dryrun_size_records)


def gate_train_4k_fit(c, card, r):
    """Logs ``r``, the dry-run's count of a train_4k run of ``c``
    (``count_train_4k``), before the run, and fails the phase with its
    reason where the count leaves less than ``TRAIN_4K["free_share"]`` of
    the card free: 4096 is the cell, so nothing runs at a shorter
    sequence. Returns the counted peak in bytes."""
    peak, limit = r["peak"], card_limit(TRAIN_4K["free_share"])
    log(f"[train_4k {c['arch']}] the dry-run's count of one step, "
        f"{r['layers']} layers, batch {TRAIN_4K['batch']} x "
        f"{TRAIN_4K['seq']} in {TRAIN_4K['micro']} microbatches "
        f"(train_4k_card, one device): {r['params'] / 1e9:.3f} B params, "
        f"peak {peak / 1e9:.2f} GB (arguments {r['arguments'] / 1e9:.2f} "
        f"GB) against {limit / 1e9:.0f} GB "
        f"({TRAIN_4K['free_share']:.0%} of 80 GB free), counted in "
        f"{r['seconds']:.1f} s; card: {card}")
    check_all(f"train_4k {c['arch']}", {
        f"the count ({peak / 1e9:.2f} GB) fits {limit / 1e9:.0f} GB":
            peak <= limit})
    return peak


def train_4k_shapes(cfg, model, c):
    """{flash shape (B, H, Hkv, S, T, D, causal, window, q_offset):
    launches} a loop of ``c`` gives the kernel, from where each family
    runs attention under its remat (``train_flash_launches``): one row a
    microbatch at S = T = ``c["seq"]``, causal; whisper's encoder over its
    frames, non-causal, beside its decoder."""
    b, n = c["batch"] // c["micro"], c["micro"] * c["steps"]
    h, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dec = (b, h, hkv, c["seq"], c["seq"], d, True, None, 0)
    if cfg.family == "audio":
        return {(b, h, hkv, cfg.enc_seq, cfg.enc_seq, d, False, None, 0):
                2 * cfg.enc_layers * n, dec: 2 * cfg.num_layers * n}
    return {dec: train_flash_launches(cfg, model, c["micro"], c["steps"])}


def train_run(label, cfg, model, state, c, card, count=None):
    """One loop of the configuration ``c`` from ``state``: train.step.
    make_train_step under counting_call, through train.loop.run with a
    tracer and a registry, over SyntheticTokens at ``c``'s batch and
    sequence. Step 1's gradients are read once before the loop (every
    leaf nonzero: the flash kernel's Function carries wq, wk and wv a
    gradient; an MoE's read twice, bitwise the same); the flash counts
    and the host syncs are zeroed just before the loop and read just
    after. ``count`` (train_4k's runs): the dry-run's peak, against which
    the loop's max_memory_allocated is held; the flash launches must then
    come at exactly ``train_4k_shapes`` and an MoE's routing at one group
    of the row's tokens in every MoE layer of every microbatch. Returns
    (state, the run's readings, its data, step and configs)."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core.tracing import TraceStats, counting_call
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           batch_to_device)
    from repro_torch.models import moe
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.optimizer import OptConfig, tree_leaves
    from repro_torch.train.step import (StepConfig, make_grad_fn,
                                        make_train_step)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    tokens = c["batch"] * c["seq"]
    opt_cfg = OptConfig(lr=c["lr"], warmup_steps=min(20, c["steps"] // 5),
                        total_steps=c["steps"])
    step_cfg = StepConfig(num_microbatches=c["micro"])
    data = SyntheticTokens(DataConfig(seed=c["seed"],
                                      vocab_size=cfg.vocab_size,
                                      seq_len=c["seq"],
                                      global_batch=c["batch"]), cfg)
    # step 1's gradients, read once (this also warms up the forward and
    # backward shapes before the loop)
    t0 = time.perf_counter()
    loss0, grads = make_grad_fn(model, step_cfg)(
        state.params, batch_to_device(data.batch(0), "cuda"))
    names, leaves = zip(*_named(grads))
    amax = torch.stack([g.abs().amax() for g in leaves]).tolist()
    finite = torch.stack([torch.isfinite(g).all() for g in leaves]).all()
    zero = [n for n, a in zip(names, amax) if not a > 0]
    log(f"[{label}] step 1's gradients in {time.perf_counter() - t0:.2f} "
        f"s: loss {loss0.item():.4f}; max|grad| by leaf " + ", ".join(
            f"{n} {a:.3e}" for n, a in zip(names, amax)))
    grads_ok = bool(finite) and not zero
    checks = {}
    if cfg.is_moe:
        # an MoE's step-1 gradients again, bitwise: the dispatch's backward
        # sums a token's k rows in a fixed order (models/moe.py route),
        # where a scatter-add by token index would add them with atomics
        _, again = make_grad_fn(model, step_cfg)(
            state.params, batch_to_device(data.batch(0), "cuda"))
        same = all(torch.equal(a, b) for a, b in zip(leaves, _leaves(again)))
        log(f"[{label}] step 1's gradients read again: bitwise the same "
            f"{same}")
        checks["step 1's gradients again: bitwise the same"] = same
        del again
        # the phase's peak is the step's, not the two gradient sets'
        torch.cuda.reset_peak_memory_stats()
    del grads, leaves
    other = 0
    if count is not None:
        # the loop's own peak, held against the count of one step: the
        # state is among the count's arguments, anything else on the card
        # is beside it
        torch.cuda.synchronize()
        other = torch.cuda.memory_allocated() - sum(
            x.numel() * x.element_size() for x in tree_leaves(dict(
                p=state.params, m=state.opt.m, v=state.opt.v,
                step=state.opt.step)))
        torch.cuda.reset_peak_memory_stats()
    stats = TraceStats()
    step = make_train_step(model, opt_cfg, step_cfg)
    counted = counting_call(step, "train_step", stats)
    tracer, registry = Tracer(), MetricsRegistry()
    loop_cfg = loop_mod.LoopConfig(total_steps=c["steps"],
                                   ckpt_every=c["steps"] + 1)
    watch = count is not None and cfg.is_moe
    with flash_shapes() as shapes, (
            moe_drops() if watch else contextlib.nullcontext({})) as routed:
        (state, history, summary), wall, n_syncs, (n_flash, routes,
                                                   windowed) = \
            counted_path(lambda: loop_mod.run(
                counted, state, data, loop_cfg, device="cuda",
                tracer=tracer, metrics_registry=registry))
    peak = torch.cuda.max_memory_allocated()
    walls = [r["wall_s"] for r in history]
    med = float(np.median(walls[1:]))
    model_flop, flop_what = train_model_flop(cfg, state.params, c)
    by_tag = summary["energy_by_tag"]
    for r in history:
        log(f"[{label}] step {r['step']}: loss {r['loss']:.4f}, grad norm "
            f"{r['grad_norm']:.4f}, wall {r['wall_s'] * 1e3:.1f} ms")
    depth = (f"{c['layers']} of {configs.get(c['arch']).num_layers} layers"
             if c["layers"] is not None else f"{cfg.num_layers} layers, "
             "whole")
    log(f"[{label}] {cfg.name} ({depth}, full width): "
        f"{n_params / 1e9:.3f} B params; batch {c['batch']} x {c['seq']} in "
        f"{c['micro']} microbatches; {c['steps']} steps in {wall:.2f} s; "
        f"step wall median of steps 2-{c['steps']} {med * 1e3:.1f} ms "
        f"({tokens / med:.0f} tokens/s); model FLOP {flop_what} "
        f"{model_flop / 1e12:.2f} TFLOP a step (the remat recompute not "
        f"counted): {model_flop / med / 1e12:.1f} TFLOP/s, "
        f"{model_flop / med / PEAK_OPS['bfloat16']:.1%} of 989; "
        f"peak memory {peak / 1e9:.2f} GB"
        + ("" if count is None else
           f" (the loop's; the dry-run's count {count / 1e9:.2f} GB with "
           f"{other / 1e9:.3f} GB of other allocations beside it: "
           f"{peak / (count + other) - 1:+.2%})")
        + f"; modeled energy {summary['energy_j']:.3f} J, "
        f"{summary['j_per_token']:.6f} J/token (H100_SXM power model at "
        f"utilization 1.0 through the probe's 240 W clip); tags {by_tag}; "
        f"host syncs {n_syncs}; train_step_compiles "
        f"{stats.compiles('train_step')}; flash launches {n_flash} by route "
        f"{routes}, windowed {windowed}, by shape (B, H, Hkv, S, T, D, "
        f"causal, window, q_offset) {dict(shapes)}; card: {card}")
    want_flash = train_flash_launches(cfg, model, c["micro"], c["steps"])
    checks |= {
        "every loss and grad norm finite": all(
            np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
            for r in history) and len(history) == c["steps"],
        "step 1: every parameter leaf has a nonzero gradient": grads_ok,
        "train_step_compiles == 1": stats.compiles("train_step") == 1,
        "host syncs == steps": n_syncs == c["steps"],
        "per-tag joules partition the session (1e-6 J)": abs(
            sum(by_tag.values()) - summary["energy_j"]) <= 1e-6,
        f"flash launches == {want_flash} (train_flash_launches: "
        f"{cfg.family}, {c['micro']} microbatches x {c['steps']} steps), "
        f"all wgmma, none windowed": (
            n_flash == want_flash and routes == {"wgmma": n_flash,
                                                 "ffma": 0}
            and windowed == 0),
    }
    if count is not None:
        limit = card_limit(TRAIN_4K["free_share"])
        checks |= {
            f"peak within {DRYRUN['peak_rel']:.0%} of the count": abs(
                count + other - peak) <= DRYRUN["peak_rel"] * peak,
            f"peak under {limit / 1e9:.0f} GB": peak <= limit,
            "flash at exactly the 4096 shapes": dict(shapes)
            == train_4k_shapes(cfg, model, c),
        }
    if watch:
        # every MoE layer routes each microbatch's row as one group, in the
        # forward and again in its remat recompute
        group = (1, c["seq"], moe.capacity_for(cfg, c["seq"]))
        calls = ((cfg.num_layers - cfg.first_k_dense) * c["micro"]
                 * c["steps"] * 2)
        seen = {k: (n, int(d)) for k, (n, d) in routed.items()}
        log(f"[{label}] routing by (groups, tokens, capacity): " + ", ".join(
            f"{k} {n} choices, {d / n:.1%} dropped"
            for k, (n, d) in seen.items()))
        checks[f"routing at exactly {group}, {calls} calls"] = (
            set(seen) == {group} and seen[group][0]
            == calls * c["seq"] * cfg.experts_per_token)
    check_all(label, checks)
    return state, dict(arch=c["arch"], launches=n_flash, step_ms=med * 1e3,
                       peak_gb=peak / 1e9, shapes=dict(shapes)), dict(
        data=data, step=step, step_cfg=step_cfg, opt_cfg=opt_cfg)


def phase_train(card, c, count=None):
    """The port's trainer on the card for one configuration of TRAIN or
    TRAIN_FAMILIES: f32 master parameters made on the card from a seed,
    through ``train_run``'s loop and gates, then a profiled step
    (granite-20b's also in its two halves). A family of
    ``TRAIN_4K["archs"]`` then trains at train_4k's sequence from the same
    masters (its AdamW moments zeroed): ``count``, its dry-run count
    (``count_train_4k``), gated first (``gate_train_4k_fit``), then
    ``train_run`` held to it, and a profiled step for
    ``TRAIN_4K["profiled"]``."""
    import torch
    from repro_torch.data.pipeline import batch_to_device
    from repro_torch.train.optimizer import (adamw_update, init_opt_state,
                                             tree_leaves)
    from repro_torch.train.step import TrainState, make_grad_fn
    label = "train" if c is TRAIN else f"train {c['arch']}"
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = make_model(c["arch"], c["seed"], c["layers"],
                                    dtype=torch.float32)
    box = [TrainState(params, init_opt_state(params))]
    del params
    log(f"[{label}] state (f32 params, m, v) "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
    box[0], out, run = train_run(label, cfg, model, box[0], c, card)
    # a step, and (granite-20b's) its two halves apart: the forward and
    # backward of both microbatches (grad_fn), and the AdamW update on one
    # set of gradients
    batch = batch_to_device(run["data"].batch(c["steps"]), "cuda")

    def one_step():
        box[0], _ = run["step"](box[0], batch)

    if c["profile"]:
        out["profile"] = profile_steps(
            label, {"train step": one_step},
            **({} if c is TRAIN else dict(n=1, warm=False)))["train step"]
    if c is TRAIN:
        grad_fn = make_grad_fn(model, run["step_cfg"])
        _, grads = grad_fn(box[0].params, batch)
        profile_steps("train", {
            "forward and backward (2 microbatches)": lambda: grad_fn(
                box[0].params, batch),
            "AdamW update": lambda: adamw_update(
                run["opt_cfg"], box[0].params, grads, box[0].opt),
        })
        del grads
    del batch, run
    if c["arch"] in TRAIN_4K["archs"]:
        c4 = dict(c, **{k: TRAIN_4K[k] for k in ("batch", "seq", "micro",
                                                 "steps", "lr", "seed")})
        label4 = f"train_4k {c['arch']}"
        peak4 = gate_train_4k_fit(c4, card, count)
        for x in tree_leaves(box[0].opt._asdict()):
            x.zero_()
        box[0], out["train4k"], run = train_run(label4, cfg, model, box[0],
                                                c4, card, peak4)
        if c["arch"] in TRAIN_4K["profiled"]:
            batch = batch_to_device(run["data"].batch(c4["steps"]), "cuda")

            def one_step_4k():
                box[0], _ = run["step"](box[0], batch)

            out["train4k"]["profile"] = profile_steps(
                label4, {"train step": one_step_4k}, n=1,
                warm=False)["train step"]
            del batch
        del run
    del box
    log(f"[{label}] phase in {time.perf_counter() - t_phase:.1f} s")
    return dict(out, shape=(c["batch"] // c["micro"], cfg.num_heads,
                            cfg.num_kv_heads, c["seq"], cfg.head_dim))


# the parallel phase: the train phase's configuration for 3 steps through
# the sharded step at one NCCL rank (bitwise equal to the unsharded step);
# deepseek-moe-16b's MoE layer in f32 at 4 x 256 tokens through expert
# parallelism; the compressed pod reduction over one granite-20b layer's
# gradients, twice (error feedback), timed over 5 calls
PARALLEL = dict(steps=3, moe_x=(4, 256), moe_seed=0, moe_rel_tol=1e-5,
                compress_iters=5)


def _checksums(tree):
    """Per leaf: the f64 sum and a bit-level hash (each element's 32 bits
    as an integer, weighted by its index mod 65521 plus 1, summed in
    int64), in chunks, so two states compare bit for bit by their
    readings alone."""
    import torch
    out = {}
    for name, t in _named(tree):
        flat = t.detach().reshape(-1)
        h = torch.zeros((), dtype=torch.int64, device=t.device)
        for lo in range(0, flat.numel(), 1 << 26):
            c = flat[lo:lo + (1 << 26)]
            w = (torch.arange(lo, lo + c.numel(), device=t.device)
                 % 65521 + 1)
            h += (c.view(torch.int32).to(torch.int64) * w).sum()
        out[name] = (flat.double().sum().item(), h.item())
    return out


def parallel_train(mesh, sharded):
    """The train phase's model from its seed through ``PARALLEL["steps"]``
    steps of train.loop.run, unsharded or through ShardedTrainStep on the
    one-rank mesh; (history, per-leaf checksums of the parameters, flash
    counts, host syncs, the last step's layer-0 gradients)."""
    import torch
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           batch_to_device)
    from repro_torch.models import build_model, common
    from repro_torch.train import loop as loop_mod
    from repro_torch.train.optimizer import (OptConfig, init_opt_state,
                                             tree_map)
    from repro_torch.train.step import (ShardedTrainStep, StepConfig,
                                        TrainState, make_grad_fn,
                                        make_train_step)
    c, steps = TRAIN, PARALLEL["steps"]
    cfg, model, params = make_model(c["arch"], c["seed"], c["layers"],
                                    dtype=torch.float32)
    state = TrainState(params, init_opt_state(params))
    del params
    opt_cfg = OptConfig(lr=c["lr"], warmup_steps=min(20, c["steps"] // 5),
                        total_steps=c["steps"])
    step_cfg = StepConfig(num_microbatches=c["micro"])
    layout = None
    if sharded:
        model = build_model(cfg, mesh)
        layout = ShardedTrainStep(model, opt_cfg, step_cfg, mesh)
        state = layout.layout(state)
        step = layout
    else:
        step = make_train_step(model, opt_cfg, step_cfg)
    data = SyntheticTokens(DataConfig(seed=c["seed"],
                                      vocab_size=cfg.vocab_size,
                                      seq_len=c["seq"],
                                      global_batch=c["batch"]), cfg)
    loop_cfg = loop_mod.LoopConfig(total_steps=steps, ckpt_every=steps + 1)
    (state, history, _), wall, n_syncs, counts = counted_path(
        lambda: loop_mod.run(step, state, data, loop_cfg, device="cuda",
                             layout=layout))
    sums = _checksums(state.params)
    grads = None
    if sharded:
        # a gradient tree at full width for the compression check: the
        # next step's gradients of layer 0
        batch = batch_to_device(data.batch(steps), "cuda")
        _, g = make_grad_fn(model, step_cfg)(state.params, batch)
        grads = tree_map(torch.Tensor.clone, common.layer_of(g["layers"], 0))
        del g
    del state, model, step, layout
    free_card()
    log(f"[parallel] {'sharded' if sharded else 'unsharded'} step, "
        f"{steps} steps in {wall:.2f} s: " + "; ".join(
            f"step {r['step']} loss {r['loss']!r} grad norm "
            f"{r['grad_norm']!r} wall {r['wall_s'] * 1e3:.1f} ms"
            for r in history) + f"; host syncs {n_syncs}; flash {counts}")
    return history, sums, counts, n_syncs, grads


# the parallel phase's tp_layer check: the tensor-parallel algebra of the
# sharded train step at full width on one card (layer 0 of each arch, the
# production mesh's model axis); tolerances stated before the first run.
# bf16: the layer's output rounds to bf16, whose ulp at max|y| is up to
# 2^-7 of it, and the 16 partials are summed in bf16 as the all-reduce sums
# them, each add rounding again: 4e-2 is about 5 ulps of max|y|
TP_LAYER = dict(model=16, seq=4096, seed=0,
                archs=("granite-20b", "qwen3-32b"),
                tol={"float32": 1e-4, "bfloat16": 4e-2})


def tp_layer_sum(cfg, p, x, size):
    """A layer's output from ``size`` model ranks' forwards on their
    blocks of ``p`` (one layer's leaves, full), with the all-reduce over
    the ranks left out: each rank's partial attention output (its query
    heads, the KV heads they read, its rows of wo), summed in ``x``'s
    dtype as the all-reduce sums them, then each rank's partial MLP
    output (its columns of w_gate and w_up, rows of w_down) on the summed
    residual, summed alike."""
    import torch
    from repro_torch.models import common
    from repro_torch.models.transformer import _dense_layer_axes
    from repro_torch.parallel.sharding import (NamedSharding,
                                               TensorParallel, tree_specs)
    from repro_torch.train.optimizer import tree_map

    class Partial(TensorParallel):
        def sum(self, y):
            return y

    sizes = {"model": size}
    specs = tree_specs(sizes, _dense_layer_axes(cfg, ()), p)

    def block(r, part):
        return tree_map(lambda t, s: NamedSharding(sizes, s).block(
            t, {"model": r}), p[part], specs[part])

    positions = torch.arange(x.shape[1], device=x.device)
    xn = common.rms_norm(x, p["norm1"])
    h = None
    for r in range(size):
        y = common.attention(xn, block(r, "attn"), cfg, positions=positions,
                             tp=Partial(None, size, r))[0]
        h = y if h is None else h + y
    x = x + h
    xn = common.rms_norm(x, p["norm2"])
    out = None
    for r in range(size):
        y = common.mlp(xn, block(r, "mlp"), Partial(None, size, r),
                       cfg.d_ff)
        out = y if out is None else out + y
    return x + out


def tp_layer_check(card):
    """tp_layer: for each arch of ``TP_LAYER``, layer 0 at its published
    width (f32 master weights and x from the seed), unsharded
    (``DecoderLM._layer``) and as the sum of ``model`` ranks' partial
    outputs (``tp_layer_sum``), in f32 and in bf16 compute: max|diff| over
    max|y| within the stated tolerance, and the flash launches of each run
    by route and shape. Returns {arch: {dtype: reading}}."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model, common
    from repro_torch.models.transformer import _dense_layer_shapes
    from repro_torch.parallel.sharding import TensorParallel
    c = TP_LAYER
    out = {}
    for arch in c["archs"]:
        cfg = configs.get(arch).adapt_for_mesh(c["model"])
        gen = torch.Generator(device="cuda")
        gen.manual_seed(c["seed"])
        p = common.init_tree(_dense_layer_shapes(cfg, (), cfg.d_ff), gen,
                             "cuda", torch.float32)
        x = torch.randn(1, c["seq"], cfg.d_model, generator=gen,
                        device="cuda")
        positions = torch.arange(c["seq"], device="cuda")
        out[arch] = {}
        for dt in ("float32", "bfloat16"):
            dcfg = cfg.replace(dtype=dt)
            xd = x.to(getattr(torch, dt))
            zero_flash_counts()
            with flash_shapes() as full_shapes:
                want = build_model(dcfg)._layer(xd, p,
                                                positions=positions)[0]
            full = flash_counts()
            zero_flash_counts()
            with flash_shapes() as rank_shapes:
                got = tp_layer_sum(dcfg, p, xd, c["model"])
            ranks = flash_counts()
            torch.cuda.synchronize()
            scale = want.float().abs().max().item()
            rel = (got.float() - want.float()).abs().max().item() / scale
            finite = bool(torch.isfinite(got).all())
            route = "ffma" if dt == "float32" else "wgmma"
            h = cfg.q_heads // c["model"]
            kvh = cfg.num_kv_heads // c["model"]
            if cfg.num_kv_heads % c["model"]:
                sel = common.rank_kv_heads(cfg, TensorParallel(
                    None, c["model"], 0), h)
                kvh = h if isinstance(sel, list) else sel.stop - sel.start
            want_shape = (1, h, kvh, c["seq"], c["seq"], cfg.head_dim, True,
                          None, 0)
            out[arch][dt] = dict(rel=rel, launches=ranks[0],
                                 routes=ranks[1], shapes=rank_shapes)
            log(f"[parallel] tp_layer {arch} layer 0, {dt}, model "
                f"{c['model']}, x [1,{c['seq']},{cfg.d_model}]: summed "
                f"partials vs unsharded max|diff| {rel:.3e} of max|y| "
                f"{scale:.4g} (tol {c['tol'][dt]:g}); flash unsharded "
                f"{full[0]} launch(es) {full[1]} at {sorted(full_shapes)}, "
                f"ranks {ranks[0]} launches {ranks[1]} at "
                f"{sorted(rank_shapes)}; card: {card}")
            check_all("parallel", {
                f"tp_layer {arch} {dt}: summed partials within "
                f"{c['tol'][dt]:g} of max|y|": rel <= c["tol"][dt] and finite,
                f"tp_layer {arch} {dt}: {c['model']} rank launches on "
                f"{route} at q [1,{h},{c['seq']},{cfg.head_dim}] over "
                f"{kvh} KV head(s)": (
                    ranks[0] == c["model"] and ranks[1][route] == ranks[0]
                    and set(rank_shapes) == {want_shape}),
                f"tp_layer {arch} {dt}: one unsharded launch on {route}": (
                    full[0] == 1 and full[1][route] == 1),
            })
            del want, got, xd
        del p, x
        free_card()
    return out


# the parallel phase's tp_serve check: the serve cells' layout (the
# reference dry-run's serve_rules) at full width on one card, layer 0 as
# 16 model ranks; tolerances stated before the first run: f32 1e-4 and
# bf16 4e-2 of max|y| as tp_layer's, the MoE layer routed equal and
# within 1e-5 of max|y| in f32. (a) granite-20b decode (MQA: the cache
# split over sequence, 2048 positions a rank): decode_32k's 8 rank rows
# at positions whose keys lie, for the first three rows, wholly in rank
# 0's block, so that the other 15 blocks hold no valid key for them; the
# ranks run as threads whose collectives meet (ThreadRanks). (b)
# qwen3-32b prefill_32k's rank: 2 rows, 4 query heads a rank over the one
# KV head they read, the cache split over sequence; bf16 at S 32768 (the
# flash shape of the timing row), f32 at S 4096; the ranks one after the
# other, their partial outputs summed as tp_layer sums them. (c)
# deepseek-moe-16b's first MoE layer, 4 experts a rank, summed.
TP_SERVE = dict(model=16, seed=0, tol={"float32": 1e-4, "bfloat16": 4e-2},
                decode_arch="granite-20b", decode_seq=32768,
                decode_pos=(100, 1500, 2046, 5000, 12000, 20000, 30000,
                            32767),
                prefill_arch="qwen3-32b", prefill_rows=2,
                prefill_seq={"bfloat16": 32768, "float32": 4096},
                moe_x=(8, 256), moe_tol=1e-5)


class ThreadRanks:
    """``size`` ranks as threads of this process, for one card: a
    collective waits for every rank's tensor, and each rank computes the
    result from all of them in rank order (every rank holds the same
    bits) before any rank goes on. The ranks' kernels share the default
    stream, so what one rank enqueued before a barrier is done before
    what another enqueues after it. A rank that raises breaks the
    barrier: the others raise too, and none waits past ``timeout`` s."""

    def __init__(self, size, timeout=300.0):
        import threading
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = [None] * size

    def group(self, rank):
        """Rank ``rank``'s group (a ``comm`` stand-in whose collectives
        are these)."""
        import torch
        from repro_torch.parallel import comm
        ranks = self

        class Rank(comm.ShapeGroup):
            def __init__(self):
                self.rank, self.size = rank, ranks.size
                self.axes, self.crosses_pod = ("model",), False

            def _meet(self, t, combine):
                ranks.slots[rank] = t
                ranks.barrier.wait()
                out = combine(list(ranks.slots))
                ranks.barrier.wait()
                return out

            def _fold(self, t, op):
                def fold(parts):
                    acc = parts[0].clone()
                    for x in parts[1:]:
                        acc = op(acc, x)
                    return acc
                return t.copy_(self._meet(t, fold))

            def all_reduce(self, t):
                return self._fold(t, torch.add)

            def all_reduce_max(self, t):
                return self._fold(t, torch.maximum)

            def all_gather(self, x):
                return self._meet(x, lambda parts: torch.cat(parts))

        return Rank()

    def run(self, fn):
        """``fn(rank)`` on every rank's thread; the results in rank
        order."""
        import threading
        out, errs = [None] * self.size, []

        def body(r):
            try:
                out[r] = fn(r)
            except BaseException as e:          # noqa: BLE001 (re-raised)
                errs.append((r, e))
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            first = [e for e in errs if not isinstance(
                e[1], threading.BrokenBarrierError)] or errs
            raise RuntimeError(f"rank {first[0][0]} failed") from first[0][1]
        return out


def _layer_blocks(cfg, p, size, r):
    """Rank ``r`` of ``size`` model ranks' blocks of one dense layer's
    leaves ``p`` (full)."""
    from repro_torch.models.transformer import _dense_layer_axes
    from repro_torch.parallel.sharding import NamedSharding, tree_specs
    from repro_torch.train.optimizer import tree_map
    sizes = {"model": size}
    specs = tree_specs(sizes, _dense_layer_axes(cfg, ()), p)
    return tree_map(lambda t, s: NamedSharding(sizes, s).block(
        t, {"model": r}), p, specs)


def tp_serve_decode(card, dt):
    """tp_serve (a): granite-20b's layer 0 decode step on a cache split
    over sequence, 16 ranks as threads: each rank writes the new token's
    K/V where its block holds the row's position, gathers the query
    heads, attends over its block, the blocks' partial softmaxes combine,
    and wo and the MLP sum over the ranks. Against the unsharded layer:
    y, and every rank's cache block against the unsharded cache's
    slice (bitwise)."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model, common
    from repro_torch.models.transformer import _dense_layer_shapes
    from repro_torch.parallel.sharding import TensorParallel
    c = TP_SERVE
    n = c["model"]
    cfg = configs.get(c["decode_arch"]).adapt_for_mesh(n).replace(dtype=dt)
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    p = common.init_tree(_dense_layer_shapes(cfg, (), cfg.d_ff), gen,
                         "cuda", torch.float32)
    rows, t = len(c["decode_pos"]), c["decode_seq"]
    x = torch.randn(rows, 1, cfg.d_model, generator=gen,
                    device="cuda").to(dtype)
    ck, cv = (torch.randn(rows, t, cfg.num_kv_heads, cfg.head_dim,
                          generator=gen, device="cuda").to(dtype)
              for _ in range(2))
    pos = torch.tensor(c["decode_pos"], device="cuda")
    blk = t // n
    blocks = [(_layer_blocks(cfg, p, n, r),
               ck[:, r * blk:(r + 1) * blk].clone(),
               cv[:, r * blk:(r + 1) * blk].clone()) for r in range(n)]
    want = build_model(cfg)._layer(x, p, positions=pos[:, None],
                                   kv_cache=(ck, cv), cache_pos=pos)[0]
    ranks = ThreadRanks(n)

    def rank(r):
        tp = TensorParallel(ranks.group(r), n, r)
        b, bk, bv = blocks[r]
        h, _ = common.attention(common.rms_norm(x, b["norm1"]), b["attn"],
                                cfg, positions=pos[:, None],
                                kv_cache=(bk, bv), cache_pos=pos, tp=tp,
                                kv_split=tp)
        x1 = x + h
        return x1 + common.mlp(common.rms_norm(x1, b["norm2"]), b["mlp"], tp,
                               cfg.d_ff)

    t0 = time.perf_counter()
    ys = ranks.run(rank)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scale = want.float().abs().max().item()
    rel = (ys[0].float() - want.float()).abs().max().item() / scale
    same = all(torch.equal(y, ys[0]) for y in ys)
    caches = all(torch.equal(bk, ck[:, r * blk:(r + 1) * blk])
                 and torch.equal(bv, cv[:, r * blk:(r + 1) * blk])
                 for r, (_, bk, bv) in enumerate(blocks))
    empty = sum(1 for q in c["decode_pos"] if q < blk)
    tol = c["tol"][dt]
    log(f"[parallel] tp_serve (a) {cfg.name} layer 0 decode, {dt}, model "
        f"{n} as threads: {rows} rows at positions {list(c['decode_pos'])} "
        f"on a {t}-position cache split over sequence ({blk} a rank; "
        f"{empty} rows with no valid key in {n - 1} of the {n} blocks): "
        f"max|diff| {rel:.3e} of max|y| {scale:.4g} (tol {tol:g}); every "
        f"rank's y equal {same}; every rank's cache block equal to the "
        f"unsharded cache's slice {caches}; ranks' wall {wall:.2f} s; "
        f"card: {card}")
    check_all("parallel", {
        f"tp_serve (a) decode {dt}: combined ranks within {tol:g} of "
        f"max|y|": rel <= tol and bool(torch.isfinite(ys[0]).all()),
        f"tp_serve (a) decode {dt}: every rank's y equal": same,
        f"tp_serve (a) decode {dt}: each rank's cache block holds the "
        f"unsharded cache's positions bitwise": caches,
    })
    return rel


def tp_serve_prefill(card, dt):
    """tp_serve (b): qwen3-32b's layer 0 prefill from position 0 into a
    cache split over sequence: each of 16 ranks runs its 4 query heads
    over the one KV head they read on the flash kernel and writes its
    block of the cache; the partial outputs summed (the all-reduce left
    out, as tp_layer). Against the unsharded layer: y, the cache blocks
    (bitwise), the flash launches by route and shape."""
    import torch
    from repro_torch import configs
    from repro_torch.models import build_model, common
    from repro_torch.models.transformer import _dense_layer_shapes
    from repro_torch.parallel.sharding import TensorParallel

    class Partial(TensorParallel):
        def sum(self, y):
            return y

    c = TP_SERVE
    n, b, s = c["model"], c["prefill_rows"], c["prefill_seq"][dt]
    cfg = configs.get(c["prefill_arch"]).adapt_for_mesh(n).replace(dtype=dt)
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    p = common.init_tree(_dense_layer_shapes(cfg, (), cfg.d_ff), gen,
                         "cuda", torch.float32)
    x = torch.randn(b, s, cfg.d_model, generator=gen,
                    device="cuda").to(dtype)
    positions = torch.arange(s, device="cuda")
    kv = (b, s, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (torch.zeros(kv, dtype=dtype, device="cuda") for _ in range(2))
    zero_flash_counts()
    with flash_shapes() as full_shapes:
        want = build_model(cfg)._layer(x, p, positions=positions,
                                       kv_cache=(ck, cv), cache_pos=0)[0]
    full = flash_counts()
    blk = s // n
    zero_flash_counts()
    with flash_shapes() as rank_shapes:
        h = None
        blocks = []
        for r in range(n):
            lb = _layer_blocks(cfg, p, n, r)
            bk, bv = (torch.zeros((b, blk) + kv[2:], dtype=dtype,
                                  device="cuda") for _ in range(2))
            tp = Partial(None, n, r)
            y = common.attention(common.rms_norm(x, lb["norm1"]), lb["attn"],
                                 cfg, positions=positions, kv_cache=(bk, bv),
                                 cache_pos=0, tp=tp, kv_split=tp)[0]
            h = y if h is None else h + y
            blocks.append((lb["mlp"], bk, bv))
        x1 = x + h
        xn = common.rms_norm(x1, p["norm2"])
        out = None
        for r, (mlp, _, _) in enumerate(blocks):
            y = common.mlp(xn, mlp, Partial(None, n, r), cfg.d_ff)
            out = y if out is None else out + y
        got = x1 + out
    ranks = flash_counts()
    torch.cuda.synchronize()
    scale = want.float().abs().max().item()
    rel = (got.float() - want.float()).abs().max().item() / scale
    caches = all(torch.equal(bk, ck[:, r * blk:(r + 1) * blk])
                 and torch.equal(bv, cv[:, r * blk:(r + 1) * blk])
                 for r, (_, bk, bv) in enumerate(blocks))
    route = "ffma" if dt == "float32" else "wgmma"
    h_rank = cfg.q_heads // n
    want_shape = (b, h_rank, 1, s, s, cfg.head_dim, True, None, 0)
    tol = c["tol"][dt]
    log(f"[parallel] tp_serve (b) {cfg.name} layer 0 prefill, {dt}, model "
        f"{n}: x [{b},{s},{cfg.d_model}], the cache split over sequence "
        f"({blk} positions a rank): summed partials vs unsharded max|diff| "
        f"{rel:.3e} of max|y| {scale:.4g} (tol {tol:g}); cache blocks equal "
        f"to the unsharded slices {caches}; flash unsharded {full[0]} "
        f"launch(es) {full[1]} at {sorted(full_shapes)}, ranks {ranks[0]} "
        f"launches {ranks[1]} at {sorted(rank_shapes)}; card: {card}")
    check_all("parallel", {
        f"tp_serve (b) prefill {dt}: summed partials within {tol:g} of "
        f"max|y|": rel <= tol and bool(torch.isfinite(got).all()),
        f"tp_serve (b) prefill {dt}: each rank's cache block holds the "
        f"unsharded cache's positions bitwise": caches,
        f"tp_serve (b) prefill {dt}: {n} rank launches on {route} at q "
        f"[{b},{h_rank},{s},{cfg.head_dim}] over 1 KV head": (
            ranks[0] == n and ranks[1][route] == n
            and set(rank_shapes) == {want_shape}),
        f"tp_serve (b) prefill {dt}: one unsharded launch on {route}": (
            full[0] == 1 and full[1][route] == 1),
    })
    return dict(rel=rel, launches=ranks[0], routes=ranks[1])


def tp_serve_moe(card):
    """tp_serve (c): deepseek-moe-16b's first MoE layer in f32, x from the
    seed, as 16 model ranks of 4 experts each (the router whole, the
    shared experts' columns split), their partial outputs summed, against
    the grouped path over all 64 experts: every call routes alike (ids,
    slots, source tokens, keep equal) and y within the stated tolerance."""
    import torch
    from repro_torch import configs
    from repro_torch.models import common, moe
    from repro_torch.parallel.sharding import (NamedSharding, TensorParallel,
                                               tree_specs)
    from repro_torch.train.optimizer import tree_map

    class Partial(TensorParallel):
        def sum(self, y):
            return y

    c = TP_SERVE
    n = c["model"]
    cfg = configs.get("deepseek-moe-16b").adapt_for_mesh(n)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    p = common.layer_of(common.init_tree(moe.moe_param_shapes(cfg, 1), gen,
                                         "cuda", torch.float32), 0)
    b, s = c["moe_x"]
    x = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda")
    sizes = {"model": n}
    axes = tree_map(lambda a: a[1:], moe.moe_param_axes(cfg))
    specs = tree_specs(sizes, axes, p)
    routed = []
    route = moe.route

    def spy(xg, logits, mcfg, capacity):
        out = route(xg, logits, mcfg, capacity)
        _, ids = moe.top_k(torch.softmax(logits.float(), dim=-1),
                           mcfg.experts_per_token)
        routed.append((ids, out[1][0], out[1][1], out[3]))
        return out

    moe.route = spy
    try:
        want, _ = moe.moe_apply(x, p, cfg)
        got = None
        for r in range(n):
            blocks = tree_map(lambda t, sp: NamedSharding(sizes, sp).block(
                t, {"model": r}), p, specs)
            blocks["router"] = p["router"]          # used whole
            shd = types.SimpleNamespace(mesh=None, local=False,
                                        tp=Partial(None, n, r))
            y, _ = moe.moe_apply(x, blocks, cfg, shd)
            got = y if got is None else got + y
    finally:
        moe.route = route
    torch.cuda.synchronize()
    same = len(routed) == n + 1 and all(
        all(torch.equal(u, v) for u, v in zip(routed[0], rt))
        for rt in routed[1:])
    rel = ((got - want).abs().max() / want.abs().max()).item()
    log(f"[parallel] tp_serve (c) {cfg.name} MoE layer f32, x [{b},{s},"
        f"{cfg.d_model}], {cfg.num_experts // n} experts a rank of {n}: "
        f"routing (ids, slots, tokens, keep) equal on all {len(routed)} "
        f"calls {same}; summed partials vs the grouped path max|diff| "
        f"{rel:.3e} of max|y| (tol {c['moe_tol']:g}); card: {card}")
    check_all("parallel", {
        "tp_serve (c) MoE: every rank routes as the grouped path": same,
        f"tp_serve (c) MoE: summed partials within {c['moe_tol']:g} of "
        f"max|y|": rel <= c["moe_tol"] and bool(torch.isfinite(got).all()),
    })
    return rel


def tp_serve_check(card):
    """tp_serve (a)-(c); returns their readings."""
    out = {"decode": {}, "prefill": {}}
    for dt in ("float32", "bfloat16"):
        out["decode"][dt] = tp_serve_decode(card, dt)
        free_card()
        out["prefill"][dt] = tp_serve_prefill(card, dt)
        free_card()
    out["moe"] = tp_serve_moe(card)
    free_card()
    return out


# the parallel phase's tp_recurrent check: the recurrent families' layout
# (their compute split over model) at full width on one card, layer by
# layer as 16 model ranks against the unsharded layer; tolerances stated
# before the first run: f32 1e-4 and bf16 4e-2 of max|y|, as tp_layer's,
# and the states each rank writes within the same share of their largest
# entry. (a) zamba2-1.2b's Mamba2 layer 0: a decode step of 8 rows and a
# 256-token chunk of one row, each from a random state (4 of 64 heads a
# rank, the w_in product's blocks all-gathered, the conv state gathered,
# out_norm's sums of squares all-reduced, w_out summed); (b) xlstm-1.3b's
# mLSTM layer 0 decode of 8 rows (its 4 heads whole on every rank; the
# row-parallel q, k, v and gates summed) and its first sLSTM layer over a
# 64-token chunk of one row (w_in's (gate, head) blocks all-gathered, the
# FFN split); (c) whisper-small's decoder layer 0 decode of 8 rows on a
# 4096-position self cache split over sequence (12 KV heads do not divide
# 16: every rank runs the 12 heads over its block, the partial softmaxes
# combined; cross attention over 1500 frames whole; the MLP summed), the
# cache blocks bitwise the unsharded cache's slices; (d) zamba2-1.2b's
# shared attention decode at long_500k: bf16 [1, 524288, 32, 64] caches
# (2.1 GB each) split over 16 sequence ranks and combined, against the
# unsplit decode; the ranks of (a)-(d) run as threads whose collectives
# meet (ThreadRanks). (e) zamba2-1.2b's shared attention and MLP prefill
# from position 0 as 16 ranks of 2 heads each, one after the other, their
# partial outputs summed (as tp_layer): at train_4k's rank shape [1, 4096]
# in f32 and bf16 and at prefill_32k's [2, 32768] in bf16, flash launched
# once a rank at q [B,2,S,64] over its 2 KV heads
TP_RECURRENT = dict(model=16, seed=0, tol={"float32": 1e-4, "bfloat16": 4e-2},
                    rows=8, chunk=256, slstm_chunk=64,
                    whisper_seq=4096,
                    whisper_pos=(100, 255, 256, 1000, 2000, 3000, 4000,
                                 4095),
                    long_seq=524288, long_pos=400000,
                    prefill=((1, 4096, ("float32", "bfloat16")),
                             (2, 32768, ("bfloat16",))))


def _rank_leaves(p, axes, size, r, whole=()):
    """Rank ``r`` of ``size`` model ranks' blocks of one layer's leaves
    ``p`` (full), laid out by their logical ``axes`` (no ``layers``
    entry); the leaves named in ``whole`` used whole, as the model's
    ``tp_replicated`` leaves are."""
    from repro_torch.parallel.sharding import NamedSharding, spec_for
    if isinstance(p, dict):
        return {k: p[k] if k in whole else _rank_leaves(p[k], axes[k], size,
                                                        r, whole)
                for k in p}
    sizes = {"model": size}
    spec = spec_for(sizes, axes, tuple(p.shape))
    return NamedSharding(sizes, spec).block(p, {"model": r})


def _unstacked(axes):
    """Logical axes of a stacked layer's leaves without ``layers``."""
    if isinstance(axes, dict):
        return {k: _unstacked(v) for k, v in axes.items()}
    return axes[1:]


def _random_norms(p, gen, names):
    """Fill the zero-initialised leaves ``names`` of ``p`` with N(0, 0.1)
    from ``gen``, so that a wrong block of them shows."""
    for k in names:
        p[k].normal_(0.0, 0.1, generator=gen)


def _on_threads(n, fn):
    """``fn(r, tp)`` for every rank ``r`` of ``n`` as threads
    (``ThreadRanks``), ``tp`` the rank's ``TensorParallel``; (results in
    rank order, wall seconds)."""
    import torch
    from repro_torch.parallel.sharding import TensorParallel
    ranks = ThreadRanks(n)
    t0 = time.perf_counter()
    out = ranks.run(lambda r: fn(r, TensorParallel(ranks.group(r), n, r)))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _rel(got, want) -> float:
    """max|got - want| over max|want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def tp_recurrent_layers(card, dt):
    """tp_recurrent (a)-(c) in ``dt``: each layer's y and states against
    the unsharded layer's. Returns {name: rel of y}."""
    import torch
    from repro_torch import configs
    from repro_torch.models import common, mamba2, whisper, xlstm
    c = TP_RECURRENT
    n, rows, tol = c["model"], c["rows"], c["tol"][dt]
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out, checks = {}, {}

    def hold(name, want, ys, states=()):
        """y against the unsharded one, every rank's y equal, and each
        (got, want) state pair within the tolerance of max|want|."""
        rel = _rel(ys[0], want)
        same = all(torch.equal(y, ys[0]) for y in ys)
        srel = max([_rel(g, w) for g, w in states] or [0.0])
        out[name] = rel
        log(f"[parallel] tp_recurrent {name}, {dt}, model {n}: max|diff| "
            f"{rel:.3e} of max|y| {want.float().abs().max().item():.4g} "
            f"(tol {tol:g}); every rank's y equal {same}; the ranks' "
            f"states against the unsharded ones {srel:.3e} of max; card: "
            f"{card}")
        checks.update({
            f"tp_recurrent {name} {dt}: within {tol:g} of max|y|": (
                rel <= tol and bool(torch.isfinite(ys[0]).all())),
            f"tp_recurrent {name} {dt}: every rank's y equal": same,
            f"tp_recurrent {name} {dt}: states within {tol:g}": srel <= tol,
        })

    # (a) zamba2's Mamba2 layer 0
    cfg = configs.get("zamba2-1.2b").replace(dtype=dt)
    di, ns = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    nh, hd = di // cfg.head_dim, cfg.head_dim
    p = common.layer_of(common.init_tree(mamba2.mamba_shapes(cfg, 1), gen,
                                         "cuda", torch.float32), 0)
    _random_norms(p, gen, ("norm", "out_norm", "a_log", "dt_bias"))
    axes = _unstacked(mamba2.param_axes(cfg)["mamba"])
    hl, cl = nh // n, (di + 2 * ns) // n
    for name, b, t in (("(a) zamba2 mamba decode", rows, 1),
                       ("(a) zamba2 mamba chunk", 1, c["chunk"])):
        x = randn(b, t, cfg.d_model, dtype=dtype)
        S, conv = randn(b, nh, ns, hd), randn(b, 3, di + 2 * ns)
        ws, wc = S.clone(), conv.clone()
        with torch.no_grad():
            want = mamba2.mamba_block(x, p, cfg, (ws, wc))

            def rank(r, tp):
                st = (S[:, r * hl:(r + 1) * hl].clone(),
                      conv[..., r * cl:(r + 1) * cl].clone())
                y = mamba2.mamba_block(
                    x, _rank_leaves(p, axes, n, r, ("conv",)), cfg, st,
                    tp=tp)
                return y, st

            res, _ = _on_threads(n, rank)
        hold(name, want, [y for y, _ in res], [
            (st[i], w[sl]) for r, (_, st) in enumerate(res)
            for i, (w, sl) in enumerate((
                (ws, (slice(None), slice(r * hl, (r + 1) * hl))),
                (wc, (..., slice(r * cl, (r + 1) * cl)))))])
        del S, conv, ws, wc, res
    del p

    # (b) xlstm's mLSTM layer 0 decode and its first sLSTM layer
    cfg = configs.get("xlstm-1.3b").replace(dtype=dt)
    d, nh = cfg.d_model, cfg.num_heads
    di = 2 * d
    p = common.layer_of(common.init_tree(xlstm.mlstm_shapes(cfg, 1), gen,
                                         "cuda", torch.float32), 0)
    _random_norms(p, gen, ("norm", "out_norm", "b_gates"))
    axes = _unstacked(xlstm.param_axes(cfg)["mlstm"])
    cl = di // n
    x = randn(rows, 1, d, dtype=dtype)
    C = randn(rows, nh, di // nh, di // nh)
    nn_, conv = randn(rows, nh, di // nh), randn(rows, 3, di)
    wst = (C.clone(), nn_.clone(), conv.clone())
    with torch.no_grad():
        want = xlstm.mlstm_block(x, p, cfg, wst)

        def rank(r, tp):
            st = (C.clone(), nn_.clone(),
                  conv[..., r * cl:(r + 1) * cl].clone())
            return xlstm.mlstm_block(x, _rank_leaves(p, axes, n, r), cfg,
                                     st, tp=tp), st

        res, _ = _on_threads(n, rank)
    hold("(b) xlstm mLSTM decode", want, [y for y, _ in res], [
        pair for r, (_, st) in enumerate(res) for pair in (
            (st[0], wst[0]), (st[1], wst[1]),
            (st[2], wst[2][..., r * cl:(r + 1) * cl]))])
    del C, nn_, conv, wst, res, p
    p = common.init_tree(xlstm.slstm_shapes(cfg), gen, "cuda", torch.float32)
    _random_norms(p, gen, ("norm", "out_norm", "b"))
    axes = xlstm.param_axes(cfg)["slstm_0"]
    x = randn(1, c["slstm_chunk"], d, dtype=dtype)
    sd = d // nh
    st0 = (randn(1, nh, sd), randn(1, nh, sd).abs() + 1.0, randn(1, nh, sd),
           0.1 * randn(1, nh, sd))
    wst = tuple(s.clone() for s in st0)
    with torch.no_grad():
        want = xlstm.slstm_block(x, p, cfg, wst)

        def rank(r, tp):
            st = tuple(s.clone() for s in st0)
            return xlstm.slstm_block(x, _rank_leaves(p, axes, n, r, ("r",)),
                                     cfg, st, tp), st

        res, _ = _on_threads(n, rank)
    hold("(b) xlstm sLSTM chunk", want, [y for y, _ in res],
         [pair for _, st in res for pair in zip(st, wst)])
    del p, res, wst, st0

    # (c) whisper's decoder layer 0 decode on a sequence-split self cache
    cfg = configs.get("whisper-small").replace(dtype=dt)
    model = whisper.Whisper(cfg)
    full = common.init_tree(whisper.param_shapes(cfg)["decoder"], gen,
                            "cuda", torch.float32)
    p = common.layer_of(full, 0)
    del full
    _random_norms(p, gen, ("norm1", "norm_x", "norm2"))
    axes = _unstacked(whisper.param_axes(cfg)["decoder"])
    t = c["whisper_seq"]
    blk = t // n
    x = randn(rows, 1, cfg.d_model, dtype=dtype)
    xk, xv = (randn(rows, cfg.enc_seq, cfg.q_heads, cfg.head_dim,
                    dtype=dtype) for _ in range(2))
    ck, cv = (randn(rows, t, cfg.num_kv_heads, cfg.head_dim, dtype=dtype)
              for _ in range(2))
    pos = torch.tensor(c["whisper_pos"], device="cuda")
    blocks = [(ck[:, r * blk:(r + 1) * blk].clone(),
               cv[:, r * blk:(r + 1) * blk].clone()) for r in range(n)]
    with torch.no_grad():
        want = model._dec_layer(x, p, xk, xv, pos[:, None], (ck, cv), pos)

        def rank(r, tp):
            return model._dec_layer(x, _rank_leaves(p, axes, n, r), xk, xv,
                                    pos[:, None], blocks[r], pos,
                                    kv_split=tp, tp=tp)

        ys, _ = _on_threads(n, rank)
    caches = all(torch.equal(bk, ck[:, r * blk:(r + 1) * blk])
                 and torch.equal(bv, cv[:, r * blk:(r + 1) * blk])
                 for r, (bk, bv) in enumerate(blocks))
    hold("(c) whisper decoder decode", want, ys)
    checks[f"tp_recurrent (c) whisper {dt}: each rank's cache block holds "
           f"the unsharded cache's positions bitwise"] = caches
    check_all("parallel", checks)
    return out


def tp_recurrent_long(card):
    """tp_recurrent (d): zamba2-1.2b's shared attention decode at
    long_500k in bf16, the caches split over 16 sequence ranks."""
    import torch
    from repro_torch import configs
    from repro_torch.models import common
    c = TP_RECURRENT
    n, t, q = c["model"], c["long_seq"], c["long_pos"]
    cfg = configs.get("zamba2-1.2b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    p = common.init_tree(common.attn_shapes(cfg), gen, "cuda", torch.float32)
    x = torch.randn(1, 1, cfg.d_model, generator=gen,
                    device="cuda").to(torch.bfloat16)
    ck, cv = (torch.randn(1, t, cfg.num_kv_heads, cfg.head_dim,
                          generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    blk = t // n
    blocks = [(ck[:, r * blk:(r + 1) * blk].clone(),
               cv[:, r * blk:(r + 1) * blk].clone()) for r in range(n)]
    positions = torch.full((1,), q, device="cuda")
    with torch.no_grad():
        want = common.attention(x, p, cfg, positions=positions,
                                kv_cache=(ck, cv), cache_pos=q)[0]
        ys, wall = _on_threads(n, lambda r, tp: common.attention(
            x, p, cfg, positions=positions, kv_cache=blocks[r],
            cache_pos=q, kv_split=tp)[0])
    rel = _rel(ys[0], want)
    same = all(torch.equal(y, ys[0]) for y in ys)
    caches = all(torch.equal(bk, ck[:, r * blk:(r + 1) * blk])
                 and torch.equal(bv, cv[:, r * blk:(r + 1) * blk])
                 for r, (bk, bv) in enumerate(blocks))
    tol = c["tol"]["bfloat16"]
    log(f"[parallel] tp_recurrent (d) {cfg.name} shared attention decode at "
        f"long_500k, bf16: caches [1,{t},{cfg.num_kv_heads},"
        f"{cfg.head_dim}] ({2 * ck.nbytes / 1e9:.2f} GB a site) split over "
        f"{n} sequence ranks of {blk} positions, the token at {q}: combined "
        f"vs unsplit max|diff| {rel:.3e} of max|y| (tol {tol:g}); every "
        f"rank's y equal {same}; cache blocks equal to the unsplit slices "
        f"{caches}; ranks' wall {wall:.2f} s; card: {card}")
    check_all("parallel", {
        f"tp_recurrent (d) long_500k decode: within {tol:g} of max|y|": (
            rel <= tol and bool(torch.isfinite(ys[0]).all())),
        "tp_recurrent (d) long_500k decode: every rank's y equal": same,
        "tp_recurrent (d) long_500k decode: the cache blocks hold the "
        "unsplit cache's positions bitwise": caches,
    })
    return rel


def tp_recurrent_prefill(card, b, s, dt):
    """tp_recurrent (e): zamba2-1.2b's shared attention and MLP prefill
    from position 0 as 16 ranks of 2 heads each, the partial outputs
    summed, against the unsharded block; the rank's KV cache blocks
    against the unsharded cache's head slices, flash launched once a rank
    at q [b,2,s,64] over 2 KV heads."""
    import torch
    from repro_torch import configs
    from repro_torch.models import common, mamba2
    from repro_torch.parallel.sharding import TensorParallel

    class Partial(TensorParallel):
        def sum(self, y):
            return y

    c = TP_RECURRENT
    n = c["model"]
    cfg = configs.get("zamba2-1.2b").replace(dtype=dt)
    dtype = getattr(torch, dt)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(c["seed"])
    p = common.init_tree(mamba2.param_shapes(cfg)["shared_attn"], gen,
                         "cuda", torch.float32)
    _random_norms(p, gen, ("norm1", "norm2"))
    axes = mamba2.param_axes(cfg)["shared_attn"]
    x = torch.randn(b, s, cfg.d_model, generator=gen, device="cuda").to(dtype)
    positions = torch.arange(s, device="cuda")
    kv = (b, s, cfg.num_kv_heads, cfg.head_dim)
    ck, cv = (torch.zeros(kv, dtype=dtype, device="cuda") for _ in range(2))
    model = mamba2.Zamba2(cfg)
    zero_flash_counts()
    with torch.no_grad(), flash_shapes() as full_shapes:
        want = model._shared_attn(x, p, positions, (ck, cv), 0)
    full = flash_counts()
    hl = cfg.num_kv_heads // n
    zero_flash_counts()
    blocks = [_rank_leaves(p, axes, n, r) for r in range(n)]
    caches = [tuple(torch.zeros((b, s, hl, cfg.head_dim), dtype=dtype,
                                device="cuda") for _ in range(2))
              for _ in range(n)]
    with torch.no_grad(), flash_shapes() as rank_shapes:
        h = sum(common.attention(
            common.rms_norm(x, blocks[r]["norm1"]), blocks[r]["attn"], cfg,
            positions=positions, kv_cache=caches[r], cache_pos=0,
            tp=Partial(None, n, r))[0] for r in range(n))
        x1 = x + h
        xn = common.rms_norm(x1, p["norm2"])
        got = x1 + sum(common.mlp(xn, blocks[r]["mlp"], Partial(None, n, r),
                                  cfg.d_ff) for r in range(n))
    ranks = flash_counts()
    torch.cuda.synchronize()
    rel = _rel(got, want)
    # the rank's k and v come from a product over its columns of wk and
    # wv: another GEMM shape, so held at the tolerance, not bitwise
    cache_rel = max(max(_rel(bk, ck[:, :, r * hl:(r + 1) * hl]),
                        _rel(bv, cv[:, :, r * hl:(r + 1) * hl]))
                    for r, (bk, bv) in enumerate(caches))
    route = "ffma" if dt == "float32" else "wgmma"
    want_shape = (b, hl, hl, s, s, cfg.head_dim, True, None, 0)
    tol = c["tol"][dt]
    log(f"[parallel] tp_recurrent (e) {cfg.name} shared attention + MLP "
        f"prefill, {dt}, model {n}: x [{b},{s},{cfg.d_model}], {hl} of "
        f"{cfg.num_heads} heads a rank: summed partials vs unsharded "
        f"max|diff| {rel:.3e} of max|y| (tol {tol:g}); the ranks' cache "
        f"blocks against the unsharded heads {cache_rel:.3e} of max; flash "
        f"unsharded "
        f"{full[0]} launch(es) {full[1]} at {sorted(full_shapes)}, ranks "
        f"{ranks[0]} launches {ranks[1]} at {sorted(rank_shapes)}; card: "
        f"{card}")
    check_all("parallel", {
        f"tp_recurrent (e) prefill [{b},{s}] {dt}: summed partials within "
        f"{tol:g} of max|y|": rel <= tol and bool(torch.isfinite(got).all()),
        f"tp_recurrent (e) prefill [{b},{s}] {dt}: the cache blocks within "
        f"{tol:g} of the unsharded cache's heads": cache_rel <= tol,
        f"tp_recurrent (e) prefill [{b},{s}] {dt}: {n} rank launches on "
        f"{route} at q [{b},{hl},{s},{cfg.head_dim}]": (
            ranks[0] == n and ranks[1][route] == n
            and set(rank_shapes) == {want_shape}),
        f"tp_recurrent (e) prefill [{b},{s}] {dt}: one unsharded launch on "
        f"{route}": full[0] == 1 and full[1][route] == 1,
    })
    return dict(rel=rel, launches=ranks[0], routes=ranks[1])


def tp_recurrent_check(card):
    """tp_recurrent (a)-(e); returns their readings and wall seconds."""
    t0 = time.perf_counter()
    out = {"layers": {}, "prefill": {}}
    for dt in ("float32", "bfloat16"):
        out["layers"][dt] = tp_recurrent_layers(card, dt)
        free_card()
    out["long"] = tp_recurrent_long(card)
    free_card()
    for b, s, dts in TP_RECURRENT["prefill"]:
        for dt in dts:
            out["prefill"][(b, s, dt)] = tp_recurrent_prefill(card, b, s, dt)
            free_card()
    out["seconds"] = time.perf_counter() - t0
    return out


def phase_parallel(card):
    """The port's parallel layer on the card at one NCCL rank (the
    process group on a file:// store under build/, a mixed cuda:nccl /
    cpu:gloo backend so the host side of (c) runs too), with
    make_host_mesh(1, 1, 1, "cuda"):

    (a) the train phase's configuration (granite-20b at full width, 4 of
        52 layers, batch 8 x 512 in 2 microbatches, seed 0) for 3 steps,
        unsharded and then rebuilt from the seed through ShardedTrainStep:
        losses, grad norms and every parameter's checksums equal bit for
        bit (one rank: every collective is the identity), the sharded
        run's flash launches counted (zeroed just before, read just after:
        layers x microbatches x steps x 2, all wgmma);
    (b) deepseek-moe-16b's MoE layer at full width in f32 (weights and x
        [4, 256, 2048] from a seed) through moe_apply_shard_map and
        moe_apply on the same mesh: the two paths' groupings route alike
        (ids, slots, keep equal) and y within 1e-5 of max|y|;
    (c) compress_grads_over_pod on layer 0's gradients from (a)'s
        sharded state, twice (error feedback), on the card and on the
        host: outputs and error states equal bit for bit; timed with
        events (GB/s of f32 gradient reduced) beside compression_ratio;
    (d) tp_layer (``tp_layer_check``): the tensor-parallel algebra at full
        width, summed partial outputs of 16 model ranks against the
        unsharded layer;
    (e) tp_serve (``tp_serve_check``): the serve cells' layout at full
        width, 16 model ranks of layer 0 combined or summed against the
        unsharded layer (``TP_SERVE``);
    (f) tp_recurrent (``tp_recurrent_check``): the recurrent families'
        layout at full width, 16 model ranks of a layer against the
        unsharded layer, and zamba2's long_500k decode on a cache split
        over 16 sequence ranks (``TP_RECURRENT``).
    """
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common, moe
    from repro_torch.parallel import compress
    from repro_torch.parallel.sharding import Sharder
    from repro_torch.train.optimizer import tree_map
    t_phase = time.perf_counter()
    store = ROOT / "build" / "parallel_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    if store.exists():
        store.unlink()
    torch.cuda.set_device(0)
    dist.init_process_group("cpu:gloo,cuda:nccl",
                            init_method=f"file://{store}", rank=0,
                            world_size=1)
    mesh = make_host_mesh(1, 1, 1, "cuda")
    c = TRAIN

    # (a) the sharded train step against the unsharded one
    plain, plain_sums, _, _, _ = parallel_train(mesh, sharded=False)
    shard, shard_sums, counts, n_syncs, grads = parallel_train(
        mesh, sharded=True)
    n_flash, routes, windowed = counts
    want_flash = c["layers"] * c["micro"] * PARALLEL["steps"] * 2
    differ = [n for n in plain_sums if plain_sums[n] != shard_sums[n]]
    walls = [(a["wall_s"], b["wall_s"]) for a, b in zip(plain, shard)]
    log(f"[parallel] train: step walls unsharded / sharded (ms): "
        + ", ".join(f"{a * 1e3:.1f} / {b * 1e3:.1f}" for a, b in walls)
        + f"; leaves whose checksums differ: {differ}; card: {card}")
    check_all("parallel", {
        "sharded losses equal the unsharded ones bitwise": [
            r["loss"] for r in plain] == [r["loss"] for r in shard],
        "sharded grad norms equal the unsharded ones bitwise": [
            r["grad_norm"] for r in plain] == [r["grad_norm"] for r in shard],
        "every parameter's f64 sum and bit hash equal": not differ,
        "sharded flash launches == layers x microbatches x steps x 2, all "
        "wgmma": (n_flash == want_flash and routes == {
            "wgmma": n_flash, "ffma": 0} and windowed == 0),
        "host syncs == steps": n_syncs == PARALLEL["steps"],
    })

    # (b) expert parallelism against the grouped path on the same mesh
    mcfg = configs.get("deepseek-moe-16b")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PARALLEL["moe_seed"])
    p = common.layer_of(common.init_tree(moe.moe_param_shapes(mcfg, 1), gen,
                                         "cuda", torch.float32), 0)
    b, s = PARALLEL["moe_x"]
    x = torch.randn(b, s, mcfg.d_model, generator=gen, device="cuda")
    shd = Sharder(mesh)
    groups = moe._n_groups(b, shd, 0)
    tg = b * s // groups
    t_rank = b * s // mesh.shape[2]
    routed = {}
    for name, xs, cap in (
            ("grouped", x.reshape(groups, tg, -1), moe.capacity_for(mcfg, tg)),
            ("expert-parallel", x.reshape(1, t_rank, -1),
             moe.capacity_for(mcfg, t_rank))):
        logits = xs @ p["router"]
        _, ids = moe.top_k(torch.softmax(logits, dim=-1),
                           mcfg.experts_per_token)
        _, (slot, _, _), _, keep, _ = moe.route(xs, logits, mcfg, cap)
        routed[name] = (ids.reshape(-1).cpu(), slot.reshape(-1).cpu(),
                        keep.reshape(-1).cpu(), cap)
    ms = {}
    out = {}
    for name, impl in (("grouped", "gspmd"), ("expert-parallel",
                                              "shard_map")):
        fn = (lambda impl=impl: moe.moe_apply(x, p, mcfg, shd, impl=impl))
        out[name] = fn()
        ms[name] = cuda_timed(fn, iters=5, warmup=1)
    (yg, auxg), (ye, auxe) = out["grouped"], out["expert-parallel"]
    rel = ((ye - yg).abs().max() / yg.abs().max()).item()
    same = all(torch.equal(u, v) for u, v in zip(routed["grouped"][:3],
                                                  routed["expert-parallel"][:3]))
    n_drop = int((~routed["grouped"][2]).sum())
    log(f"[parallel] moe: {mcfg.name} MoE layer f32, x [{b},{s},"
        f"{mcfg.d_model}]: grouped {groups} group(s) of {tg} tokens, "
        f"capacity {routed['grouped'][3]}; expert-parallel {t_rank} tokens "
        f"a rank, capacity {routed['expert-parallel'][3]}; {n_drop} of "
        f"{routed['grouped'][2].numel()} choices dropped; ids, slots, keep "
        f"equal {same}; max|y_ep - y| {rel:.3e} of max|y|; aux "
        f"{auxg.item()!r} / {auxe.item()!r}; ms grouped "
        f"{ms['grouped']:.3f}, expert-parallel {ms['expert-parallel']:.3f}")
    check_all("parallel", {
        "EP routing (ids, slots, keep) equals the grouped path's": same,
        f"EP y within {PARALLEL['moe_rel_tol']:g} of max|y|": (
            rel <= PARALLEL["moe_rel_tol"] and bool(torch.isfinite(ye).all())),
    })
    del p, x, out, yg, ye

    # (c) the compressed pod reduction, on the card and on the host
    n = sum(g.numel() for g in _leaves(grads))
    host_grads = tree_map(torch.Tensor.cpu, grads)
    sides = {}
    for side, g in (("card", grads), ("host", host_grads)):
        red1, err1 = compress.compress_grads_over_pod(g, mesh)
        red2, err2 = compress.compress_grads_over_pod(g, mesh, err1)
        sides[side] = [dict(_named(tree_map(torch.Tensor.cpu, t)))
                       for t in (red1, err1, red2, err2)]
        del red1, err1, red2, err2
    bitwise = all(torch.equal(sides["card"][i][k], sides["host"][i][k])
                  for i in range(4) for k in sides["host"][i])
    err_ms = cuda_timed(lambda: compress.compress_grads_over_pod(grads, mesh),
                        iters=PARALLEL["compress_iters"], warmup=1)
    gbs = n * 4 / (err_ms / 1e3) / 1e9
    ratio = compress.compression_ratio(n)
    log(f"[parallel] compress: granite-20b layer 0's gradients, {n} f32 "
        f"elements ({n * 4 / 1e9:.3f} GB) in {len(sides['host'][0])} "
        f"leaves: card and "
        f"host outputs and error states (two calls) equal bitwise "
        f"{bitwise}; compress_grads_over_pod {err_ms:.3f} ms a call by "
        f"events ({gbs:.1f} GB/s of f32 gradient); compression_ratio "
        f"{ratio:.4f}; card: {card}")
    check_all("parallel", {
        "compressed reduction: card equals host bitwise": bitwise,
    })
    del grads, host_grads, sides
    dist.destroy_process_group()
    free_card()

    # (d) the tensor-parallel algebra at full width
    tp = tp_layer_check(card)
    # (e) the serve cells' layout at full width
    t_serve = time.perf_counter()
    tp_serve = tp_serve_check(card)
    t_serve = time.perf_counter() - t_serve
    # (f) the recurrent families' layout at full width
    tp_rec = tp_recurrent_check(card)
    wall = time.perf_counter() - t_phase
    log(f"[parallel] tp_serve in {t_serve:.1f} s, tp_recurrent in "
        f"{tp_rec['seconds']:.1f} s; phase in {wall:.1f} s")
    return dict(compress_ms=err_ms, compress_gbs=gbs, ratio=ratio,
                moe_ms=ms, walls=walls, seconds=wall, tp=tp,
                tp_serve=tp_serve, tp_recurrent=tp_rec)


# the dryrun phase: the port's dry-run (launch.dryrun: one rank's step on
# the meta device, counted by perf.op_cost) held against the card. (a) the
# train phase's configuration sized on a one-device mesh and then run for
# one step on the card under the same counter: FLOPs equal, flash launched
# as often as the train phase's step launches it, the peak within
# ``peak_rel`` of max_memory_allocated; (b) granite-20b's decode_step at
# full width and depth on a contiguous cache, counted on meta and on the
# card (in the serve phase, before granite is freed): FLOPs equal; (c) the
# depth cuts of PERF.md §4 against 80 GB; (d) one production cell of each
# family on the single mesh (every cell completes: the whole grid takes
# longer than the phase's budget, and runs device-free with the CLI); (e)
# the cross-run gate on the card's own rows (after record_cli)
ONE_DEVICE = {"data": 1, "model": 1}
DRYRUN = dict(
    decode_batch=4, decode_seq=512, peak_rel=0.10, budget_s=120.0,
    # (arch, layers (None: full depth), cell, want fits)
    cuts=(("granite-20b", None, "train_phase", False),
          ("granite-20b", 4, "train_phase", True),
          ("internvl2-76b", None, "vlm_phase", False),
          ("internvl2-76b", 32, "vlm_phase", True),
          ("deepseek-moe-16b", None, "serve_phase", True),
          # the train phase's other families (TRAIN_FAMILIES), whole and
          # at their cuts: xlstm-1.3b's whole count fits, so it trains
          # whole; internvl2-76b's 2 layers do not
          ("zamba2-1.2b", None, "train_phase", True),
          ("whisper-small", None, "whisper_train", True),
          ("xlstm-1.3b", None, "train_phase", True),
          ("deepseek-moe-16b", None, "train_phase", False),
          ("deepseek-moe-16b", 4, "train_phase", True),
          ("internvl2-76b", None, "vlm_train", False),
          ("internvl2-76b", 2, "vlm_train", False),
          ("internvl2-76b", 1, "vlm_train", True),
          # the dense phase serves these two whole; serve_long's decode
          # step at batch 4 x 32768 fits for its three models, and
          # qwen3-32b's one-row 32768-token prefill does not
          ("qwen3-32b", None, "serve_phase", True),
          ("deepseek-coder-33b", None, "serve_phase", True),
          ("granite-20b", None, "long_decode", True),
          ("gemma3-27b", None, "long_decode", True),
          ("zamba2-1.2b", None, "long_decode", True),
          ("qwen3-32b", None, "long_prefill", False)),
    # one production cell of each family (the dense one also trains)
    cells=(("granite-20b", "train_4k"), ("granite-20b", "prefill_32k"),
           ("granite-20b", "decode_32k"), ("deepseek-moe-16b", "decode_32k"),
           ("internvl2-76b", "prefill_32k"), ("xlstm-1.3b", "long_500k"),
           ("zamba2-1.2b", "decode_32k"), ("whisper-small", "decode_32k")),
    # the cells that must fit 80 GB a rank with useful >= min_useful: the
    # sharded step's per-layer gathers, reduce-scatter and tensor
    # parallelism
    fit=(("granite-20b", "train_4k"),), min_useful=0.5,
    # the serve cells that must fit 80 GB a rank: the sharded serve step
    # (per-layer gathers, compute over model, caches split over sequence
    # for granite's MQA, over KV heads for deepseek-moe's 16)
    serve_fit=(("granite-20b", "prefill_32k"), ("granite-20b", "decode_32k"),
               ("deepseek-moe-16b", "decode_32k")))


def phase_cells():
    """The card phases' shapes as dry-run cells: the train phase (batch 8
    x 512; whisper-small's 8 x 448 over its frames, internvl2-76b's 4 x
    256 after its 256 patches; train_4k's runs, 2 x 4096), the VLM
    phase's forward (256 patches + 256
    tokens), the serve phase (batch 4, 512 positions), and serve_long's
    decode step (batch 4 over 32768 positions) and one-row 32768-token
    prefill."""
    from repro_torch.configs.base import ShapeConfig
    fam = {c["arch"]: c for c in TRAIN_FAMILIES}
    return {
        "train_phase": ShapeConfig("train_phase", "train", TRAIN["seq"],
                                   TRAIN["batch"]),
        "whisper_train": ShapeConfig(
            "whisper_train", "train", fam["whisper-small"]["seq"],
            fam["whisper-small"]["batch"]),
        "vlm_train": ShapeConfig(
            "vlm_train", "train", fam["internvl2-76b"]["seq"],
            fam["internvl2-76b"]["batch"]),
        "train_4k_card": ShapeConfig("train_4k_card", "train",
                                     TRAIN_4K["seq"], TRAIN_4K["batch"]),
        "vlm_phase": ShapeConfig("vlm_phase", "prefill", 256, 1),
        "serve_phase": ShapeConfig("serve_phase", "prefill",
                                   SERVE["max_seq"], SERVE["batch"]),
        "long_decode": ShapeConfig("long_decode", "decode",
                                   SERVE_LONG["max_seq"],
                                   SERVE_LONG["batch"]),
        "long_prefill": ShapeConfig("long_prefill", "prefill",
                                    SERVE_LONG["max_seq"], 1),
    }


def dryrun_decode(model, params, card, seq, batch, busy=None):
    """(b): a served model's decode_step (full width and depth, bf16
    weights ``params`` already on the card) on a contiguous cache of
    ``batch`` x ``seq`` at position ``seq - 1`` (granite-20b at the serve
    phase's 4 x 512 and serve_long's 4 x 32768, deepseek-moe-16b at
    serve_long's batch x 32768): its FLOPs counted once on the meta device by
    the dry-run (``dryrun.engine_decode_count``: the model as the engine
    runs it, with no mesh) and once on the card by the same counter must
    be equal, and so must the decode cell's on a one-device mesh
    (``analyze_cell``) but for an MoE model's (on a mesh it routes one
    group of all rows, the engine a group a row: a batch of b makes b
    times the expert products); the dry-run's peak, with the card's
    other allocations beside it, within ``peak_rel`` of
    max_memory_allocated for the step. The cell's memory term is printed
    beside ``busy``, the profile phase's device-busy time of a decode
    step (the paged pool's, at batch 4), where given."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.perf import op_cost
    t0 = time.perf_counter()
    rec, cell = dryrun.analyze_cell(
        model.cfg.name, ShapeConfig(f"decode_{batch}x{seq}", "decode", seq,
                                    batch), ONE_DEVICE)
    meta = dryrun.engine_decode_count(model.cfg, batch=batch, max_seq=seq)
    meta_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - sum(
        p.numel() * p.element_size() for p in _leaves(params))
    cache = model.init_cache(batch, seq, device="cuda")
    tok = torch.zeros((batch, 1), dtype=torch.int32, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad(), op_cost.OpCounter() as on_card:
        logits, _ = model.decode_step(params, tok, seq - 1, cache)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(logits).all())
    del cache, logits
    rl = rec["roofline"]
    dry_peak = meta.peak_bytes
    log(f"[dryrun] (b) {model.cfg.name} decode_step, batch {batch} x {seq} "
        f"at position {seq - 1}: FLOPs meta {meta.flops:.6e} card "
        f"{on_card.flops:.6e}, the one-device cell {cell.flops:.6e}; "
        f"bytes meta {meta.bytes:.6e} card "
        f"{on_card.bytes:.6e}; compute term {rl['compute_s'] * 1e3:.3f} ms, "
        f"memory term {rl['memory_s'] * 1e3:.3f} ms (bytes / 3.35 TB/s)"
        + (f" beside the profile phase's decode step device-busy "
           f"{busy:.3f} ms" if busy is not None else "")
        + f"; dry-run peak {dry_peak / 1e9:.3f} GB (the cell's "
        f"{rec['analysis']['peak_bytes'] / 1e9:.3f}), fits {rec['fits']}, "
        f"card max_memory_allocated {peak / 1e9:.3f} GB "
        f"({(dry_peak + other) / peak - 1:+.2%} with {other / 1e9:.3f} GB "
        f"of other allocations); meta count in {meta_s:.1f} s; card: {card}")
    check_all("dryrun", {
        f"(b) decode {batch} x {seq}: FLOPs on meta == FLOPs on the card": (
            meta.flops == on_card.flops > 0),
        f"(b) decode {batch} x {seq}: the one-device cell's FLOPs == the "
        f"engine's" + (" (but an MoE's routing: fewer)" if model.cfg.is_moe
                       else ""): (cell.flops < meta.flops if model.cfg.is_moe
                                  and batch > 1 else
                                  cell.flops == meta.flops),
        f"(b) decode {batch} x {seq}: dry-run peak (with the other "
        f"allocations) within {DRYRUN['peak_rel']:.0%} of "
        f"max_memory_allocated": abs(dry_peak + other - peak)
        <= DRYRUN["peak_rel"] * peak,
        f"(b) decode {batch} x {seq}: logits finite": finite,
    })
    return dict(flops=meta.flops, memory_ms=rl["memory_s"] * 1e3,
                compute_ms=rl["compute_s"] * 1e3, busy_ms=busy,
                seconds=meta_s, peak=peak, dry_peak=dry_peak + other)


def dryrun_train(card, train):
    """(a): the train phase's configuration (granite-20b at full width, 4
    of 52 layers, batch 8 x 512 in 2 microbatches) through
    ShardedTrainStep on a one-device RankMesh: counted on the meta device
    by the dry-run, then one step on the card under the same counter
    (f32 master weights from the train phase's seed). FLOPs equal exactly,
    the counted step's flash launches equal the train phase's per step
    (layers x microbatches x 2, all wgmma), and the dry-run's peak within
    ``peak_rel`` of max_memory_allocated for that step."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           batch_to_device)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import RankMesh
    from repro_torch.models import build_model
    from repro_torch.perf import op_cost
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.step import (ShardedTrainStep, StepConfig,
                                        TrainState)
    c = TRAIN
    cfg = configs.get(c["arch"]).replace(num_layers=c["layers"])
    t0 = time.perf_counter()
    rec, meta = dryrun.analyze_cell(c["arch"], phase_cells()["train_phase"],
                                    ONE_DEVICE, {"n_micro": c["micro"]}, cfg)
    meta_s = time.perf_counter() - t0
    other = torch.cuda.memory_allocated()
    _, _, params = make_model(c["arch"], c["seed"], c["layers"],
                              dtype=torch.float32)
    mesh = RankMesh(ONE_DEVICE)
    step = ShardedTrainStep(build_model(cfg, mesh),
                            OptConfig(lr=c["lr"], total_steps=c["steps"]),
                            StepConfig(num_microbatches=c["micro"]), mesh)
    state = step.layout(TrainState(params, init_opt_state(params)))
    del params
    data = SyntheticTokens(DataConfig(seed=c["seed"],
                                      vocab_size=cfg.vocab_size,
                                      seq_len=c["seq"],
                                      global_batch=c["batch"]), cfg)
    batch = batch_to_device(data.batch(0), "cuda")
    torch.cuda.synchronize()
    zero_flash_counts()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    with op_cost.OpCounter() as on_card:
        state, metrics = step(state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    n_flash, routes, windowed = flash_counts()
    loss = metrics["loss"].item()
    del state, step, batch, metrics
    free_card()
    rl = rec["roofline"]
    dry_peak = rec["analysis"]["peak_bytes"]
    want_flash = c["layers"] * c["micro"] * 2
    model_flop = 6 * rec["n_params"] * c["batch"] * c["seq"]
    log(f"[dryrun] (a) {cfg.name} train step ({c['layers']} of "
        f"{configs.get(c['arch']).num_layers} layers, batch {c['batch']} x "
        f"{c['seq']} in {c['micro']} microbatches) on a one-device "
        f"RankMesh: FLOPs meta {meta.flops:.6e} card {on_card.flops:.6e} "
        f"({meta.flops / model_flop:.3f}x the model FLOPs 6·N·tokens "
        f"{model_flop:.4e}); bytes meta {meta.bytes:.6e} card "
        f"{on_card.bytes:.6e}; compute term {rl['compute_s'] * 1e3:.1f} ms, "
        f"memory term {rl['memory_s'] * 1e3:.1f} ms beside the train "
        f"phase's step wall {train['step_ms']:.1f} ms (counted step "
        f"{wall * 1e3:.1f} ms under the counter); peak dry-run "
        f"{dry_peak / 1e9:.3f} GB (arguments "
        f"{rec['analysis']['memory']['argument_bytes'] / 1e9:.3f} GB), card "
        f"max_memory_allocated {peak / 1e9:.3f} GB "
        f"({dry_peak / peak - 1:+.2%}; {other / 1e9:.3f} GB other "
        f"allocations before the step), the train phase's "
        f"{train['peak_gb']:.2f} GB; flash {n_flash} launches by route "
        f"{routes}, windowed {windowed}; loss {loss:.4f}; meta count in "
        f"{meta_s:.1f} s; card: {card}")
    check_all("dryrun", {
        "(a) train: FLOPs on meta == FLOPs on the card": (
            meta.flops == on_card.flops > 0),
        "(a) train: flash launches == layers x microbatches x 2, all "
        "wgmma": (n_flash == want_flash and routes == {"wgmma": n_flash,
                                                       "ffma": 0}
                  and windowed == 0),
        f"(a) train: dry-run peak (with the other allocations) within "
        f"{DRYRUN['peak_rel']:.0%} of max_memory_allocated": abs(
            dry_peak + other - peak) <= DRYRUN["peak_rel"] * peak,
        "(a) train: loss finite": math.isfinite(loss),
    })
    return dict(flops=meta.flops, launches=n_flash, peak=peak,
                dry_peak=dry_peak, compute_ms=rl["compute_s"] * 1e3,
                memory_ms=rl["memory_s"] * 1e3, seconds=meta_s)


def dryrun_size_records():
    """The counts of (c) and (d), device-free, so that they may run in a
    worker process beside the card's phases (``start_host_work``): ([(arch,
    layers, cell, want fits, the count's layers, n_params, peak GB,
    argument bytes, fits)] for the depth cuts of PERF.md §4 on a
    one-device mesh, [(arch, shape, record)] for one production cell of
    each family on the single (16 x 16) mesh, (c)'s seconds, (d)'s)."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    cells = phase_cells()
    cuts = []
    for arch, layers, cell, want in DRYRUN["cuts"]:
        cfg = configs.get(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        shape = cells[cell]
        variant = {"n_micro": TRAIN["micro"]} if shape.kind == "train" \
            else None
        rec, _ = dryrun.analyze_cell(arch, shape, ONE_DEVICE, variant, cfg)
        cuts.append((arch, layers, cell, want, cfg.num_layers,
                     rec["n_params"], rec["peak_gb"],
                     rec["analysis"]["memory"]["argument_bytes"],
                     rec["fits"]))
    cuts_s = time.perf_counter() - t0
    out_dir = ROOT / "build" / "dryrun_phase"
    prod = [(arch, shape, dryrun.run_cell(arch, shape, "single", force=True,
                                          out_dir=out_dir))
            for arch, shape in DRYRUN["cells"]]
    return cuts, prod, cuts_s, time.perf_counter() - t0 - cuts_s


def dryrun_sizes(card, records):
    """(c) and (d): the depth cuts of PERF.md §4 on a one-device mesh
    against 80 GB, and one production cell of each family on the single
    (16 x 16) mesh, a line a cell, from ``records``, what
    ``dryrun_size_records`` returned. Returns the counts' seconds."""
    from repro_torch.launch import dryrun
    cuts, prod, cuts_s, prod_s = records
    cells = phase_cells()
    checks = {}
    for arch, layers, cell, want, n_layers, n, peak_gb, args, fits in cuts:
        shape = cells[cell]
        log(f"[dryrun] (c) {arch} at {n_layers} layers, {cell} "
            f"({shape.kind}, batch {shape.global_batch} x "
            f"{shape.seq_len}): {n / 1e9:.3f} B params; "
            f"peak {peak_gb:.2f} GB (arguments {args / 1e9:.2f} GB) against "
            f"{dryrun.H100_SXM.mem_gb} GB: fits {fits}")
        checks[f"(c) {arch} at {n_layers} layers, {cell}: fits "
               f"{want}"] = fits is want
    for arch, shape, rec in prod:
        if "error" in rec:
            log(rec["traceback"])
        else:
            rl = rec["roofline"]
            t = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
            log(f"[dryrun] (d) single/{arch}/{shape}: dominant "
                f"{rl['dominant']}, roofline fraction "
                f"{rl['compute_s'] / t:.3f} (compute {rl['compute_s']:.4g} "
                f"s, memory {rl['memory_s']:.4g} s, collective "
                f"{rl['collective_s']:.4g} s), useful "
                f"{rl['useful_ratio']:.4f}, {rec['peak_gb']:.2f} GB a "
                f"rank, fits {rec['fits']}, {rec['wall_s']:.1f} s")
        checks[f"(d) single/{arch}/{shape} completes"] = "error" not in rec
        if (arch, shape) in DRYRUN["fit"]:
            checks[f"(d) single/{arch}/{shape} fits 80 GB a rank, useful "
                   f">= {DRYRUN['min_useful']}"] = (
                "error" not in rec and rec["fits"] and
                rec["roofline"]["useful_ratio"] >= DRYRUN["min_useful"])
        if (arch, shape) in DRYRUN["serve_fit"]:
            checks[f"(d) single/{arch}/{shape} fits 80 GB a rank"] = (
                "error" not in rec and rec["fits"])
    log(f"[dryrun] (c) in {cuts_s:.1f} s, (d) in {prod_s:.1f} s in a "
        f"worker process; card: {card}")
    check_all("dryrun", checks)
    return cuts_s + prod_s


def dryrun_lint():
    """(e), on the host: the port's linter (``python -m repro_torch.analysis
    --project --baseline``, in-process) over its default paths in this
    checkout with the checked-in (empty) baseline, which must exit 0; logs
    each rule's active and suppressed findings and the seconds taken, and
    leaves its ``--gate-json`` rows for the gate. Returns the rows' path."""
    from repro_torch.analysis import cli
    t0 = time.perf_counter()
    rows_path = GATE_DIR / "analysis_rows.json"
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--project", "--baseline", "--json", "--gate-json",
                       str(rows_path)] + cli.default_paths(str(ROOT)))
    seconds = time.perf_counter() - t0
    doc = json.loads(out.getvalue())
    counts = {code: {"active": 0, "suppressed": 0}
              for code in sorted(json.loads(rows_path.read_text()))
              if code != "analysis/total"}
    for f in doc["findings"]:
        kind = "suppressed" if f["suppressed"] or f["baselined"] \
            else "active"
        counts[f"analysis/{f['code']}"][kind] += 1
    log(f"[dryrun] (e) repro_torch.analysis --project --baseline: rc {rc}, "
        f"{doc['summary']} in {seconds:.2f} s; by rule (active, "
        f"suppressed): " + ", ".join(
            f"{code.split('/')[1]} {c['active']} {c['suppressed']}"
            for code, c in counts.items()))
    for f in doc["findings"]:
        log(f"[dryrun] (e) lint: {f['path']}:{f['line']} {f['code']} "
            f"suppressed={f['suppressed']} baselined={f['baselined']}")
    check_all("dryrun", {"(e) the port's linter exits 0": rc == 0})
    return rows_path


def dryrun_gate():
    """(e): the port's regression gate (in-process, ``main(argv)``) on the
    card's own rows: the bench phase's rows against themselves (rc 0),
    against a copy with one ``compiles`` raised by 1 (rc 1) and with one
    timed row above 50 us slowed by 20 % (rc 1); the record_cli phase's
    two replay reports against each other (rc 0); the port linter's
    ``--gate-json`` rows (``dryrun_lint``) against themselves (rc 0) and
    against a copy with one rule's ``findings`` raised by 1 (rc 1)."""
    from repro_torch.benchmarks import regression_gate
    lint_path = dryrun_lint()
    t0 = time.perf_counter()
    rows_path = GATE_DIR / "bench_rows.json"
    rows = json.loads(rows_path.read_text())
    compiled = sorted(n for n, r in rows.items() if "compiles" in r)
    timed = sorted(n for n, r in rows.items() if "compiles" not in r
                   and r["us_per_call"] >= regression_gate.MIN_GATED_US)
    if not compiled or not timed:
        raise AssertionError(f"bench rows without a compile row or a timed "
                             f"row above 50 us: {sorted(rows)}")
    raised = json.loads(rows_path.read_text())
    raised[compiled[0]]["compiles"] += 1
    slowed = json.loads(rows_path.read_text())
    slowed[timed[0]]["us_per_call"] *= 1.2
    lint_rule = "analysis/DLK002"
    lint_raised = json.loads(lint_path.read_text())
    lint_raised[lint_rule]["findings"] += 1
    for name, doc in (("raised", raised), ("slowed", slowed),
                      ("analysis_raised", lint_raised)):
        (GATE_DIR / f"{name}.json").write_text(json.dumps(doc))
    cases = {
        "rows against themselves": ([rows_path, rows_path], 0),
        f"one compiles raised by 1 ({compiled[0]})": (
            [rows_path, GATE_DIR / "raised.json"], 1),
        f"one row slowed by 20 % ({timed[0]})": (
            [rows_path, GATE_DIR / "slowed.json"], 1),
        "the two replay reports": ([GATE_DIR / "replay_a.json",
                                    GATE_DIR / "replay_b.json"], 0),
        "the linter's rows against themselves": ([lint_path, lint_path], 0),
        f"one rule's findings raised by 1 ({lint_rule})": (
            [lint_path, GATE_DIR / "analysis_raised.json"], 1),
    }
    rcs = {}
    for name, (files, _) in cases.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs[name] = regression_gate.main([str(f) for f in files])
        for line in buf.getvalue().strip().splitlines():
            log(f"[dryrun] (e) {name}: {line}")
    log(f"[dryrun] (e) gate return codes {rcs} in "
        f"{time.perf_counter() - t0:.2f} s")
    check_all("dryrun", {f"(e) gate rc {want}: {name}": rcs[name] == want
                         for name, (_, want) in cases.items()})
    return rcs


def _profiled(fn, n=3, warm=True):
    """(host ms per call, device-busy ms per call, kernels per call,
    {kernel name: device ms per call}, whole) of ``fn`` on the card: host
    time without the profiler, device time as the sum of the CUDA
    kernels' durations under ``torch.profiler`` in one session
    (``benchmarks.common.kernel_events``, the kernels alone: xlstm-1.3b's
    train step launches 560,000 kernels); ``whole`` False where that
    session lost its first or last kernels (a lower bound). ``warm``
    False: ``fn`` has run at these shapes already (a train step of
    xlstm-1.3b takes 15 s)."""
    import torch
    from repro_torch.benchmarks.common import kernel_events
    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    by_name = {}
    events, whole = kernel_events(fn, n, tries=1)
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 1e3 / n
    return host_ms, sum(by_name.values()), len(events) / n, by_name, whole


def _device_ms(fn, by_kernel=False):
    """``repro_torch.benchmarks.common.device_ms``: one call's device time
    under ``torch.profiler``, the median of 30 calls."""
    from repro_torch.benchmarks.common import device_ms
    return device_ms(fn, by_kernel=by_kernel)


def _names(by_kernel) -> str:
    """The kernels of a ``_device_ms(..., by_kernel=True)`` reading, each
    with its device ms, names cut to 72 characters."""
    return "; ".join(f"{k[:72]} {v:.4f} ms" for k, v in by_kernel.items())


def phase_profile(eng, label="profile"):
    """Where the time goes in the serve phase's two steps at full width
    (granite-20b; deepseek-moe-16b with ``label`` profile_moe): one decode
    step of the whole batch and one cold 256-token prefill (the serve's
    largest bucket)."""
    import torch
    ad = eng.adapter
    b = eng.batch_size
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=ad.device)
    pos = torch.full((b,), 200, dtype=torch.int32, device=ad.device)
    prompt = torch.zeros((1, 256), dtype=torch.int32, device=ad.device)
    null_row = torch.zeros(ad.n_slot_blocks, dtype=torch.int32,
                           device=ad.device)
    # every slot is free after the serve: tables point at the null block,
    # so these steps write only there
    return profile_steps(label, {
        "decode step (4 rows)": lambda: ad.decode_step(tokens, pos),
        "prefill (256 tokens)": lambda: ad._prefill_slot(
            ad.params, prompt, 200, 0, null_row, ad.caches),
    })


def phase_profile_window(eng):
    """The same for gemma3-27b on its window rings: one decode step of the
    whole batch at position 1500 (past the window) and one cold 2048-token
    prefill into slot 0 (every slot is free after the serve)."""
    import torch
    ad = eng.adapter
    b = eng.batch_size
    tokens = torch.zeros((b, 1), dtype=torch.int32, device=ad.device)
    pos = torch.full((b,), 1500, dtype=torch.int32, device=ad.device)
    prompt = torch.zeros((1, 2048), dtype=torch.int32, device=ad.device)
    return profile_steps("profile_window", {
        "decode step (4 rows)": lambda: ad.decode_step(tokens, pos),
        "prefill (2048 tokens)": lambda: ad._prefill_slot(
            ad.params, prompt, 2048, 0, ad.caches),
    })


# kernel classes of a profile, by the first rule a kernel's name meets
KERNEL_CLASSES = (("flash", ("flash_fwd",)),
                  ("matmul", ("nvjet", "gemm", "xmma", "cutlass")),
                  ("copy/cast", ("copy", "Memcpy")),
                  ("fill", ("Fill",)),
                  ("reduce", ("reduce_kernel",)),
                  ("elementwise", ("elementwise",)))


def kernel_class(name) -> str:
    for cls, keys in KERNEL_CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def profile_steps(label, steps, n=3, **kw):
    out = {}
    for name, fn in steps.items():
        host, dev, n_k, by_name, whole = _profiled(fn, n, **kw)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        by_class = {}
        for k, v in by_name.items():
            cls = kernel_class(k)
            by_class[cls] = by_class.get(cls, 0.0) + v
        flash = by_class.get("flash", 0.0)
        idle = 1.0 - dev / host if host > 0 else 0.0
        log(f"[{label}] {name}: host {host:.3f} ms, device busy "
            f"{dev:.3f} ms (idle share {idle:.1%}), {n_k:.0f} kernels"
            + ("" if whole else " (the profiler lost the session's first or "
               "last kernels: a lower bound)") + "; "
            f"flash kernel {flash:.3f} ms; device ms by class: "
            + ", ".join(f"{c} {v:.3f}" for c, v in sorted(
                by_class.items(), key=lambda kv: -kv[1]))
            + "; top: "
            + "; ".join(f"{k[:120]} {v:.3f} ms" for k, v in top))
        out[name] = dict(host_ms=host, device_ms=dev, kernels=n_k,
                         flash_ms=flash, by_class=by_class, whole=whole)
    return out


def _to_cuda(tree):
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    return tree.cuda()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def flash_work(s, t, d, h, hkv, q_offset, itemsize, window=None,
               causal=True):
    """(bytes, operations) the function needs at these shapes: q read and
    the output written once, k and v read once over the keys some query
    can see (causal: from ``q_offset - window + 1`` with a window, up to
    ``q_offset + s``; non-causal: all ``t``); 4·D operations for every
    (query, visible key) pair."""
    if not causal:
        return itemsize * (2 * h * s * d + 2 * hkv * t * d), 4 * d * h * s * t
    lo = 0 if window is None else max(0, q_offset - window + 1)
    pairs = sum(min(q_offset + i + 1, t)
                - (0 if window is None else max(0, q_offset + i - window + 1))
                for i in range(s))
    keys = min(t, q_offset + s) - lo
    n_bytes = itemsize * (2 * h * s * d + 2 * hkv * keys * d)
    return n_bytes, 4 * d * h * pairs


def flash_dispatch(q, k, v, causal, win, off, rounds=5, iters=20):
    """The flash op's host dispatch at one shape: CUDA events a call over
    back-to-back calls of the op (``torch.ops.repro_torch.flash_fwd``, as
    every path reaches the kernel) and of its CUDA implementation called
    directly (``ops._flash_fwd_cuda``: the same planned launch without the
    dispatcher), alternated ``rounds`` times so that both meet the host's
    load alike; (op ms, direct ms), each the median of its rounds. The
    two outputs are held equal bitwise."""
    import statistics
    import torch
    from repro_torch.kernels.flash_attention import ops
    op = lambda: torch.ops.repro_torch.flash_fwd(  # noqa: E731
        q, k, v, causal, win, off)
    direct = lambda: ops._flash_fwd_cuda(q, k, v, causal, win, off)  # noqa: E731
    if not torch.equal(op(), direct()):
        raise AssertionError("flash through the op differs from the direct "
                             "launch")
    a, b = [], []
    for _ in range(rounds):
        a.append(cuda_timed(op, iters))
        b.append(cuda_timed(direct, iters))
    return statistics.median(a), statistics.median(b)


def phase_timing(cfg, shapes):
    """Flash at each of the serve phase's prefill shapes, bf16: the planned
    call (wgmma) and the ffma route beside the plain version and sdpa with
    the causal mask as a tensor (the same function at any q_offset), by
    CUDA events over back-to-back calls; and the device time of one call
    under the profiler of each route and tile, of sdpa with the mask and,
    at q_offset 0, of sdpa with is_causal (the call PyTorch's own flash
    backend takes). Held at the stated tolerances on the same inputs.
    Returns {route: [row per shape]}."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    h, hkv, d, t = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                    SERVE["max_seq"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = {"wgmma": [], "ffma": []}
    for s, off in shapes:
        g = torch.Generator(device="cuda")
        g.manual_seed(s + off)
        q, k, v = (torch.randn(1, n, m, d, device="cuda", generator=g,
                               dtype=torch.bfloat16)
                   for n, m in ((h, s), (hkv, t), (hkv, t)))
        mask = (torch.arange(t, device="cuda")[None, :]
                <= torch.arange(s, device="cuda")[:, None] + off)
        planned = ops.plan(1, h, hkv, s, t, d, torch.bfloat16, sms)
        if planned[0] != "wgmma":
            raise AssertionError(f"the serve's bf16 prefill planned "
                                 f"{planned}")
        calls = {
            "wgmma": lambda: ops.flash_attention(q, k, v, q_offset=off),
            "ffma": lambda: ops.launch(q, k, v, causal=True, window=None,
                                       q_offset=off, route="ffma",
                                       block_m=64),
        }
        before = dict(ops.route_launches)
        events = {r: cuda_timed(fn) for r, fn in calls.items()}
        taken = {r: c - before[r] for r, c in ops.route_launches.items()}
        if taken != {"wgmma": 23, "ffma": 23}:
            raise AssertionError(f"timed calls took routes {taken}")
        device = {f"wgmma/{bm}": _device_ms(lambda: ops.launch(
            q, k, v, causal=True, window=None, q_offset=off, route="wgmma",
            block_m=bm)) for bm in ops.TILES["wgmma"]}
        device["ffma/64"] = _device_ms(calls["ffma"])
        plain_ms = cuda_timed(lambda: ref.attention(q, k, v, q_offset=off),
                              iters=5)
        sdpa = lambda: F.scaled_dot_product_attention(      # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
        lib = {"mask": (cuda_timed(sdpa), _device_ms(sdpa))}
        if off == 0:
            causal = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, is_causal=True, enable_gqa=True)
            lib["is_causal"] = (cuda_timed(causal), _device_ms(causal))
        # held at the stated tolerances on these very inputs: bf16 on both
        # routes, f32 (the ffma route's own dtype) on the planned call
        errs = {}
        for route in calls:
            errs[route] = (calls[route]().float() - ref.attention(
                q, k, v, q_offset=off).float()).abs().max().item()
        qf, kf, vf = (x.float() for x in (q, k, v))
        errs["float32"] = (ops.flash_attention(qf, kf, vf, q_offset=off)
                           - ref.attention(qf, kf, vf, q_offset=off)
                           ).abs().max().item()
        for name, err in errs.items():
            tol = FLASH_TOL["float32" if name == "float32" else "bfloat16"]
            if not err <= tol:
                raise AssertionError(f"flash {name} disagrees at S {s} "
                                     f"q_offset {off}: {err} > {tol}")
        op_ms, direct_ms = flash_dispatch(q, k, v, True, None, off)
        n_bytes, n_ops = flash_work(s, t, d, h, hkv, off, 2)
        t_bytes = n_bytes / PEAK_BYTES * 1e3
        t_ops = n_ops / PEAK_OPS["bfloat16"] * 1e3
        for route, bm in (planned, ("ffma", 64)):
            rows[route].append(dict(
                s=s, q_offset=off, t=t, ms=events[route],
                device_ms=device[f"{route}/{bm}"], plain_ms=plain_ms,
                library_ms=lib["mask"][0],
                library_device_ms=lib["mask"][1],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                max_abs_err=max(errs[route], errs["float32"])
                if route == "ffma" else errs[route]))
        rows["wgmma"][-1].update(op_ms=op_ms, direct_ms=direct_ms)
        log(f"[timing] flash bf16 q[1,{h},{s},{d}] kv[1,{hkv},{t},{d}] "
            f"q_offset {off} (plan {planned[0]} tile {planned[1]}): events "
            f"wgmma {events['wgmma']:.4f} ms, ffma {events['ffma']:.4f} ms, "
            f"plain {plain_ms:.4f} ms, " + ", ".join(
                f"sdpa {n} {e:.4f} ms" for n, (e, _) in lib.items())
            + "; device time a call: " + ", ".join(
                f"{n} {v:.4f} ms" for n, v in device.items()) + ", "
            + ", ".join(f"sdpa {n} {dv:.4f} ms" for n, (_, dv) in
                        lib.items())
            + f"; bound {max(t_bytes, t_ops):.5f} ms "
            f"({'bytes' if t_bytes > t_ops else 'operations'}); max|err| "
            f"bf16 wgmma {errs['wgmma']:.3e}, ffma {errs['ffma']:.3e} (tol "
            f"{FLASH_TOL['bfloat16']:g}), f32 {errs['float32']:.3e} (tol "
            f"{FLASH_TOL['float32']:g}); dispatch: the op {op_ms:.4f} ms, "
            f"the direct launch {direct_ms:.4f} ms by events")
    return rows


def timing_flash_f32(shape):
    """The ffma route on its own path: f32 at the smoke model's first
    prefill shape (q [1,H,S,D], kv [1,Hkv,T,D], q_offset 0), planned and
    counted, by CUDA events and device time beside the plain version and
    sdpa with the mask; held at the f32 tolerance."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    h, hkv, s, t, d = shape
    g = torch.Generator(device="cuda")
    g.manual_seed(s)
    q, k, v = (torch.randn(1, n, m, d, device="cuda", generator=g)
               for n, m in ((h, s), (hkv, t), (hkv, t)))
    mask = (torch.arange(t, device="cuda")[None, :]
            <= torch.arange(s, device="cuda")[:, None])
    call = lambda: ops.flash_attention(q, k, v)             # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(          # noqa: E731
        q, k, v, attn_mask=mask, enable_gqa=True)
    before = dict(ops.route_launches)
    ms = cuda_timed(call)
    taken = {r: c - before[r] for r, c in ops.route_launches.items()
             if c != before[r]}
    if taken != {"ffma": 23}:
        raise AssertionError(f"the f32 calls took routes {taken}")
    op_ms, direct_ms = flash_dispatch(q, k, v, True, None, 0)
    err = (call() - ref.attention(q, k, v)).abs().max().item()
    if not err <= FLASH_TOL["float32"]:
        raise AssertionError(f"flash ffma f32 disagrees: {err}")
    n_bytes, n_ops = flash_work(s, t, d, h, hkv, 0, 4)
    row = dict(_row(ms, cuda_timed(lambda: ref.attention(q, k, v), iters=5),
                    cuda_timed(sdpa), n_bytes, n_ops, PEAK_OPS["float32"],
                    err),
               device_ms=_device_ms(call), library_device_ms=_device_ms(sdpa),
               op_ms=op_ms, direct_ms=direct_ms,
               timed_at=f"f32 q[1,{h},{s},{d}] kv[1,{hkv},{t},{d}] "
                        f"q_offset 0 (the f32 smoke model's prefill)")
    log(f"[timing] flash ffma {row['timed_at']}: events {row['ms']:.4f} ms, "
        f"plain {row['plain_ms']:.4f} ms, sdpa mask {row['library_ms']:.4f} "
        f"ms; device {row['device_ms']:.4f} ms, sdpa mask "
        f"{row['library_device_ms']:.4f} ms; bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}); max|err| {err:.3e} (tol "
        f"{FLASH_TOL['float32']:g}); dispatch: the op {op_ms:.4f} ms, the "
        f"direct launch {direct_ms:.4f} ms by events")
    return row


# gemma3-27b's prefill attention at full width, S = T = 2048: a local
# layer (window 1024) and a global one (causal, no window)
WINDOW_TIMING = ((2048, 1024), (2048, None))


def timing_window(cfg):
    """Flash at gemma3-27b's S 2048 prefill, bf16 q [1,32,2048,128] and kv
    [1,16,2048,128], with the 1024 window (a local layer) and without (a
    global layer): ``time_flash``. Returns {window: row}."""
    return {win: time_flash(1, cfg.num_heads, cfg.num_kv_heads, s,
                            cfg.head_dim, win,
                            f"gemma3-27b's {'local' if win else 'global'} "
                            f"layer")
            for s, win in WINDOW_TIMING}


def row_err(got, want) -> float:
    """max over query rows of max|got - want| in the row / max|want| in
    the row (``FLASH_ROW_TOL``)."""
    got, want = got.float(), want.float()
    return ((got - want).abs().amax(-1)
            / want.abs().amax(-1).clamp_min(1e-30)).max().item()


def planted_tile(s, off) -> int:
    """The first key of the 64-key V tile the planted fault zeroes at a
    shape of ``s`` query rows from ``off``: key 16384 where some row lies
    past that tile, else the tile at the middle of the keys the last row
    sees (a kernel that skips a tile's load past some offset)."""
    last = off + s - 1
    if last >= 16384 + 2 * FLASH_TILE:
        return 16384
    return FLASH_TILE * (last // (2 * FLASH_TILE))


def _calls_in(ms, budget_ms, most) -> int:
    """How many calls of ``ms`` each fit ``budget_ms``: 1 to ``most``."""
    return max(1, min(most, int(budget_ms // max(ms, 1e-6))))


def time_flash(b, h, hkv, s, d, win, what, t=None, off=0, causal=True,
               hold=None):
    """The planned flash call (wgmma) on bf16 q [b,h,s,d], kv [b,hkv,t,d]
    (causal from ``q_offset`` ``off``, with ``win`` a window; ``t`` None:
    s; ``causal`` False: every query sees every key) beside the plain
    version and sdpa with the boolean mask (non-causal: with no mask; and,
    causal without a window at q_offset 0, with is_causal, whose mask is
    aligned at the top left: query i sees keys up to i, which is q_offset
    0 at any t), by CUDA events over back-to-back calls and by one call's
    device time under the profiler; the bound. The kernel and sdpa are
    held against the plain version at the bf16 tolerance, the kernel also
    row by row (``FLASH_ROW_TOL``), and that row check must fail the
    plain version with one 64-key tile of V zeroed (``planted_tile``);
    ``hold`` (None: every query row) holds only the first and the last
    ``hold`` query rows (rows are independent), where the plain version
    over every row takes seconds. The plain version runs as many query
    rows at a time as keep their f32 scores within 4 GiB. The timed calls
    of each follow from one call's time: the kernel's and sdpa's about
    150 ms, the dispatch rounds and the plain version's about a
    second."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    tol = FLASH_TOL["bfloat16"]
    t = s if t is None else t
    g = torch.Generator(device="cuda")
    g.manual_seed(s + (win or 0))
    q, k, v = (torch.randn(b, n, m, d, device="cuda", generator=g,
                           dtype=torch.bfloat16)
               for n, m in ((h, s), (hkv, t), (hkv, t)))
    qp = torch.arange(s, device="cuda")[:, None] + off
    kp = torch.arange(t, device="cuda")[None, :]
    mask = kp <= qp
    if win is not None:
        mask = mask & (qp - kp < win)
    call = lambda: ops.flash_attention(q, k, v, window=win,  # noqa: E731
                                       q_offset=off, causal=causal)
    rows = 2 ** ((2 ** 32 // (4 * b * h * t)).bit_length() - 1)
    spans = ((0, s),) if hold is None else ((0, hold), (s - hold, s))

    def plain(v=v, spans=((0, s),)):
        return torch.cat([ref.attention(
            q[:, :, i:min(i + rows, hi)], k, v, window=win,
            q_offset=off + i, causal=causal)
            for lo, hi in spans for i in range(lo, hi, rows)], dim=2)

    def held(x):
        return torch.cat([x[:, :, lo:hi] for lo, hi in spans], dim=2)

    one = cuda_timed(call, iters=1, warmup=1)
    iters = _calls_in(one, 150, 20)
    before = dict(ops.route_launches)
    ms = cuda_timed(call, iters)
    taken = {r: c - before[r] for r, c in ops.route_launches.items()
             if c != before[r]}
    if taken != {"wgmma": iters + 3}:
        raise AssertionError(f"the timed calls took routes {taken}")
    op_ms, direct_ms = flash_dispatch(
        q, k, v, causal, win, off, _calls_in(2 * (iters + 3) * one, 1000, 5),
        iters)
    device = _device_ms(call)
    first = []
    first_ms = cuda_timed(lambda: first.append(plain(spans=spans)), iters=1,
                          warmup=0)
    want = first.pop().float()
    plain_ms = cuda_timed(plain, iters=_calls_in(
        first_ms * s / want.shape[2], 1000, 5), warmup=0)
    if causal:
        lib = {"mask": lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)}
        if win is None and off == 0:
            lib["is_causal"] = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
    else:
        lib = {"no mask": lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=True)}
    got = held(call())
    err = (got.float() - want).abs().max().item()
    rel = row_err(got, want)
    tile = planted_tile(s, off)
    v_bad = v.clone()
    v_bad[:, :, tile:tile + FLASH_TILE] = 0
    planted = row_err(got, plain(v_bad, spans))
    del got, v_bad
    lib_err = {n: (held(fn()).float() - want).abs().max().item()
               for n, fn in lib.items()}
    if not (err <= tol and all(e <= tol for e in lib_err.values())
            and rel <= FLASH_ROW_TOL):
        raise AssertionError(f"flash (or sdpa) disagrees at B {b} S {s} "
                             f"window {win}: {err}, row by row {rel}, sdpa "
                             f"{lib_err}")
    if not planted > FLASH_ROW_TOL:
        raise AssertionError(f"the row check passes a plain version with V's "
                             f"keys {tile}-{tile + FLASH_TILE - 1} zeroed at "
                             f"B {b} S {s} window {win}: {planted}")
    lib_ms = {n: (cuda_timed(fn, _calls_in(one, 150, 20)),
                  _device_ms(fn)) for n, fn in lib.items()}
    first = next(iter(lib_ms))           # the mask, or no mask: the same
    n_bytes, n_ops = flash_work(s, t, d, h, hkv, off, 2, win, causal)
    row = dict(_row(ms, plain_ms, lib_ms[first][0], b * n_bytes,
                    b * n_ops, PEAK_OPS["bfloat16"], err),
               row_rel_err=rel, device_ms=device,
               library_device_ms=lib_ms[first][1], op_ms=op_ms,
               direct_ms=direct_ms,
               timed_at=f"bf16 q[{b},{h},{s},{d}] kv[{b},{hkv},{t},{d}] "
                        f"q_offset {off}, "
                        + (f"window {win}" if causal else "non-causal")
                        + f" ({what})"
                        + ("" if hold is None else
                           f"; held at query rows 0-{hold - 1} and "
                           f"{s - hold}-{s - 1}"))
    if "is_causal" in lib_ms:
        row["is_causal_ms"], row["is_causal_device_ms"] = \
            lib_ms["is_causal"]
    log(f"[timing] flash {row['timed_at']}: events {ms:.4f} ms ({iters} "
        f"calls), plain {plain_ms:.4f} ms ({min(rows, s)} query rows at a "
        f"time, every row), " + ", ".join(
            f"sdpa {n} {e:.4f} ms" for n, (e, _) in lib_ms.items())
        + f"; device time a call: wgmma {device:.4f} ms, " + ", ".join(
            f"sdpa {n} {dv:.4f} ms" for n, (_, dv) in lib_ms.items())
        + f"; bound {row['bound_ms']:.5f} ms ({row['bound_by']}; "
        f"{b * n_ops / 1e9:.2f} GFLOP, {b * n_bytes / 1e6:.1f} MB); "
        f"{b * n_ops / device / 1e9:.1f} TFLOP/s by device time; max|err| "
        f"{err:.3e}, sdpa "
        + ", ".join(f"{n} {e:.3e}" for n, e in lib_err.items())
        + f" (tol {tol:g}); row by row {rel:.3e} of the row's max|want| "
        f"(tol {FLASH_ROW_TOL:g}), against V's keys {tile}-"
        f"{tile + FLASH_TILE - 1} zeroed {planted:.3e}; dispatch: the op "
        f"{op_ms:.4f} ms, the direct launch {direct_ms:.4f} ms by events")
    return row


def timing_train_4k(trains):
    """{row name: (launches, timing row)}: each train_4k run's flash shape
    at 4096 (whisper-small's decoder: its encoder's launches are at the
    whisper_small row's shape, one row over 1500 frames), timed at one
    microbatch and counted over that run's loop; ``trains``: the train
    phase's results."""
    rows = {}
    for r in trains:
        if "train4k" not in r:
            continue
        (sh, n), = [(sh, n) for sh, n in r["train4k"]["shapes"].items()
                    if sh[3] == TRAIN_4K["seq"]]
        b, h, hkv, s, t, d, causal, win, off = sh
        rows[f"flash_attention/wgmma/{r['arch'].split('-')[0]}_train4k"] = (
            n, time_flash(b, h, hkv, s, d, win, f"{r['arch']}'s train_4k "
                          f"run, one microbatch", t=t, off=off,
                          causal=causal))
    return rows


def moe_long_specs():
    """The MoE models' (MHA 16:16, D 128, the same shapes on both) flash
    rows at serve_long's shapes, as ``time_long_rows`` takes them: the
    cold 32768-token prefill and a prefix hit's tail, counted over both
    MoE serves (one that did not fit launched none)."""
    from repro_torch import configs
    t, e = SERVE_LONG["max_seq"], configs.get("deepseek-moe-16b")
    archs = ("deepseek-moe-16b", "moonshot-v1-16b-a3b")
    return {"moe_long_cold": (archs, e, t, t, None, 0,
                              "the MoE models' cold 32768-token prefill"),
            "moe_long_tail": (archs, e, t // 2, t, None, t // 2,
                              "the MoE models' prefix-hit tail")}


def time_long_rows(long, specs, held=None):
    """Flash by ``time_flash`` at each of ``specs`` ({name: (arch or archs,
    cfg, query rows, keys, window, q_offset, what)}), bf16, each with the
    launches the serves in ``long`` made at that shape (it fails where
    they made none); ``held``: {name: the query rows held at each end}.
    Returns {name: (launches, row)}."""
    rows = {}
    for name, (arch, cfg, s, keys, win, off, what) in specs.items():
        keys = s if win is not None else keys
        shape = (1, cfg.num_heads, cfg.num_kv_heads, s, keys, cfg.head_dim,
                 True, win, off)
        archs = arch if isinstance(arch, tuple) else (arch,)
        n = sum(long[a].get("shapes", {}).get(shape, 0) for a in archs)
        if not n:
            raise AssertionError(f"serve_long gave flash no launch at "
                                 f"{shape}: " + "; ".join(
                                     str(long[a].get("shapes"))
                                     for a in archs))
        rows[name] = (n, time_flash(
            1, cfg.num_heads, cfg.num_kv_heads, s, cfg.head_dim, win, what,
            t=keys, off=off, hold=(held or {}).get(name)))
    return rows


def timing_long(long):
    """Flash at serve_long's shapes (``time_long_rows``): granite-20b's
    cold 32768-token prefill (q [1,48,32768,128] over 1 KV head) and a
    prefix hit's tail (q [1,48,16384,128] at q_offset 16384), gemma3-27b's
    global layer (causal, S = T = 32768, 32 q / 16 KV heads) and local
    layer (the 1024 window), zamba2-1.2b's first and last chunk
    ([1,32,16384,64] at q_offset 0, [1,32,32,64] at q_offset 32704), each
    over the 32768 positions of its cache row but the local layer (over
    its own keys); zamba2-1.2b's long_500k serve, over its 524288
    positions: the 4096-token chunk at its offset (held at its first and
    last 64 query rows: the plain version over all 4096 takes seconds)
    and the last chunk (32 tokens at q_offset 524224); and the MoE
    models' rows (``moe_long_specs``)."""
    from repro_torch import configs
    t = SERVE_LONG["max_seq"]
    g, m, z = (configs.get(a) for a in ("granite-20b", "gemma3-27b",
                                        "zamba2-1.2b"))
    chunks, t5 = long["zamba2-1.2b-500k"]["chunks"], SERVE_500K["max_seq"]
    at = {}
    for i, size in enumerate(chunks):
        at.setdefault(size, sum(chunks[:i]))
    specs = {
        "granite_long_cold": ("granite-20b", g, t, t, None, 0,
                              "granite-20b's cold 32768-token prefill"),
        "granite_long_tail": ("granite-20b", g, t // 2, t, None, t // 2,
                              "granite-20b's prefix-hit tail"),
        "gemma3_long_global": ("gemma3-27b", m, t, t, None, 0,
                               "gemma3-27b's global layer at 32768"),
        "gemma3_long_window": ("gemma3-27b", m, t, t, m.sliding_window, 0,
                               "gemma3-27b's local layer at 32768"),
        "zamba2_long_first": ("zamba2-1.2b", z, t // 2, t, None, 0,
                              "zamba2-1.2b's first chunk"),
        "zamba2_long_last": ("zamba2-1.2b", z, 32, t, None, t - 64,
                             "zamba2-1.2b's last chunk"),
        "zamba2_500k_chunk4096": ("zamba2-1.2b-500k", z, 4096, t5, None,
                                  at[4096], "zamba2-1.2b's long_500k "
                                  "4096-token chunk"),
        "zamba2_500k_last": ("zamba2-1.2b-500k", z, chunks[-1], t5, None,
                             at[chunks[-1]], "zamba2-1.2b's long_500k last "
                             "chunk"),
    } | moe_long_specs()
    return time_long_rows(long, specs, held={"zamba2_500k_chunk4096": 64})


#: a flash timing row's keys that go into the kernels line (the first five
#: in every row)
FLASH_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
              "row_rel_err", "device_ms", "library_device_ms", "is_causal_ms",
              "is_causal_device_ms", "op_ms", "direct_ms", "timed_at")


def flash_keys(row) -> dict:
    """A flash timing row's numbers for the kernels line."""
    return {k: row[k] for k in FLASH_KEYS[:5]} | {
        k: row[k] for k in FLASH_KEYS[5:] if k in row}


def _row(ms, plain_ms, lib_ms, n_bytes, n_ops, peak_ops, err):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                max_abs_err=err)


def timing_stream(errs):
    """The six STREAM kernels at 128 MiB f32 (32768x1024), past the 50 MB
    L2, beside their plain versions and one library call each."""
    import torch
    from repro_torch.kernels.stream import ref, stream as sk
    shape = (32768, 1024)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    a = torch.randn(shape, device="cuda", generator=g)
    b = torch.randn(shape, device="cuda", generator=g)
    stream_held(a, b, errs)                   # held on these very inputs
    x = STREAM_X
    xr = ref.scalar(x, a.dtype).item()
    n = a.numel() * a.element_size()
    n_blocks = shape[0] // 256
    cases = {
        # name: (kernel, plain, library, bytes, operations)
        "stream_copy": (lambda: sk.stream_copy(a), lambda: ref.copy(a),
                        lambda: a.clone(), 2 * n, 0),
        "stream_scale": (lambda: sk.stream_scale(a, x),
                         lambda: ref.scale(a, x), lambda: torch.mul(a, xr),
                         2 * n, a.numel()),
        "stream_add": (lambda: sk.stream_add(a, b), lambda: ref.add(a, b),
                       lambda: torch.add(a, b), 3 * n, a.numel()),
        "stream_triad": (lambda: sk.stream_triad(a, b, x),
                         lambda: ref.triad(a, b, x),
                         lambda: torch.add(b, a, alpha=xr), 3 * n,
                         2 * a.numel()),
        "stream_write": (lambda: sk.stream_write(shape, x),
                         lambda: ref.write(shape, x, a.dtype, "cuda"),
                         lambda: torch.full(shape, xr, device="cuda"), n, 0),
        "stream_read": (lambda: sk.stream_read(a), lambda: ref.read(a),
                        lambda: a.view(n_blocks, -1).sum(1),
                        n + n_blocks * 4, a.numel()),
    }
    rows = {}
    for name, (kern, plain, lib, n_bytes, n_ops) in cases.items():
        before = alloc_counts()
        ms = cuda_timed(kern)
        allocs = [b - a for a, b in zip(before, alloc_counts())]
        plain_ms, lib_ms = cuda_timed(plain), cuda_timed(lib)
        rows[name] = r = _row(ms, plain_ms, lib_ms, n_bytes, n_ops,
                              PEAK_OPS["float32"], errs[name])
        r["device_ms"] = _device_ms(kern)
        r["library_device_ms"], lib_by = _device_ms(lib, by_kernel=True)
        log(f"[timing] {name} f32 {shape}: kernel {ms:.4f} ms "
            f"({n_bytes / ms / 1e6:.1f} GB/s), plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}, {n_bytes} bytes); kernel at "
            f"{r['bound_ms'] / ms:.1%} of the bound; device time a call: "
            f"kernel {r['device_ms']:.4f} ms "
            f"({r['bound_ms'] / r['device_ms']:.1%} of the bound), library "
            f"{r['library_device_ms']:.4f} ms ({_names(lib_by)}); "
            f"allocator in the kernel's events loop: {allocs[0]} new "
            f"segments, {allocs[1]} retries")
    return rows


def timing_dpa(errs):
    """dpa_matmul at 512^3 (the bench's size) and 4096^3 beside its plain
    version and one library call: torch.mm in f32 with TF32 off, torch.mm
    in bf16 (which writes bf16, not f32), torch._int_mm (int8 -> int32).
    Logged beside them, as yardsticks only: torch.mm in bf16 with
    out_dtype f32 where this torch takes it, and the device time of one
    kernel call and of one library call under the profiler (at 512^3 the
    events time of back-to-back calls is mostly the host's dispatch). The
    route each call took is read from the per-route launch counts."""
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk, ref
    assert torch.backends.cuda.matmul.allow_tf32 is False
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = {"fma_f32": torch.mm, "dpa2": torch.mm, "dpa4": torch._int_mm}
    peak = {v: PEAK_OPS[DPA_IN[v]] for v in DPA_IN}
    rows = {}
    for size in (512, 4096):
        for variant in DPA_IN:
            a, b = dpa_inputs(size, size, size, variant, g)
            dpa_held(a, b, variant, errs)
            iters = 20 if size == 512 else 10
            route, bm, bn = dk.plan(size, size, size, variant, sms)
            before = dict(dk.route_launches)
            allocs = alloc_counts()
            ms = cuda_timed(lambda: dk.dpa_matmul(a, b, variant=variant),
                            iters=iters)
            allocs = [y - x for x, y in zip(allocs, alloc_counts())]
            taken = {r: c - before[r] for r, c in dk.route_launches.items()
                     if c != before[r]}
            if set(taken) != {f"{variant}/{route}"}:
                raise AssertionError(f"{variant} {size}^3 planned route "
                                     f"{route}, took {taken}")
            plain_ms = cuda_timed(lambda: ref.matmul(a, b, variant),
                                  iters=iters)
            lib_ms = cuda_timed(lambda: lib[variant](a, b), iters=iters)
            dev_ms, dev_by = _device_ms(
                lambda: dk.dpa_matmul(a, b, variant=variant), by_kernel=True)
            dev_lib_ms, lib_by = _device_ms(lambda: lib[variant](a, b),
                                            by_kernel=True)
            extra = ""
            if variant == "dpa4":
                # the transpose's share of the call, and the mma route on
                # the same inputs: plan's route rule rests on this reading
                t_ms = sum(v for k, v in dev_by.items() if "transpose" in k)
                mma_ms = _device_ms(lambda: dk.launch(a, b, "dpa4", "mma",
                                                      128, 128))
                extra += (f", device time by kernel: {_names(dev_by)} "
                          f"(transpose {t_ms / dev_ms:.1%} of the call), "
                          f"mma route 128x128 {mma_ms:.4f} ms")
                if not dev_ms < mma_ms:
                    raise AssertionError(f"dpa4 {size}^3: wgmma {dev_ms} ms "
                                         f"is not below mma {mma_ms} ms")
            if size == 512 and len(dk.TILES[route]) > 1:
                # every tile of the route at the bench's size, the reading
                # plan's tile rule rests on
                tiles = {f"{tm}x{tn}": _device_ms(lambda: dk.launch(
                    a, b, variant, route, tm, tn))
                    for tm, tn in dk.TILES[route]}
                extra += (", device time a call by tile: " + ", ".join(
                    f"{t} {v:.4f} ms" for t, v in tiles.items()))
            if variant == "dpa2":
                try:
                    f32_ms = cuda_timed(lambda: torch.mm(
                        a, b, out_dtype=torch.float32), iters=iters)
                    extra += f", torch.mm out_dtype=f32 {f32_ms:.4f} ms"
                except (TypeError, RuntimeError) as e:
                    extra += (f", torch.mm out_dtype=f32 not taken "
                              f"({type(e).__name__})")
            n_ops = 2 * size ** 3
            n_bytes = 2 * size * size * a.element_size() + size * size * 4
            name = f"dpa_matmul/{variant}"
            r = _row(ms, plain_ms, lib_ms, n_bytes, n_ops, peak[variant],
                     errs[name])
            r.update(device_ms=dev_ms, library_device_ms=dev_lib_ms)
            if variant == "dpa4":
                r.update(transpose_device_ms=t_ms, mma_device_ms=mma_ms)
            rows[(name, size)] = r
            log(f"[timing] {name} {size}^3 (route {route}, tile {bm}x{bn}, "
                f"launches by route {taken}): kernel {ms:.4f} ms "
                f"({n_ops / ms / 1e9:.2f} Top/s), plain {plain_ms:.4f} ms, "
                f"library {lib_ms:.4f} ms{extra}, bound {r['bound_ms']:.5f} "
                f"ms ({r['bound_by']}); kernel at {r['bound_ms'] / ms:.1%} "
                f"of the bound; device time a call under the profiler: "
                f"kernel {dev_ms:.4f} ms, library {dev_lib_ms:.4f} ms "
                f"({_names(lib_by)}); allocator in the kernel's events "
                f"loop: {allocs[0]} new segments, {allocs[1]} retries")
    return rows


def timing_transpose(errs, in_call_ms):
    """dpa4's int8 transpose alone at 4096^2 (B of the 4096^3 product)
    beside its plain version, ``b.t().contiguous()``, which is also the one
    PyTorch call computing it; bound by bytes, K N read and K N written.
    Each timed call takes the next of four inputs and its output stays
    alive for four calls, so what a call reads and writes was last touched
    at least 96 MiB of traffic before, past the 50 MB L2 (back to back on
    one B, B and B^T stay there and the time reads below the HBM bound).
    ``in_call_ms`` is its device time inside the 4096^3 dpa4 call."""
    import collections
    import itertools
    import torch
    from repro_torch.kernels.dpa_matmul import dpa_matmul as dk
    g = torch.Generator(device="cuda")
    g.manual_seed(9)
    k = n = 4096
    bs = [torch.randint(-128, 128, (k, n), device="cuda", generator=g,
                        dtype=torch.int8) for _ in range(4)]
    for b in bs:
        if not torch.equal(dk.transpose_int8(b), b.t().contiguous()):
            raise AssertionError("the int8 transpose disagrees at 4096^2")

    def rotating(fn):
        inputs, outs = itertools.cycle(bs), collections.deque(maxlen=4)
        return lambda: outs.append(fn(next(inputs)))
    kern = rotating(dk.transpose_int8)
    plain = rotating(lambda b: b.t().contiguous())
    ms, plain_ms = cuda_timed(kern), cuda_timed(plain)
    r = _row(ms, plain_ms, plain_ms, 2 * k * n, 0, PEAK_OPS["int8"],
             errs[TRANSPOSE_NAME])
    r["device_ms"] = _device_ms(kern)
    r["device_ms_in_dpa4_call"] = in_call_ms
    r["library_device_ms"], lib_by = _device_ms(plain, by_kernel=True)
    log(f"[timing] {TRANSPOSE_NAME} int8 [{k},{n}] -> [{n},{k}], four "
        f"inputs in turn: kernel {ms:.4f} ms, plain = library "
        f"(b.t().contiguous()) {plain_ms:.4f} ms, bound "
        f"{r['bound_ms']:.5f} ms (bytes); device time a call: kernel "
        f"{r['device_ms']:.4f} ms ({r['bound_ms'] / r['device_ms']:.1%} of "
        f"the bound), inside the 4096^3 dpa4 call {in_call_ms:.4f} ms "
        f"({r['bound_ms'] / in_call_ms:.1%}), library "
        f"{r['library_device_ms']:.4f} ms ({_names(lib_by)})")
    return r


def phase_cli():
    """The serving CLI on the card: granite-20b's smoke model on the
    continuous engine, and gemma3-27b's (the CLI's default arch) on the
    static engine with a timeline written by --trace-out; the training
    CLI on granite-20b's, zamba2-1.2b's, whisper-small's and
    deepseek-moe-16b's smoke models, 4 steps each, each with its own
    --trace-out; and the port's bench_serving (every scenario on the smoke
    models; its gates print PASS or FAIL, readings, and its token
    assertions must hold). validate_chrome_trace must accept every
    timeline, and each must partition its run's joules. All run side by
    side."""
    import tempfile
    from repro_torch.obs import validate_chrome_trace
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cli = [sys.executable, "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        traces = {"serve": trace}
        runs = {
            "granite continuous": cli + ["--arch", "granite-20b", "--smoke"],
            "gemma3 static": cli + ["--arch", "gemma3-27b", "--smoke",
                                    "--engine", "static", "--prompt-len",
                                    "40", "--trace-out", str(trace)],
            "bench serving": [sys.executable, "-m",
                              "repro_torch.benchmarks.run", "--only",
                              "serving"],
        }
        for arch in ("granite-20b", "zamba2-1.2b", "whisper-small",
                     "deepseek-moe-16b"):
            name = f"{arch.split('-')[0]} train"
            traces[name] = pathlib.Path(tmp) / f"train_{arch}.json"
            runs[name] = [sys.executable, "-m", "repro_torch.launch.train",
                          "--arch", arch, "--smoke", "--steps", "4",
                          "--trace-out", str(traces[name])]
        procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True)
                 for name, cmd in runs.items()}
        failed = []
        for name, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=600)
            finally:
                proc.kill()
            for line in out.strip().splitlines():
                log(f"[cli] {name}: {line}")
            if proc.returncode != 0:
                log(err[-4000:])
                failed.append(f"{name} exited {proc.returncode}")
        if failed:
            raise AssertionError(f"CLI runs failed: {failed}")
        for name, path in traces.items():
            doc = json.loads(path.read_text())
            validate_chrome_trace(doc)
            od = doc["otherData"]
            log(f"[cli] {name} --trace-out: {len(doc['traceEvents'])} "
                f"events, {od['n_spans']} spans, {od['attributed_j']:.3f} J "
                f"attributed of {od['energy_total_j']:.3f} J")
            if abs(od["attributed_j"] - od["energy_total_j"]) > 1e-6:
                raise AssertionError(f"the {name} timeline's spans do not "
                                     f"partition the session's joules")
    log(f"[cli] ok in {time.perf_counter() - t0:.1f} s")


def phase_record_cli():
    """The record and replay CLIs and the host benches, on the host beside
    the card: ``launch.record`` writes a 2-node trace of the paper's
    topology under build/record, then ``launch.replay`` replays it with
    ``--check-determinism`` side by side with the bench runner's energy
    platform, elastic and scheduler benches, once each. Every one must
    exit 0."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    RECORD_DIR.mkdir(parents=True, exist_ok=True)
    trace = RECORD_DIR / "cli_cluster.dkt"
    py = [sys.executable, "-m"]
    t0 = time.perf_counter()
    rec = subprocess.run(py + ["repro_torch.launch.record", "--out",
                               str(trace), "--nodes", "2", "--duration",
                               "0.5"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    for line in rec.stdout.strip().splitlines():
        log(f"[record_cli] record: {line}")
    GATE_DIR.mkdir(parents=True, exist_ok=True)
    replay = py + ["repro_torch.launch.replay", str(trace), "--ttl", "0.3",
                   "--cap", "150"]
    runs = {
        "replay": replay + ["--check-determinism", "--json",
                            str(GATE_DIR / "replay_a.json")],
        "replay again": replay + ["--json", str(GATE_DIR / "replay_b.json")],
        **{f"bench {b}": py + ["repro_torch.benchmarks.run", "--only", b]
           for b in ("energy", "elastic", "scheduler")},
    }
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, env=env,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, cmd in runs.items()}
    rcs = {"record": rec.returncode}
    errs = {"record": rec.stderr}
    for name, proc in procs.items():
        try:
            out, errs[name] = proc.communicate(timeout=300)
        finally:
            proc.kill()
        rcs[name] = proc.returncode
        for line in out.strip().splitlines():
            log(f"[record_cli] {name}: {line}")
    for name, rc in rcs.items():
        if rc != 0:
            log(errs[name][-4000:])
    log(f"[record_cli] done in {time.perf_counter() - t0:.1f} s")
    check_all("record_cli", {f"{name} rc 0": rc == 0
                             for name, rc in rcs.items()})


def free_card():
    """Return the memory of dropped tensors to the card."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[memory] {torch.cuda.memory_allocated() / 1e9:.1f} GB allocated "
        f"after freeing")


def main() -> int:
    # one allocator for every phase, read before CUDA starts: on fixed
    # segments the blocks xlstm-1.3b's whole train step frees (it peaks at
    # 76.7 GB of the card's 79.2 GiB) left its 2.8 GB stacked gradients no
    # room, 7 GB reserved but free (the step OOMed in two runs of three)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    import repro_torch  # noqa: F401  (fails here, before any output, alone)
    from repro_torch import configs
    t_start = time.perf_counter()

    def mark(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s")

    card = smi_line()
    idle = subprocess.run(["nvidia-smi", "--query-gpu=power.draw,clocks.sm,"
                           "clocks.max.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {card}; before any work "
        f"(power draw, SM clock, max SM clock): {idle}; allocator "
        f"{os.environ['PYTORCH_CUDA_ALLOC_CONF']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    phase_build()
    flash_errs = phase_kernels()
    hold_flash_function()
    errs = phase_kernels_measurement()
    bench_launches = phase_bench()
    f32_launches, f32_shape = phase_small()
    mark("build, kernels, bench, small")
    cfg, eng, launches, shapes = phase_serve(card)
    launches.update(bench_launches)
    dry_b = dryrun_decode(
        eng.model, eng.params, card, DRYRUN["decode_seq"],
        DRYRUN["decode_batch"],
        phase_profile(eng)["decode step (4 rows)"]["device_ms"])
    serve_sharded_one_rank(eng.model, eng.params, card)
    del eng                                    # frees the 56 GB of weights
    free_card()
    wcfg, wmodel, wparams, weng, wlaunches, wshapes = phase_serve_window(
        card)
    phase_profile_window(weng)
    del weng
    free_card()
    wshapes |= phase_static_window(wcfg, wmodel, wparams)
    del wmodel, wparams                        # frees gemma3's 56.8 GB
    free_card()
    held_err = hold_window_shapes(wshapes)
    mark("serve, serve_window")
    phase_serve_dense(card)
    free_card()
    mark("dense (qwen3-32b, deepseek-coder-33b whole)")
    # the device-free work from here on, beside phases bound by the card
    # (serve_long's 32k prefills first), so that the host-bound readings
    # above (the bench's launch latency, the 512 serves' tok/s and decode
    # host ms) are taken on an otherwise idle host
    host_pool, counts_4k, hosts_4k, sizes = start_host_work()
    sizes.add_done_callback(lambda _: mark("the worker's device-free work"))
    long_serves = phase_serve_long(card)
    mark("serve_long")
    mcfg, mmodel, mparams, meng, moe_launches, mshapes = phase_serve_moe(
        card)
    phase_profile(meng, "profile_moe")
    del meng
    hold_moe_layer(mcfg, mparams)
    free_card()
    mark("serve_moe (deepseek-moe-16b)")
    # serve_long's MoE cells on the served weights: (e) deepseek-moe-16b,
    # then, after its f32 hold, (f) moonshot-v1-16b-a3b
    long_moe = {mcfg.name: serve_long_moe(card, mcfg, mmodel, mparams,
                                          "serve_long_moe", profile=True)}
    del mmodel, mparams                        # frees deepseek-moe's 32.8 GB
    free_card()
    mark("serve_long (e) deepseek-moe-16b")
    moe_held_err = hold_window_shapes(mshapes, "hold_moe_flash")
    hold_long_paged(card, mcfg.name, "hold_long_moe", same_chunks=True)
    mark("hold_long_moe")
    ocfg, omodel, oparams, oeng, moon_launches, oshapes = serve_moe_model(
        SERVE_MOONSHOT["arch"], SERVE_MOONSHOT["seed"], card,
        "serve_moonshot")
    del oeng
    free_card()
    long_moe[ocfg.name] = serve_long_moe(card, ocfg, omodel, oparams,
                                         "serve_long_moonshot", profile=True)
    del omodel, oparams                        # frees moonshot's 56.8 GB
    free_card()
    moon_held_err = hold_window_shapes(oshapes, "hold_moonshot_flash")
    mark("serve_moe, serve_long (f) (moonshot-v1-16b-a3b)")
    rec = phase_serve_recurrent(card)
    rec_held_err = hold_window_shapes(
        set().union(*(r["shapes"] for r in rec.values())),
        "hold_recurrent_flash")
    mark("serve_recurrent")
    vlm_launches, vlm_shape = phase_vlm(card)
    free_card()
    mark("vlm")
    counts_4k = counts_4k.result()
    train = phase_train(card, TRAIN, counts_4k.get(TRAIN["arch"]))
    free_card()
    mark("train granite-20b")
    trains = []
    for c in TRAIN_FAMILIES:
        trains.append(phase_train(card, c, counts_4k.get(c["arch"])))
        free_card()
        mark(f"train {c['arch']}")
    for arch in TRAIN_4K["archs"]:
        small_train(arch, SMALL_TRAIN_4K, hosts_4k[arch].result())
    mark("small at 4096")
    dry_a = dryrun_train(card, train)
    dry_s = dryrun_sizes(card, sizes.result())
    host_pool.shutdown()
    mark("dryrun (a), (c), (d)")
    par = phase_parallel(card)
    mark("parallel")
    flash_rows = phase_timing(cfg, shapes)
    window_rows = timing_window(wcfg)
    train_row = time_flash(*train["shape"][:3], train["shape"][3],
                           train["shape"][4], None,
                           "granite-20b's train step, one microbatch")
    # granite-20b's train_4k tensor-parallel rank on the model axis of 16:
    # its 3 query heads over the one KV head, causal S 4096
    tp_cfg = configs.get("granite-20b")
    tp_row = time_flash(1, tp_cfg.q_heads // TP_LAYER["model"],
                        tp_cfg.num_kv_heads, TP_LAYER["seq"],
                        tp_cfg.head_dim, None,
                        "granite-20b's train_4k rank, model axis 16")
    # qwen3-32b's prefill_32k tensor-parallel rank on the model axis of 16
    # (2 rows, its 4 query heads over the one KV head they read, causal S
    # 32768): the parallel phase's tp_serve (b) launched it once a rank
    ts_cfg = configs.get(TP_SERVE["prefill_arch"])
    tp_serve_row = time_flash(
        TP_SERVE["prefill_rows"], ts_cfg.q_heads // TP_SERVE["model"], 1,
        TP_SERVE["prefill_seq"]["bfloat16"], ts_cfg.head_dim, None,
        "qwen3-32b's prefill_32k rank, model axis 16")
    # zamba2-1.2b's tensor-parallel rank on the model axis of 16 (2 of 32
    # heads over their 2 KV heads, causal): train_4k's [1, 4096] and
    # prefill_32k's [2, 32768]; the parallel phase's tp_recurrent (e) in
    # bf16 launched each once a rank
    z_cfg = configs.get("zamba2-1.2b")
    z_h = z_cfg.num_heads // TP_RECURRENT["model"]
    z_rows = {(b, s): time_flash(
        b, z_h, z_h, s, z_cfg.head_dim, None,
        f"zamba2-1.2b's {'train_4k' if b == 1 else 'prefill_32k'} rank, "
        f"model axis 16")
        for b, s, _ in TP_RECURRENT["prefill"]}
    # deepseek-moe-16b's largest serve prefill (the 256 bucket, cold, over
    # the 512-position cache view) and internvl2-76b's forward
    moe_top = max(mshapes, key=lambda sh: (sh[3], -sh[8]))
    moe_row = time_flash(1, mcfg.num_heads, mcfg.num_kv_heads, moe_top[3],
                         mcfg.head_dim, None,
                         "deepseek-moe-16b's largest serve prefill",
                         t=moe_top[4], off=moe_top[8])
    vlm_row = time_flash(1, vlm_shape[1], vlm_shape[2], vlm_shape[3],
                         vlm_shape[5], None,
                         "internvl2-76b's forward, 256 patches + 256 tokens")
    # moonshot-v1-16b-a3b's largest serve prefill, as deepseek-moe-16b's
    moon_top = max(oshapes, key=lambda sh: (sh[3], -sh[8]))
    moon_row = time_flash(1, ocfg.num_heads, ocfg.num_kv_heads, moon_top[3],
                          ocfg.head_dim, None,
                          "moonshot-v1-16b-a3b's largest serve prefill",
                          t=moon_top[4], off=moon_top[8])
    # each flash shape the train phase's other families gave the kernel
    # under the gradient, at one microbatch, with its launches in the loop
    train_rows = {}
    for r in trains:
        tag = r["arch"].split("-")[0]
        for sh, n in sorted(r["shapes"].items(), key=str):
            b, h, hkv, s, t, d, causal, win, off = sh
            part = ({True: "_decoder", False: "_encoder"}[causal]
                    if r["arch"] == "whisper-small" else "")
            name = f"flash_attention/wgmma/{tag}_train{part}"
            if name in train_rows:
                raise AssertionError(f"{r['arch']} trained on more flash "
                                     f"shapes than named: {r['shapes']}")
            train_rows[name] = (n, time_flash(
                b, h, hkv, s, d, win, f"{r['arch']}'s train step, one "
                f"microbatch" + (f" ({part[1:]})" if part else ""), t=t,
                off=off, causal=causal))
    for name, row in timing_train_4k([train] + trains).items():
        if name in train_rows:
            raise AssertionError(f"two flash rows named {name}")
        train_rows[name] = row
    # whisper-small's encoder (non-causal, 12:12, S = T = 1500) and
    # zamba2-1.2b's shared attention on a cold 256-token chunk (32:32 over
    # its 512-position cache row)
    whisper_cfg = rec["whisper-small"]["model"]
    whisper_row = time_flash(1, whisper_cfg.num_heads,
                             whisper_cfg.num_kv_heads, whisper_cfg.enc_seq,
                             whisper_cfg.head_dim, None,
                             "whisper-small's encoder", causal=False)
    zamba_cfg = rec["zamba2-1.2b"]["model"]
    zamba_row = time_flash(1, zamba_cfg.num_heads, zamba_cfg.num_kv_heads,
                           256, zamba_cfg.head_dim, None,
                           "zamba2-1.2b's shared attention, a cold "
                           "256-token chunk", t=SERVE_RECURRENT["max_seq"])
    long_rows = timing_long(long_serves | long_moe)
    ffma_row = timing_flash_f32(f32_shape)
    stream_rows = timing_stream(errs)
    dpa_rows = timing_dpa(errs)
    # the paper's Fig. 5/7 ladder (FMA -> DPA2 -> DPA4) at 4096^3
    log("[timing] ladder at 4096^3, Top/s by events / by device time: "
        + ", ".join(f"{v} {2 * 4096 ** 3 / r['ms'] / 1e9:.1f} / "
                    f"{2 * 4096 ** 3 / r['device_ms'] / 1e9:.1f}"
                    for v, r in ((v, dpa_rows[(f"dpa_matmul/{v}", 4096)])
                                 for v in DPA_IN)))
    transpose_row = timing_transpose(
        errs, dpa_rows[("dpa_matmul/dpa4", 4096)]["transpose_device_ms"])
    mark("timing")
    phase_cli()
    mark("cli")
    phase_record_cli()
    mark("record_cli")
    t_gate = time.perf_counter()
    gate_rcs = dryrun_gate()
    log(f"[dryrun] phase: (a) train FLOPs {dry_a['flops']:.6e} equal on meta "
        f"and the card, {dry_a['launches']} flash launches, peak dry-run "
        f"{dry_a['dry_peak'] / 1e9:.3f} GB vs card "
        f"{dry_a['peak'] / 1e9:.3f} GB, compute / memory terms "
        f"{dry_a['compute_ms']:.1f} / {dry_a['memory_ms']:.1f} ms; (b) "
        f"decode FLOPs {dry_b['flops']:.6e} equal, memory term "
        f"{dry_b['memory_ms']:.2f} ms vs device busy {dry_b['busy_ms']:.2f} "
        f"ms; (c), (d) in {dry_s:.1f} s; (e) gate {gate_rcs}; the phase's "
        f"dry-run work {dry_a['seconds'] + dry_b['seconds'] + dry_s + time.perf_counter() - t_gate:.1f} s "
        f"(budget {DRYRUN['budget_s']:.0f} s; the card steps of (a) and (b) "
        f"not included); card: {card}")
    # flash on each route at its own path's shape: wgmma at the serve's
    # largest prefill (bf16), launches from the serve phase; ffma at the
    # f32 smoke model's prefill, launches from that model (its bf16 times
    # at the serve shapes are in the log); ms, plain and library by CUDA
    # events, the device times beside them; each error the largest over
    # the kernels phase and the timing shapes
    top = max(flash_rows["wgmma"], key=lambda r: (r["s"], r["q_offset"]))
    top["timed_at"] = (
        f"bf16 q[1,{cfg.num_heads},{top['s']},{cfg.head_dim}] "
        f"kv[1,{cfg.num_kv_heads},{top['t']},{cfg.head_dim}] q_offset "
        f"{top['q_offset']} (the serve's largest prefill)")
    timed = {"wgmma": (launches["flash_attention/wgmma"], top),
             "ffma": (f32_launches, ffma_row)}
    kernels = []
    for route, (n, top) in timed.items():
        kernels.append({
            "name": f"flash_attention/{route}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": n,
            "max_abs_err": max([flash_errs[route], top["max_abs_err"]]
                               + [r["max_abs_err"]
                                  for r in flash_rows[route]]),
            **flash_keys(top),
        })
    # the same wgmma route on gemma3-27b's serve: its local layers (window
    # 1024) and its global layers (causal), each timed at S 2048 and
    # counted over that serve
    for tag, win in (("window", 1024), ("global", None)):
        row = window_rows[win]
        kernels.append({
            "name": f"flash_attention/wgmma/gemma3_{tag}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": wlaunches[tag],
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"],
                               held_err),
            **flash_keys(row),
        })
    # the same wgmma route under the train phase's gradient: granite-20b's
    # 4 layers x 2 microbatches x 6 steps, each a forward and a remat
    # recompute, timed at one microbatch's shape
    kernels.append({
        "name": "flash_attention/wgmma/granite_train",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/"
                    "flash_attention.py:22",
        "launches": train["launches"],
        # the dryrun phase's counted step (one step of the same
        # configuration through ShardedTrainStep on a one-device RankMesh
        # under the op counter) launched flash this often, all wgmma
        "dryrun_launches": dry_a["launches"],
        "max_abs_err": max(flash_errs["wgmma"], train_row["max_abs_err"]),
        **flash_keys(train_row),
    })
    # the same wgmma route at granite-20b's train_4k tensor-parallel rank
    # (q [1,3,4096,128] over one KV head): the parallel phase's tp_layer
    # check in bf16 launched it once a rank
    kernels.append({
        "name": "flash_attention/wgmma/granite_tp_rank",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/"
                    "flash_attention.py:22",
        "launches": par["tp"]["granite-20b"]["bfloat16"]["launches"],
        "tp_layer_rel_err": {a: {d: r["rel"] for d, r in v.items()}
                             for a, v in par["tp"].items()},
        "max_abs_err": max(flash_errs["wgmma"], tp_row["max_abs_err"]),
        **flash_keys(tp_row),
    })
    # the same wgmma route at qwen3-32b's prefill_32k tensor-parallel rank
    # (q [2,4,32768,128] over one KV head, the cache split over sequence):
    # the parallel phase's tp_serve (b) in bf16 launched it once a rank
    kernels.append({
        "name": "flash_attention/wgmma/qwen3_tp_serve_rank",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/"
                    "flash_attention.py:22",
        "launches": par["tp_serve"]["prefill"]["bfloat16"]["launches"],
        "tp_serve_rel_err": {
            "decode": par["tp_serve"]["decode"],
            "prefill": {d: r["rel"] for d, r in
                        par["tp_serve"]["prefill"].items()},
            "moe": par["tp_serve"]["moe"]},
        "max_abs_err": max(flash_errs["wgmma"],
                           tp_serve_row["max_abs_err"]),
        **flash_keys(tp_serve_row),
    })
    # the same wgmma route at zamba2-1.2b's tensor-parallel rank (2 of 32
    # heads, D 64, MHA): train_4k's q [1,2,4096,64] and prefill_32k's
    # [2,2,32768,64], each launched once a rank by the parallel phase's
    # tp_recurrent (e) in bf16
    rec_tp = par["tp_recurrent"]
    for (b, s), row in z_rows.items():
        kernels.append({
            "name": "flash_attention/wgmma/zamba2_tp_"
                    + ("train_rank" if b == 1 else "prefill_rank"),
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": rec_tp["prefill"][(b, s, "bfloat16")]["launches"],
            "tp_recurrent_rel_err": {
                "layers": rec_tp["layers"], "long_500k": rec_tp["long"],
                "prefill": {f"{pb}x{ps} {dt}": r["rel"] for (pb, ps, dt), r
                            in rec_tp["prefill"].items()}},
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"]),
            **flash_keys(row),
        })
    # the same wgmma route on the MoE and VLM paths: deepseek-moe-16b's
    # serve (28 layers x prefills) and internvl2-76b's forward and text
    # serve (32 layers x calls)
    for tag, n, row, held in (("deepseek_moe", moe_launches, moe_row,
                               moe_held_err),
                              ("moonshot", moon_launches, moon_row,
                               moon_held_err),
                              ("internvl2_vlm", vlm_launches, vlm_row, 0.0)):
        kernels.append({
            "name": f"flash_attention/wgmma/{tag}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": n,
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"],
                               held),
            **flash_keys(row),
        })
    # the same wgmma route on the recurrent families' serves, head dim 64
    # and MHA: whisper-small's (its encoder's non-causal launches and its
    # decoder's causal ones; timed at the encoder's shape) and zamba2-1.2b's
    # shared attention (timed at a cold 256-token chunk)
    for tag, arch, row in (("whisper_small", "whisper-small", whisper_row),
                           ("zamba2", "zamba2-1.2b", zamba_row)):
        kernels.append({
            "name": f"flash_attention/wgmma/{tag}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": rec[arch]["launches"],
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"],
                               rec_held_err),
            **flash_keys(row),
        })
    # the same wgmma route under the train phase's gradient for the other
    # families (zamba2-1.2b, whisper-small's encoder and decoder,
    # deepseek-moe-16b, internvl2-76b; xlstm-1.3b launches none) and for
    # the train_4k runs at 4096, each timed at one microbatch's shape and
    # counted over its loop
    for name, (n, row) in train_rows.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": n,
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"]),
            **flash_keys(row),
        })
    # the same wgmma route on serve_long's 32k serves: each shape timed
    # and held (absolutely and row by row) and counted over the serve that
    # gave it
    for name, (n, row) in long_rows.items():
        kernels.append({
            "name": f"flash_attention/wgmma/{name}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:22",
            "launches": n,
            "max_abs_err": max(flash_errs["wgmma"], row["max_abs_err"]),
            **flash_keys(row),
        })
    # STREAM at 128 MiB f32, dpa_matmul at 4096^3; each error is the
    # largest over every case the kernel was held at
    for name, line in STREAM_REPLACES.items():
        kernels.append(dict(name=name, route="cuda",
                            source="src/repro_torch/csrc/stream.cu",
                            replaces=f"src/repro/kernels/stream/stream.py:"
                                     f"{line}",
                            launches=launches[name],
                            **stream_rows[name]))
    for name in DPA_NAMES:
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/dpa_matmul.cu",
            replaces="src/repro/kernels/dpa_matmul/dpa_matmul.py:42",
            launches=launches[name],
            **dpa_rows[(name, 4096)]))
    # the transpose that dpa4's wgmma route runs before each product: no
    # TPU kernel of its own, half of the port of dpa_matmul's dpa4 variant
    kernels.append(dict(
        name=TRANSPOSE_NAME, route="cuda",
        source="src/repro_torch/csrc/dpa_matmul.cu",
        replaces="src/repro/kernels/dpa_matmul/dpa_matmul.py:42",
        part_of="dpa_matmul/dpa4",
        launches=launches[TRANSPOSE_NAME], **transpose_row))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
