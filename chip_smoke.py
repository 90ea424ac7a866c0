"""Drive the PyTorch port's division unit, its conformance grid, LM serving
(dense, sliding-window, MoE, SSM, hybrid, encoder-decoder, embedding-input),
attention, the ILM and LM training on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--seed N] [--json PATH]

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc per
source, in parallel), then runs, each phase printing one line:

  1. device    — torch/CUDA versions, the card, the kernel build time;
  2. kernels   — each kernel against its plain PyTorch version on the card,
                 2^22 seeded inputs per schedule, bit for bit;
  3. golden    — the reference's committed golden stores through the port
                 on the card, 0 int ulp (every cell, recip/ilm included);
                 then the port's generators on the card into build/golden:
                 every array of the reciprocal, divide and rsqrt stores
                 equal to the committed one, the softmax store's int-ulp
                 distance on its oracle-normal lanes reported (<= 16);
  4. gradients — autograd through div and rsqrt, against the analytic rule
                 evaluated with the plain versions on the card;
  5. kmeans    — K-Means at N=10^6, D=128, K=1024, 10 Lloyd steps (an
                 IVF1024 coarse-quantizer training step at SIFT1M's shape),
                 kernel modes against the exact twin;
  6. qr        — batched Givens QR, 4096 matrices of 64 x 64, via div and
                 via rsqrt, against the exact twin;
  7. calls     — each kernel call site of phases 5-6 once more, on that
                 phase's inputs and through the same entry point, held bit
                 for bit against the plain version (the whole 10^6 x 1024
                 distance plane included, in chunks of 2^26 lanes);
  8. consumers — the softmax and RMSNorm kernels against their plain
                 versions on the consumer corpora (D = 128, 768, 2048, 2176,
                 f32 and bf16, edge rows included; RMSNorm's weight in f32
                 and in bf16), bit for bit, and the
                 consumer gates (row sums, distance from the exact twin,
                 masked rows);
  9. serve     — paper_fpdiv at full width (bf16 params from --seed) served
                 in taylor_pallas: generate_batch over 8 prompts of 2048 ..
                 256 tokens, 64 new tokens each, and serve() with 4 slots
                 over the same requests, 32 new tokens each; the same batch
                 under mode="exact"; timings; the greedy agreement with
                 the exact twin gated as tests/test_decode_equiv.py gates
                 it (teacher-forced, f32 params: the same seeded weights
                 before their bf16 rounding) and reported in bf16;
  9a. conformance — the port's quick conformance grid (eval/conformance.py)
                 on the card: every cell through its mode (the kernel modes
                 through the tsdiv, softmax and RMSNorm kernels) must pass its
                 gate; the max-ulp column per cell is printed;
  9b. serve_swa — gemma3_12b at full width (48 layers, 5:1 sliding-window to
                 global, W = 1024; bf16 params from --seed) in taylor_pallas:
                 generate_batch over 4 prompts of 2048, 1536, 1024 and 512
                 tokens, 32 new each, its launches held to 48 softmax and 97
                 RMSNorm per forward; the exact twin on the same batch;
                 serve() with 2 slots against generate_batch (>= 99% of
                 tokens); a serve_calls line: every softmax and RMSNorm call
                 of one prefill and one decode step held bit for bit to its
                 plain version; the f32 greedy gate against the exact twin at
                 12 layers (two periods);
  9c. serve_moe — deepseek_moe_16b at full width (28 layers, 64 experts top-6
                 + 2 shared) the same way: 55 softmax (router included), 57
                 RMSNorm and 27 reciprocal launches per forward; the timed run
                 at the config's capacity factor 1.25, the gates (serve(), the
                 f32 twin at 4 layers) at 8.0, drop-free;
  9d. serve_ssm — mamba2_780m at full width and depth (48 Mamba-2 layers,
                 d_inner 3072, 48 heads x 64, state 128) the same way: 97
                 RMSNorm launches per forward (48 block norms, 48 gated
                 norms over d_inner, the final one), no softmax; the f32
                 gates at full depth, serve() against generate_batch among
                 them (in bf16 the batch shape's GEMM rounding flips greedy
                 tokens of this random-init model: reported);
  9e. serve_hybrid — jamba_1_5_large at full width, its first 5 layers (4
                 Mamba, 1 attention; 2 MoE FFNs of 16 experts top-2): 15
                 RMSNorm, 3 softmax (1 attention, 2 routers), 2 reciprocal;
                 timed at capacity factor 1.25, bf16 serve() reported there;
                 the f32 gates at 2 layers (Mamba + dense, Mamba + MoE),
                 capacity factor 8, over prompts of 512 and 256 tokens;
  9f. serve_encdec — whisper_tiny at full width and depth (4 + 4 layers)
                 on 4 x 1500 encoder frames from --seed, decoder prompts of
                 384, 256, 128 and 64 tokens: prefill 12 softmax (encoder,
                 self, cross) and 22 RMSNorm, decode 8 and 13; serve()
                 refuses as the reference's; the f32 gate at full depth;
  9g. serve_vlm — llava_next_mistral_7b's backbone at full width and depth
                 (32 layers, d 4096) on prompt embeddings from --seed of
                 MODEL_LENS tokens: 32 softmax, 65 RMSNorm; serve() refuses;
                 the f32 gate at full depth;
 10. serve calls — every softmax and RMSNorm call of one prefill and one
                 decode step, made again on its own inputs through the same
                 entry point, held bit for bit against the plain version;
 11. flash     — the flash-attention kernels against their plain versions
                 on a corpus of (BH, S, hd) shapes (ragged S included),
                 causal or not, three schedules, early skip on and off: f32
                 (CUDA cores) bit for bit, bf16 (tensor cores) under the
                 gate of kernels/flash_attention.tc_gate (every lane within
                 one bf16 ulp + 2^-16 max|v|, >= 99% of lanes identical;
                 the identical share and the worst excess are printed);
                 then the reference's attention gates on the card (every
                 mode against the exact twin, ragged S, the ILM window, the
                 f64 oracle);
 12. flash serve — division_modes.attention at full width on paper_fpdiv's
                 own layer-0 q/k/v (the served batch of phase 9, (96, 2048,
                 64) bf16) in taylor_pallas and goldschmidt_pallas, and once
                 at S = 1000, through the bf16 kernel: gated against the
                 plain version on 8 of the 96 heads, vs the model's
                 materialised-score attention at every request's valid
                 positions, peak memory; then the same q/k/v in f32 through
                 the f32 kernel, bit for bit on the 8 heads;
 13. ilm       — ops.ilm_mul / ilm_square on 2^24 seeded operand pairs below
                 2^16 (edges 0, 1, 2^16 - 1 included) at iters 1, 2, 3, 4,
                 6, 8, 16: kernel vs plain version bit for bit, a*b exactly
                 at the exact bound, and the accuracy table; then both
                 kernels on 2^22 operands (pairs) over all of uint32 at
                 iters 1-32 against their plain versions' stage loop;
 13a. train    — paper_fpdiv trained at full width and depth (bf16 params
                 from --seed) in taylor_pallas through train.loop.run: 8
                 steps of 32 x 2048 SyntheticLM tokens from --seed in 2
                 microbatches of 16, remat on; its launches held to 48
                 softmax, 98 RMSNorm (the final norm is not recomputed) and
                 one tsdiv_recip per parameter leaf (111) a step; the loss
                 must fall by 0.3; step time, tokens/s, peak memory;
 13b. train calls — one more step with every softmax, RMSNorm and AdamW
                 reciprocal call held bit for bit to its plain version on
                 its own inputs, each remat recompute to its forward; AdamW
                 on that step's grads against its exact twin on f32 copies
                 of the params (< 1e-6, tests/test_optim.py's gate), its
                 time in both modes, the exact twin's step, and one
                 microbatch's grads against the exact twin's (relative L2
                 per leaf, f32 copies; reported); then kill -> resume at
                 full width on 8 x 512 tokens: 6 steps straight against a
                 run killed before step 4 and resumed from its step-4
                 checkpoint, every leaf of the state equal;
 13b'. roofline — the train cell on the H100's roofline: the one-rank dry
                 run (launch/dryrun.py, fake CUDA tensors) of 13a's cell
                 gives FLOPs, HBM bytes, the roofline terms and the memory
                 estimate; exact gates: its FlopCounterMode count equals a
                 real step's on the card, its unit calls equal 13a's
                 launches a step (48 / 98 / 111), abstract_params' bytes the
                 parameters'; reports train_mfu (6ND over 989 TFLOP/s x the
                 measured step), roofline_share (t_step over the measured
                 step), bound, t_step, and the memory estimate beside the
                 measured peak;
 13c. mesh     — 2 ranks on the one card (spawned processes of one gloo
                 process group, launch.mesh.run_ranks), against this
                 process's single-process runs: the tiled ops
                 (ops.tsdiv_divide / recip / rsqrt) on a DTensor of the
                 K-Means plane's shape (10^6, 1024) split over 'data', one
                 launch a rank on its (500000, 1024) shard, no collective
                 (CommDebugMode), held to the plain version, the
                 single-process launch's bits (per-chunk checksums);
                 kmeans_sharded on the K-Means cell (assignments equal,
                 centroids within 1 int ulp, inertia within 1e-6, the
                 centroid divides held to plain); qr_givens_sharded on
                 4096 x 64 x 64 both ways, bit-equal to the batched run
                 (position-weighted fingerprints of Q and R a rank);
                 then 4 more ranks: paper_fpdiv trained on a ("pod",
                 "model") = (2, 2) mesh (heads, MLP and vocab split over
                 model) with compress_axis="pod", 2 steps of 4 x 2048
                 tokens a pod: each leaf bit-equal on the ranks that hold
                 its block after every step, step 1's int8 mean within
                 max|g'_block|/127 + 1e-6 of the exact f32 mean (the max
                 over the rank's blocks of a stack of layers: one scale a
                 block), 24 softmax / 49 RMSNorm / 111 reciprocal launches
                 a step and rank, every reciprocal held to plain, the
                 error tree stored as blocks;
 13d. tp       — tensor parallelism over the model axis (models/parallel.py),
                 its ranks sharing the card over gloo (every all-reduce
                 through host copies: not a speed figure): llama3_8b at
                 full width, cut to TP_SERVE_DEPTH (4) layers, on (data 1,
                 model 2) in bf16 (the ranks' blocks drawn from --seed):
                 generate_batch over MODEL_LENS prompts, TP_NEW (16) new
                 tokens each, 4 softmax and 9 RMSNorm launches a forward
                 and rank, every call of one
                 prefill and one decode step held bit for bit to its plain
                 version, tokens against this process's unsharded run
                 (reported); in f32 at TP_F32_DEPTH layers the gate of
                 test_decode_equiv against the unsharded run (>= 99% of
                 teacher-forced tokens, logit drift < 5e-3) and serve()
                 with 2 slots against generate_batch; then paper_fpdiv
                 trained on (data 2, model 2), 2 steps of 8 x 2048 tokens,
                 2 microbatches a data rank: 48 softmax / 98 RMSNorm / 111
                 reciprocal launches a step and rank, every call of step 1
                 held to plain on rank 0, replicated leaves bit-equal on
                 all 4 ranks and split blocks on the data peers after
                 every step, and one f32 step against the single-process
                 step (loss within 1e-5 relative, the state within
                 tests/test_torch_tensor_parallel.py's bounds). The
                 sequence layouts: on the f32 serving ranks llama3_8b's
                 seq_shard prefill (logits against the unsharded run,
                 drift < 5e-3; its time beside the base layout's) and the
                 kvseq teacher-forced decode (the f32 gate; 12 split
                 softmax launches a step, 3 passes a layer), every kernel
                 call of one
                 prefill and one decode step of each held to plain; the
                 same f32 step under seq_shard against the single process;
                 then the seq part on the training ranks: gemma3_12b at
                 full width cut to 6 layers, f32, batch 1, a cache of
                 524288 slots split by sequence over data (long_500k's
                 layout) on (2, 2), 4 teacher-forced decode steps at the
                 cache's last positions over seeded K/V against this
                 process's unsharded run (every token, drift < 5e-3), a
                 512-token generate equal to the unsharded run's (rank
                 data 1's slots all masked), 13 RMSNorm and 18 split
                 softmax launches a step and rank, every call held to
                 plain; the same steps under each planted fault of the
                 combine (a rank's probs @ V partial dropped; each rank's
                 own sum) must fail that gate;
 13e. ep       — (run third, after golden: its 4 ranks need most of the
                 card) expert parallelism (models/moe.py over
                 models/parallel.py's plan), 4 ranks sharing the card over
                 gloo: deepseek_moe_16b
                 at full width, cut to 14 layers, on (data 2, model 2) in
                 bf16, its 64 experts on data (32 a rank) and expert_mlp
                 on model (the ranks' blocks drawn from --seed):
                 generate_batch over 4 prompts of 512 .. 128 tokens, 4 new
                 each, 27 softmax / 29 RMSNorm / 13 reciprocal launches a
                 forward and rank,
                 every call of one prefill and one decode step held bit for
                 bit to its plain version on each rank; in f32 at 4 layers
                 (capacity factor 8) the gate of test_decode_equiv against
                 this process's unsharded run and serve() against
                 generate_batch; then deepseek trained at full width cut to
                 2 layers on (2, 2), its AdamW moments in bf16 (the four
                 ranks' states share the card), the batch split over data
                 (the expert exchange: all-to-all and all-gather over
                 data), 2 steps, the launches a step from the code, every
                 call of step 1 held to plain on rank 0, each leaf
                 bit-equal on the ranks that hold the same block; one f32
                 step at 2 layers against the single-process step (loss, m
                 and v at the tp phase's bounds, the parameters where the
                 gradient's sign is resolved, PERF.md §6); the
                 collectives' share of the prefill, the decode steps and
                 the train steps;
 13f. tp_ssm   — (run fourth, after ep) the Mamba-2 mixer split by heads
                 over the model axis (models/mamba2.py over
                 models/parallel.py's plan), its ranks sharing the card
                 over gloo: mamba2_780m at full width cut to 24 layers on
                 (data 1, model 2) in bf16: generate_batch over 4 prompts
                 of 512 .. 128 tokens, 4 new each, 49 RMSNorm launches a
                 forward and rank, every call of one prefill and one
                 decode step held to plain on each rank; in f32 at 24
                 layers the gate of test_decode_equiv
                 against this process's unsharded run and serve() against
                 generate_batch; jamba_1_5_large under its own rules on
                 (data 2, model 2), its embed leaves stored as blocks over
                 data and gathered before use (FSDP), experts on data:
                 at its 5-layer cut in bf16 generate_batch over prompts of
                 512 and 256, 1 new token, 3 softmax / 15 RMSNorm / 2
                 reciprocal launches a forward and rank, the all-gathers'
                 and reduce-scatters' shares, every call of one prefill
                 and one decode step held to plain; its prefill logits at
                 2 layers bit for bit against the same mesh with embed
                 whole; trained at 1 layer (Mamba + dense FFN), one bf16
                 step (bf16 moments) and one f32 step against the
                 single-process step under l2_gate; then mamba2_780m
                 trained at full width cut to 6 layers on (2, 2), 2
                 steps of 8 x 256 tokens split over data, f32 moments,
                 the launches a step from the code, every call of step 1
                 held to plain on rank 0, each leaf bit-equal on the ranks
                 that hold the same block; one f32 step at 8 layers
                 against the single-process step, leaf by leaf in the L2
                 norm; the
                 collectives' share of the prefill, the decode steps and
                 the train steps;
 14. ilm serve — paper_fpdiv at full width in mode="ilm", teacher-forced
                 against the exact twin in f32 over 4 prompts of 2048 ..
                 512 tokens, 8 steps (reported, not gated);
 15. times     — each kernel, its plain version and the torch yardstick: the
                 tsdiv kernels on the K-Means distance plane, softmax and
                 RMSNorm at the serving prefill and decode shapes, flash
                 attention at (96, 2048, 64) causal in bf16 and in f32, the
                 ILM multiplier and squarer on 2^24 lanes at iters 16 and 4,
                 the SWA and MoE models' shapes: softmax on deepseek's router rows
                 (8192, 64) and gemma's sliding-window rows (131072, 2048),
                 RMSNorm at (8192, 3840) bf16, the reciprocal of the (8192,)
                 top-k sums; and the SSM, hybrid and encoder-decoder models'
                 shapes: RMSNorm on mamba2's
                 gated-norm rows (8192, 3072) and (4, 3072) and jamba's
                 (8192, 16384), bf16 with an f32 weight; softmax on jamba's
                 router rows (8192, 16) and whisper's 1500-key encoder and
                 cross rows; and tsdiv_recip on one train step's 111
                 AdamW denominators (134.1 M lanes) beside torch.reciprocal;
                 and the tiled kernels at the mesh phase's shard shape
                 (rank 0, the other rank idle); the split softmax kernel's
                 three passes on rank 0's rows of the seq part's global
                 and sliding-window layers, (8, 262144) and (8, 512), and of
                 the tp part's kvseq decode, (128, 1032), each pass's device
                 ms beside their sum, beside torch.softmax of the same rows.
                 Times are CUDA events over back-to-back wrapper calls
                 (``ms``, which holds the wrapper's host time where a kernel
                 is shorter); softmax, RMSNorm, flash attention and the ILM
                 kernels also give ``device_ms``, their kernel's own device time
                 from torch.profiler, and ``library_device_ms`` (flash: also
                 ``library_kernels``, the device kernels of the SDPA call).

Phases 4-6, 9, 9a-9g, 12, 13, 13a, 13c, 13d, 13e and 13f are the main path: launch counts are reset before
each and read after it. The command's wall time, the build included, is
printed on a ``wall`` line, and each phase line carries ``at_s``, the
seconds since the script started. Any failed check raises, and the script then exits non-zero
without printing a result. It needs a CUDA card and the repository around
it; it imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet, at the 700 W limit
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# No data-sheet figure: 132 SMs x 64 INT32 lanes (half the 128 FP32 lanes
# behind the 67 TFLOP/s, which counts an fma as two) x 1.98 GHz boost.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_TC_OPS_PER_S = 989e12    # H100 SXM dense bf16 on the tensor cores
# f32 operations per element of each timed body (n_iters=2, factored;
# newton_iters=2), an fma counting two: counted from csrc/tsdiv_body.cuh.
# softmax: max, sub, exp (~10 in libdevice), add, mul; rmsnorm: x*x, add,
# x*r, *w. Per-row work (the reciprocal, the rsqrt, the trees) is left out.
# flash attention (both kernels): per (query, key, d) triple of the causal
# pairs, one multiply-add in QK^T and one in PV (the bf16 kernel's second PV
# mma, for p's low half, is its design's cost, not the work). The ILM
# squarer (the closed form x*x - r*r) per lane: a popcount, a compare and
# x*x; on lanes whose popcount exceeds iters also ILM_SQUARE_RESIDUE_OPS
# (r*r, the subtract) and ILM_STEP_OPS per step of its residue loop (a step
# and its loop test; iters steps, as csrc/ilm.cu residue() runs them),
# counted on this run's operands (ilm_square_ops).
# The ILM multiplier (the closed form x*y - rx*ry) per lane: two
# popcounts, two compares, x*y, rx*ry and the subtract; per operand whose
# popcount exceeds iters also ILM_STEP_OPS per step (ilm_mul_ops). The
# stage loops they replaced counted ILM_SQUARE_STAGE_OPS / ILM_MUL_STAGE_OPS
# per stage (csrc/ilm.cu's earlier kernels: the loop tests, the leading-zero
# counts, the leading ones and residues, the guarded shifts and the
# accumulate); the times rows give that bound too.
OPS_PER_ELEMENT = {"tsdiv_divide": 52, "tsdiv_recip": 29, "tsdiv_rsqrt": 50,
                   "softmax_f32": 14, "softmax_split_f32": 14, "rmsnorm_f32": 4, "flash_attention_f32": 4,
                   "flash_attention_bf16": 4, "ilm_mul_u32": 7, "ilm_square_u32": 3}
ILM_SQUARE_RESIDUE_OPS, ILM_STEP_OPS = 2, 3
ILM_SQUARE_STAGE_OPS, ILM_MUL_STAGE_OPS = 13, 22
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {"tsdiv_divide": CSRC + "tsdiv.cu", "tsdiv_recip": CSRC + "tsdiv.cu",
           "tsdiv_rsqrt": CSRC + "tsdiv.cu", "softmax_f32": CSRC + "softmax.cu",
           "softmax_split_f32": CSRC + "softmax.cu",
           "rmsnorm_f32": CSRC + "rmsnorm.cu",
           "flash_attention_f32": CSRC + "flash_attention.cu",
           "flash_attention_bf16": CSRC + "flash_attention_tc.cu",
           "ilm_mul_u32": CSRC + "ilm.cu", "ilm_square_u32": CSRC + "ilm.cu"}
REPLACES = {"tsdiv_divide": "src/repro/kernels/tsdiv.py:199",
            "tsdiv_recip": "src/repro/kernels/tsdiv.py:122",
            "tsdiv_rsqrt": "src/repro/kernels/tsdiv.py:147",
            "softmax_f32": "src/repro/kernels/softmax.py:46",
            "softmax_split_f32": "src/repro/kernels/softmax.py:46",
            "rmsnorm_f32": "src/repro/kernels/rmsnorm.py:47",
            "flash_attention_f32": "src/repro/kernels/flash_attention.py:133",
            "flash_attention_bf16": "src/repro/kernels/flash_attention.py:133",
            "ilm_mul_u32": "src/repro/kernels/ilm.py:66",
            "ilm_square_u32": "src/repro/kernels/ilm.py:77"}
N_PLANE, D, K = 1_000_000, 128, 1024
PLAIN_ELEMENTS = 1 << 26
CONSUMER_DIMS = (128, 768, 2048, 2176)
SCHEDULES = ("paper", "factored", "goldschmidt")
SERVE_LENS = tuple(2048 - 256 * i for i in range(8))   # 2048, 1792, ..., 256
SERVE_NEW, SLOTS, SLOT_NEW = 64, 4, 32
FLASH_CORPUS = ((4, 128, 64), (2, 256, 64), (3, 1000, 64), (2, 384, 128), (2, 256, 32))
FLASH_PLAIN_HEADS = tuple(range(0, 96, 12))   # head 0 of each request at full width
ILM_LANES = 1 << 24
ILM_ITERS = (1, 2, 3, 4, 6, 8, 16)
ILM_FULL_RANGE_LANES = 1 << 22    # ILM operands over all of uint32, iters 1-32
ILM_TIMED_ITERS = (16, 4)
ILM_SERVE_NEW = 8                 # 32 on SERVE_LENS until the command outgrew its time limit
ILM_SERVE_LENS = SERVE_LENS[::2]  # 2048, 1536, 1024, 512
MODEL_LENS = (2048, 1536, 1024, 512)     # the model phases 9b-9e and 9g
MODEL_NEW, MODEL_SLOTS = 32, 2


@dataclasses.dataclass(frozen=True)
class Serving:
    """One served architecture: its phase line, the launches per forward
    from the code (``per_decode`` where a decode step's differ), the timed
    run's depth cut, the f32 gate's depth, capacity factor and prompt
    lengths (the timed ones when None), the prefill hand-off: ``enc``
    (encoder frames) or ``emb`` (prompt embeddings), and whether serve() is
    gated against generate_batch in f32 at the gate's depth (``f32_serve``;
    the bf16 full-width agreement is then reported) or in bf16."""
    phase: str
    arch: str
    per_forward: dict
    gate_depth: dict
    per_decode: dict | None = None
    depth: dict = dataclasses.field(default_factory=dict)
    gate_cf: float | None = None
    gate_lens: tuple | None = None
    lens: tuple = MODEL_LENS
    hand: str | None = None
    f32_serve: bool = False


# Launches per forward, from the code: one softmax per attention layer
# (sliding, global, encoder and cross alike, query-chunked at 2048 keys), one
# RMSNorm before each mixer, cross attention and FFN and the final one (an
# encoder adds its blocks' and its own final one); a MoE layer adds its
# router softmax and one reciprocal of the top-k sums; a Mamba mixer adds
# its gated RMSNorm over d_inner.
MOE_GATE_CF = 8.0                     # drop-free routing, as test_decode_equiv
SWA = Serving("serve_swa", "gemma3_12b", {"softmax_f32": 48, "rmsnorm_f32": 2 * 48 + 1},
              {"n_layers": 12})       # two 6-layer periods (5 sliding, 1 global)
MOE = Serving("serve_moe", "deepseek_moe_16b",
              {"softmax_f32": 28 + 27, "rmsnorm_f32": 2 * 28 + 1, "tsdiv_recip": 27},
              {"n_layers": 4}, gate_cf=MOE_GATE_CF, f32_serve=True)   # dense, 3 MoE
SSM = Serving("serve_ssm", "mamba2_780m", {"rmsnorm_f32": 2 * 48 + 1}, {},   # full depth
              f32_serve=True)
# jamba's first 5 layers: Mamba + dense, Mamba + MoE (twice), attention + dense.
HYBRID = Serving("serve_hybrid", "jamba_1_5_large",
                 {"softmax_f32": 1 + 2, "rmsnorm_f32": 2 * 5 + 4 + 1, "tsdiv_recip": 2},
                 {"n_layers": 2}, depth={"n_layers": 5}, gate_cf=MOE_GATE_CF,
                 gate_lens=(512, 256), f32_serve=True)
ENCDEC = Serving("serve_encdec", "whisper_tiny",
                 {"softmax_f32": 4 + 4 + 4, "rmsnorm_f32": (2 * 4 + 1) + (3 * 4 + 1)}, {},
                 per_decode={"softmax_f32": 4 + 4, "rmsnorm_f32": 3 * 4 + 1},
                 lens=(384, 256, 128, 64), hand="enc")   # the decoder's context is 448
VLM = Serving("serve_vlm", "llava_next_mistral_7b",
              {"softmax_f32": 32, "rmsnorm_f32": 2 * 32 + 1}, {}, hand="emb")
# The times phase's model shapes: (kernel, model phase, step, row length,
# rows where a length recurs, site).
MODEL_TIMES = [("softmax", "moe", "prefill", 64, None, "router"),
               ("softmax", "hybrid", "prefill", 16, None, "router"),
               ("softmax", "swa", "prefill", 2048, None, "swa_prefill"),
               ("softmax", "encdec", "prefill", 1500, 4 * 6 * 1500, "encoder"),
               ("softmax", "encdec", "prefill", 1500, 4 * 6 * 384, "cross"),
               ("rmsnorm", "swa", "prefill", 3840, None, "swa_prefill"),
               ("rmsnorm", "ssm", "prefill", 3072, None, "gated_norm"),
               ("rmsnorm", "ssm", "decode", 3072, None, "gated_norm"),
               ("rmsnorm", "hybrid", "prefill", 16384, None, "gated_norm"),
               ("recip", "moe", "prefill", 4 * 2048, None, "topk_sums")]   # (T,), flattened
DEVICE = "cuda"     # the phases of the serving slice run here


def sync() -> None:
    torch.cuda.synchronize()


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


T0 = time.perf_counter()     # at_s on each phase line: seconds since the script started


def say(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "at_s": time.perf_counter() - T0}), flush=True)


def corpus(n: int, seed: int) -> np.ndarray:
    """Random f32 bit patterns over all exponents, exponent fields 0, 1,
    253, 254 and 255 with random mantissas, and the IEEE edges."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**32, n - n // 4, dtype=np.uint64).astype(np.uint32)
    m = n // 4 - 16
    exp = rng.choice(np.array([0, 1, 253, 254, 255], np.uint32), m)
    man = rng.integers(0, 2**23, m, dtype=np.int64).astype(np.uint32)
    sign = rng.integers(0, 2, m).astype(np.uint32) << 31
    edges = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 2.0**-126,
                      2.0**-149, -(2.0**-140), 1.5 * 2.0**126, 2.0**127, 3.4e38,
                      -(2.0**-127), 0.5, 2.0], np.float32)
    return np.concatenate([bits.view(np.float32),
                           (sign | (exp << 23) | man).view(np.float32), edges])


def mismatch(got: torch.Tensor, want: torch.Tensor):
    """(lanes whose bits differ, nan matching nan; max |got - want| there)."""
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"kernel gave {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    same = (got.view(ints) == want.view(ints)) | (got.isnan() & want.isnan())
    bad = ~same
    if not got.numel():
        return 0, 0.0
    err = torch.where(bad, (got.float() - want.float()).abs().nan_to_num(nan=float("inf")), 0.0)
    return int(bad.sum()), float(err.max())


def held_to_plain(got: torch.Tensor, plain, *operands: torch.Tensor):
    """Compare a kernel's output with its plain version on the same
    (broadcast) operands, PLAIN_ELEMENTS lanes at a time, so that the plain
    version's temporaries fit at any size: (lanes differing, max abs err)."""
    flat = [t.reshape(-1) for t in torch.broadcast_tensors(*operands)]
    got = got.reshape(-1)
    n_bad, err = 0, 0.0
    for s in range(0, got.numel(), PLAIN_ELEMENTS):
        want = plain(*(t[s:s + PLAIN_ELEMENTS].contiguous() for t in flat))
        b, e = mismatch(got[s:s + PLAIN_ELEMENTS], want)
        n_bad, err = n_bad + b, max(err, e)
    return n_bad, err


def kmeans_data(seed: int, n: int = N_PLANE, d: int = D, k: int = K, device: str = "cuda"):
    from repro_torch.workloads import kmeans

    gen = torch.Generator(device=device).manual_seed(seed)
    x = kmeans.make_blobs(gen, n, d, k, device=device)
    return x, x[torch.randperm(n, generator=gen, device=device)[:k]].clone()


def qr_data(seed: int, shape=(4096, 64, 64), device: str = "cuda"):
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    return torch.randn(shape, generator=gen, device=device)


def event_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_launches(fn, reps: int = 10) -> dict:
    """{kernel or copy name: (device ms per call, launches recorded)} of
    ``fn`` from torch.profiler over ``reps`` calls after a warm-up. A name's
    time is its mean over the launches the profiler recorded of it times its
    launches a call (those recorded over ``reps``, rounded, at least 1), so
    a record the profiler lost moves no reading; a name it recorded no
    device time of is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / e.count * max(1, round(e.count / reps)),
                    e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and e.count}


def device_times(fn, reps: int = 10) -> dict:
    """{kernel or copy name: device ms per call} of ``fn``
    (:func:`device_launches`)."""
    return {name: ms for name, (ms, _) in device_launches(fn, reps).items()}


def summed_ms(times: dict, kernel: str | None = None):
    """The sum of ``times``' entries whose name holds ``kernel`` (all when
    None); None where there is none."""
    ms = [t for name, t in times.items() if kernel is None or kernel in name]
    return sum(ms) if ms else None


def device_ms(fn, kernel: str | None = None, reps: int = 10):
    """Device time per call of ``fn``: the kernels whose name holds
    ``kernel`` (every kernel and copy on the card when None). None where the
    profiler shows no device time for them."""
    return summed_ms(device_times(fn, reps), kernel)


def phase_device():
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    # Full f32 and bf16 matmuls: the reference's numbers, not TF32's.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    regs = {name: [line.strip() for line in log.splitlines() if "registers" in line]
            for name, log in _build.build_info.get("log", {}).items()}
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        nvidia_smi=smi, build_s=round(build_s, 3), ptxas=regs,
        allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        allow_bf16_reduced_precision_reduction=(
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction))
    return smi


def phase_kernels(seed: int):
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, tsdiv

    x = torch.from_numpy(corpus(1 << 22, seed)).cuda()
    a = torch.from_numpy(corpus(1 << 22, seed + 1)).cuda()
    table = compute_segments(2, 24)
    err = {k: 0.0 for k in tsdiv.LAUNCHES}
    rows = []
    for sched in ("paper", "factored", "goldschmidt"):
        for name, got, want in (
                ("tsdiv_recip", tsdiv.recip(x, 2, 24, sched),
                 common.recip_f32_bits(x, table, 2, sched)),
                ("tsdiv_divide", tsdiv.divide(a, x, 2, 24, sched),
                 common.divide_f32_bits(a, x, table, 2, sched))):
            n_bad, e = mismatch(got, want)
            rows.append((name, sched, n_bad))
            err[name] = max(err[name], e)
    n_bad, e = mismatch(tsdiv.rsqrt(x, 2, 16),
                        common.rsqrt_f32_bits(x, rsqrt_seed_table(16), 2))
    rows.append(("tsdiv_rsqrt", "newton2", n_bad))
    err["tsdiv_rsqrt"] = e
    torch.cuda.synchronize()
    say("kernels", elements=x.numel(), mismatched_lanes=rows, max_abs_err=err)
    check(all(r[2] == 0 for r in rows), f"kernel differs from its plain version: {rows}")
    return err


GOLDEN_OUT = ROOT / "build" / "golden"     # the generators' stores (build/ is gitignored)


def phase_golden():
    """The committed stores checked through the port on the card (0 int
    ulp), then regenerated there into GOLDEN_OUT: every array of the
    reciprocal, divide and rsqrt stores equal to the committed one, the
    softmax store's int-ulp distance on its oracle-normal lanes reported
    and held to golden.SOFTMAX_TOLERANCE_ULP."""
    from repro_torch.eval import golden

    failures = (golden.check(device="cuda") + golden.check_divide(device="cuda")
                + golden.check_rsqrt(device="cuda"))
    n = (len(golden.golden_cells()) + len(golden.golden_div_cells())
         + len(golden.golden_rsqrt_cells()))
    t0 = time.perf_counter()
    differing = {}
    for gen, committed in ((golden.generate, golden.GOLDEN_PATH),
                           (golden.generate_divide, golden.DIVIDE_PATH),
                           (golden.generate_rsqrt, golden.RSQRT_PATH)):
        path = gen(GOLDEN_OUT / committed.name, device="cuda")
        with np.load(path) as got, np.load(committed) as want:
            keys = [k for k in want.files if k != "meta"]
            # Bit patterns, so that a nan input is equal to itself.
            differing[committed.name] = {
                k: int((got[k].view(np.uint32) != want[k].view(np.uint32)).sum())
                if k in got.files else -1 for k in keys}
    golden.generate_softmax(GOLDEN_OUT / golden.SOFTMAX_PATH.name, device="cuda")
    drift = golden.softmax_drift(device="cuda")
    say("golden", cells=n, failures=failures, generated=str(GOLDEN_OUT),
        generated_arrays_differing=differing, generate_s=time.perf_counter() - t0,
        softmax_max_int_ulp={k: v["max_ulp"] for k, v in drift.items()},
        softmax_lanes_differing={k: v["lanes"] for k, v in drift.items()},
        softmax_tolerance_ulp=golden.SOFTMAX_TOLERANCE_ULP)
    check(not failures, f"golden cells drifted: {failures}")
    check(all(v == 0 for d in differing.values() for v in d.values()),
          f"a generated store differs from the committed one: {differing}")
    check(all(v["max_ulp"] <= golden.SOFTMAX_TOLERANCE_ULP for v in drift.values()),
          f"the softmax store drifted past {golden.SOFTMAX_TOLERANCE_ULP} int ulp: {drift}")


def phase_gradients(seed: int):
    from repro_torch.core import division_modes as dm
    from repro_torch.core.fpparts import finite_or_zero as finite
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common

    rng = np.random.default_rng(seed + 2)
    n = 1 << 20
    a = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    b = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    b[:4] = torch.tensor([0.0, -0.0, float("inf"), 1e-40])
    g = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    bad = {}
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        cfg = dm.DivisionConfig(mode=mode)
        sched = "factored" if mode == "taylor_pallas" else "goldschmidt"
        ta, tb = a.clone().requires_grad_(), b.clone().requires_grad_()
        dm.div(ta, tb, cfg).backward(g)
        rb = finite(common.recip_f32_bits(b, compute_segments(2, 24), 2, sched))
        q = finite(common.divide_f32_bits(a, b, compute_segments(2, 24), 2, sched))
        tx = b.abs().clone().requires_grad_()
        dm.rsqrt(tx, cfg).backward(g)
        r = finite(common.rsqrt_f32_bits(b.abs(), rsqrt_seed_table(16), 2))
        for key, got, want in (("da", ta.grad, g * rb), ("db", tb.grad, -(g * q * rb)),
                               ("dx", tx.grad, g * finite(-0.5 * r * r * r))):
            bad[f"{mode}/{key}"] = mismatch(got, want)[0]
            check(bool(torch.isfinite(got).all()), f"{mode} {key}: non-finite gradient")
    say("gradients", elements=n, mismatched_lanes=bad)
    check(not any(bad.values()), f"gradients differ from the plain versions: {bad}")


def phase_kmeans(seed: int, launches: dict):
    from repro_torch.core import division_modes as dm
    from repro_torch.eval import workload_metrics as wm
    from repro_torch.kernels import tsdiv
    from repro_torch.workloads import kmeans

    x, init = kmeans_data(seed)
    runs, out = {}, {}
    for mode in ("exact", "taylor_pallas", "goldschmidt_pallas"):
        # One warm-up step per mode (cuBLAS handles, allocator growth).
        kmeans.kmeans(x, cfg=dm.DivisionConfig(mode=mode), init=init, n_iters=1,
                      device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tsdiv.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = kmeans.kmeans(x, cfg=dm.DivisionConfig(mode=mode), init=init,
                                   n_iters=10, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tsdiv.LAUNCHES)
        out[mode] = {"ms_10_steps_plus_final_assignment": wall * 1e3, "launches": counts,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if mode != "exact":
            for k, v in counts.items():
                launches[k] += v
            check(counts["tsdiv_divide"] == 3 * 10 + 2,
                  f"{mode}: {counts['tsdiv_divide']} divide launches, expected 32")
    ex = runs["exact"]
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        r = runs[mode]
        out[mode]["inertia_rel_delta"] = wm.relative_delta(r.inertia.cpu().numpy(),
                                                           ex.inertia.cpu().numpy())
        out[mode]["assignment_agreement"] = float(
            (r.assignments == ex.assignments).float().mean())
        check(bool(torch.isfinite(r.centroids).all()), f"{mode}: non-finite centroids")
    say("kmeans", n=N_PLANE, d=D, k=K, n_iters=10,
        exact_inertia=float(ex.inertia), runs=out)
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        check(out[mode]["inertia_rel_delta"] <= 1e-4, f"{mode}: inertia gate")
        check(out[mode]["assignment_agreement"] >= 0.99, f"{mode}: assignment gate")


def _qr_residuals(q, r, a):
    from repro_torch.eval import workload_metrics as wm

    q, r, a = (t.double().cpu().numpy() for t in (q, r, a))
    rows = [wm.qr_residuals(q[i], r[i], a[i]) for i in range(a.shape[0])]
    return {k: max(row[k] for row in rows) for k in rows[0]}


def phase_qr(seed: int, launches: dict):
    from repro_torch.core import division_modes as dm
    from repro_torch.kernels import tsdiv
    from repro_torch.workloads import qr

    a = qr_data(seed)
    rotations = 64 * 63 // 2
    out = {}
    for via, want in (("div", {"tsdiv_divide": 2 * rotations}),
                      ("rsqrt", {"tsdiv_rsqrt": rotations})):
        q, r = qr.qr_givens_batched(a, dm.EXACT, via=via, device="cuda")
        exact = _qr_residuals(q, r, a)
        torch.cuda.synchronize()
        tsdiv.reset_launches()
        t0 = time.perf_counter()
        q, r = qr.qr_givens_batched(a, dm.DivisionConfig(mode="taylor_pallas"),
                                    via=via, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tsdiv.LAUNCHES)
        for k, v in counts.items():
            launches[k] += v
        got = _qr_residuals(q, r, a)
        out[via] = {"seconds": wall, "launches": counts, "exact": exact,
                    "taylor_pallas": got}
        for k, v in want.items():
            check(counts[k] == v, f"qr via={via}: {counts[k]} {k} launches, expected {v}")
        for k in ("orthogonality", "reconstruction"):
            check(got[k] <= 2 * exact[k], f"qr via={via}: {k} {got[k]} > 2 x {exact[k]}")
    say("qr", batch=4096, m=64, n=64, runs=out)


def phase_calls(seed: int, err: dict) -> torch.Tensor:
    """Each kernel call of the K-Means and QR paths, made again through the
    same entry point on the same inputs, against the plain version. Returns
    the K-Means distance plane for the times phase."""
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common
    from repro_torch.workloads import kmeans, qr

    def plain_div(cfg):
        table = compute_segments(cfg.n_iters, cfg.precision_bits)
        sched = dm._kernel_schedule(cfg)
        return lambda a, b: common.divide_f32_bits(a, b, table, cfg.n_iters, sched)

    x, init = kmeans_data(seed)
    d2 = kmeans.pairwise_sqdist(x, init)          # the first assignment's plane
    dmin, assign = d2.min(-1)
    counts = torch.bincount(assign, minlength=K).to(x.dtype)[:, None]
    sums = torch.zeros_like(init).index_add_(0, assign, x)
    rows = []
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        cfg = dm.DivisionConfig(mode=mode)
        for site, a, b in (("kmeans/distance_plane", d2, torch.tensor(float(D), device="cuda")),
                           ("kmeans/inertia", dmin.sum(-1), torch.tensor(float(N_PLANE), device="cuda")),
                           ("kmeans/centroid_update", sums, counts.clamp_min(1.0))):
            got = dm.div(a, b, cfg)
            n_bad, e = held_to_plain(got, plain_div(cfg), a, b)
            del got
            rows.append((mode, site, a.numel(), n_bad))
            err["tsdiv_divide"] = max(err["tsdiv_divide"], e)
    del x, init, dmin, assign, sums

    r0 = qr_data(seed)
    an, bn, t, _ = qr.givens_operands(r0[:, 0, 0], r0[:, 1, 0])   # the first rotation
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    for site, got, plain, ops, name in (
            ("qr/c", dm.div(an, torch.sqrt(t), cfg), plain_div(cfg), (an, torch.sqrt(t)), "tsdiv_divide"),
            ("qr/s", dm.div(bn, torch.sqrt(t), cfg), plain_div(cfg), (bn, torch.sqrt(t)), "tsdiv_divide"),
            ("qr/inv_r", dm.rsqrt(t, cfg),
             lambda v: common.rsqrt_f32_bits(v, rsqrt_seed_table(cfg.rsqrt_segments),
                                             cfg.rsqrt_newton), (t,), "tsdiv_rsqrt")):
        n_bad, e = held_to_plain(got, plain, *ops)
        rows.append(("taylor_pallas", site, got.numel(), n_bad))
        err[name] = max(err[name], e)
    torch.cuda.synchronize()
    say("calls", mismatched_lanes=rows)
    check(all(r[3] == 0 for r in rows), f"a path call differs from the plain version: {rows}")
    return d2


def kernel_row(name, ms, plain_ms, library_ms, nbytes, elements, launches, err,
               ops_per_s=F32_OPS_PER_S, ops=None, **extra):
    """One entry of the kernels line; the operation count of the bound is
    ``ops``, or ``elements`` times OPS_PER_ELEMENT."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = (OPS_PER_ELEMENT[name] * elements if ops is None else ops) / ops_per_s * 1e3
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": library_ms, "elements": elements, **extra}


def phase_times(x: torch.Tensor, err: dict, launches: dict, consumer_inputs: dict):
    from repro_torch.kernels import common, rmsnorm, softmax, tsdiv
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table

    torch.cuda.empty_cache()
    n = x.numel()
    d = torch.full_like(x, float(D))          # the divisor as the K-Means path materialises it
    xs = x.view(-1)[:PLAIN_ELEMENTS].clone()
    ds = d.view(-1)[:PLAIN_ELEMENTS].clone()
    table = compute_segments(2, 24)
    cases = {
        "tsdiv_divide": (lambda: tsdiv.divide(x, d, 2, 24, "factored"),
                         lambda: common.divide_f32_bits(xs, ds, table, 2, "factored"),
                         lambda: torch.div(x, d), 12),
        "tsdiv_recip": (lambda: tsdiv.recip(x, 2, 24, "factored"),
                        lambda: common.recip_f32_bits(xs, table, 2, "factored"),
                        lambda: torch.reciprocal(x), 8),
        "tsdiv_rsqrt": (lambda: tsdiv.rsqrt(x, 2, 16),
                        lambda: common.rsqrt_f32_bits(xs, rsqrt_seed_table(16), 2),
                        lambda: torch.rsqrt(x), 8),
    }
    rows = []
    for name, (kernel, plain, library, bytes_per) in cases.items():
        rows.append(kernel_row(name, event_ms(kernel), event_ms(plain, 3), event_ms(library),
                               bytes_per * n, n, launches, err,
                               shape=list(x.shape), plain_elements=PLAIN_ELEMENTS))
        say("times", **rows[-1])
    del x, d, xs, ds
    torch.cuda.empty_cache()
    # The consumers at the serving path's own shapes and inputs (phase 10),
    # the weight in its own dtype as the model passes it. Each also gets its
    # kernel's device time apart from the wrapper's host time, and the
    # library call's device time (all of its kernels).
    sched = dm_config("taylor_pallas").schedule
    for step in ("prefill", "decode"):
        sx = consumer_inputs[("softmax", step)]
        rx, w = consumer_inputs[("rmsnorm", step)]
        for name, kernel_name, kernel, plain, library, nbytes, t in (
                ("softmax_f32", "softmax_kernel", lambda: softmax.softmax(sx, 2, 24, sched),
                 lambda: softmax.softmax_plain(sx, table, 2, sched),
                 lambda: torch.softmax(sx, -1), 2 * sx.numel() * sx.element_size(), sx),
                ("rmsnorm_f32", "rmsnorm_kernel", lambda: rmsnorm.rmsnorm(rx, w, 1e-6, 2, 16),
                 lambda: rmsnorm.rmsnorm_plain(rx, w, 1e-6, rsqrt_seed_table(16), 2),
                 lambda: torch.nn.functional.rms_norm(rx, (rx.shape[-1],), w.to(rx.dtype), 1e-6),
                 2 * rx.numel() * rx.element_size() + w.numel() * w.element_size(), rx)):
            extra = {"device_ms": device_ms(kernel, kernel_name),
                     "library_device_ms": device_ms(library)}
            if name == "rmsnorm_f32":
                extra["w_dtype"] = str(w.dtype).replace("torch.", "")
            row = kernel_row(name, event_ms(kernel), event_ms(plain, 3), event_ms(library),
                             nbytes, t.numel(), launches, err, shape=list(t.shape),
                             dtype=str(t.dtype).replace("torch.", ""), step=step, **extra)
            say("times", **row)
            if step == "prefill":
                rows.append(row)
    return rows


def dm_config(mode: str):
    """paper_fpdiv's own division config (paper schedule, n=2, p=24) in ``mode``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("paper_fpdiv").division, mode=mode)


def consumer_corpus(d: int, seed: int):
    """The ported softmax and RMSNorm corpora at row length d, edge rows
    included: (softmax logits, rmsnorm activations, rmsnorm weight), f32."""
    from repro_torch.eval import consumers

    sm = np.concatenate([*consumers.softmax_rows("float32", 64, d, seed).values(),
                         consumers.softmax_edge_rows("float32", d),
                         np.full((2, d), -1e30, np.float32)])       # NEG_INF rows
    edges = np.zeros((4, d), np.float32)
    edges[1, :] = 3e38                  # sum of squares overflows: scale by 0
    edges[2, 0] = np.inf
    edges[3, d // 2] = np.nan
    rms = np.concatenate([*consumers.rmsnorm_rows("float32", 64, d, seed).values(), edges])
    return sm, rms, consumers.rmsnorm_weight(d, seed)


def phase_consumers(seed: int, err: dict):
    """Kernels vs plain versions on the corpora, then the consumer gates."""
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.eval import consumers
    from repro_torch.kernels import rmsnorm, softmax

    rows = []
    for d in CONSUMER_DIMS:
        sm, rms, w = consumer_corpus(d, seed)
        sm, rms, w = (torch.from_numpy(a).to(DEVICE) for a in (sm, rms, w))
        for dtype in (torch.float32, torch.bfloat16):
            xs, xr = sm.to(dtype), rms.to(dtype)
            for sched in SCHEDULES:
                n_bad, e = mismatch(softmax.softmax(xs, 2, 24, sched),
                                    softmax.softmax_plain(xs, compute_segments(2, 24), 2, sched))
                rows.append(("softmax_f32", d, str(dtype), sched, xs.numel(), n_bad))
                err["softmax_f32"] = max(err["softmax_f32"], e)
            for wd in (w, w.to(torch.bfloat16)):      # the weight in f32 and in bf16
                n_bad, e = mismatch(rmsnorm.rmsnorm(xr, wd, 1e-6, 2, 16),
                                    rmsnorm.rmsnorm_plain(xr, wd, 1e-6, rsqrt_seed_table(16), 2))
                rows.append(("rmsnorm_f32", d, str(dtype), str(wd.dtype), xr.numel(), n_bad))
                err["rmsnorm_f32"] = max(err["rmsnorm_f32"], e)
    sync()
    # The reference's gates (tests/test_consumer_conformance.py), on the card.
    gates = {}
    sm_corpus = consumers.softmax_rows("float32", n_rows=32, d=128, seed=5)
    rms_corpus = consumers.rmsnorm_rows("float32", n_rows=32, d=128, seed=6)
    w6 = consumers.rmsnorm_weight(128, seed=6)
    wt = torch.from_numpy(w6).to(DEVICE)
    for mode, sched in (("taylor_pallas", "factored"), ("taylor_pallas", "paper"),
                        ("goldschmidt_pallas", "factored")):
        cfg = dm.DivisionConfig(mode=mode, schedule=sched)
        row_sum, vs_exact = 0.0, 0
        for name, x in sm_corpus.items():
            xt = torch.from_numpy(x).to(DEVICE)
            out = dm.softmax(xt, -1, cfg).cpu().numpy()
            twin = dm.softmax(xt, -1, dm.EXACT).cpu().numpy()
            row_sum = max(row_sum, float(consumers.row_sum_ulp1(out).max()))
            vs_exact = max(vs_exact, consumers.vs_exact_int_ulp(
                out, twin, consumers.softmax_oracle(x.astype(np.float64))))
        rms_vs_exact = 0
        for name, x in rms_corpus.items():
            xt = torch.from_numpy(x).to(DEVICE)
            out = dm.rmsnorm(xt, wt, cfg).cpu().numpy()
            twin = dm.rmsnorm(xt, wt, dm.EXACT).cpu().numpy()
            rms_vs_exact = max(rms_vs_exact, consumers.vs_exact_int_ulp(
                out, twin, consumers.rmsnorm_oracle(x.astype(np.float64), w6.astype(np.float64))))
        masked_zero = True
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 16))).to(DEVICE, dtype)
            where = torch.from_numpy(np.stack([np.zeros(16, bool), np.eye(16, dtype=bool)[5],
                                               np.arange(16) < 9])).to(DEVICE)
            s = dm.softmax(x, -1, cfg, where=where).float()
            inf_rows = dm.softmax(torch.full((2, 8), -torch.inf, device=DEVICE, dtype=dtype),
                                  -1, cfg).float()
            masked_zero &= bool((s[0] == 0).all() and (s[2, 9:] == 0).all()
                                and (inf_rows == 0).all())
        gates[f"{mode}/{sched}"] = {"row_sum_ulp": row_sum, "softmax_vs_exact_ulp": vs_exact,
                                    "rmsnorm_vs_exact_ulp": rms_vs_exact,
                                    "masked_rows_zero": masked_zero}
    say("consumers", mismatched_lanes=rows, gates=gates,
        row_sum_gate_ulp=consumers.ROW_SUM_GATE_ULP, vs_exact_gate_ulp=consumers.VS_EXACT_GATE_ULP)
    check(all(r[-1] == 0 for r in rows), f"a consumer kernel differs from its plain version: {rows}")
    for key, g in gates.items():
        check(g["row_sum_ulp"] <= consumers.ROW_SUM_GATE_ULP, f"{key}: row-sum gate {g}")
        check(g["softmax_vs_exact_ulp"] <= consumers.VS_EXACT_GATE_ULP, f"{key}: softmax gate {g}")
        check(g["rmsnorm_vs_exact_ulp"] <= consumers.VS_EXACT_GATE_ULP, f"{key}: rmsnorm gate {g}")
        check(g["masked_rows_zero"], f"{key}: masked rows are not zero")


def serve_setup(seed: int, param_dtype: str = "bfloat16"):
    """paper_fpdiv at full width, params drawn in f32 from a CUDA generator
    seeded with ``seed`` and cast to ``param_dtype`` (so the bf16 model is the
    f32 one rounded), and the 8 unequal prompts (token ids from ``seed``)."""
    return model_setup("paper_fpdiv", seed, param_dtype, SERVE_LENS)


def padded(prompts, align: int = 1):
    """Right-padded tokens (to a multiple of ``align``, the engine's window
    alignment) and the lengths, on the card."""
    n = -(-max(len(p) for p in prompts) // align) * align
    toks = torch.zeros((len(prompts), n), dtype=torch.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=DEVICE)
    return toks.to(DEVICE), lengths


def prefill_batch(engine, prompts, hand=None):
    """The engine's prefill of ``prompts`` right-padded to its alignment:
    token prompts, or with ``hand`` (generate_batch's ``enc_embeds`` or
    ``embeds``) an encoder-decoder's or an embedding-input model's. Returns
    (last logits, cache, lengths, padded length)."""
    hand = hand or {}
    if "embeds" in hand:
        lengths = torch.tensor([e.shape[0] for e in hand["embeds"]], dtype=torch.int32,
                               device=DEVICE)
        n = engine._pad_to(int(lengths.max()))
        emb = torch.zeros((len(lengths), n, engine.cfg.d_model), device=DEVICE)
        for i, e in enumerate(hand["embeds"]):
            emb[i, :e.shape[0]] = e
        return (*engine._prefill_emb(emb, lengths), lengths, n)
    toks, lengths = padded(prompts, engine._align)
    if "enc_embeds" in hand:
        return (*engine._prefill_enc(toks, hand["enc_embeds"], lengths), lengths, toks.shape[1])
    return (*engine._prefill_tok(toks, lengths), lengths, toks.shape[1])


def replay(engine, prompts, steps: int, teacher=None, hand=None):
    """Greedy decode through the engine's own steps, as
    tests/test_decode_equiv.py does: with ``teacher`` (the exact run's
    tokens, (steps, B)) that stream is fed back instead of the engine's own
    argmax, so both runs see the same context at every step. Returns the
    argmax of every step (steps, B) and the logits (steps, B, V)."""
    logits, cache, lengths, n = prefill_batch(engine, prompts, hand)
    cache = engine._fit(cache, n, len(lengths))
    pos, picks, seen = lengths, [], []
    for t in range(steps):
        seen.append(logits)
        choice = engine._argmax(logits)
        picks.append(choice[:, 0])
        feed = choice if teacher is None else torch.as_tensor(
            teacher[t], dtype=torch.int32, device=DEVICE)[:, None]
        logits, cache = engine._decode(cache, feed, pos)
        pos = pos + 1
    return torch.stack(picks).cpu().numpy(), torch.stack(seen)


def cache_len(cfg, prompts, steps: int) -> int:
    """Cache slots for ``prompts`` padded to the engine's alignment and
    ``steps`` new tokens."""
    from repro_torch.serving import alignment

    a, s = alignment(cfg), max(len(p) for p in prompts)
    return max(-(-s // a) * a, s + steps)


def mode_agreement(cfg, params, prompts, steps: int, mode: str = "taylor_pallas", hand=None):
    """Teacher-forced greedy agreement of ``mode`` with the exact twin (the
    config's own division in both modes), and the logit drift max|dl| /
    max|l| (the gates of test_decode_equiv)."""
    from repro_torch.serving import ServingEngine

    engs = {m: ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, steps),
                             division=dataclasses.replace(cfg.division, mode=m))
            for m in ("exact", mode)}
    teacher, exact_logits = replay(engs["exact"], prompts, steps, hand=hand)
    picks, logits = replay(engs[mode], prompts, steps, teacher, hand)
    drift = float((logits - exact_logits).abs().max() / exact_logits.abs().max())
    return float((picks == teacher).mean()), drift, teacher


def phase_serve(seed: int, launches: dict):
    from repro_torch.kernels import rmsnorm, softmax
    from repro_torch.serving import Request, ServingEngine

    cfg, params, prompts = serve_setup(seed)
    max_len = max(SERVE_LENS) + SERVE_NEW
    engines = {mode: ServingEngine(cfg, params, max_len=max_len, division=dm_config(mode))
               for mode in ("taylor_pallas", "exact")}
    toks, lengths = padded(prompts)
    out, runs = {}, {}
    for mode, eng in engines.items():
        eng.generate_batch([prompts[-1][:16]], max_new=2)        # warm-up
        sync()
        t0 = time.perf_counter()
        eng._prefill_tok(toks, lengths)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        softmax.reset_launches()
        rmsnorm.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = eng.generate_batch(prompts, max_new=SERVE_NEW)
        sync()
        wall = time.perf_counter() - t0
        counts = {**softmax.LAUNCHES, **rmsnorm.LAUNCHES}
        forwards = 1 + SERVE_NEW
        out[mode] = {"generate_batch_s": wall, "prefill_ms": prefill_ms,
                     "decode_ms_per_step": (wall * 1e3 - prefill_ms) / SERVE_NEW,
                     "tokens_per_s": len(prompts) * SERVE_NEW / wall,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "launches": counts}
        if mode == "taylor_pallas":
            for k, v in counts.items():
                launches[k] += v
            check(counts == {"softmax_f32": 12 * forwards, "rmsnorm_f32": 25 * forwards},
                  f"generate_batch launches {counts}, expected 12 and 25 per forward x {forwards}")
        else:
            check(not any(counts.values()), f"exact mode launched a consumer kernel: {counts}")
    # serve(): 4 slots over the same 8 requests, 32 new tokens each.
    eng = engines["taylor_pallas"]
    reqs = [Request(list(p), max_new=SLOT_NEW) for p in prompts]
    softmax.reset_launches()
    rmsnorm.reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs, slots=SLOTS)
    sync()
    wall = time.perf_counter() - t0
    counts = {**softmax.LAUNCHES, **rmsnorm.LAUNCHES}
    for k, v in counts.items():
        launches[k] += v
    fwd = counts["softmax_f32"] // 12
    check(counts["softmax_f32"] > 0 and counts == {"softmax_f32": 12 * fwd, "rmsnorm_f32": 25 * fwd},
          f"serve() launches {counts}: not 12 and 25 per forward")
    check(all(r.done and len(r.out) == SLOT_NEW for r in reqs), "serve() left a request unfinished")
    gb = runs["taylor_pallas"]
    serve_diff = sum(a != b for r, g in zip(reqs, gb) for a, b in zip(r.out, g[:SLOT_NEW]))
    n_serve = len(reqs) * SLOT_NEW
    out["serve"] = {"slots": SLOTS, "seconds": wall, "tokens_per_s": n_serve / wall,
                    "forwards": fwd, "launches": counts, "tokens_differing_from_generate_batch":
                    serve_diff, "agreement": 1 - serve_diff / n_serve}
    # Greedy agreement with the exact twin. The gate is the reference's
    # (tests/test_decode_equiv.py: teacher forcing, f32 params, >= 99% of
    # tokens, logit drift < 5e-3), here at full width on the same seeded
    # weights before their bf16 rounding. In bf16 a 1-ulp f32 difference in
    # a probability or a norm output can flip a bf16 rounding; that is
    # reported, with the free-running agreement.
    teacher = np.array(runs["exact"]).T                        # (steps, B)
    bf16_forced, _ = replay(eng, prompts, SERVE_NEW, teacher)
    del engines, eng, params
    torch.cuda.empty_cache()
    f32_agree, f32_drift, _ = mode_agreement(*serve_setup(seed, "float32"), SERVE_NEW)
    out["agreement_vs_exact"] = {
        "bf16_free_running": float((np.array(gb).T == teacher).mean()),
        "bf16_teacher_forced": float((bf16_forced == teacher).mean()),
        "f32_teacher_forced": f32_agree, "f32_logit_drift": f32_drift}
    say("serve", arch=cfg.name, params_dtype=cfg.param_dtype, prompt_lens=list(SERVE_LENS),
        max_new=SERVE_NEW, division=dataclasses.asdict(dm_config("taylor_pallas")), runs=out)
    for mode, toks_out in runs.items():
        check(all(len(o) == SERVE_NEW for o in toks_out), f"{mode}: short output")
    check(f32_agree >= 0.99, f"greedy agreement with the exact twin {f32_agree} < 0.99")
    check(f32_drift < 5e-3, f"logit drift from the exact twin {f32_drift} >= 5e-3")
    check(out["serve"]["agreement"] >= 0.99,
          f"serve() agrees with generate_batch on {out['serve']['agreement']} < 0.99 of tokens")


def phase_serve_calls(seed: int, err: dict) -> dict:
    """Every softmax and RMSNorm call of one prefill and one decode step, on
    its own inputs through the same entry point, against the plain version.
    Returns the first call's inputs of each kind and step, for the times."""
    from repro_torch.serving import ServingEngine

    cfg, params, prompts = serve_setup(seed)
    eng = ServingEngine(cfg, params, max_len=max(SERVE_LENS) + SERVE_NEW,
                        division=dm_config("taylor_pallas"))
    rows, first = held_calls(eng, prompts, err)
    n_calls = {k: sum(1 for r in rows if r[:2] == k) for k in
               (("softmax_f32", "prefill"), ("rmsnorm_f32", "prefill"),
                ("softmax_f32", "decode"), ("rmsnorm_f32", "decode"))}
    say("serve_calls", calls={f"{a}/{b}": n for (a, b), n in n_calls.items()},
        shapes=sorted({(r[0], r[1], str(r[2])) for r in rows}),
        mismatched_lanes=sum(r[3] for r in rows))
    check(list(n_calls.values()) == [12, 25, 12, 25], f"serving call sites: {n_calls}")
    check(all(r[3] == 0 for r in rows), f"a serving call differs from the plain version: "
          f"{[r for r in rows if r[3]]}")
    out = {}
    for (kind, step, _), v in first.items():
        out.setdefault((kind, step), v)
    return out


def first_of(first: dict, kind: str, step: str, d: int, rows: int | None = None):
    """The first input held_calls kept of ``kind`` at ``step`` with rows of
    ``d`` (and ``rows`` of them, where given)."""
    return next(v for (k, st, shape), v in first.items()
                if (k, st, shape[-1]) == (kind, step, d)
                and (rows is None or math.prod(shape[:-1]) == rows))


# ------------------------------------------- slice 8: conformance, SWA, MoE

def phase_conformance(launches: dict):
    """The port's quick conformance grid on the card (eval/conformance.py):
    every cell must pass its gate, through the tsdiv, softmax and RMSNorm
    kernels in the kernel modes."""
    from repro_torch.eval import conformance
    from repro_torch.kernels import rmsnorm, softmax, tsdiv

    for m in (tsdiv, softmax, rmsnorm):
        m.reset_launches()
    t0 = time.perf_counter()
    report = conformance.run_conformance(quick=True, seed=0, device=DEVICE)
    sync()
    wall = time.perf_counter() - t0
    counts = {**tsdiv.LAUNCHES, **softmax.LAUNCHES, **rmsnorm.LAUNCHES}
    for k, v in counts.items():
        launches[k] += v
    failing = [c["key"] for c in report["cells"] if not c["pass"]]
    say("conformance", cells=len(report["cells"]), seconds=wall, sweep=report["meta"]["sweep"],
        max_ulp={c["key"]: c["overall"]["max_ulp"] for c in report["cells"]},
        vs_exact_max_ulp={c["key"]: c["vs_exact_max_ulp"] for c in report["cells"]
                          if "vs_exact_max_ulp" in c},
        launches=counts, failing=failing)
    check(not failing, f"conformance cells fail their gates: {failing}")
    check(all(counts.values()), f"the conformance grid left a kernel unlaunched: {counts}")


def model_setup(arch: str, seed: int, param_dtype: str = "bfloat16", lens=None, **repl):
    """``arch`` at full width (``repl`` may cut its depth), params drawn leaf
    by leaf in f32 from a CUDA generator seeded with ``seed`` and cast to
    ``param_dtype``, and prompts of ``lens`` tokens (MODEL_LENS by default;
    token ids from ``seed``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), param_dtype=param_dtype, **repl)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lens or MODEL_LENS]
    return cfg, params, prompts


def hand_offs(cfg, kind, prompts, seed: int):
    """generate_batch's prefill inputs beside the prompts, drawn on the card
    from ``seed`` (stub frontends, as in the reference): encoder frames
    (B, encoder_seq, d_model) or per-request prompt embeddings (len_i,
    d_model), f32."""
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 13)
    if kind == "enc":
        return {"enc_embeds": torch.randn((len(prompts), cfg.encoder_seq, cfg.d_model),
                                          generator=gen, device=DEVICE)}
    if kind == "emb":
        return {"embeds": [torch.randn((len(p), cfg.d_model), generator=gen, device=DEVICE)
                           for p in prompts]}
    return {}


def cut(hand: dict, n: int, rows: int = 1) -> dict:
    """The hand-off of the first ``rows`` requests, each cut to ``n`` tokens."""
    if "embeds" in hand:
        return {"embeds": [e[:n] for e in hand["embeds"][:rows]]}
    return {k: v[:rows] for k, v in hand.items()}


def rows_held(got: torch.Tensor, plain, x: torch.Tensor, *rest):
    """mismatch() of a row kernel's (M, D) output against ``plain(x, *rest)``
    on blocks of rows of at most PLAIN_ELEMENTS elements (the plain versions
    work row by row), so that its temporaries fit beside a large model."""
    step = max(1, PLAIN_ELEMENTS // max(1, x.shape[-1]))
    n_bad, err = 0, 0.0
    for s in range(0, x.shape[0], step):
        b, e = mismatch(got[s:s + step], plain(x[s:s + step], *rest))
        n_bad, err = n_bad + b, max(err, e)
    return n_bad, err


def held_calls(eng, prompts, err: dict, recip: bool = False, hand=None, keep=None):
    """One prefill of ``prompts`` (padded; ``hand``: prefill_batch's) and one
    decode step through ``eng`` with every softmax, RMSNorm (and, with
    ``recip``, reciprocal) kernel call held bit for bit against its plain
    version on its own inputs (and each pass of the split softmax kernel,
    where a decode step runs it). Returns the rows (kernel, step, shape,
    lanes differing) and the first input of each (kind, step, shape), of
    the (kind, step, row length) in ``keep`` where given."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, rmsnorm, softmax, softmax_split, tsdiv

    rows, first, step = [], {}, ["prefill"]
    real = (softmax.softmax, rmsnorm.rmsnorm, tsdiv.recip)
    real_split = {n: getattr(softmax_split, n) for n in SPLIT_PASSES}

    def kept(kind, x, make):
        key = (kind, step[0], tuple(x.shape))
        if key not in first and (keep is None or (kind, step[0], x.shape[-1]) in keep):
            first[key] = make()

    def sm_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real[0](x, n_iters, precision_bits, schedule)
        n_bad, e = rows_held(got, softmax.softmax_plain, x,
                             compute_segments(n_iters, precision_bits), n_iters, schedule)
        rows.append(("softmax_f32", step[0], list(x.shape), n_bad))
        err["softmax_f32"] = max(err["softmax_f32"], e)
        kept("softmax", x, x.clone)
        return got

    def rms_spy(x, w, eps=1e-6, newton_iters=2, n_segments=16):
        got = real[1](x, w, eps, newton_iters, n_segments)
        n_bad, e = rows_held(got, lambda xs: rmsnorm.rmsnorm_plain(
            xs, w, eps, rsqrt_seed_table(n_segments), newton_iters), x)
        rows.append(("rmsnorm_f32", step[0], list(x.shape), n_bad))
        err["rmsnorm_f32"] = max(err["rmsnorm_f32"], e)
        kept("rmsnorm", x, lambda: (x.clone(), w.clone()))
        return got

    def recip_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real[2](x, n_iters, precision_bits, schedule)
        table = compute_segments(n_iters, precision_bits)
        n_bad, e = held_to_plain(got, lambda v: common.recip_f32_bits(
            v, table, n_iters, schedule), x)
        rows.append(("tsdiv_recip", step[0], list(x.shape), n_bad))
        err["tsdiv_recip"] = max(err["tsdiv_recip"], e)
        kept("recip", x, x.clone)
        return got

    def split_spy(name):
        def spy(*a, **k):
            got = real_split[name](*a, **k)
            n_bad, e = split_held(name, real_split[name], got, a, k)
            rows.append(("softmax_split_f32", step[0], list(a[0].shape), n_bad))
            err["softmax_split_f32"] = max(err.get("softmax_split_f32", 0.0), e)
            return got
        return spy

    softmax.softmax, rmsnorm.rmsnorm = sm_spy, rms_spy
    for n in SPLIT_PASSES:
        setattr(softmax_split, n, split_spy(n))
    if recip:
        tsdiv.recip = recip_spy
    try:
        logits, cache, lengths, n = prefill_batch(eng, prompts, hand)
        cache = eng._fit(cache, n, len(lengths))
        step[0] = "decode"
        eng._decode(cache, eng._argmax(logits), lengths)
        sync()
    finally:
        softmax.softmax, rmsnorm.rmsnorm, tsdiv.recip = real
        for n, fn in real_split.items():
            setattr(softmax_split, n, fn)
    return rows, first


def serve_agreement(eng, prompts, gb=None):
    """serve() with MODEL_SLOTS slots over ``prompts`` against
    generate_batch's tokens ``gb`` (run here when None): (requests, seconds,
    tokens differing)."""
    from repro_torch.serving import Request

    gb = eng.generate_batch(prompts, MODEL_NEW) if gb is None else gb
    reqs = [Request(list(p), max_new=MODEL_NEW) for p in prompts]
    t0 = time.perf_counter()
    eng.serve(reqs, slots=MODEL_SLOTS)
    sync()
    wall = time.perf_counter() - t0
    check(all(r.done and len(r.out) == MODEL_NEW for r in reqs), "serve() left a request")
    return reqs, wall, sum(a != b for r, g in zip(reqs, gb) for a, b in zip(r.out, g))


def phase_serve_model(sv: Serving, seed: int, launches: dict, err: dict):
    """``sv.arch`` at full width in taylor_pallas (bf16 params from ``seed``,
    depth cut by ``sv.depth``): generate_batch over the ``sv.lens`` prompts
    (with the seeded encoder frames or prompt embeddings of ``sv.hand``),
    MODEL_NEW new tokens each, timed, its launches held to ``sv.per_forward``
    (and ``sv.per_decode``); the exact twin on the same batch; serve() with
    MODEL_SLOTS slots against generate_batch, or its refusal of
    encoder-decoder and embedding-input configs; every softmax, RMSNorm and
    reciprocal call of one prefill and one decode step held to its plain
    version; then the f32 greedy gate against the exact twin at the depth
    ``sv.gate_depth``.

    With ``sv.gate_cf`` (MoE) the gates run at that capacity factor, the
    timed run at the config's own. With ``sv.f32_serve`` serve() is gated
    against generate_batch in f32 at ``sv.gate_depth``; in bf16 at full
    width it is reported (at the gate's capacity factor where the gate's
    prompts are the timed ones): there a random-init model turns the batch
    shape's rounding into other greedy tokens (a MoE's router into other
    experts, PERF.md §6). Returns the first inputs of the calls, for the
    times."""
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.serving import Request, ServingEngine

    mods = (softmax, rmsnorm, tsdiv)
    arch, per_decode = sv.arch, sv.per_decode or sv.per_forward
    held = torch.cuda.memory_allocated() / 2**30     # earlier phases' inputs kept for the times
    cfg, params, prompts = model_setup(arch, seed, lens=sv.lens, **sv.depth)
    hand = hand_offs(cfg, sv.hand, prompts, seed)
    tok_prompts = None if sv.hand == "emb" else prompts   # embeddings replace the tokens
    max_len = cache_len(cfg, prompts, MODEL_NEW)
    div = {m: dataclasses.replace(cfg.division, mode=m) for m in ("taylor_pallas", "exact")}
    engines = {m: ServingEngine(cfg, params, max_len=max_len, division=d) for m, d in div.items()}
    out, runs = {}, {}
    for mode, eng in engines.items():
        eng.generate_batch(None if tok_prompts is None else [prompts[-1][:16]],   # warm-up
                           max_new=2, **cut(hand, 16))
        sync()
        t0 = time.perf_counter()
        prefill_batch(eng, prompts, hand)
        sync()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.reset_peak_memory_stats()
        for m in mods:
            m.reset_launches()
        t0 = time.perf_counter()
        runs[mode] = eng.generate_batch(tok_prompts, max_new=MODEL_NEW, **hand)
        sync()
        wall = time.perf_counter() - t0
        counts = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        out[mode] = {"generate_batch_s": wall, "prefill_ms": prefill_ms,
                     "decode_ms_per_step": (wall * 1e3 - prefill_ms) / MODEL_NEW,
                     "tokens_per_s": len(prompts) * MODEL_NEW / wall,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30, "launches": counts}
        if mode == "taylor_pallas":
            for k, v in counts.items():
                launches[k] += v
            want = {k: v + MODEL_NEW * per_decode[k] for k, v in sv.per_forward.items()}
            check(counts == want, f"{arch} generate_batch launches {counts}, expected {want}")
        else:
            check(not counts, f"{arch}: exact mode launched a kernel: {counts}")
    teacher = np.array(runs["exact"]).T                        # (steps, B)
    bf16_forced, _ = replay(engines["taylor_pallas"], prompts, MODEL_NEW, teacher, hand)
    out["agreement_vs_exact"] = {
        "bf16_free_running": float((np.array(runs["taylor_pallas"]).T == teacher).mean()),
        "bf16_teacher_forced": float((bf16_forced == teacher).mean())}
    del engines
    # serve() against generate_batch, at the gates' capacity factor where
    # the gates' prompts are these (jamba's experts at capacity factor 8 on
    # 4 x 2048 tokens would not fit beside its weights).
    serve_cf = sv.gate_cf if sv.gate_lens is None else None
    gcfg = cfg if serve_cf is None else dataclasses.replace(cfg, capacity_factor=serve_cf)
    eng = ServingEngine(gcfg, params, max_len=max_len, division=div["taylor_pallas"])
    n_serve = len(prompts) * MODEL_NEW
    if sv.hand:       # the reference's serve() refuses these before it prefills
        try:
            eng.serve([Request(list(prompts[-1]), max_new=MODEL_NEW)])
            msg = ""
        except ValueError as e:
            msg = str(e)
        out["serve"] = {"refused": msg}
        check("serve() " in msg and "generate/generate_batch" in msg,
              f"{arch}: serve() did not refuse as the reference does: {msg!r}")
    else:
        gb = (runs["taylor_pallas"] if serve_cf is None
              else eng.generate_batch(prompts, MODEL_NEW))
        for m in mods:
            m.reset_launches()
        _, wall, diff = serve_agreement(eng, prompts, gb)
        counts = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        for k, v in counts.items():
            launches[k] += v
        fwd = counts.get("rmsnorm_f32", 0) // sv.per_forward["rmsnorm_f32"]
        check(fwd > 0 and counts == {k: v * fwd for k, v in sv.per_forward.items()},
              f"{arch} serve() launches {counts}: not {sv.per_forward} per forward")
        out["serve"] = {"slots": MODEL_SLOTS, "capacity_factor": gcfg.capacity_factor,
                        "seconds": wall, "tokens_per_s": n_serve / wall, "forwards": fwd,
                        "launches": counts, "tokens_differing_from_generate_batch": diff,
                        "agreement": 1 - diff / n_serve}

    # Every kernel call of one prefill and one decode step, on its own inputs.
    keep = {(k, st, d) for k, m, st, d, _, _ in MODEL_TIMES if m == sv.phase.removeprefix("serve_")}
    rows, first = held_calls(eng, prompts, err, recip="tsdiv_recip" in sv.per_forward,
                             hand=hand, keep=keep)
    n_calls = {f"{k}/{st}": sum(1 for r in rows if r[:2] == (k, st))
               for st in ("prefill", "decode") for k in sv.per_forward}
    say("serve_calls", arch=cfg.name, calls=n_calls,
        shapes=sorted({(r[0], r[1], str(r[2])) for r in rows}),
        mismatched_lanes=sum(r[3] for r in rows))
    want = {f"{k}/{st}": n[k] for st, n in (("prefill", sv.per_forward), ("decode", per_decode))
            for k in sv.per_forward}
    check(n_calls == want, f"{arch} call sites per step: {n_calls}, expected {want}")
    check(all(r[3] == 0 for r in rows), f"{arch}: a serving call differs from the plain version: "
          f"{[r for r in rows if r[3]]}")
    del eng, params, hand
    torch.cuda.empty_cache()

    # The reference's serving gate, f32 at a cut depth where the full-width
    # f32 copy would not fit beside its activations.
    repl = dict(sv.gate_depth)
    if sv.gate_cf is not None:
        repl["capacity_factor"] = sv.gate_cf
    fcfg, fparams, gprompts = model_setup(arch, seed, "float32", lens=sv.gate_lens or sv.lens,
                                          **repl)
    ghand = hand_offs(fcfg, sv.hand, gprompts, seed)
    f32_agree, f32_drift, _ = mode_agreement(fcfg, fparams, gprompts, MODEL_NEW, hand=ghand)
    out["agreement_vs_exact"].update(f32_teacher_forced=f32_agree, f32_logit_drift=f32_drift,
                                     f32_depth=fcfg.n_layers,
                                     f32_prompt_lens=[len(p) for p in gprompts])
    serve_gate = out["serve"].get("agreement")
    if sv.f32_serve:
        feng = ServingEngine(fcfg, fparams, max_len=cache_len(fcfg, gprompts, MODEL_NEW),
                             division=div["taylor_pallas"])
        _, _, fdiff = serve_agreement(feng, gprompts)
        serve_gate = out["serve"]["f32_agreement"] = 1 - fdiff / (len(gprompts) * MODEL_NEW)
        out["serve"]["f32_depth"] = fcfg.n_layers
        del feng
    del fparams, ghand
    torch.cuda.empty_cache()
    say(sv.phase, arch=cfg.name, layers=cfg.n_layers, params_dtype=cfg.param_dtype,
        prompt_lens=list(sv.lens), max_new=MODEL_NEW, hand_off=sv.hand,
        capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
        gate_capacity_factor=sv.gate_cf, held_gib_at_start=held,
        launches_per_forward=sv.per_forward,
        launches_per_decode=per_decode, division=dataclasses.asdict(div["taylor_pallas"]),
        runs=out)
    for mode, toks_out in runs.items():
        check(all(len(o) == MODEL_NEW for o in toks_out), f"{arch} {mode}: short output")
    check(f32_agree >= 0.99, f"{arch}: greedy agreement with the exact twin {f32_agree} < 0.99")
    check(f32_drift < 5e-3, f"{arch}: logit drift from the exact twin {f32_drift} >= 5e-3")
    check(serve_gate is None or serve_gate >= 0.99,
          f"{arch}: serve() agrees with generate_batch on {serve_gate} < 0.99")
    return first


def phase_times_models(err: dict, launches: dict, firsts: dict):
    """The main-path shapes of the model phases, each kernel beside its
    plain version, the torch call and the bound: softmax on the routers'
    (T, E) rows, gemma's sliding-window prefill rows (b*nb*h*w, 2w) and
    whisper's 1500-key encoder and cross rows; RMSNorm at gemma's d = 3840
    and on the Mamba gated norms' rows of d_inner (mamba2's 3072 at prefill
    and decode, jamba's 16384), bf16 with an f32 weight; the reciprocal of
    the (T, 1) top-k sums."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, rmsnorm, softmax, tsdiv

    table = compute_segments(2, 24)
    rows = []
    for kind, model, step, d, n_rows, site in MODEL_TIMES:
        inp = first_of(firsts[model], kind, step, d, n_rows)
        if kind == "softmax":
            x = inp
            name, kernel_name = "softmax_f32", "softmax_kernel"
            kernel = lambda: softmax.softmax(x, 2, 24, "factored")
            plain = lambda: softmax.softmax_plain(x, table, 2, "factored")
            library = lambda: torch.softmax(x, -1)
            nbytes, extra = 2 * x.numel() * x.element_size(), {}
        elif kind == "rmsnorm":
            x, w = inp
            name, kernel_name = "rmsnorm_f32", "rmsnorm_kernel"
            kernel = lambda: rmsnorm.rmsnorm(x, w, 1e-6, 2, 16)
            plain = lambda: rmsnorm.rmsnorm_plain(x, w, 1e-6, rsqrt_seed_table(16), 2)
            library = lambda: torch.nn.functional.rms_norm(x, (x.shape[-1],), w.to(x.dtype), 1e-6)
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            extra = {"w_dtype": str(w.dtype).replace("torch.", "")}
        else:
            x = inp
            name, kernel_name = "tsdiv_recip", "elementwise_kernel"
            kernel = lambda: tsdiv.recip(x, 2, 24, "factored")
            plain = lambda: common.recip_f32_bits(x, table, 2, "factored")
            library = lambda: torch.reciprocal(x)
            nbytes, extra = 2 * x.numel() * x.element_size(), {}
        row = kernel_row(name, event_ms(kernel), event_ms(plain, 3), event_ms(library), nbytes,
                         x.numel(), launches, err, shape=list(x.shape),
                         dtype=str(x.dtype).replace("torch.", ""), step=step, site=site,
                         model=model, device_ms=device_ms(kernel, kernel_name),
                         library_device_ms=device_ms(library), **extra)
        say("times", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------- slice 10: training

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 32, 2048, 8     # microbatches of the config's 16
# The kill -> resume gate: RESUME_STEPS straight, then a kill before step
# RESUME_KILL and a resume from the checkpoint of step RESUME_EVERY.
RESUME_BATCH, RESUME_SEQ, RESUME_STEPS, RESUME_KILL, RESUME_EVERY = 8, 512, 6, 4, 4
OPT_TWIN_GATE = 1e-6      # tests/test_optim.py:35-47, max |params| difference


def train_config(mode: str = "taylor_pallas", param_dtype: str = "bfloat16"):
    """paper_fpdiv at full width and depth, its own division in ``mode``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("paper_fpdiv"), param_dtype=param_dtype,
                               division=dm_config(mode))


def train_launches(cfg, n_micro: int, n_leaves: int) -> dict:
    """Launches per step, from the code: per microbatch one softmax per
    attention layer and two RMSNorms per block plus the final one, each
    block's again in the backward pass when ``cfg.remat``; one reciprocal
    per parameter leaf in AdamW."""
    runs = 1 + cfg.remat
    return {"softmax_f32": n_micro * cfg.n_layers * runs,
            "rmsnorm_f32": n_micro * (2 * cfg.n_layers * runs + 1),
            "tsdiv_recip": n_leaves}


def bits_sum(t: torch.Tensor):
    """(shape, the int64 sum of the bit patterns): a fingerprint of a tensor."""
    ints = {4: torch.int32, 2: torch.int16}[t.element_size()]
    return tuple(t.shape), int(t.reshape(-1).view(ints).sum(dtype=torch.int64))


def phase_train(seed: int, launches: dict, err: dict):
    """paper_fpdiv trained at full width and depth (bf16 params from
    ``seed``) in taylor_pallas through ``train.loop.run``: TRAIN_STEPS steps
    of TRAIN_BATCH x TRAIN_SEQ tokens of SyntheticLM from ``seed`` in
    microbatches of the config's size, remat as configured. Gates: the
    launches of every step (train_launches), the loss falling by 0.3
    (tests/test_train_loop.py), then phase_train_calls' and the kill ->
    resume run's. Returns AdamW's denominators of one step, for the times,
    and the phase's result (its step time and peak memory, for the roofline
    phase)."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.train.loop import LoopConfig, run

    mods = (softmax, rmsnorm, tsdiv)
    held = torch.cuda.memory_allocated() / 2**30
    cfg = train_config()
    n_micro = TRAIN_BATCH // cfg.train_microbatch_size
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed)
    stamps = []
    torch.cuda.reset_peak_memory_stats()
    for m in mods:
        m.reset_launches()
    t0 = time.perf_counter()
    out = run(cfg, LoopConfig(total_steps=TRAIN_STEPS, n_micro=n_micro, log_every=1, seed=seed),
              data_cfg, log=lambda line: stamps.append(time.perf_counter()), device=DEVICE)
    sync()
    wall = time.perf_counter() - t0
    counts = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in counts.items():
        launches[k] += v
    state, losses = out["state"], out["losses"]
    n_leaves = len(tree.leaves(state.params))
    per_step = train_launches(cfg, n_micro, n_leaves)
    steps_s = np.diff(stamps)                    # each step after the first, batch to loss
    step_ms = float(np.median(steps_s)) * 1e3
    tokens = TRAIN_BATCH * TRAIN_SEQ
    result = {"arch": cfg.name, "layers": cfg.n_layers, "params_dtype": cfg.param_dtype,
              "n_params": sum(t.numel() for t in tree.leaves(state.params)),
              "n_leaves": n_leaves, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
              "n_micro": n_micro, "remat": cfg.remat, "steps": TRAIN_STEPS,
              "division": dataclasses.asdict(cfg.division), "seconds": wall,
              "first_step_ms": (stamps[0] - t0) * 1e3, "step_ms": step_ms,
              "step_ms_each": [float(s) * 1e3 for s in steps_s],
              "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
              "held_gib_at_start": held, "losses": losses,
              "launches": counts, "launches_per_step": per_step}
    check(counts == {k: v * TRAIN_STEPS for k, v in per_step.items()},
          f"train launches {counts}, expected {per_step} x {TRAIN_STEPS} steps")
    check(all(math.isfinite(x) for x in losses), f"train: a loss is not finite: {losses}")
    check(losses[-1] < losses[0] - 0.3, f"train: no learning, {losses[0]} -> {losses[-1]}")
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in SyntheticLM(data_cfg).batch(TRAIN_STEPS).items()}
    recips = phase_train_calls(cfg, state, batch, n_micro, err, result)
    del out, state, batch
    torch.cuda.empty_cache()
    result["resume"] = train_resume(cfg, seed)
    say("train", **result)
    return recips, result


def phase_train_calls(cfg, state, batch, n_micro: int, err: dict, result: dict):
    """One more step of the train phase's run through train_step with every
    kernel call held bit for bit to its plain version on its own inputs:
    every softmax and RMSNorm of both microbatches (forward and remat
    recompute) and every AdamW reciprocal; each recompute's output held to
    its forward's (the fingerprint bits_sum of input and output). Then, on
    that step's own f32 grads and moments: AdamW in taylor_pallas against
    the exact twin on f32 copies of the params (the gate of
    tests/test_optim.py), AdamW's time in both modes, the exact twin's
    step, and the grads of one microbatch against the exact twin's (f32
    copies of the params; per-leaf relative L2). Adds its figures to
    ``result``; returns AdamW's denominators."""
    from repro_torch import tree
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, rmsnorm, softmax, tsdiv
    from repro_torch.optim import adamw
    from repro_torch.train import step as ts

    rows, seen, recips, captured, repeats = [], {}, [], {}, [0]
    real = (softmax.softmax, rmsnorm.rmsnorm, tsdiv.recip, adamw.update)

    def remember(kind, x, got):
        key, fp = (kind, bits_sum(x)), bits_sum(got)
        if key in seen:
            repeats[0] += 1
            check(seen[key] == fp, f"{kind} {list(x.shape)}: the recompute gave other bits")
        seen[key] = fp

    def sm_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real[0](x, n_iters, precision_bits, schedule)
        n_bad, e = rows_held(got, softmax.softmax_plain, x,
                             compute_segments(n_iters, precision_bits), n_iters, schedule)
        rows.append(("softmax_f32", list(x.shape), n_bad))
        err["softmax_f32"] = max(err["softmax_f32"], e)
        remember("softmax_f32", x, got)
        return got

    def rms_spy(x, w, eps=1e-6, newton_iters=2, n_segments=16):
        got = real[1](x, w, eps, newton_iters, n_segments)
        n_bad, e = rows_held(got, lambda xs: rmsnorm.rmsnorm_plain(
            xs, w, eps, rsqrt_seed_table(n_segments), newton_iters), x)
        rows.append(("rmsnorm_f32", list(x.shape), n_bad))
        err["rmsnorm_f32"] = max(err["rmsnorm_f32"], e)
        remember("rmsnorm_f32", x, got)
        return got

    def recip_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real[2](x, n_iters, precision_bits, schedule)
        table = compute_segments(n_iters, precision_bits)
        n_bad, e = held_to_plain(got, lambda v: common.recip_f32_bits(
            v, table, n_iters, schedule), x)
        rows.append(("tsdiv_recip", list(x.shape), n_bad))
        err["tsdiv_recip"] = max(err["tsdiv_recip"], e)
        recips.append(x.clone())
        return got

    def update_spy(grads, opt, params, opt_cfg, lr_scale=1.0, split=None):
        captured.update(grads=grads, opt=opt, params=params, opt_cfg=opt_cfg)
        return real[3](grads, opt, params, opt_cfg, lr_scale, split)

    softmax.softmax, rmsnorm.rmsnorm, tsdiv.recip, adamw.update = (
        sm_spy, rms_spy, recip_spy, update_spy)
    try:
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        ts.train_step(cfg, opt_cfg, state, batch, n_micro=n_micro)
        sync()
    finally:
        softmax.softmax, rmsnorm.rmsnorm, tsdiv.recip, adamw.update = real
    n_leaves = len(tree.leaves(state.params))
    calls = {k: sum(1 for r in rows if r[0] == k) for k in ("softmax_f32", "rmsnorm_f32",
                                                            "tsdiv_recip")}
    want_repeats = n_micro * 3 * cfg.n_layers if cfg.remat else 0
    say("train_calls", calls=calls, recomputed_calls=repeats[0],
        shapes=sorted({(r[0], str(r[1])) for r in rows if r[0] != "tsdiv_recip"}),
        recip_elements=sum(x.numel() for x in recips), mismatched_lanes=sum(r[2] for r in rows))
    check(calls == train_launches(cfg, n_micro, n_leaves), f"train call sites per step: {calls}")
    check(repeats[0] == want_repeats, f"{repeats[0]} recomputed calls, expected {want_repeats}")
    check(all(r[2] == 0 for r in rows), f"a train call differs from the plain version: "
          f"{[r for r in rows if r[2]]}")

    # AdamW against its exact twin on this step's own grads and moments.
    grads, opt, params = captured["grads"], captured["opt"], captured["params"]
    p32 = tree.map_tree(lambda t: t.float(), params)
    cfgs = {m: dataclasses.replace(opt_cfg, division=dm_config(m)) for m in ("taylor_pallas", "exact")}
    new = {m: tree.leaves(adamw.update(grads, opt, p32, c)[0]) for m, c in cfgs.items()}
    twin_diff = max(float((a - b).abs().max()) for a, b in zip(new["taylor_pallas"], new["exact"]))
    del new, p32
    adamw_ms = {m: event_ms(lambda c=c: adamw.update(grads, opt, params, c), 3)
                for m, c in cfgs.items()}
    exact_cfg = train_config("exact")
    exact_opt = cfgs["exact"]
    ts.train_step(exact_cfg, exact_opt, state, batch, n_micro=n_micro)     # warm-up
    sync()
    t0 = time.perf_counter()
    ts.train_step(exact_cfg, exact_opt, state, batch, n_micro=n_micro)
    sync()
    exact_step_ms = (time.perf_counter() - t0) * 1e3
    del grads, opt, captured
    torch.cuda.empty_cache()

    # One microbatch's grads against the exact twin's, on f32 copies.
    p32 = tree.map_tree(lambda t: t.float(), params)
    mb = {k: v[:TRAIN_BATCH // n_micro] for k, v in batch.items()}
    g = {}
    for m in ("taylor_pallas", "exact"):
        loss, _, gm = ts.grads_fn(train_config(m, "float32"), p32, mb, 1)
        g[m] = (float(loss), tree.leaves(gm))
        del gm
    rel = [float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))
           for a, b in zip(g["taylor_pallas"][1], g["exact"][1])]
    paths = tree.paths(params)
    result.update(
        adamw_ms=adamw_ms["taylor_pallas"], adamw_exact_ms=adamw_ms["exact"],
        adamw_share=adamw_ms["taylor_pallas"] / result["step_ms"],
        exact_step_ms=exact_step_ms,
        optimizer_vs_exact_max_abs=twin_diff, optimizer_gate=OPT_TWIN_GATE,
        grads_vs_exact={"loss": g["taylor_pallas"][0], "exact_loss": g["exact"][0],
                        "rel_l2_max": max(rel), "rel_l2_median": float(np.median(rel)),
                        "worst_leaf": paths[int(np.argmax(rel))],
                        "microbatch": TRAIN_BATCH // n_micro})
    check(twin_diff < OPT_TWIN_GATE,
          f"AdamW differs from its exact twin by {twin_diff} >= {OPT_TWIN_GATE}")
    return recips


def train_resume(cfg, seed: int) -> dict:
    """Kill -> resume at full width and depth on RESUME_BATCH x RESUME_SEQ
    tokens (tests/test_train_loop.py's gate): RESUME_STEPS steps straight;
    then a run killed by the injector before step RESUME_KILL and a run that
    resumes from its checkpoint. Every leaf of the final state (params,
    moments, steps) must equal the straight run's. The checkpoints go to a
    temporary directory that is removed."""
    import shutil
    import tempfile

    from repro_torch import tree
    from repro_torch.data import DataConfig
    from repro_torch.train import fault
    from repro_torch.train.loop import LoopConfig, run

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=RESUME_SEQ, global_batch=RESUME_BATCH,
                          seed=seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    logs = []
    lc = lambda d: LoopConfig(total_steps=RESUME_STEPS, ckpt_every=RESUME_EVERY, n_micro=2,
                              ckpt_dir=d, log_every=RESUME_STEPS, seed=seed)
    try:
        straight = run(cfg, lc(None), data_cfg, log=lambda s: None, device=DEVICE)
        killed = False
        try:
            run(cfg, lc(tmp), data_cfg, injector=fault.FailureInjector(RESUME_KILL),
                log=lambda s: None, device=DEVICE)
        except fault.FailureInjector.Injected:
            killed = True
        t0 = time.perf_counter()
        resumed = run(cfg, lc(tmp), data_cfg, log=logs.append, device=DEVICE)
        sync()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree.leaves(resumed["state"]), tree.leaves(straight["state"]))]
    out = {"batch": RESUME_BATCH, "seq_len": RESUME_SEQ, "steps": RESUME_STEPS,
           "killed_at": RESUME_KILL, "ckpt_every": RESUME_EVERY, "n_micro": 2,
           "resumed_run_s": resume_s, "leaves": len(diffs), "max_abs_diff": max(diffs),
           "losses_straight": straight["losses"], "losses_resumed": resumed["losses"]}
    check(killed, "the injector did not stop the run")
    check(f"[resume] restored checkpoint at step {RESUME_EVERY}" in logs,
          f"the resumed run did not restore step {RESUME_EVERY}: {logs}")
    check(max(diffs) == 0.0, f"kill -> resume differs from the straight run by {max(diffs)}")
    return out


def phase_times_train(err: dict, launches: dict, recips: list):
    """tsdiv_recip at AdamW's leaves: one step's denominators, one launch per
    leaf, the paper_fpdiv config's paper schedule; beside its plain version
    and torch.reciprocal on the same leaves (device times summed)."""
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import common, tsdiv

    table, sched = compute_segments(2, 24), dm_config("taylor_pallas").schedule
    kernel = lambda: [tsdiv.recip(x, 2, 24, sched) for x in recips]
    plain = lambda: [common.recip_f32_bits(x, table, 2, sched) for x in recips]
    library = lambda: [torch.reciprocal(x) for x in recips]
    n = sum(x.numel() for x in recips)
    row = kernel_row("tsdiv_recip", event_ms(kernel, 5), event_ms(plain, 2), event_ms(library, 5),
                     2 * 4 * n, n, launches, err, shape=[len(recips), n], dtype="float32",
                     step="train", site="adamw_leaves", model="train", schedule=sched,
                     device_ms=device_ms(kernel, "elementwise_kernel", 5),
                     library_device_ms=device_ms(library, None, 5))
    say("times", **row)
    return [row]


# -------------------------------------------------------------- roofline

def phase_roofline(seed: int, train: dict, smi: str) -> dict:
    """The train phase's cell on the H100's roofline (launch/roofline.py).
    The one-rank dry run of that cell (launch/dryrun.py: train_config() at
    TRAIN_BATCH x TRAIN_SEQ, its microbatches, remat; fake CUDA tensors, no
    launch) gives the FLOPs, the HBM bytes, the roofline terms and the memory
    estimate. Exact gates: the fake step's FlopCounterMode count equals one
    real step's on the card (counted around train_step in this phase); the
    fake step's unit calls equal train_launches (as the real step's
    launches do); abstract_params' bytes equal the real parameters'.
    Reported: train_mfu (model FLOPs over 989e12 x the train phase's measured
    step; also without the input embedding's parameters) and roofline_share (the roofline's t_step over that step), the dry
    run's total_hbm_bytes beside the measured peak, the card and its limit.
    The real step's launches are a measurement's, not the main path's."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import tree
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rl
    from repro_torch.models import abstract_params, init_params
    from repro_torch.models.params import active_param_count
    from repro_torch.optim import adamw
    from repro_torch.train.step import init_state, train_step

    cfg = train_config()
    n_micro = train["n_micro"]
    shape = ShapeConfig("train_smoke", "train", TRAIN_SEQ, TRAIN_BATCH)
    t_phase = t0 = time.perf_counter()
    cell = dryrun.run_cell(cfg.name, one_rank=True, shape=shape, cfg=cfg, n_micro=n_micro,
                           device=DEVICE)
    dry_s = time.perf_counter() - t0

    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
    state = init_state(cfg, params, opt_cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH, seed=seed)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in SyntheticLM(data_cfg).batch(0).items()}
    mods = (softmax, rmsnorm, tsdiv)
    for m in mods:
        m.reset_launches()
    with FlopCounterMode(display=False) as fc:
        train_step(cfg, opt_cfg, state, batch, n_micro=n_micro)
    sync()
    real_launches = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
    n_leaves = len(tree.leaves(params))
    per_step = train_launches(cfg, n_micro, n_leaves)
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    real_bytes = nbytes(tree.leaves(params))
    abstract_bytes = nbytes(tree.leaves(abstract_params(cfg)))
    real_flops = fc.get_total_flops()
    del params, state, batch
    torch.cuda.empty_cache()

    roof = cell["roofline"]
    step_s = train["step_ms"] / 1e3
    # 6ND counts the input embedding's parameters, which a step gathers
    # and multiplies by nothing; the MFU without them is reported beside.
    n_params = active_param_count(cfg)
    n_embed = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    train_mfu = rl.measured_mfu(roof["model_flops"], step_s)
    result = {"arch": cfg.name, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "n_micro": n_micro,
              "remat": cfg.remat, "nvidia_smi": smi, "dry_run_s": dry_s,
              "model_flops": roof["model_flops"], "flops": roof["flops"],
              "real_step_flops": real_flops, "t_compute": roof["t_compute"],
              "t_memory": roof["t_memory"], "t_collective": roof["t_collective"],
              "bound": roof["bound"], "t_step": roof["t_step"],
              "step_ms": train["step_ms"], "train_mfu": train_mfu,
              "train_mfu_without_embedding": train_mfu * (n_params - n_embed) / n_params,
              "n_params": n_params, "n_embedding_params": n_embed,
              "roofline_share": roof["t_step"] / step_s, "roofline_mfu": roof["mfu"],
              "flops_efficiency": roof["flops_efficiency"],
              "hbm_traffic_model": cell["hbm_traffic_model"], "memory": cell["memory"],
              "total_hbm_gib": cell["memory"]["total_hbm_bytes"] / 2**30,
              "peak_gib": train["peak_gib"], "unit_calls": cell["unit_calls"],
              "launches_per_step": per_step, "real_step_launches": real_launches,
              "param_bytes": real_bytes, "abstract_param_bytes": abstract_bytes,
              "constants": {"PEAK_FLOPS": rl.PEAK_FLOPS, "HBM_BW": rl.HBM_BW},
              "seconds": time.perf_counter() - t_phase}
    check(roof["flops"] == real_flops,
          f"roofline: the fake step counts {roof['flops']} FLOPs, the real step {real_flops}")
    check(cell["unit_calls"] == per_step,
          f"roofline: the fake step's unit calls {cell['unit_calls']}, expected {per_step}")
    check(real_launches == per_step,
          f"roofline: the real step launched {real_launches}, expected {per_step}")
    check(abstract_bytes == real_bytes,
          f"roofline: abstract_params holds {abstract_bytes} bytes, the parameters {real_bytes}")
    say("roofline", **result)
    return result


# ------------------------------------------------------------------ mesh
# The mesh phase: MESH_RANKS ranks on the one card (launch.mesh.run_ranks,
# gloo: NCCL takes one GPU per rank), each its own process of one process
# group, against this process's single-process runs.
MESH_RANKS = 2
MESH_PLANE = (N_PLANE, 1024)    # the K-Means distance plane
MESH_CHUNK_ROWS = 15625         # the plane in 64 chunks of 15625 x 1024, 32 a rank
MESH_KM_ITERS = 10              # the K-Means cell (N_PLANE, D, K)
MESH_QR = (4096, 64, 64)
MESH_TRAIN_STEPS = 2
# The cross-pod trainer: paper_fpdiv on (pod 2, model 2), 4 ranks, its
# heads, MLP and vocab split over model and the int8 mean taken over pod
# on each rank's blocks; 4 x 2048 tokens a pod.
MESH_POD_MESH = (2, 2)
MESH_TRAIN_BATCH = 8
MESH_TIMEOUT_S = 600.0


def plane_rows(seed: int, chunks) -> tuple:
    """The plane's operands (a, b) at the rows of ``chunks``: chunk c from a
    generator seeded with (seed, c), so a rank makes only its own rows."""
    rows, cols = MESH_CHUNK_ROWS, MESH_PLANE[1]
    a = torch.empty((len(chunks) * rows, cols), device="cuda")
    b = torch.empty_like(a)
    for i, c in enumerate(chunks):
        g = torch.Generator(device="cuda").manual_seed(seed * 1000 + c)
        torch.randn((rows, cols), generator=g, device="cuda", out=a[i * rows:(i + 1) * rows])
        torch.rand((rows, cols), generator=g, device="cuda", out=b[i * rows:(i + 1) * rows])
    a.mul_(4.0)
    b.mul_(9.9).add_(0.1)
    return a, b


def plane_cases():
    """{kernel: (entry point on (a, b), plain version on (a, b), operands)}:
    the tiled ops at the main path's default config."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, ops

    table = compute_segments(2, 24)
    return {"tsdiv_divide": (lambda a, b: ops.tsdiv_divide(a, b),
                             lambda a, b: common.divide_f32_bits(a, b, table, 2, "factored"),
                             (0, 1)),
            "tsdiv_recip": (lambda a, b: ops.tsdiv_recip(a),
                            lambda a: common.recip_f32_bits(a, table, 2, "factored"), (0,)),
            "tsdiv_rsqrt": (lambda a, b: ops.tsdiv_rsqrt(b),
                            lambda b: common.rsqrt_f32_bits(b, rsqrt_seed_table(16), 2), (1,))}


def chunk_sums(y: torch.Tensor) -> list:
    return [bits_sum(y[i:i + MESH_CHUNK_ROWS]) for i in range(0, y.shape[0], MESH_CHUNK_ROWS)]


def fingerprint(t: torch.Tensor) -> tuple:
    """bits_sum and a position-weighted sum of the bit patterns."""
    ints = t.detach().reshape(-1).view({4: torch.int32, 2: torch.int16}[t.element_size()])
    w = torch.arange(ints.numel(), device=t.device) % 65521 + 1
    return bits_sum(t) + (int((ints.long() * w).sum()),)


SPLIT_PASSES = ("split_max", "split_exp", "split_scale")


def split_held(name: str, fn, got, args, kwargs):
    """(lanes differing, max abs error) of one pass of the split softmax
    kernel (``name``, its wrapper ``fn``, output ``got``) against its
    plain version on the same inputs."""
    import inspect

    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import softmax_split as ks

    a = inspect.signature(fn).bind(*args, **kwargs)
    a.apply_defaults()
    a = a.arguments
    if name == "split_max":
        return mismatch(got, ks.split_max_plain(a["x"]))
    if name == "split_exp":
        we, ws = ks.split_exp_plain(a["x"], a["top"].reshape(-1, 1))
        (b1, e1), (b2, e2) = mismatch(got[0], we), mismatch(got[1], ws)
        return b1 + b2, max(e1, e2)
    return mismatch(got, ks.split_scale_plain(
        a["ex"], a["total"].reshape(-1, 1), compute_segments(a["n_iters"], a["precision_bits"]),
        a["n_iters"], a["schedule"]))


@contextlib.contextmanager
def first_split_inputs(kept: dict):
    """While open, the first input of each shape that the split softmax's
    max pass is given, kept on the host in ``kept`` (shape -> rows): the
    times phase's inputs."""
    from repro_torch.kernels import softmax_split

    real = softmax_split.split_max

    def keep(x):
        if tuple(x.shape) not in kept:
            kept[tuple(x.shape)] = x.cpu()
        return real(x)

    softmax_split.split_max = keep
    try:
        yield kept
    finally:
        softmax_split.split_max = real


@contextlib.contextmanager
def held_kernels(held: list, kinds, on: bool = True, hold_s=None):
    """While open (and ``on``), every call of the kernels in ``kinds``
    (softmax_f32, rmsnorm_f32, tsdiv_recip, softmax_split_f32: each of its
    passes) through the kernel modules is held to its plain version on its
    own inputs: (kind, lanes differing, max abs error) appended to
    ``held``. ``hold_s``, a one-item list, adds up the seconds the holding
    took."""
    from repro_torch.core.seeds import compute_segments, rsqrt_seed_table
    from repro_torch.kernels import common, rmsnorm, softmax, softmax_split, tsdiv

    def hold(kind, fn):
        if hold_s is not None:
            sync()
        t0 = time.perf_counter()
        held.append((kind,) + fn())
        if hold_s is not None:
            sync()
            hold_s[0] += time.perf_counter() - t0

    def sm_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real["softmax"](x, n_iters, precision_bits, schedule)
        hold("softmax_f32", lambda: rows_held(got, softmax.softmax_plain, x, compute_segments(
            n_iters, precision_bits), n_iters, schedule))
        return got

    def rms_spy(x, w, eps=1e-6, newton_iters=2, n_segments=16):
        got = real["rmsnorm"](x, w, eps, newton_iters, n_segments)
        hold("rmsnorm_f32", lambda: rows_held(got, lambda xs: rmsnorm.rmsnorm_plain(
            xs, w, eps, rsqrt_seed_table(n_segments), newton_iters), x))
        return got

    def recip_spy(x, n_iters=2, precision_bits=24, schedule="factored"):
        got = real["recip"](x, n_iters, precision_bits, schedule)
        table = compute_segments(n_iters, precision_bits)
        hold("tsdiv_recip", lambda: held_to_plain(got, lambda v: common.recip_f32_bits(
            v, table, n_iters, schedule), x))
        return got

    def split_spy(name):
        def spy(*a, **k):
            got = real[name](*a, **k)
            hold("softmax_split_f32", lambda: split_held(name, real[name], got, a, k))
            return got
        return spy

    sites = {"softmax_f32": [(softmax, "softmax", sm_spy)],
             "rmsnorm_f32": [(rmsnorm, "rmsnorm", rms_spy)],
             "tsdiv_recip": [(tsdiv, "recip", recip_spy)],
             "softmax_split_f32": [(softmax_split, n, split_spy(n)) for n in SPLIT_PASSES]}
    real = {name: getattr(mod, name) for k in sites for mod, name, _ in sites[k]}
    try:
        if on:
            for k in kinds:
                for mod, name, spy in sites[k]:
                    setattr(mod, name, spy)
        yield held
    finally:
        for k in kinds:
            for mod, name, _ in sites[k]:
                setattr(mod, name, real[name])


def blocks_bit_equal(block: list, state) -> bool:
    """Whether each leaf of ``state``'s params, m and v is bit for bit the
    same on every rank of the process group that holds the same block of
    it; ``block``: this rank's coordinates on each leaf's split axes."""
    import torch.distributed as dist

    from repro_torch import tree

    prints = [fingerprint(t.to_local()) for t in
              tree.leaves((state.params, state.opt.m, state.opt.v))]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (block, prints))
    n = len(block)
    return all(e[1][i + k * n] == o[1][i + k * n] for e in every for o in every
               for k in range(3) for i in range(n) if e[0][i] == o[0][i])


def rank_plane(seed: int, mesh, rank: int, want: dict) -> dict:
    """The tiled dispatch on this rank's rows of the plane: one launch per
    op, no collective, held to the plain version, the parent's chunk
    checksums; then the kernels' times at the shard shape, one rank at a
    time."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.kernels import tsdiv
    from repro_torch.sharding import rules as shr

    per = MESH_PLANE[0] // MESH_CHUNK_ROWS // MESH_RANKS
    al, bl = plane_rows(seed, range(rank * per, (rank + 1) * per))
    pl = shr.batch_sharding(mesh, shr.batch_partition(mesh, MESH_PLANE[0]), 2).placements
    A, B = (DTensor.from_local(t, mesh, pl, run_check=False) for t in (al, bl))
    out = {}
    for name, (entry, plain, which) in plane_cases().items():
        tsdiv.reset_launches()
        with shr.use_mesh(mesh), CommDebugMode() as comm:
            y = entry(A, B)
        torch.cuda.synchronize()
        yl = y.to_local()
        n_bad, e = held_to_plain(yl, plain, *((al, bl)[i] for i in which))
        out[name] = {"launches": dict(tsdiv.LAUNCHES), "collectives": comm.get_total_counts(),
                     "placements": str(tuple(y.placements)), "mismatched_lanes": n_bad,
                     "max_abs_err": e, "shard_shape": list(yl.shape),
                     "checksums_equal": chunk_sums(yl) == want[name][rank * per:(rank + 1) * per]}
        del y, yl
    times = {}
    torch.cuda.synchronize()
    dist.barrier()                 # the other rank's checks are off the card
    for turn in range(MESH_RANKS):
        if turn == rank:
            times = plane_times(mesh, A, B)
        dist.barrier()
    return {"ops": out, "times": times}


def plane_times(mesh, A, B) -> dict:
    """Each tsdiv kernel at the shard shape: events and device time of the
    raw kernel on the rank's block, events of the ops entry point on the
    DTensors (the mesh dispatch around that launch), the plain version on
    PLAIN_ELEMENTS lanes, the torch call."""
    from repro_torch.kernels import tsdiv
    from repro_torch.sharding import rules as shr

    a, b = A.to_local(), B.to_local()
    xs, bs = a.view(-1)[:PLAIN_ELEMENTS].clone(), b.view(-1)[:PLAIN_ELEMENTS].clone()
    out = {}
    library = {"tsdiv_divide": lambda: torch.div(a, b), "tsdiv_recip": lambda: torch.reciprocal(a),
               "tsdiv_rsqrt": lambda: torch.rsqrt(b)}
    kernels = {"tsdiv_divide": lambda: tsdiv.divide(a, b), "tsdiv_recip": lambda: tsdiv.recip(a),
               "tsdiv_rsqrt": lambda: tsdiv.rsqrt(b)}
    for name, (entry, plain, which) in plane_cases().items():
        ops_ = [(xs, bs)[i] for i in which]
        with shr.use_mesh(mesh):
            dispatch_ms = event_ms(lambda: entry(A, B))
        out[name] = {"ms": event_ms(kernels[name]), "dispatch_ms": dispatch_ms,
                     "device_ms": device_ms(kernels[name], "elementwise_kernel"),
                     "plain_ms": event_ms(lambda: plain(*ops_), 3),
                     "library_ms": event_ms(library[name]),
                     "library_device_ms": device_ms(library[name])}
    return out


def rank_kmeans(seed: int, mesh, want: dict) -> dict:
    """kmeans_sharded on the K-Means cell, its centroid divides held to the
    plain version, against the parent's single-process run."""
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import common, tsdiv
    from repro_torch.sharding import rules as shr
    from repro_torch.workloads import kmeans

    n, d, k = N_PLANE, D, K
    x, init = kmeans_data(seed, n, d, k)
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    held, real = [], tsdiv.divide

    def spy(a, b, n_iters=2, precision_bits=24, schedule="factored"):
        got = real(a, b, n_iters, precision_bits, schedule)
        if a.numel() == k * d:                     # the centroid update
            table = compute_segments(n_iters, precision_bits)
            held.append(held_to_plain(got, lambda u, v: common.divide_f32_bits(
                u, v, table, n_iters, schedule), a, b))
        return got

    with shr.use_mesh(mesh):
        kmeans.kmeans_sharded(x, cfg=cfg, init=init, n_iters=1)  # warm-up
        torch.cuda.synchronize()
        tsdiv.reset_launches()
        tsdiv.divide = spy
        try:
            t0 = time.perf_counter()
            res = kmeans.kmeans_sharded(x, cfg=cfg, init=init, n_iters=MESH_KM_ITERS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            tsdiv.divide = real
    launches = dict(tsdiv.LAUNCHES)
    lo = shr.local_offset(shr.batch_sharding(mesh, shr.batch_partition(mesh, n), 2), 0, n)
    assign = res.assignments.to_local().cpu()
    c = res.centroids.cpu()
    ulps = (c.view(torch.int32).long() - want["centroids"].view(torch.int32).long()).abs()
    return {"ms": wall * 1e3, "launches": launches, "rows": assign.numel(),
            "assignments_differing": int((assign != want["assign"][lo:lo + assign.numel()]).sum()),
            "centroid_max_ulp": int(ulps.max()), "centroid_lanes_differing": int((ulps > 0).sum()),
            "inertia": float(res.inertia),
            "inertia_rel": abs(float(res.inertia) - want["inertia"]) / abs(want["inertia"]),
            "centroid_divides_held": len(held), "held_mismatched_lanes": sum(h[0] for h in held),
            "held_max_abs_err": max((h[1] for h in held), default=0.0)}


def rank_qr(seed: int, mesh, rank: int, want: dict) -> dict:
    """qr_givens_sharded on this rank's matrices, both ways, against the
    parent's batched run's fingerprints."""
    from repro_torch.core import division_modes as dm
    from repro_torch.kernels import tsdiv
    from repro_torch.sharding import rules as shr
    from repro_torch.workloads import qr

    a = qr_data(seed, MESH_QR)
    out = {}
    for via in ("div", "rsqrt"):
        tsdiv.reset_launches()
        t0 = time.perf_counter()
        with shr.use_mesh(mesh):
            q, r = qr.qr_givens_sharded(a, dm.DivisionConfig(mode="taylor_pallas"), via=via)
        torch.cuda.synchronize()
        out[via] = {"seconds": time.perf_counter() - t0, "launches": dict(tsdiv.LAUNCHES),
                    "matrices": q.to_local().shape[0],
                    "bits_equal": [fingerprint(q.to_local()), fingerprint(r.to_local())]
                    == want[via][rank]}
    return out


def pod_train_rank(rank: int, seed: int) -> dict:
    """One rank of paper_fpdiv trained on a ("pod", "model") =
    MESH_POD_MESH mesh, the gradients' cross-pod mean int8-compressed on the
    rank's blocks: every reciprocal held to its plain version, step 1's
    compressed mean against the exact f32 mean of the same blocks, each
    leaf compared across the ranks that hold its block after every step."""
    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.models.parallel import split_axes, tensor_parallel
    from repro_torch.optim import adamw, compress
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    rank_settings()
    cfg = train_config()
    mesh = make_mesh(MESH_POD_MESH, ("pod", "model"), "cuda")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    dev = DEVICE
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         shardings=shr.param_shardings(cfg, mesh))
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
    state = ts.init_state(cfg, params, opt_cfg)
    err_tree = compress.init_error_tree(params)
    plan = tensor_parallel(cfg, mesh)
    split = tree.leaves_at(split_axes(cfg, plan), plan.shardings)
    block = [tuple(coord[a] for a in (axes or ())) for axes in split]
    del params
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=MESH_TRAIN_BATCH, seed=seed))
    pods = MESH_POD_MESH[0]
    n_micro = max(1, MESH_TRAIN_BATCH // pods // cfg.train_microbatch_size)
    mods = (softmax, rmsnorm, tsdiv)
    real_psum = compress.psum_compressed
    held, hold_s, gate = [], [0.0], {}

    def psum_spy(grads, errs, axis_name, periods):
        mean, new = real_psum(grads, errs, axis_name, periods)
        if not gate:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            worst = 0.0
            gps = [g.float() + e for g, e in zip(tree.leaves(grads), tree.leaves(errs))]
            means = tree.leaves(mean)
            for group in compress.stacks(grads, periods):   # one scale a block of a stack
                top = comm.all_reduce(torch.stack([gps[i].abs().max() for i in group]).max(),
                                      mesh, [axis_name], op="max")
                bound = float(top) / 127.0 + 1e-6
                for i in group:
                    exact = comm.all_reduce(gps[i], mesh, [axis_name]) / pods
                    worst = max(worst, float((means[i] - exact).abs().max()) / bound)
            gate.update(worst_over_bound=worst, leaves=len(means))
            torch.cuda.synchronize()
            hold_s[0] += time.perf_counter() - t0
        return mean, new

    torch.cuda.reset_peak_memory_stats()
    free_gib = torch.cuda.mem_get_info()[0] / 2**30
    steps = []
    compress.psum_compressed = psum_spy
    try:
        for s in range(MESH_TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
            for m in mods:
                m.reset_launches()
            held.clear()
            hold_s[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with (held_kernels(held, ("tsdiv_recip",), hold_s=hold_s),
                  shr.use_mesh(mesh), CollectiveClock() as clock):
                state, metrics, err_tree = ts.train_step(cfg, opt_cfg, state, batch,
                                                         n_micro=n_micro, compress_axis="pod",
                                                         err_tree=err_tree)
                loss = float(metrics["loss"])
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            same_block = blocks_bit_equal(block, state)
            steps.append({"ms": wall * 1e3, "hold_ms": hold_s[0] * 1e3,
                          "net_ms": (wall - hold_s[0]) * 1e3, "loss": loss,
                          "launches": {k: v for m in mods for k, v in m.LAUNCHES.items() if v},
                          "recips_held": len(held), "held_mismatched_lanes": sum(h[1] for h in held),
                          "held_max_abs_err": max((h[2] for h in held), default=0.0),
                          "collectives": {"count": clock.count, "bytes": clock.bytes,
                                          "seconds": clock.seconds},
                          "ranks_bit_equal": same_block})
    finally:
        compress.psum_compressed = real_psum
    return {"arch": cfg.name, "layers": cfg.n_layers, "params_dtype": cfg.param_dtype,
            "n_leaves": len(split), "n_split": sum(a is not None for a in split),
            "err_blocks": all(hasattr(e, "placements") for e in tree.leaves(err_tree)),
            "n_micro": n_micro, "remat": cfg.remat, "batch_per_pod": MESH_TRAIN_BATCH // pods,
            "seq_len": TRAIN_SEQ, "steps": steps, "compressed_mean_gate": gate,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
            "card_free_gib_at_start": free_gib}


def mesh_rank(rank: int, seed: int, want: dict) -> dict:
    """One rank of the mesh phase: the tiled dispatch, K-Means, QR; returns
    its readings (the parent checks them)."""
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    # Two ranks and this phase's parent share one card: segments that grow
    # in place leave less reserved but unused.
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    mesh = make_host_mesh(device_type="cuda")                # (data 2, model 1)
    parts = (("plane", lambda: rank_plane(seed, mesh, rank, want["plane"])),
             ("kmeans", lambda: rank_kmeans(seed, mesh, want["kmeans"])),
             ("qr", lambda: rank_qr(seed, mesh, rank, want["qr"])))
    out = {}
    for part, run in parts:
        t0 = time.perf_counter()
        out[part] = run()
        torch.cuda.synchronize()
        out[part]["part_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def mesh_want(seed: int) -> dict:
    """This process's single-process runs, as the ranks compare with them:
    the plane's chunk checksums of each op (one launch over the whole
    plane), K-Means' centroids, assignments and inertia, QR's fingerprints
    per rank block."""
    from repro_torch.core import division_modes as dm
    from repro_torch.workloads import kmeans, qr

    a, b = plane_rows(seed, range(MESH_PLANE[0] // MESH_CHUNK_ROWS))
    plane = {}
    for name, (entry, _, _) in plane_cases().items():
        y = entry(a, b)
        plane[name] = chunk_sums(y)
        del y
    del a, b
    x, init = kmeans_data(seed)
    cfg = dm.DivisionConfig(mode="taylor_pallas")
    res = kmeans.kmeans(x, cfg=cfg, init=init, n_iters=MESH_KM_ITERS)
    km = {"centroids": res.centroids.cpu(), "assign": res.assignments.cpu(),
          "inertia": float(res.inertia)}
    del x, init, res
    a = qr_data(seed, MESH_QR)
    per = MESH_QR[0] // MESH_RANKS
    qrs = {}
    for via in ("div", "rsqrt"):
        q, r = qr.qr_givens_batched(a, cfg, via=via)
        qrs[via] = [[fingerprint(q[i * per:(i + 1) * per]), fingerprint(r[i * per:(i + 1) * per])]
                    for i in range(MESH_RANKS)]
        del q, r
    torch.cuda.empty_cache()
    return {"plane": plane, "kmeans": km, "qr": qrs}


TILED_SITES = {"tsdiv_divide": "src/repro/kernels/tsdiv.py:199",
               "tsdiv_recip": "src/repro/kernels/tsdiv.py:225",
               "tsdiv_rsqrt": "src/repro/kernels/tsdiv.py:252"}


def phase_mesh(seed: int, launches: dict, err: dict) -> dict:
    """The mesh phase: MESH_RANKS ranks on the one card (2 processes share it,
    so times are not a scaling figure). Gates: each tiled op one launch a
    rank on its shard, no collective, held to its plain version, its chunk
    checksums the single-process launch's; kmeans_sharded's assignments the
    single-process run's, centroids within 1 int ulp (the lanes that differ
    reported), inertia within 1e-6, its centroid divides held to plain; QR
    sharded bit-equal to batched (position-weighted fingerprints per rank
    block); the cross-pod trainer (paper_fpdiv on (pod, model) =
    MESH_POD_MESH, 4 more ranks): each leaf bit-equal on the ranks holding
    its block after every step, step 1's compressed mean within
    max|g'_block|/127 + 1e-6 of the exact f32 mean, its launches a step and
    every reciprocal held to plain. Returns the tiled kernels' times at the shard shape (rank 0's,
    the other rank idle) for phase_times_mesh."""
    from repro_torch.launch.mesh import run_ranks

    import gc

    t0 = time.perf_counter()
    want = mesh_want(seed)
    want_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30,
              "card_free_gib": torch.cuda.mem_get_info()[0] / 2**30}
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_RANKS, seed, want, device_type="cuda",
                      timeout_s=MESH_TIMEOUT_S)
    ranks_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tr = run_ranks(pod_train_rank, MESH_POD_MESH[0] * MESH_POD_MESH[1], seed,
                   device_type="cuda", timeout_s=MESH_TIMEOUT_S)
    train_s = time.perf_counter() - t0

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # The tiled dispatch on the plane.
    plane = [r["plane"]["ops"] for r in ranks]
    say("mesh", part="plane", shape=list(MESH_PLANE), ranks=MESH_RANKS, ops=plane,
        single_process_s=want_s, ranks_s=ranks_s, part_s=[r["plane"]["part_s"] for r in ranks],
        parent_memory=parent)
    for name in plane_cases():
        for ops_ in plane:
            o = ops_[name]
            add(o["launches"])
            err[name] = max(err[name], o["max_abs_err"])
            want_l = {k: int(k == name) for k in o["launches"]}
            check(o["launches"] == want_l, f"mesh {name}: launches {o['launches']}, want {want_l}")
            check(o["collectives"] == 0, f"mesh {name}: {o['collectives']} collectives")
            check(o["mismatched_lanes"] == 0, f"mesh {name}: {o['mismatched_lanes']} lanes differ")
            check(o["checksums_equal"], f"mesh {name}: not the single-process launch's bits")

    # kmeans_sharded.
    km = [r["kmeans"] for r in ranks]
    say("mesh", part="kmeans", n=N_PLANE, d=D, k=K, n_iters=MESH_KM_ITERS,
        mode="taylor_pallas", note="2 ranks share one card: not a scaling figure", ranks=km)
    for o in km:
        add(o["launches"])
        err["tsdiv_divide"] = max(err["tsdiv_divide"], o["held_max_abs_err"])
        want_d = 3 * MESH_KM_ITERS + 2
        check(o["launches"].get("tsdiv_divide", 0) == want_d,
              f"mesh kmeans: {o['launches']}, want {want_d} divides")
        check(o["assignments_differing"] == 0, f"mesh kmeans: {o['assignments_differing']} "
              "assignments differ from the single-process run")
        check(o["centroid_max_ulp"] <= 1, f"mesh kmeans: centroids {o['centroid_max_ulp']} ulp off")
        check(o["inertia_rel"] <= 1e-6, f"mesh kmeans: inertia {o['inertia_rel']} relative")
        check(o["centroid_divides_held"] == MESH_KM_ITERS and o["held_mismatched_lanes"] == 0,
              f"mesh kmeans: centroid divides held {o['centroid_divides_held']}, "
              f"{o['held_mismatched_lanes']} lanes differ")

    # qr_givens_sharded.
    q = [r["qr"] for r in ranks]
    say("mesh", part="qr", shape=list(MESH_QR), ranks=q)
    rotations = MESH_QR[1] * (MESH_QR[1] - 1) // 2
    for o in q:
        for via, name, n in (("div", "tsdiv_divide", 2 * rotations),
                             ("rsqrt", "tsdiv_rsqrt", rotations)):
            add(o[via]["launches"])
            check(o[via]["launches"].get(name, 0) == n,
                  f"mesh qr via={via}: {o[via]['launches']}")
            check(o[via]["bits_equal"], f"mesh qr via={via}: not the batched run's bits")

    # The cross-pod trainer.
    per_step = None
    for o in tr:
        L, n_micro = o["layers"], o["n_micro"]
        per_step = {"softmax_f32": n_micro * L * (1 + o["remat"]),
                    "rmsnorm_f32": n_micro * (2 * L * (1 + o["remat"]) + 1),
                    "tsdiv_recip": o["n_leaves"]}
        for s in o["steps"]:
            add(s["launches"])
            err["tsdiv_recip"] = max(err["tsdiv_recip"], s["held_max_abs_err"])
            check(s["launches"] == per_step,
                  f"mesh train: launches {s['launches']} a step, want {per_step}")
            check(s["recips_held"] == o["n_leaves"] and s["held_mismatched_lanes"] == 0,
                  f"mesh train: {s['recips_held']} reciprocals held, "
                  f"{s['held_mismatched_lanes']} lanes differ")
            check(s["ranks_bit_equal"], "mesh train: a block differs across its ranks")
            check(math.isfinite(s["loss"]), f"mesh train: loss {s['loss']}")
        check(o["n_split"] > 0 and o["err_blocks"],
              f"mesh train: {o['n_split']} split leaves, error tree as blocks {o['err_blocks']}")
        g = o["compressed_mean_gate"]
        check(g.get("leaves") == o["n_leaves"] and g["worst_over_bound"] <= 1.0,
              f"mesh train: compressed mean off by {g} of max|g'|/127 + 1e-6")
    step_ms = [float(np.median([s["net_ms"] for s in o["steps"][1:]] or [o["steps"][0]["net_ms"]]))
               for o in tr]
    say("mesh", part="train", arch=tr[0]["arch"], layers=tr[0]["layers"],
        params_dtype=tr[0]["params_dtype"], mesh=dict(zip(("pod", "model"), MESH_POD_MESH)),
        compress_axis="pod", batch_per_pod=tr[0]["batch_per_pod"], seq_len=tr[0]["seq_len"],
        n_micro=tr[0]["n_micro"], remat=tr[0]["remat"], launches_per_step=per_step,
        n_leaves=tr[0]["n_leaves"], n_split=tr[0]["n_split"],
        step_ms_net_of_holds=step_ms, peak_gib=[o["peak_gib"] for o in tr],
        peak_reserved_gib=[o["peak_reserved_gib"] for o in tr],
        card_free_gib_at_start=[o["card_free_gib_at_start"] for o in tr], ranks_s=train_s,
        note="4 ranks share one card: not a scaling figure",
        ranks=[{k: o[k] for k in ("steps", "compressed_mean_gate")} for o in tr])

    return {"shard_shape": plane[0]["tsdiv_divide"]["shard_shape"],
            "times": ranks[0]["plane"]["times"]}


def phase_times_mesh(err: dict, launches: dict, mesh: dict) -> list:
    """The tiled kernels at the mesh phase's shard shape (rank 0's times,
    taken while the other rank waited): ``ms`` and ``device_ms`` of the raw
    kernel on the rank's block, ``dispatch_ms`` of the ops entry point on
    the DTensors (the dispatch with its launch), beside the plain versions
    and the torch calls."""
    rows = []
    n = mesh["shard_shape"][0] * mesh["shard_shape"][1]
    for name, t in mesh["times"].items():
        rows.append(kernel_row(name, t["ms"], t["plain_ms"], t["library_ms"],
                               (12 if name == "tsdiv_divide" else 8) * n, n, launches, err,
                               replaces=TILED_SITES[name], site="mesh_shard", model="mesh",
                               ranks=MESH_RANKS, shape=mesh["shard_shape"],
                               plain_elements=PLAIN_ELEMENTS, device_ms=t["device_ms"],
                               dispatch_ms=t["dispatch_ms"],
                               library_device_ms=t["library_device_ms"]))
        say("times", **rows[-1])
    return rows


# ---------------------------------------------------------------- the tp phase

TP_ARCH = "llama3_8b"
TP_SERVE_MESH = (1, 2)            # (data, model): llama3_8b served on 2 ranks
# The command must stay well inside its time limit beside the ep and tp_ssm
# phases: the timed bf16 run is cut to 4 of llama3_8b's 32 layers (16 and 8
# until the tp_ssm phase took jamba's FSDP run, 8 until the sequence
# layouts joined this phase), the f32 gate to 4, and every run to 16 new
# tokens a prompt (MODEL_NEW, 32, until then).
TP_SERVE_DEPTH = 4
TP_F32_DEPTH = 4
TP_NEW = 16
TP_SERVE_LENS = (512, 384, 256, 128)   # f32 serve() against generate_batch
TP_TRAIN_MESH = (2, 2)            # paper_fpdiv trained on 4 ranks
TP_TRAIN_BATCH = 8                # x TRAIN_SEQ tokens a step: 4 a data rank, 2 microbatches
TP_TRAIN_MICRO = 2
TP_TRAIN_STEPS = 2
TP_STEP_RTOL = {"params": 1e-4, "m": 1e-5, "v": 1e-5}   # tests/test_torch_tensor_parallel.py
TP_TIMEOUT_S = 900.0


def rank_settings() -> None:
    """A rank's matmul precision, the parent's (no TF32, no
    reduced-precision bf16 sums), and, as the mesh phase's ranks, segments
    that grow in place on the shared card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")


def tp_mesh(shape):
    """A (data, model) mesh over this rank's group, under rank_settings,
    after the rank's first draw of blocks (jamba's smoke config under its
    own rules, bf16): a process's first init_params(shardings=) took
    8-11 s a rank on the card, its second under a second (mamba2_780m and
    jamba, PERF.md §6), and in_turn's draws would pay the first one rank
    after another; here the ranks pay it at once."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    rank_settings()
    mesh = make_mesh(shape, ("data", "model"), "cuda")
    cfg = dataclasses.replace(get_smoke_config(HYBRID.arch), param_dtype="bfloat16",
                              sharding_rules=get_config(HYBRID.arch).sharding_rules)
    init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                shardings=shr.param_shardings(cfg, mesh))
    sync()
    return mesh


def tp_model(seed: int, mesh, param_dtype: str, **repl):
    """TP_ARCH at full width from ``seed`` as model_setup draws it, the
    rank keeping its blocks (``init_params(shardings=)``), in taylor_pallas;
    with ``mesh`` None the whole model in this process."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    cfg = dataclasses.replace(get_config(TP_ARCH), param_dtype=param_dtype, **repl)
    cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division,
                                                                mode="taylor_pallas"))
    sh = None if mesh is None else shr.param_shardings(cfg, mesh)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in MODEL_LENS]
    return cfg, params, prompts


class CollectiveClock:
    """Seconds spent inside ``sharding.comm``'s all-reduce, all-gather,
    all-to-all and reduce-scatter (each started after a synchronize, so the
    clock holds the collective's host copies and gloo's exchange, not the
    work queued before it), and their count and bytes, while the block
    runs."""

    NAMES = ("all_reduce", "all_gather", "all_to_all", "reduce_scatter")

    def __init__(self):
        self.seconds, self.count, self.bytes = 0.0, 0, 0
        self.by_op = {n: {"seconds": 0.0, "count": 0, "bytes": 0} for n in self.NAMES}

    def __enter__(self):
        from repro_torch.sharding import comm

        self.real = tuple(getattr(comm, n) for n in self.NAMES)

        def clocked(name, real):
            def run(t, *a, **k):
                sync()
                t0 = time.perf_counter()
                out = real(t, *a, **k)
                dt, nbytes = time.perf_counter() - t0, t.numel() * t.element_size()
                self.seconds += dt
                self.count += 1
                self.bytes += nbytes
                op = self.by_op[name]
                op["seconds"] += dt
                op["count"] += 1
                op["bytes"] += nbytes
                return out
            return run

        for n, f in zip(self.NAMES, self.real):
            setattr(comm, n, clocked(n, f))
        return self

    def __exit__(self, *exc):
        from repro_torch.sharding import comm

        for n, f in zip(self.NAMES, self.real):
            setattr(comm, n, f)


def tp_timed(eng, prompts, new: int = MODEL_NEW, warm: bool = True) -> dict:
    """generate_batch over ``prompts`` (``new`` new tokens) after a
    warm-up (``warm``): tokens, launches, the prefill's and the decode
    steps' times (and the collectives' share of each, in all and by op),
    peak memory."""
    from repro_torch.kernels import rmsnorm, softmax, tsdiv

    if warm:
        eng.generate_batch([prompts[-1][:16]], max_new=2)
    sync()
    torch.cuda.reset_peak_memory_stats()
    for m in (softmax, rmsnorm, tsdiv):
        m.reset_launches()
    real, seen = eng._prefill_tok, {}

    def timed_prefill(*a):
        with CollectiveClock() as pre:
            t0 = time.perf_counter()
            out = real(*a)
            sync()
            seen["prefill_s"] = time.perf_counter() - t0
        seen["prefill"] = pre
        return out

    eng._prefill_tok = timed_prefill
    t0 = time.perf_counter()
    try:
        with CollectiveClock() as clock:        # the prefill's are counted in both
            toks = eng.generate_batch(prompts, max_new=new)
            sync()
    finally:
        del eng._prefill_tok     # the class's method again, and no cycle holding eng
    wall = time.perf_counter() - t0
    pre = seen["prefill"]
    decode_s = wall - seen["prefill_s"]
    counts = {k: v for m in (softmax, rmsnorm, tsdiv) for k, v in m.LAUNCHES.items() if v}
    return {"tokens": toks, "launches": counts,
            "generate_batch_s": wall, "prefill_ms": seen["prefill_s"] * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / new,
            "prefill_collectives": {"count": pre.count, "bytes": pre.bytes,
                                    "seconds": pre.seconds,
                                    "share": pre.seconds / seen["prefill_s"]},
            "decode_collectives": {"count": clock.count - pre.count,
                                   "bytes": clock.bytes - pre.bytes,
                                   "seconds": clock.seconds - pre.seconds,
                                   "share": (clock.seconds - pre.seconds) / decode_s},
            "prefill_by_op": {n: {**v, "share": v["seconds"] / seen["prefill_s"]}
                              for n, v in pre.by_op.items() if v["count"]},
            "decode_by_op": {n: {k: v[k] - pre.by_op[n][k] for k in v}
                             | {"share": (v["seconds"] - pre.by_op[n]["seconds"]) / decode_s}
                             for n, v in clock.by_op.items() if v["count"] > pre.by_op[n]["count"]},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def allreduce_times(mesh, rows: int, width: int) -> dict:
    """One (rows, width) all-reduce over the model axis, the prefill's
    size, three ways (3 reps, median ms): bf16 on the card (comm.all_reduce:
    device -> host -> gloo -> device), f32 on the card, bf16 on the host
    (gloo alone)."""
    import torch.distributed as dist

    from repro_torch.sharding import comm

    out = {}
    for name, dt, dev in (("bf16_card", torch.bfloat16, DEVICE),
                          ("f32_card", torch.float32, DEVICE),
                          ("bf16_host_gloo_only", torch.bfloat16, "cpu")):
        t = torch.ones((rows, width), dtype=dt, device=dev)
        times = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            if dev == "cpu":
                dist.all_reduce(t, group=mesh.get_group("model"))
            else:
                comm.all_reduce(t, mesh, ("model",))
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times))
    return out


def tp_want(seed: int) -> dict:
    """This process's unsharded runs of TP_ARCH, as the serving ranks are
    held to them: bf16 generate_batch (tokens and times), and at
    TP_F32_DEPTH in f32 the greedy stream and its logits (replay)."""
    from repro_torch.serving import ServingEngine

    cfg, params, prompts = tp_model(seed, None, "bfloat16", n_layers=TP_SERVE_DEPTH)
    eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, TP_NEW))
    bf16 = tp_timed(eng, prompts, TP_NEW)
    del eng, params
    torch.cuda.empty_cache()
    cfg, params, prompts = tp_model(seed, None, "float32", n_layers=TP_F32_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, TP_NEW))
    teacher, logits = replay(eng, prompts, TP_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del eng, params
    logits = logits.cpu()
    torch.cuda.empty_cache()
    return {"bf16": bf16, "teacher": teacher, "logits": logits, "f32_peak_gib": peak}


def tp_serve_rank(rank: int, seed: int, teacher) -> dict:
    """One rank of the tp phase's serving part on TP_SERVE_MESH: bf16 at
    full width (the timed generate_batch, every kernel call of one prefill
    and one decode step held to its plain version), then f32 at
    TP_F32_DEPTH (the replay under the unsharded run's teacher stream,
    generate_batch, serve() with MODEL_SLOTS slots)."""
    from repro_torch import tree
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules as shr

    mesh = tp_mesh(TP_SERVE_MESH)
    out = {}
    cfg, params, prompts = tp_model(seed, mesh, "bfloat16", n_layers=TP_SERVE_DEPTH)
    out["allreduce_ms"] = allreduce_times(mesh, len(MODEL_LENS) * max(MODEL_LENS), cfg.d_model)
    err = {"softmax_f32": 0.0, "rmsnorm_f32": 0.0, "tsdiv_recip": 0.0}
    with shr.use_mesh(mesh):
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, TP_NEW))
        out["bf16"] = tp_timed(eng, prompts, TP_NEW)
        t0 = time.perf_counter()
        rows, _ = held_calls(eng, prompts, err, keep=set())
        out["held"] = {"rows": rows, "err": err, "seconds": time.perf_counter() - t0}
    out["param_gib"] = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree.leaves(params)) / 2**30
    del eng, params
    torch.cuda.empty_cache()
    cfg, params, prompts = tp_model(seed, mesh, "float32", n_layers=TP_F32_DEPTH)
    torch.cuda.reset_peak_memory_stats()
    with shr.use_mesh(mesh):
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, TP_NEW))
        t0 = time.perf_counter()
        picks, logits = replay(eng, prompts, TP_NEW, teacher)
        out["f32_replay_s"] = time.perf_counter() - t0
        out["f32_picks"], out["f32_logits"] = picks, logits.cpu()
        del logits
        short = [p[:n] for p, n in zip(prompts, TP_SERVE_LENS)]
        gb = eng.generate_batch(short, TP_NEW)
        reqs = [Request(list(p), max_new=TP_NEW) for p in short]
        t0 = time.perf_counter()
        eng.serve(reqs, slots=MODEL_SLOTS)
        out["f32_serve_s"] = time.perf_counter() - t0
    out["f32_generate_batch"], out["f32_serve"] = gb, [r.out for r in reqs]
    out["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng
    out["seq"] = tp_seq_layouts(cfg, params, prompts, mesh, teacher)
    return out


def tp_seq_layouts(cfg, params, prompts, mesh, teacher) -> dict:
    """The sequence layouts on the tp phase's f32 blocks (TP_F32_DEPTH):
    the prompts' prefill under ``seq_shard`` (the last real position's
    logits; its time and the base layout's, in turns), the teacher-forced
    replay under ``kvseq`` (its launches), and every kernel call of one
    prefill and one decode step of each held to its plain version."""
    from repro_torch.kernels import rmsnorm, softmax, softmax_split, tsdiv
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import rules as shr

    rules = cfg.sharding_rules
    layouts = {"base": cfg,
               "seq_shard": dataclasses.replace(cfg, sharding_rules={
                   **rules, "__seq_shard__": "model"}),
               "kvseq": dataclasses.replace(cfg, sharding_rules={
                   **rules, "__kv_seq_shard__": "model"})}
    n = cache_len(cfg, prompts, TP_NEW)
    max_len = -(-n // TP_SERVE_MESH[1]) * TP_SERVE_MESH[1]    # the slots split over model
    err = {"softmax_f32": 0.0, "rmsnorm_f32": 0.0, "tsdiv_recip": 0.0, "softmax_split_f32": 0.0}
    out = {"prefill_ms": {}, "prefill_collectives": {}}
    with shr.use_mesh(mesh):
        engs = {k: ServingEngine(c, params, max_len=max_len) for k, c in layouts.items()}
        for k in ("base", "seq_shard"):
            sync()
            t0 = time.perf_counter()
            with CollectiveClock() as clock:
                logits = prefill_batch(engs[k], prompts)[0]
                sync()
            ms = (time.perf_counter() - t0) * 1e3
            out["prefill_ms"][k] = ms
            out["prefill_collectives"][k] = {
                n_: {"count": v["count"], "bytes": v["bytes"], "share": v["seconds"] * 1e3 / ms}
                for n_, v in clock.by_op.items() if v["count"]}
            if k == "seq_shard":
                out["seq_prefill_logits"] = logits.cpu()
            del logits
        mods = (softmax, rmsnorm, tsdiv, softmax_split)
        for m in mods:
            m.reset_launches()
        sync()
        t0 = time.perf_counter()
        with first_split_inputs({}) as kept:
            picks, logits = replay(engs["kvseq"], prompts, TP_NEW, teacher)
        out["kv_replay_s"] = time.perf_counter() - t0
        out["split_inputs"] = kept
        out["kv_launches"] = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        out["kv_picks"], out["kv_logits"] = picks, logits.cpu()
        del logits
        short = [p[:n] for p, n in zip(prompts, TP_SERVE_LENS)]
        out["held"] = {k: held_calls(engs[k], short, err, recip=True, keep=set())[0]
                       for k in ("seq_shard", "kvseq")}
    out["held_err"] = err
    out["kv_cache_slots"] = max_len // TP_SERVE_MESH[1]
    return out


def tp_train_rank(rank: int, seed: int, seq_teacher) -> dict:
    """One rank of the tp phase's training part on TP_TRAIN_MESH:
    paper_fpdiv at full width, TP_TRAIN_STEPS steps in bf16 (launches,
    every kernel call of the first step held to its plain version on rank
    0, the ranks' leaves compared after every step), then one f32 step
    from the same seed and the same step under ``seq_shard``, their
    states gathered, and on rank 0 the single-process step on the same
    global batch; then, on the same mesh, the seq phase's decode
    (``seq_on_mesh``, under the unsharded run's ``seq_teacher``): one spawn
    of 4 ranks fewer."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.models import init_params
    from repro_torch.models.parallel import split_axes, tensor_parallel
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    mesh = tp_mesh(TP_TRAIN_MESH)
    mods = (softmax, rmsnorm, tsdiv)
    cfg = train_config()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TP_TRAIN_BATCH, seed=seed))
    batch_of = lambda s: {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(s).items()}

    def placed(cfg):
        sh = shr.param_shardings(cfg, mesh)
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        return opt_cfg, ts.init_state(cfg, params, opt_cfg)

    opt_cfg, state = placed(cfg)
    split = tree.leaves(split_axes(cfg, tensor_parallel(cfg, mesh)))
    held = []

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(TP_TRAIN_STEPS):
        batch = batch_of(s)
        for m in mods:
            m.reset_launches()
        spying = s == 0 and rank == 0
        sync()
        t0 = time.perf_counter()
        with (held_kernels(held, ("softmax_f32", "rmsnorm_f32", "tsdiv_recip"), on=spying),
              shr.use_mesh(mesh), CollectiveClock() as clock):
            state, metrics = ts.train_step(cfg, opt_cfg, state, batch, n_micro=TP_TRAIN_MICRO)
            loss = float(metrics["loss"])
            sync()
        wall = time.perf_counter() - t0
        prints = [fingerprint(t.to_local()) for t in
                  tree.leaves((state.params, state.opt.m, state.opt.v))]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, prints)
        n = len(split)
        rep_equal = all(all(e[i + k * n] == every[0][i + k * n] for e in every)
                        for k in range(3) for i in range(n) if split[i] is None)
        data_equal = all(every[a][i] == every[b][i] for a, b in ((0, 2), (1, 3))
                         for i in range(3 * n))
        steps.append({"ms": wall * 1e3, "loss": loss, "spied": spying,
                      "collectives": {"count": clock.count, "bytes": clock.bytes,
                                      "seconds": clock.seconds, "share": clock.seconds / wall},
                      "launches": {k: v for m in mods for k, v in m.LAUNCHES.items() if v},
                      "replicated_bit_equal": rep_equal, "data_peers_bit_equal": data_equal})
    out = {"steps": steps, "n_leaves": len(split), "n_split": sum(a is not None for a in split),
           "held": [(k, int(b), float(e)) for k, b, e in held],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    torch.cuda.empty_cache()

    # One f32 step against the single-process step on the same global batch.
    cfg32 = train_config(param_dtype="float32")
    opt32, state = placed(cfg32)
    batch = batch_of(TP_TRAIN_STEPS)
    with shr.use_mesh(mesh):
        new, metrics = ts.train_step(cfg32, opt32, state, batch, n_micro=TP_TRAIN_MICRO)
    got = {k: [shr.global_tensor(t) for t in tree.leaves(v)]
           for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
    tp_loss = float(metrics["loss"])
    del new, state
    # The same step with the residual stream split by sequence over model.
    cfg_seq = dataclasses.replace(cfg32, sharding_rules={**cfg32.sharding_rules,
                                                         "__seq_shard__": "model"})
    opt_seq, state = placed(cfg_seq)
    sync()
    t0 = time.perf_counter()
    with shr.use_mesh(mesh), CollectiveClock() as clock:
        new, metrics = ts.train_step(cfg_seq, opt_seq, state, batch, n_micro=TP_TRAIN_MICRO)
        sync()
    seq_ms = (time.perf_counter() - t0) * 1e3
    got_seq = {k: [shr.global_tensor(t) for t in tree.leaves(v)]
               for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
    seq_loss = float(metrics["loss"])
    out["seq_step"] = {"ms": seq_ms, "collectives": {
        n: {"count": v["count"], "bytes": v["bytes"], "share": v["seconds"] * 1e3 / seq_ms}
        for n, v in clock.by_op.items() if v["count"]}}
    del new, state
    if rank == 0:
        out.update(tp_single_step(cfg32, opt32, seed, batch, got, tp_loss, got_seq, seq_loss,
                                  out["seq_step"]))
    del got, got_seq
    torch.cuda.empty_cache()
    out["seq"] = seq_on_mesh(mesh, seed, seq_teacher)
    return out


def tp_single_step(cfg32, opt32, seed: int, batch, got, tp_loss, got_seq, seq_loss,
                   seq_step) -> dict:
    """Rank 0's single-process f32 step on the tp phase's global batch, and
    the split steps' readings against it."""
    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.train import step as ts

    out = {}
    params = init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(seed))
    single, m1 = ts.train_step(cfg32, opt32, ts.init_state(cfg32, params, opt32), batch,
                               n_micro=TP_TRAIN_MICRO * TP_TRAIN_MESH[0])
    want = {"params": single.params, "m": single.opt.m, "v": single.opt.v}
    worst = {k: max(float((g - w).abs().max()) / float(w.abs().max())
                    for g, w in zip(got[k], tree.leaves(want[k]))) for k in got}
    out["f32_step"] = {"loss": tp_loss, "single_loss": float(m1["loss"]),
                       "loss_rel": abs(tp_loss - float(m1["loss"])) / abs(float(m1["loss"])),
                       "worst_over_leaf_max": worst}
    out["seq_step"] = dict(seq_step, **{
        "loss": seq_loss,
        "loss_rel": abs(seq_loss - float(m1["loss"])) / abs(float(m1["loss"])),
        "worst_over_leaf_max": {k: max(float((g - w).abs().max()) / float(w.abs().max())
                                       for g, w in zip(got_seq[k], tree.leaves(want[k])))
                                for k in got_seq}})
    del params, single, want
    return out


def phase_tp(seed: int, launches: dict, err: dict) -> dict:
    """The tp phase: tensor parallelism over the model axis, its ranks
    sharing the one card over gloo (every all-reduce through host copies:
    the times are not a speed figure). Serving: TP_ARCH at full width and
    depth TP_SERVE_DEPTH on TP_SERVE_MESH in bf16 (a softmax a layer and two
    RMSNorms a layer and one more, a forward and rank; every call of one prefill and one decode step held to
    plain on each rank; tokens against this process's unsharded run,
    reported), and in f32 at TP_F32_DEPTH the gate of test_decode_equiv
    against the unsharded run (>= 99% of teacher-forced tokens, logit
    drift < 5e-3) and serve() against generate_batch on prompts of
    TP_SERVE_LENS (>= 99%); the collectives' share of the prefill and the
    decode steps, and one all-reduce at the prefill's size. Training:
    paper_fpdiv on TP_TRAIN_MESH, TP_TRAIN_STEPS steps (the data-parallel
    run's 48 / 98 / 111 launches a step and rank, every call of step 1 held
    to plain on rank 0, replicated leaves bit-equal on all ranks and split
    blocks on the data peers after every step), and one f32 step against
    the single-process step (loss within 1e-5 relative, the state within
    TP_STEP_RTOL of each leaf's largest value). The sequence layouts:
    ``tp_seq_layouts`` on the f32 serving ranks (``check_tp_seq``), the
    f32 step under ``seq_shard``, and the seq part (``seq_want`` here,
    ``seq_on_mesh`` on the training ranks, ``check_seq``)."""
    import gc

    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    want = tp_want(seed)
    want_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30,
              "card_free_gib": torch.cuda.mem_get_info()[0] / 2**30}
    n_serve = TP_SERVE_MESH[0] * TP_SERVE_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(tp_serve_rank, n_serve, seed, want["teacher"], device_type="cuda",
                      timeout_s=TP_TIMEOUT_S)
    serve_s = time.perf_counter() - t0

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # One softmax an attention layer, two RMSNorms a block and the final
    # one: 16 and 33 at TP_SERVE_DEPTH.
    depth = TP_SERVE_DEPTH
    per_forward = {"softmax_f32": depth, "rmsnorm_f32": 2 * depth + 1}
    forwards = 1 + TP_NEW
    n_tok = len(MODEL_LENS) * TP_NEW
    for o in ranks:
        add(o["bf16"]["launches"])
        check(o["bf16"]["launches"] == {k: v * forwards for k, v in per_forward.items()},
              f"tp serve launches {o['bf16']['launches']}, expected {per_forward} x {forwards}")
        rows = o["held"]["rows"]
        calls = {f"{k}/{st}": sum(1 for r in rows if r[:2] == (k, st))
                 for st in ("prefill", "decode") for k in per_forward}
        check(calls == {f"{k}/{st}": v for st in ("prefill", "decode")
                        for k, v in per_forward.items()}, f"tp serve held calls {calls}")
        check(all(r[3] == 0 for r in rows), f"tp serve: a call differs from the plain version: "
              f"{[r for r in rows if r[3]]}")
        for k, e in o["held"]["err"].items():
            err[k] = max(err[k], e)
        check(o["f32_picks"].tolist() == ranks[0]["f32_picks"].tolist(),
              "tp serve: the ranks chose different tokens")
    logits = torch.cat([o["f32_logits"] for o in ranks], -1)
    drift = float((logits - want["logits"]).abs().max() / want["logits"].abs().max())
    agree = float((ranks[0]["f32_picks"] == want["teacher"]).mean())
    serve_diff = sum(a != b for r, g in zip(ranks[0]["f32_serve"], ranks[0]["f32_generate_batch"])
                     for a, b in zip(r, g))
    bf16_same = sum(a == b for r, g in zip(ranks[0]["bf16"]["tokens"], want["bf16"]["tokens"])
                    for a, b in zip(r, g))
    say("tp", part="serve", arch=TP_ARCH, mesh=dict(zip(("data", "model"), TP_SERVE_MESH)),
        prompt_lens=list(MODEL_LENS), max_new=TP_NEW, launches_per_forward=per_forward,
        allreduce_ms_at_prefill_size=[o["allreduce_ms"] for o in ranks],
        bf16={"prefill_ms": [o["bf16"]["prefill_ms"] for o in ranks],
              "decode_ms_per_step": [o["bf16"]["decode_ms_per_step"] for o in ranks],
              "prefill_collectives": [o["bf16"]["prefill_collectives"] for o in ranks],
              "decode_collectives": [o["bf16"]["decode_collectives"] for o in ranks],
              "generate_batch_s": [o["bf16"]["generate_batch_s"] for o in ranks],
              "peak_gib": [o["bf16"]["peak_gib"] for o in ranks],
              "param_gib": [o["param_gib"] for o in ranks],
              "unsharded": {k: want["bf16"][k] for k in ("prefill_ms", "decode_ms_per_step",
                                                         "generate_batch_s", "peak_gib")},
              "tokens_equal_to_unsharded": bf16_same / n_tok},
        held={"calls_per_rank": len(ranks[0]["held"]["rows"]),
              "mismatched_lanes": sum(r[3] for o in ranks for r in o["held"]["rows"]),
              "seconds": [o["held"]["seconds"] for o in ranks]},
        f32={"depth": TP_F32_DEPTH, "teacher_forced_agreement": agree, "logit_drift": drift,
             "serve_prompt_lens": list(TP_SERVE_LENS), "serve_slots": MODEL_SLOTS,
             "serve_tokens_differing": serve_diff,
             "serve_agreement": 1 - serve_diff / n_tok,
             "replay_s": [o["f32_replay_s"] for o in ranks],
             "serve_s": [o["f32_serve_s"] for o in ranks],
             "peak_gib": [o["f32_peak_gib"] for o in ranks],
             "unsharded_peak_gib": want["f32_peak_gib"]},
        unsharded_s=want_s, ranks_s=serve_s, parent_memory=parent,
        note="ranks share one card over gloo: every all-reduce through host copies")
    check(agree >= 0.99, f"tp serve: teacher-forced agreement {agree} < 0.99")
    check(drift < 5e-3, f"tp serve: logit drift {drift} >= 5e-3")
    check(1 - serve_diff / n_tok >= 0.99, f"tp serve: serve() differs on {serve_diff} tokens")
    check(all(len(o) == TP_NEW for o in ranks[0]["bf16"]["tokens"]), "tp serve: short output")
    split_inputs = {(s, f"tp: {TP_ARCH}'s kvseq decode on (1, 2)"): x
                    for s, x in ranks[0]["seq"].pop("split_inputs").items()}
    check_tp_seq(ranks, want, launches, err)
    del ranks, want, logits
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    seq = seq_want(seed)
    seq["seconds"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    n_train = TP_TRAIN_MESH[0] * TP_TRAIN_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(tp_train_rank, n_train, seed, seq["teacher"], device_type="cuda",
                      timeout_s=TP_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    for s, x in ranks[0]["seq"].pop("split_inputs").items():
        layer = "global" if s[-1] == SEQ_SLOTS // SEQ_MESH[0] else "sliding-window"
        split_inputs[s, f"seq: {SEQ_ARCH}'s {layer} layer at batch 1, its cache over data 2"] = x
    check_seq([o["seq"] for o in ranks], seq, launches, err, train_s)
    per_step = train_launches(train_config(), TP_TRAIN_MICRO, ranks[0]["n_leaves"])
    for o in ranks:
        for st in o["steps"]:
            add(st["launches"])
            check(st["launches"] == per_step, f"tp train launches {st['launches']} a step, "
                  f"want {per_step}")
            check(st["replicated_bit_equal"], "tp train: a replicated leaf differs across ranks")
            check(st["data_peers_bit_equal"], "tp train: a block differs across data peers")
            check(math.isfinite(st["loss"]), f"tp train: loss {st['loss']}")
    held = ranks[0]["held"]
    n_held = {k: sum(1 for h in held if h[0] == k) for k in per_step}
    check(n_held == per_step, f"tp train: held calls {n_held}, want {per_step}")
    check(all(h[1] == 0 for h in held), "tp train: a call differs from its plain version")
    for k, _, e in held:
        err[k] = max(err[k], e)
    f32 = ranks[0]["f32_step"]
    say("tp", part="train", arch="paper_fpdiv", mesh=dict(zip(("data", "model"), TP_TRAIN_MESH)),
        batch=TP_TRAIN_BATCH, seq_len=TRAIN_SEQ, n_micro_per_data_rank=TP_TRAIN_MICRO,
        n_leaves=ranks[0]["n_leaves"], n_split=ranks[0]["n_split"],
        launches_per_step=per_step, held_calls=n_held,
        step_ms=[[st["ms"] for st in o["steps"]] for o in ranks],
        step_collectives=[[st["collectives"] for st in o["steps"]] for o in ranks],
        losses=[st["loss"] for st in ranks[0]["steps"]],
        peak_gib=[o["peak_gib"] for o in ranks], f32_step=f32, ranks_s=train_s,
        note="4 ranks share one card over gloo; rank 0's step 1 includes its held calls")
    seq = ranks[0]["seq_step"]
    say("tp", part="train_seq_shard", arch="paper_fpdiv",
        mesh=dict(zip(("data", "model"), TP_TRAIN_MESH)), f32_step=seq,
        step_ms=[o["seq_step"]["ms"] for o in ranks],
        collectives=[o["seq_step"]["collectives"] for o in ranks],
        note="the f32 step with __seq_shard__ = model against the single-process step")
    for name, f in (("f32", f32), ("f32 seq_shard", seq)):
        check(f["loss_rel"] <= 1e-5, f"tp train {name}: loss {f['loss_rel']} relative")
        for k, tol in TP_STEP_RTOL.items():
            check(f["worst_over_leaf_max"][k] <= tol,
                  f"tp train {name}: {k} off by {f['worst_over_leaf_max'][k]} of the leaf's max")
    return {"serve_s": serve_s, "train_s": train_s, "split_inputs": split_inputs}


def phase_times_split(err: dict, launches: dict, inputs: dict) -> list:
    """The split softmax kernel's three passes on the main path's own rows,
    kept by the tp phase (``first_split_inputs``; ``inputs``: (shape, site)
    -> rows): rank 0's scores in the seq part's first decode step, of
    gemma3_12b's global layer (its query heads' rows over its SEQ_SLOTS / 2
    slots) and of a sliding-window layer, and in llama3_8b's first
    ``kvseq`` step. One rank's work without the all-reduces between the
    passes (on one rank they compute the row softmax), held bit for bit to
    its plain version, beside the plain version and ``torch.softmax`` of
    the same rows, with each pass's device ms; the bound: the rows read
    once and the output written once (the three passes' own traffic, five
    times the rows' bytes, beside it)."""
    from repro_torch.configs import get_config
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import softmax_split as ks

    div = dataclasses.replace(get_config(SEQ_ARCH).division, mode="taylor_pallas")
    n, bits, sched = div.n_iters, div.precision_bits, dm._kernel_schedule(div)
    table = compute_segments(n, bits)
    rows = []
    for (shape, site), x in sorted(inputs.items(), key=lambda kv: -kv[0][0][-1]):
        x = x.to(DEVICE)

        def kernel():
            e, s = ks.split_exp(x, ks.split_max(x))
            return ks.split_scale(e, s, n, bits, sched)

        def plain():
            e, s = ks.split_exp_plain(x, ks.split_max_plain(x))
            return ks.split_scale_plain(e, s, table, n, sched)

        n_bad, e = mismatch(kernel(), plain())
        check(n_bad == 0, f"softmax_split_f32 {shape}: {n_bad} lanes differ from the plain version")
        err["softmax_split_f32"] = max(err["softmax_split_f32"], e)
        library = lambda: torch.softmax(x, -1)
        times = device_times(kernel)
        passes = {p: summed_ms(times, p) for p in ("split_max", "split_exp", "split_scale")}
        nbytes = x.numel() * x.element_size()
        row = kernel_row("softmax_split_f32", event_ms(kernel), event_ms(plain, 3),
                         event_ms(library), 2 * nbytes, x.numel(), launches, err,
                         shape=list(shape), dtype="float32", step="decode", passes=3,
                         device_ms=summed_ms(times, "split_"),
                         pass_device_ms=passes,
                         three_pass_bytes_ms=5 * nbytes / HBM_BYTES_PER_S * 1e3,
                         library_device_ms=device_ms(library), site=site)
        say("times", **row)
        rows.append(row)
        del x
    torch.cuda.empty_cache()
    return rows


def check_tp_seq(ranks: list, want: dict, launches: dict, err: dict) -> None:
    """The tp phase's sequence layouts (``tp_seq_layouts``) against the
    unsharded f32 run: the seq_shard prefill's last logits (drift < 5e-3
    over the largest), the kvseq teacher-forced stream (>= 99% of tokens,
    drift < 5e-3) and its launches (3 TP_F32_DEPTH split softmax passes a
    decode step, in the softmax kernel's place), every held call at 0
    lanes."""
    d = TP_F32_DEPTH
    parts = [o["seq"] for o in ranks]
    ref = want["logits"]
    drift = lambda got, w: float((got - w).abs().max() / w.abs().max())
    seq_drift = drift(torch.cat([p["seq_prefill_logits"] for p in parts], -1), ref[0])
    kv_drift = drift(torch.cat([p["kv_logits"] for p in parts], -1), ref)
    kv_agree = float((parts[0]["kv_picks"] == want["teacher"]).mean())
    kv_want = {"softmax_f32": d, "rmsnorm_f32": (2 * d + 1) * (1 + TP_NEW),
               "softmax_split_f32": 3 * d * TP_NEW}

    def calls(rows):
        return {f"{kind}/{st}": sum(1 for r in rows if r[:2] == (kind, st))
                for kind in ("softmax_f32", "rmsnorm_f32", "tsdiv_recip", "softmax_split_f32")
                for st in ("prefill", "decode")}

    held_want = {k: {"softmax_f32/prefill": d, "softmax_f32/decode": 0 if k == "kvseq" else d,
                     "rmsnorm_f32/prefill": 2 * d + 1, "rmsnorm_f32/decode": 2 * d + 1,
                     "tsdiv_recip/prefill": 0, "tsdiv_recip/decode": 0,
                     "softmax_split_f32/prefill": 0,
                     "softmax_split_f32/decode": 3 * d if k == "kvseq" else 0}
                 for k in ("seq_shard", "kvseq")}
    say("tp", part="seq_layouts", arch=TP_ARCH, depth=d,
        mesh=dict(zip(("data", "model"), TP_SERVE_MESH)), prompt_lens=list(MODEL_LENS),
        seq_shard={"prefill_logit_drift": seq_drift,
                   "prefill_ms": [p["prefill_ms"]["seq_shard"] for p in parts],
                   "base_prefill_ms": [p["prefill_ms"]["base"] for p in parts],
                   "prefill_collectives": [p["prefill_collectives"]["seq_shard"]
                                           for p in parts],
                   "base_prefill_collectives": [p["prefill_collectives"]["base"]
                                                for p in parts]},
        kvseq={"teacher_forced_agreement": kv_agree, "logit_drift": kv_drift,
               "cache_slots_a_rank": parts[0]["kv_cache_slots"],
               "launches": [p["kv_launches"] for p in parts],
               "replay_s": [p["kv_replay_s"] for p in parts]},
        held={"calls_a_rank": {k: calls(rows) for k, rows in parts[0]["held"].items()},
              "mismatched_lanes": sum(r[3] for p in parts for rows in p["held"].values()
                                      for r in rows)},
        note="ranks share one card over gloo: the times are not a speed figure")
    for p in parts:
        for k, v in p["kv_launches"].items():
            launches[k] = launches.get(k, 0) + v
        check(p["kv_launches"] == kv_want, f"tp kvseq launches {p['kv_launches']}, "
              f"want {kv_want}")
        for k, e in p["held_err"].items():
            err[k] = max(err[k], e)
        for k, rows in p["held"].items():
            check(calls(rows) == held_want[k], f"tp {k} held calls {calls(rows)}")
            check(all(r[3] == 0 for r in rows),
                  f"tp {k}: a call differs from its plain version")
    check(seq_drift < 5e-3, f"tp seq_shard prefill: logit drift {seq_drift} >= 5e-3")
    check(kv_agree >= 0.99, f"tp kvseq: teacher-forced agreement {kv_agree} < 0.99")
    check(kv_drift < 5e-3, f"tp kvseq: logit drift {kv_drift} >= 5e-3")


# ---------------------------------------------------------------- the ep phase

EP_ARCH = "deepseek_moe_16b"
EP_MESH = (2, 2)                  # (data, model): experts on data, expert_mlp on model
EP_LENS = (512, 384, 256, 128)    # (1024, 768, 512, 256) and 8 new tokens until the
EP_NEW = 4                        # sequence layouts joined the command (16 new before)
EP_F32_DEPTH = 4                  # the f32 gate's depth: one dense, three MoE layers
EP_SERVE_DEPTH = 14               # the timed bf16 run: one dense, 13 MoE layers (28 until the
                                  # sequence layouts joined the command)
EP_TRAIN_DEPTH = 2                # one dense, one MoE layer (4 until the command outgrew its
                                  # time limit); AdamW's f32 moments of all 16.4 B: 131 GB
# The 4 ranks' train states share the one card: with f32 moments a rank of
# the 4-layer cut peaks at ~20 GiB in AdamW (old and new state, the f32
# gradients; the vocab blocks are held on both data rows), and 4 of them do
# not fit in 79 GiB. bf16 moments (the reference's "optbf16" variant) halve
# them; the f32 step at EP_F32_STEP_DEPTH keeps f32 moments.
EP_TRAIN_OPT_DTYPE = "bfloat16"
EP_F32_STEP_DEPTH = 2             # the f32 step beside the single-process one
EP_TRAIN_BATCH, EP_TRAIN_SEQ = 4, 1024   # 2 rows a data rank, 1 a microbatch
EP_TRAIN_MICRO, EP_TRAIN_STEPS = 2, 2
EP_TIMEOUT_S = 900.0


def ep_model(seed: int, mesh, param_dtype: str, **repl):
    """EP_ARCH at full width from ``seed`` as model_setup draws it, the rank
    keeping its blocks (``init_params(shardings=)``), in taylor_pallas, with
    prompts of EP_LENS; with ``mesh`` None the whole model here."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    cfg = dataclasses.replace(get_config(EP_ARCH), param_dtype=param_dtype, **repl)
    cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division,
                                                                mode="taylor_pallas"))
    sh = None if mesh is None else shr.param_shardings(cfg, mesh)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in EP_LENS]
    return cfg, params, prompts


def ep_want(seed: int) -> dict:
    """This process's unsharded f32 run of EP_ARCH at EP_F32_DEPTH (capacity
    factor MOE_GATE_CF): the greedy stream and its logits (replay)."""
    from repro_torch.serving import ServingEngine

    cfg, params, prompts = ep_model(seed, None, "float32", n_layers=EP_F32_DEPTH,
                                    capacity_factor=MOE_GATE_CF)
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, EP_NEW))
    teacher, logits = replay(eng, prompts, EP_NEW)
    peak = torch.cuda.max_memory_allocated() / 2**30
    del eng, params
    logits = logits.cpu()
    torch.cuda.empty_cache()
    return {"teacher": teacher, "logits": logits, "f32_peak_gib": peak}


def ep_serve_rank(rank: int, seed: int, teacher) -> dict:
    """One rank of the ep phase's serving part on EP_MESH: bf16 at full
    width (the timed generate_batch, every kernel call of one prefill and
    one decode step held to its plain version), then f32 at EP_F32_DEPTH
    (the replay under the unsharded run's teacher stream, generate_batch,
    serve() with MODEL_SLOTS slots)."""
    from repro_torch import tree
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules as shr

    mesh = tp_mesh(EP_MESH)
    out = {}
    t0 = time.perf_counter()
    cfg, params, prompts = ep_model(seed, mesh, "bfloat16", n_layers=EP_SERVE_DEPTH)
    out["init_s"] = time.perf_counter() - t0
    err = {"softmax_f32": 0.0, "rmsnorm_f32": 0.0, "tsdiv_recip": 0.0}
    with shr.use_mesh(mesh):
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, EP_NEW))
        out["bf16"] = tp_timed(eng, prompts, EP_NEW)
        t0 = time.perf_counter()
        rows, _ = held_calls(eng, prompts, err, recip=True, keep=set())
        out["held"] = {"rows": rows, "err": err, "seconds": time.perf_counter() - t0}
    out["param_gib"] = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree.leaves(params)) / 2**30
    del eng, params
    torch.cuda.empty_cache()
    cfg, params, prompts = ep_model(seed, mesh, "float32", n_layers=EP_F32_DEPTH,
                                    capacity_factor=MOE_GATE_CF)
    torch.cuda.reset_peak_memory_stats()
    with shr.use_mesh(mesh):
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, EP_NEW))
        picks, logits = replay(eng, prompts, EP_NEW, teacher)
        out["f32_picks"], out["f32_logits"] = picks, logits.cpu()
        del logits
        gb = eng.generate_batch(prompts, EP_NEW)
        reqs = [Request(list(p), max_new=EP_NEW) for p in prompts]
        t0 = time.perf_counter()
        eng.serve(reqs, slots=MODEL_SLOTS)
        out["f32_serve_s"] = time.perf_counter() - t0
    out["f32_generate_batch"], out["f32_serve"] = gb, [r.out for r in reqs]
    out["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def ep_train_config(param_dtype: str, n_layers: int, **repl):
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(EP_ARCH), param_dtype=param_dtype, n_layers=n_layers,
                              **repl)
    return dataclasses.replace(cfg, division=dm_config("taylor_pallas"))


def ep_train_launches(cfg, n_micro: int, n_leaves: int) -> dict:
    """Launches per step and rank, from the code: per microbatch one softmax
    per attention layer and per MoE layer (its router), two RMSNorms per
    block plus the final one, one reciprocal per MoE layer (the top-k sums),
    each block's again in the backward pass when ``cfg.remat``; one
    reciprocal per parameter leaf in AdamW."""
    runs = 1 + cfg.remat
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    return {"softmax_f32": n_micro * (cfg.n_layers + n_moe) * runs,
            "rmsnorm_f32": n_micro * (2 * cfg.n_layers * runs + 1),
            "tsdiv_recip": n_micro * n_moe * runs + n_leaves}


def on_rank0(x):
    """The global value of the DTensor ``x`` on rank 0, on the host (None on
    the other ranks): each rank sends its block to rank 0 once, where an
    all-gather through every mesh axis would hand every rank the whole
    leaf. Point to point: gloo's gather moves large blocks slower than its
    sends (``tools/gloo_rates.py``)."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard

    local = x.to_local().detach().to("cpu").contiguous()
    if dist.get_rank() != 0:
        dist.send(local, dst=0)
        return None
    parts = [local] + [torch.empty_like(local) for _ in range(1, dist.get_world_size())]
    for r in range(1, len(parts)):
        dist.recv(parts[r], src=r)
    mesh = x.device_mesh
    coords = {int(r): c for c, r in np.ndenumerate(mesh.mesh.numpy())}
    out = torch.empty(tuple(x.shape), dtype=local.dtype)
    for r, part in enumerate(parts):
        where = []
        for d in range(x.dim()):
            n, i = 1, 0
            for md, pl in enumerate(x.placements):       # the first mesh axis major
                if isinstance(pl, Shard) and pl.dim == d:
                    n, i = n * mesh.shape[md], i * mesh.shape[md] + coords[r][md]
            step = x.shape[d] // n
            where.append(slice(i * step, (i + 1) * step))
        out[tuple(where)] = part
    return out


def ep_train_rank(rank: int, seed: int) -> dict:
    """One rank of the ep phase's training part on EP_MESH: EP_ARCH at full
    width and EP_TRAIN_DEPTH layers, EP_TRAIN_STEPS steps in bf16 on
    SyntheticLM batches split over data (launches, every kernel call of
    the first step held to its plain version on rank 0, the leaves compared
    across the ranks that hold the same block after every step), then one
    f32 step at EP_F32_STEP_DEPTH from the same seed, its state gathered,
    and on rank 0 the single-process step on the same global batch."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, softmax, tsdiv
    from repro_torch.models import init_params
    from repro_torch.models.parallel import split_axes, tensor_parallel
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    mesh = tp_mesh(EP_MESH)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    mods = (softmax, rmsnorm, tsdiv)
    cfg = ep_train_config("bfloat16", EP_TRAIN_DEPTH, opt_state_dtype=EP_TRAIN_OPT_DTYPE)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=EP_TRAIN_SEQ,
                                  global_batch=EP_TRAIN_BATCH, seed=seed))
    batch_of = lambda s: {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(s).items()}

    def placed(cfg):
        sh = shr.param_shardings(cfg, mesh)
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        return opt_cfg, ts.init_state(cfg, params, opt_cfg)

    opt_cfg, state = placed(cfg)
    plan = tensor_parallel(cfg, mesh)
    split = tree.leaves_at(split_axes(cfg, plan), plan.shardings)
    # The ranks that hold the same block of a leaf: its coordinates on the
    # leaf's split axes.
    block = [tuple(coord[a] for a in (axes or ())) for axes in split]
    held = []

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(EP_TRAIN_STEPS):
        batch = batch_of(s)
        for m in mods:
            m.reset_launches()
        spying = s == 0 and rank == 0
        sync()
        t0 = time.perf_counter()
        with (held_kernels(held, ("softmax_f32", "rmsnorm_f32", "tsdiv_recip"), on=spying),
              shr.use_mesh(mesh), CollectiveClock() as clock):
            state, metrics = ts.train_step(cfg, opt_cfg, state, batch,
                                           n_micro=EP_TRAIN_MICRO)
            loss = float(metrics["loss"])
            sync()
        wall = time.perf_counter() - t0
        same_block = blocks_bit_equal(block, state)
        steps.append({"ms": wall * 1e3, "loss": loss, "spied": spying,
                      "collectives": {"count": clock.count, "bytes": clock.bytes,
                                      "seconds": clock.seconds, "share": clock.seconds / wall},
                      "launches": {k: v for m in mods for k, v in m.LAUNCHES.items() if v},
                      "same_blocks_bit_equal": same_block})
    out = {"steps": steps, "n_leaves": len(split), "n_split": sum(a is not None for a in split),
           "split_axes": sorted({a for axes in split if axes for a in axes}),
           "held": [(k, int(b), float(e)) for k, b, e in held],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    torch.cuda.empty_cache()

    # One f32 step against the single-process step on the same global batch.
    cfg32 = ep_train_config("float32", EP_F32_STEP_DEPTH)
    opt32, state = placed(cfg32)
    batch = batch_of(EP_TRAIN_STEPS)
    with shr.use_mesh(mesh):
        new, metrics = ts.train_step(cfg32, opt32, state, batch, n_micro=EP_TRAIN_MICRO)
    got = {k: [on_rank0(t) for t in tree.leaves(v)]
           for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
    ep_loss = float(metrics["loss"])
    del new, state
    torch.cuda.empty_cache()
    dist.barrier()             # the other ranks' states are gone before rank 0's step
    if rank != 0:
        return out
    params = init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(seed))
    single, m1 = ts.train_step(cfg32, opt32, ts.init_state(cfg32, params, opt32), batch,
                               n_micro=EP_TRAIN_MICRO)
    out["f32_step"] = step_gate(got, single, ep_loss, float(m1["loss"]), opt32.lr)
    return out


def phase_ep(seed: int, launches: dict, err: dict) -> dict:
    """The ep phase: expert parallelism for the MoE FFN, 4 ranks sharing the
    one card over gloo (every collective through host copies: the times
    are not a speed figure). Serving: EP_ARCH at full width and depth on
    EP_MESH in bf16 (55 softmax, 57 RMSNorm and 27 reciprocal launches a
    forward and rank; every call of one prefill and one decode step held to
    plain on each rank), and in f32 at EP_F32_DEPTH (capacity factor
    MOE_GATE_CF) the gate of test_decode_equiv against the unsharded run
    (>= 99% of teacher-forced tokens, logit drift < 5e-3) and serve()
    against generate_batch (>= 99%); the collectives' share of the prefill
    and the decode steps. Training: EP_TRAIN_DEPTH layers on EP_MESH,
    EP_TRAIN_STEPS steps with the batch split over data, AdamW's moments in
    EP_TRAIN_OPT_DTYPE (launches a step
    and rank from the code, every call of step 1 held to plain on rank 0,
    each leaf bit-equal on the ranks that hold the same block after every
    step), and one f32 step at EP_F32_STEP_DEPTH against the single-process
    step (loss within 1e-5 relative, m and v within TP_STEP_RTOL, the
    parameters within it where the single run's first moment is above the m
    gate's resolution, elsewhere within one AdamW step's reach, 2 lr: there
    the gradient's sign is the two sum orders' noise)."""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    want = ep_want(seed)
    want_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30,
              "card_free_gib": torch.cuda.mem_get_info()[0] / 2**30}
    n_ranks = EP_MESH[0] * EP_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(ep_serve_rank, n_ranks, seed, want["teacher"], device_type="cuda",
                      timeout_s=EP_TIMEOUT_S)
    serve_s = time.perf_counter() - t0

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    cfg = get_config(EP_ARCH)
    # MOE.per_forward at EP_SERVE_DEPTH: one dense layer, the rest MoE.
    d = EP_SERVE_DEPTH
    per_forward = {"softmax_f32": d + d - 1, "rmsnorm_f32": 2 * d + 1, "tsdiv_recip": d - 1}
    forwards = 1 + EP_NEW
    n_tok = len(EP_LENS) * EP_NEW
    for o in ranks:
        add(o["bf16"]["launches"])
        check(o["bf16"]["launches"] == {k: v * forwards for k, v in per_forward.items()},
              f"ep serve launches {o['bf16']['launches']}, expected {per_forward} x {forwards}")
        rows = o["held"]["rows"]
        calls = {f"{k}/{st}": sum(1 for r in rows if r[:2] == (k, st))
                 for st in ("prefill", "decode") for k in per_forward}
        check(calls == {f"{k}/{st}": v for st in ("prefill", "decode")
                        for k, v in per_forward.items()}, f"ep serve held calls {calls}")
        check(all(r[3] == 0 for r in rows), f"ep serve: a call differs from the plain version: "
              f"{[r for r in rows if r[3]]}")
        for k, e in o["held"]["err"].items():
            err[k] = max(err[k], e)
        check(o["f32_picks"].tolist() == ranks[0]["f32_picks"].tolist(),
              "ep serve: the ranks chose different tokens")
    # The logits are split over vocab on model: ranks 0 and 1 hold the halves.
    logits = torch.cat([ranks[r]["f32_logits"] for r in range(EP_MESH[1])], -1)
    drift = float((logits - want["logits"]).abs().max() / want["logits"].abs().max())
    agree = float((ranks[0]["f32_picks"] == want["teacher"]).mean())
    serve_diff = sum(a != b for r, g in zip(ranks[0]["f32_serve"], ranks[0]["f32_generate_batch"])
                     for a, b in zip(r, g))
    say("ep", part="serve", arch=EP_ARCH, mesh=dict(zip(("data", "model"), EP_MESH)),
        experts_per_rank=cfg.n_experts // EP_MESH[0], prompt_lens=list(EP_LENS),
        max_new=EP_NEW, launches_per_forward=per_forward,
        bf16={"prefill_ms": [o["bf16"]["prefill_ms"] for o in ranks],
              "decode_ms_per_step": [o["bf16"]["decode_ms_per_step"] for o in ranks],
              "prefill_collectives": [o["bf16"]["prefill_collectives"] for o in ranks],
              "decode_collectives": [o["bf16"]["decode_collectives"] for o in ranks],
              "generate_batch_s": [o["bf16"]["generate_batch_s"] for o in ranks],
              "peak_gib": [o["bf16"]["peak_gib"] for o in ranks],
              "param_gib": [o["param_gib"] for o in ranks],
              "init_s": [o["init_s"] for o in ranks]},
        held={"calls_per_rank": len(ranks[0]["held"]["rows"]),
              "mismatched_lanes": sum(r[3] for o in ranks for r in o["held"]["rows"]),
              "seconds": [o["held"]["seconds"] for o in ranks]},
        f32={"depth": EP_F32_DEPTH, "capacity_factor": MOE_GATE_CF,
             "teacher_forced_agreement": agree, "logit_drift": drift,
             "serve_slots": MODEL_SLOTS, "serve_tokens_differing": serve_diff,
             "serve_agreement": 1 - serve_diff / n_tok,
             "serve_s": [o["f32_serve_s"] for o in ranks],
             "peak_gib": [o["f32_peak_gib"] for o in ranks],
             "unsharded_peak_gib": want["f32_peak_gib"]},
        unsharded_s=want_s, ranks_s=serve_s, parent_memory=parent,
        note="ranks share one card over gloo: every collective through host copies")
    check(agree >= 0.99, f"ep serve: teacher-forced agreement {agree} < 0.99")
    check(drift < 5e-3, f"ep serve: logit drift {drift} >= 5e-3")
    check(1 - serve_diff / n_tok >= 0.99, f"ep serve: serve() differs on {serve_diff} tokens")
    check(all(len(o) == EP_NEW for o in ranks[0]["bf16"]["tokens"]), "ep serve: short output")
    del ranks, want, logits
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(ep_train_rank, n_ranks, seed, device_type="cuda", timeout_s=EP_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    per_step = ep_train_launches(ep_train_config("bfloat16", EP_TRAIN_DEPTH), EP_TRAIN_MICRO,
                                 ranks[0]["n_leaves"])
    for o in ranks:
        for st in o["steps"]:
            add(st["launches"])
            check(st["launches"] == per_step, f"ep train launches {st['launches']} a step, "
                  f"want {per_step}")
            check(st["same_blocks_bit_equal"], "ep train: a block differs across its ranks")
            check(math.isfinite(st["loss"]), f"ep train: loss {st['loss']}")
    held = ranks[0]["held"]
    n_held = {k: sum(1 for h in held if h[0] == k) for k in per_step}
    check(n_held == per_step, f"ep train: held calls {n_held}, want {per_step}")
    check(all(h[1] == 0 for h in held), "ep train: a call differs from its plain version")
    for k, _, e in held:
        err[k] = max(err[k], e)
    f32 = ranks[0]["f32_step"]
    say("ep", part="train", arch=EP_ARCH, mesh=dict(zip(("data", "model"), EP_MESH)),
        n_layers=EP_TRAIN_DEPTH, opt_state_dtype=EP_TRAIN_OPT_DTYPE, batch=EP_TRAIN_BATCH,
        seq_len=EP_TRAIN_SEQ,
        n_micro_per_data_rank=EP_TRAIN_MICRO, n_leaves=ranks[0]["n_leaves"],
        n_split=ranks[0]["n_split"], split_axes=ranks[0]["split_axes"],
        launches_per_step=per_step, held_calls=n_held,
        step_ms=[[st["ms"] for st in o["steps"]] for o in ranks],
        step_collectives=[[st["collectives"] for st in o["steps"]] for o in ranks],
        losses=[st["loss"] for st in ranks[0]["steps"]],
        peak_gib=[o["peak_gib"] for o in ranks], f32_step_depth=EP_F32_STEP_DEPTH,
        f32_step=f32, ranks_s=train_s,
        note="4 ranks share one card over gloo; rank 0's step 1 includes its held calls")
    check_step_gate("ep", f32)
    return {"serve_s": serve_s, "train_s": train_s}


# -------------------------------------------------------------- the tp_ssm phase

SSM_TP_MESH = (1, 2)              # (data, model): the Mamba-2 mixers by heads on 2 ranks
# mamba2_780m cut to 24 of its 48 layers, the timed run and the f32 gate
# (full depth until the sequence layouts joined the command).
SSM_TP_SERVED = (dataclasses.replace(SSM, per_forward={"rmsnorm_f32": 2 * 24 + 1},
                                     gate_depth={"n_layers": 24}, depth={"n_layers": 24}),)
SSM_TP_LENS = TP_SERVE_LENS       # (512, 384, 256, 128): the tp phase's f32 serve() prompts
SSM_TP_NEW = 4                    # 8 until jamba's FSDP gates joined the phase
SSM_TP_TRAIN_MESH = (2, 2)        # mamba2_780m trained on 4 ranks at full width
SSM_TP_TRAIN_DEPTH = 6            # of its 48 layers (48, 24, then 12, as the FSDP run grew)
SSM_TP_TRAIN_BATCH, SSM_TP_TRAIN_SEQ = 8, 256   # 4 rows a data rank, 2 a microbatch
SSM_TP_TRAIN_MICRO, SSM_TP_TRAIN_STEPS = 2, 2
# The f32 step's depth: its state is gathered through host copies (params,
# m and v of all 48 layers: 9.4 GB in f32) before it is held to the single
# process, which took most of a minute on the H100.
SSM_TP_F32_STEP_DEPTH = 8
SSM_TP_TIMEOUT_S = 900.0
# The f32 step against the single process. At full width the Mamba leaves'
# gradients (A_log, dt_bias, conv_B / conv_C, wB / wC: sums over every token
# and head, with much cancellation) carry a sum-order noise far above
# TP_STEP_RTOL's elementwise 1e-5 of a leaf's max: m 3.9e-4 to 1.4e-3 and v
# 3.8e-4 to 2.2e-3 there, the more the fewer tokens a step has (8 x 1024, 8 x
# 256 and 4 x 256 tokens; PERF.md §6, tp_ssm), and AdamW's first step moves an
# element by ~lr * sign(g), so where g lies below that noise the two runs'
# parameters differ by up to 2 lr (PERF.md §6, ep). So the step is held
# leaf by leaf in the L2 norm: m and v within SSM_TP_STATE_L2 of the leaf's
# norm (read 2.2e-4 and 3.2e-4 on 8 x 256 tokens, 7.2e-4 and 1.9e-3 on 4 x
# 256; on the CPU at full width and 3 layers 1.7e-5 and 2.0e-5,
# tools/ssm_step_noise.py), the parameters within SSM_TP_PARAMS_L2 (1.3e-4
# and 1.8e-4; the CPU 1.8e-5; the zero-init A_log
# and dt_bias, whose norm is the step's own, are not) and every parameter
# within one AdamW step's reach, 2 lr, plus TP_STEP_RTOL of its leaf's
# largest value. A missing sum over a mesh axis moves m by 7-8% and v by 15%
# of a leaf's largest value (tests/test_torch_ssm_parallel.py run on a copy
# with the wB / wC sum dropped), past either bound.
SSM_TP_STATE_L2 = 1e-2
SSM_TP_PARAMS_L2 = 1e-3
# jamba under its own rules on (data 2, model 2): embed on data (FSDP, each
# leaf stored as its block and gathered before use), experts on data,
# expert_mlp, heads and the Mamba-2 heads on model. Every forward gathers
# the FSDP leaves through gloo's host copies (~2.3 GB a rank at the
# 5-layer cut in bf16), so few tokens are decoded.
FSDP_MESH = (2, 2)
FSDP_LENS = (512, 256)
FSDP_NEW = 1                      # one decode step: ~8 s of gathers
FSDP_TRAIN_DEPTH = 1              # Mamba + dense FFN (2 layers: ~97 GB for 4 ranks)
FSDP_TRAIN_BATCH, FSDP_TRAIN_SEQ, FSDP_TRAIN_MICRO = 8, 256, 1


def in_turn(fn):
    """``fn()`` on each rank of the process group in turn, the others
    waiting at a barrier, and the cache it leaves freed: each rank's
    ``init_params(shardings=)`` draws every leaf whole before it keeps its
    block (jamba's expert leaves are 12.9 GB in f32), and two ranks doing
    so at once do not fit beside their blocks on the shared card."""
    import torch.distributed as dist

    out = None
    for r in range(dist.get_world_size()):
        if dist.get_rank() == r:
            out = fn()
            sync()
            torch.cuda.empty_cache()
        dist.barrier()
    return out


def ssm_model(sv: Serving, seed: int, mesh, param_dtype: str, lens, **repl):
    """``sv.arch`` at full width from ``seed`` as model_setup draws it
    (``repl`` cuts its depth), the rank keeping its blocks
    (``init_params(shardings=)``, the ranks drawing in turn), in
    taylor_pallas, with prompts of ``lens``; with ``mesh`` None the whole
    model here."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    cfg = dataclasses.replace(get_config(sv.arch), param_dtype=param_dtype, **repl)
    cfg = dataclasses.replace(cfg, division=dm_config("taylor_pallas"))
    draw = lambda sh=None: init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                                       shardings=sh)
    params = draw() if mesh is None else in_turn(lambda: draw(shr.param_shardings(cfg, mesh)))
    rng = np.random.default_rng(seed + 11)
    return cfg, params, [rng.integers(1, cfg.vocab, n).tolist() for n in lens]


def ssm_gate(sv: Serving) -> tuple:
    """(config replacements, prompt lengths) of ``sv``'s f32 gate: its
    gate depth and capacity factor; jamba's prompts of 512 and 256."""
    repl = dict(sv.gate_depth)
    if sv.gate_cf is not None:
        repl["capacity_factor"] = sv.gate_cf
    return repl, sv.gate_lens or SSM_TP_LENS


def ssm_want(seed: int, served) -> dict:
    """This process's unsharded f32 runs at the gate of each Serving in
    ``served``: the greedy stream and its logits (replay)."""
    from repro_torch.serving import ServingEngine

    out = {}
    for sv in served:
        repl, lens = ssm_gate(sv)
        cfg, params, prompts = ssm_model(sv, seed, None, "float32", lens, **repl)
        torch.cuda.reset_peak_memory_stats()
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, SSM_TP_NEW))
        teacher, logits = replay(eng, prompts, SSM_TP_NEW)
        out[sv.phase] = {"teacher": teacher, "logits": logits.cpu(), "depth": cfg.n_layers,
                         "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del eng, params, logits
        torch.cuda.empty_cache()
    return out


def f32_gate(outs: list, w: dict) -> dict:
    """The f32 gate's readings of ``outs``, the readings of one rank of each
    model block in model order, against the unsharded run ``w``: the
    teacher-forced agreement and logit drift (over the largest logit), and
    serve() against generate_batch on the first rank."""
    full = w["logits"].shape[-1]
    parts = [o["f32_logits"] for o in outs]
    logits = parts[0] if parts[0].shape[-1] == full else torch.cat(parts, -1)
    n_tok = sum(len(t) for t in outs[0]["f32_generate_batch"])
    serve_diff = sum(a != b for r, g in zip(outs[0]["f32_serve"], outs[0]["f32_generate_batch"])
                     for a, b in zip(r, g))
    return {"teacher_forced_agreement": float((outs[0]["f32_picks"] == w["teacher"]).mean()),
            "logit_drift": float((logits - w["logits"]).abs().max() / w["logits"].abs().max()),
            "serve_tokens_differing": serve_diff, "serve_agreement": 1 - serve_diff / n_tok}


def check_f32_gate(what: str, gate: dict) -> None:
    """test_decode_equiv's gate: >= 99% of teacher-forced tokens, logit drift
    < 5e-3; serve() against generate_batch >= 99%."""
    agree, drift = gate["teacher_forced_agreement"], gate["logit_drift"]
    check(agree >= 0.99, f"{what}: teacher-forced agreement {agree} < 0.99")
    check(drift < 5e-3, f"{what}: logit drift {drift} >= 5e-3")
    check(gate["serve_agreement"] >= 0.99,
          f"{what}: serve() differs on {gate['serve_tokens_differing']} tokens")


def ssm_serve_rank(rank: int, seed: int, teachers: dict) -> dict:
    """One rank of the tp_ssm phase's serving part on SSM_TP_MESH, for each
    model of SSM_TP_SERVED: bf16 at full width and its serving depth (the
    timed generate_batch, every kernel call of one prefill and one decode
    step held to its plain version), then f32 at its gate (the replay
    under the unsharded run's teacher stream, generate_batch and serve()
    with MODEL_SLOTS slots)."""
    from repro_torch import tree
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules as shr

    mesh = tp_mesh(SSM_TP_MESH)
    out = {}
    for sv in SSM_TP_SERVED:
        o, t0 = {}, time.perf_counter()
        cfg, params, prompts = ssm_model(sv, seed, mesh, "bfloat16", SSM_TP_LENS, **sv.depth)
        o["init_s"] = time.perf_counter() - t0
        o["ssm_split"] = tensor_parallel(cfg, mesh).ssm
        err = {"softmax_f32": 0.0, "rmsnorm_f32": 0.0, "tsdiv_recip": 0.0}
        with shr.use_mesh(mesh):
            eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, SSM_TP_NEW))
            o["bf16"] = tp_timed(eng, prompts, SSM_TP_NEW)
            t0 = time.perf_counter()
            rows, _ = held_calls(eng, prompts, err, recip="tsdiv_recip" in sv.per_forward,
                                 keep=set())
            o["held"] = {"rows": rows, "err": err, "seconds": time.perf_counter() - t0}
        o["param_gib"] = sum(t.to_local().numel() * t.to_local().element_size()
                             for t in tree.leaves(params)) / 2**30
        del eng, params
        torch.cuda.empty_cache()
        repl, lens = ssm_gate(sv)
        t0 = time.perf_counter()
        cfg, params, prompts = ssm_model(sv, seed, mesh, "float32", lens, **repl)
        o["f32_init_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        with shr.use_mesh(mesh):
            eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, SSM_TP_NEW))
            t0 = time.perf_counter()
            picks, logits = replay(eng, prompts, SSM_TP_NEW, teachers[sv.phase])
            o["f32_replay_s"] = time.perf_counter() - t0
            o["f32_picks"], o["f32_logits"] = picks, logits.cpu()
            del logits
            gb = eng.generate_batch(prompts, SSM_TP_NEW)
            reqs = [Request(list(p), max_new=SSM_TP_NEW) for p in prompts]
            t0 = time.perf_counter()
            eng.serve(reqs, slots=MODEL_SLOTS)
            o["f32_serve_s"] = time.perf_counter() - t0
        o["f32_generate_batch"], o["f32_serve"] = gb, [r.out for r in reqs]
        o["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del eng, params
        torch.cuda.empty_cache()
        out[sv.phase] = o
    return out


def ssm_train_config(param_dtype: str, **repl):
    from repro_torch.configs import get_config

    repl = {"n_layers": SSM_TP_TRAIN_DEPTH, **repl}
    cfg = dataclasses.replace(get_config(SSM.arch), param_dtype=param_dtype, **repl)
    return dataclasses.replace(cfg, division=dm_config("taylor_pallas"))


def ssm_train_launches(cfg, n_micro: int, n_leaves: int) -> dict:
    """Launches per step and rank of a Mamba-2 model with no FFN, from the
    code: per microbatch two RMSNorms per block (the block norm and the
    gated norm over d_inner, on the gathered rows) plus the final one,
    each block's again in the backward pass when ``cfg.remat``; one
    reciprocal per parameter leaf in AdamW."""
    runs = 1 + cfg.remat
    return {"rmsnorm_f32": n_micro * (2 * cfg.n_layers * runs + 1), "tsdiv_recip": n_leaves}


def ssm_train_rank(rank: int, seed: int) -> dict:
    """One rank of the tp_ssm phase's training part on SSM_TP_TRAIN_MESH:
    mamba2_780m at full width cut to SSM_TP_TRAIN_DEPTH, SSM_TP_TRAIN_STEPS steps in bf16 on
    SyntheticLM batches split over data (launches, every kernel call of
    the first step held to its plain version on rank 0, each leaf compared
    across the ranks that hold the same block after every step), then one
    f32 step from the same seed, its state gathered, and on rank 0 the
    single-process step on the same global batch."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.kernels import rmsnorm, tsdiv
    from repro_torch.models import init_params
    from repro_torch.models.params import model_specs
    from repro_torch.models.parallel import split_axes, tensor_parallel
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    mesh = tp_mesh(SSM_TP_TRAIN_MESH)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    mods = (rmsnorm, tsdiv)
    cfg = ssm_train_config("bfloat16")
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SSM_TP_TRAIN_SEQ,
                                  global_batch=SSM_TP_TRAIN_BATCH, seed=seed))
    batch_of = lambda s: {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(s).items()}

    def placed(cfg):
        sh = shr.param_shardings(cfg, mesh)
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
        opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
        return opt_cfg, ts.init_state(cfg, params, opt_cfg)

    opt_cfg, state = placed(cfg)
    plan = tensor_parallel(cfg, mesh)
    split = tree.leaves_at(split_axes(cfg, plan), plan.shardings)
    block = [tuple(coord[a] for a in (axes or ())) for axes in split]
    held = []

    torch.cuda.reset_peak_memory_stats()
    steps = []
    for s in range(SSM_TP_TRAIN_STEPS):
        batch = batch_of(s)
        for m in mods:
            m.reset_launches()
        spying = s == 0 and rank == 0
        sync()
        t0 = time.perf_counter()
        with (held_kernels(held, ("rmsnorm_f32", "tsdiv_recip"), on=spying),
              shr.use_mesh(mesh), CollectiveClock() as clock):
            state, metrics = ts.train_step(cfg, opt_cfg, state, batch,
                                           n_micro=SSM_TP_TRAIN_MICRO)
            loss = float(metrics["loss"])
            sync()
        wall = time.perf_counter() - t0
        same_block = blocks_bit_equal(block, state)
        steps.append({"ms": wall * 1e3, "loss": loss, "spied": spying,
                      "collectives": {"count": clock.count, "bytes": clock.bytes,
                                      "seconds": clock.seconds, "share": clock.seconds / wall},
                      "launches": {k: v for m in mods for k, v in m.LAUNCHES.items() if v},
                      "same_blocks_bit_equal": same_block})
    out = {"steps": steps, "n_leaves": len(split), "n_split": sum(a is not None for a in split),
           "ssm_split": plan.ssm, "held": [(k, int(b), float(e)) for k, b, e in held],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg32 = ssm_train_config("float32", n_layers=SSM_TP_F32_STEP_DEPTH)
    opt32, state = placed(cfg32)
    batch = batch_of(SSM_TP_TRAIN_STEPS)
    with shr.use_mesh(mesh):
        new, metrics = ts.train_step(cfg32, opt32, state, batch, n_micro=SSM_TP_TRAIN_MICRO)
    got = {k: [on_rank0(t) for t in tree.leaves(v)]
           for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
    mesh_loss = float(metrics["loss"])
    del new, state
    torch.cuda.empty_cache()
    out["f32_mesh_s"] = time.perf_counter() - t0
    dist.barrier()             # the other ranks' states are gone before rank 0's step
    if rank != 0:
        return out
    t0 = time.perf_counter()
    params = init_params(cfg32, torch.Generator(device=DEVICE).manual_seed(seed))
    single, m1 = ts.train_step(cfg32, opt32, ts.init_state(cfg32, params, opt32), batch,
                               n_micro=SSM_TP_TRAIN_MICRO * SSM_TP_TRAIN_MESH[0])
    zero = [p.init == "zeros" for p in tree.leaves(model_specs(cfg32))]
    out["f32_step"] = l2_gate(got, single, mesh_loss, float(m1["loss"]), opt32.lr, zero)
    out["f32_single_s"] = time.perf_counter() - t0
    return out


def l2_gate(got: dict, single, mesh_loss: float, single_loss: float, lr: float,
            zero_init: list) -> dict:
    """A mesh step's gathered state (``got``: params, m, v leaf lists, on
    the host) against the single-process step ``single``, leaf by leaf:
    the L2 distance over the leaf's norm (``l2``; not for the zero-init
    leaves' parameters) and the largest elementwise distance over its
    largest value (``max``), the leaves past SSM_TP_STATE_L2 (m, v) or
    SSM_TP_PARAMS_L2, and the parameters past 2 lr + TP_STEP_RTOL of their
    leaf's largest value."""
    from repro_torch import tree

    out = {"loss": mesh_loss, "single_loss": single_loss,
           "loss_rel": abs(mesh_loss - single_loss) / abs(single_loss)}
    paths = tree.paths(single.params)
    for k, want in (("params", single.params), ("m", single.opt.m), ("v", single.opt.v)):
        rows = []
        for path, g, w, z in zip(paths, got[k], tree.leaves(want), zero_init):
            d = (g.to(DEVICE) - w).abs()
            top, norm = float(w.abs().max()), float(w.norm())
            l2 = 0.0 if (k == "params" and z) or not norm else float(d.norm()) / norm
            bound = SSM_TP_PARAMS_L2 if k == "params" else SSM_TP_STATE_L2
            far = l2 > bound or (k == "params" and float(d.max()) >
                                 2 * lr + TP_STEP_RTOL["params"] * top)
            rows.append((path, l2, float(d.max()) / top if top else 0.0, float(d.max()), far))
        worst = max(rows, key=lambda r: r[1])
        out[k] = {"l2": worst[1], "l2_leaf": worst[0], "max": max(r[2] for r in rows),
                  "leaves_over_bound": [r[0] for r in rows if r[4]]}
        if k == "params":
            out[k]["max_abs_over_lr"] = max(r[3] for r in rows) / lr
    return out


def step_gate(got: dict, single, mesh_loss: float, single_loss: float, lr: float) -> dict:
    """A mesh step's gathered state (``got``: params, m, v leaf lists, on
    the host) against the single-process step ``single``: the loss's
    relative distance, each leaf's worst distance over its largest value,
    and the parameters split as the ep phase gates them (PERF.md §6). On step 1
    AdamW moves every element by lr * m_hat / (sqrt(v_hat) + eps) ~ lr *
    sign(g): an element whose gradient lies below the two runs' sum-order
    noise (the m gate's resolution) may take the other sign, a move of up
    to 2 lr. Where the single run's first moment is above that resolution
    the parameters are held to TP_STEP_RTOL; the others are counted, and
    held to one step's reach."""
    from repro_torch import tree

    want = {"params": single.params, "m": single.opt.m, "v": single.opt.v}
    rel = {k: [float((g.to(DEVICE) - w).abs().max()) / float(w.abs().max())
               for g, w in zip(got[k], tree.leaves(want[k]))] for k in got}
    resolved, unresolved = [], {"elements": 0, "over_bound": 0, "max_abs_diff": 0.0}
    for g, w, m in zip(got["params"], tree.leaves(want["params"]), tree.leaves(want["m"])):
        d = (g.to(DEVICE) - w).abs()
        sure = m.abs() > TP_STEP_RTOL["m"] * float(m.abs().max())
        resolved.append(float(torch.where(sure, d, 0).max()) / float(w.abs().max()))
        unresolved["elements"] += int((~sure).sum())
        unresolved["over_bound"] += int(((d > TP_STEP_RTOL["params"] * float(w.abs().max()))
                                         & ~sure).sum())
        unresolved["max_abs_diff"] = max(unresolved["max_abs_diff"],
                                         float(torch.where(sure, 0, d).max()))
    paths = tree.paths(want["params"])
    i = int(np.argmax(rel["params"]))
    diff = (got["params"][i].to(DEVICE) - tree.leaves(want["params"])[i]).abs().reshape(-1)
    j = int(diff.argmax())
    return {"loss": mesh_loss, "single_loss": single_loss,
            "loss_rel": abs(mesh_loss - single_loss) / abs(single_loss),
            "worst_over_leaf_max": {k: max(v) for k, v in rel.items()},
            "params_resolved_worst_over_leaf_max": max(resolved),
            "params_unresolved": {**unresolved, "one_step_reach": 2 * lr},
            "params_worst_element": {
                "path": paths[i], "m_mesh": float(got["m"][i].reshape(-1)[j]),
                "m_single": float(tree.leaves(want["m"])[i].reshape(-1)[j]),
                "m_leaf_max": float(tree.leaves(want["m"])[i].abs().max())}}


def check_step_gate(phase: str, f32: dict) -> None:
    check(f32["loss_rel"] <= 1e-5, f"{phase} train f32: loss {f32['loss_rel']} relative")
    for k in ("m", "v"):
        check(f32["worst_over_leaf_max"][k] <= TP_STEP_RTOL[k],
              f"{phase} train f32: {k} off by {f32['worst_over_leaf_max'][k]} of the leaf's max")
    check(f32["params_resolved_worst_over_leaf_max"] <= TP_STEP_RTOL["params"],
          f"{phase} train f32: params off by {f32['params_resolved_worst_over_leaf_max']} of "
          "the leaf's max where the gradient's sign is resolved")
    unresolved = f32["params_unresolved"]
    check(unresolved["max_abs_diff"] <= unresolved["one_step_reach"],
          f"{phase} train f32: an unresolved element moved {unresolved['max_abs_diff']}, more "
          "than one AdamW step can")


def fsdp_config(param_dtype: str, n_layers: int):
    """jamba_1_5_large at full width cut to ``n_layers``, in taylor_pallas,
    under its own rules."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(HYBRID.arch), param_dtype=param_dtype,
                               n_layers=n_layers, division=dm_config("taylor_pallas"))


def fsdp_train_launches(cfg, n_micro: int, n_leaves: int) -> dict:
    """Launches a step and rank of jamba at one layer (Mamba + dense FFN),
    from the code: per microbatch the block, gated and FFN norms (again in
    the backward pass under remat) and the final norm; one reciprocal per
    leaf in AdamW."""
    return {"rmsnorm_f32": n_micro * (3 * (1 + cfg.remat) + 1), "tsdiv_recip": n_leaves}


def fsdp_draw(cfg, seed: int, mesh):
    """``cfg``'s parameters from ``seed``, this rank's blocks on ``mesh``,
    the ranks drawing in turn."""
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    return in_turn(lambda: init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed),
                                       shardings=shr.param_shardings(cfg, mesh)))


def fsdp_batch(cfg, seed: int) -> dict:
    """The FSDP training's global batch: FSDP_TRAIN_BATCH x FSDP_TRAIN_SEQ
    SyntheticLM tokens from ``seed``, on the card."""
    from repro_torch.data import DataConfig, SyntheticLM

    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=FSDP_TRAIN_SEQ,
                                  global_batch=FSDP_TRAIN_BATCH, seed=seed))
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}


def fsdp_f32_step(rank: int, seed: int, mesh, batch: dict, state_dtype=None) -> dict:
    """One f32 step of jamba at FSDP_TRAIN_DEPTH on ``mesh`` under its own
    rules, AdamW's moments in ``state_dtype`` (the config's, bf16, where
    None), its state gathered to rank 0; there the single process's step
    on the same ``batch`` and its l2_gate against the mesh's
    (``f32_step``, rank 0 only)."""
    import torch.distributed as dist

    from repro_torch import tree
    from repro_torch.models import init_params
    from repro_torch.models.params import model_specs
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    t0 = time.perf_counter()
    cfg = fsdp_config("float32", FSDP_TRAIN_DEPTH)
    opt = adamw.AdamWConfig(state_dtype=state_dtype or cfg.opt_state_dtype,
                            division=cfg.division)
    state = ts.init_state(cfg, fsdp_draw(cfg, seed, mesh), opt)
    with shr.use_mesh(mesh):
        new, metrics = ts.train_step(cfg, opt, state, batch, n_micro=FSDP_TRAIN_MICRO)
    got = {k: [on_rank0(t) for t in tree.leaves(v)]
           for k, v in (("params", new.params), ("m", new.opt.m), ("v", new.opt.v))}
    mesh_loss = float(metrics["loss"])
    del new, state
    torch.cuda.empty_cache()
    out = {"f32_mesh_s": time.perf_counter() - t0}
    dist.barrier()             # the other ranks' states are gone before rank 0's step
    if rank == 0:
        t0 = time.perf_counter()
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed))
        single, m1 = ts.train_step(cfg, opt, ts.init_state(cfg, params, opt), batch,
                                   n_micro=FSDP_TRAIN_MICRO * FSDP_MESH[0])
        zero = [p.init == "zeros" for p in tree.leaves(model_specs(cfg))]
        out["f32_step"] = l2_gate(got, single, mesh_loss, float(m1["loss"]), opt.lr, zero)
        out["f32_single_s"] = time.perf_counter() - t0
        del single, params
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def fsdp_rank(rank: int, seed: int, teacher) -> dict:
    """One rank of the tp_ssm phase's FSDP part on FSDP_MESH, jamba under its
    own rules: bf16 at the 5-layer cut (the timed generate_batch over
    FSDP_LENS, FSDP_NEW new tokens, the all-gathers' and reduce-scatters'
    shares; every kernel call of one prefill and one decode step held to
    its plain version); then f32 at its gate (HYBRID's 2 layers and
    capacity factor), first with embed whole (the replay under the
    unsharded run's ``teacher`` stream, generate_batch and serve() with
    MODEL_SLOTS slots), then under FSDP, the prefill logits of the two
    bit for bit; then training at FSDP_TRAIN_DEPTH: one step in bf16 (bf16
    moments, jamba's), every call held to plain on rank 0, each leaf
    compared across the ranks holding its block, and fsdp_f32_step."""
    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.kernels import rmsnorm, tsdiv
    from repro_torch.models import forward
    from repro_torch.models.params import model_specs
    from repro_torch.models.parallel import split_axes, tensor_parallel
    from repro_torch.optim import adamw
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.sharding import rules as shr
    from repro_torch.train import step as ts

    mesh = tp_mesh(FSDP_MESH)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    draw = lambda cfg: fsdp_draw(cfg, seed, mesh)
    out = {"coord": coord}

    t0 = time.perf_counter()
    cfg = fsdp_config("bfloat16", HYBRID.depth["n_layers"])
    params = draw(cfg)
    out["init_s"] = time.perf_counter() - t0
    plan = tensor_parallel(cfg, mesh)
    out["fsdp_leaves"] = sum("data" in sh.spec and not p.expert for p, sh in zip(
        tree.leaves(model_specs(cfg)), tree.leaves(plan.shardings)))
    out["param_gib"] = sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree.leaves(params)) / 2**30
    rng = np.random.default_rng(seed + 11)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in FSDP_LENS]
    err = {"softmax_f32": 0.0, "rmsnorm_f32": 0.0, "tsdiv_recip": 0.0}
    with shr.use_mesh(mesh):
        eng = ServingEngine(cfg, params, max_len=cache_len(cfg, prompts, FSDP_NEW))
        out["bf16"] = tp_timed(eng, prompts, FSDP_NEW, warm=False)   # a forward gathers GBs
        t0 = time.perf_counter()
        rows, _ = held_calls(eng, prompts, err, recip=True, keep=set())
        out["held"] = {"rows": rows, "err": err, "seconds": time.perf_counter() - t0}
    del eng, params
    torch.cuda.empty_cache()

    # The gate's config (f32, 2 layers, drop-free routing) with embed whole
    # is held to the unsharded run; the same config under FSDP is held bit
    # for bit to it, which carries the gate over.
    repl, lens = ssm_gate(HYBRID)
    whole_rules = {**get_config(HYBRID.arch).sharding_rules, "embed": None}
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, FSDP_LENS[0]))).to(DEVICE)
    t0 = time.perf_counter()
    c, params, gate_prompts = ssm_model(HYBRID, seed, mesh, "float32", lens,
                                        sharding_rules=whole_rules, **repl)
    out["f32_init_s"] = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    logits = {}
    with shr.use_mesh(mesh):
        with torch.no_grad():
            logits[True] = forward(c, params, tokens=toks, mode="prefill")[0].cpu()
        eng = ServingEngine(c, params, max_len=cache_len(c, gate_prompts, SSM_TP_NEW))
        t0 = time.perf_counter()
        picks, replayed = replay(eng, gate_prompts, SSM_TP_NEW, teacher)
        out["f32_replay_s"] = time.perf_counter() - t0
        out["f32_picks"], out["f32_logits"] = picks, replayed.cpu()
        del replayed
        gb = eng.generate_batch(gate_prompts, SSM_TP_NEW)
        reqs = [Request(list(p), max_new=SSM_TP_NEW) for p in gate_prompts]
        t0 = time.perf_counter()
        eng.serve(reqs, slots=MODEL_SLOTS)
        out["f32_serve_s"] = time.perf_counter() - t0
    out["f32_generate_batch"], out["f32_serve"] = gb, [r.out for r in reqs]
    out["f32_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng, params
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c, params, _ = ssm_model(HYBRID, seed, mesh, "float32", lens, **repl)
    with torch.no_grad(), shr.use_mesh(mesh):
        logits[False] = forward(c, params, tokens=toks, mode="prefill")[0].cpu()
    del params
    torch.cuda.empty_cache()
    out["bit_equal"] = torch.equal(logits[False].view(torch.int32),
                                   logits[True].view(torch.int32))
    out["bit_shape"] = list(logits[False].shape)
    out["bit_s"] = time.perf_counter() - t0

    mods = (rmsnorm, tsdiv)
    batch = fsdp_batch(cfg, seed)

    cfg = fsdp_config("bfloat16", FSDP_TRAIN_DEPTH)
    opt_cfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype, division=cfg.division)
    state = ts.init_state(cfg, draw(cfg), opt_cfg)
    plan = tensor_parallel(cfg, mesh)
    split = tree.leaves_at(split_axes(cfg, plan), plan.shardings)
    block = [tuple(coord[a] for a in (axes or ())) for axes in split]
    held = []
    for m in mods:
        m.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    with (held_kernels(held, ("rmsnorm_f32", "tsdiv_recip"), on=rank == 0),
          shr.use_mesh(mesh), CollectiveClock() as clock):
        state, metrics = ts.train_step(cfg, opt_cfg, state, batch, n_micro=FSDP_TRAIN_MICRO)
        loss = float(metrics["loss"])
        sync()
    wall = time.perf_counter() - t0
    n = len(split)
    out["train"] = {
        "ms": wall * 1e3, "loss": loss, "n_leaves": n,
        "n_data_split": sum(bool(a) and "data" in a for a in split),
        "launches": {k: v for m in mods for k, v in m.LAUNCHES.items() if v},
        "collectives": {"count": clock.count, "bytes": clock.bytes, "seconds": clock.seconds,
                        "share": clock.seconds / wall,
                        "by_op": {k: v for k, v in clock.by_op.items() if v["count"]}},
        "same_blocks_bit_equal": blocks_bit_equal(block, state),
        "held": [(k, int(b), float(e)) for k, b, e in held],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del state
    torch.cuda.empty_cache()

    out.update(fsdp_f32_step(rank, seed, mesh, batch))
    return out


def check_fsdp(ranks: list, unsharded: dict, launches: dict, err: dict, ranks_s: float) -> None:
    """The parent's gates and report of fsdp_rank's readings; ``unsharded``: the
    unsharded f32 run at HYBRID's gate."""
    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    forwards = 1 + FSDP_NEW
    for o in ranks:
        add(o["bf16"]["launches"])
        check(o["bf16"]["launches"] == {k: v * forwards for k, v in HYBRID.per_forward.items()},
              f"tp_ssm fsdp launches {o['bf16']['launches']}, expected {HYBRID.per_forward} "
              f"x {forwards}")
        rows = o["held"]["rows"]
        calls = {f"{k}/{st}": sum(1 for r in rows if r[:2] == (k, st))
                 for st in ("prefill", "decode") for k in HYBRID.per_forward}
        check(calls == {f"{k}/{st}": v for st in ("prefill", "decode")
                        for k, v in HYBRID.per_forward.items()},
              f"tp_ssm fsdp held calls {calls}")
        check(all(r[3] == 0 for r in rows), "tp_ssm fsdp: a call differs from the plain "
              f"version: {[r for r in rows if r[3]]}")
        for k, e in o["held"]["err"].items():
            err[k] = max(err[k], e)
        check(o["bf16"]["prefill_by_op"].get("all_gather", {}).get("count", 0)
              >= o["fsdp_leaves"], f"tp_ssm fsdp: the prefill gathered "
              f"{o['bf16']['prefill_by_op']} for {o['fsdp_leaves']} FSDP leaves")
        check(o["bit_equal"], "tp_ssm fsdp: f32 prefill logits differ from the embed-whole "
              "run's")
        check(o["f32_picks"].tolist() == ranks[0]["f32_picks"].tolist(),
              "tp_ssm fsdp f32: the ranks chose different tokens")
        check(all(len(t) == FSDP_NEW for t in o["bf16"]["tokens"]), "tp_ssm fsdp: short output")
        check(o["bf16"]["tokens"] == ranks[0]["bf16"]["tokens"],
              "tp_ssm fsdp: the ranks chose different tokens")
        t = o["train"]
        add(t["launches"])
        want = fsdp_train_launches(fsdp_config("bfloat16", FSDP_TRAIN_DEPTH), FSDP_TRAIN_MICRO,
                                   t["n_leaves"])
        check(t["launches"] == want, f"tp_ssm fsdp train launches {t['launches']}, want {want}")
        check(t["same_blocks_bit_equal"], "tp_ssm fsdp train: a block differs across its ranks")
        check(t["n_data_split"] > 0, "tp_ssm fsdp train: no leaf is split over data")
        check(t["collectives"]["by_op"].get("reduce_scatter", {}).get("count", 0) > 0,
              "tp_ssm fsdp train: no reduce-scatter")
        check(math.isfinite(t["loss"]), f"tp_ssm fsdp train: loss {t['loss']}")
    held = ranks[0]["train"]["held"]
    n_held = {k: sum(1 for h in held if h[0] == k) for k in want}
    check(n_held == want, f"tp_ssm fsdp train: held calls {n_held}, want {want}")
    check(all(h[1] == 0 for h in held), "tp_ssm fsdp train: a call differs from plain")
    for k, _, e in held:
        err[k] = max(err[k], e)
    row = sorted((o for o in ranks if o["coord"]["data"] == 0), key=lambda o: o["coord"]["model"])
    gate = f32_gate(row, unsharded)
    f32 = ranks[0]["f32_step"]
    say("tp_ssm", part="fsdp", arch=HYBRID.arch, mesh=dict(zip(("data", "model"), FSDP_MESH)),
        layers=HYBRID.depth["n_layers"], prompt_lens=list(FSDP_LENS), max_new=FSDP_NEW,
        fsdp_leaves=ranks[0]["fsdp_leaves"], launches_per_forward=HYBRID.per_forward,
        bf16={k: [o["bf16"][k] for o in ranks]
              for k in ("prefill_ms", "decode_ms_per_step", "prefill_collectives",
                        "decode_collectives", "prefill_by_op", "decode_by_op",
                        "generate_batch_s", "peak_gib")}
        | {"param_gib": [o["param_gib"] for o in ranks], "init_s": [o["init_s"] for o in ranks]},
        held={"calls_per_rank": len(ranks[0]["held"]["rows"]),
              "seconds": [o["held"]["seconds"] for o in ranks]},
        f32_embed_whole={"depth": unsharded["depth"], **gate, "serve_slots": MODEL_SLOTS,
                         "prompt_lens": list(ssm_gate(HYBRID)[1]), "max_new": SSM_TP_NEW,
                         "serve_s": [o["f32_serve_s"] for o in ranks],
                         "replay_s": [o["f32_replay_s"] for o in ranks],
                         "init_s": [o["f32_init_s"] for o in ranks],
                         "peak_gib": [o["f32_peak_gib"] for o in ranks],
                         "unsharded_peak_gib": unsharded["peak_gib"]},
        bit_equal_prefill={"depth": unsharded["depth"], "dtype": "float32",
                           "logits_shape": ranks[0]["bit_shape"],
                           "equal": [o["bit_equal"] for o in ranks],
                           "seconds": [o["bit_s"] for o in ranks]},
        train={"layers": FSDP_TRAIN_DEPTH, "batch": FSDP_TRAIN_BATCH, "seq_len": FSDP_TRAIN_SEQ,
               "n_micro": FSDP_TRAIN_MICRO, "n_leaves": ranks[0]["train"]["n_leaves"],
               "n_data_split": ranks[0]["train"]["n_data_split"], "launches_per_step": want,
               "ms": [o["train"]["ms"] for o in ranks],
               "collectives": [o["train"]["collectives"] for o in ranks],
               "peak_gib": [o["train"]["peak_gib"] for o in ranks],
               "f32_step": f32, "f32_mesh_s": [o["f32_mesh_s"] for o in ranks],
               "f32_single_s": ranks[0]["f32_single_s"]},
        ranks_s=ranks_s, note="4 ranks share one card over gloo: every collective through "
        "host copies")
    check_f32_gate("tp_ssm fsdp f32 embed whole", gate)
    check(f32["loss_rel"] <= 1e-5, f"tp_ssm fsdp train f32: loss {f32['loss_rel']} relative")
    for k in ("params", "m", "v"):
        check(not f32[k]["leaves_over_bound"], f"tp_ssm fsdp train f32: {k} of "
              f"{f32[k]['leaves_over_bound'][:5]} past its bound (l2 {f32[k]['l2']})")


def phase_tp_ssm(seed: int, launches: dict, err: dict) -> dict:
    """The tp_ssm phase: the Mamba-2 mixer split by heads over the model
    axis (models/mamba2.py over models/parallel.py's plan), the ranks
    sharing the one card over gloo (every collective through host copies:
    the times are not a speed figure). Serving on SSM_TP_MESH: mamba2_780m
    at full width and SSM_TP_SERVED's depth in bf16, generate_batch over
    SSM_TP_LENS prompts, SSM_TP_NEW new tokens each, the unsharded
    serving phase's launches a layer and rank (the gated norm runs on the
    gathered rows),
    every call of one prefill and one decode step held to plain on each
    rank; in f32 at its gate depth the gate of test_decode_equiv against this
    process's unsharded run (>= 99% of teacher-forced tokens, logit drift
    < 5e-3) and serve() against generate_batch (>= 99%). Then jamba under
    its own rules on FSDP_MESH (fsdp_rank, check_fsdp): its embed leaves
    stored as blocks over data and gathered before use; at its 2-layer f32
    gate the same mesh with embed whole is held to this process's
    unsharded run as mamba2 is, and the FSDP prefill bit for bit to it.
    Training:
    mamba2_780m at full width cut to SSM_TP_TRAIN_DEPTH on
    SSM_TP_TRAIN_MESH, SSM_TP_TRAIN_STEPS steps in bf16 with f32 moments
    (launches a step and rank from the code, every call of step 1 held to
    plain on rank 0, each leaf bit-equal on the ranks that hold the same
    block after every step), and one f32 step at SSM_TP_F32_STEP_DEPTH
    layers against the single-process step, leaf by leaf in the L2 norm
    (l2_gate)."""
    import gc

    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    want = ssm_want(seed, SSM_TP_SERVED + (HYBRID,))
    want_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    parent = {"allocated_gib": torch.cuda.memory_allocated() / 2**30,
              "reserved_gib": torch.cuda.memory_reserved() / 2**30,
              "card_free_gib": torch.cuda.mem_get_info()[0] / 2**30}
    n_serve = SSM_TP_MESH[0] * SSM_TP_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(ssm_serve_rank, n_serve, seed,
                      {sv.phase: want[sv.phase]["teacher"] for sv in SSM_TP_SERVED},
                      device_type="cuda", timeout_s=SSM_TP_TIMEOUT_S)
    serve_s = time.perf_counter() - t0

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    forwards = 1 + SSM_TP_NEW
    for sv in SSM_TP_SERVED:
        outs = [r[sv.phase] for r in ranks]
        for o in outs:
            check(o["ssm_split"], f"tp_ssm {sv.arch}: the mixer is not split by heads")
            add(o["bf16"]["launches"])
            check(o["bf16"]["launches"] == {k: v * forwards for k, v in sv.per_forward.items()},
                  f"tp_ssm {sv.arch} launches {o['bf16']['launches']}, expected "
                  f"{sv.per_forward} x {forwards}")
            rows = o["held"]["rows"]
            calls = {f"{k}/{st}": sum(1 for r in rows if r[:2] == (k, st))
                     for st in ("prefill", "decode") for k in sv.per_forward}
            check(calls == {f"{k}/{st}": v for st in ("prefill", "decode")
                            for k, v in sv.per_forward.items()},
                  f"tp_ssm {sv.arch} held calls {calls}")
            check(all(r[3] == 0 for r in rows), f"tp_ssm {sv.arch}: a call differs from the "
                  f"plain version: {[r for r in rows if r[3]]}")
            for k, e in o["held"]["err"].items():
                err[k] = max(err[k], e)
            check(o["f32_picks"].tolist() == outs[0]["f32_picks"].tolist(),
                  f"tp_ssm {sv.arch}: the ranks chose different tokens")
        w = want[sv.phase]
        gate = f32_gate(outs, w)
        say("tp_ssm", part="serve", arch=sv.arch, mesh=dict(zip(("data", "model"), SSM_TP_MESH)),
            layers=sv.depth.get("n_layers"), prompt_lens=list(SSM_TP_LENS), max_new=SSM_TP_NEW,
            launches_per_forward=sv.per_forward,
            bf16={k: [o["bf16"][k] for o in outs]
                  for k in ("prefill_ms", "decode_ms_per_step", "prefill_collectives",
                            "decode_collectives", "generate_batch_s", "peak_gib")}
            | {"param_gib": [o["param_gib"] for o in outs],
               "init_s": [o["init_s"] for o in outs]},
            held={"calls_per_rank": len(outs[0]["held"]["rows"]),
                  "mismatched_lanes": sum(r[3] for o in outs for r in o["held"]["rows"]),
                  "seconds": [o["held"]["seconds"] for o in outs]},
            f32={"depth": w["depth"], **gate,
                 "serve_slots": MODEL_SLOTS, "serve_s": [o["f32_serve_s"] for o in outs],
                 "replay_s": [o["f32_replay_s"] for o in outs],
                 "init_s": [o["f32_init_s"] for o in outs],
                 "peak_gib": [o["f32_peak_gib"] for o in outs],
                 "unsharded_peak_gib": w["peak_gib"]},
            note="ranks share one card over gloo: every collective through host copies")
        check_f32_gate(f"tp_ssm {sv.arch}", gate)
        check(all(len(t) == SSM_TP_NEW for t in outs[0]["bf16"]["tokens"]),
              f"tp_ssm {sv.arch}: short output")
    say("tp_ssm", part="serve_wall", unsharded_s=want_s, ranks_s=serve_s, parent_memory=parent)
    del ranks
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(fsdp_rank, FSDP_MESH[0] * FSDP_MESH[1], seed,
                      want[HYBRID.phase]["teacher"], device_type="cuda",
                      timeout_s=SSM_TP_TIMEOUT_S)
    fsdp_s = time.perf_counter() - t0
    check_fsdp(ranks, want[HYBRID.phase], launches, err, fsdp_s)
    del ranks, want
    gc.collect()
    torch.cuda.empty_cache()

    n_train = SSM_TP_TRAIN_MESH[0] * SSM_TP_TRAIN_MESH[1]
    t0 = time.perf_counter()
    ranks = run_ranks(ssm_train_rank, n_train, seed, device_type="cuda",
                      timeout_s=SSM_TP_TIMEOUT_S)
    train_s = time.perf_counter() - t0
    cfg = ssm_train_config("bfloat16")
    per_step = ssm_train_launches(cfg, SSM_TP_TRAIN_MICRO, ranks[0]["n_leaves"])
    for o in ranks:
        check(o["ssm_split"], "tp_ssm train: the mixer is not split by heads")
        for st in o["steps"]:
            add(st["launches"])
            check(st["launches"] == per_step, f"tp_ssm train launches {st['launches']} a step, "
                  f"want {per_step}")
            check(st["same_blocks_bit_equal"], "tp_ssm train: a block differs across its ranks")
            check(math.isfinite(st["loss"]), f"tp_ssm train: loss {st['loss']}")
    held = ranks[0]["held"]
    n_held = {k: sum(1 for h in held if h[0] == k) for k in per_step}
    check(n_held == per_step, f"tp_ssm train: held calls {n_held}, want {per_step}")
    check(all(h[1] == 0 for h in held), "tp_ssm train: a call differs from its plain version")
    for k, _, e in held:
        err[k] = max(err[k], e)
    f32 = ranks[0]["f32_step"]
    say("tp_ssm", part="train", arch=SSM.arch, mesh=dict(zip(("data", "model"),
                                                            SSM_TP_TRAIN_MESH)),
        n_layers=cfg.n_layers, opt_state_dtype=cfg.opt_state_dtype, batch=SSM_TP_TRAIN_BATCH,
        seq_len=SSM_TP_TRAIN_SEQ, n_micro_per_data_rank=SSM_TP_TRAIN_MICRO,
        n_leaves=ranks[0]["n_leaves"], n_split=ranks[0]["n_split"],
        launches_per_step=per_step, held_calls=n_held,
        step_ms=[[st["ms"] for st in o["steps"]] for o in ranks],
        step_collectives=[[st["collectives"] for st in o["steps"]] for o in ranks],
        losses=[st["loss"] for st in ranks[0]["steps"]],
        peak_gib=[o["peak_gib"] for o in ranks], f32_step_depth=SSM_TP_F32_STEP_DEPTH,
        f32_step=f32, f32_mesh_s=[o["f32_mesh_s"] for o in ranks],
        f32_single_s=ranks[0]["f32_single_s"], ranks_s=train_s,
        note="4 ranks share one card over gloo; rank 0's step 1 includes its held calls")
    check(f32["loss_rel"] <= 1e-5, f"tp_ssm train f32: loss {f32['loss_rel']} relative")
    for k in ("params", "m", "v"):
        check(not f32[k]["leaves_over_bound"], f"tp_ssm train f32: {k} of "
              f"{f32[k]['leaves_over_bound'][:5]} past its bound (l2 {f32[k]['l2']})")
    return {"serve_s": serve_s, "fsdp_s": fsdp_s, "train_s": train_s}


# --------------------------------------------------------------- the seq phase

SEQ_ARCH = "gemma3_12b"
SEQ_MESH = (2, 2)                 # (data, model): the cache's slots on data, heads on model
SEQ_DEPTH = 6                     # one period: 5 sliding-window layers and 1 global
SEQ_SLOTS = 524288                # long_500k's cache, batch 1
SEQ_NEW = 4                       # teacher-forced steps at SEQ_SLOTS - 4 .. SEQ_SLOTS - 1
SEQ_PROMPT = 512                  # the batch-1 generate's prompt: rank data 1's slots all masked
SEQ_CHUNK = 8192                  # the cache's seeded draws, SEQ_CHUNK slots each
# Faults planted in the split decode's combine over data, each of which the
# seq gate must catch: data rank 1 adds zeros in place of its probs @ V
# partial; every rank divides by its own exponentials' sum, not the sum
# over the ranks.
SEQ_FAULTS = ("dropped_partial", "local_sum")


@contextlib.contextmanager
def planted(fault: str):
    """``fault`` (one of SEQ_FAULTS) planted in ``comm.all_reduce`` for a
    scope: the combine's sums over data are told apart by their shape (the
    row sums (rows, 1), the ``probs @ V`` partials (b, q, h, hd)). Every
    rank still takes part in every collective it issues."""
    from repro_torch.sharding import comm
    from repro_torch.sharding import rules as shr

    real = comm.all_reduce

    def faulty(t, mesh, axes, op="sum"):
        if tuple(axes) == ("data",) and op == "sum":
            if fault == "local_sum" and t.dim() == 2:
                return t
            if (fault == "dropped_partial" and t.dim() == 4
                    and shr.axis_index(mesh, "data") == 1):
                t = torch.zeros_like(t)
        return real(t, mesh, axes, op=op)

    comm.all_reduce = faulty
    try:
        yield
    finally:
        comm.all_reduce = real


def seq_model(seed: int, mesh):
    """SEQ_ARCH at full width and SEQ_DEPTH layers in f32 and taylor_pallas,
    drawn from ``seed`` (the rank's blocks on ``mesh``, the whole model with
    None), and the generate prompt."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.sharding import rules as shr

    cfg = dataclasses.replace(get_config(SEQ_ARCH), param_dtype="float32", n_layers=SEQ_DEPTH)
    cfg = dataclasses.replace(cfg, division=dataclasses.replace(cfg.division,
                                                                mode="taylor_pallas"))
    sh = None if mesh is None else shr.param_shardings(cfg, mesh)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), shardings=sh)
    rng = np.random.default_rng(seed + 17)
    return cfg, params, rng.integers(1, cfg.vocab, SEQ_PROMPT).tolist(), int(
        rng.integers(1, cfg.vocab))


def seq_fill(cache, cfg, seed: int) -> None:
    """Fill the cache's K/V (the rank's blocks under the active mesh) below
    position SEQ_SLOTS - SEQ_NEW -- every slot of a ring -- from seeded
    draws: SEQ_CHUNK slots of every KV head at a time, each chunk from a
    generator seeded by (seed, layer, leaf, chunk), so a rank draws only the
    chunks of its own slots and the unsharded run draws the same values."""
    from repro_torch.models.model import cache_layout, group_layers
    from repro_torch.models.parallel import tensor_parallel

    lay = cache_layout(cfg, 1, SEQ_SLOTS)
    tp = tensor_parallel(cfg)
    li = 0
    for g, gc in zip(cfg.groups(), cache["groups"]):
        for spec, lc in zip(group_layers(g), gc["layers"]):
            window = cfg.sliding_window if spec.mixer == "swa" else 0
            seq = lay["ring" if window else "full"]
            total = window or SEQ_SLOTS
            filled = window or SEQ_SLOTS - SEQ_NEW
            for j, name in enumerate(("k", "v")):
                a = lc["attn"][name]
                L, H = a.shape[1], a.shape[2]
                lo = 0 if seq is None else seq.index * L
                h0 = tp.kv_range()[0] if H < cfg.n_kv_heads else 0
                for c0 in range(lo - lo % SEQ_CHUNK, min(lo + L, filled), SEQ_CHUNK):
                    gen = torch.Generator(device=DEVICE).manual_seed(
                        ((seed * 1009 + li) * 2 + j) * 4099 + c0 // SEQ_CHUNK)
                    chunk = torch.randn((min(SEQ_CHUNK, total - c0), cfg.n_kv_heads,
                                         cfg.head_dim), generator=gen, device=DEVICE)
                    s0, s1 = max(c0, lo), min(c0 + SEQ_CHUNK, lo + L, filled)
                    a[0, s0 - lo:s1 - lo] = chunk[s0 - c0:s1 - c0, h0:h0 + H].to(a.dtype)
                    del chunk
            li += 1


def seq_decode(cfg, params, cache, first: int, teacher=None, timed: bool = False):
    """SEQ_NEW decode steps at SEQ_SLOTS - SEQ_NEW ..: the first fed
    ``first``, then ``teacher``'s tokens (the unsharded run's picks) or the
    run's own greedy picks. Returns (picks, logits on the host, each step's
    ms and collectives when ``timed``)."""
    from repro_torch.models import forward
    from repro_torch.models.parallel import tensor_parallel
    from repro_torch.serving.engine import greedy

    tok = torch.tensor([[first]], dtype=torch.int32, device=DEVICE)
    picks, logits, steps = [], [], []
    for t in range(SEQ_NEW):
        sync()
        t0 = time.perf_counter()
        with CollectiveClock() as clock, torch.no_grad():
            out, cache, _ = forward(cfg, params, tokens=tok, cache=cache,
                                    pos=SEQ_SLOTS - SEQ_NEW + t, mode="decode")
            pick = greedy(out[:, 0], tensor_parallel(cfg))
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        if timed:
            steps.append({"ms": ms, "collectives": {
                n: {"count": v["count"], "bytes": v["bytes"], "share": v["seconds"] * 1e3 / ms}
                for n, v in clock.by_op.items() if v["count"]}})
        picks.append(int(pick[0, 0]))
        logits.append(out[:, 0].cpu())
        tok = pick if teacher is None else torch.tensor([[teacher[t]]], dtype=torch.int32,
                                                        device=DEVICE)
    return picks, torch.stack(logits), steps


def seq_want(seed: int) -> dict:
    """This process's unsharded run of the seq phase: the whole cache of
    SEQ_SLOTS slots filled by seq_fill, SEQ_NEW greedy steps (the teacher
    stream and its logits), then a batch-1 generate of the SEQ_PROMPT
    prompt into a fresh cache of SEQ_SLOTS slots."""
    from repro_torch.models import make_cache
    from repro_torch.serving import ServingEngine

    cfg, params, prompt, first = seq_model(seed, None)
    torch.cuda.reset_peak_memory_stats()
    cache = make_cache(cfg, 1, SEQ_SLOTS, DEVICE)
    seq_fill(cache, cfg, seed)
    picks, logits, _ = seq_decode(cfg, params, cache, first)
    seq_fill(cache, cfg, seed)        # the rings' slots were overwritten: refill
    _, _, steps = seq_decode(cfg, params, cache, first, picks, timed=True)
    del cache
    peak = torch.cuda.max_memory_allocated() / 2**30
    eng = ServingEngine(cfg, params, max_len=SEQ_SLOTS)
    gen = eng.generate(prompt, SEQ_NEW)
    del eng, params
    torch.cuda.empty_cache()
    return {"teacher": picks, "logits": logits, "steps": steps, "generate": gen,
            "peak_gib": peak}


def seq_on_mesh(mesh, seed: int, teacher: list) -> dict:
    """One rank's part of the seq phase on ``mesh`` (SEQ_MESH, the tp phase's
    training ranks): its blocks of the model, its block of the filled cache
    (SEQ_SLOTS / 2 slots a data rank, 4 of 8 KV heads), SEQ_NEW decode steps
    under the unsharded run's ``teacher`` stream (every kernel call held to
    its plain version; rank 0 keeps the first split softmax input of the
    global layer and of the rings for the times phase), the same steps
    again timed over a refilled
    cache, the steps under each planted fault of the combine
    (``SEQ_FAULTS``) over a refilled cache, then the batch-1 generate."""
    from repro_torch import tree
    from repro_torch.kernels import rmsnorm, softmax, softmax_split, tsdiv
    from repro_torch.models import make_cache
    from repro_torch.serving import ServingEngine
    from repro_torch.sharding import rules as shr

    t0 = time.perf_counter()
    cfg, params, prompt, first = seq_model(seed, mesh)
    mods = (softmax, rmsnorm, tsdiv, softmax_split)
    out = {"init_s": time.perf_counter() - t0}
    torch.cuda.reset_peak_memory_stats()
    with shr.use_mesh(mesh):
        cache = make_cache(cfg, 1, SEQ_SLOTS, DEVICE)
        seq_fill(cache, cfg, seed)
        out["cache_gib"] = sum(t.numel() * t.element_size() for t in tree.leaves(cache)) / 2**30
        held = []
        for m in mods:
            m.reset_launches()
        with (first_split_inputs({}) as kept,
              held_kernels(held, ("softmax_f32", "rmsnorm_f32", "tsdiv_recip",
                                  "softmax_split_f32"))):
            picks, logits, _ = seq_decode(cfg, params, cache, first, teacher)
        out["launches"] = {k: v for m in mods for k, v in m.LAUNCHES.items() if v}
        if torch.distributed.get_rank() == 0:
            out["split_inputs"] = kept
        seq_fill(cache, cfg, seed)    # the rings' slots were overwritten: refill
        _, again, steps = seq_decode(cfg, params, cache, first, teacher, timed=True)
        out.update(picks=picks, logits=logits, steps=steps, held=held,
                   again_equal=bool(torch.equal(again, logits)), faults={})
        for fault in SEQ_FAULTS:
            seq_fill(cache, cfg, seed)
            with planted(fault):
                out["faults"][fault] = seq_decode(cfg, params, cache, first, teacher)[:2]
        del cache
        out["decode_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        eng = ServingEngine(cfg, params, max_len=SEQ_SLOTS)
        sync()
        t0 = time.perf_counter()
        out["generate"] = eng.generate(prompt, SEQ_NEW)
        sync()
        out["generate_s"] = time.perf_counter() - t0
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del eng, params
    torch.cuda.empty_cache()
    return out


def check_seq(ranks: list, want: dict, launches: dict, err: dict, ranks_s: float) -> None:
    """The seq phase: SEQ_ARCH at full width, SEQ_DEPTH layers, f32, batch 1,
    its cache of SEQ_SLOTS slots split by sequence over data (the
    long_500k layout; heads and vocab over model) on SEQ_MESH, run by the
    tp phase's 4 training ranks sharing the card over gloo, against this
    process's unsharded run (``want``), which ran first and was freed
    before the ranks started: SEQ_NEW teacher-forced steps (every token the
    unsharded run's, logit drift < 5e-3 over the largest), a batch-1
    generate of a SEQ_PROMPT prompt (rank data 1's slots all masked) equal
    to the unsharded run's, every kernel call of the steps held bit for
    bit to its plain version; per rank the decode step's ms, the
    collectives' share of it by op and peak GiB. Each planted fault of
    the combine (SEQ_FAULTS) must fail the gate. ``ranks`` holds each
    rank's ``seq_on_mesh`` readings."""
    ref = want["logits"]

    def gate(picks, logits):
        return (sum(a == b for a, b in zip(picks, want["teacher"])),
                float((logits - ref).abs().max() / ref.abs().max()))

    agree, drift = gate(ranks[0]["picks"], torch.cat([ranks[r]["logits"] for r in (0, 1)], -1))
    faults = {f: dict(zip(("agree", "drift"), gate(ranks[0]["faults"][f][0], torch.cat(
        [ranks[r]["faults"][f][1] for r in (0, 1)], -1)))) for f in SEQ_FAULTS}
    # A decode step on a rank: two RMSNorms a layer and the final one, and
    # the split softmax's three passes a layer; no softmax kernel.
    per_step = {"rmsnorm_f32": (2 * SEQ_DEPTH + 1) * SEQ_NEW,
                "softmax_split_f32": 3 * SEQ_DEPTH * SEQ_NEW}
    for o in ranks:
        for k, v in o["launches"].items():
            launches[k] = launches.get(k, 0) + v
        check(o["launches"] == per_step, f"seq launches {o['launches']}, want {per_step}")
        n_held = {k: sum(1 for h in o["held"] if h[0] == k) for k in per_step}
        check(n_held == per_step, f"seq held calls {n_held}, want {per_step}")
        check(all(h[1] == 0 for h in o["held"]), "seq: a call differs from its plain version")
        for k, _, e in o["held"]:
            err[k] = max(err[k], e)
        check(o["again_equal"], "seq: a second run of the steps gave other logits")
    say("seq", arch=SEQ_ARCH, depth=SEQ_DEPTH, mesh=dict(zip(("data", "model"), SEQ_MESH)),
        cache_slots=SEQ_SLOTS, batch=1, dtype="float32", new=SEQ_NEW,
        teacher_forced_agreement=agree / SEQ_NEW, logit_drift=drift, planted_faults=faults,
        generate_equal=[o["generate"] == want["generate"] for o in ranks],
        generate_prompt=SEQ_PROMPT, generate_s=[o["generate_s"] for o in ranks],
        decode_ms=[[st["ms"] for st in o["steps"]] for o in ranks],
        decode_collectives=[o["steps"][-1]["collectives"] for o in ranks],
        init_s=[o["init_s"] for o in ranks], cache_gib=[o["cache_gib"] for o in ranks],
        decode_peak_gib=[o["decode_peak_gib"] for o in ranks],
        peak_gib=[o["peak_gib"] for o in ranks], launches_per_rank=per_step,
        unsharded={"decode_ms": [st["ms"] for st in want["steps"]],
                   "peak_gib": want["peak_gib"], "seconds": want["seconds"]},
        ranks_s_with_tp_train=ranks_s, note="the tp phase's 4 training ranks, sharing one "
        "card over gloo: the collectives go through host copies, the times are not a speed "
        "figure")
    check(agree == SEQ_NEW, f"seq: {agree} of {SEQ_NEW} teacher-forced tokens agree")
    check(drift < 5e-3, f"seq: logit drift {drift} >= 5e-3")
    for f, g in faults.items():
        check(g["agree"] < SEQ_NEW or g["drift"] >= 5e-3,
              f"seq: the gate misses the planted fault {f} ({g})")
    check(all(o["generate"] == want["generate"] for o in ranks),
          f"seq: generate {[o['generate'] for o in ranks]} != {want['generate']}")


def u32_mismatch(got: torch.Tensor, want: torch.Tensor):
    """mismatch() for uint32 lanes: (lanes differing, max |got - want|)."""
    from repro_torch.core.ilm import as_u32_lanes

    check(got.dtype == want.dtype == torch.uint32 and got.shape == want.shape,
          f"ILM kernel gave {got.dtype} {tuple(got.shape)}, plain {want.dtype} {tuple(want.shape)}")
    d = (as_u32_lanes(got) - as_u32_lanes(want)).abs()
    return int((d != 0).sum()), float(d.max()) if d.numel() else 0.0


def qkv(seed: int, shape, dtype=torch.float32, scale: float = 1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(DEVICE, dtype)
            for _ in range(3)]


def attention_f64(q, k, v, causal: bool):
    """Softmax attention in f64: the oracle of tests/test_flash_attention.py."""
    qd, kd, vd = (t.double() for t in (q, k, v))
    sc = qd @ kd.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        sc = sc.masked_fill(~torch.ones(sc.shape[-2:], dtype=torch.bool, device=sc.device).tril(),
                            -math.inf)
    return torch.softmax(sc, -1) @ vd


def tc_gated(gates: list, got, want, max_abs_v: float, err: dict) -> dict:
    """The bf16 kernel against its plain version under its gate
    (kernels/flash_attention.tc_gate); notes the gate and the largest
    difference."""
    from repro_torch.kernels import flash_attention as fa

    g = fa.tc_gate(got, want, max_abs_v)
    gates.append(g)
    err["flash_attention_bf16"] = max(err["flash_attention_bf16"],
                                      float((got.float() - want.float()).abs().max()))
    return g


def gate_summary(gates: list) -> dict:
    """The worst of several tc_gate results: the least identical share, the
    largest excess, the lanes over each bound."""
    return {"identical_share_min": min(g["identical_share"] for g in gates),
            "worst_excess": max(g["worst_excess"] for g in gates),
            "lanes_over": sum(g["lanes_over"] for g in gates),
            "lanes_over_2^-8": sum(g["lanes_over_2^-8"] for g in gates),
            "ok": all(g["ok"] for g in gates)}


def phase_flash(seed: int, err: dict):
    """The flash kernels against their plain versions on the corpus (f32 bit
    for bit, bf16 under its gate), then the reference's attention
    gates on the card."""
    from repro_torch.core import division_modes as dm
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    table = compute_segments(2, 24)
    rows, gates = [], []
    for i, shape in enumerate(FLASH_CORPUS):
        for dtype in (torch.float32, torch.bfloat16):
            q3, k3, v3, kw = ops.flash_padded(*qkv(seed + 20 + i, shape, dtype))
            vmax = float(v3.float().abs().max())
            plain = fa.PLAIN[fa.kernel_for(dtype)]
            for causal in (True, False):
                for sched in SCHEDULES:
                    for skip in (True, False):
                        got = fa.flash_attention(q3, k3, v3, causal=causal, schedule=sched,
                                                 skip_masked_k=skip, **kw)
                        want = plain(q3, k3, v3, table, 2, sched, causal=causal,
                                     skip_masked_k=skip, **kw)
                        case = [list(shape), str(dtype).replace("torch.", ""), causal, sched, skip]
                        if dtype == torch.float32:
                            n_bad, e = mismatch(got, want)
                            rows.append((*case, n_bad))
                            err["flash_attention_f32"] = max(err["flash_attention_f32"], e)
                        else:
                            g = tc_gated(gates, got, want, vmax, err)
                            rows.append((*case, g["identical_share"], g["worst_excess"]))
    sync()
    # The reference's gates (tests/test_consumer_conformance.py and
    # tests/test_flash_attention.py), on the card.
    q, k, v = qkv(7, (2, 64, 32))
    vs_exact = {}
    for mode, sched in (("taylor", "paper"), ("taylor", "factored"), ("taylor_pallas", "paper"),
                        ("taylor_pallas", "factored"), ("goldschmidt", "factored"),
                        ("goldschmidt_pallas", "factored")):
        cfg = dm.DivisionConfig(mode=mode, schedule=sched)
        vs_exact[f"{mode}/{sched}"] = max(
            float((dm.attention(q, k, v, cfg, causal=c) - dm.attention(q, k, v, dm.EXACT, causal=c))
                  .abs().max()) for c in (True, False))
    qi = qkv(8, (1, 16, 8))[0]
    ilm_out = dm.attention(qi, qi, qi, dm.DivisionConfig(mode="ilm"))
    ilm_dev = float((ilm_out - dm.attention(qi, qi, qi, dm.EXACT)).abs().max())
    qr, kr, vr = qkv(9, (2, 100, 32))
    ragged = float((dm.attention(qr, kr, vr, dm.DivisionConfig(mode="taylor_pallas"))
                    - dm.attention(qr, kr, vr, dm.EXACT)).abs().max())
    oracle = {}
    for j, (bh, sl, hd, bq, bk, causal, atol, rtol, dtype) in enumerate((
            (2, 256, 64, 128, 128, True, 2e-6, 1e-5, torch.float32),
            (3, 128, 32, 64, 32, True, 2e-6, 1e-5, torch.float32),
            (2, 256, 64, 128, 64, False, 2e-6, 1e-5, torch.float32),
            (1, 512, 128, 128, 128, True, 2e-6, 1e-5, torch.float32),
            (2, 64, 16, 64, 64, True, 2e-6, 1e-5, torch.float32),
            (2, 100, 32, 32, 32, True, 5e-6, 1e-4, torch.float32),
            (3, 77, 32, 32, 16, False, 5e-6, 1e-4, torch.float32),
            (1, 300, 16, 128, 64, True, 5e-6, 1e-4, torch.float32),
            (2, 128, 64, 128, 128, True, 0.04, 0.0, torch.bfloat16))):
        q, k, v = qkv(seed + 40 + j, (bh, sl, hd), dtype)
        o = ops.flash_attention(q, k, v, causal, bq, bk).double()
        e = attention_f64(q, k, v, causal)
        excess = float(((o - e).abs() - (atol + rtol * e.abs())).max())
        oracle[f"{bh}x{sl}x{hd}/bq{bq}/bk{bk}/causal{int(causal)}/{str(dtype)[6:]}"] = {
            "max_abs_err": float((o - e).abs().max()), "atol": atol, "rtol": rtol, "ok": excess <= 0}
    f32_rows = [r for r in rows if r[1] == "float32"]
    bf16 = gate_summary(gates)
    say("flash", cases=len(rows), f32_mismatched_lanes=sum(r[-1] for r in f32_rows),
        bf16_gate=bf16, bf16_cases=[r for r in rows if r[1] == "bfloat16"],
        corpus=[list(c) for c in FLASH_CORPUS], vs_exact_twin=vs_exact, vs_exact_gate=1e-5,
        ragged_taylor_pallas=ragged, ragged_gate=5e-6, ilm_dev=ilm_dev, ilm_window=[1e-8, 1e-2],
        f64_oracle=oracle)
    check(all(r[-1] == 0 for r in f32_rows),
          f"the f32 flash kernel differs from its plain version: {[r for r in f32_rows if r[-1]]}")
    check(bf16["ok"], f"the bf16 flash kernel misses the gate against its plain version: {bf16}")
    check(all(d <= 1e-5 for d in vs_exact.values()), f"attention vs the exact twin: {vs_exact}")
    check(ragged <= 5e-6, f"ragged attention {ragged} > 5e-6")
    check(bool(torch.isfinite(ilm_out).all()) and 1e-8 < ilm_dev < 1e-2, f"ILM attention {ilm_dev}")
    check(all(c["ok"] for c in oracle.values()), f"flash vs the f64 oracle: {oracle}")


def flash_inputs(seed: int):
    """paper_fpdiv's layer-0 q/k/v after RoPE on phase 9's served batch, made
    by the port's own model functions: (b, s, h, hd) bf16, and the lengths."""
    from repro_torch.models import attention as mattn
    from repro_torch.models.layers import embed_tokens, rms_norm

    cfg, params, prompts = serve_setup(seed)
    toks, lengths = padded(prompts)
    b, s = toks.shape
    positions = torch.arange(s, dtype=torch.int32, device=DEVICE).expand(b, s)
    bp = params["groups"][0]["layers"][0]
    h = rms_norm(embed_tokens(params["embed"], toks, cfg), bp["mixer_norm"], cfg.division,
                 cfg.norm_eps)
    p = bp["attn"]
    q = mattn.rope_apply(mattn._proj(h, p["wq"]), positions, cfg)
    k = mattn._repeat_kv(mattn.rope_apply(mattn._proj(h, p["wk"]), positions, cfg), cfg.q_per_kv)
    v = mattn._repeat_kv(mattn._proj(h, p["wv"]), cfg.q_per_kv)
    return q, k, v, positions, lengths


def phase_flash_serve(seed: int, err: dict, launches: dict):
    """division_modes.attention at full width on the served model's own
    q/k/v: bf16 in both kernel modes and once at S = 1000 (the tensor-core
    kernel, under its gate against its plain version), then the same
    q/k/v in f32 (the f32 kernel, bit for bit). Returns the (b, h, s, hd)
    q/k/v for the times."""
    from repro_torch.core import division_modes as dm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.models import attention as mattn

    q, k, v, positions, lengths = flash_inputs(seed)
    b, s, h, hd = q.shape
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))     # (b, h, s, hd)
    sel = torch.tensor(FLASH_PLAIN_HEADS, device=DEVICE)
    mask = positions[:, None, :, None] >= positions[:, None, None, :]
    vmax = float(v.float().abs().max())
    out, gates = {}, []

    def plain_slice(o, qs, ks, vs, div):
        """The kernel's output on the selected heads and the plain version's."""
        n = qs.shape[-2]
        flat = lambda t: t.reshape(b * h, n, hd)[sel]
        want = ref.flash_attention_ref(flat(qs), flat(ks), flat(vs), causal=True,
                                       n_iters=div.n_iters, precision_bits=div.precision_bits,
                                       schedule=dm._kernel_schedule(div))
        return flat(o), want

    sync()
    fa.reset_launches()
    for mode in ("taylor_pallas", "goldschmidt_pallas"):
        div = dm_config(mode)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        o = dm.attention(qh, kh, vh, div)
        sync()
        flash_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        g = tc_gated(gates, *plain_slice(o, qh, kh, vh, div), vmax, err)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = mattn._sdpa(q, k, v, mask, div, 1.0 / math.sqrt(hd))        # (b, s, h, hd)
        sync()
        sdpa_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        dev = max(float((o[i, :, :n].transpose(0, 1).float() - want[i, :n].float()).abs().max())
                  for i, n in enumerate(lengths.tolist()))
        out[mode] = {"plain_heads": len(FLASH_PLAIN_HEADS), "gate": g,
                     "vs_sdpa_max_abs": dev, "vs_sdpa_over_max_abs_v": dev / vmax,
                     "flash_peak_gib": flash_gib, "sdpa_peak_gib": sdpa_gib,
                     "score_tensor_gib": b * h * s * s * 4 / 2**30, "finite": bool(torch.isfinite(o).all())}
        del o, want
    # S = 1000: the sk_real path (q and k/v padded to 1024) at full width.
    div = dm_config("taylor_pallas")
    q1, k1, v1 = (t[:, :, :1000].contiguous() for t in (qh, kh, vh))
    o1 = dm.attention(q1, k1, v1, div)
    sync()
    g = tc_gated(gates, *plain_slice(o1, q1, k1, v1, div), vmax, err)
    out["taylor_pallas_s1000"] = {"gate": g, "finite": bool(torch.isfinite(o1).all())}
    counts_bf16 = dict(fa.LAUNCHES)
    # The same q/k/v in f32 through the f32 kernel, held bit for bit.
    fa.reset_launches()
    qf, kf, vf = (t.float() for t in (qh, kh, vh))
    of = dm.attention(qf, kf, vf, div)
    sync()
    counts_f32 = dict(fa.LAUNCHES)
    n_bad, e = mismatch(*plain_slice(of, qf, kf, vf, div))
    err["flash_attention_f32"] = max(err["flash_attention_f32"], e)
    out["taylor_pallas_f32"] = {"mismatched_lanes": n_bad, "finite": bool(torch.isfinite(of).all())}
    del of
    for key in launches:
        if key.startswith("flash_attention"):
            launches[key] += counts_bf16[key] + counts_f32[key]
    summary = gate_summary(gates)
    say("flash_serve", arch="paper_fpdiv", layer=0, shape=[b * h, s, hd], dtype=str(q.dtype)[6:],
        lengths=lengths.tolist(), division=dataclasses.asdict(div),
        launches={"bfloat16": counts_bf16, "float32": counts_f32}, max_abs_v=vmax,
        bf16_gate=summary, vs_sdpa_gate_over_max_abs_v=0.04, runs=out)
    check(counts_bf16 == {"flash_attention_f32": 0, "flash_attention_bf16": 3},
          f"bf16 flash launches {counts_bf16}, expected 3 of the bf16 kernel and 0 of the f32 one")
    check(counts_f32 == {"flash_attention_f32": 1, "flash_attention_bf16": 0},
          f"f32 flash launches {counts_f32}, expected 1 of the f32 kernel")
    check(summary["ok"], f"the bf16 flash kernel at full width misses the gate: {summary}")
    for key, r in out.items():
        check(r.get("mismatched_lanes", 0) == 0 and r["finite"], f"flash at full width, {key}: {r}")
        check(r.get("vs_sdpa_over_max_abs_v", 0.0) <= 0.04, f"flash vs _sdpa, {key}: {r}")
    return qh, kh, vh


def ilm_operands(seed: int):
    """ILM_LANES seeded operand pairs in [1, 2^16), the edges 0, 1 and
    2^16 - 1 in every pairing first, as uint32 on the card."""
    rng = np.random.default_rng(seed + 30)
    a = rng.integers(1, 2**16, ILM_LANES, dtype=np.int64).astype(np.uint32)
    b = rng.integers(1, 2**16, ILM_LANES, dtype=np.int64).astype(np.uint32)
    e = np.array([0, 1, 2**16 - 1], np.uint32)
    a[:9], b[:9] = np.repeat(e, 3), np.tile(e, 3)
    return torch.from_numpy(a).to(DEVICE), torch.from_numpy(b).to(DEVICE)


def phase_ilm(seed: int, err: dict, launches: dict):
    """ops.ilm_mul / ilm_square at each iteration count (the path of the
    reference's bench_ilm_accuracy), then each output against the plain
    version and the exact product. Returns the operands for the times."""
    from repro_torch.core import ilm as ilm_core
    from repro_torch.kernels import ilm, ops

    a, b = ilm_operands(seed)
    sync()
    ilm.reset_launches()
    outs = {it: (ops.ilm_mul(a, b, iters=it), ops.ilm_square(a, iters=it)) for it in ILM_ITERS}
    sync()
    counts = dict(ilm.LAUNCHES)
    for key, n in counts.items():
        launches[key] += n
    a64, b64 = ilm_core.as_u32_lanes(a), ilm_core.as_u32_lanes(b)
    exact_mul, exact_sq = a64 * b64, a64 * a64
    nz = exact_mul > 0
    rows, table = [], {}
    for it, (pm, ps) in outs.items():
        for name, got, want in (("ilm_mul_u32", pm, ilm.ilm_mul_plain(a, b, it)),
                                ("ilm_square_u32", ps, ilm.ilm_square_plain(a, it))):
            n_bad, e = u32_mismatch(got, want)
            rows.append((name, it, n_bad))
            err[name] = max(err[name], e)
        p = ilm_core.as_u32_lanes(pm)
        rel = (exact_mul - p)[nz].double() / exact_mul[nz].double()
        table[it] = {"max_rel": float(rel.max()), "mean_rel": float(rel.mean()),
                     "exact_frac": float((p == exact_mul).double().mean()),
                     "square_exact_frac": float((ilm_core.as_u32_lanes(ps) == exact_sq).double().mean())}
    bound = ilm_core.exact_iters_bound(16)
    exact_at_bound = (bool((ilm_core.as_u32_lanes(outs[bound][0]) == exact_mul).all()),
                      bool((ilm_core.as_u32_lanes(outs[bound][1]) == exact_sq).all()))
    say("ilm", lanes=a.numel(), iters=list(ILM_ITERS), launches=counts, mismatched_lanes=rows,
        exact_at_bound={"iters": bound, "mul": exact_at_bound[0], "square": exact_at_bound[1]},
        accuracy=table)
    check(counts == {"ilm_mul_u32": len(ILM_ITERS), "ilm_square_u32": len(ILM_ITERS)},
          f"ILM launches {counts}")
    check(all(r[2] == 0 for r in rows), f"an ILM kernel differs from its plain version: {rows}")
    check(all(exact_at_bound), f"ILM at iters={bound} is not the exact product")
    # Both closed forms over all of uint32 (wrap included) against their
    # plain versions' stage loop, at every iters up to 32; the multiplier's
    # operands start with the edges in every pairing.
    rng = np.random.default_rng(seed + 31)
    fa, fb = (rng.integers(0, 2**32, ILM_FULL_RANGE_LANES, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    edges = np.array([0, 1, 2**16 - 1, 2**32 - 1, 0xFFFF0000], np.uint32)
    fa[:4] = edges[:4]
    fa[4:4 + edges.size**2], fb[4:4 + edges.size**2] = np.repeat(edges, 5), np.tile(edges, 5)
    fa, fb = torch.from_numpy(fa).to(DEVICE), torch.from_numpy(fb).to(DEVICE)
    full_rows = []
    for it in range(1, 33):
        full_rows.append(("ilm_square_u32", it, u32_mismatch(ilm.ilm_square(fa, it),
                                                              ilm.ilm_square_plain(fa, it))[0]))
        full_rows.append(("ilm_mul_u32", it, u32_mismatch(ilm.ilm_mul(fa, fb, it),
                                                           ilm.ilm_mul_plain(fa, fb, it))[0]))
    say("ilm_full_range", lanes=fa.numel(), kernels=["ilm_square_u32", "ilm_mul_u32"],
        mismatched_lanes=[r for r in full_rows if r[2]], iters_checked=32,
        edge_pairs=int(edges.size**2))
    check(all(r[2] == 0 for r in full_rows),
          f"an ILM kernel differs from its plain version over all of uint32: "
          f"{[r for r in full_rows if r[2]]}")
    return a, b


def phase_ilm_serve(seed: int):
    """paper_fpdiv at full width served in mode="ilm", teacher-forced against
    the exact twin with f32 params: reported, not gated (the ILM mode is
    ~1e4 ulp by design)."""
    agree, drift, _ = mode_agreement(*model_setup("paper_fpdiv", seed, "float32", ILM_SERVE_LENS),
                                     ILM_SERVE_NEW, mode="ilm")
    say("ilm_serve", arch="paper_fpdiv", params_dtype="float32", prompt_lens=list(ILM_SERVE_LENS),
        steps=ILM_SERVE_NEW, division=dataclasses.asdict(dm_config("ilm")),
        f32_teacher_forced_agreement=agree, f32_logit_drift=drift)
    check(math.isfinite(drift), f"ILM serving gave non-finite logits: drift {drift}")


def phase_times_attention_ilm(err: dict, launches: dict, flash_in, ilm_in):
    """Flash attention at (96, 2048, 64) causal in the served config's
    schedule, bf16 (tensor cores) and the same q/k/v in f32 (CUDA cores),
    each against scaled_dot_product_attention on its own inputs (and the
    SDPA call's device kernels by name); the ILM kernels on ILM_LANES lanes
    at iters 16 and 4."""
    from repro_torch.core import ilm as ilm_core
    from repro_torch.core.seeds import compute_segments
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ilm

    div = dm_config("taylor_pallas")
    b, h, s, hd = flash_in[0].shape
    sel = torch.tensor(FLASH_PLAIN_HEADS, device=DEVICE)
    table = compute_segments(div.n_iters, div.precision_bits)
    rows = []
    for name, dtype, ops_per_s, device_name in (
            ("flash_attention_bf16", torch.bfloat16, BF16_TC_OPS_PER_S, "flash_tc_kernel"),
            ("flash_attention_f32", torch.float32, F32_OPS_PER_S, "flash_kernel")):
        qh, kh, vh = (t.to(dtype) for t in flash_in)
        q3, k3, v3 = (t.reshape(b * h, s, hd) for t in (qh, kh, vh))
        q8, k8, v8 = (t[sel].contiguous() for t in (q3, k3, v3))
        kernel = lambda: fa.flash_attention(q3, k3, v3, causal=True, schedule=div.schedule)
        plain = lambda: fa.PLAIN[name](q8, k8, v8, table, div.n_iters, div.schedule, causal=True,
                                       block_k=min(128, s), sk_real=s, skip_masked_k=True)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh,
                                                                            is_causal=True)
        library_kernels = device_times(library)
        rows.append(kernel_row(name, event_ms(kernel), event_ms(plain, 1), event_ms(library),
                               4 * q3.numel() * q3.element_size(),
                               b * h * (s * (s + 1) // 2) * hd, launches, err, ops_per_s=ops_per_s,
                               shape=[b * h, s, hd], dtype=str(dtype).replace("torch.", ""),
                               causal=True, plain_heads=len(FLASH_PLAIN_HEADS),
                               device_ms=device_ms(kernel, device_name),
                               library_device_ms=sum(library_kernels.values()) or None,
                               library_kernels=library_kernels))
        say("times", **rows[-1])
        del qh, kh, vh, q3, k3, v3
    a, bb = ilm_in
    a64, b64 = ilm_core.as_u32_lanes(a), ilm_core.as_u32_lanes(bb)
    pa, pb = ilm_core._popcount32(a64), ilm_core._popcount32(b64)
    # Both kernels at iters 16 (every 16-bit operand on the popcount route)
    # and 4 (most lanes on a residue loop), with their kernels' device time.
    for name, kernel_name, nbytes, library, kernel, plain, ops, stages in (
            ("ilm_mul_u32", "ilm_mul_kernel", 12, lambda: torch.mul(a64, b64),
             lambda it: lambda: ilm.ilm_mul(a, bb, it),
             lambda it: lambda: ilm.ilm_mul_plain(a, bb, it),
             lambda it: ilm_mul_ops(pa, pb, it),
             lambda it: ILM_MUL_STAGE_OPS * torch.minimum(torch.clamp(pa, max=it), pb)),
            ("ilm_square_u32", "ilm_square_kernel", 8, lambda: torch.mul(a64, a64),
             lambda it: lambda: ilm.ilm_square(a, it),
             lambda it: lambda: ilm.ilm_square_plain(a, it),
             lambda it: ilm_square_ops(pa, it),
             lambda it: ILM_SQUARE_STAGE_OPS * torch.clamp(pa, max=it))):
        library_ms, library_dev = event_ms(library), device_ms(library)
        for it in ILM_TIMED_ITERS:
            slow = (pa > it) | (pb > it) if name == "ilm_mul_u32" else pa > it
            rows.append(kernel_row(
                name, event_ms(kernel(it)), event_ms(plain(it), 3), library_ms,
                nbytes * a.numel(), a.numel(), launches, err, ops_per_s=INT32_OPS_PER_S,
                ops=ops(it), shape=[a.numel()], iters=it,
                device_ms=device_ms(kernel(it), kernel_name), library_device_ms=library_dev,
                residue_lanes=float(slow.double().mean()),
                stage_loop_bound_ms=int(stages(it).sum()) / INT32_OPS_PER_S * 1e3))
            say("times", **rows[-1])
    return rows


def ilm_square_ops(popcounts: torch.Tensor, iters: int) -> int:
    """Integer operations the squarer kernel does on these operands
    (OPS_PER_ELEMENT's count per lane, the residue's where popcount > iters)."""
    slow = int((popcounts > iters).sum())
    return (OPS_PER_ELEMENT["ilm_square_u32"] * popcounts.numel()
            + (ILM_SQUARE_RESIDUE_OPS + ILM_STEP_OPS * iters) * slow)


def ilm_mul_ops(pa: torch.Tensor, pb: torch.Tensor, iters: int) -> int:
    """Integer operations the multiplier kernel does on these operand pairs
    (OPS_PER_ELEMENT's count per lane, each operand's residue loop where its
    popcount > iters)."""
    slow = int((pa > iters).sum()) + int((pb > iters).sum())
    return OPS_PER_ELEMENT["ilm_mul_u32"] * pa.numel() + ILM_STEP_OPS * iters * slow


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", type=Path, help="also write the full result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is reported", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import tsdiv

    t_start = time.perf_counter()
    smi = phase_device()
    err = phase_kernels(args.seed)
    err.update(softmax_f32=0.0, softmax_split_f32=0.0, rmsnorm_f32=0.0, flash_attention_f32=0.0,
               flash_attention_bf16=0.0, ilm_mul_u32=0.0, ilm_square_u32=0.0)
    phase_golden()
    launches = {k: 0 for k in err}
    # The ep phase's 4 ranks need most of the card: it runs before the later
    # phases' kept inputs fragment this process's cache (~16 GiB reserved
    # by the mesh phase).
    phase_ep(args.seed, launches, err)
    phase_tp_ssm(args.seed, launches, err)
    tsdiv.reset_launches()
    phase_gradients(args.seed)
    for k, v in tsdiv.LAUNCHES.items():
        launches[k] += v
    phase_kmeans(args.seed, launches)
    phase_qr(args.seed, launches)
    plane = phase_calls(args.seed, err)
    phase_consumers(args.seed, err)
    phase_serve(args.seed, launches)
    phase_conformance(launches)
    firsts = {sv.phase.removeprefix("serve_"): phase_serve_model(sv, args.seed, launches, err)
              for sv in (SWA, MOE, SSM, HYBRID, ENCDEC, VLM)}
    flash_in = phase_flash_serve(args.seed, err, launches)
    ilm_in = phase_ilm(args.seed, err, launches)
    recips, train = phase_train(args.seed, launches, err)
    phase_roofline(args.seed, train, smi)
    # The mesh phase's two ranks need room on the card: the distance plane
    # (4 GB, for the times phase) waits on the host meanwhile.
    plane = plane.cpu()
    mesh = phase_mesh(args.seed, launches, err)
    tp = phase_tp(args.seed, launches, err)
    plane = plane.cuda()
    check(all(launches.values()), f"a kernel was not launched on the main path: {launches}")
    consumer_inputs = phase_serve_calls(args.seed, err)
    phase_flash(args.seed, err)
    phase_ilm_serve(args.seed)
    rows = phase_times(plane, err, launches, consumer_inputs)
    rows += phase_times_attention_ilm(err, launches, flash_in, ilm_in)
    rows += phase_times_models(err, launches, firsts)
    rows += phase_times_train(err, launches, recips)
    rows += phase_times_mesh(err, launches, mesh)
    rows += phase_times_split(err, launches, tp["split_inputs"])
    result = {"kernels": rows}
    say("wall", seconds=time.perf_counter() - t_start)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(
            {**result, "nvidia_smi": smi, "seconds": time.perf_counter() - t_start},
            indent=1))
    print(json.dumps(result))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
