#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Copied alone into a directory without the repository it exits 2 and says
so: it runs the port from ``src/repro_torch`` beside it.

Phases (each prints its seconds; any failure exits non-zero):
  1. device   — the card's name and power limit; no CUDA device is an error.
  2. build    — compile every kernel of the path (one nvcc per source, in
                parallel) into build/repro_torch/.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                its path's shapes, with its tolerance, its time, the
                plain version's time, one PyTorch library call's time (in
                the path's dtype: bf16 for vq_dequant_matmul's int8
                codebooks, the f32 call's time beside it) and the least time the card could take (bound), and the
                variant that ran (vq_dequant_matmul: split-K at M <= 16,
                int8 or 3-term tensor cores for bf16 x above; flash:
                tensor cores for bf16). The card is kept busy for a second
                first, so the first timed row meets ramped clocks.
                vq_assign's source also holds the quantizer's two loops,
                one launch each: vq_group_sweep at one 256-column group of
                wq and of w1 (2.25bpv_2d, U from a seeded activation
                sample's Hessian), held bitwise to vq_assign with U = I
                and to the plain loop with the real U (indices on >= 99%
                of spans, tr(E H E^T) within 1%); vq_em at the quantizer's
                bands and the KV codebook fit's (codebooks at 10 steps
                within rtol 1e-4, atol 1e-5; distortion at 25 within 0.1%);
                both the same bits from call to call.
                vq_assign, vq_group_sweep, vq_em, vq_dequant_matmul and
                paged_attention rows also carry their device time, the
                call replayed from a CUDA graph. vq_dequant_matmul's
                codebooks are
                in the path's form (int8 times a per-(group, band) scale),
                plus one row per regime with arbitrary f32 ones; its rows
                are held bitwise independent of the other rows of x and
                bitwise the same from call to call at M = 4 and M = 64.
                paged_attention runs at the 256-token engine's shapes
                (serve: Llama-2-7B heads; gqa: Qwen2-72B heads) and at the
                4096-token context (long, gqa long: 256 pages a slot),
                every page format with f32 queries and the serve dtypes
                with bf16 ones; at long and gqa long each slot's output
                is held bitwise equal alone and in the batch, and from
                call to call.
                Each bf16 flash row also counts the outputs that differ
                from bf16(plain) for the tensor-core kernel, the FP32 one
                and p1-only and p1 + p2 controls (every term of p shows).
                For the budget phase: vq_group_sweep in its babai metric
                mode at the wq and w1 groups (held to its plain version by
                the same bars, counted under launches_by_impl["babai"]),
                and one vq_group_sweep and one vq_em row at a d = 1
                (2.125bpv_1d) and a k = 256 (4.125bpv_2d) setting at the
                wq group's shape.
                For the train phase: flash_attention at its microbatch (B
                2, 4,096 tokens, 32 heads of 128) and the backward kernel
                (flash_attention_bwd) against flash_attention_bwd_plain on
                the same q, k, v, dout and the forward kernel's out, the
                kernel fed the forward kernel's lse and the plain version
                flash_attention_plain's, which the kernel's is held to
                (rtol 1e-5 plus 1e-5 * max|lse|): the train shape in bf16
                and f32, GQA (64 heads over 8),
                a q_offset (Sq 512, Sk 2048), non-causal at hd 64, and f32
                queries over bf16 keys and values; f32 within rtol 1e-4,
                atol 1e-5 * max|g|, bf16 within one bf16 rounding of the
                f32 plain result plus 1e-3 * max|g|; the same bits on two
                calls; the forward's out bitwise equal with and without
                its lse; timed beside SDPA's backward alone.
  4. small    — the whole path on the SKILL smoke config, on the card and
                on the CPU (plain versions), held against each other.
  5. main     — the port's main path at Llama-2-7B full width with depth cut
                to 2 layers (random weights from seed 0): calibration
                tokens, fp perplexity, GPTVQ quantize_model at 2.25bpv_2d
                (em_iters 25, update_iters 10, pack=True), then the packed
                model's perplexity through prepare_fused_tree (every
                quantized matmul in the vq_dequant_matmul kernel). Launch
                counts are zeroed just before and read just after: one
                vq_group_sweep and one vq_em launch a column group (278),
                no vq_assign; all 14 vq_dequant_matmul launches must be
                int8 tensor-core ones. Stage seconds are printed beside
                the readings from when the host launched every span and
                EM step.
                Then
                teacher-forced logits of the fused form against the
                dequant_tree (gather) form.
  5b. mesh    — the data axis of the mesh. (a) NCCL at world size 1 on
                the card (launch.mesh.make_host_mesh): accumulate_sharded
                against accumulate and accumulate_diag on main's
                4096-column activations (2 x 512 rows; bitwise reported),
                and main's quantize under hessian_mesh= against main's
                packed payload (sha256, equal), launches as main's. (b)
                2 ranks over gloo on the one card (NCCL refuses two ranks
                on one device): this script under torchrun as
                ``chip_smoke.py mesh-worker <dir>``, each rank running
                main's quantize with the Hessians captured over the data
                axis: every tap's merged sum after every call within 1e-5
                of max|H| of the single-device sum of the same
                activations, the two ranks' payloads bitwise equal, bpv
                exactly 2.25, each target's tr(E H E^T) within 1% of
                main's, vq_group_sweep and vq_em 278 times a rank and
                vq_assign never, and main's fused-vs-gather evaluation at
                main's bars (14 tc_int8 launches a rank). Prints each
                part's backend and world size.
  6. budget   — the budgeted path at the same full width: fresh weights
                (seed 0), main's tokens, quantize_model at budget_bpv 2.5
                (raised by 0.25 until the allocator picks two settings)
                with the closed-form scorer and main's overrides; the
                allocation, achieved bpv (<= the budget), stage seconds and
                recon error printed. Held: vq_group_sweep and vq_em once a
                column group of the allocated settings (all diagonal),
                vq_assign never, no (c, c) Hessian built in the pre-pass
                (init_hessian counted inside it), the packed model's
                perplexity with one vq_dequant_matmul launch a packed leaf,
                by variant as the host plan predicts, and main's
                fused-vs-gather bars. Then the method table on block 0's
                full-width Hessians (wq, w1, w2): gptvq, kmeans and
                kmeans_data at 2.125bpv_2d, IntQuant(2, 128) by RTN and
                GPTQ, gptvq with the babai and cd solvers at 2.25bpv_2d,
                each one's tr(E H E^T) and seconds; held: cd_refine never
                above the gptq sweep it refines and every babai sweep
                launched in-kernel; the Table-1 order is printed only.
  7. serve    — main's packed model served by the paged engine (max_batch
                4, max_len 256, page_size 16, f32 KV pages, fused paged
                attention and fused VQ matmuls): 8 greedy requests of 40-72
                prompt tokens, 64 new tokens each. Launch counts zeroed just
                before ``run`` and read just after: paged_attention must
                equal decode ticks x layers, vq_dequant_matmul must run at
                M = 4 and, by variant, as the host plan predicts (split-K
                for decode ticks and chunks of <= 16 rows, int8 tensor
                cores for wider prefill chunks). Then teacher-forced
                logits of request 0 through the paged path (gather
                prefill + kernel decode) against the cache-free forward
                and against the gather decode, and three
                shorter engines (4 requests, 32 new tokens) with int8, int4
                and vq2 pages, their drift against the f32-page run printed
                and the vq2 engine's codebook fit counted (one vq_em
                launch a pool and layer, no vq_assign; counts zeroed just
                before the engine is built). Last,
                the long run: an engine of Llama-2-7B's 4096-token context
                (max_len 4096, f32 pages), 4 greedy requests of 3,000-4,000
                prompt tokens, 32 new tokens each, so every decode tick's
                paged_attention walks 190-256 pages a slot; its launches
                held to the host plan as above and request 0's
                teacher-forced kernel decode to the gather decode and to
                the cache-free forward, with the 256-token run's bars.
  8. long     — the quantize path at Llama-2-7B's 4096-token context, same
                full-width 2-layer model and recipe: calibration 4 x 4096
                tokens, heldout 8 x 4096; fp perplexity, quantize_model
                with a Telemetry, vq perplexity, the packed checkpoint
                saved (build/repro_torch/long_ckpt, removed after),
                restored and evaluated again. Every attention runs the
                flash_attention kernel; launch and dispatch counts are
                zeroed just before the fp perplexity and read just after
                the restored one, and held to the prediction (10 flash
                launches: 8 on tensor cores, 2 on the FP32 kernel in the
                f32 advance pass; 28 int8 tensor-core vq_dequant_matmul
                launches; vq_group_sweep and vq_em once a column group,
                vq_assign never), with the restored leaves bit for bit, the
                restored perplexity equal to the vq one and the quant
                event counts.
  9. train   — training on one device: full-width Llama-2-7B, 2 layers,
                bf16, on the long phase's 4 x 4096 calibration tokens in 2
                microbatches, AdamW (lr 3e-5, warmup 1, 8 total), remat
                True. The f32 copy's gradients through the kernels against
                the same step with the plain flash forward and backward
                swapped in on the card (relative Frobenius error a leaf
                <= 1e-4, wq/wk/wv among them); 4 bf16 steps on the one
                batch (finite loss and grad norm, loss at step 4 below
                step 1), launches held to the plan (a step: forward 2
                layers x 2 microbatches x 2, all tc; backward 2 x 2), step
                seconds, tokens/s, the model FLOPs share of the bf16 peak
                and max_memory_allocated; one step under remat="save_attn"
                (forward 2 x 2: attention not re-run); one bf16 step's
                gradients against the plain flash pair (<= 2e-2 a leaf);
                4 steps at lr 3e-4, where the loss rises, through the
                kernels and through the plain pair (steps 1-2 within 2e-2
                of each other); last a supervised launch/train run on the
                smoke config with a failure injected at step 3, which
                resumes from its checkpoint to step 6.
  9b. train_families — training the hybrid and audio families on one
                device: Zamba2-7B at the hybrid phase's width and depth (12
                Mamba layers in 2 groups, LoRA B drawn non-zero) on the long
                phase's 4 x 4096 tokens, and whisper-small at full width and
                depth (q/k/v biases drawn non-zero) on 4 x 448 decoder
                tokens with 4 x 1,500 stub frames; 2 microbatches, remat
                True (a checkpointed hybrid group; checkpointed audio
                layers), train's AdamW (lr 3e-5). For each: the f32 copy's
                gradients through the kernels against the plain flash pair
                (<= 1e-4 a leaf, the hybrid's shared wq/wk/wv and LoRA A/B
                among them; its Mamba scan's per-head A_log, dt_bias and
                D_skip <= 3.3e-4, beside a control: the plain pair at
                other chunk sizes), remat=True against remat=False in the
                f32 copy (<= 1e-6; the hybrid at one 4096-token sequence),
                one bf16 step's gradients: the kernels no further from
                the f32 copy's gradients than the plain bf16 path (1.25x a
                leaf, 2x on the scan leaves) and, an outer guard, against
                the plain pair (audio <= 2e-2, the hybrid <= 7.8e-2), 4
                bf16 steps (finite loss and grad norm, loss at step 4
                below step 1; seconds a step, tokens/s, model FLOPs share
                of the bf16 peak, max_memory_allocated), and flash
                launches by variant held to the host plan (the hybrid:
                forward with its lse twice and backward once a group and
                microbatch, tc in bf16 and fp32 in the f32 copy; audio:
                none, its attention stays under 2048 tokens). Its kernels-
                phase rows: flash_attention with its lse and the tc
                backward at the hybrid's microbatch (B 2, 4,096 tokens, 32
                heads of 112).
  9c. model_axis — the mesh's model axis: 2 ranks over gloo on the one
                card (this script under torchrun as ``chip_smoke.py
                model-axis-worker <dir>``), a (data 1, model 2) mesh.
                (a) full-width 2-layer Llama-2-7B on the train phase's
                tokens (2 microbatches, remat): the f32 copy's loss and
                gradients on the mesh, gathered, against the single
                device's (rank 0; <= 1e-4 a leaf), 4 bf16 steps (losses
                within 2e-2 of the train phase's, falling; flash
                launches a rank 8 tc forwards with lse and 4 tc
                backwards a step; seconds, tokens/s, peak memory a
                rank); (b) the step-2 state saved sharded (whole
                arrays), restored with shardings= bit for bit on both
                ranks, step 3 from it bit for bit, and restored again in
                this process (world 1, NCCL), each leaf's shard
                checksums equal to the ranks'; (c) full-width 2-layer
                Qwen3-MoE (64 experts a rank): a forward and backward of
                2 x 2048 tokens (one _apply_ep call a layer), and layer
                0's experts alone on seeded f32 inputs against
                _apply_ep_plain at tp 2: keep masks equal, pairs dropped,
                y, aux and the gradients <= 1e-4. Its kernels-phase
                rows: the flash pair at a rank's heads (B 2, 4,096
                tokens, 16 heads of 128).
 10. moe     — the MoE family at Qwen3-MoE-30B-A3B's full width, depth cut
                to 2 layers (random weights from seed 0, bf16; 128 experts,
                top-8, 32 query heads over 4 kv heads): calibration 16 x 256
                tokens, fp perplexity on a heldout 8 x 256, quantize_model
                at 2.25bpv_2d with a Telemetry (every expert its own
                routed-token Hessians), vq perplexity through
                prepare_fused_tree (each expert stack one vq_dequant_matmul
                launch), then main's serve run on the packed model. Held:
                vq_group_sweep and vq_em once a column group of every
                expert (4,944 each), vq_assign never; achieved bpv equal to
                the host plan's; every expert matmul one launch a stack
                (launches_by_experts[128] = 3 x layers x forwards, no
                expert launched alone), by variant as the host plan
                predicts; fused vs gather teacher-forced logits with the
                gather forward's routing replayed (main's bars) and, free,
                the count of (token, layer) routings that flipped; the
                serve run's kernel decode vs gather decode, routing
                replayed, at the serve bars; solo and interleaved tokens
                identical. Its kernels-phase rows: the expert-stacked
                vq_dequant_matmul at E = 128 for w_in and w_out at the
                decode tick's 32 rows an expert and a prefill chunk's 8,
                bitwise equal to 128 separate 2-D launches and the same
                bits twice, beside torch.bmm on the dense bf16 stack; and
                paged_attention at its serve shape (G = 8).
 11. vlm     — the vlm family at Phi-3-vision-4.2B's full width, depth cut
                to 2 layers (random weights from seed 0, bf16; MHA, 32
                heads of 96): quantize_model at 2.25bpv_2d calibrated on
                text only (the long phase's 4 x 4096 tokens); heldout 2
                sequences of 1,024 seeded patch embeddings + 3,072 text
                tokens: fp and vq perplexity on the text positions, fused
                vs gather logits (main's bars), a dense-cache prefill of
                the patches + 2,048 tokens and one decode step against
                the full forward's row (the serve bars); then main's serve
                run, text only (the engine passes no patches, as the
                reference's), each request alone, and 4 x 32 on vq2
                pages. Held: vq_group_sweep and vq_em once a column group
                (predict_groups), vq_assign never; flash_attention 10 tc
                and 2 fp32 launches at hd 96; every matmul by variant as
                planned; paged_attention every decode tick; kernel vs
                gather decode; solo = interleaved tokens. Its kernels-
                phase rows: paged_attention at its serve shape (B 4, 32
                heads of 96, 16 pages) every format and query dtype, with
                each slot bitwise alone and in the batch; flash_attention
                at B 2, 4,096 tokens, 32 heads of 96 (tc and fp32);
                vq_dequant_matmul at Phi-3's w_in (M 4 and 64).
 12. ssm     — the ssm family at xLSTM-125M's full width and depth (12
                layers, sLSTM at 3 and 9, tied vocab 50,304; bf16):
                calibration 16 x 256, heldout 8 x 256; the two recurrences
                timed alone at a decode tick and a 64-token chunk;
                quantize_model at 2.25bpv_2d with the keep-dense targets
                (mLSTM w_i/w_f, sLSTM r_*) reported with their reasons
                and left untouched; fused vs gather logits in bf16 (bars
                set from the first readings: the random 12-layer model
                amplifies a bf16 rounding, measured in the run as its f32
                copy's sensitivity to rounding the dequantized W) and in
                the f32 copy (main's bars); main's serve run (no
                paged_attention: every prompt fed in exact power-of-two
                chunks, the state slot-resident), each request alone, a
                preemption replay and a prefix cache that stays off; the
                served path teacher-forced, fused vs gather decode and vs
                the cache-free forward, in bf16 (the ssm bars) and in the
                f32 copy (the serve bars). Its kernels-phase rows:
                vq_dequant_matmul at the mLSTM up projection's width (M 4
                and 64), its rows bitwise independent.
 13. hybrid  — the hybrid family at Zamba2-7B's full width, depth cut to
                12 Mamba layers in 2 groups of 6 (random weights from seed
                0 with the LoRA B factors drawn non-zero from a numpy seed,
                bf16; the shared attention's 32 heads of 112, Mamba2 d_inner
                7168, state 64): the SSD scan and a decode step timed
                alone; quantize_model at 2.25bpv_2d calibrated on the long
                phase's 4 x 4096 tokens (the shared block's Hessians over
                both invocations, then each Mamba layer); held: the
                reference adapter's 28 targets, LoRA, norms, conv and scan
                leaves untouched, vq_group_sweep and vq_em once a column
                group (602), vq_assign never, flash_attention 2 tc and 2
                fp32 launches in the quantize and 8 and 8 in the phase, bpv
                exactly the plan's; fused vs gather logits on 2 x 4096
                held-out tokens in bf16 (main's bars) and in the f32 copy,
                with the bf16 sensitivity of W measured; main's serve run
                (paged_attention twice a decode tick, 24 vq_dequant_matmul
                launches a forward, exact power-of-two prefill chunks), the
                densify of the shared block timed alone, teacher-forced
                kernel decode vs gather decode and vs the cache-free
                forward (bf16 at bars set from the readings, the f32 copy
                at the serve bars), each request alone, a preemption
                replay, a prefix cache that stays off, and 4 x 32 on int8
                and vq2 pages. Its kernels-phase rows: vq_dequant_matmul at
                the Mamba2 in_proj (N 14,576: a partial last tile) and
                out_proj (M 4 and 64), in_proj's rows bitwise independent;
                paged_attention at hd 112 every format and query dtype,
                each slot bitwise alone and in the batch; flash_attention
                at B 4, 4,096 tokens, 32 heads of 112 (tc and fp32).
 14. audio   — the audio family at whisper-small's full width and depth
                (12 encoder + 12 decoder layers, 12 heads of 64, 1,500 stub
                frames, random weights from seed 0, bf16): calibration 16 x
                256 decoder tokens with the stub frontend's frames, heldout
                8 x 256 with frames of their own (bf16); fp and vq
                perplexity; quantize_model at 2.25bpv_2d (the decoder's
                cross wk/wv on the encoder memory's Hessians); held: the
                reference adapter's 192 targets, vq_group_sweep and vq_em
                once a column group (792), vq_assign never, no
                flash_attention launch in the phase, bpv exactly 2.25; the
                fused evaluation with frames one vq_dequant_matmul launch a
                packed leaf (72 encoder + 120 decoder, int8 tensor cores,
                the encoder and cross wk/wv at 12,000 rows); fused vs
                gather logits in bf16 and in the f32 copy (main's bars),
                the bf16 sensitivity of W measured; main's serve run
                (frames-free, as the reference's engine: the cross K/V
                stay zero; 12 paged_attention launches and 96
                vq_dequant_matmul launches a decode tick), the cross K/V's
                slot_merge and restore_masked and a tick's cross-attention
                over 1,500 keys timed alone; teacher-forced kernel decode
                vs gather decode and vs a dense-cache prefill of the same
                tokens (serve bars, bf16 and the f32 copy), each request
                alone, a preemption replay, a prefix cache that stays off,
                and 4 x 32 on int8 and vq2 pages. Its kernels-phase rows:
                paged_attention at hd 64 (B 4, 12 heads, 16 pages) every
                format and query dtype, each slot bitwise alone and in the
                batch; vq_dequant_matmul at whisper's w_in and w_out at M 4,
                64 and 12,000 beside torch.matmul on the dense bf16 W, w_in's
                rows bitwise independent; vq_group_sweep at one group of
                w_in (3,072 rows) and of w_out (768 rows) and vq_em over
                such a group's 768 and 192 bands, held as main's.
Then it prints the kernel JSON line, the card line and, last,
{"ok": true, "device": {...}}. Per-shape results go to
chiprun_out/chip_smoke.json. The profiler pass over the quantize path is
``python -m repro_torch.launch.profile_quantize``.

Run as ``chip_smoke.py mesh-worker <dir>`` under torchrun, it is one rank
of the mesh phase's part (b) and writes ``<dir>/rank<r>.json``; as
``chip_smoke.py model-axis-worker <dir>``, one rank of the model_axis
phase. Run as
``chip_smoke.py grad-readings SEED ...``, it takes the hybrid train cell's
gradient readings alone at those seeds (``grad_readings``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, FP32
# (non-tensor-core) FLOP/s and bf16 tensor-core FLOP/s. A product of f32
# operands is bound at the FP32 peak; one of bf16 operands with an f32 sum
# at the bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12

# 2.25bpv_2d on the Llama-2-7B projections: d=2, k=16, 256-column groups of
# 4 rows; (N, K) per layer shape
VQ_D, VQ_K, VQ_GROUP_COLS, VQ_ROWS_PER_BAND = 2, 16, 256, 4
MATMUL_SHAPES = {"wq": (4096, 4096), "w1": (11008, 4096), "w2": (4096, 11008)}
# the vlm, ssm, hybrid and audio phases' widths, held at a decode tick's
# and a prefill chunk's rows: Phi-3-vision's w_in (d_model 3072 -> d_ff
# 8192), xLSTM-125M's mLSTM up projection (768 -> 1536), Zamba2-7B's Mamba2
# in_proj (3584 -> 14,576: its last 64-row tile holds 48 rows) and out_proj
# (7168 -> 3584), and whisper-small's w_in (768 -> 3072) and w_out (3072 ->
# 768), also at its encoder evaluation's rows; each at the layout
# plan_groups gives it at 2.25bpv_2d
FAMILY_MATMUL_SHAPES = {"phi3 w1": (8192, 3072), "xlstm up": (1536, 768),
                        "zamba in_proj": (14576, 3584),
                        "zamba out_proj": (3584, 7168),
                        "whisper w_in": (3072, 768),
                        "whisper w_out": (768, 3072)}
# the budget phase: the budget it starts from (raised by the step until the
# allocator picks two settings), the settings of its extra kernel rows (a
# d = 1 and a k = 256 point) and block 0's matrices of its method table
BUDGET_BPV, BUDGET_STEP = 2.5, 0.25
BUDGET_KERNEL_SETTINGS = ("2.125bpv_1d", "4.125bpv_2d")
METHOD_TABLE_LEAVES = {"wq": ("attn", "wq", "attn_in"),
                       "w1": ("ffn", "w_in", "ffn_in"),
                       "w2": ("ffn", "w_out", "ffn_out_in")}
# the three entry points of csrc/vq_assign.cu: the quantize path launches
# the group sweep and EM once a column group each, and vq_assign not at all
VQ_ENTRY_POINTS = ("vq_assign", "vq_group_sweep", "vq_em")
# the main phase's readings on an NVIDIA H100 80GB HBM3 at 700.00 W while
# the host launched every span step and EM step (about 10 small ops each):
# shown beside this run's, which runs each group's sweep and EM in-kernel
HOST_LOOP_MAIN = {"recon_error": 550.07, "quantize": 13.35,
                  "column_sweep": 7.73, "em_init": 2.41,
                  "codebook_update": 2.64}


def predict_groups(cfg) -> int:
    """Column groups a quantize of ``cfg``'s dense layers runs: 256-column
    groups over the input width of wq, wk, wv, wo, w1 and w3 (d_model) and
    of w2 (d_ff)."""
    return cfg.n_layers * (6 * (cfg.d_model // VQ_GROUP_COLS)
                           + cfg.d_ff // VQ_GROUP_COLS)


def quantize_launch_checks(launches: dict, n_groups: int) -> dict:
    want = {"vq_assign": 0, "vq_group_sweep": n_groups, "vq_em": n_groups}
    return {f"{fn} launches == {n}": launches[fn] == n
            for fn, n in want.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(nbytes: float, flops: float,
             flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    """The least time: bytes over the HBM rate or operations over the peak
    of the units that can do them exactly, whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / flop_per_s
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def impl_delta(before: dict, after: dict) -> dict:
    """Launches by variant between two snapshots of a launches_by_impl."""
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
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


def graph_ms(torch, fn, iters: int = 20):
    """Device time of one call: ``iters`` calls captured in a CUDA graph
    and replayed, so no host dispatch is timed (what ``time_ms`` reads for
    a call whose host work outlasts its kernels). None, with the reason
    logged, if the call cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (3 * iters)
    except RuntimeError as e:  # a measurement, not a check of the port
        log(f"[kernels] graph timing unavailable: {e}")
        return None


def kernel_device_ms(torch, fn, iters: int = 2) -> dict:
    """Device ms a call of each kernel that one call of ``fn`` launches
    once, by kernel name, from torch.profiler over ``iters`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = re.sub(r"^void ", "", name).split("(")[0]
            out[name] = e.device_time_total / iters / 1000
    return out


def _fmt_ms(t) -> str:
    return "n/a" if t is None else f"{t:.4f} ms"


class Failed(Exception):
    pass


def phase_device(torch):
    t0 = time.perf_counter()
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"[device] {name} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | "
        f"{time.perf_counter() - t0:.2f}s")
    log(f"[device] nvidia-smi: {smi}")
    return dev, name, smi


def kernel_label(mangled: str) -> str:
    """The innermost name of an Itanium-mangled kernel and its integer
    template argument, where it has one: 'flash_bwd_dq_tc_kernel<128>'.
    The name's components are length-prefixed; nvcc puts the kernels in
    an anonymous namespace whose component ends in a hex hash."""
    i, name = (3 if mangled.startswith("_ZN") else 2), mangled
    while m := re.match(r"\d+", mangled[i:]):
        n, i = int(m.group()), i + m.end()
        name, i = mangled[i:i + n], i + n
    arg = re.match(r"ILi(\d+)E", mangled[i:])
    return name + (f"<{arg.group(1)}>" if arg else "")


def phase_build():
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all(force=True)
    for name, rep in report.items():
        log(f"[build] {name}.cu {rep['seconds']:.1f}s")
        kernel = "?"
        for ln in rep["ptxas"].splitlines():
            entry = re.search(r"Compiling entry function '([^']+)'", ln)
            if entry:
                kernel = kernel_label(entry.group(1))
            elif "Used" in ln or "spill" in ln:
                log(f"[build]   {kernel}: {ln.strip()}")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.1f}s")


def check_assign(torch, dev, B: int, n: int, label: str) -> dict:
    from repro_torch.core.codebook import weighted_distances
    from repro_torch.kernels.vq_assign import vq_assign, vq_assign_plain

    g = torch.Generator(device=dev).manual_seed(B * 1000 + n)
    d, k = VQ_D, VQ_K
    x = torch.randn((B, n, d), generator=g, device=dev)
    hw = torch.rand((n, d), generator=g, device=dev) + 0.1
    cb = torch.randn((B, k, d), generator=g, device=dev)
    idx_k = vq_assign(x, hw, cb)
    idx_p = vq_assign_plain(x, hw, cb)
    torch.cuda.synchronize()
    diff = x[:, :, None, :] - cb[:, None, :, :]
    dist = torch.sum(hw[None, :, None, :] * diff * diff, dim=-1)
    dk = torch.gather(dist, 2, idx_k.long()[..., None])[..., 0]
    dp = torch.gather(dist, 2, idx_p.long()[..., None])[..., 0]
    # argmin outputs: hold the chosen weighted distances, not the indices
    # (a near-tie may flip an index); same f32 sum, FMA contraction aside
    abs_err = float((dk - dp).abs().max())
    err = float(((dk - dp).abs() / (1 + dp.abs())).max())
    tol = 1e-5
    ms = time_ms(torch, lambda: vq_assign(x, hw, cb))
    dev_ms = graph_ms(torch, lambda: vq_assign(x, hw, cb))
    plain_ms = time_ms(torch, lambda: vq_assign_plain(x, hw, cb))
    lib_ms = time_ms(torch, lambda: torch.argmin(
        weighted_distances(x, hw, cb), dim=-1))
    nbytes = 4 * (x.numel() + hw.numel() + cb.numel() + B * n)
    b_ms, b_by = bound_ms(nbytes, 4.0 * B * n * k * d)
    row = {"name": "vq_assign", "shape": label, "B": B, "n": n, "d": d,
           "k": k, "max_abs_err": abs_err, "max_rel_err": err, "tol": tol,
           "index_agreement": float((idx_k == idx_p).float().mean()),
           "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] vq_assign {label} B={B} n={n}: chosen-distance max abs "
        f"err {abs_err:.2e}, rel err {err:.2e} (tol {tol:.0e}), index agreement "
        f"{row['index_agreement']:.6f} | kernel {ms:.4f} ms "
        f"({_fmt_ms(dev_ms)} replayed from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, argmin(expanded) {lib_ms:.4f} ms, bound "
        f"{b_ms:.6f} ms ({b_by})")
    if not err <= tol:
        raise Failed(f"vq_assign {label}: error {err} > {tol}")
    return row


def sweep_layout(setting: str, r: int, c: int = 4096) -> tuple:
    """(d, k, group columns, rows a band) of a PAPER_SETTINGS point on an
    (r, c) projection, as the quantizer plans it."""
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.gptvq import plan_groups

    cfg = PAPER_SETTINGS[setting]
    cg, rg = plan_groups(r, c, cfg)
    return cfg.d, cfg.k, cg, rg


def sweep_inputs(torch, dev, r: int, setting: str = "2.25bpv_2d",
                 K: int = 4096):
    """One column group of a projection with r rows and K input columns
    (Llama-2-7B's 4096 by default) at ``setting``, as the quantizer meets
    it: W (seed r), U and H from the SPD Hessian of a seeded activation
    sample over the K columns (the group is their first), the Cholesky
    weights, scales of ones (no blockwise normalization) and each band's
    codebook from 25 EM steps (plain version) from its Mahalanobis seed."""
    from repro_torch.core import hessian as hes
    from repro_torch.core.codebook import mahalanobis_init
    from repro_torch.kernels.vq_assign import vq_em_plain

    d, k, cg, rg = sweep_layout(setting, r, K)
    g = torch.Generator(device=dev).manual_seed(r)
    W = torch.randn((r, cg), generator=g, device=dev)
    mix = torch.randn((K, K), generator=g, device=dev) / K ** 0.5
    X = torch.randn((2048, K), generator=g, device=dev) @ (
        torch.eye(K, device=dev) + 0.5 * mix)
    H = hes.finalize(hes.accumulate(hes.init_hessian(K, device=dev), X))
    U = hes.inv_hessian_cholesky(H)
    wgt = hes.cholesky_diag_weights(U)[:cg].contiguous()
    S = torch.ones((r, cg), device=dev)
    spans = cg // d
    Xb = W.reshape(r // rg, rg * spans, d)
    Hw = wgt.reshape(1, spans, d).repeat(rg, 1, 1).reshape(rg * spans, d)
    C = vq_em_plain(Xb, Hw, mahalanobis_init(Xb, k), 25).contiguous()
    return W, U[:cg, :cg], H[:cg, :cg].contiguous(), S, C, wgt, Hw


def check_sweep(torch, dev, layer: str, setting: str = "2.25bpv_2d",
                babai: bool = False) -> dict:
    """vq_group_sweep at one group of ``layer`` (a MATMUL_SHAPES or
    FAMILY_MATMUL_SHAPES projection, (rows, input columns)) at ``setting``
    against its plain loop on the card: with U = I (no feedback; diagonal
    metric) the indices are vq_assign's bits and Q = C[idx] * S bit for bit; with the
    real U the indices agree on >= 99% of spans and the group's error
    tr(E H E^T) is within 1%; two calls give the same bits. ``babai``: the
    kernel's metric mode, each span's full (U_PP^T U_PP)^{-1}, held to the
    plain loop's metric mode by the same bars. Times: the kernel eager and
    from a CUDA graph, the plain loop, and the bound. The timed calls do
    not reset W between calls (the work does not depend on the values)."""
    from repro_torch.core.gptvq import gather_codebooks
    from repro_torch.kernels.vq_assign import (
        span_metrics, vq_assign, vq_group_sweep, vq_group_sweep_plain)

    r, K = matmul_nk(layer)
    d, k, cg, rg = sweep_layout(setting, r, K)
    W0, U, H, S, C, wgt, Hw = sweep_inputs(torch, dev, r, setting, K)
    metric = span_metrics(U, d) if babai else None
    kw = dict(d=d, rows_per_band=rg, exact_span_solve=True, metric=metric)
    spans = cg // d
    identity = {}
    if not babai:
        # no feedback: every span is one assignment of the normalized
        # weights
        W = W0.clone()
        Qi, ii, _ = vq_group_sweep(W, torch.eye(cg, device=dev), S, C, wgt,
                                   **kw)
        ref = vq_assign((W0 / S).reshape(r // rg, rg * spans, d), Hw,
                        C).reshape(r, spans)
        identity = {
            "indices == vq_assign's (bitwise)": torch.equal(ii, ref),
            "Q == C[idx] * S (bitwise)": torch.equal(
                Qi, gather_codebooks(C[None], ii, cg, rg, d) * S),
            "W unchanged": torch.equal(W, W0)}
    # the real U, against the plain loop on the card
    Wk, Wp = W0.clone(), W0.clone()
    impl = "babai" if babai else "diag"
    before = vq_group_sweep.launches_by_impl.get(impl, 0)
    Qk, ik, Ek = vq_group_sweep(Wk, U, S, C, wgt, **kw)
    variant_ok = vq_group_sweep.launches_by_impl.get(impl, 0) == before + 1
    Qp, ip, Ep = vq_group_sweep_plain(Wp, U, S, C, wgt, **kw)
    torch.cuda.synchronize()
    agree = float((ik == ip).float().mean())
    err_k = float(torch.sum((W0 - Qk) * ((W0 - Qk) @ H)))
    err_p = float(torch.sum((W0 - Qp) * ((W0 - Qp) @ H)))
    rows = (ik == ip).all(dim=1)
    abs_err = (float((Qk - Qp)[rows].abs().max()) if rows.any()
               else float("nan"))
    W2 = W0.clone()
    again = vq_group_sweep(W2, U, S, C, wgt, **kw)
    same_bits = all(torch.equal(a, b) for a, b in
                    zip((W2, *again), (Wk, Qk, ik, Ek)))
    Wt = W0.clone()
    ms = time_ms(torch, lambda: vq_group_sweep(Wt, U, S, C, wgt, **kw))
    dev_ms = graph_ms(torch, lambda: vq_group_sweep(Wt, U, S, C, wgt, **kw))
    plain_ms = time_ms(torch, lambda: vq_group_sweep_plain(
        Wt, U, S, C, wgt, **kw), iters=3, warmup=1)
    # bytes: W read and written, S read, U's upper triangle, the codebooks,
    # weights (and metrics) read, Q, E and the indices written; operations:
    # each span's distances to the k centroids (diagonal: 4 a coordinate;
    # babai: y's 2 and y M y's 2 + 2d a coordinate) and the multiply-adds
    # of the in-group update
    nbytes = 4 * (5 * r * cg + cg * (cg + 1) // 2 + C.numel() + cg
                  + r * spans + (metric.numel() if babai else 0))
    per_coord = 4.0 + 2.0 * d if babai else 4.0
    flops = (per_coord * k * r * cg
             + 2.0 * r * d * sum(cg - (j + 1) * d for j in range(spans)))
    b_ms, b_by = bound_ms(nbytes, flops)
    label = f"{layer} group" + ("" if setting == "2.25bpv_2d"
                                else f" {setting}")
    row = {"name": "vq_group_sweep", "shape": label, "setting": setting,
           "metric": impl, "r": r, "cg": cg, "d": d, "k": k,
           "rows_per_band": rg, "identity_u": identity,
           "index_agreement": agree,
           "rows_agreeing": float(rows.float().mean()),
           "error_kernel": err_k, "error_plain": err_p,
           "error_ratio": err_k / err_p, "max_abs_err": abs_err,
           "bitwise_repeat": same_bits, "counted_as": impl,
           "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernels] vq_group_sweep {label} ({impl} metric; {r} x {cg}, "
        f"d={d}, k={k}, {rg} rows a band): U = I {identity or 'n/a'}; real "
        f"U: indices agree on {agree:.6f} of spans (tol 0.99), tr(E H E^T) "
        f"kernel {err_k:.6g} plain {err_p:.6g} (ratio {err_k / err_p:.6f}, "
        f"tol 1%), Q max abs err {abs_err:.2e} on agreeing rows, same bits "
        f"twice {same_bits}, counted as {impl} {variant_ok} | kernel "
        f"{ms:.4f} ms ({_fmt_ms(dev_ms)} from a CUDA graph), plain loop "
        f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    if not (all(identity.values()) and agree >= 0.99 and variant_ok
            and abs(err_k - err_p) <= 0.01 * err_p and same_bits):
        raise Failed(f"vq_group_sweep {label}: {row}")
    return row


def check_em(torch, dev, label: str, B: int, n: int, d: int = VQ_D,
             k: int = VQ_K) -> dict:
    """vq_em against its plain loop on the card at ``B`` bands of ``n``
    points (the quantizer's: Hessian weights shared by the bands; the KV
    codebook fit's: weights of one, a plane a band): at 10 iterations the
    codebooks agree at rtol 1e-4, atol 1e-5 in every band whose last E-step
    gave both the same assignment; at the path's 25 the weighted distortion
    per band agrees within 0.1% on average, and two calls give the same
    bits. Times at 25 iterations.

    The two sum each centroid's points in another order, so their
    codebooks differ in the last bits, and a point on a near-tie can then
    go to another centroid: that band's codebook moves by about a point
    over the centroid's count (~4e-3 at the KV fit's 256 points a
    centroid), its distortion by ~1e-8. Such bands are counted (at most
    10% of them) and held by their distortion only."""
    from repro_torch.core.codebook import mahalanobis_init
    from repro_torch.kernels.vq_assign import (
        vq_assign_plain, vq_em, vq_em_plain)

    iters = KV_FIT_EM_ITERS
    g = torch.Generator(device=dev).manual_seed(B * 7 + n)
    X = torch.randn((B, n, d), generator=g, device=dev)
    Hw = (torch.ones((B, n, d), device=dev) if label == "kv vq2 fit"
          else torch.rand((n, d), generator=g, device=dev) + 0.1)
    C0 = mahalanobis_init(X, k).contiguous()
    c10_k, c10_p = vq_em(X, Hw, C0, 10), vq_em_plain(X, Hw, C0, 10)
    # the assignments the 10th M-step read, from each one's 9th codebooks
    same_e = (vq_assign_plain(X, Hw, vq_em(X, Hw, C0, 9))
              == vq_assign_plain(X, Hw, vq_em_plain(X, Hw, C0, 9))).all(1)
    close = torch.isclose(c10_k, c10_p, rtol=1e-4, atol=1e-5).flatten(1)
    flipped = int((~same_e).sum())
    close10 = bool(close.all(1)[same_e].all()) and flipped <= B // 10
    ck, cp = vq_em(X, Hw, C0, iters), vq_em_plain(X, Hw, C0, iters)
    same_bits = torch.equal(ck, vq_em(X, Hw, C0, iters))

    def distortion(C):
        diff = X[:, :, None, :] - C[:, None, :, :]
        dist = torch.sum(Hw.expand(X.shape)[:, :, None, :] * diff * diff, -1)
        return dist.min(dim=-1).values.sum(dim=-1)

    dk, dp = distortion(ck), distortion(cp)
    dist_rel = float(((dk - dp).abs() / dp).mean())
    abs_err = (float((c10_k - c10_p)[same_e].abs().max()) if flipped < B
               else float("nan"))
    abs_err_all = float((c10_k - c10_p).abs().max())
    ms = time_ms(torch, lambda: vq_em(X, Hw, C0, iters))
    dev_ms = graph_ms(torch, lambda: vq_em(X, Hw, C0, iters))
    plain_ms = time_ms(torch, lambda: vq_em_plain(X, Hw, C0, iters),
                       iters=5, warmup=1)
    # bytes: X, the weights and the seeds read once, the codebooks written;
    # operations: each step's distances (4 a coordinate a centroid) and its
    # M-step sums (a multiply-add and an add a coordinate)
    nbytes = 4 * (X.numel() + Hw.numel() + 2 * C0.numel())
    flops = iters * B * n * d * (4.0 * k + 3.0)
    b_ms, b_by = bound_ms(nbytes, flops)
    row = {"name": "vq_em", "shape": label, "B": B, "n": n, "d": d, "k": k,
           "iters": iters, "close_at_10": close10,
           "bands_flipped_at_10": flipped,
           "bands_close_at_10": int(close.all(1).sum()),
           "max_abs_err": abs_err, "max_abs_err_all_bands": abs_err_all,
           "distortion_rel_diff": dist_rel,
           "bitwise_repeat": same_bits, "ms": ms, "device_ms": dev_ms,
           "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernels] vq_em {label} B={B} n={n}: codebooks at 10 iterations "
        f"within rtol 1e-4, atol 1e-5 where the last E-steps agree {close10} "
        f"(max abs err {abs_err:.2e}; {flipped} of {B} bands with a "
        f"near-tie flip, tol {B // 10}; all bands within the tolerance: "
        f"{row['bands_close_at_10']}, max abs err {abs_err_all:.2e}); "
        f"distortion at {iters} mean rel diff "
        f"{dist_rel:.2e} (tol 1e-3); same bits twice {same_bits} | kernel "
        f"{ms:.4f} ms ({_fmt_ms(dev_ms)} from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by})")
    if not (close10 and dist_rel <= 1e-3 and same_bits):
        raise Failed(f"vq_em {label}: {row}")
    return row


def matmul_inputs(torch, dev, layer: str, M: int, scale_block: int,
                  cb_form: str):
    """Random codes, codebooks and x at a projection's layout (Llama-2-7B's,
    or plan_groups' for FAMILY_MATMUL_SHAPES).
    cb_form "int8": the path's form, int8 values times a per-(group, band)
    f32 scale as quantize_codebooks leaves them (the kernel also gets the
    int8 codebooks and the scales); "f32": arbitrary f32 codebooks."""
    N, K = matmul_nk(layer)
    d, k = VQ_D, VQ_K
    gc, rpb = matmul_layout(layer)
    n_cg, n_bands = K // gc, N // rpb
    g = torch.Generator(device=dev).manual_seed(N + K + M + scale_block)
    words = torch.randint(-2**31, 2**31 - 1, (N, K // d // 8),
                          generator=g, device=dev, dtype=torch.int32)
    cb = torch.randn((n_cg, n_bands, k, d), generator=g, device=dev) * 0.05
    extra = {}
    if cb_form == "int8":
        s = cb.abs().amax(dim=(2, 3)) / 127
        cb_i8 = torch.clamp(torch.round(cb / s[..., None, None]), -128,
                            127).to(torch.int8)
        cb = cb_i8.to(torch.float32) * s[..., None, None]
        extra = dict(codebooks_i8=cb_i8, cb_scale=s)
    scales = None
    if scale_block:
        scales = torch.rand((N, K // scale_block), generator=g,
                            device=dev) + 0.5
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(d=d, code_bits=4, rows_per_band=rpb, group_cols=gc,
              scale_block=scale_block)
    return x, words, cb, scales, extra, kw


def matmul_nk(layer: str) -> tuple[int, int]:
    return {**MATMUL_SHAPES, **FAMILY_MATMUL_SHAPES}[layer]


def matmul_layout(layer: str) -> tuple[int, int]:
    """(group_cols, rows_per_band) of a projection at 2.25bpv_2d: the
    Llama-2-7B layout for MATMUL_SHAPES, plan_groups' for the others."""
    if layer in MATMUL_SHAPES:
        return VQ_GROUP_COLS, VQ_ROWS_PER_BAND
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.gptvq import plan_groups

    N, K = FAMILY_MATMUL_SHAPES[layer]
    return plan_groups(N, K, PAPER_SETTINGS["2.25bpv_2d"])


def check_matmul(torch, dev, layer: str, M: int, scale_block: int,
                 cb_form: str = "int8") -> dict:
    from repro_torch.kernels.vq_dequant_matmul import (
        Prepared, reconstruct, vq_dequant_matmul, vq_dequant_matmul_plain)

    N, K = matmul_nk(layer)
    x, words, cb, scales, extra, kw = matmul_inputs(torch, dev, layer, M,
                                                    scale_block, cb_form)
    # timed as the path calls it: a fused leaf checks its codes and
    # codebooks once (core/vq_linear.fused_matmul), each call checks x
    prep = Prepared(words, cb, scales, k_c=VQ_K, **kw, **extra)
    run = lambda: prep(x)
    before = dict(vq_dequant_matmul.launches_by_impl)
    y = run()
    impl = impl_delta(before, vq_dequant_matmul.launches_by_impl)
    (impl,) = impl
    ref = vq_dequant_matmul_plain(x, words, cb, scales, **kw)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    it = (5, 1) if M * N * K > 2**38 else (20, 3)
    ms = time_ms(torch, run, *it)
    dev_ms = graph_ms(torch, run, it[0])
    plain_ms = time_ms(torch, lambda: vq_dequant_matmul_plain(
        x, words, cb, scales, **kw), *it)
    W = reconstruct(words, cb, scales, **kw)
    xf = x.float()
    # the library call: with the path's int8 codebooks what a dense bf16
    # model runs instead, bf16 x times W rounded to bf16; with arbitrary
    # f32 codebooks (the 3-term variant) the f32 product
    lib_x, lib_w = (x, W.to(torch.bfloat16)) if extra else (xf, W)
    lib = lambda: torch.matmul(lib_x, lib_w.T)
    lib_ms = time_ms(torch, lib, *it)
    lib_dev_ms = graph_ms(torch, lib, it[0])
    lib_f32_ms = (lib_ms if not extra else time_ms(
        torch, lambda: torch.matmul(xf, W.T), *it))
    # the bytes the kernel must move: x, the words, the codebooks it reads
    # (int8 and their scales, or f32), the plane, y
    cb_bytes = (extra["codebooks_i8"].numel() + extra["cb_scale"].numel() * 4
                if extra else cb.numel() * 4)
    nbytes = (x.numel() * x.element_size() + words.numel() * 4 + cb_bytes
              + (scales.numel() * 4 if scale_block else 0) + M * N * 4)
    # whatever variant runs, bf16 x times a bf16-exact W is exact on bf16
    # tensor cores with an f32 sum: the int8 values as they are, an
    # arbitrary f32 value as three bf16 terms (three times the operations)
    flops = 2.0 * M * N * K * (1 if extra else 3)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
    row = {"name": "vq_dequant_matmul", "shape": layer, "M": M, "N": N,
           "K": K, "scale_block": scale_block, "cb_form": cb_form,
           "impl": impl, "max_abs_err": err, "tol": tol, "ms": ms,
           "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "library_device_ms": lib_dev_ms,
           "library_f32_ms": lib_f32_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernels] vq_dequant_matmul {layer} M={M} N={N} K={K} "
        f"sb={scale_block} cb={cb_form} ({impl}): max abs err {err:.2e} "
        f"(tol {tol:.2e}), max rel "
        f"{err / max(float(ref.abs().max()), 1e-30):.2e} | kernel {ms:.4f} "
        f"ms ({_fmt_ms(dev_ms)} replayed from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, torch.matmul {lib_x.dtype} x {lib_w.dtype} "
        f"{lib_ms:.4f} ms ({_fmt_ms(lib_dev_ms)} from a graph), f32 "
        f"torch.matmul {lib_f32_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    if not err <= tol:
        raise Failed(f"vq_dequant_matmul {layer} M={M} sb={scale_block} "
                     f"cb={cb_form}: error {err} > {tol}")
    return row


def check_matmul_rows(torch, dev, layer: str = "wq",
                      cases=((4, 1), (64, 17))) -> dict:
    """Row m of y is the same bit for bit whatever the other rows of x
    hold (the engine's solo-vs-interleaved token identity rests on it),
    and two calls give the same bits. At M = 4 (split-K) y of x[:1] is
    held to row 0; at M = 64 and above (tensor cores) y of x[:17], the
    fewest rows that stay on the tensor cores, to rows 0-16: x[:1] would
    run split-K, whose sums go in another order."""
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul

    out = {}
    for M, sub in cases:
        x, words, cb, _, extra, kw = matmul_inputs(torch, dev, layer, M, 0,
                                                   "int8")
        run = lambda xx: vq_dequant_matmul(xx, words, cb, k_c=VQ_K, **kw,
                                           **extra)
        y = run(x)
        same_run = bool(torch.equal(run(x), y))
        same_rows = bool(torch.equal(run(x[:sub].contiguous()), y[:sub]))
        other = x.clone()
        other[sub:] = -other[sub:]
        same_other = bool(torch.equal(run(other)[:sub], y[:sub]))
        out[M] = {"rows_checked": sub, "two_calls_equal": same_run,
                  "rows_alone_equal": same_rows,
                  "other_rows_changed_equal": same_other}
        log(f"[kernels] vq_dequant_matmul {layer} bitwise at M={M}: two calls "
            f"{same_run}, y(x[:{sub}]) == y(x)[:{sub}] {same_rows}, with "
            f"the other rows changed {same_other}")
        if not (same_run and same_rows and same_other):
            raise Failed(f"vq_dequant_matmul {layer} rows at M={M} are not "
                         "bitwise independent and deterministic")
    return out


def check_expert_matmul(torch, dev, weight: str, M: int) -> dict:
    """The expert-stacked vq_dequant_matmul at E = 128 of one Qwen3-MoE
    expert stack's layout (int8 codebooks, bf16 x of M rows an expert):
    one launch, counted once under its variant and its expert count;
    allclose to the plain per-expert loop; bitwise equal to 128 separate
    2-D launches on each expert's slice and the same bits twice. Timed
    eager and replayed from a CUDA graph, beside the 128 2-D launches, the
    plain loop and torch.bmm on the dense bf16 stack."""
    from repro_torch.kernels.vq_dequant_matmul import (
        Prepared, reconstruct, vq_dequant_matmul,
        vq_dequant_matmul_experts_plain)

    E, (N, K) = MOE_EXPERTS, MOE_MATMUL_SHAPES[weight]
    d, k = VQ_D, VQ_K
    n_cg, n_bands = K // VQ_GROUP_COLS, N // VQ_ROWS_PER_BAND
    g = torch.Generator(device=dev).manual_seed(E + N + K + M)
    words = torch.randint(-2**31, 2**31 - 1, (E, N, K // d // 8),
                          generator=g, device=dev, dtype=torch.int32)
    cb = torch.randn((E, n_cg, n_bands, k, d), generator=g, device=dev) * 0.05
    s = cb.abs().amax(dim=(3, 4)) / 127
    cb_i8 = torch.clamp(torch.round(cb / s[..., None, None]), -128,
                        127).to(torch.int8)
    cb = cb_i8.to(torch.float32) * s[..., None, None]
    x = torch.randn((E, M, K), generator=g, device=dev).to(torch.bfloat16)
    kw = dict(d=d, code_bits=4, rows_per_band=VQ_ROWS_PER_BAND,
              group_cols=VQ_GROUP_COLS, scale_block=0)
    prep = Prepared(words, cb, k_c=k, codebooks_i8=cb_i8, cb_scale=s, **kw)
    run = lambda: prep(x)
    n0 = vq_dequant_matmul.launches
    by_impl = dict(vq_dequant_matmul.launches_by_impl)
    by_e = dict(vq_dequant_matmul.launches_by_experts)
    y = run()
    (impl,) = impl_delta(by_impl, vq_dequant_matmul.launches_by_impl)
    one_launch = (vq_dequant_matmul.launches == n0 + 1 and impl_delta(
        by_e, vq_dequant_matmul.launches_by_experts) == {E: 1})
    ref = vq_dequant_matmul_experts_plain(x, words, cb, **kw)
    ones = [Prepared(words[e], cb[e], k_c=k, codebooks_i8=cb_i8[e],
                     cb_scale=s[e], **kw) for e in range(E)]
    loop = lambda: [p(x[e]) for e, p in enumerate(ones)]
    bitwise = bool(torch.equal(y, torch.stack(loop())))
    twice = bool(torch.equal(run(), y))
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    ms = time_ms(torch, run)
    dev_ms = graph_ms(torch, run)
    loop_ms = time_ms(torch, loop, 5, 1)
    plain_ms = time_ms(torch, lambda: vq_dequant_matmul_experts_plain(
        x, words, cb, **kw), 3, 1)
    Wt = torch.stack([reconstruct(words[e], cb[e], None, **kw)
                      for e in range(E)]).to(torch.bfloat16).transpose(
                          1, 2).contiguous()  # (E, K, N)
    lib_ms = time_ms(torch, lambda: torch.bmm(x, Wt))
    lib_dev_ms = graph_ms(torch, lambda: torch.bmm(x, Wt))
    # the bytes the launch must move: x, every expert's words, int8
    # codebooks and their scales, y; the operations: 2MNK an expert on the
    # bf16 tensor cores (int8 values are exact in bf16)
    nbytes = (x.numel() * 2 + words.numel() * 4 + cb_i8.numel()
              + s.numel() * 4 + E * M * N * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * E * M * N * K, BF16_TC_FLOP_PER_S)
    row = {"name": "vq_dequant_matmul", "shape": f"{weight} experts",
           "E": E, "M": M, "N": N, "K": K, "scale_block": 0,
           "cb_form": "int8", "impl": impl, "max_abs_err": err, "tol": tol,
           "one_launch": one_launch, "bitwise_2d_launches": bitwise,
           "two_calls_equal": twice, "ms": ms, "device_ms": dev_ms,
           "loop_2d_ms": loop_ms, "plain_ms": plain_ms,
           "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"[kernels] vq_dequant_matmul {weight} x {E} experts M={M} N={N} "
        f"K={K} ({impl}): one launch {one_launch}, max abs err {err:.2e} "
        f"(tol {tol:.2e}), bitwise == {E} 2-D launches {bitwise}, two calls "
        f"{twice} | kernel {ms:.4f} ms ({_fmt_ms(dev_ms)} replayed from a "
        f"CUDA graph), {E} 2-D launches {loop_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, torch.bmm(x, W) bf16 {lib_ms:.4f} ms "
        f"({_fmt_ms(lib_dev_ms)} from a graph), bound {b_ms:.4f} ms "
        f"({b_by})")
    if not (err <= tol and one_launch and bitwise and twice):
        raise Failed(f"vq_dequant_matmul {weight} x {E} experts M={M}: "
                     f"error {err} (tol {tol}), one launch {one_launch}, "
                     f"bitwise {bitwise}, two calls {twice}")
    return row


# paged decode attention at the serve phase's shape (Llama-2-7B heads) and
# a GQA shape (Qwen2-72B heads, G = 8), 16 pages of 16 rows a slot as the
# 256-token engine; then both at Llama-2-7B's 4096-token context (256 pages
# a slot, as the long serve run's engine), one slot full, one idle
PAGED_SHAPES = {
    "serve": dict(B=4, H=32, KV=32, hd=128, pos=[0, 57, 111, 135],
                  n_pages=16),
    "gqa": dict(B=4, H=64, KV=8, hd=128, pos=[200, 0, 255, 33], n_pages=16),
    "long": dict(B=4, H=32, KV=32, hd=128, pos=[4095, 3071, 1500, 0],
                 n_pages=256),
    "gqa long": dict(B=4, H=64, KV=8, hd=128, pos=[4095, 3071, 1500, 0],
                     n_pages=256),
    # the moe phase's engine: Qwen3-MoE heads (32 over 4 kv heads, G = 8)
    "moe serve": dict(B=4, H=32, KV=4, hd=128, pos=[0, 57, 111, 135],
                      n_pages=16),
    # the vlm phase's engine: Phi-3-vision heads (MHA, 32 heads of 96)
    "vlm serve": dict(B=4, H=32, KV=32, hd=96, pos=[0, 57, 111, 135],
                      n_pages=16),
    # the hybrid phase's engine: Zamba2-7B's shared attention (MHA, 32
    # heads of 112: 28 of a row's 32 lanes hold dims; vq2 rows of 28 B)
    "zamba serve": dict(B=4, H=32, KV=32, hd=112, pos=[0, 57, 111, 135],
                        n_pages=16),
    # the audio phase's engine: whisper-small's decoder self-attention
    # (MHA, 12 heads of 64: lanes_per_row 16, two page rows a warp)
    "whisper serve": dict(B=4, H=12, KV=12, hd=64, pos=[0, 57, 111, 135],
                          n_pages=16),
}
PAGE_SIZE = 16


def paged_inputs(torch, dev, shape: str, fmt, q_dtype):
    """Random pools in ``fmt`` (quantized by kernels/kv_quant) at a
    PAGED_SHAPES shape, a page table mapping each slot's live pages to
    distinct blocks, the idle slot (pos 0) on an all-scratch row: (q, k
    pool, v pool, table, pos, scale and codebook kwargs)."""
    from repro_torch.kernels import kv_quant as kvq

    sh = PAGED_SHAPES[shape]
    B, H, KV, hd, pos = sh["B"], sh["H"], sh["KV"], sh["hd"], sh["pos"]
    n_pages = sh["n_pages"]
    nb = B * n_pages + 1
    g = torch.Generator(device=dev).manual_seed(H + KV + len(str(fmt)))
    q = torch.randn((B, H, hd), generator=g, device=dev).to(q_dtype)
    kp = torch.randn((nb, PAGE_SIZE, KV, hd), generator=g, device=dev)
    vp = torch.randn((nb, PAGE_SIZE, KV, hd), generator=g, device=dev)
    kw = {}
    if fmt == "bf16":
        kp, vp = kp.to(torch.bfloat16), vp.to(torch.bfloat16)
    elif fmt == "vq2":
        cbs = [torch.randn((KV, 16, 2), generator=g, device=dev)
               for _ in range(2)]
        (kp, ks), (vp, vs) = (kvq.vq_quantize_rows(kp, cbs[0]),
                              kvq.vq_quantize_rows(vp, cbs[1]))
        kw = dict(k_scale=ks, v_scale=vs, k_codebook=cbs[0],
                  v_codebook=cbs[1])
    elif fmt in (8, 4):
        (kp, ks), (vp, vs) = kvq.quantize_kv(kp, fmt), kvq.quantize_kv(vp, fmt)
        kw = dict(k_scale=ks, v_scale=vs)
    kp, vp = kp.contiguous(), vp.contiguous()
    table = torch.zeros((B, n_pages), dtype=torch.int32)
    blocks = iter(torch.randperm(nb - 1, generator=torch.Generator()
                                 .manual_seed(B)).add(1).tolist())
    for b in range(B):
        if pos[b]:
            for p in range(min(pos[b] // PAGE_SIZE + 1, n_pages)):
                table[b, p] = next(blocks)
    table = table.to(dev)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    return q, kp, vp, table, pos_t, kw


def check_paged(torch, dev, shape: str, fmt, q_dtype) -> dict:
    """paged_attention against its plain version on random pools in
    ``fmt``, ragged positions and an idle slot (pos 0, all-scratch table
    row); timed eager, replayed from a CUDA graph, beside the plain version
    and SDPA on the decoded view."""
    from repro_torch.kernels.paged_attention import (
        _decoded_view, paged_attention, paged_attention_plain)

    sh = PAGED_SHAPES[shape]
    B, H, KV, hd, pos = sh["B"], sh["H"], sh["KV"], sh["hd"], sh["pos"]
    n_pages = sh["n_pages"]
    q, kp, vp, table, pos_t, kw = paged_inputs(torch, dev, shape, fmt,
                                               q_dtype)
    run = lambda: paged_attention(q, kp, vp, table, pos_t, **kw)
    out = run()
    ref = paged_attention_plain(q, kp, vp, table, pos_t, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # f32: online softmax, split merges and FMA dot products sum in another
    # order; bf16 output: both round f32 results ~1e-6 apart, so they
    # differ by at most one bf16 ulp, 2^-7 of the value
    rtol, atol = (2e-5, 2e-5) if q_dtype == torch.float32 else (2.0**-7, 1e-5)
    ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
    ms = time_ms(torch, run)
    dev_ms = graph_ms(torch, run)
    plain_ms = time_ms(torch, lambda: paged_attention_plain(
        q, kp, vp, table, pos_t, **kw))
    # library yardstick: SDPA over the K/V view gathered and decoded
    # beforehand, the same kpos <= pos mask
    kd = _decoded_view(kp, kw.get("k_scale"), kw.get("k_codebook"), table,
                       hd).transpose(1, 2).contiguous()
    vd = _decoded_view(vp, kw.get("v_scale"), kw.get("v_codebook"), table,
                       hd).transpose(1, 2).contiguous()
    mask = (torch.arange(kd.shape[2], device=dev)[None, :]
            <= pos_t.long()[:, None])[:, None, None, :]
    qf = q.float()[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(torch, lambda: sdpa(qf, kd, vd, attn_mask=mask,
                                         enable_gqa=True))
    rows = sum(min(p + 1, n_pages * PAGE_SIZE) for p in pos)
    row_bytes = kp.shape[-1] * kp.element_size() + (4 if kw else 0)
    nbytes = (2 * rows * KV * row_bytes + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + B * 4
              + (2 * KV * 32 * 4 if fmt == "vq2" else 0))
    b_ms, b_by = bound_ms(nbytes, 4.0 * rows * H * hd)
    row = {"name": "paged_attention", "shape": shape, "fmt": str(fmt),
           "q_dtype": str(q_dtype).replace("torch.", ""), "B": B, "H": H,
           "KV": KV, "hd": hd, "pos": pos, "n_pages": n_pages,
           "max_abs_err": err, "rtol": rtol, "atol": atol, "ms": ms,
           "device_ms": dev_ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by}
    log(f"[kernels] paged_attention {shape} fmt={fmt} q={row['q_dtype']} "
        f"B={B} H={H} KV={KV} hd={hd} pages={n_pages} pos={pos}: max abs "
        f"err {err:.2e} (rtol {rtol:.1e}, atol {atol:.0e}) | kernel "
        f"{ms:.4f} ms "
        f"({_fmt_ms(dev_ms)} replayed from a CUDA graph), plain "
        f"{plain_ms:.4f} ms, sdpa(decoded view) {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}), {ms / b_ms:.1f}x the bound")
    if not ok:
        raise Failed(f"paged_attention {shape} fmt={fmt}: error {err} "
                     f"past rtol {rtol}, atol {atol}")
    return row


def check_paged_slots(torch, dev, shape: str) -> dict:
    """A slot's output is the same bits alone (B = 1: its q row, table row
    and pos) as inside the batch with the other slots' positions, and the
    same bits from call to call (the engine's solo-vs-interleaved token
    identity rests on it): f32 and vq2 pages, f32 and bf16 queries."""
    from repro_torch.kernels.paged_attention import paged_attention

    out = {}
    for fmt, q_dtype in (("f32", torch.float32), ("f32", torch.bfloat16),
                         ("vq2", torch.float32)):
        q, kp, vp, table, pos_t, kw = paged_inputs(torch, dev, shape, fmt,
                                                   q_dtype)
        run = lambda qq, tt, pp: paged_attention(qq, kp, vp, tt, pp, **kw)
        y = run(q, table, pos_t)
        same_run = bool(torch.equal(run(q, table, pos_t), y))
        alone = [bool(torch.equal(run(q[b:b + 1], table[b:b + 1],
                                      pos_t[b:b + 1])[0], y[b]))
                 for b in range(q.shape[0])]
        key = f"{fmt} pages, {str(q_dtype).replace('torch.', '')} q"
        out[key] = {"two_calls_equal": same_run, "slots_alone_equal": alone}
        log(f"[kernels] paged_attention bitwise at {shape}, {key}: two "
            f"calls {same_run}, each slot alone == in the batch {alone}")
        if not (same_run and all(alone)):
            raise Failed(f"paged_attention {shape} {key}: slots are not "
                         "bitwise independent and deterministic")
    return out


def warm_card(torch, dev, seconds: float = 1.0) -> None:
    """Keep the card busy for ``seconds`` before the first timed row, so
    that its clocks have ramped up when the timing starts."""
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(10):
            a = torch.tanh(a @ a)
        torch.cuda.synchronize()


# the long phase: Llama-2-7B's published 4096-token context
LONG_SEQ, LONG_CALIB, LONG_HELDOUT = 4096, 4, 8

# flash attention at the long phase's shapes (Llama-2-7B heads, 4096-token
# context: heldout B = 8, calibration B = 4), a GQA shape with Qwen2-72B's
# heads, and two small exactness cases (q_offset > 0; non-causal, Sk != Sq)
FLASH_SHAPES = {
    "llama B=8": dict(B=8, Sq=4096, Sk=4096, H=32, KV=32, hd=128,
                      causal=True, q_offset=0),
    "llama B=4": dict(B=4, Sq=4096, Sk=4096, H=32, KV=32, hd=128,
                      causal=True, q_offset=0),
    "gqa": dict(B=1, Sq=4096, Sk=4096, H=64, KV=8, hd=128, causal=True,
                q_offset=0),
    "q_offset": dict(B=2, Sq=512, Sk=2048, H=8, KV=2, hd=128, causal=True,
                     q_offset=1536),
    "non-causal": dict(B=2, Sq=512, Sk=2048, H=8, KV=8, hd=64,
                       causal=False, q_offset=0),
    # the vlm phase's evaluation: Phi-3-vision heads (32 of 96), 1,024
    # patches + 3,072 text tokens a sequence
    "phi3 B=2": dict(B=2, Sq=4096, Sk=4096, H=32, KV=32, hd=96, causal=True,
                     q_offset=0),
    # the hybrid phase's calibration: Zamba2-7B's shared attention (32
    # heads of 112) over the long phase's 4 x 4096 tokens
    "zamba B=4": dict(B=4, Sq=4096, Sk=4096, H=32, KV=32, hd=112,
                      causal=True, q_offset=0),
    # the train phase's microbatch: 2 x 4096 tokens of Llama-2-7B
    "llama B=2": dict(B=2, Sq=4096, Sk=4096, H=32, KV=32, hd=128,
                      causal=True, q_offset=0),
    # the train_families phase's hybrid microbatch: Zamba2-7B's shared
    # attention over 2 x 4096 tokens
    "zamba B=2": dict(B=2, Sq=4096, Sk=4096, H=32, KV=32, hd=112,
                      causal=True, q_offset=0),
}
# shapes whose forward also runs with its log-sum-exp output (the launch a
# train step makes under autograd), bf16: check_flash_lse; the last, a
# model_axis rank's heads of the train phase's microbatch (Llama-2-7B's 32
# heads on a model axis of 2)
FLASH_LSE_SHAPES = {
    "zamba B=2": FLASH_SHAPES["zamba B=2"],
    "llama tp B=2": dict(B=2, Sq=4096, Sk=4096, H=16, KV=16, hd=128,
                         causal=True, q_offset=0),
    # the model_axis phase's families: a rank's 16 heads of Phi-3-vision
    # (hd 96) and of Zamba2-7B's shared attention (hd 112)
    "phi3 tp B=2": dict(B=2, Sq=4096, Sk=4096, H=16, KV=16, hd=96,
                        causal=True, q_offset=0),
    "zamba tp B=2": dict(B=2, Sq=4096, Sk=4096, H=16, KV=16, hd=112,
                         causal=True, q_offset=0),
}

# flash attention's backward: the train phase's microbatch (bf16 and f32),
# GQA with Qwen2-72B's heads, a q_offset, non-causal at hd 64, f32 queries
# over bf16 keys and values, and Zamba2-7B's shared attention (32 heads of
# 112: a head dim not a power of two at full length); (shape, q dtype, kv
# dtype)
FLASH_BWD_SHAPES = {
    "train": dict(B=2, Sq=4096, Sk=4096, H=32, KV=32, hd=128, causal=True,
                  q_offset=0),
    "gqa": dict(B=1, Sq=4096, Sk=4096, H=64, KV=8, hd=128, causal=True,
                q_offset=0),
    "q_offset": dict(B=2, Sq=512, Sk=2048, H=8, KV=2, hd=128, causal=True,
                     q_offset=1536),
    "non-causal": dict(B=2, Sq=512, Sk=2048, H=8, KV=8, hd=64,
                       causal=False, q_offset=0),
    "zamba": dict(B=1, Sq=4096, Sk=4096, H=32, KV=32, hd=112, causal=True,
                  q_offset=0),
    # the train_families phase's hybrid microbatch
    "zamba train": dict(B=2, Sq=4096, Sk=4096, H=32, KV=32, hd=112,
                        causal=True, q_offset=0),
    # the model_axis phase: a rank's 16 heads of the train microbatch,
    # of Phi-3-vision's and of Zamba2-7B's
    "tp train": dict(B=2, Sq=4096, Sk=4096, H=16, KV=16, hd=128,
                     causal=True, q_offset=0),
    "phi3 tp train": FLASH_LSE_SHAPES["phi3 tp B=2"],
    "zamba tp train": FLASH_LSE_SHAPES["zamba tp B=2"],
}
FLASH_BWD_ROWS = (("train", "bfloat16", "bfloat16"),
                  ("train", "float32", "float32"),
                  ("gqa", "bfloat16", "bfloat16"),
                  ("q_offset", "bfloat16", "bfloat16"),
                  ("non-causal", "bfloat16", "bfloat16"),
                  ("q_offset", "float32", "bfloat16"),
                  ("zamba", "bfloat16", "bfloat16"),
                  ("zamba train", "bfloat16", "bfloat16"),
                  ("tp train", "bfloat16", "bfloat16"),
                  ("phi3 tp train", "bfloat16", "bfloat16"),
                  ("zamba tp train", "bfloat16", "bfloat16"))


def flash_bwd_rule(q_name: str, kv_name: str, hd: int) -> str:
    """The backward variant the wrapper must pick for 16-byte aligned
    inputs: tc for bf16 q, k, v with a head dim that is a multiple of 16,
    fp32 otherwise."""
    bf16 = q_name == kv_name == "bfloat16"
    return "tc" if bf16 and hd % 16 == 0 else "fp32"


def flash_pairs(sh: dict) -> int:
    """Unmasked (row, column) pairs of one (batch, head)."""
    Sq, Sk, off = sh["Sq"], sh["Sk"], sh["q_offset"]
    if sh["causal"]:
        return sum(min(Sk, off + i + 1) for i in range(Sq))
    return Sq * Sk


def check_flash_bwd(torch, dev, shape: str, q_name: str,
                    kv_name: str) -> dict:
    """The forward kernel's lse against flash_attention_plain's (f32 on
    the upcast values); the backward kernel, fed the kernel's out and lse,
    against flash_attention_bwd_plain fed the same out and the plain lse
    (f32 on the upcast values), so a wrong lse shows in both checks; the
    same bits on two calls; the forward's out bitwise equal with and
    without its lse; timed beside the plain version and SDPA's backward
    alone."""
    from repro_torch.kernels.flash_attention import (
        _launch_forward, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain)

    sh = FLASH_BWD_SHAPES[shape]
    B, Sq, Sk, H, KV, hd = (sh[n] for n in ("B", "Sq", "Sk", "H", "KV", "hd"))
    causal, off = sh["causal"], sh["q_offset"]
    q_dt, kv_dt = getattr(torch, q_name), getattr(torch, kv_name)
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H + hd + 1)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(q_dt)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(kv_dt)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(kv_dt)
    dout = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(q_dt)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = _launch_forward(q, k, v, causal, off, lse)
    out_bitwise = bool(torch.equal(out, _launch_forward(q, k, v, causal,
                                                        off)))
    _, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=causal, q_offset=off,
                                       with_lse=True)
    # lse: rtol 1e-5 plus 1e-5 * max|lse| (a row's lse is its first
    # score alone, which may lie near 0); an error d scales the row's P,
    # and so its gradients, by exp(-d)
    lse_d = (lse - ref_lse).abs()
    lse_err = float(lse_d.max())
    lse_ok = bool((lse_d <= 1e-5 * ref_lse.abs()
                   + 1e-5 * float(ref_lse.abs().max())).all())
    before = flash_attention_bwd.launches
    before_impl = dict(flash_attention_bwd.launches_by_impl)
    got = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                              q_offset=off)
    again = flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                q_offset=off)
    torch.cuda.synchronize()
    launched = flash_attention_bwd.launches - before
    by_impl = impl_delta(before_impl, flash_attention_bwd.launches_by_impl)
    (impl,) = by_impl if len(by_impl) == 1 else (None,)
    impl_ok = impl == flash_bwd_rule(q_name, kv_name, hd)
    same_bits = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    want = flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), ref_lse,
        causal=causal, q_offset=off)
    del ref_lse
    # f32: rtol 1e-4, atol 1e-5 * max|g| (the kernel sums rows in 64-row
    # tiles, the plain version in 512 x 1024 chunks); bf16: one bf16
    # rounding of the f32 result plus 1e-3 * max|g|
    err, ok = 0.0, True
    for a, w in zip(got, want):
        scale = float(w.abs().max())
        d = (a.float() - w).abs()
        err = max(err, float(d.max()))
        if a.dtype == torch.float32:
            ok = ok and bool((d <= 1e-4 * w.abs() + 1e-5 * scale).all())
        else:
            ok = ok and bool((d <= 2.0**-8 * w.abs() + 1e-3 * scale).all())
        ok = ok and bool(torch.isfinite(a).all())
    del want
    # the train row: the lo terms of P and dS show (the fp32 launch here
    # comes after the launch count above)
    terms = None
    if shape == "train" and impl == "tc":
        terms = bwd_term_counts(torch, q, k, v, out, dout, lse, got)
        log(f"[kernels] flash_attention_bwd {shape}: bf16 dq, dk, dv off "
            f"bf16(plain) {terms}")
    terms_ok = terms is None or bwd_terms_match(terms)
    big = B * H * Sq * Sk > 2**30
    iters, warm = (5, 1) if big else (20, 3)

    def run():
        return flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                   q_offset=off)

    ms = time_ms(torch, run, iters, warm)
    dev_ms = graph_ms(torch, run, iters)
    # the D pre-pass, the dk/dv pass and the dq pass apart
    passes = kernel_device_ms(torch, run)
    plain_ms = time_ms(torch, lambda: flash_attention_bwd_plain(
        q, k, v, out, dout, lse, causal=causal, q_offset=off), iters, warm)
    # library yardstick: SDPA's backward alone (its forward outside the
    # timing) on the same values, in q's dtype for all three
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).to(q_dt).detach().requires_grad_(True)
                  for t in (q, k, v))
    mask = None
    if causal and off:
        mask = (torch.arange(Sk, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])
    o_lib = sdpa(qt, kt, vt, attn_mask=mask, is_causal=causal and not off,
                 enable_gqa=KV != H)
    do_lib = dout.transpose(1, 2)
    lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qt, kt, vt), do_lib, retain_graph=True), iters, warm)
    del o_lib
    # bound: the five products the function needs (S, dP, dV, dK, dQ:
    # 2.5 times the forward's two), bf16 q, k, v at the tensor-core peak,
    # f32 or mixed at the FP32 peak; bytes: q, k, v, out, dout, lse read
    # once, dq, dk, dv written once. bf16 rows also give the time of the
    # ten product-units the tc design issues (P and dS in two terms, S and
    # dP again in the dq pass) at the same peak
    flops = 4.0 * hd * flash_pairs(sh) * B * H
    nbytes = sum(t.numel() * t.element_size()
                 for t in (q, k, v, out, dout, lse, *got))
    issued_ms = None
    if q_dt == torch.bfloat16 and kv_dt == torch.bfloat16:
        b_ms, b_by = bound_ms(nbytes, 2.5 * flops, BF16_TC_FLOP_PER_S)
        issued_ms = bound_ms(nbytes, 2.5 * 2 * flops, BF16_TC_FLOP_PER_S)[0]
    else:
        b_ms, b_by = bound_ms(nbytes, 2.5 * flops)
    row = {"name": "flash_attention_bwd", "shape": shape, **sh,
           "dtype": q_name, "kv_dtype": kv_name, "impl": impl,
           "max_abs_err": err, "lse_max_abs_err": lse_err,
           "same_bits": same_bits,
           "out_bitwise_with_lse": out_bitwise, "launches_per_call": launched,
           "ms": ms, "device_ms": dev_ms, "passes_ms": passes,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_issued_ms": issued_ms,
           "flops": 2.5 * flops, "off_plain": terms}
    log(f"[kernels] flash_attention_bwd {shape} q {q_name} kv {kv_name} "
        f"({impl}) B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
        f"q_offset={off}: lse max abs err {lse_err:.2e}, max abs err "
        f"{err:.2e}, same bits {same_bits}, "
        f"out bitwise with lse {out_bitwise} | kernel {ms:.4f} ms (device "
        f"{_fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa backward "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), issued units "
        f"{_fmt_ms(issued_ms)}; passes "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in passes.items()))
    if not (ok and lse_ok and same_bits and out_bitwise and launched == 2
            and impl_ok and terms_ok):
        raise Failed(f"flash_attention_bwd {shape} {q_name}/{kv_name}: ok "
                     f"{ok} (err {err}), lse ok {lse_ok} (err {lse_err}), "
                     f"terms {terms}, "
                     f"same bits {same_bits}, out bitwise {out_bitwise}, "
                     f"launches {launched} by variant {by_impl} (the rule: "
                     f"{flash_bwd_rule(q_name, kv_name, hd)})")
    return row


def bf16_terms(torch, x, terms: int):
    """f32 x cut to the sum of its first ``terms`` bf16 terms (1: bf16(x);
    2: hi + bf16(x - hi), the tensor-core backward's split)."""
    cut, rest = torch.zeros_like(x), x
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        cut, rest = cut + t, rest - t
    return cut


def attention_p_terms(torch, q, k, v, *, causal: bool, q_offset: int,
                      terms: int):
    """f32 attention in one softmax pass with p = exp(s - max) cut to the
    sum of its first ``terms`` bf16 terms (1: bf16(p)); (batch, 8 heads)
    blocks at a time. A control for what the tensor-core flash kernel
    would give with fewer terms of p."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    dev = q.device
    live = None
    if causal:
        live = (torch.arange(Sk, device=dev)[None, :]
                <= q_offset + torch.arange(Sq, device=dev)[:, None])
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32, device=dev)
    for b in range(B):
        for h0 in range(0, H, 8):
            heads = torch.arange(h0, min(H, h0 + 8), device=dev)
            kv = heads // (H // KV)
            qb = q[b][:, heads].float().transpose(0, 1)
            kb = k[b][:, kv].float().transpose(0, 1)
            vb = v[b][:, kv].float().transpose(0, 1)
            s = qb @ kb.transpose(1, 2) * scale
            if live is not None:
                s = s.masked_fill(~live, -1e30)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            l = p.sum(dim=-1, keepdim=True)
            out[b][:, heads] = ((bf16_terms(torch, p, terms) @ vb)
                                / l.clamp(min=1e-30)).transpose(0, 1)
    return out


def flash_term_counts(torch, q, k, v, out, ref, **kw) -> dict:
    """How many bf16 outputs differ from the plain version's: the
    tensor-core kernel's (all three terms of p), the FP32 kernel's on the
    same values (q upcast: that variant, output rounded to bf16 here), and
    the p1-only and p1 + p2 controls."""
    from repro_torch.kernels.flash_attention import flash_attention

    def off(x):
        return int((x.to(torch.bfloat16) != ref).sum())

    counts = {"elements": ref.numel(), "tc": off(out),
              "fp32": off(flash_attention(q.float(), k, v, **kw))}
    for n in (1, 2):
        counts[f"p{n}_only" if n == 1 else "p1_p2"] = off(
            attention_p_terms(torch, q, k, v, terms=n, **kw))
    return counts


def terms_match(c: dict) -> bool:
    """The tensor-core kernel's count is the FP32 kernel's, within a
    factor of 1.5 (both sum in another order than the plain version), at
    most a tenth of the p1-only control's and half the p1 + p2 one's: each
    term of p shows in the outputs."""
    return (c["tc"] <= 1.5 * c["fp32"] + 16 and 10 * c["tc"] <= c["p1_only"]
            and 2 * c["tc"] <= c["p1_p2"])


def bwd_cut_terms(torch, q, k, v, out, dout, lse, terms: int) -> list:
    """The f32 backward (causal from row 0, H = KV) with P and dS each cut
    to ``terms`` bf16 terms where they enter dV = P^T dO, dK = scale dS^T Q
    and dQ = scale dS K: one term is the control for a tensor-core kernel
    that dropped the lo terms, two the arithmetic the tc kernel is
    designed to. Returns (dq, dk, dv) f32, a (batch, head) at a time."""
    from repro_torch.kernels.flash_attention import _scale

    B, S, H, hd = q.shape
    scale = _scale(hd)
    masked = torch.ones((S, S), dtype=torch.bool, device=q.device).triu(1)
    grads = [torch.empty(q.shape, device=q.device) for _ in range(3)]
    for b in range(B):
        for h in range(H):
            qh, kh, vh, oh, doh = (t[b, :, h].float()
                                   for t in (q, k, v, out, dout))
            p = torch.exp((qh @ kh.T) * scale - lse[b, h][:, None])
            p = p.masked_fill(masked, 0.0)
            ds = p * (doh @ vh.T - (doh * oh).sum(dim=-1, keepdim=True))
            p, ds = bf16_terms(torch, p, terms), bf16_terms(torch, ds, terms)
            for g, val in zip(grads, (scale * ds @ kh, scale * ds.T @ qh,
                                      p.T @ doh)):
                g[b, :, h] = val
    return grads


def bwd_term_counts(torch, q, k, v, out, dout, lse, got) -> dict:
    """How many bf16 dq, dk, dv differ from bf16 of the plain backward's,
    every one fed the kernel's lse: the tc kernel's (``got``), the fp32
    kernel's on the same values (q, out and dout upcast), and the one- and
    two-term controls of ``bwd_cut_terms``."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    ref = [w.to(torch.bfloat16) for w in flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), out.float(), dout.float(), lse,
        causal=True)]

    def off(grads):
        return sum(int((g.to(torch.bfloat16) != r).sum())
                   for g, r in zip(grads, ref))

    counts = {"elements": sum(r.numel() for r in ref), "tc": off(got),
              "fp32": off(flash_attention_bwd(
                  q.float(), k, v, out.float(), dout.float(), lse,
                  causal=True))}
    for n in (1, 2):
        counts[f"{n}_term"] = off(bwd_cut_terms(torch, q, k, v, out, dout,
                                                lse, n))
    return counts


def bwd_terms_match(c: dict) -> bool:
    """The tc kernel moves about as few outputs off bf16(plain) as the
    two-term control (within 1.5x: its tiles sum in another order) and at
    most a tenth of what the one-term control moves: the lo terms of P
    and dS show in the outputs."""
    return c["tc"] <= 1.5 * c["2_term"] + 16 and 10 * c["tc"] <= c["1_term"]


def check_flash(torch, dev, shape: str, dtype) -> dict:
    """flash_attention against its plain version (the reference's two-level
    scan), timed beside SDPA on the same q/k/v."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_plain)

    sh = FLASH_SHAPES[shape]
    B, Sq, Sk, H, KV, hd = (sh[n] for n in ("B", "Sq", "Sk", "H", "KV", "hd"))
    causal, off = sh["causal"], sh["q_offset"]
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H + hd)
    q = torch.randn((B, Sq, H, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((B, Sk, KV, hd), generator=g, device=dev).to(dtype)
    kw = dict(causal=causal, q_offset=off)
    before = dict(flash_attention.launches_by_impl)
    out = flash_attention(q, k, v, **kw)
    (impl,) = impl_delta(before, flash_attention.launches_by_impl)
    ref = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    # f32: online softmax over 64-column tiles and FMA dot products sum in
    # another order; bf16 output: both round f32 results ~1e-6 apart, so
    # they differ by at most one bf16 ulp, 2^-7 of the value
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0**-7, 1e-5)
    ok = bool(torch.allclose(out.float(), ref.float(), rtol=rtol, atol=atol))
    terms = None
    if impl == "tc":
        terms = flash_term_counts(torch, q, k, v, out, ref, **kw)
        log(f"[kernels] flash_attention {shape}: outputs off bf16(plain) "
            f"{terms}")
        ok = ok and terms_match(terms)
    big = B * H * Sq * Sk > 2**30
    iters, warm = (5, 1) if big else (20, 3)
    ms = time_ms(torch, lambda: flash_attention(q, k, v, **kw), iters, warm)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, **kw),
                       iters, warm)
    # library yardstick: SDPA on the same q/k/v in (B, H, S, hd) order; a
    # q_offset needs an explicit mask (is_causal aligns rows at 0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if causal and off:
        mask = (torch.arange(Sk, device=dev)[None, :]
                <= off + torch.arange(Sq, device=dev)[:, None])
    lib_ms = time_ms(torch, lambda: sdpa(
        qt, kt, vt, attn_mask=mask, is_causal=causal and not off,
        enable_gqa=KV != H), iters, warm)
    # the work these inputs need: every unmasked (row, column) pair costs
    # 2 * hd FLOPs of q.k and 2 * hd of p.v per head; each input read once,
    # the output written once. bf16 q, k, v bound at the bf16 tensor-core
    # peak, f32 at the FP32 peak. bf16 rows also give the time of what the
    # tc design issues: p.v with the f32 p split into three bf16 terms
    # (flops/2 + 3 flops/2) at the same peak
    if causal:
        pairs = sum(min(Sk, off + i + 1) for i in range(Sq))
    else:
        pairs = Sq * Sk
    flops = 4.0 * hd * pairs * B * H
    nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
    issued_ms = None
    if dtype == torch.bfloat16:
        b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
        issued_ms = bound_ms(nbytes, 2 * flops, BF16_TC_FLOP_PER_S)[0]
    else:
        b_ms, b_by = bound_ms(nbytes, flops)
    row = {"name": "flash_attention", "shape": shape, **sh,
           "dtype": str(dtype).replace("torch.", ""), "impl": impl,
           "max_abs_err": err, "rtol": rtol, "atol": atol, "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
           "bound_by": b_by, "bound_issued_ms": issued_ms, "flops": flops,
           "off_plain": terms}
    log(f"[kernels] flash_attention {shape} {row['dtype']} ({impl}) B={B} "
        f"Sq={Sq} Sk={Sk} H={H} KV={KV} hd={hd} causal={causal} "
        f"q_offset={off}: max abs err {err:.2e} (rtol {rtol:.1e}, atol "
        f"{atol:.0e}) | kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), issued units "
        f"{_fmt_ms(issued_ms)}")
    if not ok:
        raise Failed(f"flash_attention {shape} {dtype}: error {err} outside "
                     f"rtol {rtol}, atol {atol}")
    return row


def check_flash_lse(torch, dev, shape: str) -> dict:
    """The forward kernel with its log-sum-exp output, as a train step
    launches it under autograd, in bf16: out bitwise the launch without
    the lse and within one bf16 ulp of flash_attention_plain's, the lse at
    rtol 1e-5 plus 1e-5 * max|lse| of the plain forward's; timed beside
    the plain forward with its lse and SDPA's forward."""
    from repro_torch.kernels.flash_attention import (
        _launch_forward, flash_attention_plain)

    sh = FLASH_LSE_SHAPES[shape]
    B, Sq, Sk, H, KV, hd = (sh[n] for n in ("B", "Sq", "Sk", "H", "KV", "hd"))
    causal, off = sh["causal"], sh["q_offset"]
    g = torch.Generator(device=dev).manual_seed(Sq + Sk + H + hd)
    q, k, v = (torch.randn(shp, generator=g, device=dev).to(torch.bfloat16)
               for shp in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd)))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    out = _launch_forward(q, k, v, causal, off, lse)
    out_bitwise = bool(torch.equal(out, _launch_forward(q, k, v, causal,
                                                        off)))
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=off, with_lse=True)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    out_ok = bool(torch.allclose(out.float(), ref.float(), rtol=2.0**-7,
                                 atol=1e-5))
    lse_d = (lse - ref_lse).abs()
    lse_err = float(lse_d.max())
    lse_ok = bool((lse_d <= 1e-5 * ref_lse.abs()
                   + 1e-5 * float(ref_lse.abs().max())).all())
    del ref, ref_lse
    ms = time_ms(torch, lambda: _launch_forward(q, k, v, causal, off, lse),
                 5, 1)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(
        q, k, v, causal=causal, q_offset=off, with_lse=True), 5, 1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=causal,
                                         enable_gqa=KV != H), 5, 1)
    # bound as check_flash's bf16 rows, the lse written too
    flops = 4.0 * hd * flash_pairs(sh) * B * H
    nbytes = ((q.numel() + k.numel() + v.numel() + out.numel())
              * q.element_size() + lse.numel() * lse.element_size())
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TC_FLOP_PER_S)
    issued_ms = bound_ms(nbytes, 2 * flops, BF16_TC_FLOP_PER_S)[0]
    row = {"name": "flash_attention_lse", "shape": shape, **sh,
           "dtype": "bfloat16", "impl": "tc", "max_abs_err": err,
           "lse_max_abs_err": lse_err, "out_bitwise_with_lse": out_bitwise,
           "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_issued_ms": issued_ms,
           "flops": flops}
    log(f"[kernels] flash_attention with lse {shape} bfloat16 B={B} Sq={Sq} "
        f"Sk={Sk} H={H} KV={KV} hd={hd}: max abs err {err:.2e}, lse max "
        f"abs err {lse_err:.2e}, out bitwise without lse {out_bitwise} | "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), issued units "
        f"{_fmt_ms(issued_ms)}")
    if not (out_ok and lse_ok and out_bitwise):
        raise Failed(f"flash_attention with lse {shape}: out ok {out_ok} "
                     f"(err {err}), lse ok {lse_ok} (err {lse_err}), out "
                     f"bitwise {out_bitwise}")
    return row


def phase_kernels(torch, dev) -> list[dict]:
    t0 = time.perf_counter()
    rows = []
    warm_card(torch, dev)
    # the quantizer's EM and span sweep, then the serve engine's vq2 KV
    # codebook fit (32 kv heads x 64 tokens x 64 pairs of head dims)
    for label, B, n in (("em", 1024, 512), ("em", 2752, 512),
                        ("sweep", 1024, 4), ("sweep", 2752, 4),
                        ("kv vq2 fit", 32, 4096)):
        rows.append(check_assign(torch, dev, B, n, label))
    # the loops around it, one launch each: the sweep of one column group of
    # wq and of w1, EM over a group's bands of wq and of w1, and the KV fit
    for layer in ("wq", "w1"):
        rows.append(check_sweep(torch, dev, layer))
    for label, B, n in (("em", 1024, 512), ("em", 2752, 512),
                        ("kv vq2 fit", 32, 4096)):
        rows.append(check_em(torch, dev, label, B, n))
    # the audio phase's: one group of whisper's 3,072-row w_in and of its
    # 768-row w_out (the other 768-row projections' groups have its
    # layout), and EM over such a group's bands (768 and 192 of 512 points)
    for layer in ("whisper w_in", "whisper w_out"):
        rows.append(check_sweep(torch, dev, layer))
        d, k, cg, rg = sweep_layout("2.25bpv_2d", *matmul_nk(layer))
        rows.append(check_em(torch, dev, f"em {layer}",
                             matmul_nk(layer)[0] // rg, rg * cg // d))
    # the budget phase's settings: the babai metric at 2.25bpv_2d, then a
    # d = 1 and a k = 256 setting, each at wq's group
    for layer in ("wq", "w1"):
        rows.append(check_sweep(torch, dev, layer, babai=True))
    for setting in BUDGET_KERNEL_SETTINGS:
        rows.append(check_sweep(torch, dev, "wq", setting))
        d, k, cg, rg = sweep_layout(setting, 4096)
        rows.append(check_em(torch, dev, f"em {setting}", 4096 // rg,
                             rg * cg // d, d, k))
    # decode M = 1 (timed only), the serve engine's decode ticks (M = 4)
    # and prefill chunks (M = 64), the main phase's evaluation (M = 512),
    # the long phase's (8 x 4096 rows); then one row per regime with
    # arbitrary f32 codebooks
    for layer in MATMUL_SHAPES:
        for M in (1, SERVE_MAX_BATCH, SERVE_PREFILL_CHUNK, 512):
            for sb in (0, 64):
                rows.append(check_matmul(torch, dev, layer, M, sb))
        rows.append(check_matmul(torch, dev, layer, LONG_HELDOUT * LONG_SEQ,
                                 0))
    for M in (SERVE_MAX_BATCH, 512):
        rows.append(check_matmul(torch, dev, "wq", M, 0, "f32"))
    # the vlm, ssm, hybrid and audio phases' widths at a decode tick and a
    # prefill chunk; whisper's also at its encoder evaluation's rows
    for layer in FAMILY_MATMUL_SHAPES:
        for M in (SERVE_MAX_BATCH, SERVE_PREFILL_CHUNK):
            rows.append(check_matmul(torch, dev, layer, M, 0))
    for layer in ("whisper w_in", "whisper w_out"):
        rows.append(check_matmul(torch, dev, layer, AUDIO_ENC_ROWS, 0))
    # the moe phase's expert stacks, one launch a stack
    for weight in MOE_MATMUL_SHAPES:
        for M in MOE_SLAB_ROWS:
            rows.append(check_expert_matmul(torch, dev, weight, M))
    invariance = {"vq_dequant_matmul": check_matmul_rows(torch, dev),
                  "vq_dequant_matmul xlstm up": check_matmul_rows(
                      torch, dev, "xlstm up"),
                  "vq_dequant_matmul zamba in_proj": check_matmul_rows(
                      torch, dev, "zamba in_proj"),
                  "vq_dequant_matmul whisper w_in": check_matmul_rows(
                      torch, dev, "whisper w_in",
                      ((4, 1), (64, 17), (AUDIO_ENC_ROWS, 17)))}
    for shape in ("long", "gqa long", "vlm serve", "zamba serve",
                  "whisper serve"):
        invariance[f"paged_attention {shape}"] = check_paged_slots(
            torch, dev, shape)
    rows += paged_rows(torch, dev)
    for shape in FLASH_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            rows.append(check_flash(torch, dev, shape, dt))
    for shape in FLASH_LSE_SHAPES:
        rows.append(check_flash_lse(torch, dev, shape))
    for shape, q_name, kv_name in FLASH_BWD_ROWS:
        rows.append(check_flash_bwd(torch, dev, shape, q_name, kv_name))
    log(f"[kernels] {len(rows)} checks passed in "
        f"{time.perf_counter() - t0:.1f}s")
    return rows, invariance


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts and lists, in order."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_small(torch, dev) -> dict:
    """The whole path on a small input, on the card and on the CPU (where
    every kernel runs its plain version): the SKILL smoke config in f32,
    same weights and tokens. f32 sums in another order can flip a near-tie
    in the sweep, which feeds a different error forward, so the packed
    codes must agree on >= 90% of spans and per-target errors within 10%;
    the packed model's logits must be finite."""
    from repro_torch.configs import SMOKE
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.models import model_zoo

    t0 = time.perf_counter()
    cfg = SMOKE["llama2-7b"].scaled(dtype="float32", n_layers=2, d_model=64,
                                    vocab_size=256, max_seq_len=64)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    calib = torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"]).with_quantize_overrides(
            em_iters=8, codebook_update_iters=4)
    out = {}
    for where in ("cpu", dev):
        q, rep = quantize_model(model, _to(params, where), calib.to(where),
                                recipe=recipe, pack=True)
        logits = model.forward(vql_mod.prepare_fused_tree(q),
                               {"tokens": tokens.to(where)})[0]
        codes = torch.cat([vql_mod.unpack_indices(leaf).flatten().cpu()
                           for lp in q["layers"]
                           for sub in (lp["attn"], lp["ffn"])
                           for leaf in sub.values()])
        out[str(where)] = ({k: e["error"] for k, e in rep.per_target.items()},
                           codes, logits)
    (err_c, codes_c, _), (err_g, codes_g, lg_g) = out["cpu"], out[str(dev)]
    worst = max(abs(err_g[k] - err_c[k]) / err_c[k] for k in err_c)
    agree = float((codes_g == codes_c).float().mean())
    finite = bool(torch.isfinite(lg_g).all())
    log(f"[small] smoke config on {dev} vs cpu: codes agree on "
        f"{agree:.4f} of spans (tol 0.9), worst per-target error ratio "
        f"{worst:.2e} (tol 0.1), logits finite {finite} | "
        f"{time.perf_counter() - t0:.1f}s")
    if not (agree >= 0.9 and worst <= 0.1 and finite):
        raise Failed("small-input check of the CUDA path against the CPU")
    return {"code_agreement": agree, "worst_error_ratio": worst}


def main_recipe():
    """The main phase's quantize: 2.25bpv_2d, 25 EM and 10 codebook-update
    iterations."""
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.recipe import QuantRecipe

    return QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(em_iters=25, codebook_update_iters=10)


def main_inputs(torch, dev):
    """The main phase's model (full-width Llama-2-7B, 2 layers, seed 0),
    calibration 16 x 64 and heldout 8 x 64 tokens."""
    from repro_torch.configs import ARCHS
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.models import model_zoo

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=16, seq_len=64,
                               device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=8, seq_len=64,
                                 seed=777, device=dev)
    return model, params, calib, heldout


def phase_main(torch, dev) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.train.loss import perplexity

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    log(f"[main] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, layers {cfg.n_layers}, "
        f"dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model, params, calib, heldout = main_inputs(torch, dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    recipe = main_recipe()

    n_groups = predict_groups(cfg)
    log(f"[main] predicted quantize launches: vq_group_sweep {n_groups}, "
        f"vq_em {n_groups} (one each a column group), vq_assign 0")
    for fn in VQ_ENTRY_POINTS:
        getattr(vqa, fn).launches = 0
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[main]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused = vql_mod.prepare_fused_tree(qparams)
    ppl_vq = perplexity(model, fused, heldout)
    t["ppl_vq"] = time.perf_counter() - t0
    launches = {fn: getattr(vqa, fn).launches for fn in VQ_ENTRY_POINTS}
    launches["vq_dequant_matmul"] = vq_dequant_matmul.launches
    impls = dict(vq_dequant_matmul.launches_by_impl)
    # one evaluation forward of 8 x 64 rows: 7 matmuls a layer, all on the
    # int8 tensor cores (bf16 x, int8 leaves)
    want_impl = {"tc_int8": 7 * cfg.n_layers}
    packed = sum(leaf.payload_bytes() for lp in fused["layers"]
                 for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    dense = sum(w.numel() * w.element_size() for lp in params["layers"]
                for sub in (lp["attn"], lp["ffn"]) for w in sub.values())

    log(f"[main] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.4f} bpv")
    for name, e in rep.per_target.items():
        log(f"[main]   {name}: error {e['error']:.5f} bpv {e['bpv']:.4f}")
    log("[main] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[main] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    now = dict(rep.stage_seconds, quantize=t["quantize"],
               recon_error=rep.total_error())
    log("[main] beside the host-loop readings: " + "  ".join(
        f"{k} {now.get(k, float('nan')):.2f} (was {v})"
        for k, v in HOST_LOOP_MAIN.items()))
    log(f"[main] launches in the main path: {launches}; vq_dequant_matmul "
        f"by variant {impls} (predicted {want_impl})")
    log(f"[main] quantized weights streamed per forward: {packed / 2**20:.1f}"
        f" MiB packed (words + f32 codebooks) vs {dense / 2**20:.1f} MiB "
        f"dense {cfg.dtype}")

    with torch.no_grad():
        lf = model.forward(fused, {"tokens": heldout})[0]
        lg = model.forward(qparams, {"tokens": heldout})[0]
    dl = (lf - lg).float()
    max_d, rms_d = float(dl.abs().max()), float(dl.pow(2).mean().sqrt())
    # tolerance: the gather form rounds the dequantized W and every matmul
    # output to bf16 (relative 2^-9); over 2 layers that moves logits of
    # unit scale by ~1e-2 RMS. A wrong code, band or scale moves them O(1).
    max_tol, rms_tol = 0.5, 0.05
    log(f"[main] fused vs gather logits {tuple(lf.shape)}: max |diff| "
        f"{max_d:.4e} (tol {max_tol}), RMS {rms_d:.4e} (tol {rms_tol})")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] max_memory_allocated {peak / 2**30:.2f} GiB")

    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits shape": tuple(lf.shape) == (8, 64, cfg.padded_vocab),
        "logits finite": bool(torch.isfinite(lf).all()),
        "fused vs gather": max_d <= max_tol and rms_d <= rms_tol,
        "bpv": abs(rep.achieved_bpv - 2.25) < 1e-9,
        "vq_dequant_matmul launched": launches["vq_dequant_matmul"] > 0,
        "vq_dequant_matmul by variant as planned": impls == want_impl,
        "column groups as planned": n_groups == sum(
            leaf.n_cg for lp in qparams["layers"]
            for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values()),
        **quantize_launch_checks(launches, n_groups),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"main path checks failed: {bad}")
    res = {"launches": launches, "vq_impl_counts": impls,
           "predicted_vq_impl_counts": want_impl,
           "predicted_column_groups": n_groups,
           "host_loop_readings": HOST_LOOP_MAIN,
           "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
           "recon_error": rep.total_error(),
           "achieved_bpv": rep.achieved_bpv,
           "per_target": rep.per_target, "stage_seconds": rep.stage_seconds,
           "seconds": t, "logit_max_diff": max_d, "logit_rms_diff": rms_d,
           "packed_bytes": packed, "dense_bytes": dense,
           "max_memory_allocated": peak}
    return res, model, qparams, (calib, heldout)


def budget_groups(params, per_target) -> int:
    """Column groups the allocated settings give: one vq_group_sweep and
    one vq_em launch each (c / plan_groups(r, c, cfg)[0] a target)."""
    from repro_torch.core.bpv import VQConfig
    from repro_torch.core.gptvq import plan_groups

    n = 0
    for name, e in per_target.items():
        _, i, sub, leaf = name.split(".")
        c, r = params["layers"][int(i)][sub][leaf].shape  # (in, out)
        cfg = VQConfig(d=e["d"], bits_per_dim=e["bits_per_dim"],
                       group_size=e["group_size"])
        n += c // plan_groups(r, c, cfg)[0]
    return n


def count_impls(pairs, x_dtype) -> dict:
    """vq_dequant_matmul launches by variant for (leaf, rows) pairs: one a
    packed leaf, at the variant its layout selects at those rows."""
    from repro_torch.core.vq_linear import FusedVQLinear
    from repro_torch.kernels.vq_dequant_matmul import select_impl

    want: dict = {}
    for leaf, rows in pairs:
        if isinstance(leaf, FusedVQLinear):
            p = leaf.prepared
            d, k_c, _, rpb, gc, sb = p.layout
            impl = select_impl(rows, x_dtype, d=d, k_c=k_c,
                               rows_per_band=rpb, n_bands=p.n_bands,
                               group_cols=gc, scale_block=sb,
                               has_int8=p.int8_ok)
            want[impl] = want.get(impl, 0) + 1
    return want


def predict_matmul_impls(fused, M: int, x_dtype, m_experts=None) -> dict:
    """vq_dequant_matmul launches by variant for one forward of M rows:
    one a packed leaf, each at the variant its layout selects (an expert
    stack: one launch at ``m_experts`` rows an expert)."""
    from repro_torch.core.vq_linear import FusedVQLinear

    # the layers, or the hybrid's trunk (its shared block runs densified)
    trunk = fused["layers"] if "layers" in fused else fused["mamba"]
    return count_impls(
        [(leaf, m_experts if isinstance(leaf, FusedVQLinear)
          and leaf.prepared.n_experts else M)
         for lp in trunk for leaf in tree_leaves(lp)], x_dtype)


def phase_budget(torch, dev, model, calib, heldout) -> dict:
    """The budgeted path at full width: quantize_model with budget_bpv on
    fresh weights (seed 0) and main's tokens, the closed-form scorer, then
    the packed model through the fused kernel; then the method table on
    block 0's full-width Hessians. See the module docstring."""
    from repro_torch.core import adapters, hessian as hes
    from repro_torch.core import pipeline as pl
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.gptvq import gptvq_quantize_matrix, plan_groups
    from repro_torch.core.recipe import IntQuant, QuantRecipe, Quantize
    from repro_torch.core.solvers import cd_refine
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = model.cfg
    params = model.init_params(seed=0, device=dev)
    overrides = dict(em_iters=25, codebook_update_iters=10)
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(**overrides)

    # the pre-pass may build no (c, c) Hessian: count init_hessian calls
    # made inside it (diagonal states are counted too, to show it ran)
    inits = {"full": 0, "diag": 0}
    real_prepass = pl._budget_prepass
    real_init, real_diag = hes.init_hessian, hes.init_diag_hessian

    def guarded_prepass(*a, **kw):
        def full(*ia, **ikw):
            inits["full"] += 1
            return real_init(*ia, **ikw)

        def diag(*ia, **ikw):
            inits["diag"] += 1
            return real_diag(*ia, **ikw)

        hes.init_hessian, hes.init_diag_hessian = full, diag
        try:
            return real_prepass(*a, **kw)
        finally:
            hes.init_hessian, hes.init_diag_hessian = real_init, real_diag

    budget, tries = BUDGET_BPV, []
    pl._budget_prepass = guarded_prepass
    try:
        while True:
            for fn in VQ_ENTRY_POINTS:
                getattr(vqa, fn).launches = 0
            vqa.vq_group_sweep.launches_by_impl = {}
            t0 = time.perf_counter()
            qparams, rep = pl.quantize_model(
                model, params, calib, recipe=recipe, budget_bpv=budget,
                budget_scorer="closed_form", pack=True)
            torch.cuda.synchronize()
            t_quant = time.perf_counter() - t0
            launches = {fn: getattr(vqa, fn).launches
                        for fn in VQ_ENTRY_POINTS}
            sweep_impls = dict(vqa.vq_group_sweep.launches_by_impl)
            alloc = {k: e["rule"].split("]")[0][len("budget["):]
                     for k, e in rep.per_target.items()}
            tries.append((budget, sorted(set(alloc.values()))))
            if len(set(alloc.values())) >= 2 or budget >= 4.125:
                break
            log(f"[budget] {budget} bpv allocates one setting "
                f"{set(alloc.values())}; raising by {BUDGET_STEP}")
            budget += BUDGET_STEP
    finally:
        pl._budget_prepass = real_prepass
    n_groups = budget_groups(params, rep.per_target)
    packed_groups = sum(leaf.n_cg for lp in qparams["layers"]
                        for sub in (lp["attn"], lp["ffn"])
                        for leaf in sub.values())
    log(f"[budget] budget {budget} bpv (tried {tries}): achieved "
        f"{rep.achieved_bpv:.6f} bpv, quantize {t_quant:.2f}s, recon err "
        f"{rep.total_error():.4f}")
    for name, setting in alloc.items():
        e = rep.per_target[name]
        log(f"[budget]   {name}: {setting} (bpv {e['bpv']:.4f}, error "
            f"{e['error']:.5f})")
    log("[budget] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log(f"[budget] pre-pass Hessian states: {inits['diag']} diagonal, "
        f"{inits['full']} (c, c)")

    fused = vql_mod.prepare_fused_tree(qparams)
    M = heldout.numel()
    want_impl = predict_matmul_impls(fused, M, getattr(torch, cfg.dtype))
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    t0 = time.perf_counter()
    ppl_vq = perplexity(model, fused, heldout)
    t_ppl = time.perf_counter() - t0
    mm_launches = vq_dequant_matmul.launches
    impls = dict(vq_dequant_matmul.launches_by_impl)
    with torch.no_grad():
        lf = model.forward(fused, {"tokens": heldout})[0]
        lg = model.forward(qparams, {"tokens": heldout})[0]
    dl = (lf - lg).float()
    max_d, rms_d = float(dl.abs().max()), float(dl.pow(2).mean().sqrt())
    log(f"[budget] launches: {launches}, vq_group_sweep by metric "
        f"{sweep_impls} (predicted {n_groups} groups; packed leaves hold "
        f"{packed_groups}); vq ppl {ppl_vq:.3f} in {t_ppl:.2f}s, "
        f"vq_dequant_matmul {mm_launches} launches by variant {impls} "
        f"(predicted {want_impl}); fused vs gather logits max |diff| "
        f"{max_d:.4e} (tol 0.5), RMS {rms_d:.4e} (tol 0.05)")
    checks = {
        "two or more settings": len(set(alloc.values())) >= 2,
        "achieved bpv <= budget": rep.achieved_bpv <= budget + 1e-9,
        "vq_group_sweep launches == groups": launches["vq_group_sweep"]
        == n_groups == packed_groups,
        "vq_em launches == groups": launches["vq_em"] == n_groups,
        "vq_assign launches == 0": launches["vq_assign"] == 0,
        "sweeps all diagonal (gptq solver)": sweep_impls == {
            "diag": n_groups},
        "no (c, c) Hessian in the pre-pass": inits["full"] == 0
        and inits["diag"] > 0,
        "vq_dequant_matmul a packed leaf": mm_launches == 7 * cfg.n_layers,
        "vq_dequant_matmul by variant as planned": impls == want_impl,
        "ppl finite": math.isfinite(ppl_vq),
        "fused vs gather": max_d <= 0.5 and rms_d <= 0.05,
        "budget stages": {"budget_prepass", "budget_allocate"}
        <= set(rep.stage_seconds),
    }
    del qparams, fused, lf, lg

    # ---- the method table on block 0's full-width Hessians ---------------
    t_tab = time.perf_counter()
    adapter = adapters.get_adapter(model, params)
    blk = adapter.blocks()[0]
    taps: dict = {}
    for ci, c in enumerate(calib[i:i + 8] for i in range(0, len(calib), 8)):
        taps = blk.capture(adapter.calib_state(c, ci), taps,
                           frozenset({"attn", "mlp"}))
    stage_s: dict = {}

    def stage(name):
        import contextlib

        @contextlib.contextmanager
        def timed():
            torch.cuda.synchronize()
            ts = time.perf_counter()
            yield
            torch.cuda.synchronize()
            stage_s[name] = stage_s.get(name, 0.0) + time.perf_counter() - ts
        return timed()

    s2125 = dataclasses.replace(PAPER_SETTINGS["2.125bpv_2d"], **overrides)
    s225 = dataclasses.replace(PAPER_SETTINGS["2.25bpv_2d"], **overrides)
    methods = {
        "gptvq 2.125bpv_2d": Quantize(s2125),
        "kmeans 2.125bpv_2d": Quantize(s2125, method="kmeans"),
        "kmeans_data 2.125bpv_2d": Quantize(s2125, method="kmeans_data"),
        "rtn int2 g128": IntQuant(2, 128, method="rtn"),
        "gptq int2 g128": IntQuant(2, 128),
        "gptvq 2.25bpv_2d": Quantize(s225),
        "babai 2.25bpv_2d": Quantize(s225, solver="babai"),
        "cd 2.25bpv_2d": Quantize(s225, solver="cd"),
    }
    table, babai_launches, babai_want = {}, 0, 0
    gen = torch.Generator(device=dev).manual_seed(0)
    for layer, (sub, leaf, tap) in METHOD_TABLE_LEAVES.items():
        W_io = params["layers"][0][sub][leaf]
        H = hes.finalize(taps[tap])
        row = {}
        for label, action in methods.items():
            stage_s.clear()
            before = vqa.vq_group_sweep.launches_by_impl.get("babai", 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            q, _ = pl._apply_action(W_io, H, action, gen, stage)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            if action is methods["babai 2.25bpv_2d"]:
                babai_launches += vqa.vq_group_sweep.launches_by_impl.get(
                    "babai", 0) - before
                c, r = W_io.shape
                babai_want += c // plan_groups(r, c, s225)[0]
            row[label] = {"error": pl._recon_error(W_io, q, H),
                          "seconds": sec, "stages": dict(stage_s)}
        # cd_refine's property on one sweep: never above the sweep it
        # refines
        W = W_io.T.float()
        U = hes.inv_hessian_cholesky(H, s225.percdamp)
        res = gptvq_quantize_matrix(W, U, s225)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Qcd, _, n_changed = cd_refine(
            W, res.arrays.Q, res.arrays.indices, res.arrays.codebooks,
            res.expanded_scales(), H, cfg=s225, group_cols=res.group_cols,
            rows_per_band=res.rows_per_band, passes=s225.cd_passes)
        torch.cuda.synchronize()
        t_cd = time.perf_counter() - t0
        e_sweep = float(torch.sum((W - res.arrays.Q)
                                  * ((W - res.arrays.Q) @ H)))
        e_cd = float(torch.sum((W - Qcd) * ((W - Qcd) @ H)))
        row["cd_refine on the gptq sweep"] = {
            "error_sweep": e_sweep, "error_cd": e_cd, "seconds": t_cd,
            "switches": n_changed}
        checks[f"cd <= gptq sweep ({layer})"] = e_cd <= e_sweep
        table[layer] = row
        e = {k: v["error"] for k, v in row.items() if "error" in v}
        log(f"[budget] method table {layer} {tuple(W_io.shape[::-1])}: "
            + "; ".join(f"{k} {v['error']:.5g} ({v['seconds']:.2f}s)"
                        for k, v in row.items() if "error" in v))
        log(f"[budget]   {layer}: cd_refine on the gptq sweep "
            f"{e_sweep:.6g} -> {e_cd:.6g} ({n_changed} switches, "
            f"{t_cd:.2f}s); gptq_quantize {row['gptq int2 g128']['stages']}"
            f"; Table-1 order kmeans >= kmeans_data >= gptvq: "
            f"{e['kmeans 2.125bpv_2d'] >= e['kmeans_data 2.125bpv_2d'] >= e['gptvq 2.125bpv_2d']}"
            " (printed, not held: random weights)")
    checks["babai sweeps launched in-kernel"] = babai_launches == babai_want
    log(f"[budget] method table {time.perf_counter() - t_tab:.1f}s; babai "
        f"launches {babai_launches} (predicted {babai_want})")
    bad = [k for k, ok in checks.items() if not ok]
    log(f"[budget] phase {time.perf_counter() - t_phase:.1f}s")
    if bad:
        raise Failed(f"budget phase checks failed: {bad}")
    return {"budget_bpv": budget, "tries": tries, "allocation": alloc,
            "achieved_bpv": rep.achieved_bpv,
            "recon_error": rep.total_error(),
            "per_target": rep.per_target, "stage_seconds": rep.stage_seconds,
            "quantize_seconds": t_quant, "launches": launches,
            "sweep_by_metric": sweep_impls, "predicted_groups": n_groups,
            "prepass_hessian_states": inits, "ppl_vq": ppl_vq,
            "vq_impl_counts": impls, "predicted_vq_impl_counts": want_impl,
            "logit_max_diff": max_d, "logit_rms_diff": rms_d,
            "method_table": table, "babai_launches": babai_launches,
            "checks": checks, "seconds": time.perf_counter() - t_phase}


# the serve phase: 8 greedy requests of 40-72 prompt tokens, 64 new tokens
SERVE_REQUESTS, SERVE_NEW, SERVE_MAX_BATCH = 8, 64, 4
SERVE_PREFILL_CHUNK = 64  # the engine's default prefill chunk
SERVE_MAX_LEN, SERVE_PAGE = 256, 16
# serve/engine.calibrate_vq_codebooks's em_iters default
KV_FIT_EM_ITERS = 25


# the long serve run, at Llama-2-7B's 4096-token context: 4 greedy
# requests of 3,000-4,000 prompt tokens, 32 new tokens each
LONG_SERVE_REQUESTS, LONG_SERVE_NEW, LONG_SERVE_MAX_LEN = 4, 32, 4096

# the moe phase: Qwen3-MoE-30B-A3B at full width, 2 of its 48 layers;
# calibration and heldout (sequences, tokens)
MOE_ARCH, MOE_LAYERS = "qwen3-moe-30b-a3b", 2
MOE_CALIB, MOE_HELDOUT = (16, 256), (8, 256)
# its expert stacks at 2.25bpv_2d (the Llama projections' layout: d = 2,
# k = 16, 256-column groups of 4 rows): one expert's (N, K) of w_in (w_gate
# alike) and w_out; rows an expert in a decode tick (max_batch slots x a
# capacity of 8) and in a 64-token prefill chunk (a capacity of 8)
MOE_EXPERTS = 128
MOE_MATMUL_SHAPES = {"w_in": (768, 2048), "w_out": (2048, 768)}
MOE_SLAB_ROWS = (SERVE_MAX_BATCH * 8, 8)
# free-routing fused vs gather: the share of (token, layer) routings whose
# expert set may differ. A bf16 rounding difference moves the router's
# logits by ~1e-3 where the 8th and 9th of 128 are ~0.06 apart, and a
# flip in layer 0 moves that token's input to layer 1 O(1). The first
# reading on the H100 was 10.08% (413 of 4096); a router reading wrong
# logits or ids would share ~8 of 128 experts a token with the gather
# form's choice, flipping nearly every routing (PERF.md, section 6)
MOE_FLIP_TOL = 0.20


def serve_prompts(vocab: int, n: int, lo: int = 40, hi: int = 72) -> list:
    rng = np.random.RandomState(0)
    sizes = rng.randint(lo, hi + 1, size=n)
    return [rng.randint(0, vocab, size=int(s)) for s in sizes]


def prefill_chunk_ms(prompts, pad: bool = True) -> list:
    """The rows (M) of each prefill forward the engine plans for these
    prompts (scheduler.prefill_chunk_len: full chunks, then the rest
    padded to its power-of-two bucket, or, for a recurrent family
    (``pad=False``), fed as its exact power-of-two pieces)."""
    out = []
    for p in prompts:
        rest = len(p)
        while rest > 0:
            if rest >= SERVE_PREFILL_CHUNK:
                m = real = SERVE_PREFILL_CHUNK
            elif pad:
                m, real = 1 << (rest - 1).bit_length(), rest
            else:
                m = real = 1 << (rest.bit_length() - 1)
            out.append(m)
            rest -= real
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else float("nan")


def serve_run(torch, dev, model, qparams, kv_bits, n_req, n_new,
              max_len: int = SERVE_MAX_LEN, prompt_len=(40, 72)) -> dict:
    """One engine over ``n_req`` requests with prompts of ``prompt_len``
    tokens; kernel launch counts are zeroed just before ``run`` and read
    just after."""
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.serve.engine import Engine, Request

    # engine load: a vq2 engine fits its KV codebooks here (vq_em)
    for fn in VQ_ENTRY_POINTS:
        getattr(vqa, fn).launches = 0
    t0 = time.perf_counter()
    eng = Engine(model, qparams, max_batch=SERVE_MAX_BATCH,
                 max_len=max_len, page_size=SERVE_PAGE,
                 paged_attn_impl="fused", vq_matmul_impl="fused",
                 kv_cache_bits=kv_bits, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    load_launches = {fn: getattr(vqa, fn).launches for fn in VQ_ENTRY_POINTS}
    reqs = [Request(rid=i, prompt=p, max_new_tokens=n_new)
            for i, p in enumerate(serve_prompts(model.cfg.vocab_size, n_req,
                                                *prompt_len))]
    paged_attention.launches = 0
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_m = {}
    vq_dequant_matmul.launches_by_impl = {}
    vq_dequant_matmul.launches_by_experts = {}
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention": paged_attention.launches,
                "vq_dequant_matmul": vq_dequant_matmul.launches}
    ms_seen = dict(vq_dequant_matmul.launches_by_m)
    impls_seen = dict(vq_dequant_matmul.launches_by_impl)
    experts_seen = dict(vq_dequant_matmul.launches_by_experts)
    st = eng.stats
    recs = eng.drain_request_records()
    ttft = [r.ttft_s for r in recs if r.ttft_s is not None]
    itl = [r.itl_mean_s for r in recs if r.itl_mean_s is not None]
    res = {"kv_bits": str(kv_bits), "max_len": max_len,
           "prompt_tokens": [len(r.prompt) for r in reqs],
           "requests": n_req, "new": n_new,
           "tokens": st["tokens"], "ticks": st["ticks"],
           "decode_ticks": st["decode_ticks"],
           "prefill_chunks": st["prefill_chunks"],
           "preemptions": st["preemptions"], "wall_s": wall,
           "engine_wall_s": st["wall_s"], "load_s": load_s,
           "tok_per_s": st["tokens"] / wall,
           "ttft_median_s": _median(ttft), "ttft_worst_s": max(ttft),
           "itl_median_s": _median(itl), "itl_worst_s": max(itl),
           "launches": launches, "vq_m_counts": ms_seen,
           "vq_impl_counts": impls_seen, "vq_experts_counts": experts_seen,
           "load_launches": load_launches,
           "out": [r.out_tokens for r in reqs],
           "prompts": [r.prompt for r in reqs]}
    log(f"[serve] kv={kv_bits} max_len={max_len}: {n_req} requests of "
        f"{min(res['prompt_tokens'])}-{max(res['prompt_tokens'])} prompt "
        f"tokens, {st['tokens']} tokens, "
        f"{st['ticks']} ticks ({st['decode_ticks']} decode, "
        f"{st['prefill_chunks']} prefill chunks, {st['preemptions']} "
        f"preemptions) in {wall:.3f} s = {res['tok_per_s']:.1f} tok/s "
        f"(engine load {load_s:.2f} s) | TTFT median "
        f"{res['ttft_median_s'] * 1e3:.1f} ms worst "
        f"{res['ttft_worst_s'] * 1e3:.1f} ms | ITL median "
        f"{res['itl_median_s'] * 1e3:.2f} ms worst "
        f"{res['itl_worst_s'] * 1e3:.2f} ms | launches {launches}, "
        f"vq_dequant_matmul launches by M {ms_seen}, by variant "
        f"{impls_seen}, launches at engine load {load_launches}")
    res["engine"] = eng
    return res


def forced_logits(torch, dev, model, eng, prompt, forced, impl,
                  params=None):
    """Teacher-forced per-step logits through a fresh paged cache in the
    engine's page format and length (and, for vq2, its frozen codebooks;
    a recurrent layer starts from its reset state), on the engine's params
    unless ``params`` is given."""
    from repro_torch.serve import paged_cache as pc
    from repro_torch.serve.serve_step import teacher_forced_logits

    cache = model.init_cache(1, eng.max_len, dtype=torch.float32,
                             paged=eng.layout, device=dev)
    n_pages = eng.max_len // SERVE_PAGE
    cache = pc.push_page_table(
        cache, np.arange(1, n_pages + 1, dtype=np.int32)[None])
    cache = pc.map_paged(
        lambda c, e: c if e.k_codebook is None else c._replace(
            k_codebook=e.k_codebook, v_codebook=e.v_codebook),
        cache, eng.cache)
    return teacher_forced_logits(
        model, eng.params if params is None else params, prompt, forced,
        cache=cache, paged_impl=impl)


def predict_serve(run: dict, n_layers: int, tag: str) -> dict:
    """Launch counts of a serve run from the host plan: paged_attention
    once a layer per decode tick; 7 quantized matmuls a layer in every
    forward (decode tick or prefill chunk), the decode ticks at M =
    max_batch; by variant, decode ticks and prefill chunks of <= 16 rows on
    split-K, wider chunks on the int8 tensor cores, none on the 3-term or
    FP32 variants (the model is bf16, its leaves int8)."""
    chunks = prefill_chunk_ms(run["prompts"])
    want = {"paged_attention": run["decode_ticks"] * n_layers,
            "vq_dequant_matmul": 7 * n_layers * (run["decode_ticks"]
                                                 + run["prefill_chunks"]),
            "at_m4": 7 * n_layers * (run["decode_ticks"]
                                     + chunks.count(SERVE_MAX_BATCH)),
            "chunks": chunks}
    impl = {"splitk": 7 * n_layers * (run["decode_ticks"]
                                      + sum(m <= 16 for m in chunks)),
            "tc_int8": 7 * n_layers * sum(m > 16 for m in chunks)}
    want["by_impl"] = {k: v for k, v in impl.items() if v}
    shown = chunks if len(chunks) <= 16 else (
        f"{len(chunks)} chunks, {sum(m > 16 for m in chunks)} of > 16 rows")
    log(f"[serve] {tag} predicted launches: paged_attention = decode ticks "
        f"x layers = {want['paged_attention']}; vq_dequant_matmul = 7 x "
        f"layers x (decode ticks + prefill chunks) = "
        f"{want['vq_dequant_matmul']}, of them "
        f"{7 * n_layers * run['decode_ticks']} at M = {SERVE_MAX_BATCH}; "
        f"prefill chunks: {shown}; by variant "
        f"{want['by_impl']}")
    return want


def serve_run_checks(run: dict, want: dict, n_new: int, tag: str) -> dict:
    """The checks of a serve run against its predicted launch counts
    (``predict_serve``'s or ``predict_family_serve``'s)."""
    return {
        f"{tag}: all requests finished": all(len(o) == n_new
                                             for o in run["out"])
            and run["decode_ticks"] > 0,
        f"{tag}: paged_attention launches as planned":
            run["launches"]["paged_attention"] == want["paged_attention"],
        f"{tag}: vq_dequant_matmul launches as planned":
            run["launches"]["vq_dequant_matmul"]
            == want["vq_dequant_matmul"] > 0,
        f"{tag}: vq_dequant_matmul at M = 4": run["vq_m_counts"].get(
            SERVE_MAX_BATCH, 0) == want["at_m4"],
        f"{tag}: prefill chunks as planned":
            run["prefill_chunks"] == len(want["chunks"]),
        f"{tag}: vq_dequant_matmul launches by variant as planned":
            run["vq_impl_counts"] == want["by_impl"],
    }


def teacher_forced(torch, dev, model, run: dict, eng, tag: str) -> tuple:
    """Request 0's prompt + outputs through the paged path (gather prefill
    + kernel decode) against the gather decode and the cache-free forward:
    {name: (max |diff|, RMS)} and the share of steps whose argmax is the
    served token."""
    from repro_torch.models.attention import FLASH_THRESHOLD

    prompt, out = run["prompts"][0], run["out"][0]
    forced = out[:-1]
    seq = np.concatenate([prompt, forced])
    n = len(seq)
    if n > FLASH_THRESHOLD:
        # the flash path takes whole 1024-token chunks; the tokens after
        # the sequence do not move its causal logits
        seq = np.pad(seq, (0, -n % 1024))
    with torch.no_grad():
        fused = forced_logits(torch, dev, model, eng, prompt, forced, "fused")
        gather = forced_logits(torch, dev, model, eng, prompt, forced,
                               "gather")
        free = model.forward(eng.params, {"tokens": torch.as_tensor(
            seq, device=dev)[None]})[0][0]
        free = free[len(prompt) - 1:n].float()
    diffs = {}
    for name, other in (("cache-free forward", free),
                        ("gather decode", gather)):
        d = (fused - other).float()
        diffs[name] = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
        log(f"[serve] {tag} teacher-forced kernel decode vs {name}, "
            f"{tuple(fused.shape)} logits: max |diff| {diffs[name][0]:.4e} "
            f"(tol {SERVE_MAX_TOL}), RMS {diffs[name][1]:.4e} (tol "
            f"{SERVE_RMS_TOL})")
    agree = float((fused.argmax(-1).cpu()
                   == torch.tensor(out)).float().mean())
    log(f"[serve] {tag} teacher-forced argmax reproduces the served tokens "
        f"on {agree:.4f} of steps")
    return diffs, agree, fused


# bars set from the readings on the H100: sound decodes read up to 5.2e-2
# max / 1.0e-2 RMS (vs the cache-free forward, which rounds probabilities
# to bf16) and 3.1e-2 / 5.2e-3 (vs the gather decode); a decode that read
# K/V at int8 precision drifts 9.4e-2 / 1.77e-2 and fails the RMS bar, a
# wrong page, mask or scale moves logits O(1)
SERVE_MAX_TOL, SERVE_RMS_TOL = 0.1, 0.015


def within_bars(diff: tuple) -> bool:
    return diff[0] <= SERVE_MAX_TOL and diff[1] <= SERVE_RMS_TOL


def phase_serve(torch, dev, model, qparams) -> dict:
    cfg = model.cfg
    t_phase = time.perf_counter()
    main = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                     SERVE_NEW)
    eng = main.pop("engine")
    n_layers = cfg.n_layers
    want = predict_serve(main, n_layers, "256-token run")
    diffs, greedy_agree, _ = teacher_forced(torch, dev, model, main, eng,
                                            "256-token run")
    prompt, out = main["prompts"][0], main["out"][0]

    # the vq2 engine's codebook fit: one vq_em launch (every E/M step of
    # the 32 kv heads) per pool (K and V) and layer; no vq_assign launch
    want_load = {str(bits): {"vq_assign": 0, "vq_group_sweep": 0,
                             "vq_em": 2 * n_layers if bits == "vq2" else 0}
                 for bits in (8, 4, "vq2")}
    quant = {}
    for bits in (8, 4, "vq2"):
        r = serve_run(torch, dev, model, qparams, bits, 4, 32)
        e = r.pop("engine")
        with torch.no_grad():
            ref = forced_logits(torch, dev, model, eng, prompt, out[:31],
                                "fused")
            got = forced_logits(torch, dev, model, e, prompt, out[:31],
                                "fused")
        d = got - ref
        r["drift_max"] = float(d.abs().max())
        r["drift_rms"] = float(d.pow(2).mean().sqrt())
        r["finite"] = bool(torch.isfinite(got).all())
        log(f"[serve] kv={bits}: launches at engine load "
            f"{r['load_launches']} (predicted {want_load[str(bits)]})")
        log(f"[serve] kv={bits}: teacher-forced drift vs f32 pages on "
            f"request 0 (32 steps): max {r['drift_max']:.4e}, RMS "
            f"{r['drift_rms']:.4e}, finite {r['finite']}")
        quant[str(bits)] = r
    del eng
    # the long run: 4 requests of 3,000-4,000 prompt tokens on an engine of
    # Llama-2-7B's 4096-token context, every decode tick's paged_attention
    # walking 190-256 pages a slot (prefill reads through gather)
    long = serve_run(torch, dev, model, qparams, 16, LONG_SERVE_REQUESTS,
                     LONG_SERVE_NEW, max_len=LONG_SERVE_MAX_LEN,
                     prompt_len=(3000, 4000))
    leng = long.pop("engine")
    want_long = predict_serve(long, n_layers, "4096-token run")
    diffs_long, agree_long, _ = teacher_forced(torch, dev, model, long, leng,
                                               "4096-token run")
    del leng
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f}s")

    checks = serve_run_checks(main, want, SERVE_NEW, "256-token run")
    checks.update(serve_run_checks(long, want_long, LONG_SERVE_NEW,
                                   "4096-token run"))
    checks.update({
        "teacher-forced vs cache-free": within_bars(
            diffs["cache-free forward"]),
        "teacher-forced vs gather decode": within_bars(
            diffs["gather decode"]),
        "4096-token run: teacher-forced vs gather decode": within_bars(
            diffs_long["gather decode"]),
        "4096-token run: teacher-forced vs cache-free": within_bars(
            diffs_long["cache-free forward"]),
    })
    for bits, r in quant.items():
        checks[f"kv={bits} finished"] = all(len(o) == 32 for o in r["out"])
        checks[f"kv={bits} paged_attention launches"] = (
            r["launches"]["paged_attention"] == r["decode_ticks"] * n_layers
            > 0)
        checks[f"kv={bits} logits finite"] = r["finite"]
        checks[f"kv={bits} vq_dequant_matmul on split-K and int8 tensor "
               "cores only"] = set(r["vq_impl_counts"]) <= {"splitk",
                                                            "tc_int8"}
        checks[f"kv={bits} launches at engine load"] = (
            r["load_launches"] == want_load[bits])
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"serve phase checks failed: {bad}")
    for r in [main, long, *quant.values()]:
        r.pop("prompts")
        r["out"] = r["out"][:2]
    for w in (want, want_long):
        w.pop("chunks")
    return {"kv16": main, "quantized": quant, "teacher_forced": diffs,
            "greedy_agree": greedy_agree, "long": long,
            "long_teacher_forced": diffs_long,
            "long_greedy_agree": agree_long,
            "predicted": dict(want, launches_at_load=want_load),
            "long_predicted": want_long}


def phase_long(torch, dev) -> dict:
    """Quantize and evaluate at 4096 tokens (flash_attention in every
    attention), save the packed checkpoint, restore it and evaluate the
    restored tree. Launch and dispatch counts are zeroed just before the
    fp perplexity and read just after the restored one."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.obs import Telemetry, dispatch
    from repro_torch.train.loss import perplexity

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    log(f"[long] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, layers "
        f"{cfg.n_layers}, dtype {cfg.dtype}; calibration {LONG_CALIB} x "
        f"{LONG_SEQ}, heldout {LONG_HELDOUT} x {LONG_SEQ} tokens")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=LONG_CALIB,
                               seq_len=LONG_SEQ, device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=LONG_HELDOUT,
                                 seq_len=LONG_SEQ, seed=777, device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    recipe = QuantRecipe.uniform(
        PAPER_SETTINGS["2.25bpv_2d"], name="2.25bpv_2d"
    ).with_quantize_overrides(em_iters=25, codebook_update_iters=10)
    tel = Telemetry()
    ck_dir = os.path.join(ROOT, "build", "repro_torch", "long_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    # one calibration chunk (4 sequences <= quantize_model's chunk of 8):
    # per layer one capture and one advance forward, and one forward in
    # each of the fp, vq and restored-vq evaluations, each with one
    # attention over 4096 tokens
    want_flash = cfg.n_layers * (2 + 3)
    want_vq = 7 * cfg.n_layers * 2  # the vq and restored-vq evaluations

    # by variant: the bf16 forwards (capture, the three evaluations) on
    # tensor cores, the advance forward on the FP32 kernel (it runs the
    # quantized block on f32-dequantized weights, as the reference's
    # adapters/transformer.advance does, so q, k and v are f32); every
    # vq_dequant_matmul on the int8 tensor cores (bf16 x, int8 leaves)
    want_impl = {"flash_attention": {"tc": cfg.n_layers * (1 + 3),
                                     "fp32": cfg.n_layers},
                 "vq_dequant_matmul": {"tc_int8": want_vq}}

    flash_attention.launches = 0
    flash_attention.launches_by_impl = {}
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    for fn in VQ_ENTRY_POINTS:
        getattr(vqa, fn).launches = 0
    dispatch.reset_dispatch_counters()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True, telemetry=tel,
        progress=lambda m: log(f"[long]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl_vq = perplexity(model, vql_mod.prepare_fused_tree(qparams), heldout)
    t["ppl_vq"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    Checkpointer(ck_dir, keep=1).save(0, qparams, metadata={
        "arch": cfg.name, "recipe": recipe.to_json(),
        "achieved_bpv": rep.achieved_bpv, "per_target": rep.per_target,
        "ppl_fp": ppl_fp, "ppl_vq": ppl_vq})
    t["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, meta = Checkpointer(ck_dir).restore(qparams)
    torch.cuda.synchronize()
    t["restore"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ppl_rs = perplexity(model, vql_mod.prepare_fused_tree(restored), heldout)
    t["ppl_restored"] = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "vq_dequant_matmul": vq_dequant_matmul.launches}
    launches.update({fn: getattr(vqa, fn).launches for fn in VQ_ENTRY_POINTS})
    impls = {"flash_attention": dict(flash_attention.launches_by_impl),
             "vq_dequant_matmul": dict(vq_dequant_matmul.launches_by_impl)}
    flash_dispatch = dispatch.snapshot_dispatch_counters()["flash"]["fused"]
    peak = torch.cuda.max_memory_allocated()

    from repro_torch.checkpoint.checkpointer import _flatten

    pairs = list(zip(_flatten(qparams), _flatten(restored)))
    bitwise = all(p == r and a.dtype == b.dtype and a.device == b.device
                  and torch.equal(a, b) for (p, a), (r, b) in pairs)
    n_bf16 = sum(a.dtype == torch.bfloat16 for (_, a), _ in pairs)
    ck_bytes = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(ck_dir) for f in fs)
    shutil.rmtree(ck_dir, ignore_errors=True)
    evs = tel.events.events
    n_stage = sum(e["event"] == "quant_stage" for e in evs)
    n_target = sum(e["event"] == "quant_target" for e in evs)
    # per block: capture, advance, and per target one codebook_update and
    # one em_init and one column_sweep for each of its column groups
    n_groups = sum(leaf.n_cg for lp in qparams["layers"]
                   for sub in (lp["attn"], lp["ffn"]) for leaf in sub.values())
    want_stage = cfg.n_layers * (2 + 7) + 2 * n_groups

    log(f"[long] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} restored={ppl_rs:.3f} | "
        f"recon err={rep.total_error():.4f} | achieved "
        f"{rep.achieved_bpv:.4f} bpv")
    log("[long] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[long] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[long] launches: {launches}; predicted flash_attention "
        f"{want_flash}, vq_dequant_matmul {want_vq}, vq_group_sweep and "
        f"vq_em {predict_groups(cfg)} each, vq_assign 0; \"flash\" dispatch "
        f"{flash_dispatch}; by variant {impls} (predicted {want_impl})")
    log(f"[long] checkpoint: {len(pairs)} leaves ({n_bf16} bf16), "
        f"{ck_bytes / 2**20:.1f} MiB, restored bit for bit: {bitwise}")
    log(f"[long] events: quant_stage {n_stage} (predicted {want_stage}), "
        f"quant_target {n_target} (predicted {7 * cfg.n_layers})")
    log(f"[long] max_memory_allocated {peak / 2**30:.2f} GiB")

    checks = {
        "ppl finite": all(math.isfinite(x) for x in (ppl_fp, ppl_vq, ppl_rs)),
        "restored ppl == vq ppl": ppl_rs == ppl_vq,
        "bpv": rep.achieved_bpv == 2.25,
        "checkpoint bitwise": bitwise and n_bf16 > 0,
        "metadata": meta["achieved_bpv"] == 2.25,
        "flash_attention launches": launches["flash_attention"] == want_flash,
        "flash dispatch": flash_dispatch == want_flash,
        "vq_dequant_matmul launches": launches["vq_dequant_matmul"] == want_vq,
        "launches by variant as planned": impls == want_impl,
        "column groups as planned": n_groups == predict_groups(cfg),
        **quantize_launch_checks(launches, predict_groups(cfg)),
        "quant_stage events": n_stage == want_stage,
        "quant_target events": n_target == 7 * cfg.n_layers,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"long phase checks failed: {bad}")
    return calib, heldout, {"launches": launches, "launches_by_impl": impls, "predicted": {
                "flash_attention": want_flash, "vq_dequant_matmul": want_vq,
                "quant_stage": want_stage, "by_impl": want_impl},
            "flash_dispatch": flash_dispatch, "ppl_fp": ppl_fp,
            "ppl_vq": ppl_vq, "ppl_restored": ppl_rs,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv,
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "checkpoint_leaves": len(pairs), "checkpoint_bf16_leaves": n_bf16,
            "checkpoint_bytes": ck_bytes, "events": {
                "quant_stage": n_stage, "quant_target": n_target},
            "max_memory_allocated": peak}


# the train phase: full-width Llama-2-7B (2 layers, bf16) on the long
# phase's 4 x 4096 calibration tokens, 2 microbatches of 2 x 4096
TRAIN_STEPS, TRAIN_MICROBATCHES = 4, 2
# lr 3e-5: at 3e-4 the random full-width model's loss rises after Adam's
# first step (10.92 -> 24.49 -> 13.26 -> 11.82 on these tokens; at 3e-5
# 10.92 -> 9.99 -> 8.65 -> 8.69; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md,
# section 6)
TRAIN_OPT = dict(lr=3e-5, warmup_steps=1, total_steps=8)
TRAIN_GRAD_RTOL = 1e-4  # relative Frobenius error a leaf, f32 copy
# the same in bf16 (kernels vs the plain flash pair, both in the model's
# bf16): about five bf16 roundings (2^-8 each); a missing or wrong
# attention gradient moves a leaf O(1)
TRAIN_GRAD_RTOL_BF16 = 2e-2
# the witness at the lr the loss rises at: the same steps through the
# kernels and through the plain flash pair; steps 1 and 2 (from the same
# params, then after one sign-like Adam step) within this relative
# difference of the loss, steps 3-4 recorded
TRAIN_LR_HIGH = 3e-4
TRAIN_LOSS_RTOL_HIGH = 2e-2


class plain_flash_hook:
    """Within the context ``models/attention.flash_attention`` runs the
    plain forward (with its log-sum-exp) and the plain backward on the
    card, through an autograd Function of their own: the train phase's
    reference for the gradients through the kernels. ``chunks`` (query,
    kv) replaces the plain version's chunk sizes within the context: the
    same function with its f32 sums in another order."""

    def __init__(self, chunks=None):
        self.chunks = chunks

    def __enter__(self):
        import torch

        from repro_torch.kernels import flash_attention as fa
        from repro_torch.models import attention

        class PlainFlashFn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, q, k, v, causal, q_offset):
                out, lse = fa.flash_attention_plain(
                    q, k, v, causal=causal, q_offset=q_offset, with_lse=True)
                ctx.save_for_backward(q, k, v, out, lse)
                ctx.causal, ctx.q_offset = causal, q_offset
                return out

            @staticmethod
            def backward(ctx, dout):
                q, k, v, out, lse = ctx.saved_tensors
                return (*fa.flash_attention_bwd_plain(
                    q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
                    q_offset=ctx.q_offset), None, None)

        self.attention, self.real = attention, attention.flash_attention
        self.fa, self.real_chunks = fa, (fa.Q_CHUNK, fa.KV_CHUNK)
        if self.chunks is not None:
            fa.Q_CHUNK, fa.KV_CHUNK = self.chunks
        attention.flash_attention = (
            lambda q, k, v, *, causal, q_offset=0: PlainFlashFn.apply(
                q.contiguous(), k.contiguous(), v.contiguous(), causal,
                q_offset))
        return self

    def __exit__(self, *exc):
        self.attention.flash_attention = self.real
        self.fa.Q_CHUNK, self.fa.KV_CHUNK = self.real_chunks


def train_counts() -> dict:
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)

    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_by_impl": dict(flash_attention.launches_by_impl),
            "flash_attention_bwd_by_impl": dict(
                flash_attention_bwd.launches_by_impl)}


def train_model_flops(cfg, params, tokens: int, seq: int) -> float:
    """Model FLOPs of one step (no recompute counted): 6 a matmul
    parameter a token (every layer matrix and the head; the embedding is
    a gather) plus the causal attention's products, 4 * hd a visible
    (row, column) pair a head and layer forward, three times that with
    the backward."""
    n_matmul = sum(t.numel() for lp in params["layers"]
                   for sub in (lp["attn"], lp["ffn"]) for t in sub.values()
                   if t.dim() == 2)
    n_matmul += (params["embed"] if cfg.tie_embeddings
                 else params["lm_head"]).numel()
    pairs = seq * (seq + 1) // 2
    attn = 3 * 4.0 * cfg.hd * pairs * cfg.n_heads * cfg.n_layers
    return 6.0 * n_matmul * tokens + attn * tokens / seq


def phase_train(torch, dev, tokens) -> dict:
    """Train full-width Llama-2-7B (2 layers) at 4 x 4096 tokens through
    the flash kernels: the f32 copy's gradients against the plain flash
    forward and backward; 4 bf16 steps (finite, falling loss; launches
    as planned; step time, tokens/s, model FLOPs share, peak memory); one
    step under remat="save_attn"; one bf16 step's gradients against the
    plain flash pair; 4 steps at lr 3e-4 through the kernels and through
    the plain pair; a supervised launcher run with a failure injected."""
    import shutil

    from repro_torch.configs import ARCHS
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        TrainState, loss_and_grads, make_train_step)

    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    B, S = tokens.shape
    mb = TRAIN_MICROBATCHES
    log(f"[train] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, layers "
        f"{cfg.n_layers}, dtype {cfg.dtype}; batch {B} x {S} tokens in {mb} "
        f"microbatches; {TRAIN_OPT}")
    batch = {"tokens": tokens}
    t = {}
    res = {}

    # 1. gradients in the f32 copy: kernels vs the plain flash pair
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    params32 = to_f32(params)
    zero_counts()
    g_kernel, m_kernel = loss_and_grads(model32, params32, batch,
                                        microbatches=mb, remat=True)
    torch.cuda.synchronize()
    counts32 = train_counts()
    with plain_flash_hook():
        g_plain, m_plain = loss_and_grads(model32, params32, batch,
                                          microbatches=mb, remat=True)
    torch.cuda.synchronize()
    names, rel = [], []
    for name, a, b in zip(_leaf_names(g_plain), opt.tree_leaves(g_kernel),
                          opt.tree_leaves(g_plain)):
        names.append(name)
        rel.append(float((a - b).norm() / b.norm().clamp(min=1e-30)))
    worst = max(zip(rel, names))
    attn_rel = {n: r for n, r in zip(names, rel)
                if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")}
    t["grad_check"] = time.perf_counter() - t0
    log(f"[train] f32 copy: loss kernels {float(m_kernel['loss']):.6f}, "
        f"plain {float(m_plain['loss']):.6f}; relative Frobenius error a "
        f"leaf, worst {worst[0]:.2e} ({worst[1]}), wq/wk/wv "
        + ", ".join(f"{n} {r:.2e}" for n, r in attn_rel.items())
        + f"; launches {counts32}")
    del g_kernel, g_plain, params32, model32
    torch.cuda.empty_cache()

    # 2. four bf16 steps on the same batch
    ocfg = opt.OptConfig(**TRAIN_OPT)
    state = TrainState(params, opt.init(params, ocfg))
    del params
    step = make_train_step(model, ocfg, microbatches=mb, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, gnorms, secs = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    flops = train_model_flops(cfg, state.params, B * S, S)
    steady = _median(secs[1:])
    log(f"[train] bf16 steps: loss {losses}, grad norm {gnorms}, seconds "
        f"{[round(x, 4) for x in secs]}; launches {counts}")
    log(f"[train] {steady:.4f} s a step (median of steps 2-{TRAIN_STEPS}), "
        f"{B * S / steady:.1f} tokens/s, model FLOPs {flops / 1e12:.2f} T a "
        f"step = {flops / steady / BF16_TC_FLOP_PER_S:.4f} of the bf16 peak; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")

    # 3. one step under remat="save_attn": attention is not re-run
    step_sa = make_train_step(model, ocfg, microbatches=mb,
                              remat="save_attn")
    zero_counts()
    t0 = time.perf_counter()
    state_sa, m_sa = step_sa(state, batch)
    torch.cuda.synchronize()
    t["save_attn_step"] = time.perf_counter() - t0
    counts_sa = train_counts()
    log(f"[train] save_attn step: loss {float(m_sa['loss']):.6f}, "
        f"{t['save_attn_step']:.4f} s; launches {counts_sa}")
    del state_sa, state, step, step_sa
    torch.cuda.empty_cache()

    # 4. one bf16 step's gradients: kernels (tc forward with its lse, the
    # backward fed it) vs the plain flash pair, both in bf16
    t0 = time.perf_counter()
    params = model.init_params(seed=0, device=dev)
    g_kernel, _ = loss_and_grads(model, params, batch, microbatches=mb,
                                 remat=True)
    with plain_flash_hook():
        g_plain, _ = loss_and_grads(model, params, batch, microbatches=mb,
                                    remat=True)
    torch.cuda.synchronize()
    rel16 = [float((a - b).norm() / b.norm().clamp(min=1e-30))
             for a, b in zip(opt.tree_leaves(g_kernel),
                             opt.tree_leaves(g_plain))]
    worst16 = max(zip(rel16, names))
    t["grad_check_bf16"] = time.perf_counter() - t0
    log(f"[train] bf16 gradients, kernels vs the plain flash pair: "
        f"relative Frobenius error a leaf, worst {worst16[0]:.2e} "
        f"({worst16[1]}), wq/wk/wv "
        + ", ".join(f"{n} {r:.2e}" for n, r in zip(names, rel16)
                    if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")))
    del g_kernel, g_plain
    torch.cuda.empty_cache()

    # 5. at lr 3e-4, 4 bf16 steps through the kernels and through the
    # plain flash pair: whether the loss's rise is Adam's or the kernels'
    t0 = time.perf_counter()
    ocfg_hi = opt.OptConfig(**dict(TRAIN_OPT, lr=TRAIN_LR_HIGH))

    def high_lr_losses(ctx) -> list:
        st = TrainState(params, opt.init(params, ocfg_hi))
        stp = make_train_step(model, ocfg_hi, microbatches=mb, remat=True)
        out = []
        with ctx:
            for _ in range(TRAIN_STEPS):
                st, m = stp(st, batch)
                out.append(float(m["loss"]))
        return out

    hi_kernel = high_lr_losses(contextlib.nullcontext())
    torch.cuda.empty_cache()
    hi_plain = high_lr_losses(plain_flash_hook())
    del params
    torch.cuda.empty_cache()
    hi_rel = [abs(a - b) / abs(b) for a, b in zip(hi_kernel, hi_plain)]
    t["high_lr"] = time.perf_counter() - t0
    log(f"[train] lr {TRAIN_LR_HIGH}: loss through the kernels {hi_kernel}, "
        f"through the plain flash pair {hi_plain}; relative difference a "
        f"step {[f'{x:.2e}' for x in hi_rel]}")

    # 6. the launcher on a smoke config, a failure injected at step 3
    ck_dir = os.path.join(ROOT, "build", "repro_torch", "train_ckpt")
    shutil.rmtree(ck_dir, ignore_errors=True)
    fails = []

    def fail_once(i):
        if i == 3 and not fails:
            fails.append(i)
            raise RuntimeError("injected failure")

    t0 = time.perf_counter()
    sup = launch_train.run(launch_train.parse_args([
        "--arch", "llama2-7b", "--smoke", "--device", dev.type, "--steps", "6",
        "--global-batch", "4", "--seq-len", "64", "--microbatches", "2",
        "--checkpoint-every", "2", "--ckpt-dir", ck_dir]),
        before_step=fail_once)
    t["launcher"] = time.perf_counter() - t0
    sup_step = int(sup.final_state.opt.step)
    shutil.rmtree(ck_dir, ignore_errors=True)
    log(f"[train] launcher: {sup.steps_done} steps, {sup.restarts} "
        f"restarts, final step {sup_step}, {t['launcher']:.1f}s")

    L = cfg.n_layers
    want = {"flash_attention": TRAIN_STEPS * L * mb * 2,
            "flash_attention_bwd": TRAIN_STEPS * L * mb,
            "flash_attention_by_impl": {"tc": TRAIN_STEPS * L * mb * 2},
            "flash_attention_bwd_by_impl": {"tc": TRAIN_STEPS * L * mb}}
    want32 = {"flash_attention": L * mb * 2, "flash_attention_bwd": L * mb,
              "flash_attention_by_impl": {"fp32": L * mb * 2},
              "flash_attention_bwd_by_impl": {"fp32": L * mb}}
    want_sa = {"flash_attention": L * mb, "flash_attention_bwd": L * mb,
               "flash_attention_by_impl": {"tc": L * mb},
               "flash_attention_bwd_by_impl": {"tc": L * mb}}
    checks = {
        "f32 gradients within 1e-4 of the plain flash pair":
            worst[0] <= TRAIN_GRAD_RTOL,
        "wq, wk, wv checked": len(attn_rel) == 3 * L,
        "f32 launches as planned": counts32 == want32,
        "bf16 gradients within 2e-2 of the plain flash pair":
            worst16[0] <= TRAIN_GRAD_RTOL_BF16,
        "lr 3e-4: steps 1-2 through the kernels match the plain pair":
            max(hi_rel[:2]) <= TRAIN_LOSS_RTOL_HIGH,
        "loss finite": all(math.isfinite(x) for x in losses),
        "grad norm finite": all(math.isfinite(x) for x in gnorms),
        "loss falls": losses[-1] < losses[0],
        "launches as planned": counts == want,
        "save_attn launches as planned": counts_sa == want_sa,
        "save_attn loss finite": math.isfinite(float(m_sa["loss"])),
        "launcher resumed to the last step":
            (sup.steps_done, sup.restarts, sup_step) == (6, 1, 6),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"train phase checks failed: {bad}")
    res.update({
        "grad_rel_frobenius": dict(zip(names, rel)), "grad_worst": worst,
        "grad_rel_frobenius_bf16": dict(zip(names, rel16)),
        "grad_worst_bf16": worst16, "high_lr": {
            "lr": TRAIN_LR_HIGH, "losses_kernels": hi_kernel,
            "losses_plain": hi_plain, "relative_difference": hi_rel},
        "launches_f32": counts32, "losses": losses, "grad_norms": gnorms,
        "step_seconds": secs, "seconds_per_step": steady,
        "tokens_per_s": B * S / steady, "model_flops_per_step": flops,
        "mfu_bf16": flops / steady / BF16_TC_FLOP_PER_S,
        "max_memory_allocated": peak, "launches": counts,
        "launches_save_attn": counts_sa, "predicted": {
            "remat": want, "f32": want32, "save_attn": want_sa},
        "launcher": {"steps_done": sup.steps_done,
                     "restarts": sup.restarts, "final_step": sup_step},
        "seconds": t})
    return res


def _leaf_names(tree, prefix="") -> list:
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix]


class route_hook:
    """Within the context every ``models/moe.route`` call's expert ids are
    recorded (the list ``as`` binds); with ``replay`` (an earlier
    recording, one entry a call in the same order) each call takes the
    recorded ids instead, its gate values read from its own probabilities
    at them."""

    def __init__(self, moe, replay=None):
        self.moe, self.replay, self.seen = moe, replay, []

    def __enter__(self):
        real, it = self.moe.route, (None if self.replay is None
                                    else iter(self.replay))
        self.real = real

        def hooked(x, router, k):
            probs, gate, ids = real(x, router, k)
            if it is not None:
                ids = next(it)
                gate = probs.gather(-1, ids)
            self.seen.append(ids)
            return probs, gate, ids

        self.moe.route = hooked
        return self.seen

    def __exit__(self, *exc):
        self.moe.route = self.real


def routing_flips(torch, a: list, b: list) -> tuple[list, int]:
    """Between two recordings of the same forwards: the (token, layer)
    routings whose expert sets differ, a route call (a layer) each, and
    the routings a call."""
    flips = []
    for x, y in zip(a, b):
        sx, sy = x.sort(-1).values, y.sort(-1).values
        flips.append(int((sx != sy).any(-1).sum()))
    return flips, a[0][..., 0].numel()


def moe_plan(cfg, setting) -> tuple[int, float, list]:
    """The host plan of a moe quantize at ``setting``: column groups (one
    vq_group_sweep and one vq_em launch each: E x c / group columns a
    target), the size-weighted effective bpv of the targets' shapes, and
    the targets (name, matrices, r, c)."""
    from repro_torch.core.bpv import effective_bpv, weighted_bpv
    from repro_torch.core.gptvq import plan_groups

    D, hd, F = cfg.d_model, cfg.head_dim, cfg.d_ff
    shapes = {"attn.wq": (1, cfg.n_heads * hd, D),
              "attn.wk": (1, cfg.n_kv_heads * hd, D),
              "attn.wv": (1, cfg.n_kv_heads * hd, D),
              "attn.wo": (1, D, cfg.n_heads * hd),
              "ffn.w_in": (cfg.n_experts, F, D),
              "ffn.w_gate": (cfg.n_experts, F, D),
              "ffn.w_out": (cfg.n_experts, D, F)}
    targets = [(f"layers.{i}.{n}", *sh) for i in range(cfg.n_layers)
               for n, sh in shapes.items()]
    groups = sum(E * c // plan_groups(r, c, setting)[0]
                 for _, E, r, c in targets)
    bpv = weighted_bpv((E * r * c, effective_bpv(setting, r, c))
                       for _, E, r, c in targets)
    return groups, bpv, targets


def predict_moe_serve(run: dict, fused, cfg) -> dict:
    """Launch counts of a moe serve run from the host plan: paged_attention
    once a layer per decode tick; in every forward 4 attention matmuls and
    3 expert stacks a layer, each stack one launch of 128 experts; the
    decode ticks' attention at M = max_batch and experts at max_batch x
    capacity(1) rows an expert, a prefill chunk's attention at its padded
    rows m and experts at capacity(m); by variant as each leaf's layout
    selects at those rows."""
    import torch

    from repro_torch.models import moe

    chunks = prefill_chunk_ms(run["prompts"])
    forwards = run["decode_ticks"] + run["prefill_chunks"]
    plan = [(SERVE_MAX_BATCH, SERVE_MAX_BATCH * moe.capacity(1, cfg),
             run["decode_ticks"])] + [(m, moe.capacity(m, cfg), 1)
                                      for m in chunks]
    impls: dict = {}
    for m_attn, m_exp, times in plan:
        for k, v in predict_matmul_impls(fused, m_attn, torch.bfloat16,
                                         m_exp).items():
            impls[k] = impls.get(k, 0) + v * times
    want = {"paged_attention": run["decode_ticks"] * cfg.n_layers,
            "vq_dequant_matmul": 7 * cfg.n_layers * forwards,
            "by_experts": {cfg.n_experts: 3 * cfg.n_layers * forwards},
            "by_impl": impls, "chunks": chunks,
            "decode_rows": plan[0][:2]}
    log(f"[moe] serve predicted launches: paged_attention = decode ticks x "
        f"layers = {want['paged_attention']}; vq_dequant_matmul = 7 x layers "
        f"x forwards = {want['vq_dequant_matmul']}, of them "
        f"{want['by_experts']} expert stacks (experts: launches); decode "
        f"rows (attention, a expert) {plan[0][:2]}; prefill chunks {chunks}; "
        f"by variant {impls}")
    return want


def phase_moe(torch, dev) -> dict:
    """The MoE family at Qwen3-MoE-30B-A3B's full width, 2 layers: see the
    module docstring."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo, moe
    from repro_torch.obs import Telemetry
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = ARCHS[MOE_ARCH].scaled(n_layers=MOE_LAYERS)
    log(f"[moe] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} over "
        f"{cfg.n_kv_heads} kv x {cfg.head_dim}, {cfg.n_experts} experts "
        f"top-{cfg.n_experts_active} of d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, layers {cfg.n_layers}, dtype {cfg.dtype}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=MOE_CALIB[0],
                               seq_len=MOE_CALIB[1], device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=MOE_HELDOUT[0],
                                 seq_len=MOE_HELDOUT[1], seed=777,
                                 device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    setting = PAPER_SETTINGS["2.25bpv_2d"]
    recipe = QuantRecipe.uniform(setting, name="2.25bpv_2d"
                                 ).with_quantize_overrides(
                                     em_iters=25, codebook_update_iters=10)
    n_groups, want_bpv, targets = moe_plan(cfg, setting)
    log(f"[moe] host plan: {len(targets)} targets, vq_group_sweep and vq_em "
        f"{n_groups} launches each (one a column group of every expert), "
        f"vq_assign 0; achieved bpv {want_bpv:.6f}")

    for fn in VQ_ENTRY_POINTS:
        getattr(vqa, fn).launches = 0
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    tel = Telemetry()
    # every event of the run: a stage event a column group and expert
    # outnumbers the log's default ring
    tel.events.keep = 1 << 20
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True, telemetry=tel,
        progress=lambda m: log(f"[moe]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    quant_launches = {fn: getattr(vqa, fn).launches
                      for fn in VQ_ENTRY_POINTS}
    n_target = sum(e["event"] == "quant_target" for e in tel.events.events)
    n_stage = sum(e["event"] == "quant_stage" for e in tel.events.events)
    # a stage event for the sweep and the EM of every column group, the
    # codebook update of every matrix, capture and advance of every block
    want_stage = (2 * n_groups + sum(E for _, E, _, _ in targets)
                  + 2 * cfg.n_layers)
    del params

    fused = vql_mod.prepare_fused_tree(qparams)
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    vq_dequant_matmul.launches_by_experts = {}
    t0 = time.perf_counter()
    ppl_vq = perplexity(model, fused, heldout)
    torch.cuda.synchronize()
    t["ppl_vq"] = time.perf_counter() - t0
    eval_launches = {"launches": vq_dequant_matmul.launches,
                     "by_impl": dict(vq_dequant_matmul.launches_by_impl),
                     "by_experts": dict(
                         vq_dequant_matmul.launches_by_experts)}
    B, S = MOE_HELDOUT
    want_eval = {"launches": 7 * cfg.n_layers,
                 "by_impl": predict_matmul_impls(
                     fused, B * S, torch.bfloat16,
                     B * moe.capacity(S, cfg)),
                 "by_experts": {cfg.n_experts: 3 * cfg.n_layers}}

    # fused vs gather teacher-forced logits: free, then with the gather
    # forward's routing replayed in the fused one
    with torch.no_grad():
        with route_hook(moe) as gather_ids:
            lg = model.forward(qparams, {"tokens": heldout})[0]
        with route_hook(moe) as free_ids:
            lf_free = model.forward(fused, {"tokens": heldout})[0]
        with route_hook(moe, replay=gather_ids):
            lf = model.forward(fused, {"tokens": heldout})[0]
    by_layer, per_layer = routing_flips(torch, gather_ids, free_ids)
    flips, routings = sum(by_layer), per_layer * len(by_layer)
    diffs = {}
    for name, got in (("replayed", lf), ("free", lf_free)):
        dl = (got - lg).float()
        diffs[name] = (float(dl.abs().max()), float(dl.pow(2).mean().sqrt()))
    del lg, lf_free
    max_tol, rms_tol = 0.5, 0.05  # main's fused-vs-gather bars
    log(f"[moe] fused vs gather logits {tuple(lf.shape)}, routing replayed: "
        f"max |diff| {diffs['replayed'][0]:.4e} (tol {max_tol}), RMS "
        f"{diffs['replayed'][1]:.4e} (tol {rms_tol}); free routing: max "
        f"{diffs['free'][0]:.4e}, RMS {diffs['free'][1]:.4e}, {flips} of "
        f"{routings} (token, layer) routings flipped "
        f"({flips / routings:.4%}; bar {MOE_FLIP_TOL:.0%}), by layer "
        f"{by_layer} of {per_layer}")

    # the serve run, main's engine and traffic, then each request alone
    t0 = time.perf_counter()
    run = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                    SERVE_NEW)
    eng = run.pop("engine")
    want_serve = predict_moe_serve(run, eng.params, cfg)
    prompt, out = run["prompts"][0], run["out"][0]
    with torch.no_grad():
        with route_hook(moe) as tf_ids:
            tf_gather = forced_logits(torch, dev, model, eng, prompt,
                                      out[:-1], "gather")
        with route_hook(moe, replay=tf_ids):
            tf_kernel = forced_logits(torch, dev, model, eng, prompt,
                                      out[:-1], "fused")
    d = (tf_kernel - tf_gather).float()
    tf_diff = (float(d.abs().max()), float(d.pow(2).mean().sqrt()))
    log(f"[moe] serve: teacher-forced kernel decode vs gather decode, "
        f"routing replayed, {tuple(d.shape)} logits: max |diff| "
        f"{tf_diff[0]:.4e} (tol {SERVE_MAX_TOL}), RMS {tf_diff[1]:.4e} (tol "
        f"{SERVE_RMS_TOL})")
    solo = solo_tokens(torch, dev, model, qparams, run["prompts"], SERVE_NEW)
    solo_same = [a == b for a, b in zip(solo, run["out"])]
    log(f"[moe] solo vs interleaved tokens identical: {solo_same}")
    t["serve"] = time.perf_counter() - t0
    del eng

    peak = torch.cuda.max_memory_allocated()
    log(f"[moe] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.6f} bpv "
        f"(host plan {want_bpv:.6f})")
    log("[moe] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[moe] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[moe] quantize launches {quant_launches} (predicted "
        f"vq_group_sweep and vq_em {n_groups} each, vq_assign 0); "
        f"quant_target events {n_target} (predicted {7 * cfg.n_layers}), "
        f"quant_stage {n_stage} (predicted {want_stage}); evaluation "
        f"matmuls "
        f"{eval_launches} (predicted {want_eval})")
    log(f"[moe] max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    n_fwd = run["decode_ticks"] + run["prefill_chunks"]
    dec_attn, dec_exp = want_serve["decode_rows"]
    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits shape": tuple(lf.shape) == (B, S, cfg.padded_vocab),
        "logits finite": bool(torch.isfinite(lf).all()),
        "fused vs gather, routing replayed": (
            diffs["replayed"][0] <= max_tol
            and diffs["replayed"][1] <= rms_tol),
        "free routing flips within the bar": flips <= MOE_FLIP_TOL * routings,
        "bpv == host plan": abs(rep.achieved_bpv - want_bpv) < 1e-9,
        "quant_target events": n_target == 7 * cfg.n_layers,
        "quant_stage events": n_stage == want_stage,
        **quantize_launch_checks(quant_launches, n_groups),
        "evaluation: 7 launches a layer by variant as planned":
            eval_launches == want_eval,
        "serve: all requests finished": all(len(o) == SERVE_NEW
                                            for o in run["out"]),
        "serve: prefill chunks as planned":
            run["prefill_chunks"] == len(want_serve["chunks"]),
        "serve: paged_attention launches == decode ticks x layers":
            run["launches"]["paged_attention"]
            == want_serve["paged_attention"] > 0,
        "serve: vq_dequant_matmul launches == 7 x layers x forwards":
            run["launches"]["vq_dequant_matmul"]
            == want_serve["vq_dequant_matmul"] > 0,
        "serve: every expert stack one launch (no expert alone)":
            run["vq_experts_counts"] == want_serve["by_experts"],
        "serve: decode ticks at the planned rows":
            run["vq_m_counts"].get(dec_attn, 0)
            >= 4 * cfg.n_layers * run["decode_ticks"]
            and run["vq_m_counts"].get(dec_exp, 0)
            >= 3 * cfg.n_layers * run["decode_ticks"],
        "serve: by variant as planned":
            run["vq_impl_counts"] == want_serve["by_impl"],
        "serve: teacher-forced kernel vs gather decode, routing replayed":
            within_bars(tf_diff),
        "serve: solo == interleaved tokens": all(solo_same),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"moe phase checks failed: {bad}")
    run.pop("prompts")
    run["out"] = run["out"][:2]
    want_serve.pop("chunks")
    return {"launches": quant_launches, "predicted_column_groups": n_groups,
            "eval_launches": eval_launches, "predicted_eval": want_eval,
            "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv, "predicted_bpv": want_bpv,
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "logit_diffs": diffs, "routing_flips": by_layer,
            "routings": routings, "serve": run,
            "serve_predicted": want_serve,
            "serve_teacher_forced": tf_diff, "solo_equal": solo_same,
            "max_memory_allocated": peak,
            "phase_seconds": time.perf_counter() - t_phase}

# the vlm phase: Phi-3-vision-4.2B at full width, 2 of its 32 layers,
# calibrated on text only: the long phase's 4 x 4096 calibration tokens
# (drawn below 32,000, inside Phi-3's vocab of 32,064). Heldout: 2
# sequences of 1,024 seeded patch embeddings (x 0.1, as the reference's
# tests/models/test_smoke.py makes them) + the first 3,072 tokens of the
# long phase's first two heldout sequences. Its vq2-page engine: 4
# requests, 32 new tokens each
VLM_ARCH, VLM_LAYERS = "phi-3-vision-4.2b", 2
VLM_HELDOUT, VLM_TEXT = 2, 3072
# its dense-cache prefill: the patches and the first 2,048 text tokens (a
# flash attention over 3,072 rows: its chunks take whole 1,024-row
# blocks), then one decode step at position 3,072
VLM_PREFILL = 2048
VLM_VQ2 = (4, 32)
# the ssm phase: xLSTM-125M at full width and depth (12 layers, sLSTM at
# 3 and 9); calibration and heldout (sequences, tokens)
SSM_ARCH = "xlstm-125m"
SSM_CALIB, SSM_HELDOUT = (16, 256), (8, 256)
# main's fused-vs-gather bars on the teacher-forced logits
FUSED_MAX_TOL, FUSED_RMS_TOL = 0.5, 0.05
# the ssm phase's bf16 comparisons (fused vs gather logits; the served
# path's teacher-forced decode vs the gather decode and the cache-free
# forward): twice the first readings on the H100 (max 0.97, RMS 0.101 for
# fused vs gather; logits ~0.55 RMS). The 12-layer random xLSTM amplifies
# a bf16 rounding (of the dequantized W, which the gather form makes, or
# of an activation) that much, so main's and the serve bars cannot hold
# in bf16; the phase measures that sensitivity directly (its f32 copy
# with the dequantized W exact against rounded to bf16). A wrong code,
# band or scale moves logits O(1) and fails the f32 copy's comparisons,
# held to main's and the serve bars
SSM_BF16_MAX_TOL, SSM_BF16_RMS_TOL = 2.0, 0.2


def family_plan(model, params, setting) -> dict:
    """The host plan of a quantize at ``setting`` through the family's
    adapter: the targets it quantizes ((r, c) each) and those it keeps
    dense (reason), the column groups (one vq_group_sweep and one vq_em
    launch each) and the size-weighted achieved bpv."""
    from repro_torch.core import adapters
    from repro_torch.core.bpv import effective_bpv, weighted_bpv
    from repro_torch.core.gptvq import plan_groups
    from repro_torch.core.recipe import DENSE_BITS

    quant, dense, sizes = {}, {}, []
    for blk in adapters.get_adapter(model, params).blocks():
        for spec in blk.targets():
            W = adapters.tree_get(blk.params(), spec.path)
            name = f"{blk.prefix}.{spec.name}"
            r, c = W.shape[-1], W.shape[-2]
            if spec.keep_dense:
                dense[name] = spec.keep_dense
                sizes.append((W.numel(), DENSE_BITS))
            else:
                quant[name] = (r, c)
                sizes.append((W.numel(), effective_bpv(setting, r, c)))
    groups = sum(c // plan_groups(r, c, setting)[0]
                 for r, c in quant.values())
    return {"quantized": quant, "dense": dense, "groups": groups,
            "bpv": weighted_bpv(sizes)}


def zero_counts() -> None:
    """Every kernel wrapper's launch counts to 0."""
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.paged_attention import paged_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul

    for fn in VQ_ENTRY_POINTS:
        getattr(vqa, fn).launches = 0
    for fn in (flash_attention, flash_attention_bwd, paged_attention,
               vq_dequant_matmul):
        fn.launches = 0
    flash_attention.launches_by_impl = {}
    flash_attention_bwd.launches_by_impl = {}
    vq_dequant_matmul.launches_by_impl = {}
    vq_dequant_matmul.launches_by_m = {}
    vq_dequant_matmul.launches_by_experts = {}


def to_f32(tree):
    """An f32 copy of a params tree: dense leaves in f32, VQLinear leaves
    as they are."""
    import torch

    from repro_torch.core.vq_linear import VQLinear

    if isinstance(tree, dict):
        return {k: to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_f32(v) for v in tree]
    return tree if isinstance(tree, VQLinear) else tree.to(torch.float32)


def logit_diff(torch, a, b) -> tuple:
    d = (a - b).float()
    return float(d.abs().max()), float(d.pow(2).mean().sqrt())


def text_ppl(torch, logits, tokens) -> float:
    """train/loss.perplexity's number from logits already computed: the
    last S positions (the text's, after any patches)."""
    from repro_torch.train.loss import next_token_loss

    lg = logits[:, -tokens.shape[1]:].float()
    return float(torch.exp(next_token_loss(lg, tokens, z_loss=0.0)[1]["nll"]))


def solo_tokens(torch, dev, model, qparams, prompts, n_new, rid0=100):
    """Each prompt served alone on a fresh engine (the serve runs' own
    settings)."""
    from repro_torch.serve.engine import Engine, Request

    out = []
    for i, p in enumerate(prompts):
        e = Engine(model, qparams, max_batch=SERVE_MAX_BATCH,
                   max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                   paged_attn_impl="fused", vq_matmul_impl="fused",
                   device=dev)
        r = Request(rid=rid0 + i, prompt=p, max_new_tokens=n_new)
        e.run([r])
        out.append(r.out_tokens)
    return out


def phase_vlm(torch, dev, calib, long_heldout) -> dict:
    """The vlm family at Phi-3-vision-4.2B's full width, 2 layers: see the
    module docstring."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = ARCHS[VLM_ARCH].scaled(n_layers=VLM_LAYERS)
    n_img = cfg.n_image_tokens
    log(f"[vlm] {cfg.name}: d_model {cfg.d_model}, heads {cfg.n_heads} over "
        f"{cfg.n_kv_heads} kv x {cfg.hd}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, layers {cfg.n_layers}, dtype {cfg.dtype}; text "
        f"calibration {tuple(calib.shape)}; heldout {VLM_HELDOUT} x ({n_img} "
        f"patches + {VLM_TEXT} text tokens)")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    text = long_heldout[:VLM_HELDOUT, :VLM_TEXT].contiguous()
    g = torch.Generator(device=dev).manual_seed(1)
    patches = torch.randn((VLM_HELDOUT, n_img, cfg.d_model), generator=g,
                          device=dev) * 0.1
    batch = {"tokens": text, "patches": patches}
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    setting = PAPER_SETTINGS["2.25bpv_2d"]
    recipe = QuantRecipe.uniform(setting, name="2.25bpv_2d"
                                 ).with_quantize_overrides(
                                     em_iters=25, codebook_update_iters=10)
    plan = family_plan(model, params, setting)
    # flash: every attention over > 2048 tokens. Per layer the fp
    # evaluation, the capture (one calibration chunk), the fused and the
    # gather evaluations and the dense-cache prefill on tensor cores (bf16
    # q, k, v); the advance pass on the FP32 kernel (f32-dequantized
    # weights, as the reference's adapters/transformer.advance)
    want_flash = {"tc": 5 * cfg.n_layers, "fp32": cfg.n_layers}
    log(f"[vlm] host plan: {len(plan['quantized'])} targets, "
        f"vq_group_sweep and vq_em {plan['groups']} launches each "
        f"(predict_groups {predict_groups(cfg)}), vq_assign 0; achieved bpv "
        f"{plan['bpv']:.6f}; flash_attention by variant {want_flash}")

    zero_counts()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, text, batch_extra={"patches": patches})
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[vlm]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    quant_launches = {fn: getattr(vqa, fn).launches
                      for fn in VQ_ENTRY_POINTS}
    del params

    fused = vql_mod.prepare_fused_tree(qparams)
    B, S = VLM_HELDOUT, n_img + VLM_TEXT
    # the fused evaluation, then the dense-cache prefill of the patches and
    # VLM_PREFILL text tokens, then one decode step
    P = n_img + VLM_PREFILL
    want_eval = {}
    for m in (B * S, B * P, B):
        for k, v in predict_matmul_impls(fused, m, torch.bfloat16).items():
            want_eval[k] = want_eval.get(k, 0) + v
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        lf = model.forward(fused, batch)[0]
        torch.cuda.synchronize()
        t["eval_fused"] = time.perf_counter() - t0
        ppl_vq = text_ppl(torch, lf, text)
        t0 = time.perf_counter()
        cache = model.init_cache(B, P + 1, dtype=torch.bfloat16, device=dev)
        _, cache, _ = model.forward(
            fused, {"tokens": text[:, :VLM_PREFILL], "patches": patches},
            cache=cache, pos=0, last_only=True)
        ld = model.forward(
            fused, {"tokens": text[:, VLM_PREFILL:VLM_PREFILL + 1]},
            cache=cache, pos=P)[0]
        torch.cuda.synchronize()
        t["prefill_decode"] = time.perf_counter() - t0
        del cache
        eval_launches = {"launches": vq_dequant_matmul.launches,
                         "by_impl": dict(vq_dequant_matmul.launches_by_impl)}
        dec_diff = logit_diff(torch, ld[:, 0], lf[:, P])
        lg = model.forward(qparams, batch)[0]
    diffs = logit_diff(torch, lf, lg)
    del lg
    flash = {"launches": flash_attention.launches,
             "by_impl": dict(flash_attention.launches_by_impl)}
    log(f"[vlm] fused vs gather logits {tuple(lf.shape)}: max |diff| "
        f"{diffs[0]:.4e} (tol {FUSED_MAX_TOL}), RMS {diffs[1]:.4e} (tol "
        f"{FUSED_RMS_TOL})")
    log(f"[vlm] dense-cache prefill of {n_img} patches + {VLM_PREFILL} "
        f"tokens, then one decode step, vs the full forward's row {P}: max "
        f"|diff| {dec_diff[0]:.4e} (tol {SERVE_MAX_TOL}), RMS "
        f"{dec_diff[1]:.4e} (tol {SERVE_RMS_TOL})")

    # text-only serving (the engine passes no patches, as the reference's)
    t0 = time.perf_counter()
    run = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                    SERVE_NEW)
    eng = run.pop("engine")
    want_serve = predict_serve(run, cfg.n_layers, "vlm run")
    tf_diffs, agree, _ = teacher_forced(torch, dev, model, run, eng,
                                        "vlm run")
    solo = solo_tokens(torch, dev, model, qparams, run["prompts"], SERVE_NEW)
    solo_same = [a == b for a, b in zip(solo, run["out"])]
    log(f"[vlm] solo vs interleaved tokens identical: {solo_same}")
    vq2 = serve_run(torch, dev, model, qparams, "vq2", *VLM_VQ2)
    e2 = vq2.pop("engine")
    prompt, out = run["prompts"][0], run["out"][0]
    n_forced = VLM_VQ2[1] - 1
    with torch.no_grad():
        ref = forced_logits(torch, dev, model, eng, prompt, out[:n_forced],
                            "fused")
        got = forced_logits(torch, dev, model, e2, prompt, out[:n_forced],
                            "fused")
    vq2["drift"] = logit_diff(torch, got, ref)
    vq2["finite"] = bool(torch.isfinite(got).all())
    log(f"[vlm] kv=vq2: teacher-forced drift vs f32 pages on request 0 "
        f"({n_forced + 1} steps): max {vq2['drift'][0]:.4e}, RMS "
        f"{vq2['drift'][1]:.4e}, finite {vq2['finite']}; launches at engine "
        f"load {vq2['load_launches']}")
    t["serve"] = time.perf_counter() - t0
    del eng, e2

    peak = torch.cuda.max_memory_allocated()
    log(f"[vlm] ppl (text positions) fp={ppl_fp:.3f} vq={ppl_vq:.3f} | "
        f"recon err={rep.total_error():.4f} | achieved "
        f"{rep.achieved_bpv:.6f} bpv (host plan {plan['bpv']:.6f})")
    log("[vlm] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[vlm] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[vlm] quantize launches {quant_launches}; flash_attention "
        f"{flash} (predicted by variant {want_flash}); evaluation, prefill "
        f"and decode matmuls {eval_launches} (predicted {want_eval})")
    log(f"[vlm] max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits shape": tuple(lf.shape) == (B, S, cfg.padded_vocab),
        "logits finite": bool(torch.isfinite(lf).all()),
        "fused vs gather": (diffs[0] <= FUSED_MAX_TOL
                            and diffs[1] <= FUSED_RMS_TOL),
        "prefill + decode vs the full forward": within_bars(dec_diff),
        "bpv == host plan": abs(rep.achieved_bpv - plan["bpv"]) < 1e-9,
        "column groups == predict_groups": plan["groups"]
            == predict_groups(cfg),
        **quantize_launch_checks(quant_launches, plan["groups"]),
        "flash_attention launches by variant as planned":
            flash["by_impl"] == want_flash
            and flash["launches"] == sum(want_flash.values()),
        "evaluation matmuls by variant as planned":
            eval_launches["by_impl"] == want_eval
            and eval_launches["launches"] == sum(want_eval.values()),
        **serve_run_checks(run, want_serve, SERVE_NEW, "serve"),
        "serve: teacher-forced kernel vs gather decode": within_bars(
            tf_diffs["gather decode"]),
        "serve: teacher-forced kernel vs cache-free": within_bars(
            tf_diffs["cache-free forward"]),
        "serve: solo == interleaved tokens": all(solo_same),
        "vq2: finished": all(len(o) == VLM_VQ2[1] for o in vq2["out"]),
        "vq2: paged_attention every decode tick":
            vq2["launches"]["paged_attention"]
            == vq2["decode_ticks"] * cfg.n_layers > 0,
        "vq2: launches at engine load": vq2["load_launches"] == {
            "vq_assign": 0, "vq_group_sweep": 0, "vq_em": 2 * cfg.n_layers},
        "vq2: logits finite": vq2["finite"],
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"vlm phase checks failed: {bad}")
    for r in (run, vq2):
        r.pop("prompts")
        r["out"] = r["out"][:2]
    want_serve.pop("chunks")
    return {"launches": quant_launches, "predicted_column_groups":
            plan["groups"], "flash": flash, "predicted_flash": want_flash,
            "eval_launches": eval_launches, "predicted_eval": want_eval,
            "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv, "predicted_bpv": plan["bpv"],
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "fused_vs_gather": diffs, "prefill_decode_vs_full": dec_diff,
            "serve": run, "serve_predicted": want_serve,
            "serve_teacher_forced": tf_diffs, "greedy_agree": agree,
            "solo_equal": solo_same, "vq2": vq2,
            "max_memory_allocated": peak,
            "phase_seconds": time.perf_counter() - t_phase}


def time_recurrences(torch, dev, cfg, params) -> dict:
    """The two recurrences alone on the card, at a decode tick (B =
    max_batch, one step) and a 64-token prefill chunk (B = 1): the mLSTM
    core (models/xlstm._mlstm_core) on random q/k/v and gates at layer 0's
    widths, and slstm_apply (its four input projections and the loop) with
    an sLSTM layer's weights, each from its reset state."""
    from repro_torch.models import xlstm

    d_inner, H, hd = xlstm._mlstm_dims(cfg)
    sl = params["layers"][cfg.slstm_layers[0]]["core"]
    g = torch.Generator(device=dev).manual_seed(2)
    out = {}
    for B, S in ((SERVE_MAX_BATCH, 1), (1, SERVE_PREFILL_CHUNK)):
        qkv = [torch.randn((B, S, H, hd), generator=g, device=dev).to(
            torch.bfloat16) for _ in range(3)]
        gates = [torch.randn((B, S, H), generator=g, device=dev)
                 for _ in range(2)]
        st = xlstm.mlstm_cache(cfg, B, dev)
        x = torch.randn((B, S, cfg.d_model), generator=g, device=dev).to(
            torch.bfloat16)
        sc = xlstm.slstm_cache(cfg, B, dev)
        with torch.no_grad():
            ms_m = time_ms(torch, lambda: xlstm._mlstm_core(*qkv, *gates, st))
            ms_s = time_ms(torch, lambda: xlstm.slstm_apply(sl, cfg, x, sc))
        out[f"B={B} S={S}"] = {"mlstm_core_ms": ms_m, "slstm_apply_ms": ms_s}
        log(f"[ssm] recurrences at B={B} S={S}: mLSTM core {ms_m:.4f} ms, "
            f"sLSTM block core {ms_s:.4f} ms")
    return out


def predict_family_serve(run: dict, fused, attn_per_tick: int = 0,
                         tag: str = "ssm", impls_at=None,
                         pad: bool = False) -> dict:
    """Launch counts of a family's serve run from the host plan:
    ``attn_per_tick`` paged_attention launches a decode tick (the ssm has
    no attention leaves; the hybrid one a group, audio one a decoder
    layer); ``impls_at(m)``, the packed leaves one forward of m rows runs
    by variant (default: every packed leaf of the layers or the hybrid's
    trunk), once a forward, the decode ticks at M = max_batch, the prefill
    chunks at the prompts' exact power-of-two pieces (the engine pads no
    recurrent prompt) or, with ``pad``, at their padded buckets."""
    import torch

    if impls_at is None:
        impls_at = lambda m: predict_matmul_impls(fused, m, torch.bfloat16)
    chunks = prefill_chunk_ms(run["prompts"], pad=pad)
    per_fwd = sum(impls_at(SERVE_MAX_BATCH).values())
    impls: dict = {}
    for m, times in [(SERVE_MAX_BATCH, run["decode_ticks"])] + [
            (m, 1) for m in chunks]:
        for k, v in impls_at(m).items():
            impls[k] = impls.get(k, 0) + v * times
    want = {"paged_attention": attn_per_tick * run["decode_ticks"],
            "vq_dequant_matmul": per_fwd * (run["decode_ticks"]
                                            + len(chunks)),
            "at_m4": per_fwd * (run["decode_ticks"] + chunks.count(
                SERVE_MAX_BATCH)), "by_impl": impls,
            "chunks": chunks, "per_forward": per_fwd}
    log(f"[{tag}] serve predicted launches: paged_attention "
        f"{want['paged_attention']}; "
        f"vq_dequant_matmul = {per_fwd} x forwards = "
        f"{want['vq_dequant_matmul']}, of them {want['at_m4']} at M = "
        f"{SERVE_MAX_BATCH}; prefill chunks {len(chunks)} "
        f"(sizes {sorted(set(chunks))}); by variant {impls}")
    return want


def slot_state_serve(torch, dev, model, qparams, run: dict, eng, tag: str,
                     predict, attn_layers: int = 0,
                     low_pages=None) -> tuple[dict, dict]:
    """The serve checks of a family whose cache holds slot state (ssm,
    hybrid, audio), after ``run`` on ``eng``: the run's launches held to
    ``predict(run, fused params, tag)``; each prompt served alone gives the
    interleaved tokens; under a pool of 6 pages a slot where a request
    needs up to 9, the youngest is evicted, replayed from a reset slot, and
    every request's tokens are the unpressured run's; the prefix cache is
    asked for and left off. With ``low_pages`` (requests, new tokens): a
    run on int8 pages and one on vq2 pages, each held to the plan (the vq2
    engine's load fits a K and a V codebook for each of the
    ``attn_layers``), and request 0's served tokens teacher-forced through
    each against the f32 pages (drift, finite). Trims the runs for the
    JSON; returns (results, checks)."""
    from repro_torch.serve.engine import Engine, Request

    secs = {}
    want = predict(run, eng.params, tag)
    checks = serve_run_checks(run, want, SERVE_NEW, "serve")
    t0 = time.perf_counter()
    solo = solo_tokens(torch, dev, model, qparams, run["prompts"], SERVE_NEW)
    solo_same = [a == b for a, b in zip(solo, run["out"])]
    log(f"[{tag}] solo vs interleaved tokens identical: {solo_same}")
    tight = Engine(model, qparams, max_batch=SERVE_MAX_BATCH,
                   max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                   num_blocks=6 * SERVE_MAX_BATCH + 1,
                   paged_attn_impl="fused", vq_matmul_impl="fused",
                   device=dev)
    reqs = [Request(rid=200 + i, prompt=p, max_new_tokens=SERVE_NEW)
            for i, p in enumerate(run["prompts"])]
    tight.run(reqs)
    preempt = {"preemptions": tight.stats["preemptions"],
               "tokens_equal": [r.out_tokens == o
                                for r, o in zip(reqs, run["out"])]}
    log(f"[{tag}] preemption replay: {preempt['preemptions']} preemptions, "
        f"tokens equal to the unpressured run: {preempt['tokens_equal']}")
    prefix_inert = Engine(model, qparams, max_batch=SERVE_MAX_BATCH,
                          max_len=SERVE_MAX_LEN, page_size=SERVE_PAGE,
                          prefix_cache=True, device=dev).prefix_cache is None
    log(f"[{tag}] prefix cache asked for and left off (slot-resident "
        f"state): {prefix_inert}")
    secs["solo_preempt"] = time.perf_counter() - t0
    del tight
    checks.update({
        "serve: solo == interleaved tokens": all(solo_same),
        "serve: preemption replayed identically": preempt["preemptions"] > 0
            and all(preempt["tokens_equal"]),
        "serve: prefix cache inert": prefix_inert})
    res = {"serve": run, "serve_predicted": want, "solo_equal": solo_same,
           "preemption": preempt, "prefix_inert": prefix_inert,
           "seconds": secs}
    if low_pages is not None:
        t0 = time.perf_counter()
        low = {}
        prompt, out = run["prompts"][0], run["out"][0]
        n_forced = low_pages[1] - 1
        for bits in (8, "vq2"):
            r = serve_run(torch, dev, model, qparams, bits, *low_pages)
            e = r.pop("engine")
            w = r["predicted"] = predict(r, e.params, f"{tag} kv={bits}")
            with torch.no_grad():
                ref = forced_logits(torch, dev, model, eng, prompt,
                                    out[:n_forced], "fused")
                got = forced_logits(torch, dev, model, e, prompt,
                                    out[:n_forced], "fused")
            r["drift"] = logit_diff(torch, got, ref)
            r["finite"] = bool(torch.isfinite(got).all())
            log(f"[{tag}] kv={bits}: teacher-forced drift vs f32 pages on "
                f"request 0 ({n_forced + 1} steps): max "
                f"{r['drift'][0]:.4e}, RMS {r['drift'][1]:.4e}, finite "
                f"{r['finite']}; launches at engine load "
                f"{r['load_launches']}")
            checks.update({
                **serve_run_checks(r, w, low_pages[1], f"kv={bits}"),
                f"kv={bits}: launches at engine load": r["load_launches"]
                    == {"vq_assign": 0, "vq_group_sweep": 0,
                        "vq_em": 2 * attn_layers if bits == "vq2" else 0},
                f"kv={bits}: logits finite": r["finite"]})
            r.pop("prompts")
            r["out"] = r["out"][:2]
            w.pop("chunks")
            low[str(bits)] = r
            del e
        res["low_bit_pages"] = low
        secs["int8_vq2"] = time.perf_counter() - t0
    run.pop("prompts")
    run["out"] = run["out"][:2]
    want.pop("chunks")
    return res, checks


def phase_ssm(torch, dev) -> dict:
    """The ssm family at xLSTM-125M's full width and depth: see the module
    docstring."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import adapters
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = ARCHS[SSM_ARCH]
    log(f"[ssm] {cfg.name}: d_model {cfg.d_model}, {cfg.n_heads} heads, "
        f"sLSTM at layers {tuple(cfg.slstm_layers)} of {cfg.n_layers}, vocab "
        f"{cfg.vocab_size} (tied), dtype {cfg.dtype}; calibration "
        f"{SSM_CALIB}, heldout {SSM_HELDOUT}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=SSM_CALIB[0],
                               seq_len=SSM_CALIB[1], device=dev)
    heldout = calibration_tokens(cfg.vocab_size, n_sequences=SSM_HELDOUT[0],
                                 seq_len=SSM_HELDOUT[1], seed=777,
                                 device=dev)
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    setting = PAPER_SETTINGS["2.25bpv_2d"]
    recipe = QuantRecipe.uniform(setting, name="2.25bpv_2d"
                                 ).with_quantize_overrides(
                                     em_iters=25, codebook_update_iters=10)
    plan = family_plan(model, params, setting)
    log(f"[ssm] host plan: {len(plan['quantized'])} targets quantized, "
        f"{len(plan['dense'])} kept dense, vq_group_sweep and vq_em "
        f"{plan['groups']} launches each, vq_assign 0; achieved bpv "
        f"{plan['bpv']:.6f}; {model_zoo.count_params(model) / 1e6:.1f} M "
        "parameters")
    recurrences = time_recurrences(torch, dev, cfg, params)

    zero_counts()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[ssm]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    quant_launches = {fn: getattr(vqa, fn).launches
                      for fn in VQ_ENTRY_POINTS}
    # the keep-dense targets: reported with their reasons, and left as the
    # same tensors (no vq_* launch touched them: the launches above are the
    # quantized targets' column groups exactly)
    kept = {name: rep.per_target[name].get("reason")
            for name in plan["dense"]}
    kept_same = all(
        torch.equal(adapters.tree_get(qparams, path), adapters.tree_get(
            params, path))
        for path in (("layers", int(n.split(".")[1]), *n.split(".")[2:])
                     for n in plan["dense"]))

    fused = vql_mod.prepare_fused_tree(qparams)
    B, S = SSM_HELDOUT
    want_eval = predict_matmul_impls(fused, B * S, torch.bfloat16)
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        lf = model.forward(fused, {"tokens": heldout})[0]
        torch.cuda.synchronize()
        t["eval_fused"] = time.perf_counter() - t0
        eval_launches = {"launches": vq_dequant_matmul.launches,
                         "by_impl": dict(vq_dequant_matmul.launches_by_impl)}
        lg = model.forward(qparams, {"tokens": heldout})[0]
    ppl_vq = text_ppl(torch, lf, heldout)
    diffs = logit_diff(torch, lf, lg)
    windows = {f"{lo}-{hi}": logit_diff(torch, lf[:, lo:hi], lg[:, lo:hi])
               for lo, hi in ((0, 16), (16, 64), (64, S)) if lo < S}
    del lg
    # the f32 copy: the same packed leaves (the fused form on the fp32
    # variant, the gather form dequantized to f32), where no activation or
    # W is rounded to bf16; and the model's own sensitivity to the bf16
    # rounding of the dequantized W, which sets the bf16 comparisons' bars
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    q32 = to_f32(qparams)
    with torch.no_grad():
        lg32 = model32.forward(q32, {"tokens": heldout})[0]
        f32_diffs = logit_diff(
            torch, model32.forward(vql_mod.prepare_fused_tree(q32),
                                   {"tokens": heldout})[0], lg32)
        rounded = to_f32(vql_mod.dequant_tree(q32, torch.bfloat16))
        sens = logit_diff(torch, model32.forward(
            rounded, {"tokens": heldout})[0], lg32)
        del lg32, rounded
    bars = (SSM_BF16_MAX_TOL, SSM_BF16_RMS_TOL)
    log(f"[ssm] f32 copy, fused vs gather logits: max |diff| "
        f"{f32_diffs[0]:.4e} (tol {FUSED_MAX_TOL}), RMS {f32_diffs[1]:.4e} "
        f"(tol {FUSED_RMS_TOL})")
    log(f"[ssm] sensitivity: the f32 copy with the dequantized W exact "
        f"against rounded to bf16: max {sens[0]:.4e}, RMS {sens[1]:.4e}")
    log(f"[ssm] bf16 fused vs gather logits {tuple(lf.shape)}: max |diff| "
        f"{diffs[0]:.4e} (tol {bars[0]}), RMS {diffs[1]:.4e} (tol "
        f"{bars[1]}); by positions "
        + ", ".join(f"{k}: {v[0]:.4e} / {v[1]:.4e}"
                    for k, v in windows.items()))

    t0 = time.perf_counter()
    run = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                    SERVE_NEW)
    eng = run.pop("engine")
    t["serve"] = time.perf_counter() - t0
    prompt, out = run["prompts"][0], run["out"][0]
    forced = out[:-1]
    seq = torch.as_tensor(np.concatenate([prompt, forced]), device=dev)
    # request 0's served path, teacher-forced: the fused decode against the
    # gather decode and the cache-free forward, in the bf16 model (the
    # bars above) and in its f32 copy (the serve bars)
    fused32 = vql_mod.prepare_fused_tree(q32)
    tf_diffs = {}
    with torch.no_grad():
        for tag, mdl, fused_p, gather_p in (("bf16", model, eng.params,
                                             qparams),
                                            ("f32", model32, fused32, q32)):
            tf_kernel = forced_logits(torch, dev, mdl, eng, prompt, forced,
                                      "gather", params=fused_p)
            tf_gather = forced_logits(torch, dev, mdl, eng, prompt, forced,
                                      "gather", params=gather_p)
            free = mdl.forward(fused_p, {"tokens": seq[None]})[0][0][
                len(prompt) - 1:]
            for name, other in (("gather decode", tf_gather),
                                ("cache-free forward", free)):
                d = tf_diffs[f"{tag} {name}"] = logit_diff(torch, tf_kernel,
                                                           other)
                tol = bars if tag == "bf16" else (SERVE_MAX_TOL,
                                                  SERVE_RMS_TOL)
                log(f"[ssm] serve, {tag}: teacher-forced fused decode vs "
                    f"{name}, {tuple(tf_kernel.shape)} logits: max |diff| "
                    f"{d[0]:.4e} (tol {tol[0]:.4e}), RMS {d[1]:.4e} (tol "
                    f"{tol[1]:.4e})")
    del q32, fused32
    tail, tail_checks = slot_state_serve(
        torch, dev, model, qparams, run, eng, "ssm",
        lambda r, f, tag: predict_family_serve(r, f, tag=tag))
    t.update(tail.pop("seconds"))
    del eng

    peak = torch.cuda.max_memory_allocated()
    log(f"[ssm] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.6f} bpv "
        f"(host plan {plan['bpv']:.6f}) | kept dense {len(kept)}: reasons "
        f"{sorted(set(kept.values()))}")
    log("[ssm] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[ssm] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[ssm] quantize launches {quant_launches} (predicted "
        f"vq_group_sweep and vq_em {plan['groups']} each, vq_assign 0); "
        f"evaluation matmuls {eval_launches} (predicted {want_eval})")
    log(f"[ssm] max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits shape": tuple(lf.shape) == (B, S, cfg.padded_vocab),
        "logits finite": bool(torch.isfinite(lf).all()),
        "f32 copy: fused vs gather": (f32_diffs[0] <= FUSED_MAX_TOL
                                      and f32_diffs[1] <= FUSED_RMS_TOL),
        "bf16: fused vs gather within the ssm bf16 bars":
            diffs[0] <= bars[0] and diffs[1] <= bars[1],
        "bpv == host plan": abs(rep.achieved_bpv - plan["bpv"]) < 1e-9,
        **quantize_launch_checks(quant_launches, plan["groups"]),
        "keep-dense targets reported with their reasons":
            kept == plan["dense"] and len(kept) > 0,
        "keep-dense leaves untouched": kept_same,
        "evaluation: one launch a packed leaf by variant as planned":
            eval_launches["by_impl"] == want_eval
            and eval_launches["launches"] == sum(want_eval.values()),
        **tail_checks,
        **{f"serve, f32: teacher-forced fused decode vs {name}": within_bars(
            tf_diffs[f"f32 {name}"])
           for name in ("gather decode", "cache-free forward")},
        **{f"serve, bf16: teacher-forced fused decode vs {name}":
           tf_diffs[f"bf16 {name}"][0] <= bars[0]
           and tf_diffs[f"bf16 {name}"][1] <= bars[1]
           for name in ("gather decode", "cache-free forward")},
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"ssm phase checks failed: {bad}")
    return {"launches": quant_launches, "predicted_column_groups":
            plan["groups"], "eval_launches": eval_launches,
            "predicted_eval": want_eval, "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv, "predicted_bpv": plan["bpv"],
            "kept_dense": kept, "stage_seconds": rep.stage_seconds,
            "seconds": t, "fused_vs_gather": diffs,
            "fused_vs_gather_by_position": windows,
            "f32_fused_vs_gather": f32_diffs, "sensitivity": sens,
            "bf16_bars": bars, **tail, "serve_teacher_forced": tf_diffs,
            "recurrences": recurrences,
            "max_memory_allocated": peak,
            "phase_seconds": time.perf_counter() - t_phase}


# the hybrid phase: Zamba2-7B at full width, 12 of its 78 Mamba layers (2
# groups of 6: one group would never run a second LoRA slice or a second
# shared-attention KV stack), calibrated on the long phase's 4 x 4096
# tokens and evaluated on 2 x 4096 held-out ones; the int8 and vq2 page
# engines' (requests, new tokens)
HYBRID_ARCH, HYBRID_LAYERS = "zamba2-7b", 12
HYBRID_HELDOUT = 2
HYBRID_QUANT_PAGES = (4, 32)
# the LoRA B factors start at zeros (the reference's init), where a wrong
# group slice adds nothing and goes unseen: the phase draws them from this
# numpy seed with this std instead
HYBRID_LORA_SEED, HYBRID_LORA_STD = 0, 0.02
# the bf16 comparisons. Fused vs gather logits: main's bars (the first
# reading on the H100, 0.148 max / 0.024 RMS, holds them). The served
# path's teacher-forced kernel decode vs the gather decode and vs the
# cache-free forward: twice the first readings (max 0.147, RMS 0.0293 vs
# the cache-free forward; 0.102 / 0.0177 vs the gather decode, where only
# the attention's rounding differs). The 12 Mamba layers carry a bf16
# rounding of one step's residual stream on in their f32 state, so the
# serve bars cannot hold in bf16; the f32 copy of the same path reads
# 1e-5 and is held to the serve bars, and a wrong page, group slice or
# state moves logits O(1) (PERF.md, section 6)
HYBRID_BF16_BARS = (FUSED_MAX_TOL, FUSED_RMS_TOL)
HYBRID_BF16_SERVE_BARS = (0.3, 0.06)


def seed_lora_b(torch, params, seed: int = HYBRID_LORA_SEED) -> None:
    """Every LoRA B factor (n_groups, r, dim) drawn from
    N(0, HYBRID_LORA_STD^2) with numpy's ``seed``, in place of the
    reference's zeros."""
    rng = np.random.default_rng(seed)
    for name in ("q", "k", "v"):
        B = params["lora"][name]["B"]
        draw = rng.standard_normal(tuple(B.shape)).astype(np.float32)
        params["lora"][name]["B"] = torch.from_numpy(
            draw * HYBRID_LORA_STD).to(B.device, B.dtype)


def hybrid_targets(cfg) -> list:
    """The reference adapter's targets in its order: the shared block's
    q/k/v/o, then each Mamba layer's in_proj and out_proj."""
    n_groups, per = cfg.n_layers // cfg.shared_attn_every, \
        cfg.shared_attn_every
    return ([f"shared.attn.{w}" for w in ("wq", "wk", "wv", "wo")]
            + [f"mamba.{g}.{j}.mixer.{w}" for g in range(n_groups)
               for j in range(per) for w in ("in_proj", "out_proj")])


def hybrid_dense_leaves(params) -> dict:
    """The leaves the quantizer leaves dense: the LoRA factors, the shared
    norm, every layer's norm and its conv and scan parameters."""
    out = {f"lora.{n}.{f}": params["lora"][n][f]
           for n in ("q", "k", "v") for f in ("A", "B")}
    out["shared.norm"] = params["shared"]["norm"]
    for g, grp in enumerate(params["mamba"]):
        for j, lp in enumerate(grp):
            out[f"mamba.{g}.{j}.norm"] = lp["norm"]
            for w in ("conv_w", "conv_b", "A_log", "dt_bias", "D_skip",
                      "norm_scale"):
                out[f"mamba.{g}.{j}.mixer.{w}"] = lp["mixer"][w]
    return out


def time_ssd(torch, dev, cfg, params) -> dict:
    """The Mamba2 scan alone on the card (plain PyTorch, f32): the
    chunked SSD at a 64-token prefill chunk (B = 1) and at the
    calibration's 4 x 4096 tokens, on random inputs at Zamba2-7B's widths
    (112 heads of 64, state 64); and one decode step of layer 0's mixer
    up to out_proj (ssm.pre_out at B = max_batch, S = 1, its dense
    in_proj included) from a reset cache."""
    from repro_torch.models import ssm

    _, heads, _ = ssm._dims(cfg)
    hd, N = cfg.ssm_head_dim, cfg.ssm_state
    A = -torch.exp(params["mamba"][0][0]["mixer"]["A_log"])
    g = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for B, S in ((1, SERVE_PREFILL_CHUNK), (LONG_CALIB, LONG_SEQ)):
        xh = torch.randn((B, S, heads, hd), generator=g, device=dev)
        Bm, Cm = (torch.randn((B, S, N), generator=g, device=dev)
                  for _ in range(2))
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, heads), generator=g, device=dev) - 2)
        with torch.no_grad():
            ms = time_ms(torch, lambda: ssm._ssd_chunked(
                xh, Bm, Cm, dt, A, cfg.ssm_chunk), 5, 1)
        out[f"ssd B={B} S={S}"] = ms
        log(f"[hybrid] SSD scan at B={B} S={S}: {ms:.4f} ms a layer")
        del xh, Bm, Cm, dt
    lp = params["mamba"][0][0]
    x = torch.randn((SERVE_MAX_BATCH, 1, cfg.d_model), generator=g,
                    device=dev).to(torch.bfloat16)
    cache = ssm.init_cache(cfg, SERVE_MAX_BATCH, device=dev)
    with torch.no_grad():
        ms = time_ms(torch, lambda: ssm.pre_out(lp["mixer"], cfg, x, cache))
    out[f"decode step B={SERVE_MAX_BATCH}"] = ms
    log(f"[hybrid] Mamba2 decode step (pre_out, dense in_proj) at "
        f"B={SERVE_MAX_BATCH}: {ms:.4f} ms a layer")
    return out


def phase_hybrid(torch, dev, calib, long_heldout) -> dict:
    """The hybrid family at Zamba2-7B's full width, 12 Mamba layers in 2
    groups: see the module docstring."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import hybrid, model_zoo
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = ARCHS[HYBRID_ARCH].scaled(n_layers=HYBRID_LAYERS)
    n_groups = cfg.n_layers // cfg.shared_attn_every
    log(f"[hybrid] {cfg.name}: d_model {cfg.d_model}, shared attention "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv x {cfg.hd} (LoRA rank "
        f"{cfg.shared_attn_lora_rank}), Mamba2 d_inner "
        f"{cfg.ssm_expand * cfg.d_model}, state {cfg.ssm_state}, head dim "
        f"{cfg.ssm_head_dim}; {cfg.n_layers} Mamba layers in {n_groups} "
        f"groups of {cfg.shared_attn_every}; vocab {cfg.vocab_size}, dtype "
        f"{cfg.dtype}; calibration {tuple(calib.shape)}, heldout "
        f"{HYBRID_HELDOUT} x {LONG_SEQ}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    seed_lora_b(torch, params)
    heldout = long_heldout[:HYBRID_HELDOUT].contiguous()
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    setting = PAPER_SETTINGS["2.25bpv_2d"]
    recipe = QuantRecipe.uniform(setting, name="2.25bpv_2d"
                                 ).with_quantize_overrides(
                                     em_iters=25, codebook_update_iters=10)
    plan = family_plan(model, params, setting)
    targets = hybrid_targets(cfg)
    # flash: every shared-attention invocation over > 2048 tokens. The fp
    # evaluation, the capture of the shared block (the unquantized trunk
    # replayed) and the fused and gather evaluations on tensor cores (bf16
    # q, k, v); each group-entry capture on the FP32 kernel (the shared
    # block dequantized to f32, as the reference's adapter) and the f32
    # copy's three evaluations too
    want_quant_flash = {"tc": n_groups, "fp32": n_groups}
    want_flash = {"tc": 4 * n_groups, "fp32": 4 * n_groups}
    log(f"[hybrid] host plan: {len(plan['quantized'])} targets (the "
        f"reference adapter's {len(targets)}), {len(plan['dense'])} kept "
        f"dense by the adapter, vq_group_sweep and vq_em {plan['groups']} "
        f"launches each, vq_assign 0; achieved bpv {plan['bpv']:.6f}; "
        f"flash_attention by variant {want_flash} (the quantize's "
        f"{want_quant_flash}); {model_zoo.count_params(model) / 1e9:.3f} B "
        "parameters")
    parts = time_ssd(torch, dev, cfg, params)
    dense_leaves = hybrid_dense_leaves(params)

    zero_counts()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout)
    t["ppl_fp"] = time.perf_counter() - t0
    flash_before = dict(flash_attention.launches_by_impl)
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[hybrid]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    quant_launches = {fn: getattr(vqa, fn).launches
                      for fn in VQ_ENTRY_POINTS}
    quant_flash = impl_delta(flash_before, flash_attention.launches_by_impl)
    del params
    quantized = [k for k, e in rep.per_target.items()
                 if e["action"] == "quantize"]
    packed = all(isinstance(leaf, vql_mod.VQLinear) for leaf in (
            [qparams["shared"]["attn"][w] for w in ("wq", "wk", "wv", "wo")]
            + [lp["mixer"][w] for grp in qparams["mamba"] for lp in grp
               for w in ("in_proj", "out_proj")]))
    dense_same = all(torch.equal(a, b) for a, b in zip(
        dense_leaves.values(), hybrid_dense_leaves(qparams).values()))

    fused = vql_mod.prepare_fused_tree(qparams)
    B, S = heldout.shape
    want_eval = predict_matmul_impls(fused, B * S, torch.bfloat16)
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        lf = model.forward(fused, {"tokens": heldout})[0]
        torch.cuda.synchronize()
        t["eval_fused"] = time.perf_counter() - t0
        eval_launches = {"launches": vq_dequant_matmul.launches,
                         "by_impl": dict(vq_dequant_matmul.launches_by_impl)}
        lg = model.forward(qparams, {"tokens": heldout})[0]
    ppl_vq = text_ppl(torch, lf, heldout)
    diffs = logit_diff(torch, lf, lg)
    windows = {f"{lo}-{hi}": logit_diff(torch, lf[:, lo:hi], lg[:, lo:hi])
               for lo, hi in ((0, 64), (64, 1024), (1024, S)) if lo < S}
    del lg
    # the f32 copy: the same packed leaves (the fused form on the fp32
    # variant, the gather form dequantized to f32), where no activation or
    # W is rounded to bf16; and the model's own sensitivity to the bf16
    # rounding of the dequantized W
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    q32 = to_f32(qparams)
    fused32 = vql_mod.prepare_fused_tree(q32)
    with torch.no_grad():
        lg32 = model32.forward(q32, {"tokens": heldout})[0]
        f32_diffs = logit_diff(
            torch, model32.forward(fused32, {"tokens": heldout})[0], lg32)
        rounded = to_f32(vql_mod.dequant_tree(q32, torch.bfloat16))
        sens = logit_diff(torch, model32.forward(
            rounded, {"tokens": heldout})[0], lg32)
        del lg32, rounded
    flash = {"launches": flash_attention.launches,
             "by_impl": dict(flash_attention.launches_by_impl)}
    bars = HYBRID_BF16_BARS
    log(f"[hybrid] bf16 fused vs gather logits {tuple(lf.shape)}: max "
        f"|diff| {diffs[0]:.4e} (tol {bars[0]}), RMS {diffs[1]:.4e} (tol "
        f"{bars[1]}); by positions "
        + ", ".join(f"{k}: {v[0]:.4e} / {v[1]:.4e}"
                    for k, v in windows.items()))
    log(f"[hybrid] f32 copy, fused vs gather logits: max |diff| "
        f"{f32_diffs[0]:.4e} (tol {FUSED_MAX_TOL}), RMS {f32_diffs[1]:.4e} "
        f"(tol {FUSED_RMS_TOL})")
    log(f"[hybrid] sensitivity: the f32 copy with the dequantized W exact "
        f"against rounded to bf16: max {sens[0]:.4e}, RMS {sens[1]:.4e}")
    del lf

    t0 = time.perf_counter()
    run = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                    SERVE_NEW)
    eng = run.pop("engine")
    t["serve"] = time.perf_counter() - t0

    # the shared block's densify alone: its four fused leaves decoded to
    # bf16 and each group's LoRA delta added, as every forward does
    def densify():
        top = {k: v for k, v in eng.params.items() if k != "mamba"}
        d = vql_mod.dequant_tree(top, torch.bfloat16, densify_fused=True)
        for g in range(n_groups):
            hybrid.lora_attn_params(d["shared"],
                                    hybrid.lora_group(d["lora"], g), cfg)

    with torch.no_grad():
        densify_ms = time_ms(torch, densify)
    itl_ms = run["itl_median_s"] * 1e3
    log(f"[hybrid] densify of the shared block a forward: {densify_ms:.4f} "
        f"ms, {100 * densify_ms / itl_ms:.1f}% of the median ITL "
        f"{itl_ms:.3f} ms")

    # request 0's served path, teacher-forced: the kernel decode against
    # the gather decode and the cache-free forward, in the bf16 model and
    # in its f32 copy (the serve bars)
    tf_diffs, agree, _ = teacher_forced(torch, dev, model, run, eng,
                                        "hybrid run")
    prompt, out = run["prompts"][0], run["out"][0]
    forced = out[:-1]
    seq = torch.as_tensor(np.concatenate([prompt, forced]), device=dev)
    with torch.no_grad():
        tf_kernel = forced_logits(torch, dev, model32, eng, prompt, forced,
                                  "fused", params=fused32)
        tf_gather = forced_logits(torch, dev, model32, eng, prompt, forced,
                                  "gather", params=fused32)
        free = model32.forward(fused32, {"tokens": seq[None]})[0][0][
            len(prompt) - 1:]
    for name, other in (("gather decode", tf_gather),
                        ("cache-free forward", free)):
        d = tf_diffs[f"f32 {name}"] = logit_diff(torch, tf_kernel, other)
        log(f"[hybrid] serve, f32 copy: teacher-forced kernel decode vs "
            f"{name}, {tuple(tf_kernel.shape)} logits: max |diff| "
            f"{d[0]:.4e} (tol {SERVE_MAX_TOL}), RMS {d[1]:.4e} (tol "
            f"{SERVE_RMS_TOL})")
    del q32, fused32, model32, tf_kernel, tf_gather, free
    tail, tail_checks = slot_state_serve(
        torch, dev, model, qparams, run, eng, "hybrid",
        lambda r, f, tag: predict_family_serve(r, f, n_groups, tag),
        n_groups, HYBRID_QUANT_PAGES)
    t.update(tail.pop("seconds"))
    del eng

    peak = torch.cuda.max_memory_allocated()
    log(f"[hybrid] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.6f} bpv "
        f"(host plan {plan['bpv']:.6f})")
    log("[hybrid] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[hybrid] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[hybrid] quantize launches {quant_launches} (predicted "
        f"vq_group_sweep and vq_em {plan['groups']} each, vq_assign 0), "
        f"flash_attention {quant_flash} (predicted {want_quant_flash}); "
        f"flash_attention in all {flash} (predicted {want_flash}); "
        f"evaluation matmuls {eval_launches} (predicted {want_eval})")
    log(f"[hybrid] max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    serve_bars = HYBRID_BF16_SERVE_BARS
    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits finite": math.isfinite(diffs[0]),
        "targets == the reference adapter's": quantized == targets
            == list(rep.per_target) and sorted(plan["quantized"])
            == sorted(targets) and not plan["dense"],
        "every target packed": packed,
        "LoRA, norms, conv and scan leaves untouched": dense_same,
        "bpv == host plan": abs(rep.achieved_bpv - plan["bpv"]) < 1e-9,
        **quantize_launch_checks(quant_launches, plan["groups"]),
        "quantize: flash_attention by variant as planned":
            quant_flash == want_quant_flash,
        "flash_attention launches by variant as planned":
            flash["by_impl"] == want_flash
            and flash["launches"] == sum(want_flash.values()),
        "evaluation: one launch a packed trunk leaf by variant as planned":
            eval_launches["by_impl"] == want_eval
            and eval_launches["launches"] == sum(want_eval.values()),
        "f32 copy: fused vs gather": (f32_diffs[0] <= FUSED_MAX_TOL
                                      and f32_diffs[1] <= FUSED_RMS_TOL),
        "bf16: fused vs gather": diffs[0] <= bars[0] and diffs[1] <= bars[1],
        **tail_checks,
        **{f"serve, f32 copy: teacher-forced kernel decode vs {name}":
           within_bars(tf_diffs[f"f32 {name}"])
           for name in ("gather decode", "cache-free forward")},
        **{f"serve, bf16: teacher-forced kernel decode vs {name}":
           tf_diffs[name][0] <= serve_bars[0]
           and tf_diffs[name][1] <= serve_bars[1]
           for name in ("gather decode", "cache-free forward")},
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"hybrid phase checks failed: {bad}")
    return {"launches": quant_launches, "predicted_column_groups":
            plan["groups"], "quant_flash": quant_flash,
            "predicted_quant_flash": want_quant_flash, "flash": flash,
            "predicted_flash": want_flash, "eval_launches": eval_launches,
            "predicted_eval": want_eval, "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv, "predicted_bpv": plan["bpv"],
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "fused_vs_gather": diffs, "fused_vs_gather_by_position": windows,
            "f32_fused_vs_gather": f32_diffs, "sensitivity": sens,
            "bf16_bars": bars, "bf16_serve_bars": serve_bars, **tail,
            "serve_teacher_forced": tf_diffs, "greedy_agree": agree,
            "ssd_ms": parts,
            "densify_ms": densify_ms, "itl_median_ms": itl_ms,
            "max_memory_allocated": peak,
            "phase_seconds": time.perf_counter() - t_phase}


# the audio phase: whisper-small at full width and depth (12 encoder + 12
# decoder layers, 12 heads of 64, 1,500 frames, tied vocab 51,865; bf16);
# calibration and heldout (sequences, decoder tokens). The heldout frames
# are the stub frontend's at their own chunk index, apart from the
# calibration chunks' (0 and 1)
AUDIO_ARCH = "whisper-small"
AUDIO_CALIB, AUDIO_HELDOUT = (16, 256), (8, 256)
AUDIO_HELDOUT_CHUNK = 1000
AUDIO_QUANT_PAGES = (4, 32)
# the encoder's rows in the heldout evaluation: 8 x 1,500 frames
AUDIO_ENC_ROWS = AUDIO_HELDOUT[0] * 1500
# the bf16 comparisons: main's bars for fused vs gather and the serve bars
# for the teacher-forced decode; the f32 copy is held to the same bars
AUDIO_BF16_BARS = (FUSED_MAX_TOL, FUSED_RMS_TOL)
AUDIO_BF16_SERVE_BARS = (SERVE_MAX_TOL, SERVE_RMS_TOL)


def audio_targets(cfg) -> list:
    """The reference adapter's targets in its order: each encoder layer's
    attn q/k/v/o and ffn w_in/w_out, then each decoder layer's self q/k/v/o,
    cross q/k/v/o and ffn w_in/w_out."""
    ffn = ["ffn.w_in", "ffn.w_out"]
    enc = [f"attn.{w}" for w in ("wq", "wk", "wv", "wo")] + ffn
    dec = ([f"self_attn.{w}" for w in ("wq", "wk", "wv", "wo")]
           + [f"cross_attn.{w}" for w in ("wq", "wk", "wv", "wo")] + ffn)
    return ([f"enc.{i}.{t}" for i in range(cfg.n_encoder_layers)
             for t in enc]
            + [f"dec.{i}.{t}" for i in range(cfg.n_layers) for t in dec])


def audio_matmul_impls(fused, m_dec: int, m_enc: int | None,
                       x_dtype) -> dict:
    """vq_dequant_matmul launches by variant for one audio forward: every
    packed decoder leaf at ``m_dec`` rows; with frames (``m_enc`` rows of
    memory) the encoder's leaves and the decoder's cross wk/wv at
    ``m_enc``; without (serving) neither runs."""
    pairs = []
    if m_enc is not None:
        pairs += [(leaf, m_enc) for lp in fused["enc_layers"]
                  for leaf in tree_leaves(lp)]
    for lp in fused["dec_layers"]:
        for name, sub in lp.items():
            if not isinstance(sub, dict):
                continue
            for w, leaf in sub.items():
                if name == "cross_attn" and w in ("wk", "wv"):
                    if m_enc is not None:
                        pairs.append((leaf, m_enc))
                else:
                    pairs.append((leaf, m_dec))
    return count_impls(pairs, x_dtype)


def dense_prefill_logits(torch, dev, model, params, prompt, forced):
    """The teacher-forced rows of one dense-``KVCache`` prefill of prompt +
    forced tokens (f32 cache, its cross K/V the zeros the engine's slots
    hold: not ``memory=zeros``, whose projection adds the biases)."""
    seq = np.concatenate([prompt, forced])
    cache = model.init_cache(1, len(seq), dtype=torch.float32, device=dev)
    with torch.no_grad():
        lg = model.forward(params, {"tokens": torch.as_tensor(
            seq, device=dev)[None]}, cache=cache, pos=0)[0][0]
    return lg[len(prompt) - 1:].float()


def time_cross_state(torch, dev, eng, cfg) -> dict:
    """The slot-resident cross K/V's costs on the engine after its run:
    ``slot_merge`` as a prefill chunk runs it (every batch-axis leaf cloned,
    the cross K/V included), ``restore_masked`` as a decode tick runs it
    (the cross K/V come back as the same tensors and are skipped) and as
    it would run on fresh tensors (a ``torch.where`` over them), and the
    cross-attention of one decode tick over the 1,500 keys (every layer's
    q projection, attention and wo, with the f32 cache's conversion to
    bf16 the forward makes)."""
    from repro_torch.models import encdec
    from repro_torch.serve import paged_cache as pc

    cache, axes = eng.cache, eng.axes
    nbytes = sum(c.numel() * c.element_size()
                 for c in cache.cross_k + cache.cross_v)
    view = pc.slot_view_dyn(cache, axes, 0)
    keep = torch.zeros(eng.max_batch, dtype=torch.bool, device=dev)
    keep[0] = True
    fresh = cache._replace(cross_k=[c.clone() for c in cache.cross_k],
                           cross_v=[c.clone() for c in cache.cross_v])
    x = torch.randn((eng.max_batch, 1, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev).to(torch.bfloat16)

    def cross_tick():
        for i, lp in enumerate(eng.params["dec_layers"]):
            encdec._cross_attend(lp["cross_attn"], cfg, x,
                                 cache.cross_k[i].to(x.dtype),
                                 cache.cross_v[i].to(x.dtype))

    with torch.no_grad():
        out = {"cross_kv_bytes": nbytes,
               "slot_merge_ms": time_ms(torch, lambda: pc.slot_merge_dyn(
                   cache, view, axes, 0)),
               "restore_masked_ms": time_ms(torch, lambda: pc.restore_masked(
                   cache, cache, axes, keep)),
               "restore_masked_fresh_ms": time_ms(
                   torch, lambda: pc.restore_masked(cache, fresh, axes,
                                                    keep)),
               "cross_attention_tick_ms": time_ms(torch, cross_tick)}
    del fresh
    log(f"[audio] cross K/V {nbytes / 1e6:.1f} MB ({cfg.n_layers} layers x "
        f"{eng.max_batch} slots x {cfg.encoder_seq} x {cfg.n_kv_heads} x "
        f"{cfg.hd}, K and V, f32 as the engine's cache): slot_merge per "
        f"prefill chunk {out['slot_merge_ms']:.4f} ms, restore_masked per "
        f"tick {out['restore_masked_ms']:.4f} ms as run (the same tensors, "
        f"skipped) and {out['restore_masked_fresh_ms']:.4f} ms on fresh "
        f"ones (torch.where); cross-attention over {cfg.encoder_seq} keys "
        f"a decode tick ({cfg.n_layers} layers) "
        f"{out['cross_attention_tick_ms']:.4f} ms")
    return out


def phase_audio(torch, dev) -> dict:
    """The audio family at whisper-small's full width and depth: see the
    module docstring."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import adapters
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.core.bpv import PAPER_SETTINGS
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.recipe import QuantRecipe
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul
    from repro_torch.models import model_zoo
    from repro_torch.train.loss import perplexity

    t_phase = time.perf_counter()
    cfg = ARCHS[AUDIO_ARCH]
    log(f"[audio] {cfg.name}: {cfg.n_encoder_layers} encoder + "
        f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv x {cfg.hd}, d_ff "
        f"{cfg.d_ff} ({cfg.activation}), {cfg.encoder_seq} frames, vocab "
        f"{cfg.vocab_size} (tied), dtype {cfg.dtype}; calibration "
        f"{AUDIO_CALIB}, heldout {AUDIO_HELDOUT}")
    torch.cuda.reset_peak_memory_stats()
    t = {}
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    calib = calibration_tokens(cfg.vocab_size, n_sequences=AUDIO_CALIB[0],
                               seq_len=AUDIO_CALIB[1], device=dev)
    heldout = calibration_tokens(cfg.vocab_size,
                                 n_sequences=AUDIO_HELDOUT[0],
                                 seq_len=AUDIO_HELDOUT[1], seed=777,
                                 device=dev)
    frames32 = adapters.calib_extras(cfg, heldout,
                                     AUDIO_HELDOUT_CHUNK)["frames"]
    frames = frames32.to(torch.bfloat16)
    batch = {"tokens": heldout, "frames": frames}
    torch.cuda.synchronize()
    t["init"] = time.perf_counter() - t0
    setting = PAPER_SETTINGS["2.25bpv_2d"]
    recipe = QuantRecipe.uniform(setting, name="2.25bpv_2d"
                                 ).with_quantize_overrides(
                                     em_iters=25, codebook_update_iters=10)
    plan = family_plan(model, params, setting)
    targets = audio_targets(cfg)
    log(f"[audio] host plan: {len(plan['quantized'])} targets (the "
        f"reference adapter's {len(targets)}), {len(plan['dense'])} kept "
        f"dense, vq_group_sweep and vq_em {plan['groups']} launches each, "
        f"vq_assign 0, flash_attention 0 (1,500 frames and 256 tokens stay "
        f"under 2,048); achieved bpv {plan['bpv']:.6f}; "
        f"{model_zoo.count_params(model) / 1e9:.4f} B parameters")

    zero_counts()
    t0 = time.perf_counter()
    ppl_fp = perplexity(model, params, heldout, batch_extra={"frames":
                                                             frames})
    t["ppl_fp"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    qparams, rep = quantize_model(
        model, params, calib, recipe=recipe, pack=True,
        progress=lambda m: log(f"[audio]   {m} "
                               f"({time.perf_counter() - t0:.1f}s)"))
    torch.cuda.synchronize()
    t["quantize"] = time.perf_counter() - t0
    quant_launches = {fn: getattr(vqa, fn).launches
                      for fn in VQ_ENTRY_POINTS}
    del params
    quantized = [k for k, e in rep.per_target.items()
                 if e["action"] == "quantize"]
    packed = all(isinstance(adapters.tree_get(
        qparams[f"{side}_layers"][int(i)], tuple(rest.split("."))),
        vql_mod.VQLinear)
        for side, i, rest in (n.split(".", 2) for n in targets))

    fused = vql_mod.prepare_fused_tree(qparams)
    B, S = heldout.shape
    want_eval = audio_matmul_impls(fused, B * S, B * cfg.encoder_seq,
                                   torch.bfloat16)
    vq_dequant_matmul.launches = 0
    vq_dequant_matmul.launches_by_impl = {}
    with torch.no_grad():
        t0 = time.perf_counter()
        lf = model.forward(fused, batch)[0]
        torch.cuda.synchronize()
        t["eval_fused"] = time.perf_counter() - t0
        eval_launches = {"launches": vq_dequant_matmul.launches,
                         "by_impl": dict(vq_dequant_matmul.launches_by_impl)}
        t0 = time.perf_counter()
        lg = model.forward(qparams, batch)[0]
        torch.cuda.synchronize()
        t["eval_gather"] = time.perf_counter() - t0
    ppl_vq = text_ppl(torch, lf, heldout)
    diffs = logit_diff(torch, lf, lg)
    del lg, lf
    # the f32 copy: the same packed leaves with f32 frames (the fused form
    # on the fp32 variant, the gather form dequantized to f32), where no
    # activation or W is rounded to bf16; and the model's own sensitivity
    # to the bf16 rounding of the dequantized W
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    q32 = to_f32(qparams)
    fused32 = vql_mod.prepare_fused_tree(q32)
    batch32 = {"tokens": heldout, "frames": frames32}
    with torch.no_grad():
        lg32 = model32.forward(q32, batch32)[0]
        f32_diffs = logit_diff(torch, model32.forward(fused32, batch32)[0],
                               lg32)
        rounded = to_f32(vql_mod.dequant_tree(q32, torch.bfloat16))
        sens = logit_diff(torch, model32.forward(rounded, batch32)[0], lg32)
        del lg32, rounded
    bars = AUDIO_BF16_BARS
    log(f"[audio] bf16 fused vs gather logits ({B}, {S}, "
        f"{cfg.padded_vocab}): max |diff| {diffs[0]:.4e} (tol {bars[0]}), "
        f"RMS {diffs[1]:.4e} (tol {bars[1]})")
    log(f"[audio] f32 copy, fused vs gather logits: max |diff| "
        f"{f32_diffs[0]:.4e} (tol {FUSED_MAX_TOL}), RMS {f32_diffs[1]:.4e} "
        f"(tol {FUSED_RMS_TOL})")
    log(f"[audio] sensitivity: the f32 copy with the dequantized W exact "
        f"against rounded to bf16: max {sens[0]:.4e}, RMS {sens[1]:.4e}")

    t0 = time.perf_counter()
    run = serve_run(torch, dev, model, qparams, 16, SERVE_REQUESTS,
                    SERVE_NEW)
    eng = run.pop("engine")
    t["serve"] = time.perf_counter() - t0
    cross_zero = all(float(c.abs().max()) == 0
                     for c in eng.cache.cross_k + eng.cache.cross_v)
    cross = time_cross_state(torch, dev, eng, cfg)
    itl_ms = run["itl_median_s"] * 1e3
    log(f"[audio] cross K/V still zero after the run (no frames served): "
        f"{cross_zero}; the cross-attention is "
        f"{100 * cross['cross_attention_tick_ms'] / itl_ms:.1f}% of the "
        f"median ITL {itl_ms:.3f} ms")

    # request 0's served path, teacher-forced: the kernel decode against
    # the gather decode and a dense-cache prefill of the same tokens, in
    # the bf16 model and in its f32 copy
    prompt, out = run["prompts"][0], run["out"][0]
    forced = out[:-1]
    tf_diffs = {}
    with torch.no_grad():
        for tag, mdl, p in (("bf16", model, eng.params),
                            ("f32", model32, fused32)):
            kern = forced_logits(torch, dev, mdl, eng, prompt, forced,
                                 "fused", params=p)
            for name, other in (
                    ("gather decode", forced_logits(
                        torch, dev, mdl, eng, prompt, forced, "gather",
                        params=p)),
                    ("dense prefill", dense_prefill_logits(
                        torch, dev, mdl, p, prompt, forced))):
                d = tf_diffs[f"{tag} {name}"] = logit_diff(torch, kern,
                                                           other)
                tol = AUDIO_BF16_SERVE_BARS if tag == "bf16" else (
                    SERVE_MAX_TOL, SERVE_RMS_TOL)
                log(f"[audio] serve, {tag}: teacher-forced kernel decode vs "
                    f"{name}, {tuple(kern.shape)} logits: max |diff| "
                    f"{d[0]:.4e} (tol {tol[0]}), RMS {d[1]:.4e} (tol "
                    f"{tol[1]})")
            if tag == "bf16":
                agree = float((kern.argmax(-1).cpu()
                               == torch.tensor(out)).float().mean())
    del q32, fused32, model32
    tail, tail_checks = slot_state_serve(
        torch, dev, model, qparams, run, eng, "audio",
        lambda r, f, tag: predict_family_serve(
            r, f, cfg.n_layers, tag, pad=True,
            impls_at=lambda m: audio_matmul_impls(f, m, None,
                                                  torch.bfloat16)),
        cfg.n_layers, AUDIO_QUANT_PAGES)
    t.update(tail.pop("seconds"))
    del eng
    flash = {"launches": flash_attention.launches,
             "by_impl": dict(flash_attention.launches_by_impl)}

    peak = torch.cuda.max_memory_allocated()
    log(f"[audio] ppl fp={ppl_fp:.3f} vq={ppl_vq:.3f} | recon err="
        f"{rep.total_error():.4f} | achieved {rep.achieved_bpv:.6f} bpv "
        f"(host plan {plan['bpv']:.6f})")
    log("[audio] stages: " + "  ".join(
        f"{k}={v:.2f}s" for k, v in sorted(rep.stage_seconds.items(),
                                          key=lambda kv: -kv[1])))
    log("[audio] seconds: " + "  ".join(f"{k}={v:.2f}" for k, v in t.items()))
    log(f"[audio] quantize launches {quant_launches} (predicted "
        f"vq_group_sweep and vq_em {plan['groups']} each, vq_assign 0); "
        f"flash_attention in the phase {flash} (predicted 0); evaluation "
        f"matmuls {eval_launches} (predicted {want_eval})")
    log(f"[audio] max_memory_allocated {peak / 2**30:.2f} GiB; phase "
        f"{time.perf_counter() - t_phase:.1f}s")

    serve_bars = AUDIO_BF16_SERVE_BARS
    checks = {
        "ppl finite": math.isfinite(ppl_fp) and math.isfinite(ppl_vq),
        "logits finite": math.isfinite(diffs[0]),
        "targets == the reference adapter's": quantized == targets
            == list(rep.per_target) and sorted(plan["quantized"])
            == sorted(targets) and not plan["dense"],
        "every target packed": packed,
        "bpv == 2.25 == host plan": rep.achieved_bpv == 2.25
            and abs(rep.achieved_bpv - plan["bpv"]) < 1e-9,
        **quantize_launch_checks(quant_launches, plan["groups"]),
        "no flash_attention launch": flash["launches"] == 0,
        "evaluation: one launch a packed leaf by variant as planned":
            eval_launches["by_impl"] == want_eval
            and eval_launches["launches"] == sum(want_eval.values()),
        "f32 copy: fused vs gather": (f32_diffs[0] <= FUSED_MAX_TOL
                                      and f32_diffs[1] <= FUSED_RMS_TOL),
        "bf16: fused vs gather": diffs[0] <= bars[0] and diffs[1] <= bars[1],
        **tail_checks,
        "serve: cross K/V left at zero": cross_zero,
        **{f"serve, f32 copy: teacher-forced kernel decode vs {name}":
           within_bars(tf_diffs[f"f32 {name}"])
           for name in ("gather decode", "dense prefill")},
        **{f"serve, bf16: teacher-forced kernel decode vs {name}":
           tf_diffs[f"bf16 {name}"][0] <= serve_bars[0]
           and tf_diffs[f"bf16 {name}"][1] <= serve_bars[1]
           for name in ("gather decode", "dense prefill")},
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"audio phase checks failed: {bad}")
    return {"launches": quant_launches, "predicted_column_groups":
            plan["groups"], "flash": flash, "eval_launches": eval_launches,
            "predicted_eval": want_eval, "ppl_fp": ppl_fp, "ppl_vq": ppl_vq,
            "recon_error": rep.total_error(),
            "achieved_bpv": rep.achieved_bpv, "predicted_bpv": plan["bpv"],
            "stage_seconds": rep.stage_seconds, "seconds": t,
            "fused_vs_gather": diffs, "f32_fused_vs_gather": f32_diffs,
            "sensitivity": sens, "bf16_bars": bars,
            "bf16_serve_bars": serve_bars, **tail,
            "serve_teacher_forced": tf_diffs, "greedy_agree": agree,
            "cross_state": cross,
            "itl_median_ms": itl_ms, "max_memory_allocated": peak,
            "phase_seconds": time.perf_counter() - t_phase}


# the train_families phase: the hybrid at the hybrid phase's width and
# depth on the long phase's 4 x 4096 tokens, whisper-small at full width
# and depth on 4 x 448 decoder tokens (its published text context) with 4
# x 1,500 stub frames; 2 microbatches, remat True, train's optimizer
TRAIN_FAMILY_AUDIO_TOKENS = (4, 448)
# remat=True against remat=False in the f32 copy: the backward re-runs the
# same ops on the same inputs (bitwise expected). The hybrid's comparison
# runs at one 4096-token sequence: its un-checkpointed f32 forward keeps
# every Mamba layer's chunked scan (about 2.5 GB a layer and sequence)
TRAIN_REMAT_RTOL = 1e-6
# the Mamba2 scan's per-head leaves: their gradients sum over every
# position of every sequence with cancellation, so the f32 kernels'
# reordered sums move them far more, relatively, than any matrix: held at
# 1.77x the largest of nine readings (this phase's inputs and
# ``grad_readings`` at seeds 0-7: 1.65-1.87e-4 on A_log leaves; NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md, section 2), every other leaf at the
# train phase's 1e-4. The f32 check also reports a control: the plain
# pair itself at other chunk sizes, a reordered f32 sum (1.48-1.89e-4 on
# the same leaves)
TRAIN_SCAN_LEAVES = ("A_log", "dt_bias", "D_skip")
TRAIN_SCAN_GRAD_RTOL = 3.3e-4
TRAIN_CONTROL_CHUNKS = (256, 256)
# bf16: the hybrid's 12 Mamba layers carry a bf16 rounding on through
# their f32 state, so the plain bf16 path itself lies 1-6e-2 from the f32
# copy's gradients. The kernels are held to add no error of their own
# beyond bf16's: their distance to the f32 copy's gradients (the plain
# pair) within TRAIN_BF16_VS_F32_RATIO times the plain bf16 path's, a
# leaf (nine readings, as above: at most 1.109x); on the scan leaves,
# where both distances are a cancelling sum's rounding noise, within
# TRAIN_BF16_VS_F32_RATIO_SCAN (1.11-1.61x). Behind that, an outer guard,
# kernels vs the plain pair a leaf: the train phase's 2e-2 for audio, for
# the hybrid 1.76x the largest reading (4.42e-2 on a dt_bias; 2.62e-2 the
# largest off the scan leaves, on the LoRA q.A)
TRAIN_FAMILY_GRAD_RTOL_BF16 = {"hybrid": 7.8e-2, "audio": 2e-2}
TRAIN_BF16_VS_F32_RATIO = 1.25
TRAIN_BF16_VS_F32_RATIO_SCAN = 2.0
# the audio family's q/k/v biases start at zeros (the reference's init),
# where a bias on the wrong side goes unseen: drawn like the hybrid's
# LoRA B factors instead
AUDIO_BIAS_SEED, AUDIO_BIAS_STD = 0, 0.02


def seed_qkv_biases(torch, params) -> None:
    """Every q/k/v bias of the encoder's attention and the decoder's self-
    and cross-attention drawn from N(0, AUDIO_BIAS_STD^2) with numpy's
    AUDIO_BIAS_SEED."""
    rng = np.random.default_rng(AUDIO_BIAS_SEED)
    attns = ([lp["attn"] for lp in params["enc_layers"]]
             + [lp[k] for lp in params["dec_layers"]
                for k in ("self_attn", "cross_attn")])
    for attn in attns:
        for b in ("bq", "bk", "bv"):
            t = attn[b]
            draw = rng.standard_normal(tuple(t.shape)).astype(np.float32)
            attn[b] = torch.from_numpy(draw * AUDIO_BIAS_STD).to(t.device,
                                                                 t.dtype)


def family_train_flops(cfg, params, B: int, S: int) -> float:
    """Model FLOPs of one step (no recompute counted): 6 a matmul
    parameter a token that passes it, plus attention's products, 4 * hd a
    visible (row, column) pair a head forward, three times that with the
    backward. Hybrid: each Mamba layer's in_proj and out_proj over every
    token, the shared q/k/v/o once a group, the head; the SSD scan's own
    products and the conv are not counted. Audio: the encoder's matrices
    over the frames, the decoder's over the tokens, the cross K/V
    projections over the frames, the tied head over the tokens; attention
    full in the encoder, causal in the decoder, tokens x frames across."""
    def mats(tree) -> int:
        return sum(t.numel() for t in tree.values() if t.dim() == 2)

    if cfg.family == "hybrid":
        n_groups = len(params["mamba"])
        mm = sum(lp["mixer"]["in_proj"].numel()
                 + lp["mixer"]["out_proj"].numel()
                 for group in params["mamba"] for lp in group)
        mm += n_groups * mats(params["shared"]["attn"])
        mm += params["lm_head"].numel()
        attn = (3 * 4.0 * cfg.hd * cfg.n_heads * n_groups * B
                * S * (S + 1) // 2)
        return 6.0 * mm * B * S + attn
    F = cfg.encoder_seq
    enc = sum(mats(lp["attn"]) + mats(lp["ffn"])
              for lp in params["enc_layers"])
    dec = sum(mats(lp["self_attn"]) + mats(lp["ffn"])
              + lp["cross_attn"]["wq"].numel()
              + lp["cross_attn"]["wo"].numel()
              for lp in params["dec_layers"])
    cross_kv = sum(lp["cross_attn"]["wk"].numel()
                   + lp["cross_attn"]["wv"].numel()
                   for lp in params["dec_layers"])
    mm = (enc + cross_kv) * B * F + (dec + params["embed"].numel()) * B * S
    pairs = (cfg.n_encoder_layers * F * F
             + cfg.n_layers * (S * (S + 1) // 2 + S * F))
    return 6.0 * mm + 3 * 4.0 * cfg.hd * cfg.n_heads * B * pairs


def rel_frobenius(torch, ga, gb, names) -> tuple[dict, tuple]:
    """Per-leaf relative Frobenius error of ``ga`` against ``gb`` and the
    worst (error, leaf)."""
    from repro_torch.train import optimizer as opt

    rel = {n: float((a.float() - b.float()).norm()
                    / b.float().norm().clamp(min=1e-30))
           for n, a, b in zip(names, opt.tree_leaves(ga),
                              opt.tree_leaves(gb))}
    return rel, max((r, n) for n, r in rel.items())


def f32_grad_readings(torch, model32, params32, batch32: dict,
                      names) -> tuple:
    """The f32 copy's gradients through the kernels against the plain
    flash pair swapped in, a leaf, split into the scan's per-head leaves
    and the rest; beside them the control, the plain pair at
    TRAIN_CONTROL_CHUNKS against its own. Returns the kernels' and the
    plain pair's gradients and the readings."""
    from repro_torch.train.train_step import loss_and_grads

    mb = TRAIN_MICROBATCHES
    zero_counts()
    g_k, m_k = loss_and_grads(model32, params32, batch32, microbatches=mb,
                              remat=True)
    torch.cuda.synchronize()
    counts = train_counts()
    with plain_flash_hook():
        g_p, m_p = loss_and_grads(model32, params32, batch32,
                                  microbatches=mb, remat=True)
    torch.cuda.synchronize()
    rel, worst = rel_frobenius(torch, g_k, g_p, names)
    with plain_flash_hook(chunks=TRAIN_CONTROL_CHUNKS):
        g_c, _ = loss_and_grads(model32, params32, batch32,
                                microbatches=mb, remat=True)
    rel_c, worst_c = rel_frobenius(torch, g_c, g_p, names)
    del g_c
    scan = {n for n in names if n.rsplit(".", 1)[-1] in TRAIN_SCAN_LEAVES}
    worst_m = max((r, n) for n, r in rel.items() if n not in scan)
    worst_s = max(((r, n) for n, r in rel.items() if n in scan),
                  default=(0.0, None))
    return g_k, g_p, {
        "loss_kernels": float(m_k["loss"]), "loss_plain": float(m_p["loss"]),
        "rel": rel, "worst": worst, "worst_m": worst_m, "worst_s": worst_s,
        "rel_c": rel_c, "worst_c": worst_c, "counts": counts}


def bf16_grad_readings(torch, model, params, batch16: dict, names,
                       g_f32) -> dict:
    """One bf16 step's gradients through the kernels against the plain
    flash pair, a leaf; and each path's distance to the f32 copy's
    gradients ``g_f32``, with the worst ratio of the kernels' distance
    over the plain path's, the scan's per-head leaves apart."""
    from repro_torch.train.train_step import loss_and_grads

    mb = TRAIN_MICROBATCHES
    g_k, _ = loss_and_grads(model, params, batch16, microbatches=mb,
                            remat=True)
    with plain_flash_hook():
        g_p, _ = loss_and_grads(model, params, batch16, microbatches=mb,
                                remat=True)
    torch.cuda.synchronize()
    rel16, worst16 = rel_frobenius(torch, g_k, g_p, names)
    k_f32, _ = rel_frobenius(torch, g_k, g_f32, names)
    p_f32, _ = rel_frobenius(torch, g_p, g_f32, names)
    del g_k, g_p
    scan = {n for n in names if n.rsplit(".", 1)[-1] in TRAIN_SCAN_LEAVES}
    ratios = {n: (k_f32[n] / p_f32[n] if p_f32[n] > 0 else
                  float(k_f32[n] > 0)) for n in names}
    ratio = max((r, n) for n, r in ratios.items() if n not in scan)
    ratio_scan = max(((r, n) for n, r in ratios.items() if n in scan),
                     default=(0.0, None))
    worst16_m = max((r, n) for n, r in rel16.items() if n not in scan)
    return {"rel16": rel16, "worst16": worst16, "worst16_m": worst16_m,
            "k_f32": k_f32, "p_f32": p_f32, "ratio": ratio,
            "ratio_scan": ratio_scan}


def train_family(torch, dev, fam: str, cfg, batch16: dict,
                 batch32: dict, remat_rows: int, seed_fn) -> dict:
    """One family's training checks (see phase_train_families)."""
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        TrainState, loss_and_grads, make_train_step)

    mb = TRAIN_MICROBATCHES
    B, S = batch16["tokens"].shape
    # shared-attention invocations a forward (none for audio)
    n_attn = (cfg.n_layers // cfg.shared_attn_every
              if cfg.family == "hybrid" else 0)
    t, res = {}, {}
    model = model_zoo.build(cfg)
    params = model.init_params(seed=0, device=dev)
    seed_fn(torch, params)
    names = _leaf_names(params)

    # 1. the f32 copy: kernels vs the plain flash pair, remat vs none
    t0 = time.perf_counter()
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    params32 = to_f32(params)
    g_k, g_f32, f32 = f32_grad_readings(torch, model32, params32, batch32,
                                        names)
    rel, worst, rel_c, worst_c, worst_m, worst_s, counts32 = (
        f32[k] for k in ("rel", "worst", "rel_c", "worst_c", "worst_m",
                         "worst_s", "counts"))
    t["grad_check"] = time.perf_counter() - t0
    log(f"[train_families] {fam} f32 copy: loss kernels "
        f"{f32['loss_kernels']:.6f}, plain {f32['loss_plain']:.6f}; "
        f"relative Frobenius error a leaf, worst {worst_m[0]:.2e} "
        f"({worst_m[1]}), scan leaves {worst_s[0]:.2e} ({worst_s[1]}); "
        f"the plain pair at chunks {TRAIN_CONTROL_CHUNKS} vs its own: worst "
        f"{worst_c[0]:.2e} ({worst_c[1]})"
        + (f", on {worst_s[1]} {rel_c[worst_s[1]]:.2e}" if worst_s[1]
           else "") + f"; launches {counts32}")
    t0 = time.perf_counter()
    part = {k: x[:remat_rows] for k, x in batch32.items()}
    n_mb = min(mb, remat_rows)
    if remat_rows < B:
        g_k, _ = loss_and_grads(model32, params32, part, microbatches=n_mb,
                                remat=True)
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    g_n, _ = loss_and_grads(model32, params32, part, microbatches=n_mb,
                            remat=False)
    torch.cuda.synchronize()
    counts_n = train_counts()
    peak_n = torch.cuda.max_memory_allocated()
    rel_r, worst_r = rel_frobenius(torch, g_k, g_n, names)
    bitwise_r = all(bool(torch.equal(a, b)) for a, b in zip(
        opt.tree_leaves(g_k), opt.tree_leaves(g_n)))
    t["remat_check"] = time.perf_counter() - t0
    log(f"[train_families] {fam} f32 copy, remat=True vs remat=False on "
        f"{remat_rows} x {S} tokens: worst {worst_r[0]:.2e} ({worst_r[1]}), "
        f"bitwise {bitwise_r}; remat=False launches {counts_n}, "
        f"max_memory_allocated {peak_n / 2**30:.2f} GiB")
    del g_k, g_n, params32, model32, part
    torch.cuda.empty_cache()

    # 2. one bf16 step's gradients: kernels vs the plain flash pair
    t0 = time.perf_counter()
    b16 = bf16_grad_readings(torch, model, params, batch16, names, g_f32)
    rel16, worst16, k_f32, p_f32, ratio, ratio_s = (
        b16[k] for k in ("rel16", "worst16", "k_f32", "p_f32", "ratio",
                         "ratio_scan"))
    del g_f32
    torch.cuda.empty_cache()
    t["grad_check_bf16"] = time.perf_counter() - t0
    bar16 = TRAIN_FAMILY_GRAD_RTOL_BF16[fam]
    log(f"[train_families] {fam} bf16 gradients against the f32 copy's, "
        f"the kernels over the plain bf16 path: worst {ratio[0]:.3f}x "
        f"({ratio[1]}: {k_f32[ratio[1]]:.2e} vs {p_f32[ratio[1]]:.2e}; bar "
        f"{TRAIN_BF16_VS_F32_RATIO}x), scan leaves {ratio_s[0]:.3f}x "
        f"({ratio_s[1]}; bar {TRAIN_BF16_VS_F32_RATIO_SCAN}x); kernels vs "
        f"the plain flash pair: worst {worst16[0]:.2e} ({worst16[1]}; outer "
        f"bar {bar16})")

    # 3. four bf16 steps on the one batch
    ocfg = opt.OptConfig(**TRAIN_OPT)
    state = TrainState(params, opt.init(params, ocfg))
    del params
    step = make_train_step(model, ocfg, microbatches=mb, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, gnorms, secs = [], [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch16)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    counts = train_counts()
    peak = torch.cuda.max_memory_allocated()
    flops = family_train_flops(cfg, state.params, B, S)
    steady = _median(secs[1:])
    tokens = B * S
    log(f"[train_families] {fam} bf16 steps: loss {losses}, grad norm "
        f"{gnorms}, seconds {[round(x, 4) for x in secs]}; launches "
        f"{counts}")
    log(f"[train_families] {fam} {steady:.4f} s a step (median of steps "
        f"2-{TRAIN_STEPS}), {tokens / steady:.1f} tokens/s, model FLOPs "
        f"{flops / 1e12:.2f} T a step = "
        f"{flops / steady / BF16_TC_FLOP_PER_S:.4f} of the bf16 peak; "
        f"max_memory_allocated {peak / 2**30:.2f} GiB")
    del state, step
    torch.cuda.empty_cache()

    # the host plan: S past 2048 sends each shared-attention invocation
    # through the flash pair (forward with its lse twice under remat, once
    # without; one backward), a group and microbatch
    flash = S > 2048
    n_fwd, n_bwd = n_attn * mb * 2, n_attn * mb

    def plan(impl, fwd, bwd):
        if not flash:
            return {"flash_attention": 0, "flash_attention_bwd": 0,
                    "flash_attention_by_impl": {},
                    "flash_attention_bwd_by_impl": {}}
        return {"flash_attention": fwd, "flash_attention_bwd": bwd,
                "flash_attention_by_impl": {impl: fwd},
                "flash_attention_bwd_by_impl": {impl: bwd}}

    n_mb_r = min(mb, remat_rows)
    want = plan("tc", TRAIN_STEPS * n_fwd, TRAIN_STEPS * n_bwd)
    want32 = plan("fp32", n_fwd, n_bwd)
    want_n = plan("fp32", n_attn * n_mb_r, n_attn * n_mb_r)
    checked = [n for n in names if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")
               or ".lora." in n]
    checks = {
        "f32 gradients within 1e-4 of the plain flash pair":
            worst_m[0] <= TRAIN_GRAD_RTOL,
        "f32 scan leaves within 3.3e-4": worst_s[0] <= TRAIN_SCAN_GRAD_RTOL,
        "remat=True equals remat=False": worst_r[0] <= TRAIN_REMAT_RTOL,
        "bf16 kernels no further from the f32 gradients than the plain "
        f"pair ({TRAIN_BF16_VS_F32_RATIO}x)":
            ratio[0] <= TRAIN_BF16_VS_F32_RATIO,
        "the same on the scan leaves "
        f"({TRAIN_BF16_VS_F32_RATIO_SCAN}x)":
            ratio_s[0] <= TRAIN_BF16_VS_F32_RATIO_SCAN,
        f"bf16 gradients within {bar16} of the plain flash pair":
            worst16[0] <= bar16,
        "loss finite": all(math.isfinite(x) for x in losses),
        "grad norm finite": all(math.isfinite(x) for x in gnorms),
        "loss falls": losses[-1] < losses[0],
        "f32 launches as planned": counts32 == want32,
        "remat=False launches as planned": counts_n == want_n,
        "launches as planned": counts == want,
    }
    if fam == "hybrid":
        checks["shared wq/wk/wv and LoRA A/B checked"] = (
            {n for n in checked if n.startswith(".shared.")}
            == {".shared.attn.wq", ".shared.attn.wk", ".shared.attn.wv"}
            and len([n for n in checked if ".lora." in n]) == 6)
    res.update({
        "checks": checks, "grad_rel_frobenius": rel, "grad_worst": worst,
        "grad_worst_matrices": worst_m, "grad_worst_scan": worst_s,
        "grad_rel_frobenius_control": rel_c, "grad_worst_control": worst_c,
        "grad_rel_frobenius_bf16": rel16,
        "grad_bf16_vs_f32": {"kernels": k_f32, "plain": p_f32,
                             "worst_ratio": ratio,
                             "worst_ratio_scan": ratio_s},
        "grad_checked": {n: rel[n] for n in checked},
        "remat_rel_frobenius_worst": worst_r, "remat_bitwise": bitwise_r,
        "remat_rows": remat_rows, "remat_false_peak": peak_n,
        "grad_worst_bf16": worst16, "losses": losses, "grad_norms": gnorms,
        "step_seconds": secs, "seconds_per_step": steady,
        "tokens_per_s": tokens / steady, "model_flops_per_step": flops,
        "mfu_bf16": flops / steady / BF16_TC_FLOP_PER_S,
        "max_memory_allocated": peak, "launches": counts,
        "launches_f32": counts32, "launches_remat_false": counts_n,
        "predicted": {"remat": want, "f32": want32, "remat_false": want_n},
        "seconds": t})
    log(f"[train_families] {fam} checked leaves {len(checked)}: worst "
        f"{max((rel[n], n) for n in checked) if checked else None}; "
        f"predicted launches {want} (f32 {want32}, remat=False {want_n})")
    return res


def phase_train_families(torch, dev, long_calib) -> dict:
    """Train the hybrid and audio families on one device: Zamba2-7B at
    the hybrid phase's width and depth (12 Mamba layers in 2 groups, LoRA
    B drawn non-zero) on the long phase's 4 x 4096 tokens, and
    whisper-small at full width and depth (q/k/v biases drawn non-zero)
    on 4 x 448 tokens with 4 x 1,500 stub frames; 2 microbatches, remat
    True, AdamW at train's lr 3e-5. Each family: the f32 copy's gradients
    through the kernels against the plain flash pair (<= 1e-4 a leaf; the
    scan's per-head leaves <= 3.3e-4); remat=True against remat=False (<=
    1e-6); one bf16 step's gradients against the f32 copy's (the kernels
    within 1.25x of the plain bf16 path's distance, 2x on the scan leaves)
    and, an outer guard, against the plain pair (audio 2e-2, hybrid
    7.8e-2); 4 bf16 steps (finite, falling loss;
    step seconds, tokens/s, model FLOPs share, peak memory); flash
    launches by variant held to the host plan."""
    from repro_torch.configs import ARCHS
    from repro_torch.core import adapters

    t_phase = time.perf_counter()
    res = {}
    cfg_h = ARCHS[HYBRID_ARCH].scaled(n_layers=HYBRID_LAYERS)
    log(f"[train_families] hybrid {cfg_h.name}: d_model {cfg_h.d_model}, "
        f"shared attention {cfg_h.n_heads} x {cfg_h.hd}, {cfg_h.n_layers} "
        f"Mamba layers in {cfg_h.n_layers // cfg_h.shared_attn_every} "
        f"groups; batch "
        f"{tuple(long_calib.shape)} in {TRAIN_MICROBATCHES} microbatches; "
        f"{TRAIN_OPT}")
    batch = {"tokens": long_calib}
    res["hybrid"] = train_family(torch, dev, "hybrid", cfg_h, batch, batch,
                                 1, seed_lora_b)
    torch.cuda.empty_cache()

    cfg_a = ARCHS[AUDIO_ARCH]
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg_a.vocab_size, TRAIN_FAMILY_AUDIO_TOKENS)).to(dev)
    frames = adapters.calib_extras(cfg_a, toks)["frames"]
    log(f"[train_families] audio {cfg_a.name}: {cfg_a.n_encoder_layers} + "
        f"{cfg_a.n_layers} layers, d_model {cfg_a.d_model}; batch "
        f"{tuple(toks.shape)} tokens with {tuple(frames.shape)} frames in "
        f"{TRAIN_MICROBATCHES} microbatches; {TRAIN_OPT}")
    res["audio"] = train_family(
        torch, dev, "audio", cfg_a,
        {"tokens": toks, "frames": frames.to(torch.bfloat16)},
        {"tokens": toks, "frames": frames.float()},
        TRAIN_FAMILY_AUDIO_TOKENS[0], seed_qkv_biases)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"[train_families] phase {res['seconds']:.1f}s")
    bad = [f"{fam}: {k}" for fam in ("hybrid", "audio")
           for k, ok in res[fam]["checks"].items() if not ok]
    if bad:
        raise Failed(f"train_families checks failed: {bad}")
    return res


def grad_readings(seeds: list) -> int:
    """``chip_smoke.py grad-readings SEED ...``: the hybrid train cell's
    gradient readings alone (``f32_grad_readings``, then
    ``bf16_grad_readings``) at other seeds than the train_families
    phase's 0: the init params, the LoRA B draw and the 4 x 4096 tokens
    each from the seed. The bars TRAIN_SCAN_GRAD_RTOL,
    TRAIN_BF16_VS_F32_RATIO and the hybrid's outer bf16 bar are set from
    these readings and the phase's. One line a seed; all in
    chiprun_out/grad_readings.json."""
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.data.calibration import calibration_tokens
    from repro_torch.models import model_zoo

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    phase_build()
    dev = torch.device("cuda")
    cfg = ARCHS[HYBRID_ARCH].scaled(n_layers=HYBRID_LAYERS)
    model, model32 = (model_zoo.build(cfg),
                      model_zoo.build(cfg.scaled(dtype="float32")))
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        params = model.init_params(seed=seed, device=dev)
        seed_lora_b(torch, params, seed)
        names = _leaf_names(params)
        batch = {"tokens": calibration_tokens(
            cfg.vocab_size, n_sequences=LONG_CALIB, seq_len=LONG_SEQ,
            seed=seed, device=dev)}
        g_k, g_f32, f32 = f32_grad_readings(torch, model32, to_f32(params),
                                            batch, names)
        del g_k
        b16 = bf16_grad_readings(torch, model, params, batch, names, g_f32)
        del g_f32, params
        torch.cuda.empty_cache()
        ratio, ratio_s = b16["ratio"], b16["ratio_scan"]
        row = {"seed": seed, "f32_worst_matrices": f32["worst_m"],
               "f32_worst_scan": f32["worst_s"],
               "f32_control_worst": f32["worst_c"],
               "bf16_worst": b16["worst16"],
               "bf16_worst_matrices": b16["worst16_m"],
               "bf16_vs_f32_ratio": ratio,
               "bf16_vs_f32_ratio_scan": ratio_s,
               "bf16_ratio_leaves": {n: (b16["k_f32"][n], b16["p_f32"][n])
                                     for n in (ratio[1], ratio_s[1])},
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        row.update({"f32_rel": f32["rel"], "f32_rel_control": f32["rel_c"],
                    "bf16_rel": b16["rel16"], "bf16_kernels_vs_f32":
                    b16["k_f32"], "bf16_plain_vs_f32": b16["p_f32"]})
        out.append(row)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "grad_readings.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


# the mesh phase: 2 ranks on the one card (gloo: NCCL refuses two ranks
# on one device), each a process of this script under torchrun
MESH_RANKS = 2
MESH_TIMEOUT_S = 300
# the merged Hessians against the same activations' single-device sum:
# within this share of max|H| (f32 sums of 512 and 1,024 rows in another
# order)
MESH_H_RTOL = 1e-5
# per-target tr(E H E^T) against the single-device run: the merged H's
# last bits flip near-tie assignments, which feed the error forward
MESH_ERR_RTOL = 0.01


def payload_digest(tree) -> str:
    """sha256 of every tensor of a packed tree, the fields of its VQLinear
    leaves included, in order."""
    import hashlib

    import torch

    from repro_torch.core.vq_linear import VQLinear

    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        parts = ([getattr(leaf, f.name) for f in dataclasses.fields(leaf)]
                 if isinstance(leaf, VQLinear) else [leaf])
        for t in parts:
            if torch.is_tensor(t):
                h.update(t.detach().contiguous().view(torch.uint8).cpu()
                         .numpy().tobytes())
    return h.hexdigest()


def eval_fused_vs_gather(torch, model, qparams, heldout) -> dict:
    """Main's evaluation of a packed model: the fused form's logits (every
    packed leaf through vq_dequant_matmul) against the gather form's, at
    main's bars, and the launches by variant."""
    from repro_torch.core import vq_linear as vql_mod
    from repro_torch.kernels.vq_dequant_matmul import vq_dequant_matmul

    vq_dequant_matmul.launches_by_impl = {}
    with torch.no_grad():
        lf = model.forward(vql_mod.prepare_fused_tree(qparams),
                           {"tokens": heldout})[0]
        impls = dict(vq_dequant_matmul.launches_by_impl)
        lg = model.forward(qparams, {"tokens": heldout})[0]
    d = (lf - lg).float()
    max_d, rms_d = float(d.abs().max()), float(d.pow(2).mean().sqrt())
    return {"max": max_d, "rms": rms_d, "impls": impls,
            "finite": bool(torch.isfinite(lf).all()),
            "ok": max_d <= FUSED_MAX_TOL and rms_d <= FUSED_RMS_TOL}


def mesh_worker(out_dir: str) -> int:
    """One rank of the mesh phase's part (b), under ``torchrun
    --nproc-per-node 2``: main's quantize with the Hessians captured over
    the 2-rank data axis (gloo, both ranks on the one card), each tap's
    merged sum held after every call against the single-device sum of the
    same activations, the launches counted, the packed payload hashed and
    main's fused evaluation run; written to ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import hessian as hes
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.launch.quantize import hessian_mesh

    t0 = time.perf_counter()
    mesh, dev = hessian_mesh(MESH_RANKS, torch.device("cuda"))
    rank = dist.get_rank()
    model, params, calib, heldout = main_inputs(torch, dev)
    real, shadows, worst = hes.accumulate_sharded, {}, [0.0]

    def witnessed(state, x, mesh, axis="data"):
        # a tap's first call starts from an empty state
        key = state.H.data_ptr()
        sh = (hes.init_hessian(state.H.shape[0], device=x.device)
              if state.n == 0 else shadows[key])
        shadows[key] = hes.accumulate(sh, x)
        new = real(state, x, mesh, axis)
        want = shadows[key].H
        worst[0] = max(worst[0], float((new.H - want).abs().max()
                                       / want.abs().max()))
        return new

    hes.accumulate_sharded = witnessed
    zero_counts()
    t1 = time.perf_counter()
    try:
        qparams, rep = quantize_model(model, params, calib,
                                      recipe=main_recipe(),
                                      hessian_mesh=mesh, pack=True)
    finally:
        hes.accumulate_sharded = real
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t1
    launches = {fn: getattr(vqa, fn).launches for fn in VQ_ENTRY_POINTS}
    shadows.clear()
    ev = eval_fused_vs_gather(torch, model, qparams, heldout)
    res = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "device": str(dev),
           "hessian_worst_rel": worst[0], "launches": launches,
           "achieved_bpv": rep.achieved_bpv,
           "errors": {k: e["error"] for k, e in rep.per_target.items()},
           "payload_sha256": payload_digest(qparams), "eval": ev,
           "quantize_s": t_quant, "seconds": time.perf_counter() - t0}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def phase_mesh(torch, dev, main_res, main_qparams) -> dict:
    """The data axis of the mesh: (a) NCCL at world size 1 on the card
    (accumulate_sharded against accumulate and accumulate_diag on main's
    4096-column activations; main's quantize under
    ``hessian_mesh=make_host_mesh()`` against main's packed payload); (b)
    2 ranks over gloo on the one card (mesh_worker), held to main's
    single-device run."""
    import torch.distributed as dist

    from repro_torch.core import hessian as hes
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.kernels import vq_assign as vqa
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    t = {}
    model, params, calib, heldout = main_inputs(torch, dev)
    n_groups = main_res["predicted_column_groups"]

    # (a) world 1, NCCL
    mesh = mesh_lib.make_host_mesh("cuda")
    backend_a, world_a = dist.get_backend(), dist.get_world_size()
    log(f"[mesh] (a) backend {backend_a}, world size {world_a}, mesh "
        f"{mesh.mesh_dim_names} {tuple(mesh.shape)}")
    xs = [params["embed"][calib[i:i + 8]] for i in (0, 8)]  # (8, 64, 4096)
    c = xs[0].shape[-1]
    full, full_s = hes.init_hessian(c, device=dev), hes.init_hessian(
        c, device=dev)
    diag, diag_s = hes.init_diag_hessian(c, device=dev), \
        hes.init_diag_hessian(c, device=dev)
    for x in xs:
        full, diag = hes.accumulate(full, x), hes.accumulate_diag(diag, x)
        full_s = hes.accumulate_sharded(full_s, x, mesh)
        diag_s = hes.accumulate_sharded(diag_s, x, mesh)
    torch.cuda.synchronize()
    acc = {"full_bitwise": bool(torch.equal(full.H, full_s.H)),
           "diag_bitwise": bool(torch.equal(diag.diag, diag_s.diag)),
           "full_max_rel": float((full.H - full_s.H).abs().max()
                                 / full.H.abs().max()),
           "diag_max_rel": float((diag.diag - diag_s.diag).abs().max()
                                 / diag.diag.abs().max()),
           "n": (full_s.n, diag_s.n)}
    log(f"[mesh] (a) accumulate_sharded vs accumulate on 2 x 512 rows of "
        f"{c} columns: full bitwise {acc['full_bitwise']} (max rel "
        f"{acc['full_max_rel']:.2e}), diag bitwise {acc['diag_bitwise']} "
        f"(max rel {acc['diag_max_rel']:.2e}), n {acc['n']}")
    del full, full_s, diag, diag_s, xs
    zero_counts()
    t0 = time.perf_counter()
    q_a, rep_a = quantize_model(model, params, calib, recipe=main_recipe(),
                                hessian_mesh=mesh, pack=True)
    torch.cuda.synchronize()
    t["quantize_world1"] = time.perf_counter() - t0
    launches_a = {fn: getattr(vqa, fn).launches for fn in VQ_ENTRY_POINTS}
    digest_a, digest_main = payload_digest(q_a), payload_digest(main_qparams)
    log(f"[mesh] (a) quantize on the host mesh: {t['quantize_world1']:.2f}s"
        f", launches {launches_a}, payload equal to main's "
        f"{digest_a == digest_main}, bpv {rep_a.achieved_bpv}")
    del q_a
    dist.destroy_process_group()
    del model, params
    torch.cuda.empty_cache()

    # (b) 2 ranks over gloo on the one card
    out_dir = os.path.join(ROOT, "build", "repro_torch", "mesh_ranks")
    t["ranks"] = run_ranks("mesh-worker", out_dir, MESH_RANKS,
                           MESH_TIMEOUT_S, "mesh",
                           show=("hessian mesh:", "[build]"))
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    main_err = {k: e["error"] for k, e in main_res["per_target"].items()}
    err_rel = max(abs(rk["errors"][k] - main_err[k]) / main_err[k]
                  for rk in ranks for k in main_err)
    for rk in ranks:
        log(f"[mesh] (b) rank {rk['rank']} of {rk['world']}: backend "
            f"{rk['backend']}, {rk['device']}; merged H vs single-device "
            f"worst {rk['hessian_worst_rel']:.2e} of max|H| (tol "
            f"{MESH_H_RTOL}); launches {rk['launches']}; bpv "
            f"{rk['achieved_bpv']}; quantize {rk['quantize_s']:.2f}s of "
            f"{rk['seconds']:.2f}s; fused vs gather max "
            f"{rk['eval']['max']:.4e} RMS {rk['eval']['rms']:.4e} "
            f"{rk['eval']['impls']}")
    log(f"[mesh] (b) payloads equal across ranks "
        f"{len({rk['payload_sha256'] for rk in ranks}) == 1}; worst "
        f"per-target error vs main's single-device run {err_rel:.2e} (tol "
        f"{MESH_ERR_RTOL}); ranks {t['ranks']:.1f}s")
    want_impl = {"tc_int8": 7 * 2}
    checks = {
        "(a) NCCL at world 1": (backend_a, world_a) == ("nccl", 1),
        "(a) n exact": acc["n"] == (1024, 1024),
        "(a) payload equal to main's": digest_a == digest_main,
        "(a) bpv 2.25": rep_a.achieved_bpv == 2.25,
        **{f"(a) {k}": ok for k, ok in quantize_launch_checks(
            launches_a, n_groups).items()},
        "(b) gloo, 2 ranks": all((rk["backend"], rk["world"])
                                 == ("gloo", MESH_RANKS) for rk in ranks),
        "(b) merged H within 1e-5 of max|H|": all(
            rk["hessian_worst_rel"] <= MESH_H_RTOL for rk in ranks),
        "(b) payloads equal across ranks":
            len({rk["payload_sha256"] for rk in ranks}) == 1,
        "(b) bpv 2.25": all(rk["achieved_bpv"] == 2.25 for rk in ranks),
        "(b) errors within 1% of main's": err_rel <= MESH_ERR_RTOL,
        "(b) launches": all(all(quantize_launch_checks(
            rk["launches"], n_groups).values()) for rk in ranks),
        "(b) fused vs gather at main's bars": all(
            rk["eval"]["ok"] and rk["eval"]["finite"]
            and rk["eval"]["impls"] == want_impl for rk in ranks),
    }
    t["phase"] = time.perf_counter() - t_phase
    log(f"[mesh] phase {t['phase']:.1f}s")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"mesh phase checks failed: {bad}")
    return {"a": {"backend": backend_a, "world": world_a,
                  "accumulate": acc, "launches": launches_a,
                  "payload_equal_main": digest_a == digest_main},
            "b": ranks, "error_rel_vs_main": err_rel, "seconds": t}


# ---------------------------------------------------------------------------
# the mesh's model axis: tensor and expert parallelism on 2 ranks
# ---------------------------------------------------------------------------

MODEL_AXIS_RANKS = 2
MODEL_AXIS_TIMEOUT_S = 600
# (a) bf16 steps on the mesh against the train phase's single-device steps,
# relative, step by step: the loss (readings on the H100 at most 3.51e-5)
# and the gradient norm (at most 4.3e-4, the fourth step's)
MODEL_AXIS_LOSS_RTOL = 1e-3
MODEL_AXIS_GNORM_RTOL = 5e-3
# (c) full-width Qwen3-MoE: a forward and backward of 2 x 2048 tokens; the
# expert-parallel layer alone on seeded f32 inputs of the same size
MODEL_AXIS_MOE_TOKENS = (2, 2048)


# (d) the other four families on the same mesh at full width: (arch,
# layers or None for the config's own, (sequences, tokens)) of a batch in
# TRAIN_MICROBATCHES microbatches. vlm: the long phase's first 3,072
# tokens of each sequence after 1,024 seeded patch embeddings (4,096
# positions: 16 heads of 96 a rank through the flash pair); hybrid: one
# group (the shared block and 6 Mamba layers) on the long phase's 4 x
# 4096 tokens (16 heads of 112 and 56 Mamba heads a rank; one device
# held 59.33 GiB at 12 layers, and two ranks share the card); audio:
# train_families' 4 x 448 tokens with 4 x 1,500 stub frames (6 heads of
# 64, no flash); ssm: 4 x 32 seeded tokens (2 heads of 384: the xLSTM's
# time loops launch ~60 kernels a step and layer, so the step's time
# grows with S: on the mesh 13.9 s a step at 4 x 128, 7.8 s at 4 x 64;
# NVIDIA H100 80GB HBM3, 700 W)
# a leaf whose single-device gradient's max is below this share of the
# tree's max is rounding noise (its gradient is zero in exact arithmetic):
# its distance is held to the same share of the tree's max
MODEL_AXIS_NOISE_FRAC = 1e-6
MODEL_AXIS_FAMILIES = {
    "vlm": (VLM_ARCH, VLM_LAYERS, (LONG_CALIB, VLM_TEXT)),
    "hybrid": (HYBRID_ARCH, 6, (LONG_CALIB, LONG_SEQ)),
    "audio": (AUDIO_ARCH, None, TRAIN_FAMILY_AUDIO_TOKENS),
    "ssm": (SSM_ARCH, None, (4, 32)),
}
# the per-head (or per-column) gate and scan leaves: their gradients sum
# over every position of every sequence with cancellation, so any
# reordered f32 sum moves them more, relatively, than a matrix (PERF.md
# section 2): held at TRAIN_SCAN_GRAD_RTOL. The Mamba2 scan's, and the
# xLSTM's forget-gate biases (read 9.82e-5 at 4 x 128 and 1.55e-4 at 4 x
# 64, every other xLSTM leaf 5-7e-5)
MODEL_AXIS_SUM_LEAVES = TRAIN_SCAN_LEAVES + ("b_f",)
# bf16 steps against one device: (loss, grad norm, steps held) relative,
# the dense case's bars over the 4 steps; but the xLSTM's random 12
# layers amplify the split's other bf16 roundings (PERF.md section 2's
# ssm bf16 bars), and from step 2 its two runs start from other params
# and part (the loss rising on one, falling on the other): its step 1
# read 2.58e-4 / 2.65e-2 at 4 x 128, 2.89e-4 / 2.81e-2 at 4 x 64 and
# 6.56e-4 / 3.48e-2 at 4 x 32, step 4 up to 1.03e-2 / 1.81e-1 (step 3),
# while the f32 copy's loss agreed to 8.7e-8: its step 1 is held at
# about 3x the largest reading, the rest only finite with the loss falling
MODEL_AXIS_BF16_BARS = {"ssm": (2e-3, 0.1, 1)}


def checksum(torch, t) -> int:
    """An exact fingerprint of a tensor's bits: its elements read as
    integers of their width, weighted by position (mod 65,521) and summed
    in int64 on the card. Equal bits give equal sums; a single flipped
    bit changes it."""
    t = t.detach().contiguous()
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    v = t.view(ints[t.element_size()]).reshape(-1).to(torch.int64)
    w = torch.arange(v.numel(), device=v.device, dtype=torch.int64) % 65521
    return int((v * (w + 1)).sum())


def model_axis_family_batches(torch, dev, fam: str, cfg, long_tokens):
    """(bf16 batch, f32 batch) of one (d) case, the same on every rank."""
    from repro_torch.core import adapters

    B, S = MODEL_AXIS_FAMILIES[fam][2]
    if fam in ("vlm", "hybrid"):
        toks = long_tokens[:B, :S].contiguous()
    else:
        rng = np.random.default_rng(1)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (B, S))).to(dev)
    extra = {}
    if fam == "vlm":
        g = torch.Generator(device=dev).manual_seed(11)
        extra["patches"] = torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=g,
            device=dev) * 0.1
    elif fam == "audio":
        extra["frames"] = adapters.calib_extras(cfg, toks)["frames"].float()
    return ({"tokens": toks, **{k: v.to(torch.bfloat16)
                                for k, v in extra.items()}},
            {"tokens": toks, **extra})


def model_axis_family(torch, dev, mesh, fam: str, long_tokens,
                      note) -> dict:
    """(d) one family on the (1, 2) mesh: the f32 copy's loss and
    gradients on the mesh (gathered) and, on rank 0, the single-device
    step's; on rank 0, 4 bf16 steps on one device, then on both ranks the
    same 4 steps on the mesh (seconds, tokens/s, peak memory, flash
    launches by variant); the leaves stored split and read whole, with
    the bytes a step gathers for them."""
    import torch.distributed as dist

    from repro_torch.configs import ARCHS
    from repro_torch.models import model_zoo
    from repro_torch.models import parallel as par
    from repro_torch.runtime import elastic
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        TrainState, data_rows, loss_and_grads, make_train_step)

    t_fam = time.perf_counter()
    arch, layers, (B, S) = MODEL_AXIS_FAMILIES[fam]
    cfg = ARCHS[arch] if layers is None else ARCHS[arch].scaled(
        n_layers=layers)
    rank, mb = dist.get_rank(), TRAIN_MICROBATCHES
    model = model_zoo.build(cfg)
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    layout = par.Layout(model, mesh)
    params = model.init_params(seed=0, device=dev)
    seed = {"hybrid": seed_lora_b, "audio": seed_qkv_biases}.get(fam)
    if seed is not None:
        seed(torch, params)
    b16, b32 = model_axis_family_batches(torch, dev, fam, cfg, long_tokens)
    rows16, rows32 = data_rows(b16, mesh, mb), data_rows(b32, mesh, mb)
    tp = layout.axis.tp
    whole = [(path, leaf) for path, leaf in layout.leaves.items()
             if leaf.model_dim is not None and leaf.mode != par.SPLIT]
    shapes = {path: t for path, t in zip(
        layout.leaves, opt.tree_leaves(model_zoo.abstract_params(model)))}
    # self-attentions past 2048 positions a forward: the flash pair's
    n_attn = {"vlm": cfg.n_layers,
              "hybrid": cfg.n_layers // max(cfg.shared_attn_every, 1)}
    res = {"family": fam, "arch": cfg.name, "layers": cfg.n_layers,
           "flash_attentions": n_attn.get(fam, 0), "batch": [B, S],
           "modes": sorted({leaf.mode for leaf in layout.leaves.values()}),
           "read_whole": sorted({".".join(p for p in path
                                          if isinstance(p, str))
                                 for path, _ in whole}),
           # an all_gather of a leaf stored split: each rank receives the
           # other ranks' parts, in the model's dtype, once a step
           "read_whole_bytes": sum(
               shapes[path].numel() * shapes[path].element_size()
               * (tp - 1) // tp for path, _ in whole),
           # the FULL_SUM leaves' f32 gradients, summed over the model axis
           # once a step
           "full_sum_grad_bytes": sum(
               shapes[path].numel() * 4 for path, leaf in
               layout.leaves.items() if leaf.mode == par.FULL_SUM)}
    t = {}

    # the f32 copy on the mesh, then on one device (rank 0)
    t0 = time.perf_counter()
    p32 = elastic.reshard(to_f32(params), model32.param_specs(), mesh)
    zero_counts()
    views, m32 = loss_and_grads(
        model32, opt.tree_unflatten(p32, layout.views(p32)), rows32,
        microbatches=mb, remat=True, axis=layout.axis)
    torch.cuda.synchronize()
    res["launches_f32"] = train_counts()
    grads = [par.whole(g) for g in opt.tree_leaves(
        layout.grads(p32, opt.tree_leaves(views)))]
    del views, p32
    torch.cuda.empty_cache()
    res["loss_f32_tp"] = float(m32["loss"])
    t["f32_tp"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        g1, m1 = loss_and_grads(model32, to_f32(params), b32,
                                microbatches=mb, remat=True)
        names = _leaf_names(g1)
        rel, _ = rel_frobenius(torch, grads, g1, names)
        scan = {n for n in names
                if n.rsplit(".", 1)[-1] in MODEL_AXIS_SUM_LEAVES}
        # a leaf whose gradient is zero but for rounding (audio's key
        # biases: a shift of a query row's scores, which the softmax
        # cancels; the xLSTM's input-gate biases) is held to the tree's
        # max, not to its own norm
        g1s = opt.tree_leaves(g1)
        tmax = max(float(g.abs().max()) for g in g1s)
        res["grad_noise_leaves"] = {
            n: float((a.float() - b.float()).abs().max()) / tmax
            for n, a, b in zip(names, grads, g1s)
            if float(b.abs().max()) < MODEL_AXIS_NOISE_FRAC * tmax}
        res["loss_f32_single"] = float(m1["loss"])
        res["grad_rel_frobenius"] = rel
        res["grad_worst"] = max((r, n) for n, r in rel.items()
                                if n not in scan
                                and n not in res["grad_noise_leaves"])
        res["grad_worst_scan"] = max(((r, n) for n, r in rel.items()
                                      if n in scan), default=(0.0, None))
        res["grad_worst_5"] = sorted(
            ((r, n) for n, r in rel.items()
             if n not in res["grad_noise_leaves"]), reverse=True)[:5]
        del g1, g1s
        t["f32_single"] = time.perf_counter() - t0
        note(f"(d) {fam} f32 copy: loss on the mesh {res['loss_f32_tp']:.6f}"
             f", one device {res['loss_f32_single']:.6f}; worst gradients "
             f"{res['grad_worst_5']}, scan and gate-bias leaves "
             f"{res['grad_worst_scan']}")
    del grads
    torch.cuda.empty_cache()
    dist.barrier()

    ocfg = opt.OptConfig(**TRAIN_OPT)

    def steps(state, step, batch) -> dict:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        out = {"losses": [], "grad_norms": [], "step_seconds": []}
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            out["step_seconds"].append(time.perf_counter() - t0)
            out["losses"].append(float(m["loss"]))
            out["grad_norms"].append(float(m["grad_norm"]))
        out["launches"] = train_counts()
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        out["seconds_per_step"] = _median(out["step_seconds"][1:])
        out["tokens_per_s"] = B * S / out["seconds_per_step"]
        return out

    if rank == 0:  # the same 4 bf16 steps on one device
        res["single"] = steps(
            TrainState(params, opt.init(params, ocfg)),
            make_train_step(model, ocfg, microbatches=mb, remat=True), b16)
        torch.cuda.empty_cache()
    dist.barrier()
    pt = elastic.reshard(params, model.param_specs(), mesh)
    del params
    res.update(steps(TrainState(pt, opt.init(pt, ocfg)), make_train_step(
        model, ocfg, microbatches=mb, remat=True, mesh=mesh), rows16))
    del pt
    torch.cuda.empty_cache()
    t["all"] = time.perf_counter() - t_fam
    res["seconds"] = t
    note(f"(d) {fam} bf16 steps: losses {res['losses']}, seconds "
         f"{[round(x, 4) for x in res['step_seconds']]}, peak "
         f"{res['max_memory_allocated'] / 2**30:.2f} GiB, launches "
         f"{res['launches']}; {t['all']:.1f}s")
    dist.barrier()
    return res


def model_axis_worker(out_dir: str) -> int:
    """One rank of the model_axis phase, under ``torchrun
    --nproc-per-node 2``: a (data 1, model 2) mesh over gloo, both ranks
    on the one card. (a) full-width 2-layer Llama-2-7B on the train
    phase's 4 x 4096 tokens (2 microbatches, remat): the f32 copy's loss
    and gradients (gathered; rank 0 then takes the single-device step's
    own), 4 bf16 steps (seconds, tokens/s, peak memory, flash launches by
    variant); (b) a sharded save of the step-2 state, its restore with
    ``shardings=``, bit for bit on every rank, step 3 from it against the
    uninterrupted step 3, and each leaf's shard checksums for the parent's
    own restore; (c) full-width 2-layer Qwen3-MoE: a bf16 forward and
    backward through expert parallelism (64 experts a rank), layer 0's
    experts alone (``_apply_ep``) against ``_apply_ep_plain`` at tp 2 on
    rank 0, and the f32 copy's forward and backward on the mesh, its loss
    and gradients (gathered) against rank 0's single-device step with
    ``moe.apply`` as ``_apply_ep_plain`` at tp 2; (d) the vlm, hybrid,
    audio and ssm families at full width (``MODEL_AXIS_FAMILIES``,
    ``model_axis_family``). Writes ``out_dir/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo, moe
    from repro_torch.models import parallel as par
    from repro_torch.runtime import elastic
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import (
        TrainState, data_rows, loss_and_grads, make_train_step)

    t_all = time.perf_counter()
    mesh = mesh_lib.make_production_mesh(model_parallel=MODEL_AXIS_RANKS,
                                         device_type="cuda")
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    tokens = torch.load(os.path.join(out_dir, "tokens.pt")).to(dev)
    res = {"rank": rank, "world": dist.get_world_size(),
           "backend": dist.get_backend(), "mesh": list(mesh.shape),
           "device": str(dev)}
    t = {}
    mb = TRAIN_MICROBATCHES

    def note(msg: str) -> None:
        print(f"[model_axis rank {rank}] {msg}", flush=True)

    def flag_all(ok: bool) -> bool:
        """``ok`` on every rank."""
        v = torch.tensor([0 if ok else 1], device=dev)
        dist.all_reduce(v)
        return int(v) == 0

    # (a) dense tensor parallelism, full-width Llama-2-7B
    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    model = model_zoo.build(cfg)
    model32 = model_zoo.build(cfg.scaled(dtype="float32"))
    layout = par.Layout(model, mesh)
    rows = data_rows({"tokens": tokens}, mesh, mb)
    params = model.init_params(seed=0, device=dev)
    t0 = time.perf_counter()
    p32 = elastic.reshard(to_f32(params), model32.param_specs(), mesh)
    zero_counts()
    views, m32 = loss_and_grads(
        model32, opt.tree_unflatten(p32, layout.views(p32)), rows,
        microbatches=mb, remat=True, axis=layout.axis)
    torch.cuda.synchronize()
    res["launches_f32"] = train_counts()
    grads = [par.whole(g) for g in opt.tree_leaves(
        layout.grads(p32, opt.tree_leaves(views)))]
    del views, p32
    torch.cuda.empty_cache()
    t["f32_tp"] = time.perf_counter() - t0
    res["loss_f32_tp"] = float(m32["loss"])
    note(f"(a) f32 copy on the mesh: loss {res['loss_f32_tp']:.6f}, "
         f"{t['f32_tp']:.1f}s, launches {res['launches_f32']}")
    if rank == 0:  # the single-device step's loss and gradients
        t0 = time.perf_counter()
        g1, m1 = loss_and_grads(model32, to_f32(params), {"tokens": tokens},
                                microbatches=mb, remat=True)
        rel, worst = rel_frobenius(torch, grads, g1, _leaf_names(g1))
        res["loss_f32_single"] = float(m1["loss"])
        res["grad_rel_frobenius"], res["grad_worst"] = rel, worst
        del g1
        t["f32_single"] = time.perf_counter() - t0
        note(f"(a) single device: loss {res['loss_f32_single']:.6f}, worst "
             f"gradient {res['grad_worst']}")
    del grads
    torch.cuda.empty_cache()
    dist.barrier()

    ocfg = opt.OptConfig(**TRAIN_OPT)
    pt = elastic.reshard(params, model.param_specs(), mesh)
    del params
    state = TrainState(pt, opt.init(pt, ocfg))
    step = make_train_step(model, ocfg, microbatches=mb, remat=True,
                           mesh=mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    losses, gnorms, secs, kept = [], [], [], {}
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state, rows)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        if i + 1 in (2, 3):
            kept[i + 1] = state
    res["launches"] = train_counts()
    res["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    res.update(losses=losses, grad_norms=gnorms, step_seconds=secs)
    steady = _median(secs[1:])
    res["seconds_per_step"] = steady
    res["tokens_per_s"] = tokens.numel() / steady
    note(f"(a) bf16 steps: losses {losses}, seconds {secs}, peak "
         f"{res['max_memory_allocated'] / 2**30:.2f} GiB, launches "
         f"{res['launches']}")
    del state

    # (b) the step-2 state saved sharded, restored with shardings=
    t0 = time.perf_counter()
    ck_dir = os.path.join(out_dir, "ckpt")
    ckpt = Checkpointer(ck_dir, async_save=True)
    s2 = kept[2]
    ckpt.save(2, s2, metadata={"mesh": list(mesh.shape)})
    ckpt.wait()
    t["save"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back, meta = ckpt.restore(s2, step=2, shardings=launch_train
                              .shardings_for(mesh, model, s2))
    torch.cuda.synchronize()
    t["restore"] = time.perf_counter() - t0
    same = all(a.placements == b.placements and torch.equal(
        a.to_local(), b.to_local()) for a, b in zip(
            _state_leaves(back), _state_leaves(s2)))
    res["restore_bitwise"] = flag_all(same)
    res["restore_meta"] = meta
    r3, _ = step(back, rows)
    res["step3_bitwise"] = flag_all(all(torch.equal(
        a.to_local(), b.to_local()) for a, b in zip(
            opt.tree_leaves(r3.params), opt.tree_leaves(kept[3].params))))
    res["shard_checksums"] = [checksum(torch, x.to_local())
                              for x in _state_leaves(s2)]
    res["shard_placements"] = [repr(x.placements)
                               for x in _state_leaves(s2)]
    note(f"(b) save {t['save']:.1f}s, restore {t['restore']:.1f}s, bitwise "
         f"{res['restore_bitwise']}, step 3 bitwise {res['step3_bitwise']}")
    del back, r3, kept, s2, step
    torch.cuda.empty_cache()

    # (c) expert parallelism, full-width Qwen3-MoE
    t0 = time.perf_counter()
    mcfg = ARCHS[MOE_ARCH].scaled(n_layers=MOE_LAYERS)
    mmodel = model_zoo.build(mcfg)
    mlayout = par.Layout(mmodel, mesh)
    B, S = MODEL_AXIS_MOE_TOKENS
    mtok = {"tokens": tokens[:B, :S].contiguous()}
    mparams = mmodel.init_params(seed=0, device=dev)
    mp = elastic.reshard(mparams, mmodel.param_specs(), mesh)
    moe._apply_ep.calls = 0
    mviews, mm = loss_and_grads(
        mmodel, opt.tree_unflatten(mp, mlayout.views(mp)), mtok,
        microbatches=1, remat=False, axis=mlayout.axis)
    torch.cuda.synchronize()
    res["moe_ep_calls"] = moe._apply_ep.calls
    res["moe_loss"] = float(mm["loss"])
    res["moe_grads_finite"] = flag_all(all(
        bool(torch.isfinite(g).all()) for g in opt.tree_leaves(mviews)))
    res["moe_modes"] = sorted({leaf.mode for leaf in mlayout.of(mp)})
    del mviews
    t["moe_model"] = time.perf_counter() - t0
    note(f"(c) moe forward and backward: loss {res['moe_loss']:.4f}, EP "
         f"calls {res['moe_ep_calls']}, {t['moe_model']:.1f}s")

    t0 = time.perf_counter()
    axis = par.ModelAxis(mesh)
    layer = mp["layers"][0]["ffn"]
    # the router whole, this rank's experts
    p = {k: (par.whole(v) if k == "router" else v.to_local()).to(
        torch.float32).clone().requires_grad_() for k, v in layer.items()}
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((B, S, mcfg.d_model), generator=g, device=dev)
    dy = torch.randn((B, S, mcfg.d_model), generator=g, device=dev)
    xr = x.clone().requires_grad_()
    y, aux, keep = moe._apply_ep(p, mcfg, xr, axis)
    gr = torch.autograd.grad((y * dy).sum() + aux,
                             [xr] + [p[k] for k in sorted(p)])
    names = ["x"] + sorted(p)
    shards = {k: par.all_gather(gr[names.index(k)], 0, axis.model_group)
              for k in ("w_in", "w_gate", "w_out")}
    keeps = par.all_gather(keep[None], 0, axis.model_group)
    whole = {k: par.all_gather(p[k].detach(), 0, axis.model_group)
             for k in ("w_in", "w_gate", "w_out")}
    if rank == 0:
        pw = {"router": p["router"].detach().clone().requires_grad_(),
              **{k: v.requires_grad_() for k, v in whole.items()}}
        xw = x.clone().requires_grad_()
        yw, auxw, keepw = moe._apply_ep_plain(pw, mcfg, xw, MODEL_AXIS_RANKS)
        gw = torch.autograd.grad((yw * dy).sum() + auxw,
                                 [xw] + [pw[k] for k in sorted(pw)])
        want = dict(zip(names, gw))
        got = {"x": gr[0], "router": gr[names.index("router")], **shards}
        outs, _ = rel_frobenius(torch, [y, aux], [yw, auxw], ["y", "aux"])
        ep = {"keep_equal": bool(torch.equal(keeps, keepw)),
              "pairs": keepw[0].numel(), "kept": int(keepw.sum()),
              "capacity": moe.capacity(S, mcfg),
              "y_rel": outs["y"], "aux_rel": outs["aux"],
              "grad_rel": rel_frobenius(torch, list(got.values()), [
                  want[k] for k in got], list(got))[0]}
        ep["dropped"] = ep["pairs"] - ep["kept"]
        res["ep_layer"] = ep
        del pw, xw, yw, gw, want, got
    del p, gr, shards, whole, mp, layer
    torch.cuda.empty_cache()
    t["moe_layer"] = time.perf_counter() - t0

    # the f32 copy's step on the mesh against one device running
    # _apply_ep_plain at tp 2 in place of the dispatch (the EP semantics)
    t0 = time.perf_counter()
    mmodel32 = model_zoo.build(mcfg.scaled(dtype="float32"))
    mp32 = elastic.reshard(to_f32(mparams), mmodel32.param_specs(), mesh)
    mviews, mm = loss_and_grads(
        mmodel32, opt.tree_unflatten(mp32, mlayout.views(mp32)), mtok,
        microbatches=1, remat=False, axis=mlayout.axis)
    mgrads = [par.whole(g) for g in opt.tree_leaves(
        mlayout.grads(mp32, opt.tree_leaves(mviews)))]
    del mviews, mp32
    torch.cuda.empty_cache()
    res["moe_loss_f32_tp"] = float(mm["loss"])
    if rank == 0:
        real = moe.apply
        moe.apply = lambda p, c, x: moe._apply_ep_plain(
            p, c, x, MODEL_AXIS_RANKS)[:2]
        try:
            g1, m1 = loss_and_grads(mmodel32, to_f32(mparams), mtok,
                                    microbatches=1, remat=False)
        finally:
            moe.apply = real
        rel, worst = rel_frobenius(torch, mgrads, g1, _leaf_names(g1))
        res["moe_loss_f32_single"] = float(m1["loss"])
        res["moe_grad_worst"] = worst
        res["moe_grad_rel_frobenius"] = rel
        del g1
    del mgrads, mparams
    torch.cuda.empty_cache()
    t["moe_f32"] = time.perf_counter() - t0
    note(f"(c) f32 copy: loss on the mesh {res['moe_loss_f32_tp']:.6f}, "
         f"{t['moe_f32']:.1f}s")

    # (d) the vlm, hybrid, audio and ssm families
    res["families"] = {fam: model_axis_family(torch, dev, mesh, fam, tokens,
                                              note)
                       for fam in MODEL_AXIS_FAMILIES}
    t["all"] = time.perf_counter() - t_all
    res["seconds"] = t
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _state_leaves(state) -> list:
    from repro_torch.train import optimizer as opt

    return (opt.tree_leaves(state.params) + [state.opt.step]
            + [x for t in (state.opt.m, state.opt.v, state.opt.master)
               for x in opt.tree_leaves(t)])


def run_ranks(worker: str, out_dir: str, n: int, timeout_s: int,
              tag: str, show: tuple = ()) -> float:
    """``chip_smoke.py <worker> <out_dir>`` on ``n`` ranks under torchrun
    (its own session: on a timeout every rank is killed with it); the
    ranks' lines starting with one of ``show``, or naming an error, are
    logged."""
    import signal

    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        if f.startswith("rank"):
            os.remove(os.path.join(out_dir, f))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", os.path.abspath(__file__), worker,
         out_dir], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise Failed(f"{tag} ranks did not end within {timeout_s} s")
    for line in out.splitlines():
        if (show and line.startswith(show)) or "Error" in line:
            log(f"[{tag}]   {line}")
    if proc.returncode != 0:
        log(out[-6000:])
        raise Failed(f"{tag} ranks exited {proc.returncode}")
    return time.perf_counter() - t0


def model_axis_family_checks(ranks: list) -> tuple[dict, dict]:
    """(checks, summary) of the model_axis phase's (d) cases from the
    ranks' results: each family's f32 loss and gradients and 4 bf16 steps
    against rank 0's single-device runs, its flash launches a rank against
    the host plan, and its ranks' peaks; one log line each."""
    r0, mb = ranks[0], TRAIN_MICROBATCHES
    fam_checks, fam_summary = {}, {}
    for fam, (_, _, (B, S)) in MODEL_AXIS_FAMILIES.items():
        fr = r0["families"][fam]
        one = fr["single"]
        loss_rel_f = [abs(a - b) / abs(b)
                      for a, b in zip(fr["losses"], one["losses"])]
        gnorm_rel_f = [abs(a - b) / abs(b)
                       for a, b in zip(fr["grad_norms"], one["grad_norms"])]
        f32_rel = (abs(fr["loss_f32_tp"] - fr["loss_f32_single"])
                   / abs(fr["loss_f32_single"]))
        # the host plan: each self-attention past 2048 positions through
        # the flash pair (forward with lse twice under remat, one backward)
        # a layer (the hybrid: a group) and microbatch
        noise = max(((v, n) for n, v in fr["grad_noise_leaves"].items()),
                    default=(0.0, None))
        loss_bar, gnorm_bar, held = MODEL_AXIS_BF16_BARS.get(
            fam, (MODEL_AXIS_LOSS_RTOL, MODEL_AXIS_GNORM_RTOL, TRAIN_STEPS))
        n_attn = fr["flash_attentions"]
        fwd, bwd = n_attn * mb * 2, n_attn * mb

        def plan(impl, f, b):
            return {"flash_attention": f, "flash_attention_bwd": b,
                    "flash_attention_by_impl": {impl: f} if f else {},
                    "flash_attention_bwd_by_impl": {impl: b} if b else {}}

        want_f = plan("tc", TRAIN_STEPS * fwd, TRAIN_STEPS * bwd)
        want32_f = plan("fp32", fwd, bwd)
        peaks = [rk["families"][fam]["max_memory_allocated"] for rk in ranks]
        log(f"[model_axis] (d) {fam} {fr['arch']} ({fr['layers']} layers), "
            f"{B} x {S} tokens in {mb} microbatches: f32 loss on the mesh "
            f"{fr['loss_f32_tp']:.6f}, one device "
            f"{fr['loss_f32_single']:.6f} (relative {f32_rel:.2e}); "
            f"gradients relative Frobenius worst {fr['grad_worst'][0]:.2e} "
            f"({fr['grad_worst'][1]}), scan and gate-bias leaves "
            f"{fr['grad_worst_scan'][0]:.2e} ({fr['grad_worst_scan'][1]}); "
            f"rounding-noise leaves, worst of the tree's max: "
            f"{noise[0]:.2e} ({noise[1]})")
        log(f"[model_axis] (d) {fam} bf16, 4 steps: mesh "
            f"{fr['seconds_per_step']:.4f} s a step, "
            f"{fr['tokens_per_s']:.1f} tokens/s, peak a rank "
            f"{[round(x / 2**30, 2) for x in peaks]} GiB; one device "
            f"{one['seconds_per_step']:.4f} s, {one['tokens_per_s']:.1f} "
            f"tokens/s, {one['max_memory_allocated'] / 2**30:.2f} GiB; "
            f"losses {fr['losses']} vs {one['losses']} (relative "
            f"{[f'{x:.2e}' for x in loss_rel_f]}), grad norms relative "
            f"{[f'{x:.2e}' for x in gnorm_rel_f]}; flash launches a rank "
            f"{fr['launches']} (f32 {fr['launches_f32']}), planned {want_f} "
            f"(f32 {want32_f}); read whole {fr['read_whole']}, "
            f"{fr['read_whole_bytes'] / 2**20:.1f} MiB gathered a step a "
            f"rank, FULL_SUM gradients {fr['full_sum_grad_bytes'] / 2**20:.1f}"
            f" MiB all-reduced; {fr['seconds']['all']:.1f}s")
        fam_summary[fam] = {"loss_rel_vs_single": loss_rel_f,
                            "grad_norm_rel_vs_single": gnorm_rel_f,
                            "f32_loss_rel": f32_rel,
                            "predicted": {"bf16": want_f, "f32": want32_f},
                            "peaks": peaks}
        fam_checks.update({
            f"{fam}: f32 loss within 1e-4 of one device": f32_rel <= 1e-4,
            f"{fam}: f32 gradients within 1e-4 of one device":
                fr["grad_worst"][0] <= TRAIN_GRAD_RTOL,
            f"{fam}: f32 scan and gate-bias leaves within 3.3e-4 of one "
            "device":
                fr["grad_worst_scan"][0] <= TRAIN_SCAN_GRAD_RTOL,
            f"{fam}: f32 rounding-noise leaves within 1e-6 of the tree's "
            "max": all(x <= MODEL_AXIS_NOISE_FRAC
                       for x in fr["grad_noise_leaves"].values()),
            f"{fam}: bf16 losses within {loss_bar} of one device, "
            f"steps 1-{held}": len(loss_rel_f) == TRAIN_STEPS
            and max(loss_rel_f[:held]) <= loss_bar,
            f"{fam}: bf16 grad norms within {gnorm_bar} of one device, "
            f"steps 1-{held}": max(gnorm_rel_f[:held]) <= gnorm_bar,
            f"{fam}: bf16 loss finite and falling": all(
                math.isfinite(x) for x in fr["losses"])
            and fr["losses"][-1] < fr["losses"][0],
            f"{fam}: ranks agree on the loss": all(
                rk["families"][fam]["losses"] == fr["losses"]
                for rk in ranks),
            f"{fam}: flash launches a rank as planned": all(
                rk["families"][fam]["launches"] == want_f
                and rk["families"][fam]["launches_f32"] == want32_f
                for rk in ranks),
            f"{fam}: both ranks' peaks within 72 GiB":
                sum(peaks) <= 72 * 2**30,
        })
    return fam_checks, fam_summary


def phase_model_axis(torch, dev, tokens, train_res) -> dict:
    """The mesh's model axis: ``model_axis_worker`` on 2 gloo ranks sharing
    the card, held to the single-device runs (the train phase's 4 bf16
    steps on the same tokens and seed; rank 0's own single-device f32
    gradients; ``_apply_ep_plain``), then the sharded checkpoint restored
    in this process (world 1, NCCL) with ``shardings=`` on a 1 x 1 mesh,
    each leaf cut as the ranks hold it, checksum for checksum; and the
    vlm, hybrid, audio and ssm families' f32 gradients and bf16 steps
    against rank 0's single-device runs (gradients within 1e-4 a leaf,
    the Mamba scan's per-head leaves and the xLSTM's forget-gate biases
    3.3e-4; losses and grad norms as the dense case's but for the xLSTM,
    MODEL_AXIS_BF16_BARS), the loss finite and falling, their flash
    launches a rank against the plan."""
    import shutil

    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs import ARCHS
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model_zoo
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import init_state

    t_phase = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "repro_torch", "model_axis")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.save(tokens.cpu(), os.path.join(out_dir, "tokens.pt"))
    torch.cuda.empty_cache()
    t_ranks = run_ranks("model-axis-worker", out_dir, MODEL_AXIS_RANKS,
                        MODEL_AXIS_TIMEOUT_S, "model_axis",
                        show=("[model_axis rank",))
    ranks = []
    for r in range(MODEL_AXIS_RANKS):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    L, mb = 2, TRAIN_MICROBATCHES
    want = {"flash_attention": TRAIN_STEPS * L * mb * 2,
            "flash_attention_bwd": TRAIN_STEPS * L * mb,
            "flash_attention_by_impl": {"tc": TRAIN_STEPS * L * mb * 2},
            "flash_attention_bwd_by_impl": {"tc": TRAIN_STEPS * L * mb}}
    want32 = {"flash_attention": L * mb * 2, "flash_attention_bwd": L * mb,
              "flash_attention_by_impl": {"fp32": L * mb * 2},
              "flash_attention_bwd_by_impl": {"fp32": L * mb}}
    single = train_res["losses"]
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], single)]
    gnorm_rel = [abs(a - b) / abs(b) for a, b in zip(
        r0["grad_norms"], train_res["grad_norms"])]
    for rk in ranks:
        log(f"[model_axis] rank {rk['rank']} of {rk['world']}: backend "
            f"{rk['backend']}, mesh (data, model) {rk['mesh']}, "
            f"{rk['device']}; bf16 losses {rk['losses']}, grad norms "
            f"{rk['grad_norms']}, seconds "
            f"{[round(x, 4) for x in rk['step_seconds']]}"
            f"; {rk['seconds_per_step']:.4f} s a step, "
            f"{rk['tokens_per_s']:.1f} tokens/s, max_memory_allocated "
            f"{rk['max_memory_allocated'] / 2**30:.2f} GiB; launches "
            f"{rk['launches']} (f32 copy {rk['launches_f32']}); seconds "
            f"{ {k: round(v, 2) for k, v in rk['seconds'].items()} }")
    log(f"[model_axis] (a) f32 copy: loss on the mesh "
        f"{r0['loss_f32_tp']:.6f}, single device {r0['loss_f32_single']:.6f}"
        f"; gradients gathered vs single device, relative Frobenius worst "
        f"{r0['grad_worst'][0]:.2e} ({r0['grad_worst'][1]}); bf16 losses "
        f"vs the train phase's single-device steps {single}: relative "
        f"{[f'{x:.2e}' for x in loss_rel]}; grad norms vs "
        f"{train_res['grad_norms']}: relative "
        f"{[f'{x:.2e}' for x in gnorm_rel]}")
    log(f"[model_axis] (b) restore with shardings= bitwise "
        f"{r0['restore_bitwise']}, step 3 from it bitwise "
        f"{r0['step3_bitwise']}")
    ep = r0["ep_layer"]
    log(f"[model_axis] (c) {MOE_ARCH}: forward and backward of "
        f"{MODEL_AXIS_MOE_TOKENS} tokens, loss {r0['moe_loss']:.4f}, "
        f"_apply_ep calls {r0['moe_ep_calls']}, modes {r0['moe_modes']}; "
        f"layer 0 alone vs _apply_ep_plain (tp 2): keep equal "
        f"{ep['keep_equal']}, {ep['dropped']} of {ep['pairs']} (token, k) "
        f"pairs dropped at capacity {ep['capacity']}, y {ep['y_rel']:.2e}, "
        f"aux {ep['aux_rel']:.2e}, gradients "
        + ", ".join(f"{k} {v:.2e}" for k, v in ep["grad_rel"].items()))
    moe_loss_rel = (abs(r0["moe_loss_f32_tp"] - r0["moe_loss_f32_single"])
                    / abs(r0["moe_loss_f32_single"]))
    log(f"[model_axis] (c) f32 copy: loss on the mesh "
        f"{r0['moe_loss_f32_tp']:.6f}, one device with _apply_ep_plain "
        f"(tp 2) {r0['moe_loss_f32_single']:.6f} (relative "
        f"{moe_loss_rel:.2e}); gradients gathered, relative Frobenius worst "
        f"{r0['moe_grad_worst'][0]:.2e} ({r0['moe_grad_worst'][1]}) of "
        f"{len(r0['moe_grad_rel_frobenius'])} leaves")

    # (d) the other families, each against rank 0's single-device runs
    fam_checks, fam_summary = model_axis_family_checks(ranks)

    # (b) world 1: the same checkpoint restored here, cut as the ranks
    t0 = time.perf_counter()
    cfg = ARCHS["llama2-7b"].scaled(n_layers=2)
    model = model_zoo.build(cfg)
    hmesh = mesh_lib.make_host_mesh("cuda")
    like = init_state(model, 0, opt.OptConfig(**TRAIN_OPT), device=dev,
                      mesh=hmesh)
    back, meta = Checkpointer(os.path.join(out_dir, "ckpt")).restore(
        like, step=2, shardings=launch_train.shardings_for(hmesh, model,
                                                           like))
    del like
    sums = [[] for _ in ranks]
    for leaf, placed in zip(_state_leaves(back), r0["shard_placements"]):
        whole = leaf.to_local()
        shard_dim = re.search(r"Shard\(dim=(\d+)\)\)$", placed)
        for r in range(len(ranks)):
            part = (whole.chunk(len(ranks), int(shard_dim.group(1)))[r]
                    if shard_dim else whole)
            sums[r].append(checksum(torch, part))
    world1_ok = all(sums[r] == ranks[r]["shard_checksums"]
                    for r in range(len(ranks)))
    backend_1 = dist.get_backend()
    del back
    dist.destroy_process_group()
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    t_world1 = time.perf_counter() - t0
    log(f"[model_axis] (b) world 1 ({backend_1}): restore with shardings= "
        f"on a 1 x 1 mesh, every leaf's shard checksums equal the ranks' "
        f"{world1_ok}; {t_world1:.1f}s")

    checks = {
        "2 gloo ranks on a (1, 2) mesh": all(
            (rk["backend"], rk["world"], rk["mesh"]) == ("gloo", 2, [1, 2])
            for rk in ranks),
        "f32 loss within 1e-4 of the single device": abs(
            r0["loss_f32_tp"] - r0["loss_f32_single"])
        <= 1e-4 * abs(r0["loss_f32_single"]),
        "f32 gradients within 1e-4 of the single device":
            r0["grad_worst"][0] <= TRAIN_GRAD_RTOL,
        "bf16 losses within 1e-3 of the single device":
            max(loss_rel) <= MODEL_AXIS_LOSS_RTOL,
        "bf16 grad norms within 5e-3 of the single device":
            len(gnorm_rel) == TRAIN_STEPS
            and max(gnorm_rel) <= MODEL_AXIS_GNORM_RTOL,
        "bf16 loss finite and falling": all(
            math.isfinite(x) for x in r0["losses"])
        and r0["losses"][-1] < r0["losses"][0],
        "ranks agree on the loss": all(
            rk["losses"] == r0["losses"] for rk in ranks),
        "flash launches a rank as planned": all(
            rk["launches"] == want and rk["launches_f32"] == want32
            for rk in ranks),
        "restore bitwise at world 2": r0["restore_bitwise"],
        "step 3 from the restore bitwise": r0["step3_bitwise"],
        "restore at world 1 equals the ranks' shards": world1_ok,
        "moe: _apply_ep once a layer": all(
            rk["moe_ep_calls"] == L for rk in ranks),
        "moe: loss and gradients finite": math.isfinite(r0["moe_loss"])
        and r0["moe_grads_finite"],
        "moe: keep masks equal": ep["keep_equal"],
        "moe: pairs dropped": ep["dropped"] > 0,
        "moe: y, aux and gradients within 1e-4": max(
            [ep["y_rel"], ep["aux_rel"], *ep["grad_rel"].values()])
        <= TRAIN_GRAD_RTOL,
        "moe f32 step: loss within 1e-4 of one device with _apply_ep_plain":
            moe_loss_rel <= 1e-4,
        "moe f32 step: gradients within 1e-4 of one device with "
        "_apply_ep_plain": r0["moe_grad_worst"][0] <= TRAIN_GRAD_RTOL,
        **fam_checks,
    }
    t_phase = time.perf_counter() - t_phase
    log(f"[model_axis] phase {t_phase:.1f}s (ranks {t_ranks:.1f}s)")
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise Failed(f"model_axis phase checks failed: {bad}")
    return {"ranks": ranks, "loss_rel_vs_single": loss_rel,
            "grad_norm_rel_vs_single": gnorm_rel,
            "moe_loss_rel_vs_plain": moe_loss_rel,
            "predicted": {"bf16": want, "f32": want32},
            "world1_checksums_equal": world1_ok, "families": fam_summary,
            "seconds": {"phase": t_phase, "ranks": t_ranks,
                        "world1_restore": t_world1}}


def kernel_line(rows: list[dict], launches: dict) -> dict:
    """One entry per kernel source, at the shape its path launches most:
    vq_dequant_matmul at the eval's M=512 on a 4096x4096 projection,
    vq_assign.cu at its group sweep over one 4096 x 256 group of wq (the
    main path launches the sweep and EM, not vq_assign itself),
    paged_attention at the long serve run's B=4, 32 heads of 128, 256 pages
    a slot, bf16 queries over f32 pages, flash_attention at the long
    phase's heldout B=8, 32 heads of 128, 4096 tokens, bf16; and the group
    sweep's babai metric mode at the same wq group. Launches: the main
    phase's for the first two (vq_assign.cu's three entry points summed),
    the long serve run's for paged_attention, the long phase's for
    flash_attention, the budget phase's method table for the babai
    sweep; and the expert-stacked vq_dequant_matmul at a Qwen3-MoE decode
    tick's w_in stack (128 experts of 32 rows), launches from the moe
    phase's serve run. The audio phase's: vq_assign.cu at its group sweep
    over one 3,072 x 256 group of whisper's w_in, launches its quantize's
    (the three entry points summed); paged_attention at head dim 64
    (whisper-small's serve shape, bf16 queries over f32 pages), launches
    from its serve run; vq_dequant_matmul at whisper's w_in over the
    encoder evaluation's 12,000 rows, launches from its fused evaluation
    and its serve run. The train phase's: flash_attention at its
    microbatch (B=2, 32 heads of 128, 4096 tokens, bf16; launches the 4
    steps' forwards) and flash_attention_bwd at the same shape, once per
    variant: tc in bf16 (launches the 4 steps' backwards) and fp32 in f32
    (launches the f32 gradient check's; library_ms SDPA's backward alone
    in the row's dtype). The train_families phase's: flash_attention
    with its log-sum-exp output at the hybrid's microbatch (B=2, 32 heads
    of 112, 4096 tokens, bf16; launches the 4 hybrid steps' forwards) and
    flash_attention_bwd's tc variant at the same shape (launches their
    backwards). The model_axis phase's: the same pair at one rank's heads
    of the train microbatch on a model axis of 2 (B=2, 16 heads of 128,
    4096 tokens, bf16; launches rank 0's in its 4 bf16 steps), and at
    one rank's heads of the vlm's (16 of 96) and the hybrid's (16 of 112)
    microbatches (launches rank 0's in their 4 bf16 steps).
    library_ms
    is each row's own: for vq_dequant_matmul at int8 codebooks a bf16
    torch.matmul."""
    pick = {
        "vq_dequant_matmul": (
            "vq_dequant_matmul",
            lambda r: r["shape"] == "wq" and r["M"] == 512
            and r["scale_block"] == 0 and r["cb_form"] == "int8",
            "src/repro_torch/kernels/csrc/vq_dequant_matmul.cu",
            "src/repro/kernels/vq_dequant_matmul.py:137"),
        "vq_assign": (
            "vq_group_sweep",
            lambda r: r["shape"] == "wq group" and r["metric"] == "diag",
            "src/repro_torch/kernels/csrc/vq_assign.cu",
            "src/repro/kernels/vq_assign.py:37"),
        "vq_group_sweep_babai": (
            "vq_group_sweep",
            lambda r: r["shape"] == "wq group" and r["metric"] == "babai",
            "src/repro_torch/kernels/csrc/vq_assign.cu",
            "src/repro/kernels/vq_assign.py:37"),
        "paged_attention": (
            "paged_attention",
            lambda r: r["shape"] == "long" and r["fmt"] == "f32"
            and r["q_dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:128"),
        "flash_attention": (
            "flash_attention",
            lambda r: r["shape"] == "llama B=8" and r["dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "vq_dequant_matmul_experts": (
            "vq_dequant_matmul",
            lambda r: r["shape"] == "w_in experts"
            and r["M"] == MOE_SLAB_ROWS[0],
            "src/repro_torch/kernels/csrc/vq_dequant_matmul.cu",
            "src/repro/kernels/vq_dequant_matmul.py:137"),
        "vq_assign_whisper": (
            "vq_group_sweep",
            lambda r: r["shape"] == "whisper w_in group"
            and r["metric"] == "diag",
            "src/repro_torch/kernels/csrc/vq_assign.cu",
            "src/repro/kernels/vq_assign.py:37"),
        "paged_attention_hd64": (
            "paged_attention",
            lambda r: r["shape"] == "whisper serve" and r["fmt"] == "f32"
            and r["q_dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention.py:128"),
        "vq_dequant_matmul_whisper": (
            "vq_dequant_matmul",
            lambda r: r["shape"] == "whisper w_in"
            and r["M"] == AUDIO_ENC_ROWS,
            "src/repro_torch/kernels/csrc/vq_dequant_matmul.cu",
            "src/repro/kernels/vq_dequant_matmul.py:137"),
        "flash_attention_train": (
            "flash_attention",
            lambda r: r["shape"] == "llama B=2" and r["dtype"] == "bfloat16",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "train" and r["impl"] == "tc",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd_fp32": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "train" and r["impl"] == "fp32",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_train_hd112": (
            "flash_attention_lse",
            lambda r: r["shape"] == "zamba B=2",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd_hd112": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "zamba train" and r["impl"] == "tc",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_train_tp": (
            "flash_attention_lse",
            lambda r: r["shape"] == "llama tp B=2",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd_tp": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "tp train" and r["impl"] == "tc",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_train_hd96_tp": (
            "flash_attention_lse",
            lambda r: r["shape"] == "phi3 tp B=2",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd_hd96_tp": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "phi3 tp train" and r["impl"] == "tc",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_train_hd112_tp": (
            "flash_attention_lse",
            lambda r: r["shape"] == "zamba tp B=2",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
        "flash_attention_bwd_hd112_tp": (
            "flash_attention_bwd",
            lambda r: r["shape"] == "zamba tp train" and r["impl"] == "tc",
            "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:68"),
    }
    out = []
    for name, (row_name, sel, source, replaces) in pick.items():
        r = next(r for r in rows if r["name"] == row_name and sel(r))
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches.get(name, 0),
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
        if r.get("bound_issued_ms") is not None:
            out[-1]["bound_issued_ms"] = r["bound_issued_ms"]
    return {"kernels": out}


def paged_rows(torch, dev) -> list[dict]:
    """paged_attention's kernels-phase rows: every shape at every page
    format with f32 queries, and the serve dtypes with bf16 ones; the moe
    serve shape at its path's bf16 queries over f32 pages."""
    rows = []
    for shape in PAGED_SHAPES:
        if shape == "moe serve":  # the moe phase's own dtypes only
            rows.append(check_paged(torch, dev, shape, "f32",
                                    torch.bfloat16))
            continue
        for fmt in ("f32", "bf16", 8, 4, "vq2"):
            rows.append(check_paged(torch, dev, shape, fmt, torch.float32))
        # the serve path's own dtypes: the bf16 model's queries over the
        # engine's f32 pages and over each quantized page format
        if shape != "gqa":
            for fmt in ("f32", 8, 4, "vq2"):
                rows.append(check_paged(torch, dev, shape, fmt,
                                        torch.bfloat16))
    return rows


def main() -> int:
    out_dir = os.path.join(ROOT, "chiprun_out")
    workers = {"mesh-worker": mesh_worker,
               "model-axis-worker": model_axis_worker}
    if sys.argv[1:2] and sys.argv[1] in workers:
        from repro_torch.launch.mesh import close_world

        code = workers[sys.argv[1]](sys.argv[2])
        close_world()  # the rank's gloo threads joined before shutdown
        return code
    if sys.argv[1:2] == ["grad-readings"]:
        return grad_readings([int(a) for a in sys.argv[2:]])

    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from the root of a checkout of the repository",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    t_all = time.perf_counter()
    dev, name, smi = phase_device(torch)
    phase_build()
    rows, invariance = phase_kernels(torch, dev)
    small_res = phase_small(torch, dev)
    main_res, model, qparams, (calib, heldout) = phase_main(torch, dev)
    mesh_res = phase_mesh(torch, dev, main_res, qparams)
    budget_res = phase_budget(torch, dev, model, calib, heldout)
    serve_res = phase_serve(torch, dev, model, qparams)
    del model, qparams
    long_calib, long_heldout, long_res = phase_long(torch, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_res = phase_train(torch, dev, long_calib)
    log(f"[train] phase {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    train_families_res = phase_train_families(torch, dev, long_calib)
    torch.cuda.empty_cache()
    model_axis_res = phase_model_axis(torch, dev, long_calib, train_res)
    torch.cuda.empty_cache()
    moe_res = phase_moe(torch, dev)
    torch.cuda.empty_cache()
    vlm_res = phase_vlm(torch, dev, long_calib, long_heldout)
    torch.cuda.empty_cache()
    ssm_res = phase_ssm(torch, dev)
    torch.cuda.empty_cache()
    hybrid_res = phase_hybrid(torch, dev, long_calib, long_heldout)
    torch.cuda.empty_cache()
    audio_res = phase_audio(torch, dev)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "chip_smoke.json")
    with open(out, "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": rows,
                   "bitwise": invariance,
                   "small": small_res, "main": main_res,
                   "budget": budget_res, "serve": serve_res, "long": long_res,
                   "train": train_res,
                   "train_families": train_families_res, "mesh": mesh_res,
                   "model_axis": model_axis_res,
                   "moe": moe_res, "vlm": vlm_res, "ssm": ssm_res,
                   "hybrid": hybrid_res, "audio": audio_res}, f,
                  indent=1, default=str)
    log(f"[done] {time.perf_counter() - t_all:.1f}s; details in {out}")
    launches = dict(main_res["launches"], paged_attention=serve_res[
        "long"]["launches"]["paged_attention"],
        flash_attention=long_res["launches"]["flash_attention"])
    launches["vq_assign"] = sum(main_res["launches"][fn]
                                for fn in VQ_ENTRY_POINTS)
    launches["vq_assign_whisper"] = sum(audio_res["launches"][fn]
                                        for fn in VQ_ENTRY_POINTS)
    launches["paged_attention_hd64"] = audio_res["serve"]["launches"][
        "paged_attention"]
    launches["vq_dequant_matmul_whisper"] = (
        audio_res["eval_launches"]["launches"]
        + audio_res["serve"]["launches"]["vq_dequant_matmul"])
    launches["vq_group_sweep_babai"] = budget_res["babai_launches"]
    launches["vq_dequant_matmul_experts"] = moe_res["serve"][
        "vq_experts_counts"].get(MOE_EXPERTS, 0)
    launches["flash_attention_train"] = train_res["launches"][
        "flash_attention"]
    launches["flash_attention_bwd"] = train_res["launches"][
        "flash_attention_bwd_by_impl"]["tc"]
    launches["flash_attention_bwd_fp32"] = train_res["launches_f32"][
        "flash_attention_bwd_by_impl"]["fp32"]
    hybrid_train = train_families_res["hybrid"]["launches"]
    launches["flash_attention_train_hd112"] = hybrid_train[
        "flash_attention_by_impl"]["tc"]
    launches["flash_attention_bwd_hd112"] = hybrid_train[
        "flash_attention_bwd_by_impl"]["tc"]
    tp_rank0 = model_axis_res["ranks"][0]["launches"]
    launches["flash_attention_train_tp"] = tp_rank0[
        "flash_attention_by_impl"]["tc"]
    launches["flash_attention_bwd_tp"] = tp_rank0[
        "flash_attention_bwd_by_impl"]["tc"]
    for fam, hd in (("vlm", 96), ("hybrid", 112)):
        fam_rank0 = model_axis_res["ranks"][0]["families"][fam]["launches"]
        launches[f"flash_attention_train_hd{hd}_tp"] = fam_rank0[
            "flash_attention_by_impl"]["tc"]
        launches[f"flash_attention_bwd_hd{hd}_tp"] = fam_rank0[
            "flash_attention_bwd_by_impl"]["tc"]
    print(json.dumps(kernel_line(rows, launches)))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
