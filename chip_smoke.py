#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card: the SkyQuery
cross-match (K1-K3), the LifeRaft serving decode of CodeQwen1.5-7B (K4) and
of the MoE moonshot-v1-16b-a3b (K4 and the grouped matmul K5), the
durable service daemon over both (a kill -9 drill on the cross-match),
the paper's drivers and gates, the rest of the model zoo (the SSM,
the Jamba hybrid, the encoder-decoder and the VLM, and the four largest
configs: mixtral-8x22b, qwen1.5-110b, mistral-large-123b and
nemotron-4-340b, cut in depth), served and prefilled, the MoE train
step with K5's backward, the trainer with its checkpoint and resume,
the mesh tools, and CodeQwen's sequence-parallel decode over two ranks
of the card, and the training of the SSM, the hybrid and mixtral with
their 8-bit AdamW, the VLM and the encoder-decoder.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the last line is printed:

1. build   -- compile ``src/repro_torch/csrc/crossmatch.cu``,
              ``csrc/paged_attention.cu``, ``csrc/grouped_matmul.cu`` and
              five copies of the first with one planted fault each
              (``PLANTED_FAULTS``, under ``build/planted/``) with nvcc (one
              process each, started together, into ``build/kernels/``) and
              load them; the main path's catalog and trace are made on the
              host while nvcc runs.
2. kernels -- each cross-match join (K1 single bucket, K2 fused, K3 shared
              plan: instances of one CUDA kernel) against its plain PyTorch
              version on the card, at the main path's shapes: a bucket of
              10,000 rows padded to 16,384 and M in {256, 4096, 32768}
              probes, the real rows, as the card path hands them (K1 also
              the real bucket row count and the padded probe count, its
              band's grid); one bucket row in 20 copied onto the next, 8
              probes at each segment's last row (the last of them the last
              real row), and K1's 8 last probes of each tile row at its
              band's last row.  Tolerance
              (the plain version takes its dots from cuBLAS, in another
              order than the kernel): best_dot within 2 ulp; best_idx equal
              or the float64 dots of both indices within 2 ulp, and the
              lowest of identical bucket rows; n_cand equal except on probes
              with a pair whose float64 dot lies within 2 ulp of the
              threshold.  Kernel, plain and torch.mm dots-only times are
              CUDA-event medians of 20 of one call (the kernel's also as
              device time, ``device_ms``: 20 launches between one pair of
              events, over 20, and as ``profiled_ms``, its mean duration
              in a profiler trace: the kernel's own time where the host's
              launch is slower; all cases in one trace after phase 3's,
              since each profiler session makes later traces of the
              process lose device events).  Each join prints its probes a
              thread, and the splits it launched and the pairs its threads
              dot, both counted on the card by a build of the source with
              ``CROSSMATCH_COUNT_PAIRS`` (outputs equal to the kernel's bit
              for bit), against the real pairs; the counts must equal the
              plan's.  Then each planted fault runs through the wrappers and
              must fail this check: the three in code all joins share (ties
              to the higher index, each range short of its last row, the
              last split's count dropped) both K1's cases and K2/K3's, K1's
              own two (the band's last tile dropped, the whole bucket short
              of its last real row) K1's; the script exits if one passes.
3. main    -- the SkyQuery cross-match at the paper's SDSS bucket width
              (10,000 objects a bucket), cut in depth to 100 buckets, 200
              queries; three engines on ``cuda``: A fuse_k=1 (K1), B fuse_k=4
              (K2), C shared plan with per-query radius and magnitude cut
              (K3, and K1 for indexed members).  Each run's kernel launches
              must be > 0 and add up to its device dispatches; its decision
              log and per-query results must match a ``device="cpu"`` run of
              the same engine on the first ``CPU_QUERIES`` (15) queries
              (the plain fused join takes minutes on the host for the
              whole trace), under the
              tolerance above.  Each run's drain is run once more under
              ``torch.profiler`` for the device's busy share; the trace
              must hold every cross-match launch of the drain.
4. shapes  -- each kernel against its plain version again, at the shape the
              main path gave it: K1 on one 10,000-row bucket (N = 16,384)
              with run A's largest probe batch, the real rows; K2 and K3 on
              four
              10,000-row buckets (N = 65,536) with the largest probe batch
              of run B and run C, as the card path hands it (the real rows),
              and again padded as the reference pads it (``shapes.padded``
              in the record).  These cases make the kernels' record.
5. paged   -- K4 against its plain version on the card, bf16, with a
              permuted page table and ragged lengths >= 1, at (a) the serving
              path's own shape (B=8, H=KV=32, D=128, 64 slots in pages of 16,
              lengths up to 16), (b) ``benchmarks/kernel_bench.py``'s (B=16,
              H=16, KV=8, page 64 x 32 pages), (c) CodeQwen's heads at a
              long cache (B=8, H=KV=32, page 64 x 64 pages), (d) the MoE
              serving path's own shape (moonshot: H=KV=16, otherwise as
              (a)), (e) one CodeQwen sequence of 4,096 slots alone (B=1,
              H=KV=32, page 64 x 64 pages), and phase 11's decode shapes:
              (f) paligemma's (B=8, H=8 on KV=1, D=256, as (a)'s pages),
              (g) seamless's self-attention (H=KV=16, D=64) and (h) its
              cross-attention (16 slots, one page, every sequence full);
              the four largest configs' decode shapes, 8 KV heads, as
              (a)'s pages: (i) mixtral-8x22b (H=48, G=6), (j)
              qwen1.5-110b (H=64, G=8), (k) mistral-large-123b (H=96,
              G=12), (l) nemotron-4-340b (H=96, G=12, D=192); (m)
              mixtral's heads over its 4,096-slot window's ring, B=8,
              every sequence full; (n) nemotron's heads and (o)
              qwen1.5-110b's over 4,096 full slots (pages of 16 x 256).
              Each shape must take its instance (``PAGED_MMA``: the
              tensor-core one at G > 2, the ring's pair instance else).
              (p) K4 with its partials (the max score m and softmax sum l
              of each row, for a sequence-sharded cache) at a decode_32k
              shard: B=8, H=KV=32, D=128, 16,384 slots (32 splits), timed
              as the others; beforehand the partials at (a)'s shape (one
              split) and at (p)'s against
              ``paged_attention_partials_ref``: m within 1e-4, l within
              2e-4 relative (``PARTIALS_M_TOL``, ``PARTIALS_L_TOL``), an
              empty row exactly (out 0, m -1e30, l 0), a bad page in the
              last split NaN in its row of out, m and l only; and (p)'s
              two halves merged as ``attention._local_decode`` merges
              shards against K4 on the whole.
              Tolerance: the reference's for this kernel, rtol = 5e-2 in
              bf16, and atol = 5e-2 times the largest |output| where that
              is below 1 (an average over thousands of slots is small; a
              fixed 5e-2 would pass a merge that drops a split).  Each
              shape prints its splits, chunk, workspace bytes and loads
              (``path``).
              Times: ``ms`` is the kernel's device time, 20 launches
              between one pair of CUDA events over 20, after a warm-up;
              ``wrapper_ms`` one call between a pair, median of 20;
              ``profiled_ms`` the kernel's own mean duration in a
              ``torch.profiler`` trace of 20 launches, every shape's in
              one trace (what (a), (d) and (f)-(h), few-µs kernels behind
              a host-bound launch, need).  The plain
              version and one ``scaled_dot_product_attention`` call over
              the dense K/V with a length mask (``library_ms``) are timed
              the first way, SDPA also the second.  ``k4_tune.py`` sweeps
              the chunk and breaks the wrapper's host time into parts.
6. serve   -- the port's ``launch/serve.py`` on ``cuda`` at CodeQwen1.5-7B's
              full config (32 layers, bf16) with the launcher's defaults but
              ``ZOO_REQUESTS`` (5) of its 40 requests (4 tenants, rate 50,
              ``liferaft``).  K4's launches must equal 32 x the decode steps;
              the engine summary must equal the ``--no-decode`` run's; a
              2-layer cut of the same widths, with the same seeded weights
              (drawn on the card and copied to the CPU), must decode 8 steps
              on the card as on the CPU (step-1 logits within
              ``BF16_LOGIT_TOL``; greedy tokens equal wherever the CPU's top-2
              margin exceeds it).  CodeQwen's weights are freed before phase
              8.
7. grouped -- K5 against its plain version on the card at (a) moonshot's
              gate/up products (T = 16,384 capacity rows, 64 groups of 256,
              d = 2048, f = 1408, bf16), (a') its down product (d = 1408,
              f = 2048), (b) ``benchmarks/kernel_bench.py``'s shape (T =
              4096, d = f = 1024, groups [512, 1024, 512, 2048]) in bf16 and
              f32, and (e) the decode call: (a)'s shape with the real rows of
              each tile (``tile_rows``) from a seeded top-6 routing of 8
              tokens over the 64 experts, computed by the MoE layer's own
              ``expert_tiles``, and x zero past them; (j) and (j') the same
              at jamba's decode call: 8 tokens top-2 over 16 experts of C
              = 256 rows, d = 4096 -> f = 14336 and back; (x) and (x')
              at mixtral-8x22b's decode call: 8 tokens top-2 over its 8
              experts of C = 256 rows, d = 6144 -> f = 16384 (a weight
              stack of 1.61 GB) and back; (e f32) (e) in
              float32, the decode call of a full-width f32 cut; (b bf16
              elem) (b) with f = 1020, which TMA cannot describe: the bf16
              element-load kernels, forward and dW.  At (b f32) and (e
              f32) the TMA-fed f32 kernel must equal the element-load one
              (``gmm_f32``, on a misaligned copy of x) bit for bit; both
              are timed.  Tolerance: the
              reference's, rtol = atol = 5e-2 in bf16 and 1e-5 in f32
              (``tests/test_kernels.py:173``).  Kernel, plain and library
              call (``torch.bmm`` on the (E, C, d) view at (a)/(a')/(e),
              ``torch._grouped_mm`` with offsets at (b) bf16 where the card's
              torch has it) are CUDA-event medians of 20.  (e)'s bound counts
              what the call must move: the weights of the experts with a
              token, x's row tiles with a real row, the tile maps and y
              written whole.
8. moe     -- ``launch/serve.py`` on ``cuda`` at moonshot-v1-16b-a3b's full
              config (48 layers, 64 experts top-6, 28.06 G parameters in
              bf16) with phase 6's requests.  K5's launches must equal
              3 x 48 x the decode steps and K4's 48 x the steps; the engine
              summary must equal the ``--no-decode`` run's; a 2-layer cut at
              full width decodes 2 steps on the card as on the CPU under
              phase 6's rules.
9. daemon  -- the durable service tier (``serving/daemon.py``) on the card.
              (a) The kill -9 drill (``benchmarks/smoke_recovery.py``) over
              phase 3's engine C and all 200 queries: an uninterrupted
              daemon, then a child interpreter running the same client loop,
              SIGKILLed once its journal holds a third of the uninterrupted
              run's round records, then a fresh daemon recovering on the
              card (replay re-runs every journaled round's join) and
              finishing.  Its journal records must equal the uninterrupted
              run's byte for byte, every acked query must complete with
              results equal bit for bit, and each daemon's launches must add
              up to its device dispatches.  Prints the rounds replayed, the
              recovery's seconds, and the daemon's intake (fsync'd acks of
              JSON payloads) beside phase 3's engine intake.  (b) The card
              daemon on the first ``CPU_QUERIES`` (15) queries writes
              segment files equal byte for byte to a ``device="cpu"``
              daemon's.  (c) The launcher's
              trace and engine behind the daemon, decoding moonshot's 2-layer
              cut at full width on the card (seeded weights): journal equal
              to a ``--no-decode`` daemon's, K4 launches 2 x the steps and K5
              3 x 2 x the steps; a copy cut after half its round records
              recovers (re-decoding that half) to the same journal.  (d)
              Phase 3's runs A and C again with ``obs`` on: decision logs and
              results equal to the obs-off runs, the round counter equal to
              the rounds, one Perfetto span a round; the drain ratio is
              printed, not gated.
10. drivers -- the reference's drivers through the port's engines and
              kernels on ``cuda``, each at its defaults and held against a
              ``device="cpu"`` run of itself in this process: the SkyQuery
              example (``examples/crossmatch_skyquery``; K1), Fig. 2's
              scan-vs-index break-even (each w's scan against its plain
              version under phase 2's contract), ``bench_scheduler``'s
              ``compile_count`` (padded shapes within log2(max batch) + 1,
              <= 1 library load) and ``fused_dispatch``,
              ``bench_sharedplan``'s dispatch reduction (>= 2x fewer, bit-
              equal) and compile bounding, ``kernel_bench`` (K1, K5 bf16 and
              f32, K4 bf16 against their plain versions on the CPU; it
              decides nothing, so no cpu run) and ``serve_multitenant``
              with its default flags and ``--adaptive``.  Each driver's
              launches must be > 0 and, for the cross-match drivers, add up
              to its device dispatches (Fig. 2: its joins); the serving
              example's K4 launches must equal layers x steps and K5's 3 x
              layers x steps; the decision-derived counts (batches,
              dispatches, shapes, the engine summary, tokens a tenant) must
              equal the cpu run's.  Prints each driver's wall and the
              CUDA-event span around it; the reports go to
              ``build/drivers/BENCH_torch_*.json``.
11. zoo    -- the families the earlier phases leave out, each on ``cuda``
              at full width with seeded weights: falcon-mamba-7b (64
              Mamba layers), paligemma-3b (18 layers, MQA, D=256) and
              seamless-m4t-large-v2 (24 + 24 layers) whole, and
              jamba-v0.1-52b cut in depth to 16 of its 32 layers (two
              periods: 2 attention, 14 Mamba, 8 MoE layers; 26.05 G
              parameters), and the four largest configs at their
              published widths cut in depth to fit the card with their
              cache (``ZOO_LAYERS``): mixtral-8x22b 8 of 56 layers,
              qwen1.5-110b 16 of 80, mistral-large-123b 16 of 88,
              nemotron-4-340b 4 of 96.  Each: the launcher's engine and
              trace with
              ``ZOO_REQUESTS`` (5) of its 40 requests; K4's launches must
              equal (attention + cross-attention layers) x steps and K5's 3
              x MoE layers x steps, from ``cfg.uses_attention`` /
              ``uses_moe``; the summary must equal the ``--no-decode``
              run's; the median CUDA-event step, rows a second, peak memory
              and a profile of 4 steps are printed.  Then
              ``make_prefill_step`` at 8 prompts of 64 tokens (paligemma
              adds its 256 patch embeddings, seamless takes 64 frames and
              64 decoder tokens): logits finite, the CUDA-event median of
              5, prompt positions a second.  Then a 2-layer cut of the same
              widths in float32 (jamba's: one period of an attention layer
              with its MLP and a Mamba layer with its MoE; the four largest
              configs' one layer, ``ZOO_CUT_LAYERS``; the host's free
              memory printed first), weights drawn on
              the card and copied, held to ``ZOO_F32_TOL`` under phase 6's
              rules: the prefill's logits at 2 prompts of 16 tokens (16
              patches / frames) and its greedy tokens; 8 decode steps (2
              with experts and for the three dense largest configs,
              ``ZOO_CPU_STEPS``), seamless's after ``prefill_cross_kv`` filled
              the cross K/V; for the token-only families the card's decode
              over the prompt against its forward's last position;
              mixtral's cut also decodes across its window's wrap: a
              cache of 8,192 slots is a ring of 4,096, seeded K/V, 8
              steps from position 4,092 on the CPU and the card, every
              step's logits within ``ZOO_F32_TOL``, tokens under phase
              6's rule, the slots written equal.  Each model is freed
              before the next.
12. train  -- training on ``cuda``: moonshot-v1-16b-a3b at its published
              widths cut in depth to ``TRAIN_LAYERS`` (4) of its 48 layers
              (2.95 G parameters; the cut is forced by memory), bf16, its
              own AdamW and remat.  (a) K5's backward against its plain
              versions on the card at the training call's shapes, E = 64
              experts of C = 512 rows (8 x 512 tokens top-6, routing from
              the model's first MoE layer on a real batch), gate/up (d =
              2048, f = 1408) and down (1408 -> 2048), plus a ragged f32
              case (r) with an empty expert and a partly filled tile, and
              (t f32) the f32 cut's call (2 x 16 tokens top-6 over the 64
              experts at C = 256, d = 2048, f = 1408): dX (K5 on
              the transposed weights) and dW (its own kernel) within
              ``TRAIN_DW_TOL`` of the largest value, an empty expert's dW
              and a padding row's dX +0; in f32 the TMA-fed kernels equal
              the element-load ones bit for bit; kernel, element-load,
              plain and ``torch.bmm`` CUDA-event medians beside the bound;
              the transposed-weight copy's time.  (c) ``TRAIN_STEPS`` (10)
              steps of
              ``make_train_step`` on ``TokenPipeline(seed=0)`` batches of 8
              x 512: each step's loss and grad norm (finite, the last loss
              below the first), the median CUDA-event step after step 1,
              tokens a second, peak memory, K5's forward / dX / dW launches
              a step (6 / 3 / 3 a layer with remat), the experts' first
              moments nonzero after step 1 (their gradients reached them),
              the step's floor (its operations at the bf16 peak against
              AdamW's bytes at 3.35 TB/s), then a profile of 2 steps
              (device busy, launches a step).  (b) A 2-layer float32 cut
              at the same widths, weights drawn on the card and copied: the
              loss and every gradient leaf for 2 x 16 tokens on the card
              against the CPU within ``TRAIN_LOSS_TOL`` (relative) and
              ``TRAIN_GRAD_TOL`` (of each leaf's largest value), each MoE
              layer's routing compared and a flip printed; the card's
              backward is profiled (its device-to-device copies and K5
              kernels printed) and K5 must have taken its float32 TMA
              kernels (``GK.KERNEL_LAUNCHES``).
13. trainer -- ``training/trainer.py`` on ``cuda``.  (a) moonshot-v1-16b-a3b
              at its published widths cut in depth to ``TRAINER_LAYERS``
              (1) of 48 layers (1.24 G parameters; its checkpoint, bf16
              weights and AdamW's f32 moments, ~12.4 GB: the cut is forced
              by checkpoint bytes and the run's time limit), bf16, AdamW,
              remat, batches of 8 x 512 from ``TokenPipeline(seed=0)``: two
              uninterrupted ``Trainer``s of ``TRAINER_STEPS`` (6) steps
              (the card's run-to-run spread of the loss), then trainer A,
              3 steps with a checkpoint at step 3 into
              ``build/trainer_ckpt/``, then trainer B on that directory to
              step 6.  B must start at step 3 with every leaf of its
              parameters and optimizer state equal to A's (bf16
              included), the manifest must hold bfloat16 leaves, B's
              losses at steps 4-6 must lie within ``TRAINER_LOSS_TOL`` of
              the first uninterrupted run's, every loss finite, and every
              run's K5 forward / dX / dW launches 6 / 3 / 3 a layer a step.
              Printed: free disk (below twice the checkpoint's bytes the
              phase fails), checkpoint bytes and files, the ms ``save``
              blocked the loop, the s ``wait`` blocked, the restore s, the
              median step.  (b) ``Trainer`` at the f32 smoke configs of
              codeqwen1.5-7b, moonshot-v1-16b-a3b (K5's f32 kernels),
              falcon-mamba-7b and jamba-v0.1-52b (8-bit AdamW) for
              ``TRAINER_SMOKE_STEPS`` (20) steps from weights made on the
              CPU: every loss within ``TRAINER_SMOKE_TOL`` (relative) of the
              CPU run's, jamba's within ``TRAINER_SMOKE_TOL_8BIT``; jamba's
              also saved at step 10 and resumed by a second trainer, every
              leaf (int8 codes and f32 scales) restored equal and both
              trainers' losses within ``TRAINER_LOSS_TOL`` of the
              uninterrupted card run's.  (c) ``launch.train`` (codeqwen1.5-7b, 20
              steps) prints a finite final loss and ``examples.train_lm
              --big --steps 100`` prints ``improved``.  The checkpoint
              directory stays until phase 14 ends.
  14. mesh    The mesh tools.  (a) ``python -m repro_torch.launch.dryrun``
              in subprocesses of their own (each on a ``fake`` process
              group of 256 or 512 ranks, shapes only), started together
              while (b) runs: moonshot-v1-16b-a3b train_4k --zero1 on
              16x16 and, with --multi-pod, on 2x16x16, and
              codeqwen1.5-7b decode_32k on 16x16 (its 32 KV heads take
              the sequence-parallel K4 merge under DECODE_RULES).  Each
              must exit 0; its OK line and the argument bytes a rank
              holds are printed beside the card's memory.  (b) an NCCL
              process group of one rank and a (1, 1) ("data", "model")
              mesh on the card; ``elastic_restore`` of phase 13's step-3
              checkpoint with zero1: every leaf a DTensor on cuda:0; from
              their local tensors, two train steps on the batches
              trainer B took must give B's step-4 and step-5 losses bit
              for bit.  Printed: the restore's seconds beside phase 13's
              plain restore, and the phase's seconds.  (a) also traces
              falcon-mamba-7b prefill_32k and jamba-v0.1-52b prefill_32k
              on 16x16: the full-sequence SSM cells, whose causal conv
              runs in ``local_map`` (torch 2.11 refuses ``F.pad`` of a
              DTensor).
  15. sharded The sequence-parallel decode on the card: a process of
              its own (``--sharded-decode-rank``) with a one-rank NCCL
              group and a (1, 1) ("data", "model") mesh under
              ``DECODE_RULES`` (``SHARDED_RANKS`` says why not two),
              the cache's sequence sharded over "model":
              CodeQwen1.5-7B at full width cut to 8 of 32 layers in
              float32, B=2, a 32,768-slot cache holding seeded K/V below
              position 16,380, 8 greedy ``make_serve_step`` steps.  K4
              returns its partials and ``_local_decode`` merges them
              through all-reduces.  Rank 0 first decodes the same 8 steps
              unsharded; every rank's greedy tokens must equal those, the
              cache must be sequence-sharded, and K4 must launch once a
              layer a step in both runs.  Printed: the step times and K4
              launches a step of both runs, the cache's placements.
  16. zootrain Training on ``cuda`` for the families phases 12 and 13 leave
              out, each at its published widths in bf16 with its own
              optimizer and remat, ``ZOOTRAIN_STEPS`` (4) steps of
              ``make_train_step`` on ``TokenPipeline(seed=0)`` batches of 8
              x 512 tokens (paligemma adds 256 seeded normal patches a row,
              seamless takes 512 seeded normal frames; ``family_batch``):
              jamba-v0.1-52b cut to two periods of 2 layers (attention +
              MLP, then Mamba + MoE; 8-bit AdamW), mixtral-8x22b cut to 2
              of 56 layers (8-bit AdamW), falcon-mamba-7b cut to 8
              of 64 layers, paligemma-3b and seamless-m4t-large-v2 whole
              (``ZOOTRAIN`` says why).  (a) Each loss finite and the last
              below the first (paligemma and seamless, whose gradients at
              the reference's init grow with depth until the clip stalls
              them, ``ZOOTRAIN_STALLS``: each loss finite, and their
              2-layer cut in bf16 must lower its first batch's loss in
              as many steps); printed: the median CUDA-event step after
              step 1, tokens a second, peak memory against the card's, a
              2-step profile (device busy, launches a step; read from the
              trace's raw events) and the optimizer update alone.  For
              jamba and mixtral, first K5 at its training call, gate/up
              and down with the cut's first MoE layer's routing on the
              first batch: jamba's (jt) d = 4096 -> f = 14336 and (jt'),
              16 experts of C = 768 rows, mixtral's (xt) d = 6144 -> f =
              16384 and (xt'), 8 experts of C = 1,536 rows; its forward
              under phase 7's rules (the records join phase 7's), its
              backward under phase 12 (a)'s (dX bit-equal to K5 on a
              contiguous w^T, dW within ``TRAIN_DW_TOL``; the records join
              phase 12's); then K5's forward / dX / dW launches 6 / 3
              / 3 an MoE layer a step and the experts' 8-bit m codes
              nonzero after step 1.  (b) The float32 cut (``zoo_cut``; 2
              layers, mixtral's 1) against the CPU under phase 12 (b)'s
              rules (loss within ``TRAIN_LOSS_TOL``, each gradient leaf
              within ``TRAIN_GRAD_TOL``; the
              encoder-decoder's within ``ZOO_GRAD_TOL``).  (c) jamba and
              mixtral: one
              ``adamw8bit`` update of that cut on the card against the same
              update on the CPU at sampled 256-blocks of every leaf (each
              chunk boundary, both ends, a stride): parameters within
              ``OPT8_TOL``, codes equal but for at most 1 in 1,000 one off,
              scales within ``OPT8_TOL``.  Each model is freed before the
              next.

Every phase prints its seconds.  The last two lines are the kernels' JSON
record and the device record.
Imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.benchmarks import smoke_recovery as drill  # noqa: E402
from repro_torch.benchmarks import (  # noqa: E402
    bench_scheduler, bench_sharedplan, fig2_hybrid_join, kernel_bench,
)
from repro_torch.benchmarks import common as bench_common  # noqa: E402
from repro_torch.benchmarks.common import (  # noqa: E402
    PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, bound as bound_ms, misaligned,
    profiled_runs, same_bits,
)
from repro_torch.examples import (  # noqa: E402
    crossmatch_skyquery, serve_multitenant,
)
from repro_torch.benchmarks.skyquery import (  # noqa: E402
    make_engine, make_skyquery_catalog, queries_for, trace_records,
)
from repro_torch.kernels.crossmatch import kernel as K  # noqa: E402
from repro_torch.kernels.crossmatch import ops, ref  # noqa: E402
from repro_torch.kernels.nvcc import CudaLibrary  # noqa: E402
from repro_torch.kernels.grouped_matmul import kernel as GK  # noqa: E402
from repro_torch.kernels.grouped_matmul import ops as gmm_ops  # noqa: E402
from repro_torch.kernels.grouped_matmul.ref import (  # noqa: E402
    grouped_matmul_dw_ref, grouped_matmul_tiles_ref,
)
from repro_torch.kernels.paged_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_partials_ref, paged_attention_ref,
)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import registry as models  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models.common import pad_vocab  # noqa: E402
from repro_torch.training import make_optimizer, make_train_step  # noqa: E402
from repro_torch.training import optimizer as opt_mod  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from repro_torch.training.train_step import make_prefill_step  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.examples import train_lm  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.training import trainer as trainer_mod  # noqa: E402
from repro_torch.training.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.checkpoint import elastic_restore  # noqa: E402
from repro_torch.sharding import DEFAULT_RULES, ShardingRules  # noqa: E402
from repro_torch.obs import Observability  # noqa: E402
from repro_torch.serving import ServiceDaemon, ServingHost  # noqa: E402

ULPS = 2
PROBE_COUNTS = (256, 4096, 32768)  # kernel-check probe counts (M)
REPS = 20  # CUDA-event timing repetitions (median)
CPU_QUERIES = 15  # the cpu run of each engine takes the first 15 queries
DEVICE = "cuda"  # the device the main path runs on

SOURCE = "src/repro_torch/csrc/crossmatch.cu"
REPLACES = {
    "crossmatch": "src/repro/kernels/crossmatch/kernel.py:89",
    "crossmatch_fused": "src/repro/kernels/crossmatch/kernel.py:248",
    "crossmatch_shared": "src/repro/kernels/crossmatch/kernel.py:206",
}
# Faults planted in copies of SOURCE: (line in the source, its mutation,
# the joins whose phase-2 check it must fail).
PLANTED_FAULTS = {
    "ties resolved to the higher index": (
        "      if (d > best[r]) {", "      if (d >= best[r]) {",
        ("K1", "K2/K3")),
    "each range drops its last row": (
        "    const int seg_end = sm_hi;", "    const int seg_end = sm_hi - 1;",
        ("K1", "K2/K3")),
    "the last split's count dropped": (
        "      cnt[r] += __ldcg(a.ws_cnt + k);",
        "      cnt[r] += s == a.splits - 1 ? 0 : __ldcg(a.ws_cnt + k);",
        ("K1", "K2/K3")),
    "the band's last tile dropped": (
        "  const int tile_hi = min(center + a.band + 1, a.n_j);",
        "  const int tile_hi = min(center + a.band, a.n_j);", ("K1",)),
    "the whole bucket short of its last real row": (
        "    hi = a.rows;", "    hi = a.rows - 1;", ("K1",)),
}
# Phase 12's planted fault: a copy of GMM_SOURCE whose TMA dW kernel no
# longer zeroes the rows past a tile's count in the boxes it loads (line,
# mutation); it must fail phase 12 (a)'s dW check.
DW_PLANTED_FAULT = ("      const bool straddles = valid < kBK;",
                    "      const bool straddles = false;")
K1_BAND = 2  # phase 2's band (tiles of 128 x 512)
PAGED_SOURCE = "src/repro_torch/csrc/paged_attention.cu"
PAGED_REPLACES = "src/repro/kernels/paged_attention/kernel.py:102"
PAGED_TOL = 5e-2  # bf16, the reference's (tests/test_kernels.py:235)
# The launcher's decode cache, MAX_SEQ slots, as K4 pages it: (page, pages).
SERVE_PAGES = (math.gcd(serve_launcher.MAX_SEQ, attn_mod.DECODE_PAGE),
               serve_launcher.MAX_SEQ
               // math.gcd(serve_launcher.MAX_SEQ, attn_mod.DECODE_PAGE))
# A 4,096-slot cache (mixtral's window) as K4 pages it: (page, pages).
RING_PAGES = (math.gcd(4096, attn_mod.DECODE_PAGE),
              4096 // math.gcd(4096, attn_mod.DECODE_PAGE))
# Phase 5's shapes: (B, H, KV, D, page, pages, longest length).
PAGED_SHAPES = {
    "a": (8, 32, 32, 128, math.gcd(64, attn_mod.DECODE_PAGE),
          64 // math.gcd(64, attn_mod.DECODE_PAGE), 16),
    "b": (16, 16, 8, 128, 64, 32, 2048),
    "c": (8, 32, 32, 128, 64, 64, 4096),
    "d": (8, 16, 16, 128, math.gcd(64, attn_mod.DECODE_PAGE),
          64 // math.gcd(64, attn_mod.DECODE_PAGE), 16),
    "e": (1, 32, 32, 128, 64, 64, 4096),
    # phase 11's decode shapes: (f) paligemma (MQA, D = 256), (g) seamless's
    # self-attention (D = 64), (h) its cross-attention over ENC_LEN slots,
    # every sequence full (PAGED_FULL)
    "f": (8, 8, 1, 256, math.gcd(64, attn_mod.DECODE_PAGE),
          64 // math.gcd(64, attn_mod.DECODE_PAGE), 16),
    "g": (8, 16, 16, 64, math.gcd(64, attn_mod.DECODE_PAGE),
          64 // math.gcd(64, attn_mod.DECODE_PAGE), 16),
    "h": (8, 16, 16, 64, math.gcd(serve_launcher.ENC_LEN, attn_mod.DECODE_PAGE),
          serve_launcher.ENC_LEN
          // math.gcd(serve_launcher.ENC_LEN, attn_mod.DECODE_PAGE),
          serve_launcher.ENC_LEN),
    # the four largest configs' decode shapes, 8 KV heads each: (i)
    # mixtral-8x22b (G = 6), (j) qwen1.5-110b (G = 8), (k)
    # mistral-large-123b (G = 12), (l) nemotron-4-340b (G = 12, D = 192);
    # (m) mixtral's heads over its 4,096-slot sliding-window ring, every
    # sequence full (the steady state of a decode past the window); (n)
    # nemotron's and (o) qwen1.5-110b's heads over 4,096 full slots
    "i": (8, 48, 8, 128, *SERVE_PAGES, 16),
    "j": (8, 64, 8, 128, *SERVE_PAGES, 16),
    "k": (8, 96, 8, 128, *SERVE_PAGES, 16),
    "l": (8, 96, 8, 192, *SERVE_PAGES, 16),
    "m": (8, 48, 8, 128, *RING_PAGES, 4096),
    "n": (8, 96, 8, 192, *RING_PAGES, 4096),
    "o": (8, 64, 8, 128, *RING_PAGES, 4096),
}
PAGED_FULL = {"h", "m", "n", "o"}  # shapes whose every sequence is max_len long
# Shapes that must take the tensor-core instance (bf16, G > 2); every
# other phase-5 shape takes the pair instance's cp.async ring ("async").
PAGED_MMA = {"f", "i", "j", "k", "l", "m", "n", "o"}
# Phase 5 (p): K4 with its partials (max and sum) at a decode_32k shard:
# the 32,768-slot cache of CodeQwen's heads cut in two by a (1, 2) mesh's
# "model" axis, 8 sequences (decode_32k's 128 over a data axis of 16).
PARTIALS_SHAPE = (8, 32, 32, 128, math.gcd(16384, attn_mod.DECODE_PAGE),
                  16384 // math.gcd(16384, attn_mod.DECODE_PAGE), 16384)
# m: the kernel's base-2 max times ln 2, absolute (an f32 dot of D = 128
# unit normals is good to 128 * 2**-24 * sum|q k| / sqrt(D), ~6e-5); l:
# relative (exp of that).
PARTIALS_M_TOL = 1e-4
PARTIALS_L_TOL = 2e-4
MANY = 20  # launches between one pair of CUDA events
SERVE_ARCH = "codeqwen1.5-7b"
MOE_ARCH = "moonshot-v1-16b-a3b"
CPU_LAYERS = 2  # the CPU comparison's cut in depth
# Decode steps of the CPU comparisons without experts: 8 (at 16 steps
# CodeQwen's 2-layer bf16 cut took 18.8 s and 36.1 s of phase 6 on two
# H100 80GB HBM3 hosts, and the script has 1,200 s).
CPU_STEPS = 8
# The MoE cut's CPU expert products are 567 GFLOP a step: 2 steps (the
# script has 1,200 s, and the largest cuts' CPU reads the whole cut each
# step).
MOE_CPU_STEPS = 2
GMM_SOURCE = "src/repro_torch/csrc/grouped_matmul.cu"
GMM_REPLACES = "src/repro/kernels/grouped_matmul/kernel.py:48"
GMM_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-5}  # tests/test_kernels.py:173
GMM_BT = 128
# Phase 7 (e), (j), (x): the decode call's routing, B tokens top-k over E
# experts (moonshot's; jamba's; mixtral-8x22b's, whose C = 256 rows an
# expert hold about 2 real ones and whose call streams 1.61 GB of expert
# weights), at the gate/up shape (e), (j), (x) and the down shape (e'),
# (j'), (x') as (routing, d, f).
GMM_DECODE = dict(B=8, k=6, E=64, C=256)
JAMBA_DECODE = dict(B=8, k=2, E=16, C=256)
MIXTRAL_DECODE = dict(B=8, k=2, E=8, C=256)
# (e f32): (e) in float32, the decode call of a full-width f32 cut (phase
# 11's cuts, phase 12 (b)).
GMM_DECODE_SHAPES = {"e": (GMM_DECODE, 2048, 1408, torch.bfloat16),
                     "e'": (GMM_DECODE, 1408, 2048, torch.bfloat16),
                     "j": (JAMBA_DECODE, 4096, 14336, torch.bfloat16),
                     "j'": (JAMBA_DECODE, 14336, 4096, torch.bfloat16),
                     "x": (MIXTRAL_DECODE, 6144, 16384, torch.bfloat16),
                     "x'": (MIXTRAL_DECODE, 16384, 6144, torch.bfloat16),
                     "e f32": (GMM_DECODE, 2048, 1408, torch.float32)}
# Phase 7's shapes: (T, d, f, group sizes, dtype, weight scale).  The
# weights of (a)/(a') are the model's init scale, 1/sqrt(d); (b) takes
# kernel_bench's 0.02.  (b bf16 elem) is (b) with f = 1020, which TMA
# cannot describe (rows of 2040 bytes): the bf16 element-load kernels'
# row, forward and dW (``GMM_DW_ELEM``).
GMM_SHAPES = {
    "a": (16384, 2048, 1408, [256] * 64, torch.bfloat16, 2048 ** -0.5),
    "a'": (16384, 1408, 2048, [256] * 64, torch.bfloat16, 1408 ** -0.5),
    "b bf16": (4096, 1024, 1024, [512, 1024, 512, 2048], torch.bfloat16, 0.02),
    "b f32": (4096, 1024, 1024, [512, 1024, 512, 2048], torch.float32, 0.02),
    "b bf16 elem": (4096, 1024, 1020, [512, 1024, 512, 2048],
                    torch.bfloat16, 0.02),
}
GMM_DW_ELEM = "b bf16 elem"
# K5's float32 kernels fed by TMA ("f32") are held bit for bit to the
# element-load ones ("f32_elem") at every f32 shape of phases 7 and 12:
# each output of both is one fmaf chain in the same order.  The element-
# load call takes a copy of the same inputs whose base lies 4 bytes past
# a 16-byte boundary (``misaligned``), which TMA cannot describe.
# Step-1 logits, bf16, cpu vs card: four bf16 ulps at the largest logits
# (|logit| in [4, 8), ulp 2^-5).  Both runs round every product's f32 sum
# to bf16; a sum summed in another order lands on the other side of a
# rounding boundary now and then, one ulp, and the unembedding adds its own.
BF16_LOGIT_TOL = 2.0**-3
PROFILE_STEPS = 4
# Phase 11: the families this slice ports, each at full width; jamba cut
# to its first 16 layers (two periods of 8), which fit the card with their
# cache.  The engine runs ZOO_REQUESTS of the launcher's 40 requests, as
# phases 6 and 8 do (their step median and launches a step are the numbers
# compared; 40 requests took 36 s and 93 s of engine wall on an H100
# 80GB HBM3 at 700 W, 10 requests 9.4 s and 23.3 s; 5 requests still
# make 80 decode steps a model).
# The four largest configs follow at their published widths, cut in depth
# to fit one 80 GB card with their cache (``ModelConfig.param_count``, bf16):
# mixtral-8x22b 8 of 56 layers (20.435 G parameters, 40.9 GB),
# qwen1.5-110b 16 of 80 (24.235 G, 48.5 GB), mistral-large-123b 16 of 88
# (22.952 G, 45.9 GB), nemotron-4-340b 4 of 96 (23.253 G, 46.5 GB; its
# embedding and unembedding alone are 9.44 G).
ZOO_ARCHS = ("falcon-mamba-7b", "paligemma-3b", "seamless-m4t-large-v2",
             "jamba-v0.1-52b", "mixtral-8x22b", "qwen1.5-110b",
             "mistral-large-123b", "nemotron-4-340b")
ZOO_LAYERS = {"jamba-v0.1-52b": 16, "mixtral-8x22b": 8, "qwen1.5-110b": 16,
              "mistral-large-123b": 16, "nemotron-4-340b": 4}
# The float32 cut's depth where it is not CPU_LAYERS: nemotron's 2-layer
# cut is 16.35 G parameters, 65.4 GB on the card beside the CPU's copy of
# as much in the host's 96 GiB; one layer is 12.891 G, 51.6 GB.  The other
# three largest configs' cuts are one layer too, for the script's time:
# their 2-layer checks took 26.5 s (mixtral, with its ring), 15.3 s and
# 11.5 s of phase 11 and mixtral's 61.5 s of phase 16 on an H100 80GB
# HBM3's host; one layer is 2.907 G (mixtral), 3.850 G (qwen1.5-110b)
# and 2.189 G (mistral-large-123b) parameters against 5.411, 5.209 and
# 3.574 G at two.  Every layer of theirs is of one kind, so one layer
# holds each kind the served model runs.
ZOO_CUT_LAYERS = {"mixtral-8x22b": 1, "qwen1.5-110b": 1,
                  "mistral-large-123b": 1, "nemotron-4-340b": 1}
# Decode steps of the f32 cut on both devices where not CPU_STEPS (or
# MOE_CPU_STEPS with experts): the CPU reads the whole cut each step, and
# nemotron's 51.6 GB took its check to 54.9 s at 16 steps, qwen1.5-110b's
# and mistral-large-123b's 20.8 and 14.3 GB theirs to 25.9 and 22.3 s (an
# H100 80GB HBM3's host), so the dense three take as many as the MoE cuts.
ZOO_CPU_STEPS = {"qwen1.5-110b": MOE_CPU_STEPS,
                 "mistral-large-123b": MOE_CPU_STEPS,
                 "nemotron-4-340b": MOE_CPU_STEPS}
# Mixtral's f32 cut also decodes across its sliding window's wrap: a cache
# of 2 x window slots (a ring of ``sliding_window`` = 4,096), seeded K/V,
# RING_STEPS steps from position window - RING_LEAD on the CPU and the
# card, ZOO_CPU_B sequences.
RING_LEAD, RING_STEPS = 4, 8
ZOO_REQUESTS = 5
PREFILL_B, PREFILL_S = 8, 64  # prompts a prefill, tokens (frames) a prompt
PREFILL_REPS = 5
# The 2-layer cut's prefill against the CPU: B prompts of S tokens (S
# patches / S frames), and the decode tail over those S tokens.
ZOO_CPU_B, ZOO_CPU_S = 2, 16
# The cut runs in float32: at the reference's init scale the attention
# scores spread over hundreds (wq's fan_in is H by its scale rule), so a
# softmax over a prompt is nearly one-hot and a bf16 rounding can move its
# winner (paligemma's 2-layer cut in bf16 on the CPU differs from the
# same in f32 by up to 3.99 in a logit).  Two f32 runs on the CPU with 8
# threads and with 1 differ by up to 1.3e-2 (seamless's cut; paligemma's
# 5.9e-4), against logits up to ~7: four times that.
ZOO_F32_TOL = 5e-2
# Phase 12: moonshot at full width cut to TRAIN_LAYERS of 48 layers, the
# cut forced by memory (4 layers: 2.95 G parameters; bf16 weights and
# gradients, AdamW's f32 moments and the step's temporaries; 8 would not
# fit in 80 GB); TRAIN_STEPS steps of B x S tokens, the last
# TRAIN_PROFILE_STEPS profiled.
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_S = 8, 512
TRAIN_STEPS = 10
TRAIN_PROFILE_STEPS = 2
# (b): the float32 cut (``zoo_cut``, 2 layers) against the CPU, 2 prompts
# of 16 tokens.  Tighter than ZOO_F32_TOL: the loss within 1e-4 relative,
# each gradient leaf within 1e-2 of its largest value (an H100 at 700 W
# measured 9.5e-7 of a loss of 12.5 and 2.2e-3, the embedding's, with
# weights drawn on the CPU; 0 and 5.4e-4 with the card's: the table's
# gradient is scattered from 32 tokens, each a sum in another order).
TRAIN_CPU_B, TRAIN_CPU_S = 2, 16
TRAIN_LOSS_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-2
# Phase 16 (b): the encoder-decoder's cut needs more room.  At the
# reference's init its attention softmaxes are near one-hot, and their
# backward, p (g - sum p g), cancels most digits of an f32 gradient: on an
# H100 (80GB HBM3, 700 W) the card's f32 leaves and the CPU's differed by
# up to 0.165 of a leaf's largest value (enc.attn.wq), while in float64
# the two agree to 4.9e-4 and each f32 run is 0.133 (CPU) and 0.027
# (card) from it (``benchmarks/grad_conditioning.py``).
ZOO_GRAD_TOL = {"encdec": 0.3}
# (a): K5's backward against its plain versions, of the largest value: in
# bf16 both round an f32 sum over up to C = 512 rows to bf16 once (one
# bf16 rounding is 2^-8 relative); in f32 the sums differ in order only.
TRAIN_DW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-5}
# The earlier element-load wmma dW kernel's median at (a) and (a') on an
# H100 80GB HBM3 at 700.00 W, as PERF.md records it: printed beside this
# run's time, not measured here (the kernel is gone).
DW_EARLIER_MS = {"a": 2.8397, "a'": 2.7099}
# Phase 13: the trainer at moonshot's full width cut to TRAINER_LAYERS of
# 48 layers (the cut forced by checkpoint bytes: 12.4 GB a save at one
# layer, 29.5 GB at four, and two saves and a restore a run).
# TRAINER_LOSS_TOL: B's resumed losses against the first uninterrupted
# run's, relative.  The card's own run-to-run spread is printed beside it
# (the MoE dispatch's index_add_ and the embedding's backward may sum in
# no fixed order): an H100 at 700 W measured 0 for both, so the tolerance
# only leaves room for such sums (an f32 ulp of a loss of 12 is 8e-8
# relative), while a batch out of place moves a loss by ~1e-3.
# TRAINER_SMOKE_TOL: the f32 smoke configs' 20 losses on the card against
# the CPU's, relative (measured 5.4e-5 and 3.6e-5: the products sum in
# other orders, and 20 AdamW steps carry the differences on).
# TRAINER_SMOKE_TOL_8BIT: the same for jamba's, which trains with 8-bit
# AdamW.  Where a block's v code rounds to 0 the update is m / eps, so a
# code one off at a rounding boundary (the gradients differ in their last
# bits) moves a parameter by ~0.1 on one side only, and the losses part
# from step 3 on: an H100 (80GB HBM3, 700 W) measured 1.98e-3 against the
# CPU, and the CPU differs from itself as much between runs (its
# embedding gradient sums in no fixed order).  Jamba's smoke trainer also
# saves at TRAINER_SMOKE_SAVE_AT into TRAINER_SMOKE_DIR, and a second
# trainer resumes it on the card.
TRAINER_LAYERS = 1
TRAINER_STEPS = 6
TRAINER_SAVE_AT = 3
TRAINER_LOSS_TOL = 1e-5
TRAINER_SMOKE_ARCHS = (SERVE_ARCH, MOE_ARCH, "falcon-mamba-7b",
                       "jamba-v0.1-52b")
TRAINER_SMOKE_STEPS = 20
TRAINER_SMOKE_TOL = 1e-3
TRAINER_SMOKE_TOL_8BIT = 1e-2
TRAINER_SMOKE_SAVE_AT = 10
TRAINER_DIR = pathlib.Path(ROOT) / "build" / "trainer_ckpt"
TRAINER_SMOKE_DIR = pathlib.Path(ROOT) / "build" / "trainer_smoke_ckpt"
TRAIN_LM_DIR = pathlib.Path(ROOT) / "build" / "train_lm_ckpt"
# Phase 14 (a): the dry-run's cells, each a subprocess, and their output.
MESH_CELLS = (
    ("--arch", MOE_ARCH, "--shape", "train_4k", "--zero1"),
    ("--arch", MOE_ARCH, "--shape", "train_4k", "--zero1", "--multi-pod"),
    ("--arch", SERVE_ARCH, "--shape", "decode_32k"),
    ("--arch", "falcon-mamba-7b", "--shape", "prefill_32k"),
    ("--arch", "jamba-v0.1-52b", "--shape", "prefill_32k"),
)
MESH_DIR = pathlib.Path(ROOT) / "build" / "dryrun_smoke"
MESH_TIMEOUT = 600
# Phase 14 (b): the steps after the checkpoint that are replayed.
MESH_STEPS = 2
# Phase 15: CodeQwen's sequence-parallel decode on a (1, SHARDED_RANKS)
# ("data", "model") mesh of one card, its ranks processes over
# SHARDED_BACKEND.  Two ranks of one card would need gloo (NCCL takes one
# rank a device), and the card machine's gloo (torch 2.11) crashes on
# all_gather_into_tensor of CUDA tensors (all-reduce works), which the
# decode's DTensors need (q's heads, the vocab); so one rank over NCCL,
# whose "model" axis of size 1 still shards the cache's sequence: K4
# returns its partials and they go through _local_decode's all-reduces.
# The merge of two shards by value is held on the CPU
# (tests/test_torch_sharded_decode.py) and of two halves on the card
# (phase 5).  Full width, cut to SHARDED_LAYERS of 32 layers and in
# float32: the sharded run's partial sums and merge round in another
# order than the unsharded one, which in bf16 may move a greedy
# near-tie; in f32 the weights, decode_32k's 32,768-slot cache of
# SHARDED_B sequences and the unsharded run's copy of it fit the card at
# 8 layers.  The cache holds seeded K/V below SHARDED_POS, so with two
# ranks the SHARDED_STEPS greedy steps cross into the second shard
# halfway.
SHARDED_RANKS = 1
SHARDED_BACKEND = "nccl"
SHARDED_LAYERS = 8
SHARDED_B, SHARDED_SLOTS = 2, 32768
SHARDED_STEPS = 8
SHARDED_POS = SHARDED_SLOTS // 2 - SHARDED_STEPS // 2
SHARDED_TIMEOUT = 600
# Phase 16: the families phases 12 and 13 leave out, trained on the card
# at their published widths in bf16 with their own optimizer and remat,
# TRAIN_B x TRAIN_S tokens a step.  The cuts in depth, from
# ``ModelConfig.param_count`` (bf16 weights and gradients, the optimizer's
# state; activations not counted): falcon-mamba 8 of 64 layers (1.38 G
# parameters, 16.5 GB; 16 layers, 2.22 G, took 32.6 s of the phase on an
# H100 80GB HBM3, the script's time limit is the cut; all 64 with AdamW's
# f32 moments 87.3 GB); jamba
# two periods of 2 layers, attention + MLP then Mamba + MoE, the period
# of phase 11's f32 cut (6.82 G, 41.1 GB with the 8-bit moments; jamba's
# own 8-layer period is 13.30 G, 80.2 GB, and ``hybrid._n_periods`` takes
# whole periods); paligemma (1.90 G, 22.9 GB) and seamless (1.63 G, 19.6
# GB) whole.
# mixtral-8x22b 2 of 56 layers with its 8-bit AdamW (5.411 G parameters:
# bf16 weights and gradients and the 8-bit moments 32.5 GB; 4 layers would
# be 10.419 G, 62.5 GB before the step's activations).  The dense three do
# not train here: qwen1.5-110b's and mistral-large-123b's 2-layer cuts
# would fit, but this slice serves them only; nemotron-4-340b cannot, one
# layer with its embeddings being 12.891 G, 77.3 GB with 8-bit moments
# before their scales and the step's activations.
ZOOTRAIN = {
    "jamba-v0.1-52b": dict(n_layers=4, attn_period=2, attn_offset=0),
    "mixtral-8x22b": dict(n_layers=2),
    "falcon-mamba-7b": dict(n_layers=8),
    "paligemma-3b": {},
    "seamless-m4t-large-v2": {},
}
# K5's keys at each MoE arch's training call (gate/up; down adds a
# prime): jamba's C = 768 rows an expert, mixtral's 1,536, 8,192 real
# rows each.
ZOOTRAIN_K5 = {"jamba-v0.1-52b": "jt", "mixtral-8x22b": "xt"}
ZOOTRAIN_STEPS = 4
# At the reference's init (wq's fan_in is H, so attention logits reach the
# hundreds) an attention stack's gradient grows several-fold a layer: on
# an H100 (80GB HBM3, 700 W) paligemma's grad norm was ~5e2 at 2 layers
# and ~1e15 at its 18, seamless's ~4e3 at 2 + 2 and inf at 24 + 24 (the
# norm's f32 squares overflow, and the clip scales the update to 0).
# Under the clip (norm 1) AdamW's eps then swamps every leaf but the
# largest, and the full-depth losses stay flat.  These two are held to
# finite losses at full depth, and their 2-layer cut (``cut_learns``) to
# a falling loss.
ZOOTRAIN_STALLS = ("paligemma-3b", "seamless-m4t-large-v2")
# (c): the 256-blocks of each leaf the CPU's 8-bit update repeats: about
# ZOOTRAIN_SAMPLE a leaf at a stride, and ZOOTRAIN_EDGE at each end and on
# each side of every chunk boundary.  OPT8_TOL: the optimizer tests' 1e-6.
ZOOTRAIN_SAMPLE = 4096
ZOOTRAIN_EDGE = 4
OPT8_TOL = 1e-6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = card_name()
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    faults = planted_libraries()
    counting = counting_library()
    dw_fault = planted_dw_library()
    builds = [m.build for m in (K, PK, GK)] + [
        lib.load for lib in (*faults.values(), counting, dw_fault)]
    with ThreadPoolExecutor(len(builds)) as pool:
        futures = [pool.submit(b) for b in builds]
        # -- data: the main path's catalog, made on the host while nvcc runs
        t1 = time.perf_counter()
        cat = make_skyquery_catalog()
        trace = trace_records(cat)
        n_probes = sum(len(r["payload"]["positions"]) for r in trace)
        print(f"[data] catalog {cat.n_objects} objects, {cat.n_buckets} "
              f"buckets; {len(trace)} queries, {n_probes} probe objects; "
              f"{time.perf_counter() - t1:.2f}s beside the builds", flush=True)
        for fut in futures:
            fut.result()
    print(f"[build] three libraries, {len(faults)} planted-fault copies of "
          f"the cross-match kernel, its counting build and a planted-fault "
          f"copy of the grouped matmul in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    for mod in (K, PK, GK):
        info = mod.build_info()
        print(f"[build] {info['path']} compiled={info['compiled']} "
              f"{info['seconds']:.2f}s", flush=True)
        for line in info["log"].splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"[build]   {line.strip()}")
    print(f"[build] phase 1 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 2. kernels against their plain versions ----------------------------
    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    buckets = largest_buckets(cat, 4)
    rng = np.random.default_rng(11)
    checks = []
    for m in PROBE_COUNTS:
        for c in kernel_cases(buckets[0], m, rng, dev):
            measure(c, counting)
            checks.append(c)
    check_planted_faults(faults, checks)
    print(f"[kernels] phase 2 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 3. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    by_run, batches, obs_off = run_main_path(cat, trace)
    print(f"[main] phase 3 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 4. kernels at the main path's shapes --------------------------------
    t0 = time.perf_counter()
    shaped = main_shape_cases(buckets, batches, rng, dev)
    records = [measure(c, counting) for c in shaped]
    profile_cases(checks + shaped + [c["padded"] for c in shaped
                                     if "padded" in c])
    print(f"[shapes] phase 4 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 5. K4 against its plain version -------------------------------------
    t0 = time.perf_counter()
    paged = run_paged_phase(dev)
    k4 = dict(paged["a"], shapes={k: v for k, v in paged.items() if k != "a"})
    records.append(k4)
    print(f"[paged] phase 5 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 6. the serving path ---------------------------------------------------
    t0 = time.perf_counter()
    by_run["serve"] = run_serve_path(SERVE_ARCH, "serve", CPU_STEPS)
    print(f"[serve] phase 6 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 7. K5 against its plain version -------------------------------------
    t0 = time.perf_counter()
    grouped = {key: measure_grouped(key, shape, dev)
               for key, shape in GMM_SHAPES.items()}
    for key, (routing, d, f, dtype) in GMM_DECODE_SHAPES.items():
        grouped[key] = measure_grouped_decode(key, routing, d, f, dtype, dev)
    grouped_dw = measure_grouped_dw(GMM_DW_ELEM, GMM_SHAPES[GMM_DW_ELEM], dev)
    k5 = dict(grouped["a"], shapes={
        k: v for k, v in grouped.items() if k != "a"})
    records.append(k5)
    print(f"[grouped] phase 7 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 8. the MoE serving path ----------------------------------------------
    t0 = time.perf_counter()
    by_run["moe"] = run_serve_path(MOE_ARCH, "moe", MOE_CPU_STEPS)
    print(f"[moe] phase 8 in {time.perf_counter() - t0:.1f}s", flush=True)
    spread = get_config(MOE_ARCH).n_layers * (
        2 * grouped["e"]["ms"] + grouped["e'"]["ms"])
    print(f"[moe] K5 a step at phase 7's spread routing "
          f"({grouped['e']['active_experts']} active experts): layers x "
          f"(2 x (e) + (e')) = {spread:.3f} ms", flush=True)

    # -- 9. the durable service tier -------------------------------------------
    t0 = time.perf_counter()
    by_run["daemon"] = run_daemon_phase(cat, trace, obs_off, smi)
    print(f"[daemon] phase 9 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 10. the drivers ---------------------------------------------------------
    t0 = time.perf_counter()
    by_run["drivers"] = run_drivers_phase(smi)
    print(f"[drivers] phase 10 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 11. the rest of the model zoo: decode and prefill ---------------------
    t0 = time.perf_counter()
    by_run["zoo"] = run_zoo_phase(smi)
    print(f"[zoo] phase 11 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 12. training: K5's backward and the train step at full width -------
    t0 = time.perf_counter()
    by_run["train"], backward = run_train_phase(smi, dw_fault)
    backward[1]["shapes"][GMM_DW_ELEM] = grouped_dw
    records.extend(backward)
    print(f"[train] phase 12 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 13. the trainer: checkpoint and resume at full width ----------------
    t0 = time.perf_counter()
    by_run["trainer"], resumed = run_trainer_phase(smi)
    print(f"[trainer] phase 13 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 14. the mesh tools: the dry-run and the elastic restore -------------
    t0 = time.perf_counter()
    by_run["mesh"] = run_mesh_phase(smi, resumed)
    shutil.rmtree(TRAINER_DIR)
    print(f"[mesh] phase 14 in {time.perf_counter() - t0:.1f}s", flush=True)

    # -- 15. the sequence-parallel decode ------------------------------------
    t0 = time.perf_counter()
    by_run["sharded"] = run_sharded_phase(smi)
    print(f"[sharded] phase 15 in {time.perf_counter() - t0:.1f}s",
          flush=True)

    # -- 16. training the rest of the zoo -------------------------------------
    t0 = time.perf_counter()
    by_run["zootrain"] = run_zootrain_phase(smi, backward, k5["shapes"])
    print(f"[zootrain] phase 16 in {time.perf_counter() - t0:.1f}s",
          flush=True)

    for rec in records:
        rec["launches_by_run"] = {
            run: counts.get(rec["name"], 0) for run, counts in by_run.items()
        }
        rec["launches"] = sum(rec["launches_by_run"].values())
    missing = [r["name"] for r in records if r["launches"] <= 0]
    if missing:
        raise SystemExit(f"main path never launched {missing}")
    for r in records:
        lib = r.get("library_ms")
        extra = (f"dots-only {r['dots_mm_ms']:.4f} ms" if "dots_mm_ms" in r
                 else f"library {lib:.4f} ms" if lib is not None
                 else "library none")
        wrap = (f" (one call {r['wrapper_ms']:.4f} ms)" if "wrapper_ms" in r
                else "")
        print(f"[summary] {r['name']} ({r['shape']}): kernel "
              f"{r['ms']:.4f} ms{wrap}, plain {r['plain_ms']:.4f} ms, {extra}, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), launches "
              f"{r['launches_by_run']}")

    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind,
                   "count": torch.cuda.device_count()},
    }))
    return 0


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in pairs)
    return float(times[len(times) // 2])


def many_ms(fn, n: int = MANY) -> float:
    """Device time of ``fn``: ``n`` runs between one pair of CUDA events,
    over ``n``, after a warm-up.  The launches queue ahead of the device, so
    a kernel longer than the wrapper's host time is timed alone; a shorter
    one times the host (see ``profiled_ms``)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return float(start.elapsed_time(end)) / n


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def profiled_ms(fn, name: str, n: int = MANY):
    """``profiled_runs`` of one fn: its kernel's mean duration over the
    launches traced, or None (``cm_tune.py``)."""
    return profiled_runs([fn], name, n)[0][0]


# ---------------------------------------------------------------- tolerance
def within_ulps(a, b, ulps=ULPS):
    """|a - b| <= ulps * spacing of the larger magnitude, in float32."""
    a64 = np.asarray(a, np.float64)
    b64 = np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a64), np.abs(b64)).astype(np.float32)
    return np.abs(a64 - b64) <= ulps * np.spacing(mag).astype(np.float64)


class JoinMismatch(SystemExit):
    """A kernel's join disagrees with its plain version (exits non-zero
    where not caught)."""


def check_join(label, case, got, want):
    """Hold a kernel's (idx, dot, cnt) against the plain version's.

    ``case`` has the padded f32 inputs ``b8``/``p8`` (CUDA tensors), the
    per-row threshold ``thr`` (numpy f32) and ``keep(rows)`` -> bool mask
    (len(rows), N) of the pairs that take part.  A best_idx may differ on
    a 2-ulp tie of two different rows; between identical bucket rows
    (equal dots on both sides) the lowest index must win.  Raises
    ``JoinMismatch``; returns max |dot diff|."""
    gi, gd, gc = (x.cpu().numpy() for x in got)
    wi, wd, wc = (x.cpu().numpy() for x in want)
    b64 = case["b8"].double()

    def dots64(rows):
        p = case["p8"][torch.as_tensor(rows, device=b64.device)].double()
        d = p @ b64.t()
        keep = case["keep"](rows)
        return torch.where(keep, d, torch.full_like(d, -2.0)).cpu().numpy()

    bad_dot = ~within_ulps(gd, wd)
    if bad_dot.any():
        r = int(np.nonzero(bad_dot)[0][0])
        raise JoinMismatch(f"{label}: best_dot differs beyond {ULPS} ulp at "
                           f"row {r}: {gd[r]!r} vs {wd[r]!r}")
    rows = np.nonzero(gi != wi)[0]
    if rows.size:
        d = dots64(rows)
        a = d[np.arange(rows.size), gi[rows]]
        b = d[np.arange(rows.size), wi[rows]]
        tie = within_ulps(a, b)
        if not tie.all():
            r = int(rows[~tie][0])
            raise JoinMismatch(f"{label}: best_idx differs at row {r} "
                               f"({gi[r]} vs {wi[r]}) without a {ULPS}-ulp "
                               f"tie")
        b8 = case["b8"]
        same = (b8[torch.as_tensor(gi[rows], device=b8.device)]
                == b8[torch.as_tensor(wi[rows], device=b8.device)]).all(1)
        if same.any():
            r = int(rows[same.cpu().numpy()][0])
            raise JoinMismatch(f"{label}: best_idx {gi[r]} at row {r} where "
                               f"the identical bucket row {wi[r]} comes "
                               f"first (ties take the lowest index)")
    rows_c = np.nonzero(gc != wc)[0]
    if rows_c.size:
        d = dots64(rows_c)
        thr = case["thr"][rows_c].astype(np.float64)[:, None]
        near = within_ulps(d, np.broadcast_to(thr, d.shape)).any(axis=1)
        if not near.all():
            r = int(rows_c[~near][0])
            raise JoinMismatch(f"{label}: n_cand differs at row {r} "
                               f"({gc[r]} vs {wc[r]}) with no pair near the "
                               f"threshold")
    print(f"[kernels]   {label}: ok (idx ties {rows.size}, near-threshold "
          f"counts {rows_c.size})", flush=True)
    return float(np.max(np.abs(gd.astype(np.float64) - wd)))


def largest_buckets(cat, k: int) -> list:
    """Positions of the catalog's ``k`` largest buckets (10,000 rows each
    at the main path's partitioning)."""
    sizes = [cat.partitioner.object_slice(b).size for b in range(cat.n_buckets)]
    ids = np.argsort(sizes, kind="stable")[::-1][:k]
    return [cat.store.read(int(b))["positions"] for b in ids]


def near_probes(bucket_pos, m, rng):
    """``m`` unit vectors: three in four within ~2e-3 rad of a bucket row,
    the rest anywhere on the sky."""
    near = bucket_pos[rng.integers(0, len(bucket_pos), m)] + rng.normal(
        scale=2e-3, size=(m, 3)
    )
    probes = near / np.linalg.norm(near, axis=1, keepdims=True)
    sky = rng.normal(size=(m // 4, 3))
    probes[: m // 4] = sky / np.linalg.norm(sky, axis=1, keepdims=True)
    return probes


def k1_case(bucket_pos, probes, thr, band, label, dev):
    """A K1 case, built as ``ops.crossmatch`` builds it on ``cuda``: the
    padded bucket, the real probe rows only, the real bucket row count and
    the padded probe count (the band's grid)."""
    b8, p8, n_real, m = ops._host_prepare(bucket_pos, probes, 128, 512,
                                          pad_probes=False)
    m_grid = ops._probe_grid(m, 128)
    b8t, p8t = torch.from_numpy(b8).to(dev), torch.from_numpy(p8).to(dev)
    n = b8.shape[0]
    keep_fn = (ref.band_keep(m_grid, n, 128, 512, band, dev)
               if band is not None else None)

    def keep(rows):
        if keep_fn is None:
            return torch.ones(len(rows), n, dtype=torch.bool, device=dev)
        return torch.cat([keep_fn(int(r), int(r) + 1) for r in rows])

    r = K.segment_layout()[0]
    rows = K.bucket_rows_taken(n, n_real, thr)
    _, splits = K.segment_plan(m, rows, dev)
    real_lo, real_hi = k1_ranges(m, n_real, band, m_grid, n, m)
    walk_lo, walk_hi = k1_ranges(m, rows, band, m_grid, n, -(-m // r) * r, r)
    pairs = int((real_hi - real_lo).sum())
    plan = dict(probes_a_thread=r, splits=splits, real_pairs=pairs,
                walked_pairs=int((walk_hi - walk_lo).sum()))
    kw = dict(bm=128, bn=512, band=band)
    return dict(
        name="crossmatch", label=label, b8=b8t, p8=p8t,
        thr=np.full(m, thr, np.float32), keep=keep,
        kernel=lambda: K.crossmatch_kernel(b8t, p8t, thr, n_real=n_real,
                                           m_grid=m_grid, **kw),
        plain=lambda: ref.crossmatch_ref(b8t, p8t, thr, m_grid=m_grid, **kw),
        pairs=pairs, in_bytes=(b8.size + p8.size) * 4, plan=plan, rows=rows,
    )


def k1_ranges(m, rows, band, m_grid, n_grid, count, r=1):
    """(lo, hi) of each of ``count`` probe rows' bucket ranges in a K1 join
    of ``m`` probes (``ref.bucket_rows`` on tiles of 128 x 512, rows [0,
    ``rows``)); with ``r`` probes a thread, a row past the last takes its
    thread's first row's range, as the kernel does, so a thread's pairs
    are the sum of its rows' range lengths."""
    lo, hi = ref.bucket_rows(m_grid, rows, band, 128, 512, m_grid, n_grid)
    at = np.arange(count)
    at = np.where(at < m, at, at // r * r)
    return np.stack([lo.numpy()[at], hi.numpy()[at]])


def seg_cases(bucket_pos, probes, bseg, pseg, thr_real, label, dev,
              pad_probes=False):
    """The K2 case (threshold cos 5e-3) and the K3 case (per-probe
    thresholds ``thr_real``) on one segmented input, built as the card
    path builds it (``ops.crossmatch_fused``/``crossmatch_shared`` on
    ``cuda``: the real probe rows only), or with ``pad_probes`` as the
    reference pads it."""
    b8s, p8s, bs, ps, _, m = ops._segmented_inputs(
        bucket_pos, probes, bseg, pseg, 128, 512, pad_probes
    )
    b8t, p8t = torch.from_numpy(b8s).to(dev), torch.from_numpy(p8s).to(dev)
    bst, pst = torch.from_numpy(bs).to(dev), torch.from_numpy(ps).to(dev)
    thr_row = np.full(p8s.shape[0], 2.0, np.float32)
    thr_row[:m] = thr_real
    thr_t = torch.from_numpy(thr_row).to(dev)
    pairs = seg_pair_count(bs, ps)
    in_bytes = (b8s.size + p8s.size + bs.size + ps.size) * 4
    r = K.segment_layout()[0]
    _, splits = K.segment_plan(p8s.shape[0], b8s.shape[0], dev)
    plan = dict(probes_a_thread=r, splits=splits,
                walked_pairs=walked_pairs(bs, ps, r), real_pairs=pairs)

    def keep(rows):
        r = torch.as_tensor(rows, device=dev)
        return pst[r][:, None] == bst[None, :]

    thr = float(np.cos(5e-3))
    shape = "padded" if pad_probes else "card path"
    return [
        dict(name="crossmatch_fused", label=f"K2 {label} ({shape})", b8=b8t,
             p8=p8t, thr=np.full(p8s.shape[0], thr, np.float32), keep=keep,
             kernel=lambda: K.crossmatch_fused_kernel(b8t, p8t, bst, pst, thr),
             plain=lambda: ref.crossmatch_fused_ref(b8t, p8t, bst, pst, thr),
             pairs=pairs, in_bytes=in_bytes, plan=plan),
        dict(name="crossmatch_shared", label=f"K3 {label} ({shape})", b8=b8t,
             p8=p8t, thr=thr_row, keep=keep,
             kernel=lambda: K.crossmatch_shared_kernel(b8t, p8t, bst, pst,
                                                       thr_t),
             plain=lambda: ref.crossmatch_shared_ref(b8t, p8t, bst, pst,
                                                     thr_t),
             pairs=pairs, in_bytes=in_bytes + thr_row.size * 4, plan=plan),
    ]


def kernel_cases(bucket_pos, m, rng, dev):
    """Phase 2's K1/K2/K3 cases at one probe count on one bucket of
    10,000 rows (N = 16,384), with ties and probes at the ranges' last
    rows (``seg_fault_data``, ``band_edge_probes``)."""
    n_real = len(bucket_pos)
    bucket, probes = seg_fault_data(bucket_pos, near_probes(bucket_pos, m, rng),
                                    m, rng)
    k1_probes = band_edge_probes(bucket, probes, rng)
    cases = [
        k1_case(bucket, k1_probes, thr, band,
                f"K1 M={m} thr={thr:.6g} band={band}", dev)
        for thr, band in ((float(np.cos(5e-3)), None),
                          (float(np.cos(5e-3)), K1_BAND),
                          (float(np.cos(2.0)), None))
    ]
    # K2 / K3: 4 segments, segment 2 has probes but no bucket rows.
    bseg = np.repeat([0, 1, 3], [3000, 3000, n_real - 6000])
    pseg = np.repeat([0, 1, 2, 3], m // 4)
    radii = np.array([1e-3, 2e-3, 2.5e-3, 5e-3, 1e-2, 2e-2, 0.1, 2.0])
    thr_real = np.cos(radii)[np.arange(m) % 8].astype(np.float32)
    k2, k3 = seg_cases(bucket, probes, bseg, pseg, thr_real,
                       f"M={m} k=4 (one empty)", dev)
    k3["label"] += ", 8 thresholds"
    return cases + [k2, k3]


def seg_fault_data(bucket_pos, probes, m, rng):
    """Phase 2's K2/K3 data, where each planted fault shows: one bucket
    row in 20 copied onto the next row (exact ties, some across a split
    boundary), and in each segment's quarter of the probes, 8 within 1e-4
    rad of the segment's last row (its best, and a candidate, in the last
    split)."""
    bucket = bucket_pos.copy()
    dup = np.nonzero(rng.random(len(bucket) - 1) < 0.05)[0]
    bucket[dup + 1] = bucket[dup]
    probes = probes.copy()
    for seg_quarter, last_row in ((0, 2999), (1, 5999), (3, len(bucket) - 1)):
        at = seg_quarter * (m // 4) + np.arange(min(8, m // 4))
        p = bucket[last_row] + rng.normal(scale=1e-4, size=(len(at), 3))
        probes[at] = p / np.linalg.norm(p, axis=1, keepdims=True)
    return bucket, probes


def band_edge_probes(bucket, probes, rng):
    """K1's phase-2 probes: ``probes`` with each tile row's last 8 (of
    128) within 1e-4 rad of the last row its band (``K1_BAND`` tiles of
    512 each side) keeps of the real rows, where dropping the band's last
    tile moves their best."""
    m, n_real = len(probes), len(bucket)
    n_grid = ops._ceil_to(ops._pow2_ceil(n_real), 512)
    _, hi = ref.bucket_rows(m, n_real, K1_BAND, 128, 512,
                            ops._probe_grid(m, 128), n_grid)
    out = probes.copy()
    for i in range(m // 128):
        at = np.arange(i * 128 + 120, (i + 1) * 128)
        p = bucket[int(hi[at[0]]) - 1] + rng.normal(scale=1e-4, size=(8, 3))
        out[at] = p / np.linalg.norm(p, axis=1, keepdims=True)
    return out


def main_shape_cases(buckets, batches, rng, dev):
    """Phase 4: each kernel at the shape the main path gave it.  K1 joins
    one bucket with run A's largest probe batch; K2 and K3 join four
    whole buckets (N = 65,536) with the largest probe batch of run B and
    run C (for C, the whole shared group before ``share_width`` chunks
    it: at most what one K3 call sees), the probes split evenly over the
    four segments, as the card path hands them (the real rows); the same
    probes padded as the reference pads them make a second case under
    ``padded``.  K3's thresholds are run C's radii."""
    m1 = batches["A"]
    k1 = k1_case(buckets[0], near_probes(buckets[0], m1, rng),
                 float(np.cos(5e-3)), None, f"K1 main shape M={m1}", dev)
    bucket_cat = np.concatenate(buckets)
    bseg = np.repeat(np.arange(len(buckets)), [len(b) for b in buckets])
    out = [k1]
    for run, name in (("B", "crossmatch_fused"), ("C", "crossmatch_shared")):
        m = batches[run]
        parts = np.array_split(np.arange(m), len(buckets))
        probes = np.concatenate([
            near_probes(b, len(p), rng) for b, p in zip(buckets, parts)
        ])
        pseg = np.repeat(np.arange(len(buckets)), [len(p) for p in parts])
        radii = np.array([2.5e-3, 5e-3, 1e-2])
        thr_real = np.cos(radii)[np.arange(m) % 3].astype(np.float32)
        real, padded = (
            next(c for c in seg_cases(bucket_cat, probes, bseg, pseg,
                                      thr_real, f"main shape M={m} k=4", dev,
                                      pad_probes=pad) if c["name"] == name)
            for pad in (False, True)
        )
        real["padded"] = padded
        out.append(real)
    return out


def seg_pair_count(bseg, pseg):
    """Real pairs of equal segment: the work a segment-masked join must do
    (padded rows, of segment ``PAD_SEG``, need none)."""
    vals, nb = np.unique(bseg[bseg != K.PAD_SEG], return_counts=True)
    pv, npr = np.unique(pseg[pseg != K.PAD_SEG], return_counts=True)
    _, ib, ip = np.intersect1d(vals, pv, return_indices=True)
    return int((nb[ib].astype(np.int64) * npr[ip]).sum())


def walked_pairs(bseg, pseg, probes_a_thread) -> int:
    """Pairs the segment kernel's threads compute: each thread takes
    ``probes_a_thread`` consecutive probes and walks, with all of its
    chains, the rows of every distinct segment among them (a thread
    straddling a segment edge walks both)."""
    r = probes_a_thread
    ps = np.full(-(-len(pseg) // r) * r, np.nan, np.float64)
    ps[:len(pseg)] = pseg
    ps = np.sort(ps.reshape(-1, r), axis=1)  # NaN (no probe) last
    first = np.ones(ps.shape, bool)
    first[:, 1:] = ps[:, 1:] != ps[:, :-1]
    first &= ~np.isnan(ps)
    b = np.asarray(bseg, np.float64)
    v = np.where(first, ps, 0.0)
    rows = np.searchsorted(b, v, "right") - np.searchsorted(b, v, "left")
    return int(r * (rows * first).sum())


def measure(c, counting: CudaLibrary) -> dict:
    """Hold one case's kernel against its plain version, time both and a
    dots-only ``torch.mm`` of the same operands, and count the pairs it
    walks and its splits on the card with the ``counting`` build, which
    must match the plan (``c["plan"]``: the pairs the kernel's design
    walks); return its record (with the padded shape's record under
    ``shapes`` where the case has one)."""
    got = c["kernel"]()
    err = check_join(c["label"], c, got, c["plain"]())
    walked, splits = count_on_card(c, counting, got)
    plan = c["plan"]
    if (walked, splits) != (plan["walked_pairs"], plan["splits"]):
        raise SystemExit(f"{c['label']}: the card walked {walked} pairs in "
                         f"{splits} splits; the plan is "
                         f"{plan['walked_pairs']} in {plan['splits']}")
    k_ms = cuda_ms(c["kernel"], REPS)
    dev_ms = many_ms(c["kernel"])
    p_ms = cuda_ms(c["plain"], REPS)
    b8, p8 = c["b8"], c["p8"]
    mm_ms = cuda_ms(lambda: torch.mm(p8, b8.t()), REPS)
    m, n = p8.shape[0], b8.shape[0]
    flops = 8.0 * c["pairs"]  # 4 FMA per real pair
    nbytes = c["in_bytes"] + 12.0 * m
    bound, bound_by = bound_ms(nbytes, flops, PEAK_FP32_FLOPS)
    plan_txt = (f" [{plan['probes_a_thread']} probes a thread, {splits} "
                f"splits, pairs walked {walked} (counted on the card) vs real "
                f"{plan['real_pairs']} "
                f"({walked / max(plan['real_pairs'], 1):.4f}x)]")
    print(f"[kernels]   {c['label']}: M={m} N={n} pairs={c['pairs']} kernel "
          f"{k_ms:.4f} ms ({k_ms / bound:.2f}x bound; device {dev_ms:.4f} ms "
          f"over {MANY} launches), plain {p_ms:.4f} ms, "
          f"torch.mm dots-only {mm_ms:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by}){plan_txt}", flush=True)
    rec = dict(
        name=c["name"], route="cuda", source=SOURCE,
        replaces=REPLACES[c["name"]], launches=0, max_abs_err=err,
        ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
        library_ms=None, dots_mm_ms=mm_ms, device_ms=dev_ms,
        profiled_ms=None, shape=f"M={m}, N={n}",
        probes_a_thread=plan["probes_a_thread"], splits=splits,
        walked_pairs=walked,
    )
    if "padded" in c:
        rec["shapes"] = {"padded": measure(c["padded"], counting)}
    c["record"] = rec
    return rec


def profile_cases(cases) -> None:
    """Each case's kernel's ``profiled_runs`` time, set as its record's
    ``profiled_ms``: all cases in one trace, after phase 3's."""
    runs = profiled_runs([c["kernel"] for c in cases], "crossmatch")
    for c, (ms, traced) in zip(cases, runs):
        c["record"]["profiled_ms"] = ms
        print(f"[kernels]   {c['label']}: profiled {fmt_ms(ms)} ms ({traced} "
              f"of {MANY} launches traced)", flush=True)


# ---------------------------------------------------------------- faults
def source_copy(text: str, where: str, name: str = "crossmatch",
                bind=K._bind) -> CudaLibrary:
    """A ``CudaLibrary`` of ``text``, a variant of ``csrc/<name>.cu``
    (``SOURCE`` by default) written to ``build/<where>/<name>.cu``."""
    path = os.path.join(ROOT, "build", where, f"{name}.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    lib = CudaLibrary(name, bind)
    lib.source = pathlib.Path(path)
    return lib


def planted_libraries() -> dict:
    """{fault: CudaLibrary} of copies of ``SOURCE`` with one planted fault
    each (``PLANTED_FAULTS``), written under ``build/planted/``; built in
    phase 1 beside the real libraries."""
    text = open(os.path.join(ROOT, SOURCE)).read()
    out = {}
    for i, (fault, (old, new, _)) in enumerate(PLANTED_FAULTS.items()):
        if text.count(old) != 1:
            raise SystemExit(f"planted fault {fault!r}: its line is not in "
                             f"{SOURCE} exactly once")
        out[fault] = source_copy(text.replace(old, new), f"planted/{i}")
    return out


def planted_dw_library() -> CudaLibrary:
    """A copy of ``GMM_SOURCE`` with ``DW_PLANTED_FAULT`` (the TMA dW
    kernel keeps the rows past each count), under ``build/planted/dw/``."""
    text = open(os.path.join(ROOT, GMM_SOURCE)).read()
    old, new = DW_PLANTED_FAULT
    if text.count(old) != 1:
        raise SystemExit(f"planted dW fault: its line is not in "
                         f"{GMM_SOURCE} exactly once")
    return source_copy(text.replace(old, new), "planted/dw",
                       "grouped_matmul", GK._bind)


def counting_library() -> CudaLibrary:
    """``SOURCE`` built with ``CROSSMATCH_COUNT_PAIRS``: the same kernel,
    which also counts on the card the pairs it dots and the splits it
    launched (``crossmatch_count_read``); under ``build/counting/``."""
    text = open(os.path.join(ROOT, SOURCE)).read()
    return source_copy("#define CROSSMATCH_COUNT_PAIRS\n" + text, "counting")


def count_on_card(c, lib: CudaLibrary, want) -> tuple:
    """(pairs walked, splits) of one call of case ``c``'s kernel, counted
    on the card by the counting build ``lib``, whose outputs must equal
    ``want``, the kernel's, bit for bit."""
    saved = K.LIBRARY
    K.LIBRARY = lib
    try:
        read = lib.load().crossmatch_count_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        read.restype = ctypes.c_int
        pairs, splits = ctypes.c_ulonglong(0), ctypes.c_uint(0)
        lib.check(read(ctypes.byref(pairs), ctypes.byref(splits)),
                  "crossmatch_count_read")
        got = c["kernel"]()
        lib.check(read(ctypes.byref(pairs), ctypes.byref(splits)),
                  "crossmatch_count_read")
    finally:
        K.LIBRARY = saved
    for g, w in zip(got, want):
        if not torch.equal(g.view(torch.int32), w.view(torch.int32)):
            raise SystemExit(f"{c['label']}: the counting build's outputs "
                             f"differ from the kernel's")
    return int(pairs.value), int(splits.value)


def check_planted_faults(faults: dict, cases) -> None:
    """Each planted fault, launched through the wrappers on phase 2's
    cases, must fail phase 2's check on the cases of every join it names
    (K1: ``crossmatch``; K2/K3: the segmented joins); exits if one
    passes."""
    want = [c["plain"]() for c in cases]
    saved = K.LIBRARY
    try:
        for fault, lib in faults.items():
            K.LIBRARY = lib
            for joins in PLANTED_FAULTS[fault][2]:
                caught = None
                for c, w in zip(cases, want):
                    if (c["name"] == "crossmatch") != (joins == "K1"):
                        continue
                    try:
                        check_join(c["label"], c, c["kernel"](), w)
                    except JoinMismatch as e:
                        caught = str(e)
                        break
                if caught is None:
                    raise SystemExit(f"planted fault {fault!r} passed phase "
                                     f"2's check of {joins}")
                print(f"[faults] {fault}: fails phase 2's check of {joins}, "
                      f"as it must: {caught}", flush=True)
    finally:
        K.LIBRARY = saved


# ---------------------------------------------------------------- main path
def encode_round(outcome) -> tuple:
    """The decision-log fields of one round (bit-comparable)."""
    v = outcome.vector
    return (
        tuple((int(d.bucket_id), float(d.score), bool(d.in_cache),
               int(d.queue_size)) for d in outcome.decisions),
        float(outcome.cost),
        (float(v.alpha), int(v.fuse_k), bool(v.spill),
         int(getattr(v, "share_width", 0))),
        tuple(int(b) for b in outcome.spill_changed),
        float(getattr(outcome, "stall", 0.0)),
    )


def submit_all(eng, queries) -> float:
    """``CrossMatchEngine.run``'s intake half: admit the whole trace in
    arrival order; returns its wall seconds."""
    t0 = time.perf_counter()
    for q in sorted(queries, key=lambda q: q.arrival_time):
        eng.sim_clock = max(eng.sim_clock, q.arrival_time)
        eng.submit(q)
    return time.perf_counter() - t0


def drain(eng, device) -> float:
    """``CrossMatchEngine.run``'s drain half: service rounds until idle;
    returns its wall seconds, ending in a synchronise on the card."""
    t0 = time.perf_counter()
    while eng.step() is not None:
        pass
    eng.close()
    if device != "cpu":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def drive(cat, records, kind, device, n, obs=None):
    """One run of the main path as ``engine.run`` does it, timed in its
    intake and drain halves."""
    eng = make_engine(cat, kind, device, obs=obs)
    log: list = []
    eng.loop.add_round_tap(lambda o: log.append(encode_round(o)))
    queries = queries_for(records, kind, n)
    t_in = submit_all(eng, queries)
    t_out = drain(eng, device)
    done = len(eng.wm.response_times())
    if done != len(queries):
        raise SystemExit(f"run {kind} on {device}: {done} of {len(queries)} "
                         f"queries completed")
    return eng, log, eng.results, queries, (t_in, t_out)


def profile_drain(cat, records, kind):
    """Device busy share of one run's drain, from a torch.profiler trace:
    the summed durations of the device's kernels and copies over the
    drain's wall time (profiler on)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine(cat, kind, DEVICE)
    submit_all(eng, queries_for(records, kind, len(records)))
    reset_all_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = drain(eng, DEVICE)
    launched = sum(K.LAUNCHES.values())
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e for e in dev if "crossmatch" in e.name]
    if len(kern) != launched:
        raise SystemExit(f"[profile] run {kind}: the trace holds {len(kern)} "
                         f"cross-match kernels of the {launched} launched")
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    kern_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    copy_ms = sum(e.time_range.elapsed_us() for e in dev
                  if "memcpy" in e.name.lower()) / 1e3
    print(f"[profile] run {kind}: drain {wall:.3f}s under the profiler; device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / 1e3 / wall:.3f}%): "
          f"crossmatch kernels {kern_ms:.3f} ms in {len(kern)} launches, "
          f"copies {copy_ms:.3f} ms, {len(dev)} device events", flush=True)


def result_rows(cat, results):
    """{(query, bucket, probe): (match_obj, best_dot, n_cand)}."""
    bucket_of = np.empty(cat.n_objects, np.int64)
    for b in range(cat.n_buckets):
        bucket_of[cat.partitioner.object_slice(b)] = b
    out = {}
    for qid, groups in results.items():
        for r in groups:
            for p, mo, d, c in zip(r.probe_idx, r.match_obj, r.best_dot,
                                   r.n_candidates):
                key = (int(qid), int(bucket_of[mo]), int(p))
                if key in out:
                    raise SystemExit(f"duplicate result row {key}")
                out[key] = (int(mo), np.float32(d), int(c))
    return out


def compare_results(cat, eng, queries, got, want, label):
    """Per-query results of a cuda run vs the cpu run, under the join
    tolerance: a differing row must be explained by a 2-ulp tie of its
    best index or a pair within 2 ulp of its threshold."""
    g, w = result_rows(cat, got), result_rows(cat, want)
    qmap = {q.query_id: q for q in queries}
    n_explained = 0
    for key in sorted(set(g) | set(w)):
        a, b = g.get(key), w.get(key)
        if a == b:
            continue
        if a is not None and b is not None and not within_ulps(a[1], b[1]):
            raise SystemExit(f"{label}: result row {key} best_dot differs "
                             f"beyond {ULPS} ulp: cuda {a} cpu {b}")
        qid, bucket, p = key
        pos = cat.store.read(bucket)["positions"].astype(np.float32)
        probe = qmap[qid].payload["positions"][p].astype(np.float32)
        d = pos.astype(np.float64) @ probe.astype(np.float64)
        thr, _ = eng._pred_of(qid)
        thr32 = np.float32(thr)
        near_thr = within_ulps(d, np.full_like(d, thr32)).any()
        top = d.max()
        tie = int(within_ulps(d, np.full_like(d, top)).sum()) > 1
        if a is not None and b is not None:
            ok = (a[0] == b[0] or tie) and (a[2] == b[2] or near_thr)
        else:  # matched on one side only: a threshold or mag-cut edge
            ok = near_thr or tie
        if not ok:
            raise SystemExit(f"{label}: result row {key} differs: cuda {a} "
                             f"cpu {b}")
        n_explained += 1
    return len(g), n_explained


def all_launches() -> dict:
    return {**K.LAUNCHES, **PK.LAUNCHES, **GK.LAUNCHES}


def reset_all_launches() -> None:
    K.reset_launches()
    PK.reset_launches()
    GK.reset_launches()


def run_main_path(cat, records):
    """Phase 3; returns each run's kernel launches, its largest probe
    batch (the engine's ``max_probe_batch``), and its decision log, results
    and times (for phase 9's obs-on runs)."""
    n_cpu = min(CPU_QUERIES, len(records))
    expect = {"A": "crossmatch", "B": "crossmatch_fused",
              "C": "crossmatch_shared"}
    by_run, batches, runs = {}, {}, {}
    for kind in ("A", "B", "C"):
        reset_all_launches()
        eng, log, res, queries, (t_in, t_out) = drive(
            cat, records, kind, DEVICE, len(records)
        )
        launches = all_launches()
        runs[kind] = dict(log=log, results=res, intake=t_in, drain=t_out)
        by_run[kind] = launches
        batches[kind] = int(eng.max_probe_batch)
        dd = eng.summary()["device_dispatches"]
        n_match = sum(len(r.probe_idx) for g in res.values() for r in g)
        print(f"[main] run {kind}: {len(queries)} queries in "
              f"{t_in + t_out:.3f}s wall (intake {t_in:.3f}s, drain "
              f"{t_out:.3f}s), "
              f"{eng.batches} buckets serviced in {eng.dispatches} rounds, "
              f"{dd} device dispatches, launches {launches}, "
              f"max_probe_batch {batches[kind]}, {n_match} matched probes",
              flush=True)
        if launches[expect[kind]] <= 0:
            raise SystemExit(f"run {kind} never launched {expect[kind]}")
        if sum(launches.values()) != dd:
            raise SystemExit(f"run {kind}: {sum(launches.values())} launches "
                             f"but {dd} device dispatches")
        if n_cpu < len(records):
            eng, log, res, queries, _ = drive(
                cat, records, kind, DEVICE, n_cpu
            )
        _, clog, cres, _, (c_in, c_out) = drive(
            cat, records, kind, "cpu", n_cpu
        )
        if log != clog:
            first = next((i for i, (a, b) in enumerate(zip(log, clog))
                          if a != b), min(len(log), len(clog)))
            raise SystemExit(f"run {kind}: decision log differs from the cpu "
                             f"run at round {first}")
        n_rows, n_expl = compare_results(cat, eng, queries, res, cres,
                                         f"run {kind}")
        print(f"[main] run {kind} vs cpu on the first {n_cpu} queries: "
              f"{len(log)} rounds identical, {n_rows} result rows, "
              f"{n_expl} differ within tolerance; cpu wall {c_in + c_out:.3f}s",
              flush=True)
    for kind in ("A", "B", "C"):
        profile_drain(cat, records, kind)
    return by_run, batches, runs


# ---------------------------------------------------------------- phase 5
def paged_inputs(B, H, KV, D, page, pages, max_len, dev, seed):
    """bf16 q and pools of B * pages pages on the card, a permuted page
    table and ragged lengths in [1, max_len] (the first at max_len)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = B * pages
    bf = dict(device=dev, dtype=torch.bfloat16, generator=gen)
    q = torch.randn(B, H, D, **bf)
    kp = torch.randn(n, page, KV, D, **bf)
    vp = torch.randn(n, page, KV, D, **bf)
    table = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    lens = torch.randint(1, max_len + 1, (B,), device=dev, generator=gen,
                         dtype=torch.int32)
    lens[0] = max_len
    return q, kp, vp, table.view(B, pages), lens


def run_paged_phase(dev) -> dict:
    """Phase 5: K4 at every shape of ``PAGED_SHAPES`` and with its partials
    at (p), each against its plain version and timed; its records by
    shape, each with its ``profiled_ms``."""
    paged = {key: measure_paged(key, shape, dev)
             for key, shape in PAGED_SHAPES.items()}
    check_paged_partials(dev)
    paged["p"] = measure_paged("p", PARTIALS_SHAPE, dev, partials=True)
    # every shape's kernel in one profiler session (each session makes the
    # later ones of the process lose device events)
    traced = profiled_runs([r.pop("kernel_fn") for r in paged.values()],
                           "paged_attention")
    for (key, rec), (ms, _) in zip(paged.items(), traced):
        rec["profiled_ms"] = ms
        print(f"[paged] ({key}) profiled {fmt_ms(ms)} ms", flush=True)
    return paged


def measure_paged(key, shape, dev, partials=False) -> dict:
    """Phase 5, one shape: K4 against its plain version on the same card
    inputs, then its times (the module docstring says how each is taken;
    ``kernel_fn``, the timed call, goes to the caller's one profiler
    session for ``profiled_ms``),
    the plain version's and one SDPA call's over the dense K/V (gathered
    once, outside the timing) with a length mask; the bound counts the
    valid K/V slots' bytes.  ``partials``: K4 with its max and sum, held
    to ``paged_attention_partials_ref``."""
    B, H, KV, D, page, pages, max_len = shape
    q, kp, vp, table, lens = paged_inputs(*shape, dev, seed=20 + ord(key))
    if key in PAGED_FULL:
        lens.fill_(max_len)
    args = (q, kp, vp, table, lens)
    plain = paged_attention_partials_ref if partials else paged_attention_ref
    got = PK.paged_attention_kernel(*args, partials=partials)
    want = plain(*args)
    err = (check_partials(f"K4 ({key})", got, want)[0] if partials
           else check_paged(f"K4 ({key})", got, want))
    S = page * pages
    idx = table.long()
    kd = kp[idx].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    vd = vp[idx].reshape(B, S, KV, D).transpose(1, 2).contiguous()
    q4 = q.view(B, H, 1, D)
    mask = (torch.arange(S, device=dev)[None, :] < lens[:, None]).view(
        B, 1, 1, S)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def library():
        return sdpa(q4, kd, vd, attn_mask=mask, enable_gqa=H != KV)

    def kernel():
        return PK.paged_attention_kernel(*args, partials=partials)

    want_out = want[0] if partials else want
    lib_err = float((library().view(B, H, D).float()
                     - want_out.float()).abs().max())
    k_ms = many_ms(kernel)
    w_ms = cuda_ms(kernel, REPS)
    p_ms = many_ms(lambda: plain(*args))
    l_ms = many_ms(library)
    lw_ms = cuda_ms(library, REPS)
    slots = int(lens.sum())
    esize = q.element_size()
    nbytes = (2 * slots * KV * D * esize + 2 * q.numel() * esize
              + table.numel() * 4 + lens.numel() * 4
              + (2 * B * H * 4 if partials else 0))  # m and l
    flops = 4.0 * slots * H * D  # QK and PV, one FMA each
    bound, bound_by = bound_ms(nbytes, flops, PEAK_BF16_FLOPS)
    splits, chunk = PK.split_plan(S)
    ws = PK.workspace_bytes(B, H, KV, D, splits)
    path = PK.kernel_path(q, kp, vp)
    if path != ("mma" if key in PAGED_MMA else "async"):
        raise SystemExit(f"K4 ({key}): G = {H // KV}, D = {D} took the "
                         f"{path} instance")
    label = (f"({key}) B={B} H={H} KV={KV} (G={H // KV}) D={D} "
             f"page={page}x{pages} lens<= {max_len}, {slots} slots"
             + (", with partials" if partials else ""))
    print(f"[paged] {label}: max |diff| {err:.3e} (SDPA {lib_err:.3e}); "
          f"splits {splits} x chunk {chunk}, workspace {ws} B, loads {path}; "
          f"kernel {k_ms:.4f} ms ({MANY} launches), wrapper {w_ms:.4f} ms "
          f"(one call); plain {p_ms:.4f} ms; SDPA "
          f"{l_ms:.4f} ms ({MANY} launches), {lw_ms:.4f} ms (one call); "
          f"bound {bound:.4f} ms ({bound_by}, {nbytes / 1e6:.3f} MB)",
          flush=True)
    rec = dict(
        name="paged_attention", route="cuda", source=PAGED_SOURCE,
        replaces=PAGED_REPLACES, launches=0, max_abs_err=err, ms=k_ms,
        plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, library_ms=l_ms,
        wrapper_ms=w_ms, kernel_fn=kernel, library_wrapper_ms=lw_ms,
        splits=splits, chunk=chunk, workspace_bytes=ws, path=path,
        shape=label,
    )
    return rec


def check_partials(label, got, want) -> tuple:
    """K4's (out, m, l) against the plain version's: out by
    ``check_paged``, m within ``PARTIALS_M_TOL`` absolute and l within
    ``PARTIALS_L_TOL`` relative (rows with no valid slot: m = -1e30 and l
    = 0 exactly); exits if not.  Returns (out's, m's, l's max error)."""
    err = check_paged(label, got[0], want[0])
    m, l_ = got[1], got[2]
    m_err = float((m - want[1]).abs().max())
    l_err = float(((l_ - want[2]).abs() / want[2].clamp(min=1e-30)).max())
    empty = want[2] == 0
    if not (m_err <= PARTIALS_M_TOL and l_err <= PARTIALS_L_TOL
            and bool((m[empty] == -1e30).all()) and bool((l_[empty] == 0).all())):
        raise SystemExit(f"{label}: m or l differs from the plain version's "
                         f"(max |m diff| {m_err}, max l rel. diff {l_err})")
    return err, m_err, l_err


def check_paged_partials(dev) -> None:
    """Phase 5: K4's partials against the plain version at one split
    ((a)'s shape, 64 slots) and at the decode_32k shard (splits > 1), on a
    shard no slot of which is valid yet (seq_len 0) and with a bad page met
    by the last split (NaN in out, m and l of that sequence only); and
    the shard's two halves merged by ``attention._local_decode``'s formula
    against K4 on the whole shard."""
    for key, shape in (("a", PAGED_SHAPES["a"]), ("p", PARTIALS_SHAPE)):
        B, H, KV, D, page, pages, max_len = shape
        q, kp, vp, table, lens = paged_inputs(*shape, dev, seed=90 + ord(key))
        lens[1] = 0
        args = (q, kp, vp, table, lens)
        got = PK.paged_attention_kernel(*args, partials=True)
        errs = check_partials(f"K4 partials ({key})", got,
                              paged_attention_partials_ref(*args))
        if not (torch.count_nonzero(got[0][1]) == 0
                and bool((got[1][1] == -1e30).all())
                and bool((got[2][1] == 0).all())):
            raise SystemExit(f"K4 partials ({key}): an empty row is not "
                             f"(out 0, m -1e30, l 0)")
        splits, chunk = PK.split_plan(page * pages)
        bad = table.clone()
        bad[0, (splits - 1) * chunk // page] = kp.shape[0]
        out = PK.paged_attention_kernel(q, kp, vp, bad, lens, partials=True)
        torch.cuda.synchronize()
        for x in out:
            if not (bool(torch.isnan(x[0]).all())
                    and not bool(torch.isnan(x[1:]).any())):
                raise SystemExit(f"K4 partials ({key}): a bad page gives no "
                                 f"NaN, or NaN elsewhere")
        print(f"[paged] partials ({key}) B={B} H={H} D={D} {page * pages} "
              f"slots, {splits} splits: max |diff| out {errs[0]:.3e}, m "
              f"{errs[1]:.3e} (tolerance {PARTIALS_M_TOL}), l relative "
              f"{errs[2]:.3e} ({PARTIALS_L_TOL}); an empty row gives out 0, "
              f"m -1e30, l 0; a bad page in the last split NaN in its row "
              f"of out, m and l only", flush=True)
    half = page * pages // 2
    lens[:2] = torch.tensor([page * pages - 3, half - 100])  # one ends early
    parts = []
    for lo in (0, half):
        part = table[:, lo // page:(lo + half) // page].contiguous()
        shard = torch.clamp(lens - lo, 0, half).to(torch.int32)
        parts.append(PK.paged_attention_kernel(q, kp, vp, part, shard,
                                               partials=True))
    m_all = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(m_s - m_all) * l_s for _, m_s, l_s in parts]
    num = sum(w_s[..., None] * o.float() for w_s, (o, _, _) in zip(w, parts))
    merged = (num / torch.clamp(w[0] + w[1], min=1e-30)[..., None]).to(q.dtype)
    err = check_paged("K4 partials, two halves merged", merged,
                      PK.paged_attention_kernel(q, kp, vp, table, lens))
    print(f"[paged] partials: the shard's two halves of {half} slots merged "
          f"as _local_decode merges them = K4 on all {2 * half}: max |diff| "
          f"{err:.3e}", flush=True)


def check_paged(label, got, want) -> float:
    """Max |got - want|; exits unless within the bf16 tolerance, its atol
    scaled down to the output's size (the module docstring, phase 5)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    atol = PAGED_TOL * min(1.0, float(want.abs().max()))
    if not torch.allclose(got, want, rtol=PAGED_TOL, atol=atol):
        raise SystemExit(f"{label} differs from its plain version: "
                         f"max |diff| {err}")
    return err


# ---------------------------------------------------------------- phase 6, 8
def serve_args(arch, *extra):
    return serve_launcher.build_parser().parse_args(
        ["--arch", arch, "--full-config", "--device", DEVICE, *extra])


def to_device(tree, dev):
    return {k: to_device(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def profile_steps(cfg, params, dev, tag) -> None:
    """Device busy share of a few decode steps under torch.profiler, K5's
    share of the device time and the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step = serve_launcher.make_serve_step(cfg, serve_launcher.MAX_SEQ)
    B = serve_launcher.DECODE_BATCH
    cache = models.make_cache(cfg, B, serve_launcher.MAX_SEQ, device=dev,
                              enc_len=serve_launcher.ENC_LEN)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    tok, cache = step(params, tok, cache)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            tok, cache = step(params, tok, cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        print(f"[{tag}] device time not measured (the profiler saw no device "
              f"events); {PROFILE_STEPS} steps {wall:.4f}s", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_name: dict = {}
    for e in ev:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    k5 = [v for name, v in by_name.items() if "gmm_" in name]
    k5_ms, k5_n = sum(v[0] for v in k5), sum(v[1] for v in k5)
    k4 = [v for name, v in by_name.items() if "paged_attention" in name]
    k4_ms, k4_n = sum(v[0] for v in k4), sum(v[1] for v in k4)
    launch_calls = sum(a.count for a in prof.key_averages()
                       if a.key == "cudaLaunchKernel")
    print(f"[{tag}] profile of {PROFILE_STEPS} steps: wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.2f}%), K5 {k5_ms:.3f} ms in {k5_n} "
          f"launches ({k5_ms / PROFILE_STEPS:.3f} ms a step), K4 "
          f"{k4_ms:.3f} ms in {k4_n} launches ({k4_ms / PROFILE_STEPS:.4f} ms "
          f"a step), {len(ev)} device events ({len(ev) / PROFILE_STEPS:.1f} a "
          f"step), cudaLaunchKernel {launch_calls} calls "
          f"({launch_calls / PROFILE_STEPS:.1f} a step), {len(by_name)} "
          f"kernel names; the heaviest:", flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[{tag}]   {ms:9.3f} ms in {n:5d} launches  {name[:90]}")
    ops_ = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print(f"[{tag}] host: the operators with the most self time in those "
          f"{PROFILE_STEPS} steps:", flush=True)
    for a in ops_[:8]:
        print(f"[{tag}]   {a.self_cpu_time_total / 1e3:9.3f} ms self in "
              f"{a.count:5d} calls  {a.key[:60]}")


def count_active_experts(cfg, params, dev, steps, tag) -> None:
    """The experts each MoE layer routed a token to, read on the card from
    the tile_rows that ``moe.expert_tiles`` hands K5, over one decode call
    of the serving run: ``steps`` greedy steps from zero tokens into a fresh
    cache, as every call of ``launch/serve.py``'s decode function runs."""
    seen = []
    inner = moe_mod.expert_tiles

    def recording(top_idx, E, C, bt=moe_mod.EXPERT_BT):
        gid, rows = inner(top_idx, E, C, bt)
        seen.append((rows.view(E, -1).sum(dim=1) > 0).sum())
        return gid, rows

    step = serve_launcher.make_serve_step(cfg, serve_launcher.MAX_SEQ)
    B = serve_launcher.DECODE_BATCH
    cache = models.make_cache(cfg, B, serve_launcher.MAX_SEQ, device=dev,
                              enc_len=serve_launcher.ENC_LEN)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    moe_mod.expert_tiles = recording
    try:
        for _ in range(steps):
            tok, cache = step(params, tok, cache)
    finally:
        moe_mod.expert_tiles = inner
    layers = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    if len(seen) != steps * layers:
        raise SystemExit(f"{tag}: {len(seen)} expert tilings for {steps} "
                         f"steps of {layers} MoE layers")
    active = torch.stack(seen).view(steps, layers).cpu()
    print(f"[{tag}] active experts a layer over one decode call ({steps} "
          f"steps x {layers} MoE layers, B={B}, top-{cfg.top_k} of "
          f"{cfg.n_experts}): min {int(active.min())}, max "
          f"{int(active.max())}, mean {float(active.float().mean()):.3f}; "
          f"step 1: {active[0].tolist()}", flush=True)


def compare_with_cpu(cfg, steps, tag) -> None:
    """A 2-layer cut at full width: the same seeded weights
    (``cut_weights``) decode ``steps`` steps on the CPU and the card from
    zero tokens (``decode_cpu_vs_card``)."""
    cut = dataclasses.replace(cfg, n_layers=CPU_LAYERS)
    t0 = time.perf_counter()
    decode_cpu_vs_card(cut, cut_weights(cut), steps, tag)
    print(f"[{tag}] cpu vs card in {time.perf_counter() - t0:.1f}s",
          flush=True)


def decode_cpu_vs_card(cut, params, steps, tag, prime=None,
                       tol=BF16_LOGIT_TOL) -> None:
    """``steps`` decode steps of ``cut`` from zero tokens on the CPU and on
    the card, ``params`` by device; ``prime(params, cache, device)`` fills
    a fresh cache first (the encoder-decoder's cross K/V).  Both runs are
    fed the CPU's greedy tokens, so a close call on one step does not
    change the inputs of the next.  Step 1's logits within ``tol``
    (``BF16_LOGIT_TOL``); greedy tokens equal wherever the CPU's top-2
    margin exceeds it."""
    B, S = serve_launcher.DECODE_BATCH, serve_launcher.MAX_SEQ
    step = models.decode_fn(cut, S)
    caches = {d: models.make_cache(cut, B, S, device=d,
                                   enc_len=serve_launcher.ENC_LEN)
              for d in ("cpu", DEVICE)}
    if prime is not None:
        for d, cache in caches.items():
            prime(params[d], cache, d)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    checked, agree, margins = 0, 0, []
    for i in range(steps):
        lc, caches["cpu"] = step(params["cpu"], tok, caches["cpu"])
        lg, caches[DEVICE] = step(params[DEVICE], tok.to(DEVICE),
                                  caches[DEVICE])
        lc, lg = lc[:, -1].float(), lg[:, -1].float().cpu()
        if i == 0:
            err = float((lc - lg).abs().max())
            print(f"[{tag}] cpu vs card, step 1 logits ({tuple(lc.shape)}, "
                  f"|logit| <= {float(lc.abs().max()):.3f}): max |diff| "
                  f"{err:.5f} (tolerance {tol})", flush=True)
            if not (err <= tol and torch.isfinite(lg).all()):
                raise SystemExit(f"{tag}: cpu and card step-1 logits differ")
        n, ok, margin = sure_tokens_agree(lc, lg, f"{tag} step {i + 1}", tol)
        checked, agree = checked + n, agree + ok
        margins.append(margin)
        tok = lc.argmax(-1).to(torch.int32)[:, None]
    print(f"[{tag}] cpu vs card, {steps} steps at {cut.n_layers} layers "
          f"({cut.dtype}): greedy tokens agree on {agree} of {checked} "
          f"checked rows (rows with a cpu top-2 margin > {tol}; smallest "
          f"margin a step {min(margins):.4f})", flush=True)


def sure_tokens_agree(want, got, label, tol=BF16_LOGIT_TOL) -> tuple:
    """Greedy tokens of two (rows, V) logits equal on every row whose
    ``want`` top-2 margin exceeds ``tol``; exits if not.  Returns (rows
    checked, rows equal, smallest margin)."""
    top2 = torch.topk(want, 2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    sure = margin > tol
    same = want.argmax(-1) == got.argmax(-1)
    if not bool(same[sure].all()):
        raise SystemExit(f"{label}: greedy tokens differ where the reference "
                         f"margin exceeds {tol}")
    return int(sure.sum()), int((same & sure).sum()), float(margin.min())


def expected_launches(cfg, steps: int) -> dict:
    """K4 once an attention layer a step (twice an encoder-decoder layer:
    self and cross), K5 three times an MoE layer a step (gate, up,
    down), from the layer kinds."""
    attn = sum(cfg.uses_attention(i) for i in range(cfg.n_layers))
    if cfg.family == "encdec":
        attn *= 2
    moe = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    return {"paged_attention": attn * steps,
            "grouped_matmul": 3 * moe * steps}


def run_serve_path(arch, tag, cpu_steps) -> dict:
    """Phase 6 (dense) or 8 (MoE) for ``arch`` at its full config
    (``serve_on_card``), then its 2-layer cut against the CPU; returns the
    serving run's kernel launches."""
    cfg = get_config(arch)
    params = seeded_on_card(cfg, arch, tag)
    launches = serve_on_card(cfg, params, arch, tag, "--requests",
                             str(ZOO_REQUESTS))
    del params
    torch.cuda.empty_cache()
    compare_with_cpu(cfg, cpu_steps, tag)
    torch.cuda.empty_cache()
    return launches


def seeded_on_card(cfg, arch, tag) -> dict:
    """``cfg``'s weights drawn on the card from seed 0, as the launcher
    draws them."""
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in iter_leaves(params))
    full = get_config(arch).n_layers
    depth = (f"{cfg.n_layers} of {full} layers" if cfg.n_layers != full
             else f"{full} layers")
    print(f"[{tag}] {arch} ({cfg.family}): {depth}, d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, {n_params / 1e9:.3f} G "
          f"parameters in {cfg.dtype}, made on the card in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    return params


def serve_on_card(cfg, params, arch, tag, *extra) -> dict:
    """The launcher's engine and trace (``launch/serve.py`` with ``extra``
    arguments) decoding ``cfg`` on the card with ``params``: each step's
    CUDA-event time, rows a second, peak memory; K4's and K5's launches
    must equal ``expected_launches`` and the summary the ``--no-decode``
    run's; then a profile of a few steps and, with experts, the active
    experts a layer.  Returns the engine run's launches."""
    dev = torch.device(DEVICE)
    args = serve_args(arch, *extra)
    stats = serve_launcher.DecodeStats()
    decode = serve_launcher.make_decode_fn(cfg, params, dev, stats,
                                           time_steps=True)
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    summary = serve_launcher.make_engine(args, decode).run(
        serve_launcher.make_requests(args.requests, args.tenants, args.rate))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    step_ms = sorted(stats.step_ms())
    med = step_ms[len(step_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    want = expected_launches(cfg, stats.steps)
    B = serve_launcher.DECODE_BATCH
    print(f"[{tag}] engine run ({args.requests} requests): {wall:.3f}s wall, "
          f"{stats.calls} decode calls, {stats.steps} steps, "
          f"{stats.request_tokens} request tokens, {stats.padded_tokens} "
          f"decoded rows (B={B} x steps); step {med:.3f} ms median "
          f"({step_ms[0]:.3f}-{step_ms[-1]:.3f}), {B / med * 1e3:.1f} decoded "
          f"rows/s at the median step, {stats.padded_tokens / wall:.1f} over "
          f"the wall; peak memory {peak / 2**30:.3f} GiB; launches "
          f"{launches} ({want['paged_attention'] // max(stats.steps, 1)} K4 "
          f"and {want['grouped_matmul'] // max(stats.steps, 1)} K5 a step)",
          flush=True)
    got = {k: launches[k] for k in want}
    if stats.steps <= 0 or got != want:
        raise SystemExit(f"{tag}: launches {got} for {stats.steps} steps of "
                         f"{cfg.n_layers} layers; expected {want}")
    # bf16 query-head groups (G > 2) take the tensor-core instance, the rest
    # the ring's pair instance (every config's head_dim is 64-256)
    if got["paged_attention"]:
        k4_path = ("mma" if cfg.dtype == "bfloat16"
                   and cfg.n_heads > 2 * cfg.n_kv_heads else "async")
        if PK.PATH_LAUNCHES[k4_path] != got["paged_attention"]:
            raise SystemExit(f"{tag}: K4 launches by instance "
                             f"{PK.PATH_LAUNCHES}; expected all "
                             f"{got['paged_attention']} on {k4_path}")
        print(f"[{tag}] K4: {got['paged_attention']} launches, all on the "
              f"{k4_path} instance (G = {cfg.n_heads // cfg.n_kv_heads}, "
              f"D = {cfg.head_dim})", flush=True)
    dry, dry_stats = serve_launcher.serve(serve_args(arch, *extra,
                                                     "--no-decode"))
    if dry != summary or dry_stats.calls:
        raise SystemExit(f"{tag}: the engine summary differs from the "
                         f"--no-decode run")
    print(f"[{tag}] engine summary equals the --no-decode run: "
          f"{summary['n_completed']} completed, makespan "
          f"{summary['makespan']!r}, {summary['batches']} batches", flush=True)
    profile_steps(cfg, params, dev, tag)
    if cfg.n_experts:
        count_active_experts(cfg, params, dev, stats.steps // stats.calls, tag)
    return launches


def iter_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from iter_leaves(v)
        else:
            yield v


# ---------------------------------------------------------------- phase 7
def grouped_library(x, w, sizes):
    """One PyTorch call computing K5's function on the same inputs: a
    batched product where the groups are equal, ``torch._grouped_mm``
    (bf16, with offsets) where they are not and the card's torch has it;
    in float32 with unequal groups ``torch.bmm`` over the row tiles, each
    with its group's weights (gathered once, outside the timing: the call
    reads a copy of w for each tile); else None."""
    G, d, f = w.shape
    if len(set(sizes)) == 1:
        xv = x.view(G, sizes[0], d)
        return lambda: torch.bmm(xv, w).view(-1, f), "torch.bmm"
    if x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm"):
        offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32,
                            device=x.device)
        wt = w.transpose(-2, -1).contiguous().transpose(-2, -1)
        return (lambda: torch._grouped_mm(x, wt, offs=offs),
                "torch._grouped_mm")
    if x.dtype == torch.float32:
        T = x.shape[0]
        gid = gmm_ops.tile_groups(torch.tensor(sizes, device=x.device), T,
                                  GMM_BT, G)
        tiles, wg = x.view(T // GMM_BT, GMM_BT, d), w[gid.long()]
        return (lambda: torch.bmm(tiles, wg).view(T, f),
                "torch.bmm over row tiles (weights gathered once)")
    return None, "none"


def grouped_dw_library(x, dy, sizes):
    """One PyTorch call computing K5's weight gradient on the same inputs:
    ``torch.bmm`` of the (G, C, d) view transposed with the (G, C, f) one
    where the groups are equal, ``torch._grouped_mm`` of x^T and dy with
    offsets along the rows (bf16, where the card's torch has it and the
    rows are a whole number of 16 bytes, which it requires) where they are
    not; else None."""
    G, d, f = len(sizes), x.shape[1], dy.shape[1]
    if len(set(sizes)) == 1:
        xv, dyv = x.view(G, sizes[0], d), dy.view(G, sizes[0], f)
        return lambda: torch.bmm(xv.transpose(1, 2), dyv), "torch.bmm"
    if (x.dtype == torch.bfloat16 and hasattr(torch, "_grouped_mm")
            and d % 8 == 0 and f % 8 == 0):
        offs = torch.tensor(np.cumsum(sizes), dtype=torch.int32,
                            device=x.device)
        return (lambda: torch._grouped_mm(x.t(), dy, offs=offs),
                "torch._grouped_mm")
    return None, ("none: torch._grouped_mm refuses rows that are not a "
                  "whole number of 16 bytes, and the groups are unequal")


def measure_grouped(key, shape, dev) -> dict:
    """Phase 7, one dense shape: every row real.  The bound counts x, w and
    tile_gid read once and y written once, and 2 T d f operations."""
    T, d, f, sizes, dtype, scale = shape
    G = len(sizes)
    gen = torch.Generator(device=dev).manual_seed(70 + len(key) + d)
    x = torch.randn(T, d, device=dev, generator=gen).to(dtype)
    w = (torch.randn(G, d, f, device=dev, generator=gen) * scale).to(dtype)
    gid = gmm_ops.tile_groups(torch.tensor(sizes, device=dev), T, GMM_BT, G)
    nbytes = (T * d + G * d * f + T * f) * x.element_size() + gid.numel() * 4
    label = (f"({key}) T={T} d={d} f={f} groups={G} "
             f"{str(dtype).replace('torch.', '')}")
    return time_grouped(x, gid, w, None, grouped_library(x, w, sizes),
                        nbytes, 2.0 * T * d * f, label)


def measure_grouped_decode(key, c, d, f, dtype, dev) -> dict:
    """Phase 7 (e), (e'), (j), (j'), (x), (x'), (e f32): the MoE decode's
    call.
    tile_rows from a seeded top-k routing ``c`` (the same seed at every
    shape) through ``moe.expert_tiles``; x random in the real rows and zero
    past them, so ``torch.bmm`` on the dense view computes the same
    function.  The bound counts the active experts' weights, x's real rows,
    tile_gid and tile_rows read once, y (all T rows) written once, and 2 d
    f operations a real row."""
    E, C = c["E"], c["C"]
    gen = torch.Generator(device=dev).manual_seed(75)
    top = torch.rand(c["B"], E, device=dev, generator=gen).argsort(
        dim=1)[:, :c["k"]]
    gid, rows = moe_mod.expert_tiles(top, E, C, GMM_BT)
    return measure_grouped_routed(key, gid, rows, E, d, f, dtype, gen,
                                  f"decode: {c['B']} tokens top-{c['k']}")


def measure_grouped_routed(key, gid, rows, E, d, f, dtype, gen,
                           what) -> dict:
    """K5 (``time_grouped``) at a routed call of E experts: the tiling
    (gid, rows) of ``moe.expert_tiles``; x drawn from ``gen`` in the real
    rows and zero past them, w at the init scale; the bound as
    ``measure_grouped_decode`` says."""
    T = gid.numel() * GMM_BT
    C = T // E
    dev = gid.device
    real = (torch.arange(GMM_BT, device=dev) < rows[:, None]).reshape(T)
    n_real = int(real.sum())
    x = torch.zeros(T, d, device=dev, dtype=dtype)
    x[real] = torch.randn(n_real, d, device=dev, generator=gen).to(x.dtype)
    w = (torch.randn(E, d, f, device=dev, generator=gen)
         * d ** -0.5).to(dtype)
    active = int((rows.view(E, -1).sum(dim=1) > 0).sum())
    used_tiles = int((rows > 0).sum())
    nbytes = ((active * d * f + n_real * d + T * f) * x.element_size()
              + (gid.numel() + rows.numel()) * 4)
    label = (f"({key}) T={T} d={d} f={f} groups={E} "
             f"{str(dtype).replace('torch.', '')}, {what}, {active} active "
             f"experts, {n_real} real rows in {used_tiles} row tiles")
    rec = time_grouped(x, gid, w, rows, grouped_library(x, w, [C] * E),
                       nbytes, 2.0 * n_real * d * f, label)
    rec.update(active_experts=active, real_rows=n_real)
    return rec


def time_grouped(x, gid, w, rows, library, nbytes, flops, label) -> dict:
    """K5 against its plain version on the same card inputs, then the
    CUDA-event medians of the kernel, the plain version and the library
    call, beside the bound for ``nbytes`` and ``flops``.  In float32 the
    element-load kernel too, on a misaligned copy of x: its output must
    equal the TMA kernel's bit for bit, and its time is printed beside."""
    got = GK.grouped_matmul_kernel(x, gid, w, GMM_BT, rows)
    want = grouped_matmul_tiles_ref(x, gid, w, GMM_BT, rows)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    tol = GMM_TOL[x.dtype]
    if not (torch.isfinite(got).all()
            and torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)):
        raise SystemExit(f"K5 {label} differs from its plain version: "
                         f"max |diff| {err}")
    path = GK.kernel_path(x, w)
    elem_fn = None
    if x.dtype == torch.float32:
        xe = misaligned(x)
        if path != "f32" or GK.kernel_path(xe, w) != "f32_elem":
            raise SystemExit(f"K5 {label}: paths {path}, "
                             f"{GK.kernel_path(xe, w)}; expected f32, "
                             f"f32_elem")

        def elem_fn():
            return GK.grouped_matmul_kernel(xe, gid, w, GMM_BT, rows)

        if not same_bits(got, elem_fn()):
            raise SystemExit(f"K5 {label}: gmm_f32_tma differs from gmm_f32 "
                             f"(the element-load kernel) in its bits")
    lib_fn, lib_name = library
    lib_ms, lib_err = None, None
    if lib_fn is not None:
        lib_err = float((lib_fn().float() - want.float()).abs().max())
        lib_ms = cuda_ms(lib_fn, REPS)
    k_ms = cuda_ms(lambda: GK.grouped_matmul_kernel(x, gid, w, GMM_BT, rows),
                   REPS)
    k_dev = many_ms(lambda: GK.grouped_matmul_kernel(x, gid, w, GMM_BT, rows))
    e_ms = cuda_ms(elem_fn, REPS) if elem_fn is not None else None
    e_dev = many_ms(elem_fn) if elem_fn is not None else None
    p_ms = cuda_ms(lambda: grouped_matmul_tiles_ref(x, gid, w, GMM_BT, rows),
                   REPS)
    peak = PEAK_BF16_FLOPS if x.dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    bound, bound_by = bound_ms(nbytes, flops, peak)
    lib_txt = (f"{lib_name} {lib_ms:.4f} ms (max |diff| {lib_err:.3e})"
               if lib_ms is not None else "library none")
    elem_txt = (f"; f32_elem ({GK.KERNELS['f32_elem']}, bit-equal) "
                f"{e_ms:.4f} ms (device {e_dev:.4f})" if e_ms is not None
                else "")
    print(f"[grouped] {label}: K5 path {path} ({GK.KERNELS[path]}), max "
          f"|diff| {err:.3e} (tolerance {tol}); kernel {k_ms:.4f} ms "
          f"(device {k_dev:.4f}) "
          f"({flops / k_ms / 1e9:.1f} TFLOP/s, "
          f"{nbytes / k_ms / 1e9:.3f} TB/s of the bound's bytes, "
          f"{bound / k_ms:.2f} of the bound){elem_txt}, plain "
          f"{p_ms:.4f} ms, {lib_txt}, bound {bound:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
    return dict(
        name="grouped_matmul", route="cuda", source=GMM_SOURCE,
        replaces=GMM_REPLACES, launches=0, max_abs_err=err, ms=k_ms,
        plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
        library=lib_name, shape=label, path=path, kernel=GK.KERNELS[path],
        device_ms=k_dev,
        **({} if e_ms is None else {"elem_ms": e_ms, "elem_device_ms": e_dev,
                                     "elem_kernel": GK.KERNELS["f32_elem"]}),
    )


def measure_grouped_dw(key, shape, dev) -> dict:
    """Phase 7 (b bf16 elem)'s dW: K5's weight gradient at a dense shape of
    phase 7, x (T, d) and dy (T, f) random, every row real, against its
    plain version within ``TRAIN_DW_TOL`` of the largest value.  The bound
    counts x, dy and the ids read once, dw written once, 2 T d f
    operations."""
    T, d, f, sizes, dtype, _ = shape
    G = len(sizes)
    gen = torch.Generator(device=dev).manual_seed(78)
    x = torch.randn(T, d, device=dev, generator=gen).to(dtype)
    dy = torch.randn(T, f, device=dev, generator=gen).to(dtype)
    gid = gmm_ops.tile_groups(torch.tensor(sizes, device=dev), T, GMM_BT, G)

    def kern():
        return GK.grouped_matmul_dw_kernel(x, dy, gid, G, GMM_BT)

    def plain():
        return grouped_matmul_dw_ref(x, dy, gid, G, GMM_BT)

    got, want = kern(), plain()
    torch.cuda.synchronize()
    tol = TRAIN_DW_TOL[dtype]
    ok, err, scale = backward_close(got, want, tol)
    if not ok:
        raise SystemExit(f"K5 dW ({key}) differs from its plain version: "
                         f"max |diff| {err} of {scale}")
    path = GK.dw_kernel_path(x, dy)
    lib_fn, lib_name = grouped_dw_library(x, dy, sizes)
    lib_ms = cuda_ms(lib_fn, REPS) if lib_fn is not None else None
    k_ms, p_ms = cuda_ms(kern, REPS), cuda_ms(plain, REPS)
    nbytes = (T * (d + f) + G * d * f) * x.element_size() + gid.numel() * 4
    flops = 2.0 * T * d * f
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    bound, bound_by = bound_ms(nbytes, flops, peak)
    label = (f"({key}) dW T={T} d={d} f={f} groups={G} "
             f"{str(dtype).replace('torch.', '')}")
    lib_txt = (f"{lib_name} {lib_ms:.4f} ms" if lib_ms is not None
               else f"library none ({lib_name})")
    print(f"[grouped] {label}: dW path {path} ({GK.DW_KERNELS[path]}), max "
          f"|diff| {err:.3e} of {scale:.3e} (tolerance {tol} of the "
          f"largest); kernel {k_ms:.4f} ms ({flops / k_ms / 1e9:.1f} "
          f"TFLOP/s, {bound / k_ms:.2f} of the bound), plain {p_ms:.4f} ms, "
          f"{lib_txt}, bound {bound:.4f} ms ({bound_by}, "
          f"{nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} GFLOP)", flush=True)
    return dict(
        name="grouped_matmul_dw", route="cuda", source=GMM_SOURCE,
        replaces=GMM_REPLACES, launches=0, max_abs_err=err, ms=k_ms,
        plain_ms=p_ms, bound_ms=bound, bound_by=bound_by, library_ms=lib_ms,
        library=lib_name, shape=label, kernel_path=path,
        kernel=GK.DW_KERNELS[path],
    )


# ---------------------------------------------------------------- phase 9
def run_daemon_phase(cat, records, obs_off, smi) -> dict:
    """Phase 9; returns the kernel launches of its card runs, each counted
    from 0 just before the run and read just after it."""
    launches = {k: 0 for k in all_launches()}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the kill -9 drill
    try:
        out = drill.run_drill("crossmatch", DEVICE, cell=(cat, records),
                              log=lambda m: print(f"[daemon] (a) {m}",
                                                  flush=True))
    except drill.DrillFailed as exc:
        raise SystemExit(f"[daemon] (a) kill -9 drill: {exc}")
    for run in ("uninterrupted", "recovered"):
        add(out["launches"][run])
    if out["launches"]["uninterrupted"]["crossmatch_shared"] <= 0:
        raise SystemExit("[daemon] (a) the daemon never launched K3")
    print(f"[daemon] (a) {out['items']} queries, {out['rounds']} rounds; "
          f"child killed at {out['killed_at_rounds']} round records; "
          f"recovery replayed {out['replayed_rounds']} rounds (each join "
          f"re-run on the card) in {out['recovery_s']:.3f}s ({smi}); daemon "
          f"intake {out['intake_s']:.3f}s (fsync'd acks, JSON payloads; "
          f"the submit records' appends {out['submit_journal_s']['append']:.3f}"
          f"s, their fsyncs {out['submit_journal_s']['fsync']:.3f}s) against "
          f"phase 3's engine intake {obs_off['C']['intake']:.3f}s (run C); "
          f"uninterrupted wall {out['wall_s']:.3f}s; launches "
          f"{out['launches']}, device dispatches {out['dispatches']}",
          flush=True)

    # (b) the card daemon's journal against the cpu daemon's
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-daemon-"))
    walls = {}
    for dev in (DEVICE, "cpu"):
        reset_all_launches()
        t0 = time.perf_counter()
        d = drill.crossmatch_daemon(cat, work / dev, dev)
        drill.drive(d, queries_for(records, "C", CPU_QUERIES))
        d.close()
        walls[dev] = time.perf_counter() - t0
        if dev == DEVICE:
            got, dd = all_launches(), d.host.engine.summary()[
                "device_dispatches"]
            add(got)
            if sum(got.values()) != dd:
                raise SystemExit(f"[daemon] (b) {sum(got.values())} launches "
                                 f"for {dd} device dispatches")
    if not drill.segments_equal(work / DEVICE, work / "cpu"):
        raise SystemExit(f"[daemon] (b) the card daemon's journal differs "
                         f"from the cpu daemon's; left at {work}")
    print(f"[daemon] (b) first {CPU_QUERIES} queries: the card daemon's "
          f"{len(drill.journal_records(work / DEVICE))} journal records equal "
          f"the cpu daemon's, segment files byte for byte; wall card "
          f"{walls[DEVICE]:.3f}s, cpu {walls['cpu']:.3f}s", flush=True)
    shutil.rmtree(work)

    add(run_serving_daemon(smi))

    # (d) obs on the main path: a round's results are copied to the host
    # (``.cpu()`` synchronises), so its wall span holds its device time.
    for kind in ("A", "C"):
        obs = Observability()
        reset_all_launches()
        _, log, res, _, (t_in, t_out) = drive(cat, records, kind, DEVICE,
                                              len(records), obs=obs)
        add(all_launches())
        off = obs_off[kind]
        if log != off["log"]:
            raise SystemExit(f"[daemon] (d) run {kind}: the obs-on decision "
                             f"log differs from the obs-off run's")
        if not drill.results_equal(res, off["results"]):
            raise SystemExit(f"[daemon] (d) run {kind}: obs-on results "
                             f"differ from the obs-off run's")
        series = obs.snapshot()["metrics"]["liferaft_rounds_total"]["series"]
        counted = sum(x["value"] for x in series)
        spans = [e for e in obs.perfetto()["traceEvents"]
                 if e["ph"] == "X" and e["name"] == "round"]
        if not counted == len(spans) == len(log):
            raise SystemExit(f"[daemon] (d) run {kind}: {counted} rounds "
                             f"counted, {len(spans)} spans, {len(log)} rounds")
        print(f"[daemon] (d) run {kind} with obs on: {len(log)} rounds and "
              f"the results identical to the obs-off run's; rounds counter "
              f"{counted:.0f}, {len(spans)} round spans; drain {t_out:.3f}s "
              f"against {off['drain']:.3f}s obs off (ratio "
              f"{t_out / off['drain']:.3f}, not gated: the host varies), "
              f"intake {t_in:.3f}s against {off['intake']:.3f}s", flush=True)
    return launches


def run_serving_daemon(smi) -> dict:
    """Phase 9 (c); returns the launches of its two decoding daemons."""
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=CPU_LAYERS)
    dev = torch.device(DEVICE)
    params = models.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0))
    args = serve_args(MOE_ARCH)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-serving-"))
    launches = {k: 0 for k in all_launches()}

    def run(name, decode):
        stats = serve_launcher.DecodeStats()
        fn = (serve_launcher.make_decode_fn(cfg, params, dev, stats)
              if decode else None)
        reset_all_launches()
        t0 = time.perf_counter()
        d = ServiceDaemon(ServingHost(serve_launcher.make_engine(args, fn)),
                          work / name)
        t_recover, replayed = time.perf_counter() - t0, stats.steps
        drill.drive(d, serve_launcher.make_requests(args.requests,
                                                    args.tenants, args.rate))
        d.close()
        torch.cuda.synchronize()
        got = all_launches()
        want = {"paged_attention": cfg.n_layers * stats.steps,
                "grouped_matmul": 3 * cfg.n_layers * stats.steps}
        if {k: got[k] for k in want} != want or (decode and not stats.steps):
            raise SystemExit(f"[daemon] (c) {name}: launches {got} for "
                             f"{stats.steps} steps; expected {want}")
        for k, v in got.items():
            launches[k] += v
        return d, stats, time.perf_counter() - t0, (t_recover, replayed)

    full, stats, wall, _ = run("decode", True)
    run("dry", False)
    if not drill.segments_equal(work / "decode", work / "dry"):
        raise SystemExit(f"[daemon] (c) the decoding daemon's journal differs "
                         f"from the --no-decode daemon's; left at {work}")
    half = len(full.entries) // 2
    n_cut = drill.cut_journal(work / "decode", work / "cut", half)
    rec, rstats, rwall, (t_recover, replayed) = run("cut", True)
    if (drill.journal_records(work / "cut")
            != drill.journal_records(work / "decode")
            or rstats.steps != stats.steps):
        raise SystemExit(f"[daemon] (c) recovery from the cut journal "
                         f"differs from the uninterrupted run; left at {work}")
    print(f"[daemon] (c) {MOE_ARCH} at {cfg.n_layers} layers, full width, "
          f"{args.requests} requests: {len(full.entries)} rounds, "
          f"{stats.calls} decode calls, {stats.steps} steps, wall "
          f"{wall:.3f}s; journal equal to the --no-decode daemon's; cut "
          f"after {half} rounds ({n_cut} records), recovered in "
          f"{t_recover:.3f}s ({smi}; the replay re-decoded {replayed} "
          f"steps), finished in {rwall:.3f}s wall with the same journal; "
          f"launches {launches}",
          flush=True)
    shutil.rmtree(work)
    del params
    torch.cuda.empty_cache()
    return launches



# ---------------------------------------------------------------- phase 10
DRIVER_DIR = pathlib.Path(ROOT) / "build" / "drivers"


def on_card(label, fn):
    """Run one driver on the card with every launch count at 0; returns
    (its result, its launches), printing its wall and the CUDA-event span
    around it."""
    reset_all_launches()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = all_launches()
    print(f"[drivers] {label}: wall {wall:.3f}s, CUDA-event span "
          f"{start.elapsed_time(end) / 1e3:.3f}s, launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    return out, launches


def need(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"[drivers] {what}")


def same(label, card, cpu) -> None:
    need(card == cpu, f"{label}: the card's {card} differ from the cpu "
                      f"run's {cpu}")


def without(d: dict, *keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def run_drivers_phase(smi) -> dict:
    """Phase 10: the reference's drivers on the card through the port's
    engines and kernels, each held against a ``device="cpu"`` run of
    itself in this process (kernel_bench, which decides nothing, against
    its plain versions); returns the launches of all its card runs."""
    DRIVER_DIR.mkdir(parents=True, exist_ok=True)
    dev = torch.device(DEVICE)
    total: dict = {}

    def count(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # (a) the SkyQuery example: K1 a round
    rep, n = on_card("crossmatch_skyquery", lambda: crossmatch_skyquery.run(
        device=DEVICE,
        out_path=DRIVER_DIR / "BENCH_torch_crossmatch_skyquery.json"))
    count(n)
    need(n["crossmatch"] > 0
         and sum(n.values()) == rep["summary"]["device_dispatches"],
         f"crossmatch_skyquery: launches {n}, device dispatches "
         f"{rep['summary']['device_dispatches']}")
    cpu = crossmatch_skyquery.run(device="cpu", out_path=None, verbose=False)
    same("crossmatch_skyquery summary", rep["summary"], cpu["summary"])
    print(f"[drivers] crossmatch_skyquery: {rep['matched_objects']} matched "
          f"on the card, {cpu['matched_objects']} on the cpu; summary equal",
          flush=True)

    # (b) Fig. 2's measured view: each w's scan against its plain version
    joins: list = []
    rep, n = on_card("fig2_hybrid_join", lambda: fig2_hybrid_join.run(
        device=DEVICE, out_path=DRIVER_DIR / "BENCH_torch_fig2_hybrid_join.json",
        joins_out=joins))
    count(n)
    need(n["crossmatch"] == rep["joins"] == sum(n.values()),
         f"fig2: launches {n}, joins {rep['joins']}")
    for j in joins:
        case = k1_case(j["bucket"], j["probes"], fig2_hybrid_join.THR, None,
                       f"fig2 scan w={j['w']}", dev)
        check_join(case["label"], case, j["scan"], case["plain"]())
    cpu = fig2_hybrid_join.run(device="cpu", out_path=None, verbose=False)
    same("fig2 cost-model view", rep["model"], cpu["model"])
    be = rep["measured_break_even"]
    print(f"[drivers] fig2 ({smi}): measured break-even {be['wall_probes']} "
          f"probes on the wall ({be['wall_frac']} of the bucket), "
          f"{be['device_part_probes']} on the device part alone; cost "
          f"model {rep['model']['break_even_queue']:.0f} "
          f"({rep['model']['break_even_frac']:.4f})", flush=True)

    # (c) bench_scheduler: compile_count and fused_dispatch
    cc, n = on_card("bench_scheduler compile_count",
                    lambda: bench_scheduler.bench_compiles(device=DEVICE))
    count(n)
    need(cc["within_bound"], f"compile_count out of bound: {cc}")
    need(n["crossmatch"] == cc["batches"] == sum(n.values()),
         f"compile_count: launches {n}, batches {cc['batches']}")
    fd, n = on_card("bench_scheduler fused_dispatch",
                    lambda: bench_scheduler.bench_fused(device=DEVICE))
    count(n)
    need(sum(n.values()) == sum(v["dispatches"] for v in fd.values()),
         f"fused_dispatch: launches {n}, {fd}")
    cpu_cc = bench_scheduler.bench_compiles(device="cpu")
    same("compile_count", without(cc, "library_loads", "launch_shapes"),
         cpu_cc)
    same("fused_dispatch", {k: without(v, "wall_s") for k, v in fd.items()},
         {k: without(v, "wall_s") for k, v in
          bench_scheduler.bench_fused(device="cpu").items()})
    bench_common.write_report(DRIVER_DIR / "BENCH_torch_scheduler.json", {
        "compile_count": cc, "fused_dispatch": fd, "device": smi})
    print(f"[drivers] compile_count: {cc['shapes_compiled']} padded shapes "
          f"(bound {cc['bound_log2_max_probes_plus_1']}), "
          f"{cc.get('library_loads')} library loads, {cc.get('launch_shapes')} launch "
          f"shapes; fused_dispatch {fd}", flush=True)

    # (d) bench_sharedplan: dispatch reduction (K1 per predicate vs K3) and
    # compile bounding
    dr, n = on_card("bench_sharedplan device_dispatch_reduction",
                    lambda: bench_sharedplan.bench_dispatch_reduction(
                        device=DEVICE))
    count(n)
    need(dr["passed"], f"device_dispatch_reduction failed its gate: {dr}")
    need(n["crossmatch_shared"] > 0 and sum(n.values())
         == dr["per_predicate_dispatches"] + dr["shared_dispatches"],
         f"device_dispatch_reduction: launches {n}, {dr}")
    cb, n = on_card("bench_sharedplan compile_bounding",
                    lambda: bench_sharedplan.bench_compile_bounding(
                        device=DEVICE))
    count(n)
    need(cb["bounded"] and n["crossmatch_shared"] == cb["distinct_predicates"],
         f"compile_bounding: {cb}, launches {n}")
    same("device_dispatch_reduction", dr,
         bench_sharedplan.bench_dispatch_reduction(device="cpu"))
    same("compile_bounding", cb,
         bench_sharedplan.bench_compile_bounding(device="cpu"))
    bench_common.write_report(DRIVER_DIR / "BENCH_torch_sharedplan.json", {
        "device_dispatch_reduction": dr, "compile_bounding": cb,
        "device": smi})
    print(f"[drivers] sharedplan: {dr['per_predicate_dispatches']} -> "
          f"{dr['shared_dispatches']} dispatches ({dr['reduction']:.2f}x), "
          f"bit-equal {dr['results_bit_equal']}", flush=True)

    # (e) kernel_bench
    rep, n = on_card("kernel_bench", lambda: kernel_bench.run(
        device=DEVICE, out_path=DRIVER_DIR / "BENCH_torch_kernel_bench.json"))
    count(n)
    need(not kernel_bench.check(rep), "kernel_bench: a kernel differs from "
         f"its plain version: {kernel_bench.check(rep)}")
    need(all(n[k] > 0 for k in ("crossmatch", "grouped_matmul",
                                 "paged_attention")),
         f"kernel_bench: launches {n}")

    # (f) serve_multitenant, default flags and --adaptive
    for flags in ([], ["--adaptive"]):
        tag = " ".join(["serve_multitenant", *flags])
        name = "_".join(["serve_multitenant", *(f[2:] for f in flags)])
        args = serve_multitenant.build_parser().parse_args(
            [*flags, "--device", DEVICE,
             "--out", str(DRIVER_DIR / f"BENCH_torch_{name}.json")])
        rep, n = on_card(tag, lambda: serve_multitenant.run(args))
        count(n)
        steps = rep["layers"] * rep["decode_steps"]
        need(n["paged_attention"] == steps and n["grouped_matmul"] == 3 * steps,
             f"{tag}: launches {n} for {rep['layers']} layers x "
             f"{rep['decode_steps']} steps")
        cpu = serve_multitenant.run(
            serve_multitenant.build_parser().parse_args(
                [*flags, "--device", "cpu", "--out", ""]), verbose=False)
        keys = ("summary", "controller", "decoded_tokens", "decode_calls",
                "decode_steps")
        same(tag, {k: rep[k] for k in keys}, {k: cpu[k] for k in keys})
    return total


# ---------------------------------------------------------------- phase 11
def zoo_config(arch):
    """The arch's full config, jamba cut in depth (``ZOO_LAYERS``)."""
    cfg = get_config(arch)
    if arch in ZOO_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=ZOO_LAYERS[arch])
    return cfg


def zoo_cut(cfg):
    """A 2-layer cut at full width (``ZOO_CUT_LAYERS`` where it says
    otherwise).  The hybrid's is one period of two: an attention layer
    with its MLP, then a Mamba mixer with its MoE (the layer kinds jamba
    pairs); the encoder-decoder cuts both stacks."""
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=CPU_LAYERS,
                                   attn_period=CPU_LAYERS, attn_offset=0)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=CPU_LAYERS,
                                   n_enc_layers=CPU_LAYERS)
    return dataclasses.replace(
        cfg, n_layers=ZOO_CUT_LAYERS.get(cfg.name, CPU_LAYERS))


def prefill_batch(cfg, B, S, dev, seed, n_prefix=None) -> tuple:
    """(batch, positions a prompt) in the reference's batch keys, seeded:
    B prompts of S tokens; the VLM adds ``n_prefix`` (by default
    ``cfg.n_prefix``) patch embeddings before them, the encoder-decoder
    takes S frames and S decoder tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev, dtype=torch.int32)

    def embeds(n):
        return torch.randn(B, n, cfg.d_model, generator=gen, device=dev)

    if cfg.family == "encdec":
        return {"frames": embeds(S), "dec_tokens": toks}, 2 * S
    if cfg.family == "vlm":
        n_prefix = cfg.n_prefix if n_prefix is None else n_prefix
        return {"patches": embeds(n_prefix), "tokens": toks}, n_prefix + S
    return {"tokens": toks}, S


def measure_prefill(cfg, params, tag) -> dict:
    """``make_prefill_step`` at PREFILL_B prompts of PREFILL_S tokens on the
    card: the forward's logits finite and of the expected shape, then the
    CUDA-event median of PREFILL_REPS steps after a warm one, the prompt
    positions a second, peak memory; returns the launches of all of it."""
    dev = torch.device(DEVICE)
    batch, per = prefill_batch(cfg, PREFILL_B, PREFILL_S, dev, seed=90)
    reset_all_launches()
    torch.cuda.reset_peak_memory_stats()
    logits = models.forward_fn(cfg)(params, batch)
    shape = tuple(logits.shape)
    rows = PREFILL_S if cfg.family == "encdec" else per  # decoder positions
    if shape[:2] != (PREFILL_B, rows) or not bool(
            torch.isfinite(logits).all()):
        raise SystemExit(f"[{tag}] prefill logits {shape} not finite or not "
                         f"of the prompt's shape")
    del logits
    step = make_prefill_step(cfg)
    tok = step(params, batch)
    times = []
    for _ in range(PREFILL_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tok = step(params, batch)
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    med = ms[len(ms) // 2]
    if tok.shape != (PREFILL_B,) or tok.dtype != torch.int32 or not bool(
            ((tok >= 0) & (tok < shape[-1])).all()):
        raise SystemExit(f"[{tag}] prefill tokens {tok}")
    launches = all_launches()
    print(f"[{tag}] prefill: B={PREFILL_B} x {per} positions ({shape[1]} "
          f"logit rows of {shape[-1]}): {med:.3f} ms median of "
          f"{PREFILL_REPS} ({ms[0]:.3f}-{ms[-1]:.3f}), "
          f"{PREFILL_B * per / med * 1e3:.1f} prompt positions/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; "
          f"launches {launches} in {PREFILL_REPS + 2} passes", flush=True)
    return launches


def zoo_cpu_check(cfg, tag) -> None:
    """Phase 11's card against the CPU, at ``zoo_cut(cfg)`` in float32
    with the same seeded weights on both (``cut_weights``): the prefill's
    logits (all positions; ZOO_CPU_B prompts of ZOO_CPU_S tokens, and as
    many patches or frames) within ``ZOO_F32_TOL`` and its greedy tokens
    equal where the CPU's margin exceeds it; ``CPU_STEPS`` decode steps
    (``MOE_CPU_STEPS`` with experts) under phase 6's rules at that
    tolerance, the encoder-decoder's after ``prefill_cross_kv`` has filled
    both caches' cross K/V; and, for the token-only families, on the card,
    the decode over the prompt against the forward's last position under
    the same rules."""
    cut = dataclasses.replace(zoo_cut(cfg), dtype="float32")
    tol = ZOO_F32_TOL
    t0 = time.perf_counter()
    n = cut.param_count()
    print(f"[{tag}] the {cut.n_layers}-layer float32 cut: {n / 1e9:.3f} G "
          f"parameters, {4 * n / 1e9:.1f} GB on the card and as much copied "
          f"to the host, whose free memory is {host_free_gb():.1f} GB",
          flush=True)
    params = cut_weights(cut)
    batch, _ = prefill_batch(cut, ZOO_CPU_B, ZOO_CPU_S, torch.device("cpu"),
                             seed=91, n_prefix=ZOO_CPU_S)
    fwd = models.forward_fn(cut)
    lc = fwd(params["cpu"], batch).float()
    lg = fwd(params[DEVICE], to_device(batch, DEVICE)).float().cpu()
    err = float((lc - lg).abs().max())
    print(f"[{tag}] cpu vs card at {cut.n_layers} layers ({cut.dtype}), "
          f"prefill logits {tuple(lc.shape)} (|logit| <= "
          f"{float(lc.abs().max()):.3f}): max |diff| {err:.5f} (tolerance "
          f"{tol})", flush=True)
    if not (err <= tol and torch.isfinite(lg).all()):
        raise SystemExit(f"{tag}: cpu and card prefill logits differ")
    n, ok, margin = sure_tokens_agree(lc[:, -1], lg[:, -1], f"{tag} prefill",
                                      tol)
    tc = make_prefill_step(cut)(params["cpu"], batch)
    if not torch.equal(tc, lc[:, -1].argmax(-1).to(torch.int32)):
        raise SystemExit(f"{tag}: make_prefill_step is not the forward's "
                         f"argmax")
    print(f"[{tag}] prefill tokens agree on {ok} of {n} checked rows "
          f"(smallest margin {margin:.4f})", flush=True)

    prime = None
    if cut.family == "encdec":
        frames = torch.randn(serve_launcher.DECODE_BATCH,
                             serve_launcher.ENC_LEN, cut.d_model,
                             generator=torch.Generator().manual_seed(92))

        def prime(p, cache, d):
            _, ck, cv = encdec_mod.prefill_cross_kv(cut, p, frames.to(d))
            cache["cross_k"].copy_(ck)
            cache["cross_v"].copy_(cv)

    steps = ZOO_CPU_STEPS.get(cut.name,
                              MOE_CPU_STEPS if cut.n_experts else CPU_STEPS)
    decode_cpu_vs_card(cut, params, steps, tag, prime, tol)

    if cut.family not in ("encdec", "vlm"):
        toks = batch["tokens"].to(DEVICE)
        cache = models.make_cache(cut, ZOO_CPU_B, ZOO_CPU_S, device=DEVICE)
        step = models.decode_fn(cut, ZOO_CPU_S)
        for t in range(ZOO_CPU_S):
            ld, cache = step(params[DEVICE], toks[:, t:t + 1], cache)
        ld = ld[:, 0].float().cpu()
        tail = float((ld - lg[:, -1]).abs().max())
        print(f"[{tag}] card decode over the {ZOO_CPU_S}-token prompt vs the "
              f"card forward's last position: max |diff| {tail:.5f}",
              flush=True)
        if tail > tol:
            raise SystemExit(f"{tag}: the decode tail differs from the "
                             f"forward's last position")
        sure_tokens_agree(lg[:, -1], ld, f"{tag} decode tail", tol)
    if cut.sliding_window is not None:
        ring_cpu_vs_card(cut, params, tag)
    print(f"[{tag}] cpu vs card in {time.perf_counter() - t0:.1f}s",
          flush=True)


def host_free_gb() -> float:
    """The host's free physical memory, GB."""
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE") / 1e9


def ring_cpu_vs_card(cut, params, tag) -> None:
    """Phase 11, mixtral: ``cut`` (f32, ``params`` by device) decoding
    across its sliding window's wrap.  A cache of 2 x window slots is a
    ring of ``window`` slots; both devices start from the same seeded K/V
    (drawn on the card, copied) at position window - ``RING_LEAD`` and take
    ``RING_STEPS`` steps from zero tokens, each fed the CPU's greedy
    tokens.  Every step's logits within ``ZOO_F32_TOL`` and its greedy
    tokens equal where the CPU's margin exceeds it; the slots the steps
    wrote (the ring's last ``RING_LEAD`` and its first) equal within the
    same tolerance, and slot 0 rewritten."""
    W = cut.sliding_window
    max_seq = 2 * W
    layout = attn_mod.cache_layout(cut, max_seq)
    if not (layout.ring and layout.seq == W):
        raise SystemExit(f"{tag}: a {max_seq}-slot cache is not a ring of "
                         f"{W}: {layout}")
    B, tol = ZOO_CPU_B, ZOO_F32_TOL
    gen = torch.Generator(device=DEVICE).manual_seed(93)
    card = models.make_cache(cut, B, max_seq, device=DEVICE)
    for name in ("k", "v"):
        card[name].normal_(generator=gen)
    card["pos"] = W - RING_LEAD
    caches = {DEVICE: card,
              "cpu": dict(card, k=card["k"].to("cpu", copy=True),
                          v=card["v"].to("cpu", copy=True))}
    seeded = caches["cpu"]["k"][:, :, 0].clone()
    step = models.decode_fn(cut, max_seq)
    tok = torch.zeros((B, 1), dtype=torch.int32)
    worst, checked, agree = 0.0, 0, 0
    for i in range(RING_STEPS):
        lc, caches["cpu"] = step(params["cpu"], tok, caches["cpu"])
        lg, caches[DEVICE] = step(params[DEVICE], tok.to(DEVICE),
                                  caches[DEVICE])
        lc, lg = lc[:, -1].float(), lg[:, -1].float().cpu()
        err = float((lc - lg).abs().max())
        worst = max(worst, err)
        if not (err <= tol and torch.isfinite(lg).all()):
            raise SystemExit(f"{tag}: ring step at position "
                             f"{W - RING_LEAD + i}: cpu and card logits "
                             f"differ by {err}")
        n, ok, _ = sure_tokens_agree(lc, lg, f"{tag} ring step {i + 1}", tol)
        checked, agree = checked + n, agree + ok
        tok = lc.argmax(-1).to(torch.int32)[:, None]
    slots = [(W - RING_LEAD + i) % W for i in range(RING_STEPS)]
    kv_err = max(float((caches[DEVICE][n][:, :, slots].cpu()
                        - caches["cpu"][n][:, :, slots]).abs().max())
                 for n in ("k", "v"))
    end = W - RING_LEAD + RING_STEPS
    if not (caches["cpu"]["pos"] == caches[DEVICE]["pos"] == end
            and kv_err <= tol
            and not torch.equal(caches["cpu"]["k"][:, :, 0], seeded)):
        raise SystemExit(f"{tag}: the ring's written slots differ (max "
                         f"|diff| {kv_err}) or slot 0 was not rewritten")
    print(f"[{tag}] ring: window {W}, a {max_seq}-slot cache is a ring of "
          f"{layout.seq}; B={B}, positions {W - RING_LEAD}-{end - 1} (slots "
          f"{slots[0]}-{W - 1}, then 0-{slots[-1]}): logits max |diff| "
          f"{worst:.5f} over {RING_STEPS} steps (tolerance {tol}); greedy "
          f"tokens agree on {agree} of {checked} checked rows; the written "
          f"slots' K/V max |diff| {kv_err:.2e}, slot 0 rewritten", flush=True)


def run_zoo_model(arch) -> dict:
    """Phase 11 for one arch; returns the launches of its engine run and
    its prefill passes."""
    cfg = zoo_config(arch)
    tag = f"zoo {arch}"
    params = seeded_on_card(cfg, arch, tag)
    launches = serve_on_card(cfg, params, arch, tag, "--requests",
                             str(ZOO_REQUESTS))
    prefill = measure_prefill(cfg, params, tag)
    del params
    torch.cuda.empty_cache()
    zoo_cpu_check(cfg, tag)
    torch.cuda.empty_cache()
    return {k: launches[k] + prefill[k] for k in launches}


def run_zoo_phase(smi) -> dict:
    """Phase 11: every family this slice ports, served and prefilled on the
    card and held to the CPU; returns the launches of its runs."""
    total: dict = {}
    for arch in ZOO_ARCHS:
        t0 = time.perf_counter()
        for k, v in run_zoo_model(arch).items():
            total[k] = total.get(k, 0) + v
        print(f"[zoo] {arch} in {time.perf_counter() - t0:.1f}s ({smi})",
              flush=True)
    return total


# ---------------------------------------------------------------- phase 12
def train_tiles(cfg, params, tokens) -> tuple:
    """The (tile_gid, tile_rows) that ``moe.expert_tiles`` hands K5 in the
    first MoE layer of a no-grad forward of ``params`` over ``tokens``: the
    training call's routing, from real tokens."""
    seen = []
    inner = moe_mod.expert_tiles

    def recording(top_idx, E, C, bt=moe_mod.EXPERT_BT):
        out = inner(top_idx, E, C, bt)
        seen.append(out)
        return out

    moe_mod.expert_tiles = recording
    try:
        with torch.no_grad():
            models.forward_fn(cfg)(params, {"tokens": tokens})
    finally:
        moe_mod.expert_tiles = inner
    return seen[0]


def measure_backward(key, gid, rows, E, d, f, dtype, label,
                     dw_fault=None) -> list:
    """Phase 12 (a): K5's backward at one shape against its plain versions
    on the card.  x (E*C, d) and dy (E*C, f) random, with seeded noise in
    the rows past each tile's count and NaN in one partly filled tile's
    (the kernels and the plain versions must mask them: the TMA dW kernel
    loads whole 64-row boxes and zeroes those rows itself); zero-padded
    copies feed ``torch.bmm``, which has no mask.  w (E, d, f) at the init
    scale.  dX reads w through its tensor map and must equal K5 on a
    contiguous w^T (the earlier path, whose copy is timed apart) bit for
    bit; dW is held to its plain version within ``TRAIN_DW_TOL`` and
    printed beside the earlier kernel's recorded time (``DW_EARLIER_MS``).
    In float32 dX and dW also run on the element-load kernels (misaligned
    copies of x and dy; that dX copies w^T first), which must give the
    same bits, and are timed beside.  With ``dw_fault`` (a library
    whose dW keeps the rows past the counts) the check must fail.  Returns
    the (dX, dW) records; the bounds count each input read once (x's and
    dy's real rows, the active experts' weights, the ids) and each output
    written once, and 2 d f operations a real row."""
    T = gid.numel() * GMM_BT
    C = T // E
    dev = gid.device
    gen = torch.Generator(device=dev).manual_seed(120 + d)
    real = (torch.arange(GMM_BT, device=dev) < rows[:, None]).reshape(-1)
    n_real = int(real.sum())
    active = int((rows.view(E, -1).sum(dim=1) > 0).sum())
    # NaN past a count that ends inside a 16-row step, so a kernel that
    # kept those rows would read them
    partial = torch.nonzero(rows % 16 != 0).flatten()
    if partial.numel() == 0:
        raise SystemExit(f"[train] ({key}) no tile's count ends inside a "
                         f"16-row step: nothing to hold the row mask to")
    nan_tile = int(partial[0])
    tile = torch.arange(T, device=dev) // GMM_BT
    nan_rows = ~real & (tile == nan_tile)
    x = torch.randn(T, d, device=dev, generator=gen)
    dy = torch.randn(T, f, device=dev, generator=gen)
    x[nan_rows], dy[nan_rows] = float("nan"), float("nan")
    x, dy = x.to(dtype), dy.to(dtype)
    x0 = x.masked_fill(~real[:, None], 0)
    dy0 = dy.masked_fill(~real[:, None], 0)
    w = (torch.randn(E, d, f, device=dev, generator=gen) * d ** -0.5).to(dtype)
    wt = w.transpose(1, 2).contiguous()
    esize = x.element_size()
    flops = 2.0 * n_real * d * f
    ids = (gid.numel() + rows.numel()) * 4
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    tol = TRAIN_DW_TOL[dtype]
    bf16 = dtype == torch.bfloat16
    xe, dye = (None, None) if bf16 else (misaligned(x), misaligned(dy))
    elem = {} if bf16 else {
        "grouped_matmul_dx": lambda: GK._k5(
            dye, gid, w, GMM_BT, rows, "grouped_matmul_dx", w_transposed=True),
        "grouped_matmul_dw": lambda: GK.grouped_matmul_dw_kernel(
            xe, dye, gid, E, GMM_BT, rows),
    }
    out = []
    for name, kern, earlier, plain, lib, nbytes, path in (
        ("grouped_matmul_dx",
         lambda: GK._k5(dy, gid, w, GMM_BT, rows, "grouped_matmul_dx",
                        w_transposed=True),
         lambda: GK._k5(dy, gid, wt, GMM_BT, rows, "grouped_matmul_dx"),
         lambda: grouped_matmul_tiles_ref(dy, gid, wt, GMM_BT, rows),
         lambda: torch.bmm(dy0.view(E, C, f), w.transpose(1, 2)).view(T, d),
         (n_real * f + active * d * f + T * d) * esize + ids,
         GK.kernel_path(dy, w)),
        ("grouped_matmul_dw",
         lambda: GK.grouped_matmul_dw_kernel(x, dy, gid, E, GMM_BT, rows),
         None,
         lambda: grouped_matmul_dw_ref(x, dy, gid, E, GMM_BT, rows),
         lambda: torch.bmm(x0.view(E, C, d).transpose(1, 2),
                           dy0.view(E, C, f)),
         (n_real * (d + f) + E * d * f) * esize + ids,
         GK.dw_kernel_path(x, dy)),
    ):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        ok, err, scale = backward_close(got, want, tol)
        lib_err = float((lib().float() - want.float()).abs().max())
        if name == "grouped_matmul_dx" and not torch.equal(
                got.view(torch.int16 if bf16 else torch.int32),
                earlier().view(torch.int16 if bf16 else torch.int32)):
            raise SystemExit(f"[train] ({key}) dX read through w's tensor "
                             f"map differs from K5 on a contiguous w^T")
        if name == "grouped_matmul_dw" and dw_fault is not None:
            check_dw_fault(dw_fault, kern, want, tol, key)
        kernels = GK.KERNELS if name == "grouped_matmul_dx" else GK.DW_KERNELS
        if name in elem:
            if path != "f32" or not same_bits(got, elem[name]()):
                raise SystemExit(f"[train] ({key}) {name} on path {path}: "
                                 f"differs from the element-load kernel "
                                 f"{kernels['f32_elem']} in its bits")
        k_ms = cuda_ms(kern, REPS)
        k_dev = many_ms(kern)
        e_ms = cuda_ms(earlier, REPS) if earlier is not None else None
        el_ms = cuda_ms(elem[name], REPS) if name in elem else None
        el_dev = many_ms(elem[name]) if name in elem else None
        p_ms = cuda_ms(plain, REPS)
        l_ms = cuda_ms(lib, REPS)
        bound, bound_by = bound_ms(nbytes, flops, peak)
        if e_ms is not None:
            before = (f"; the earlier design {e_ms:.4f} ms (K5 on a copied "
                      f"w^T, the copy apart)" if bf16 else
                      f"; K5 on a contiguous w^T {e_ms:.4f} ms (the copy "
                      f"apart)")
        elif key in DW_EARLIER_MS and name == "grouped_matmul_dw":
            before = (f"; the earlier element-load wmma kernel "
                      f"{DW_EARLIER_MS[key]:.4f} ms as recorded, not timed "
                      f"here")
        else:
            before = ""
        if el_ms is not None:
            before += (f"; f32_elem ({kernels['f32_elem']}, bit-equal"
                       f"{', its w^T copy included' if e_ms else ''}) "
                       f"{el_ms:.4f} ms (device {el_dev:.4f})")
        print(f"[train] ({key}) {name} {label}: path {path} "
              f"({kernels[path]}); max |diff| "
              f"{err:.3e} of {scale:.3e} (tolerance {tol} of the largest, "
              f"noise past the counts, NaN past tile {nan_tile}'s "
              f"{int(rows[nan_tile])}); kernel {k_ms:.4f} ms (device "
              f"{k_dev:.4f}; {flops / k_ms / 1e9:.1f} TFLOP/s, "
              f"{k_ms / l_ms:.2f}x "
              f"torch.bmm, {bound / k_ms:.2f} of the bound){before}; plain "
              f"{p_ms:.4f} ms, torch.bmm "
              f"{l_ms:.4f} ms (max |diff| {lib_err:.3e}), bound {bound:.4f} "
              f"ms ({bound_by}, {nbytes / 1e6:.3f} MB, {flops / 1e9:.3f} "
              f"GFLOP)", flush=True)
        if not ok:
            raise SystemExit(f"[train] ({key}) {name} differs from its plain "
                             f"version: max |diff| {err}")
        out.append(dict(
            name=name, route="cuda", source=GMM_SOURCE,
            replaces=GMM_REPLACES, launches=0, max_abs_err=err, ms=k_ms,
            plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
            library_ms=l_ms, library="torch.bmm", kernel_path=path,
            kernel=kernels[path], device_ms=k_dev,
            **({} if e_ms is None else {"earlier_ms": e_ms}),
            **({} if el_ms is None else {"elem_ms": el_ms,
                                          "elem_device_ms": el_dev,
                                          "elem_kernel": kernels["f32_elem"]}),
            shape=f"({key}) {label}",
            note=("backward of K5; the reference has no Pallas backward "
                  "(XLA transposes its einsum)"),
        ))
    copy_ms = cuda_ms(lambda: w.transpose(1, 2).contiguous(), REPS)
    what = ("removed: the transposed-weight copy the earlier dX took first"
            if bf16 else "the transposed-weight copy the f32_elem dX still "
            "takes first (none on the f32 path)")
    print(f"[train] ({key}) {what}, {copy_ms:.4f} ms "
          f"({2 * w.numel() * esize / 1e6:.3f} MB moved, "
          f"{2 * w.numel() * esize / copy_ms / 1e9:.3f} TB/s)", flush=True)
    out[0]["wt_copy_ms"] = copy_ms
    idle = rows.view(E, -1).sum(dim=1) == 0
    dw = GK.grouped_matmul_dw_kernel(x, dy, gid, E, GMM_BT, rows)
    dx = GK._k5(dy, gid, w, GMM_BT, rows, "grouped_matmul_dx",
                w_transposed=True)
    if not (bool((dw[idle] == 0).all()) and bool((dx[~real] == 0).all())
            and not bool(torch.signbit(dw[idle]).any())
            and not bool(torch.signbit(dx[~real]).any())):
        raise SystemExit(f"[train] ({key}) an empty expert's dW or a "
                         f"padding row's dX is not +0")
    print(f"[train] ({key}) {E} experts, {active} active, {n_real} real rows "
          f"of {T}, {int(idle.sum())} empty experts", flush=True)
    return out


def backward_close(got, want, tol) -> tuple:
    """(finite and within ``tol`` of the largest value, max |diff|, the
    largest value)."""
    scale = float(want.float().abs().max()) or 1.0
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.float(), want.float(), rtol=tol, atol=tol * scale)
    return ok, err, scale


def check_dw_fault(lib: CudaLibrary, kern, want, tol, key) -> None:
    """The dW kernel of ``lib`` (``DW_PLANTED_FAULT``: the rows past the
    counts kept) through the wrapper must fail phase 12 (a)'s check."""
    saved = GK.LIBRARY
    GK.LIBRARY = lib
    try:
        got = kern()
        torch.cuda.synchronize()
    finally:
        GK.LIBRARY = saved
    ok, err, _ = backward_close(got, want, tol)
    if ok:
        raise SystemExit(f"[faults] ({key}) the dW kernel with the row "
                         f"zeroing removed passed phase 12 (a)'s check")
    print(f"[faults] ({key}) the dW kernel with the row zeroing removed "
          f"fails phase 12 (a)'s check, as it must: max |diff| {err:.3e}, "
          f"{int((~torch.isfinite(got)).sum())} non-finite", flush=True)


def train_batch(cfg, B, S, seed=0) -> dict:
    """``TokenPipeline(seed)``'s first batch of B x S tokens."""
    return TokenPipeline(DataConfig(cfg.vocab_size, S, B, seed=seed)).next_batch()


def batch_on(b, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def family_batch(cfg, b, seed) -> dict:
    """A ``TokenPipeline`` batch ``b`` as CPU tensors in the family's keys
    (``tests/test_torch_train.py::_step_batch``'s rule): the
    encoder-decoder takes its tokens as ``dec_tokens`` beside as many
    seeded normal frames, the VLM ``cfg.n_prefix`` seeded normal patches
    before them."""
    out = batch_on(b, "cpu")
    rows, seq = out["tokens"].shape
    gen = torch.Generator().manual_seed(seed)
    if cfg.family == "encdec":
        return {"frames": torch.randn(rows, seq, cfg.d_model, generator=gen),
                "dec_tokens": out["tokens"], "labels": out["labels"]}
    if cfg.family == "vlm":
        return {"patches": torch.randn(rows, cfg.n_prefix, cfg.d_model,
                                       generator=gen), **out}
    return out


def cut_weights(cut) -> dict:
    """``cut``'s weights by device: drawn on the card from seed 1 and
    copied to the CPU, so both hold the same values."""
    card = models.init_params(cut, torch.Generator(device=DEVICE).manual_seed(1))
    return {"cpu": tree_map(lambda p: p.to("cpu", copy=True), card),
            DEVICE: card}


def train_cpu_check(cfg, tag) -> tuple:
    """Phase 12 (b), 16 (b): the float32 cut (``zoo_cut``: 2 layers at
    full width), the same seeded weights on the card and the CPU: the loss
    and every gradient leaf for ``TRAIN_CPU_B`` x ``TRAIN_CPU_S`` tokens
    (as many frames, ``cfg.n_prefix`` patches) on the card against the
    CPU, the routing of each MoE layer compared (a flip is printed); with
    experts the card's backward is profiled (``profiled_backward``).  The
    leaves' tolerance is ``ZOO_GRAD_TOL``'s for the family, else
    ``TRAIN_GRAD_TOL``.  Returns the cut, its card weights and the card's
    gradient leaves."""
    cut = dataclasses.replace(zoo_cut(cfg), dtype="float32")
    t0 = time.perf_counter()
    params = cut_weights(cut)
    b = family_batch(cut, train_batch(cut, TRAIN_CPU_B, TRAIN_CPU_S, seed=1),
                     seed=161)
    out = {}
    times = [time.perf_counter() - t0]
    inner = moe_mod.expert_tiles
    for dev in ("cpu", DEVICE):
        t1 = time.perf_counter()
        routes = []

        def recording(top_idx, E, C, bt=moe_mod.EXPERT_BT):
            routes.append(top_idx.cpu())
            return inner(top_idx, E, C, bt)

        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        params[dev])
        before = dict(GK.KERNEL_LAUNCHES)
        moe_mod.expert_tiles = recording
        try:
            loss = models.loss_fn(cut)(live, to_device(b, dev))
        finally:
            moe_mod.expert_tiles = inner
        if dev == DEVICE and cut.n_experts:
            grads = profiled_backward(loss, tree_leaves(live), before, tag)
        else:
            grads = torch.autograd.grad(loss, tree_leaves(live))
        out[dev] = (float(loss.detach()), grads, routes)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    (lc, gc, rc), (lg, gg, rg) = out["cpu"], out[DEVICE]
    flips = sum(int((a != b).any(dim=1).sum()) for a, b in zip(rc, rg))
    print(f"[{tag}] cpu vs card, {cut.n_layers}-layer cut in float32, "
          f"{TRAIN_CPU_B} x {TRAIN_CPU_S} tokens: routing of "
          f"{len(rc)} MoE layers, {flips} token(s) routed differently",
          flush=True)
    t1 = time.perf_counter()
    worst, where = 0.0, ""
    names = [n for n, _ in iter_named_leaves(params["cpu"])]
    for name, a, g in zip(names, gc, gg):  # on the card: 3.7 G elements
        a = a.to(g.device)
        scale = float(a.abs().max()) or 1.0
        rel = float((a - g).abs().max()) / scale
        if rel > worst:
            worst, where = rel, name
    tol = ZOO_GRAD_TOL.get(cut.family, TRAIN_GRAD_TOL)
    print(f"[{tag}] loss cpu {lc:.6f} card {lg:.6f} (|diff| "
          f"{abs(lc - lg):.3e}); {len(gc)} gradient leaves, the largest "
          f"|diff| / the leaf's largest value {worst:.3e} ({where}); "
          f"tolerances {TRAIN_LOSS_TOL} (loss, relative) and {tol} "
          f"(leaves); {time.perf_counter() - t0:.1f}s (weights "
          f"{times[0]:.1f}, cpu {times[1]:.1f}, card {times[2]:.1f}, "
          f"compare {time.perf_counter() - t1:.1f})", flush=True)
    if not (abs(lc - lg) <= TRAIN_LOSS_TOL * abs(lc)
            and worst <= tol and math.isfinite(lg)):
        raise SystemExit(f"{tag}: the card's loss or gradients differ from "
                         f"the cpu's")
    return cut, params[DEVICE], gg


def profiled_backward(loss, leaves, before, tag) -> tuple:
    """Phase 12 (b)'s float32 backward on the card under torch.profiler:
    the gradients of ``leaves``.  Prints the K5 kernels the forward and
    the backward launched (by ``GK.KERNEL_LAUNCHES`` since ``before``) and
    the backward's device-to-device copies and K5 kernels from the trace;
    fails unless K5 took its float32 TMA kernels (the products are at
    moonshot's full widths, which TMA describes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    launched = {k: GK.KERNEL_LAUNCHES[k] - before[k] for k in before
                if GK.KERNEL_LAUNCHES[k] != before[k]}
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if ev:
        def total(match):
            hits = [e for e in ev if match(e.name)]
            return len(hits), sum(e.time_range.elapsed_us()
                                  for e in hits) / 1e3

        dtod = total(lambda n: n.startswith("Memcpy DtoD"))
        kern = total(lambda n: "direct_copy_kernel" in n)
        gmm = {}
        for e in ev:
            found = re.search(r"(gmm_[a-z0-9_]+)\s*[<(]", e.name)
            if found:
                gmm[found.group(1)] = gmm.get(found.group(1), 0) + 1
        traced = (f"the trace's device-to-device copies: {dtod[0]} Memcpy "
                  f"DtoD ({dtod[1]:.3f} ms) and {kern[0]} copy kernels "
                  f"({kern[1]:.3f} ms); K5 kernels in it {gmm}")
    else:
        traced = ("device copies not measured (the profiler saw no device "
                  "events)")
    print(f"[{tag}] the f32 cut's forward and backward on the card: K5 "
          f"launched {launched}; backward: {traced}", flush=True)
    if not (launched.get("gmm_f32_tma", 0) > 0
            and launched.get("gmm_dw_f32_tma", 0) > 0):
        raise SystemExit(f"[{tag}] the f32 cut did not run K5's float32 TMA "
                         f"kernels: {launched}")
    return grads


def iter_named_leaves(tree, path=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from iter_named_leaves(v, f"{path}{k}.")
        else:
            yield f"{path}{k}", v


def train_flops(cfg, B, S, n_real) -> float:
    """The operations of one train step from its shapes: each MoE layer's
    products (attention projections, scores and values over all S x S
    pairs as ``attn_full`` computes them, the router, the expert products
    on ``n_real`` real rows) run 4 times with remat (forward, recomputed
    forward, two backward products), 3 without; the unembedding 3 times."""
    T, d = B * S, cfg.d_model
    hd = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    ff = cfg.moe_d_ff or cfg.d_ff
    proj = 2 * T * d * (2 * hd + 2 * kv)
    scores = 2 * 2 * B * cfg.n_heads * S * S * cfg.head_dim
    layer = proj + scores + 2 * T * d * cfg.n_experts + 3 * 2 * n_real * d * ff
    passes = 4 if cfg.remat else 3
    unembed = 2 * T * d * pad_vocab(cfg.vocab_size)
    return cfg.n_layers * passes * layer + 3 * unembed


def profile_train(step, params, state, batch, tag) -> None:
    """Device busy share, launches and the heaviest kernels of
    ``TRAIN_PROFILE_STEPS`` train steps under torch.profiler, read from
    the trace's raw events: a Mamba model's step launches some 10^5
    kernels, for which ``prof.events()`` would build Python objects for
    minutes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    launch_calls = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, k = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (ms + e.duration_ns() / 1e6, k + 1)
        elif "LaunchKernel" in e.name():
            launch_calls += 1
    n = TRAIN_PROFILE_STEPS
    if not by_name:
        print(f"[{tag}] device time not measured (the profiler saw no "
              f"device events); {n} steps {wall:.4f}s; kernel launch calls "
              f"{launch_calls / n:.1f} a step", flush=True)
        return
    busy = sum(v[0] for v in by_name.values())
    events = sum(v[1] for v in by_name.values())
    print(f"[{tag}] profile of {n} steps: wall {wall * 1e3:.3f} ms "
          f"(profiler on), device busy {busy:.3f} ms "
          f"({100 * busy / (wall * 1e3):.2f}%), {events / n:.1f} device "
          f"events and {launch_calls / n:.1f} kernel launch calls a step; "
          f"the heaviest kernels:", flush=True)
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"[{tag}]   {ms / n:9.3f} ms a step in {k / n:8.1f} launches  "
              f"{name[:90]}")

    def total(match):
        hits = [v for name, v in by_name.items() if match(name)]
        return sum(v[0] for v in hits) / n, sum(v[1] for v in hits) / n

    dw_ms, dw_k = total(lambda name: "gmm_dw" in name)
    cp_ms, cp_k = total(lambda name: name.startswith("Memcpy DtoD"))
    ck_ms, ck_k = total(lambda name: "direct_copy_kernel" in name)
    print(f"[{tag}] a step: dW {dw_ms:.3f} ms in {dw_k:.1f} launches; "
          f"device-to-device copies {cp_k:.1f} Memcpy DtoD ({cp_ms:.3f} ms) "
          f"and {ck_k:.1f} copy kernels ({ck_ms:.3f} ms), by kernel:",
          flush=True)
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0]):
        if "direct_copy_kernel" in name:
            head = name.split("at::native::direct_copy_kernel_cuda")[0]
            print(f"[{tag}]   {ms / n:9.3f} ms a step in {k / n:8.1f} "
                  f"launches  {head[:70]}direct_copy", flush=True)


def update_bytes(name: str, n_params: int) -> float:
    """The bytes an update of bf16 parameters moves: AdamW reads p, g, m,
    v and writes p, m, v (22 a parameter); 8-bit AdamW reads p, g and the
    m, v codes and writes p and the codes, with an f32 scale a 256-block
    for each of m and v read and written."""
    if name == "adamw8bit":
        return (2 + 2 + 2 + 2 + 2 + 16 / 256) * n_params
    return 22 * n_params


def time_update(opt, params, state, step_ms, tag) -> float:
    """The optimizer's update alone (zero gradients) on the card, the
    median of 3, beside the bytes it moves; returns its ms."""
    n_params = sum(t.numel() for t in iter_leaves(params))
    nbytes = update_bytes(opt.name, n_params)
    zeros = tree_map(torch.zeros_like, params)
    upd_ms = cuda_ms(lambda: opt.update(zeros, state, params), 3)
    print(f"[{tag}] the {opt.name} update alone: {upd_ms:.3f} ms a step, "
          f"{nbytes / upd_ms / 1e9:.3f} TB/s of its {nbytes / 1e9:.3f} GB "
          f"(floor {nbytes / bench_common.PEAK_BYTES * 1e3:.3f} ms); the "
          f"loss and its gradients the other {step_ms - upd_ms:.3f} ms of "
          f"the median step", flush=True)
    return upd_ms


def train_steps(step, params, state, batches, tag) -> tuple:
    """``step`` (a ``make_train_step``) over ``batches`` on the card, each
    step between two CUDA events; prints each step's loss, grad norm and
    ms.  Returns (params, state, the run's record: losses, grad norms, ms,
    the median of steps 2 on and their sorted ms, peak memory, kernel
    launches, K5's launches a step, the experts' first moments nonzero
    after step 1)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    metrics, events, nonzero = [], [], {}
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, state, m = step(params, state, batch)
        end.record()
        metrics.append(m)
        events.append((start, end))
        if i == 0:
            nonzero = expert_moments_nonzero(state)
    torch.cuda.synchronize()
    launches = all_launches()
    ms = [a.elapsed_time(b) for a, b in events]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    for i, (l, g, t) in enumerate(zip(losses, norms, ms)):
        print(f"[{tag}] step {i + 1}: loss {l:.6f}, grad norm {g:.6f}, "
              f"{t:.3f} ms", flush=True)
    later = sorted(ms[1:])
    return params, state, {
        "losses": losses, "norms": norms, "ms": ms, "later": later,
        "median": later[len(later) // 2],
        "peak": torch.cuda.max_memory_allocated(), "launches": launches,
        "per": {k: launches[k] / len(batches) for k in
                ("grouped_matmul", "grouped_matmul_dx", "grouped_matmul_dw")},
        "nonzero": nonzero}


def expert_moments_nonzero(state) -> dict:
    """The nonzero first-moment entries of each expert weight (``...moe.w*``
    leaves' ``m``, or ``m_q`` codes in 8 bits)."""
    return {name: int((t != 0).sum())
            for name, t in iter_named_leaves(state["mu"])
            if ".moe.w" in f".{name}" and name.rsplit(".", 1)[1] in ("m", "m_q")}


def check_train_run(cfg, run, tag, learns: bool = True) -> None:
    """A ``train_steps`` record: K5's forward / dX / dW launches 6 / 3 / 3 an
    MoE layer a step (with remat), every loss finite, the experts' first
    moments nonzero after step 1; where the model ``learns``, every grad
    norm finite and the last loss below the first."""
    moe = sum(cfg.uses_moe(i) for i in range(cfg.n_layers))
    want = {"grouped_matmul": 3 * moe * (2 if cfg.remat else 1),
            "grouped_matmul_dx": 3 * moe, "grouped_matmul_dw": 3 * moe}
    per = run["per"]
    if {k: int(v) for k, v in per.items()} != want or any(
            v % 1 for v in per.values()):
        raise SystemExit(f"[{tag}] K5 launches a step {per}, expected {want}")
    if not all(math.isfinite(v) for v in run["losses"]
               + (run["norms"] if learns else [])):
        raise SystemExit(f"[{tag}] a loss or grad norm is not finite")
    if moe and not (run["nonzero"] and all(v > 0 for v in
                                           run["nonzero"].values())):
        raise SystemExit(f"[{tag}] an expert weight got no gradient: "
                         f"{run['nonzero']}")
    if learns and not run["losses"][-1] < run["losses"][0]:
        raise SystemExit(f"[{tag}] the loss did not fall: {run['losses']}")


def run_train_phase(smi, dw_fault=None) -> tuple:
    """Phase 12: K5's backward against its plain versions at moonshot's
    training call, the float32 2-layer cut's gradients against the CPU,
    and ``make_train_step`` at full width (``TRAIN_LAYERS`` layers, bf16,
    the config's AdamW and remat) on ``TokenPipeline(seed=0)``.  Returns
    the launches of the train run and the (dX, dW) kernel records.
    ``dw_fault``: the planted dW library (built here if not given)."""
    tag = "train"
    dev = torch.device(DEVICE)
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAIN_LAYERS)
    params = seeded_on_card(cfg, MOE_ARCH, tag)
    b0 = train_batch(cfg, TRAIN_B, TRAIN_S)
    gid, rows = train_tiles(cfg, params, batch_on(b0, dev)["tokens"])
    E = cfg.n_experts
    C = gid.numel() * GMM_BT // E

    # (a) K5's backward at the training call: gate/up (2048 -> 1408) and
    # down (1408 -> 2048); then a ragged float32 case
    label = (f"T={E * C} (E={E} x C={C}), {TRAIN_B} x {TRAIN_S} tokens "
             f"top-{cfg.top_k}, bf16")
    if dw_fault is None:
        dw_fault = planted_dw_library()
    up = measure_backward("a", gid, rows, E, cfg.d_model, cfg.moe_d_ff,
                          torch.bfloat16, f"d={cfg.d_model} f={cfg.moe_d_ff} "
                          + label, dw_fault)
    down = measure_backward("a'", gid, rows, E, cfg.moe_d_ff, cfg.d_model,
                            torch.bfloat16, f"d={cfg.moe_d_ff} "
                            f"f={cfg.d_model} " + label)
    rgid = torch.arange(8, dtype=torch.int32, device=dev) // 2
    rrows = torch.tensor([128, 128, 0, 0, 128, 77, 5, 0], dtype=torch.int32,
                         device=dev)
    ragged = measure_backward("r", rgid, rrows, 4, 192, 160, torch.float32,
                              "d=192 f=160 f32, 4 experts of 256 rows, one "
                              "empty, a partly filled tile")
    # (t f32): the call of (b)'s float32 cut, its TRAIN_CPU_B x TRAIN_CPU_S
    # tokens routed top-k over the E experts (seeded) at the capacity the
    # MoE layer gives them
    n_tok = TRAIN_CPU_B * TRAIN_CPU_S
    C32 = moe_mod.moe_capacity(cfg, n_tok)
    tgen = torch.Generator(device=dev).manual_seed(126)
    top = torch.rand(n_tok, E, device=dev, generator=tgen).argsort(
        dim=1)[:, :cfg.top_k]
    tgid, trows = moe_mod.expert_tiles(top, E, C32, GMM_BT)
    cut = measure_backward("t", tgid, trows, E, cfg.d_model, cfg.moe_d_ff,
                           torch.float32, f"d={cfg.d_model} f={cfg.moe_d_ff} "
                           f"T={E * C32} (E={E} x C={C32}), {n_tok} tokens "
                           f"top-{cfg.top_k}, f32 (the f32 cut's call)")
    dx_rec = dict(up[0], shapes={"a'": down[0], "r f32": ragged[0],
                                 "t f32": cut[0]})
    dw_rec = dict(up[1], shapes={"a'": down[1], "r f32": ragged[1],
                                 "t f32": cut[1]})

    # (c) the slice at full width
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(cfg, opt)
    state = opt.init(params)
    n_params = sum(t.numel() for t in iter_leaves(params))
    data = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batches = [batch_on(data.next_batch(), dev) for _ in range(TRAIN_STEPS)]
    params, state, run = train_steps(step, params, state, batches, tag)
    launches, peak, med, per, nonzero = (
        run[k] for k in ("launches", "peak", "median", "per", "nonzero"))
    later = run["later"]
    tokens = TRAIN_B * TRAIN_S
    flops = train_flops(cfg, TRAIN_B, TRAIN_S, int(rows.sum()))
    opt_bytes = update_bytes(opt.name, n_params)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = opt_bytes / bench_common.PEAK_BYTES * 1e3
    print(f"[{tag}] {MOE_ARCH} at full width, {cfg.n_layers} of "
          f"{get_config(MOE_ARCH).n_layers} layers, {n_params / 1e9:.3f} G "
          f"parameters, bf16, {opt.name}, remat={cfg.remat}: step "
          f"{med:.3f} ms median of steps 2-{TRAIN_STEPS} ({later[0]:.3f}-"
          f"{later[-1]:.3f}), {tokens / med * 1e3:.1f} tokens/s; peak memory "
          f"{peak / 2**30:.3f} GiB; K5 launches a step: forward "
          f"{per['grouped_matmul']:.1f}, dX {per['grouped_matmul_dx']:.1f}, "
          f"dW {per['grouped_matmul_dw']:.1f}; floor "
          f"{max(t_ops, t_bytes):.3f} ms (operations {flops / 1e12:.3f} TFLOP "
          f"at the bf16 peak {t_ops:.3f} ms; AdamW's {opt_bytes / 1e9:.3f} GB "
          f"at 3.35 TB/s {t_bytes:.3f} ms); experts' first moments nonzero "
          f"after step 1: {nonzero} ({smi})", flush=True)
    check_train_run(cfg, run, tag)
    profile_train(step, params, state, batches[-1], tag)
    time_update(opt, params, state, med, tag)
    del params, state, batches
    torch.cuda.empty_cache()

    # (b) the float32 cut against the CPU
    train_cpu_check(cfg, tag)
    torch.cuda.empty_cache()
    return launches, [dx_rec, dw_rec]


# ---------------------------------------------------------------- phase 13
def timed(fn, out: list, sync: bool = False):
    """``fn`` that appends each call's host seconds to ``out``."""
    def wrapper(*args, **kw):
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
        return result
    return wrapper


def make_trainer(cfg, tag, steps, ckpt_dir) -> Trainer:
    """A ``Trainer`` on the card to ``steps``, checkpointing into
    ``ckpt_dir`` (or not) every ``TRAINER_SAVE_AT`` steps."""
    tcfg = TrainerConfig(steps=steps, checkpoint_every=TRAINER_SAVE_AT,
                         checkpoint_dir=None if ckpt_dir is None
                         else str(ckpt_dir), log_every=1, seed=0,
                         global_batch=TRAIN_B, seq_len=TRAIN_S)
    return Trainer(cfg, tcfg, log_fn=lambda s: print(f"[{tag}] {s}",
                                                     flush=True),
                   device=DEVICE)


def run_counted(t, launches, tag) -> list:
    """``t.run()``'s history; its kernel launches added to ``launches``,
    K5's checked against 6 / 3 / 3 a layer a step (phase 12's rule with
    remat), every loss finite."""
    reset_all_launches()
    hist = t.run()
    torch.cuda.synchronize()
    got = all_launches()
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    n, L = len(hist), t.cfg.n_layers
    want = {"grouped_matmul": 3 * L * (2 if t.cfg.remat else 1) * n,
            "grouped_matmul_dx": 3 * L * n, "grouped_matmul_dw": 3 * L * n}
    if {k: got.get(k, 0) for k in want} != want:
        raise SystemExit(f"[{tag}] K5 launches {got} for {n} steps of "
                         f"{L} layers; expected {want}")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"[{tag}] a loss is not finite: {losses}")
    return hist


def resume_check(cfg, smi, launches) -> dict:
    """Phase 13 (a): two uninterrupted runs, then A (to the checkpoint) and
    B (resumed from it) at full width.  Returns B's losses and the plain
    restore's seconds; the checkpoint stays for phase 14."""
    tag = "trainer"
    full = get_config(MOE_ARCH).n_layers
    meta = models.init_params(cfg, device="meta")
    n_params = sum(t.numel() for t in iter_leaves(meta))
    # the weights, AdamW's f32 m and v, and its int32 step
    ckpt_bytes = sum(t.numel() * t.element_size() for t in iter_leaves(meta)
                     ) + 2 * 4 * n_params + 4
    shutil.rmtree(TRAINER_DIR, ignore_errors=True)
    TRAINER_DIR.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(TRAINER_DIR.parent).free
    print(f"[{tag}] {MOE_ARCH} at full width, {cfg.n_layers} of {full} "
          f"layers, {n_params:,} parameters in {cfg.dtype}, {cfg.optimizer}, "
          f"remat={cfg.remat}, {TRAIN_B} x {TRAIN_S} tokens a step; "
          f"checkpoint {ckpt_bytes / 1e9:.3f} GB; free disk "
          f"{free / 1e9:.3f} GB under {TRAINER_DIR.parent}", flush=True)
    if free < 2 * ckpt_bytes:
        raise SystemExit(f"[{tag}] {free / 1e9:.3f} GB free under "
                         f"{TRAINER_DIR.parent}: two checkpoints need "
                         f"{2 * ckpt_bytes / 1e9:.3f} GB")

    # two uninterrupted runs: the card's own spread
    runs = []
    for i in range(2):
        t = make_trainer(cfg, f"{tag} run {i + 1}", TRAINER_STEPS, None)
        hist = run_counted(t, launches, tag)
        runs.append(hist)
        del t
        torch.cuda.empty_cache()
    u1 = [h["loss"] for h in runs[0]]
    u2 = [h["loss"] for h in runs[1]]
    spread = max(abs(a - b) / abs(a) for a, b in zip(u1, u2))

    # A: to the checkpoint
    a = make_trainer(cfg, f"{tag} A", TRAINER_SAVE_AT, TRAINER_DIR)
    saves, waits = [], []
    a.ckpt.save = timed(a.ckpt.save, saves)
    a.ckpt.wait = timed(a.ckpt.wait, waits)
    hist_a = run_counted(a, launches, tag)
    step_dir = TRAINER_DIR / f"step_{TRAINER_SAVE_AT:08d}"
    files = sorted(step_dir.iterdir())
    on_disk = sum(f.stat().st_size for f in files)
    manifest = json.loads((step_dir / "manifest.json").read_text())
    dtypes = sorted({leaf["dtype"] for leaf in manifest["leaves"]})
    print(f"[{tag}] A: {len(hist_a)} steps, checkpoint at step "
          f"{TRAINER_SAVE_AT}: {on_disk:,} bytes in {len(files)} files "
          f"({len(manifest['leaves'])} leaves, dtypes {dtypes}); save() "
          f"blocked the loop {saves[0] * 1e3:.3f} ms (the host snapshot), "
          f"wait() blocked {waits[-1]:.3f} s (the write)", flush=True)
    if "bfloat16" not in dtypes:
        raise SystemExit(f"[{tag}] the manifest holds no bfloat16 leaf")

    # B: resumed from A's checkpoint
    restores = []
    inner = trainer_mod.restore_checkpoint
    trainer_mod.restore_checkpoint = timed(inner, restores, sync=True)
    try:
        b = make_trainer(cfg, f"{tag} B", TRAINER_STEPS, TRAINER_DIR)
    finally:
        trainer_mod.restore_checkpoint = inner
    if b.start_step != TRAINER_SAVE_AT or len(restores) != 1:
        raise SystemExit(f"[{tag}] B started at step {b.start_step}, "
                         f"expected {TRAINER_SAVE_AT}")
    n_leaves = 0
    for mine, theirs in ((b.params, a.params), (b.opt_state, a.opt_state)):
        la, lb = list(iter_leaves(theirs)), list(iter_leaves(mine))
        if len(la) != len(lb) or not all(
                x.dtype == y.dtype and x.device == y.device
                and torch.equal(x, y) for x, y in zip(la, lb)):
            raise SystemExit(f"[{tag}] B's restored state differs from A's")
        n_leaves += len(la)
    del a
    torch.cuda.empty_cache()
    print(f"[{tag}] B: restored step {b.start_step} in {restores[0]:.3f} s; "
          f"{n_leaves} leaves of parameters and optimizer state equal to "
          f"A's (torch.equal, bf16 included)", flush=True)
    bsaves, bwaits = [], []
    b.ckpt.save = timed(b.ckpt.save, bsaves)
    b.ckpt.wait = timed(b.ckpt.wait, bwaits)
    hist_b = run_counted(b, launches, tag)
    del b
    torch.cuda.empty_cache()
    got = [h["loss"] for h in hist_b]
    want = u1[TRAINER_SAVE_AT:]
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    steps_ms = sorted(h["sec"] * 1e3 for h in runs[0][1:] + runs[1][1:])
    la = [h["loss"] for h in hist_a]
    print(f"[{tag}] losses: run 1 {u1}; run 2 {u2}; A {la}; B (steps "
          f"{TRAINER_SAVE_AT + 1}-{TRAINER_STEPS}) {got}", flush=True)
    print(f"[{tag}] B against run 1: largest |diff| / |loss| {worst:.3e} "
          f"(tolerance {TRAINER_LOSS_TOL}); the card's spread, run 1 against "
          f"run 2: {spread:.3e}; B's save at step {TRAINER_STEPS} blocked "
          f"{bsaves[0] * 1e3:.3f} ms and its wait {bwaits[-1]:.3f} s; step "
          f"{steps_ms[len(steps_ms) // 2]:.3f} ms median of the runs' steps "
          f"2-{TRAINER_STEPS} ({steps_ms[0]:.3f}-{steps_ms[-1]:.3f}; host "
          f"clock around the step and its loss read back) ({smi})",
          flush=True)
    if worst > TRAINER_LOSS_TOL:
        raise SystemExit(f"[{tag}] B's losses differ from the uninterrupted "
                         f"run's by {worst:.3e}")
    return {"b_losses": got, "restore_s": restores[0]}


def smoke_cpu_check(arch, launches) -> None:
    """Phase 13 (b): the smoke config's ``Trainer`` on the card from the
    CPU trainer's initial weights, loss for loss against the CPU; with
    8-bit AdamW also ``smoke_resume_check``."""
    tag = "trainer"
    cfg = smoke_config(arch)
    tcfg = TrainerConfig(steps=TRAINER_SMOKE_STEPS, seed=0)
    quiet = dict(log_fn=lambda s: None)
    cpu = Trainer(cfg, tcfg, device="cpu", **quiet)
    card = Trainer(cfg, tcfg, device=DEVICE, **quiet)
    card.params = tree_map(lambda p: p.to(DEVICE, copy=True), cpu.params)
    card.opt_state = card.opt.init(card.params)
    init = tree_map(lambda p: p.to(DEVICE, copy=True), cpu.params)
    t0 = time.perf_counter()
    want = [h["loss"] for h in cpu.run()]
    t_cpu = time.perf_counter() - t0
    reset_all_launches()
    t0 = time.perf_counter()
    got = [h["loss"] for h in card.run()]
    t_card = time.perf_counter() - t0
    for k, v in all_launches().items():
        launches[k] = launches.get(k, 0) + v
    tol = (TRAINER_SMOKE_TOL_8BIT if cfg.optimizer == "adamw8bit"
           else TRAINER_SMOKE_TOL)
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    print(f"[{tag}] {arch} smoke config (f32, {cfg.n_layers} layers, "
          f"d_model {cfg.d_model}{', %d experts' % cfg.n_experts if cfg.n_experts else ''}, "
          f"{cfg.optimizer}): {TRAINER_SMOKE_STEPS} steps of "
          f"{tcfg.global_batch} x {tcfg.seq_len} on the card ({t_card:.2f} s) "
          f"against the cpu ({t_cpu:.2f} s): loss {want[0]:.6f} -> "
          f"{want[-1]:.6f}, largest |diff| / |loss| {worst:.3e} (tolerance "
          f"{tol})", flush=True)
    if not (worst <= tol and all(math.isfinite(v) for v in got)):
        raise SystemExit(f"[{tag}] {arch}: the card's losses differ from "
                         f"the cpu's")
    if cfg.optimizer == "adamw8bit":
        smoke_resume_check(cfg, init, got, launches)


def smoke_resume_check(cfg, init, want, launches) -> None:
    """Phase 13 (b), 8-bit AdamW: a smoke ``Trainer`` on the card from
    ``init`` to ``TRAINER_SMOKE_SAVE_AT`` with a checkpoint, then one
    resumed from it to ``TRAINER_SMOKE_STEPS``.  Every restored leaf
    (the int8 ``m_q``/``v_q`` codes and f32 scales too) must equal the
    first trainer's, and both trainers' losses must lie within
    ``TRAINER_LOSS_TOL`` of the uninterrupted card run's ``want``."""
    tag = "trainer"
    shutil.rmtree(TRAINER_SMOKE_DIR, ignore_errors=True)
    tcfg = TrainerConfig(steps=TRAINER_SMOKE_SAVE_AT, seed=0,
                         checkpoint_every=TRAINER_SMOKE_SAVE_AT,
                         checkpoint_dir=str(TRAINER_SMOKE_DIR))
    quiet = dict(log_fn=lambda s: None)
    reset_all_launches()
    a = Trainer(cfg, tcfg, device=DEVICE, **quiet)
    a.params = init
    a.opt_state = a.opt.init(a.params)
    got = [h["loss"] for h in a.run()]
    b = Trainer(cfg, dataclasses.replace(tcfg, steps=TRAINER_SMOKE_STEPS),
                device=DEVICE, **quiet)
    if b.start_step != TRAINER_SMOKE_SAVE_AT:
        raise SystemExit(f"[{tag}] the resumed smoke trainer started at step "
                         f"{b.start_step}, expected {TRAINER_SMOKE_SAVE_AT}")
    kinds: dict = {}
    for mine, theirs in ((b.params, a.params), (b.opt_state, a.opt_state)):
        for (name, x), y in zip(iter_named_leaves(theirs), iter_leaves(mine)):
            if not (x.dtype == y.dtype and x.device == y.device
                    and torch.equal(x, y)):
                raise SystemExit(f"[{tag}] the restored {name} differs from "
                                 f"the saved trainer's")
            kinds[str(x.dtype)] = kinds.get(str(x.dtype), 0) + 1
    if "torch.int8" not in kinds:
        raise SystemExit(f"[{tag}] the 8-bit checkpoint holds no int8 leaf")
    got += [h["loss"] for h in b.run()]
    shutil.rmtree(TRAINER_SMOKE_DIR, ignore_errors=True)
    for k, v in all_launches().items():
        launches[k] = launches.get(k, 0) + v
    worst = max(abs(x - y) / abs(y) for x, y in zip(got, want))
    print(f"[{tag}] {cfg.name} smoke config: saved at step "
          f"{TRAINER_SMOKE_SAVE_AT}, resumed by a second trainer: every "
          f"leaf restored equal ({kinds}); the two trainers' losses against "
          f"the uninterrupted card run: largest |diff| / |loss| {worst:.3e} "
          f"(tolerance {TRAINER_LOSS_TOL})", flush=True)
    if worst > TRAINER_LOSS_TOL or len(got) != len(want):
        raise SystemExit(f"[{tag}] the resumed 8-bit smoke trainer's losses "
                         f"differ from the uninterrupted run's")


def captured(fn, *args) -> str:
    """``fn(*args)``'s standard output, echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return out


def run_trainer_phase(smi):
    """Phase 13: the trainer on the card.  Returns the phase's kernel
    launches and ``resume_check``'s record."""
    launches: dict = {}
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAINER_LAYERS)
    resumed = resume_check(cfg, smi, launches)
    for arch in TRAINER_SMOKE_ARCHS:
        smoke_cpu_check(arch, launches)

    # (c) the entry points
    reset_all_launches()
    t0 = time.perf_counter()
    out = captured(train_launcher.main, ["--arch", SERVE_ARCH, "--steps",
                                         "20", "--device", DEVICE])
    last = out.strip().splitlines()[-1]
    if not (last.startswith("[train] final loss ")
            and math.isfinite(float(last.split()[3]))):
        raise SystemExit(f"[trainer] launch.train printed {last!r}")
    t_launch = time.perf_counter() - t0
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    out = captured(train_lm.main, ["--big", "--steps", "100", "--device",
                                   DEVICE, "--ckpt-dir", str(TRAIN_LM_DIR)])
    shutil.rmtree(TRAIN_LM_DIR, ignore_errors=True)
    if "(improved)" not in out:
        raise SystemExit("[trainer] train_lm --big did not print improved")
    for k, v in all_launches().items():
        launches[k] = launches.get(k, 0) + v
    print(f"[trainer] launch.train {t_launch:.2f} s, train_lm --big 100 "
          f"steps {time.perf_counter() - t0:.2f} s on the card", flush=True)
    return launches, resumed


# ---------------------------------------------------------------- phase 14
def start_dryruns() -> list:
    """Phase 14 (a): one ``launch.dryrun`` subprocess a cell, started
    together; returns (cell, process) pairs."""
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for cell in MESH_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *cell,
               "--out", str(MESH_DIR)]
        procs.append((cell, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)))
    return procs


def finish_dryruns(procs, smi) -> None:
    """Phase 14 (a): wait for each cell; it must exit 0.  Prints its OK
    line and the argument bytes a rank holds beside the card's memory."""
    total = torch.cuda.get_device_properties(0).total_memory
    failed = []
    for cell, proc in procs:
        try:
            out, err = proc.communicate(timeout=MESH_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
        ok = [ln for ln in out.splitlines() if ln.startswith("OK")]
        if proc.returncode != 0 or not ok:
            failed.append(cell)
            print(f"[mesh] dryrun {' '.join(cell)} exited {proc.returncode}:"
                  f"\n{out[-2000:]}\n{err[-4000:]}", flush=True)
            continue
        mesh = "2x16x16" if "--multi-pod" in cell else "16x16"
        rec = json.loads((MESH_DIR / f"{cell[1]}__{cell[3]}__{mesh}.json")
                         .read_text())
        args = rec["memory_analysis"]["argument_bytes"]
        print(f"[mesh] {ok[0].strip()}", flush=True)
        print(f"[mesh]   {rec['chips']} ranks, trace {rec['trace_s']:.2f} s "
              f"(cell {rec['cell_s']:.2f} s with its scan lengths); "
              f"arguments {args / 1e9:.3f} GB a rank against this card's "
              f"{total / 1e9:.3f} GB ({smi}); kernels {rec['kernels']}",
              flush=True)
    if failed:
        raise SystemExit(f"[mesh] dry-run cells failed: {failed}")


def elastic_check(smi, resumed, launches) -> None:
    """Phase 14 (b): phase 13's checkpoint restored onto a (1, 1) mesh of
    the card, and B's next steps replayed from the local tensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=TRAINER_LAYERS)
    tcfg = TrainerConfig(seed=0, global_batch=TRAIN_B, seq_len=TRAIN_S)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        rules = ShardingRules(mesh, dict(DEFAULT_RULES))
        opt = make_optimizer(cfg.optimizer, lr=tcfg.lr)
        meta = models.init_params(cfg, device="meta")
        like = {"params": meta, "opt": opt.init(meta)}
        paxes = models.param_axes(cfg)
        axes = {"params": paxes, "opt": opt.state_axes(paxes)}
        t0 = time.perf_counter()
        tree, step = elastic_restore(TRAINER_DIR, TRAINER_SAVE_AT, like, axes,
                                     rules, zero1=True)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        leaves = list(iter_leaves(tree))
        where = {str(t.device) for t in leaves}
        if step != TRAINER_SAVE_AT or not all(
                isinstance(t, DTensor) for t in leaves) or where != {"cuda:0"}:
            raise SystemExit(f"[mesh] elastic restore gave step {step}, "
                             f"devices {where}, "
                             f"{sum(isinstance(t, DTensor) for t in leaves)} "
                             f"DTensors of {len(leaves)} leaves")
        print(f"[mesh] elastic restore of step {step} onto a (1, 1) mesh: "
              f"{len(leaves)} leaves, every one a DTensor on cuda:0, in "
              f"{t_restore:.3f} s (phase 13's plain restore "
              f"{resumed['restore_s']:.3f} s) ({smi})", flush=True)
        local = tree_map(lambda t: t.to_local(), tree)
        del tree, leaves
        params, state = local["params"], local["opt"]
        data = TokenPipeline.restore(
            DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=tcfg.seed),
            {"step": step, "seed": tcfg.seed})
        step_fn = make_train_step(cfg, opt)
        reset_all_launches()
        got = []
        for _ in range(MESH_STEPS):
            batch = {k: torch.from_numpy(v).to(DEVICE)
                     for k, v in data.next_batch().items()}
            params, state, metrics = step_fn(params, state, batch)
            got.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        for k, v in all_launches().items():
            launches[k] = launches.get(k, 0) + v
        want = resumed["b_losses"][:MESH_STEPS]
        print(f"[mesh] steps {step + 1}-{step + MESH_STEPS} from the elastic "
              f"restore: losses {got}; trainer B's {want}; K5 launches "
              f"{ {k: v for k, v in all_launches().items() if v} }",
              flush=True)
        if got != want:
            raise SystemExit("[mesh] the elastic restore's losses differ from "
                             "trainer B's")
        del params, state, local
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    """A free localhost port (closed again before the group binds it)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_mesh_phase(smi, resumed) -> dict:
    """Phase 14: the mesh tools.  Returns the phase's kernel launches."""
    launches: dict = {}
    has_fake = importlib.util.find_spec(
        "torch.testing._internal.distributed.fake_pg") is not None
    print(f"[mesh] torch {torch.__version__}: "
          f"torch.testing._internal.distributed.fake_pg "
          f"{'present' if has_fake else 'missing'}", flush=True)
    procs = start_dryruns()
    try:
        elastic_check(smi, resumed, launches)
    finally:
        finish_dryruns(procs, smi)
    return launches


# ---------------------------------------------------------------- phase 15
def sharded_config():
    return dataclasses.replace(get_config(SERVE_ARCH), n_layers=SHARDED_LAYERS,
                               dtype="float32")


def fill_prefix(k, v, lo: int) -> None:
    """Seeded K/V in slots [0, SHARDED_POS) of every layer, written where
    they fall in ``k``/``v`` (L, B, S_l, KV, D), slots [lo, lo + S_l):
    each rank draws the same numbers and keeps its own."""
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    L, B, S_l, KV, D = k.shape
    hi = min(SHARDED_POS, lo + S_l)
    for i in range(L):
        for t in (k, v):
            draw = torch.randn((B, SHARDED_POS, KV, D), generator=gen,
                               device=DEVICE, dtype=t.dtype)
            if hi > lo:
                t[i, :, :hi - lo] = draw[:, lo:hi]


def timed_steps(step, params, cache, put, full) -> dict:
    """SHARDED_STEPS greedy steps of ``step`` (``make_serve_step``) from
    seeded tokens: the tokens, each step's ms (host clock to a
    synchronize) and K4's launches."""
    tok = torch.from_numpy(np.random.default_rng(15).integers(
        0, sharded_config().vocab_size,
        (SHARDED_B, 1)).astype(np.int32)).to(DEVICE)
    reset_all_launches()
    tokens, ms = [], []
    for _ in range(SHARDED_STEPS):
        t0 = time.perf_counter()
        tok, cache = step(params, put(tok), cache)
        tok = full(tok)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(tok[:, 0].tolist())
    return {"tokens": tokens, "ms": ms,
            "k4": PK.LAUNCHES["paged_attention"]}


def sharded_decode_rank(rank: int, port: str) -> None:
    """Phase 15, one rank (a process of its own): the unsharded decode on
    rank 0, then the sequence-sharded one on every rank under
    DECODE_RULES, the weights and cache placed as each rank's shards of
    the same seeded tensors.  Prints its record as JSON."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.sharding import DECODE_RULES, activate
    from repro_torch.training import make_serve_step, tree_shardings

    torch.cuda.set_device(0)
    PK.build()
    dist.init_process_group(SHARDED_BACKEND,
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=SHARDED_RANKS)
    cfg = sharded_config()
    B, S = SHARDED_B, SHARDED_SLOTS
    mesh = init_device_mesh(torch.device(DEVICE).type, (1, SHARDED_RANKS),
                            mesh_dim_names=("data", "model"))
    rules = ShardingRules(mesh, dict(DECODE_RULES))
    step = make_serve_step(cfg, S)
    rec = {"rank": rank, "backend": SHARDED_BACKEND}
    t0 = time.perf_counter()
    params = models.init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0))
    meta = models.make_cache(cfg, B, S, device="meta")
    csh = tree_shardings(rules, models.cache_axes(cfg, B, S), meta)
    local = {k: torch.zeros(csh[k].shard_shape(meta[k].shape),
                            dtype=meta[k].dtype, device=DEVICE)
             for k in ("k", "v")}
    lo = csh["k"].local_slices(meta["k"].shape)[2].start or 0
    fill_prefix(local["k"], local["v"], lo)
    torch.cuda.synchronize()
    rec["setup_s"] = time.perf_counter() - t0
    if rank == 0:
        full = models.make_cache(cfg, B, S, device=DEVICE)
        fill_prefix(full["k"], full["v"], 0)
        full["pos"] = SHARDED_POS
        rec["want"] = timed_steps(step, params, full, lambda t: t,
                                  lambda t: t)
        del full

    def place(t, sh):
        if sh is None:
            return t
        return DTensor.from_local(t[sh.local_slices(t.shape)].contiguous(),
                                  mesh, sh.placements, run_check=False,
                                  shape=t.shape, stride=t.stride())

    sharded = tree_map(place, params,
                       tree_shardings(rules, models.param_axes(cfg), params))
    del params
    cache = {k: DTensor.from_local(local[k], mesh, csh[k].placements,
                                   run_check=False, shape=meta[k].shape,
                                   stride=meta[k].stride())
             for k in ("k", "v")}
    cache["pos"] = SHARDED_POS
    torch.cuda.empty_cache()
    tok_sh = rules.sharding_for(("batch", "seq"), (B, 1))
    rec["cache_placements"] = [str(p) for p in cache["k"].placements]
    rec["local_slots"] = [lo, lo + local["k"].shape[2]]
    dist.barrier()
    with activate(rules), implicit_replication():
        rec["got"] = timed_steps(step, sharded, cache,
                                 lambda t: place(t, tok_sh),
                                 lambda t: t.full_tensor())
    rec["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    dist.destroy_process_group()
    print(json.dumps(rec), flush=True)


def run_sharded_phase(smi) -> dict:
    """Phase 15: SHARDED_RANKS processes (``sharded_decode_rank``) on the
    card.  The sharded greedy tokens must equal rank 0's unsharded ones at
    every step, on every rank; K4 must launch once a layer a step in both
    runs.  Returns the launches of both runs, every rank's."""
    torch.cuda.empty_cache()
    print(f"[sharded] this process holds {torch.cuda.memory_reserved() / 2**30:.3f} "
          f"GiB of the card before the ranks start", flush=True)
    port = str(free_port())
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-X", "faulthandler", os.path.abspath(__file__),
         "--sharded-decode-rank",
         str(r), port], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for r in range(SHARDED_RANKS)]
    deadline = time.monotonic() + SHARDED_TIMEOUT
    outs = []
    for proc in procs:
        try:
            outs.append(proc.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            proc.kill()
            outs.append(proc.communicate())
        if proc.returncode != 0:  # the others would wait for it forever
            for p in procs:
                p.kill()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        for r in failed:
            print(f"[sharded] rank {r} exited {procs[r].returncode}:\n"
                  f"{outs[r][0][-2000:]}\n{outs[r][1][-6000:]}", flush=True)
        raise SystemExit(f"[sharded] ranks {failed} failed")
    recs = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    cfg = sharded_config()
    want = recs[0]["want"]
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    print(f"[sharded] {SERVE_ARCH} at full width, {cfg.n_layers} of 32 "
          f"layers in {cfg.dtype}; B={SHARDED_B}, a {SHARDED_SLOTS}-slot "
          f"cache, {SHARDED_STEPS} greedy steps from position {SHARDED_POS} "
          f"through make_serve_step; mesh (1, {SHARDED_RANKS}) over "
          f"{SHARDED_BACKEND}, one card ({smi})", flush=True)
    print(f"[sharded] unsharded: step {med(want['ms']):.3f} ms median "
          f"({min(want['ms']):.3f}-{max(want['ms']):.3f}), K4 "
          f"{want['k4'] / SHARDED_STEPS:.1f} launches a step; tokens "
          f"{want['tokens']}", flush=True)
    launches = {"paged_attention": want["k4"]}
    for rec in recs:
        got = rec["got"]
        print(f"[sharded] rank {rec['rank']}: cache {rec['cache_placements']} "
              f"(slots {rec['local_slots'][0]}-{rec['local_slots'][1]}), "
              f"step {med(got['ms']):.3f} ms median ({min(got['ms']):.3f}-"
              f"{max(got['ms']):.3f}), K4 {got['k4'] / SHARDED_STEPS:.1f} "
              f"launches a step, set-up {rec['setup_s']:.2f} s, peak "
              f"{rec['peak_gib']:.3f} GiB", flush=True)
        if got["tokens"] != want["tokens"]:
            raise SystemExit(f"[sharded] rank {rec['rank']}'s tokens "
                             f"{got['tokens']} differ from the unsharded "
                             f"{want['tokens']}")
        if rec["cache_placements"][1] != "S(2)":
            raise SystemExit("[sharded] the cache's sequence is not sharded")
        if got["k4"] != cfg.n_layers * SHARDED_STEPS \
                or want["k4"] != cfg.n_layers * SHARDED_STEPS:
            raise SystemExit(f"[sharded] K4 launches {got['k4']} / "
                             f"{want['k4']}, expected one a layer a step")
        launches["paged_attention"] += got["k4"]
    print(f"[sharded] the sequence-sharded decode's greedy tokens equal the "
          f"unsharded decode's at all {SHARDED_STEPS} steps on every rank",
          flush=True)
    return launches



# ---------------------------------------------------------------- phase 16
def zootrain_backward(cfg, params, tokens, backward, forward) -> None:
    """Phase 16 (a'): K5 at the arch's training call, gate/up (d -> f) and
    down, E experts of C rows with the routing of the cut's first MoE
    layer on ``tokens``, bf16, keys from ``ZOOTRAIN_K5``: its forward
    (``measure_grouped_routed``), the records joining phase 7's K5
    record's shapes (``forward``), and its backward
    (``measure_backward``), joining phase 12's (dX, dW) ``backward``
    records' shapes."""
    gid, rows = train_tiles(cfg, params, tokens)
    E = cfg.n_experts
    C = gid.numel() * GMM_BT // E
    what = (f"{TRAIN_B} x {TRAIN_S} tokens top-{cfg.top_k}, {cfg.name}'s "
            f"training call")
    label = f"T={E * C} (E={E} x C={C}), {what}, bf16"
    ff = cfg.moe_d_ff or cfg.d_ff
    k = ZOOTRAIN_K5[cfg.name]
    gen = torch.Generator(device=gid.device).manual_seed(76)
    for key, (d, f) in ((k, (cfg.d_model, ff)), (k + "'", (ff, cfg.d_model))):
        forward[key] = measure_grouped_routed(key, gid, rows, E, d, f,
                                              torch.bfloat16, gen, what)
        dx, dw = measure_backward(key, gid, rows, E, d, f, torch.bfloat16,
                                  f"d={d} f={f} " + label)
        backward[0]["shapes"][key] = dx
        backward[1]["shapes"][key] = dw


def sampled_blocks(nb: int) -> torch.Tensor:
    """Phase 16 (c)'s 256-blocks of a leaf of ``nb`` blocks: the first and
    last ``ZOOTRAIN_EDGE`` blocks, as many on each side of every boundary
    of the update's chunks, and every block a stride that takes about
    ``ZOOTRAIN_SAMPLE`` more."""
    per = opt_mod._CHUNK // opt_mod._QBLOCK
    picked = set(range(0, nb, max(1, nb // ZOOTRAIN_SAMPLE)))
    for edge in [0, nb] + list(range(per, nb, per)):
        picked.update(range(max(0, edge - ZOOTRAIN_EDGE),
                            min(nb, edge + ZOOTRAIN_EDGE)))
    return torch.tensor(sorted(picked), dtype=torch.long)


def eightbit_update_check(cut, params, grads, tag) -> None:
    """Phase 16 (c): one ``adamw8bit`` update of the float32 cut on the
    card (from a fresh state, with the card's gradients of (b)) against
    the same update on the CPU, at ``sampled_blocks`` of every leaf (a full
    update of the cut's 3.7 G elements takes the CPU minutes): each leaf's
    blocks and their gradients, scaled by the card's clip factor, make a
    CPU leaf of whole blocks that the CPU's ``adamw8bit`` (clip off)
    updates; every code and scale of those blocks is computed from the
    same 256 values as the card's.  Parameters within ``OPT8_TOL``
    (relative and absolute); m and v codes equal except at most 1 in
    1,000 off by one; scales within ``OPT8_TOL`` relative
    (``tests/test_torch_train.py::_compare_state``'s rule)."""
    t0 = time.perf_counter()
    leaves = tree_leaves(params)
    qb = opt_mod._QBLOCK
    picks = [sampled_blocks(-(-p.numel() // qb)) for p in leaves]

    def blocks(t, pick):  # the picked 256-blocks of a leaf, flat, on the CPU
        flat = t.detach().reshape(-1)
        flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % qb))
        return flat.view(-1, qb)[pick.to(flat.device)].cpu().reshape(-1)

    before = [blocks(p, k) for p, k in zip(leaves, picks)]
    gsub = [blocks(g, k) for g, k in zip(grads, picks)]
    opt = make_optimizer("adamw8bit")
    state = opt.init(params)
    it = iter(grads)
    _, state, metrics = opt.update(tree_map(lambda _: next(it), params),
                                   state, params)
    scale = float(torch.clamp_max(1.0 / torch.clamp_min(
        metrics["grad_norm"], 1e-9), 1.0))
    names = [n for n, _ in iter_named_leaves(params)]
    sub = {n: b.clone() for n, b in zip(names, before)}
    cpu = make_optimizer("adamw8bit", clip_norm=math.inf)
    cstate = cpu.init(sub)
    cpu.update({n: g * scale for n, g in zip(names, gsub)}, cstate, sub)
    card_mu = dict(iter_named_leaves(state["mu"]))
    n_el = sum(int((torch.clamp(p.numel() - k * qb, 0, qb)).sum())
               for p, k in zip(leaves, picks))
    worst, bad, codes_off, codes = 0.0, [], 0, 0
    for name, p, pick in zip(names, leaves, picks):
        got = blocks(p, pick)
        want = sub[name]
        worst = max(worst, float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=OPT8_TOL, atol=OPT8_TOL):
            bad.append(name)
        for key in ("m", "v"):
            q = card_mu[f"{name}.{key}_q"][pick.to(p.device)].cpu()
            off = (q.int() - cstate["mu"][name][f"{key}_q"].int()).abs()
            if int(off.max()) > 1:
                raise SystemExit(f"[{tag}] {name} {key}_q more than one code "
                                 f"from the cpu's")
            codes_off += int((off > 0).sum())
            codes += off.numel()
            sc = card_mu[f"{name}.{key}_s"][pick.to(p.device)].cpu()
            ws = cstate["mu"][name][f"{key}_s"]
            if not torch.allclose(sc, ws, rtol=OPT8_TOL, atol=0):
                raise SystemExit(f"[{tag}] {name} {key}_s differs from the "
                                 f"cpu's")
    print(f"[{tag}] (c) one adamw8bit update of the f32 cut on the card "
          f"against the cpu at {n_el:,} of "
          f"{sum(p.numel() for p in leaves):,} elements ({len(leaves)} "
          f"leaves; every chunk boundary, first and last blocks, a stride): "
          f"parameters max |diff| {worst:.3e} (tolerance {OPT8_TOL} relative "
          f"and absolute); {codes_off} of {codes:,} m/v codes one off (at "
          f"most 1 in 1,000); scales within {OPT8_TOL}; "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if bad or codes_off > codes / 1000:
        raise SystemExit(f"[{tag}] the card's 8-bit update differs from the "
                         f"cpu's")


def cut_learns(cfg, tag) -> None:
    """Phase 16 (a) for ``ZOOTRAIN_STALLS``: ``zoo_cut(cfg)`` (2 layers at
    full width, bf16, its optimizer) from seed-0 weights on the card,
    ``ZOOTRAIN_STEPS`` steps on the phase's batches; every loss and grad
    norm finite, and the first batch's loss after the steps below its
    loss before them."""
    cut = zoo_cut(cfg)
    dev = torch.device(DEVICE)
    params = models.init_params(cut, torch.Generator(device=DEVICE)
                                .manual_seed(0))
    data = TokenPipeline(DataConfig(cut.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batches = [to_device(family_batch(cut, data.next_batch(), seed=160 + i),
                         dev) for i in range(ZOOTRAIN_STEPS)]
    opt = make_optimizer(cut.optimizer)
    loss = models.loss_fn(cut)
    with torch.no_grad():
        before = float(loss(params, batches[0]))
    params, state, run = train_steps(make_train_step(cut, opt), params,
                                     opt.init(params), batches,
                                     f"{tag} 2-layer cut")
    with torch.no_grad():
        after = float(loss(params, batches[0]))
    print(f"[{tag}] its 2-layer cut (bf16, {opt.name}): the first batch's "
          f"loss {before:.6f} before the steps, {after:.6f} after", flush=True)
    if not (all(math.isfinite(v) for v in run["losses"] + run["norms"])
            and after < before):
        raise SystemExit(f"[{tag}] the 2-layer cut did not learn")
    del params, state, batches
    torch.cuda.empty_cache()


def zootrain_model(arch, smi, backward, forward) -> dict:
    """Phase 16 for one arch: ``ZOOTRAIN_STEPS`` steps of
    ``make_train_step`` at the arch's cut (``ZOOTRAIN``), bf16, its own
    optimizer and remat, on ``TokenPipeline(seed=0)`` batches of
    ``TRAIN_B`` x ``TRAIN_S`` (``family_batch``); with experts K5's
    backward at the training call first.  Then (b) the float32 cut's loss
    and gradients against the CPU and, for 8-bit AdamW, (c).  Returns
    the train run's kernel launches."""
    cfg = dataclasses.replace(get_config(arch), **ZOOTRAIN[arch])
    tag = f"zootrain {arch}"
    dev = torch.device(DEVICE)
    params = seeded_on_card(cfg, arch, tag)
    data = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B, seed=0))
    batches = [to_device(family_batch(cfg, data.next_batch(), seed=160 + i),
                         dev) for i in range(ZOOTRAIN_STEPS)]
    if cfg.n_experts:
        zootrain_backward(cfg, params, batches[0]["tokens"], backward,
                          forward)
    opt = make_optimizer(cfg.optimizer)
    step = make_train_step(cfg, opt)
    state = opt.init(params)
    n_params = sum(t.numel() for t in iter_leaves(params))
    params, state, run = train_steps(step, params, state, batches, tag)
    per, later = run["per"], run["later"]
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"[{tag}] {cfg.n_layers} of {get_config(arch).n_layers} layers "
          f"at full width, {n_params / 1e9:.3f} G parameters, bf16, "
          f"{opt.name}, remat={cfg.remat}, {TRAIN_B} x {TRAIN_S} tokens a "
          f"step: step {run['median']:.3f} ms median of steps "
          f"2-{ZOOTRAIN_STEPS} ({later[0]:.3f}-{later[-1]:.3f}), "
          f"{TRAIN_B * TRAIN_S / run['median'] * 1e3:.1f} tokens/s; peak "
          f"memory {run['peak'] / 2**30:.3f} GiB of the card's "
          f"{total / 2**30:.3f}; K5 launches a step: forward "
          f"{per['grouped_matmul']:.1f}, dX {per['grouped_matmul_dx']:.1f}, "
          f"dW {per['grouped_matmul_dw']:.1f}; experts' first moments "
          f"nonzero after step 1: {run['nonzero']} ({smi})", flush=True)
    stalls = arch in ZOOTRAIN_STALLS
    check_train_run(cfg, run, tag, learns=not stalls)
    profile_train(step, params, state, batches[-1], tag)
    time_update(opt, params, state, run["median"], tag)
    del params, state, batches
    torch.cuda.empty_cache()
    if stalls:
        cut_learns(cfg, tag)
    cut, cut_params, grads = train_cpu_check(cfg, tag)
    if cfg.optimizer == "adamw8bit":
        eightbit_update_check(cut, cut_params, grads, tag)
    del cut_params, grads
    torch.cuda.empty_cache()
    return run["launches"]


def run_zootrain_phase(smi, backward, forward) -> dict:
    """Phase 16: the SSM, the hybrid and mixtral with their 8-bit AdamW,
    the VLM and the encoder-decoder trained on the card; K5's backward at
    jamba's and mixtral's training calls joins ``backward``, its forward
    there ``forward`` (phase 7's K5 record's shapes).  Returns the train
    runs' launches."""
    total: dict = {}
    for arch in ZOOTRAIN:
        t0 = time.perf_counter()
        for k, v in zootrain_model(arch, smi, backward, forward).items():
            total[k] = total.get(k, 0) + v
        print(f"[zootrain] {arch} in {time.perf_counter() - t0:.1f}s ({smi})",
              flush=True)
    return total

if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-decode-rank"]:
        sharded_decode_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
