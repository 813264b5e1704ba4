#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # every phase, as a check run does
    python3 chip_smoke.py --phases 1      # kernels against plain versions only
    python3 chip_smoke.py --phases 3 --profile   # + where a decode step's time goes
    python3 chip_smoke.py --phases 4      # the GEMM super-kernel path only
    python3 chip_smoke.py --phases 4 --profile   # + where a GEMM dispatch's time goes (K1, K2)
    python3 chip_smoke.py --phases 5      # the RWKV-6 serving path only
    python3 chip_smoke.py --phases 5 --profile   # + where an RWKV decode step's time goes
    python3 chip_smoke.py --phases 6      # paligemma-3b, then musicgen, qwen2, granite, gemma3
    python3 chip_smoke.py --phases 6 --profile   # + where a paligemma decode step's time goes
    python3 chip_smoke.py --phases 7      # granite-moe, zamba2 and llama4-maverick
    python3 chip_smoke.py --phases 7 --profile   # + where their merged decode steps' time goes
    python3 chip_smoke.py --phases 8      # a live fleet of two stablelm-1.6b engines
    python3 chip_smoke.py --phases 9      # the front door: python -m repro_torch, LiveRun, HTTP
    python3 chip_smoke.py --phases 10     # training: K4 and K5 backward kernels, train()
    python3 chip_smoke.py --phases 10 --profile  # + where a full-width train step's time goes
    python3 chip_smoke.py --phases 11     # the dry run and build_step's programs on the card
    python3 chip_smoke.py --phases 12     # the example scripts of repro_torch/examples

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch/``), then:

  1. holds every kernel against its plain PyTorch version on the card, in
     float32 and bfloat16, at the shapes of the serving path and at the
     edges of K4's tiles (K4 also with ``q_offset`` read from a device
     buffer, as a captured prefill piece launches it: n queries at start 0,
     mid-block, on block edges and with start + n = 2048 against a whole
     cache of 2048 keys, against its plain version and bitwise against the
     host-int launch, after its two controls, a stale offset buffer and an
     offset off by one, were caught), and times the kernel, the plain
     version and ``scaled_dot_product_attention`` (the library yardstick,
     which the port never calls); an attention softcap must give the plain
     version's output with no kernel launch (the op's rule, as the
     reference's);
  2. builds stablelm-1.6b at full width (bf16, seeded random weights) and
     compares the kernel path's logits with the plain path's over a
     777-token prefill and 8 decode steps;
  3. serves 16 requests for four full-width stablelm-1.6b tenants through
     ``MultiTenantEngine`` in ``space_time`` and ``time_only`` mode, with
     every kernel's launch counter read around the run;
  4. drives the paper's GEMM super-kernel path: (a) holds K1
     ``batched_gemm`` and K2 ``grouped_gemm`` against their plain versions
     in float32 and bfloat16 and times them beside ``torch.bmm`` and the
     previous kernel; (b) runs
     Table 1, the four strategies over the paper's SGEMM shapes and R
     sweep; (c) drives ``DynamicSpaceTimeScheduler`` with bare
     ``GemmProblem``s on two stochastic streams (the ablation trace, and a
     ragged merge at stablelm-1.6b's MLP width), checks every result, and
     reads the launch counters around each run. Phase 4 runs with
     ``CUDA_DEVICE_MAX_CONNECTIONS=32``, so that space_only's 32 streams
     get 32 hardware queues; after other phases, which keep CUDA's
     default, it runs in a child process of its own;
  5. drives the RWKV-6 serving path: (a) holds K5 ``wkv6_scan`` (its
     chunked kernel) against its plain version in float32 and bfloat16,
     from a zero and a random state, whole and split in two, under strong
     and weak decay, and times it at a median prompt beside its first,
     sequential kernel (checked, then timed as ``prior_ms``); holds the
     state pass K5-state ``wkv6_state`` (bf16 and float32 k, v with
     float32 w) against its plain version likewise and at head sizes 8-64
     with N != V, and at the serving run's median prompt prints ``ok`` only
     after its three controls (w rounded to bf16, T - 1 steps, the incoming
     state dropped) fail the same check, then times it in turns with its
     prior (the chunked K5 with float32 w, the second launch a bf16
     prefill made before it) beside its plain version and its bound; (b)
     builds rwkv6-1.6b at full width (seeded random weights, decay made
     data-dependent) and compares the kernel path's logits with the plain
     path's over a 777-token prefill, whole and chunked (512 + 265), and
     8 decode steps: in float32 directly, in bf16 each against the float32
     plain path; (c) serves 16 requests for four rwkv6-1.6b tenants (bf16)
     in ``space_time`` and ``time_only`` mode, with the launch counters
     read around the run: in each mode one chunked K5 and one segmented
     K5-state launch per layer and prefill (``rwkv.prefill_launches``), no
     K5 launch with float32 w; with ``--profile``, K5's and K5-state's
     shares of a prefill;
  6. drives paligemma-3b (head dim 256, 8 query heads on one kv head, a
     stub SigLIP frontend): (a) at full width (bf16, seeded random weights,
     18 layers), the kernel path's logits against the plain path's over a
     prefill of 256 seeded patch embeddings (1152 wide) and 521 tokens,
     then 8 decode steps; (b) serves the 16 requests of phase 3 for four
     paligemma-3b tenants in both modes (text only, as the reference's
     engine), every K4 launch wgmma, 18 per prefill, every K3 launch
     mma; (c) holds musicgen-large (a 64-frame prefix), qwen2-7b and
     granite-3-8b at full width and 2 layers, and gemma3-27b at full width
     and 6 layers (one global), kernel path against plain path over a
     prefill and 4 decode steps;
  7. drives the last three architectures: (a) granite-moe-1b-a400m (24
     layers of attention + MoE, top-8 of 32 experts with per-sequence
     capacity) and zamba2-7b (all 81 layers: 68 Mamba2 layers and one
     shared attention block of head dim 112 applied at 13 positions) at
     full width, kernel path against plain path over a whole prefill, a
     chunked one (512 + 265) and 8 decode steps, in float32 (within
     MODEL_RTOL) and in bf16 (phase 5b's scheme: each held against the
     float32 plain path), zamba2's chunked prefill also against its whole
     one; then llama4-maverick at full width and 2 of 48 layers (a dense
     layer and an MoE layer of all 128 experts and the shared expert, 37.1
     GB in bf16), kernel path against plain path; (b) serves the 16
     requests of phase 3 for four granite-moe tenants (10.7 GB) and four
     zamba2 tenants (45.9 GB, 8.2 GB of caches) in both modes, with their
     kernels rows. Before (a), zamba2's Mamba2 mixer: SSD-scan (its
     tensor-core kernel, ``mma``) against its plain version at the graphed
     prefill's pieces (1-512 tokens) from a
     seeded state and at whole prompts (742, 777) from zero, in three decay
     regimes, SSD-step over 3 successive steps merged (R 4 x B 4) and for
     one tenant (R 1), float32 and bf16, two launches the same bits, the
     controls that must fail (SSD-scan's three: a zeroed state, B and C
     swapped, the chunk chain cut; SSD-step's two); (a)'s plain path runs their plain
     versions, and P8 holds a 6-layer zamba2 prefill bitwise under
     ``cudnn.allow_tf32`` True against False; (b) counts SSD-scan once per
     Mamba2 layer (68) per prefill piece (and per eager whole prompt) and
     SSD-step once per Mamba2 layer per decode pass, no plain call;
  8. measures ``HardwareSpec``'s two launch terms (the host time of an empty
     launch, and what a synchronize after it adds), then serves a live
     fleet: two replicas, each a ``MultiTenantEngine`` over the same four
     full-width stablelm-1.6b tenants (one 13.15 GB stacked weight set, 2
     slots a tenant, cache 2048), behind ``LiveFleet`` on the wall clock
     (least_cost routing over a ``FleetCalibrator``, a ``FlightRecorder``,
     a roofline prior over the "h100" spec). A seeded Poisson trace of 48
     requests over the four tenants at 16 requests/s (prompts of 128-1024
     tokens, 8 new tokens each) is submitted at its instants through
     ``LiveFleet.submit_one``, once with the engines in ``space_time`` and
     once in ``time_only``. It fails unless every admitted request returns
     8 tokens inside the vocabulary, both replicas dispatched, the
     recorder's dispatches equal the pumps' and the exported Chrome trace's,
     the calibrator holds measured seconds for every dispatched key, and
     every K3 launch took split_kv and every K4 launch wgmma. It prints a
     ``fleet`` line, and K3 and K4 rows at the fleet's shapes;
  9. drives the front door through ``repro_torch.api.cli.main`` in process,
     with the launch counters read around each step: (a) ``python -m
     repro_torch specs`` in a subprocess that cannot import jax, and
     ``check`` on every committed spec with the hardware overrides
     (``--set cost_model.hardware=h100``; hetero_fleet's card list too);
     (b) ``simulate --check`` (a same-seed byte-identical rerun) of
     paper_mix and partitioned_fleet on the H100, and the resolved knee
     plan; (c) ``calibrate`` on the card, every K1 launch ``simt``, then a
     calibrated sim replaying the table; (d) live stablelm-1.6b and
     rwkv6-1.6b smoke specs (float32, as the reference builds them; K3 and
     K4 at D = 64, K5 at N = V = 32 padded to 64), each run twice, the
     second starting from the fleet calibration the first saved, and a sim
     replaying it; (e) the ``LiveRun`` flow over two replicas of four
     full-width bf16 stablelm-1.6b tenants (the engine factory replaced
     here by phase 8's), 24 Poisson requests at 16/s, its report held to
     the CLI's live checks; (f) ``launch/serve.run_server`` in a thread
     over serve_smoke.json (arch=fake) and over a live stablelm-1.6b smoke
     spec on the card, 8 concurrent predicts each, /healthz, /v1/report and
     a clean shutdown (invariants only). It prints a ``front_door`` line
     and K1, K3, K4 and K5 rows at its paths' shapes;
 10. drives the training path (``training/*``, ``Model.forward_train``),
     whose attention layers run K4 forward and K4's backward kernel and
     whose RWKV-6 layers K5 forward and K5's backward kernel, through the
     ops' autograd route: (a) K4's backward kernels (``bwd_variant``'s,
     wgmma for bf16 at D 64-256, and the prior cuda_core kernel) against
     ``ref.attention_bwd`` and autograd through ``ref.attention``, in
     float32 and bf16, at stablelm's training shape, GQA at q_per_kv 2 and
     8 (D 256), D 112 and 32, a sliding window and S off the tiles, the
     wgmma forward's ``lse`` against ``ref.attention_lse``, a second launch
     giving the same bits, the new kernel timed in turns with the prior
     beside the plain version and SDPA's backward; (b) K5's backward kernels
     (cluster, from the chunk states the forward writes into its ``ckpt``,
     held against ``ref.wkv6_chunk_states``, and the prior chunked kernel)
     against ``ref.wkv6_scan_bwd`` and autograd through ``ref.wkv6_scan``
     under strong and weak decay, T off the chunks and N = V = 32 padded,
     timed likewise beside the plain version; (c) stablelm-1.6b and rwkv6-1.6b at
     full width cut to 2 layers: loss and every parameter's gradient,
     kernel path against ``plain_kernels=True``, in float32 and (each
     against the float32 plain path) bf16; (d) ``train()`` on both at full
     width and depth in bf16 (4 x 1024 and 4 x 512 tokens, 20 steps,
     remat "block"), its step a CUDA graph (``training.graphs``: one eager
     step, one capture, replays), a checkpoint saved after the last step and
     restored leaf for leaf; it fails unless the step ran graphed, every
     loss and grad norm is finite, the last loss is below the first, the
     forward kernel launched 2 x layers x steps times and the backward
     kernel (wgmma, cluster) layers x steps times, replays counted, and no
     op made a plain call; (e) on both, at full width and depth in bf16, a
     graphed ``TrainProgram`` and an eager one from the same params over
     the same batches for 8 steps: every step's loss, grad norm and lr and
     then every param, moment and the step counter must be bitwise equal,
     and a replay must launch one step's forward and backward kernels; the
     host wall of steady steps on both routes, the device time of replays
     back to back (CUDA events), the idle shares, kernels a step (the
     profiler), the capture's seconds and pool against the eager step's
     peak memory; two controls, each from equal states, must fail the same
     check: replays over an unstaged batch, and a program that does not
     write its step counter back; (f) the AdamW kernels (``kernels/adamw.py``:
     the global norm, then every leaf's update in one pass) on an edge tree
     and on stablelm-1.6b's and rwkv6-1.6b's full-width trees, with seeded
     gradients where the clip binds and where it does not: the update kernel
     given the plain step's scale, bias corrections and lr bitwise equal to
     the plain update, the norm kernel within ``adamw.norm_rtol`` of a
     float64 sum and bitwise equal to itself over two launches, whether a
     whole kernel step is bitwise equal to a plain step recorded; three
     controls must fail those checks (bc1 and bc2 swapped, the last leaf's
     last element left out, the largest leaf left out of the norm); both
     kernels timed on each tree beside the plain versions and their bounds.
     In (d) and (e) the AdamW kernels must launch once each a step, and a
     gradient made contiguous for them is named. ``--profile`` adds the
     AdamW kernels' device ms a step. It prints a ``train`` line, a
     ``train_graphs`` line, an ``adamw`` line and the backward and AdamW
     kernels' rows;
 11. runs ``launch.steps.build_step``'s programs on the card at full width
     and depth in bf16, the assigned shapes' batch cut to fit (train_4k 4 x
     4096, microbatch 1 and 4, stablelm-1.6b and rwkv6-1.6b; prefill_32k 1 x
     32768, both; decode_32k 4 sequences of stablelm-1.6b against caches of
     32768; the merged decode of 4 stablelm-1.6b tenants, one sequence
     each): each step's meta arguments must be the bytes the card holds
     for them, each kernel's launches by variant those of the program (the
     train steps' AdamW kernels once each a call; no plain call), and its
     time and peak memory are printed beside the meta
     run's temporaries; the eager decode step at 32768 is profiled once
     (its kernel share of the wall, K3's time); K3, K4, K5, K5-state and
     both backward kernels are held against their plain versions at
     these shapes, a slice of (batch, head) at 32768; K3 at the decode
     step's (4, 32, 32, 32768, 64), and K5 and K5-state at rwkv6's 32 heads
     x 32768 steps, are timed beside their bounds (K3 beside SDPA; the
     ``long_context`` rows of the phase's line); in float32 at full
     width and 2 layers, microbatch 4 must equal microbatch 1 at the
     reference's tolerances and the merged 4-tenant decode each tenant's own
     step, and each negative control (half the batch left out; two tenants'
     weights swapped) must fail that check. Meanwhile three niced children
     with jax and repro unimportable run ``python -m
     repro_torch.launch.dryrun --all --mesh host``, one pod1 record (its
     arguments must be the sum of ``shard_shape`` over its specs) and the
     dry-run records of the steps above. The phase must end within 90 s. It
     prints a ``dryrun_steps`` line;
 12. runs the port's example scripts (``repro_torch/examples``):
     ``train_small`` (300 steps of a 4-layer stablelm variant in float32,
     graphed: K4 cuda_core 2 x 4 x 300 launches, its backward 4 x 300, each
     AdamW kernel 300, the loss falling), ``multi_tenant_serving`` (4 tenants, 16 requests of 12
     tokens, every one served; K4 in the prefills, K3 once per layer and
     decode pass, the decode step graphed) and ``spacetime_ablation`` (K1
     simt once per dispatch) in process at the reference's sizes, with no
     plain call; then each as ``python -m repro_torch.examples.<name>`` in
     a child that cannot import jax (``train_small`` for 30 steps), and
     ``quickstart``, ``policy_sweep``
     and ``fleet_routing`` as niced children at 2000 events; every child
     must exit 0. It prints an ``examples`` line.

K5 takes its chunked kernel for every shape (``wkv6_scan.variant``), on heads
zero-padded to N = V = 64 below that (``wkv6_scan.padded_dims``); K5-state
its segmented kernel over ``wkv6_state.segments(BH, T)`` CTAs a head. K1, K2
and K4 each have a kernel for the tensor cores, picked by dtype and shape
before the launch (``batched_gemm.variant``, ``grouped_gemm.variant``,
``flash_attention.variant``): wgmma with TMA for bf16; otherwise K1's
register-tiled ``simt`` kernel (K split across a cluster) and K2's and K4's
CUDA-core kernels; K4's wgmma kernel lays bf16 D = 112 out as 128 columns,
the last 16 TMA's zeros. K3 picks by ``decode_attention.variant(dtype, D,
q_per_kv)``: ``mma`` (the tensor cores' mma.sync, the group's query heads
the n = 8 columns) for bf16 at D = 256 and at D = 128 from q_per_kv 5,
``split_kv`` (CUDA-core dot products) for every other shape; in both the live prefix of each
(sequence, kv head) is split across a thread-block cluster (up to 16 CTAs
for mma, by ``mma_splits(B * Hkv, S)``) and combined on chip; one launch
takes up to 8 query heads per kv head, and a larger ratio runs as one
launch per head group of 8. K3 and K4 take head dims 32, 64, 112, 128 and
256; bf16 at head dim 32 takes K4's CUDA-core kernel.
Phase 1 checks K3 at its tile and split edges, at q_per_kv 1 to 8 and at 12
and 16 (two launches a call), at every head dim (mma at D = 256 and 128 at
q_per_kv 1, 7 and 8, at 16 and 8 splits), and that two launches give the same bits;
each new kernel's negative controls run before its checks and must be
caught (K4 at D = 112 with K's, then V's, columns 96-111 zeroed; K3's mma
with ``lengths - 1`` and with each group's query heads rolled by one, each
against the plain version on the true inputs); it holds mma against the
plain version at every registered architecture's decode shape and times it
beside split_kv there in turns (the ``k3_rule`` line); K5 at the reference kernel tests' head sizes (16, 16), (16,
32), (8, 8) and at (32, 32) over a median prompt, from a zero and a random
state, whole and split in two in one buffer (``final_state is
init_state``); K3 and K4 at D = 32 (MQA, suffix queries, a stale cache
beyond ``lengths``), each timed beside SDPA and its bound; phase 4a checks K1 at its row-tile, K and N edges and that a
problem's output is bit-identical whatever the others hold, on both of its
kernels. Launch checks count attention layers, not layers (zamba2: 13 of
81; its Mamba2 layers launch no kernel). Phases 3, 6b and 7b fail unless
every K4 launch on the serving path took the variant the wrapper's rule
gives (wgmma for all five), once per attention layer per prefill, and
every K3 launch the rule's (mma for paligemma, split_kv for the other four),
once per attention layer per decode pass of the model;
phases 2, 6a, 6c and 7a unless K4 and K3 launched once per attention layer
per prefill (or chunk) and decode step, by the wrapper's rule; phase 4c
unless every K1 launch of scheduler run 1 took simt and every K1 and K2
launch of run 2 wgmma; phase 5c unless every K5 launch took chunked and every
K5-state launch segmented. Every
row of the ``kernels`` line carries the ``variant``, the ``shape`` it was
timed at, its launches by variant, and ``prior_ms``: the previous kernel's
time at the same inputs (K1: its first, CUDA-core kernel; K2, K4: the
CUDA-core variant; K3: split_kv where the rule takes mma, else its first,
single-pass kernel, null at D = 112, where it has no instance; K5: its first, sequential
kernel; K5-state: the chunked K5 with float32 w, the launch it replaces;
SSD-scan: its first, CUDA-core kernel, whose rows also carry both terms of
its bound, the operations at the CUDA cores' rate beside them, and the
kernel's ratio to each), launched explicitly. Kernel times are device times of back-to-back
launches queued behind a sleep kernel, so the host's launch cost does not pace
them. The build prints ptxas's report for every kernel, the dynamic shared
memory of the wgmma kernels, K3's ring and K5's chunked kernel, and how many
of K3's clusters fit on the card at once. Each phase prints its wall time.

Every engine decodes through CUDA graphs, by the engine's rule on the card
(``repro_torch.serving.graphs``): each decode step (the merged one, or each
tenant's) runs eagerly once, is then captured and replayed from the next
step on; phases 3, 5c, 6b and 7b fail unless every program of the main path
ran eagerly exactly once and replayed from then on. Engines of the
architectures that take pieces (``serving.engine.takes_pieces``: stablelm,
rwkv6, paligemma and zamba2 here; granite-moe's MoE capacity keeps whole
prompts) prefill by pieces of fixed lengths (``prefill_pieces``), each a
program captured when the engine is built (one per tenant and piece size,
44 at cache 2048): the phases fail unless each was captured exactly once
at build and the run replayed one a piece, and count K4, K5 and K5-state
launches once per layer and piece. Their kernels rows add K4 at a piece of
the median prompt against the whole cache, its offset on the card. After each of them, the
model is served again by an eager engine (``graphs=False``) and a graphed
one in lockstep, in both modes, over the same weights, prompts and slots:
the logits of a steady step (bitwise), every cache after 8 steps (K/V,
RWKV's state and token shifts, Mamba2's state and conv tails; bitwise),
every request's 32 greedy tokens and the kernels' launches by variant must
be equal, and replays = decode passes - eager passes; before the first
decode step every prompt's prefill, installed into its slot, must give the
same first token and bitwise the same caches on both engines (the eager one
prefills by the same pieces, eagerly); the graphed pieces' logits and
caches must lie within MODEL_RTOL of the whole prompt's eager prefill, and
the prefill controls, each from zeroed caches, must fail the bitwise check:
pieces replayed over a start buffer left unstaged (models with attention),
and a prompt whose recurrent state was not zeroed (RWKV, Mamba2). Two negative controls
each run in a short round from zeroed caches, the engines shown equal just
before: replays over token and length buffers left unstaged must fail the
logit check, and a step decoded twice (for a model with recurrent state) or
not at all (attention only: writing K/V twice at one position changes
nothing) must fail the cache check. Each mode's wall per step of both
engines, the device time of a step's graphs replayed back to back (CUDA
events), both idle shares, the capture seconds and the bytes the captures
reserved go into a ``graphs`` JSON line, the engines' prefill programs
(route, captures, capture seconds, pool bytes, replays, build seconds,
prefill p50, decode tokens/s) into a ``prefills`` line. ``--profile``
profiles the graphed and the eager engine and says whether the profiler saw
every kernel inside the graphs, and one prefill of the median prompt whole,
as pieces run eagerly and as pieces replayed (wall, kernel time, idle share).

Prints a ``prefills`` JSON line (phases 3, 5, 6, 7), a ``fleet`` JSON line
(phase 8), a ``front_door`` JSON line (phase 9), a ``train``, a ``train_graphs`` and an
``adamw`` JSON line (phase 10), a ``dryrun_steps``
JSON line (phase 11), an ``examples`` JSON line (phase 12), a
``graphs`` JSON line (phases 3, 5, 6, 7), a ``k3_rule`` JSON line (phase 1),
a ``kernels`` JSON line (with phase 11's launches by variant on the rows of
the kernels it runs), the card's
name and power limit, and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, if
there is no CUDA card, if the port cannot be imported, or if any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12,    # dense bf16 tensor cores
              "torch.float32": 67e12,      # float32 outside the tensor cores
              "tf32": 495e12}              # dense TF32 tensor cores
# f32: the JAX kernel tests' own tolerance; only the order of float32 sums
# differs between kernel and plain version.
# bf16: both compute in float32 from the same bf16 inputs, then round the
# output to bf16 (8 mantissa bits, relative step 2^-8 = 3.9e-3); a sum-order
# difference can flip that rounding, so allow a few steps.
TOL = {"torch.float32": (2e-5, 2e-4), "torch.bfloat16": (2e-2, 2e-2)}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:113",
    "flash_attention": "src/repro/kernels/flash_attention.py:150",
    "wkv6_scan": "src/repro/kernels/wkv6_scan.py:84",
    # no Pallas kernel: the reference's jnp lax.scan _wkv_final_state
    "wkv6_state": "src/repro/models/rwkv.py:188",
    # no Pallas kernel: the reference's jnp adamw_update, fused by XLA
    "adamw": "src/repro/training/optimizer.py:41",
    # no Pallas kernel: the reference's jnp ssd_scan and mamba2_decode
    "ssd_scan": "src/repro/models/ssm.py:93",
    "ssd_step": "src/repro/models/ssm.py:257",
}
ATTENTION_KERNELS = ("decode_attention", "flash_attention")  # phases 3 and 6's path
SSD_KERNELS = ("ssd_scan", "ssd_step")  # zamba2's Mamba2 layers, phase 7
EXTRA_HEAD_DIMS = (112, 256)  # zamba2-7b's and paligemma-3b's head dims


SLEEP_CYCLES_PER_CALL = 400_000  # ~0.2 ms at the H100's ~2 GHz


class PhaseFailed(Exception):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 2, sleep_cycles: int = SLEEP_CYCLES_PER_CALL) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by
    CUDA events. The calls are queued behind a sleep kernel long enough for
    the host to enqueue them all (``sleep_cycles`` a call, ~0.2 ms by
    default), so the events time the card's work and not the host's launch
    cost, which paces a kernel of a few tens of microseconds otherwise."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, want, dtype_key: str, tol=None) -> float:
    """Max |got - want|; raises PhaseFailed outside (rtol, atol), which
    default to TOL[dtype_key]."""
    import torch

    rtol, atol = tol or TOL[dtype_key]
    got32, want32 = got.float(), want.float()
    if not torch.isfinite(got32).all():
        raise PhaseFailed(f"{name}: kernel output has non-finite values")
    err = (got32 - want32).abs()
    max_err = float(err.max())
    bad = int((err > atol + rtol * want32.abs()).sum())
    verdict = "ok" if bad == 0 else f"FAIL ({bad} elements out of tolerance)"
    log(f"  {name}: max_abs_err={max_err:.3e} (rtol={rtol}, atol={atol}) {verdict}")
    if bad:
        raise PhaseFailed(f"{name}: {bad} elements out of tolerance")
    return max_err


# ----------------------------------------------------------------- bounds
def flash_work(B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, dtype):
    """(bytes, flops) the attention function needs for these inputs."""
    q_pos = np.arange(Sq)[:, None] + q_offset
    kv_pos = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= q_pos >= kv_pos
    if window > 0:
        vis &= (q_pos - kv_pos) < window
    pairs = int(vis.sum())
    esize = 2 if "bfloat16" in dtype else 4
    nbytes = esize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    return nbytes, 4 * B * Hq * D * pairs


def decode_work(B, Hq, Hkv, S, D, lengths, dtype):
    esize = 2 if "bfloat16" in dtype else 4
    total = int(np.minimum(np.asarray(lengths), S).sum())
    nbytes = esize * (2 * B * Hq * D + 2 * total * Hkv * D) + 4 * B
    return nbytes, 4 * total * Hq * D


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- library yardsticks
def sdpa_flash(q, k, v, causal, window, q_offset):
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[2], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    plain_causal = causal and window == 0 and q_offset == 0 and Sq == Skv
    g = q.shape[1] // k.shape[1]
    if g > 1:  # one call per function: GQA expanded once, outside the timing
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    if plain_causal:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_decode(q, kc, vc, lengths):
    import torch
    import torch.nn.functional as F

    S = kc.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    g = q.shape[1] // kc.shape[1]
    if g > 1:
        kc, vc = kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)


# ----------------------------------------------------------------- phase 1
def check_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window, q_offset=None,
                causal=True):
    """K4 against its plain version on one case; returns (inputs, keywords,
    max error)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    qo = Skv - Sq if q_offset is None else q_offset
    kw = dict(causal=causal, window=window, q_offset=qo)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    name = (f"flash_attention {str(dtype)[6:]} {(B, Hq, Hkv, Sq, Skv, D)} window={window} "
            f"q_offset={qo}{'' if causal else ' non-causal'} [{fa.variant(dtype, D)}]")
    return (q, k, v), kw, check_close(name, got, want, str(dtype))


def measure_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window, q_offset=None,
                  iters=20, prior=False):
    """K4 checked and timed beside its plain version and SDPA; with
    ``prior``, the CUDA-core variant too (checked, then timed as
    ``prior_ms``), launched explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    (q, k, v), kw, err = check_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window,
                                     q_offset)
    nbytes, flops = flash_work(B, Hq, Hkv, Sq, Skv, D, True, window, kw["q_offset"], str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "variant": fa.variant(dtype, D),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters),
        "plain_ms": time_ms(lambda: ops.flash_attention_plain(q, k, v, **kw), 3, 1),
        "library_ms": time_ms(sdpa_flash(q, k, v, True, window, kw["q_offset"]), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if prior:
        check_close("  its CUDA-core variant", fa.flash_attention(q, k, v, kernel="cuda_core", **kw),
                    ops.flash_attention_plain(q, k, v, **kw), str(dtype))
        row["prior_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, kernel="cuda_core", **kw),
                                  iters)
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" prior_ms={row['prior_ms']:.4f} (CUDA cores)" if prior else ""))
    return row


def measure_flash_piece(ops, dev, gen, Hq, Hkv, D, n, start, iters=20):
    """K4 as a captured prefill piece launches it (bf16, n queries at
    ``start`` against the whole cache, the offset read on the card),
    checked as in phase 1 and timed beside its plain version, SDPA (one
    call over the keys the piece sees) and its CUDA-core variant; the bound
    counts the keys the piece reads, start + n of them."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    dtype = torch.bfloat16
    (q, k, v), offset, err = check_flash_device_offset(ops, dev, gen, dtype, Hq, Hkv, D, n, start)
    seen = start + n
    nbytes, flops = flash_work(1, Hq, Hkv, n, seen, D, True, 0, start, str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    kw = dict(causal=True, q_offset=offset)
    row = {
        "variant": fa.variant(dtype, D), "max_abs_err": err,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters),
        "plain_ms": time_ms(lambda: ops.flash_attention_plain(q, k, v, causal=True,
                                                              q_offset=start), 3, 1),
        "library_ms": time_ms(sdpa_flash(q, k[:, :, :seen].contiguous(),
                                         v[:, :, :seen].contiguous(), True, 0, start), iters),
        "prior_ms": time_ms(lambda: fa.flash_attention(q, k, v, kernel="cuda_core", **kw), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) prior_ms={row['prior_ms']:.4f} (CUDA cores)")
    return row


def decode_inputs(gen, dev, dtype, B, Hq, Hkv, S, D, lengths):
    import torch

    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    return q, kc, vc, torch.as_tensor(np.asarray(lengths, np.int32), device=dev)


def k3_kinds(dtype, D, Hq, Hkv, kernel=None):
    """The kernel of each launch of one K3 call (one per head group):
    ``kernel``, or the wrapper's rule at each group's size; none for a
    model without attention (Hq = 0)."""
    from repro_torch.kernels import decode_attention as da

    if not Hq:
        return []
    if kernel is not None:
        return [kernel] * len(da.head_groups(Hq // Hkv))
    return da.launch_variants(dtype, D, Hq // Hkv)


def k3_variant(dtype, D, Hq, Hkv, kernel=None):
    """The kernels of one K3 call as a row's ``variant``: one name, or
    names joined by '+' where head groups take different ones."""
    return "+".join(dict.fromkeys(k3_kinds(dtype, D, Hq, Hkv, kernel)))


def k3_splits(dtype, B, Hq, Hkv, S, D, kernel=None):
    """CTAs per (sequence, kv head) of a K3 call's first launch."""
    from repro_torch.kernels import decode_attention as da

    return da.launch_splits(k3_kinds(dtype, D, Hq, Hkv, kernel)[0], B * Hkv, S)


def check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, kernel=None):
    """K3 against its plain version on one case, and against itself: a
    second launch on the same inputs must give the same bits. ``kernel``
    forces a variant (launched through the wrapper); otherwise the op's
    rule picks. Returns (inputs, max error)."""
    import torch

    from repro_torch.kernels import decode_attention as da

    q, kc, vc, lens = decode_inputs(gen, dev, dtype, B, Hq, Hkv, S, D, lengths)
    if kernel is None:
        run = lambda: ops.decode_attention(q, kc, vc, lens)  # noqa: E731
    else:
        run = lambda: da.decode_attention(q, kc, vc, lens, kernel=kernel)  # noqa: E731
    got = run()
    again = run()
    want = ops.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    shown = lengths if len(lengths) <= 8 else f"min={min(lengths)} max={max(lengths)}"
    name = (f"decode_attention {str(dtype)[6:]} {(B, Hq, Hkv, S, D)} lengths {shown} "
            f"[{k3_variant(dtype, D, Hq, Hkv, kernel)}, "
            f"{k3_splits(dtype, B, Hq, Hkv, S, D, kernel)} splits]")
    err = check_close(name, got, want, str(dtype))
    if not torch.equal(got, again):
        raise PhaseFailed(f"{name}: two launches on the same inputs differ")
    return (q, kc, vc, lens), err


def check_decode_groups(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths):
    """K3 at a GQA ratio above one launch's 8 query heads per kv head:
    ``check_decode``'s checks, and one launch per head group a call."""
    from repro_torch.kernels import decode_attention as da

    c = ops.COUNTERS["decode_attention"]
    before = c.launches
    check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths)  # two calls
    groups = da.head_groups(Hq // Hkv)
    per_call = (c.launches - before) / 2
    log(f"    q_per_kv {Hq // Hkv}: {per_call:g} launches a call over head groups {groups}")
    if per_call != len(groups):
        raise PhaseFailed(f"decode_attention at q_per_kv {Hq // Hkv}: {per_call:g} launches a "
                          f"call, not {len(groups)}")


def measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, iters=20, prior=None):
    """K3 checked and timed beside its plain version and SDPA; with
    ``prior`` (a kernel name: "single_pass", K3's first kernel, or
    "split_kv", the one mma replaced), that kernel too (checked, then timed
    as ``prior_ms``), launched explicitly on the same inputs."""
    from repro_torch.kernels import decode_attention as da

    (q, kc, vc, lens), err = check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths)
    nbytes, flops = decode_work(B, Hq, Hkv, S, D, lengths, str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "variant": k3_variant(dtype, D, Hq, Hkv),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), iters),
        "plain_ms": time_ms(lambda: ops.decode_attention_plain(q, kc, vc, lens), 3, 1),
        "library_ms": time_ms(sdpa_decode(q, kc, vc, lens), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if prior:
        before = lambda: da.decode_attention(q, kc, vc, lens, kernel=prior)  # noqa: E731
        check_close(f"  its prior, {prior}", before(), ops.decode_attention_plain(q, kc, vc, lens),
                    str(dtype))
        row["prior_ms"] = time_ms(before, iters)
        row["prior_variant"] = prior
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" prior_ms={row['prior_ms']:.4f} ({prior})" if prior else ""))
    return row


def k3_prior(dtype, D, Hq, Hkv):
    """The kernel that ran before at a K3 shape: split_kv where the rule now
    takes mma, else the first, single-pass kernel where it has an instance
    (D 64 and 128), else none."""
    from repro_torch.kernels import decode_attention as da

    if "mma" in k3_kinds(dtype, D, Hq, Hkv):
        return "split_kv"
    return "single_pass" if D in da.SINGLE_PASS_HEAD_DIMS else None


def decode_edge_lengths(S, B, n_splits=None):
    """B lengths at K3's tile and split edges for a cache of S: 0, 1, 63, 64,
    65, either side of the first rank boundary of a full cache over
    ``n_splits`` ranks (split_kv's ``splits(S)`` by default), S - 1, S."""
    from repro_torch.kernels import decode_attention as da

    edge = da.key_ranges(S, n_splits or da.splits(S))[0][1]
    lens = [0, 1, 63, 64, 65, edge - 1, edge, edge + 1, S - 1, S]
    return (lens * (-(-B // len(lens))))[:B]


def must_fail(what, check):
    """A negative control: ``check()`` must raise PhaseFailed; raises
    PhaseFailed when it does not."""
    try:
        check()
    except PhaseFailed as e:
        log(f"    control, {what}: caught ({e})")
        return
    raise PhaseFailed(f"control, {what}: not caught, so its check cannot fail")


def flash_controls(ops, dev, gen, D=112):
    """K4's wgmma kernel at a padded head dim: K with columns 96 up to D
    zeroed, and V likewise, each against the plain version on the true
    inputs, must fail ``check_close``: the last columns of a padded row
    count in S and in O."""
    import torch

    bf = torch.bfloat16
    q = torch.randn((1, 8, 777, D), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((1, 1, 777, D), generator=gen, device=dev).to(bf) for _ in range(2))
    want = ops.flash_attention_plain(q, k, v)
    for name, (kk, vv) in (("k", (k.clone(), v)), ("v", (k, v.clone()))):
        (kk if name == "k" else vv)[..., 96:D] = 0
        got = ops.flash_attention(q, kk, vv)
        torch.cuda.synchronize()
        must_fail(f"flash_attention bf16 (1, 8, 1, 777, 777, {D}) with {name}'s columns 96-{D - 1} "
                  "zeroed, against the plain version on the whole rows",
                  lambda: check_close("    (control)", got, want, "torch.bfloat16"))


# K4 with q_offset read from a device buffer, as a captured prefill piece
# launches it: n queries at absolute positions start..start+n-1 against a
# whole cache of CACHE_LEN keys. Offsets: 0, mid-block, block edges, and
# start + n == CACHE_LEN.
DEVICE_OFFSET_CASES = ((64, 0), (100, 37), (64, 64), (128, 512), (1, 1000), (512, 1024),
                       (64, 1984), (1024, 1024))


def check_flash_device_offset(ops, dev, gen, dtype, Hq, Hkv, D, n, start, Skv=None):
    """K4 with ``q_offset`` a 0-dim int64 on the card against the plain
    version at the host offset ``start``, and bitwise against the host-int
    launch on the same inputs. Returns (inputs, the offset buffer, max
    error)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    Skv = Skv or CACHE_LEN
    q = torch.randn((1, Hq, n, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((1, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((1, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    offset = torch.full((), start, dtype=torch.int64, device=dev)
    got = ops.flash_attention(q, k, v, causal=True, q_offset=offset)
    host = ops.flash_attention(q, k, v, causal=True, q_offset=start)
    want = ops.flash_attention_plain(q, k, v, causal=True, q_offset=start)
    torch.cuda.synchronize()
    name = (f"flash_attention {str(dtype)[6:]} {(1, Hq, Hkv, n, Skv, D)} q_offset={start} "
            f"from a device buffer [{fa.variant(dtype, D)}]")
    err = check_close(name, got, want, str(dtype))
    if not torch.equal(got, host):
        raise PhaseFailed(f"{name}: not bitwise equal to the host-int launch (max gap "
                          f"{float((got.float() - host.float()).abs().max()):.3e})")
    return (q, k, v), offset, err


def device_offset_controls(ops, dev, gen, dtype, Hq, Hkv, D):
    """The device offset's two controls, each against the plain version at
    the true offset, must fail ``check_close``: the buffer left at the
    previous piece's start (stale: 0 where the piece starts at 512), and
    the offset off by one (1 where the piece starts at 0: each row sees one
    key more)."""
    import torch

    for what, n, start, read in (("stale offset buffer (the previous piece's 0)", 128, 512, 0),
                                 ("offset off by one (1 for 0)", 64, 0, 1)):
        q = torch.randn((1, Hq, n, D), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((1, Hkv, CACHE_LEN, D), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        offset = torch.full((), read, dtype=torch.int64, device=dev)
        got = ops.flash_attention(q, k, v, causal=True, q_offset=offset)
        want = ops.flash_attention_plain(q, k, v, causal=True, q_offset=start)
        torch.cuda.synchronize()
        must_fail(f"flash_attention {str(dtype)[6:]} D={D} at start {start} with the {what}, "
                  "against the plain version at the true start",
                  lambda: check_close("    (control)", got, want, str(dtype)))


def phase_device_offsets(ops, dev, gen):
    """K4 with its offset on the card, both variants (wgmma: bf16 D 64,
    112, 128, 256; cuda_core: float32 D 64 and bf16 D 32), the controls
    first."""
    import torch

    for dtype, D, Hq, Hkv in ((torch.bfloat16, 64, 32, 32), (torch.bfloat16, 112, 32, 32),
                              (torch.bfloat16, 128, 28, 4), (torch.bfloat16, 256, 8, 1),
                              (torch.float32, 64, 32, 32), (torch.bfloat16, 32, 8, 1)):
        device_offset_controls(ops, dev, gen, dtype, Hq, Hkv, D)
        for n, start in DEVICE_OFFSET_CASES:
            check_flash_device_offset(ops, dev, gen, dtype, Hq, Hkv, D, n, start)


def decode_controls(ops, dev, gen, B, Hq, Hkv, S, D, kernel):
    """A K3 kernel's two controls, bf16 at edge lengths: the kernel on
    ``lengths - 1`` (the split and tile edges), and on q with each group's
    query heads rolled by one (the head-to-column mapping), each against the
    plain version on the true inputs, must fail ``check_close``."""
    import torch

    from repro_torch.kernels import decode_attention as da

    bf = torch.bfloat16
    n_splits = k3_splits(bf, B, Hq, Hkv, S, D, kernel)
    q, kc, vc, lens = decode_inputs(gen, dev, bf, B, Hq, Hkv, S, D,
                                    decode_edge_lengths(S, B, n_splits))
    want = ops.decode_attention_plain(q, kc, vc, lens)
    G = Hq // Hkv
    rolled = q.view(B, Hkv, G, D).roll(1, dims=2).reshape(B, Hq, D).contiguous()
    cases = [("lengths - 1", q, (lens - 1).clamp(min=0))]
    if G > 1:
        cases.append(("query heads rolled by one in each group", rolled, lens))
    for what, qq, ll in cases:
        got = da.decode_attention(qq, kc, vc, ll, kernel=kernel)
        torch.cuda.synchronize()
        must_fail(f"decode_attention [{kernel}, {n_splits} splits] bf16 {(B, Hq, Hkv, S, D)} "
                  f"with {what}, against the plain version",
                  lambda: check_close("    (control)", got, want, "torch.bfloat16"))


def check_softcap(ops, dev, gen):
    """An attention softcap goes to the plain version by the op's rule (as
    the reference's op sends it to its jnp path): the output equals the
    plain version's and no kernel launches."""
    import torch

    q, k, v = (torch.randn((1, 8, 300, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    c = ops.COUNTERS["flash_attention"]
    launches, plain = c.launches, c.plain_calls
    got = ops.flash_attention(q, k, v, logit_softcap=30.0)
    want = ops.flash_attention_plain(q, k, v, logit_softcap=30.0)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    log(f"  flash_attention bf16 (1, 8, 8, 300, 300, 64) logit_softcap=30.0 [route "
        f"{ops.flash_attention_route(True, 30.0)}]: equal to the plain version {same}, kernel "
        f"launches {c.launches - launches}, plain calls {c.plain_calls - plain}")
    if not same or c.launches != launches or c.plain_calls != plain + 2:
        raise PhaseFailed("flash_attention with a softcap: not the plain version's result, or "
                          "a kernel launched")


# K3's rule, measured: each registered architecture's decode shape (bf16, the
# cache of the serving phases, mid-generation lengths of prompts of 128-1024)
# at the merged step's 16 sequences and one tenant's 4.
K3_SURVEY_B = (16, 4)
K3_SURVEY = {}  # (arch, B) -> {kernel: ms}, printed in the ``k3_rule`` line


def survey_k3(ops, dev, gen, seed):
    """The mma kernel held against the plain version at every registered
    architecture's (Hq, Hkv, D), bf16, where its instances reach, then timed
    beside split_kv on the same inputs (split_kv, mma, mma, split_kv); logs
    which is faster beside the kernel ``variant``'s rule picks."""
    import torch

    from repro_torch.config import get_config, list_configs
    from repro_torch.kernels import decode_attention as da

    rng = np.random.RandomState(seed + 7)
    bf = torch.bfloat16
    seen = set()
    for arch in list_configs():
        cfg = get_config(arch)
        shape = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        if not cfg.num_heads or shape in seen or cfg.head_dim not in da.MMA_HEAD_DIMS:
            continue
        seen.add(shape)
        Hq, Hkv, D = shape
        for B in K3_SURVEY_B:
            lengths = [int(n) for n in rng.randint(128, 1025, size=B) + MAX_NEW // 2]
            (q, kc, vc, lens), _ = check_decode(ops, dev, gen, bf, B, Hq, Hkv, CACHE_LEN, D,
                                                lengths, kernel="mma")
            runs = {k: (lambda k=k: da.decode_attention(q, kc, vc, lens, kernel=k))
                    for k in ("split_kv", "mma")}
            ms = {k: [] for k in runs}
            for k in ("split_kv", "mma", "mma", "split_kv"):
                ms[k].append(time_ms(runs[k], 20))
            best = {k: min(v) for k, v in ms.items()}
            rule = k3_variant(bf, D, Hq, Hkv)
            faster = min(best, key=best.get)
            K3_SURVEY[f"{arch} B={B}"] = {"shape": [B, Hq, Hkv, CACHE_LEN, D], "ms": ms,
                                          "rule": rule, "faster": faster}
            log(f"    {arch} (B, Hq, Hkv, S, D)={(B, Hq, Hkv, CACHE_LEN, D)}: split_kv "
                f"{ms['split_kv'][0]:.4f}/{ms['split_kv'][1]:.4f} ms, mma {ms['mma'][0]:.4f}/"
                f"{ms['mma'][1]:.4f} ms ({da.mma_splits(B * Hkv, CACHE_LEN)} splits); faster "
                f"{faster}, the rule takes {rule}")


def phase_kernels(ops, dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.RandomState(seed)
    check_softcap(ops, dev, gen)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (777, 1024):
            for window in (0, 512):
                measure_flash(ops, dev, gen, dtype, 1, 32, 32, S, S, 64, window)
        measure_flash(ops, dev, gen, dtype, 1, 28, 4, 777, 777, 128, 0)
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0)           # suffix
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0, q_offset=512)  # chunk
        for (B, Hq, Hkv, S, D) in ((16, 32, 32, 2048, 64), (16, 28, 4, 2048, 128)):
            lengths = [1, 2048] + list(rng.randint(1, 2049, size=B - 2))
            measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, prior="single_pass")
        # the other GQA ratios the kernels take (q_per_kv 2, 4, 8), both head
        # dims, a ragged sequence length and a length-0 decode row
        for g in (2, 4, 8):
            for D in (64, 128):
                measure_flash(ops, dev, gen, dtype, 2, 4 * g, 4, 300, 300, D, 64, iters=3)
                measure_decode(ops, dev, gen, dtype, 4, 4 * g, 4, 600, D, [0, 1, 333, 600],
                               iters=3)
        # K3's split and tile edges: lengths 0, 1, 63-65, either side of a rank
        # boundary, S - 1 and S, at every q_per_kv of 1, 2, 4, 7 and 8 (bf16 D
        # 128 at 7 and 8 takes mma, at 8 splits here)
        for S in (777, 2048):
            for g in (1, 2, 4, 7, 8):
                for D in (64, 128):
                    check_decode(ops, dev, gen, dtype, 10, 2 * g, 2, S, D, decode_edge_lengths(
                        S, 10, k3_splits(dtype, 10, 2 * g, 2, S, D)))
        # the mma kernel at D 128, where its rule takes q_per_kv 5 to 8: its
        # controls first, then its edges at q_per_kv 1, 7 and 8 on one and two
        # kv heads (16 and 8 splits), asked for by name
        if dtype == torch.bfloat16:
            decode_controls(ops, dev, gen, 10, 7, 1, 2048, 128, "mma")
            for S in (777, 2048):
                for g in (1, 7, 8):
                    for Hkv in (1, 2):
                        n_splits = k3_splits(dtype, 10, g * Hkv, Hkv, S, 128, "mma")
                        check_decode(ops, dev, gen, dtype, 10, g * Hkv, Hkv, S, 128,
                                     decode_edge_lengths(S, 10, n_splits), kernel="mma")
        # q_per_kv 12 and 16, more query heads per kv head than one launch
        # takes: the wrapper launches over two head groups a call
        for g in (12, 16):
            for S in (777, 2048):
                check_decode_groups(ops, dev, gen, dtype, 10, 2 * g, 2, S, 128,
                                    decode_edge_lengths(S, 10))
        # edges of the 64-row, 64-key tiles: lengths off the tile, fewer keys
        # than a tile, one query, runtime offsets with a window, GQA 7,
        # queries placed before every key, and no causal mask
        for D in (64, 128):
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 40, 40, D, 0)
            check_flash(ops, dev, gen, dtype, 2, 8, 4, 100, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 2, 100, 300, D, 48, q_offset=150)
            check_flash(ops, dev, gen, dtype, 1, 28, 4, 300, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 8, 1, 777, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 4, 2, 70, 130, D, 0, q_offset=-20)
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 200, 200, D, 0, causal=False)
        # head dims 112 (zamba2-7b) and 256 (paligemma-3b): K3 at its tile and
        # split edges at q_per_kv 1, 7 and 8, on one and on two kv heads (bf16
        # D 256 takes mma: 16 and 8 splits at these rows); K4 with lengths off
        # the 64-row and 64-key tiles, a window, runtime offsets and no causal
        # mask (bf16 D 112 takes wgmma over a padded row). Each new kernel's
        # negative controls run first: no check below prints ok unless they
        # were caught.
        if dtype == torch.bfloat16:
            flash_controls(ops, dev, gen, 112)
            phase_device_offsets(ops, dev, gen)
            for Hkv in (1, 2):
                decode_controls(ops, dev, gen, 10, 8 * Hkv, Hkv, 2048, 256, "mma")
        for D in EXTRA_HEAD_DIMS:
            for S in (777, 2048):
                for g in (1, 7, 8):
                    for Hkv in (1, 2):
                        n_splits = k3_splits(dtype, 10, g * Hkv, Hkv, S, D)
                        check_decode(ops, dev, gen, dtype, 10, g * Hkv, Hkv, S, D,
                                     decode_edge_lengths(S, 10, n_splits))
            check_decode_groups(ops, dev, gen, dtype, 10, 12, 1, 777, D,
                                decode_edge_lengths(777, 10, k3_splits(dtype, 10, 8, 1, 777, D)))
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 777, 777, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 2, 2, 130, 130, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 777, 777, D, 512)
            check_flash(ops, dev, gen, dtype, 2, 8, 1, 100, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 100, 300, D, 48, q_offset=150)
            check_flash(ops, dev, gen, dtype, 1, 4, 2, 70, 130, D, 0, q_offset=-20)
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 200, 200, D, 0, causal=False)
            check_flash(ops, dev, gen, dtype, 1, 4, 1, 1, 1000, D, 0)
    survey_k3(ops, dev, gen, seed)
    phase_head_sizes(ops, dev, seed)


# The head sizes of P6: K5 at the reference kernel tests' (BH, T, N, V) and
# at the smoke variants' N = V = 32 over a median prompt; K3 and K4 at the
# reference attention tests' D = 32.
WKV_P6_CASES = ((2, 64, 16, 16), (4, 70, 16, 32), (1, 33, 8, 8), (32, 742, 32, 32))
WKV_SMOKE_CASE = (32, 742, 32, 32)


def wkv_case_inputs(gen, dev, dtype, BH, T, N, V):
    """r, k, v ~ 0.5 N(0, 1) (BH, T, N or V), decay logits w ~ N(-3, 1), u
    (BH, N) ~ 0.3 N(0, 1): ``wkv_inputs``' scales at any head size."""
    import torch

    def draw(width, scale, shift=0.0):
        t = torch.randn((BH, T, width), generator=gen, device=dev) * scale + shift
        return t.to(dtype)

    r, k = draw(N, 0.5), draw(N, 0.5)
    v, w = draw(V, 0.5), draw(N, 1.0, -3.0)
    return r, k, v, w, torch.randn((BH, N), generator=gen, device=dev) * 0.3


def wkv_case_work(BH, T, N, V, dtype):
    """(bytes, float32 flops) of one scan of BH heads of (N, V), unpadded:
    r, k, w, v read and out written once, u, the initial state read and the
    final state written once; ~5 N V flops per head per step (o: r S and
    the bonus, S: decay S + k v)."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    nbytes = BH * T * (3 * N + 2 * V) * esize + 4 * BH * N + 2 * 4 * BH * N * V
    return nbytes, 5 * N * V * BH * T


def check_wkv_case(ops, gen, dev, dtype, BH, T, N, V):
    """K5 at one (BH, T, N, V) against its plain version, from a zero and a
    random state, whole and split in two with the state carried in one
    buffer that is both ``init_state`` and ``final_state``. Returns the
    inputs and the whole scan's error from the random state."""
    import torch

    from repro_torch.kernels import wkv6_scan as wk

    tag = f"wkv6_scan {str(dtype)[6:]} (BH, T, N, V)={(BH, T, N, V)} [padded to " \
          f"{wk.padded_dims(N, V)}]"
    inputs = wkv_case_inputs(gen, dev, dtype, BH, T, N, V)
    check_wkv(ops, f"{tag} zero state", dtype, inputs, None)
    s0 = torch.randn((BH, N, V), generator=gen, device=dev)
    err, whole, whole_state = check_wkv(ops, f"{tag} random state", dtype, inputs, s0)
    buf = s0.clone()
    cut = T // 2
    parts = []
    for a, b in ((0, cut), (cut, T)):
        out, state = ops.wkv6_scan(*(t[:, a:b] for t in inputs[:4]), inputs[4],
                                   init_state=buf, final_state=buf)
        if state is not buf:
            raise PhaseFailed(f"{tag}: the final state is not the caller's buffer")
        parts.append(out)
    torch.cuda.synchronize()
    # the split moves the chunk boundaries, so float32 sums differ in order:
    # check_wkv's tolerances (bf16 outputs may flip one rounding step)
    check_close(f"{tag} {cut} + {T - cut} from the carried state vs whole, out",
                torch.cat(parts, dim=1), whole, str(dtype),
                WKV_TOL if dtype == torch.float32 else None)
    check_close(f"{tag} {cut} + {T - cut} vs whole, final state", buf, whole_state,
                "torch.float32", WKV_TOL)
    return inputs, s0, err


def phase_head_sizes(ops, dev, seed):
    """P6's shapes on the card, each against its plain version in float32
    and bf16: K5 at WKV_P6_CASES (timed at the smoke variant's head size
    beside its bound), K3 at (1, 8, 1, 96, 32) and (1, 2, 1, 64, 32) with a
    stale cache beyond ``lengths`` (bit-identical outputs), K4 at (1, 8, 1,
    96, 32) causal and windowed and at suffix queries (32 over 96), K3 and
    K4 timed beside SDPA and their bounds."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 32)
    for dtype in (torch.float32, torch.bfloat16):
        for case in WKV_P6_CASES:
            inputs, s0, err = check_wkv_case(ops, gen, dev, dtype, *case)
            if case != WKV_SMOKE_CASE:
                continue
            state = s0.clone()
            nbytes, flops = wkv_case_work(*case, dtype)
            bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
            ms = time_ms(lambda: ops.wkv6_scan(*inputs, init_state=state, final_state=state), 20)
            plain_ms = time_ms(lambda: ops.wkv6_scan_plain(*inputs, init_state=state,
                                                           final_state=state), 3, 1)
            log(f"    ms={ms:.4f} plain_ms={plain_ms:.4f} library: none bound_ms={bound_ms:.4f} "
                f"({bound_by}) kernel/bound={ms / bound_ms:.1f} (padding copies included)")
        for B, Hq, Hkv, S, lengths in ((1, 8, 1, 96, [96]), (1, 8, 1, 96, [50]),
                                       (1, 2, 1, 64, [20])):
            (q, kc, vc, lens), _ = check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, 32, lengths)
            kc2, vc2 = kc.clone(), vc.clone()
            kc2[:, :, lengths[0]:], vc2[:, :, lengths[0]:] = 99.0, -99.0
            stale = [ops.decode_attention(q, a, b, lens) for a, b in ((kc, vc), (kc2, vc2))]
            torch.cuda.synchronize()
            same = bool(torch.equal(*stale))
            log(f"    stale cache beyond length {lengths[0]}: bit-identical output {same}")
            if not same:
                raise PhaseFailed(f"decode_attention D=32 {(B, Hq, Hkv, S)}: the cache beyond "
                                  "lengths changed the output")
            measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, 32, lengths, iters=20)
        for window in (0, 32):
            measure_flash(ops, dev, gen, dtype, 1, 8, 1, 96, 96, 32, window)
        measure_flash(ops, dev, gen, dtype, 1, 2, 2, 32, 96, 32, 0)  # suffix queries


# ----------------------------------------------------------------- phase 2
# bf16 logits: both paths round each attention output to bf16 at the same
# place, but a float32 sum-order difference can land it one bf16 step
# (2^-8 relative) apart, and 24 residual layers carry such steps forward.
# Allow 5% of the largest logit; a wrong kernel (a wrong mask, head or
# position) moves logits by O(1) of it.
MODEL_RTOL = 5e-2
PROMPT_LEN = 777
DECODE_STEPS = 8
CACHE_LEN = 2048


def compare_logits(what, got, want):
    """Kernel-path logits against plain-path logits: within MODEL_RTOL of
    the largest |logit|; whether the argmax agrees is printed."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise PhaseFailed(f"model {what}: shape {tuple(got.shape)} or non-finite logits")
    err = float((got - want).abs().max())
    lim = MODEL_RTOL * float(want.abs().max())
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"  {what}: max_abs_err={err:.4f} limit={lim:.4f} (5% of max |logit|) "
        f"argmax_agree={agree} {'ok' if err <= lim else 'FAIL'}")
    if err > lim:
        raise PhaseFailed(f"model {what}: kernel path and plain path disagree")


def attention_layers(cfg) -> int:
    """Layers that run K4 in a prefill and K3 in a decode step: every block
    kind with attention (zamba2: its 13 shared-attention positions of 81;
    its Mamba2 layers run no kernel)."""
    from repro_torch.models.transformer import ATTENTION_BLOCKS

    return sum(k in ATTENTION_BLOCKS for k in cfg.layer_pattern)


def tree_params(params) -> int:
    """Parameters the model holds, counted from its tree (zamba2's
    ``cfg.param_count()`` counts per-head B/C projections it does not hold)."""
    from repro_torch.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def model_vs_plain(ops, cfg, dev, seed, prompt_len, decode_steps):
    """``cfg`` at full width (its dtype, seeded random weights): the kernel
    path's logits against the plain path's on the same weights, over a
    prefill of ``prompt_len`` tokens (for a stub frontend, seeded prefix
    embeddings take the first P positions) and ``decode_steps`` greedy
    decode steps. Fails unless K4 launched once per attention layer in the
    prefill and K3 once per attention layer per decode step, every launch
    the variant the wrapper's rule gives at the config's head dim."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    plain = build_model(cfg, device=dev, plain_kernels=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    nparams = tree_params(params)
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, prompt_len)), device=dev)
    prefix, what = None, f"prefill {prompt_len} tokens"
    if cfg.num_prefix_embeddings:
        P, width = cfg.num_prefix_embeddings, cfg.frontend_embed_dim or cfg.d_model
        prefix = torch.as_tensor(rng.standard_normal((1, P, width)).astype(np.float32),
                                 device=dev)
        what = f"prefill {P} prefix embeddings ({width} wide) + {prompt_len - P} tokens"
    log(f"  {cfg.name} {cfg.dtype}: {nparams / 1e9:.3f}B params, {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
    ops.reset_counters()
    with torch.no_grad():
        lk, ck = model.forward_prefill(params, tokens, CACHE_LEN, prefix_embeds=prefix)
        lp, cp = plain.forward_prefill(params, tokens, CACHE_LEN, prefix_embeds=prefix)
        compare_logits(f"{cfg.name} {what}", lk, lp)
        lengths = torch.tensor([prompt_len], device=dev)
        for step in range(decode_steps):
            tok = lk.argmax(-1)  # both paths decode the same token
            lk, ck = model.forward_decode(params, tok, ck, lengths)
            lp, cp = plain.forward_decode(params, tok, cp, lengths)
            compare_logits(f"{cfg.name} decode step {step}", lk, lp)
            lengths = lengths + 1
    torch.cuda.synchronize()
    dtype, n_attn = model.dtype, attention_layers(cfg)
    k3_want = {}
    for kind in k3_kinds(dtype, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads):
        k3_want[kind] = k3_want.get(kind, 0) + n_attn * decode_steps
    for name, want in (("flash_attention", {fa.variant(dtype, cfg.head_dim): n_attn}),
                       ("decode_attention", k3_want)):
        by_variant = dict(ops.COUNTERS[name].variants)
        if by_variant != want:
            raise PhaseFailed(f"{cfg.name}: {name} launches {by_variant}, not {want}")
    log(f"    kernel launches: flash_attention {n_attn} {fa.variant(dtype, cfg.head_dim)}, "
        f"decode_attention {k3_want} (D={cfg.head_dim}, {n_attn} attention layers); "
        f"{time.perf_counter() - t0:.1f} s")
    del params, ck, cp
    torch.cuda.empty_cache()


def phase_model(ops, dev, seed):
    from repro_torch.config import get_config

    model_vs_plain(ops, get_config("stablelm-1.6b"), dev, seed, PROMPT_LEN, DECODE_STEPS)


# ----------------------------------------------------------------- phase 3
R_TENANTS = 4
SLOTS = 4
REQUESTS = 16
MAX_NEW = 32
PREFILL_REPORT = {}  # model -> mode -> the prefill route's numbers, in the ``prefills`` line


def prefill_pieces(S, chunk, cache_len):
    from repro_torch.serving.engine import prefill_pieces as rule

    return rule(S, chunk, cache_len)


def piece_sizes(chunk, cache_len):
    from repro_torch.serving.engine import piece_sizes as rule

    return rule(chunk, cache_len)


def takes_pieces(cfg):
    from repro_torch.serving.engine import takes_pieces as rule

    return rule(cfg)


def prefills_run(cfg, prompts):
    """The forward passes a model's serving engine (graphed, so on the piece
    route where the architecture takes it) runs to prefill ``prompts``: one
    per piece, or one per prompt."""
    if not takes_pieces(cfg):
        return len(prompts)
    return sum(len(prefill_pieces(len(p), 0, CACHE_LEN)) for _, p in prompts)


def run_engine(model, stacked, mode, prompts, ops, kernels):
    """Serve ``prompts`` in ``mode`` (decode steps as CUDA graphs, by the
    engine's rule on the card); every kernel in ``kernels`` must launch.
    Returns (greedy tokens by request id, requests, launches in this run,
    the model's decode passes: one per merged step in space_time, one per
    tenant per step in time_only). A pass is an eager run or a replay of a
    step program (``MultiTenantEngine.programs.stats()``): it fails unless each
    program ran eagerly exactly once (its first step) and replayed from
    then on, and unless the model's decode was called once per eager pass
    and once per capture (a replay runs no Python). On the piece route
    (``serving.engine.prefill_route``) the engine captures its prefill
    programs when it is built: it fails unless each (tenant, piece size)
    was captured exactly once, after one eager warm-up a size, and the run
    replayed one program a piece (``prefill_pieces``) and captured none."""
    import torch

    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    t_build = time.perf_counter()
    eng = MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
        num_tenants=R_TENANTS, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t_build
    built = eng.programs.stats()
    reqs = [InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW) for t, p in prompts]
    calls = [0]
    decode = model.forward_decode_tenants  # forward_decode runs through it too

    def counted(*args, **kwargs):
        calls[0] += 1
        return decode(*args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: c.launches for k, c in ops.COUNTERS.items()}
    model.forward_decode_tenants = counted
    try:
        with torch.no_grad():
            for r in reqs:
                eng.submit(r)
            t0 = time.perf_counter()
            first = eng.step()  # admits (prefills) every request, then one decode step
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        del model.forward_decode_tenants
    launches = {k: c.launches - before[k] for k, c in ops.COUNTERS.items()}
    rep = eng.report()
    stats = eng.programs.stats()
    done = [r for r in reqs if len(r.generated) == MAX_NEW]
    decode_tps = (eng.decode_tokens - first) / (t2 - t1)
    log(f"  {mode}: {len(eng.finished)}/{REQUESTS} finished, {len(done)} with {MAX_NEW} tokens; "
        f"steps={int(rep['steps'])} wall={t2 - t0:.3f}s")
    log(f"    decode tokens/s={decode_tps:.1f} decode p50={rep['p50_s'] * 1e3:.3f}ms "
        f"p95={rep['p95_s'] * 1e3:.3f}ms spread={rep['spread']:.4f} "
        f"prefill p50={rep['prefill_p50_s'] * 1e3:.3f}ms "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"    launches: " + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" over {eng.steps} steps")
    log(f"    decode programs ({'CUDA graphs' if stats['graphed'] else 'eager'}): "
        f"{stats['programs']} programs, {stats['decode_passes']} passes = "
        f"{stats['eager_passes']} eager + {stats['replays']} replays, {stats['captures']} "
        f"captures in {stats['capture_s']:.3f} s, {stats['pool_bytes'] / 2**20:.1f} MiB reserved "
        f"by the captures; the model's decode called {calls[0]} times")
    if eng.prefill_route == "pieces":
        pieces = sum(len(prefill_pieces(len(p), 0, CACHE_LEN)) for _, p in prompts)
        log(f"    prefill programs (pieces, {'CUDA graphs' if stats['graphed'] else 'eager'}): "
            f"{stats['prefill_programs']} programs, {stats['prefill_warm_ups']} warm-ups and "
            f"{built['prefill_captures']} captures at build in {t_build:.3f} s (captures "
            f"{stats['prefill_capture_s']:.3f} s, {stats['prefill_pool_bytes'] / 2**20:.1f} MiB "
            f"reserved); serving: {stats['prefill_replays']} replays for {pieces} pieces of "
            f"{len(prompts)} prompts, {stats['prefill_captures'] - built['prefill_captures']} "
            "captures")
        if not stats["graphed"] or built["prefill_captures"] != built["prefill_programs"] \
                or stats["prefill_captures"] != built["prefill_captures"] \
                or built["prefill_replays"] or stats["prefill_replays"] != pieces \
                or stats["prefill_eager_passes"] \
                or stats["prefill_warm_ups"] != len(piece_sizes(0, CACHE_LEN)):
            raise PhaseFailed(f"{mode}: prefill programs are not one capture each at build and "
                              f"one replay a piece: built {built}, after {stats}, {pieces} pieces")
    else:
        log(f"    prefills: whole prompts, eager ({model.cfg.name}: "
            f"{'pieces' if takes_pieces(model.cfg) else 'MoE or ring cache, no pieces'}); engine "
            f"built in {t_build:.3f} s")
    if len(eng.finished) != REQUESTS or len(done) != REQUESTS:
        raise PhaseFailed(f"{mode}: not every request finished with {MAX_NEW} tokens")
    for k in kernels:
        if launches[k] <= 0:
            raise PhaseFailed(f"{mode}: kernel {k} was never launched on the serving path")
    if not stats["graphed"] or stats["eager_passes"] != stats["programs"] \
            or stats["captures"] != stats["programs"] \
            or stats["replays"] != stats["decode_passes"] - stats["eager_passes"] \
            or calls[0] != stats["eager_passes"] + stats["captures"]:
        raise PhaseFailed(f"{mode}: decode steps are not one eager pass and replays per "
                          f"program: {stats}, {calls[0]} decode calls")
    tokens = {r.request_id: list(r.generated) for r in reqs}
    PREFILL_REPORT.setdefault(model.cfg.name, {})[mode] = {
        "route": eng.prefill_route, "engine_build_s": t_build,
        "prefill_p50_ms": rep["prefill_p50_s"] * 1e3, "decode_tokens_per_s": decode_tps,
        **{k: v for k, v in stats.items() if k.startswith("prefill_")}}
    del eng
    return tokens, reqs, launches, stats["decode_passes"]


def phase_serving(dev, seed, ops, arch, profile=False, flash_variant="wgmma"):
    """Phases 3, 6b and 7b: R_TENANTS tenants of ``arch`` served in both
    modes; returns (config, launches over both modes, per mode, prompt
    lengths). Fails unless every K4 launch took ``flash_variant``, once per
    attention layer per prefill in each mode, and every K3 launch the
    wrapper's rule at the model's (dtype, D, q_per_kv) (split_kv; mma for
    paligemma-3b), once per attention layer per decode pass of the model."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed)
    seq_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        model.init_caches(1, CACHE_LEN)))
    log(f"  caches: {seq_bytes / 1e6:.1f} MB a sequence at {CACHE_LEN} positions, "
        f"{R_TENANTS * SLOTS * seq_bytes / 1e9:.2f} GB for {R_TENANTS * SLOTS} slots")
    torch.cuda.empty_cache()
    prompts, lens = serve_prompts(cfg, seed)
    n_mamba = mamba_layers(cfg)
    kernels = ATTENTION_KERNELS + (SSD_KERNELS if n_mamba else ())
    launches, per_mode, passes = serve_both_modes(model, stacked, prompts, ops, kernels)
    k3_want = k3_variant(model.dtype, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads)
    for name, want in (("flash_attention", flash_variant), ("decode_attention", k3_want)):
        by_variant = dict(ops.COUNTERS[name].variants)
        log(f"  {name} launches by variant on the serving path (D={cfg.head_dim}): {by_variant}")
        if by_variant.get(want, 0) != launches[name]:
            raise PhaseFailed(f"{name}: {launches[name]} launches on the serving path, not all "
                              f"{want}: {by_variant}")
    n_attn = attention_layers(cfg)
    prefills = prefills_run(cfg, prompts)  # one a piece on the piece route
    for mode, per, n in zip(("space_time", "time_only"), per_mode, passes):
        if per["flash_attention"] != n_attn * prefills:
            raise PhaseFailed(f"{mode}: flash_attention launched {per['flash_attention']} times, "
                              f"not {n_attn} per prefill piece ({prefills})")
        if per["decode_attention"] != n_attn * n:
            raise PhaseFailed(f"{mode}: decode_attention launched {per['decode_attention']} "
                              f"times in {n} decode passes, not {n_attn} per pass")
    log(f"  launches per mode: flash_attention {n_attn} attention layers x {prefills} prefill "
        f"passes ({'pieces' if takes_pieces(cfg) else 'whole prompts'} of {REQUESTS} prompts); "
        f"decode_attention {n_attn} x {passes[0]} merged passes (space_time), x {passes[1]} "
        "per-tenant passes (time_only)")
    if n_mamba:
        ssd_serving_checks(ops, n_mamba, prefills, launches, per_mode, passes)
    graph_checks(ops, cfg, model, stacked, prompts)
    if profile:
        profile_serving(model, stacked, prompts)
        profile_prefill(model, stacked, prompts)
    return cfg, launches, per_mode, lens


def ssd_serving_checks(ops, n_mamba, prefills, launches, per_mode, passes):
    """SSD-scan once per Mamba2 layer per prefill pass (a piece on the graph
    route) and SSD-step once per Mamba2 layer per decode pass (merged in
    space_time, a tenant's in time_only), in each mode, every launch its
    kernel's one variant (plain calls: none, checked by serve_both_modes)."""
    from repro_torch.kernels import ssd

    for mode, per, n in zip(("space_time", "time_only"), per_mode, passes):
        if per["ssd_scan"] != n_mamba * prefills or per["ssd_step"] != n_mamba * n:
            raise PhaseFailed(f"{mode}: ssd_scan launched {per['ssd_scan']} times and ssd_step "
                              f"{per['ssd_step']}, not {n_mamba} per prefill pass ({prefills}) "
                              f"and per decode pass ({n})")
    for name, variant in (("ssd_scan", ssd.SCAN_VARIANT), ("ssd_step", ssd.STEP_VARIANT)):
        by_variant = dict(ops.COUNTERS[name].variants)
        if by_variant != {variant: launches[name]}:
            raise PhaseFailed(f"{name}: {launches[name]} launches on the serving path, not all "
                              f"{variant}: {by_variant}")
    log(f"  launches per mode: ssd_scan {n_mamba} Mamba2 layers x {prefills} prefill passes, "
        f"ssd_step {n_mamba} x {passes[0]} merged passes (space_time), x {passes[1]} per-tenant "
        f"passes (time_only); by variant: ssd_scan {dict(ops.COUNTERS['ssd_scan'].variants)}, "
        f"ssd_step {dict(ops.COUNTERS['ssd_step'].variants)}")


def stacked_tenants(model, dev, seed, init=None):
    """R_TENANTS tenants' seeded random weights, stacked; ``init(params,
    gen)`` (if given) runs on the stack after ``Model.init_stacked``."""
    import torch

    from repro_torch.core.tenancy import tenant_bytes

    gens = []
    for t in range(R_TENANTS):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1 + t)
        gens.append(g)
    stacked = model.init_stacked(gens)
    if init is not None:
        init(stacked, gens[0])
    wbytes = tenant_bytes(stacked)
    log(f"  {R_TENANTS} tenants stacked: {wbytes / 1e9:.2f} GB of weights; merged decode "
        f"step weight-bytes bound {wbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    return stacked


def serve_prompts(cfg, seed, n=None):
    """``n`` (default REQUESTS) (tenant, prompt) pairs, prompts of 128-1024
    random tokens, tenants in turn."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=REQUESTS if n is None else n)
    prompts = [(i % R_TENANTS, rng.randint(1, cfg.vocab_size, size=int(n)).tolist())
               for i, n in enumerate(lens)]
    log(f"  prompts: lengths {sorted(int(x) for x in lens)}")
    return prompts, [int(x) for x in lens]


def serve_both_modes(model, stacked, prompts, ops, kernels):
    """The serving path's main run: counters zeroed just before, both modes,
    counters read just after. Returns (launches over both, per mode, the
    model's decode passes per mode)."""
    import torch

    ops.reset_counters()  # the main path starts here
    tok_st, reqs_st, per_st, passes_st = run_engine(model, stacked, "space_time", prompts, ops,
                                                    kernels)
    torch.cuda.empty_cache()
    tok_to, reqs_to, per_to, passes_to = run_engine(model, stacked, "time_only", prompts, ops,
                                                    kernels)
    launches = {k: c.launches for k, c in ops.COUNTERS.items()}
    plain_calls = {k: c.plain_calls for k, c in ops.COUNTERS.items()}
    if any(plain_calls.values()):
        raise PhaseFailed(f"plain versions were called on the serving path: {plain_calls}")
    same = sum(a == b for r1, r2 in zip(reqs_st, reqs_to)
               for a, b in zip(tok_st[r1.request_id], tok_to[r2.request_id]))
    log(f"  greedy-token agreement space_time vs time_only: {same}/{REQUESTS * MAX_NEW} "
        "(bf16: exact agreement not required)")
    log(f"  main-path launches (both modes): {launches}; plain-version calls: {plain_calls}")
    return launches, (per_st, per_to), (passes_st, passes_to)


# Graphed against eager decode steps (the same weights, prompts and slots):
# the logits of one steady step, every cache after GRAPH_CACHE_STEP steps, and
# every request's greedy tokens must be equal; each check is shown to fail
# under its negative control, in short rounds of CONTROL_REQUESTS prompts.
GRAPH_LOGIT_STEP = 4    # step 1 prefills and runs each program eagerly, 2 captures
GRAPH_CACHE_STEP = 8
CONTROL_PROMPT = 64
CONTROL_PREFILL = 100   # the prefill controls' prompts: pieces 64, 32, 4
CONTROL_STEP = 3        # the control acts at this step of its round
GRAPH_TIME_ITERS = 10
GRAPH_REPORT = {}       # model -> mode -> numbers, printed as the ``graphs`` line


def engine_pair(model, stacked, mode):
    """An eager engine (the yardstick) and a graphed one over the same
    stacked weights, each with caches of its own; the eager one prefills by
    the pieces the graphed one replays, where the architecture takes them."""
    from repro_torch.serving import EngineConfig, MultiTenantEngine

    def make(graphs, pieces=None):
        return MultiTenantEngine(model, stacked_params=stacked, graphs=graphs, pieces=pieces,
                                 config=EngineConfig(num_tenants=R_TENANTS, slots_per_tenant=SLOTS,
                                                     cache_len=CACHE_LEN, mode=mode))
    eager, graph = make(False, takes_pieces(model.cfg)), make(True)
    if eager.prefill_route != graph.prefill_route:
        raise PhaseFailed(f"{model.cfg.name}: the engines prefill by {eager.prefill_route} and "
                          f"{graph.prefill_route}")
    return eager, graph


def caches_differ(a, b):
    """Names of the caches whose tensors are not bitwise equal."""
    import torch

    return sorted({name for name, layers in a.caches.items()
                   for x, y in zip(layers, b.caches[name]) if not torch.equal(x, y)})


def logits_gap(a, b):
    """(bitwise equal, max |a - b|) of two engines' last step logits."""
    import torch

    la, lb = a._step_logits, b._step_logits
    return torch.equal(la, lb), float((la.float() - lb.float()).abs().max())


def counted_step(eng, ops, into):
    """``eng.step()``, its launches by op added to ``into``; returns the
    step's host wall seconds (a step ends on the host, with its tokens)."""
    before = {k: c.copy() for k, c in ops.COUNTERS.items()}
    t0 = time.perf_counter()
    eng.step()
    wall = time.perf_counter() - t0
    for k, c in ops.COUNTERS.items():
        into.setdefault(k, ops._build.OpCounter()).add(c.since(before[k]))
    return wall


def counted_admit(eng, ops, into):
    """``eng._admit()`` (every queued request's prefill, installed into its
    slot, no decode step), its launches by op added to ``into``."""
    before = {k: c.copy() for k, c in ops.COUNTERS.items()}
    eng._admit()
    for k, c in ops.COUNTERS.items():
        into.setdefault(k, ops._build.OpCounter()).add(c.since(before[k]))


def first_tokens(eng):
    """(tenant, slot) -> the first token of the request there."""
    return {key: req.generated[0] for key, req in eng.active.items()}


def prefill_control_round(eager, graph, prompts, control):
    """Prefills on both engines from zeroed slots and scratch caches: the
    first R_TENANTS prompts (one a tenant) must leave the engines equal,
    then the next R_TENANTS are admitted with ``control(graph)`` in force.
    Returns (first tokens equal, caches that differ) after the control's
    admissions; the requests are then drained."""
    import torch

    from repro_torch.serving import InferenceRequest

    for eng in (eager, graph):  # slots and scratch: an earlier control wrote past its prompts
        for caches in (eng.caches, eng.scratch):
            for layers in caches.values():
                for c in layers:
                    c.zero_()
        for t, p in prompts[:R_TENANTS]:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=2))
        eng._admit()
    if first_tokens(eager) != first_tokens(graph) or caches_differ(eager, graph):
        raise PhaseFailed(f"prefill control round: the engines differ before the control: first "
                          f"tokens {first_tokens(eager)} and {first_tokens(graph)}, caches "
                          f"{caches_differ(eager, graph)}")
    for eng in (eager, graph):
        for t, p in prompts[R_TENANTS:2 * R_TENANTS]:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=2))
    eager._admit()
    undo = control(graph)
    try:
        graph._admit()
    finally:
        undo()
    out = first_tokens(eager) == first_tokens(graph), caches_differ(eager, graph)
    eager.run_until_drained()
    graph.run_until_drained()
    torch.cuda.synchronize()
    return out


def stale_start(graph):
    """Negative control: every piece replays with the start buffer as the
    last piece before it left it (nothing is staged into it)."""
    pp = graph.programs.prefill

    def run(tenant, tokens, start):
        prog = pp.programs[(tenant, tokens.shape[1])]
        prog.tokens.copy_(tokens)
        return prog.run()
    pp.run = run

    def undo():
        del pp.run
    return undo


def state_unreset(graph):
    """Negative control: a prompt's first piece continues from the recurrent
    state the last prompt left in the scratch cache (nothing is zeroed)."""
    state, graph._state = graph._state, []

    def undo():
        graph._state = state
    return undo


def prefill_vs_whole(ops, cfg, model, stacked, graph, prompts):
    """The graphed engine's piece route against the whole-prompt eager
    prefill (``Model.forward_prefill`` of the whole prompt into a fresh
    cache) on the same weights, prompt by prompt, by the port's bf16 rule
    (``hold_bf16``'s: no farther than twice the plain path, plus 0.1% of the
    largest magnitude): the last piece's logits, and every cache the model
    keeps (K/V over the prompt's positions: the scratch keeps older prompts'
    keys past them, which no query sees), each no farther from the whole
    prompt's than twice the plain path's pieces (``plain_kernels=True``,
    the same lengths) are from the plain path's whole prompt. In bf16 the
    two differ by more than rounding where state is kept (RWKV-6 carries
    the kept float32-w state across pieces, the whole prompt's output scan
    its own), which the plain path shows as well. Returns the largest gaps
    by cache and the logits', (kernel, plain)."""
    import torch

    from repro_torch.core.tenancy import tenant_view
    from repro_torch.models import build_model

    plain = build_model(cfg, device=model.device, plain_kernels=True)

    def live(caches, name, n):
        return [c[:, :, :n] if name in ("k", "v") else c for c in caches[name]]

    def gap(a, b):
        return float((a.float() - b.float()).abs().max()), float(b.float().abs().max())

    gaps = {}
    with torch.no_grad():
        for t, p in prompts:
            params = tenant_view(stacked, t)
            tokens = torch.as_tensor(np.asarray(p, np.int64), device=model.device)[None, :]
            pieces = prefill_pieces(len(p), 0, CACHE_LEN)
            got = graph._run_pieces(t, tokens)
            before = {k: c.copy() for k, c in ops.COUNTERS.items()}
            want, whole = model.forward_prefill(params, tokens, CACHE_LEN)
            scan = ops.COUNTERS["ssd_scan"].since(before["ssd_scan"])
            if (scan.launches, scan.plain_calls) != (mamba_layers(cfg), 0):
                raise PhaseFailed(f"{cfg.name} whole prompt of {len(p)}: ssd_scan launched "
                                  f"{scan.launches} times, not once per Mamba2 layer "
                                  f"({mamba_layers(cfg)}), and {scan.plain_calls} plain calls")
            p_whole, p_whole_c = plain.forward_prefill(params, tokens, CACHE_LEN)
            p_got, p_got_c, pos = None, None, 0
            for n in pieces:
                p_got, p_got_c = plain.forward_prefill(params, tokens[:, pos:pos + n], CACHE_LEN,
                                                       caches=p_got_c, start=pos or None)
                pos += n
            pairs = {"logits": ([got], [want], [p_got], [p_whole])}
            for name in whole:
                pairs[name] = (live(graph.scratch, name, len(p)), live(whole, name, len(p)),
                               live(p_got_c, name, len(p)), live(p_whole_c, name, len(p)))
            for name, (k_got, k_want, p_g, p_w) in pairs.items():
                for a, b, c, d in zip(k_got, k_want, p_g, p_w):
                    (e_k, scale), (e_p, _) = gap(a, b), gap(c, d)
                    old = gaps.get(name, (0.0, 0.0, 0.0))
                    gaps[name] = (max(old[0], e_k), max(old[1], e_p), max(old[2], scale))
                    if not e_k <= 2 * e_p + 1e-3 * scale:
                        raise PhaseFailed(
                            f"{cfg.name} prompt of {len(p)}, pieces {pieces}: {name} of the "
                            f"graphed pieces {e_k:.4e} from the whole prompt's, more than twice "
                            f"the plain path's {e_p:.4e} (+0.1% of {scale:.4e})")
            del whole, p_whole_c, p_got_c
    log(f"    pieces (graphed) vs the whole prompt (eager), {len(prompts)} prompts, largest gap, "
        "kernel path / plain path / max |value|: "
        + ", ".join(f"{k} {v[0]:.3e} / {v[1]:.3e} / {v[2]:.3e}" for k, v in sorted(gaps.items()))
        + " (kernel <= 2 x plain + 0.1%: ok)")
    del plain
    torch.cuda.empty_cache()
    return {k: {"kernel": v[0], "plain": v[1], "max": v[2]} for k, v in gaps.items()}


def control_round(ops, eager, graph, prompts, control):
    """A short round on both engines from zeroed caches: CONTROL_STEP - 1
    steps that must leave them equal, then one step with ``control(graph)``
    in force. Returns (logits bitwise equal, max gap, tokens of the step
    equal, caches that differ) after the control's step."""
    import torch

    from repro_torch.serving import InferenceRequest

    for eng in (eager, graph):
        for layers in eng.caches.values():
            for c in layers:
                c.zero_()
        for t, p in prompts:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=CONTROL_STEP + 2))
    for _ in range(CONTROL_STEP - 1):
        eager.step()
        graph.step()
    same, gap = logits_gap(eager, graph)
    if not same or caches_differ(eager, graph) or \
            not np.array_equal(eager.last_token, graph.last_token):
        raise PhaseFailed(f"control round: the engines differ before the control "
                          f"(logit gap {gap})")
    eager.step()
    undo = control(graph)
    try:
        graph.step()
    finally:
        undo()
    same, gap = logits_gap(eager, graph)
    out = same, gap, np.array_equal(eager.last_token, graph.last_token), \
        caches_differ(eager, graph)
    eager.run_until_drained()
    graph.run_until_drained()
    torch.cuda.synchronize()
    return out


def stale_inputs(graph):
    """Negative control: the step's replays read what the static token and
    length buffers held from the step before (nothing is staged)."""
    progs = list(graph.programs.programs.values())
    for p in progs:
        p.stage = lambda tokens, lengths: None

    def undo():
        for p in progs:
            del p.stage
    return undo


def decode_twice(graph):
    """Negative control: each program replays twice in the step."""
    progs = list(graph.programs.programs.values())
    for p in progs:
        p.run = lambda tokens, lengths, _p=p, _run=p.run: (_run(tokens, lengths), _p.replay())[1]

    def undo():
        for p in progs:
            del p.run
    return undo


def decode_skipped(graph):
    """Negative control: no program runs in the step (the logits are the
    last replay's)."""
    progs = list(graph.programs.programs.values())
    for p in progs:
        p.run = lambda tokens, lengths, _p=p: _p.logits

    def undo():
        for p in progs:
            del p.run
    return undo


def graph_vs_eager(ops, cfg, model, stacked, prompts, mode):
    """One mode of ``graph_checks``: the two engines in lockstep over
    ``prompts`` to the end, then the two control rounds. Returns the
    numbers of the ``graphs`` line for this mode."""
    import torch

    from repro_torch.serving import InferenceRequest

    eager, graph = engine_pair(model, stacked, mode)
    reqs = {}
    for name, eng in (("eager", eager), ("graph", graph)):
        reqs[name] = [InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW)
                      for t, p in prompts]
        for r in reqs[name]:
            eng.submit(r)
    launches = {"eager": {}, "graph": {}}
    walls = {"eager": [], "graph": []}
    logit_check = cache_check = None
    step = 0
    with torch.no_grad():
        # every prompt's prefill, installed into its slot: the first tokens
        # and every cache bitwise equal (the same pieces, or whole prompts)
        for name, eng in (("graph", graph), ("eager", eager)):
            counted_admit(eng, ops, launches[name])
        admit_tokens = first_tokens(eager) == first_tokens(graph)
        admit_caches = caches_differ(eager, graph)
        while eager.queue or eager.active or graph.queue or graph.active:
            step += 1
            if step > MAX_NEW + 2:
                raise PhaseFailed(f"{mode}: the engines did not drain in step")
            for name, eng in (("graph", graph), ("eager", eager)):
                walls[name].append(counted_step(eng, ops, launches[name]))
            if step == GRAPH_LOGIT_STEP:
                logit_check = logits_gap(eager, graph)
            if step == GRAPH_CACHE_STEP:
                cache_check = caches_differ(eager, graph)
        same_tokens = sum(a.generated == b.generated for a, b in zip(reqs["eager"], reqs["graph"]))
        st_e, st_g = eager.programs.stats(), graph.programs.stats()
        progs = list(graph.programs.programs.values())
        device_ms = time_ms(lambda: [p.graph.replay() for p in progs], GRAPH_TIME_ITERS)
        # the controls' rounds: one prompt of CONTROL_PROMPT tokens a slot
        rng = np.random.RandomState(7)
        short = [(i % R_TENANTS, rng.randint(1, cfg.vocab_size, size=CONTROL_PROMPT).tolist())
                 for i in range(R_TENANTS * SLOTS)]
        stale = control_round(ops, eager, graph, short, stale_inputs)
        recurrent = any(n in eager.caches for n in ("wkv", "ssm"))
        kind, control = ("decoded twice", decode_twice) if recurrent else (
            "decode skipped", decode_skipped)
        state = control_round(ops, eager, graph, short, control)
        prefill = {"route": graph.prefill_route, "first_tokens_equal": admit_tokens,
                   "caches_differ": admit_caches}
        if graph.prefill_route == "pieces":
            st_p = graph.programs.stats()
            prefill.update({k[len("prefill_"):]: v for k, v in st_p.items()
                            if k.startswith("prefill_")})
            # the controls' prefills: prompts of CONTROL_PREFILL tokens (three pieces)
            longer = [(i % R_TENANTS, rng.randint(1, cfg.vocab_size, size=CONTROL_PREFILL).tolist())
                      for i in range(2 * R_TENANTS)]
            # a stale start moves attention's positions (RWKV-6 reads none);
            # unreset state carries RWKV-6's and Mamba2's into the next prompt
            controls = [("stale start", stale_start)] if model.has_attention else []
            if recurrent:
                controls.append(("recurrent state left unreset", state_unreset))
            for what, fn in controls:
                equal, differ = prefill_control_round(eager, graph, longer, fn)
                prefill[what.replace(" ", "_") + "_control"] = {
                    "first_tokens_equal": equal, "caches_differ": differ, "caught": bool(differ)}
            if mode == "space_time":
                prefill["vs_whole_gaps"] = prefill_vs_whole(
                    ops, cfg, model, stacked, graph, prompts[:2])
    k3 = {n: launches[n]["decode_attention"] for n in launches}
    n_attn = attention_layers(cfg)
    steady = slice(GRAPH_LOGIT_STEP - 1, None)  # from the first steady replay on
    wall_e = float(np.median(walls["eager"][steady])) * 1e3
    wall_g = float(np.median(walls["graph"][steady])) * 1e3
    by_op = {n: {k: dict(c.variants) for k, c in launches[n].items() if c.launches}
             for n in launches}
    row = {
        "eager_wall_ms": wall_e, "graph_wall_ms": wall_g, "graph_device_ms": device_ms,
        "eager_idle": 1 - device_ms / wall_e, "graph_idle": 1 - device_ms / wall_g,
        "capture_s": st_g["capture_s"], "pool_bytes": st_g["pool_bytes"],
        "programs": st_g["programs"], "decode_passes": st_g["decode_passes"],
        "eager_passes": st_g["eager_passes"], "replays": st_g["replays"],
        "logits_bitwise": logit_check[0], "logit_max_gap": logit_check[1],
        "caches_differ": cache_check, "tokens_equal": same_tokens, "requests": len(prompts),
        "launches_by_op": by_op["graph"],
        "stale_inputs_control": {"logits_bitwise": stale[0], "logit_max_gap": stale[1],
                                 "tokens_equal": stale[2]},
        "state_control": {"kind": kind, "caches_differ": state[3]},
        "prefill": prefill,
    }
    caught_stale = not stale[0] and stale[1] > TOL["torch.bfloat16"][1]
    caught_state = bool(state[3])
    log(f"  {cfg.name} {mode} graphed vs eager: step {GRAPH_LOGIT_STEP} logits "
        f"{'bitwise equal' if logit_check[0] else f'max gap {logit_check[1]:.3e}'}; caches after "
        f"{GRAPH_CACHE_STEP} steps {'equal' if not cache_check else f'differ: {cache_check}'}; "
        f"greedy tokens equal in {same_tokens}/{len(prompts)} requests; decode passes "
        f"{st_g['decode_passes']} = {st_g['eager_passes']} eager + {st_g['replays']} replays "
        f"(eager engine: {st_e['decode_passes']} eager); K3 {dict(k3['graph'].variants)} graphed, "
        f"{dict(k3['eager'].variants)} eager, {n_attn} attention layers")
    log(f"    wall {wall_e:.3f} ms a step eager, {wall_g:.3f} graphed; a step's graphs replayed "
        f"back to back {device_ms:.3f} ms of device time; idle share {row['eager_idle']:.3f} "
        f"eager, {row['graph_idle']:.3f} graphed (CUDA events); {st_g['captures']} captures in "
        f"{st_g['capture_s']:.3f} s, {st_g['pool_bytes'] / 2**20:.1f} MiB reserved by them")
    log(f"    prefills ({prefill['route']}): first tokens "
        f"{'equal' if admit_tokens else 'DIFFER'}, installed caches "
        f"{'bitwise equal' if not admit_caches else f'differ: {admit_caches}'}"
        + "".join(f"; control, {k[:-len('_control')].replace('_', ' ')}: caches that differ "
                  f"{v['caches_differ'] or 'none'}: {'caught' if v['caught'] else 'NOT caught'}"
                  for k, v in prefill.items() if k.endswith("_control")))
    log(f"    control, stale token and length buffers: logits "
        f"{'bitwise equal' if stale[0] else f'max gap {stale[1]:.3e}'}, the step's tokens "
        f"{'equal' if stale[2] else 'differ'}: {'caught' if caught_stale else 'NOT caught'}; "
        f"control, {kind}: caches that differ {state[3] or 'none'}: "
        f"{'caught' if caught_state else 'NOT caught'}")
    passes_ok = (st_g["eager_passes"] == st_g["programs"] == st_g["captures"]
                 and st_g["replays"] == st_g["decode_passes"] - st_g["eager_passes"]
                 and st_g["decode_passes"] == st_e["decode_passes"] == st_e["eager_passes"])
    k3_ok = (dict(k3["graph"].variants) == dict(k3["eager"].variants)
             and k3["graph"].launches == n_attn * st_g["decode_passes"]
             and set(k3["graph"].variants) <= set(k3_kinds(model.dtype, cfg.head_dim,
                                                           cfg.num_heads, cfg.num_kv_heads)))
    if not (logit_check[0] or logit_check[1] <= TOL["torch.bfloat16"][1]) or cache_check \
            or same_tokens != len(prompts) or not passes_ok or not k3_ok \
            or by_op["graph"] != by_op["eager"] or not caught_stale or not caught_state \
            or not admit_tokens or admit_caches \
            or not all(v["caught"] for k, v in prefill.items() if k.endswith("_control")) \
            or (graph.prefill_route == "pieces" and len(
                [k for k in prefill if k.endswith("_control")])
                != model.has_attention + recurrent):
        raise PhaseFailed(f"{cfg.name} {mode}: graphed decode differs from eager, or a control "
                          f"was not caught: {row}")
    del eager, graph
    torch.cuda.empty_cache()
    return row


def graph_checks(ops, cfg, model, stacked, prompts):
    """The graphed engine against the eager one in both modes, into
    GRAPH_REPORT[cfg.name]."""
    GRAPH_REPORT[cfg.name] = {mode: graph_vs_eager(ops, cfg, model, stacked, prompts, mode)
                              for mode in ("space_time", "time_only")}


def profile_serving(model, stacked, prompts, steps=8):
    """Where a decode step's time goes: torch.profiler over ``steps`` steady
    decode steps of each mode, after the first step has run every prefill
    and the second has captured the step's graphs; the graphed engine, then
    the eager one (``graphs=False``) over the same prompts.

    Prints the host wall time per step, the device time spent in kernels per
    step, the device's idle share (1 - kernel time / wall), the kernel
    launches per step, and the kernels that take the most device time; and
    whether the profiler saw as many kernels a step inside the graphs as
    the eager engine launched.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    for mode in ("space_time", "time_only"):
        seen = {}
        for route, graphs in (("graphed", None), ("eager", False)):
            eng = MultiTenantEngine(model, stacked_params=stacked, graphs=graphs,
                                    config=EngineConfig(num_tenants=R_TENANTS,
                                                        slots_per_tenant=SLOTS,
                                                        cache_len=CACHE_LEN, mode=mode))
            for t, p in prompts:
                eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW))
            with torch.no_grad():
                eng.step()
                eng.step()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(steps):
                        eng.step()
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
            avgs = prof.key_averages()
            kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_us = sum(e.self_device_time_total for e in kernels)
            n_kernels = sum(e.count for e in kernels)
            seen[route] = n_kernels
            log(f"  profile {mode} {route}: wall {wall / steps * 1e3:.3f} ms/step, kernels "
                f"{busy_us / steps / 1e3:.3f} ms/step, device idle share "
                f"{1 - busy_us / 1e6 / wall:.3f}, {n_kernels / steps:.0f} kernels/step")
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
                log(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
                    f"{e.count / steps:6.0f}x  {e.key[:90]}")
            del eng
            torch.cuda.empty_cache()
        log(f"  profile {mode}: the profiler saw {seen['graphed']} device activities (kernels, "
            f"copies) in {steps} graphed steps, {seen['eager']} in {steps} eager steps: "
            + ("equal" if seen["graphed"] == seen["eager"] else
               f"{seen['graphed'] - seen['eager']:+d} graphed (the graphed idle share of the "
               "CUDA-event line does not depend on the profiler)"))


def main_path_kernel_rows(ops, dev, seed, cfg, prompt_lens, launches, per_mode, slots=SLOTS,
                          max_new=MAX_NEW, path=""):
    """Kernel vs plain vs SDPA at a serving path's own shapes (bf16, ``cfg``'s
    heads and head dim, ``slots`` per tenant): K3 at the merged decode step
    (space_time) and at one tenant's decode (time_only), each row with its
    mode's launches; K4 at a median prefill. ``prior_ms`` is the K3 kernel
    that ran before (``k3_prior``: split_kv where mma took over, else the
    first kernel where it has an instance at the head dim) and K4's
    CUDA-core variant. ``path`` prefixes the rows' shape labels."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100)
    lens_mid = [n + max_new // 2 for n in prompt_lens]  # mid-generation cache lengths
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    prior = k3_prior(torch.bfloat16, D, Hq, Hkv)
    log(f"  {cfg.name} decode_attention at the merged decode step: R*B={R_TENANTS * slots}, "
        f"cache {CACHE_LEN}, lengths = prompt + {max_new // 2}")
    merged = measure_decode(ops, dev, gen, torch.bfloat16, R_TENANTS * slots, Hq, Hkv, CACHE_LEN,
                            D, lens_mid[:R_TENANTS * slots], prior=prior)
    alone = lens_mid[::R_TENANTS][:slots]  # tenant 0's requests: prompts go to tenants in turn
    log(f"  {cfg.name} decode_attention at a time_only decode step: tenant 0 alone, B={slots}, "
        f"lengths {alone}")
    single = measure_decode(ops, dev, gen, torch.bfloat16, slots, Hq, Hkv, CACHE_LEN, D, alone,
                            prior=prior)
    s_med = int(np.median(prompt_lens))
    log(f"  {cfg.name} flash_attention at a median prefill: {s_med} tokens")
    fl = measure_flash(ops, dev, gen, torch.bfloat16, 1, Hq, Hkv, s_med, s_med, D, 0, prior=True)
    per_st, per_to = per_mode
    cases = [
        ("decode_attention", "merged decode (space_time)", per_st["decode_attention"], merged),
        ("decode_attention", "one tenant's decode (time_only)", per_to["decode_attention"],
         single),
        ("flash_attention", "median prefill", launches["flash_attention"], fl)]
    if takes_pieces(cfg):  # the launch the piece route makes: a piece against the whole cache
        pieces = prefill_pieces(s_med, 0, CACHE_LEN)
        n, start = (pieces[1], pieces[0]) if len(pieces) > 1 else (pieces[0], 0)
        log(f"  {cfg.name} flash_attention at the median prefill's piece of {n} at {start} "
            f"(pieces {pieces}), {CACHE_LEN} cached keys, the offset read on the card")
        cases.append(("flash_attention", f"median prefill's piece of {n} at {start} against "
                                         f"{CACHE_LEN} cached keys",
                      launches["flash_attention"],
                      measure_flash_piece(ops, dev, gen, Hq, Hkv, D, n, start)))
    return [kernel_row(name, f"{path}{cfg.name} {shape}, D={D}", n, row)
            for name, shape, n, row in cases]


# ----------------------------------------------------------------- phase 4
# The paper's GEMM super-kernel path: K1 batched_gemm and K2 grouped_gemm
# against their plain versions, the Table 1 strategy sweep, and the
# scheduler on two stochastic GEMM streams.
#
# Tolerances are the JAX kernel tests' own: K1 rtol 2e-4 (f32) / 2e-2
# (bf16) with atol = rtol * sqrt(K), the spread of a K-term float32 sum;
# K2 rtol 2e-4 / 3e-2 with atol = 10 * rtol. Both kernels compute in full
# float32 (no TF32), so only the order of the sums differs in f32.
GEMM_RTOL = {"torch.float32": 2e-4, "torch.bfloat16": 2e-2}
GROUPED_RTOL = {"torch.float32": 2e-4, "torch.bfloat16": 3e-2}
K1_CASES = [  # (R, M, K, N): tests/test_kernels_batched_gemm.py's shapes
    (2, 512, 512, 1), (4, 256, 1152, 128), (3, 256, 256, 256),
    (1, 128, 128, 128), (5, 100, 70, 33), (8, 16, 512, 16),
    (3, 200, 300, 96),  # the JAX block-shape-invariance problem
]
# K1's tile edges: row tiles (64 or 128 rows) ending inside a problem, K
# tails (8 = half a 16-deep stage; 2056 = 32 stages of 64 + 8) and N tails
# (40 inside one column tile, 5640 = 44 tiles + 8 columns)
K1_EDGE_CASES = [(3, m, 256, 136) for m in (1, 16, 100, 129, 300)] + [
    (2, 100, 8, 40), (2, 129, 2056, 5640), (3, 16, 2056, 40), (2, 300, 8, 5640)]
PAPER_RS = (2, 16, 120)
GROUP_SIZES = ([64, 64], [100, 5, 0, 260], [1, 1, 1], [300])
PAPER_GEOMEAN = {"rnn_matvec": 2.48, "resnet18_conv2_2": 3.23, "square_256": 4.93}
TABLE1_REPS = 5
ABLATION_TENANTS, ABLATION_TICKS = 8, 120   # examples/spacetime_ablation.py's trace
RAGGED_TENANTS, RAGGED_TICKS = 4, 40
RAGGED_K, RAGGED_N = 2048, 5632             # stablelm-1.6b: d_model, d_ff
WINDOW_S = 0.002
GEMM_MAX_CONNECTIONS = "32"  # hardware queues for space_only's 32 streams
GEMM_TIMEOUT_S = 600
GEMM_REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:91",
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:92",
}


def gemm_tol(dtype, K):
    r = GEMM_RTOL[str(dtype)]
    return r, r * K ** 0.5


def grouped_tol(dtype):
    r = GROUPED_RTOL[str(dtype)]
    return r, 10 * r


def gemm_work(rows, K, N, w_mats, dtype):
    """(bytes, flops): x, w and out once each; 2*rows*K*N operations."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    return esize * (rows * K + w_mats * K * N + rows * N), 2 * rows * K * N


def ragged_trace(seed):
    """Per tick, the (tenant, M) arrivals of the ragged stream: stablelm
    MLP-shaped GEMMs with M from decode batches (1-16 rows) and prefill
    chunks (128-1024 rows), half each."""
    rng = np.random.default_rng(seed + 7)
    ticks = []
    for _ in range(RAGGED_TICKS):
        arr = []
        for _ in range(1 + rng.poisson(1.0)):
            decode = rng.random() < 0.5
            m = int(rng.integers(1, 17)) if decode else int(rng.integers(128, 1025))
            arr.append((int(rng.integers(RAGGED_TENANTS)), m))
        ticks.append(arr)
    return ticks


def timed_row(err, kernel, plain, library, work, dtype, iters):
    """The kernels-line numbers of one kernel: its time, its plain
    version's and the library call's (CUDA events), and its bound."""
    bound_ms, bound_by = bound(*work, str(dtype))
    row = {
        "max_abs_err": err,
        "ms": time_ms(kernel, iters),
        "plain_ms": time_ms(plain, 3, 1),
        "library_ms": time_ms(library, iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} bmm_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) kernel/bmm={row['ms'] / row['library_ms']:.2f}")
    return row


def measure_batched(ops, x, w, err, iters=20):
    """K1 timed beside its plain version and torch.bmm, then its first,
    CUDA-core kernel (checked, then timed as ``prior_ms``), launched
    explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import batched_gemm as bg

    R, M, K = x.shape
    N = w.shape[2]
    row = {"variant": bg.variant(x.dtype, K, N)}
    row.update(timed_row(err, lambda: ops.batched_gemm(x, w), lambda: ops.batched_gemm_plain(x, w),
                         lambda: torch.bmm(x, w), gemm_work(R * M, K, N, R, x.dtype), x.dtype,
                         iters))
    prior = lambda: bg.batched_gemm(x, w, kernel="cuda_core")  # noqa: E731
    check_close("  its CUDA-core kernel", prior(), ops.batched_gemm_plain(x, w), str(x.dtype),
                gemm_tol(x.dtype, K))
    row["prior_ms"] = time_ms(prior, iters)
    log(f"    prior_ms={row['prior_ms']:.4f} (first CUDA-core kernel) prior/kernel="
        f"{row['prior_ms'] / row['ms']:.2f}")
    return row


def measure_grouped(ops, x, w, bg, bm, err, iters=10):
    """K2 timed beside its plain version and torch.bmm, then its CUDA-core
    variant (checked, then timed as ``prior_ms``), launched explicitly on
    the same inputs."""
    import torch

    from repro_torch.kernels import grouped_gemm as gg

    T, K = x.shape
    wg = w[torch.as_tensor(bg, device=w.device).long()]  # gathered outside the timing
    xb = x.view(T // bm, bm, K)
    used = len(np.unique(bg))  # w counts once per group the blocks use
    row = {"variant": gg.variant(x.dtype, K, w.shape[2])}
    row.update(timed_row(err, lambda: ops.grouped_gemm(x, w, bg, bm=bm),
                         lambda: ops.grouped_gemm_plain(x, w, bg, bm=bm),
                         lambda: torch.bmm(xb, wg), gemm_work(T, K, w.shape[2], used, x.dtype),
                         x.dtype, iters))
    check_close("  its CUDA-core variant", gg.grouped_gemm(x, w, bg, bm, kernel="cuda_core"),
                ops.grouped_gemm_plain(x, w, bg, bm=bm), str(x.dtype), grouped_tol(x.dtype))
    row["prior_ms"] = time_ms(lambda: gg.grouped_gemm(x, w, bg, bm, kernel="cuda_core"), iters)
    log(f"    prior_ms={row['prior_ms']:.4f} (CUDA cores) prior/kernel="
        f"{row['prior_ms'] / row['ms']:.2f}")
    return row


def check_batched(ops, gen, dev, dtype, R, M, K, N):
    import torch

    from repro_torch.kernels import batched_gemm as bg

    x = torch.randn((R, M, K), generator=gen, device=dev).to(dtype)
    w = torch.randn((R, K, N), generator=gen, device=dev).to(dtype)
    got = ops.batched_gemm(x, w)
    want = ops.batched_gemm_plain(x, w)
    torch.cuda.synchronize()
    err = check_close(f"batched_gemm {str(dtype)[6:]} {(R, M, K, N)} [{bg.variant(dtype, K, N)}]",
                      got, want, str(dtype), gemm_tol(dtype, K))
    return x, w, err


def check_independence(ops, gen, dev, dtype, M, K, N):
    """Four problems; changing x[2] must leave problems 0, 1 and 3
    bit-identical."""
    import torch

    from repro_torch.kernels import batched_gemm as bg

    x = torch.randn((4, M, K), generator=gen, device=dev).to(dtype)
    w = torch.randn((4, K, N), generator=gen, device=dev).to(dtype)
    base = ops.batched_gemm(x, w)
    x2 = x.clone()
    x2[2] = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    pert = ops.batched_gemm(x2, w)
    same = [bool(torch.equal(base[r], pert[r])) for r in range(4)]
    log(f"  batched_gemm {str(dtype)[6:]} {(4, M, K, N)} [{bg.variant(dtype, K, N)}] problem "
        f"independence: bit-identical per problem after changing x[2]: {same}")
    if same != [True, True, False, True]:
        raise PhaseFailed("batched_gemm: a problem's output depends on another's data")


def group_inputs(gen, dev, dtype, sizes, bm, K, N):
    import torch

    from repro_torch.kernels.grouped_gemm import make_group_layout

    offs, bg, T = make_group_layout(np.asarray(sizes), bm=bm)
    x = torch.zeros((T, K), device=dev)
    for g, sz in enumerate(sizes):
        x[offs[g]:offs[g] + sz] = torch.randn((sz, K), generator=gen, device=dev)
    w = torch.randn((len(sizes), K, N), generator=gen, device=dev)
    return x.to(dtype), w.to(dtype), bg


def check_grouped(ops, name, dtype, x, w, bg, bm):
    import torch

    from repro_torch.kernels import grouped_gemm as gg

    got = ops.grouped_gemm(x, w, bg, bm=bm)
    want = ops.grouped_gemm_plain(x, w, bg, bm=bm)
    torch.cuda.synchronize()
    kind = gg.variant(dtype, x.shape[1], w.shape[2])
    return check_close(f"{name} [{kind}]", got, want, str(dtype), grouped_tol(dtype))


def phase_gemm_kernels(ops, dev, seed):
    """(a) K1 and K2 against their plain versions, f32 and bf16; times at
    the Table 1 shapes."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4)
    ragged_sizes = [m for tick in ragged_trace(seed) for _, m in tick][:8]
    for dtype in (torch.float32, torch.bfloat16):
        for case in K1_CASES:
            check_batched(ops, gen, dev, dtype, *case)
        for g in PAPER_GEMM_SHAPES.values():
            for R in PAPER_RS:
                x, w, err = check_batched(ops, gen, dev, dtype, R, g.M, g.K, g.N)
                if dtype == torch.float32:  # Table 1 is float32
                    measure_batched(ops, x, w, err)
        for case in K1_EDGE_CASES:
            check_batched(ops, gen, dev, dtype, *case)
        # bitwise problem independence: changing x[2] leaves 0, 1, 3 as they
        # were; at M = 100 a 128-row wgmma tile reads the next problem's rows,
        # and at K = 1152 the simt kernel splits K over a cluster of 4
        for M, K, N in ((64, 64, 64), (100, 1152, 136)):
            check_independence(ops, gen, dev, dtype, M, K, N)
        tag = str(dtype)[6:]
        # bm against the 64-row (CUDA cores) and 128-row (wgmma) tiles: 96 is
        # 1.5 of the one, 256 two of the other; K 48 and N 40 are tails
        # inside one 64-deep stage and one 128-wide tile
        for sizes in GROUP_SIZES:
            for bm in (32, 96, 128, 256):
                x, w, bg = group_inputs(gen, dev, dtype, sizes, bm, 48, 40)
                check_grouped(ops, f"grouped_gemm {tag} sizes={sizes} bm={bm}",
                              dtype, x, w, bg, bm)
        # K and N tails at full width: K 2056 = 32 stages + 8, N 5640 = 44
        # tiles + 8 columns; and an N that only the CUDA-core kernel takes
        for sizes, bm, K, N in (([300, 17, 130], 128, 2056, 5640), ([100, 5, 0, 260], 96, 2056, 40),
                                ([100, 5, 0, 260], 96, 48, 5640), ([100, 5, 0, 260], 32, 72, 33)):
            x, w, bg = group_inputs(gen, dev, dtype, sizes, bm, K, N)
            check_grouped(ops, f"grouped_gemm {tag} sizes={sizes} bm={bm} K={K} N={N}",
                          dtype, x, w, bg, bm)
        # a tail of zero blocks and zero weights, as SuperKernelCache.ragged_layout pads them
        check_ragged_tail(ops, gen, dev, dtype, [300, 17, 5], 256, 136)
        x, w, bg = group_inputs(gen, dev, dtype, ragged_sizes, 128, RAGGED_K, RAGGED_N)
        check_grouped(ops, f"grouped_gemm {str(dtype)[6:]} sizes={ragged_sizes} bm=128 "
                      f"K={RAGGED_K} N={RAGGED_N}", dtype, x, w, bg, 128)
        # group isolation: rows of group g see only w[g]; padded rows are 0
        x, w, bg = group_inputs(gen, dev, dtype, [16, 9], 16, 24, 8)
        out = ops.grouped_gemm(x, w, bg, bm=16).float()
        x32, w32 = x.float(), w.float()
        want = torch.cat([x32[:16] @ w32[0], x32[16:] @ w32[1]])
        check_close(f"grouped_gemm {str(dtype)[6:]} group isolation", out, want,
                    str(dtype), grouped_tol(dtype))
        if not torch.equal(out[25:], torch.zeros_like(out[25:])):
            raise PhaseFailed("grouped_gemm: padded rows are not zero")


def check_ragged_tail(ops, gen, dev, dtype, sizes, K, N):
    """K2 on the layout ``execute_ragged`` builds for ``sizes``: rows packed
    at their offsets, padded to a pow2 bucket of row blocks (group 0, zero
    rows) and a pow2 bucket of groups (zero weights). The tail rows must be
    0."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import SuperKernelCache
    from repro_torch.core.superkernel import RAGGED_BM

    offs, T, bg, G = SuperKernelCache(ScheduleConfig()).ragged_layout(sizes)
    x = torch.zeros((T, K), device=dev)
    for o, m in zip(offs, sizes):
        x[int(o):int(o) + m] = torch.randn((m, K), generator=gen, device=dev)
    w = torch.zeros((G, K, N), device=dev)
    w[: len(sizes)] = torch.randn((len(sizes), K, N), generator=gen, device=dev)
    x, w = x.to(dtype), w.to(dtype)
    check_grouped(ops, f"grouped_gemm {str(dtype)[6:]} ragged_layout({sizes}): T={T}, "
                  f"{len(bg)} blocks, G={G}", dtype, x, w, bg, RAGGED_BM)
    out = ops.grouped_gemm(x, w, bg, bm=RAGGED_BM)
    tail = int(offs[-1])
    if not torch.equal(out[tail:], torch.zeros_like(out[tail:])):
        raise PhaseFailed("grouped_gemm: rows of the padded tail blocks are not zero")


def phase_table1(ops, dev, seed):
    """(b) Table 1 on the card: four strategies, f32, reps 5, min time."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES, PAPER_R_SWEEP
    from repro_torch.core import GemmProblem, SuperKernelCache
    from repro_torch.core.strategies import Exclusive, SpaceOnly, SpaceTime, TimeOnly
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    log(f"  {'shape':18s} {'R':>4s} | GFLOP/s {'time_only':>10s} {'space_only':>10s} "
        f"{'space_time':>10s} {'exclusive':>10s} | st/space st/time")
    for name, g in PAPER_GEMM_SHAPES.items():
        vs_space, vs_time = [], []
        for r in PAPER_R_SWEEP:
            problems = [GemmProblem(tenant_id=t,
                                    x=torch.randn((g.M, g.K), generator=gen, device=dev),
                                    w=torch.randn((g.K, g.N), generator=gen, device=dev))
                        for t in range(r)]
            rates = {}
            for s in (TimeOnly(), SpaceOnly(),
                      SpaceTime(SuperKernelCache(ScheduleConfig(r_bucketing="exact"))),
                      Exclusive()):
                s.prepare(problems)
                times = []
                for _ in range(TABLE1_REPS):
                    outs, t = s.run()
                    times.append(t)
                rates[s.name] = g.flops * r / min(times)
                if r == 16:  # every strategy's outputs, once, against the plain product
                    ws = [problems[0].w if s.name == "exclusive" else p.w for p in problems]
                    want = ref.batched_gemm(torch.stack([p.x for p in problems]),
                                            torch.stack(ws))
                    check_close(f"{name} R=16 {s.name}", torch.stack(outs), want,
                                "torch.float32", gemm_tol(torch.float32, g.K))
            vs_space.append(rates["space_time"] / rates["space_only"])
            vs_time.append(rates["space_time"] / rates["time_only"])
            log(f"  {name:18s} {r:4d} | {'':7s} " + " ".join(
                f"{rates[k] / 1e9:10.1f}" for k in ("time_only", "space_only", "space_time",
                                                    "exclusive"))
                + f" | {vs_space[-1]:7.2f}x {vs_time[-1]:6.2f}x")
            del problems
        log(f"  {name:18s} geomean over R: st/space_only {geomean(vs_space):.2f}x "
            f"st/time_only {geomean(vs_time):.2f}x (paper geomean vs next-best: "
            f"{PAPER_GEOMEAN[name]:.2f}x)")


def geomean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def run_gemm_stream(ops, sched, ticks, make_problem):
    """Drive ``sched`` on a WallClock over ``ticks`` (lists of arrival
    specs), as examples/spacetime_ablation.py does; returns the completed
    problems and each op's (launches, plain calls), zeroed just before the
    run and read just after."""
    import torch

    done = []
    torch.cuda.synchronize()
    ops.reset_counters()
    for arrivals in ticks:
        for spec in arrivals:
            sched.submit(make_problem(spec))
        done.extend(sched.pump())
        time.sleep(0.0002)
    done.extend(sched.flush())
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls, dict(c.variants)) for k, c in ops.COUNTERS.items()}
    return done, counts


def report_stream(what, sched, done, n_submitted, counts, tol_of):
    """Check every completed problem against its plain product; print the
    run's metrics."""
    import torch

    from repro_torch.kernels import ref

    if len(done) != n_submitted or any(p.result is None for p in done):
        raise PhaseFailed(f"{what}: {len(done)}/{n_submitted} problems completed")
    worst, bad = 0.0, 0
    for p in done:
        rtol, atol = tol_of(p)
        want = ref.batched_gemm(p.x[None], p.w[None])[0].float()
        got = p.result.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise PhaseFailed(f"{what}: result of shape {tuple(got.shape)} or non-finite")
        err = (got - want).abs()
        worst = max(worst, float(err.max()))
        bad += int((err > atol + rtol * want.abs()).any())
    lat = np.asarray([p.completion_time - p.arrival_time for p in done])
    rep = sched.report()
    log(f"  {what}: {len(done)} problems, dispatches={int(rep['dispatches'])}, "
        f"cache_hit_rate={rep['cache_hit_rate']:.3f}, achieved_tflops={rep['achieved_tflops']:.3f}, "
        f"latency p50={np.percentile(lat, 50) * 1e3:.3f}ms p95={np.percentile(lat, 95) * 1e3:.3f}ms, "
        f"cache {sched.cache.stats}")
    log(f"    results vs plain product: max_abs_err={worst:.3e}, {bad} out of tolerance; "
        f"launches/plain calls: {counts}")
    if bad:
        raise PhaseFailed(f"{what}: {bad} results out of tolerance")


def ablation_stream(dev, seed):
    """Run 1's stream, examples/spacetime_ablation.py's trace: 8 tenants'
    conv2_2 GEMMs (f32), 1 + Poisson(1.5) arrivals per tick, 120 ticks.
    Returns (ticks of (tenant, input) specs, spec -> GemmProblem)."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
    from repro_torch.core import GemmProblem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    rng = np.random.default_rng(seed)
    ws = [torch.randn((g.K, g.N), generator=gen, device=dev) for _ in range(ABLATION_TENANTS)]
    xs = [torch.randn((g.M, g.K), generator=gen, device=dev) for _ in range(4)]
    ticks = [[(int(rng.integers(ABLATION_TENANTS)), int(rng.integers(4)))
              for _ in range(1 + rng.poisson(1.5))] for _ in range(ABLATION_TICKS)]
    return ticks, lambda s: GemmProblem(tenant_id=s[0], x=xs[s[1]], w=ws[s[0]])


def ragged_stream(dev, seed):
    """Run 2's stream: ``ragged_trace``'s arrivals of stablelm-1.6b MLP
    GEMMs (bf16) from 4 tenants. Returns (ticks, spec -> GemmProblem)."""
    import torch

    from repro_torch.core import GemmProblem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    wr = [torch.randn((RAGGED_K, RAGGED_N), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(RAGGED_TENANTS)]
    return ragged_trace(seed), lambda s: GemmProblem(
        tenant_id=s[0], w=wr[s[0]],
        x=torch.randn((s[1], RAGGED_K), generator=gen, device=dev).to(torch.bfloat16))


def phase_gemm_scheduler(ops, dev, seed):
    """(c) DynamicSpaceTimeScheduler on two stochastic GEMM streams."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import DynamicSpaceTimeScheduler

    # run 1: the ablation trace
    ticks, make_problem = ablation_stream(dev, seed)
    sizes1 = []
    sched = DynamicSpaceTimeScheduler(
        ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64),
        on_dispatch=lambda batch, dt, rid: sizes1.append(len(batch)))
    done, counts1 = run_gemm_stream(ops, sched, ticks, make_problem)
    K = done[0].x.shape[1]
    report_stream(f"run 1: {ABLATION_TENANTS} tenants resnet18_conv2_2 f32, window "
                  f"{WINDOW_S * 1e3:g} ms", sched, done, sum(map(len, ticks)), counts1,
                  lambda p: gemm_tol(torch.float32, K))
    log(f"    dispatch sizes R: {sizes1}")
    del done, sched

    # run 2: ragged merge at stablelm-1.6b's MLP width, bf16
    ticks, make_problem = ragged_stream(dev, seed)
    layouts = []
    sched = DynamicSpaceTimeScheduler(
        ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64,
                       allow_ragged_merge=True),
        on_dispatch=lambda batch, dt, rid: layouts.append([p.x.shape[0] for p in batch]))
    done, counts2 = run_gemm_stream(ops, sched, ticks, make_problem)
    report_stream(f"run 2: {RAGGED_TENANTS} tenants ragged K={RAGGED_K} N={RAGGED_N} bf16",
                  sched, done, sum(map(len, ticks)), counts2,
                  lambda p: gemm_tol(torch.bfloat16, RAGGED_K))
    log(f"    dispatch row counts: {layouts}")
    del done
    if counts1["batched_gemm"][0] <= 0:
        raise PhaseFailed("run 1 never launched batched_gemm")
    if counts2["grouped_gemm"][0] <= 0:
        raise PhaseFailed("run 2 never launched grouped_gemm")
    # every launch of the path on the kernel its dtype and shape route to:
    # run 1 (f32) K1 on simt; run 2 (bf16, K and N multiples of 8) K1 and K2
    # on wgmma
    for run, counts, name, want in (("run 1", counts1, "batched_gemm", "simt"),
                                    ("run 2", counts2, "batched_gemm", "wgmma"),
                                    ("run 2", counts2, "grouped_gemm", "wgmma")):
        by_variant = counts[name][2]
        log(f"    {run} {name} launches by variant: {by_variant}")
        if by_variant.get(want, 0) != counts[name][0]:
            raise PhaseFailed(f"{run}: {name} launches not all {want}: {by_variant}")
    plain = {k: counts1[k][1] + counts2[k][1] for k in GEMM_REPLACES}
    if any(plain.values()):
        raise PhaseFailed(f"plain versions were called on the GEMM path: {plain}")
    # each ragged dispatch's sizes and the layout its cache launched K2 on;
    # each dispatch of one row count, which the cache launched K1 on
    ragged = [(l, sched.cache.ragged_layout(l)) for l in layouts if len(set(l)) > 1]
    single = [l for l in layouts if len(set(l)) == 1]
    return (counts1, counts2), sizes1, ragged, single


def gemm_path_kernel_rows(ops, dev, seed, counts, sizes1, ragged, single):
    """K1 and K2 against plain and torch.bmm at the scheduler runs' shapes:
    K1 at run 1's median dispatch (R padded to its pow2 bucket, f32) and at
    run 2's median dispatch of one row count (bf16), K2 at run 2's median
    ragged dispatch (by padded rows), on the layout the cache launched it on.
    Each row's launches are its run's."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
    from repro_torch.core import round_pow2
    from repro_torch.core.superkernel import RAGGED_BM

    counts1, counts2 = counts
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    R = round_pow2(int(np.median(sizes1)))
    log(f"  batched_gemm at run 1's median dispatch: R={R} (pow2 bucket), {g.name} f32")
    x, w, err = check_batched(ops, gen, dev, torch.float32, R, g.M, g.K, g.N)
    k1 = measure_batched(ops, x, w, err)
    if single:
        by_work = sorted(single, key=lambda l: round_pow2(len(l)) * l[0])
        sizes = by_work[len(by_work) // 2]
        R, M = round_pow2(len(sizes)), sizes[0]
        log(f"  batched_gemm at run 2's median dispatch of one row count: {len(sizes)} x M={M} "
            f"-> R={R} (pow2 bucket), K={RAGGED_K} N={RAGGED_N} bf16")
    else:  # no dispatch of one row count happened: a decode-sized problem alone
        R, M = 1, int(np.median([m for tick in ragged_trace(seed) for _, m in tick if m <= 16]))
        log(f"  run 2 made no dispatch of one row count; batched_gemm bf16 at R=1, M={M}")
    x, w, err = check_batched(ops, gen, dev, torch.bfloat16, R, M, RAGGED_K, RAGGED_N)
    k1b = measure_batched(ops, x, w, err)
    by_rows = sorted(ragged, key=lambda r: r[1][1])
    sizes, (offs, T, bg, G) = by_rows[len(by_rows) // 2]
    log(f"  grouped_gemm at run 2's median ragged dispatch: M={sizes} -> T={T} rows, "
        f"{G} groups (pow2), bf16")
    x = torch.zeros((T, RAGGED_K), device=dev)
    for o, m in zip(offs, sizes):
        x[int(o):int(o) + m] = torch.randn((m, RAGGED_K), generator=gen, device=dev)
    x = x.to(torch.bfloat16)
    w = torch.zeros((G, RAGGED_K, RAGGED_N), device=dev, dtype=torch.bfloat16)
    w[: len(sizes)] = torch.randn((len(sizes), RAGGED_K, RAGGED_N), generator=gen,
                                  device=dev).to(torch.bfloat16)
    err = check_grouped(ops, "grouped_gemm bf16 at that layout", torch.bfloat16, x, w, bg,
                        RAGGED_BM)
    k2 = measure_grouped(ops, x, w, bg, RAGGED_BM, err)
    rows = []
    for name, shape, cnt, row in (
            ("batched_gemm", "run 1's median dispatch, f32", counts1["batched_gemm"], k1),
            ("batched_gemm", "run 2's median dispatch of one row count, bf16",
             counts2["batched_gemm"], k1b),
            ("grouped_gemm", "run 2's median ragged dispatch, bf16", counts2["grouped_gemm"], k2)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": GEMM_REPLACES[name], "shape": shape, "launches": cnt[0],
                     "launches_by_variant": cnt[2], **row})
    return rows


def profile_gemm_stream(ops, dev, seed):
    """Where a merged GEMM dispatch's time goes: torch.profiler over run 1's
    stream (K1) and run 2's (K2). Prints the mean dispatch time (the
    scheduler's busy time over its dispatches), the device's kernel time per
    dispatch, its idle share over the run (the stream sleeps 0.2 ms per
    tick), and the kernels and host ops that take the most time. Profiled
    times include the profiler's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import DynamicSpaceTimeScheduler

    for run, (ticks, make_problem), ragged in (("run 1", ablation_stream(dev, seed), False),
                                               ("run 2", ragged_stream(dev, seed), True)):
        sched = DynamicSpaceTimeScheduler(
            ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64,
                           allow_ragged_merge=ragged))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_gemm_stream(ops, sched, ticks, make_problem)
            wall = time.perf_counter() - t0
        n = sched.stats.dispatches
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        log(f"  profile {run}: wall {wall * 1e3:.3f} ms, {n} dispatches, mean dispatch "
            f"{sched.stats.busy_time_s / n * 1e3:.3f} ms (scheduler busy time), device kernels "
            f"{busy_us / n / 1e3:.3f} ms per dispatch, device idle share "
            f"{1 - busy_us / 1e6 / wall:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    device {e.self_device_time_total / n / 1e3:8.3f} ms/dispatch "
                f"{e.count / n:5.1f}x  {e.key[:80]}")
        host = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU]
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
            log(f"    host   {e.self_cpu_time_total / n / 1e3:8.3f} ms/dispatch "
                f"{e.count / n:5.1f}x  {e.key[:80]}")
        del sched
        torch.cuda.empty_cache()


def phase_gemm(ops, dev, seed, profile=False):
    import torch

    log(" (a) K1 batched_gemm and K2 grouped_gemm against their plain versions")
    phase_gemm_kernels(ops, dev, seed)
    log(" (b) Table 1 on the card: four strategies, float32, min of "
        f"{TABLE1_REPS} runs, GFLOP/s")
    ops.reset_counters()
    phase_table1(ops, dev, seed)
    counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTERS.items()}
    log(f"  launches / plain calls over the sweep: {counts}")
    if any(counts[k][1] for k in GEMM_REPLACES):
        raise PhaseFailed(f"plain versions were called in the Table 1 sweep: {counts}")
    torch.cuda.empty_cache()
    log(" (c) the scheduler on stochastic GEMM streams (WallClock)")
    counts, sizes1, ragged, single = phase_gemm_scheduler(ops, dev, seed)
    log(f"  GEMM path launches (run 1; run 2): "
        f"{ {k: counts[0][k][0] for k in GEMM_REPLACES} }; "
        f"{ {k: counts[1][k][0] for k in GEMM_REPLACES} }")
    log("kernels at the GEMM path's shapes")
    rows = gemm_path_kernel_rows(ops, dev, seed, counts, sizes1, ragged, single)
    if profile:
        profile_gemm_stream(ops, dev, seed)
    return rows


def phase_gemm_apart(seed, profile):
    """Phase 4 in a child process with CUDA_DEVICE_MAX_CONNECTIONS set (it
    reuses the kernels this run built); returns its kernels rows."""
    with tempfile.TemporaryDirectory() as tmp:
        rows_file = Path(tmp) / "rows.json"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--phases", "4",
               "--seed", str(seed), "--rows-out", str(rows_file)]
        env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS=GEMM_MAX_CONNECTIONS)
        try:
            rc = subprocess.run(cmd + (["--profile"] if profile else []), env=env,
                                timeout=GEMM_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"phase 4 took more than {GEMM_TIMEOUT_S} s") from None
        if rc != 0:
            raise PhaseFailed(f"phase 4 exited with {rc}")
        return json.loads(rows_file.read_text())


# ----------------------------------------------------------------- phase 5
# The RWKV-6 serving path: K5 wkv6_scan against its plain version, the
# full-width model, and four rwkv6-1.6b tenants through the engine.
#
# K5 tolerances. The final state is float32 in both versions, from the
# same inputs; only the order of float32 sums differs, over a 64-term dot
# and T steps of an accumulating state: the JAX kernel test's own rtol
# 2e-4, atol 2e-3, in both dtypes. Outputs: that in f32; in bf16 both
# round the same float32 value once, so TOL's bf16 (2e-2, 2e-2) covers a
# flipped rounding step.
RWKV = "rwkv6-1.6b"
WKV_TOL = (2e-4, 2e-3)
WKV_HEADS, WKV_N = 32, 64                # rwkv6-1.6b: H heads of N = V = 64
WKV_TS = (1, 17, 128, 777, 1024)
CHUNK_SPLIT = 512                        # chunked prefills: 777 = 512 + 265
# decay logits w ~ N(mean, std) besides the default N(-3, 1): strong decay
# (products of 16 decays underflow to 0 inside a chunk) and weak (d ~ 0.9997)
WKV_DECAYS = {"strong": (1.0, 1.0), "weak": (-8.0, 0.5)}
LORA_B_SCALE = 0.1                       # w_lora_b std: a data-dependent decay


def live_decay_(params, gen):
    """Random w_lora_b in every RWKV layer. At the JAX init it is zero, so
    the decay is the constant exp(-exp(-4)) and K5's per-token decay would
    go untested; a trained model's is data-dependent."""
    from repro_torch.models import layers

    for lp in params["layers"]:
        layers.normal_(lp["w_lora_b"], LORA_B_SCALE, gen)


def wkv_inputs(gen, dev, dtype, T, w_dtype=None, w_mean=-3.0, w_std=1.0, N=WKV_N):
    """r, k, v, w as the serving path hands them to K5: (1, T, H, N)
    projections read as (1, H, T, N) views (N = V, rwkv6's 64 by default);
    r, k, v ~ 0.5 N(0, 1) and decay logits w ~ N(w_mean, w_std) (by default
    decays from 0.37 to 0.998); u (H, N) ~ 0.3 N(0, 1)."""
    import torch

    shape = (1, T, WKV_HEADS, N)

    def proj(scale, shift=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return t.to(dt).transpose(1, 2)

    r, k, v = proj(0.5), proj(0.5), proj(0.5)
    w = proj(w_std, w_mean, w_dtype or dtype)
    u = torch.randn((WKV_HEADS, N), generator=gen, device=dev) * 0.3
    return r, k, v, w, u


def wkv_work(T, dtype, w_dtype=None):
    """(bytes, float32 flops) of one scan over WKV_HEADS heads of N = V =
    WKV_N (``wkv_case_work``), a float32 w beside bf16 r, k, v read at 4
    bytes."""
    nbytes, flops = wkv_case_work(WKV_HEADS, T, WKV_N, WKV_N, dtype)
    if "float32" in str(w_dtype) and "bfloat16" in str(dtype):
        nbytes += 2 * WKV_HEADS * T * WKV_N
    return nbytes, flops


def check_wkv(ops, name, dtype, inputs, s0, kernel=None):
    """K5 (``variant``'s kernel, or ``kernel`` launched directly) against
    its plain version on one case; returns (max error, out, final state)."""
    import torch

    from repro_torch.kernels import wkv6_scan as wk

    kind = kernel or wk.variant(dtype, inputs[0].shape[-2])
    if kernel is None:
        got, gs = ops.wkv6_scan(*inputs, init_state=s0)
    else:
        got, gs = wk.wkv6_scan(*inputs, init_state=s0, kernel=kernel)
    want, ws = ops.wkv6_scan_plain(*inputs, init_state=s0)
    torch.cuda.synchronize()
    out_tol = WKV_TOL if dtype == torch.float32 else None
    err = check_close(f"{name} [{kind}] out", got, want, str(dtype), out_tol)
    check_close(f"{name} [{kind}] final state", gs, ws, "torch.float32", WKV_TOL)
    return err, got, gs


def phase_wkv_kernel(ops, dev, seed):
    """(a) K5 against its plain version: f32 and bf16, every T of WKV_TS,
    from a zero and a random state; a 777-step scan against 512 steps then
    265 from the carried state (in one buffer, as the model's cache); strong
    and weak decay at T = 777; the (BH, T, N) form and a float32 w beside
    bf16 r, k, v."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for T in WKV_TS:
            inputs = wkv_inputs(gen, dev, dtype, T)
            check_wkv(ops, f"wkv6_scan {tag} T={T} zero state", dtype, inputs, None)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            _, whole, whole_state = check_wkv(ops, f"wkv6_scan {tag} T={T} random state",
                                              dtype, inputs, s0)
            if T != 777:
                continue
            buf = s0.clone()
            parts = [ops.wkv6_scan(*(t[:, :, a:b] for t in inputs[:4]), inputs[4],
                                   init_state=buf, final_state=buf)[0]
                     for a, b in ((0, CHUNK_SPLIT), (CHUNK_SPLIT, T))]
            torch.cuda.synchronize()
            split = torch.cat(parts, dim=2)
            check_close(f"wkv6_scan {tag} 512 + 265 from the carried state vs 777 out",
                        split, whole, str(dtype), WKV_TOL)
            check_close(f"wkv6_scan {tag} 512 + 265 vs 777 final state", buf, whole_state,
                        "torch.float32", WKV_TOL)
            log(f"    split bit-identical to whole: out {bool(torch.equal(split, whole))}, "
                f"state {bool(torch.equal(buf, whole_state))}")
        for regime, (mean, std) in WKV_DECAYS.items():
            inputs = wkv_inputs(gen, dev, dtype, 777, w_mean=mean, w_std=std)
            name = f"wkv6_scan {tag} T=777 {regime} decay, w ~ N({mean}, {std}),"
            check_wkv(ops, f"{name} zero state", dtype, inputs, None)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            check_wkv(ops, f"{name} random state", dtype, inputs, s0)
        r, k, v, w, u = wkv_inputs(gen, dev, dtype, 777)
        flat = [t.reshape(WKV_HEADS, 777, WKV_N) for t in (r, k, v, w)]  # (BH, T, N) copies
        check_wkv(ops, f"wkv6_scan {tag} (BH, T, N) contiguous, u (BH, N)", dtype,
                  (*flat, u.contiguous()), None)
    r, k, v, w, u = wkv_inputs(gen, dev, torch.bfloat16, 777, w_dtype=torch.float32)
    check_wkv(ops, "wkv6_scan bf16 with float32 w", torch.bfloat16, (r, k, v, w, u), None)


def measure_wkv(ops, dev, seed, T, launches, by_variant):
    """K5 at a median prompt of the serving run, bf16, as the path calls it
    (strided views, state updated in place in one buffer), checked and timed
    beside its plain version; its first, sequential kernel too (checked,
    then timed as ``prior_ms``), launched explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import wkv6_scan as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    inputs = wkv_inputs(gen, dev, torch.bfloat16, T)
    state = torch.zeros((WKV_HEADS, WKV_N, WKV_N), device=dev)
    name = f"wkv6_scan bf16 at a median prompt, T={T}"
    err, _, _ = check_wkv(ops, name, torch.bfloat16, inputs, state)
    check_wkv(ops, name, torch.bfloat16, inputs, state, kernel="sequential")
    nbytes, flops = wkv_work(T, torch.bfloat16)
    bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
    row = {
        "variant": wk.variant(torch.bfloat16, T),
        "shape": f"median prompt: {WKV_HEADS} heads, T={T}, bf16",
        "launches_by_variant": by_variant,
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.wkv6_scan(*inputs, init_state=state, final_state=state), 20),
        "prior_ms": time_ms(lambda: wk.wkv6_scan(*inputs, init_state=state, final_state=state,
                                                 kernel="sequential"), 20),
        "plain_ms": time_ms(lambda: ops.wkv6_scan_plain(*inputs, init_state=state,
                                                        final_state=state), 3, 1),
        "library_ms": None,  # no single PyTorch call computes the WKV6 recurrence
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} prior_ms={row['prior_ms']:.4f} (sequential, "
        f"{row['prior_ms'] / row['ms']:.2f}x) plain_ms={row['plain_ms']:.4f} library: none (no "
        f"PyTorch call computes WKV6) bound_ms={bound_ms:.4f} ({bound_by}; bytes "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f}, operations "
        f"{flops / PEAK_FLOPS['torch.float32'] * 1e3:.4f}) kernel/bound={row['ms'] / bound_ms:.1f}")
    return {"name": "wkv6_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6_scan.cu",
            "replaces": REPLACES["wkv6_scan"], "launches": launches, **row}


# The state pass (K5-state, ``wkv6_state``): the float32 state after T steps
# from float32 w, what a bf16 prefill keeps. Its median-prompt check draws w ~
# N(STATE_W_MEAN, 1): decays slow enough that the incoming state survives
# the prompt and w's bf16 rounding accumulates, so each of the check's three
# controls (w rounded to bf16, T - 1 steps, the state dropped) must fail it
# (at rwkv6's N(-3, 1) the state is forgotten within a few hundred steps).
STATE_W_MEAN = -6.0
STATE_HEADS = ((16, 32), (32, 16), (8, 8), (32, 32), (64, 8))  # (N, V) besides 64 x 64


def state_work(BH, T, N, V, dtype):
    """(bytes, float32 flops) of one state pass: k, v in ``dtype`` and w in
    float32 read once, the state read and written once; 3 N V flops per
    head-step (k v, d S, the sum)."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    nbytes = BH * T * ((N + V) * esize + 4 * N) + 2 * 4 * BH * N * V
    return nbytes, 3 * N * V * BH * T


def state_bound(BH, T, N, V, dtype, kind):
    """K5-state's bound from ``state_work``: the larger of its bytes at the
    memory rate and its operations at the rate of the units its ``kind`` of
    kernel runs them on: the CUDA cores' float32 rate for ``segmented``;
    for ``row_blocks``, whose tiles are tensor-core products, float32-
    accurate TF32 passes as SSD-scan's (``ssd_scan_bound``: two for bf16 v,
    exact in TF32, three for float32). Returns (bound_ms, bound_by)."""
    nbytes, flops = state_work(BH, T, N, V, dtype)
    if kind != "row_blocks":
        return bound(nbytes, flops, "torch.float32")
    passes = 2 if "bfloat16" in str(dtype) else 3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops * passes / PEAK_FLOPS["tf32"] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def check_state(ops, name, k, v, w, s0, kernel=None):
    """The state pass (its wrapper's rule, or ``kernel`` launched directly)
    against its plain version from ``s0`` (None: zero), at WKV_TOL, tagged
    with the variant its wrapper counted; returns (max error, the kernel's
    state)."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    counter = ops.COUNTERS["wkv6_state"]
    before = counter.copy()
    got = (ops.wkv6_state(k, v, w, init_state=s0) if kernel is None else
           ws.wkv6_state(k, v, w, s0, kernel=kernel))
    want = ops.wkv6_state_plain(k, v, w, init_state=s0)
    torch.cuda.synchronize()
    kinds = sorted(counter.since(before).variants)
    if kinds == ["segmented"]:
        kinds = [f"segmented, {ws.segments(got.shape[0], k.shape[-2])} segments"]
    tag = f"{name} [{', '.join(kinds)}]"
    return check_close(tag, got, want, "torch.float32", WKV_TOL), got


def phase_state_kernel(ops, dev, seed):
    """(a) the state pass against its plain version: bf16 and float32 k, v
    with float32 w, every T of WKV_TS, from a zero and a random state, in
    one buffer (``final_state is init_state``) bitwise as into a new one;
    777 steps against 512 then 265 from the carried state; strong and weak
    decay; the (BH, T, N) form; the head sizes of STATE_HEADS under both
    kernels."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    for dtype in (torch.float32, torch.bfloat16):
        tag = f"wkv6_state {str(dtype)[6:]} k, v, float32 w"
        for T in WKV_TS:
            _, k, v, w, _ = wkv_inputs(gen, dev, dtype, T, w_dtype=torch.float32)
            check_state(ops, f"{tag} T={T} zero state", k, v, w, None)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            _, whole = check_state(ops, f"{tag} T={T} random state", k, v, w, s0)
            buf = s0.clone()
            if ops.wkv6_state(k, v, w, init_state=buf, final_state=buf) is not buf:
                raise PhaseFailed(f"{tag}: the state is not the caller's buffer")
            torch.cuda.synchronize()
            if not torch.equal(buf, whole):
                raise PhaseFailed(f"{tag} T={T}: in place is not bitwise the new buffer's state")
            if T != 777:
                continue
            buf = s0.clone()
            for a, b in ((0, CHUNK_SPLIT), (CHUNK_SPLIT, T)):
                ops.wkv6_state(*(t[:, :, a:b] for t in (k, v, w)), init_state=buf,
                               final_state=buf)
            torch.cuda.synchronize()
            check_close(f"{tag} 512 + 265 from the carried state vs 777", buf, whole,
                        "torch.float32", WKV_TOL)
        for regime, (mean, std) in WKV_DECAYS.items():
            _, k, v, w, _ = wkv_inputs(gen, dev, dtype, 777, w_dtype=torch.float32,
                                       w_mean=mean, w_std=std)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            check_state(ops, f"{tag} T=777 {regime} decay, w ~ N({mean}, {std})", k, v, w, s0)
        _, k, v, w, _ = wkv_inputs(gen, dev, dtype, 777, w_dtype=torch.float32)
        flat = [t.reshape(WKV_HEADS, 777, WKV_N) for t in (k, v, w)]  # (BH, T, N) copies
        check_state(ops, f"{tag} (BH, T, N) contiguous", *flat, None)
        for N, V in STATE_HEADS:
            _, k, v, w, _ = wkv_case_inputs(gen, dev, dtype, 8, 200, N, V)
            s0 = torch.randn((8, N, V), generator=gen, device=dev)
            for kind in ws.VARIANT_CODES:
                check_state(ops, f"{tag} (BH, T, N, V)={(8, 200, N, V)}", k, v, w.float(), s0,
                            kernel=kind)


ROW_BLOCK_HEADS = (8, 32, 64)  # N = V of the row-block checks at every piece size


def phase_row_blocks(ops, dev, seed):
    """(a) the state pass's row-block kernel (launched directly) against its
    plain version at every piece size (``state_pieces``) and N = V in
    ROW_BLOCK_HEADS, bf16 and float32 k, v as the model's (1, H, T, N)
    views, float32 w ~ N(STATE_W_MEAN, 1), from a random state; in one buffer
    (``final_state is init_state``) bitwise as into a new one. ``ok`` only
    after its control fails the same check: one row of one head's incoming
    state perturbed, which must move that row alone (the rows are
    independent), every other row bitwise as before."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 14)
    name = "wkv6_state row_blocks, 512-token piece, N = V = 64, bf16, random state"
    _, k, v, w, _ = wkv_inputs(gen, dev, torch.bfloat16, 512, w_dtype=torch.float32,
                               w_mean=STATE_W_MEAN)
    s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
    want = ops.wkv6_state_plain(k, v, w, init_state=s0)
    good = ws.wkv6_state(k, v, w, s0, kernel="row_blocks")
    bad_in = s0.clone()
    bad_in[3, 37] += 1.0  # head 3, row 37: the third of its four row blocks
    bad = ws.wkv6_state(k, v, w, bad_in, kernel="row_blocks")
    torch.cuda.synchronize()
    moved = (bad != good).any(dim=-1)
    if moved.sum() != 1 or not moved[3, 37]:
        raise PhaseFailed(f"{name}: a perturbed state row moved rows "
                          f"{moved.nonzero().tolist()}, not (3, 37) alone")

    def control():
        check_close(name, bad, want, "torch.float32", WKV_TOL)

    must_fail("one row of the incoming state perturbed", control)
    for dtype in (torch.bfloat16, torch.float32):
        for N in ROW_BLOCK_HEADS:
            for T in state_pieces():
                _, k, v, w, _ = wkv_inputs(gen, dev, dtype, T, w_dtype=torch.float32,
                                           w_mean=STATE_W_MEAN, N=N)
                s0 = torch.randn((WKV_HEADS, N, N), generator=gen, device=dev)
                tag = f"wkv6_state {str(dtype)[6:]} T={T} N=V={N} random state"
                _, whole = check_state(ops, tag, k, v, w, s0, kernel="row_blocks")
                buf = s0.clone()
                if ws.wkv6_state(k, v, w, buf, buf, kernel="row_blocks") is not buf:
                    raise PhaseFailed(f"{tag}: the state is not the caller's buffer")
                torch.cuda.synchronize()
                if not torch.equal(buf, whole):
                    raise PhaseFailed(f"{tag}: in place is not bitwise the new buffer's state")


def measure_state(ops, dev, seed, T):
    """The state pass at a median prompt of the serving run (bf16 k, v as
    (1, H, T, N) views, float32 w ~ N(STATE_W_MEAN, 1), a random state):
    ``ok`` only after its three controls fail the same check; then timed in
    turns with its prior, the chunked K5 launched on the same inputs with
    float32 w (the prefill's second launch before the state pass), beside
    its plain version and its bound. Returns the kernels row without the
    main path's launches."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 12)
    r, k, v, w, u = wkv_inputs(gen, dev, torch.bfloat16, T, w_dtype=torch.float32,
                               w_mean=STATE_W_MEAN)
    s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
    want = ops.wkv6_state_plain(k, v, w, init_state=s0)
    name = f"wkv6_state at a median prompt, T={T}, w ~ N({STATE_W_MEAN}, 1), random state"

    def control(k_, v_, w_, s_):
        def run():
            got = ops.wkv6_state(k_, v_, w_, init_state=s_)
            torch.cuda.synchronize()
            check_close(name, got, want, "torch.float32", WKV_TOL)
        return run

    must_fail("w rounded to bf16", control(k, v, w.to(torch.bfloat16).float(), s0))
    must_fail(f"{T - 1} steps", control(k[:, :, :-1], v[:, :, :-1], w[:, :, :-1], s0))
    must_fail("the incoming state dropped", control(k, v, w, None))
    err, _ = check_state(ops, name, k, v, w, s0)
    buf, prior_buf = s0.clone(), s0.clone()
    ms, prior_ms, turns = timed_turns(
        lambda: ops.wkv6_state(k, v, w, init_state=buf, final_state=buf),
        lambda: ops.wkv6_scan(r, k, v, w, u, init_state=prior_buf, final_state=prior_buf), 20)
    bound_ms, bound_by = state_bound(WKV_HEADS, T, WKV_N, WKV_N, torch.bfloat16, ws.variant(T))
    row = {
        "variant": ws.variant(T), "segments": ws.segments(WKV_HEADS, T),
        "shape": f"median prompt: {WKV_HEADS} heads, T={T}, bf16 k, v, float32 w",
        "max_abs_err": err, "ms": ms, "prior": "wkv6_scan chunked, float32 w", "prior_ms": prior_ms,
        "turns_ms": turns,
        "plain_ms": time_ms(lambda: ops.wkv6_state_plain(k, v, w, init_state=buf,
                                                         final_state=buf), 3, 1),
        "library_ms": None,  # no single PyTorch call computes the WKV6 state
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={ms:.4f} prior_ms={prior_ms:.4f} (the chunked K5 with float32 w, "
        f"{prior_ms / ms:.2f}x; turns {', '.join(f'{t:.4f}' for t in turns)}) "
        f"plain_ms={row['plain_ms']:.4f} library: none bound_ms={bound_ms:.4f} ({bound_by}) "
        f"kernel/bound={ms / bound_ms:.1f}")
    return {"name": "wkv6_state", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/wkv6_state.cu",
            "replaces": REPLACES["wkv6_state"], **row}


def stage_logits(model, params, tokens, decode_tokens, keep=None):
    """Logits of a whole prefill, a chunked one (CHUNK_SPLIT + the rest) and
    decode steps fed ``decode_tokens`` after the whole prefill; and, where
    ``keep`` names a cache, copies of its tensors after the whole prefill."""
    import torch

    out = {}
    logits, caches = model.forward_prefill(params, tokens, CACHE_LEN)
    out["prefill"] = logits
    kept = None if keep is None else [c.clone() for c in caches[keep]]
    _, cc = model.forward_prefill(params, tokens[:, :CHUNK_SPLIT], CACHE_LEN)
    out["chunked"], _ = model.forward_prefill(params, tokens[:, CHUNK_SPLIT:], CACHE_LEN,
                                              caches=cc, start=CHUNK_SPLIT)
    del cc
    lengths = torch.tensor([tokens.shape[1]], device=tokens.device)
    for step, tok in enumerate(decode_tokens):
        out[f"decode step {step}"], caches = model.forward_decode(params, tok, caches, lengths)
        lengths = lengths + 1
    return out, kept


def phase_rwkv_model(ops, dev, seed):
    """(b) rwkv6-1.6b at full width: kernel path against plain path on the
    same seeded weights (data-dependent decay), in float32 and in bf16
    (``model_vs_plain_f32_bf16``).

    In float32 the two paths differ by float32 rounding alone, and the
    kernel path must be within MODEL_RTOL of the plain path (a wrong scan
    moves logits by O(1) of the largest). In bf16 a flipped rounding of
    one scan output grows through 24 layers and 777 tokens of recurrent
    state: two bf16 runs whose scans differ only in the order of float32
    sums end several percent apart. So in bf16 both paths are held against
    the float32 plain path (``hold_bf16``)."""
    from repro_torch.config import get_config

    def state_gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    kept = model_vs_plain_f32_bf16(ops, get_config(RWKV), dev, seed, init=live_decay_,
                                   keep="wkv",
                                   note=f"w_lora_b ~ {LORA_B_SCALE} N(0, 1)")
    log(f"  wkv state after the whole prefill, max over layers of max |d| / max |S|, kernel vs "
        f"plain: f32 {state_gap(kept['f32', False], kept['f32', True]):.3e}, bf16 "
        f"{state_gap(kept['bf16', False], kept['bf16', True]):.3e}")


def hold_bf16(what, kernel, plain, ref32):
    """bf16 kernel-path logits against the float32 plain path's: no farther
    from them than twice the bf16 plain path is (plus 0.1% of the largest
    |logit|, so float32-level agreement always passes); the bf16 paths'
    distance from each other is printed beside it."""
    ref = ref32.float()
    scale = float(ref.abs().max())
    e_k = float((kernel.float() - ref).abs().max())
    e_p = float((plain.float() - ref).abs().max())
    e_kp = float((kernel.float() - plain.float()).abs().max())
    agree = bool((kernel.argmax(-1) == plain.argmax(-1)).all())
    ok = e_k <= 2 * e_p + 1e-3 * scale
    log(f"  bf16 {what}: kernel vs plain max_abs_err={e_kp:.4f} ({e_kp / scale:.2%} of max "
        f"|logit|) argmax_agree={agree}; vs the f32 plain path: kernel {e_k:.4f}, plain "
        f"{e_p:.4f} (kernel <= 2 x plain: {'ok' if ok else 'FAIL'})")
    if not ok:
        raise PhaseFailed(f"model bf16 {what}: the kernel path is farther from float32 than "
                          "twice the plain path")


def model_vs_plain_f32_bf16(ops, cfg, dev, seed, init=None, keep=None, note=""):
    """``cfg`` at full width on seeded random weights (``init(params, gen)``
    runs on them if given), the kernel path against the plain path over a
    whole prefill of PROMPT_LEN tokens, a chunked one (CHUNK_SPLIT + the
    rest) and DECODE_STEPS decode steps, in float32 (within MODEL_RTOL) and
    in bf16 (``hold_bf16``: each path against the float32 plain path; a
    bf16 rounding can flip a top-8-of-32 routing or grow through a
    recurrent state). The chunked prefill is held against the plain path's
    whole prefill, except for an MoE config, whose capacity is per chunk,
    where it is held against the plain path's chunked one. Fails unless
    each kernel run launched K4 once per attention layer per prefill or
    chunk and K3 once per attention layer per decode step, by the
    wrapper's rule at each dtype. Returns the ``keep`` cache's tensors
    after the whole prefill, by (dtype, plain)."""
    import dataclasses

    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = build_model(cfg, device=dev).init(gen)
    if init is not None:
        init(params, gen)
    n_attn = attention_layers(cfg)
    log(f"  {cfg.name} {cfg.dtype}: {tree_params(params) / 1e9:.3f}B params in the tree "
        f"({cfg.param_count() / 1e9:.3f}B by cfg.param_count()), {cfg.num_layers} layers, "
        f"{n_attn} with attention, d_model {cfg.d_model}{'; ' + note if note else ''}; "
        "float32 copy of the same weights")
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, PROMPT_LEN)), device=dev)
    decode_tokens = [torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1,)), device=dev)
                     for _ in range(DECODE_STEPS)]
    runs, kept = {}, {}
    ops.reset_counters()
    with torch.no_grad():
        for name, c in (("bf16", cfg), ("f32", cfg32)):
            p = params if name == "bf16" else tree_map(lambda t: t.float(), params)
            for plain in (False, True):
                model = build_model(c, device=dev, plain_kernels=plain)
                runs[name, plain], kept[name, plain] = stage_logits(model, p, tokens,
                                                                    decode_tokens, keep)
            del p
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()
    for op, per_run in (("flash_attention", 3 * n_attn), ("decode_attention", DECODE_STEPS * n_attn)):
        want = {}
        for dtype in (torch.bfloat16, torch.float32):
            if not per_run:
                continue
            kinds = ([fa.variant(dtype, cfg.head_dim)] if op == "flash_attention" else
                     k3_kinds(dtype, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads))
            for v in kinds:
                want[v] = want.get(v, 0) + per_run
        got = dict(ops.COUNTERS[op].variants)
        log(f"    {op} launches over both kernel runs: {got}")
        if got != want:
            raise PhaseFailed(f"{cfg.name}: {op} launches {got}, not {want}")
    from repro_torch.kernels import ssd

    n_mamba = mamba_layers(cfg)
    for op, variant, per_run in (("ssd_scan", ssd.SCAN_VARIANT, 3 * n_mamba),
                                 ("ssd_step", ssd.STEP_VARIANT, DECODE_STEPS * n_mamba)):
        c = ops.COUNTERS[op]
        want = {variant: 2 * per_run} if per_run else {}
        # the plain runs (plain_kernels=True) call the plain version as often
        if dict(c.variants) != want or c.plain_calls != 2 * per_run:
            raise PhaseFailed(f"{cfg.name}: {op} launches {dict(c.variants)} and plain calls "
                              f"{c.plain_calls}, not {want} and {2 * per_run}")
        if per_run:
            log(f"    {op} launches over both kernel runs: {dict(c.variants)}; plain calls over "
                f"both plain runs: {c.plain_calls}")
    k32, p32 = runs["f32", False], runs["f32", True]
    kbf, pbf = runs["bf16", False], runs["bf16", True]
    whole = cfg.moe is None
    for stage in k32:
        want = "prefill" if stage == "chunked" and whole else stage
        what = (f"{cfg.name} chunked prefill {CHUNK_SPLIT} + {PROMPT_LEN - CHUNK_SPLIT}"
                + (" vs whole" if whole else "")
                if stage == "chunked" else f"{cfg.name} {stage} ({PROMPT_LEN}-token prompt)")
        compare_logits(f"f32 {what}", k32[stage], p32[want])
        hold_bf16(what, kbf[stage], pbf[want], p32[want])
    log(f"    {time.perf_counter() - t0:.1f} s")
    return kept


@contextlib.contextmanager
def scan_w_dtypes():
    """The dtype of w at every call of K5's wrapper while open (a list);
    the calls themselves run unchanged."""
    from repro_torch.kernels import wkv6_scan as wk

    seen, real = [], wk.wkv6_scan

    def spy(r, k, v, w, *args, **kwargs):
        seen.append(w.dtype)
        return real(r, k, v, w, *args, **kwargs)

    wk.wkv6_scan = spy
    try:
        yield seen
    finally:
        wk.wkv6_scan = real


def phase_rwkv(ops, dev, seed, profile=False):
    """Phase 5: (a) K5 and the state pass, (b) the full-width model, (c) four
    rwkv6-1.6b tenants served in both modes; returns K5's and the state
    pass's kernels rows."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model, rwkv

    cfg = get_config(RWKV)
    prompts, lens = serve_prompts(cfg, seed)
    median = int(np.median(lens))
    log(" (a) K5 wkv6_scan against its plain version")
    phase_wkv_kernel(ops, dev, seed)
    log(" (a) the state pass wkv6_state against its plain version")
    phase_state_kernel(ops, dev, seed)
    log(" (a) its row-block kernel at every piece size of the graphed prefill")
    phase_row_blocks(ops, dev, seed)
    log(f"  the state pass at the serving run's median prompt (T={median}): controls, check, "
        "times")
    state_row = measure_state(ops, dev, seed, median)
    log(f" (b) {RWKV} at full width, kernel path vs plain path")
    phase_rwkv_model(ops, dev, seed)
    torch.cuda.empty_cache()
    log(f" (c) serving {REQUESTS} requests for {R_TENANTS} {RWKV} tenants")
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed, live_decay_)
    per_layer = rwkv.prefill_launches(model.dtype)
    with scan_w_dtypes() as w_dtypes:
        launches, per_mode, _ = serve_both_modes(model, stacked, prompts, ops, tuple(per_layer))
    # per layer and prefill pass (a piece of the prompt, on the piece route):
    # the outputs' scan (w rounded to the model dtype) and, in bf16, the
    # state pass (float32 w) for the kept state
    prefills = prefills_run(cfg, prompts)
    for mode, per in zip(("space_time", "time_only"), per_mode):
        for op, n in per_layer.items():
            if per[op] != cfg.num_layers * n * prefills:
                raise PhaseFailed(f"{mode}: {op} launched {per[op]} times, not "
                                  f"{cfg.num_layers * n} per prefill pass ({prefills})")
    # both ops' launches by (variant, piece length), as their wrappers count them
    counted = {op: ops.COUNTERS[op].copy() for op in per_layer}
    by_variant = {op: counted[op].variants for op in per_layer}
    log(f"  launches per mode: " + ", ".join(f"{op} {cfg.num_layers * n * prefills} = "
                                            f"{cfg.num_layers} layers x {n} x {prefills} prefill "
                                            f"passes ({REQUESTS} prompts)"
                                            for op, n in per_layer.items())
        + f"; by variant on the serving path: {by_variant}; w of the wkv6_scan calls "
        f"({len(w_dtypes)}: eager warm-ups and captures, whose launches replays repeat): "
        f"{sorted(set(str(d) for d in w_dtypes))}")
    if by_variant["wkv6_scan"] != {"chunked": launches["wkv6_scan"]}:
        raise PhaseFailed(f"wkv6_scan: {launches['wkv6_scan']} launches on the serving path, not "
                          f"all chunked: {by_variant['wkv6_scan']}")
    if "wkv6_state" in per_layer:
        check_state_launches(launches, counted)
    # every launch is an eager call or a replay of a captured call: the spy
    # sees both kinds of call, and a replay repeats what it saw captured
    if not w_dtypes or torch.float32 in w_dtypes:
        raise PhaseFailed(f"wkv6_scan: {len(w_dtypes)} calls for {launches['wkv6_scan']} launches, "
                          f"w dtypes {set(w_dtypes)}: a scan took float32 w")
    graph_checks(ops, cfg, model, stacked, prompts)
    if profile:
        profile_serving(model, stacked, prompts)
        profile_prefill(model, stacked, prompts)
    del stacked
    torch.cuda.empty_cache()
    log("kernels at the RWKV serving path's shapes")
    rows = [measure_wkv(ops, dev, seed, median, launches["wkv6_scan"], by_variant["wkv6_scan"])]
    if "wkv6_state" in per_layer:
        rows.append({**state_row, "launches": launches["wkv6_state"],
                     "launches_by_variant": by_variant["wkv6_state"]})
        rows += measure_state_pieces(ops, dev, seed, counted)
    return rows


def check_state_launches(launches, counted):
    """The serving path's K5-state and K5 launches, as their wrappers counted
    them by (variant, piece length) (``counted[op]``): every length a piece
    size (``state_pieces``); every K5-state launch up to
    ``ROW_BLOCKS_MAX_T`` steps the row-block kernel and every longer one
    segmented; one K5 launch beside each K5-state launch at every length;
    the counts by length summing to K5-state's launches."""
    from repro_torch.kernels import wkv6_state as ws

    state, scan = counted["wkv6_state"].sizes, counted["wkv6_scan"].sizes
    table = {T: {kind: n for (kind, t), n in counted["wkv6_state"].variant_sizes.items()
                 if t == T}
             for T in sorted(state, reverse=True)}
    log(f"  wkv6_state serving launches by piece size and variant: {table} (sum "
        f"{sum(state.values())} of {launches['wkv6_state']}); wkv6_scan by piece size: "
        f"{dict(sorted(scan.items(), reverse=True))}")
    wrong = {T: kinds for T, kinds in table.items()
             if set(kinds) != {"row_blocks" if T <= ws.ROW_BLOCKS_MAX_T else "segmented"}}
    if (wrong or not set(state) <= set(state_pieces()) or scan != state
            or sum(state.values()) != launches["wkv6_state"]):
        raise PhaseFailed(f"wkv6_state: serving launches by piece size and variant {table} "
                          f"(not the rule's at {sorted(wrong)}), {launches['wkv6_state']} in all; "
                          f"wkv6_scan by size {scan}")


def state_pieces():
    """Every piece size of the graphed prefill at phase 5's cache, longest
    first, by the engine's rule. K5-state and K5 get a row at each."""
    from repro_torch.serving.engine import piece_sizes

    return piece_sizes(0, CACHE_LEN)


PIECE_ITERS = 50  # timed launches a piece size


def piece_kernel_times(ops, gen, dev, T, state_prior=None):
    """K5-state and K5 at one T-token piece of the graphed prefill, called as
    ``rwkv_prefill`` calls them: 32 heads, bf16 r, k, v as (1, H, T, N)
    views, a random state; K5-state from float32 w ~ N(STATE_W_MEAN, 1) into
    the state in place, K5 from w rounded to bf16 into a scratch state. Each
    is checked against its plain version, then timed (``time_ms``) beside its
    plain version and its bound; ``state_prior(k, v, w, s0, s_out)``, where
    given, is another K5-state kernel, checked likewise and timed in turns
    with the rule's (``timed_turns``). Returns {op: record}, each with the
    variant its wrapper counted for one launch. Reads nothing of the
    wrappers but their counters, so it times an older checkout's kernels
    too (``experiments/prefill_turns.py --routes state``)."""
    import torch

    r, k, v, w, u = wkv_inputs(gen, dev, torch.bfloat16, T, w_dtype=torch.float32,
                               w_mean=STATE_W_MEAN)
    wb = w.to(torch.bfloat16)
    s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
    buf, prior_buf, scratch = s0.clone(), s0.clone(), torch.empty_like(s0)
    err_state, _ = check_state(ops, f"wkv6_state a {T}-token piece from a random state",
                               k, v, w, s0)
    err_scan, _, _ = check_wkv(ops, f"wkv6_scan a {T}-token piece from a random state",
                               torch.bfloat16, (r, k, v, wb, u), s0)
    cases = {
        "wkv6_state": (err_state, None,
                       lambda: ops.wkv6_state(k, v, w, init_state=buf, final_state=buf),
                       lambda: ops.wkv6_state_plain(k, v, w, init_state=buf, final_state=buf)),
        "wkv6_scan": (err_scan, wkv_work(T, torch.bfloat16),
                      lambda: ops.wkv6_scan(r, k, v, wb, u, init_state=s0, final_state=scratch),
                      lambda: ops.wkv6_scan_plain(r, k, v, wb, u, init_state=s0,
                                                  final_state=scratch)),
    }
    recs = {}
    for op, (err, work, kernel, plain) in cases.items():
        before = ops.COUNTERS[op].copy()
        kernel()
        (kind,) = ops.COUNTERS[op].since(before).variants
        bound_ms, bound_by = (bound(*work, "torch.float32") if work else
                              state_bound(WKV_HEADS, T, WKV_N, WKV_N, torch.bfloat16, kind))
        recs[op] = {"T": T, "variant": kind, "max_abs_err": err,
                    "plain_ms": time_ms(plain, 3, 1), "bound_ms": bound_ms, "bound_by": bound_by}
        if op == "wkv6_state" and state_prior is not None:
            want = ops.wkv6_state_plain(k, v, w, init_state=s0)
            got = state_prior(k, v, w, s0, scratch)
            torch.cuda.synchronize()
            check_close(f"wkv6_state prior at a {T}-token piece", got, want, "torch.float32",
                        WKV_TOL)
            recs[op]["ms"], recs[op]["prior_ms"], recs[op]["turns_ms"] = timed_turns(
                kernel, lambda: state_prior(k, v, w, prior_buf, prior_buf), PIECE_ITERS)
        else:
            recs[op]["ms"] = time_ms(kernel, PIECE_ITERS)
    return recs


def measure_state_pieces(ops, dev, seed, counted):
    """K5-state's and K5's rows at every piece size of the graphed prefill
    (``state_pieces``, ``piece_kernel_times``; K5-state's row-block pieces
    with the segmented kernel launched on the same inputs as their prior),
    each with the serving path's launches at that size by variant, as the
    wrappers counted them (``counted[op]``, over both modes)."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    def segmented(k, v, w, s0, s_out):
        return ws.wkv6_state(k, v, w, s0, s_out, kernel="segmented")

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 13)
    sources = {"wkv6_state": "src/repro_torch/kernels/csrc/wkv6_state.cu",
               "wkv6_scan": "src/repro_torch/kernels/csrc/wkv6_scan.cu"}
    rows = []
    for T in state_pieces():
        prior = segmented if ws.variant(T) != "segmented" else None
        for op, rec in piece_kernel_times(ops, gen, dev, T, prior).items():
            at_T = {kind: n for (kind, t), n in counted[op].variant_sizes.items() if t == T}
            prior_ms = rec.get("prior_ms")
            log(f"    {op} T={T} [{rec['variant']}]: ms={rec['ms']:.4f} "
                + (f"prior_ms={prior_ms:.4f} (segmented, turns "
                   f"{', '.join(f'{x:.4f}' for x in rec['turns_ms'])}) " if prior_ms else "")
                + f"plain_ms={rec['plain_ms']:.4f} library: none bound_ms={rec['bound_ms']:.4f} "
                f"({rec['bound_by']}) kernel/bound={rec['ms'] / rec['bound_ms']:.1f} serving "
                f"launches at this size {at_T}")
            rows.append({"name": op, "route": "cuda", "source": sources[op],
                         "replaces": REPLACES[op], "variant": rec["variant"],
                         "shape": f"a {T}-token piece of the graphed prefill: {WKV_HEADS} heads, "
                                  + ("bf16 k, v, float32 w" if op == "wkv6_state" else
                                     "bf16 r, k, v, w") + ", from a state",
                         "launches": sum(at_T.values()), "launches_by_variant": at_T,
                         "launches_counted": "at this piece size",
                         "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                         "prior": "wkv6_state segmented" if prior_ms else None,
                         "prior_ms": prior_ms, "turns_ms": rec.get("turns_ms"),
                         "plain_ms": rec["plain_ms"], "library_ms": None,
                         "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"]})
    return rows


def profile_prefill(model, stacked, prompts):
    """Where a prefill's time goes, by route: torch.profiler over one
    tenant's prefill of the median prompt (after two unprofiled ones) as a
    whole prompt (eager), as the engine's pieces run eagerly, and as the
    pieces replayed from the programs an engine captured at its build.
    Prints each route's host wall, device time in kernels, idle share and
    kernel count, and K5's and the state pass's time, launches and share of
    the kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.tenancy import tenant_view
    from repro_torch.serving import EngineConfig, MultiTenantEngine

    t, prompt = sorted(prompts, key=lambda p: len(p[1]))[len(prompts) // 2]
    params = tenant_view(stacked, t)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=model.device)[None, :]
    routes = [("whole", lambda: model.forward_prefill(params, tokens, CACHE_LEN))]
    if takes_pieces(model.cfg):
        for name, graphs in (("pieces, eager", False), ("pieces, graphed", True)):
            t0 = time.perf_counter()
            eng = MultiTenantEngine(model, stacked_params=stacked, graphs=graphs, pieces=True,
                                    config=EngineConfig(num_tenants=R_TENANTS, slots_per_tenant=1,
                                                        cache_len=CACHE_LEN))
            st = eng.programs.stats()
            log(f"  {name} engine built in {time.perf_counter() - t0:.3f} s: "
                f"{st['prefill_captures']} captures in {st['prefill_capture_s']:.3f} s, "
                f"{st['prefill_pool_bytes'] / 2**20:.1f} MiB reserved")
            routes.append((name, lambda eng=eng: eng._run_pieces(t, tokens)))
    for name, run in routes:
        with torch.no_grad():
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        parts = {}
        for what, key in (("K4", "flash_"), ("K5", "wkv6_chunked"), ("K5-state", "wkv6_state")):
            mine = [e for e in kernels if key in e.key]
            if mine:
                parts[what] = (sum(e.self_device_time_total for e in mine),
                               sum(e.count for e in mine))
        log(f"  profile prefill of {tokens.shape[1]} tokens (tenant {t}), {name}: wall "
            f"{wall * 1e3:.3f} ms, kernels {busy_us / 1e3:.3f} ms (idle share "
            f"{1 - busy_us / 1e6 / wall:.3f}), {sum(e.count for e in kernels)} device activities"
            + "".join(f"; {what} {us / 1e3:.3f} ms in {n} launches, share of kernel time "
                      f"{us / max(busy_us, 1e-9):.3f}, of wall {us / 1e6 / wall:.3f}"
                      for what, (us, n) in parts.items()))
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")
    del routes
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 6
# paligemma-3b at full width: head dim 256, one kv head for 8
# query heads, its stub SigLIP frontend fed 256 seeded patch embeddings;
# then musicgen-large, qwen2-7b, granite-3-8b and gemma3-27b.
PALI = "paligemma-3b"
# (arch, layers kept, prompt tokens): full width, depth cut so the whole run
# stays in time. gemma3 keeps 6 layers, so its sixth (global) layer runs
# beside five sliding-window ones, and a prompt past its 1024-key window, so
# K4 masks by the window and the ring caches wrap.
OTHER_CONFIGS = (("musicgen-large", 2, PROMPT_LEN), ("qwen2-7b", 2, PROMPT_LEN),
                  ("granite-3-8b", 2, PROMPT_LEN), ("gemma3-27b", 6, 1300))
OTHER_DECODE_STEPS = 4


def phase_pali(ops, dev, seed, profile=False):
    """Phase 6: (a) paligemma-3b's kernel path against its plain path over
    a prefill of 256 prefix embeddings + 521 tokens and 8 decode steps; (b)
    four tenants served in both modes (K4 wgmma at D = 256 once per layer
    per prefill, K3 mma), with its kernels rows; (c) musicgen-large,
    qwen2-7b, granite-3-8b and gemma3-27b, kernel path against plain path
    over a prefill and 4 decode steps. Returns the kernels rows."""
    import dataclasses

    import torch

    from repro_torch.config import get_config

    cfg = get_config(PALI)
    if cfg.head_dim != 256:
        raise PhaseFailed(f"{PALI}: head dim {cfg.head_dim}, not 256")
    log(f" (a) {PALI} at full width, kernel path vs plain path")
    model_vs_plain(ops, cfg, dev, seed, PROMPT_LEN, DECODE_STEPS)
    log(f" (b) serving {REQUESTS} requests for {R_TENANTS} {PALI} tenants (text only, as the "
        "reference's engine)")
    cfg, launches, per_mode, lens = phase_serving(dev, seed, ops, PALI, profile)
    torch.cuda.empty_cache()
    log(f"kernels at {PALI}'s serving path's shapes")
    rows = main_path_kernel_rows(ops, dev, seed, cfg, lens, launches, per_mode)
    log(f" (c) {', '.join(a for a, _, _ in OTHER_CONFIGS)} at full width, cut in depth")
    for arch, layers, n in OTHER_CONFIGS:
        full = get_config(arch)
        log(f"  {arch}: {layers} of {full.num_layers} layers")
        model_vs_plain(ops, dataclasses.replace(full, num_layers=layers), dev, seed, n,
                       OTHER_DECODE_STEPS)
    return rows


# ----------------------------------------------------------------- phase 7
# The last three architectures: granite-moe-1b-a400m (attention + MoE in
# every layer, top-8 of 32 experts), zamba2-7b (68 Mamba2 layers and one
# shared attention block of head dim 112 applied at 13 positions) and
# llama4-maverick (a dense and an MoE layer in turn, 128 experts and a
# shared expert).
MOE_ARCH = "granite-moe-1b-a400m"
ZAMBA = "zamba2-7b"
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2  # one period of its pattern: a dense layer, then an MoE layer


def phase_new_archs(ops, dev, seed, profile=False):
    """Phase 7: (a) zamba2's SSD-scan and SSD-step against their plain
    versions (``phase_ssd_kernels``), granite-moe-1b-a400m and zamba2-7b at
    full width, kernel path against plain path in float32 and bf16, P8
    (``p8_check``), then llama4-maverick at full width and LLAMA4_LAYERS
    layers in bf16; (b) four tenants of granite-moe and of zamba2 served in
    both modes (K4 by the wrapper's rule once per attention layer per
    prefill, K3 by its rule once per attention layer per decode pass,
    zamba2's SSD-scan and SSD-step once per Mamba2 layer per prefill piece
    and decode pass), with their kernels rows (zamba2's SSD rows from
    ``measure_ssd``). Returns the rows."""
    import dataclasses

    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa

    log(f" (a) {ZAMBA}'s Mamba2 mixer: SSD-scan and SSD-step against their plain versions at "
        "full width")
    phase_ssd_kernels(ops, dev, seed)
    log(f" (a) {MOE_ARCH} and {ZAMBA} at full width, kernel path vs plain path, f32 and bf16")
    for arch in (MOE_ARCH, ZAMBA):
        model_vs_plain_f32_bf16(ops, get_config(arch), dev, seed)
    p8_check(get_config(ZAMBA), dev, seed)
    full = get_config(LLAMA4)
    log(f"  {LLAMA4}: {LLAMA4_LAYERS} of {full.num_layers} layers at full width (a dense layer, "
        f"then an MoE layer of all {full.moe.num_experts} experts and the shared expert), bf16")
    cut = dataclasses.replace(full, num_layers=LLAMA4_LAYERS,
                              block_pattern=full.block_pattern[:LLAMA4_LAYERS])
    model_vs_plain(ops, cut, dev, seed, PROMPT_LEN, OTHER_DECODE_STEPS)
    torch.cuda.empty_cache()
    rows = []
    for arch in (MOE_ARCH, ZAMBA):
        log(f" (b) serving {REQUESTS} requests for {R_TENANTS} {arch} tenants")
        cfg = get_config(arch)
        cfg, launches, per_mode, lens = phase_serving(
            dev, seed, ops, arch, profile, flash_variant=fa.variant(torch.bfloat16, cfg.head_dim))
        torch.cuda.empty_cache()
        log(f"kernels at {arch}'s serving path's shapes")
        rows += main_path_kernel_rows(ops, dev, seed, cfg, lens, launches, per_mode)
        if mamba_layers(cfg):
            rows += measure_ssd(ops, dev, seed, int(np.median(lens)), launches, per_mode)
    return rows


# Mamba2's SSD mixer (SSD-scan, SSD-step) against its plain versions at
# zamba2-7b's full width: 112 heads of P = 64, state N = 64, conv window 4.
SSD_HEADS, SSD_P, SSD_N = 112, 64, 64
SSD_PIECES = (1, 4, 64, 128, 512)   # the graphed prefill's pieces, from a seeded state
SSD_FRESH = (742, 777)              # whole prompts from zero, off the kernel's chunk
# dt = softplus(dt_raw), dt_raw ~ N(mean, std); A = -linspace(1, 16) (zamba2's
# init): "strong" decays by up to e^-21 a step, "weak" by at most e^-0.04
SSD_DECAYS = {"default": (0.0, 1.0), "strong": (1.0, 1.0), "weak": (-6.0, 0.5)}
SSD_STEP_SEQS = ((4, 4), (1, 4))    # (R, B): the merged decode step, one tenant's
SSD_STEPS = 3                       # successive steps: the shifted windows are read back
SSD_STEP_FLOPS = 5                  # float32 operations a state element: 2 x, 1 +, 1 FMA
SSD_STEP_COLD_BYTES = 96 << 20      # state a cold timing cycles over: ~2x the L2
SSD_PLAIN_SLEEP_CYCLES = 10_000_000  # ~5 ms a call: the plain versions' tens of launches queue
SSD_TIMED_PIECES = (1, 64, 512)     # SSD-scan's rows: pieces from a state, then the median prompt
P8_LAYERS = 6                       # P8's zamba2 cut: 5 Mamba2 layers and the shared attention
# SSD-scan in float32 against its plain version: the plain version takes the
# model's chunk of 256 steps, the kernel 64, and exp(cum_l - cum_m) rounds as
# eps |cum|, which grows with the chunk: on the CPU the plain version at 256
# is 1.1e-5 of max |y| from a float64 recurrence and at 64 2.9e-6 (8 of
# zamba2's decay rates over 777 steps, tests/test_torch_kernels_ssd.py). An
# element may differ by 1e-4 of the largest |value| besides TOL.
SSD_SCAN_ATOL_OF_MAX = 1e-4


def mamba_layers(cfg) -> int:
    """Layers that run SSD-scan in a prefill and SSD-step in a decode pass
    (zamba2-7b: 68 of 81)."""
    from repro_torch.config import BlockKind

    return sum(k == BlockKind.MAMBA2 for k in cfg.layer_pattern)


def ssd_scan_inputs(gen, dev, dtype, S, decay="default", state=True):
    """xh (1, S, H, P) ~ N(0, 1), dt (1, S, H) = softplus(N(mean, std)) of
    ``decay``, A (H,) = -linspace(1, 16), Bm, Cm (1, S, N) ~ 0.5 N(0, 1),
    in the scan's dtypes; a seeded state (1, H, P, N) ~ N(0, 1) or None."""
    import torch
    import torch.nn.functional as F

    mean, std = SSD_DECAYS[decay]
    xh = torch.randn((1, S, SSD_HEADS, SSD_P), generator=gen, device=dev).to(dtype)
    dt = F.softplus(torch.randn((1, S, SSD_HEADS), generator=gen, device=dev) * std + mean)
    A = -torch.linspace(1.0, 16.0, SSD_HEADS, device=dev)
    Bm, Cm = ((torch.randn((1, S, SSD_N), generator=gen, device=dev) * 0.5).to(dtype)
              for _ in range(2))
    s0 = torch.randn((1, SSD_HEADS, SSD_P, SSD_N), generator=gen, device=dev) if state else None
    return (xh, dt, A, Bm, Cm), s0


def ssd_scan_tol(dtype, want):
    """(rtol, atol) of a scan check: TOL, and in float32 an atol of
    SSD_SCAN_ATOL_OF_MAX of the largest |value|."""
    rtol, atol = TOL[str(dtype)]
    if str(dtype) != "torch.bfloat16":
        atol = max(atol, SSD_SCAN_ATOL_OF_MAX * float(want.float().abs().max()))
    return rtol, atol


def ssd_chunk():
    from repro_torch.config import get_config

    return get_config(ZAMBA).ssm.chunk_size


def check_ssd_scan(ops, name, inputs, s0, kernel=None, plain=None):
    """SSD-scan on ``kernel`` = (inputs, state), by default the plain
    version's own, against its plain version at the model's chunk (or
    ``plain``, its result): y and the final state; returns (max error of
    y, y, state)."""
    import torch

    xh = inputs[0]
    want, want_s = plain or ops.ssd_scan_plain(*inputs, ssd_chunk(), init_state=s0)
    k_inputs, k_s0 = kernel or (inputs, s0)
    got, got_s = ops.ssd_scan(*k_inputs, ssd_chunk(), init_state=k_s0)
    torch.cuda.synchronize()
    err = check_close(f"{name} y", got, want, str(xh.dtype), ssd_scan_tol(xh.dtype, want))
    check_close(f"{name} final state", got_s, want_s, "torch.float32",
                ssd_scan_tol(torch.float32, want_s))
    return err, got, got_s


def ssd_step_inputs(gen, dev, dtype, R, B):
    """zamba2's decode mixer at full width for R tenants x B slots: the
    tenant-stacked params (conv weights ~ 0.1 N(0, 1), biases ~ 0.1 N(0, 1),
    A_log = log(linspace(1, 16)), D ~ 1 + 0.2 N(0, 1), dt_bias ~ 0.5 N(0,
    1), norm ~ 1 + 0.1 N(0, 1)), caches (windows ~ N(0, 1), state ~ N(0, 1))
    and SSD_STEPS steps' projections (~ N(0, 1)), all seeded."""
    import torch

    H, P, N, W = SSD_HEADS, SSD_P, SSD_N, 4
    d = H * P

    def rnd(*shape, scale=1.0, shift=0.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dt)

    f32 = torch.float32
    p = {"conv_x_w": rnd(R, W, d, scale=0.1), "conv_x_b": rnd(R, d, scale=0.1),
         "conv_B_w": rnd(R, W, N, scale=0.1), "conv_B_b": rnd(R, N, scale=0.1),
         "conv_C_w": rnd(R, W, N, scale=0.1), "conv_C_b": rnd(R, N, scale=0.1),
         "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)).expand(R, H).contiguous(),
         "D": rnd(R, H, scale=0.2, shift=1.0, dt=f32), "dt_bias": rnd(R, H, scale=0.5, dt=f32),
         "norm": rnd(R, d, scale=0.1, shift=1.0)}
    cache = {"conv_x": rnd(R, B, W - 1, d), "conv_B": rnd(R, B, W - 1, N),
             "conv_C": rnd(R, B, W - 1, N), "ssm": rnd(R, B, H, P, N, dt=f32)}
    steps = [(rnd(R, B, d), rnd(R, B, d), rnd(R, B, N), rnd(R, B, N), rnd(R, B, H))
             for _ in range(SSD_STEPS)]
    return p, cache, steps


def ssd_step_run(fn, p, cache, steps, after=None):
    """SSD_STEPS successive steps of ``fn`` from a copy of ``cache``: each
    step's y and copies of the caches after it (``after(cache, before)``
    runs after each step, with the caches' copies from before it)."""
    import torch

    cache = {k: v.clone() for k, v in cache.items()}
    out = []
    for proj in steps:
        before = {k: v.clone() for k, v in cache.items()}
        y = fn(p, cache, *proj)
        if after is not None:
            after(cache, before)
        out.append((y, {k: v.clone() for k, v in cache.items()}))
    torch.cuda.synchronize()
    return out


def check_ssd_steps(name, dtype, got, want):
    """Each step's y within TOL, the conv windows bitwise equal, the state
    within TOL in float32; returns the largest error of y."""
    import torch

    err = 0.0
    for i, ((y, c), (y_w, c_w)) in enumerate(zip(got, want)):
        err = max(err, check_close(f"{name} step {i} y", y, y_w, str(dtype)))
        for k in ("conv_x", "conv_B", "conv_C"):
            if not torch.equal(c[k], c_w[k]):
                raise PhaseFailed(f"{name} step {i}: the {k} window differs from the plain "
                                  "version's")
        check_close(f"{name} step {i} state", c["ssm"], c_w["ssm"], "torch.float32")
    return err


def ssd_scan_chain_cut(ops, inputs):
    """A control: SSD-scan over CHUNK-step slices of ``inputs``, each from
    zero, y concatenated and the last slice's state: the chunk chain cut."""
    import torch

    from repro_torch.kernels import ssd

    xh, dt, A, Bm, Cm = inputs
    ys, state = [], None
    for c0 in range(0, xh.shape[1], ssd.CHUNK):
        cut = slice(c0, c0 + ssd.CHUNK)
        y, state = ops.ssd_scan(xh[:, cut].contiguous(), dt[:, cut].contiguous(), A,
                                Bm[:, cut].contiguous(), Cm[:, cut].contiguous(), ssd_chunk())
        ys.append(y)
    return torch.cat(ys, 1), state


def check_ssd_scan_fit(ssd):
    """The built library's shared memory a block of ``ssd.SCAN_VARIANT``,
    by dtype, against the wrapper's mirror (``ssd.scan_smem_bytes``), and
    the one-wave rule: the card holds zamba2's one-sequence grid
    (``ssd.scan_grid``) at once in both dtypes."""
    import torch

    from repro_torch.kernels import _build

    lib = _build.load("ssd_scan")
    grid = ssd.scan_grid(1, SSD_HEADS, SSD_P)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = ssd.SCAN_VARIANT_CODES[ssd.SCAN_VARIANT]
    fits = []
    for dtype in (torch.float32, torch.bfloat16):
        got = lib.repro_ssd_scan_smem(code, _build.DTYPE_CODES[dtype])
        if got != ssd.scan_smem_bytes(dtype):
            raise PhaseFailed(f"ssd_scan {dtype}: {got} bytes of shared memory a block, the "
                              f"wrapper says {ssd.scan_smem_bytes(dtype)}")
        per_sm = lib.repro_ssd_scan_blocks_per_sm(code, _build.DTYPE_CODES[dtype])
        if per_sm * sms < grid:
            raise PhaseFailed(f"ssd_scan {dtype}: {per_sm} blocks an SM x {sms} SMs hold fewer "
                              f"than the {grid} blocks of one sequence")
        fits.append(f"{str(dtype)[6:]} {got} bytes, {per_sm} blocks an SM")
    log(f"  ssd_scan {ssd.SCAN_VARIANT} a block: {'; '.join(fits)} ({grid} blocks a sequence, "
        f"{sms} SMs: one wave)")


def phase_ssd_kernels(ops, dev, seed):
    """(a) SSD-scan and SSD-step against their plain versions at zamba2's
    full width in float32 and bf16: the scan at the graphed prefill's
    pieces (SSD_PIECES) from a seeded state and at whole prompts off the
    chunk (SSD_FRESH) from zero, in three decay regimes; the step over
    SSD_STEPS successive steps merged (R 4, B 4) and for one tenant (R 1, B
    4). Two launches give the same bits; three controls of the scan and three
    of the step (the B and C windows left unshifted, D dropped, the arrival
    counters left stale) fail their checks."""
    import torch

    from repro_torch.kernels import ssd

    check_ssd_scan_fit(ssd)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 33)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for S in SSD_PIECES:
            inputs, s0 = ssd_scan_inputs(gen, dev, dtype, S)
            check_ssd_scan(ops, f"ssd_scan {tag} S={S} from a seeded state", inputs, s0)
        for S in SSD_FRESH:
            inputs, s0 = ssd_scan_inputs(gen, dev, dtype, S, state=False)
            _, y, st = check_ssd_scan(ops, f"ssd_scan {tag} S={S} from zero", inputs, s0)
            check_same_bits(f"ssd_scan {tag} S={S}", (y, st),
                            lambda: ops.ssd_scan(*inputs, ssd_chunk(), init_state=s0))
        for decay in ("strong", "weak"):
            for S, state in ((512, True), (777, False)):
                inputs, s0 = ssd_scan_inputs(gen, dev, dtype, S, decay, state)
                check_ssd_scan(ops, f"ssd_scan {tag} S={S} {decay} decay, dt_raw ~ "
                               f"N{SSD_DECAYS[decay]}, {'seeded' if state else 'zero'} state",
                               inputs, s0)
        for R, B in SSD_STEP_SEQS:
            p, cache, steps = ssd_step_inputs(gen, dev, dtype, R, B)
            name = f"ssd_step {tag} R={R} B={B}"
            want = ssd_step_run(ops.ssd_step_plain, p, cache, steps)
            got = ssd_step_run(ops.ssd_step, p, cache, steps)
            check_ssd_steps(name, dtype, got, want)
            again = ssd_step_run(ops.ssd_step, p, cache, steps)
            check_same_bits(name, [t for y, c in got for t in (y, *c.values())],
                            lambda: [t for y, c in again for t in (y, *c.values())])
    log(f"  every scan launch {ssd.SCAN_VARIANT} (chunks of {ssd.CHUNK} steps, strips of "
        f"{ssd.TILE} rows, {ssd.scan_grid(1, SSD_HEADS, SSD_P)} blocks a sequence), every step "
        f"launch {ssd.STEP_VARIANT} ({ssd.step_grid(4, 4, SSD_HEADS)} blocks merged)")
    # the controls, at the serving shapes (bf16): each must fail its check
    dtype = torch.bfloat16
    inputs, s0 = ssd_scan_inputs(gen, dev, dtype, 512)
    plain = ops.ssd_scan_plain(*inputs, ssd_chunk(), init_state=s0)
    name = "ssd_scan bf16 S=512 from a seeded state"
    must_fail("the scan continues from a zeroed state",
              lambda: check_ssd_scan(ops, name, inputs, s0, (inputs, None), plain))
    xh, dt, A, Bm, Cm = inputs
    must_fail("B and C swapped", lambda: check_ssd_scan(ops, name, inputs, s0,
                                                        ((xh, dt, A, Cm, Bm), s0), plain))
    inputs, _ = ssd_scan_inputs(gen, dev, dtype, SSD_FRESH[0], state=False)
    want, want_s = ops.ssd_scan_plain(*inputs, ssd_chunk())
    name = f"ssd_scan bf16 S={SSD_FRESH[0]} from zero"

    def chain_cut():
        got, got_s = ssd_scan_chain_cut(ops, inputs)
        torch.cuda.synchronize()
        check_close(f"{name} y", got, want, "torch.bfloat16", ssd_scan_tol(dtype, want))
        check_close(f"{name} final state", got_s, want_s, "torch.float32",
                    ssd_scan_tol(torch.float32, want_s))
    must_fail(f"the chunk chain cut ({ssd.CHUNK}-step slices, each from zero)", chain_cut)
    p, cache, steps = ssd_step_inputs(gen, dev, dtype, 4, 4)
    want = ssd_step_run(ops.ssd_step_plain, p, cache, steps)
    name = "ssd_step bf16 R=4 B=4"

    def unshifted(c, before):
        c["conv_B"].copy_(before["conv_B"])
        c["conv_C"].copy_(before["conv_C"])
    must_fail("the B and C windows left unshifted", lambda: check_ssd_steps(
        name, dtype, ssd_step_run(ops.ssd_step, p, cache, steps, after=unshifted), want))
    no_d = {**p, "D": torch.zeros_like(p["D"])}
    must_fail("the D term dropped", lambda: check_ssd_steps(
        name, dtype, ssd_step_run(ops.ssd_step, no_d, cache, steps), want))
    stale = []

    def stale_counters(p_, c, *proj):
        # each sequence's arrival counter left at H before the launch, as a
        # launch cut short could leave it: no block sees H - 1, so no block
        # shifts the B and C windows
        counters = ssd.step_arrivals(c["ssm"], *c["ssm"].shape[:2])
        counters.fill_(SSD_HEADS)
        stale.append(counters)
        return ops.ssd_step(p_, c, *proj)
    try:
        must_fail("the arrival counters left stale (at H) before each launch",
                  lambda: check_ssd_steps(name, dtype,
                                          ssd_step_run(stale_counters, p, cache, steps), want))
    finally:
        for counters in stale:  # back to 0 for whatever state reuses the address
            counters.zero_()


def ssd_scan_work(S, given_state, dtype):
    """(bytes, float32 flops) of a scan over one sequence at zamba2's width:
    xh and y, B and C in ``dtype``, float32 dt and A read or written once,
    the state written (and read, when given); the recurrence's 4 P N
    operations a head-step (priced by ``ssd_scan_bound``)."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    H, P, N = SSD_HEADS, SSD_P, SSD_N
    nbytes = S * (2 * H * P * esize + 2 * N * esize + 4 * H) + 4 * H \
        + (1 + given_state) * 4 * H * P * N
    return nbytes, 4 * S * H * P * N


def ssd_scan_bound(S, given_state, dtype):
    """SSD-scan's bound from ``ssd_scan_work``: the larger of its bytes at
    the memory rate and its operations at the rate of the tensor-core
    products the kernel runs them as, float32-accurate TF32 passes (the
    TF32 rate over 3 for 3xTF32; over 2 in a bf16 model, where every
    product of the recurrence has a bf16 operand, exact in TF32). Returns
    (bound_ms, bound_by, bytes_ms, operations_ms, and the operations at the
    CUDA cores' float32 rate, which the first kernel runs them at)."""
    nbytes, flops = ssd_scan_work(S, given_state, dtype)
    passes = 2 if "bfloat16" in str(dtype) else 3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops * passes / PEAK_FLOPS["tf32"] * 1e3
    cuda_core_ms = flops / PEAK_FLOPS["torch.float32"] * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, bytes_ms, ops_ms, cuda_core_ms


def ssd_step_work(R, B, dtype, W=4):
    """(bytes, float32 flops) of the decode mixer of R x B sequences: the
    state read and written once; z, xs, y, B, C, dt, the windows read and
    written, the tenants' params read; SSD_STEP_FLOPS a state element."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    H, P, N = SSD_HEADS, SSD_P, SSD_N
    d = H * P
    nbytes = (2 * 4 * R * B * H * P * N
              + esize * R * B * (3 * d + 2 * N + H + 2 * (W - 1) * (d + 2 * N))
              + R * (esize * ((W + 1) * (d + 2 * N) + d) + 3 * 4 * H))
    return nbytes, SSD_STEP_FLOPS * R * B * H * P * N


def measure_ssd(ops, dev, seed, median, launches, per_mode):
    """The kernels rows of SSD-scan (pieces of SSD_TIMED_PIECES tokens from
    a state, the graphed route's; the median whole prompt from zero) and
    SSD-step (the merged step, one tenant's), bf16: kernel, plain version
    and bound (SSD-scan's both terms, ``ssd_scan_bound``), SSD-scan's first
    kernel (``cuda_core``, checked, then timed as ``prior_ms``), SSD-step
    warm and cold and in float32 too (``ssd_step_times``), with the serving
    run's launches (both modes for the scan, each step with its own
    mode's)."""
    import torch

    from repro_torch.kernels import ssd

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 34)
    dtype = torch.bfloat16
    rows = []
    scans = [(S, True, f"a {S}-token piece from a state") for S in SSD_TIMED_PIECES]
    for S, state, what in scans + [(median, False, f"the median whole prompt ({median}) from "
                                                   "zero")]:
        inputs, s0 = ssd_scan_inputs(gen, dev, dtype, S, state=state)
        name = f"ssd_scan bf16 {what}"
        err, _, _ = check_ssd_scan(ops, name, inputs, s0)
        prior = lambda: ssd.scan_prior(*inputs, init_state=s0)  # noqa: E731
        p_y, p_s = prior()
        want, want_s = ops.ssd_scan_plain(*inputs, ssd_chunk(), init_state=s0)
        torch.cuda.synchronize()
        check_close(f"{name} (cuda_core) y", p_y, want, "torch.bfloat16", ssd_scan_tol(dtype, want))
        check_close(f"{name} (cuda_core) final state", p_s, want_s, "torch.float32",
                    ssd_scan_tol(torch.float32, want_s))
        ms = time_ms(lambda: ops.ssd_scan(*inputs, ssd_chunk(), init_state=s0), 20)
        prior_ms = time_ms(prior, 20)
        plain_ms = time_ms(lambda: ops.ssd_scan_plain(*inputs, ssd_chunk(), init_state=s0), 3, 1,
                           SSD_PLAIN_SLEEP_CYCLES)
        bound_ms, bound_by, bytes_ms, ops_ms, cuda_core_ms = ssd_scan_bound(S, state, dtype)
        chunks, strips = ssd.scan_tiles(S)
        log(f"    ssd_scan {what} ({chunks} chunks, {strips} strips in the last): ms={ms:.4f} "
            f"prior_ms={prior_ms:.4f} (cuda_core, {prior_ms / ms:.2f}x) plain_ms={plain_ms:.4f} "
            f"({plain_ms / ms:.1f}x) library: none bound_ms={bound_ms:.4f} ({bound_by}; bytes "
            f"{bytes_ms:.4f}, operations {ops_ms:.4f} on TF32 tensor cores, {cuda_core_ms:.4f} "
            f"on CUDA cores) kernel/bound={ms / bound_ms:.2f} kernel/bytes={ms / bytes_ms:.2f} "
            f"kernel/operations={ms / ops_ms:.2f} kernel/cuda-core operations="
            f"{ms / cuda_core_ms:.2f}")
        rows.append(kernel_row("ssd_scan", f"{ZAMBA} {what}: {SSD_HEADS} heads of P={SSD_P}, "
                               f"N={SSD_N}, bf16", launches["ssd_scan"], {
                                   "variant": ssd.SCAN_VARIANT, "max_abs_err": err, "ms": ms,
                                   "prior": "ssd_scan cuda_core", "prior_ms": prior_ms,
                                   "plain_ms": plain_ms, "library_ms": None,
                                   "bound_ms": bound_ms, "bound_by": bound_by,
                                   "bound_bytes_ms": bytes_ms, "bound_operations_ms": ops_ms,
                                   "operations_cuda_core_ms": cuda_core_ms,
                                   "ms_over_bytes": ms / bytes_ms,
                                   "ms_over_operations": ms / ops_ms,
                                   "ms_over_operations_cuda_core": ms / cuda_core_ms}))
    for (R, B), mode, per in zip(SSD_STEP_SEQS, ("merged decode (space_time)",
                                                 "one tenant's decode (time_only)"), per_mode):
        t = {str(dt_)[6:]: ssd_step_times(ops, gen, dev, dt_, R, B)
             for dt_ in (torch.bfloat16, torch.float32)}
        bf, f32 = t["bfloat16"], t["float32"]
        log(f"    ssd_step {mode} R={R} B={B}: bf16 ms={bf['ms']:.4f} (state in L2 "
            f"{bf['ms_warm']:.4f}) plain_ms={bf['plain_ms']:.4f} "
            f"({bf['plain_ms'] / bf['ms']:.1f}x) library: none bound_ms={bf['bound_ms']:.4f} "
            f"({bf['bound_by']}) kernel/bound={bf['ms'] / bf['bound_ms']:.2f} (in L2 "
            f"{bf['ms_warm'] / bf['bound_ms']:.2f}); float32 ms={f32['ms']:.4f} (in L2 "
            f"{f32['ms_warm']:.4f}) plain_ms={f32['plain_ms']:.4f} "
            f"bound_ms={f32['bound_ms']:.4f}")
        rows.append(kernel_row("ssd_step", f"{ZAMBA} {mode}: R={R} x B={B}, {SSD_HEADS} heads "
                               f"of P={SSD_P}, N={SSD_N}, bf16", per["ssd_step"], {
                                   "variant": ssd.STEP_VARIANT, **bf,
                                   "prior": "ssd_step fused (the first kernel), timed in turns "
                                            "with the parent: experiments/prefill_turns.py "
                                            "--routes step",
                                   "library_ms": None, "float32": f32}))
    return rows


def ssd_step_times(ops, gen, dev, dtype, R, B):
    """SSD-step at (R, B) in ``dtype`` on seeded inputs: one step checked
    against its plain version, then its time cycling over caches past
    SSD_STEP_COLD_BYTES of state (``ms``: each launch reads its state from
    device memory, as a decode pass over the layers does), on one cache
    (``ms_warm``: the state stays in the 50 MB L2 between launches), the
    plain version's and the bound. Takes only ``ops.ssd_step`` and
    ``ops.ssd_step_plain`` of the port, so it times an older checkout's
    kernel as well (``experiments/prefill_turns.py --routes step``)."""
    import itertools

    p, cache, steps = ssd_step_inputs(gen, dev, dtype, R, B)
    want = ssd_step_run(ops.ssd_step_plain, p, cache, steps[:1])
    got = ssd_step_run(ops.ssd_step, p, cache, steps[:1])
    err = check_ssd_steps(f"ssd_step {str(dtype)[6:]} R={R} B={B}", dtype, got, want)
    ms_warm = time_ms(lambda: ops.ssd_step(p, cache, *steps[0]), 50)
    n_cold = max(2, -(-SSD_STEP_COLD_BYTES // (cache["ssm"].numel() * 4)))
    caches = [{k: v.clone() for k, v in cache.items()} for _ in range(n_cold)]
    turn = itertools.cycle(caches)
    # the warm-up steps every cache once, so nothing is made while timed
    ms = time_ms(lambda: ops.ssd_step(p, next(turn), *steps[0]), 50, n_cold)
    del caches
    plain_ms = time_ms(lambda: ops.ssd_step_plain(p, cache, *steps[0]), 10, 1,
                       SSD_PLAIN_SLEEP_CYCLES)
    nbytes, flops = ssd_step_work(R, B, dtype)
    bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
    return {"max_abs_err": err, "ms": ms, "ms_warm": ms_warm, "cold_caches": n_cold,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def p8_check(cfg, dev, seed, layers=P8_LAYERS):
    """(d) P8: zamba2 at full width and ``layers`` layers (5 Mamba2 and the
    shared attention block), a prefill of PROMPT_LEN tokens with
    ``torch.backends.cudnn.allow_tf32`` True gives the same bits, logits
    and every cache, as with False; so does the causal conv alone at
    d_inner. Whether ``F.conv1d`` (the conv before the repair) differs
    between the two settings at the same input is printed beside it."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.models import build_model, ssm

    cut = dataclasses.replace(cfg, num_layers=layers, block_pattern=cfg.block_pattern[:layers])
    model = build_model(cut, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 35)
    params = model.init(gen)
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cut.vocab_size, size=(1, PROMPT_LEN)), device=dev)
    d_inner = ssm.dims(cut)[0]
    x = torch.randn((1, PROMPT_LEN, d_inner), generator=gen, device=dev).to(model.dtype)
    w = (torch.randn((cut.ssm.conv_width, d_inner), generator=gen, device=dev) * 0.1).to(
        model.dtype)
    b = torch.zeros(d_inner, dtype=model.dtype, device=dev)
    W = w.shape[0]

    def conv1d():
        lhs = F.pad(x.float().transpose(1, 2), (W - 1, 0))
        return F.conv1d(lhs, w.float().t().unsqueeze(1), groups=d_inner)

    runs = {}
    prev = torch.backends.cudnn.allow_tf32
    try:
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            with torch.no_grad():
                logits, caches = model.forward_prefill(params, tokens, CACHE_LEN)
                runs[tf32] = (logits, caches, ssm._causal_conv(x, w, b), conv1d())
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    (l0, c0, v0, k0), (l1, c1, v1, k1) = runs[False], runs[True]
    same = {"logits": torch.equal(l0, l1), "conv": torch.equal(v0, v1),
            **{name: all(torch.equal(a, b) for a, b in zip(c0[name], c1[name])) for name in c0}}
    log(f"  P8: {cut.name} at {layers} layers, a {PROMPT_LEN}-token {cut.dtype} prefill with "
        f"cudnn.allow_tf32 True against False, bitwise: {same}; F.conv1d (the conv before the "
        f"repair) at d_inner {d_inner}: "
        + ("bitwise equal" if torch.equal(k0, k1) else
           f"differs by up to {float((k0 - k1).abs().max()):.3e}"))
    if not all(same.values()):
        raise PhaseFailed(f"P8: the prefill depends on cudnn.allow_tf32: {same}")
    del params, runs
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 8
# A live fleet on the card: two replicas, each a MultiTenantEngine over the
# same four full-width stablelm-1.6b tenants (one stacked weight set shared
# by both), behind the port's LiveFleet on the wall clock: least_cost
# routing over a FleetCalibrator's measured tables, a FlightRecorder, and a
# roofline prior over the "h100" HardwareSpec. Arrivals are a seeded
# Poisson trace from the port's sim.traces, submitted at their trace
# instants through LiveFleet.submit_one, as a server's loop submits them.
FLEET_ARCH = "stablelm-1.6b"
FLEET_REPLICAS = 2
FLEET_SLOTS = 2           # per tenant and engine: 8 sequences an engine
FLEET_REQUESTS = 48
FLEET_RATE_HZ = 16.0
FLEET_NEW = 8
FLEET_SLO_S = 1.0         # arrival to the 8th token of a request
FLEET_WINDOW_S = 0.005    # the fleet scheduler's batching window
FLEET_MAX_PENDING = 16    # cap admission: pending requests per tenant and replica
FLEET_TAIL_S = 60.0       # the drain's own bound before it force-flushes
LAUNCH_TERM_ITERS = 1000
LAUNCH_TERM_REPEATS = 5


def launch_terms():
    """``HardwareSpec``'s two launch terms on this card, in seconds, each the
    median of LAUNCH_TERM_REPEATS runs of LAUNCH_TERM_ITERS: the host time of
    one empty kernel launch (``torch.cuda._sleep(0)``, a kernel that spins
    zero cycles), and what a ``torch.cuda.synchronize()`` after each launch
    adds to it."""
    import torch

    for _ in range(100):
        torch.cuda._sleep(0)
    torch.cuda.synchronize()
    launch, synced = [], []
    for _ in range(LAUNCH_TERM_REPEATS):
        t0 = time.perf_counter()
        for _ in range(LAUNCH_TERM_ITERS):
            torch.cuda._sleep(0)
        launch.append((time.perf_counter() - t0) / LAUNCH_TERM_ITERS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(LAUNCH_TERM_ITERS):
            torch.cuda._sleep(0)
            torch.cuda.synchronize()
        synced.append((time.perf_counter() - t0) / LAUNCH_TERM_ITERS)
    dispatch = float(np.median(launch))
    return dispatch, float(np.median(synced)) - dispatch


def fleet_mix(cfg, weight_bytes):
    """One ``TenantSpec`` per tenant: a request of a mean prompt (576 tokens)
    and FLEET_NEW new tokens, priced by the roofline prior at 2 FLOPs a
    parameter a token and one read of the tenant's weights a decode step.
    Every tenant shares one bucket, so a replica merges requests of all
    tenants into one cohort."""
    from repro_torch.sim.traces import TenantSpec

    tokens = (128 + 1024) / 2 + FLEET_NEW
    return [TenantSpec(tenant_id=t, name=f"t{t}/request", bucket=("request", cfg.name),
                       cost=tokens, flops=2.0 * cfg.param_count() * tokens,
                       bytes=weight_bytes / R_TENANTS * FLEET_NEW, slo_s=FLEET_SLO_S,
                       kind="request")
            for t in range(R_TENANTS)]


def drive_fleet(fleet, arrivals, prompts):
    """Submit each arrival at its trace instant (from now) through
    ``submit_one``, pumping ripened cohorts while it waits, then drain the
    tail as the server's shutdown does. Returns (submissions, wall s)."""
    t0 = time.perf_counter()
    subs = []
    for (t_s, spec, cost), prompt in zip(arrivals, prompts):
        due = t0 + t_s
        while True:
            fleet.poll()
            now = time.perf_counter()
            if now >= due:
                break
            nxt = fleet.next_ripe_time()
            time.sleep(max(0.0, min(due if nxt is None else min(due, nxt), now + 0.002) - now))
        subs.append(fleet.submit_one(spec, cost, payload=prompt))
    fleet._drain_wall_tail(timeout_s=FLEET_TAIL_S)
    return subs, time.perf_counter() - t0


def check_fleet(mode, fleet, rec, calibration, subs, vocab, bucket):
    """Phase 8's checks on one run; returns its counts."""
    from types import SimpleNamespace

    from repro_torch.obs.trace_export import export_chrome_trace
    from repro_torch.sim.costmodel import batch_key

    for w, rid, admitted, _reason in subs:
        toks = w.result
        if admitted and (toks is None or len(toks) != FLEET_NEW
                         or not all(0 <= int(x) < vocab for x in toks)):
            raise PhaseFailed(f"{mode}: an admitted request on replica {rid} returned {toks}, "
                              f"not {FLEET_NEW} tokens inside the vocabulary")
    dispatches = [p.scheduler.stats.dispatches for p in fleet.pumps]
    if min(dispatches) <= 0:
        raise PhaseFailed(f"{mode}: a replica never dispatched: {dispatches}")
    shards = [rec.shards[p.replica_id] for p in fleet.pumps]
    recorded = sum(s.n_dispatches for s in shards)
    if recorded != sum(dispatches):
        raise PhaseFailed(f"{mode}: the recorder holds {recorded} dispatches, the pumps "
                          f"made {sum(dispatches)}")
    doc = json.loads(export_chrome_trace(rec))
    in_trace = sum(1 for e in doc["traceEvents"] if e.get("cat") == "dispatch")
    if in_trace != recorded:
        raise PhaseFailed(f"{mode}: the Chrome trace holds {in_trace} dispatch events, the "
                          f"recorder {recorded}")
    fitted = {}
    for p, s in zip(fleet.pumps, shards):
        table = calibration.for_replica(p.replica_id).table
        for n in set(s._dsp_size):
            key = batch_key([SimpleNamespace(bucket=bucket)] * n)
            if not table.get(key, 0.0) > 0.0:
                raise PhaseFailed(f"{mode}: replica {p.replica_id} dispatched {key} but its "
                                  f"calibrated table holds {table.get(key)}")
        fitted[p.replica_id] = dict(sorted(table.items()))
    return dispatches, recorded, fitted


def run_fleet(ops, model, stacked, cfg, mode, prompts, seed, weight_bytes):
    """One wall-clock LiveFleet run of phase 8's trace with the engines in
    ``mode`` (the cost prior's strategy too, as the reference's LiveRun
    ties them). Returns the mode's entry of the ``fleet`` line."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.launch.roofline import resolve_spec
    from repro_torch.obs.recorder import FlightRecorder
    from repro_torch.serving import EngineConfig, MultiTenantEngine
    from repro_torch.serving.fleet import EngineReplica, LiveFleet
    from repro_torch.sim.costmodel import FleetCalibrator, RooflineCostModel
    from repro_torch.sim.fleet import _arrival_stream
    from repro_torch.sim.traces import PoissonTrace

    def engine(i):
        return EngineReplica(MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
            num_tenants=R_TENANTS, slots_per_tenant=FLEET_SLOTS, cache_len=CACHE_LEN, mode=mode,
            seed=seed + i)), replica_id=i, max_new_tokens=FLEET_NEW)

    prior = RooflineCostModel(spec=resolve_spec("h100"), strategy=mode)
    calibration = FleetCalibrator(prior=prior)
    rec = FlightRecorder()
    fleet = LiveFleet(
        replicas=FLEET_REPLICAS, engine_factory=engine, router="least_cost",
        schedule=ScheduleConfig(batching_window_s=FLEET_WINDOW_S,
                                max_superkernel_size=R_TENANTS * FLEET_SLOTS,
                                max_pending_per_tenant=FLEET_MAX_PENDING,
                                default_slo_s=FLEET_SLO_S),
        cost_model=prior, calibration=calibration, recorder=rec)
    mix = fleet_mix(cfg, weight_bytes)
    arrivals = list(_arrival_stream(PoissonTrace(mix, FLEET_RATE_HZ, FLEET_REQUESTS, seed=seed)))
    before = {k: c.launches for k, c in ops.COUNTERS.items()}
    torch.cuda.synchronize()
    with torch.no_grad():
        subs, wall = drive_fleet(fleet, arrivals, [p for _, p in prompts])
    torch.cuda.synchronize()
    launches = {k: c.launches - before[k] for k, c in ops.COUNTERS.items()}
    dispatches, recorded, fitted = check_fleet(mode, fleet, rec, calibration, subs,
                                               cfg.vocab_size, mix[0].bucket)
    m = fleet.freeze(wall).summary()
    reasons = {}
    for s in rec.shards.values():
        for r in s._arr_reason:
            reasons[int(r)] = reasons.get(int(r), 0) + 1
    admitted = sum(1 for _, _, a, _ in subs if a)
    tokens = sum(len(w.result) for w, _, a, _ in subs if a)
    entry = {
        "mode": mode, "requests": len(subs), "admitted": admitted,
        "rejected": len(subs) - admitted, "reasons": {str(k): v for k, v in sorted(reasons.items())},
        "routed": list(fleet.routed_counts), "dispatches": dispatches,
        "recorded_dispatches": recorded, "p50_s": m["p50_s"], "p95_s": m["p95_s"],
        "slo_attainment": m["slo_attainment"], "wall_s": wall,
        "decode_tokens_per_s": tokens / wall,
        "launches": {k: launches[k] for k in ATTENTION_KERNELS},
        "calibrated_s": {str(rid): t for rid, t in fitted.items()},
    }
    log(f"  {mode}: {admitted}/{len(subs)} admitted (reason codes {entry['reasons']}), routed "
        f"{entry['routed']}, dispatches {dispatches}, p50 {m['p50_s'] * 1e3:.1f} ms p95 "
        f"{m['p95_s'] * 1e3:.1f} ms, {entry['decode_tokens_per_s']:.1f} decode tokens/s over "
        f"{wall:.2f} s, launches {entry['launches']}")
    for rid, table in fitted.items():
        log(f"    replica {rid} calibrated: "
            + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in table.items()))
    del fleet
    return entry


def phase_fleet(ops, dev, seed):
    """Phase 8: the launch terms, then phase 8's trace through a two-replica
    LiveFleet in space_time and in time_only. Fails unless every admitted
    request returns FLEET_NEW tokens inside the vocabulary, both replicas
    dispatch, the recorder's and the Chrome trace's dispatches equal the
    pumps', the calibrator holds measured seconds for every dispatched key,
    and every K3 launch took split_kv and every K4 launch wgmma. Returns
    (kernels rows, the ``fleet`` line's object)."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.core.tenancy import tenant_bytes
    from repro_torch.models import build_model

    dispatch_s, switch_s = launch_terms()
    card = gpu_identity()
    log(f"  launch terms on {card}: dispatch_overhead_s={dispatch_s:.4e} (host time of one empty "
        f"launch), context_switch_s={switch_s:.4e} (added by a synchronize after it)")
    cfg = get_config(FLEET_ARCH)
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed)
    weight_bytes = tenant_bytes(stacked)
    prompts, lens = serve_prompts(cfg, seed, FLEET_REQUESTS)
    log(f"  {FLEET_REPLICAS} replicas x {R_TENANTS} tenants x {FLEET_SLOTS} slots, cache "
        f"{CACHE_LEN}; {FLEET_REQUESTS} Poisson arrivals at {FLEET_RATE_HZ:g}/s, {FLEET_NEW} new "
        f"tokens each; window {FLEET_WINDOW_S * 1e3:g} ms, SLO {FLEET_SLO_S:g} s, at most "
        f"{FLEET_MAX_PENDING} pending a tenant")
    ops.reset_counters()  # the fleet path starts here
    runs = []
    for mode in ("space_time", "time_only"):
        runs.append(run_fleet(ops, model, stacked, cfg, mode, prompts, seed, weight_bytes))
        torch.cuda.empty_cache()
    launches = {k: c.launches for k, c in ops.COUNTERS.items()}
    plain_calls = {k: c.plain_calls for k, c in ops.COUNTERS.items()}
    log(f"  fleet-path launches (both modes): {launches}; plain-version calls: {plain_calls}")
    if any(plain_calls.values()):
        raise PhaseFailed(f"plain versions were called on the fleet path: {plain_calls}")
    for name, want in (("flash_attention", "wgmma"), ("decode_attention", "split_kv")):
        by_variant = dict(ops.COUNTERS[name].variants)
        if launches[name] <= 0 or by_variant.get(want, 0) != launches[name]:
            raise PhaseFailed(f"{name}: {launches[name]} launches on the fleet path, not all "
                              f"{want}: {by_variant}")
    per_mode = tuple(r["launches"] for r in runs)
    log("kernels at the fleet path's shapes")
    rows = main_path_kernel_rows(ops, dev, seed, cfg, lens, launches, per_mode,
                                 slots=FLEET_SLOTS, max_new=FLEET_NEW, path="live fleet, ")
    doc = {"card": card, "arch": FLEET_ARCH, "replicas": FLEET_REPLICAS,
           "launch_terms": {"dispatch_overhead_s": dispatch_s, "context_switch_s": switch_s},
           "runs": runs}
    return rows, doc


# ----------------------------------------------------------------- phase 9
# The front door: the port's CLI in process (``repro_torch.api.cli.main``),
# so the launch counters can be read around each step. Committed specs name
# the reference's card, so every run of one carries the hardware overrides.
SPECS_DIR = ROOT / "examples" / "specs"
SIM_SPEC_FILES = ("paper_mix", "hetero_fleet", "deadline_fleet", "traced_fleet", "replay_smoke",
                  "partitioned_fleet")
H100_SETS = ["--set", "cost_model.hardware=h100"]
H100_FLEET_SETS = H100_SETS + ["--set", 'fleet.specs=["h100","h100_half"]']
FRONT_SIM_EVENTS = 5000
CALIBRATE_EVENTS = 300
LIVE_SMOKE_EVENTS = 24
LIVE_SMOKE_ARCHS = {"stablelm-1.6b": ("flash_attention", "decode_attention"),
                    "rwkv6-1.6b": ("wkv6_scan",)}
LIVE_SMOKE_SETS = ["--set", "mode=live", "--set", "fleet.replicas=2",
                   "--set", "router.policy=least_cost"]
FRONT_FULL_REQUESTS = 24
HTTP_REQUESTS = 8


def spec_file(name):
    return str(SPECS_DIR / f"{name}.json")


def front_cli(argv):
    """One in-process call of the port's CLI; PhaseFailed unless it exits 0."""
    from repro_torch.api import cli

    log(f"  $ python -m repro_torch {' '.join(argv)}")
    rc = cli.main(argv)
    sys.stdout.flush()
    if rc != 0:
        raise PhaseFailed(f"python -m repro_torch {' '.join(argv)} exited {rc}")


def launches_of(ops):
    """(launches, launches by variant, plain calls) of every kernel."""
    return ({k: c.launches for k, c in ops.COUNTERS.items()},
            {k: dict(c.variants) for k, c in ops.COUNTERS.items()},
            {k: c.plain_calls for k, c in ops.COUNTERS.items()})


def require_launches(what, ops, kernels, variants):
    """PhaseFailed unless each of ``kernels`` launched, every launch by the
    variant ``variants`` names, and no plain version ran. Returns the
    launches."""
    launches, by_variant, plain = launches_of(ops)
    log(f"  {what}: launches {launches}; by variant {by_variant}; plain calls {plain}")
    if any(plain.values()):
        raise PhaseFailed(f"{what}: plain versions ran on the card: {plain}")
    for name in kernels:
        if launches[name] <= 0 or by_variant[name] != {variants[name]: launches[name]}:
            raise PhaseFailed(f"{what}: {name} launched {by_variant[name]}, not only "
                              f"{variants[name]}")
    return launches


def kernel_row(name, shape, launches, row):
    """A ``kernels``-line row: ``row``'s numbers with the kernel's source,
    the TPU kernel it replaces, its shape label and its launches on the
    path (``prior_ms`` null where the previous kernel has no instance)."""
    row.setdefault("prior_ms", None)
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": (REPLACES.get(name) or GEMM_REPLACES[name]), "shape": shape,
            "launches": launches, "launches_by_variant": {row["variant"]: launches}, **row}


def front_checks():
    """(a) ``python -m repro_torch specs`` in a subprocess, then ``check``
    on every committed spec with the hardware overrides."""
    from repro_torch.api.spec import ServeSpec

    # ``python -m repro_torch specs`` in a fresh interpreter in which jax (and
    # the reference package) cannot be imported, whether or not installed
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import importlib.util, runpy, sys\n"
            "print('jax installed:', importlib.util.find_spec('jax') is not None)\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "sys.argv = ['python -m repro_torch', 'specs']\n"
            "runpy.run_module('repro_torch', run_name='__main__', alter_sys=True)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    log(out.stdout.rstrip())
    log(f"  python -m repro_torch specs with jax and repro unimportable: exit {out.returncode}")
    if out.returncode != 0 or "h100_half" not in out.stdout:
        raise PhaseFailed(f"python -m repro_torch specs failed: {out.stderr.strip()[-2000:]}")
    for name in SIM_SPEC_FILES:
        front_cli(["check", "--spec", spec_file(name)]
                  + (H100_FLEET_SETS if name == "hetero_fleet" else H100_SETS))
    serve = ServeSpec.load(spec_file("serve_smoke"))
    log(f"  serve_smoke.json: ServeSpec OK, live arch={serve.system.workload.arch} replicas="
        f"{serve.system.fleet.replicas} on {serve.system.cost_model.hardware}")


def front_sims():
    """(b) same-seed byte-identical reruns of two committed sim specs on the
    H100, and the resolved knee plan of the partitioned one."""
    from repro_torch.api.build import build_mix, build_partition
    from repro_torch.api.spec import SystemSpec

    for name in ("paper_mix", "partitioned_fleet"):
        front_cli(["simulate", "--spec", spec_file(name), "--events", str(FRONT_SIM_EVENTS),
                   "--check"] + H100_SETS)
    spec = SystemSpec.load(spec_file("partitioned_fleet"), {"cost_model.hardware": "h100"})
    plan, _ = build_partition(spec, build_mix(spec.workload))
    log(f"  partitioned_fleet knee plan on h100: {plan.to_json()}")
    return json.loads(plan.to_json())


def front_calibrate(ops, dev, seed, tmp):
    """(c) ``calibrate`` on the card: every merged GEMM dispatch a K1 simt
    launch; then a calibrated sim replays the table. Returns (summary, K1
    row at the most dispatched (bucket, R))."""
    import torch

    from repro_torch.api.build import build_mix
    from repro_torch.api.spec import SystemSpec
    from repro_torch.sim.costmodel import CalibratedCostModel

    costs = tmp / "costs.json"
    ops.reset_counters()  # the calibrate path starts here
    front_cli(["calibrate", "--spec", spec_file("paper_mix"), "--events", str(CALIBRATE_EVENTS),
               "--out", str(costs)] + H100_SETS)
    torch.cuda.synchronize()
    launches = require_launches("calibrate", ops, ("batched_gemm",), {"batched_gemm": "simt"})
    front_cli(["simulate", "--spec", spec_file("paper_mix"), "--events", str(FRONT_SIM_EVENTS),
               "--check", "--set", "cost_model.kind=calibrated",
               "--set", f"cost_model.calibration_path={costs}"] + H100_SETS)
    model = CalibratedCostModel.load(str(costs))
    spec = SystemSpec.load(spec_file("paper_mix"), {"cost_model.hardware": "h100"})
    buckets = {repr(t.bucket): t.bucket for t in build_mix(spec.workload)}
    key = max(sorted(model.counts), key=model.counts.get)
    bucket_repr, r = key.rsplit("|r", 1)
    b, R = buckets[bucket_repr], int(r)
    log(f"  K1 at calibrate's most dispatched key {key} ({model.counts[key]} dispatches): "
        f"R={R} M={b.M} K={b.K} N={b.N} float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 90)
    x, w, err = check_batched(ops, gen, dev, torch.float32, R, b.M, b.K, b.N)
    row = kernel_row("batched_gemm", f"front door calibrate, paper_mix on h100: {key}",
                     launches["batched_gemm"], measure_batched(ops, x, w, err))
    summary = {"k1_launches": launches["batched_gemm"], "keys": len(model.table),
               "fitted_ms": {k: v * 1e3 for k, v in sorted(model.table.items())}}
    return summary, row


def front_live_smoke(ops, dev, seed, tmp):
    """(d) live runs of the reference's kind: the smoke variants in float32
    behind two replicas, each spec run twice (the second loads the fleet
    calibration the first saved), then a sim replays those tables. Returns
    (summary, rows at the runs' shapes)."""
    import torch

    from repro_torch.api.build import build_fleet_calibration
    from repro_torch.api.spec import CostModelSpec
    from repro_torch.config import get_config, smoke_variant

    summary, rows = {}, []
    want = {"flash_attention": "cuda_core", "decode_attention": "split_kv",
            "wkv6_scan": "chunked"}
    for arch, kernels in LIVE_SMOKE_ARCHS.items():
        table = tmp / f"fleet_{arch}.json"
        sets = LIVE_SMOKE_SETS + ["--set", f"workload.arch={arch}",
                                  "--set", f"cost_model.fleet_calibration_path={table}"]
        cfg = smoke_variant(get_config(arch))
        dims = (f"D={cfg.head_dim}" if cfg.num_heads else
                f"N=V={cfg.ssm.head_dim}, {cfg.d_model // cfg.ssm.head_dim} heads")
        total = {k: 0 for k in ops.COUNTERS}
        for run in (1, 2):
            if run == 2:
                warm = build_fleet_calibration(CostModelSpec(fleet_calibration_path=str(table)))
                fitted = {r: len(warm.for_replica(r).table) for r in range(2)}
                log(f"  {arch}: the second run starts warm from {table.name}: keys per replica "
                    f"{fitted}")
                if not any(fitted.values()):
                    raise PhaseFailed(f"{arch}: the saved fleet calibration holds no table")
            ops.reset_counters()  # this live run starts here
            front_cli(["simulate", "--check", "--events", str(LIVE_SMOKE_EVENTS)] + sets)
            torch.cuda.synchronize()
            launches = require_launches(f"{arch} smoke ({dims}) live run {run}", ops, kernels,
                                        want)
            if not table.exists():
                raise PhaseFailed(f"{arch}: the live run saved no fleet calibration")
            for k in total:
                total[k] += launches[k]
        summary[arch] = {"dims": dims, "launches": {k: total[k] for k in kernels}}
        if arch == "stablelm-1.6b":
            front_cli(["simulate", "--spec", spec_file("paper_mix"), "--events", "2000",
                       "--check", "--set", "fleet.replicas=2",
                       "--set", f"cost_model.fleet_calibration_path={table}"] + H100_SETS)
        rows += live_smoke_rows(ops, dev, seed, cfg, total)
    return summary, rows


def live_smoke_rows(ops, dev, seed, cfg, launches):
    """Kernel rows at a live smoke run's shapes (float32): K3 at the merged
    decode step (8 tenants x 2 slots, cache 32, mid-generation lengths), K4
    at one prefill of the default 8-token prompt, K5 at one such prefill."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 91)
    label = f"front door live smoke {cfg.name}, float32"
    f32 = torch.float32
    if cfg.num_heads:
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        log(f"  {label}: decode_attention at the merged decode step")
        dec = measure_decode(ops, dev, gen, f32, 16, H, Hkv, 32, D, [12] * 16)
        log(f"  {label}: flash_attention at a prefill")
        fl = measure_flash(ops, dev, gen, f32, 1, H, Hkv, 8, 8, D, 0)
        return [kernel_row("decode_attention", f"{label} merged decode, D={D}",
                           launches["decode_attention"], dec),
                kernel_row("flash_attention", f"{label} prefill, D={D}",
                           launches["flash_attention"], fl)]
    N = cfg.ssm.head_dim
    BH, T = cfg.d_model // N, 8
    log(f"  {label}: wkv6_scan at a prefill, (BH, T, N, V)={(BH, T, N, N)}")
    inputs, s0, err = check_wkv_case(ops, gen, dev, f32, BH, T, N, N)
    state = s0.clone()
    nbytes, flops = wkv_case_work(BH, T, N, N, f32)
    bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
    row = {"variant": "chunked", "max_abs_err": err,
           "ms": time_ms(lambda: ops.wkv6_scan(*inputs, init_state=state, final_state=state), 20),
           "plain_ms": time_ms(lambda: ops.wkv6_scan_plain(*inputs, init_state=state,
                                                           final_state=state), 3, 1),
           "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by}
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} library: none "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return [kernel_row("wkv6_scan", f"{label} prefill, N=V={N} padded to 64",
                       launches["wkv6_scan"], row)]


def front_full_width(ops, dev, seed, tmp):
    """(e) the LiveRun flow (spec -> build_fleet -> LiveFleet -> RunReport ->
    saved calibration) with its engine factory replaced here by phase 8's:
    two replicas over four full-width bf16 stablelm-1.6b tenants (one
    stacked weight set), FRONT_FULL_REQUESTS Poisson requests at phase 8's
    rate submitted at their instants. Returns (summary, K3 and K4 rows)."""
    import torch

    from repro_torch.api.build import LiveRun, _augment_metrics, build_recorder
    from repro_torch.api.cli import _check_live_report
    from repro_torch.api.report import RunReport
    from repro_torch.api.spec import SystemSpec
    from repro_torch.config import get_config
    from repro_torch.core.tenancy import tenant_bytes
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, MultiTenantEngine
    from repro_torch.serving.fleet import EngineReplica
    from repro_torch.sim.fleet import _arrival_stream
    from repro_torch.sim.traces import PoissonTrace

    cfg = get_config(FLEET_ARCH)
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed)
    weight_bytes = tenant_bytes(stacked)

    class FullWidthRun(LiveRun):
        def build_engine_factory(self):
            def factory(i):
                return EngineReplica(MultiTenantEngine(
                    model, stacked_params=stacked, config=EngineConfig(
                        num_tenants=R_TENANTS, slots_per_tenant=FLEET_SLOTS,
                        cache_len=CACHE_LEN, mode="space_time", seed=seed + i)),
                    replica_id=i, max_new_tokens=FLEET_NEW)
            return factory, EngineReplica.name, cfg.vocab_size

    table = tmp / "fleet_full_width.json"
    spec = SystemSpec().replace(**{
        "mode": "live", "workload.arch": FLEET_ARCH, "workload.tenants": R_TENANTS,
        "workload.events": FRONT_FULL_REQUESTS, "workload.rate_hz": FLEET_RATE_HZ,
        "workload.seed": seed, "workload.max_new_tokens": FLEET_NEW,
        "fleet.replicas": FLEET_REPLICAS, "router.policy": "least_cost",
        "scheduler.batching_window_s": FLEET_WINDOW_S,
        "scheduler.max_superkernel_size": R_TENANTS * FLEET_SLOTS,
        "scheduler.max_pending_per_tenant": FLEET_MAX_PENDING,
        "scheduler.default_slo_s": FLEET_SLO_S,
        "cost_model.fleet_calibration_path": str(table)})
    run = FullWidthRun(spec, device=dev)
    rec = build_recorder(spec)
    fleet, vocab = run.build_fleet(recorder=rec)
    mix = fleet_mix(cfg, weight_bytes)
    arrivals = list(_arrival_stream(PoissonTrace(mix, FLEET_RATE_HZ, FRONT_FULL_REQUESTS,
                                                 seed=seed)))
    prompts, lens = serve_prompts(cfg, seed, FRONT_FULL_REQUESTS)
    ops.reset_counters()  # the full-width front-door path starts here
    torch.cuda.synchronize()
    with torch.no_grad():
        subs, wall = drive_fleet(fleet, arrivals, [p for _, p in prompts])
    torch.cuda.synchronize()
    launches = require_launches("full-width front door", ops,
                                ("flash_attention", "decode_attention"),
                                {"flash_attention": "wgmma", "decode_attention": "split_kv"})
    m = fleet.freeze(wall)
    run.wall_s = wall
    run.save_calibration(fleet)
    doc = _augment_metrics(spec, m.to_dict(), m, rec)
    doc.update(arch=FLEET_ARCH, engine=run.engine_name, wall_s=wall)
    report = RunReport(executor=run.executor, mode=spec.mode, spec=spec.to_dict(), metrics=doc)
    problems = _check_live_report(report, spec)
    for w, rid, admitted, _ in subs:
        if admitted and (w.result is None or len(w.result) != FLEET_NEW
                         or not all(0 <= int(x) < vocab for x in w.result)):
            problems.append(f"an admitted request on replica {rid} returned {w.result}")
    if not table.exists():
        problems.append("no fleet calibration saved")
    if problems:
        raise PhaseFailed(f"full-width front door: {problems}")
    s = report.summary
    summary = {"arch": FLEET_ARCH, "replicas": FLEET_REPLICAS, "tenants": R_TENANTS,
               "requests": len(subs), "admitted": sum(1 for _, _, a, _ in subs if a),
               "rate_hz": FLEET_RATE_HZ, "p50_s": s["p50_s"], "p95_s": s["p95_s"],
               "slo_s": FLEET_SLO_S, "slo_attainment": s["slo_attainment"],
               "routed": [int(n) for n in m.routed_counts], "wall_s": wall,
               "launches": {k: launches[k] for k in ATTENTION_KERNELS}}
    log(f"  full width: {summary['admitted']}/{len(subs)} admitted, routed {summary['routed']}, "
        f"p50 {s['p50_s'] * 1e3:.1f} ms p95 {s['p95_s'] * 1e3:.1f} ms, attainment at "
        f"{FLEET_SLO_S:g} s {s['slo_attainment']:.3f}, {wall:.2f} s wall; report check OK")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 92)
    lens_mid = [lens[i % len(lens)] + FLEET_NEW // 2 for i in range(R_TENANTS * FLEET_SLOTS)]
    log(f"  {FLEET_ARCH} decode_attention at the front door's merged decode step")
    dec = measure_decode(ops, dev, gen, torch.bfloat16, R_TENANTS * FLEET_SLOTS, cfg.num_heads,
                         cfg.num_kv_heads, CACHE_LEN, cfg.head_dim, lens_mid,
                         prior=k3_prior(torch.bfloat16, cfg.head_dim, cfg.num_heads,
                                        cfg.num_kv_heads))
    s_med = int(np.median(lens))
    log(f"  {FLEET_ARCH} flash_attention at a median prefill: {s_med} tokens")
    fl = measure_flash(ops, dev, gen, torch.bfloat16, 1, cfg.num_heads, cfg.num_kv_heads, s_med,
                       s_med, cfg.head_dim, 0, prior=True)
    label = f"front door full width {FLEET_ARCH}"
    rows = [kernel_row("decode_attention", f"{label} merged decode (space_time), D=64",
                       launches["decode_attention"], dec),
            kernel_row("flash_attention", f"{label} median prefill, D=64",
                       launches["flash_attention"], fl)]
    del fleet, run, stacked, model
    return summary, rows


def http_round(spec, what, n, want_tokens, vocab, device=None):
    """``run_server`` in a thread; n concurrent /v1/predict, /healthz,
    /v1/report, then shutdown. Invariants only."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.serve import run_server

    ready, started = threading.Event(), []
    thread = threading.Thread(target=run_server, args=(spec,),
                              kwargs=dict(ready=ready, device=device, started=started),
                              daemon=True)
    thread.start()
    if not ready.wait(300):
        raise PhaseFailed(f"{what}: the server did not come up")
    server = started[0]
    base = f"http://127.0.0.1:{server.port}"

    def predict(i):
        req = urllib.request.Request(base + "/v1/predict", data=json.dumps(
            {"tenant_id": i % 4, "prompt": [1 + i, 2, 3]}).encode())
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())

    try:
        with ThreadPoolExecutor(n) as ex:
            outs = list(ex.map(predict, range(n)))
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(base + "/v1/report", timeout=60) as r:
            report = json.loads(r.read())
    finally:
        server.httpd.shutdown()
        thread.join(120)
    bad = [(st, d) for st, d in outs if st != 200 or len(d["tokens"]) != want_tokens
           or not all(0 <= t < vocab for t in d["tokens"])]
    replicas = sorted({d["replica"] for _, d in outs})
    log(f"  {what}: {n} concurrent predicts answered, {want_tokens} tokens each; replicas "
        f"{replicas}; healthz {health}; report http {report['metrics']['http']}; server "
        f"thread stopped {not thread.is_alive()}")
    if bad or health["status"] != "ok" or report["metrics"]["http"]["requests"] != n \
            or thread.is_alive():
        raise PhaseFailed(f"{what}: {bad or health or report['metrics']['http']}")
    return {"requests": n, "replicas": replicas}


def front_http(ops, dev):
    """(f) the HTTP front door over serve_smoke.json (arch=fake), then over
    a live stablelm-1.6b smoke spec on the card."""
    import torch

    from repro_torch.api.spec import ServeSpec, SystemSpec

    fake = http_round(ServeSpec.load(spec_file("serve_smoke")), "serve_smoke (fake)",
                      HTTP_REQUESTS, 8, 32_000)
    system = SystemSpec().replace(**{"mode": "live", "workload.arch": "stablelm-1.6b",
                                     "workload.tenants": 4, "fleet.replicas": 2,
                                     "router.policy": "least_cost"})
    spec = ServeSpec(system=system, port=0, request_timeout_s=120.0, poll_interval_s=0.01)
    ops.reset_counters()  # the HTTP path on the card starts here
    live = http_round(spec, "stablelm-1.6b smoke on the card", HTTP_REQUESTS,
                      system.workload.max_new_tokens, 1024, device=dev)
    torch.cuda.synchronize()
    live["launches"] = require_launches(
        "HTTP front door", ops, ("flash_attention", "decode_attention"),
        {"flash_attention": "cuda_core", "decode_attention": "split_kv"})
    return {"fake": fake, "live": live}


def phase_front_door(ops, dev, seed):
    """Phase 9: the front door (a)-(f). Returns (kernels rows, the
    ``front_door`` line's object)."""
    doc = {"card": gpu_identity()}
    with tempfile.TemporaryDirectory(prefix="front_door_") as d:
        tmp = Path(d)
        log("  (a) specs and check")
        front_checks()
        log("  (b) simulate --check on h100")
        doc["knee_plan"] = front_sims()
        log("  (c) calibrate on the card")
        doc["calibrate"], k1_row = front_calibrate(ops, dev, seed, tmp)
        log("  (d) live smoke specs")
        doc["live_smoke"], smoke_rows = front_live_smoke(ops, dev, seed, tmp)
        log("  (e) full-width LiveRun flow")
        doc["full_width"], full_rows = front_full_width(ops, dev, seed, tmp)
        log("  (f) the HTTP front door")
        doc["http"] = front_http(ops, dev)
    return [k1_row] + smoke_rows + full_rows, doc


# ----------------------------------------------------------------- phase 10
TRAIN_ARCHS = (("stablelm-1.6b", 4, 1024, "flash_attention"),   # (arch, batch, seq, kernel)
               ("rwkv6-1.6b", 4, 512, "wkv6_scan"))
TRAIN_STEPS = 20
TRAIN_LR = 1e-3
TRAIN_WARMUP = 5
TRAIN_CUT_LAYERS = 2                  # (c): full width, 2 of 24 layers
TRAIN_CUT_BATCH, TRAIN_CUT_SEQ = 2, 512
# Backward kernels against their plain versions, (rtol, atol as a share of
# the largest |gradient|). f32: the same float32 quantities summed in another
# order over up to S keys (or T steps) and a GQA group. bf16: both widen the
# same bf16 inputs and compute in float32, then round each gradient to bf16
# (relative step 2^-8); against autograd through the plain forward the
# output O enters delta = rowsum(dO o O) unrounded there, so allow more.
BWD_TOL = {"torch.float32": (1e-3, 1e-4), "torch.bfloat16": (2e-2, 4e-3)}
BWD_AUTOGRAD_TOL = {"torch.float32": (1e-3, 1e-4), "torch.bfloat16": (5e-2, 2e-2)}
# What the forwards hand their backward, against their plain versions,
# (rtol, atol): K4's row log-sum-exp (float32 sums of the same bf16 products
# in another order, exp2 and log2 at the card's approximate rates; +inf rows
# must match exactly) and K5's chunk-entry states (the final state's
# tolerance of phase 5, WKV_TOL: the chunked form sums in another order).
LSE_TOL = (1e-4, 1e-4)
BWD_PRIOR = {"flash_attention": "cuda_core", "wkv6_scan": "chunked"}  # the first kernels
# (c): per parameter, ||g_kernel - g_plain|| / ||g_plain|| in float32: only
# the order of float32 sums differs, through 2 layers and the loss.
GRAD_RTOL_F32 = 1e-3
LOSS_RTOL_F32 = 1e-4
# (a) cases: (B, Hq, Hkv, S, D, window)
FLASH_BWD_CASES = (
    (4, 32, 32, 1024, 64, 0),    # stablelm-1.6b's training shape
    (2, 16, 8, 300, 64, 0),      # granite-moe's GQA (q_per_kv 2), S not a multiple of a tile
    (1, 8, 1, 520, 256, 0),      # paligemma's q_per_kv 8 at D 256
    (1, 8, 8, 333, 112, 0),      # zamba2's D 112
    (2, 4, 2, 200, 32, 0),       # D 32
    (1, 8, 4, 600, 128, 128),    # a sliding window (gemma3's local layers, narrower)
)
# (b) cases: (B, H, T, N, w mean, w std); N = V
WKV_BWD_CASES = (
    (4, 32, 512, 64, -3.0, 1.0),  # rwkv6-1.6b's training shape
    (1, 32, 777, 64, 1.0, 1.0),   # strong decay: decays underflow to 0
    (1, 32, 300, 64, -8.0, 0.5),  # weak decay
    (2, 8, 17, 64, -3.0, 1.0),    # T not a multiple of 16
    (2, 4, 100, 32, -3.0, 1.0),   # N = V = 32, padded to 64
)


def check_grads(name, got, want, dtype_key, tol):
    """Gradients (a tuple) against another tuple: each within rtol |want| +
    atol_share * max |want|. Returns the largest max |got - want|."""
    import torch

    rtol, share = tol
    worst = 0.0
    for g, w, label in zip(got, want, ("d0", "d1", "d2", "d3", "d4")):
        g32, w32 = g.float(), w.float()
        if g.shape != w.shape or not torch.isfinite(g32).all():
            raise PhaseFailed(f"{name} {label}: shape {tuple(g.shape)} vs {tuple(w.shape)} or "
                              "non-finite values")
        err = (g32 - w32).abs()
        scale = float(w32.abs().max())
        bad = int((err > share * scale + rtol * w32.abs()).sum())
        worst = max(worst, float(err.max()))
        if bad:
            log(f"  {name} {label}: {bad} elements out of tolerance, max_abs_err "
                f"{float(err.max()):.3e} of max |grad| {scale:.3e}")
            raise PhaseFailed(f"{name}: {label} out of tolerance")
    log(f"  {name}: max_abs_err={worst:.3e} (rtol={rtol}, atol={share} x max |grad|) ok")
    return worst


def flash_bwd_work(B, Hq, Hkv, S, D, window, dtype):
    """(bytes, flops) of K4's backward: q, k, v, o, dO read once and dq, dk,
    dv written once; 5 products of 2 D flops per visible (query, key) pair
    (S, dP, dV, dQ, dK: the 5 * 2 * B*Hq*S^2*D of the formula, halved by
    causality, counted over this mask's visible pairs)."""
    _, flops_fwd = flash_work(B, Hq, Hkv, S, S, D, True, window, 0, dtype)
    pairs = flops_fwd // (4 * B * Hq * D)
    esize = 2 if "bfloat16" in dtype else 4
    nbytes = esize * 4 * (B * Hq * S * D + B * Hkv * S * D)
    return nbytes, 10 * B * Hq * D * pairs


def wkv_bwd_work(BH, H, T, N, V, dtype):
    """(bytes, float32 flops) of K5's backward: r, k, v, w, dO read and dr,
    dk, dv, dw written once, u read and du written once; per head and step
    ~14 N V flops from the formulas (S_{t-1} recomputed: 3; G_{t-1} = d G +
    r^T dO: 3; dr, dk, dv, dw: a product-sum over the state each, 2 each)."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    nbytes = BH * T * (4 * N + 4 * V + V) * esize + 2 * 4 * H * N
    return nbytes, 14 * N * V * BH * T


def sdpa_bwd(q, k, v, do, window):
    """SDPA's backward at these inputs, the library yardstick (the port
    never calls it): one autograd call on a causal (or windowed-mask) SDPA
    output, k and v expanded to every query head outside the timing."""
    import torch
    import torch.nn.functional as F

    g = q.shape[1] // k.shape[1]
    if g > 1:
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    if window == 0:
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    else:
        S = q.shape[2]
        pos = torch.arange(S, device=q.device)
        rel = pos[:, None] - pos[None, :]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=(rel >= 0) & (rel < window))
    return lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)


def flash_bwd_inputs(gen, dev, dtype, B, Hq, Hkv, S, D):
    import torch

    q = torch.randn((B, Hq, S, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    do = torch.randn((B, Hq, S, D), generator=gen, device=dev).to(dtype)
    return q, k, v, do


def check_same_bits(name, got, again):
    """A second launch gives the same bits (no atomics: every sum in a fixed
    order)."""
    import torch

    if not all(torch.equal(a, b) for a, b in zip(got, again())):
        raise PhaseFailed(f"{name}: a second launch gave other bits")


def check_lse(name, got, want):
    """K4's forward ``lse`` against ``ref.attention_lse``: +inf rows the same,
    the rest within LSE_TOL."""
    import torch

    if not torch.equal(torch.isinf(got), torch.isinf(want)) or torch.isnan(got).any():
        raise PhaseFailed(f"{name}: +inf rows differ from ref.attention_lse's, or NaN")
    fin = torch.isfinite(want)
    return check_close(name, got[fin], want[fin], "torch.float32", LSE_TOL)


def check_flash_bwd(ops, gen, dev, dtype, B, Hq, Hkv, S, D, window):
    """K4's backward kernels, ``bwd_variant``'s and the prior's (the
    CUDA-core kernel, launched by name) where they differ, each against
    ``ref.attention_bwd`` and against autograd through ``ref.attention``,
    the forward's output from K4 itself (as training hands it over); the
    wgmma forward's ``lse`` against ``ref.attention_lse``. Returns (inputs
    with the lse, the new kernel's max error)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    q, k, v, do = flash_bwd_inputs(gen, dev, dtype, B, Hq, Hkv, S, D)
    new = fa.bwd_variant(dtype, D)
    lse = None
    name = f"{str(dtype)[6:]} {(B, Hq, Hkv, S, D)} window={window}"
    with torch.no_grad():
        if new == "wgmma":
            lse = torch.empty((B, Hq, S), dtype=torch.float32, device=dev)
            o = fa.flash_attention(q, k, v, window=window, q_offset=0, lse=lse)
            torch.cuda.synchronize()
            check_lse(f"flash_attention lse {name}", lse, ref.attention_lse(q, k, window=window))
        else:
            o = ops.flash_attention(q, k, v, window=window)
    want = ref.attention_bwd(q, k, v, o, do, window=window)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(ref.attention(*leaves, window=window), leaves, do)
    errs = {}
    for kind in dict.fromkeys((new, BWD_PRIOR["flash_attention"])):
        got = fa.flash_attention_bwd(q, k, v, o, do, lse=lse if kind == "wgmma" else None,
                                     window=window, kernel=kind)
        torch.cuda.synchronize()
        what = f"flash_attention_bwd {name} [{kind}]"
        errs[kind] = check_grads(what + " vs ref.attention_bwd", got, want, str(dtype),
                                 BWD_TOL[str(dtype)])
        check_grads(what + " vs autograd of ref.attention", got, auto, str(dtype),
                    BWD_AUTOGRAD_TOL[str(dtype)])
        if kind == new:
            check_same_bits(what, got, lambda: fa.flash_attention_bwd(
                q, k, v, o, do, lse=lse if kind == "wgmma" else None, window=window, kernel=kind))
        del got
    return (q, k, v, o, do, lse), errs[new]


def wkv_bwd_inputs(gen, dev, dtype, B, H, T, N, w_mean, w_std):
    """As the model's train path hands K5 its inputs: (B, T, H, N)
    projections read as (B, H, T, N) views, u (H, N); dO ~ N(0, 1)."""
    import torch

    def proj(scale, shift=0.0):
        t = torch.randn((B, T, H, N), generator=gen, device=dev) * scale + shift
        return t.to(dtype).transpose(1, 2)

    r, k, v = proj(0.5), proj(0.5), proj(0.5)
    w = proj(w_std, w_mean)
    u = torch.randn((H, N), generator=gen, device=dev) * 0.3
    do = torch.randn((B, H, T, N), generator=gen, device=dev).to(dtype)
    return r, k, v, w, u, do


def check_ckpt(name, ckpt, want, N):
    """K5's forward ``ckpt`` against ``ref.wkv6_chunk_states`` on the live
    (N, N) block, the padded rows and columns 0."""
    if ckpt.shape[-1] != N and float(ckpt[..., N:].abs().max() + ckpt[..., N:, :].abs().max()):
        raise PhaseFailed(f"{name}: padded entries are not 0")
    return check_close(name, ckpt[..., :N, :N], want, "torch.float32", WKV_TOL)


def check_wkv_bwd(ops, gen, dev, dtype, B, H, T, N, w_mean, w_std):
    """K5's backward kernels, ``bwd_variant``'s (from the chunk states the
    forward wrote into its ``ckpt``, checked against
    ``ref.wkv6_chunk_states``) and the prior's (launched by name), each
    against ``ref.wkv6_scan_bwd`` and against autograd through
    ``ref.wkv6_scan``. Returns (inputs with the ckpt, the new kernel's max
    error)."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6_scan as wk

    inputs = wkv_bwd_inputs(gen, dev, dtype, B, H, T, N, w_mean, w_std)
    new = wk.bwd_variant(dtype, T)
    name = (f"{str(dtype)[6:]} (B, H, T, N)={(B, H, T, N)} w ~ N({w_mean}, {w_std}) padded to "
            f"{wk.padded_dims(N, N)}")
    ckpt = torch.empty(wk.chunk_states_shape(B * H, T, N, N), dtype=torch.float32, device=dev)
    with torch.no_grad():
        wk.wkv6_scan(*inputs[:5], ckpt=ckpt)
    torch.cuda.synchronize()
    check_ckpt(f"wkv6_scan ckpt {name}", ckpt, ref.wkv6_chunk_states(*inputs[1:4]), N)
    want = ref.wkv6_scan_bwd(*inputs)
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs[:5]]
    out, _ = ref.wkv6_scan(*leaves)
    auto = torch.autograd.grad(out, leaves, inputs[5], allow_unused=True)
    auto = [torch.zeros_like(x) if a is None else a for x, a in zip(leaves, auto)]
    errs = {}
    for kind in dict.fromkeys((new, BWD_PRIOR["wkv6_scan"])):
        got = wk.wkv6_scan_bwd(*inputs, ckpt=ckpt if kind == "cluster" else None, kernel=kind)
        torch.cuda.synchronize()
        what = f"wkv6_scan_bwd {name} [{kind}]"
        errs[kind] = check_grads(what + " vs ref.wkv6_scan_bwd", got, want, str(dtype),
                                 BWD_TOL[str(dtype)])
        check_grads(what + " vs autograd of ref.wkv6_scan", got, auto, str(dtype),
                    BWD_AUTOGRAD_TOL[str(dtype)])
        if kind == new:
            check_same_bits(what, got, lambda: wk.wkv6_scan_bwd(
                *inputs, ckpt=ckpt if kind == "cluster" else None, kernel=kind))
    return inputs + (ckpt,), errs[new]


def timed_turns(new, prior, iters):
    """(new ms, prior ms, the four times): ``new`` and ``prior`` timed in
    turns, new, prior, new, prior, on the same inputs; each the mean of its
    two turns."""
    ts = [time_ms(fn, iters) for fn in (new, prior, new, prior)]
    return (ts[0] + ts[2]) / 2, (ts[1] + ts[3]) / 2, ts


def phase_bwd_kernels(ops, dev, seed):
    """(a) K4's and (b) K5's backward kernels, ``bwd_variant``'s and the
    prior's, against their plain versions in float32 and bf16 at
    FLASH_BWD_CASES and WKV_BWD_CASES, and what the forwards save for them
    against its plain version; each timed at its model's training shape
    (bf16), in turns with the prior, beside the plain version, its bound
    and (K4) SDPA's backward; the forward's time there with and without
    its saved statistics. Returns the two rows, launches unset."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6_scan as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 40)
    timed = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in FLASH_BWD_CASES:
            inputs, err = check_flash_bwd(ops, gen, dev, dtype, *case)
            if case == FLASH_BWD_CASES[0] and dtype == torch.bfloat16:
                timed["flash"] = (case, inputs, err)
            del inputs
        for case in WKV_BWD_CASES:
            inputs, err = check_wkv_bwd(ops, gen, dev, dtype, *case)
            if case == WKV_BWD_CASES[0] and dtype == torch.bfloat16:
                timed["wkv"] = (case, inputs, err)
            del inputs
        torch.cuda.empty_cache()
    rows = []
    (B, Hq, Hkv, S, D, window), (q, k, v, o, do, lse), err = timed.pop("flash")
    nbytes, flops = flash_bwd_work(B, Hq, Hkv, S, D, window, "torch.bfloat16")
    bound_ms, bound_by = bound(nbytes, flops, "torch.bfloat16")
    new = fa.bwd_variant(torch.bfloat16, D)
    ms, prior_ms, turns = timed_turns(
        lambda: fa.flash_attention_bwd(q, k, v, o, do, lse=lse, kernel=new),
        lambda: fa.flash_attention_bwd(q, k, v, o, do, kernel=BWD_PRIOR["flash_attention"]), 10)
    fwd_ms, fwd_stats_ms, _ = timed_turns(
        lambda: fa.flash_attention(q, k, v, q_offset=0),
        lambda: fa.flash_attention(q, k, v, q_offset=0, lse=lse), 10)
    row = {
        "variant": new, "prior": BWD_PRIOR["flash_attention"],
        "shape": f"stablelm-1.6b training: {(B, Hq, Hkv, S, D)} causal, bf16",
        "max_abs_err": err, "ms": ms, "prior_ms": prior_ms, "turns_ms": turns,
        "plain_ms": time_ms(lambda: ref.attention_bwd(q, k, v, o, do), 3, 1),
        "library_ms": time_ms(sdpa_bwd(q, k, v, do, window), 10),
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fwd_ms": fwd_ms, "fwd_with_lse_ms": fwd_stats_ms,
    }
    log(f"    flash_attention_bwd [{new}] ms={ms:.4f} prior [{row['prior']}] ms={prior_ms:.4f} "
        f"(turns {', '.join(f'{t:.4f}' for t in turns)}) plain_ms={row['plain_ms']:.4f} "
        f"sdpa_bwd_ms={row['library_ms']:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
        f"kernel/bound={ms / bound_ms:.1f}; forward {fwd_ms:.4f} ms, with lse "
        f"{fwd_stats_ms:.4f} ms")
    rows.append({"name": "flash_attention_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 "replaces": REPLACES["flash_attention"], **row})
    del q, k, v, o, do, lse
    (B, H, T, N, _, _), inputs, err = timed.pop("wkv")
    *inputs, ckpt = inputs
    nbytes, flops = wkv_bwd_work(B * H, H, T, N, N, torch.bfloat16)
    bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
    new = wk.bwd_variant(torch.bfloat16, T)
    ms, prior_ms, turns = timed_turns(
        lambda: wk.wkv6_scan_bwd(*inputs, ckpt=ckpt, kernel=new),
        lambda: wk.wkv6_scan_bwd(*inputs, kernel=BWD_PRIOR["wkv6_scan"]), 10)
    fwd_ms, fwd_stats_ms, _ = timed_turns(lambda: wk.wkv6_scan(*inputs[:5]),
                                          lambda: wk.wkv6_scan(*inputs[:5], ckpt=ckpt), 10)
    row = {
        "variant": new, "prior": BWD_PRIOR["wkv6_scan"],
        "shape": f"rwkv6-1.6b training: B={B} H={H} T={T} N=V={N}, bf16",
        "max_abs_err": err, "ms": ms, "prior_ms": prior_ms, "turns_ms": turns,
        "plain_ms": time_ms(lambda: ref.wkv6_scan_bwd(*inputs), 2, 1),
        "library_ms": None,  # no single PyTorch call computes the WKV6 gradient
        "bound_ms": bound_ms, "bound_by": bound_by,
        "fwd_ms": fwd_ms, "fwd_with_ckpt_ms": fwd_stats_ms,
    }
    log(f"    wkv6_scan_bwd [{new}] ms={ms:.4f} prior [{row['prior']}] ms={prior_ms:.4f} (turns "
        f"{', '.join(f'{t:.4f}' for t in turns)}) plain_ms={row['plain_ms']:.4f} library: none "
        f"bound_ms={bound_ms:.4f} ({bound_by}) kernel/bound={ms / bound_ms:.1f}; forward "
        f"{fwd_ms:.4f} ms, with ckpt {fwd_stats_ms:.4f} ms")
    rows.append({"name": "wkv6_scan_bwd", "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/wkv6_scan_bwd.cu",
                 "replaces": REPLACES["wkv6_scan"], **row})
    return rows


def loss_and_grads(model, params, tokens, labels):
    """``forward_train``'s loss and every parameter's gradient (a list in
    ``tree_leaves`` order; zeros where the loss does not reach)."""
    import torch

    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.forward_train(params, tokens, labels)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]


def leaf_gaps(got, want):
    """Per leaf ||got - want|| / ||want|| in float32 (0 where both are 0)."""
    import torch

    out = []
    for g, w in zip(got, want):
        den = float(torch.linalg.vector_norm(w.float()))
        num = float(torch.linalg.vector_norm(g.float() - w.float()))
        out.append(num / den if den > 0 else (0.0 if num == 0 else float("inf")))
    return out


def train_vs_plain(ops, arch, op, dev, seed):
    """(c) ``arch`` at full width cut to TRAIN_CUT_LAYERS layers (seeded
    random weights; RWKV's decay data-dependent): ``forward_train``'s loss
    and every parameter's gradient, kernel path against ``plain_kernels=True``
    on the card. In float32 directly (loss within LOSS_RTOL_F32, each
    gradient within GRAD_RTOL_F32 in norm); in bf16 each path against the
    float32 plain path: the kernel path's gap no more than twice the bf16
    plain path's plus 1% (as ``hold_bf16`` holds logits). Fails unless the
    kernel runs launched the op's forward kernel twice per layer (the block
    recompute) and its backward kernel once per layer, by variant."""
    import dataclasses

    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6_scan as wk
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=TRAIN_CUT_LAYERS,
                              block_pattern=cfg.block_pattern[:TRAIN_CUT_LAYERS]
                              if cfg.block_pattern else cfg.block_pattern)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = build_model(cfg, device=dev).init(gen)
    if op == "wkv6_scan":
        live_decay_(params, gen)
    rng = np.random.RandomState(seed + 1)
    shape = (TRAIN_CUT_BATCH, TRAIN_CUT_SEQ)
    tokens = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=shape), device=dev)
    labels = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=shape), device=dev)
    ops.reset_counters()
    runs = {}
    for name, c in (("bf16", cfg), ("f32", cfg32)):
        p = params if name == "bf16" else tree_map(lambda t: t.float(), params)
        for plain in (False, True):
            runs[name, plain] = loss_and_grads(build_model(c, device=dev, plain_kernels=plain),
                                               p, tokens, labels)
        del p
    torch.cuda.synchronize()
    n = TRAIN_CUT_LAYERS
    fwd_variant = fa.variant if op == "flash_attention" else wk.variant
    bwd_variant = fa.bwd_variant if op == "flash_attention" else wk.bwd_variant
    width = cfg.head_dim if op == "flash_attention" else TRAIN_CUT_SEQ
    # the plain runs call the plain forward as often as the kernel runs launch
    # the kernel; autograd differentiates it, so no backward has a plain call
    for name, variant, per_run, plain_calls in ((op, fwd_variant, 2 * n, 4 * n),
                                                (op + "_bwd", bwd_variant, n, 0)):
        want = {}
        for dtype in (torch.bfloat16, torch.float32):
            v = variant(dtype, width)
            want[v] = want.get(v, 0) + per_run
        got = dict(ops.COUNTERS[name].variants)
        log(f"    {name} launches over both kernel runs: {got}")
        if got != want or ops.COUNTERS[name].plain_calls != plain_calls:
            raise PhaseFailed(f"{arch} training: {name} launches {got}, not {want}, or plain "
                              f"calls {ops.COUNTERS[name].plain_calls}, not {plain_calls}")
    (lk, gk), (lp, gp) = runs["f32", False], runs["f32", True]
    loss_gap = abs(float(lk) - float(lp)) / abs(float(lp))
    gaps = leaf_gaps(gk, gp)
    worst = int(np.argmax(gaps))
    ok = loss_gap <= LOSS_RTOL_F32 and max(gaps) <= GRAD_RTOL_F32
    log(f"  f32 {arch} ({n} layers, batch {shape}): loss kernel {float(lk):.6f} plain "
        f"{float(lp):.6f} (rel {loss_gap:.2e}); {len(gaps)} gradients, worst "
        f"||g_k - g_p|| / ||g_p|| = {gaps[worst]:.2e} (leaf {worst}) {'ok' if ok else 'FAIL'}")
    if not all(torch.isfinite(g).all() for g in gk) or not ok:
        raise PhaseFailed(f"{arch} training f32: the kernel path's loss or gradients disagree")
    (lkb, gkb), (lpb, gpb) = runs["bf16", False], runs["bf16", True]
    gap_k, gap_p = leaf_gaps(gkb, gp), leaf_gaps(gpb, gp)
    bad = [i for i, (a, b) in enumerate(zip(gap_k, gap_p)) if a > 2 * b + 0.01]
    lgap_k, lgap_p = abs(float(lkb) - float(lp)), abs(float(lpb) - float(lp))
    log(f"  bf16 {arch}: loss kernel {float(lkb):.6f} plain {float(lpb):.6f} (vs f32 plain: "
        f"{lgap_k:.2e}, {lgap_p:.2e}); gradients vs the f32 plain path, worst kernel gap "
        f"{max(gap_k):.2e}, worst plain gap {max(gap_p):.2e}; leaves beyond 2 x plain + 1%: "
        f"{len(bad)} {'ok' if not bad else 'FAIL'}")
    if bad or lgap_k > 2 * lgap_p + 1e-3 * abs(float(lp)):
        raise PhaseFailed(f"{arch} training bf16: the kernel path is farther from float32 than "
                          "the plain path allows")
    log(f"    {time.perf_counter() - t0:.1f} s")
    del params, runs
    torch.cuda.empty_cache()


@contextlib.contextmanager
def watch_programs():
    """The ``TrainProgram``s that ``train()`` makes inside the block."""
    from repro_torch.training import graphs as tg

    made, make = [], tg.train_program

    def watched(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]
    tg.train_program = watched
    try:
        yield made
    finally:
        tg.train_program = make


def train_full(ops, arch, batch, seq, op, dev, seed, ckpt_dir):
    """(d) ``train()`` on ``arch`` at full width and depth in bf16 for
    TRAIN_STEPS steps of ``SyntheticTokenStream`` (remat "block"), its step
    graphed (one eager pass, one capture, replays), every step logged; a
    checkpoint saved after the last step, restored and compared leaf for
    leaf. The launch counters are reset just before and
    read just after: the op's forward kernel must have launched layers x
    steps x 2 times (the block recompute), its backward kernel layers x
    steps times, every launch by the wrapper's variant rule, and no op may
    have a plain call. Returns (the train record, launches of the backward
    kernel by variant)."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6_scan as wk
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticTokenStream, train
    from repro_torch.training import checkpoint as ckpt

    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    data = SyntheticTokenStream(cfg.vocab_size, seq, batch, seed=seed)
    logs, stamps = [], []

    def log_fn(line):
        stamps.append(time.perf_counter())
        logs.append(line)

    path = os.path.join(ckpt_dir, f"{arch}.msgpack")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counters()
    t0 = time.perf_counter()
    with watch_programs() as made:
        state = train(model, data, steps=TRAIN_STEPS, seed=seed, base_lr=TRAIN_LR,
                      warmup_steps=TRAIN_WARMUP, log_every=1, checkpoint_path=path,
                      log_fn=log_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = made[0].stats()
    n_made = len(made)
    strided = leaf_paths(state.params, made[0].step.step_fn.made_contiguous)
    made.clear()  # the program (its graph's pool) goes with train()'s return
    log(f"  train() ran its step {'graphed' if st['graphed'] else 'eagerly'}: "
        f"{st['eager_passes']} eager pass, {st['captures']} capture ({st['capture_s']:.3f} s, "
        f"{st['pool_bytes'] / 2**20:.1f} MiB), {st['replays']} replays")
    if n_made != 1 or (st["graphed"], st["eager_passes"], st["captures"], st["replays"]) != (
            True, 1, 1, TRAIN_STEPS - 1):
        raise PhaseFailed(f"{arch} train(): its step did not run graphed: {st}")
    save_s = time.perf_counter() - stamps[-1]  # the last step is logged before the save
    counts = {name: (c.launches, dict(c.variants), c.plain_calls)
              for name, c in ops.COUNTERS.items()}
    peak = torch.cuda.max_memory_allocated()
    for line in logs:
        log(f"    {line}")
    losses = [float(line.split("loss")[1].split()[0]) for line in logs]
    norms = [float(line.split("grad_norm")[1].split()[0]) for line in logs]
    n_layers = cfg.num_layers
    dt = torch.bfloat16
    width = cfg.head_dim if op == "flash_attention" else seq
    fwd_v = (fa.variant if op == "flash_attention" else wk.variant)(dt, width)
    bwd_v = (fa.bwd_variant if op == "flash_attention" else wk.bwd_variant)(dt, width)
    want = {op: {fwd_v: n_layers * TRAIN_STEPS * 2}, op + "_bwd": {bwd_v: n_layers * TRAIN_STEPS},
            **adamw_launches(state.params, TRAIN_STEPS)}
    log("  launches over the run: " + ", ".join(
        f"{k} {v[1]}" for k, v in counts.items() if v[0]) + "; plain calls: "
        + str({k: v[2] for k, v in counts.items() if v[2]}) + "; gradients made contiguous "
        f"for the AdamW kernel: {strided or 'none'}")
    for name, (n, variants, plain) in counts.items():
        if variants != want.get(name, {}) or plain:
            raise PhaseFailed(f"{arch} train(): {name} launched {variants}, not "
                              f"{want.get(name, {})}, with {plain} plain calls")
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)) or losses[-1] >= losses[0]:
        raise PhaseFailed(f"{arch} train(): losses {losses} (must be finite and fall), grad "
                          f"norms {norms}")
    steps_ms = np.diff(np.asarray(stamps)) * 1e3
    t1 = time.perf_counter()
    like = {"params": state.params, "opt": state.opt}
    restored = ckpt.restore_checkpoint(path, like)
    leaves, back = ckpt.flatten(like), ckpt.flatten(restored["tree"])
    same = len(leaves) == len(back) and all(
        a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(leaves, back))
    size = os.path.getsize(path)
    restore_s = time.perf_counter() - t1
    log(f"  checkpoint after step {restored['step']}: {size / 1e9:.2f} GB, {len(leaves)} leaves, "
        f"restored leaf for leaf equal: {same} ({save_s:.1f} s to save, {restore_s:.1f} s to "
        "restore and compare)")
    os.remove(path)
    if not same or restored["step"] != TRAIN_STEPS - 1:
        raise PhaseFailed(f"{arch}: the restored checkpoint differs from the trained state")
    tokens = batch * seq
    rec = {"arch": arch, "dtype": "bfloat16", "layers": n_layers, "batch": batch, "seq": seq,
           "steps": TRAIN_STEPS, "program": st, "params": tree_params(state.params),
           "median_step_ms": float(np.median(steps_ms)),
           "tokens_per_s": tokens / (float(np.median(steps_ms)) / 1e3),
           "wall_s": wall, "peak_mem_gb": peak / 1e9, "losses": losses, "grad_norms": norms,
           "checkpoint_gb": size / 1e9, "checkpoint_save_s": save_s,
           "checkpoint_restore_s": restore_s, "made_contiguous": strided,
           "launches": {k: v[1] for k, v in counts.items() if v[0]}}
    log(f"  {arch} train(): median step {rec['median_step_ms']:.1f} ms (steps 1-{TRAIN_STEPS - 1}"
        f"), {rec['tokens_per_s']:.0f} tokens/s, peak memory {rec['peak_mem_gb']:.2f} GB, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, {wall:.1f} s wall with the checkpoint save")
    del state, like, restored, leaves, back
    torch.cuda.empty_cache()
    return rec, counts[op + "_bwd"][0], counts[op + "_bwd"][1]


# (e) the train step as a CUDA graph (training.graphs), against eager in lockstep
GRAPH_TRAIN_STEPS = 8       # lockstep steps from the same params over the same batches
GRAPH_TRAIN_TOTAL = 1000    # the schedule's length: the lr moves at every step checked
GRAPH_TRAIN_TIMED = 5       # steady steps timed on the host clock, each route
GRAPH_TRAIN_REPLAYS = 5     # replays back to back under CUDA events
GRAPH_CONTROL_STEPS = 3     # lockstep steps of each control
TRAIN_GRAPH_REPORT = {}     # arch -> numbers, printed as the ``train_graphs`` line


def train_step_numbers(m):
    """(loss, grad_norm, lr) of a step's metrics, read on the host."""
    import torch

    return torch.stack([m["loss"].float(), m["grad_norm"].float(), m["lr"].float()]).cpu()


def state_leaves(prog):
    from repro_torch.tree import tree_leaves

    return tree_leaves(prog.params) + tree_leaves(prog.opt)


def copy_state(dst, src):
    """Restore ``src``'s params, moments and step counter into ``dst``'s
    tensors in place (a graphed program's tensors are never rebound)."""
    import torch

    with torch.no_grad():
        for a, b in zip(state_leaves(dst), state_leaves(src)):
            a.copy_(b)


def lockstep(eager, graph, batches):
    """Run both programs over ``batches``, one step each in turn; after every
    step compare (loss, grad_norm, lr), after the last every param, moment
    and the step counter. Returns (steps whose three numbers are bitwise
    equal, their largest gap, state leaves that differ, the largest state
    gap)."""
    import torch

    same, gap = 0, 0.0
    for tok, lab in batches:
        e = train_step_numbers(eager.run(tok, lab))
        g = train_step_numbers(graph.run(tok, lab))
        same += bool(torch.equal(e, g))
        gap = max(gap, float((e - g).abs().max()))
    differ, sgap = 0, 0.0
    for a, b in zip(state_leaves(eager), state_leaves(graph)):
        if not torch.equal(a, b):
            differ += 1
            sgap = max(sgap, float((a.detach().float() - b.detach().float()).abs().max()))
    return same, gap, differ, sgap


def step_kernels(fn):
    """Kernels and their device ms in one call of ``fn`` (synchronized),
    under torch.profiler (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3


def graph_train_check(ops, arch, batch, seq, op, dev, seed):
    """(e) ``arch`` at full width and depth in bf16: an eager and a graphed
    ``TrainProgram`` from the same params over the same batches for
    GRAPH_TRAIN_STEPS steps, every step's loss, grad norm and lr and then
    every param, moment and the step counter required bitwise equal; the
    graph's captured launches one step's (the op's forward kernel twice a
    layer, its backward kernel once, no plain call). Then the host wall of
    steady steps, the device time of replays back to back, kernels a step,
    memory, and two controls that must fail the same lockstep check: a
    replay over an unstaged batch, and a program that does not write its
    step counter back (the frozen lr). Into TRAIN_GRAPH_REPORT[arch]."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import wkv6_scan as wk
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticTokenStream, make_train_step
    from repro_torch.training import graphs as tg
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    twin = tree_map(lambda t: t.clone(), params)
    step_fn = make_train_step(model, base_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                              total_steps=GRAPH_TRAIN_TOTAL)
    shape = (batch, seq)
    eager = tg.train_program(step_fn, params, adamw_init(params), shape, dev, False)
    graph = tg.train_program(step_fn, twin, adamw_init(twin), shape, dev, True)
    del params, twin
    data = SyntheticTokenStream(cfg.vocab_size, seq, batch, seed=seed + 3)
    batches = iter(data)

    def take(n):
        return [next(batches) for _ in range(n)]

    ops.reset_counters()
    same, gap, differ, sgap = lockstep(eager, graph, take(GRAPH_TRAIN_STEPS))
    torch.cuda.synchronize()
    st = graph.stats()
    n = cfg.num_layers
    dt = torch.bfloat16
    width = cfg.head_dim if op == "flash_attention" else seq
    fwd_v = (fa.variant if op == "flash_attention" else wk.variant)(dt, width)
    bwd_v = (fa.bwd_variant if op == "flash_attention" else wk.bwd_variant)(dt, width)
    want = {op: {fwd_v: 2 * n}, op + "_bwd": {bwd_v: n}, **adamw_launches(graph.params, 1)}
    strided = leaf_paths(graph.params, step_fn.made_contiguous)
    captured = {k: dict(c.variants) for k, c in graph.launches.items()}
    plain = {k: c.plain_calls for k, c in ops.COUNTERS.items() if c.plain_calls}
    total = {k: dict(c.variants) for k, c in ops.COUNTERS.items() if c.launches}
    want_total = {k: {v: c * GRAPH_TRAIN_STEPS * 2} for k, d in want.items() for v, c in d.items()}
    log(f"  {arch} graphed vs eager, {GRAPH_TRAIN_STEPS} steps ({batch} x {seq}, bf16): "
        f"(loss, grad_norm, lr) bitwise equal in {same}/{GRAPH_TRAIN_STEPS} steps (max gap "
        f"{gap:.3e}); params, moments and step: {differ} leaves differ (max gap {sgap:.3e}); "
        f"{st['eager_passes']} eager pass, {st['captures']} capture, {st['replays']} replays; "
        f"a replay launches {captured}; both programs launched {total}; plain calls {plain}; "
        f"gradients made contiguous: {strided or 'none'}")
    ok = (same == GRAPH_TRAIN_STEPS and differ == 0 and captured == want and not plain
          and total == want_total and (st["eager_passes"], st["captures"], st["replays"])
          == (1, 1, GRAPH_TRAIN_STEPS - 1))
    if not ok:
        raise PhaseFailed(f"{arch}: the graphed train step differs from eager, or its launches "
                          f"{captured} are not one step's {want}")

    # the steady step on each route, its memory, the graph's device time
    walls, peaks, reserved = {}, {}, {}
    for name, prog in (("eager", eager), ("graph", graph)):
        timed = take(GRAPH_TRAIN_TIMED)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base, base_r = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        for tok, lab in timed:
            prog.run(tok, lab)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t1) / GRAPH_TRAIN_TIMED * 1e3
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**20
        reserved[name] = (torch.cuda.max_memory_reserved() - base_r) / 2**20
    device_ms = time_ms(graph.graph.replay, GRAPH_TRAIN_REPLAYS, warmup=0)
    tok, lab = take(1)[0]
    kern_e, kern_e_ms = step_kernels(lambda: eager.run(tok, lab))
    kern_g, kern_g_ms = step_kernels(lambda: graph.run(tok, lab))
    row = {"batch": batch, "seq": seq, "steps": GRAPH_TRAIN_STEPS, "bitwise_steps": same,
           "max_gap": gap, "state_leaves_differ": differ,
           "eager_wall_ms": walls["eager"], "graph_wall_ms": walls["graph"],
           "graph_device_ms": device_ms, "eager_idle": 1 - device_ms / walls["eager"],
           "graph_idle": 1 - device_ms / walls["graph"],
           "kernels_per_step": {"eager": kern_e, "graph": kern_g},
           "profiled_kernel_ms": {"eager": kern_e_ms, "graph": kern_g_ms},
           "capture_s": st["capture_s"], "pool_mib": st["pool_bytes"] / 2**20,
           "eager_step_peak_mib": peaks["eager"], "graph_step_peak_mib": peaks["graph"],
           "eager_step_reserved_mib": reserved["eager"],
           "graph_step_reserved_mib": reserved["graph"],
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches_per_replay": captured, "made_contiguous": strided}
    log(f"    wall {walls['eager']:.3f} ms a steady step eager, {walls['graph']:.3f} graphed; "
        f"replays back to back {device_ms:.3f} ms of device time; idle share "
        f"{row['eager_idle']:.3f} eager, {row['graph_idle']:.3f} graphed (CUDA events); "
        f"kernels a step {kern_e} eager, {kern_g} graphed ({kern_e_ms:.3f} / {kern_g_ms:.3f} ms "
        f"profiled); capture {st['capture_s']:.3f} s, pool {row['pool_mib']:.1f} MiB reserved "
        f"against the eager step's {reserved['eager']:.1f} MiB reserved ({peaks['eager']:.1f} "
        f"MiB allocated) above its state; a replay {reserved['graph']:.1f} MiB reserved, "
        f"{peaks['graph']:.1f} MiB allocated")

    # controls: the same lockstep check, each from equal states, must fail
    copy_state(graph, eager)
    graph.stage = lambda tokens, labels: None  # the replay reads the last staged batch
    stale = lockstep(eager, graph, take(GRAPH_CONTROL_STEPS))
    del graph.stage
    graph.release()  # its pool's blocks go back: the frozen program captures into the pool
    torch.cuda.empty_cache()
    copy_state(graph, eager)

    class FrozenCounter(tg.TrainStep):
        def advance(self, opt):  # keeps the new counter as a new tensor
            pass

    frozen_prog = tg.TrainProgram(FrozenCounter(step_fn, graph.params, graph.opt), shape, dev,
                                  graph.graphs)
    frozen = lockstep(eager, frozen_prog, take(GRAPH_CONTROL_STEPS))
    caught = {"unstaged batch": stale[0] < GRAPH_CONTROL_STEPS,
              "frozen step counter": frozen[0] < GRAPH_CONTROL_STEPS}
    row["controls"] = {"unstaged_batch": {"bitwise_steps": stale[0], "max_gap": stale[1],
                                          "state_leaves_differ": stale[2]},
                       "frozen_step_counter": {"bitwise_steps": frozen[0], "max_gap": frozen[1],
                                               "state_leaves_differ": frozen[2]}}
    log("    controls (each from equal states, " + f"{GRAPH_CONTROL_STEPS} steps): " + "; ".join(
        f"{k}: {c[0]}/{GRAPH_CONTROL_STEPS} steps bitwise, {c[2]} leaves differ: "
        f"{'caught' if caught[k] else 'NOT caught'}"
        for k, c in (("unstaged batch", stale), ("frozen step counter", frozen))))
    log(f"    {time.perf_counter() - t0:.1f} s")
    if not all(caught.values()):
        raise PhaseFailed(f"{arch}: a control of the graphed train step was not caught: {row}")
    frozen_prog.release()
    eager.release()
    TRAIN_GRAPH_REPORT[arch] = row
    del eager, graph, frozen_prog
    torch.cuda.empty_cache()


# (f) the AdamW kernels (kernels/adamw.py) against the plain update
# gradient std by clip regime: a global norm of ~40 (scale ~0.025 at clip 1)
# or ~0.4 (scale 1) over the ~1.6e9 parameters of either tree
ADAMW_REGIMES = {"clip binds": 1e-3, "clip does not bind": 1e-5}
ADAMW_STATE_STEP = 10  # updates applied before: the bias corrections are step 11's
ADAMW_LR = 3e-4
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)  # make_train_step's
ADAMW_FLOPS = 17       # float32 operations an element of the update (a divide or root one)
ADAMW_ITERS = 5
# the wrappers' host cost grows with the leaves (~1-2 ms a call for rwkv6's
# 411 at the norm, more than the norm kernel's device time): queue ~5 ms a call
ADAMW_SLEEP_CYCLES = 10_000_000
ADAMW_REPORT = {}      # arch -> the checks' numbers, in the ``train`` line's ``adamw``
# edge tree (numel, dtype): off the vector and tile edges, both dtypes, and
# more leaves than one pack (two launches of each kernel)
ADAMW_EDGE = ([(1, "float32"), (7, "bfloat16"), (9, "float32"), (8191, "bfloat16"),
               (8193, "float32"), (3 * 8192 + 5, "bfloat16")]
              + [(3 + i % 13, "bfloat16" if i % 4 else "float32") for i in range(700)])


def leaf_paths(params, indices):
    """The tree paths ("layers/3/mlp/w1") of ``tree_leaves`` indices."""
    def walk(tree, prefix):
        if isinstance(tree, dict):
            return [x for k, v in tree.items() for x in walk(v, f"{prefix}{k}/")]
        if isinstance(tree, (list, tuple)):
            return [x for i, v in enumerate(tree) for x in walk(v, f"{prefix}{i}/")]
        return [prefix[:-1]]
    paths = walk(params, "")
    return [paths[i] for i in indices]


def adamw_packs(leaves):
    from repro_torch.kernels import adamw as aw

    return len(aw.plan([p.numel() for p in leaves], [p.dtype for p in leaves]).packs)


def adamw_launches(params, updates):
    """The AdamW kernels' launches over ``updates`` updates of ``params``:
    one of each a pack (one pack for both real trees)."""
    from repro_torch.kernels import adamw as aw
    from repro_torch.tree import tree_leaves

    n = adamw_packs(tree_leaves(params)) * updates
    return {"adamw_norm": {aw.VARIANT: n}, "adamw_update": {aw.VARIANT: n}}


def adamw_state(leaves, dev, seed, std):
    """Seeded gradients of ``std`` in each param's dtype, and float32 moments
    as after some steps (m ~ N(0, std), v ~ N(0, std)^2)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    grads, mus, nus = [], [], []
    for p in leaves:
        grads.append(torch.randn(p.shape, generator=gen, device=dev).mul_(std).to(p.dtype))
        mus.append(torch.randn(p.shape, generator=gen, device=dev).mul_(std))
        nus.append(torch.randn(p.shape, generator=gen, device=dev).mul_(std).square_())
    return grads, mus, nus


def adamw_run(params, grads, mus, nus, fn):
    """``fn(params, grads, mus, nus)`` on copies of the params and moments;
    returns the copies (params, mus, nus) after it."""
    import torch

    out = ([t.clone() for t in params], [t.clone() for t in mus], [t.clone() for t in nus])
    fn(out[0], grads, out[1], out[2])
    torch.cuda.synchronize()
    return out


def adamw_gap(got, want):
    """(leaves of params and moments that are not bitwise equal, the largest
    |got - want| over them)."""
    import torch

    differ, gap = 0, 0.0
    for a_list, b_list in zip(got, want):
        for a, b in zip(a_list, b_list):
            if not torch.equal(a, b):
                differ += 1
                gap = max(gap, float((a.float() - b.float()).abs().max()))
    return differ, gap


def require_bitwise(what, got, want):
    differ, gap = adamw_gap(got, want)
    n = sum(len(x) for x in want)
    log(f"    {what}: {n - differ}/{n} leaves bitwise equal (max gap {gap:.3e})")
    if differ:
        raise PhaseFailed(f"{what}: {differ} of {n} param and moment leaves differ from the "
                          f"plain update (max gap {gap:.3e})")
    return gap


def exact_norm(grads):
    """The gradients' global L2 norm summed in float64."""
    import torch

    return float(torch.sqrt(sum(torch.sum(torch.square(g.double())) for g in grads)))


def require_norm(what, got, exact, rtol):
    rel = abs(got - exact) / exact
    log(f"    {what}: {got:.9g} against the float64 sum's {exact:.9g}: relative error "
        f"{rel:.3e} (bound {rtol:.3e}) {'ok' if rel <= rtol else 'FAIL'}")
    if not rel <= rtol:
        raise PhaseFailed(f"{what}: relative error {rel:.3e} over the bound {rtol:.3e}")
    return rel


def adamw_tree_check(ops, what, leaves, dev, seed, std, controls=False):
    """The AdamW kernels on one tree (``leaves``, the params) at gradient
    ``std``: (a) the norm kernel against the float64 sum within its bound
    (``adamw.norm_rtol``) and bitwise equal to itself over two launches;
    (b) the update kernel given the plain step's scalars bitwise equal to
    the plain update; the whole kernel step (``adamw_update`` on the card:
    its own norm, then the scalars) against the plain step, recorded. With
    ``controls``, bc1 and bc2 swapped and a leaf's last element left out of
    the update must fail (b)'s check, and a norm without the largest leaf
    (a)'s. Returns the record, the grads and the moments."""
    import torch

    from repro_torch.kernels import adamw as aw
    from repro_torch.training.optimizer import AdamWState, adamw_update, update_scalars

    grads, mus, nus = adamw_state(leaves, dev, seed, std)
    step0 = torch.full((), ADAMW_STATE_STEP, dtype=torch.int32, device=dev)
    lr0 = torch.full((), ADAMW_LR, dtype=torch.float32, device=dev)
    plan = aw.plan([p.numel() for p in leaves], [p.dtype for p in leaves])
    rtol = aw.norm_rtol(plan.tiles)
    ops.reset_counters()
    gn_plain = ops.adamw_norm_plain(grads)
    scale, _, bc1, bc2, lr = update_scalars(gn_plain, step0, lr0)
    plain = adamw_run(leaves, grads, mus, nus, lambda p, g, m, v: ops.adamw_update_plain(
        p, g, m, v, scale, bc1, bc2, lr, **ADAMW_HYPER))
    kern = adamw_run(leaves, grads, mus, nus, lambda p, g, m, v: ops.adamw_update(
        p, g, m, v, scale, bc1, bc2, lr, **ADAMW_HYPER))
    gap = require_bitwise(f"{what}: the update kernel given the plain step's scalars", kern, plain)
    del kern
    exact = exact_norm(grads)
    gn = ops.adamw_norm(grads)
    again = ops.adamw_norm(grads)
    torch.cuda.synchronize()
    rel = require_norm(f"{what}: the norm kernel", float(gn), exact, rtol)
    rel_plain = abs(float(gn_plain) - exact) / exact
    if not torch.equal(gn, again):
        raise PhaseFailed(f"{what}: two launches of the norm kernel gave {float(gn)!r} and "
                          f"{float(again)!r}")

    def whole(p, g, m, v):
        adamw_update(g, AdamWState(step0.clone(), m, v), p, lr0)
    step = adamw_run(leaves, grads, mus, nus, whole)
    step_differ, step_gap = adamw_gap(step, plain)
    del step
    launched = {k: dict(c.variants) for k, c in ops.COUNTERS.items() if c.launches}
    plain_calls = {k: c.plain_calls for k, c in ops.COUNTERS.items() if c.plain_calls}
    want = {"adamw_norm": {aw.VARIANT: 3 * len(plan.packs)},
            "adamw_update": {aw.VARIANT: 2 * len(plan.packs)}}
    whole_verdict = ("bitwise equal" if not step_differ
                     else f"{step_differ} leaves differ, max gap {step_gap:.3e}")
    log(f"    {what}: scale {float(scale):.6g} (plain norm {float(gn_plain):.9g}, relative error "
        f"{rel_plain:.3e}); the whole kernel step against the plain step: {whole_verdict}; "
        f"launches {launched}, plain calls {plain_calls}")
    if launched != want or plain_calls != {"adamw_norm": 1, "adamw_update": 1}:
        raise PhaseFailed(f"{what}: AdamW launches {launched} (want {want}), plain calls "
                          f"{plain_calls}")
    rec = {"scale": float(scale), "grad_norm": float(gn), "grad_norm_plain": float(gn_plain),
           "grad_norm_f64": exact, "norm_rel_err": rel, "norm_rel_err_plain": rel_plain,
           "norm_rtol": rtol, "update_bitwise": True, "update_max_gap": gap,
           "whole_step_bitwise": not step_differ, "whole_step_max_gap": step_gap}
    if controls:
        must_fail("bc1 and bc2 swapped", lambda: require_bitwise(
            f"{what}, bc1 and bc2 swapped", adamw_run(
                leaves, grads, mus, nus, lambda p, g, m, v: aw.update(
                    p, g, m, v, scale, bc2, bc1, lr, **ADAMW_HYPER)), plain))

        def dropped(p, g, m, v):  # the last leaf's last element left out of the plan
            aw.update(p[:-1] + [p[-1].view(-1)[:-1]], g[:-1] + [g[-1].view(-1)[:-1]],
                      m[:-1] + [m[-1].view(-1)[:-1]], v[:-1] + [v[-1].view(-1)[:-1]],
                      scale, bc1, bc2, lr, **ADAMW_HYPER)
        must_fail("a leaf's last element dropped", lambda: require_bitwise(
            f"{what}, the last leaf's last element dropped",
            adamw_run(leaves, grads, mus, nus, dropped), plain))
        big = max(range(len(grads)), key=lambda i: grads[i].numel())
        must_fail("the largest leaf left out of the norm", lambda: require_norm(
            f"{what}, the norm without leaf {big}",
            float(aw.norm(grads[:big] + grads[big + 1:])), exact, rtol))
        rec["controls_caught"] = 3
    del plain
    torch.cuda.empty_cache()
    return rec, grads, mus, nus


def adamw_rows(ops, arch, leaves, grads, mus, nus, rec):
    """The two kernels timed on ``arch``'s tree (in place, ADAMW_ITERS
    launches) beside the plain versions and their bounds: the kernels line's
    rows, launches unset."""
    import torch

    from repro_torch.kernels import adamw as aw
    from repro_torch.kernels import ref

    scal = [torch.full((), x, dtype=torch.float32, device=grads[0].device)
            for x in (rec["scale"], 0.5, 0.1, ADAMW_LR)]
    ms_norm = time_ms(lambda: aw.norm(grads), ADAMW_ITERS, sleep_cycles=ADAMW_SLEEP_CYCLES)
    ms_update = time_ms(lambda: aw.update(leaves, grads, mus, nus, *scal, **ADAMW_HYPER),
                        ADAMW_ITERS, sleep_cycles=ADAMW_SLEEP_CYCLES)
    plain_norm = time_ms(lambda: ref.adamw_norm(grads), 2, 1)
    plain_update = time_ms(lambda: ref.adamw_update(leaves, grads, mus, nus, *scal,
                                                    **ADAMW_HYPER), 2, 1)
    n = sum(p.numel() for p in leaves)
    g_bytes = sum(g.numel() * g.element_size() for g in grads)
    p_bytes = sum(p.numel() * p.element_size() for p in leaves)
    norm_bound, norm_by = bound(g_bytes + 4, 2 * n, "torch.float32")
    upd_bound, upd_by = bound(g_bytes + 2 * p_bytes + 16 * n + 16, ADAMW_FLOPS * n,
                              "torch.float32")
    dtypes = sorted({str(p.dtype).replace("torch.", "") for p in leaves})
    shape = f"{arch} tree: {len(leaves)} leaves, {n} params ({'/'.join(dtypes)})"
    base = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/adamw.cu",
            "replaces": REPLACES["adamw"], "variant": aw.VARIANT, "shape": shape,
            "library_ms": None}  # no one PyTorch call: bf16 params, f32 moments, a global clip
    rows = [{"name": "adamw_norm", **base, "max_abs_err": abs(rec["grad_norm"]
                                                              - rec["grad_norm_f64"]),
             "rel_err": rec["norm_rel_err"], "ms": ms_norm, "plain_ms": plain_norm,
             "bound_ms": norm_bound, "bound_by": norm_by},
            {"name": "adamw_update", **base, "max_abs_err": rec["update_max_gap"],
             "ms": ms_update, "plain_ms": plain_update, "bound_ms": upd_bound,
             "bound_by": upd_by}]
    for r in rows:
        log(f"    {r['name']} [{aw.VARIANT}] {shape}: ms={r['ms']:.4f} plain_ms="
            f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.4f} ({r['bound_by']}) "
            f"kernel/bound={r['ms'] / r['bound_ms']:.2f}; library: none")
    log(f"    a step's two kernels {ms_norm + ms_update:.3f} ms against the plain version's "
        f"{plain_norm + plain_update:.3f} ms; bound {norm_bound + upd_bound:.3f} ms")
    return rows


def phase_adamw(ops, dev, seed):
    """(f) The AdamW kernels: an edge tree (sizes off the vector and tile
    edges, both dtypes, two packs), then stablelm-1.6b's and rwkv6-1.6b's
    full-width trees (seeded params; seeded gradients in the clip regime
    that binds and in one that does not), each through
    ``adamw_tree_check`` (its controls on the full trees where the clip
    binds), and both kernels timed on each full tree. Returns {arch: the
    two rows}."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    t0 = time.perf_counter()
    edge = [torch.randn(n, device=dev).to(getattr(torch, d)) for n, d in ADAMW_EDGE]
    log(f"  AdamW edge tree: {len(edge)} leaves, {adamw_packs(edge)} packs")
    ADAMW_REPORT["edge"] = adamw_tree_check(ops, "edge tree", edge, dev, seed, 1e-2)[0]
    del edge
    rows = {}
    for arch, *_ in TRAIN_ARCHS:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        leaves = tree_leaves(build_model(get_config(arch), device=dev).init(gen))
        log(f"  AdamW {arch}: {len(leaves)} leaves, {sum(p.numel() for p in leaves)} params, "
            f"{adamw_packs(leaves)} pack")
        report = {}
        for regime, std in ADAMW_REGIMES.items():
            binds = regime == "clip binds"
            rec, grads, mus, nus = adamw_tree_check(ops, f"{arch}, {regime}", leaves, dev,
                                                    seed + 1, std, controls=binds)
            if binds != (rec["scale"] < 1.0):
                raise PhaseFailed(f"{arch}: the clip regime '{regime}' gave scale "
                                  f"{rec['scale']}")
            report[regime] = rec
            if binds:
                rows[arch] = adamw_rows(ops, arch, leaves, grads, mus, nus, rec)
            del grads, mus, nus
            torch.cuda.empty_cache()
        ADAMW_REPORT[arch] = report
        del leaves
        torch.cuda.empty_cache()
    log(f"    {time.perf_counter() - t0:.1f} s")
    return rows


# Kernel function names of csrc/ on the training path (forward and backward).
PORT_KERNEL_NAMES = ("flash_wgmma", "flash_kernel", "delta_kernel", "dkdv_wgmma", "dq_wgmma",
                     "rows_kernel", "dkdv_kernel", "dq_kernel", "wkv6_chunked", "wkv6_bwd",
                     "adamw_norm_kernel", "adamw_update_kernel")
ADAMW_KERNEL_NAMES = ("adamw_norm_kernel", "adamw_update_kernel")


def profile_train(arch, batch, seq, dev, seed, steps=3):
    """Where a full-width bf16 train step's time goes: after two warm-up
    steps, the host wall of forward + backward and of the optimizer update,
    each ended by a synchronize; then torch.profiler over ``steps`` whole
    steps: wall and kernel time a step, the AdamW kernels' device time a
    step, the device's idle share (1 - kernel time / wall), kernels a step,
    the kernels that take the most time, and the port's own kernels among
    the rest."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticTokenStream, make_train_step
    from repro_torch.training.optimizer import adamw_init, adamw_update, lr_schedule
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    opt = adamw_init(params)
    step = make_train_step(model, base_lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                           total_steps=TRAIN_STEPS)
    data = SyntheticTokenStream(cfg.vocab_size, seq, batch, seed=seed)
    batches = [tuple(torch.as_tensor(a, device=dev).long() for a in data.batch(i))
               for i in range(2 + 2 * steps)]
    for tok, lab in batches[:2]:
        params, opt, _ = step(params, opt, tok, lab)
    torch.cuda.synchronize()
    fb, up = [], []
    leaves = tree_leaves(params)
    for tok, lab in batches[2:2 + steps]:
        t0 = time.perf_counter()
        loss, _ = model.forward_train(params, tok, lab)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _ = adamw_update(grads, opt, params,
                                      lr_schedule(opt.step, TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        up.append(time.perf_counter() - t1)
        del grads, loss
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tok, lab in batches[2 + steps:]:
            params, opt, _ = step(params, opt, tok, lab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    opt_us = sum(e.self_device_time_total for e in kernels
                 if any(name in e.key for name in ADAMW_KERNEL_NAMES))
    log(f"  profile {arch} train step ({batch} x {seq}, bf16): forward + backward "
        f"{np.median(fb) * 1e3:.1f} ms, optimizer {np.median(up) * 1e3:.1f} ms ({len(leaves)} "
        f"leaves; host wall of the eager update to a synchronize), optimizer kernels "
        f"{opt_us / steps / 1e3:.3f} ms/step of device time (the profiler: "
        f"{', '.join(ADAMW_KERNEL_NAMES)}); profiled wall {wall / steps * 1e3:.1f} ms/step, "
        f"kernels {busy_us / steps / 1e3:.1f} ms/step, device idle share "
        f"{1 - busy_us / 1e6 / wall:.3f}, "
        f"{sum(e.count for e in kernels) / steps:.0f} kernels/step")
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in ranked[:10]:
        log(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
            f"{e.count / steps:6.0f}x  {e.key[:90]}")
    for e in ranked[10:]:  # the port's own kernels below the first ten
        if any(name in e.key for name in PORT_KERNEL_NAMES):
            log(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
                f"{e.count / steps:6.0f}x  {e.key[:90]}")
    del params, opt, batches
    torch.cuda.empty_cache()


def phase_train(ops, dev, seed, profile=False):
    """Phase 10: (a, b) the backward kernels, (c) the full-width 2-layer
    kernel path against the plain path, (d) train() at full width and depth
    (its step graphed), (e) the graphed train step against the eager one,
    (f) the AdamW kernels against the plain update; with ``profile``, where
    each model's train step's time goes. Returns (the backward and AdamW
    kernels' rows, the train record)."""
    rows = phase_bwd_kernels(ops, dev, seed)
    for arch, _, _, op in TRAIN_ARCHS:
        train_vs_plain(ops, arch, op, dev, seed)
    records = []
    with tempfile.TemporaryDirectory(prefix="repro_ckpt_") as ckpt_dir:
        for (arch, batch, seq, op), row in zip(TRAIN_ARCHS, rows):
            rec, launches, by_variant = train_full(ops, arch, batch, seq, op, dev, seed, ckpt_dir)
            row["launches"] = launches
            row["launches_by_variant"] = by_variant
            records.append(rec)
    for arch, batch, seq, op in TRAIN_ARCHS:
        graph_train_check(ops, arch, batch, seq, op, dev, seed)
    adamw = phase_adamw(ops, dev, seed)
    for rec in records:  # the kernels' launches on the main path: (d)'s train()
        for row in adamw[rec["arch"]]:
            row["launches_by_variant"] = rec["launches"].get(row["name"], {})
            row["launches"] = sum(row["launches_by_variant"].values())
            rows.append(row)
    if profile:
        for arch, batch, seq, _ in TRAIN_ARCHS:
            profile_train(arch, batch, seq, dev, seed)
    return rows, records


# ----------------------------------------------------------------- phase 11
# build_step's programs on the card, at full width and depth in bf16; the
# assigned shapes' batch cut to fit one card (seq lengths kept).
P11_STEPS = (  # (arch, assigned shape, batch on the card, its seq (kept), microbatch, tenants)
    ("stablelm-1.6b", "train_4k", 4, 4096, 1, 1), ("stablelm-1.6b", "train_4k", 4, 4096, 4, 1),
    ("rwkv6-1.6b", "train_4k", 4, 4096, 1, 1), ("rwkv6-1.6b", "train_4k", 4, 4096, 4, 1),
    ("stablelm-1.6b", "prefill_32k", 1, 32768, 1, 1),
    ("rwkv6-1.6b", "prefill_32k", 1, 32768, 1, 1),
    ("stablelm-1.6b", "decode_32k", 4, 32768, 1, 1),
    ("stablelm-1.6b", "decode_32k", 4, 32768, 1, 4),
)
P11_RUNS = {"train": (1, 1), "prefill": (1, 2), "decode": (1, 5)}  # (warm-up, timed) calls
# the float32 equivalences: full width, 2 layers; microbatch 4 against 1 over
# 4 x 1024 tokens; 4 tenants x 2 slots against caches of 2048
P11_EQ = {"layers": 2, "batch": 4, "seq": 1024, "microbatch": 4, "tenants": 4, "slots": 2,
          "cache": 2048}
EQ_LOSS_RTOL = 1e-5              # tests/test_launch.py:69-71, the reference's own
EQ_GRAD_TOL = (1e-4, 1e-5)       # (rtol, atol), elementwise
EQ_LOGIT_RTOL = 1e-4             # merged vs per-tenant: of the largest |logit|
P11_BUDGET_S = 90.0
DRYRUN_JOBS = 6                  # worker processes of the --all --mesh host child
DRYRUN_NICE = 15                 # the dry-run children yield the CPU to the card's host thread
DRYRUN_POD1 = ("stablelm-1.6b", "train_4k")
DRYRUN_TIMEOUT_S = 300
P11_KERNELS = {"flash_attention": "wgmma", "flash_attention_bwd": "wgmma",
               "wkv6_scan": "chunked", "wkv6_scan_bwd": "cluster", "wkv6_state": "segmented",
               "decode_attention": "split_kv", "adamw_norm": "multi_tensor",
               "adamw_update": "multi_tensor"}


def cut_shape(name, batch, seq=None):
    """The assigned shape ``name`` with its batch (and, given, its sequence)
    cut, registered in the port's shape table under a name of its own."""
    import dataclasses

    from repro_torch.config import shapes

    full = shapes.get_shape(name)
    seq = full.seq_len if seq is None else seq
    if (batch, seq) == (full.global_batch, full.seq_len):
        return name
    cut = f"{name}_b{batch}" + ("" if seq == full.seq_len else f"_s{seq}")
    shapes.INPUT_SHAPES[cut] = dataclasses.replace(full, name=cut, global_batch=batch,
                                                   seq_len=seq)
    return cut


def no_jax_env(tmp):
    """An environment whose Python cannot import jax or the reference
    package (stub modules that raise, ahead of everything on the path), for
    every process it starts, pool workers included."""
    stub = Path(tmp) / "no_jax"
    stub.mkdir(exist_ok=True)
    for mod in ("jax", "repro"):
        (stub / f"{mod}.py").write_text(f"raise ImportError('{mod} is unimportable here')\n")
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(stub), str(ROOT / "src")]))


def meta_cut_records(out_dir):
    """``--meta-cuts DIR``: the dry run's host record (meta counts, argument
    and temporary bytes) of every step phase 11 runs on the card, at its
    cut shape, two at a time."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.launch import dryrun

    cases = [(arch, cut_shape(shape, batch, seq), mb, tenants)
             for arch, shape, batch, seq, mb, tenants in P11_STEPS]
    ctx = multiprocessing.get_context("fork")  # the workers inherit the cut shapes
    with concurrent.futures.ProcessPoolExecutor(2, mp_context=ctx) as pool:
        futures = [pool.submit(dryrun.run_one, arch, shape, "host", out_dir, False,
                               microbatch=mb, tenants=tenants)
                   for arch, shape, mb, tenants in cases]
        bad = [f.result()["error"] for f in futures if f.result()["status"] != "ok"]
    if bad:
        print("\n".join(bad), file=sys.stderr)
        return 1
    return 0


def record_name(arch, shape, mesh, microbatch=1, tenants=1):
    """The dry run's record file name (``dryrun._write``), policy fsdp."""
    return (f"{arch}__{shape}__{mesh}" + (f"__R{tenants}" if tenants > 1 else "")
            + (f"__mb{microbatch}" if microbatch > 1 else "") + ".json")


def start_dryruns(tmp):
    """The dry-run children, started at once and niced: (a) ``python -m
    repro_torch.launch.dryrun --all --mesh host``, (b) one pod1 record, (c)
    the cut-shape records of this phase's steps; all with jax and repro
    unimportable. Returns {name: (Popen, log path)}."""
    env = no_jax_env(tmp)
    mod = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    arch, shape = DRYRUN_POD1
    cmds = {
        "host --all": mod + ["--all", "--mesh", "host", "--jobs", str(DRYRUN_JOBS),
                             "--out", str(Path(tmp) / "host")],
        "pod1": mod + ["--arch", arch, "--shape", shape, "--mesh", "pod1",
                       "--out", str(Path(tmp) / "pod1")],
        "cuts": [sys.executable, str(ROOT / "chip_smoke.py"), "--meta-cuts",
                 str(Path(tmp) / "cuts")],
    }
    procs = {}
    for name, cmd in cmds.items():
        path = Path(tmp) / f"{name.split()[0]}.log"
        with open(path, "w") as out:
            procs[name] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                            stderr=subprocess.STDOUT, start_new_session=True,
                                            preexec_fn=lambda: os.nice(DRYRUN_NICE)), path)
    return procs


def finish_dryruns(procs, tmp, t_start):
    """Waits for the dry-run children (killing them at DRYRUN_TIMEOUT_S),
    then checks their records: every exit code 0; one host record per
    (arch, shape), each ok or skipped with ``eligible``'s reason; the pod1
    record's per-device argument bytes equal to the sum of ``shard_shape``
    over its step's specs. Returns (host records, pod1 record, cut records
    by file name)."""
    import math
    import signal

    from repro_torch.config import INPUT_SHAPES, get_config, list_configs
    from repro_torch.distributed.sharding import shard_shape, spec_leaves
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_step, eligible

    for name, (proc, path) in procs.items():
        try:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - t_start)))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise PhaseFailed(f"dry run {name}: still running after {DRYRUN_TIMEOUT_S} s")
        log(f"  dry run {name} (jax and repro unimportable): exit {proc.returncode}, "
            f"{time.perf_counter() - t_start:.1f} s after the phase began")
        if proc.returncode != 0:
            raise PhaseFailed(f"dry run {name} exited {proc.returncode}: "
                              f"{path.read_text()[-3000:]}")
    host = {}
    for arch in list_configs():
        for shape in INPUT_SHAPES:
            if shape not in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
                continue
            path = Path(tmp) / "host" / record_name(arch, shape, "host")
            if not path.exists():
                raise PhaseFailed(f"dry run --all --mesh host wrote no {path.name}")
            rec = json.loads(path.read_text())
            ok, why = eligible(get_config(arch), shape)
            if rec["status"] != ("ok" if ok else "skipped") or rec.get("reason", "") != why:
                raise PhaseFailed(f"dry run {arch} x {shape}: {rec['status']} "
                                  f"{rec.get('reason', rec.get('error', ''))}")
            host[arch, shape] = rec
    n_ok = sum(r["status"] == "ok" for r in host.values())
    log(f"  host records: {len(host)} ({n_ok} ok, {len(host) - n_ok} skipped with eligible's "
        "reason); one card: arguments / temporaries GB, meta-count TFLOP:")
    for (arch, shape), rec in host.items():
        if rec["status"] == "ok":
            mem = rec["memory_analysis"]
            log(f"    {arch} x {shape}: {mem['argument_size_in_bytes'] / 1e9:.2f} / "
                f"{mem['temp_size_in_bytes'] / 1e9:.2f}, {rec['hlo_flops_raw'] / 1e12:.1f} "
                f"(analytic {rec['analytic_flops'] / 1e12:.1f}), meta run {rec['meta_run_s']} s")
    arch, shape = DRYRUN_POD1
    pod = json.loads((Path(tmp) / "pod1" / record_name(arch, shape, "pod1")).read_text())
    mesh = make_production_mesh()
    _, args, in_specs, _ = build_step(get_config(arch), shape, mesh, device="meta")
    want = sum(math.prod(shard_shape(tuple(t.shape), s, mesh)) * t.element_size()
               for t, s in zip(spec_leaves(list(args)), spec_leaves(list(in_specs))))
    got = pod["memory_analysis"]["argument_size_in_bytes"]
    log(f"  pod1 record {arch} x {shape} (shard arithmetic for a 256-device mesh the port does "
        f"not run on): arguments {got} bytes a device, sum of shard_shape over the specs "
        f"{want}: {'ok' if got == want else 'FAIL'}")
    if got != want:
        raise PhaseFailed("dry run pod1: argument bytes differ from the shards of the specs")
    cuts = {p.name: json.loads(p.read_text()) for p in (Path(tmp) / "cuts").glob("*.json")}
    return host, pod, cuts


def p11_args(cfg, kind, shape, tenants, dev, seed):
    """Real tensors on the card for a step's meta args: seeded random weights
    (``Model.init`` / ``init_stacked``, RWKV's decay made data-dependent,
    then ``params_to_scan``), zero AdamW state, random tokens, caches filled
    with N(0, 1) bf16 values and lengths in the cache's last 64 positions."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models.convert import params_to_scan
    from repro_torch.training.optimizer import adamw_init

    model = build_model(cfg, device=dev)
    gens = []
    for t in range(tenants):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 100 + t)
        gens.append(g)
    if tenants > 1:
        layers = model.init_stacked(gens)
    else:
        layers = model.init(gens[0])
    if cfg.ssm is not None and "rwkv" in cfg.name:
        live_decay_(layers, gens[0])
    params = params_to_scan(cfg, layers, stack=(lambda ts: torch.stack(ts, 1))
                            if tenants > 1 else torch.stack)
    del layers
    B, S = shape.global_batch // tenants, shape.seq_len
    lead = (tenants, B) if tenants > 1 else (B,)

    def ints(low, high, size):
        return torch.randint(low, high, size, generator=gens[0], device=dev, dtype=torch.int32)

    if kind == "train":
        return (params, adamw_init(params), ints(1, cfg.vocab_size, (B, S)),
                ints(1, cfg.vocab_size, (B, S)))
    if kind == "prefill":
        return params, ints(1, cfg.vocab_size, (B, S))
    caches = model.init_caches(B, S, tenants=tenants if tenants > 1 else None)
    for leaves in caches.values():
        for c in leaves:
            c.normal_(generator=gens[0])
    return params, ints(1, cfg.vocab_size, lead), caches, ints(S - 64, S - 1, lead)


def p11_step(ops, dev, seed, arch, shape_name, batch, seq, mb, tenants):
    """One of build_step's programs on the card: its meta args' bytes against
    the bytes of the tensors really allocated for them; warm-up and timed
    calls; every op's launches by variant against the program's (layers x
    calls, the train step's forward twice a slice under remat "block", the
    bf16 RWKV prefill's scan and state pass a layer) and no plain call. The
    eager decode step at 32768 with one tenant is profiled once more: its
    wall, its kernel time and K3's (``decode_32k_profile``)."""
    import torch

    from repro_torch.config import get_config, get_shape
    from repro_torch.distributed.sharding import shard_bytes, spec_leaves
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import rwkv
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    name = cut_shape(shape_name, batch, seq)
    shape = get_shape(name)
    kind = shape.kind
    mesh = make_host_mesh()
    step, args, in_specs, _ = build_step(cfg, name, mesh, microbatch=mb, tenants=tenants,
                                         device=dev)
    meta_bytes = shard_bytes(list(args), list(in_specs), mesh)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    real = p11_args(cfg, kind, shape, tenants, dev, seed)
    torch.cuda.synchronize()
    alloc = torch.cuda.memory_allocated() - base
    leaves = spec_leaves(list(real))
    metas = spec_leaves(list(args))
    if [(tuple(t.shape), t.dtype) for t in leaves] != [(tuple(t.shape), t.dtype) for t in metas]:
        raise PhaseFailed(f"{arch} {name}: the card's arguments are not the meta arguments")
    card_bytes = sum(t.untyped_storage().nbytes() for t in leaves)
    label = (f"{arch} {kind} {shape.global_batch} x {shape.seq_len}"
             + (f" microbatch {mb}" if mb > 1 else "") + (f" R={tenants}" if tenants > 1 else ""))
    same = card_bytes == meta_bytes
    log(f"  {label} ({name}): arguments {card_bytes / 1e9:.3f} GB on the card, meta count "
        f"{meta_bytes / 1e9:.3f} GB: {'equal' if same else 'DIFFER'} (allocator: "
        f"{alloc / 1e9:.3f} GB in {len(leaves)} tensors)")
    if not same:
        raise PhaseFailed(f"{label}: argument bytes {card_bytes} on the card, {meta_bytes} "
                          "by the meta count")
    warm, timed = P11_RUNS[kind]
    ops.reset_counters()
    torch.cuda.reset_peak_memory_stats()
    times, out = [], None
    for i in range(warm + timed):
        del out
        t0 = time.perf_counter()
        out = step(*real)
        torch.cuda.synchronize()
        if i >= warm:
            times.append(time.perf_counter() - t0)
        if kind == "train":
            real = (out[0], out[1]) + real[2:]
    peak = torch.cuda.max_memory_allocated()
    check = out[2] if kind == "train" else out[0]
    if not torch.isfinite(check.float()).all():
        raise PhaseFailed(f"{label}: non-finite {'loss' if kind == 'train' else 'logits'}")
    calls = warm + timed
    L = cfg.num_layers
    if kind == "train":
        op = "flash_attention" if cfg.ssm is None else "wkv6_scan"
        packs = adamw_packs(tree_leaves(args[0]))  # the meta params
        want = {op: 2 * L * mb * calls, op + "_bwd": L * mb * calls,
                "adamw_norm": packs * calls, "adamw_update": packs * calls}
    elif kind == "prefill":
        per_layer = (rwkv.prefill_launches(torch.bfloat16) if cfg.ssm is not None
                     else {"flash_attention": 1})
        want = {op: L * calls * n for op, n in per_layer.items()}
    else:
        want = {"decode_attention": L * calls}
    got = {k: dict(c.variants) for k, c in ops.COUNTERS.items() if c.launches}
    plain = {k: c.plain_calls for k, c in ops.COUNTERS.items() if c.plain_calls}
    expect = {k: {P11_KERNELS[k]: n} for k, n in want.items()}
    log(f"    launches over {calls} calls: {got}; plain calls: {plain or 'none'}")
    if got != expect or plain:
        raise PhaseFailed(f"{label}: launches {got}, not {expect}, or plain calls {plain}")
    ms = float(np.median(times)) * 1e3
    profiled = None
    if kind == "decode" and tenants == 1:  # one call more, after the launches were read
        profiled = decode_32k_profile(step, real)
        profiled["kernel_share_of_step"] = profiled["kernel_ms"] / ms
        log(f"    kernel time {profiled['kernel_ms']:.3f} ms of the unprofiled step's {ms:.3f} ms: "
            f"share {profiled['kernel_share_of_step']:.3f}")
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    rec = {"arch": arch, "kind": kind, "shape": name, "batch": shape.global_batch,
           "seq": shape.seq_len, "microbatch": mb, "tenants": tenants, "dtype": "bfloat16",
           "layers": L, "step_ms": ms, "tokens_per_s": tokens / (ms / 1e3),
           "arguments_bytes": card_bytes, "meta_arguments_bytes": meta_bytes,
           "peak_minus_arguments_bytes": peak - card_bytes,
           "loss": float(out[2]) if kind == "train" else None,
           "launches": {k: v for k, v in got.items()}, "profile": profiled}
    log(f"    step {ms:.1f} ms (median of {timed}), {rec['tokens_per_s']:.0f} tokens/s, peak "
        f"{peak / 1e9:.2f} GB = arguments + {(peak - card_bytes) / 1e9:.2f} GB"
        + (f", loss {rec['loss']:.4f}" if kind == "train" else ""))
    del real, out, check
    torch.cuda.empty_cache()
    return rec


def decode_32k_profile(step, args):
    """One eager decode step under torch.profiler (after the timed ones):
    host wall, device time in kernels and the idle share, K3's time and
    launches, and the kernels that take the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    k3 = [e for e in kernels if "decode_" in e.key]
    k3_us = sum(e.self_device_time_total for e in k3)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    rec = {"wall_ms": wall * 1e3, "kernel_ms": busy_us / 1e3,
           "kernel_share": busy_us / 1e6 / wall, "kernels": sum(e.count for e in kernels),
           "k3_ms": k3_us / 1e3, "k3_launches": sum(e.count for e in k3),
           "top": [(e.key[:80], e.self_device_time_total / 1e3, e.count) for e in top]}
    log(f"    profiled decode step: wall {rec['wall_ms']:.3f} ms, kernels {rec['kernel_ms']:.3f} ms "
        f"(share {rec['kernel_share']:.3f}) in {rec['kernels']} launches, K3 {rec['k3_ms']:.3f} ms "
        f"in {rec['k3_launches']}")
    for key, ms, n in rec["top"]:
        log(f"      {ms:8.3f} ms {n:5d}x  {key}")
    return rec


P11_LONG_T = 32768  # the long-context rows' cache length and steps


def p11_long_context(ops, dev, seed):
    """The long-context kernel rows, each timed beside its bound (and SDPA's
    time for K3): K3 at the decode_32k step's shape (4, 32, 32, 32768, 64),
    lengths in the cache's last 64 positions; the chunked K5 (bf16 w, the
    outputs' launch) and the state pass (float32 w, with K5's float32-w
    launch as its prior) at rwkv6's prefill_32k, 32 heads x 32768 steps, from
    a random state."""
    import torch

    from repro_torch.kernels import wkv6_state as ws

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 111)
    bf = torch.bfloat16
    rows = {}
    T = P11_LONG_T
    log(f"  decode_attention bf16 (4, 32, 32, {T}, 64), the decode_32k step's shape")
    k3 = measure_decode(ops, dev, gen, bf, 4, 32, 32, T, 64, [T - 1 - 16 * i for i in range(4)],
                        iters=10)
    rows["decode_attention"] = {"shape": f"(4, 32, 32, {T}, 64)", **k3}
    r, k, v, w, u = wkv_inputs(gen, dev, bf, T, w_dtype=torch.float32)
    s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
    wb = w.to(bf)
    k5_bytes, k5_flops = wkv_work(T, bf)
    st_bytes, st_flops = state_work(WKV_HEADS, T, WKV_N, WKV_N, bf)
    buf, prior_buf, out_buf = s0.clone(), s0.clone(), s0.clone()
    ms, prior_ms, turns = timed_turns(
        lambda: ops.wkv6_state(k, v, w, init_state=buf, final_state=buf),
        lambda: ops.wkv6_scan(r, k, v, w, u, init_state=prior_buf, final_state=prior_buf), 5)
    k5_ms = time_ms(lambda: ops.wkv6_scan(r, k, v, wb, u, init_state=out_buf), 5)
    for name, t, (nbytes, flops), extra in (
            ("wkv6_scan", k5_ms, (k5_bytes, k5_flops), {"variant": "chunked", "w": "bf16"}),
            ("wkv6_state", ms, (st_bytes, st_flops),
             {"variant": ws.variant(T), "segments": ws.segments(WKV_HEADS, T),
              "w": "float32",
              "prior": "wkv6_scan chunked, float32 w", "prior_ms": prior_ms, "turns_ms": turns})):
        bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
        rows[name] = {"shape": f"({WKV_HEADS} heads, T={T}, N=V={WKV_N}), bf16 k, v", "ms": t,
                      "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None, **extra}
        log(f"  {name} at rwkv6 prefill_32k ({WKV_HEADS} heads x {T}): ms={t:.4f} "
            f"bound_ms={bound_ms:.4f} ({bound_by}) kernel/bound={t / bound_ms:.2f}"
            + (f" prior_ms={prior_ms:.4f} ({prior_ms / t:.1f}x; turns "
               f"{', '.join(f'{x:.4f}' for x in turns)})" if name == "wkv6_state" else ""))
    del r, k, v, w, wb
    torch.cuda.empty_cache()
    return rows


def p11_kernels(ops, dev, seed):
    """K3, K4, K5 and both backward kernels against their plain versions at
    this phase's shapes, a slice of (batch, head) where the plain version
    would not fit: K4 at the prefill's 32,768 and the train step's 4,096;
    K3 at the decode step's caches of 32,768; K5 at 32,768 steps (the
    outputs' launch, bf16 w) and the state pass there (float32 w), both from
    a random state; K4-bwd and K5-bwd at the train step's 4,096. Returns the
    max errors by kernel."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.kernels import wkv6_scan as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 110)
    bf = torch.bfloat16
    errs = {}
    _, _, errs["flash_attention"] = check_flash(ops, dev, gen, bf, 1, 1, 1, 32768, 32768, 64, 0)
    check_flash(ops, dev, gen, bf, 1, 2, 2, 4096, 4096, 64, 0)
    lengths = [32768 - 1 - i for i in range(4)]
    _, errs["decode_attention"] = check_decode(ops, dev, gen, bf, 4, 32, 32, 32768, 64, lengths)
    r, k, v, w, u, _ = wkv_bwd_inputs(gen, dev, bf, 1, 1, 32768, 64, -3.0, 1.0)
    s0 = torch.randn((1, 64, 64), generator=gen, device=dev)
    errs["wkv6_scan"], _, _ = check_wkv(ops, "wkv6_scan bf16 (1, 1, 32768, 64), outputs' launch",
                                        bf, (r, k, v, w, u), s0)
    w32 = w.float() + 0.01 * torch.randn(w.shape, generator=gen, device=dev)
    errs["wkv6_state"], _ = check_state(ops, "wkv6_state (1, 1, 32768, 64), bf16 k, v, float32 w, "
                                        "random state", k, v, w32, s0)
    del r, k, v, w, w32
    torch.cuda.empty_cache()
    q, k, v, do = flash_bwd_inputs(gen, dev, bf, 1, 1, 1, 4096, 64)
    lse = torch.empty((1, 1, 4096), dtype=torch.float32, device=dev)
    with torch.no_grad():
        o = fa.flash_attention(q, k, v, q_offset=0, lse=lse)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, kernel=fa.bwd_variant(bf, 64))
    errs["flash_attention_bwd"] = check_grads(
        "flash_attention_bwd bf16 (1, 1, 1, 4096, 64) [wgmma] vs ref.attention_bwd", got,
        ref.attention_bwd(q, k, v, o, do), str(bf), BWD_TOL[str(bf)])
    inputs = wkv_bwd_inputs(gen, dev, bf, 1, 1, 4096, 64, -3.0, 1.0)
    ckpt = torch.empty(wk.chunk_states_shape(1, 4096, 64, 64), dtype=torch.float32, device=dev)
    with torch.no_grad():
        wk.wkv6_scan(*inputs[:5], ckpt=ckpt)
    got = wk.wkv6_scan_bwd(*inputs, ckpt=ckpt, kernel=wk.bwd_variant(bf, 4096))
    errs["wkv6_scan_bwd"] = check_grads(
        "wkv6_scan_bwd bf16 (1, 1, 4096, 64) [cluster] vs ref.wkv6_scan_bwd", got,
        ref.wkv6_scan_bwd(*inputs), str(bf), BWD_TOL[str(bf)])
    torch.cuda.synchronize()
    return errs


def leaf_excess(grads, grads_ref):
    """Per leaf, the largest |g - g_ref| / (atol + rtol |g_ref|) at
    EQ_GRAD_TOL: above 1 where the reference's elementwise check fails."""
    rtol, atol = EQ_GRAD_TOL
    return [float(((g.float() - w.float()).abs() / (atol + rtol * w.float().abs())).max())
            for g, w in zip(grads, grads_ref)]


def grads_check(loss, grads, loss_ref, grads_ref, limits):
    """The reference's microbatch check: loss within rtol EQ_LOSS_RTOL, and
    every leaf's excess (``leaf_excess``) within its limit. Returns
    (passed, the loss's relative gap, leaves beyond their limit, the
    excesses)."""
    lgap = abs(float(loss) - float(loss_ref)) / abs(float(loss_ref))
    excess = leaf_excess(grads, grads_ref)
    bad = sum(e > lim for e, lim in zip(excess, limits))
    return lgap <= EQ_LOSS_RTOL and bad == 0, lgap, bad, excess


def p11_microbatch_equivalence(ops, arch, dev, seed):
    """Microbatch 4 against microbatch 1 in float32 at full width, 2 layers
    (``loss_and_grads``, the train step's), by the reference's check: loss
    rtol EQ_LOSS_RTOL, every gradient element within EQ_GRAD_TOL. The same
    comparison on the plain path (``plain_kernels=True``, no kernel at all)
    is the yardstick of float32 itself: a leaf whose plain-path excess is
    above 1 (the two batchings round differently there; rwkv6-1.6b's
    recurrence at 1024 steps does, run BB of PERF.md) is held to twice that
    excess instead. The negative control, half the batch left out, must
    fail the same check."""
    import dataclasses

    import torch

    from repro_torch.config import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_to_scan

    n, B, S, k = P11_EQ["layers"], P11_EQ["batch"], P11_EQ["seq"], P11_EQ["microbatch"]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=n, dtype="float32",
                              block_pattern=cfg.block_pattern[:n] if cfg.block_pattern
                              else cfg.block_pattern)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 120)
    layers = model.init(gen)
    if cfg.ssm is not None:
        live_decay_(layers, gen)
    params = params_to_scan(cfg, layers)
    del layers
    tok = torch.randint(1, cfg.vocab_size, (B, S), generator=gen, device=dev, dtype=torch.int32)
    lab = torch.randint(1, cfg.vocab_size, (B, S), generator=gen, device=dev, dtype=torch.int32)
    plain = build_model(cfg, device=dev, plain_kernels=True)
    yard = leaf_excess(loss_and_grads(plain, params, tok, lab, microbatch=k)[1],
                       loss_and_grads(plain, params, tok, lab)[1])
    limits = [2 * y if y > 1.0 else 1.0 for y in yard]
    full = loss_and_grads(model, params, tok, lab)
    ok, lgap, bad, excess = grads_check(*loss_and_grads(model, params, tok, lab, microbatch=k),
                                        *full, limits)
    c_ok, c_lgap, c_bad, c_excess = grads_check(
        *loss_and_grads(model, params, tok[:B // 2], lab[:B // 2]), *full, limits)
    torch.cuda.synchronize()
    n_leaves = len(limits)
    widened = [i for i, y in enumerate(yard) if y > 1.0]
    worst = int(np.argmax([e / lim for e, lim in zip(excess, limits)]))
    verdict = "ok" if ok and not c_ok else "FAIL"
    log(f"  f32 {arch} ({n} layers, {B} x {S}): microbatch {k} vs 1: loss rel gap {lgap:.2e} "
        f"(rtol {EQ_LOSS_RTOL}); gradients at rtol {EQ_GRAD_TOL[0]} atol {EQ_GRAD_TOL[1]}: "
        f"{bad} of {n_leaves} leaves beyond their limit, worst leaf {worst} at "
        f"{excess[worst]:.2f} x its tolerance (limit {limits[worst]:.2f}); the plain path's own "
        f"microbatch excess above 1 in {len(widened)} leaves "
        f"({', '.join(f'{i}: {yard[i]:.2f}' for i in widened) or 'none'}), those held to twice "
        f"it; control, half the batch left out: loss rel gap {c_lgap:.2e}, {c_bad} of "
        f"{n_leaves} leaves beyond (largest {max(c_excess):.1f} x its tolerance), "
        f"{'caught' if not c_ok else 'NOT caught'}: {verdict}")
    if not ok or c_ok:
        raise PhaseFailed(f"{arch}: float32 microbatch equivalence failed, or its control "
                          "passed")
    del params, full
    torch.cuda.empty_cache()
    return {"loss_rel_gap": lgap, "excess": excess, "plain_excess": yard,
            "control_leaves_caught": c_bad, "leaves": n_leaves}


def p11_tenant_equivalence(ops, dev, seed):
    """build_step's merged R-tenant decode step against its single-model
    decode step per tenant, in float32 at full width and 2 layers: logits
    within EQ_LOGIT_RTOL of the largest |logit| and the same greedy tokens;
    the negative control, two tenants' weights swapped in the merged step,
    must fail that check. In bf16 the merged kernel path is held only by
    ``hold_bf16`` against the float32 plain path on the same weights."""
    import dataclasses

    import torch

    from repro_torch.config import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_scan, params_to_scan
    from repro_torch.tree import tree_map

    n, R, B, S = P11_EQ["layers"], P11_EQ["tenants"], P11_EQ["slots"], P11_EQ["cache"]
    base = get_config("stablelm-1.6b")
    cfg = dataclasses.replace(base, num_layers=n, dtype="float32")
    model = build_model(cfg, device=dev)
    gens = []
    for t in range(R):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 130 + t)
        gens.append(g)
    params = params_to_scan(cfg, model.init_stacked(gens), stack=lambda ts: torch.stack(ts, 1))
    params = tree_map(lambda t: t.to(torch.bfloat16).float(), params)  # bf16-exact weights
    caches = model.init_caches(B, S, tenants=R)
    for leaves in caches.values():
        for c in leaves:
            c.normal_(generator=gens[0])
            c.copy_(c.to(torch.bfloat16))
    tokens = torch.randint(1, cfg.vocab_size, (R, B), generator=gens[0], device=dev,
                           dtype=torch.int32)
    lengths = torch.randint(S // 2, S - 1, (R, B), generator=gens[0], device=dev,
                            dtype=torch.int32)
    merged_name = cut_shape("decode_32k", R * B, S)
    single_name = cut_shape("decode_32k", B, S)
    merged, *_ = build_step(cfg, merged_name, make_host_mesh(), tenants=R, device=dev)
    single, *_ = build_step(cfg, single_name, make_host_mesh(), device=dev)

    def fresh():
        return tree_map(lambda c: c.clone(), caches)

    with torch.no_grad():
        got, _ = merged(params, tokens, fresh(), lengths)
        want = torch.stack([single(tree_map(lambda a: a[t], params), tokens[t],
                                   tree_map(lambda c: c[t], fresh()), lengths[t])[0]
                            for t in range(R)])
        swapped = tree_map(lambda a: a[[1, 0] + list(range(2, R))], params)
        ctrl, _ = merged(swapped, tokens, fresh(), lengths)
    torch.cuda.synchronize()

    def judge(x):
        err = float((x - want).abs().max())
        same = bool((x.argmax(-1) == want.argmax(-1)).all())
        return err <= EQ_LOGIT_RTOL * float(want.abs().max()) and same, err, same

    ok, err, same = judge(got)
    c_ok, c_err, c_same = judge(ctrl)
    lim = EQ_LOGIT_RTOL * float(want.abs().max())
    verdict = "ok" if ok and not c_ok else "FAIL"
    log(f"  f32 stablelm-1.6b ({n} layers) merged decode of R={R} x {B} against caches of {S} vs "
        f"each tenant's own step: max |d| {err:.3e} (limit {lim:.3e}), greedy tokens equal "
        f"{same}; control, tenants 0 and 1 swapped: max |d| {c_err:.3e}, greedy tokens equal "
        f"{c_same}, {'caught' if not c_ok else 'NOT caught'}: {verdict}")
    if not ok or c_ok:
        raise PhaseFailed("merged-tenant decode: float32 equivalence failed, or its control "
                          "passed")
    # bf16: the merged step's kernel path and plain path against the float32 plain path
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    p16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    c16 = tree_map(lambda c: c.to(torch.bfloat16), caches)
    merged16, *_ = build_step(cfg16, merged_name, make_host_mesh(), tenants=R, device=dev)
    with torch.no_grad():
        k16, _ = merged16(p16, tokens, tree_map(lambda c: c.clone(), c16), lengths)
        plain16 = build_model(cfg16, device=dev, plain_kernels=True)
        p16_out, _ = plain16.forward_decode_tenants(params_from_scan(cfg16, p16, True), tokens,
                                                    tree_map(lambda c: c.clone(), c16), lengths)
        plain32 = build_model(cfg, device=dev, plain_kernels=True)
        ref32, _ = plain32.forward_decode_tenants(params_from_scan(cfg, params, True), tokens,
                                                  fresh(), lengths)
    hold_bf16(f"stablelm-1.6b merged decode R={R} ({n} layers)", k16, p16_out, ref32)
    del params, caches, p16, c16
    torch.cuda.empty_cache()
    return {"max_abs_diff": err, "limit": lim, "control_max_abs_diff": c_err}


def phase_dryrun_steps(ops, dev, seed):
    """Phase 11: build_step's programs on the card (the P11_STEPS), the
    kernels at their shapes, the two float32 equivalences with their
    negative controls, and the dry-run children (started first, niced).
    Returns (the phase record, launches by kernel and variant)."""
    import torch

    t_start = time.perf_counter()
    card = gpu_identity()
    log(f"  card: {card}")
    with tempfile.TemporaryDirectory(prefix="repro_dryrun_") as tmp:
        procs = start_dryruns(tmp)
        try:
            steps = [p11_step(ops, dev, seed, *case) for case in P11_STEPS]
            errs = p11_kernels(ops, dev, seed)
            long_context = p11_long_context(ops, dev, seed)
            eq = {arch: p11_microbatch_equivalence(ops, arch, dev, seed)
                  for arch in ("stablelm-1.6b", "rwkv6-1.6b")}
            eq["tenants"] = p11_tenant_equivalence(ops, dev, seed)
            t_card = time.perf_counter() - t_start
            host, pod, cuts = finish_dryruns(procs, tmp, t_start)
        finally:
            for proc, _ in procs.values():
                if proc.poll() is None:
                    os.killpg(proc.pid, 9)
                    proc.wait()
    for rec, (arch, _, _, _, mb, tenants) in zip(steps, P11_STEPS):
        cut = cuts.get(record_name(arch, rec["shape"], "host", mb, tenants))
        if cut is None or cut["status"] != "ok":
            raise PhaseFailed(f"no meta record of {arch} {rec['shape']}")
        mem = cut["memory_analysis"]
        if mem["argument_size_in_bytes"] != rec["arguments_bytes"]:
            raise PhaseFailed(f"{arch} {rec['shape']}: the dry run's argument bytes "
                              f"{mem['argument_size_in_bytes']} are not the card's "
                              f"{rec['arguments_bytes']}")
        rec["meta_temp_bytes"] = mem["temp_size_in_bytes"]
        rec["meta_flops"] = cut["hlo_flops_raw"]
        rec["analytic_flops"] = cut["analytic_flops"]
        log(f"  {arch} {rec['kind']} {rec['shape']} mb {mb} R {tenants}: arguments "
            f"{rec['arguments_bytes'] / 1e9:.3f} GB (dry run: equal); temporaries: meta run "
            f"{rec['meta_temp_bytes'] / 1e9:.2f} GB, card max_memory_allocated - arguments "
            f"{rec['peak_minus_arguments_bytes'] / 1e9:.2f} GB; step {rec['step_ms']:.1f} ms "
            f"({card})")
    launches = {}
    for rec in steps:
        for k, v in rec["launches"].items():
            for variant, n in v.items():
                launches.setdefault(k, {}).setdefault(variant, 0)
                launches[k][variant] += n
    wall = time.perf_counter() - t_start
    log(f"  phase 11: {wall:.1f} s ({t_card:.1f} s on the card's side; budget {P11_BUDGET_S:.0f} "
        f"s); launches by kernel and variant {launches}")
    if wall > P11_BUDGET_S:
        raise PhaseFailed(f"phase 11 took {wall:.1f} s, over its {P11_BUDGET_S:.0f} s budget")
    torch.cuda.empty_cache()
    record = {"card": card, "steps": steps, "kernel_max_abs_err": errs,
              "long_context": long_context, "equivalence": eq,
              "host_records": {f"{a} x {s}": r["status"] for (a, s), r in host.items()},
              "pod1": {k: pod[k] for k in ("arch", "shape", "mesh", "chips",
                                           "memory_analysis")},
              "wall_s": wall, "card_side_s": t_card}
    return record, launches


# ----------------------------------------------------------------- phase 12
# The port's example scripts (repro_torch/examples): the three that drive
# the card in process at the reference's sizes, each again as `python -m`
# in a child process that cannot import jax; the three simulator scripts as
# children with their event counts shrunk.
EXAMPLE_SIM_EVENTS = 2000
EXAMPLE_CHILD_STEPS = 30   # train_small's child (the in-process run takes the reference's 300)
EXAMPLE_TIMEOUT_S = 300
EXAMPLE_NICE = 10          # the simulator children yield the CPU to the card's host thread


def example_child(name, tmp, code=None, argv=()):
    """Start ``python -m repro_torch.examples.<name> argv`` (or ``python -c
    code``) with jax and the reference package unimportable, its output to
    a file under ``tmp``. Returns (process, output path)."""
    out = Path(tmp) / f"example_{name}.log"
    cmd = [sys.executable] + (["-c", code] if code else
                              ["-m", f"repro_torch.examples.{name}", *argv])
    fh = open(out, "w")
    proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT, cwd=ROOT,
                            env=no_jax_env(tmp), preexec_fn=(lambda: os.nice(EXAMPLE_NICE))
                            if code else None)
    fh.close()
    return proc, out


def finish_child(name, proc, out):
    """Wait for an example's child (killed past EXAMPLE_TIMEOUT_S); its exit
    code and last line."""
    try:
        rc = proc.wait(timeout=EXAMPLE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = "timeout"
    lines = out.read_text().splitlines()
    last = lines[-1] if lines else ""
    log(f"    python {name}: exit {rc}; last line: {last[:120]}")
    if rc != 0:
        log("\n".join(lines[-20:]))
    return rc


def counted(ops, fn):
    """``fn()`` with the launch counters reset before and read after:
    (its result, launches by variant per op, plain calls per op)."""
    import torch

    ops.reset_counters()
    res = fn()
    torch.cuda.synchronize()
    launches = {k: dict(c.variants) for k, c in ops.COUNTERS.items() if c.launches}
    plain = {k: c.plain_calls for k, c in ops.COUNTERS.items() if c.plain_calls}
    return res, launches, plain


def quiet(fn):
    """``fn()`` with its standard output kept: (its result, its lines)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn()
    return res, buf.getvalue().splitlines()


def phase_examples(ops, dev, seed):
    """Phase 12: the six example scripts. Returns the ``examples`` record."""
    import torch

    from repro_torch.config import get_config, smoke_variant
    from repro_torch.examples import multi_tenant_serving, spacetime_ablation, train_small
    from repro_torch.kernels import batched_gemm as bg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    del seed  # the scripts seed themselves, as the reference's do
    rec = {}
    with tempfile.TemporaryDirectory(prefix="repro_examples_") as tmp:
        sims = {name: example_child(name, tmp, code=(
            f"import repro_torch.examples.{name} as m; m.EVENTS = {EXAMPLE_SIM_EVENTS}; m.main()"))
            for name in ("quickstart", "policy_sweep", "fleet_routing")}

        # train_small at the reference's sizes: the graphed train(), K4 f32
        t0 = time.perf_counter()
        ckpt_path = str(Path(tmp) / "train_small.msgpack")
        with watch_programs() as made:
            (state, lines), launches, plain = counted(ops, lambda: quiet(
                lambda: train_small.main(["--checkpoint", ckpt_path])))
        wall = time.perf_counter() - t0
        base = get_config("stablelm-1.6b")
        cfg = smoke_variant(base, num_layers=4, d_model=512)
        steps = 300
        fwd_v = fa.variant(torch.float32, cfg.head_dim)
        bwd_v = fa.bwd_variant(torch.float32, cfg.head_dim)
        want = {"flash_attention": {fwd_v: cfg.num_layers * steps * 2},
                "flash_attention_bwd": {bwd_v: cfg.num_layers * steps},
                **adamw_launches(state.params, steps)}
        losses = [float(line.split("loss")[1].split()[0]) for line in lines if "loss" in line]
        st = made[0].stats()
        log(f"  train_small: {lines[0]}; loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
            f"{len(losses)} logged steps, {wall:.1f} s; launches {launches}, plain {plain}; "
            f"step {st['eager_passes']} eager, {st['captures']} capture, {st['replays']} replays")
        if launches != want or plain or not losses[-1] < losses[0] or state.step != steps \
                or (st["graphed"], st["replays"]) != (True, steps - 1) \
                or not os.path.getsize(ckpt_path):
            raise PhaseFailed(f"train_small: launches {launches} (want {want}), plain {plain}, "
                              f"losses {losses}, program {st}")
        rec["train_small"] = {"wall_s": wall, "losses": [losses[0], losses[-1]],
                              "launches": launches, "program": st}

        # multi_tenant_serving: 4 tenants, 16 requests, graphed decode (K3), K4 prefills
        t0 = time.perf_counter()
        (engine, lines), launches, plain = counted(ops, lambda: quiet(
            lambda: multi_tenant_serving.main([])))
        wall = time.perf_counter() - t0
        mcfg = smoke_variant(base)
        st = engine.programs.stats()
        n_attn = mcfg.num_layers
        served = len(engine.finished)
        log(f"  multi_tenant_serving: {lines[0]}; {lines[2]}; {lines[3]}; launches {launches}, "
            f"plain {plain}; decode {st['eager_passes']} eager, {st['replays']} replays")
        ok = (served == 16 and all(len(r.generated) == 12 for r in engine.finished)
              and set(launches) == {"flash_attention", "decode_attention"}
              and set(launches["flash_attention"]) == {fa.variant(torch.float32, mcfg.head_dim)}
              and launches["decode_attention"] == {
                  da.variant(torch.float32, mcfg.head_dim, mcfg.q_per_kv):
                  n_attn * st["decode_passes"]}
              and not plain and st["graphed"] and st["replays"] > 0)
        if not ok:
            raise PhaseFailed(f"multi_tenant_serving: {served} served, launches {launches}, "
                              f"plain {plain}, programs {st}")
        rec["multi_tenant_serving"] = {"wall_s": wall, "served": served, "launches": launches,
                                       "programs": st, "report": lines[2:4]}
        del engine

        # spacetime_ablation: the scheduler over K1 (float32: simt)
        t0 = time.perf_counter()
        (rows, lines), launches, plain = counted(ops, lambda: quiet(
            lambda: spacetime_ablation.main([])))
        wall = time.perf_counter() - t0
        dispatches = int(sum(r[3]["dispatches"] for r in rows))
        kind = bg.variant(torch.float32, 1152, 128)
        for line in lines:
            log(f"    {line}")
        log(f"  spacetime_ablation: {dispatches} dispatches, launches {launches}, plain {plain}, "
            f"{wall:.1f} s")
        if launches != {"batched_gemm": {kind: dispatches}} or plain:
            raise PhaseFailed(f"spacetime_ablation: launches {launches}, not {dispatches} "
                              f"{kind}, or plain calls {plain}")
        rec["spacetime_ablation"] = {"wall_s": wall, "dispatches": dispatches,
                                     "launches": launches, "table": lines}
        torch.cuda.empty_cache()

        # each card script as `python -m` in a child that cannot import jax
        rcs = {}
        for name, argv in (("train_small", ["--steps", str(EXAMPLE_CHILD_STEPS), "--checkpoint",
                                            str(Path(tmp) / "child.msgpack")]),
                           ("multi_tenant_serving", []), ("spacetime_ablation", [])):
            t0 = time.perf_counter()
            rcs[name] = finish_child(name, *example_child(name, tmp, argv=argv))
            rec[name]["child_rc"] = rcs[name]
            rec[name]["child_wall_s"] = time.perf_counter() - t0
        for name, (proc, out) in sims.items():
            rcs[name] = finish_child(name, proc, out)
            rec[name] = {"child_rc": rcs[name], "events": EXAMPLE_SIM_EVENTS}
        if any(rc != 0 for rc in rcs.values()):
            raise PhaseFailed(f"an example script failed: {rcs}")
    return rec


# ----------------------------------------------------------------- main
@contextlib.contextmanager
def phase_wall(n):
    t = time.perf_counter()
    yield
    log(f"phase {n}: {time.perf_counter() - t:.1f} s wall")


def build_report(_build):
    """ptxas's report for every kernel instance (entry function, registers,
    spills; static shared memory is on the registers line), the dynamic
    shared memory of the wgmma kernels (K4 at D = 64, 112, 128, 256 and its
    backward's dk_dv and dq at D = 64, 128, 256), K3's split_kv ring at every
    head dim in both dtypes and its mma ring at its head dims (held equal to
    the wrapper's ``ring_bytes`` and ``mma_ring_bytes``), K5's chunked kernel
    and its backward's two variants, the state pass, and how many of K3's
    clusters fit on the card at once at stablelm's and paligemma's decode
    shapes (split_kv at 4 splits, mma at 8 and 16) and of the state pass's
    at every segment count (beside ``wkv6_state.RESIDENT_CLUSTERS``), and the
    AdamW update kernel's parameter bytes (beside ``adamw.PARAM_BYTES``)."""
    import ctypes

    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
                log(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
    gg = _build.load("grouped_gemm").repro_grouped_gemm_smem
    fa = _build.load("flash_attention").repro_flash_attention_smem
    bg = _build.load("batched_gemm").repro_batched_gemm_smem
    da = _build.load("decode_attention")
    wk = _build.load("wkv6_scan").repro_wkv6_scan_smem
    wkb = _build.load("wkv6_scan_bwd").repro_wkv6_scan_bwd_smem
    fab = _build.load("flash_attention_bwd").repro_flash_attention_bwd_smem
    wks = _build.load("wkv6_state").repro_wkv6_state_smem
    gg.argtypes, gg.restype = [], ctypes.c_int
    for fn, n in ((fa, 1), (bg, 1), (da.repro_decode_attention_smem, 2),
                  (da.repro_decode_attention_clusters, 4), (da.repro_decode_attention_mma_smem, 1),
                  (da.repro_decode_attention_mma_clusters, 3), (wk, 2), (wkb, 1), (fab, 2),
                  (wks, 1)):
        fn.argtypes, fn.restype = [ctypes.c_int] * n, ctypes.c_int
    log(f"  dynamic shared memory: grouped_gemm wgmma {gg()} bytes; batched_gemm wgmma 64-row "
        f"{bg(64)}, 128-row {bg(128)} bytes; flash_attention wgmma "
        + ", ".join(f"D={d} {fa(d)}" for d in (64, 112, 128, 256))
        + " bytes; decode_attention split_kv ring "
        + ", ".join(f"D={d} {t} {da.repro_decode_attention_smem(d, c)}"
                    for d in (64, 112, 128, 256) for t, c in (("f32", 0), ("bf16", 1)))
        + "; mma ring " + ", ".join(f"D={d} {da.repro_decode_attention_mma_smem(d)}"
                                    for d in (64, 112, 128, 256))
        + f" bytes; wkv6_scan chunked f32 {wk(0, 1)}, bf16 {wk(1, 0)} bytes; wkv6_scan_bwd "
        f"chunked {wkb(0)}, cluster (bf16) {wkb(1)} bytes; flash_attention_bwd wgmma dk_dv / dq "
        + ", ".join(f"D={d} {fab(d, 0)} / {fab(d, 1)}" for d in (64, 128, 256))
        + f" bytes; wkv6_state segmented f32 {wks(0)}, bf16 {wks(1)} bytes")
    import torch

    from repro_torch.kernels import decode_attention as dapy

    for d in (64, 112, 128, 256):  # the wrapper's mirror of the ring agrees with the source
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if da.repro_decode_attention_smem(d, code) != dapy.ring_bytes(dtype, d):
                raise PhaseFailed(f"decode_attention: ring of D={d} {dtype} is "
                                  f"{da.repro_decode_attention_smem(d, code)} bytes, the wrapper "
                                  f"says {dapy.ring_bytes(dtype, d)}")
        if da.repro_decode_attention_mma_smem(d) != dapy.mma_ring_bytes(d):
            raise PhaseFailed(f"decode_attention: mma ring of D={d} is "
                              f"{da.repro_decode_attention_mma_smem(d)} bytes, the wrapper says "
                              f"{dapy.mma_ring_bytes(d)}")
    if fa(256) <= 0 or fa(112) != fa(128):
        raise PhaseFailed("flash_attention: no wgmma kernel at D=256, or D=112 not laid out as "
                          "128")
    from repro_torch.kernels import wkv6_state as wspy

    wsc = _build.load("wkv6_state").repro_wkv6_state_clusters
    wsc.argtypes, wsc.restype = [ctypes.c_int] * 2, ctypes.c_int
    for code in (0, 1):  # the segment rule's table against the card
        got = {g: wsc(code, g) for g in wspy.RESIDENT_CLUSTERS}
        log(f"  wkv6_state clusters resident at once by segments ({'bf16' if code else 'f32'}): "
            f"{got}; the rule's table {'equal' if got == wspy.RESIDENT_CLUSTERS else 'DIFFERS'}")
    from repro_torch.kernels import adamw as awpy

    awb = _build.load("adamw").repro_adamw_param_bytes
    awb.argtypes, awb.restype = [], ctypes.c_int
    log(f"  adamw_update_kernel parameters: {awb()} bytes (the wrapper's {awpy.PARAM_BYTES}, "
        f"the limit {awpy.PARAM_LIMIT_BYTES})")
    if awb() != awpy.PARAM_BYTES:
        raise PhaseFailed(f"adamw: the kernel's parameters are {awb()} bytes, the wrapper says "
                          f"{awpy.PARAM_BYTES}")
    for d, g in ((64, 1), (256, 8)):  # stablelm's and paligemma's decode steps
        clusters = da.repro_decode_attention_clusters(d, 1, g, 4)
        log(f"  decode_attention split_kv clusters of 4 resident at once (D={d} bf16, "
            f"q_per_kv {g}): {clusters}")
        if clusters <= 0:
            raise PhaseFailed("decode_attention: no cluster of the split_kv kernel fits on the "
                              "card")
    for d, g in ((64, 1), (256, 8)):
        for n in (8, 16):
            clusters = da.repro_decode_attention_mma_clusters(d, g, n)
            log(f"  decode_attention mma clusters of {n} resident at once (D={d}, q_per_kv "
                f"{g}): {clusters}")
            if clusters <= 0:
                raise PhaseFailed(f"decode_attention: no cluster of {n} of the mma kernel fits "
                                  "on the card")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11,12",
                    help="comma list of phases to run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 5, 6 and 7, profile steady decode steps of both "
                         "modes; after phase 4, profile the scheduler's two GEMM streams; after "
                         "phase 10, profile full-width train steps")
    ap.add_argument("--rows-out", metavar="FILE",
                    help="write the kernels rows to FILE as JSON, in place of the closing "
                         "lines (how phase 4 reports to the run that started it)")
    ap.add_argument("--meta-cuts", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.meta_cuts:  # phase 11's child: the dry run's records of its cut shapes
        return meta_cut_records(args.meta_cuts)
    phases = {int(p) for p in args.phases.split(",")}
    # Phase 4's space_only spreads its products over 32 streams (Hyper-Q),
    # which map onto 32 hardware queues only with this setting (CUDA's
    # default is 8), read when the CUDA context is made. Phases 1-3 keep
    # CUDA's default: run alone, phase 4 sets it here, before torch touches
    # the card; after other phases, it runs in a process of its own.
    gemm_apart = 4 in phases and len(phases) > 1
    if phases == {4}:
        os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", GEMM_MAX_CONNECTIONS)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    rows = []
    fleet = front = trained = dry = examples = None
    try:
        if not args.rows_out:  # a child run of phase 4 reuses the parent's build and report
            build_report(_build)
        if 1 in phases:
            log("phase 1: kernels against their plain versions on the card")
            with phase_wall(1):
                phase_kernels(ops, dev, args.seed)
        if 2 in phases:
            log("phase 2: stablelm-1.6b at full width, kernel path vs plain path")
            with phase_wall(2):
                phase_model(ops, dev, args.seed)
        if 3 in phases:
            log(f"phase 3: serving {REQUESTS} requests for {R_TENANTS} stablelm-1.6b tenants")
            with phase_wall(3):
                cfg, launches, per_mode, prompt_lens = phase_serving(
                    dev, args.seed, ops, "stablelm-1.6b", args.profile)
                log("kernels at the serving path's shapes")
                rows += main_path_kernel_rows(ops, dev, args.seed, cfg, prompt_lens, launches,
                                              per_mode)
        if gemm_apart:
            torch.cuda.empty_cache()
            with phase_wall(4):
                rows += phase_gemm_apart(args.seed, args.profile)
        elif 4 in phases:
            log("phase 4: the GEMM super-kernel path (K1, K2, Table 1, the scheduler)")
            with phase_wall(4):
                rows += phase_gemm(ops, dev, args.seed, args.profile)
        if 5 in phases:
            torch.cuda.empty_cache()
            log(f"phase 5: the RWKV-6 serving path ({RWKV}, K5)")
            with phase_wall(5):
                rows += phase_rwkv(ops, dev, args.seed, args.profile)
        if 6 in phases:
            torch.cuda.empty_cache()
            log(f"phase 6: {PALI} at full width (K3, K4 at D=256), then musicgen-large, "
                "qwen2-7b, granite-3-8b and gemma3-27b")
            with phase_wall(6):
                rows += phase_pali(ops, dev, args.seed, args.profile)
        if 7 in phases:
            torch.cuda.empty_cache()
            log(f"phase 7: {MOE_ARCH} and {ZAMBA} served at full width, {LLAMA4} at "
                f"{LLAMA4_LAYERS} layers")
            with phase_wall(7):
                rows += phase_new_archs(ops, dev, args.seed, args.profile)
        if 8 in phases:
            torch.cuda.empty_cache()
            log(f"phase 8: a live fleet of {FLEET_REPLICAS} {FLEET_ARCH} engines ({R_TENANTS} "
                "tenants each) on the wall clock")
            with phase_wall(8):
                fleet_rows, fleet = phase_fleet(ops, dev, args.seed)
                rows += fleet_rows
        if 9 in phases:
            torch.cuda.empty_cache()
            log("phase 9: the front door (python -m repro_torch, LiveRun, the HTTP server)")
            with phase_wall(9):
                front_rows, front = phase_front_door(ops, dev, args.seed)
                rows += front_rows
        if 10 in phases:
            torch.cuda.empty_cache()
            log("phase 10: training (K4 and K5 backward kernels, forward_train, train())")
            with phase_wall(10):
                train_rows, trained = phase_train(ops, dev, args.seed, args.profile)
                rows += train_rows
        if 11 in phases:
            torch.cuda.empty_cache()
            log("phase 11: build_step's programs on the card (train, prefill, decode, merged "
                "decode), the float32 equivalences, the dry run")
            with phase_wall(11):
                dry, p11_launches = phase_dryrun_steps(ops, dev, args.seed)
            for name, by_variant in p11_launches.items():
                row = next((r for r in rows if r["name"] == name), None)
                if row is not None:
                    row["phase11_launches_by_variant"] = by_variant
                    row["phase11_max_abs_err"] = dry["kernel_max_abs_err"].get(name)
        if 12 in phases:
            torch.cuda.empty_cache()
            log("phase 12: the example scripts (train_small, multi_tenant_serving, "
                "spacetime_ablation on the card; quickstart, policy_sweep, fleet_routing)")
            with phase_wall(12):
                examples = phase_examples(ops, dev, args.seed)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if args.rows_out:
        Path(args.rows_out).write_text(json.dumps(rows))
        return 0
    if fleet is not None:
        log(json.dumps({"fleet": fleet}))
    if front is not None:
        log(json.dumps({"front_door": front}))
    if trained is not None:
        log(json.dumps({"train": trained}))
    if TRAIN_GRAPH_REPORT:
        log(json.dumps({"train_graphs": TRAIN_GRAPH_REPORT}))
    if ADAMW_REPORT:
        log(json.dumps({"adamw": ADAMW_REPORT}))
    if dry is not None:
        log(json.dumps({"dryrun_steps": dry}))
    if examples is not None:
        log(json.dumps({"examples": examples}))
    if GRAPH_REPORT:
        log(json.dumps({"graphs": GRAPH_REPORT}))
    if PREFILL_REPORT:
        log(json.dumps({"prefills": PREFILL_REPORT}))
    if K3_SURVEY:
        log(json.dumps({"k3_rule": K3_SURVEY}))
    if rows:
        log(json.dumps({"kernels": rows}))
    log(gpu_identity())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
