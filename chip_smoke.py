#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100
for the numbers in PERF.md).  It imports ``repro_torch`` from ``src/`` and
nothing of JAX.  Phases, each of which fails loudly:

1. the card's name and power limit; build every CUDA kernel of the main
   path from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
   at once) and print the build seconds and ptxas' register and spill
   report (the bf16 attention kernel, every ssd_scan kernel and every
   mix_tree kernel must not spill); the launch floor, an empty kernel
   timed as every kernel is, on a ``launch_floor`` line of its own;
2. every kernel against its plain PyTorch version on the card, at the main
   path's shapes and one larger shape: max abs error against the stated
   tolerance, kernel / plain / library time (CUDA events) and the bound.
   The host plane's ``stc_reduce`` / ``stc_apply`` run at every fcn leaf
   size, 2^24 and 155,582,464 (qwen3_0_6b's tied embedding) on tie-free
   data: count == k, the exact-k plain STC's support, μ within 1e-5
   relative of the plain version's and of a float64 sum, apply bit-exact.
   ``stc_fused`` (one cluster launch per leaf of n ≤ N_FUSED, τ selected
   on the card) runs at every fcn leaf size, 16383, an unaligned view,
   50152 and N_FUSED: τ bit-equal to ``stc_threshold``'s, the plain count,
   ``out`` bit-equal to ``stc_apply_ref`` at ``stc_mu_ref``'s μ, the
   exact-k support, μ within 1e-5 of a float64 mean, the same bits on two
   calls; ``ms`` beside ``chain_ms``, the chain it replaces.
   ``stc_rows_fused`` (the fleet plane's masked per-row STC of a leaf of
   rows of n ≤ N_FUSED in one launch, each row's τ selected on the card)
   runs at every (C, n) of the driven STC runs, (8, 65536), (8, N_FUSED),
   (8, 16383), an unaligned (8, 16384) view, (1024, 8192) and
   (1024, 16384), every other row masked, held row by row: τ_c bit-equal
   to ``stc_rows_threshold``'s, the plain count, ``out`` bit-equal to
   ``stc_rows_apply_ref`` at the kernel's (τ, sum, count), the exact-k
   support, μ_c within 1e-5 of a float64 mean, unmasked rows bit-equal to
   x, the same bits on two calls; ``ms`` beside ``chain_ms``.
   ``stc_rows_reduce`` / ``stc_rows_apply`` (the chain for rows past
   N_FUSED) also run at (8, 262144).  ``quant_roundtrip`` (the int8 hop of
   one PermuteOp in one launch, leaves read in place) runs at the leaf
   table of every int8 run driven here, one 65536-block leaf, F = 10 and
   26121, unaligned views, under a permuting src_of_dst, on rows with
   all-zero, tied, ±0 / subnormal and clipping blocks: decoded leaves,
   codes and scales bit-equal to ``quant_roundtrip_ref``, the same bits
   twice, ``ms`` beside ``chain_ms`` (the chain it replaces); a block
   decoded with its neighbour's scale (a planted fault) must fail the bit
   check.  ``bid_fused`` (one bid round of the device planner in one
   launch: the candidate IID distances, their subtraction from the models'
   own and the learning-value factor) runs at every bid shape of the
   driven runs and checks, at (256, 256, 10) (the largest population a
   FedDif run bids over: fig7_scaling and fleet_scaling run feddif only up
   to N = 256), at (1024, 1024, 10) (a scaling row no run bids at) and at
   (33, 70, 64) (the runtime-C instance), with and without a value: bit-equal to the chain
   it replaces (``dol_bid_scores`` → the subtraction →
   ``bid_value_fuse``) on two calls, within 2e-5 of ``bid_fused_ref``
   (1e-7 near uniform), ``ms`` beside ``chain_ms``; fed the neighbouring
   client's value or the next model's IID distance (two planted faults) it
   must fail the bit check.  All STC paths (``stc_rows``,
   ``stc_rows_fused``, ``stc_reduce`` / ``stc_apply``, ``stc_fused``)
   also run rows where magnitudes tie at τ, including τ = 0: exactly the
   k entries ``lax.top_k`` keeps, bit-equal to their plain versions, the
   exact-k μ; ``stc_fused`` and ``stc_rows_fused`` run with k − 1 (a
   planted fault) must fail the exact-k support check.  ``mix_tree``
   (Eq. 10/11 over a client-stacked tree in one launch, the leaves read in
   place) runs at the Eq.-11 row of every fleet tree the runs aggregate
   (fcn and cnn at their clients, the lm adapter, the lm model), a fcn
   MixOp (G = C = 8), both with ``w`` on the card too, the fcn fleet at
   C = 1024, a ragged tree (C = 37, G = 11), 150 leaves and a tree with a
   non-contiguous and a bf16 leaf: output leaves bit-equal to the old
   ravel → ``mix_aggregate`` → unravel chain on two calls, within
   1e-5·(1 + max|plain|) of the plain version, ``ms`` beside
   ``chain_ms`` and ``w @ x``; one leaf written from its neighbour's
   weights row (a planted fault) must fail the bit check;
3. the main path — ``run_experiment`` on the fleet plane: the quickstart
   configuration (fcn, α=0.3, 6000 samples, N=M=8, 8 rounds) for fedavg,
   feddif with the host planner and feddif with the device planner
   (``planner="jax"``) and learning-value bids (``uncertainty_weight=0.5``),
   2 rounds each of feddif_stc and stc, 2 rounds of feddif on cnn.  Launch
   counters are zeroed right before each run and read right after; every
   run must launch ``mix_tree`` once per round (Eq. 11; these strategies
   run no MixOp) and ``mix_aggregate`` never, the STC runs
   ``stc_rows_fused`` once per
   compressed leaf (and ``stc_rows_reduce`` / ``stc_rows_apply`` never),
   the device-planner run ``bid_fused`` once per bid round (its
   planner's ``loop_iterations``: each diffusion round and each plan's
   halting round) and ``dol_bid_scores`` / ``bid_value_fuse`` never; params must be finite and both FedDif runs'
   peak accuracy must beat FedAvg's.  The two FedDif runs print the
   planner's seconds per communication round and auction iterations.
   Then the adapter hop plane: FedDif on the LoRA ``lm`` task at the
   ``lm_hops`` bench's full cell (α=0.5, 32 tokens per document, 4096
   documents, N=M=8, 6 rounds) in its three arms — adapter hops packed to
   int8, adapter hops in fp32, the full model in fp32 — and feddif/fcn
   with int8 hops at the quickstart configuration.  Every int8 run must
   launch ``quant_roundtrip`` exactly once per diffusion round (one per
   PermuteOp) and ``quant_pack`` / ``quant_unpack`` never, every run's
   ledger must decompose into ``uplinks·(fp32 payload) + D2D
   hops·(hop payload)``, the full-f32 hop must be ≥ 50x the int8 adapter
   hop, the fp32 adapter arm's eval loss must fall, and the int8 arm's
   must stay within LM_LOSS_GAP of it in every round — a gate that the int8
   arm rerun with every block decoded at twice its scale (a planted
   control) must fail.
   Then the host plane (``executor="host"``, the reference's default): the
   quickstart's fedavg and feddif (FedDif's peak must beat FedAvg's), two
   rounds each of stc, feddif_stc, fedswap, d2d_random_walk, fedprox and
   feddif_prox, gossip (2 rounds) and tthf (4 rounds) on both planes, and
   feddif with int8 hops.  On the host plane ``stc_fused`` must launch
   once per compressed leaf (per hop or uplink the ledger counts; every
   fcn leaf fits N_FUSED) and ``stc_reduce`` / ``stc_apply``,
   ``mix_tree``, ``mix_aggregate`` and ``stc_rows_*`` never; on the fleet
   plane ``mix_tree`` once per MixOp plus once per round and
   ``mix_aggregate`` never; int8 hops launch
   ``quant_roundtrip`` once per PermuteOp (all 8 slots and the move).
   Then the sweep layer (``sweep_path``, artifacts under ``build/sweeps``),
   all on the fleet plane: ``fig3_alpha``'s full grid (α ∈ {0.1, 0.2, 0.5,
   1, 100} × fedavg / feddif, N = M = 10, 8000 samples, 20 rounds, seed 0,
   ``planner="jax"``), its 100 FedDif rounds first planned by
   ``prepopulate_plan_cache`` (``bid_fused`` once per bid round, the
   planner's summed ``loop_iterations``, and no other kernel), then
   ``run_sweep`` on that cache: every cell replays (plan-cache misses 0,
   ``bid_fused`` 0) and launches ``mix_tree`` once per round, every
   param finite, FedDif's peak above FedAvg's at α = 0.1; the smoke grids
   of ``fig4_epsilon``, ``fig5_gamma_min``, ``fig6_tasks``,
   ``table2_strategies`` and ``fig_lm`` (artifacts with no failed cell,
   ``mix_tree`` once per round, ``fig_lm`` ``quant_roundtrip`` once per
   PermuteOp and ``quant_pack`` / ``quant_unpack`` never); ``fig5_gamma_min``
   with the device planner pre-planned by ``run_sweep`` and cell by cell
   through ``run_cell`` with fresh caches: artifacts equal after
   ``strip_volatile``; ``fig4_epsilon`` on the card and on the CPU: equal
   ``comm`` and diffusion rounds, accuracy within 0.05, final losses
   within atol 2e-4, rtol 2e-3; and ``fig7_scaling``, ``fig_async`` and
   ``fig_scenarios`` refused naming A11 with no cell run.  One line per
   cell (label, peak accuracy, sub-frames, Eq.-15 bandwidth, seconds,
   plan-cache hits and misses, launches); the sweeps' launches count as
   main-path launches.
   Then, apart from those runs and with its launches counted apart, the
   host plane's STC entry
   point on leaves on both sides of N_FUSED must route each leaf of
   n ≤ N_FUSED to ``stc_fused`` and each larger one to the
   ``stc_reduce`` / ``stc_apply`` chain, and the fleet plane's
   (``ops.stc_topk``) each (8, n) leaf of n ≤ N_FUSED to
   ``stc_rows_fused`` and a larger one to the ``stc_rows_reduce`` /
   ``stc_rows_apply`` chain, and the standalone int8 wire
   (``adapters.pack_rows`` / ``unpack_rows``) must launch ``quant_pack``
   and ``quant_unpack`` once each, and the standalone bid ops
   (``ops.dol_bid_scores`` / ``ops.bid_value_fuse``) their kernels once
   each, and the flat ``ops.mix_aggregate`` its kernel once;
4. a small feddif_stc run on each plane and a small lm int8 run on the
   card against the
   same runs on the CPU (plain versions) from one init: equal ledgers,
   params within the fleet plane's tolerance (the card runs launching
   ``stc_rows_fused`` or ``stc_fused`` once per compressed leaf); the host
   plane against the fleet plane on the card (feddif/fcn, N=M=8, 2 rounds,
   one init: equal ledgers, params within atol 2e-4, rtol 2e-3); the lm
   adapter_int8 arm and host-plane feddif/fcn with int8 hops, as shipped
   and with the hop put back to the chain ``quant_roundtrip`` replaced:
   equal ledgers, bit-equal final params; the device planner as shipped
   (``bid_fused``) and with the bid round put back to the chain it
   replaced, on the quickstart device-planner run and every plan of the
   planner checks below: the same rounds, hops and ``scheduled``,
   bit-equal ``decrement``, ``weight`` and ``efficiency`` (and, in the
   run, equal ledgers and bit-equal final params); fleet-plane FedDif,
   gossip, tthf and the lm full fp32 arm as shipped and with Eq. 10/11
   put back to the chain ``mix_tree`` replaced: equal ledgers, bit-equal
   final params; then the device planner
   on the card (with its
   kernels) against the host planner on the CPU, on the N=M=C=10
   default-config inputs (seeds 0-2) and the 16 plans of the N=M=20
   ``planner_speedup`` cells: exact hop-list agreement is printed, and the
   plans must be equivalent (same rounds, same hop count, total Eq.-17
   decrement within 1e-6 relative);
5. a measurement, not a check: one FedDif round with each planner, one on
   the host plane, one gossip round on the fleet plane, one feddif_stc
   round on each plane, one FedDif round
   with int8 hops on each plane, and one of the lm int8 arm, under
   ``torch.profiler``
   (device busy time,
   idle share, kernel count, top kernels);
6. the LM zoo's prefill forward at the published widths: flash_attention,
   ssm_scan and ssd_scan against their plain versions on the card (at the
   zoo's shapes and a few more: bf16 and fp32, a window, Sq < Sk, D = 80,
   smollm_360m's (2, 4096, 15, 64), a 1000-key window at S = 4096, a
   ragged chunk, a ragged channel block; ssd_scan also at near-unit decay
   and two odd shapes, P 72 / N 128 and P 18 / N 9 / chunk 48), with
   attention held per element against its row's scale and normwise, and
   a planted fault (one kv tile dropped for the rows past S/2) that the
   attention bars must reject; every ssd_scan row must give the same bits
   on two calls, and at near-unit decay a planted fault (the carried state
   applied one chunk late) must fail its bar; then ``make_prefill_step``
   of qwen3_0_6b (28 layers, B = 2,
   S = 4096), zamba2_2_7b (54 mamba2 + 9 shared attention, B = 1,
   S = 4096) and falcon_mamba_7b (64 mamba1 layers, B = 1, S = 4096) from
   random params drawn on the card, one after another, under
   ``torch.inference_mode()``: loss finite, prefill tokens/s, peak memory
   (the garbage collector run before each reset),
   and each kernel launched exactly once per layer that runs it; a 2-layer
   cut of each config at B = 1, S = 256 on the card against the CPU (plain
   versions) from one init, in bf16 and in fp32 compute, loss and final
   hidden states within bars set from readings, and the same cut with the
   family's kernel output one step late (and in fp32 also with its
   sequence halves run apart, a kernel that loses its context at S/2),
   which those bars must reject; one qwen3 and one zamba2 prefill under
   ``torch.profiler``; zamba2_2_7b at full width and full depth (B = 1,
   S = 4096) from one init through the ssd_scan kernels and through its
   plain version, in fp32 compute (losses within ZOO_BARS' fp32 loss_abs)
   and in bf16 (both losses printed).

Then one ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
TF32_FLOPS_PER_S = 495e12        # H100 SXM dense TF32 tensor-core peak
KERNEL_SOURCE = "src/repro_torch/kernels/csrc"

# Every run_experiment call this script makes on the card, as (strategy,
# task, rounds, clients = models); phase 2 checks each kernel at the shapes
# these runs give it (see path_shapes).
WARMUP_RUNS = (("feddif_stc", "fcn", 1, 4), ("feddif_stc", "cnn", 1, 4))
MAIN_RUNS = (("fedavg", "fcn", 8, 8), ("feddif", "fcn", 8, 8),
             ("feddif_stc", "fcn", 2, 8), ("stc", "fcn", 2, 8),
             ("feddif", "cnn", 2, 8))
CARD_VS_CPU_RUN = ("feddif_stc", "fcn", 2, 5)
# The device-planner run of phase 3 (planner="jax", uncertainty_weight=0.5),
# and the planner checks of phase 4: (clients = models, classes, max
# diffusion rounds, [(data seed, channel seed), ...]).
DEVICE_PLANNER_RUN = ("feddif", "fcn", 8, 8)
VALUE_WEIGHT = 0.5
NUM_CLASSES = 10
PLANNER_CASES = (
    ("default_config", 10, None, [(s, s) for s in range(3)]),
    ("planner_speedup", 20, 24, [(i, t) for i in range(8) for t in range(2)]),
)
# The adapter hop plane: the lm_hops bench's full cell (benchmarks/run.py)
# and its arms, arm -> (adapter_hops, hop_quant); feddif/fcn with int8 hops
# at the quickstart configuration; phase 4's small lm int8 cell (the
# reference's tests/test_adapter_hops.py cell).
LM_DATA = dict(task="lm", alpha=0.5, dim=32, num_samples=4096)
LM_FL = dict(executor="fleet", strategy="feddif", rounds=6, num_clients=8,
             num_models=8, seed=0, topology_seed=0, max_diffusion_rounds=4)
LM_ARMS = {"adapter_int8": (True, "int8"), "adapter_f32": (True, "none"),
           "full_f32": (False, "none")}
FCN_INT8_RUN = ("feddif", "fcn", 8, 8)
LM_SMALL_DATA = dict(task="lm", alpha=0.5, dim=16, num_samples=640)
LM_SMALL_FL = dict(executor="fleet", strategy="feddif", rounds=2,
                   num_clients=4, num_models=4, seed=0, topology_seed=1,
                   max_diffusion_rounds=3, hop_quant="int8")
# The lm_hops gate on what the adapter arms move: the largest per-round gap
# between the int8 arm's eval loss and the fp32 adapter arm's.  Set from
# readings on an H100 (PERF.md §6): the gap grew to 2.50e-3 by round
# 6 (the fp32 arm's loss falls by 2.1e-3 over the six rounds, the int8
# arm's by 4.4e-5: the int8 hop rounds the LoRA B factors to 0, PERF.md
# §7), the scales ×2 control's reached 0.188.  The bar is 4x the first.
LM_LOSS_GAP = 0.01
HOP_RATIO_GATE = 50.0        # full-f32 hop / int8 adapter hop
# Phase 6, the LM zoo's prefill: (arch, batch, sequence, launches of each
# kernel per forward).  4096 is SHAPES["train_4k"]'s sequence.  The batch
# is small so that the plain versions in the kernel checks, at the same
# shapes, stay small (flash_attention_ref holds fp32 (B, H, S, S) scores).
ZOO_RUNS = (("qwen3_0_6b", 2, 4096, {"flash_attention": 28}),
            ("zamba2_2_7b", 1, 4096, {"ssd_scan_state": 54,
                                      "ssd_scan_pass": 54, "ssd_scan": 54,
                                      "flash_attention": 9}),
            ("falcon_mamba_7b", 1, 4096, {"ssm_scan": 64}))
# The card-vs-CPU cuts: 2 layers of each full-width config (zamba2's with
# attn_period 2, so the cut keeps the shared attention block), B=1, S=256.
ZOO_CUTS = (("qwen3_0_6b", {}), ("zamba2_2_7b", {"attn_period": 2}),
            ("falcon_mamba_7b", {}))
ZOO_CUT_SEQ = 256
# Card against CPU on the cuts, by compute dtype: the prefill loss within
# loss_abs, the final hidden states within hidden_rel_l2 normwise
# (‖card − cpu‖₂ / ‖cpu‖₂) and hidden_max_abs at any element.  Set from
# readings on an H100 (PERF.md §6).  bf16: losses within 8.1e-4,
# hidden states within 9.8e-3 normwise and 0.0625 at |h| ≈ 4.5 (two bf16
# ulps there).  fp32: losses within 3.4e-5, hidden states within 4.4e-6
# normwise and 7.1e-5 at an element; the controls' smallest normwise
# error there was 3.7e-3.  CONTROLS_REJECTED names the controls each
# dtype's bars must reject.
ZOO_BARS = {"bfloat16": {"loss_abs": 3e-3, "hidden_rel_l2": 2e-2,
                         "hidden_max_abs": 0.1},
            "float32": {"loss_abs": 1e-4, "hidden_rel_l2": 1e-4,
                        "hidden_max_abs": 1e-3}}
CONTROLS_REJECTED = {"bfloat16": ("one_step_late",),
                     "float32": ("one_step_late", "halves_apart")}
# The op each cut's control runs wrongly (its two sequence halves apart).
ZOO_CONTROL_OP = {"qwen3_0_6b": "flash_attention", "zamba2_2_7b": "ssd_scan",
                  "falcon_mamba_7b": "ssm_scan"}
# ssd_scan's rows in phase 6a, (B, S, H, P, N, chunk) and inputs: zamba2's
# prefill and its cut, S not a multiple of the chunk, P not a multiple of
# 16 at N 16 and chunk 64, zamba2's prefill at near-unit decay (a ≈ −1e-3,
# the state grows over 32 chunks; the planted fault runs here), and two odd
# shapes.  "model" inputs are shaped as the model's streams.  The bar is
# SSD_BAR·(1 + max|plain|).
SSD_ROWS = (((1, 4096, 80, 64, 64, 128), "model"),
            ((1, 256, 80, 64, 64, 128), "model"),
            ((1, 1000, 8, 64, 64, 128), "model"),
            ((2, 300, 3, 20, 16, 64), "model"),
            ((1, 4096, 80, 64, 64, 128), "near_unit"),
            ((1, 300, 4, 72, 128, 128), "model"),
            ((1, 200, 3, 18, 9, 48), "model"))
SSD_BAR = 5e-5
# The full-depth check of phase 6d: zamba2_2_7b, B=1, S=4096, and the bf16
# prefill loss of record for this init (through the ssd_scan kernel that
# ran its products as fp32 FMAs; PERF.md §5), beside which the run's bf16
# losses are printed.
FULL_DEPTH = ("zamba2_2_7b", 1, 4096)
FULL_DEPTH_BF16_LOSS_OF_RECORD = 10.9261
# flash_attention's bars by input type: (rel, rel_row, rel_l2).  An element
# passes when |out − plain| ≤ rel·|plain| + rel_row·rms(its row of D
# plain values), the whole output when ‖out − plain‖₂ ≤ rel_l2·‖plain‖₂.
# bf16: rel is one bf16 ulp at worst (kernel and plain both round an fp32
# result to bf16); the kernel also rounds P to bf16 before P·V (unit
# roundoff 2⁻⁸ per weight), an error of std ≈ 2⁻⁸/√3·rms(row) whose
# maximum over 10⁷ elements is ≈ 0.012·rms(row), under rel_row = 2⁻⁵.
# fp32: the same softmax summed in another order.
ATTN_BARS = {"bfloat16": (2.0 ** -7, 2.0 ** -5, 1e-2),
             "float32": (2e-5, 4e-5, 1e-5)}
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
# The host plane (phase 3b): FLConfig.stc_sparsity's default, which every
# STC run here uses; the quickstart and the two-round runs of every
# strategy on the host plane; gossip and TT-HF also on the fleet plane
# (TT-HF for 4 rounds, so its global MixOp runs once); the host-vs-fleet
# parity run.
STC_SPARSITY = 0.01
HOST_QUICKSTART = (("fedavg", 8), ("feddif", 8))
HOST_TWO_ROUND = ("stc", "feddif_stc", "fedswap", "d2d_random_walk",
                  "fedprox", "feddif_prox")
MIX_RUNS = (("gossip", 2), ("tthf", 4))
HOST_VS_FLEET_RUN = ("feddif", "fcn", 2, 8)
# The sweep phase (3c): fig3_alpha's full grid (5 α × fedavg / feddif,
# N = M = 10, 8000 samples, 20 rounds) pre-planned with the device planner,
# the smoke grids of the other paper sweeps, all on the fleet plane; the
# sweeps the port refuses (ROADMAP A11).  Artifacts go under build/.
SWEEP_DIR = ROOT / "build" / "sweeps"
SWEEP_SMOKE = ("fig4_epsilon", "fig5_gamma_min", "fig6_tasks",
               "table2_strategies", "fig_lm")
SWEEP_REFUSED = ("fig7_scaling", "fig_async", "fig_scenarios")


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _ptxas_spills(log: str) -> list[tuple[str, int, int]]:
    """(entry, spill store bytes, spill load bytes) of each kernel entry in
    one library's ptxas report."""
    out, entry = [], None
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line and entry:
            stores = int(line.split("bytes spill stores")[0].split(",")[-1])
            loads = int(line.split("bytes spill loads")[0].split(",")[-1])
            out.append((entry, stores, loads))
    return out


def _check_wgmma_spills(log: str | None) -> None:
    """The bf16 attention kernel holds two 64×128 fp32 tiles and P per
    thread on setmaxnreg's 240-register budget: ptxas must report no spill
    for any of its instances (None: built before this run, no report)."""
    if log is None:
        print(json.dumps({"check": "flash_attention_wgmma_kernel spills",
                          "ok": None, "note": "built before this run"}))
        return
    spills = [st for e, st, _ in _ptxas_spills(log) if "wgmma_kernel" in e]
    ok = len(spills) == 3 and not any(spills)
    print(json.dumps({"check": "flash_attention_wgmma_kernel spills",
                      "spill_store_bytes": spills, "ok": ok}))
    if not ok:
        _fail(f"flash_attention_wgmma_kernel: ptxas spill bytes {spills}")


def _check_ssd_spills(log: str | None) -> None:
    """Every ssd_scan kernel (the state kernel at 2 and 4 n-tiles per unit,
    the pass, the scan kernel at one and two units per warp) must build
    without spills."""
    if log is None:
        print(json.dumps({"check": "ssd_scan spills", "ok": None,
                          "note": "built before this run"}))
        return
    spills = {}
    for entry, stores, loads in _ptxas_spills(log):
        name = next((k for k in ("ssd_state_kernel", "ssd_pass_kernel",
                                 "ssd_scan_kernel") if k in entry), entry)
        if "ILi" in entry:
            name += "<" + entry.split("ILi")[1].split("E")[0] + ">"
        spills[name] = [stores, loads]
    ok = len(spills) == 5 and not any(any(v) for v in spills.values())
    print(json.dumps({"check": "ssd_scan spills", "spill_bytes": spills,
                      "ok": ok}))
    if not ok:
        _fail(f"ssd_scan: ptxas spill bytes {spills}")


def _check_mix_tree_spills(log: str | None) -> None:
    """All eight ``mix_tree_kernel`` instances (G tile 1 or 8, C ≤ 8 or
    not, ``w`` in the parameters or on the card) must build without
    spills."""
    if log is None:
        print(json.dumps({"check": "mix_tree_kernel spills", "ok": None,
                          "note": "built before this run"}))
        return
    spills = [[st, ld] for e, st, ld in _ptxas_spills(log)
              if "mix_tree_kernel" in e]
    ok = len(spills) == 8 and not any(any(v) for v in spills)
    print(json.dumps({"check": "mix_tree_kernel spills",
                      "spill_bytes": spills, "ok": ok}))
    if not ok:
        _fail(f"mix_tree_kernel: ptxas spill bytes {spills}")


def _time_ms(torch, fn, iters: int = 200, warmup: int = 10) -> float:
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


def _device_ms(torch, fn, inner: int = 20, reps: int = 10):
    """Device time per call: ``inner`` calls captured in one CUDA graph and
    replayed, so the host's per-call cost (Python, checks, launch) drops
    out.  Returns ``(ms, None)``, or ``(None, error)`` if capture fails —
    a timing that could not be taken, never a correctness verdict."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(inner):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (reps * inner), None
    except Exception as exc:            # noqa: BLE001 — reported, not hidden
        return None, f"{type(exc).__name__}: {exc}"


def _timings(torch, kernel, plain, library=None, *, inner: int = 20,
             reps: int = 10, iters: int = 200) -> dict:
    """Device ms (CUDA graph of ``inner`` calls, replayed ``reps`` times)
    of the kernel, its plain version and the library call, plus
    host-inclusive ms per wrapper call (CUDA events around ``iters``
    back-to-back calls).  Heavy shapes pass smaller counts."""
    out = {}
    for key, fn in (("ms", kernel), ("plain_ms", plain),
                    ("library_ms", library)):
        if fn is None:
            out[key] = None
            continue
        out[key], err = _device_ms(torch, fn, inner, reps)
        if err is not None:
            out[key.replace("ms", "device_error")] = err
    out["call_ms"] = _time_ms(torch, kernel, iters, min(10, iters))
    out["plain_call_ms"] = _time_ms(torch, plain, iters, min(10, iters))
    return out


def _bound(nbytes: float, flops: float,
           flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _payload_size(torch, port, task: str, adapter_hops: bool) -> int:
    """Values in the tree a run trains and hops: the LoRA adapter of the
    lm task under adapter hops, the whole model otherwise."""
    return sum(math.prod(s) for s in _payload_shapes(torch, port, task,
                                                      adapter_hops))


def path_shapes(torch, port) -> tuple[list, list, list, list]:
    """The shapes the driven runs give the kernels: ``mix_aggregate`` gets
    the (C, F, 1) Eq.-11 row of each run's fleet (F = the size of the tree
    it trains: the task's parameters, or the lm adapter), ``stc_rows`` a
    (C, n) block per leaf of size n in the STC runs, the device planner's
    bid kernels an (M, N, classes) problem per device-planner run and
    planner check, and the quant kernels a (C·⌈F/512⌉, 512) block per
    int8 run.  The fleet plane has one slot per client.  The quant list
    adds the whole lm model's block, (1208, 512), which int8 hops without
    the adapter view would pack."""
    from repro_torch.tree import tree_leaves
    from repro_torch.kernels.quant import QUANT_BLOCK
    mix, stc, quant = set(), set(), set()
    for strategy, task, _, clients in (WARMUP_RUNS + MAIN_RUNS
                                       + (CARD_VS_CPU_RUN,
                                          DEVICE_PLANNER_RUN)):
        init = port.build_task_model(task).init(torch.Generator())
        sizes = [x.numel() for x in tree_leaves(init)]
        mix.add((clients, sum(sizes), 1))
        if "stc" in strategy:
            stc.update((clients, n) for n in sizes)
    int8_runs = [("fcn", False, FCN_INT8_RUN[3]),
                 ("lm", True, LM_SMALL_FL["num_clients"]),
                 ("lm", False, LM_FL["num_clients"])]
    for adapter_hops, _ in LM_ARMS.values():
        f = _payload_size(torch, port, "lm", adapter_hops)
        mix.add((LM_FL["num_clients"], f, 1))
        int8_runs.append(("lm", adapter_hops, LM_FL["num_clients"]))
    for task, adapter_hops, clients in int8_runs:
        f = _payload_size(torch, port, task, adapter_hops)
        quant.add((clients * -(-f // QUANT_BLOCK), QUANT_BLOCK))
    bids = {(DEVICE_PLANNER_RUN[3],) * 2 + (NUM_CLASSES,)}
    bids.update((n, n, NUM_CLASSES) for _, n, _, _ in PLANNER_CASES)
    return sorted(mix), sorted(stc), sorted(bids), sorted(quant)


def _stc_tie_free(torch, gen, n: int):
    """n fp32 values with distinct magnitudes, randomly permuted, with random
    signs: the bit patterns from that of 1e-3 upward, so no magnitude ties
    at any threshold."""
    base = int(torch.tensor([1e-3]).view(torch.int32)[0])
    bits = base + torch.randperm(n, generator=gen, device="cuda").to(
        torch.int32)
    signs = torch.randint(0, 2, (n,), generator=gen, device="cuda")
    return bits.view(torch.float32) * (signs.float() * 2.0 - 1.0)


def check_stc_compress(torch, kref, port) -> list[dict]:
    """Phase 2, the host plane's whole-tensor STC: ``stc_reduce`` and
    ``stc_apply`` against their plain versions at every leaf size of the
    fcn model (the host-plane STC runs' shapes; the 10-element leaf gives
    k = 1), at 2^24 and at qwen3_0_6b's tied embedding (151936 × 1024).
    Tie-free data: the survivor count must be k exactly, the support that
    of the exact-k plain STC, μ within 1e-5 relative of the plain
    version's and of a float64 sum, and the apply bit for bit (same τ, sum
    and count in)."""
    from repro_torch.kernels import stc_compress as ks
    from repro_torch.tree import tree_leaves
    gen = torch.Generator(device="cuda").manual_seed(1)
    init = port.build_task_model("fcn").init(torch.Generator())
    sizes = sorted({x.numel() for x in tree_leaves(init)}, reverse=True)
    rows = []
    for n in sizes + [2 ** 24, 151936 * 1024]:
        big = n > 2 ** 20
        reps = dict(inner=4, reps=3, iters=5) if big else {}
        x = _stc_tie_free(torch, gen, n)
        k = max(1, int(n * STC_SPARSITY))
        thr = kref.stc_threshold(x, STC_SPARSITY)
        ssum, cnt, ties = ks.stc_reduce_cuda(x, thr)
        p_sum, p_cnt = kref.stc_reduce_ref(x, thr)
        a = x.abs()
        sum64 = float(a.double()[a >= thr].sum())
        del a
        torch.cuda.synchronize()
        mu = float(ssum[0]) / max(int(cnt[0]), 1)
        mu_plain = float(p_sum[0]) / max(int(p_cnt[0]), 1)
        rel = max(abs(mu - mu_plain) / mu_plain, abs(mu - sum64 / k) / mu)
        ok = int(cnt[0]) == int(p_cnt[0]) == k and rel <= 1e-5
        bound, by = _bound(4.0 * n + 12.0, 3.0 * n)
        # max_abs_err: the survivor sum against the plain version's; the
        # bar is on μ, relative (mu_rel_tol), and on the count, exact.
        row = {"name": "stc_reduce", "shape": [n], "k": k,
               "count": int(cnt[0]), "mu_rel_err": rel, "mu_rel_tol": 1e-5,
               "max_abs_err": abs(float(ssum[0]) - float(p_sum[0])),
               "ok": ok, **_timings(torch, lambda: ks.stc_reduce_cuda(x, thr),
                                    lambda: kref.stc_reduce_ref(x, thr),
                                    **reps),
               "bound_ms": bound, "bound_by": by}
        print(json.dumps(row))
        if not ok:
            _fail(f"stc_reduce [{n}]: count {int(cnt[0])} (k={k}), "
                  f"mu rel err {rel}")
        rows.append(row)

        out = ks.stc_apply_cuda(x, thr, ssum, cnt, ties, k)
        mu_t = kref.stc_mu_ref(ssum, cnt, thr, k)
        plain = kref.stc_apply_ref(x, thr, mu_t, k)
        exact_k = kref.stc_compress_ref(x, STC_SPARSITY)
        torch.cuda.synchronize()
        same = bool(torch.equal(out, plain))
        support = bool(torch.equal(out != 0, exact_k != 0))
        err = float((out - plain).abs().max())
        err_k = float((out - exact_k).abs().max())
        del exact_k
        bound, by = _bound(8.0 * n + 12.0, 3.0 * n)
        row = {"name": "stc_apply", "shape": [n], "max_abs_err": err,
               "tol": 0.0, "max_abs_err_vs_exact_k": err_k,
               "same_support_as_exact_k": support, "ok": same and support,
               **_timings(torch,
                          lambda: ks.stc_apply_cuda(x, thr, ssum, cnt, ties,
                                                    k),
                          lambda: kref.stc_apply_ref(x, thr, mu_t, k),
                          **reps),
               "bound_ms": bound, "bound_by": by}
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"stc_apply [{n}]: equal to the plain version {same}, "
                  f"same support as exact-k STC {support}")
        rows.append(row)
        del x, out, plain
        torch.cuda.empty_cache()
    rows += check_stc_fused(torch, kref, ks, gen, sizes)
    _stc_ties(torch, kref, ks, gen)
    return rows


def _stc_chain(kref, ks, x, k):
    """The per-leaf chain ``stc_fused`` replaces: τ by ``torch.topk``, then
    the ``stc_reduce`` and ``stc_apply`` kernels."""
    def chain():
        thr = kref.stc_threshold(x, STC_SPARSITY)
        ssum, cnt, ties = ks.stc_reduce_cuda(x, thr)
        return ks.stc_apply_cuda(x, thr, ssum, cnt, ties, k)
    return chain


def _stc_fused_verdict(torch, kref, x, k, got, mu64=None) -> dict:
    """The bars of one ``stc_fused`` call ``got = (out, thr, ssum, cnt)``:
    τ bit-equal to ``stc_threshold``'s, the count equal to the plain
    count, ``out`` bit-equal to ``stc_apply_ref`` at ``stc_mu_ref``'s μ
    from the kernel's (sum, count, τ), the support of the exact-k STC of
    record, and μ within 1e-5 relative of the exact-k μ in float64."""
    out, thr, ssum, cnt = got
    want_thr = torch.topk(x.abs(), k).values[k - 1:k]     # stc_threshold's
    p_sum, p_cnt = kref.stc_reduce_ref(x, thr)
    plain = kref.stc_apply_ref(x, thr, kref.stc_mu_ref(ssum, cnt, thr, k), k)
    exact_k = kref.stc_compress_ref(x, STC_SPARSITY)
    if mu64 is None:
        mu64 = float(torch.topk(x.abs().double(), k).values.mean())
    torch.cuda.synchronize()
    mu = float(out.abs().max())
    rel = abs(mu - mu64) / mu64 if mu64 else abs(mu)
    v = {"tau_bit_equal": bool(torch.equal(thr.view(torch.int32),
                                           want_thr.view(torch.int32))),
         "count": int(cnt[0]), "count_plain": int(p_cnt[0]),
         "out_bit_equal": bool(torch.equal(out.view(torch.int32),
                                           plain.view(torch.int32))),
         "same_support_as_exact_k": bool(torch.equal(out != 0,
                                                     exact_k != 0)),
         "sent": int((out != 0).sum()), "sent_exact_k":
             int((exact_k != 0).sum()),
         "mu_rel_err": rel, "mu_rel_tol": 1e-5,
         "max_abs_err": float((out - plain).abs().max())}
    v["ok"] = (v["tau_bit_equal"] and v["count"] == v["count_plain"]
               and v["out_bit_equal"] and v["same_support_as_exact_k"]
               and rel <= 1e-5)
    return v


def check_stc_fused(torch, kref, ks, gen, sizes) -> list[dict]:
    """Phase 2, ``stc_fused`` — the host plane's STC of a leaf of
    n ≤ N_FUSED in one launch — at every fcn leaf size, at 16383 (ragged),
    on an unaligned view (``flat[1:]`` of 16385), at 50152 (a ragged
    cluster of 4) and at N_FUSED (a cluster of 8), on tie-free data.  Each
    row must pass ``_stc_fused_verdict``'s bars and give the same bits on
    two calls.  Times: ``ms`` (the kernel, a CUDA graph of calls),
    ``chain_ms`` (the chain it replaces — ``stc_threshold``,
    ``stc_reduce_cuda``, ``stc_apply_cuda`` — in one graph at the same n),
    ``plain_ms`` (``stc_fused_ref``), ``call_ms`` (host-inclusive per
    wrapper call) and ``bound_ms`` (8n + 16 bytes)."""
    from repro_torch.kernels import build
    if build.load("stc_compress").repro_stc_fused_max_n() != ks.N_FUSED:
        _fail("stc_fused: the library's N_FUSED differs from the wrapper's")
    rows = []
    cases = [(n, "aligned") for n in sizes]
    cases += [(16383, "aligned"), (16384, "unaligned"), (50152, "aligned"),
              (ks.N_FUSED, "aligned")]
    for n, layout in cases:
        k = max(1, int(n * STC_SPARSITY))
        if layout == "unaligned":
            x = _stc_tie_free(torch, gen, n + 1)[1:]
            if x.data_ptr() % 16 == 0:
                _fail("stc_fused: the unaligned view is aligned")
        else:
            x = _stc_tie_free(torch, gen, n)
        got = ks.stc_fused_cuda(x, k)
        again = ks.stc_fused_cuda(x, k)
        torch.cuda.synchronize()
        repeat = all(bool(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32)))
                     for a, b in zip(got, again))
        v = _stc_fused_verdict(torch, kref, x, k, got)
        bound, by = _bound(8.0 * n + 16.0, 4.0 * n)
        times = _timings(torch, lambda: ks.stc_fused_cuda(x, k),
                         lambda: kref.stc_fused_ref(x, k))
        chain_ms, chain_err = _device_ms(torch, _stc_chain(kref, ks, x, k))
        row = {"name": "stc_fused", "shape": [n], "layout": layout, "k": k,
               "ctas": -(-n // 16384), **v, "same_bits_twice": repeat,
               "tol": 0.0, **times, "chain_ms": chain_ms,
               **({"chain_device_error": chain_err} if chain_err else {}),
               "bound_ms": bound, "bound_by": by}
        row["ok"] = bool(v["ok"] and repeat)
        if layout != "aligned":
            row["inputs"] = layout
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"stc_fused [{n}] {layout}: {json.dumps(row)}")
        rows.append(row)
    return rows


def _stc_ties(torch, kref, ks, gen) -> None:
    """The kernels where magnitudes tie at τ: a [16384] leaf with 50
    nonzeros (k = 163, so τ = 0 and every zero ties — μ = sum/count would
    be n/k times too small) and one with seven magnitudes tied at the k-th
    (four of them survive).  The kernels must send exactly k entries, the
    support of the exact-k STC of record (``lax.top_k``'s tie rule), equal
    their plain version (``stc_apply_ref`` at ``stc_mu_ref``'s μ) bit for
    bit, and hold μ within 1e-5 relative of the exact-k μ."""
    n = 16384
    k = max(1, int(n * STC_SPARSITY))
    zeros = torch.zeros(n, device="cuda")
    idx = torch.randperm(n, generator=gen, device="cuda")[:50]
    zeros[idx] = _stc_tie_free(torch, gen, 50)
    tied = _stc_tie_free(torch, gen, n)
    order = torch.argsort(tied.abs(), descending=True)
    at = order[k - 4:k + 3]
    tied[at] = tied[at].sign() * tied[order[k - 4]].abs()
    for case, x in (("tau_zero", zeros), ("tied_at_tau", tied)):
        thr = kref.stc_threshold(x, STC_SPARSITY)
        ssum, cnt, ties = ks.stc_reduce_cuda(x, thr)
        out = ks.stc_apply_cuda(x, thr, ssum, cnt, ties, k)
        plain = kref.stc_apply_ref(x, thr, kref.stc_mu_ref(ssum, cnt, thr, k),
                                   k)
        exact_k = kref.stc_compress_ref(x, STC_SPARSITY)
        torch.cuda.synchronize()
        mu = float(out.abs().max())
        mu_k = float(exact_k.abs().max())
        rel = abs(mu - mu_k) / mu_k
        sent, sent_k = int((out != 0).sum()), int((exact_k != 0).sum())
        same = bool(torch.equal(out, plain))
        support = bool(torch.equal(out != 0, exact_k != 0))
        extra = int(cnt[0]) - k
        ok = (same and support and sent == sent_k and rel <= 1e-5
              and (float(thr[0]) == 0.0 if case == "tau_zero"
                   else extra == 3 and sent == k))
        row = {"name": "stc_ties", "case": case, "shape": [n], "k": k,
               "tau": float(thr[0]), "count": int(cnt[0]), "sent": sent,
               "sent_exact_k": sent_k, "equal_to_plain": same,
               "same_support_as_exact_k": support, "mu": mu,
               "mu_exact_k": mu_k,
               "mu_sum_over_count": float(ssum[0]) / int(cnt[0]),
               "mu_rel_err": rel, "mu_rel_tol": 1e-5, "ok": bool(ok)}
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"stc ties ({case}): {json.dumps(row)}")

        mu64 = float(exact_k.abs().max().double())
        got = ks.stc_fused_cuda(x, k)
        v = _stc_fused_verdict(torch, kref, x, k, got, mu64)
        v["ok"] = bool(v["ok"] and v["sent"] == v["sent_exact_k"]
                       and (float(got[1][0]) == 0.0 if case == "tau_zero"
                            else v["count"] - k == 3 and v["sent"] == k))
        print(json.dumps({"name": "stc_fused_ties", "case": case,
                          "shape": [n], "k": k, "tau": float(got[1][0]),
                          **v}))
        if not v["ok"]:
            _fail(f"stc_fused ties ({case}): {json.dumps(v)}")
        # A planted fault: the kernel run with k - 1 keeps one entry too
        # few, which the exact-k support check must reject (at τ = 0 the
        # kept entries still cover every nonzero, so the control runs on
        # the tie at τ > 0 and on a tie-free leaf).
        if case == "tied_at_tau":
            for label, xc in (("tied_at_tau", x),
                              ("tie_free", _stc_tie_free(torch, gen, n))):
                c = _stc_fused_verdict(torch, kref, xc, k,
                                       ks.stc_fused_cuda(xc, k - 1))
                print(json.dumps({"name": "stc_fused_control",
                                  "control": "k_minus_1", "case": label,
                                  "shape": [n], "k": k,
                                  "same_support_as_exact_k":
                                      c["same_support_as_exact_k"],
                                  "sent": c["sent"],
                                  "sent_exact_k": c["sent_exact_k"],
                                  "must_fail": True,
                                  "failed": not c["ok"]}))
                if c["ok"] or c["same_support_as_exact_k"]:
                    _fail(f"stc_fused control k-1 ({label}) passed the "
                          "exact-k support check")


def _stc_rows_tie_free(torch, gen, c: int, n: int, offset: int = 0):
    """x (c, n) and ref (n,) on the card with no |Δ| ties in a row: each
    row's |Δ| is a permutation of n distinct multiples of 2^-e ≤ 1, and
    ref lies on the 2^-14 grid, so x = ref ± |Δ| and x − ref are exact in
    fp32.  ``offset`` elements before x in its buffer (1: a view whose base
    is not 16-byte aligned, still contiguous)."""
    step = 2.0 ** -max(1, (n - 1).bit_length())
    ref_row = torch.randint(-2 * 2 ** 14, 2 * 2 ** 14, (n,), generator=gen,
                            device="cuda") * 2.0 ** -14
    mags = (torch.rand((c, n), generator=gen, device="cuda")
            .argsort(dim=1) + 1).float() * step
    signs = torch.randint(0, 2, (c, n), generator=gen,
                          device="cuda").float() * 2.0 - 1.0
    x = ref_row[None, :] + signs * mags
    if offset:
        buf = torch.empty(c * n + offset, device="cuda")
        buf[offset:] = x.reshape(-1)
        x = buf[offset:].view(c, n)
    return x, ref_row


def _stc_rows_chain(kd, kref, x, ref_row, mask32, k):
    """The per-leaf chain ``stc_rows_fused`` replaces: τ_c by
    ``torch.topk`` (``stc_rows_threshold``), then the ``stc_rows_reduce``
    and ``stc_rows_apply`` kernels."""
    def chain():
        thr = kref.stc_rows_threshold(x, ref_row, STC_SPARSITY)
        ssum, cnt, ties = kd.stc_rows_reduce_cuda(x, ref_row, thr)
        return kd.stc_rows_apply_cuda(x, ref_row, thr, ssum, cnt, ties,
                                      mask32, k)
    return chain


def _stc_rows_fused_verdict(torch, kref, x, ref_row, mask32, k, got) -> dict:
    """The bars of one ``stc_rows_fused`` call ``got = (out, thr, ssum,
    cnt)``, held row by row: on masked rows τ_c bit-equal to
    ``stc_rows_threshold``'s, the count equal to the plain count at τ_c,
    μ_c (formed from the kernel's τ, sum and count as the kernel forms it)
    within 1e-5 relative of the top-k mean of |Δ| in float64; τ, sum and
    count 0 on unmasked rows; ``out`` bit-equal to ``stc_rows_apply_ref``
    at the kernel's own (τ, sum, count), unmasked rows bit-equal to x, and
    every row the support of the exact-k STC of record (``stc_rows_ref``,
    k = max(1, int(n·STC_SPARSITY)))."""
    out, thr, ssum, cnt = got
    c = x.shape[0]
    on = mask32 != 0
    d = (x - ref_row[None, :]).abs()
    want_thr = kref.stc_rows_threshold(x, ref_row, STC_SPARSITY)
    _, p_cnt = kref.stc_rows_reduce_ref(x, ref_row, thr)
    plain = kref.stc_rows_apply_ref(x, ref_row, thr, ssum, cnt, mask32, k)
    exact_k = kref.stc_rows_ref(x, ref_row, mask32, STC_SPARSITY)
    mu = kref.stc_mu_ref(ssum, cnt, thr, k)
    mu64 = torch.topk(d.double(), k, dim=1).values.mean(dim=1)
    rel = torch.where(mu64 > 0, (mu.double() - mu64).abs()
                      / mu64.clamp_min(1e-300), mu.double().abs())
    i32 = torch.int32
    tau_ok = torch.where(on, thr.view(i32) == want_thr.view(i32), thr == 0)
    cnt_ok = torch.where(on, cnt == p_cnt.to(i32), (cnt == 0) & (ssum == 0))
    out_ok = (out.view(i32) == plain.view(i32)).all(dim=1)
    sent = (out != ref_row[None, :]).sum(dim=1)
    sent_k = (exact_k != ref_row[None, :]).sum(dim=1)
    support_ok = ((out != ref_row[None, :])
                  == (exact_k != ref_row[None, :])).all(dim=1)
    pass_ok = (out.view(i32) == x.view(i32)).all(dim=1) | on
    mu_ok = (rel <= 1e-5) | ~on
    row_ok = tau_ok & cnt_ok & out_ok & support_ok & pass_ok & mu_ok
    torch.cuda.synchronize()
    few = c <= 8
    v = {"rows": c, "masked_rows": int(on.sum()),
         "tau_bit_equal": bool(tau_ok.all()),
         "count_equal": bool(cnt_ok.all()),
         "out_bit_equal": bool(out_ok.all()),
         "same_support_as_exact_k": bool(support_ok.all()),
         "unmasked_bit_equal": bool(pass_ok.all()),
         "sent": (sent.tolist() if few
                  else [int(sent[on].min()), int(sent[on].max())]),
         "sent_exact_k": (sent_k.tolist() if few
                          else [int(sent_k[on].min()), int(sent_k[on].max())]),
         "mu_rel_err": float(rel[on].max()), "mu_rel_tol": 1e-5,
         "max_abs_err": float((out - plain).abs().max()),
         "rows_failed": torch.nonzero(~row_ok).flatten()[:8].tolist()}
    v["ok"] = bool(row_ok.all())
    return v


def check_stc_rows_fused(torch, kd, kref, gen, shapes) -> list[dict]:
    """Phase 2, ``stc_rows_fused`` — the fleet plane's masked per-row STC
    of a leaf of rows of n ≤ N_FUSED in one launch — at every (C, n) of the
    driven STC runs (the (8, ·), (5, ·) and (4, ·) leaves), at (8, 65536)
    (a cluster of 4 per row), (8, N_FUSED) (a cluster of 8), (8, 16383)
    (ragged), an unaligned (8, 16384) view and (1024, 8192), (1024, 16384),
    on tie-free rows, every other row masked.  Each row must pass
    ``_stc_rows_fused_verdict``'s bars and the call must give the same
    bits twice.  Times: ``ms`` (the kernel, a CUDA graph of calls),
    ``chain_ms`` (the chain it replaces — ``stc_rows_threshold``,
    ``stc_rows_reduce_cuda``, ``stc_rows_apply_cuda`` — in one graph at the
    same shape), ``plain_ms`` (``stc_rows_fused_ref``), ``call_ms``
    (host-inclusive per wrapper call) and ``bound_ms`` (4·(2·C·n + n + 4·C)
    bytes)."""
    from repro_torch.kernels.stc_compress import N_FUSED
    rows = []
    cases = [(c, n, "aligned") for c, n in shapes]
    cases += [(8, 65536, "aligned"), (8, N_FUSED, "aligned"),
              (8, 16383, "aligned"), (8, 16384, "unaligned"),
              (1024, 8192, "aligned"), (1024, 16384, "aligned")]
    for c, n, layout in cases:
        k = max(1, int(n * STC_SPARSITY))
        x, ref_row = _stc_rows_tie_free(torch, gen, c, n,
                                        offset=int(layout == "unaligned"))
        if layout == "unaligned" and x.data_ptr() % 16 == 0:
            _fail("stc_rows_fused: the unaligned view is aligned")
        mask32 = (torch.arange(c, device="cuda") % 2 == 0).to(torch.int32)
        got = kd.stc_rows_fused_cuda(x, ref_row, mask32, k)
        again = kd.stc_rows_fused_cuda(x, ref_row, mask32, k)
        torch.cuda.synchronize()
        repeat = all(bool(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32)))
                     for a, b in zip(got, again))
        v = _stc_rows_fused_verdict(torch, kref, x, ref_row, mask32, k, got)
        bound, by = _bound(4.0 * (2 * c * n + n + 4 * c), 4.0 * c * n)
        times = _timings(torch,
                         lambda: kd.stc_rows_fused_cuda(x, ref_row, mask32,
                                                        k),
                         lambda: kref.stc_rows_fused_ref(x, ref_row, mask32,
                                                         k))
        chain_ms, chain_err = _device_ms(
            torch, _stc_rows_chain(kd, kref, x, ref_row, mask32, k))
        row = {"name": "stc_rows_fused", "shape": [c, n], "layout": layout,
               "k": k, "ctas": -(-n // 16384), **v,
               "same_bits_twice": repeat, "tol": 0.0, **times,
               "chain_ms": chain_ms,
               **({"chain_device_error": chain_err} if chain_err else {}),
               "bound_ms": bound, "bound_by": by}
        row["ok"] = bool(v["ok"] and repeat)
        if layout != "aligned":
            row["inputs"] = layout
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"stc_rows_fused ({c}, {n}) {layout}: {json.dumps(row)}")
        rows.append(row)
    return rows


def _stc_rows_ties(torch, kd, kref, gen) -> None:
    """``stc_rows`` (the reduce + apply chain, then ``stc_rows_fused``,
    with a k − 1 control that must fail) where |Δ| ties at τ_c, on the fcn
    fleet's largest leaf (8, 16384), k = 163: row 0 has 50 nonzero deltas
    (τ = 0, every zero ties: μ = sum/count would be n/k times too small),
    row 1 seven deltas tied at the k-th (four survive), row 2 quarter steps
    (thousands tie at τ = 1), the rest tie-free; rows 0-2 and 4 masked.
    Each masked row must send exactly the k entries of the exact-k STC of
    record (``lax.top_k``'s tie rule; fewer where τ = 0, whose kept zeros
    map to ref), the output must equal its plain version bit for bit, and μ
    must be within 1e-5 relative of the exact-k μ."""
    c, n = 8, 16384
    k = max(1, int(n * STC_SPARSITY))
    # Deltas on a 2^-14 grid in [-1, 1] and ref on the same grid, so that
    # x = ref + Δ and x − ref are exact in fp32 and the ties are the ones
    # planted.
    ref_row = torch.randint(-2 ** 14, 2 ** 14, (n,), generator=gen,
                            device="cuda") * 2.0 ** -14
    signs = torch.randint(0, 2, (c, n), generator=gen,
                          device="cuda").float() * 2.0 - 1.0
    delta = signs * (torch.rand((c, n), generator=gen, device="cuda")
                     .argsort(dim=1) + 1).float() * 2.0 ** -14
    delta[0] = torch.where(
        torch.rand(n, generator=gen, device="cuda").argsort() < 50,
        delta[0], 0.0)
    order = torch.argsort(delta[1].abs(), descending=True)
    at = order[k - 4:k + 3]
    delta[1, at] = delta[1, at].sign() * delta[1, order[k - 4]].abs()
    delta[2] = torch.randint(-4, 5, (n,), generator=gen,
                             device="cuda").float() / 4
    x = ref_row[None, :] + delta
    mask = torch.tensor([1, 1, 1, 0, 1, 0, 0, 0], device="cuda",
                        dtype=torch.bool)
    mask32 = mask.to(torch.int32)
    thr = kref.stc_rows_threshold(x, ref_row, STC_SPARSITY)
    ssum, cnt, ties = kd.stc_rows_reduce_cuda(x, ref_row, thr)
    out = kd.stc_rows_apply_cuda(x, ref_row, thr, ssum, cnt, ties, mask32, k)
    plain = kref.stc_rows_apply_ref(x, ref_row, thr, ssum, cnt, mask32, k)
    exact_k = kref.stc_rows_ref(x, ref_row, mask, STC_SPARSITY)
    torch.cuda.synchronize()
    d_out = (out - ref_row[None, :]).abs()
    d_k = (exact_k - ref_row[None, :]).abs()
    sent = (out != ref_row[None, :]).sum(dim=1).tolist()
    sent_k = (exact_k != ref_row[None, :]).sum(dim=1).tolist()
    mu = d_out.max(dim=1).values
    mu_k = d_k.max(dim=1).values
    rel = float(((mu - mu_k).abs() / mu_k.clamp_min(1e-30))[mask].max())
    same = bool(torch.equal(out, plain))
    support = bool(torch.equal(out != ref_row[None, :],
                               exact_k != ref_row[None, :]))
    ok = (same and support and sent == sent_k and rel <= 1e-5
          and float(thr[0]) == 0.0 and sent[1] == sent[2] == k
          and bool(torch.equal(out[~mask], x[~mask])))
    row = {"name": "stc_rows_ties", "shape": [c, n], "k": k,
           "tau": thr.tolist()[:3], "count": cnt.tolist()[:3],
           "sent": sent, "sent_exact_k": sent_k, "equal_to_plain": same,
           "same_support_as_exact_k": support,
           "mu_tau_zero": float(mu[0]), "mu_exact_k_tau_zero": float(mu_k[0]),
           "mu_sum_over_count_tau_zero": float(ssum[0] / cnt[0]),
           "mu_rel_err": rel, "mu_rel_tol": 1e-5, "ok": bool(ok)}
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"stc_rows ties: {json.dumps(row)}")

    # The same rows through stc_rows_fused: its bars, plus exactly the
    # exact-k entries sent, τ = 0 on row 0 and k sent on rows 1 and 2.
    got = kd.stc_rows_fused_cuda(x, ref_row, mask32, k)
    v = _stc_rows_fused_verdict(torch, kref, x, ref_row, mask32, k, got)
    v["ok"] = bool(v["ok"] and v["sent"] == v["sent_exact_k"]
                   and float(got[1][0]) == 0.0
                   and v["sent"][1] == v["sent"][2] == k)
    print(json.dumps({"name": "stc_rows_fused_ties", "shape": [c, n],
                      "k": k, "tau": got[1].tolist()[:3],
                      "count": got[3].tolist()[:3], **v}))
    if not v["ok"]:
        _fail(f"stc_rows_fused ties: {json.dumps(v)}")
    # A planted fault: the kernel run with k - 1 keeps one entry too few
    # per masked row, which the verdict (exact-k support) must reject.
    ctl = _stc_rows_fused_verdict(torch, kref, x, ref_row, mask32, k,
                                  kd.stc_rows_fused_cuda(x, ref_row, mask32,
                                                         k - 1))
    print(json.dumps({"name": "stc_rows_fused_control",
                      "control": "k_minus_1", "shape": [c, n], "k": k,
                      "same_support_as_exact_k":
                          ctl["same_support_as_exact_k"],
                      "sent": ctl["sent"],
                      "sent_exact_k": ctl["sent_exact_k"],
                      "rows_failed": ctl["rows_failed"],
                      "must_fail": True, "failed": not ctl["ok"]}))
    if ctl["ok"] or ctl["same_support_as_exact_k"]:
        _fail("stc_rows_fused control k-1 passed the exact-k support check")


def _payload_shapes(torch, port, task: str, adapter_hops: bool) -> list:
    """Leaf shapes, in ``stack_ravel``'s order, of the tree a run hops."""
    from repro_torch.tree import tree_leaves
    model = port.build_task_model(task)
    params = model.init(torch.Generator())
    if adapter_hops and model.split is not None:
        params = model.split(params)[1]
    return [tuple(x.shape) for x in tree_leaves(params)]


def _quant_rows(torch, gen, c: int, f: int):
    """(c, f) fp32 rows on the card, in 512-element blocks of random scale
    (10^±2), and in each row five planted blocks placed by the row index:
    all zeros (the ε floor), exact half-way ties after scaling (scale 1/8,
    ±15.875 at the ends: codes ±127), ±0 and subnormals among normal
    values, subnormals only (the ε floor again), and ±5 throughout (every
    code at the ±127 clip).  With fewer than five blocks the later plants
    overwrite the earlier."""
    nb = -(-f // 512)
    x = torch.randn((c, nb, 512), generator=gen, device="cuda") * (
        10.0 ** torch.empty((c, nb, 1), device="cuda").uniform_(
            -2, 2, generator=gen))
    ar = torch.arange(512, device="cuda")
    ties = (ar % 9 - 4.5) / 8.0
    ties[0], ties[-1] = 15.875, -15.875
    sub = torch.where(ar % 3 == 0, -1e-40, 1e-40).to(torch.float32)
    clip = torch.where(ar % 2 == 0, 5.0, -5.0).to(torch.float32)
    for r in range(c):
        b = [(r + t) % nb for t in range(5)]
        x[r, b[0]] = 0.0
        x[r, b[1]] = ties
        x[r, b[2], ::7] = 0.0
        x[r, b[2], 3::7] = -0.0
        x[r, b[2], 5::11] = 3e-39
        x[r, b[3]] = sub
        x[r, b[4]] = clip
    return x.reshape(c, nb * 512)[:, :f].contiguous()


def _roundtrip_inputs(torch, flat, shapes, form: str):
    """The rows of ``flat`` (C, F) cut into leaves of ``shapes``, laid out
    as a plane lays them: ``stacked`` — L client-stacked leaves (C, *shape)
    (the fleet plane's tree); ``rows`` — C separate slot trees (the host
    plane); ``unaligned`` — slot leaves that are views one element into a
    buffer, so no row is 16-byte aligned."""
    c = flat.shape[0]
    cuts, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        cuts.append((off, n, shape))
        off += n
    if form == "stacked":
        return [flat[:, o:o + n].reshape((c,) + shape).contiguous()
                for o, n, shape in cuts]
    rows = []
    for r in range(c):
        row = []
        for o, n, shape in cuts:
            if form == "unaligned":
                buf = torch.empty(n + 1, device="cuda")
                buf[1:] = flat[r, o:o + n]
                row.append(buf[1:].view(shape))
            else:
                row.append(flat[r, o:o + n].reshape(shape).clone())
        rows.append(row)
    return rows


def _old_tree_hop(params, src_of_dst):
    """The fleet plane's int8 hop before ``quant_roundtrip``: ravel, pad,
    ``quant_pack``, ``quant_unpack``, unravel, then ``diffuse_params``'s
    gather (``src_of_dst`` a host sequence, or an index on the card)."""
    import numpy as np
    import torch
    from repro_torch.distributed.fedshard import diffuse_params
    from repro_torch.fl.adapters import quant_roundtrip_rows
    from repro_torch.kernels.diffusion import stack_ravel, stack_unravel
    from repro_torch.tree import tree_leaves
    flat, spec = stack_ravel(params)
    out = stack_unravel(quant_roundtrip_rows(flat), spec)
    if not isinstance(src_of_dst, torch.Tensor):
        src_of_dst = torch.as_tensor(np.asarray(src_of_dst, np.int64),
                                     device=tree_leaves(params)[0].device)
    return diffuse_params(out, src_of_dst)


def _old_slots_hop(slots, src_of_dst):
    """The host plane's int8 hop before ``quant_roundtrip``: a cat, pad,
    ``quant_pack``, ``quant_unpack`` and slices per slot, then the
    reorder."""
    from repro_torch.fl.adapters import quant_roundtrip_slot
    out = [quant_roundtrip_slot(s) for s in slots]
    return [out[int(src_of_dst[c])] for c in range(len(slots))]


def _roundtrip_verdict(torch, got, codes, scales, want) -> dict:
    """``got`` (L leaves) with its ``codes`` / ``scales`` against the plain
    version's ``want = (leaves, codes, scales)``, bit for bit."""
    w_leaves, w_codes, w_scales = want
    out_eq = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                 for a, b in zip(got, w_leaves))
    v = {"out_bit_equal": out_eq,
         "codes_equal": bool(torch.equal(codes, w_codes)),
         "scales_bit_equal": bool(torch.equal(scales.view(torch.int32),
                                              w_scales.view(torch.int32))),
         "max_abs_err": max(float((a - b).abs().max())
                            for a, b in zip(got, w_leaves))}
    v["ok"] = v["out_bit_equal"] and v["codes_equal"] and v["scales_bit_equal"]
    return v


def check_quant_roundtrip(torch, kq, kref, port, gen) -> list[dict]:
    """Phase 2, ``quant_roundtrip`` — the int8 hop of one PermuteOp in one
    launch — at the leaf table of every int8 run this script drives (the
    lm adapter tree, 8 rows × 24 leaves, 56 blocks; the fcn tree on the
    fleet plane, 8 × 6 stacked, and on the host plane, 8 slot trees × 6,
    416 blocks; phase 4's small lm cell, 4 × 24; and the host plane's lm
    table, 8 slot trees × 24), one leaf of 65536·512 elements in 8 rows,
    one-leaf rows of F = 10 and 26121 (not multiples of 4 or 512) and the
    host fcn table on unaligned views, each under a permuting src_of_dst
    (the lm table also under the identity), on ``_quant_rows``' data.
    Each must equal ``quant_roundtrip_ref`` bit for bit — leaves, codes
    and scales — and give the same bits on two calls.  Times: ``ms`` (the
    kernel as the main path calls it, no codes or scales, a CUDA graph of
    calls), ``chain_ms`` (the chain it replaces, as the main path ran it
    before: ``_old_tree_hop`` or ``_old_slots_hop``, in one graph at the
    same table; ``chain_call_ms`` host-inclusive, beside the kernel's
    ``call_ms``), ``plain_ms`` and ``bound_ms`` (4 bytes read and 4 written
    per element).  No single PyTorch call computes the function
    (``library_ms`` none).  Then a planted fault — every block decoded with
    the next block's scale — must fail the bit check."""
    from repro_torch.kernels.quant import QUANT_BLOCK
    lm = _payload_shapes(torch, port, "lm", True)
    fcn = _payload_shapes(torch, port, "fcn", False)
    perm8 = [5, 2, 7, 0, 3, 6, 1, 4]
    tables = [("lm adapter, fleet", 8, lm, "stacked", perm8),
              ("lm adapter, fleet", 8, lm, "stacked", None),
              ("fcn, fleet", 8, fcn, "stacked", perm8),
              ("fcn, host", 8, fcn, "rows", perm8),
              ("lm adapter, small cell", LM_SMALL_FL["num_clients"], lm,
               "stacked", [2, 0, 3, 1]),
              ("lm adapter, host", 8, lm, "rows", perm8),
              ("one leaf of 65536 blocks", 8, [(8192 * QUANT_BLOCK,)],
               "stacked", perm8),
              ("one leaf, F = 10", 8, [(10,)], "stacked", perm8),
              ("one leaf, F = 26121", 8, [(26121,)], "stacked", perm8),
              ("fcn, host, unaligned views", 8, fcn, "unaligned", perm8)]
    rows = []
    for label, c, shapes, form, src in tables:
        f = sum(math.prod(sh) for sh in shapes)
        nb = -(-f // QUANT_BLOCK)
        inputs = _roundtrip_inputs(torch, _quant_rows(torch, gen, c, f),
                                   shapes, form)
        outs = []
        for _ in range(2):
            codes = torch.empty((c, nb * QUANT_BLOCK), device="cuda",
                                dtype=torch.int8)
            scales = torch.empty((c, nb), device="cuda")
            got = kq.quant_roundtrip_cuda(inputs, src, codes=codes,
                                          scales=scales)
            outs.append((got, codes, scales))
        want = kref.quant_roundtrip_ref(inputs, src)
        torch.cuda.synchronize()
        v = _roundtrip_verdict(torch, *outs[0], want)
        repeat = all(bool(torch.equal(a.view(torch.int8),
                                      b.view(torch.int8)))
                     for a, b in zip(outs[0][0] + list(outs[0][1:]),
                                     outs[1][0] + list(outs[1][1:])))
        if form == "stacked":
            idx = torch.as_tensor(src if src is not None else list(range(c)),
                                  device="cuda")
            chain = lambda: _old_tree_hop(inputs, idx)  # noqa: E731
        else:
            order = src if src is not None else range(c)
            chain = lambda: _old_slots_hop(inputs, order)  # noqa: E731
        big = c * f > 2 ** 24
        bound, by = _bound(8.0 * c * f, 8.0 * c * f)
        times = _timings(torch, lambda: kq.quant_roundtrip_cuda(inputs, src),
                         lambda: kref.quant_roundtrip_ref(inputs, src),
                         inner=5 if big else 20, reps=5 if big else 10,
                         iters=20 if big else 200)
        chain_ms, chain_err = _device_ms(torch, chain, 5 if big else 20,
                                         5 if big else 10)
        chain_call_ms = _time_ms(torch, chain, 20 if big else 200, 10)
        row = {"name": "quant_roundtrip", "table": label,
               "shape": [c, len(shapes), c * nb], "f": f, "layout": form,
               "src_of_dst": "identity" if src is None else "permuted",
               **v, "same_bits_twice": repeat, "tol": 0.0, **times,
               "chain_ms": chain_ms, "chain_call_ms": chain_call_ms,
               **({"chain_device_error": chain_err} if chain_err else {}),
               "bound_ms": bound, "bound_by": by}
        row["ok"] = bool(v["ok"] and repeat)
        if form == "unaligned":
            row["inputs"] = form
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"quant_roundtrip {label}: {json.dumps(row)}")
        rows.append(row)
    # The planted fault, on the last lm fleet table's kernel output: block
    # r decoded with block r + 1's scale (cyclic in the row).
    c, shapes = 8, lm
    f = sum(math.prod(sh) for sh in shapes)
    nb = -(-f // QUANT_BLOCK)
    inputs = _roundtrip_inputs(torch, _quant_rows(torch, gen, c, f), shapes,
                               "stacked")
    codes = torch.empty((c, nb * QUANT_BLOCK), device="cuda",
                        dtype=torch.int8)
    scales = torch.empty((c, nb), device="cuda")
    kq.quant_roundtrip_cuda(inputs, perm8, codes=codes, scales=scales)
    flat = (codes.float().reshape(c, nb, QUANT_BLOCK)
            * torch.roll(scales, -1, dims=1)[:, :, None]).reshape(c, -1)
    faulty = [flat[:, o:o + math.prod(sh)].reshape((c,) + sh)
              for o, sh in zip(itertools.accumulate(
                  [0] + [math.prod(sh) for sh in shapes]), shapes)]
    ctl = _roundtrip_verdict(torch, faulty, codes, scales,
                             kref.quant_roundtrip_ref(inputs, perm8))
    print(json.dumps({"name": "quant_roundtrip_control",
                      "fault": "block r decoded with block r+1's scale",
                      "table": "lm adapter, fleet", **ctl,
                      "must_fail": True, "failed": not ctl["ok"]}))
    if ctl["ok"] or ctl["out_bit_equal"]:
        _fail("quant_roundtrip control: a block decoded with its "
              "neighbour's scale passed the bit check")
    return rows


def launch_floor(torch) -> dict:
    """The measured cost of a launch that does no work: an empty kernel
    (``csrc/launch_floor.cu``, one warp) timed by the same CUDA-graph
    harness as every kernel (``ms``), and host-inclusive per ctypes call
    (``call_ms``).  It ports nothing, so it stands outside the ``kernels``
    summary; PERF.md reads each FL kernel's time against it."""
    from repro_torch.kernels import build
    from repro_torch.kernels.launch import raise_on
    lib = build.load("launch_floor")

    def launch():
        raise_on(lib.repro_launch_floor(
            torch.cuda.current_stream().cuda_stream), "launch_floor")
    ms, err = _device_ms(torch, launch, 20, 10)
    row = {"source": f"{KERNEL_SOURCE}/launch_floor.cu", "grid": 1,
           "block": 32, "ms": ms, "call_ms": _time_ms(torch, launch),
           **({"device_error": err} if err else {})}
    print(json.dumps({"launch_floor": row}))
    if ms is None:
        _fail(f"launch_floor could not be timed: {err}")
    return row


def check_kernels(torch, kd, kq, kref, port) -> list[dict]:
    """Phase 2: each kernel against its plain version on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    mix_shapes, stc_shapes, bid_shapes, quant_shapes = path_shapes(torch,
                                                                   port)
    print(json.dumps({"path_shapes": {"mix_aggregate": mix_shapes,
                                      "stc_rows": stc_shapes,
                                      "dol_bid_scores": bid_shapes,
                                      "bid_value_fuse": [list(s[:2]) for s
                                                         in bid_shapes],
                                      "bid_fused": bid_shapes,
                                      "quant_pack": quant_shapes}}))
    rows = []

    def record(row):
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"{row['name']} {row['shape']}: max_abs_err "
                  f"{row['max_abs_err']} > tol {row['tol']}")
        rows.append(row)

    # mix_aggregate: the driven runs' Eq.-11 rows (G=1), then a MixOp (G=C)
    # on the fcn fleet, a fleet large enough to time (107 MB, twice the
    # 50 MB L2), and ragged shapes (C not a multiple of the 8 warps, G not a
    # multiple of the tile).
    for c, f, g in mix_shapes + [(8, 26122, 8), (1024, 26122, 1),
                                 (5, 1000, 5), (37, 1001, 11)]:
        x = torch.randn((c, f), generator=gen, device="cuda")
        w = torch.rand((g, c), generator=gen, device="cuda")
        w = w / w.sum(dim=1, keepdim=True)      # row-stochastic, as Eq. 10/11
        out = kd.mix_aggregate_cuda(x, w)
        plain = kref.mix_aggregate_ref(x, w)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        tol = 1e-5 * (1.0 + float(plain.abs().max()))
        bound, by = _bound(4.0 * (c * f + g * c + g * f), 2.0 * g * c * f)
        record({"name": "mix_aggregate", "shape": [c, f, g],
                "max_abs_err": err, "tol": tol, "ok": err <= tol,
                **_timings(torch, lambda: kd.mix_aggregate_cuda(x, w),
                           lambda: kref.mix_aggregate_ref(x, w),
                           lambda: w @ x),
                "bound_ms": bound, "bound_by": by})

    # stc_rows' reduce and apply (the chain that serves rows past N_FUSED):
    # every leaf of the driven STC runs, a (1024, 8192) leaf (34 MB, which
    # stays in the 50 MB L2 across timed calls), a (1024, 16384) leaf
    # (67 MB, beyond L2) and an (8, 262144) leaf, one past N_FUSED's
    # double, the shape such a leaf gives them.  Tie-free by construction
    # (_stc_rows_tie_free; the ties are _stc_rows_ties' rows).
    sparsity = 0.01
    for c, n in stc_shapes + [(1024, 8192), (1024, 16384), (8, 262144)]:
        x, ref_row = _stc_rows_tie_free(torch, gen, c, n)
        mask = (torch.arange(c, device="cuda") % 2 == 0)
        mask32 = mask.to(torch.int32)
        k = max(1, int(n * sparsity))
        thr = kref.stc_rows_threshold(x, ref_row, sparsity)
        ssum, cnt, ties = kd.stc_rows_reduce_cuda(x, ref_row, thr)
        p_sum, p_cnt = kref.stc_rows_reduce_ref(x, ref_row, thr)
        torch.cuda.synchronize()
        if not torch.equal(cnt, p_cnt) or not bool((cnt == k).all()):
            _fail(f"stc_rows_reduce ({c}, {n}): survivor counts "
                  f"{cnt.tolist()[:4]} differ from the plain version or k={k}")
        err = float((ssum - p_sum).abs().max())
        tol = 1e-5 * (1.0 + float(p_sum.abs().max()))
        bound, by = _bound(4.0 * (c * n + n + 3 * c), 3.0 * c * n)
        record({"name": "stc_rows_reduce", "shape": [c, n],
                "max_abs_err": err, "tol": tol, "ok": err <= tol,
                **_timings(torch,
                           lambda: kd.stc_rows_reduce_cuda(x, ref_row, thr),
                           lambda: kref.stc_rows_reduce_ref(x, ref_row, thr)),
                "bound_ms": bound, "bound_by": by})

        out = kd.stc_rows_apply_cuda(x, ref_row, thr, ssum, cnt, ties,
                                     mask32, k)
        plain = kref.stc_rows_apply_ref(x, ref_row, thr, ssum, cnt, mask32, k)
        torch.cuda.synchronize()
        if not torch.equal(out[~mask], x[~mask]):
            _fail(f"stc_rows_apply ({c}, {n}): unmasked rows changed")
        err = float((out - plain).abs().max())
        # Same inputs, same fp32 operations: the apply must be exact.
        bound, by = _bound(4.0 * (2 * c * n + n + 4 * c), 4.0 * c * n)
        record({"name": "stc_rows_apply", "shape": [c, n],
                "max_abs_err": err, "tol": 0.0, "ok": err == 0.0,
                **_timings(torch,
                           lambda: kd.stc_rows_apply_cuda(
                               x, ref_row, thr, ssum, cnt, ties, mask32, k),
                           lambda: kref.stc_rows_apply_ref(
                               x, ref_row, thr, ssum, cnt, mask32, k)),
                "bound_ms": bound, "bound_by": by})

        # The composite (stc_rows_fused up to N_FUSED, else τ + reduce +
        # apply) against the exact-k plain STC.
        whole = kd.stc_rows_cuda(x, ref_row, mask32, sparsity)
        want = kref.stc_rows_ref(x, ref_row, mask, sparsity)
        torch.cuda.synchronize()
        err = float((whole - want).abs().max())
        tol = 1e-5 * (1.0 + float(want.abs().max()))
        print(json.dumps({"name": "stc_rows", "shape": [c, n],
                          "max_abs_err": err, "tol": tol, "ok": err <= tol}))
        if err > tol:
            _fail(f"stc_rows ({c}, {n}) disagrees with stc_rows_ref")
    rows += check_stc_rows_fused(torch, kd, kref, gen, stc_shapes)
    _stc_rows_ties(torch, kd, kref, gen)

    # dol_bid_scores: every planner shape of the driven runs and checks,
    # and (1024, 1024, 10), a scaling row (no FedDif run bids over more
    # than 256 clients).  A never-trained model (dol 0, chain 0) and empty clients
    # keep the δ terms live; atol 2e-5 is the reference's own bar.  Then a
    # near-uniform case (dist → 0), where the centered form must not cancel:
    # atol 1e-7.  Bound: inputs read and (M, N) written once, 2·M·N·C
    # flops of the contraction plus ~30 per output of epilogue.
    for m, n, c in bid_shapes + [(1024, 1024, NUM_CLASSES)]:
        args = _bid_inputs(torch, gen, m, n, c)
        out = kd.dol_bid_scores_cuda(*args)
        plain = kref.dol_bid_scores_fused_ref(*args)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        bound, by = _bound(4.0 * (m * c + m + n * c + n + m * n),
                           2.0 * m * n * c + 30.0 * m * n)
        record({"name": "dol_bid_scores", "shape": [m, n, c],
                "max_abs_err": err, "tol": 2e-5, "ok": err <= 2e-5,
                "max_abs_err_vs_composite": float(
                    (out - kref.dol_bid_scores_ref(*args)).abs().max()),
                **_timings(torch, lambda: kd.dol_bid_scores_cuda(*args),
                           lambda: kref.dol_bid_scores_fused_ref(*args)),
                "bound_ms": bound, "bound_by": by})
    m, n, c = 8, 12, NUM_CLASSES
    dol = torch.full((m, c), 1.0 / c, device="cuda") + 1e-4 * torch.randn(
        (m, c), generator=gen, device="cuda")
    dol = dol / dol.sum(dim=1, keepdim=True)
    args = (dol, torch.randint(100, 500, (m,), generator=gen,
                               device="cuda").float(),
            torch.full((n, c), 1.0 / c, device="cuda"),
            torch.randint(50, 100, (n,), generator=gen, device="cuda").float())
    err = float((kd.dol_bid_scores_cuda(*args)
                 - kref.dol_bid_scores_fused_ref(*args)).abs().max())
    print(json.dumps({"name": "dol_bid_scores", "case": "near_uniform",
                      "shape": [m, n, c], "max_abs_err": err, "tol": 1e-7,
                      "ok": err <= 1e-7}))
    if err > 1e-7:
        _fail(f"dol_bid_scores near-uniform: max_abs_err {err} > 1e-7")

    # bid_value_fuse: the same (M, N) shapes.  Same inputs, the same three
    # rounded fp32 operations: bit-exact.  Library: torch.addcmul, the same
    # function up to rounding (it is not used by the port).
    for m, n, _ in bid_shapes + [(1024, 1024, NUM_CLASSES)]:
        bids = torch.randn((m, n), generator=gen, device="cuda")
        value = torch.rand((n,), generator=gen, device="cuda")
        w = VALUE_WEIGHT
        out = kd.bid_value_fuse_cuda(bids, value, w)
        plain = kref.bid_value_fuse_ref(bids, value, w)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        bound, by = _bound(4.0 * (2 * m * n + n), 3.0 * m * n)
        record({"name": "bid_value_fuse", "shape": [m, n],
                "max_abs_err": err, "tol": 0.0,
                "ok": bool(torch.equal(out, plain)),
                **_timings(torch, lambda: kd.bid_value_fuse_cuda(bids, value,
                                                                 w),
                           lambda: kref.bid_value_fuse_ref(bids, value, w),
                           lambda: torch.addcmul(bids, bids, value[None, :],
                                                 value=w)),
                "bound_ms": bound, "bound_by": by})
    rows += check_bid_fused(torch, kd, kref, gen, bid_shapes)

    # quant_pack / quant_unpack: every int8 block of the driven runs, a
    # (65536, 512) block (128 MB of fp32, beyond L2), and the reference
    # tests' ragged shapes (3, 8) and (16, 128).  Rows of random scale,
    # one all-zero row, one row of exact .5 ties at scale 1/8 with both
    # clip ends.  Same inputs, the same rounded fp32 operations: codes,
    # scales and decoded values must be bit-exact.  Library: none for the
    # pack (no single PyTorch call); torch.mul with type promotion for the
    # unpack.
    for r, b in quant_shapes + [(65536, 512), (3, 8), (16, 128)]:
        x = torch.randn((r, b), generator=gen, device="cuda") * (
            10.0 ** torch.empty((r, 1), device="cuda").uniform_(
                -2, 2, generator=gen))
        x[0] = 0.0
        if r > 1:
            ties = (torch.arange(b, device="cuda") % 9 - 4.5) / 8.0
            ties[0], ties[-1] = 15.875, -15.875
            x[1] = ties
        q, sc = kq.quant_pack_cuda(x)
        p_q, p_sc = kref.quant_pack_ref(x)
        torch.cuda.synchronize()
        ok = (torch.equal(q, p_q)
              and torch.equal(sc.view(torch.int32), p_sc.view(torch.int32)))
        err = float(max((q.int() - p_q.int()).abs().max(),
                        (sc - p_sc).abs().max()))
        bound, by = _bound(5.0 * r * b + 4.0 * r, 6.0 * r * b)
        record({"name": "quant_pack", "shape": [r, b],
                "max_abs_err": err, "tol": 0.0, "ok": ok,
                **_timings(torch, lambda: kq.quant_pack_cuda(x),
                           lambda: kref.quant_pack_ref(x)),
                "bound_ms": bound, "bound_by": by})
        out = kq.quant_unpack_cuda(p_q, p_sc)
        plain = kref.quant_unpack_ref(p_q, p_sc)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        bound, by = _bound(5.0 * r * b + 4.0 * r, 1.0 * r * b)
        record({"name": "quant_unpack", "shape": [r, b],
                "max_abs_err": err, "tol": 0.0,
                "ok": bool(torch.equal(out.view(torch.int32),
                                       plain.view(torch.int32))),
                **_timings(torch, lambda: kq.quant_unpack_cuda(p_q, p_sc),
                           lambda: kref.quant_unpack_ref(p_q, p_sc),
                           lambda: torch.mul(p_q, p_sc[:, None])),
                "bound_ms": bound, "bound_by": by})
    rows += check_quant_roundtrip(torch, kq, kref, port, gen)
    return rows


def _old_mix_chain(params, w, *, collapse: bool = False,
                   keep_float32: bool = False):
    """The fleet plane's Eq. 10/11 before ``mix_tree``: ``stack_ravel``
    (a cat of every leaf), ``ops.mix_aggregate`` on the (C, F) block (the
    flat ``mix_aggregate`` kernel on the card, ``w`` moved there) and
    ``stack_unravel`` (strided views of one (G, F) block)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.diffusion import stack_ravel, stack_unravel
    flat, spec = stack_ravel(params)
    return stack_unravel(ops.mix_aggregate(flat, w), spec, collapse=collapse,
                         keep_float32=keep_float32)


def _mix_tree_cases(torch, port) -> list:
    """``check_mix_tree``'s trees: (label, C, G, leaf shapes, w on the card,
    inputs).  The Eq.-11 row (G = 1, collapsed) of every fleet tree the
    driven runs aggregate — each (task, clients) of the phase-3 and
    phase-4 fcn / cnn runs, the lm adapter at the lm_hops cell's 8 and the
    small cell's 4 clients, the lm full model — then a gossip / tthf MixOp
    (fcn, G = C = 8); the same two with ``w`` already on the card; the fcn
    fleet at C = 1024 (107 MB, twice the 50 MB L2; ``w`` on the card, over
    W_MAX); a ragged tree (C = 37, G = 11: leaves of 1, 10 and odd n);
    150 leaves at C = 16, G = 16 (three launches of ≤ L_MAX leaves; ``w``
    on the card); and a tree with a non-contiguous leaf and a bf16 leaf
    (C = 12)."""
    runs = {(task, clients) for _, task, _, clients in (
        WARMUP_RUNS + MAIN_RUNS + (CARD_VS_CPU_RUN, DEVICE_PLANNER_RUN))}
    cases = []
    for task, clients in sorted(runs):
        cases.append((f"{task}, Eq. 11", clients, 1,
                      _payload_shapes(torch, port, task, False), False,
                      "model"))
    lm_adapter = _payload_shapes(torch, port, "lm", True)
    for clients in sorted({LM_FL["num_clients"],
                           LM_SMALL_FL["num_clients"]}):
        cases.append(("lm adapter, Eq. 11", clients, 1, lm_adapter, False,
                      "model"))
    cases.append(("lm full model, Eq. 11", LM_FL["num_clients"], 1,
                  _payload_shapes(torch, port, "lm", False), False, "model"))
    fcn = _payload_shapes(torch, port, "fcn", False)
    cases.append(("fcn, MixOp", 8, 8, fcn, False, "model"))
    cases.append(("fcn, Eq. 11", 8, 1, fcn, True, "w on the card"))
    cases.append(("fcn, MixOp", 8, 8, fcn, True, "w on the card"))
    cases.append(("fcn, Eq. 11", 1024, 1, fcn, True, "model"))
    cases.append(("ragged", 37, 11, [(1,), (10,), (7, 3), (1001,), (5, 13),
                                     (4096,), (3,)], False, "ragged"))
    many = [(1 + (37 * i) % 257,) if i % 3 else (4 * (1 + i % 50),)
            for i in range(150)]
    cases.append(("150 leaves", 16, 16, many, True, "150 leaves"))
    cases.append(("non-contiguous and bf16 leaves", 12, 1,
                  [(64, 33), (128,), (9,), (256, 4)], False,
                  "non-contiguous and bf16 leaves"))
    return cases


def _mix_tree_inputs(torch, gen, c, g, shapes, w_card, inputs):
    """A tree of ``shapes`` stacked over C clients (a list of leaves, as
    ``tree_flatten`` orders a list), and a row-stochastic (G, C) ``w`` —
    fp32 on the host, as the executor builds it, or on the card.  For the
    ``non-contiguous`` inputs leaf 0 is a transposed view and leaf 3 is
    bf16."""
    leaves = [torch.randn((c,) + tuple(sh), generator=gen, device="cuda")
              for sh in shapes]
    if inputs.startswith("non-contiguous"):
        leaves[0] = torch.randn((c,) + tuple(shapes[0])[::-1],
                                generator=gen, device="cuda").transpose(1, 2)
        leaves[3] = leaves[3].to(torch.bfloat16)
    w = torch.rand((g, c), generator=gen, device="cuda")
    w = w / w.sum(dim=1, keepdim=True)
    return leaves, (w if w_card else w.cpu())


def _bits_equal(torch, a, b) -> bool:
    """Two trees' leaves equal bit for bit (shapes and dtypes too)."""
    from repro_torch.tree import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(torch.equal(x.reshape(-1).contiguous().view(torch.int8),
                             y.reshape(-1).contiguous().view(torch.int8)))
        for x, y in zip(la, lb))


def check_mix_tree(torch, kd, kref, port, gen, floor_ms: float) -> list[dict]:
    """Phase 2, ``mix_tree`` — Eq. 10/11 over a client-stacked tree in one
    launch, the leaves read in place — on ``_mix_tree_cases``' trees.  Each
    row: the output leaves bit-equal to the old chain (``_old_mix_chain``:
    ravel → the flat ``mix_aggregate`` kernel → unravel) on two calls,
    within 1e-5·(1 + max|plain|) of the plain version
    (``mix_aggregate_tree_ref`` on the card); ``ms`` (the kernel as the
    fleet executor calls it, a CUDA graph of calls), ``chain_ms`` (the old
    chain in one graph, ``w`` on the card), ``library_ms`` (``w @ x`` on
    the raveled block), ``plain_ms``, ``call_ms`` beside the chain's
    ``chain_call_ms``, ``bound_ms`` (4·(C·F + G·F + G·C) bytes at
    3.35 TB/s) and µs over the launch floor.  First the kernel's table
    limits (L_MAX, W_MAX, tile width) must equal the wrapper's; last a
    planted fault: the MixOp's largest leaf written from its neighbour's
    weights row."""
    from repro_torch.kernels import build
    from repro_torch.kernels.diffusion import stack_ravel
    lib = build.load("mix_aggregate")
    limits = {"l_max": [lib.repro_mix_tree_max_leaves(), kd.MIX_TREE_L_MAX],
              "w_max": [lib.repro_mix_tree_max_w(), kd.MIX_TREE_W_MAX],
              "tile_cols_c8": [lib.repro_mix_tree_tile_cols(8),
                               kd.mix_tree_tile_cols(8)],
              "tile_cols_c9": [lib.repro_mix_tree_tile_cols(9),
                               kd.mix_tree_tile_cols(9)]}
    print(json.dumps({"check": "mix_tree table limits, kernel vs wrapper",
                      **limits}))
    if any(a != b for a, b in limits.values()):
        _fail(f"mix_tree: the kernel's table limits differ from the "
              f"wrapper's: {limits}")
    rows = []
    for label, c, g, shapes, w_card, inputs in _mix_tree_cases(torch, port):
        leaves, w = _mix_tree_inputs(torch, gen, c, g, shapes, w_card,
                                     inputs)
        collapse = g == 1
        w_dev = w.to("cuda")
        got = [kd.mix_aggregate_tree_cuda(leaves, w, collapse=collapse)
               for _ in range(2)]
        old = _old_mix_chain(leaves, w_dev, collapse=collapse)
        plain = kref.mix_aggregate_tree_ref(leaves, w_dev, collapse=collapse)
        torch.cuda.synchronize()
        bit_equal = [_bits_equal(torch, x, old) for x in got]
        contiguous = all(x.is_contiguous() for x in got[0])
        err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got[0], plain))
        tol = 1e-5 * (1.0 + max(float(b.float().abs().max()) for b in plain))
        f = sum(math.prod(sh) for sh in shapes)
        flat = stack_ravel(leaves)[0]
        bound, by = _bound(4.0 * (c * f + g * f + g * c), 2.0 * g * c * f)
        big = c * f > 2 ** 24
        times = _timings(
            torch,
            lambda: kd.mix_aggregate_tree_cuda(leaves, w, collapse=collapse),
            lambda: kref.mix_aggregate_tree_ref(leaves, w_dev,
                                                collapse=collapse),
            lambda: w_dev @ flat, inner=5 if big else 20,
            reps=5 if big else 10, iters=20 if big else 200)

        def chain():
            return _old_mix_chain(leaves, w_dev, collapse=collapse)
        chain_ms, chain_err = _device_ms(torch, chain, 5 if big else 20,
                                         5 if big else 10)
        row = {"name": "mix_tree", "tree": label, "shape": [c, f, g],
               "leaves": len(shapes), "w": "card" if w_card else "host",
               "bit_equal_to_old_chain": bit_equal,
               "outputs_contiguous": contiguous, "max_abs_err": err,
               "tol": tol, **times, "chain_ms": chain_ms,
               "chain_call_ms": _time_ms(torch, chain, 20 if big else 200,
                                         10),
               **({"chain_device_error": chain_err} if chain_err else {}),
               "bound_ms": bound, "bound_by": by,
               "over_floor_us": (None if times["ms"] is None
                                 else (times["ms"] - floor_ms) * 1e3)}
        if inputs != "model":
            row["inputs"] = inputs
        row["ok"] = bool(all(bit_equal) and contiguous and err <= tol)
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"mix_tree {label} {row['shape']}: {json.dumps(row)}")
        rows.append(row)
    # The planted fault: the fcn MixOp with its largest leaf written from
    # the neighbouring weights row (w's rows rolled by one for that leaf).
    fcn = _payload_shapes(torch, port, "fcn", False)
    leaves, w = _mix_tree_inputs(torch, gen, 8, 8, fcn, False, "model")
    big = max(range(len(fcn)), key=lambda i: math.prod(fcn[i]))
    faulty = kd.mix_aggregate_tree_cuda(leaves, w)
    faulty[big] = kd.mix_aggregate_tree_cuda([leaves[big]],
                                             torch.roll(w, 1, dims=0))[0]
    old = _old_mix_chain(leaves, w.to("cuda"))
    torch.cuda.synchronize()
    ctl = _bits_equal(torch, faulty, old)
    print(json.dumps({"name": "mix_tree_control",
                      "fault": "the largest leaf written from its "
                               "neighbour's weights row",
                      "tree": "fcn, MixOp", "bit_equal_to_old_chain": ctl,
                      "must_fail": True, "failed": not ctl}))
    if ctl:
        _fail("mix_tree control: a leaf written from its neighbour's "
              "weights row passed the bit check")
    return rows


def mix_routing(torch, kd) -> dict:
    """Phase 3c, the flat op (``ops.mix_aggregate``) on a card block of the
    fcn fleet's shape, (8, 26122), with a host (1, 8) row: one
    ``mix_aggregate`` launch, no ``mix_tree``, bit-equal to the kernel
    called directly.  No FL path runs it since ``mix_tree`` took Eq. 10/11;
    its launch is returned apart from the main path's."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((8, 26122), generator=gen, device="cuda")
    w = torch.rand((1, 8), generator=gen, device="cuda")
    w = (w / w.sum()).cpu()
    kd.reset_launch_counts()
    out = ops.mix_aggregate(x, w)
    torch.cuda.synchronize()
    counts = dict(kd.LAUNCHES)
    same = bool(torch.equal(out.view(torch.int32), kd.mix_aggregate_cuda(
        x, w.to("cuda")).view(torch.int32)))
    row = {"check": "mix routing", "shape": [8, 26122, 1],
           "launches": {k: counts[k] for k in ("mix_aggregate", "mix_tree")},
           "bit_equal_to_kernel": same}
    row["ok"] = bool(same and counts["mix_aggregate"] == 1
                     and counts["mix_tree"] == 0)
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"mix routing: {json.dumps(row)}")
    return counts


def _bid_inputs(torch, gen, m, n, c):
    """Planner-shaped bid inputs on the card: DoLs and DSIs on the simplex,
    chains and data sizes as the planner sees them, with model 0 never
    trained (dol 0, chain 0) and client 0 empty."""
    dol = torch.rand((m, c), generator=gen, device="cuda")
    dol = dol / dol.sum(dim=1, keepdim=True)
    chain = torch.randint(200, 5000, (m,), generator=gen,
                          device="cuda").float()
    dsi = torch.rand((n, c), generator=gen, device="cuda") ** 4
    dsi = dsi / dsi.sum(dim=1, keepdim=True)
    size = torch.randint(0, 800, (n,), generator=gen, device="cuda").float()
    dol[0], chain[0], size[0] = 0.0, 0.0, 0.0
    return dol, chain, dsi, size


def _old_bid_chain(iid, dol, chain_size, dsi, data_size, value=None,
                   weight: float = 0.0, *, metric: str = "w1_norm"):
    """One bid round as the planner ran it before ``bid_fused``, with
    ``ops.bid_fused``'s signature: ``dol_bid_scores``, PyTorch's
    subtraction, then ``bid_value_fuse`` where a value is given (three
    launches on the card)."""
    from repro_torch.kernels import ops
    bids = iid[:, None] - ops.dol_bid_scores(dol, chain_size, dsi,
                                             data_size, metric=metric)
    return bids if value is None else ops.bid_value_fuse(bids, value, weight)


def check_bid_fused(torch, kd, kref, gen, shapes) -> list[dict]:
    """Phase 2, ``bid_fused`` — one bid round of the device planner in one
    launch — at every bid shape of the driven runs and checks, at
    (256, 256, 10) (the largest population any FedDif run bids over), at
    (1024, 1024, 10) (a scaling row: no run bids there) and at (33, 70, 64)
    (the kernel's runtime-C instance; C = 10 has its own), each with a learning value (w =
    VALUE_WEIGHT) and without one, on ``_bid_inputs``' data and the port's
    IID distances of its DoLs.  Each must equal the chain it replaces
    (``_old_bid_chain``: ``dol_bid_scores`` → subtraction →
    ``bid_value_fuse``) bit for bit on two calls (models 0 and 1 never
    trained, clients 0 and 1 with 0 and 0.5 samples, so a + b < 1 at four
    outputs), and ``bid_fused_ref``
    within the reference's atol 2e-5; near uniform (dist → 0) within 1e-7.
    Times: ``ms`` (a CUDA graph of calls), ``chain_ms`` (the old chain in
    one graph), ``call_ms`` / ``chain_call_ms`` host-inclusive,
    ``plain_ms``; bound: each input read once and (M, N) written once, and
    2·M·N·C + 35·M·N fp32 operations.  No single PyTorch call computes the
    function (``library_ms`` none).  Then two planted faults — the kernel
    fed the neighbouring client's value, or the next model's IID distance —
    must fail the bit check."""
    from repro_torch.core.dol import iid_distance_t
    rows = []
    w = VALUE_WEIGHT

    def same_bits(a, b) -> bool:
        return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))

    def verdict(label, m, n, c, iid, args, value, tol):
        outs = [kd.bid_fused_cuda(iid, *args, value, w) for _ in range(2)]
        chain = _old_bid_chain(iid, *args, value, w)
        plain = kref.bid_fused_ref(iid, *args, value, w)
        torch.cuda.synchronize()
        equal = [same_bits(o, chain) for o in outs]
        err = float((outs[0] - plain).abs().max())
        return {"name": "bid_fused", "shape": [m, n, c],
                "value": value is not None, "case": label,
                "bit_equal_to_chain": equal, "max_abs_err": err, "tol": tol,
                "ok": bool(all(equal) and err <= tol)}

    for m, n, c in shapes + [(256, 256, NUM_CLASSES),
                             (1024, 1024, NUM_CLASSES), (33, 70, 64)]:
        args = _bid_inputs(torch, gen, m, n, c)
        # Model 1 never trained too and client 1 with half a sample: a + b
        # of 0.5 beside _bid_inputs' 0 drives the kernel's a + b < 1
        # branch (the δ terms) at a fractional δ.
        args[0][1], args[1][1], args[3][1] = 0.0, 0.0, 0.5
        iid = iid_distance_t(args[0])
        value_n = torch.rand((n,), generator=gen, device="cuda")
        for value in (value_n, None):
            row = verdict("model", m, n, c, iid, args, value, 2e-5)
            bound, by = _bound(
                4.0 * (2 * m + m * c + n * c + n
                       + (n if value is not None else 0) + m * n),
                2.0 * m * n * c + 35.0 * m * n)
            times = _timings(torch,
                             lambda: kd.bid_fused_cuda(iid, *args, value, w),
                             lambda: kref.bid_fused_ref(iid, *args, value, w))
            chain = lambda: _old_bid_chain(iid, *args, value, w)  # noqa: E731
            chain_ms, chain_err = _device_ms(torch, chain)
            row.update({**times, "chain_ms": chain_ms,
                        "chain_call_ms": _time_ms(torch, chain),
                        **({"chain_device_error": chain_err}
                           if chain_err else {}),
                        "bound_ms": bound, "bound_by": by})
            if value is None:
                row["inputs"] = "no value"
            print(json.dumps(row))
            if not row["ok"]:
                _fail(f"bid_fused {row['shape']}: {json.dumps(row)}")
            rows.append(row)

    # Near uniform, as dol_bid_scores' case: the centered form keeps 1e-7.
    m, n, c = 8, 12, NUM_CLASSES
    dol = torch.full((m, c), 1.0 / c, device="cuda") + 1e-4 * torch.randn(
        (m, c), generator=gen, device="cuda")
    dol = dol / dol.sum(dim=1, keepdim=True)
    args = (dol, torch.randint(100, 500, (m,), generator=gen,
                               device="cuda").float(),
            torch.full((n, c), 1.0 / c, device="cuda"),
            torch.randint(50, 100, (n,), generator=gen, device="cuda").float())
    iid = iid_distance_t(dol)
    for value in (torch.rand((n,), generator=gen, device="cuda"), None):
        row = verdict("near_uniform", m, n, c, iid, args, value, 1e-7)
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"bid_fused near-uniform: {json.dumps(row)}")

    # The planted faults, at the main path's (8, 8, 10) with a value.
    m, n, c = DEVICE_PLANNER_RUN[3], DEVICE_PLANNER_RUN[3], NUM_CLASSES
    args = _bid_inputs(torch, gen, m, n, c)
    iid = iid_distance_t(args[0])
    value = torch.rand((n,), generator=gen, device="cuda")
    want = _old_bid_chain(iid, *args, value, w)
    for fault, f_iid, f_value in (
            ("value[n] read for client n + 1", iid, torch.roll(value, -1)),
            ("the subtraction taken against iid of model m + 1",
             torch.roll(iid, -1), value)):
        got = kd.bid_fused_cuda(f_iid, *args, f_value, w)
        torch.cuda.synchronize()
        same = same_bits(got, want)
        print(json.dumps({"name": "bid_fused_control", "fault": fault,
                          "shape": [m, n, c], "bit_equal_to_chain": same,
                          "must_fail": True, "failed": not same}))
        if same:
            _fail(f"bid_fused control: {fault} passed the bit check")
    return rows


def _fleet_stc_leaves(res, strategy: str, rounds: int) -> int:
    """Leaves the fleet plane compresses in a run: every leaf of the
    client-stacked tree once per compressed hop round (feddif_stc, one
    PermuteOp per diffusion round) or per uplink aggregation (stc, one per
    round)."""
    from repro_torch.tree import tree_leaves
    trees = (sum(res.diffusion_rounds) if strategy == "feddif_stc"
             else rounds if strategy == "stc" else 0)
    return trees * len(tree_leaves(res.final_params))


def main_path(torch, kd, port) -> dict:
    """Phase 3: the port's main path through run_experiment on the card."""
    from repro_torch.tree import tree_leaves
    FLConfig, ExperimentSpec = port.FLConfig, port.ExperimentSpec
    launches = {name: 0 for name in kd.LAUNCHES}
    peak = {}
    # One untimed round of each task and of the device planner first: CUDA
    # context, cuBLAS/cuDNN handles, functorch's first transforms and the
    # planner's first kernels stay out of the timed runs.
    for strategy, task, rounds, clients in WARMUP_RUNS:
        port.run_experiment(ExperimentSpec(
            task=task, alpha=0.3, num_samples=1200,
            fl=FLConfig(executor="fleet", strategy=strategy, rounds=rounds,
                        num_clients=clients, num_models=clients, seed=1)))
    port.run_experiment(ExperimentSpec(
        task="fcn", alpha=0.3, num_samples=1200,
        fl=FLConfig(executor="fleet", strategy="feddif", rounds=1,
                    num_clients=8, num_models=8, seed=1, planner="jax",
                    uncertainty_weight=VALUE_WEIGHT)))
    runs = [(*r, "host", 0.0) for r in MAIN_RUNS]
    runs.insert(2, (*DEVICE_PLANNER_RUN, "jax", VALUE_WEIGHT))
    for strategy, task, rounds, clients, planner, weight in runs:
        spec = ExperimentSpec(
            task=task, alpha=0.3, num_samples=6000,
            fl=FLConfig(executor="fleet", strategy=strategy, rounds=rounds,
                        num_clients=clients, num_models=clients,
                        epsilon=0.04, gamma_min=1.0, seed=0, planner=planner,
                        uncertainty_weight=weight))
        kd.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.run_experiment(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kd.LAUNCHES)
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_leaves(res.final_params))
        name = f"{strategy}/{task}" + (f" planner={planner} w={weight}"
                                       if planner != "host" else "")
        st = res.planner_stats
        plans = max(st.get("plans", 0), 1)
        print(json.dumps({
            "run": name, "rounds": rounds,
            "peak_accuracy": max(res.accuracy), "accuracy": res.accuracy,
            "ledger": res.ledger.as_dict(),
            "diffusion_rounds": res.diffusion_rounds,
            "mean_round_wall_s": sum(res.round_wall_s) / rounds,
            "round_wall_s": res.round_wall_s,
            "planner_s_per_round": st.get("seconds", 0.0) / plans,
            "auction_iterations_per_plan":
                st.get("auction_iterations", 0) / plans,
            "auction_host_reads_per_plan":
                st.get("auction_host_reads", 0) / plans,
            "planner_stats": st,
            "run_wall_s": wall, "launches": counts, "finite": finite}))
        if not finite:
            _fail(f"{name}: non-finite parameters")
        # One mix_tree launch per round (its Eq.-11 aggregation; these
        # strategies run no MixOp), the flat mix_aggregate never.
        if counts["mix_tree"] != rounds or counts["mix_aggregate"]:
            _fail(f"{name}: mix_tree / mix_aggregate launched "
                  f"{counts['mix_tree']} / {counts['mix_aggregate']} times "
                  f"in {rounds} rounds (want {rounds} / 0)")
        if "stc" in strategy:
            # One stc_rows_fused launch per leaf of each compressed tree (a
            # hop round of feddif_stc, an uplink of stc): every fcn leaf
            # fits N_FUSED, so the reduce / apply chain never runs.
            want = _fleet_stc_leaves(res, strategy, rounds)
            if (counts["stc_rows_fused"] != want or want == 0
                    or counts["stc_rows_reduce"] or counts["stc_rows_apply"]):
                _fail(f"{name}: stc_rows_fused / stc_rows_reduce / "
                      f"stc_rows_apply launched {counts['stc_rows_fused']} / "
                      f"{counts['stc_rows_reduce']} / "
                      f"{counts['stc_rows_apply']} times, the schedules "
                      f"imply {want} / 0 / 0")
        if (counts["quant_pack"] or counts["quant_unpack"]
                or counts["quant_roundtrip"]):
            _fail(f"{name}: fp32 hops launched the quant kernels")
        if planner == "jax":
            # One bid_fused launch per bid round (the planner's
            # loop_iterations: each diffusion round and each plan's halting
            # round); the standalone pair never.
            bid_rounds = st.get("loop_iterations", 0)
            if counts["bid_fused"] != bid_rounds or bid_rounds == 0:
                _fail(f"{name}: bid_fused launched {counts['bid_fused']} "
                      f"times over {bid_rounds} bid rounds")
            if counts["dol_bid_scores"] or counts["bid_value_fuse"]:
                _fail(f"{name}: dol_bid_scores / bid_value_fuse launched "
                      f"{counts['dol_bid_scores']} / "
                      f"{counts['bid_value_fuse']} times on the main path")
        for k in launches:
            launches[k] += counts[k]
        peak[name] = max(res.accuracy)
    fedavg = peak["fedavg/fcn"]
    feddif = {k: v for k, v in peak.items() if k.startswith("feddif/fcn")}
    print(json.dumps({"quickstart_peak_accuracy": {"fedavg/fcn": fedavg,
                                                   **feddif}}))
    for k, v in feddif.items():
        if not v > fedavg:
            _fail(f"{k} peak accuracy {v} does not beat FedAvg {fedavg}")
    return launches


def _loss_gap(a: list, b: list) -> float:
    """The largest per-round |a − b| of two loss curves (NaN if either
    curve is not finite, which no bar passes)."""
    gaps = [abs(x - y) for x, y in zip(a, b)]
    return max(gaps) if all(math.isfinite(g) for g in gaps) else math.nan


def _scales_x2(hop):
    """A corrupted int8 hop for the lm_hops gate's planted control: every
    block decoded with twice its scale (the decoded payload doubled)."""
    from repro_torch.tree import tree_map

    def wrong(params, src_of_dst=None):
        return tree_map(lambda x: x * 2.0, hop(params, src_of_dst))
    return wrong


def hop_plane_path(torch, kd, port) -> dict:
    """Phase 3, second half: the adapter hop plane on the card — the
    lm_hops arms and feddif/fcn with int8 hops.  Counters are zeroed right
    before each run and read right after.  Every int8 run must launch
    ``quant_roundtrip`` once per diffusion round (one per PermuteOp) and
    ``quant_pack`` / ``quant_unpack`` never.  The lm_hops gate: the int8
    arm's eval loss within LM_LOSS_GAP of the fp32 adapter arm's in every
    round, the fp32 arm's loss falling, and a planted control (the int8
    arm with every block decoded at twice its scale) that must fail it."""
    import dataclasses
    from repro_torch.tree import tree_leaves
    FLConfig, ExperimentSpec = port.FLConfig, port.ExperimentSpec
    launches = {name: 0 for name in kd.LAUNCHES}
    # One untimed round of the lm task first (functorch's first transforms
    # of the transformer, the quant library's load).
    port.run_experiment(ExperimentSpec(**LM_SMALL_DATA, fl=FLConfig(
        **{**LM_SMALL_FL, "rounds": 1, "seed": 1})))
    strategy, task, rounds, clients = FCN_INT8_RUN
    runs = [(f"feddif/lm {arm}", ExperimentSpec(
        **LM_DATA, adapter_hops=adapter_hops,
        fl=FLConfig(**LM_FL, hop_quant=quant)))
        for arm, (adapter_hops, quant) in LM_ARMS.items()]
    runs.append((f"{strategy}/{task} hop_quant=int8", ExperimentSpec(
        task=task, alpha=0.3, num_samples=6000,
        fl=FLConfig(executor="fleet", strategy=strategy, rounds=rounds,
                    num_clients=clients, num_models=clients, epsilon=0.04,
                    gamma_min=1.0, seed=0, hop_quant="int8"))))
    hop_bits, peak, loss = {}, {}, {}
    for name, spec in runs:
        kd.reset_launch_counts()
        t0 = time.perf_counter()
        res = port.run_experiment(spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(kd.LAUNCHES)
        finite = all(bool(torch.isfinite(x).all())
                     for x in tree_leaves(res.final_params))
        led = res.ledger.as_dict()
        hop = port.spec_adapter_bits(spec)
        f32 = port.spec_adapter_bits(dataclasses.replace(
            spec, fl=dataclasses.replace(spec.fl, hop_quant="none")))
        d2d = led["transmitted_models"] - led["uplink_models"]
        expected = led["uplink_models"] * f32 + d2d * hop
        rel = abs(led["transmitted_bits"] - expected) / expected
        hop_bits[name], peak[name] = hop, max(res.accuracy)
        loss[name] = res.loss
        diffusion = sum(res.diffusion_rounds)
        print(json.dumps({
            "run": name, "rounds": spec.fl.rounds,
            "hop_quant": spec.fl.hop_quant,
            "adapter_hops": spec.adapter_hops,
            "peak_accuracy": max(res.accuracy), "accuracy": res.accuracy,
            "loss": res.loss,
            "ledger": led, "diffusion_rounds": res.diffusion_rounds,
            "hop_bits": hop, "payload_f32_bits": f32, "d2d_hops": d2d,
            "ledger_decomposition_rel_err": rel,
            "mean_round_wall_s": sum(res.round_wall_s) / spec.fl.rounds,
            "round_wall_s": res.round_wall_s,
            "planner_s_per_round": res.planner_stats.get("seconds", 0.0)
            / max(res.planner_stats.get("plans", 0), 1),
            "run_wall_s": wall, "launches": counts, "finite": finite}))
        if not finite:
            _fail(f"{name}: non-finite parameters")
        if (counts["mix_tree"] != spec.fl.rounds
                or counts["mix_aggregate"]):
            _fail(f"{name}: mix_tree / mix_aggregate launched "
                  f"{counts['mix_tree']} / {counts['mix_aggregate']} times "
                  f"in {spec.fl.rounds} rounds (want {spec.fl.rounds} / 0)")
        want = diffusion if spec.fl.hop_quant == "int8" else 0
        if (counts["quant_roundtrip"] != want or counts["quant_pack"]
                or counts["quant_unpack"]):
            _fail(f"{name}: quant_roundtrip / quant_pack / quant_unpack "
                  f"launched {counts['quant_roundtrip']} / "
                  f"{counts['quant_pack']} / {counts['quant_unpack']} times "
                  f"over {diffusion} diffusion rounds (want {want} / 0 / 0)")
        if spec.fl.hop_quant == "int8" and diffusion == 0:
            _fail(f"{name}: no diffusion round, so no int8 hop was driven")
        if rel > 1e-9:
            _fail(f"{name}: transmitted_bits {led['transmitted_bits']} != "
                  f"uplinks·{f32} + {d2d}·{hop} (rel err {rel})")
        for k in launches:
            launches[k] += counts[k]
    # The planted control: the int8 arm again, its hop corrupted.
    import repro_torch.fl.executors as executors
    shipped = executors.quant_roundtrip_tree
    executors.quant_roundtrip_tree = _scales_x2(shipped)
    try:
        control = port.run_experiment(runs[0][1]).loss
    finally:
        executors.quant_roundtrip_tree = shipped
    int8, f32 = loss["feddif/lm adapter_int8"], loss["feddif/lm adapter_f32"]
    gap, control_gap = _loss_gap(int8, f32), _loss_gap(control, f32)
    ratio = hop_bits["feddif/lm full_f32"] / hop_bits["feddif/lm adapter_int8"]
    print(json.dumps({"lm_hops": {
        "peak_accuracy": {k: v for k, v in peak.items() if "/lm " in k},
        "loss": {"adapter_int8": int8, "adapter_f32": f32,
                 "control_scales_x2": control},
        "int8_vs_f32_max_loss_gap": gap, "loss_gap_tol": LM_LOSS_GAP,
        "f32_loss_falls": f32[-1] < f32[0],
        "control_max_loss_gap": control_gap,
        "control_fails_gate": not control_gap <= LM_LOSS_GAP,
        "bytes_per_hop": {k: v / 8.0 for k, v in hop_bits.items()},
        "full_f32_over_adapter_int8_hop_bits": ratio,
        "gate": HOP_RATIO_GATE}}))
    if ratio < HOP_RATIO_GATE:
        _fail(f"full_f32 / adapter_int8 hop bits {ratio} < {HOP_RATIO_GATE}")
    if not f32[-1] < f32[0]:
        _fail(f"lm adapter_f32 loss does not fall: {f32}")
    if not gap <= LM_LOSS_GAP:
        _fail(f"lm adapter_int8 loss is {gap} from adapter_f32's in some "
              f"round, over {LM_LOSS_GAP}")
    if control_gap <= LM_LOSS_GAP:
        _fail(f"lm_hops: the scales x2 control passed the loss gate "
              f"({control_gap} <= {LM_LOSS_GAP})")
    return launches


def _run_line(torch, port, kd, name: str, spec) -> tuple:
    """One counted run: counters zeroed right before, read right after.
    Prints its JSON line and returns ``(result, launches)``."""
    from repro_torch.tree import tree_leaves
    kd.reset_launch_counts()
    t0 = time.perf_counter()
    res = port.run_experiment(spec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kd.LAUNCHES)
    finite = all(bool(torch.isfinite(x).all())
                 for x in tree_leaves(res.final_params))
    rounds = spec.fl.rounds
    print(json.dumps({
        "run": name, "executor": res.engine.mode, "rounds": rounds,
        "peak_accuracy": max(res.accuracy), "accuracy": res.accuracy,
        "ledger": res.ledger.as_dict(),
        "diffusion_rounds": res.diffusion_rounds,
        "mean_round_wall_s": sum(res.round_wall_s) / rounds,
        "round_wall_s": res.round_wall_s,
        "planner_s_per_round": res.planner_stats.get("seconds", 0.0)
        / max(res.planner_stats.get("plans", 0), 1),
        "run_wall_s": wall, "launches": counts, "finite": finite}))
    if not finite:
        _fail(f"{name}: non-finite parameters")
    return res, counts


def host_plane_path(torch, kd, port) -> dict:
    """Phase 3b: the host plane (``executor="host"``, the reference's
    default) through run_experiment on the card — the quickstart pair,
    two rounds of the STC arms and of the other four strategies, gossip and
    TT-HF on both planes, and int8 hops.  Checks: finite params; FedDif's
    peak accuracy beats FedAvg's; on the host plane ``stc_fused`` launches
    once per compressed leaf (per hop for feddif_stc, per uplink for stc,
    as the ledger counts them; every fcn leaf fits N_FUSED), and
    ``stc_reduce``, ``stc_apply``, ``stc_rows_*``, ``mix_tree`` and
    ``mix_aggregate`` never (MixOps and Eq. 11 are plain tensor ops
    there); on the fleet plane ``mix_tree`` launches once per MixOp plus
    once per round and ``mix_aggregate`` never;
    int8 hops launch ``quant_roundtrip`` once per PermuteOp (every slot and
    the move in one launch) and ``quant_pack`` / ``quant_unpack`` never."""
    from repro_torch.tree import tree_leaves
    FLConfig, ExperimentSpec = port.FLConfig, port.ExperimentSpec
    launches = {name: 0 for name in kd.LAUNCHES}
    leaves = len(tree_leaves(port.build_task_model("fcn").init(
        torch.Generator())))

    def spec(strategy, rounds, executor="host", **kw):
        return ExperimentSpec(task="fcn", alpha=0.3, num_samples=6000,
                              fl=FLConfig(strategy=strategy, rounds=rounds,
                                          num_clients=8, num_models=8,
                                          epsilon=0.04, gamma_min=1.0, seed=0,
                                          executor=executor, **kw))

    # One untimed host-plane round first (the stc_compress library's load,
    # the eager step's first call).
    port.run_experiment(ExperimentSpec(
        task="fcn", alpha=0.3, num_samples=1200, fl=FLConfig(
            strategy="feddif_stc", rounds=1, num_clients=4, num_models=4,
            seed=1, executor="host")))
    runs = [(f"{st}/fcn host", spec(st, r)) for st, r in HOST_QUICKSTART]
    runs += [(f"{st}/fcn host", spec(st, 2)) for st in HOST_TWO_ROUND]
    for st, r in MIX_RUNS:
        runs += [(f"{st}/fcn {ex}", spec(st, r, ex))
                 for ex in ("host", "fleet")]
    runs.append(("feddif/fcn host hop_quant=int8",
                 spec("feddif", 2, hop_quant="int8")))
    peak = {}
    for name, sp in runs:
        res, counts = _run_line(torch, port, kd, name, sp)
        led, st, host = res.ledger.as_dict(), sp.fl.strategy, \
            res.engine.mode == "host"
        compressions = 0
        if st == "stc":
            compressions = led["uplink_models"] * leaves
        elif st == "feddif_stc":
            compressions = (led["transmitted_models"]
                            - led["uplink_models"]) * leaves
        # Every fcn leaf fits N_FUSED: one stc_fused launch per compressed
        # leaf, and the reduce / apply chain never.
        if counts["stc_fused"] != compressions or counts["stc_reduce"] or \
                counts["stc_apply"]:
            _fail(f"{name}: stc_fused / stc_reduce / stc_apply launched "
                  f"{counts['stc_fused']} / {counts['stc_reduce']} / "
                  f"{counts['stc_apply']} times, the schedules imply "
                  f"{compressions} / 0 / 0")
        if "stc" in st and compressions == 0:
            _fail(f"{name}: no STC compression was driven")
        mixes = sum(1 + (st == "tthf" and (t + 1) % 4 == 0)
                    for t in range(sp.fl.rounds)) if st in dict(MIX_RUNS) \
            else 0
        want_mix = 0 if host else mixes + sp.fl.rounds
        if counts["mix_tree"] != want_mix or counts["mix_aggregate"]:
            _fail(f"{name}: mix_tree / mix_aggregate launched "
                  f"{counts['mix_tree']} / {counts['mix_aggregate']} times, "
                  f"want {want_mix} / 0")
        if (counts["stc_rows_reduce"] or counts["stc_rows_apply"]
                or counts["stc_rows_fused"]):
            _fail(f"{name}: the fleet plane's stc_rows kernels launched")
        # One quant_roundtrip launch per PermuteOp, all 8 slots and the
        # move in it; the standalone pack / unpack never.
        want_q = (sum(res.diffusion_rounds)
                  if sp.fl.hop_quant == "int8" else 0)
        if (counts["quant_roundtrip"] != want_q or counts["quant_pack"]
                or counts["quant_unpack"]):
            _fail(f"{name}: quant_roundtrip / quant_pack / quant_unpack "
                  f"launched {counts['quant_roundtrip']} / "
                  f"{counts['quant_pack']} / {counts['quant_unpack']} times, "
                  f"want {want_q} / 0 / 0")
        if want_q == 0 and sp.fl.hop_quant == "int8":
            _fail(f"{name}: no diffusion round, so no int8 hop was driven")
        for k in launches:
            launches[k] += counts[k]
        peak[name] = max(res.accuracy)
    fedavg, feddif = peak["fedavg/fcn host"], peak["feddif/fcn host"]
    print(json.dumps({"host_quickstart_peak_accuracy": {
        "fedavg/fcn host": fedavg, "feddif/fcn host": feddif}}))
    if not feddif > fedavg:
        _fail(f"host plane: FedDif peak accuracy {feddif} does not beat "
              f"FedAvg {fedavg}")
    return launches


def stc_routing(torch, kd) -> dict:
    """Phase 3c, the host plane's STC entry point
    (``fl.compression.stc_compress``, what the host executor calls per
    slot) on a delta tree with leaves on both sides of N_FUSED: every leaf
    of n ≤ N_FUSED must take one ``stc_fused`` launch, every larger leaf
    the ``stc_threshold`` + ``stc_reduce`` + ``stc_apply`` chain, and each
    leaf must equal the plain STC's support.  No FL task here has a leaf
    past N_FUSED, so this is where the chain's kernels run on a path; its
    launches are returned apart from the main path's."""
    from repro_torch.fl.compression import stc_compress
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.stc_compress import N_FUSED
    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = (10, 16384, N_FUSED, N_FUSED + 1, 2 ** 24)
    tree = {f"w{n}": _stc_tie_free(torch, gen, n) for n in sizes}
    kd.reset_launch_counts()
    out = stc_compress(tree, STC_SPARSITY)
    torch.cuda.synchronize()
    counts = dict(kd.LAUNCHES)
    fused = sum(n <= N_FUSED for n in sizes)
    support = all(bool(torch.equal(out[key] != 0, kref.stc_compress_ref(
        x, STC_SPARSITY) != 0)) for key, x in tree.items())
    row = {"check": "host-plane STC routing", "leaves": list(sizes),
           "n_fused": N_FUSED, "launches": {k: counts[k] for k in (
               "stc_fused", "stc_reduce", "stc_apply")},
           "same_support_as_exact_k": support}
    row["ok"] = bool(support and counts["stc_fused"] == fused
                     and counts["stc_reduce"] == counts["stc_apply"]
                     == len(sizes) - fused)
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"host-plane STC routing: {json.dumps(row)}")
    return counts


def stc_rows_routing(torch, kd) -> dict:
    """Phase 3c, the fleet plane's STC entry point (``ops.stc_topk``, what
    ``fedshard.masked_stc_compress`` calls per leaf) on (8, n) leaves on
    both sides of N_FUSED, every other row masked: every leaf of rows of
    n ≤ N_FUSED must take one ``stc_rows_fused`` launch, the larger one the
    ``stc_rows_threshold`` + ``stc_rows_reduce`` + ``stc_rows_apply``
    chain, and each leaf must equal the plain STC's support.  No FL task
    here has a leaf past N_FUSED, so this is where the chain's kernels run
    on a path; its launches are returned apart from the main path's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels.stc_compress import N_FUSED
    gen = torch.Generator(device="cuda").manual_seed(4)
    sizes = (10, 16384, N_FUSED, N_FUSED + 1)
    leaves = {n: _stc_rows_tie_free(torch, gen, 8, n) for n in sizes}
    mask32 = (torch.arange(8, device="cuda") % 2 == 0).to(torch.int32)
    kd.reset_launch_counts()
    outs = {n: ops.stc_topk(x, r, mask32, STC_SPARSITY)
            for n, (x, r) in leaves.items()}
    torch.cuda.synchronize()
    counts = dict(kd.LAUNCHES)
    fused = sum(n <= N_FUSED for n in sizes)
    support = all(bool(torch.equal(
        outs[n] != r, kref.stc_rows_ref(x, r, mask32, STC_SPARSITY) != r))
        for n, (x, r) in leaves.items())
    row = {"check": "fleet-plane STC routing", "leaves": [[8, n]
                                                          for n in sizes],
           "n_fused": N_FUSED, "launches": {k: counts[k] for k in (
               "stc_rows_fused", "stc_rows_reduce", "stc_rows_apply")},
           "same_support_as_exact_k": support}
    row["ok"] = bool(support and counts["stc_rows_fused"] == fused
                     and counts["stc_rows_reduce"]
                     == counts["stc_rows_apply"] == len(sizes) - fused)
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"fleet-plane STC routing: {json.dumps(row)}")
    return counts


def quant_routing(torch, kd) -> dict:
    """Phase 3c, the standalone int8 wire (``fl.adapters.pack_rows`` /
    ``unpack_rows``, what a plane that sends the codes themselves calls) on
    a card tensor of the fcn fleet's shape, (8, 26122): one ``quant_pack``
    and one ``quant_unpack`` launch, codes, scales and decoded rows equal
    to the plain versions bit for bit.  No FL path runs them since
    ``quant_roundtrip`` took the hop; their launches are returned apart
    from the main path's."""
    from repro_torch.fl.adapters import pack_rows, unpack_rows
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = _quant_rows(torch, gen, 8, 26122)
    kd.reset_launch_counts()
    q, sc = pack_rows(flat)
    out = unpack_rows(q, sc, flat.shape[1])
    torch.cuda.synchronize()
    counts = dict(kd.LAUNCHES)
    cpu = flat.cpu()
    p_q, p_sc = pack_rows(cpu)
    same = (bool(torch.equal(q.cpu(), p_q))
            and bool(torch.equal(sc.cpu().view(torch.int32),
                                 p_sc.view(torch.int32)))
            and bool(torch.equal(out.cpu().view(torch.int32), unpack_rows(
                p_q, p_sc, flat.shape[1]).view(torch.int32))))
    row = {"check": "quant routing", "shape": list(flat.shape),
           "launches": {k: counts[k] for k in ("quant_pack", "quant_unpack",
                                               "quant_roundtrip")},
           "bit_equal_to_plain": same}
    row["ok"] = bool(same and counts["quant_pack"] == counts["quant_unpack"]
                     == 1 and counts["quant_roundtrip"] == 0)
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"quant routing: {json.dumps(row)}")
    return counts


def bid_routing(torch, kd) -> dict:
    """Phase 3c, the standalone bid ops (``ops.dol_bid_scores`` and
    ``ops.bid_value_fuse``) on card tensors of the main path's (8, 8, 10):
    one ``dol_bid_scores`` and one ``bid_value_fuse`` launch, no
    ``bid_fused``; the distances within 2e-5 of ``dol_bid_scores_fused_ref``
    and the fused bids bit-equal to ``bid_value_fuse_ref``.  No planner
    path runs them since ``bid_fused`` took the bid round; their launches
    are returned apart from the main path's."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    gen = torch.Generator(device="cuda").manual_seed(6)
    m = n = DEVICE_PLANNER_RUN[3]
    args = _bid_inputs(torch, gen, m, n, NUM_CLASSES)
    value = torch.rand((n,), generator=gen, device="cuda")
    kd.reset_launch_counts()
    cand = ops.dol_bid_scores(*args)
    fused = ops.bid_value_fuse(-cand, value, VALUE_WEIGHT)
    torch.cuda.synchronize()
    counts = dict(kd.LAUNCHES)
    err = float((cand - kref.dol_bid_scores_fused_ref(*args)).abs().max())
    same = bool(torch.equal(
        fused.view(torch.int32),
        kref.bid_value_fuse_ref(-cand, value, VALUE_WEIGHT).view(
            torch.int32)))
    row = {"check": "bid routing", "shape": [m, n, NUM_CLASSES],
           "launches": {k: counts[k] for k in ("dol_bid_scores",
                                               "bid_value_fuse",
                                               "bid_fused")},
           "dol_bid_scores_max_abs_err": err, "tol": 2e-5,
           "bid_value_fuse_bit_equal_to_plain": same}
    row["ok"] = bool(err <= 2e-5 and same and counts["dol_bid_scores"]
                     == counts["bid_value_fuse"] == 1
                     and counts["bid_fused"] == 0)
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"bid routing: {json.dumps(row)}")
    return counts


def _planner_case(planner, case: str, n: int, data_seed: int,
                  chan_seed: int):
    """One plan of the planner checks (PLANNER_CASES) by ``planner``, from
    the same inputs whatever the planner: the default-config inputs of
    tests/test_planner_jax.py, or a planner_speedup cell of
    benchmarks/run.py."""
    import numpy as np
    from repro_torch.channels.topology import CellTopology
    from repro_torch.core.dol import DiffusionState
    c = NUM_CLASSES
    rng = np.random.default_rng(data_seed)
    dsi = rng.dirichlet(np.ones(c) * 0.5, n).astype(np.float32)
    sizes = rng.integers(200, 800, n).astype(np.float64)
    state = DiffusionState.init(n, n, c)
    for mi in range(n):
        state.record_training(mi, mi % n, dsi[mi % n], float(sizes[mi % n]))
    if case == "default_config":
        pos = CellTopology().sample_positions(
            np.random.default_rng(chan_seed + 50), n)
        plan_rng = np.random.default_rng(chan_seed + 7)
    else:
        plan_rng = np.random.default_rng([data_seed, chan_seed])
        pos = planner.topology.sample_positions(plan_rng, n)
    return planner.plan_communication_round(state, dsi, sizes, plan_rng,
                                            positions=pos)


def _plan_diff(torch, a: list, b: list) -> str | None:
    """Two runs' device-planner outputs (``PlanOutputs``, one per plan)
    against each other: None where they have the same rounds, hops and
    ``scheduled`` and bit-equal ``decrement``, ``weight`` and
    ``efficiency``, else the first difference."""
    if len(a) != len(b) or not a:
        return f"{len(a)} plans against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if (x.num_rounds, x.converged) != (y.num_rounds, y.converged):
            return f"plan {i}: rounds / converged differ"
        for k in ("dst", "src", "scheduled", "decrement", "weight",
                  "efficiency"):
            u, v = getattr(x, k), getattr(y, k)
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            if not torch.equal(u, v):
                return f"plan {i}: {k} differs"
    return None


def _planner_arms(torch, run) -> tuple[dict, dict, dict]:
    """``run()`` twice on the card: as shipped (``ops.bid_fused``, one
    launch per bid round) and with the bid round put back to
    ``_old_bid_chain``, patched here, not a knob of the package.  Returns
    each arm's result, its device-planner outputs and its bid launches."""
    import repro_torch.core.planner as planner_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
    shipped, plan_rounds = ops.bid_fused, planner_mod._plan_rounds
    res, plans, counts = {}, {}, {}
    for arm in ("shipped", "old_chain"):
        plans[arm] = []

        def recording(*args, _out=plans[arm], **kw):
            out = plan_rounds(*args, **kw)
            _out.append(out)
            return out
        planner_mod._plan_rounds = recording
        if arm == "old_chain":
            ops.bid_fused = _old_bid_chain
        try:
            reset_launch_counts()
            res[arm] = run()
            torch.cuda.synchronize()
            counts[arm] = {k: LAUNCHES[k] for k in (
                "bid_fused", "dol_bid_scores", "bid_value_fuse")}
        finally:
            ops.bid_fused, planner_mod._plan_rounds = shipped, plan_rounds
    return res, plans, counts


def bid_chain_parity(torch, port) -> None:
    """Phase 4: the device planner as shipped against the bid round put
    back to the chain ``bid_fused`` replaced (``_planner_arms``), on the
    quickstart device-planner run (learning-value bids; equal ledgers and
    bit-equal final params too) and on every plan of PLANNER_CASES (no
    value): identical plans (``_plan_diff``)."""
    from repro_torch.core.diffusion import DiffusionPlanner
    from repro_torch.tree import tree_leaves
    strategy, task, rounds, clients = DEVICE_PLANNER_RUN
    spec = port.ExperimentSpec(
        task=task, alpha=0.3, num_samples=6000,
        fl=port.FLConfig(executor="fleet", strategy=strategy, rounds=rounds,
                         num_clients=clients, num_models=clients,
                         epsilon=0.04, gamma_min=1.0, seed=0, planner="jax",
                         uncertainty_weight=VALUE_WEIGHT))
    res, plans, counts = _planner_arms(torch,
                                       lambda: port.run_experiment(spec))
    a, b = res["shipped"], res["old_chain"]
    row = {"check": f"bid_fused vs the old chain, {strategy}/{task} "
                    f"planner=jax w={VALUE_WEIGHT}",
           "plans": len(plans["shipped"]),
           "plan_diff": _plan_diff(torch, plans["shipped"],
                                   plans["old_chain"]),
           "ledgers_equal": a.ledger.as_dict() == b.ledger.as_dict(),
           "final_params_bit_equal": all(
               bool(torch.equal(x.view(torch.int32), y.view(torch.int32)))
               for x, y in zip(tree_leaves(a.final_params),
                               tree_leaves(b.final_params))),
           "diffusion_rounds": a.diffusion_rounds, "launches": counts}
    row["ok"] = bool(row["plan_diff"] is None and row["ledgers_equal"]
                     and row["final_params_bit_equal"]
                     and counts["shipped"]["bid_fused"] > 0
                     and counts["shipped"]["dol_bid_scores"] == 0
                     and counts["old_chain"]["bid_fused"] == 0
                     and counts["old_chain"]["bid_value_fuse"]
                     == counts["shipped"]["bid_fused"])
    print(json.dumps(row))
    if not row["ok"]:
        _fail(f"bid_fused vs the old chain: {json.dumps(row)}")
    for case, n, max_rounds, seeds in PLANNER_CASES:
        planner = DiffusionPlanner(epsilon=0.04, max_rounds=max_rounds,
                                   mode="jax", device="cuda")
        _, plans, counts = _planner_arms(torch, lambda: [
            _planner_case(planner, case, n, *seed) for seed in seeds])
        row = {"check": f"bid_fused vs the old chain, planner {case}",
               "clients": n, "plans": len(plans["shipped"]),
               "plan_diff": _plan_diff(torch, plans["shipped"],
                                       plans["old_chain"]),
               "launches": counts}
        row["ok"] = bool(row["plan_diff"] is None
                         and len(plans["shipped"]) == len(seeds)
                         and counts["shipped"]["bid_fused"]
                         == counts["old_chain"]["dol_bid_scores"] > 0
                         and counts["old_chain"]["bid_fused"] == 0)
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"bid_fused vs the old chain, {case}: {json.dumps(row)}")


def mix_chain_parity(torch, port) -> None:
    """Phase 4: the fleet plane's FedDif quickstart run, gossip (2 rounds),
    tthf (4 rounds) and the lm_hops full fp32 arm, each run twice on the
    card: as shipped (one ``mix_tree`` launch per MixOp and per round) and
    with ``ops.mix_aggregate_tree`` put back to the chain it replaced
    (``_old_mix_chain``: ravel, the flat ``mix_aggregate`` kernel,
    unravel), patched here, not a knob of the package.  Ledgers must be
    equal and final params bit-equal."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
    FLConfig, ExperimentSpec = port.FLConfig, port.ExperimentSpec

    def fcn(strategy, rounds):
        return ExperimentSpec(task="fcn", alpha=0.3, num_samples=6000,
                              fl=FLConfig(executor="fleet", strategy=strategy,
                                          rounds=rounds, num_clients=8,
                                          num_models=8, epsilon=0.04,
                                          gamma_min=1.0, seed=0))
    cells = [("feddif/fcn", fcn("feddif", 8))]
    cells += [(f"{st}/fcn", fcn(st, r)) for st, r in MIX_RUNS]
    cells.append(("feddif/lm full_f32", ExperimentSpec(
        **LM_DATA, adapter_hops=False, fl=FLConfig(**LM_FL))))
    shipped = ops.mix_aggregate_tree
    for name, spec in cells:
        res, counts = {}, {}
        for arm in ("shipped", "old_chain"):
            if arm == "old_chain":
                ops.mix_aggregate_tree = _old_mix_chain
            try:
                reset_launch_counts()
                res[arm] = port.run_experiment(spec)
                torch.cuda.synchronize()
                counts[arm] = {k: LAUNCHES[k]
                               for k in ("mix_tree", "mix_aggregate")}
            finally:
                ops.mix_aggregate_tree = shipped
        a, b = res["shipped"], res["old_chain"]
        row = {"check": f"mix_tree vs the old chain, {name}",
               "ledgers_equal": a.ledger.as_dict() == b.ledger.as_dict(),
               "final_params_bit_equal": _bits_equal(torch, a.final_params,
                                                     b.final_params),
               "launches": counts, "accuracy": [a.accuracy, b.accuracy]}
        calls = counts["shipped"]["mix_tree"]
        row["ok"] = bool(row["ledgers_equal"]
                         and row["final_params_bit_equal"]
                         and calls >= spec.fl.rounds
                         and counts["shipped"]["mix_aggregate"] == 0
                         and counts["old_chain"]["mix_tree"] == 0
                         and counts["old_chain"]["mix_aggregate"] == calls)
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"mix_tree vs the old chain, {name}: {json.dumps(row)}")


def old_chain_parity(torch, port) -> None:
    """Phase 4: the lm_hops adapter_int8 arm (fleet plane) and feddif/fcn
    with int8 hops on the host plane, each run twice on the card: as
    shipped (one ``quant_roundtrip`` launch per PermuteOp) and with the
    executors' hop put back to the chain it replaced (``_old_tree_hop`` /
    ``_old_slots_hop``: ``quant_pack`` and ``quant_unpack`` around PyTorch's
    cat, pad, slices and gather), patched here, not a knob of the package.
    Ledgers must be equal and final params bit-equal.  Then the same for
    the bid round (``bid_chain_parity``) and Eq. 10/11
    (``mix_chain_parity``)."""
    import repro_torch.fl.executors as executors
    from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
    from repro_torch.tree import tree_leaves
    FLConfig, ExperimentSpec = port.FLConfig, port.ExperimentSpec
    cells = [("feddif/lm adapter_int8", ExperimentSpec(
        **LM_DATA, adapter_hops=True, fl=FLConfig(**LM_FL, hop_quant="int8"))),
        ("feddif/fcn host hop_quant=int8", ExperimentSpec(
            task="fcn", alpha=0.3, num_samples=6000, fl=FLConfig(
                strategy="feddif", rounds=2, num_clients=8, num_models=8,
                epsilon=0.04, gamma_min=1.0, seed=0, executor="host",
                hop_quant="int8")))]
    shipped = (executors.quant_roundtrip_tree, executors.quant_roundtrip_slots)
    for name, spec in cells:
        res, counts = {}, {}
        for arm in ("shipped", "old_chain"):
            if arm == "old_chain":
                executors.quant_roundtrip_tree = _old_tree_hop
                executors.quant_roundtrip_slots = _old_slots_hop
            try:
                reset_launch_counts()
                res[arm] = port.run_experiment(spec)
                torch.cuda.synchronize()
                counts[arm] = {k: LAUNCHES[k] for k in (
                    "quant_roundtrip", "quant_pack", "quant_unpack")}
            finally:
                (executors.quant_roundtrip_tree,
                 executors.quant_roundtrip_slots) = shipped
        a, b = res["shipped"], res["old_chain"]
        bit_equal = all(bool(torch.equal(x.view(torch.int32),
                                         y.view(torch.int32)))
                        for x, y in zip(tree_leaves(a.final_params),
                                        tree_leaves(b.final_params)))
        hops = sum(a.diffusion_rounds)
        row = {"check": f"quant_roundtrip vs the old chain, {name}",
               "ledgers_equal": a.ledger.as_dict() == b.ledger.as_dict(),
               "final_params_bit_equal": bit_equal,
               "diffusion_rounds": a.diffusion_rounds, "launches": counts,
               "loss": [a.loss, b.loss]}
        row["ok"] = bool(row["ledgers_equal"] and bit_equal and hops > 0
                         and counts["shipped"]["quant_roundtrip"] == hops
                         and counts["old_chain"]["quant_roundtrip"] == 0
                         and counts["old_chain"]["quant_pack"] > 0)
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"quant_roundtrip vs the old chain, {name}: "
                  f"{json.dumps(row)}")
    bid_chain_parity(torch, port)
    mix_chain_parity(torch, port)


def host_vs_fleet(torch, port) -> None:
    """Phase 4: the port's two planes on the card from one init — FedDif,
    fcn, N=M=8, 2 rounds: equal ledgers and diffusion rounds, params within
    the reference's own host-vs-fleet bar (atol 2e-4, rtol 2e-3)."""
    from repro_torch.tree import tree_leaves
    strategy, task, rounds, clients = HOST_VS_FLEET_RUN
    init = port.params_to_numpy(port.build_task_model(task).init(
        torch.Generator().manual_seed(0)))
    res = {}
    for ex in ("host", "fleet"):
        res[ex] = port.run_experiment(
            port.ExperimentSpec(
                task=task, alpha=0.3, num_samples=6000,
                fl=port.FLConfig(strategy=strategy, rounds=rounds,
                                 num_clients=clients, num_models=clients,
                                 seed=0, topology_seed=3, executor=ex)),
            init_fn=lambda g: port.params_from_numpy(init))
    host, fleet = res["host"], res["fleet"]
    if host.ledger.as_dict() != fleet.ledger.as_dict():
        _fail("host and fleet planes charge different ledgers")
    if host.diffusion_rounds != fleet.diffusion_rounds:
        _fail("host and fleet planes plan different diffusion rounds")
    err = 0.0
    for a, b in zip(tree_leaves(host.final_params),
                    tree_leaves(fleet.final_params)):
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=2e-4, rtol=2e-3):
            _fail(f"host and fleet planes' params differ by {err}")
    print(json.dumps({"check": f"host_vs_fleet {strategy}/{task}",
                      "max_abs_err": err, "atol": 2e-4, "rtol": 2e-3,
                      "diffusion_rounds": host.diffusion_rounds,
                      "accuracy": [host.accuracy, fleet.accuracy],
                      "round_wall_s": [host.round_wall_s,
                                       fleet.round_wall_s]}))


def card_vs_cpu(torch, port, executor: str = "fleet") -> None:
    """Phase 4: the kernel path on the card against the plain path on the
    CPU, from one init, on a small feddif_stc run on one data plane (the
    fleet plane's ``stc_rows_fused``, or the host plane's ``stc_fused``,
    each launched once per compressed leaf)."""
    from repro_torch.tree import tree_leaves
    strategy, task, rounds, clients = CARD_VS_CPU_RUN
    spec = port.ExperimentSpec(
        task=task, alpha=0.3, num_samples=1200,
        fl=port.FLConfig(executor=executor, strategy=strategy, rounds=rounds,
                         num_clients=clients, num_models=clients, seed=0,
                         topology_seed=3))
    from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
    model = port.build_task_model(task)
    init = port.params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    reset_launch_counts()
    gpu = port.run_experiment(
        spec, init_fn=lambda g: port.params_from_numpy(init))
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    cpu = port.run_experiment(
        spec, device="cpu", init_fn=lambda g: port.params_from_numpy(init))
    if gpu.ledger.as_dict() != cpu.ledger.as_dict():
        _fail("card and CPU runs charge different ledgers")
    if executor == "fleet":
        want = _fleet_stc_leaves(gpu, strategy, rounds)
        if (counts["stc_rows_fused"] != want or counts["stc_rows_reduce"]
                or counts["stc_rows_apply"] or want == 0):
            _fail(f"card_vs_cpu fleet: stc_rows_fused / stc_rows_reduce / "
                  f"stc_rows_apply launched {counts['stc_rows_fused']} / "
                  f"{counts['stc_rows_reduce']} / {counts['stc_rows_apply']} "
                  f"times, want {want} / 0 / 0")
    if executor == "host":
        led = gpu.ledger.as_dict()
        want = (led["transmitted_models"] - led["uplink_models"]) * len(
            tree_leaves(init))
        if (counts["stc_fused"] != want or counts["stc_reduce"]
                or counts["stc_apply"] or want == 0):
            _fail(f"card_vs_cpu host: stc_fused / stc_reduce / stc_apply "
                  f"launched {counts['stc_fused']} / {counts['stc_reduce']} "
                  f"/ {counts['stc_apply']} times, want {want} / 0 / 0")
    err = 0.0
    for a, b in zip(tree_leaves(gpu.final_params),
                    tree_leaves(cpu.final_params)):
        a = a.cpu()
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=2e-4, rtol=2e-3):
            _fail(f"card and CPU params differ by {err}")
    print(json.dumps({"check": f"card_vs_cpu {strategy}/{task}",
                      "executor": executor, "max_abs_err": err,
                      "atol": 2e-4, "rtol": 2e-3,
                      "accuracy": [gpu.accuracy, cpu.accuracy],
                      "launches": {k: v for k, v in counts.items() if v}}))


def lm_card_vs_cpu(torch, port) -> None:
    """Phase 4: the small lm int8 cell on the card (its kernels) against
    the CPU (plain versions) from one init: equal ledgers and diffusion
    rounds, one ``quant_roundtrip`` launch per diffusion round on the card,
    adapters within the reference's cross-executor tolerance (atol 5e-4,
    rtol 5e-3).  Also counts the int8 codes on which packs of the two final
    adapters differ."""
    from repro_torch.fl.adapters import pack_rows
    from repro_torch.kernels.diffusion import stack_ravel
    from repro_torch.tree import tree_leaves, tree_map
    spec = port.ExperimentSpec(**LM_SMALL_DATA,
                               fl=port.FLConfig(**LM_SMALL_FL))
    from repro_torch.kernels.launch import LAUNCHES, reset_launch_counts
    model = port.build_task_model("lm")
    init = port.params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    reset_launch_counts()
    gpu = port.run_experiment(
        spec, init_fn=lambda g: port.params_from_numpy(init))
    torch.cuda.synchronize()
    launched = LAUNCHES["quant_roundtrip"]
    cpu = port.run_experiment(
        spec, device="cpu", init_fn=lambda g: port.params_from_numpy(init))
    if gpu.ledger.as_dict() != cpu.ledger.as_dict():
        _fail("lm int8: card and CPU runs charge different ledgers")
    if launched != sum(gpu.diffusion_rounds) or launched == 0:
        _fail(f"lm int8 card run: quant_roundtrip launched {launched} times "
              f"over {sum(gpu.diffusion_rounds)} diffusion rounds")
    if gpu.diffusion_rounds != cpu.diffusion_rounds:
        _fail("lm int8: card and CPU runs plan different diffusion rounds")
    card = tree_map(lambda x: x.cpu(), gpu.final_params)
    err = 0.0
    for a, b in zip(tree_leaves(card), tree_leaves(cpu.final_params)):
        err = max(err, float((a - b).abs().max()))
        if not torch.allclose(a, b, atol=5e-4, rtol=5e-3):
            _fail(f"lm int8: card and CPU adapters differ by {err}")
    codes = [pack_rows(stack_ravel(tree_map(lambda x: x[None], p))[0])[0]
             for p in (card, cpu.final_params)]
    print(json.dumps({"check": "card_vs_cpu feddif/lm hop_quant=int8",
                      "max_abs_err": err, "atol": 5e-4, "rtol": 5e-3,
                      "final_adapter_code_flips": int(
                          (codes[0] != codes[1]).sum()),
                      "diffusion_rounds": gpu.diffusion_rounds,
                      "accuracy": [gpu.accuracy, cpu.accuracy]}))


def planners_card_vs_cpu(torch) -> None:
    """Phase 4, second half: the device planner on the card (its bids from
    the kernels) against the host planner on the CPU, on the default-config
    inputs of tests/test_planner_jax.py and the planner_speedup cells of
    benchmarks/run.py.  The card's bids differ from the composite's by
    float32 rounding, so plans are held to the reference's equivalence
    rule; exact hop-list agreement is printed beside it."""
    from repro_torch.core.diffusion import DiffusionPlanner
    for case, n, max_rounds, seeds in PLANNER_CASES:
        equal = equivalent = 0
        card_s = host_s = 0.0
        worst = 0.0
        card_planner = DiffusionPlanner(epsilon=0.04, max_rounds=max_rounds,
                                        mode="jax", device="cuda")
        host_planner = DiffusionPlanner(epsilon=0.04, max_rounds=max_rounds)
        for data_seed, chan_seed in seeds:
            plans = []
            for planner in (card_planner, host_planner):
                t0 = time.perf_counter()
                plans.append(_planner_case(planner, case, n, data_seed,
                                           chan_seed))
                if planner is card_planner:
                    card_s += time.perf_counter() - t0
                else:
                    host_s += time.perf_counter() - t0
            card, host = plans
            hops = [[(h.model, h.src, h.dst, h.round_index) for h in p.hops]
                    for p in plans]
            dec = [sum(h.decrement for h in p.hops) for p in plans]
            rel = abs(dec[0] - dec[1]) / max(dec[1], 1e-12)
            worst = max(worst, rel)
            equal += hops[0] == hops[1]
            ok = (card.num_rounds == host.num_rounds
                  and len(card.hops) == len(host.hops) and rel <= 1e-6)
            equivalent += ok
            if not ok:
                _fail(f"planners {case} seed {(data_seed, chan_seed)}: card "
                      f"{card.num_rounds} rounds / {len(card.hops)} hops / "
                      f"decrement {dec[0]} vs CPU host {host.num_rounds} / "
                      f"{len(host.hops)} / {dec[1]}")
        st = card_planner.stats
        print(json.dumps({
            "check": f"device planner (card) vs host planner (CPU), {case}",
            "clients": n, "models": n, "plans": len(seeds),
            "hop_lists_equal": equal, "plans_equivalent": equivalent,
            "max_rel_decrement_diff": worst, "rel_tol": 1e-6,
            "card_planner_s_per_plan": card_s / len(seeds),
            "host_planner_s_per_plan": host_s / len(seeds),
            "auction_iterations_per_plan":
                st["auction_iterations"] / st["plans"],
            "loop_iterations_per_plan": st["loop_iterations"] / st["plans"]
        }))


def profile_round(torch, port, planner: str = "host",
                  weight: float = 0.0, lm_int8: bool = False,
                  executor: str = "fleet", strategy: str = "feddif",
                  hop_quant: str = "none") -> None:
    """Phase 5 (a measurement, not a check): one FedDif round under
    torch.profiler — of the quickstart cell on the fleet plane with the
    host or the device planner or on the host plane (FedDif, with fp32 or
    int8 hops: ``quant_roundtrip`` once per PermuteOp), or feddif_stc on
    either plane (its hops through ``stc_rows_fused`` or ``stc_fused``), or
    gossip on the fleet plane (a MixOp and the aggregation a round, one
    ``mix_tree`` launch each), or of the lm_hops adapter_int8 arm — device
    busy time (the union of kernel
    intervals), idle share of the span from the first to the last kernel,
    kernel count and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    if lm_int8:
        spec = port.ExperimentSpec(**LM_DATA, fl=port.FLConfig(
            **{**LM_FL, "rounds": 1}, hop_quant="int8"))
        label = "feddif/lm adapter_int8 1 round (lm_hops cell)"
    else:
        spec = port.ExperimentSpec(
            task="fcn", alpha=0.3, num_samples=6000,
            fl=port.FLConfig(executor=executor, strategy=strategy, rounds=1,
                             num_clients=8, num_models=8, epsilon=0.04,
                             gamma_min=1.0, seed=0, planner=planner,
                             uncertainty_weight=weight, hop_quant=hop_quant))
        label = (f"{strategy}/fcn 1 round (quickstart cell), {executor} "
                 f"plane, planner={planner} w={weight}"
                 + (f" hop_quant={hop_quant}" if hop_quant != "none" else ""))
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            res = port.run_experiment(spec)
            torch.cuda.synchronize()
        print(json.dumps({
            "profile": label,
            "diffusion_rounds": res.diffusion_rounds,
            "planner_s": res.planner_stats["seconds"],
            "round_wall_s_profiled": res.round_wall_s[0],
            **_trace_summary(torch, prof)}))
    except Exception as exc:            # noqa: BLE001 — reported, not hidden
        print(json.dumps({"profile": "not measured",
                          "error": f"{type(exc).__name__}: {exc}"}))


def _trace_summary(torch, prof) -> dict:
    """Device busy time (the union of kernel intervals), the span from the
    first to the last kernel, the idle share of that span, the kernel count,
    the kernels with the most device time and the device time of each of
    this repository's kernels, from a torch.profiler run."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    ours = {n.split("::")[1].split("(")[0]: t for n, t in by_name.items()
            if "(anonymous namespace)::" in n}
    run_s = spans[-1][1] / 1e6 - spans[0][0] / 1e6 if spans else None
    return {"device_busy_s": busy_us / 1e6,
            "first_to_last_kernel_s": run_s,
            "device_idle_share_of_span": (None if not run_s
                                          else 1.0 - busy_us / 1e6 / run_s),
            "kernel_launches": len(kernels),
            "top_kernels_us": [[n[:80], t] for n, t in top],
            "our_kernels_us": ours}


def _visible_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the attention mask lets through, per (b, h):
    q right-aligned to the end of the keys."""
    total = 0
    for i in range(sq):
        q_pos = i + sk - sq
        hi = min(sk, q_pos + 1) if causal else sk
        lo = max(0, q_pos - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _ssd_flops(b, s, h, p, n, chunk) -> float:
    """Operations of the chunked SSD form on this shape: the lower triangle
    of C·Bᵀ per chunk and batch row, the masked (L, L) product with X, the
    carried state's contribution and the state update (2 flops per FMA)."""
    flops = 0.0
    for t0 in range(0, s, chunk):
        lv = min(chunk, s - t0)
        tri = lv * (lv + 1) / 2
        flops += 2.0 * b * (n * tri + h * p * tri + 2 * h * p * n * lv)
    return flops


def _attn_err(torch, out, plain, dt: str) -> dict:
    """flash_attention's output against its plain version under
    ATTN_BARS[dt]: the max abs error, the largest ratio of an element's
    error to its bar, and the normwise relative error."""
    rel, rel_row, rel_l2 = ATTN_BARS[dt]
    o, p = out.float(), plain.float()
    err = (o - p).abs()
    bar = rel * p.abs() + rel_row * p.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = float(torch.where(err > 0, err / bar.clamp_min(1e-30), 0.0).max())
    l2 = float(torch.linalg.vector_norm(o - p)
               / torch.linalg.vector_norm(p).clamp_min(1e-30))
    return {"max_abs_err": float(err.max()), "bar_ratio": ratio,
            "rel_l2_err": l2, "bars": [rel, rel_row, rel_l2],
            "ok": ratio <= 1.0 and l2 <= rel_l2}


def _attention_tile_dropped(torch, q, k, v, tile: int = 64):
    """Causal attention as the plain version computes it, except that keys
    [Sk/4, Sk/4 + tile) are hidden from the queries past Sq/2: what a kernel
    that skipped one kv tile for those rows would return."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    rows = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    dropped = (rows >= sq // 2) & (k_pos >= sk // 4) & (k_pos < sk // 4 + tile)
    s = s.masked_fill(~(k_pos <= rows + (sk - sq)) | dropped, float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def check_lm_kernels(torch, kref) -> list[dict]:
    """Phase 6a: the zoo's kernels against their plain versions on the card,
    at the prefill runs' shapes, the card-vs-CPU cuts' shapes and a few
    more.  flash_attention is held per element against its row's scale and
    normwise (ATTN_BARS), and at the two prefill shapes a planted fault
    (one kv tile dropped for the rows past S/2) must fail those bars.
    Tolerances of the scans: ssm_scan 1e-6·(1 + max|plain|) (it rounds as
    the plain version does, so it is expected bit-exact); ssd_scan
    SSD_BAR·(1 + max|plain|) (fp32, sums and the cumulative decay in
    another order, every product in 3×TF32; the plain version is within
    3.2e-6·(1 + max|y|) of float64 at S = 4096 on the CPU).  Each
    ssd_scan row also prints ``bound_tc_ms``: the bytes against the
    products as three TF32 passes at the tensor cores' peak."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    def record(row):
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"{row['name']} {row['shape']} disagrees with its plain "
                  f"version beyond its bars: {json.dumps(row)}")
        control = row.get("control_tile_dropped")
        if control is not None and control["ok"]:
            _fail(f"{row['name']} {row['shape']}: the bars did not reject "
                  f"a dropped kv tile: {json.dumps(control)}")
        rows.append(row)

    heavy = dict(inner=5, reps=4, iters=10)
    light = dict(inner=10, reps=5, iters=20)
    # flash_attention: (B, Sq, Sk, H, D, causal, window, dtype).  The bf16
    # qwen3 prefill shape comes first: it is the summary row.  The two
    # prefill shapes also run the planted-fault control.  The last two rows
    # are smollm_360m's full-length shape (H = 15, D = 64: the TMA strides)
    # and a window that is not a multiple of the 128-key tile (its lower
    # edge masked off the diagonal).
    for b, sq, sk, h, d, causal, window, dt in (
            (2, 4096, 4096, 16, 128, True, None, "bfloat16"),  # qwen3
            (1, 4096, 4096, 32, 80, True, None, "bfloat16"),   # zamba2
            (1, 256, 256, 16, 128, True, None, "bfloat16"),    # qwen3 cut
            (1, 256, 256, 32, 80, True, None, "bfloat16"),     # zamba2 cut
            (2, 4096, 4096, 16, 128, True, None, "float32"),
            (1, 1024, 1024, 8, 64, True, 256, "bfloat16"),     # window
            (1, 512, 2048, 8, 80, True, None, "float32"),      # Sq < Sk
            (1, 300, 1000, 4, 64, True, 128, "bfloat16"),      # both, ragged
            (2, 200, 200, 2, 32, False, None, "float32"),      # non-causal
            (1, 200, 700, 4, 80, True, None, "bfloat16"),      # Sq < Sk, D=80
            (2, 100, 100, 2, 128, False, None, "bfloat16"),    # non-causal
            (2, 4096, 4096, 15, 64, True, None, "bfloat16"),   # smollm, odd H
            (1, 4096, 4096, 8, 128, True, 1000, "bfloat16")):  # window 1000
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        out = flash_attention_cuda(q, k, v, **kw)
        plain = kref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        check = _attn_err(torch, out, plain, dt)
        if (b, sq, h, d, dt) in ((2, 4096, 16, 128, "bfloat16"),
                                 (1, 4096, 32, 80, "bfloat16")):
            check["control_tile_dropped"] = _attn_err(
                torch, _attention_tile_dropped(torch, q, k, v), plain, dt)
        pairs = b * h * _visible_pairs(sq, sk, causal, window)
        bound, by = _bound(q.element_size() * 2.0 * h * d * b * (sq + sk),
                           4.0 * d * pairs,
                           BF16_FLOPS_PER_S if dt == "bfloat16"
                           else FP32_FLOPS_PER_S)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window is None and (sq == sk or not causal):
            mask = None
        else:
            q_pos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
            k_pos = torch.arange(sk, device="cuda")[None, :]
            mask = k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
        sizes = heavy if sq * sk >= 2 ** 20 else light
        record({"name": "flash_attention", "shape": [b, sq, sk, h, d],
                "dtype": dt, "causal": causal, "window": window, **check,
                **_timings(torch,
                           lambda: flash_attention_cuda(q, k, v, **kw),
                           lambda: kref.flash_attention_ref(q, k, v, **kw),
                           lambda: F.scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=mask,
                               is_causal=causal and mask is None),
                           **sizes),
                "bound_ms": bound, "bound_by": by, "flops": 4.0 * d * pairs})

    # ssm_scan: falcon's prefill (1, 4096, 8192, 16), its cut, and D·N not
    # a multiple of the 256-thread block.  da in (0, 1) as exp(Δ·A) is.
    for b, s, d, n in ((1, 4096, 8192, 16), (1, 256, 8192, 16),
                       (2, 100, 1000, 16), (1, 37, 3, 5)):
        da = torch.exp(-torch.rand((b, s, d, n), generator=gen,
                                   device="cuda"))
        dbx = 0.1 * torch.randn((b, s, d, n), generator=gen, device="cuda")
        out = ssm_scan_cuda(da, dbx)
        plain = kref.ssm_scan_ref(da, dbx)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        tol = 1e-6 * (1.0 + float(plain.abs().max()))
        bound, by = _bound(12.0 * b * s * d * n, 2.0 * b * s * d * n)
        record({"name": "ssm_scan", "shape": [b, s, d, n],
                "max_abs_err": err, "tol": tol, "ok": err <= tol,
                "bit_exact": bool(torch.equal(out, plain)),
                **_timings(torch, lambda: ssm_scan_cuda(da, dbx),
                           lambda: kref.ssm_scan_ref(da, dbx),
                           **(dict(inner=2, reps=2, iters=3) if s > 1000
                              else light)),
                "bound_ms": bound, "bound_by": by})

    # ssd_scan: SSD_ROWS.  Inputs shaped as the model's streams: Δ =
    # softplus(·), a = −Δ·A with A in [1, 16] by head, x scaled by Δ; at
    # near-unit decay a = −1e-3·U(0.5, 1.5).
    for (b, s, h, p, n, chunk), kind in SSD_ROWS:
        dt_ = F.softplus(0.5 * torch.randn((b, s, h), generator=gen,
                                           device="cuda") - 1.0)
        a = -dt_ * torch.exp(torch.linspace(0.0, 2.772588722, h,
                                            device="cuda"))
        if kind == "near_unit":
            a = -1e-3 * (0.5 + torch.rand((b, s, h), generator=gen,
                                          device="cuda"))
        xh = torch.randn((b, s, h, p), generator=gen,
                         device="cuda") * dt_[..., None]
        bm = F.silu(torch.randn((b, s, n), generator=gen, device="cuda"))
        cm = F.silu(torch.randn((b, s, n), generator=gen, device="cuda"))
        out = ssd_scan_cuda(xh, a, bm, cm, chunk=chunk)
        again = ssd_scan_cuda(xh, a, bm, cm, chunk=chunk)
        plain = kref.ssd_scan_ref(xh, a, bm, cm, chunk)
        torch.cuda.synchronize()
        err = float((out - plain).abs().max())
        tol = SSD_BAR * (1.0 + float(plain.abs().max()))
        same_bits = bool(torch.equal(out, again))
        row = {"name": "ssd_scan", "shape": [b, s, h, p, n, chunk],
               "inputs": kind, "max_abs_err": err, "tol": tol,
               "same_bits": same_bits, "ok": err <= tol and same_bits}
        if kind == "near_unit":
            # The plain stages, and the planted fault: the state entering
            # each chunk applied one chunk late.
            acum, states = kref.ssd_chunk_states_ref(xh, a, bm, chunk)
            entering = kref.ssd_state_pass_ref(states, acum)
            late = torch.cat([torch.zeros_like(entering[:, :1]),
                              entering[:, :-1]], dim=1)
            stages = kref.ssd_chunk_output_ref(xh, acum, bm, cm, entering,
                                               chunk)
            fault = kref.ssd_chunk_output_ref(xh, acum, bm, cm, late, chunk)
            stages_err = float((stages - plain).abs().max())
            fault_err = float((fault - plain).abs().max())
            row["stages_max_abs_err"] = stages_err
            row["ok"] = row["ok"] and stages_err <= tol
            row["control_state_late"] = {"max_abs_err": fault_err,
                                         "ok": fault_err <= tol}
            del acum, states, entering, late, stages, fault
        nbytes = 4.0 * (2 * b * s * h * p + b * s * h + 2 * b * s * n)
        flops = _ssd_flops(b, s, h, p, n, chunk)
        bound, by = _bound(nbytes, flops)
        bound_tc, by_tc = _bound(nbytes, 3.0 * flops, TF32_FLOPS_PER_S)
        row.update(_timings(torch,
                            lambda: ssd_scan_cuda(xh, a, bm, cm, chunk=chunk),
                            lambda: kref.ssd_scan_ref(xh, a, bm, cm, chunk),
                            **(heavy if s >= 1000 else light)))
        row.update({"bound_ms": bound, "bound_by": by,
                    "bound_tc_ms": bound_tc, "bound_tc_by": by_tc,
                    "flops": flops})
        record(row)
        control = row.get("control_state_late")
        if control is not None and control["ok"]:
            _fail(f"ssd_scan {row['shape']}: the bar did not reject the "
                  f"state applied one chunk late: {json.dumps(control)}")
    return rows


def _profile_prefill(torch, step, params, batch, label: str) -> None:
    """One more forward under ``torch.profiler``: its device busy time and
    idle share (a measurement; a failure is printed, not raised)."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        print(json.dumps({"profile": f"prefill {label}",
                          "prefill_s_profiled": wall,
                          **_trace_summary(torch, prof)}))
    except Exception as exc:            # noqa: BLE001 — reported
        print(json.dumps({"profile": "not measured",
                          "error": f"{type(exc).__name__}: {exc}"}))


def zoo_prefill(torch, kd) -> dict:
    """Phase 6b: ``make_prefill_step`` of each full-width config on the
    card, from random params drawn there, under inference_mode.  One
    untimed forward first (cuBLAS handles, first launches), then the
    counters are zeroed, one forward is timed on the host clock (ending in
    a synchronize), and the counters are read: each kernel must have
    launched once per layer that runs it.  The qwen3 run is then profiled.
    Each model is freed, and the garbage collector run, before the next
    run's peak-memory reset (a reference cycle keeps a model's params
    allocated until the collector runs).  Last, zamba2 is built again from
    the same init and one forward profiled."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_leaves
    launches = {name: 0 for name in kd.LAUNCHES}

    def setup(arch):
        cfg = get_config(arch)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        return cfg, model, gen

    for arch, b, s, want in ZOO_RUNS:
        cfg, model, gen = setup(arch)
        step = make_prefill_step(model)
        # An earlier run's params stay allocated until the collector breaks
        # a reference cycle: collect first, so the peak is this run's.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            t0 = time.perf_counter()
            params = model.init(gen)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             generator=gen, device="cuda")}
            step(params, batch)
            torch.cuda.synchronize()
            kd.reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(step(params, batch))
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in kd.LAUNCHES.items() if v}
            peak = torch.cuda.max_memory_allocated()
            n_params = sum(x.numel() for x in tree_leaves(params))
            print(json.dumps({
                "run": f"prefill {arch}", "layers": cfg.num_layers,
                "batch": b, "seq": s, "train_4k_seq":
                    SHAPES["train_4k"].seq_len, "params": n_params,
                "compute_dtype": cfg.compute_dtype, "loss": loss,
                "prefill_s": wall, "tokens_per_s": b * s / wall,
                "init_s": init_s, "peak_memory_gb": peak / 2 ** 30,
                "launches": counts, "want_launches": want}))
            if not math.isfinite(loss):
                _fail(f"prefill {arch}: loss {loss} is not finite")
            if counts != want:
                _fail(f"prefill {arch}: launches {counts}, want {want}")
            for k, v in counts.items():
                launches[k] += v
            if arch == "qwen3_0_6b":
                _profile_prefill(torch, step, params, batch,
                                 f"{arch} B={b} S={s}")
        del params, batch
        torch.cuda.empty_cache()
    arch, b, s, _ = next(r for r in ZOO_RUNS if r[0] == "zamba2_2_7b")
    cfg, model, gen = setup(arch)
    step = make_prefill_step(model)
    with torch.inference_mode():
        params = model.init(gen)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda")}
        step(params, batch)
        torch.cuda.synchronize()
        _profile_prefill(torch, step, params, batch, f"{arch} B={b} S={s}")
    del params, batch
    torch.cuda.empty_cache()
    return launches


def _one_step_late(torch, op):
    """A wrong variant of a sequence op (output sequence on axis 1): its
    output one position late, zeros at the first, as an off-by-one in a
    kernel's position index would give."""
    def wrong(*args, **kw):
        out = op(*args, **kw)
        return torch.cat([torch.zeros_like(out[:, :1]), out[:, :-1]], dim=1)
    return wrong


def _halves_apart(torch, op):
    """A wrong variant of a sequence op (every argument has the sequence on
    axis 1): the two halves of the sequence run apart, so the second half
    loses the first half's context, as a kernel that dropped its carried
    state or its earlier kv tiles at S/2 would."""
    def wrong(*args, **kw):
        m = args[0].shape[1] // 2
        return torch.cat([op(*(x[:, :m].contiguous() for x in args), **kw),
                          op(*(x[:, m:].contiguous() for x in args), **kw)],
                         dim=1)
    return wrong


def _hidden_check(got, want, bars: dict) -> dict:
    """A run's (final hidden states, loss) against the CPU's under one
    entry of ZOO_BARS."""
    (h, loss), (h_ref, loss_ref) = got, want
    err = (h - h_ref).abs()
    rel_l2 = float((h - h_ref).norm() / h_ref.norm())
    loss_err = abs(loss - loss_ref)
    return {"loss_abs_err": loss_err, "hidden_rel_l2_err": rel_l2,
            "hidden_max_abs_err": float(err.max()),
            "hidden_mean_abs_err": float(err.mean()),
            "ok": (loss_err <= bars["loss_abs"]
                   and rel_l2 <= bars["hidden_rel_l2"]
                   and float(err.max()) <= bars["hidden_max_abs"])}


def zoo_card_vs_cpu(torch) -> None:
    """Phase 6c: a 2-layer cut of each full-width config (B = 1, S = 256)
    on the card (its kernels) against the CPU (plain versions), from one
    init drawn on the card, in the config's bf16 compute and in fp32
    compute (where card and CPU differ only by fp32 sum orders): the
    prefill loss and the final hidden states within ZOO_BARS.  Then two
    controls on the card with the family's kernel op (ZOO_CONTROL_OP)
    swapped for a wrong variant: its output one step late, and its
    sequence halves run apart.  The bars must reject the controls named in
    CONTROLS_REJECTED; the others' readings are printed (in bf16 a Mamba
    state dropped at S/2 fades within a few steps, below the bf16 noise of
    the final hidden states)."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_map
    for (arch, extra), dtype in itertools.product(ZOO_CUTS, ZOO_BARS):
        cfg = dataclasses.replace(get_config(arch), num_layers=2,
                                  compute_dtype=dtype, **extra)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        op = ZOO_CONTROL_OP[arch]
        out = {}
        with torch.inference_mode():
            params = model.init(gen)
            tokens = torch.randint(0, cfg.vocab_size, (1, ZOO_CUT_SEQ),
                                   generator=gen, device="cuda")
            variants = {"card": getattr(ops, op), "cpu": getattr(ops, op),
                        "one_step_late": _one_step_late(torch, getattr(ops, op)),
                        "halves_apart": _halves_apart(torch, getattr(ops, op))}
            for where, variant in variants.items():
                p = params if where != "cpu" else tree_map(
                    lambda x: x.cpu(), params)
                t = tokens if where != "cpu" else tokens.cpu()
                batch = {"tokens": t, "labels": torch.roll(t, -1, dims=1)}
                with mock.patch.object(ops, op, variant):
                    x = tf._embed_inputs(p, cfg, batch)
                    pos = torch.arange(ZOO_CUT_SEQ, device=t.device)[None]
                    hidden, _ = tf.forward_hidden(p, cfg, x, pos)
                    loss = float(make_prefill_step(model)(p, batch))
                out[where] = (hidden.float().cpu(), loss)
        bars = ZOO_BARS[dtype]
        check = _hidden_check(out["card"], out["cpu"], bars)
        controls = {name: {**_hidden_check(out[name], out["cpu"], bars),
                           "must_fail": name in CONTROLS_REJECTED[dtype]}
                    for name in ("one_step_late", "halves_apart")}
        print(json.dumps({
            "check": f"card_vs_cpu prefill {arch} 2-layer cut {dtype}",
            "plan": [[list(k), c] for k, c in tf.build_plan(cfg)],
            "loss": [out["card"][1], out["cpu"][1]], "bars": bars,
            **check, "control_op": op, "controls": controls}))
        if not check["ok"]:
            _fail(f"card_vs_cpu prefill {arch} {dtype}: card and CPU "
                  f"disagree")
        for name, c in controls.items():
            if c["must_fail"] and c["ok"]:
                _fail(f"card_vs_cpu prefill {arch} {dtype}: the bars did "
                      f"not reject the control {name} of {op}")
        del params
        torch.cuda.empty_cache()


def zoo_full_depth(torch) -> None:
    """Phase 6d: zamba2_2_7b at full width and full depth (FULL_DEPTH: 54
    mamba2 layers and 9 shared attention blocks, B = 1, S = 4096) from one
    init (zoo_prefill's: seed 0, params then tokens), twice: through the
    ssd_scan kernels, and with ``ops.ssd_scan`` swapped for its plain
    version by ``mock.patch``, as the controls are.  In fp32 compute the
    two losses must agree within ZOO_BARS["float32"]["loss_abs"], and the
    final hidden states' errors are printed.  In the config's bf16 both
    losses are printed beside FULL_DEPTH_BF16_LOSS_OF_RECORD: their
    difference is what a change of fp32 sum order inside ssd_scan alone
    moves the bf16 loss."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as kref
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    arch, b, s = FULL_DEPTH

    def plain(xh, a, bmat, cmat, *, chunk=128):
        return kref.ssd_scan_ref(xh, a, bmat, cmat, chunk)

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(arch), compute_dtype=dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        out = {}
        with torch.inference_mode():
            params = model.init(gen)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             generator=gen, device="cuda")}
            pos = torch.arange(s, device="cuda")[None]
            for name, op in (("kernel", ops.ssd_scan), ("plain", plain)):
                with mock.patch.object(ops, "ssd_scan", op):
                    loss = float(make_prefill_step(model)(params, batch))
                    x = tf._embed_inputs(params, cfg, batch)
                    hidden, _ = tf.forward_hidden(params, cfg, x, pos)
                out[name] = (hidden.float(), loss)
                del x, hidden
        (h_k, loss_k), (h_p, loss_p) = out["kernel"], out["plain"]
        rel_l2 = float((h_k - h_p).norm() / h_p.norm())
        line = {"check": f"full_depth {arch} {dtype}",
                "layers": cfg.num_layers, "batch": b, "seq": s,
                "loss_kernel": loss_k, "loss_plain": loss_p,
                "loss_abs_err": abs(loss_k - loss_p),
                "hidden_rel_l2_err": rel_l2,
                "hidden_max_abs_err": float((h_k - h_p).abs().max()),
                "hidden_max_abs": float(h_p.abs().max())}
        if dtype == "float32":
            line["loss_abs_bar"] = ZOO_BARS["float32"]["loss_abs"]
            line["ok"] = (math.isfinite(loss_k)
                          and line["loss_abs_err"] <= line["loss_abs_bar"])
        else:
            record = FULL_DEPTH_BF16_LOSS_OF_RECORD
            line["loss_of_record"] = record
            line["loss_kernel_minus_record"] = loss_k - record
            line["loss_plain_minus_record"] = loss_p - record
            line["ok"] = math.isfinite(loss_k)
        print(json.dumps(line))
        if not line["ok"]:
            _fail(f"full_depth {arch} {dtype}: kernel and plain disagree: "
                  f"{json.dumps(line)}")
        del params, batch, out, h_k, h_p
        torch.cuda.empty_cache()


class _ObservedRuns:
    """Wraps the orchestrator's ``run_experiment`` to count the runs and
    record whether each run's final params are finite (the artifact holds
    no params); the runs themselves are unchanged."""

    def __init__(self, torch, port):
        from repro_torch.experiments import replicate
        from repro_torch.tree import tree_leaves
        self.replicate, self.real = replicate, port.run_experiment
        self.finite: list[bool] = []

        def observed(spec, **kw):
            res = self.real(spec, **kw)
            self.finite.append(all(bool(torch.isfinite(x).all())
                                   for x in tree_leaves(res.final_params)))
            return res

        self.observed = observed

    def __enter__(self):
        self.replicate.run_experiment = self.observed
        return self

    def __exit__(self, *exc):
        self.replicate.run_experiment = self.real


def _sweep(torch, kd, runs, name, **kw) -> tuple[dict, list, float]:
    """``run_sweep`` on the card with its artifact under build/sweeps:
    returns the artifact, each cell's launch counts (read at the progress
    line that ends the cell; with ``planner="jax"`` the first line is the
    sweep's own pre-plan) and the sweep's wall seconds.  Prints one line
    per cell and fails on a failed cell, a non-finite param or an artifact
    on disk that differs from the one returned."""
    from repro_torch.experiments import run_sweep
    snaps = []

    def log(line):
        torch.cuda.synchronize()
        snaps.append(dict(kd.LAUNCHES))

    kd.reset_launch_counts()
    first = len(runs.finite)
    t0 = time.perf_counter()
    art = run_sweep(name, out_dir=str(kw.pop("out_dir", SWEEP_DIR)),
                    log=log, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre = snaps.pop(0) if kw.get("planner") == "jax" else {
        k: 0 for k in kd.LAUNCHES}
    per_cell, prev = [], pre
    for snap in snaps:
        per_cell.append({k: snap[k] - prev[k] for k in snap})
        prev = snap
    finite = runs.finite[first:]
    with open(art["path"]) as f:
        on_disk = json.load(f)
    if on_disk["failed_cells"] or art["failed_cells"]:
        _fail(f"sweep {name}: failed cells {on_disk['failed_cells']}")
    if on_disk["cells"] != json.loads(json.dumps(art["cells"])):
        _fail(f"sweep {name}: the artifact on disk differs")
    if len(finite) != len(art["cells"]) or not all(finite):
        _fail(f"sweep {name}: non-finite params in {finite}")
    for cell, counts in zip(art["cells"], per_cell):
        print(json.dumps({
            "sweep": name, "cell": cell["label"],
            "executor": cell["executor"],
            "peak_accuracy": cell["summary"]["peak_mean"],
            "subframes": cell["comm"]["subframes"],
            "bandwidth_hz_s": cell["comm"]["pusch_bandwidth_hz_s"],
            "diffusion_rounds": cell["diffusion_rounds"],
            "seconds": cell["wall_clock_s"],
            "plan_cache": {k: cell["plan_cache"][k]
                           for k in ("hits", "misses")},
            "launches": {k: v for k, v in counts.items() if v}}))
        rounds = len(cell["diffusion_rounds"]) * len(cell["seeds"])
        # No sweep strategy here runs a MixOp: one mix_tree launch a round.
        if (counts["mix_tree"] != rounds or counts["mix_aggregate"]
                or counts["dol_bid_scores"] or counts["bid_value_fuse"]
                or counts["quant_pack"] or counts["quant_unpack"]):
            _fail(f"sweep {name} {cell['label']}: launches {counts}, want "
                  f"mix_tree {rounds} and no standalone kernel")
    print(json.dumps({"sweep_summary": name, "cells": len(art["cells"]),
                      "wall_s": wall, "artifact": art["path"],
                      "plan_cache": art["plan_cache"],
                      "launches": {k: v for k, v in kd.LAUNCHES.items()
                                   if v}}))
    return art, per_cell, wall


def sweep_path(torch, port) -> dict:
    """Phase 3c: the sweep layer on the card.  Returns its launches."""
    from repro_torch.core.diffusion import PlanCache
    from repro_torch.experiments import (artifacts, expand_sweep,
                                         prepopulate_plan_cache, run_cell,
                                         run_sweep)
    from repro_torch.kernels import diffusion as kd
    total = {k: 0 for k in kd.LAUNCHES}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    with _ObservedRuns(torch, port) as runs:
        # fig3_alpha's full grid: the device pre-planner plans all 100
        # FedDif rounds first; the cells then replay them.
        cells = expand_sweep("fig3_alpha", smoke=False, executor="fleet",
                             planner="jax")
        cache = PlanCache()
        kd.reset_launch_counts()
        t0 = time.perf_counter()
        pre = prepopulate_plan_cache(cells, cache)
        torch.cuda.synchronize()
        pre_s = time.perf_counter() - t0
        counts = dict(kd.LAUNCHES)
        add(counts)
        st = pre["planner_stats"]
        feddif_rounds = sum(c.spec.fl.rounds for c in cells
                            if c.strategy == "feddif")
        print(json.dumps({
            "sweep_preplan": "fig3_alpha", "planned": pre["planned"],
            "skipped": pre["skipped"], "batches": pre["batches"],
            "seconds": pre_s, "s_per_planned_round": pre_s / max(
                pre["planned"], 1),
            "loop_iterations": st.get("loop_iterations", 0),
            "auction_iterations": st.get("auction_iterations", 0),
            "launches": {k: v for k, v in counts.items() if v}}))
        if pre["planned"] != feddif_rounds or feddif_rounds != 100:
            _fail(f"fig3 pre-plan planned {pre['planned']} rounds, want "
                  f"{feddif_rounds} (= 100)")
        if (counts["bid_fused"] != st.get("loop_iterations", -1)
                or counts["bid_fused"] == 0
                or sum(counts.values()) != counts["bid_fused"]):
            _fail(f"fig3 pre-plan launched {counts} over "
                  f"{st.get('loop_iterations')} bid rounds")
        art, per_cell, wall = _sweep(
            torch, kd, runs, "fig3_alpha", smoke=False, executor="fleet",
            planner="jax", plan_cache=cache)
        add(dict(kd.LAUNCHES))
        for cell, c in zip(art["cells"], per_cell):
            if cell["plan_cache"]["misses"] or c["bid_fused"]:
                _fail(f"fig3 {cell['label']} planned again: misses "
                      f"{cell['plan_cache']['misses']}, bid_fused "
                      f"{c['bid_fused']}")
        peak = {c["label"]: c["summary"]["peak_mean"] for c in art["cells"]}
        print(json.dumps({"fig3_alpha_full": {
            "preplan_s": pre_s, "cells_wall_s": wall,
            "wall_s": pre_s + wall, "peak_accuracy": peak}}))
        if not peak["alpha=0.1/feddif"] > peak["alpha=0.1/fedavg"]:
            _fail(f"fig3 α=0.1: FedDif {peak['alpha=0.1/feddif']} does not "
                  f"beat FedAvg {peak['alpha=0.1/fedavg']}")

        # The smoke grids of the other paper sweeps, fleet plane, host
        # planner.
        smoke = {}
        for name in SWEEP_SMOKE:
            art, per_cell, _ = _sweep(torch, kd, runs, name,
                                      executor="fleet")
            add(dict(kd.LAUNCHES))
            smoke[name] = art
            for cell, c in zip(art["cells"], per_cell):
                hops = (sum(cell["diffusion_rounds"])
                        if name == "fig_lm" else 0)
                if c["quant_roundtrip"] != hops or c["bid_fused"]:
                    _fail(f"{name} {cell['label']}: quant_roundtrip / "
                          f"bid_fused launched {c['quant_roundtrip']} / "
                          f"{c['bid_fused']} times, want {hops} / 0")
            if name == "fig_lm" and not any(
                    sum(c["diffusion_rounds"]) for c in art["cells"]):
                _fail("fig_lm ran no int8 hop")

        # Pre-planned sweep against cell-by-cell planning with fresh caches.
        pre_art, _, _ = _sweep(torch, kd, runs, "fig5_gamma_min",
                               executor="fleet", planner="jax",
                               out_dir=SWEEP_DIR / "preplanned")
        add(dict(kd.LAUNCHES))
        kd.reset_launch_counts()
        records = [run_cell(c, (0,), PlanCache())
                   for c in expand_sweep("fig5_gamma_min", executor="fleet",
                                         planner="jax")]
        torch.cuda.synchronize()
        add(dict(kd.LAUNCHES))
        per_art = artifacts.build_artifact(
            sweep_name="fig5_gamma_min", figure=pre_art["figure"],
            axis=pre_art["axis"], smoke=True, seeds=[0], cells=records,
            executor="fleet", planner="jax")
        artifacts.write_artifact(per_art, str(SWEEP_DIR / "per_cell"))
        same = (artifacts.strip_volatile(pre_art)
                == artifacts.strip_volatile(per_art))
        print(json.dumps({
            "check": "fig5_gamma_min pre-planned vs per-cell planning",
            "equal_after_strip_volatile": same,
            "preplanned_misses": [c["plan_cache"]["misses"]
                                  for c in pre_art["cells"]],
            "per_cell_misses": [r["plan_cache"]["misses"] for r in records],
            "per_cell_bid_fused": kd.LAUNCHES["bid_fused"]}))
        if not same or any(c["plan_cache"]["misses"]
                           for c in pre_art["cells"]):
            _fail("fig5 pre-planned artifact differs from cell-by-cell "
                  "planning")

        # The card against the CPU: fig4_epsilon's smoke grid, fleet plane.
        gpu = smoke["fig4_epsilon"]
        cpu = run_sweep("fig4_epsilon", executor="fleet", device="cpu",
                        out_dir=str(SWEEP_DIR / "cpu"))
        worst = {"accuracy": 0.0, "final_loss": 0.0}
        for g, c in zip(gpu["cells"], cpu["cells"]):
            if (g["comm"] != c["comm"]
                    or g["diffusion_rounds"] != c["diffusion_rounds"]):
                _fail(f"fig4 {g['label']}: card and CPU ledgers differ")
            acc = max(abs(a - b) for a, b in zip(g["accuracy"][0],
                                                 c["accuracy"][0]))
            la, lb = g["loss"][0][-1], c["loss"][0][-1]
            worst["accuracy"] = max(worst["accuracy"], acc)
            worst["final_loss"] = max(worst["final_loss"], abs(la - lb))
            if not (acc <= 0.05 and abs(la - lb) <= 2e-4 + 2e-3 * abs(lb)):
                _fail(f"fig4 {g['label']}: card vs CPU accuracy gap {acc}, "
                      f"final losses {la} / {lb}")
        print(json.dumps({"check": "fig4_epsilon card vs CPU",
                          "comm_equal": True, "max_accuracy_gap": worst[
                              "accuracy"], "max_final_loss_gap": worst[
                              "final_loss"], "bars": {
                              "accuracy": 0.05, "loss_atol": 2e-4,
                              "loss_rtol": 2e-3}}))

        # The sweeps the port refuses: A11, before a cell runs.
        for name in SWEEP_REFUSED:
            first = len(runs.finite)
            try:
                run_sweep(name, executor="fleet", out_dir=None)
            except NotImplementedError as e:
                refused = "A11" in str(e)
                message = str(e)
            else:
                refused, message = False, "ran"
            ran = len(runs.finite) - first
            print(json.dumps({"check": f"{name} refused", "error": message,
                              "cells_run": ran}))
            if not refused or ran:
                _fail(f"{name} was not refused naming A11 before running "
                      f"({message}, {ran} runs)")
    return total


def main() -> None:
    sys.stdout.reconfigure(line_buffering=True)
    if not (ROOT / "src" / "repro_torch").is_dir():
        _fail("src/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false: this smoke needs a GPU")

    from repro_torch.device import set_full_fp32
    from repro_torch.kernels import build
    from repro_torch.kernels import diffusion as kd
    from repro_torch.kernels import quant as kq
    from repro_torch.kernels import ref as kref
    import repro_torch.fl as port
    set_full_fp32()

    card = _card_line()
    print(f"card: {card}")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))

    build_s = build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": sorted(build.SOURCES.values())}))
    for name, log in sorted(build.PTXAS_INFO.items()):
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                print(f"ptxas[{name}]: {line.strip()}")
    _check_wgmma_spills(build.PTXAS_INFO.get("flash_attention"))
    _check_ssd_spills(build.PTXAS_INFO.get("ssd_scan"))
    _check_mix_tree_spills(build.PTXAS_INFO.get("mix_aggregate"))

    floor = launch_floor(torch)
    rows = check_kernels(torch, kd, kq, kref, port)
    rows += check_mix_tree(torch, kd, kref, port,
                           torch.Generator(device="cuda").manual_seed(8),
                           floor["ms"])
    rows += check_stc_compress(torch, kref, port)
    launches = main_path(torch, kd, port)
    for k, v in hop_plane_path(torch, kd, port).items():
        launches[k] += v
    for k, v in host_plane_path(torch, kd, port).items():
        launches[k] += v
    for k, v in sweep_path(torch, port).items():
        launches[k] += v
    routing = stc_routing(torch, kd)
    routing.update({k: v for k, v in stc_rows_routing(torch, kd).items()
                    if k.startswith("stc_rows")})
    routing.update({k: v for k, v in quant_routing(torch, kd).items()
                    if k in ("quant_pack", "quant_unpack")})
    routing.update({k: v for k, v in bid_routing(torch, kd).items()
                    if k in ("dol_bid_scores", "bid_value_fuse")})
    routing["mix_aggregate"] = mix_routing(torch, kd)["mix_aggregate"]
    card_vs_cpu(torch, port)
    card_vs_cpu(torch, port, "host")
    host_vs_fleet(torch, port)
    lm_card_vs_cpu(torch, port)
    old_chain_parity(torch, port)
    planners_card_vs_cpu(torch)
    profile_round(torch, port)
    profile_round(torch, port, strategy="gossip")
    profile_round(torch, port, "jax", VALUE_WEIGHT)
    profile_round(torch, port, executor="host")
    profile_round(torch, port, executor="host", strategy="feddif_stc")
    profile_round(torch, port, strategy="feddif_stc")
    profile_round(torch, port, hop_quant="int8")
    profile_round(torch, port, executor="host", hop_quant="int8")
    profile_round(torch, port, lm_int8=True)
    rows += check_lm_kernels(torch, kref)
    for k, v in zoo_prefill(torch, kd).items():
        launches[k] += v
    zoo_card_vs_cpu(torch)
    zoo_full_depth(torch)

    replaces = {
        "mix_aggregate": ("mix_aggregate.cu",
                          "src/repro/kernels/diffusion.py:119"),
        "mix_tree": ("mix_aggregate.cu",
                     "src/repro/kernels/diffusion.py:119, "
                     "src/repro/kernels/diffusion.py:63, "
                     "src/repro/kernels/diffusion.py:82"),
        "stc_rows_reduce": ("stc_rows.cu",
                            "src/repro/kernels/diffusion.py:177"),
        "stc_rows_apply": ("stc_rows.cu",
                           "src/repro/kernels/diffusion.py:200"),
        "stc_rows_fused": ("stc_compress.cu",
                           "src/repro/kernels/diffusion.py:177, "
                           "src/repro/kernels/diffusion.py:200"),
        "stc_reduce": ("stc_compress.cu",
                       "src/repro/kernels/stc_compress.py:30"),
        "stc_apply": ("stc_compress.cu",
                      "src/repro/kernels/stc_compress.py:47"),
        "stc_fused": ("stc_compress.cu",
                      "src/repro/kernels/stc_compress.py:30, "
                      "src/repro/kernels/stc_compress.py:47"),
        "dol_bid_scores": ("dol_bid_scores.cu",
                           "src/repro/kernels/diffusion.py:316"),
        "bid_value_fuse": ("bid_value_fuse.cu",
                           "src/repro/kernels/diffusion.py:377"),
        "bid_fused": ("dol_bid_scores.cu",
                      "src/repro/kernels/diffusion.py:316, "
                      "src/repro/kernels/diffusion.py:377"),
        "quant_pack": ("quant.cu", "src/repro/kernels/quant.py:32"),
        "quant_unpack": ("quant.cu", "src/repro/kernels/quant.py:43"),
        "quant_roundtrip": ("quant.cu", "src/repro/kernels/quant.py:32, "
                                        "src/repro/kernels/quant.py:43"),
        "flash_attention": ("flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:33"),
        "ssd_scan": ("ssd_scan.cu", "src/repro/kernels/ssd_scan.py:53"),
        "ssm_scan": ("ssm_scan.cu", "src/repro/kernels/ssm_scan.py:29"),
    }
    # The summary row of each kernel is its main-path shape: the (8, 26122)
    # Eq.-11 row of the fcn fleet (mix_tree: the fcn tree of 6 leaves, 8
    # clients, one row; the flat mix_aggregate: its raveled block), the
    # largest fcn leaf (8, 16384) stacked
    # on the fleet plane (stc_rows_fused) and [16384] alone on the host
    # plane (stc_fused), 2^24 for stc_reduce / stc_apply and (8, 262144)
    # for stc_rows_reduce / stc_rows_apply (they now serve only leaves past
    # N_FUSED, as the routing checks' larger leaves), the
    # device planner's (8, 8) bids over 10 classes in the quickstart cell
    # (bid_fused with a learning value; the standalone pair alone),
    # the lm adapter's (8·7, 512) int8 block in the lm_hops cell (the
    # standalone pack / unpack) and its table of 8 rows × 24 leaves, 56
    # blocks (quant_roundtrip, which took the hop from them), and the
    # zoo's prefill shapes: qwen3's bf16 attention (B, Sq, Sk, H, D),
    # zamba2's SSD (B, S, H, P, N, chunk) and falcon's scan (B, S, D, N).
    main_shape = {"mix_aggregate": [8, 26122, 1], "mix_tree": [8, 26122, 1],
                  "stc_rows_reduce": [8, 262144],
                  "stc_rows_apply": [8, 262144], "stc_rows_fused": [8, 16384],
                  "stc_reduce": [2 ** 24], "stc_apply": [2 ** 24],
                  "stc_fused": [16384],
                  "dol_bid_scores": [8, 8, NUM_CLASSES],
                  "bid_value_fuse": [8, 8],
                  "bid_fused": [8, 8, NUM_CLASSES], "quant_pack": [56, 512],
                  "quant_unpack": [56, 512], "quant_roundtrip": [8, 24, 56],
                  "flash_attention": [2, 4096, 4096, 16, 128],
                  "ssd_scan": [1, 4096, 80, 64, 64, 128],
                  "ssm_scan": [1, 4096, 8192, 16]}
    # Kernels that another kernel's wrapper launches in the same call: their
    # launches stand in that kernel's row, whose times cover both.
    helpers = {"ssd_scan": ("ssd_scan_state", "ssd_scan_pass")}
    # Kernels that no main-path run launches, with the kernel that took
    # their work, and the routing check above that drove them (and failed
    # unless they launched as it expects): stc_fused (host plane) and
    # stc_rows_fused (fleet plane) took every FL leaf (n ≤ N_FUSED),
    # quant_roundtrip took both planes' int8 hops, bid_fused the device
    # planner's bid rounds, and mix_tree the fleet plane's Eq. 10/11.
    host_stc = ("stc_fused", "for n <= N_FUSED", "the host-plane STC "
                "routing check's leaves past N_FUSED")
    fleet_stc = ("stc_rows_fused", "for n <= N_FUSED", "the fleet-plane STC "
                 "routing check's leaves past N_FUSED")
    wire = ("quant_roundtrip", "on both planes' int8 hops", "the quant "
            "routing check's pack_rows / unpack_rows call")
    bids = ("bid_fused", "on the device planner's bid rounds", "the bid "
            "routing check's ops.dol_bid_scores / ops.bid_value_fuse calls")
    mix = ("mix_tree", "on the fleet plane's MixOps and aggregations",
           "the mix routing check's ops.mix_aggregate call")
    off_path = {"mix_aggregate": mix,
                "dol_bid_scores": bids, "bid_value_fuse": bids,
                "stc_reduce": host_stc, "stc_apply": host_stc,
                "stc_rows_reduce": fleet_stc, "stc_rows_apply": fleet_stc,
                "quant_pack": wire, "quant_unpack": wire}
    summary = []
    for name, (src, rep) in replaces.items():
        row = next(r for r in rows
                   if r["name"] == name and r["shape"] == main_shape[name]
                   and r.get("inputs", "model") == "model")
        for k in (name, *helpers.get(name, ())):
            if launches[k] == 0 and k not in off_path:
                _fail(f"{k} was never launched on the main path")
        summary.append({
            "name": name, "route": "cuda",
            "source": f"{KERNEL_SOURCE}/{src}", "replaces": rep,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": row["shape"],
            **({"helper_launches": {k: launches[k] for k in helpers[name]}}
               if name in helpers else {}),
            **({"bound_tc_ms": row["bound_tc_ms"]}
               if "bound_tc_ms" in row else {}),
            **({"chain_ms": row["chain_ms"]} if "chain_ms" in row else {}),
            **({"routing_launches": routing[name],
                "note": f"0 on the main path: {off_path[name][0]} replaced "
                        f"it {off_path[name][1]}; routing_launches are "
                        f"{off_path[name][2]}"}
               if name in off_path else {}),
            "ok": all(r["ok"] for r in rows if r["name"] == name)})
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
