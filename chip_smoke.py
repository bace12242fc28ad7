#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (an H100
for the numbers in PERF.md).  It imports ``repro_torch`` from ``src/`` and
nothing of JAX.  Phases, each of which fails loudly:

1. the card's name and power limit; build every CUDA kernel of the main
   path from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
   at once) and print the build seconds and ptxas' register and spill
   report (the bf16 attention kernel, every ssd_scan kernel, forward and
   backward, and every mix_tree kernel must not spill; the SSD backward's
   SASS must hold no atomic); the launch floor, an empty kernel
   timed as every kernel is, on a ``launch_floor`` line of its own;
2. the attention backward at qwen3's, smollm's and zamba2's bf16 shapes
   under ``torch.profiler`` before anything else is profiled (each device
   kernel's µs, a measurement); then
   every kernel against its plain PyTorch version on the card, at the main
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
   configuration (fcn, α=0.3, 6000 samples, N=M=8, 8 rounds) for fedavg
   and feddif with the host planner, 4 of its rounds for feddif with the
   device planner (``planner="jax"``) and learning-value bids
   (``uncertainty_weight=0.5``), 2 rounds each of feddif_stc and stc, 2 rounds of feddif on cnn.  Launch
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
   quickstart's fedavg and feddif at 4 of its 8 rounds (FedDif's peak must
   beat FedAvg's), two
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
   1, 100} × fedavg / feddif, N = M = 10, 8000 samples, seed 0,
   ``planner="jax"``) cut to FIG3_ROUNDS of its 20 rounds, its 15 FedDif
   rounds first planned by
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
   within atol 2e-4, rtol 2e-3.  One line per
   cell (label, peak accuracy, sub-frames, Eq.-15 bandwidth, seconds,
   plan-cache hits and misses, launches); the sweeps' launches count as
   main-path launches.
   The durable phase (``durable_path``, state under ``build/durable``):
   (a) fleet FedDif and gossip at the quickstart's width (6 rounds,
   killed after round 3) and host FedDif (4 rounds, killed after round 2),
   each with ``checkpoint_every=1``, preempted by ``fail_after_save`` and
   resumed: params bit-equal to the uninterrupted run, equal ledger,
   curves and launch counts (``mix_tree`` once per round and MixOp over
   the two halves), seconds and bytes per save; (b) ``fig5_gamma_min``'s
   smoke grid, fleet plane, device planner, durable, killed inside its
   second cell once the first is done, then resumed: the resumed
   pre-planner launches ``bid_fused`` 0 times, no cell misses the plan
   cache, the artifact equals a non-durable run's after
   ``strip_volatile``; (c) the sweep CLI on ``fig4_epsilon`` sent SIGTERM
   once a round checkpoint is committed (exit −15), then ``--resume``
   (exit 0, the same artifact); (d) ``fig3_alpha``'s α = 0.1 FedAvg and
   FedDif cells on the host plane at full width (N = M = 10, 8000
   samples), seeds 0–2 and seed 0 alone, 1 round, under ``seed_vmap``
   and ``loop``: equal ``comm``, diffusion rounds and IID, each seed's
   accuracy within 2e-3 at every eval, no kernel launched by
   ``seed_vmap``, both walls and their ratio printed; (e) ``seed_vmap``
   on the card against the CPU on ``fig3_alpha``'s smoke FedDif cell:
   equal ``comm``, accuracy within 0.05.  The launches of (a) and (b)
   count as main-path launches.
   The appendix and async phases below each run in a process of their
   own (``chip_smoke.py --path appendix`` / ``async``), begun after phase
   2 beside the main process's phase 3 and read where they stood; their
   lines are printed there, and their launches are counted in the child
   as in process.
   The appendix and world phase (``appendix_path``, state under
   ``build/appendix``), on the fleet plane: (a) the ``appendix_scenarios``
   bench's full cells (fcn, α = 0.5, 4000 samples, N = M = 8, 6 of their
   12 rounds, the host planner): FedDif (baseline), gossip, the ``kld``, ``jsd`` and
   ``w1_true`` metrics, retrainable FedDif (12 diffusion rounds at most)
   and the underlay, with peak accuracy, sub-frames and mean diffusion
   rounds; the underlay must charge more sub-frames per hop than the
   overlay, and FedDif with ``planner="jax"`` (2 rounds, keyed control
   streams) must launch ``bid_fused`` never under ``kld`` and once per
   bid round under ``w1_norm``, ``bid_value_fuse`` once per bid round
   under ``kld`` with learning values and never without, and under
   ``kld`` plan as the host planner does (equal ledger and diffusion
   rounds); (b)
   ``fig_scenarios``' full grid (fedavg / d2d_random_walk / feddif ×
   static / mobile / multicell / energy_capped, N = 20, 8000 samples,
   6 of its 12 rounds) with the host planner, its joules per cell, and
   its mobile
   and multicell FedDif cells with the device planner, which must agree
   with the host planner's on sub-frames and diffusion rounds and on
   accuracy within 0.05; FedDif at that width for 2 rounds per scenario
   on each plane (and the device planner's mobile and multicell) for the
   round wall and the planner's seconds per round; (c) a mobile and an
   energy-capped FedDif run (N = M = 8, 6 rounds, a 1 J budget that
   depletes clients before the kill) each killed after round 3 and
   resumed bit-equal,
   and ``fig7_scaling``'s smoke grid (N ∈ {20, 64}, 5 % churn); (d) one
   FedDif round with ``profile_phases=True``: its train, hop_collective,
   mix and plan seconds.  The launches of (a)–(c) count as main-path
   launches.
   The async phase (``async_path``, state under ``build/async``): the
   buffered-async plane at the quickstart's width (fcn, α = 0.3, 6000
   samples, N = M = 8) on each inner plane (host and fleet): (a) FedAvg
   and FedDif at N = 20, 2 rounds, on the degenerate engine (K = all, no
   delay, no discount) against the sync executor of the same plane: on
   the host plane params bit-equal, equal ledger and curves, on the fleet
   plane params within atol 2e-4, rtol 2e-3 and equal ledger, the virtual
   clock [0, 0] on both; (b) the ``async`` and ``async_barrier`` presets,
   FedDif, 4 rounds: equal ledgers, the buffered arm's first tick before
   the barrier's, its staleness above 0 and the barrier's 0, one line per
   arm with the clock, arrivals and staleness of every tick, the virtual
   seconds to 0.98 of the lower peak and the round wall; (c) feddif_stc
   under ``async`` on each plane (``stc_fused`` / ``stc_rows_fused``),
   FedDif with int8 hops on each plane (``quant_roundtrip`` once per
   PermuteOp) and FedDif with the device planner and learning-value bids
   on the degenerate engine and under ``async`` (``bid_fused`` once per
   bid round), each launching its kernel as often as the sync run of the
   same schedules (equal ledgers; the value-driven ``async`` plans are its
   own); (d) ``buffer_k=2``, ``checkpoint_every=1``, killed after round 2
   of 4 with contributions pending, on each plane, resumed bit-equal
   (params, ledger, clock, arrivals, staleness, curves, launches), with
   seconds and bytes per save; (e) cohorts of 16 drawn from a population
   of 100,000, 2 rounds, with seconds per cohort draw; (f) ``fig_async``'s
   full grid (N = 16, 3 of its 10 rounds, 5 % churn, fedavg and
   d2d_random_walk ×
   ``async_barrier`` and ``async``): no failed cell, finite params, one
   line per cell with its virtual clock; its smoke grid on the card and on
   the CPU: equal ``comm``, virtual clock and arrivals, accuracy within
   0.05.  The launches of (b)–(f) count as main-path launches.
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
   replaced, on the quickstart device-planner run (at
   CHAIN_PARITY_ROUNDS of the quickstart's 8 rounds) and every plan of the
   planner checks below: the same rounds, hops and ``scheduled``,
   bit-equal ``decrement``, ``weight`` and ``efficiency`` (and, in the
   run, equal ledgers and bit-equal final params); fleet-plane FedDif
   (CHAIN_PARITY_ROUNDS rounds), gossip, tthf and the lm full fp32 arm as
   shipped and with Eq. 10/11
   put back to the chain ``mix_tree`` replaced: equal ledgers, bit-equal
   final params; then the device planner
   on the card (with its
   kernels) against the host planner on the CPU, on the N=M=C=10
   default-config inputs (seeds 0-2) and 2 of the 16 plans of the N=M=20
   ``planner_speedup`` cells: exact hop-list agreement is printed, and the
   plans must be equivalent (same rounds, same hop count, total Eq.-17
   decrement within 1e-6 relative);
5. a measurement, not a check: one FedDif round with each planner and
   one gossip round on the fleet plane, under ``torch.profiler`` with
   device activity alone (the feddif_stc and int8-hop rounds of each plane
   left the phase to make room for phase 8, the host-plane and lm int8
   rounds for gemma3's and pixtral's phases: their kernels run, and are
   checked, in phases 3–4; ``profile_round`` still takes them) (device
   busy time, idle share, kernel count, top kernels);
6. the LM zoo's prefill forward at the published widths: flash_attention,
   ssm_scan and ssd_scan against their plain versions on the card (at the
   zoo's shapes and a few more: bf16 and fp32, a window, Sq < Sk, D = 80,
   smollm_360m's (2, 4096, 15, 64), a 1000-key window at S = 4096,
   mixtral's 4096-key window at S = 8192, gemma3's D = 256 at
   (1, 8192, 8, 256) causal and with its 1,024-key window and pixtral's
   D = 160 at (1, 5120, 32, 160), bf16 and fp32, whisper_base's encoder
   (8, 1500, 1500, 8, 64) and cross-attention (8, 448 queries, 1500 keys)
   non-causal in bf16, each row's route read
   from the library's launch counts, a
   ragged chunk, a ragged channel block; ssd_scan also at near-unit decay
   and two odd shapes, P 72 / N 128 and P 18 / N 9 / chunk 48), with
   attention held per element against its row's scale and normwise, and
   a planted fault (one kv tile dropped for the rows past S/2; at D = 160
   the third 64-column chunk of the head dim dropped from the scores; at
   whisper's rows the ragged last 92-key tile hidden from the rows past
   Sq/2) that the attention bars must reject; at every attention row the
   output with
   ``return_lse=True`` bit-equal to the one without, and the row
   log-sum-exp within LSE_BAR of ``torch.logsumexp``'s; every ssd_scan row must give the same bits
   on two calls, and at near-unit decay a planted fault (the carried state
   applied one chunk late) must fail its bar; then ``make_prefill_step``
   of qwen3_0_6b (28 layers, B = 2,
   S = 4096), zamba2_2_7b (54 mamba2 + 9 shared attention, B = 1,
   S = 4096), falcon_mamba_7b (64 mamba1 layers, B = 1, S = 4096), the
   MoE configs at cut depths, gemma3_4b (34 layers, B = 1, S = 32,768: 29
   windowed launches), pixtral_12b (40 layers, B = 1, 1,024 seeded
   patch embeddings ahead of 4,096 text tokens) and whisper_base (6 + 6
   layers, B = 32 × (1,500 seeded frame embeddings + 448 tokens): 18
   launches at D = 64, 12 non-causal) from
   random params drawn on the card, one after another, under
   ``torch.inference_mode()``: loss finite, prefill tokens/s, peak memory
   (the garbage collector run before each reset),
   and each kernel launched exactly once per layer that runs it, through
   its head dim's instance; a 2-layer
   cut of each config at B = 1, S = 256 (gemma3 with local_global_ratio 1
   at S = 1,536; pixtral on 1,024 patches and 64 text tokens) on the card
   against the CPU (plain
   versions) from one init, in bf16 and in fp32 compute, loss and final
   hidden states within bars set from readings, and the same cut with the
   family's kernel output one step late (and in fp32 also with its
   sequence halves run apart, a kernel that loses its context at S/2;
   gemma3 unscaled and all-global, pixtral's text positions from 0),
   which those bars must reject; whisper-smoke and its cut at D = 64 over
   200 frames (B = 2, 64 tokens) on the card against the CPU in both
   dtypes, the encoder's states, the decoder's hidden states and the loss
   within the same bars, and two controls they must reject (the encoder
   causal, the cross-attention reading the next row's frames); one qwen3,
   one zamba2 and one whisper prefill under ``torch.profiler``;
   zamba2_2_7b at full width and full depth (B = 1, S = 4096) from one init
   through the ssd_scan kernels and through its
   plain version, in fp32 compute (losses within ZOO_BARS' fp32 loss_abs)
   and in bf16 (both losses printed);
7. decode and serving (``serve_path``), which reaches no kernel of ours:
   (a) ``ServingEngine`` at full width with 8 slots of 32,768 positions
   (``SHAPES["decode_32k"]``' cache length; its batch of 128 cut to 8)
   for qwen3_0_6b (greedy, and sampled at temperature 0.8, top-k 40),
   zamba2_2_7b, falcon_mamba_7b, the MoE configs at cut depths, gemma3_4b
   and pixtral_12b (its 8 slots of 8,192), 8 requests of 64–128 prompt
   tokens
   and 32 new tokens each: engine steps, seconds, ms per step, generated
   tokens/s, peak and cache GB, and every kernel launched 0 times; (b)
   ``python -m repro_torch.launch.serve`` at full width as a subprocess,
   exit 0 and its rates; (c) the 2-layer cuts at B = 2, 24 teacher-forced
   steps then 8 greedy ones (gemma3's and pixtral's full-width cuts 6 and
   2; whisper's D = 64 cut, its cache built from its frames), card
   against CPU in fp32 and bf16 compute,
   logits and caches within SERVE_BARS, and two planted controls (the new
   K/V written one position late; the recurrent state not carried between
   steps) that the bars must reject; (d) on the fp32 cuts at S = 64,
   teacher-forced decode logits against the prefill forward's (through
   flash_attention, ssd_scan and ssm_scan) within atol = rtol = 2e-4; (e)
   on the fp32 cuts, 5 requests on 2 slots equal to each request's
   unbatched greedy decode, and the sampler on card logits equal to the
   CPU's (greedy, temperature, top-k, top-p) with equal Gumbel bits; (f)
   glibc ``powf``'s tensor form (``xla_powf_t``) bit-equal on the card
   and the CPU over 2^22 inputs; (g) whisper_base at full width: its cache
   built from 8 rows of 1,500 frames (its encoder's 6 launches), 64
   teacher-forced and 32 greedy steps over 448 positions, ms a step,
   tokens/s, cache and peak GB; the serve CLI at ``--arch whisper_base``
   is (b)'s second run.

8. training (``check_train_kernels``, ``train_path``): (a) the backward
   kernels against their plain twins on the card — flash_attention's at
   qwen3's (2, 4096, 16, 128), smollm's (2, 4096, 15, 64), D = 80
   (1, 4096, 32, 80), a 1000-key window, gemma3's (1, 4096, 8, 256)
   causal and with its 1,024-key window, pixtral's (1, 5120, 32, 160),
   fp32 at D = 128, 160 and 256 and ragged rows (S % 64 != 0, Sq < Sk) at
   each bf16 head dim past 128, whisper's two non-causal rows, within
   ATTN_BWD_BARS, the kernel fed the
   forward kernel's lse and its twin ``torch.logsumexp``'s, the library's
   counts showing each row's device kernels (bf16: the ``wgmma`` dK/dV
   and dQ instances of its head dim, dK/dV in two passes past D = 128);
   ssm_scan's at falcon's (1, 4096, 8192, 16) and three more, bit-equal;
   ssd_scan's (four launches) at zamba2's (1, 4096, 80, 64, 64, 128), its
   cut at S = 256, a ragged S, the smoke width, near-unit decay and B = 4,
   each gradient within SSD_BWD_BAR·(1 + max|plain|), with ptxas' registers
   and spills (none, and no atomic in its SASS: phase 1);
   the same bits on two calls; a planted fault each (a key tile dropped,
   at D = 128, 256 and 160, and the ragged last one at whisper's rows;
   ``h_t`` for ``h_{t−1}``; G one chunk late, at every ssd_scan row) that
   must fail its bar by ≥ 10×; kernel, plain and
   library ms and the bound;
   (b) ``make_train_step`` at full width: qwen3_0_6b (B = 2 × 4096, AdamW,
   ``warmup_cosine_lr``, clip 1.0, 6 steps: the loss falls, peak GB with
   remat below the peak without), falcon_mamba_7b at 8 of its 64 layers
   (B = 1 × 4096, SGD, 3 steps) and zamba2_2_7b at full width and depth
   (54 mamba2 + 9 shared, B = 1 × 4096, AdamW, 3 steps: the loss falls),
   gemma3_4b at 12 of its 34 layers (two bodies of 5 ``swa`` + 1 ``attn``,
   B = 1 × 4096, AdamW, 3 steps) and pixtral_12b at 4 of its 40 (B = 1 ×
   (1,024 patch embeddings + 4,096 tokens), SGD with momentum, 3 steps)
   and whisper_base at full width and depth (B = 64 × (1,500 frames + 448
   tokens), AdamW, 3 steps), the losses falling, seconds a step,
   tokens/s, peak GB and launches (the forward kernels twice a layer a step
   under remat, the backward
   once, each through the instance of its head dim); one step at qwen3-,
   zamba2-, mixtral-, gemma3- and pixtral-smoke (its patch embeddings
   ahead of the text) in fp32 on the card against the CPU, params within
   1e-5, and at the head-dim cuts (gemma3 at D = 256, pixtral at 160,
   whisper at 64; whisper-smoke in fp32 too) in fp32 (params within 1e-5,
   the CUDA-core kernels) and bf16 (gradients within GRAD_BARS, the
   ``wgmma`` kernels); (c) ``launch/train`` at full width (smollm_360m, 1
   round, 4 clients, 4 steps a round) in process and the CLI at
   ``--smoke`` as a subprocess; (d) ``run_spmd_feddif`` at smollm-smoke
   and zamba2-smoke on the card against the CPU: equal ledgers, loss
   histories within SPMD_LOSS_BAR, one forward and one backward launch set
   per layer per vmapped step.  The launches of (b)–(d) count as
   main-path launches.

Then one ``{"kernels": [...]}`` line, the card line, and as the last line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import re
import shutil
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
# The device-planner run of phase 3 (planner="jax", uncertainty_weight=0.5;
# 4 of the quickstart's 8 rounds, cut to keep the script inside its time
# limit), and the planner checks of phase 4: (clients = models, classes,
# max diffusion rounds, [(data seed, channel seed), ...]).
DEVICE_PLANNER_RUN = ("feddif", "fcn", 4, 8)
VALUE_WEIGHT = 0.5
NUM_CLASSES = 10
# planner_speedup: 1 of the bench's 16 plans (data seed 0, channel seed
# 0), cut to keep the script inside its time limit (4 until the SSD
# backward's training phase, 2 until gemma3's and pixtral's phases: a plan
# takes ~2.4 s on the card and runs three times, in two arms of phase 4's
# chain parity and in its planner check).
PLANNER_CASES = (
    ("default_config", 10, None, [(s, s) for s in range(3)]),
    ("planner_speedup", 20, 24, [(i, 0) for i in range(1)]),
)
# Rounds of the runs of phase 4's chain parity, each run twice: the
# quickstart cell's FedDif (the device-planner run's bid rounds, the fleet
# plane's Eq. 10/11; 8 rounds cut) and the lm_hops arms (int8 and full
# fp32; 6 rounds cut), cut to keep the script inside its time limit.
CHAIN_PARITY_ROUNDS = 2
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
# kernel per forward, layers run: None for all).  4096 is
# SHAPES["train_4k"]'s sequence.  The batch is small so that the plain
# versions in the kernel checks, at the same shapes, stay small
# (flash_attention_ref holds fp32 (B, H, S, S) scores).  The MoE configs
# run at published widths with their depth cut so that the fp32 params
# fit beside the dropless dispatch buffers: mixtral 4 of 56 layers (41.7
# GB) at prefill_32k's sequence cut to 8192, so its 4096-key window masks
# half of each row; qwen3-moe 2 of 94 (24.9 GB); moonshot 8 of 48 (21.5
# GB).  gemma3_4b runs all 34 layers at prefill_32k's sequence (its batch
# of 32 cut to 1): five bodies of 5 swa + 1 attn and 4 swa layers, 29 of
# its 34 launches windowed (1,024 keys); pixtral_12b all 40 layers (51.1
# GB of fp32 params) at B = 1 on ZOO_PATCHES seeded patch embeddings ahead
# of 4,096 text tokens.
ZOO_RUNS = (("qwen3_0_6b", 2, 4096, {"flash_attention": 28}, None),
            ("zamba2_2_7b", 1, 4096, {"ssd_scan_state": 54,
                                      "ssd_scan_pass": 54, "ssd_scan": 54,
                                      "flash_attention": 9}, None),
            ("falcon_mamba_7b", 1, 4096, {"ssm_scan": 64}, None),
            ("mixtral_8x22b", 1, 8192, {"flash_attention": 4}, 4),
            ("qwen3_moe_235b_a22b", 1, 4096, {"flash_attention": 2}, 2),
            ("moonshot_v1_16b_a3b", 1, 4096, {"flash_attention": 8}, 8),
            ("gemma3_4b", 1, 32768, {"flash_attention": 34}, None),
            ("pixtral_12b", 1, 4096, {"flash_attention": 40}, None))
# The vision family's patch embeddings per sequence: pixtral's
# num_frontend_tokens (one image's 1,024 patches), drawn N(0, 1) in bf16.
ZOO_PATCHES = 1024
# The card-vs-CPU cuts: 2 layers of each full-width config (zamba2's with
# attn_period 2, so the cut keeps the shared attention block), B=1, S=256;
# the MoE configs' smoke configs (2 layers; mixtral-smoke's window 32 <
# S).  ZOO_PREFILL_CUTS run in phase 6c alone: moonshot at 2 layers and
# full width (the CPU's decode at that width would outlast the phase).
# ZOO_WIDE_CUTS run in 6c and in phase 7 (with fewer decode steps,
# SERVE_WIDE_STEPS): gemma3 at 2 layers of full width with
# local_global_ratio 1 (one swa layer, one global) over ZOO_CUT_SEQS'
# 1,536 tokens, so its 1,024-key window hides keys from a third of the
# rows; pixtral at 2 layers of full width on ZOO_PATCHES patch
# embeddings ahead of 64 text tokens.
ZOO_CUTS = (("qwen3_0_6b", {}), ("zamba2_2_7b", {"attn_period": 2}),
            ("falcon_mamba_7b", {}), ("mixtral_8x22b", {"smoke": True}),
            ("qwen3_moe_235b_a22b", {"smoke": True}),
            ("moonshot_v1_16b_a3b", {"smoke": True}))
ZOO_PREFILL_CUTS = (("moonshot_v1_16b_a3b", {}),)
ZOO_WIDE_CUTS = (("gemma3_4b", {"local_global_ratio": 1}),
                 ("pixtral_12b", {}))
ZOO_CUT_SEQ = 256
ZOO_CUT_SEQS = {"gemma3_4b": 1536, "pixtral_12b": 64}
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
# The wide cuts' loss bars where they are wider than ZOO_BARS' (their
# hidden-state bars stay ZOO_BARS'): the readout is a bf16 GEMM on each side, summed in another
# order on the card than on the CPU and rounded to bf16 logits.  gemma3's
# tied, scaled embeddings put its largest logits near 51, where a bf16 ulp
# is 0.25: its fp32 loss moved 3.2e-4 on an H100 with hidden states 1.7e-6
# apart (normwise); pixtral's loss averages 64 text tokens alone: 2.1e-4
# with hidden states 1.4e-6 apart.
ZOO_LOSS_ABS = {"gemma3_4b": 3e-3, "pixtral_12b": 1e-3}
CONTROLS_REJECTED = {"bfloat16": ("one_step_late",),
                     "float32": ("one_step_late", "halves_apart")}
# The op each cut's control runs wrongly (its two sequence halves apart).
ZOO_CONTROL_OP = {"qwen3_0_6b": "flash_attention", "zamba2_2_7b": "ssd_scan",
                  "falcon_mamba_7b": "ssm_scan",
                  "mixtral_8x22b": "flash_attention",
                  "qwen3_moe_235b_a22b": "flash_attention",
                  "moonshot_v1_16b_a3b": "flash_attention",
                  "gemma3_4b": "flash_attention",
                  "pixtral_12b": "flash_attention"}
# An MoE cut's card runs take the CPU's experts where their own router
# nearly ties (_Routing): the largest gap log(p_k / p_{k+1}) between the
# k-th and (k+1)-th probabilities at which they do.  bf16 moves a router's
# logits by ~1e-3 at the smoke widths (the CPU tests' flips: 2.6e-4 to
# 2.6e-3) and by ~1e-2 at moonshot's full width, where the hidden states
# of card and CPU differ by ~1 % (ZOO_BARS' readings) and 64 experts'
# logits sit ~0.05 apart.
ROUTE_NEAR_TIE = 5e-2
# The MoE cuts' planted controls, which the bars of both dtypes must
# reject: every token's first two top-k weights exchanged (expert_swapped),
# and the sliding window one key wider (window_wide).
ZOO_MOE_CONTROLS = {"mixtral_8x22b": ("expert_swapped", "window_wide"),
                    "qwen3_moe_235b_a22b": ("expert_swapped",),
                    "moonshot_v1_16b_a3b": ("expert_swapped",)}
# The wide cuts' planted controls, which the bars of both dtypes must
# reject: gemma3's embeddings left unscaled (embed_unscaled) and its
# window dropped, every layer global (all_global); pixtral's text
# positions restarting at 0 after the patches (text_positions_from_zero).
ZOO_FAMILY_CONTROLS = {"gemma3_4b": ("embed_unscaled", "all_global"),
                       "pixtral_12b": ("text_positions_from_zero",)}
# The audio family: whisper_base (configs/whisper_base.py,
# arXiv:2212.04356: 6 encoder + 6 decoder layers, d_model 512, 8 heads of
# D = 64, d_ff 2,048, vocab 51,865, 1,500 stubbed frame embeddings) at its
# published width and depth.  Its text is WHISPER_TEXT tokens, the
# decoder's published context (n_text_ctx in openai/whisper's
# ModelDimensions), in place of SHAPES' 4,096.  Phase 6b prefills
# SHAPES["prefill_32k"]'s batch of 32 × (1,500 frames + 448 tokens): each
# forward launches flash_attention 18 times at D = 64 (6 encoder, 6
# decoder and 6 cross-attention layers), 12 of them non-causal.
WHISPER = "whisper_base"
WHISPER_TEXT = 448
WHISPER_ATTN = {"flash_attention": 18}
WHISPER_NONCAUSAL = 12
# Phases 6c, 7 and 8b's cuts: whisper-smoke (2 + 2 layers, d_model 128, 4
# heads of D = 32, which the fp32 kernels take) and the same at 2 heads of
# D = 64 (the wgmma<64> instances) over 200 frames, a key length that is no
# whole number of 64- or 128-key tiles; B = 2 and WHISPER_CUT_TEXT tokens.
WHISPER_CUTS = (("whisper-smoke", {}),
                ("whisper-hd64", {"name": "whisper-hd64", "num_heads": 2,
                                  "num_kv_heads": 2,
                                  "num_frontend_tokens": 200}))
WHISPER_CUT_TEXT = 64
# Phase 6c's controls, which the bars of both dtypes must reject: the
# encoder's spec causal (its self-attention and the cross-attention then
# mask keys), and the cross-attention reading the next batch row's frames.
WHISPER_CONTROLS = ("causal_encoder", "cross_wrong_frames")
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
# The forward's row log-sum-exp (``return_lse=True``) against the plain
# one (``torch.logsumexp`` of the fp32 masked scores): |Δ| ≤ LSE_BAR·(1 +
# |plain|), +inf in the same rows.  Both form fp32 scores from the same
# inputs in another order (≈ 1e-6 at |s| ≲ 10); the bf16 kernel adds
# ex2.approx (2 ulps) and a sum of up to 4096 terms in another order, and
# carries m in log2 units (one more rounding): a few 1e-6 of 1 + |lse|,
# under the bar by ≥ 10×.  A wrong row, tile or unit (a missing ln 2 is
# 44 % of lse) fails it by orders of magnitude.
LSE_BAR = 5e-5
BF16_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor-core peak
# The host plane (phase 3b): FLConfig.stc_sparsity's default, which every
# STC run here uses; the quickstart and the two-round runs of every
# strategy on the host plane; gossip and TT-HF also on the fleet plane
# (TT-HF for 4 rounds, so its global MixOp runs once); the host-vs-fleet
# parity run.
STC_SPARSITY = 0.01
HOST_QUICKSTART = (("fedavg", 4), ("feddif", 4))   # the quickstart's 8, cut
HOST_TWO_ROUND = ("stc", "feddif_stc", "fedswap", "d2d_random_walk",
                  "fedprox", "feddif_prox")
MIX_RUNS = (("gossip", 2), ("tthf", 4))
HOST_VS_FLEET_RUN = ("feddif", "fcn", 2, 8)
# The sweep phase (3c): fig3_alpha's full grid (5 α × fedavg / feddif,
# N = M = 10, 8000 samples) pre-planned with the device planner, the smoke
# grids of the other paper sweeps, all on the fleet plane.  The grid runs
# FIG3_ROUNDS of its 20 rounds, as the sweep ``fig3_alpha_r3`` registered
# here (a copy of ``fig3_alpha`` with fewer rounds): the script ran past
# its 1,200 s limit on slow hosts (NVIDIA H100 80GB HBM3, 700.00 W; the
# FL phases host-bound), so those phases were cut in depth (20 → 10 → 5
# → 3: at 3 rounds FedDif's peak at α = 0.1 is 0.570 against FedAvg's
# 0.270 on the CPU, seed 0).  Artifacts go under build/.
FIG3_ROUNDS = 3
SWEEP_DIR = ROOT / "build" / "sweeps"
SWEEP_SMOKE = ("fig4_epsilon", "fig5_gamma_min", "fig6_tasks",
               "table2_strategies", "fig_lm")
# The durable phase: runs killed after a round checkpoint and resumed, as
# (executor, strategy, rounds, killed after round), at the quickstart's
# width; and the seed-stacked engine against the loop engine.
DURABLE_DIR = ROOT / "build" / "durable"
DURABLE_RUNS = (("fleet", "feddif", 6, 3), ("fleet", "gossip", 6, 3),
                ("host", "feddif", 4, 2))
# (d)'s seed sets: three replicates, and one, the CLI's and run_sweep's
# default, where the seed axis has nothing to batch; 1 round (fig3's 20
# cut to 5, then 3, then 1 to make room for the training phase).
SEED_VMAP_SEED_SETS = ((0, 1, 2), (0,))
SEED_VMAP_ROUNDS = 1
SEED_VMAP_ACC = 2e-3         # the reference's seed_vmap-vs-loop bar
# The appendix and world phase: the appendix_scenarios bench's full cells
# (benchmarks/run.py: fcn, α = 0.5, 4000 samples, N = M = 8, 12 rounds,
# seed 0; 6 of the 12 here) on the fleet plane with the host planner, as
# (label, FLConfig changes); fig_scenarios' full grid; resume and churn; the phase profile.
APPENDIX_DIR = ROOT / "build" / "appendix"
APPENDIX_DATA = dict(task="fcn", alpha=0.5, num_samples=4000)
APPENDIX_FL = dict(executor="fleet", strategy="feddif", rounds=6,
                   num_clients=8, num_models=8, seed=0)
APPENDIX_CELLS = (("baseline", {}), ("fully_decentralized",
                                     {"strategy": "gossip"}),
                  ("metric_kld", {"metric": "kld"}),
                  ("metric_jsd", {"metric": "jsd"}),
                  ("metric_w1_true", {"metric": "w1_true"}),
                  ("retrainable", {"allow_retraining": True,
                                   "max_diffusion_rounds": 12}),
                  ("underlay", {"underlay": True}))
# (3 rounds until the training phase came.)
SCENARIO_PROFILE_ROUNDS = 2
# fig_scenarios' full grid and its device-planner cells run 6 of its 12
# rounds (the copy ``fig_scenarios_r6``), cut to keep the script inside its
# time limit.
SCENARIO_GRID_ROUNDS = 6
# (scenario, FLConfig changes, rounds, killed after): the energy budget
# binds before the kill (clients deplete in round 3), so the resumed run
# needs the spent energy the checkpoint saved.
WORLD_RESUME = (("mobile", {}, 6, 3),
                ("energy_capped", {"energy_budget_j": 1.0}, 6, 3))
# The async phase: the buffered-async plane at the quickstart's width
# (fcn, α = 0.3, 6000 samples, N = M = 8, 4 rounds of FedDif) on each
# inner plane; degeneracy at N = 20, 2 rounds; kill/resume (rounds, killed
# after) with K = 2 of the async preset's knobs; the population front end
# (population, cohort, rounds); fig_async's full and smoke grids.
ASYNC_DIR = ROOT / "build" / "async"
ASYNC_DATA = dict(task="fcn", alpha=0.3, num_samples=6000)
ASYNC_FL = dict(strategy="feddif", rounds=4, num_clients=8, num_models=8,
                seed=0)
ASYNC_PLANES = ("host", "fleet")
ASYNC_DEGENERATE_N = 20
ASYNC_RESUME = (4, 2)
ASYNC_POPULATION = (100_000, 16, 2)
ASYNC_KERNEL_ROUNDS = 2
# fig_async's full grid runs 3 of its 10 rounds (the copy ``fig_async_r3``),
# cut to keep the script inside its time limit (10 → 5 → 3).
ASYNC_SWEEP_ROUNDS = 3
ASYNC_ACC = 0.05             # accuracy bar of the fleet plane and card-CPU


def _host() -> dict:
    """The host this run shares: its CPU model and cores, the load average
    (1, 5, 15 min) and the CPU seconds of this process and of its ended
    children so far, read where the script's wall moves with its host."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f
                          if line.startswith("model name")), None)
    except OSError:
        pass
    t = os.times()
    return {"cpu": model, "cores": os.cpu_count(),
            "loadavg": list(os.getloadavg()),
            "cpu_s": t.user + t.system,
            "children_cpu_s": t.children_user + t.children_system}


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


# --------------------------------------------------- commands run alongside
# The CLI checks (the sweep CLI's SIGTERM / --resume, the serve and train
# CLIs) spend most of their time starting Python and torch in a process of
# their own, so main() starts them together after phase 2 and each phase
# reads its result where it checks it.  Every process started here is
# recorded, and ended at exit if it still runs.
CLI_DIR = ROOT / "build" / "cli"
_CHILDREN: list = []


def _stop_children() -> None:
    for proc in _CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _src_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _popen(args: list, out_path: Path, err_path: Path | None = None):
    """``args`` started from the repo root with ``src`` on the path, its
    standard output (and error, unless ``err_path`` is given) to files."""
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with open(out_path, "w") as out, open(err_path or os.devnull, "w") as err:
        proc = subprocess.Popen(
            args, cwd=ROOT, env=_src_env(), stdout=out,
            stderr=err if err_path else subprocess.STDOUT)
    _CHILDREN.append(proc)
    return proc


def _run_cli(name: str, args: list, timeout: float) -> dict:
    """Runs ``args`` to its end: exit code, standard output and error, and
    seconds from start to exit (-9 if it outlived ``timeout``)."""
    t0 = time.perf_counter()
    out, err = CLI_DIR / f"{name}.out", CLI_DIR / f"{name}.err"
    proc = _popen(args, out, err)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    return {"returncode": proc.returncode, "stdout": out.read_text(),
            "stderr": err.read_text(), "seconds": time.perf_counter() - t0}


class _Alongside:
    """``fn()`` on a thread of its own, begun now; ``result()`` waits for
    it and returns what it returned (or raises what it raised).  ``fn``
    only starts processes and reads files: the checks stay with the
    caller."""

    def __init__(self, fn):
        import threading
        self._out: dict = {}

        def body():
            try:
                self._out["value"] = fn()
            except BaseException as exc:   # noqa: BLE001 — re-raised below
                self._out["error"] = exc
        self._thread = threading.Thread(target=body, daemon=True)
        self._thread.start()

    def result(self):
        self._thread.join()
        if "error" in self._out:
            raise self._out["error"]
        return self._out["value"]


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
    """The bf16 attention kernel holds its 64×D fp32 O tile, a tile of
    scores and P per thread on setmaxnreg's 240-register budget (at D =
    256 on 64-key tiles): ptxas must report no spill for any of its five
    instances, D = 64, 80, 128, 160, 256 (None: built before this run, no
    report)."""
    if log is None:
        print(json.dumps({"check": "flash_attention_wgmma_kernel spills",
                          "ok": None, "note": "built before this run"}))
        return
    spills = [st for e, st, _ in _ptxas_spills(log) if "wgmma_kernel" in e]
    ok = len(spills) == 5 and not any(spills)
    print(json.dumps({"check": "flash_attention_wgmma_kernel spills",
                      "spill_store_bytes": spills, "ok": ok}))
    if not ok:
        _fail(f"flash_attention_wgmma_kernel: ptxas spill bytes {spills}")


def _check_bwd_spills(log: str | None) -> None:
    """The attention backward's tensor-core kernels (dK/dV and dQ at D =
    64, 80, 128, 160, 256) and its Δ kernel (bf16, fp32) must build
    without spills: dK/dV holds two 64×D fp32 accumulators (one a pass
    past D = 128), Sᵀ and dPᵀ on setmaxnreg's 240 registers.  The fp32
    CUDA-core kernels' spills are printed."""
    if log is None:
        print(json.dumps({"check": "flash_attention_bwd spills", "ok": None,
                          "note": "built before this run"}))
        return
    spills = {}
    for entry, stores, loads in _ptxas_spills(log):
        name = next((k for k in ("fa_bwd_dkdv_wgmma_kernel",
                                 "fa_bwd_dq_wgmma_kernel",
                                 "fa_bwd_delta_kernel", "fa_bwd_dkdv_kernel",
                                 "fa_bwd_dq_kernel") if k in entry), entry)
        if "ILi" in entry:
            name += "<" + entry.split("ILi")[1].split("E")[0] + ">"
        elif "delta" in name:
            name += "<bf16>" if "bfloat16" in entry else "<f32>"
        spills[name] = [stores, loads]
    hot = {k: v for k, v in spills.items()
           if "wgmma" in k or "delta" in k}
    ok = len(hot) == 12 and not any(any(v) for v in hot.values())
    print(json.dumps({"check": "flash_attention_bwd spills",
                      "spill_bytes": spills, "ok": ok}))
    if not ok:
        _fail(f"flash_attention_bwd: ptxas spill bytes {hot}")


def _ptxas_table(log: str, names) -> dict:
    """Each kernel entry of one library's ptxas report by its name in
    ``names`` (with its template argument): [spill store bytes, spill load
    bytes, registers]."""
    regs, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry" in line:
            entry = line
        elif "Used" in line and "registers" in line and entry:
            regs[entry] = int(line.split("Used")[1].split("registers")[0])
    table = {}
    for entry, stores, loads in _ptxas_spills(log):
        name = next((k for k in names if k in entry), entry)
        if "ILi" in entry:
            name += "<" + entry.split("ILi")[1].split("E")[0] + ">"
        full = next((e for e in regs if entry in e), None)
        table[name] = [stores, loads, regs.get(full)]
    return table


SSD_BWD_KERNELS = ("ssd_bwd_local_wide_kernel", "ssd_bwd_local_kernel",
                   "ssd_bwd_pass_kernel", "ssd_bwd_wide_kernel",
                   "ssd_bwd_tile_kernel", "ssd_bwd_finish_kernel")


def _check_ssd_spills(log: str | None, bwd_log: str | None) -> None:
    """Every ssd_scan kernel (the state kernel at 2 and 4 n-tiles per unit,
    the pass, the scan kernel at one and two units per warp) and every
    kernel of its backward (the local term on TF32 wgmma and at 2 and 4
    n-tiles per unit on mma.sync, the reverse pass, the middle launch's
    wide (TF32 wgmma) and tile (mma.sync) kernels, the finishing kernel)
    must
    build without spills; the backward's SASS must hold no atomic
    (``cuobjdump``; its source is searched too)."""
    from repro_torch.kernels import build
    for label, text, names, count in (
            ("ssd_scan", log, ("ssd_state_kernel", "ssd_pass_kernel",
                               "ssd_scan_kernel"), 5),
            ("ssd_scan_bwd", bwd_log, SSD_BWD_KERNELS, 7)):
        if text is None:
            print(json.dumps({"check": f"{label} spills", "ok": None,
                              "note": "built before this run"}))
            continue
        spills = _ptxas_table(text, names)
        ok = len(spills) == count and not any(v[0] or v[1]
                                              for v in spills.values())
        print(json.dumps({"check": f"{label} spills",
                          "spill_store_load_registers": spills, "ok": ok}))
        if not ok:
            _fail(f"{label}: ptxas spill bytes {spills}")
    src = (ROOT / KERNEL_SOURCE / "ssd_scan_bwd.cu").read_text()
    sass_atomics = None
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        out = subprocess.run([tool, "-sass", str(build._target(
            "ssd_scan_bwd"))], capture_output=True, text=True, timeout=120)
        sass_atomics = len(re.findall(r"\b(?:ATOM|ATOMS|ATOMG|RED)\.",
                                      out.stdout))
        if out.returncode != 0 or "FFMA" not in out.stdout:
            sass_atomics = None
    line = {"check": "ssd_scan_bwd float atomics",
            "source_atomics": len(re.findall(
                r"\batomic[A-Z]\w*\(|\b(?:red|atom)\.", src)),
            "sass_atomics": sass_atomics}
    line["ok"] = line["source_atomics"] == 0 and sass_atomics in (0, None)
    print(json.dumps(line))
    if not line["ok"]:
        _fail(f"ssd_scan_bwd holds atomics: {line}")


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
    and the fused bids bit-equal to ``bid_value_fuse_ref``.  The
    ``w1_norm`` planner runs neither since ``bid_fused`` took its bid
    round (the Appendix-C bid rounds with learning values still launch
    ``bid_value_fuse``, in ``appendix_path``); these launches are returned
    apart from the main path's."""
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
    strategy, task, _, clients = DEVICE_PLANNER_RUN
    rounds = CHAIN_PARITY_ROUNDS
    spec = port.ExperimentSpec(
        task=task, alpha=0.3, num_samples=6000,
        fl=port.FLConfig(executor="fleet", strategy=strategy, rounds=rounds,
                         num_clients=clients, num_models=clients,
                         epsilon=0.04, gamma_min=1.0, seed=0, planner="jax",
                         uncertainty_weight=VALUE_WEIGHT))
    t0 = time.perf_counter()
    res, plans, counts = _planner_arms(torch,
                                       lambda: port.run_experiment(spec))
    a, b = res["shipped"], res["old_chain"]
    row = {"check": f"bid_fused vs the old chain, {strategy}/{task} "
                    f"planner=jax w={VALUE_WEIGHT}",
           "seconds": time.perf_counter() - t0,
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
        t0 = time.perf_counter()
        _, plans, counts = _planner_arms(torch, lambda: [
            _planner_case(planner, case, n, *seed) for seed in seeds])
        row = {"check": f"bid_fused vs the old chain, planner {case}",
               "seconds": time.perf_counter() - t0,
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
    """Phase 4: the fleet plane's FedDif quickstart cell at
    CHAIN_PARITY_ROUNDS rounds, gossip (2 rounds),
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
    cells = [("feddif/fcn", fcn("feddif", CHAIN_PARITY_ROUNDS))]
    cells += [(f"{st}/fcn", fcn(st, r)) for st, r in MIX_RUNS]
    cells.append(("feddif/lm full_f32", ExperimentSpec(
        **LM_DATA, adapter_hops=False,
        fl=FLConfig(**{**LM_FL, "rounds": CHAIN_PARITY_ROUNDS}))))
    shipped = ops.mix_aggregate_tree
    for name, spec in cells:
        res, counts = {}, {}
        t0 = time.perf_counter()
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
               "seconds": time.perf_counter() - t0,
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
        **LM_DATA, adapter_hops=True,
        fl=FLConfig(**{**LM_FL, "rounds": CHAIN_PARITY_ROUNDS},
                    hop_quant="int8"))),
        ("feddif/fcn host hop_quant=int8", ExperimentSpec(
            task="fcn", alpha=0.3, num_samples=6000, fl=FLConfig(
                strategy="feddif", rounds=2, num_clients=8, num_models=8,
                epsilon=0.04, gamma_min=1.0, seed=0, executor="host",
                hop_quant="int8")))]
    shipped = (executors.quant_roundtrip_tree, executors.quant_roundtrip_slots)
    for name, spec in cells:
        res, counts = {}, {}
        t0 = time.perf_counter()
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
               "seconds": time.perf_counter() - t0,
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
    # Device activity alone: the summary reads only kernel events, and with
    # the host-side events of a round (every op of the clients' training)
    # the five profiles of phase 5 took 81 s, against 24 s without them
    # (NVIDIA H100 80GB HBM3, 700.00 W).
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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


def _ssd_inputs(torch, gen, shape, kind: str):
    """(xh, a, b, c) on the card, shaped as the model's streams: Δ =
    softplus(·), a = −Δ·A with A in [1, 16] by head, x scaled by Δ, b and
    c through SiLU; at near-unit decay a = −1e-3·U(0.5, 1.5)."""
    import torch.nn.functional as F
    b, s, h, p, n = shape
    dt_ = F.softplus(0.5 * torch.randn((b, s, h), generator=gen,
                                       device="cuda") - 1.0)
    a = -dt_ * torch.exp(torch.linspace(0.0, 2.772588722, h, device="cuda"))
    if kind == "near_unit":
        a = -1e-3 * (0.5 + torch.rand((b, s, h), generator=gen,
                                      device="cuda"))
    xh = torch.randn((b, s, h, p), generator=gen,
                     device="cuda") * dt_[..., None]
    bm = F.silu(torch.randn((b, s, n), generator=gen, device="cuda"))
    cm = F.silu(torch.randn((b, s, n), generator=gen, device="cuda"))
    return xh, a, bm, cm


def _ssd_bwd_flops(b, s, h, p, n, chunk) -> float:
    """Operations of ssd_scan's backward on this shape, as its kernels form
    them (2 flops per FMA): per chunk and head, the chunk's own state
    gradient dYᵀ·C (L·P·N), B·Gᵀ (L·N·P), Wᵀ·dY and dY·Xᵀ on the triangle
    (P each a visible pair), dY·h and X·G (L·P·N each); per chunk C·Bᵀ, E·B
    and Eᵀ·C on the triangle (N each)."""
    flops = 0.0
    for t0 in range(0, s, chunk):
        lv = min(chunk, s - t0)
        tri = lv * (lv + 1) / 2
        flops += 2.0 * b * (h * (4 * lv * p * n + 2 * p * tri) + 3 * n * tri)
    return flops


def _lse_err(torch, lse, plain) -> dict:
    """The forward's lse against the plain one under LSE_BAR: the max abs
    error and the largest ratio of an element's error to its bar, over
    rows that see a key; +inf in the same rows."""
    none = torch.isposinf(plain)
    same_none = bool(torch.equal(torch.isposinf(lse), none))
    seen = ~none
    err = (lse - plain)[seen].abs()
    ratio = float((err / (LSE_BAR * (1.0 + plain[seen].abs()))).max()) \
        if bool(seen.any()) else 0.0
    return {"lse_max_abs_err": float(err.max()) if err.numel() else 0.0,
            "lse_bar_ratio": ratio, "lse_bar": LSE_BAR,
            "lse_inf_rows_match": same_none,
            "lse_ok": same_none and ratio <= 1.0}


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


def _attention_chunk_dropped(kref, q, k, v, **kw):
    """Attention as the plain version computes it, except that the scores
    leave out head-dim columns 128 and up (the third 64-column chunk at D =
    160): what a kernel that skipped that chunk's k-steps of Q·Kᵀ would
    return."""
    qd, kd_ = q.clone(), k.clone()
    qd[..., 128:] = 0
    kd_[..., 128:] = 0
    return kref.flash_attention_ref(qd, kd_, v, **kw)


def _attention_tile_dropped(torch, q, k, v, tile: int = 64,
                            causal: bool = True, start: int | None = None):
    """Attention as the plain version computes it, except that keys
    [start, start + tile) (start Sk/4 by default) are hidden from the
    queries past Sq/2: what a kernel that skipped one kv tile for those
    rows would return."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    start = sk // 4 if start is None else start
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
    rows = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    dropped = (rows >= sq // 2) & (k_pos >= start) & (k_pos < start + tile)
    if causal:
        dropped = dropped | ~(k_pos <= rows + (sk - sq))
    s = s.masked_fill(dropped, float("-inf"))
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
    from repro_torch.kernels.flash_attention import (BF16_HEAD_DIMS,
                                                     flash_attention_cuda,
                                                     fwd_kernel_launches)
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = []

    def record(row):
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"{row['name']} {row['shape']} disagrees with its plain "
                  f"version beyond its bars: {json.dumps(row)}")
        for key, control in row.items():
            if key.startswith("control_") and control["ok"]:
                _fail(f"{row['name']} {row['shape']}: the bars did not "
                      f"reject the planted fault {key}: "
                      f"{json.dumps(control)}")
        rows.append(row)

    heavy = dict(inner=5, reps=4, iters=10)
    light = dict(inner=10, reps=5, iters=20)
    slow = dict(inner=2, reps=2, iters=3)      # fp32 past D = 128: ~35 ms
    # flash_attention: (B, Sq, Sk, H, D, causal, window, dtype).  The bf16
    # qwen3 prefill shape comes first: it is the summary row.  The two
    # prefill shapes also run the planted-fault control.  The last two rows
    # are smollm_360m's full-length shape (H = 15, D = 64: the TMA strides)
    # and a window that is not a multiple of the 128-key tile (its lower
    # edge masked off the diagonal); then mixtral's prefill (S = 8192,
    # window 4096) with its 48 heads cut to 8, so that the plain version's
    # fp32 scores fit; then gemma3's global and local layers at prefill_32k's
    # sequence cut to 8192 (8 heads of D = 256, the local layers' 1024-key
    # window) and pixtral's prefill (1024 patches + 4096 text positions, 32
    # heads of D = 160), bf16 and fp32; then whisper_base's encoder
    # (8, 1500, 1500, 8, 64) and cross-attention (8, 448 queries, 1500
    # keys), non-causal over a key length of 11 × 128 + 92 (its prefill's 32
    # rows cut to 8, so that the plain version's fp32 scores stay small).
    # Each row's route is read from the library's counts
    # (fwd_kernel_launches): bf16 at a head dim of BF16_HEAD_DIMS through
    # that wgmma instance, fp32 through the CUDA-core kernel.  The pixtral
    # bf16 row also runs a planted fault, the scores without the third
    # 64-column chunk of D; the whisper rows one, the ragged last 92-key
    # tile hidden from the rows past Sq/2.
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
            (1, 4096, 4096, 8, 128, True, 1000, "bfloat16"),   # window 1000
            (1, 8192, 8192, 8, 128, True, 4096, "bfloat16"),   # mixtral
            (1, 8192, 8192, 8, 256, True, None, "bfloat16"),   # gemma3
            (1, 8192, 8192, 8, 256, True, 1024, "bfloat16"),   # its local
            (1, 5120, 5120, 32, 160, True, None, "bfloat16"),  # pixtral
            (1, 8192, 8192, 8, 256, True, None, "float32"),
            (1, 8192, 8192, 8, 256, True, 1024, "float32"),
            (1, 5120, 5120, 32, 160, True, None, "float32"),
            (8, 1500, 1500, 8, 64, False, None, "bfloat16"),   # whisper
            (8, 448, 1500, 8, 64, False, None, "bfloat16")):   # its cross
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, sk, h, d), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=causal, window=window)
        before = fwd_kernel_launches()
        out = flash_attention_cuda(q, k, v, **kw)
        out_l, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        after = fwd_kernel_launches()
        plain, lse_plain = kref.flash_attention_ref(q, k, v, return_lse=True,
                                                    **kw)
        torch.cuda.synchronize()
        check = _attn_err(torch, out, plain, dt)
        check.update(_lse_err(torch, lse, lse_plain))
        check["o_same_bits_with_lse"] = bool(torch.equal(out, out_l))
        check["routes"] = {n: after[n] - before[n] for n in after
                           if after[n] != before[n]}
        want_route = (f"flash_attention_wgmma_kernel<{d}>"
                      if dt == "bfloat16" and d in BF16_HEAD_DIMS
                      else "flash_attention_kernel")
        check["ok"] = (check["ok"] and check["lse_ok"]
                       and check["o_same_bits_with_lse"]
                       and check["routes"] == {want_route: 2})
        del out_l, lse, lse_plain
        if (b, sq, h, d, dt) in ((2, 4096, 16, 128, "bfloat16"),
                                 (1, 4096, 32, 80, "bfloat16")):
            check["control_tile_dropped"] = _attn_err(
                torch, _attention_tile_dropped(torch, q, k, v), plain, dt)
        if (d, dt) == (160, "bfloat16"):
            check["control_chunk_dropped"] = _attn_err(
                torch, _attention_chunk_dropped(kref, q, k, v, **kw), plain,
                dt)
        if not causal and dt == "bfloat16" and sk % 128:
            check["control_tail_tile_dropped"] = _attn_err(
                torch, _attention_tile_dropped(torch, q, k, v, sk % 128,
                                               False, sk - sk % 128),
                plain, dt)
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
        sizes = (slow if dt == "float32" and d > 128
                 else heavy if sq * sk >= 2 ** 20 else light)
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

    # ssd_scan: SSD_ROWS.
    for (b, s, h, p, n, chunk), kind in SSD_ROWS:
        xh, a, bm, cm = _ssd_inputs(torch, gen, (b, s, h, p, n), kind)
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


# Phase 7, decode and serving.  (a) The full-width engines at decode_32k's
# cache length (SHAPES["decode_32k"]: 32,768 tokens at batch 128), cut to 8
# slots: at 128 slots qwen3's KV cache alone would be 481 GB.  Each engine
# serves SERVE_REQUESTS requests (16 until the training phase came; 8 now,
# one a slot) of SERVE_PROMPT tokens (drawn from
# default_rng(0)) and SERVE_NEW new tokens; qwen3 also serves them sampled
# at examples/continuous_batching.py's temperature 0.8 and top-k 40.
SERVE_ARCHS = ("qwen3_0_6b", "zamba2_2_7b", "falcon_mamba_7b",
               "mixtral_8x22b", "qwen3_moe_235b_a22b", "gemma3_4b",
               "pixtral_12b")
# The MoE engines' depth, cut as their prefill runs' (ZOO_RUNS) so that the
# fp32 params fit: mixtral 4 of 56 layers (its swa rings 4352 positions),
# qwen3-moe 2 of 94.
SERVE_LAYERS = {"mixtral_8x22b": 4, "qwen3_moe_235b_a22b": 2}
SERVE_SLOTS = 8
SERVE_MAX_SEQ = 32768
# pixtral's cache at 8 × 32,768 positions would be 53.7 GB beside its 51.1
# GB of fp32 params: it serves 8 slots of 8,192 (a 13.4 GB cache).  gemma3
# serves the full 32,768: 5.4 GB for its five global layers, 1.2 GB for
# its 29 rings of 1,280.
SERVE_MAX_SEQS = {"pixtral_12b": 8192}
SERVE_REQUESTS = 8
SERVE_PROMPT = (64, 128)              # (64, 256) before the training phase
SERVE_NEW = 32
SERVE_SAMPLED = {"temperature": 0.8, "top_k": 40}
# (b) the serve CLI at full width: qwen3_0_6b, and whisper_base (frames
# drawn on the card, its cache built from them).
SERVE_CLI = ("--arch", "qwen3_0_6b", "--batch", "4", "--context", "64",
             "--new-tokens", "32")
SERVE_CLIS = (SERVE_CLI, ("--arch", WHISPER, "--batch", "4", "--context",
                          "64", "--new-tokens", "32"))
# (g) whisper_base's decode at full width: WHISPER_SLOTS slots of
# WHISPER_TEXT positions with cross caches over its 1,500 frames,
# WHISPER_FORCED teacher-forced steps then WHISPER_GREEDY greedy ones.
WHISPER_SLOTS = 8
WHISPER_FORCED = 64
WHISPER_GREEDY = 32
# (c) card against CPU on ZOO_CUTS: B = 2, SERVE_FORCED teacher-forced
# prompt tokens then SERVE_GREEDY greedy tokens (the CPU's, fed to both).
# Bars on the logits (max |card − cpu| over max |cpu| across all steps)
# and on every cache leaf at the end (the same ratio per leaf).  Set from
# readings on an H100 (PERF.md §6): fp32 logits within 3.4e-6 and caches
# within 3.3e-6; bf16 logits within 9.4e-3 and caches within 0.021
# (zamba2's); the controls' smallest errors 0.026 (logits) and 0.63
# (caches) in fp32, 0.030 and 0.76 in bf16.
SERVE_FORCED = 24
SERVE_GREEDY = 8
# The wide cuts (ZOO_WIDE_CUTS) decode fewer steps, (forced, greedy): on
# the CPU each bf16 step casts their 671M-entry readout to bf16.
SERVE_WIDE_STEPS = (6, 2)
SERVE_BARS = {"float32": {"logits_rel": 2e-5, "cache_rel": 2e-5},
              "bfloat16": {"logits_rel": 0.05, "cache_rel": 0.08}}
# The planted controls each cut's bars must reject: the new K/V written
# one position late, and the recurrent state not carried between steps.
SERVE_CONTROLS = {"qwen3_0_6b": ("kv_one_late",),
                  "zamba2_2_7b": ("kv_one_late", "state_not_carried"),
                  "falcon_mamba_7b": ("state_not_carried",),
                  "mixtral_8x22b": ("kv_one_late",),
                  "qwen3_moe_235b_a22b": ("kv_one_late",),
                  "moonshot_v1_16b_a3b": ("kv_one_late",),
                  "gemma3_4b": ("kv_one_late",),
                  "pixtral_12b": ("kv_one_late",)}
# (d) decode against the prefill forward (its kernels) on the fp32 cuts at
# S = 64, at the reference's own bar (tests/test_models_consistency.py).
SERVE_PREFILL_SEQ = 64
SERVE_PREFILL_TOL = 2e-4
# (e) the engine on the fp32 cuts: prompts of these lengths, 4 new tokens,
# 2 slots; and the sampler's configurations, card logits against the CPU.
SERVE_ENGINE_PROMPTS = (5, 7, 3, 6, 4)
SERVE_SAMPLERS = ({"temperature": 0.0}, {"temperature": 0.8},
                  {"temperature": 1.0, "top_k": 40},
                  {"temperature": 0.7, "top_p": 0.9},
                  {"temperature": 0.8, "top_k": 40, "top_p": 0.9})
# (f) glibc powf's tensor form, card against CPU (2^24 inputs until the
# training phase came).
SERVE_POWF_N = 1 << 22


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


def _moe_work(cfg, tokens: int, wall: float) -> dict:
    """An MoE config's expert SwiGLU work in one forward of ``tokens``
    tokens (2 flops per FMA, three products a row): the dropless
    dispatch's E·capacity rows against the T·k rows the router sends, and
    the dispatch's rate over the forward's wall (an upper bound on the
    experts' share); {} without MoE."""
    from repro_torch.models.transformer import specs_for
    m = specs_for(cfg)[2]
    if m is None:
        return {}
    per_row = 6.0 * cfg.d_model * m.d_ff_expert * cfg.num_layers
    dispatch = per_row * m.num_experts * m.capacity(tokens)
    active = per_row * tokens * m.top_k
    return {"moe_dispatch_tflop": dispatch / 1e12,
            "moe_active_tflop": active / 1e12,
            "moe_dispatch_over_active": dispatch / active,
            "moe_dispatch_tflops_over_wall": dispatch / 1e12 / wall}


def zoo_prefill(torch, kd) -> dict:
    """Phase 6b: ``make_prefill_step`` of each full-width config on the
    card, from random params drawn there, under inference_mode.  One
    untimed forward first (cuBLAS handles, first launches), then the
    counters are zeroed, one forward is timed on the host clock (ending in
    a synchronize), and the counters are read: each kernel must have
    launched once per layer that runs it, through the wgmma instance of
    its head dim (fwd_kernel_launches), once windowed per ``swa`` layer.
    A vision config's batch carries ZOO_PATCHES seeded patch embeddings
    ahead of its text.  The qwen3 and mixtral runs are then profiled.  Each model is freed, and the garbage collector run,
    before the next run's peak-memory reset (a reference cycle keeps a
    model's params allocated until the collector runs).  Last, zamba2 is
    built again from the same init and one forward profiled.  The configs
    run at published widths, the MoE ones at ZOO_RUNS' depth; an MoE run
    also prints its dropless dispatch work beside its active work
    (_moe_work), and its two forwards must give the same loss bits."""
    import dataclasses
    from unittest import mock
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import (BF16_HEAD_DIMS,
                                                     fwd_kernel_launches)
    from repro_torch.models.transformer import build_plan
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_leaves
    launches = {name: 0 for name in kd.LAUNCHES}
    real_attention = ops.flash_attention
    windowed = [0]

    def counting_attention(*args, window=None, **kw):
        windowed[0] += window is not None
        return real_attention(*args, window=window, **kw)

    def setup(arch, layers=None):
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(0)
        return cfg, model, gen

    for arch, b, s, want, layers in ZOO_RUNS:
        cfg, model, gen = setup(arch, layers)
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
            if cfg.frontend == "vision":
                batch["patch_embeddings"] = torch.randn(
                    (b, ZOO_PATCHES, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
            positions = s + (ZOO_PATCHES if cfg.frontend == "vision" else 0)
            first = float(step(params, batch))
            torch.cuda.synchronize()
            kd.reset_launch_counts()
            routes = fwd_kernel_launches()
            windowed[0] = 0
            t0 = time.perf_counter()
            with mock.patch.object(ops, "flash_attention",
                                   counting_attention):
                loss = float(step(params, batch))
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in kd.LAUNCHES.items() if v}
            after = fwd_kernel_launches()
            routes = {n: after[n] - routes[n] for n in after
                      if after[n] != routes[n]}
            d = cfg.resolved_head_dim
            want_routes = ({} if "flash_attention" not in want else {
                f"flash_attention_wgmma_kernel<{d}>" if d in BF16_HEAD_DIMS
                else "flash_attention_kernel": want["flash_attention"]})
            want_windowed = sum(count for kinds, count in build_plan(cfg)
                                for kind in kinds if kind == "swa")
            peak = torch.cuda.max_memory_allocated()
            n_params = sum(x.numel() for x in tree_leaves(params))
            print(json.dumps({
                "run": f"prefill {arch}", "layers": cfg.num_layers,
                "published_layers": get_config(arch).num_layers,
                "batch": b, "seq": s, "positions": positions,
                "train_4k_seq": SHAPES["train_4k"].seq_len,
                "prefill_32k_seq": SHAPES["prefill_32k"].seq_len,
                "params": n_params,
                "compute_dtype": cfg.compute_dtype, "loss": loss,
                "prefill_s": wall, "tokens_per_s": b * positions / wall,
                "init_s": init_s, "peak_memory_gb": peak / 2 ** 30,
                "launches": counts, "want_launches": want,
                "routes": routes, "windowed_launches": windowed[0],
                "want_windowed": want_windowed,
                **_moe_work(cfg, b * s, wall),
                **({"same_loss_twice": first == loss} if cfg.moe is not None
                   else {})}))
            if cfg.moe is not None and first != loss:
                _fail(f"prefill {arch}: two forwards gave losses {first} "
                      f"and {loss} (the MoE combine must be deterministic)")
            if not math.isfinite(loss):
                _fail(f"prefill {arch}: loss {loss} is not finite")
            if counts != want:
                _fail(f"prefill {arch}: launches {counts}, want {want}")
            if routes != want_routes or windowed[0] != want_windowed:
                _fail(f"prefill {arch}: routes {routes} with "
                      f"{windowed[0]} windowed, want {want_routes} with "
                      f"{want_windowed}")
            for k, v in counts.items():
                launches[k] += v
            if arch in ("qwen3_0_6b", "mixtral_8x22b"):
                _profile_prefill(torch, step, params, batch,
                                 f"{arch} B={b} S={s}")
        del params, batch
        torch.cuda.empty_cache()
    arch, b, s, _, _ = next(r for r in ZOO_RUNS if r[0] == "zamba2_2_7b")
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


class _Routing:
    """The MoE router's top-k choices of one run (the CPU's: ``record``),
    handed to later runs (``follow``) at the tokens where their own choice
    differs at a near tie: log(p_k / p_{k+1}) within ROUTE_NEAR_TIE.  In
    bf16 one ulp of a router's input moves its logits by ~1e-3, and a token
    routed to another expert differs by the size of its output; the
    comparison holds everything else.  Calls are matched in order (the same
    code path on both sides); ``followed`` counts the tokens handed over
    since the last ``follow`` and ``max_gap`` the largest gap among them."""

    def __init__(self, moe_lib):
        self.real = moe_lib._top_k
        self.calls: list = []
        self.i = self.followed = 0
        self.max_gap = 0.0

    def record(self):
        def top_k(a, k):
            vals, idx = self.real(a, k)
            self.calls.append(idx.cpu())
            return vals, idx
        return top_k

    def follow(self):
        import torch
        self.i = self.followed = 0
        self.max_gap = 0.0

        def top_k(a, k):
            vals, idx = self.real(a, k)
            if self.i >= len(self.calls):
                return vals, idx
            want = self.calls[self.i].to(idx.device)
            self.i += 1
            top = torch.sort(a, dim=-1, descending=True).values
            gap = torch.log(top[:, k - 1] / top[:, k])
            differ = (torch.sort(idx, dim=-1).values
                      != torch.sort(want, dim=-1).values).any(-1)
            take = (gap <= ROUTE_NEAR_TIE) & differ
            self.followed += int(take.sum())
            if bool(take.any()):
                self.max_gap = max(self.max_gap, float(gap[take].max()))
            idx = torch.where(take[:, None], want, idx)
            return torch.gather(a, -1, idx), idx
        return top_k


def _expert_swapped(torch, real):
    """The MoE router's top-k with each token's first two weights exchanged
    and its experts kept: a combine that weighs the experts the wrong way
    round."""
    def wrong(a, k):
        vals, idx = real(a, k)
        return torch.cat([vals[..., 1:2], vals[..., :1], vals[..., 2:]],
                         dim=-1), idx
    return wrong


def _window_wide(op):
    """flash_attention with its sliding window one key wider."""
    def wrong(*args, window=None, **kw):
        return op(*args, window=None if window is None else window + 1, **kw)
    return wrong


def _all_global(op):
    """flash_attention with its sliding window dropped."""
    def wrong(*args, window=None, **kw):
        return op(*args, window=None, **kw)
    return wrong


def _text_positions_from_zero(real, n_patches: int):
    """forward_hidden with the text's positions restarting at 0 after the
    patch embeddings, as a prefix that kept its own position count would
    leave them."""
    def wrong(params, cfg, x, positions=None, **kw):
        past = (positions >= n_patches).to(positions.dtype)
        return real(params, cfg, x, positions - n_patches * past, **kw)
    return wrong


def zoo_card_vs_cpu(torch) -> None:
    """Phase 6c: a 2-layer cut of each full-width config (B = 1, S = 256)
    and the MoE smoke configs (ZOO_CUTS, ZOO_PREFILL_CUTS), and the wide
    cuts (ZOO_WIDE_CUTS: gemma3 over 1,536 tokens, pixtral over 1,024
    patches and 64 text tokens) on the card (its
    kernels) against the CPU (plain versions), from one init drawn on the
    card, in the config's bf16 compute and in fp32 compute (where card and
    CPU differ only by fp32 sum orders): the prefill loss and the final
    hidden states (read from the prefill step's forward) within ZOO_BARS,
    the wide cuts' losses within ZOO_LOSS_ABS.  Then two controls on the card with the
    family's kernel op (ZOO_CONTROL_OP) swapped for a wrong variant: its
    output one step late, and its sequence halves run apart; and on an MoE
    cut its ZOO_MOE_CONTROLS, on a wide cut its ZOO_FAMILY_CONTROLS.  The
    bars must reject the controls named in CONTROLS_REJECTED and every MoE
    and family control; the others' readings are
    printed (in bf16 a Mamba state dropped at S/2 fades within a few
    steps, below the bf16 noise of the final hidden states)."""
    from unittest import mock
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_map
    for (arch, extra), dtype in itertools.product(
            ZOO_CUTS + ZOO_PREFILL_CUTS + ZOO_WIDE_CUTS, ZOO_BARS):
        t_cut = time.perf_counter()
        cfg = _cut_config(arch, extra, dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        op = ZOO_CONTROL_OP[arch]
        real = getattr(ops, op)
        seq = ZOO_CUT_SEQS.get(arch, ZOO_CUT_SEQ)
        n_patches = ZOO_PATCHES if cfg.frontend == "vision" else 0
        moe_controls = ZOO_MOE_CONTROLS.get(arch, ())
        family_controls = ZOO_FAMILY_CONTROLS.get(arch, ())
        patches = {"one_step_late": [(ops, op, _one_step_late(torch, real))],
                   "halves_apart": [(ops, op, _halves_apart(torch, real))],
                   "window_wide": [(ops, "flash_attention",
                                    _window_wide(ops.flash_attention))],
                   "all_global": [(ops, "flash_attention",
                                   _all_global(ops.flash_attention))],
                   "embed_unscaled": [(L, "embed_scale",
                                       lambda d_model, dtype: 1.0)],
                   "text_positions_from_zero": [
                       (tf, "forward_hidden", _text_positions_from_zero(
                           tf.forward_hidden, n_patches))]}
        # The CPU first: an MoE cut's card runs follow its near ties.
        names = ("cpu", "card", "one_step_late", "halves_apart",
                 *moe_controls, *family_controls)
        routing = _Routing(moe_lib)
        out, followed = {}, {}
        with torch.inference_mode():
            params = model.init(gen)
            tokens = torch.randint(0, cfg.vocab_size, (1, seq),
                                   generator=gen, device="cuda")
            prefix = (torch.randn((1, n_patches, cfg.d_model), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      if n_patches else None)
            for where in names:
                p = params if where != "cpu" else tree_map(
                    lambda x: x.cpu(), params)
                t = tokens if where != "cpu" else tokens.cpu()
                batch = {"tokens": t, "labels": torch.roll(t, -1, dims=1)}
                if prefix is not None:
                    batch["patch_embeddings"] = prefix.to(t.device)
                with contextlib.ExitStack() as stack:
                    for obj, attr, fn in patches.get(where, ()):
                        stack.enter_context(mock.patch.object(obj, attr, fn))
                    if cfg.moe is not None:
                        top_k = (routing.record() if where == "cpu"
                                 else routing.follow())
                        if where == "expert_swapped":
                            top_k = _expert_swapped(torch, top_k)
                        stack.enter_context(mock.patch.object(
                            moe_lib, "_top_k", top_k))
                    # One forward: the prefill step, its final hidden
                    # states read on the way out of forward_hidden.
                    seen = []
                    inner = tf.forward_hidden

                    def capture(*args, inner=inner, seen=seen, **kw):
                        result = inner(*args, **kw)
                        seen.append(result[0])
                        return result

                    stack.enter_context(mock.patch.object(
                        tf, "forward_hidden", capture))
                    loss = float(make_prefill_step(model)(p, batch))
                    hidden = seen[-1]
                out[where] = (hidden.float().cpu(), loss)
                followed[where] = [routing.followed, routing.max_gap]
                del p
        bars = dict(ZOO_BARS[dtype])
        bars["loss_abs"] = max(bars["loss_abs"], ZOO_LOSS_ABS.get(arch, 0.0))
        check = _hidden_check(out["card"], out["cpu"], bars)
        controls = {name: {**_hidden_check(out[name], out["cpu"], bars),
                           "must_fail": (name in CONTROLS_REJECTED[dtype]
                                         or name in moe_controls
                                         or name in family_controls)}
                    for name in names[2:]}
        print(json.dumps({
            "check": f"card_vs_cpu prefill {cfg.name} 2-layer cut {dtype}",
            "plan": [[list(k), c] for k, c in tf.build_plan(cfg)],
            "seq": seq, "patches": n_patches,
            "seconds": time.perf_counter() - t_cut,
            "loss": [out["card"][1], out["cpu"][1]], "bars": bars,
            **check, "control_op": op, "controls": controls,
            **({"near_ties_followed_and_max_gap": followed}
               if cfg.moe is not None else {})}))
        if not check["ok"]:
            _fail(f"card_vs_cpu prefill {arch} {dtype}: card and CPU "
                  f"disagree")
        for name, c in controls.items():
            if c["must_fail"] and c["ok"]:
                _fail(f"card_vs_cpu prefill {arch} {dtype}: the bars did "
                      f"not reject the control {name} of {op}")
        del params
        torch.cuda.empty_cache()


def _whisper_cut(change: dict, dtype: str):
    """A WHISPER_CUTS config (whisper-smoke with ``change``) in ``dtype``
    compute."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(WHISPER),
                               compute_dtype=dtype, **change)


def whisper_prefill(torch, kd) -> dict:
    """Phase 6b, the audio family: ``make_prefill_step`` of whisper_base at
    full width and depth, B = 32 × (1,500 frame embeddings drawn N(0, 1)
    in bf16 + WHISPER_TEXT tokens), from random params drawn on the card,
    under inference_mode: one untimed forward, then one timed on the host
    clock with the counters zeroed.  flash_attention must launch
    WHISPER_ATTN times through ``flash_attention_wgmma_kernel<64>``,
    WHISPER_NONCAUSAL of them non-causal (the encoder's and the
    cross-attention); the loss finite.  Prints seconds, tokens/s over
    frames and tokens, peak memory (the collector run first) and the
    loss; then one forward under ``torch.profiler``."""
    from unittest import mock
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import fwd_kernel_launches
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_leaves
    cfg = get_config(WHISPER)
    b, s = SHAPES["prefill_32k"].global_batch, WHISPER_TEXT
    frames = cfg.num_frontend_tokens
    model = build_model(cfg)
    step = make_prefill_step(model)
    real = ops.flash_attention
    noncausal = [0]

    def counting(*args, causal=True, **kw):
        noncausal[0] += not causal
        return real(*args, causal=causal, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        batch = {"frames": torch.randn((b, frames, cfg.d_model),
                                       generator=gen, device="cuda"
                                       ).to(torch.bfloat16),
                 "tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device="cuda")}
        first = float(step(params, batch))
        torch.cuda.synchronize()
        kd.reset_launch_counts()
        before = fwd_kernel_launches()
        t0 = time.perf_counter()
        with mock.patch.object(ops, "flash_attention", counting):
            loss = float(step(params, batch))
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in kd.LAUNCHES.items() if v}
        after = fwd_kernel_launches()
        routes = {n: after[n] - before[n] for n in after
                  if after[n] != before[n]}
        peak = torch.cuda.max_memory_allocated()
        want_routes = {"flash_attention_wgmma_kernel<64>":
                       WHISPER_ATTN["flash_attention"]}
        print(json.dumps({
            "run": f"prefill {WHISPER}",
            "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.num_layers, "batch": b, "frames": frames,
            "text": s, "positions": frames + s,
            "prefill_32k_batch": SHAPES["prefill_32k"].global_batch,
            "params": sum(x.numel() for x in tree_leaves(params)),
            "compute_dtype": cfg.compute_dtype, "loss": loss,
            "same_loss_twice": first == loss, "prefill_s": wall,
            "tokens_per_s": b * (frames + s) / wall,
            "text_tokens_per_s": b * s / wall, "init_s": init_s,
            "peak_memory_gb": peak / 2 ** 30, "launches": counts,
            "want_launches": WHISPER_ATTN, "routes": routes,
            "noncausal_launches": noncausal[0],
            "want_noncausal": WHISPER_NONCAUSAL}))
        if not math.isfinite(loss):
            _fail(f"prefill {WHISPER}: loss {loss} is not finite")
        if (counts != WHISPER_ATTN or routes != want_routes
                or noncausal[0] != WHISPER_NONCAUSAL):
            _fail(f"prefill {WHISPER}: launches {counts}, routes {routes}, "
                  f"{noncausal[0]} non-causal; want {WHISPER_ATTN}, "
                  f"{want_routes}, {WHISPER_NONCAUSAL}")
        _profile_prefill(torch, step, params, batch,
                         f"{WHISPER} B={b} T={frames} S={s}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def _roll_context(torch, real):
    """``attn_forward`` whose cross-attention reads the next batch row's
    context (its frames' encoder states)."""
    def wrong(p, spec, x, positions=None, context=None):
        if context is not None:
            context = torch.roll(context, 1, dims=0)
        return real(p, spec, x, positions, context)
    return wrong


def whisper_card_vs_cpu(torch) -> None:
    """Phase 6c, the audio family: WHISPER_CUTS on the card (its kernels)
    against the CPU (plain versions) from one init drawn on the card, B = 2
    over the cut's frames and WHISPER_CUT_TEXT tokens, in bf16 and fp32
    compute: the encoder's states (with the loss) and the decoder's final
    hidden states (with the loss) each within ZOO_BARS.  Then
    WHISPER_CONTROLS on the card, which the bars must reject: the encoder's
    spec causal, and the cross-attention reading the next row's frames."""
    from unittest import mock
    from repro_torch.models import encdec as ed
    from repro_torch.models.zoo import build_model
    from repro_torch.train.trainstep import make_prefill_step
    from repro_torch.tree import tree_map
    real_spec = ed.enc_spec
    patches = {"causal_encoder": (ed, "enc_spec", lambda cfg: (
                   dataclasses.replace(real_spec(cfg), causal=True))),
               "cross_wrong_frames": (ed, "attn_forward", _roll_context(
                   torch, ed.attn_forward))}
    for (label, change), dtype in itertools.product(WHISPER_CUTS, ZOO_BARS):
        t_cut = time.perf_counter()
        cfg = _whisper_cut(change, dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        out = {}
        with torch.inference_mode():
            params = model.init(gen)
            frames = torch.randn((2, cfg.num_frontend_tokens, cfg.d_model),
                                 generator=gen, device="cuda")
            tokens = torch.randint(0, cfg.vocab_size, (2, WHISPER_CUT_TEXT),
                                   generator=gen, device="cuda")
            for where in ("cpu", "card", *WHISPER_CONTROLS):
                dev = "cpu" if where == "cpu" else "cuda"
                p = tree_map(lambda x: x.to(dev), params)
                f, t = frames.to(dev), tokens.to(dev)
                with contextlib.ExitStack() as stack:
                    if where in patches:
                        stack.enter_context(mock.patch.object(
                            *patches[where]))
                    enc = ed.encode(p, cfg, f, remat=False)
                    hid = ed._decode_hidden(p, cfg, t, enc, remat=False)
                    loss = float(make_prefill_step(model)(p, {
                        "frames": f, "tokens": t,
                        "labels": torch.roll(t, -1, dims=1)}))
                out[where] = (enc.float().cpu(), hid.float().cpu(), loss)
                del p, enc, hid
        bars = ZOO_BARS[dtype]

        def check(where):
            enc, hid, loss = out[where]
            enc_ref, hid_ref, loss_ref = out["cpu"]
            e = _hidden_check((enc, loss), (enc_ref, loss_ref), bars)
            d = _hidden_check((hid, loss), (hid_ref, loss_ref), bars)
            return {"encoder": e, "decoder": d, "ok": e["ok"] and d["ok"]}

        line = {"check": f"card_vs_cpu prefill {label} {dtype}",
                "head_dim": cfg.resolved_head_dim,
                "frames": cfg.num_frontend_tokens, "text": WHISPER_CUT_TEXT,
                "seconds": time.perf_counter() - t_cut,
                "loss": [out["card"][2], out["cpu"][2]], "bars": bars,
                **check("card"),
                "controls": {name: check(name) for name in WHISPER_CONTROLS}}
        print(json.dumps(line))
        if not line["ok"]:
            _fail(f"card_vs_cpu prefill {label} {dtype}: card and CPU "
                  f"disagree")
        for name, c in line["controls"].items():
            if c["ok"]:
                _fail(f"card_vs_cpu prefill {label} {dtype}: the bars did "
                      f"not reject the control {name}")
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


def _cut_sweep(sweep: str, rounds: int) -> str:
    """The name of a copy of ``sweep`` whose full grid runs ``rounds``
    rounds, registered once."""
    from repro_torch.experiments import registry
    name = f"{sweep}_r{rounds}"
    if name not in registry.REGISTRY:
        registry.register(dataclasses.replace(
            registry.get_sweep(sweep), name=name, rounds=rounds))
    return name


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
        # fig3_alpha's full grid at FIG3_ROUNDS: the device pre-planner
        # plans all its FedDif rounds first; the cells then replay them.
        fig3 = _cut_sweep("fig3_alpha", FIG3_ROUNDS)
        cells = expand_sweep(fig3, smoke=False, executor="fleet",
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
            "sweep_preplan": fig3, "planned": pre["planned"],
            "skipped": pre["skipped"], "batches": pre["batches"],
            "seconds": pre_s, "s_per_planned_round": pre_s / max(
                pre["planned"], 1),
            "loop_iterations": st.get("loop_iterations", 0),
            "auction_iterations": st.get("auction_iterations", 0),
            "launches": {k: v for k, v in counts.items() if v}}))
        if pre["planned"] != feddif_rounds or feddif_rounds != 5 * FIG3_ROUNDS:
            _fail(f"fig3 pre-plan planned {pre['planned']} rounds, want "
                  f"{feddif_rounds} (= {5 * FIG3_ROUNDS})")
        if (counts["bid_fused"] != st.get("loop_iterations", -1)
                or counts["bid_fused"] == 0
                or sum(counts.values()) != counts["bid_fused"]):
            _fail(f"fig3 pre-plan launched {counts} over "
                  f"{st.get('loop_iterations')} bid rounds")
        art, per_cell, wall = _sweep(
            torch, kd, runs, fig3, smoke=False, executor="fleet",
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
    return total


class _TimedSaves:
    """Times every ``RoundCheckpointer.save`` while active and sizes the
    files each one writes (npz and metadata JSON)."""

    def __init__(self):
        from repro_torch.fl.resume import RoundCheckpointer
        self.cls, self.real = RoundCheckpointer, RoundCheckpointer.save
        self.seconds: list[float] = []
        self.bytes: list[int] = []
        timed = self

        def save(ckpt, step, *args, **kw):
            t0 = time.perf_counter()
            try:
                return timed.real(ckpt, step, *args, **kw)
            finally:
                timed.seconds.append(time.perf_counter() - t0)
                stem = os.path.join(ckpt.directory, f"ckpt_{step:08d}")
                timed.bytes.append(sum(os.path.getsize(stem + s)
                                       for s in (".npz", ".json")
                                       if os.path.exists(stem + s)))

        self.save = save

    def __enter__(self):
        self.cls.save = self.save
        return self

    def __exit__(self, *exc):
        self.cls.save = self.real


def _same_artifact(a: dict, b: dict) -> bool:
    """Two sweep artifacts equal after ``strip_volatile``, the durable
    run's manifest path aside."""
    from repro_torch.experiments import strip_volatile
    a, b = strip_volatile(a), strip_volatile(b)
    a.pop("manifest", None), b.pop("manifest", None)
    return (json.dumps(a, sort_keys=True, default=str)
            == json.dumps(b, sort_keys=True, default=str))


def _durable_run(torch, kd, port, executor: str, strategy: str,
                 rounds: int, kill: int) -> dict:
    """(a): one run killed after round ``kill``'s checkpoint and resumed,
    against the same run uninterrupted.  Returns the killed and resumed
    halves' launches."""
    from repro_torch.fl.resume import Preempted, RoundCheckpointer
    from repro_torch.train.checkpoint import valid_steps
    spec = port.ExperimentSpec(
        task="fcn", alpha=0.3, num_samples=6000,
        fl=port.FLConfig(executor=executor, strategy=strategy,
                         rounds=rounds, num_clients=8, num_models=8, seed=0,
                         checkpoint_every=1))
    root = DURABLE_DIR / f"{executor}_{strategy}"
    shutil.rmtree(root, ignore_errors=True)
    with _TimedSaves() as saves:
        kd.reset_launch_counts()
        t0 = time.perf_counter()
        clean = port.run_experiment(spec, checkpoint_dir=str(root / "clean"))
        torch.cuda.synchronize()
        clean_s = time.perf_counter() - t0
        clean_counts = dict(kd.LAUNCHES)
    kd.reset_launch_counts()
    RoundCheckpointer.fail_after_save = kill
    try:
        port.run_experiment(spec, checkpoint_dir=str(root / "killed"))
    except Preempted:
        preempted = True
    else:
        preempted = False
    finally:
        RoundCheckpointer.fail_after_save = None
    kept = valid_steps(str(root / "killed"))
    t0 = time.perf_counter()
    resumed = port.run_experiment(spec, checkpoint_dir=str(root / "killed"))
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    counts = dict(kd.LAUNCHES)
    same = {
        "params_bits": _bits_equal(torch, clean.params, resumed.params),
        "ledger": clean.ledger.as_dict() == resumed.ledger.as_dict(),
        "accuracy": clean.accuracy == resumed.accuracy,
        "loss": clean.loss == resumed.loss,
        "diffusion_rounds": clean.diffusion_rounds
        == resumed.diffusion_rounds,
        "iid_distance": clean.iid_distance == resumed.iid_distance,
        "launches": counts == clean_counts}
    print(json.dumps({
        "durable_run": f"{executor}/{strategy}/fcn", "rounds": rounds,
        "killed_after_round": kill, "preempted": preempted,
        "checkpoints_at_kill": kept, "same": same,
        "peak_accuracy": max(resumed.accuracy),
        "clean_s": clean_s, "resumed_s": resumed_s, "saves": len(saves.seconds),
        "s_per_save": sum(saves.seconds) / max(len(saves.seconds), 1),
        "max_s_per_save": max(saves.seconds, default=0.0),
        "bytes_per_save": saves.bytes[0] if saves.bytes else 0,
        "launches": {k: v for k, v in counts.items() if v}}))
    want_mix = rounds if strategy == "feddif" and executor == "fleet" else (
        0 if executor == "host" else clean_counts["mix_tree"])
    if not preempted or kept[-1:] != [kill] or not all(same.values()):
        _fail(f"durable {executor}/{strategy}: preempted {preempted}, "
              f"checkpoints {kept}, same {same}")
    if (counts["mix_tree"] != want_mix or counts["mix_aggregate"]
            or (executor == "fleet" and counts["mix_tree"] < rounds)):
        _fail(f"durable {executor}/{strategy}: mix_tree launched "
              f"{counts['mix_tree']} times over the killed and resumed "
              f"halves, want {want_mix}")
    return counts


def _durable_sweep(torch, kd) -> dict:
    """(b): fig5_gamma_min's smoke grid, fleet plane, device planner,
    durable: killed inside its second cell, then resumed.  Returns the
    killed and resumed runs' launches."""
    from repro_torch.experiments import SweepManifest, cell_slug, run_sweep
    from repro_torch.fl.resume import Preempted, RoundCheckpointer
    root = DURABLE_DIR / "fig5_gamma_min"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(executor="fleet", planner="jax", seeds=(0,),
              state_dir=str(root / "state"), out_dir=str(root / "out"))
    clean = run_sweep("fig5_gamma_min", executor="fleet", planner="jax",
                      seeds=(0,), out_dir=None)
    first, second = (c["label"] for c in clean["cells"])
    real = RoundCheckpointer.save

    def kill_in_second_cell(ckpt, step, *args, **k):
        path = real(ckpt, step, *args, **k)
        if cell_slug(second) in ckpt.directory:
            raise Preempted(f"killed after {ckpt.directory} step {step}")
        return path

    total = {k: 0 for k in kd.LAUNCHES}
    kd.reset_launch_counts()
    RoundCheckpointer.save = kill_in_second_cell
    try:
        run_sweep("fig5_gamma_min", checkpoint_every=1, **kw)
    except Preempted:
        killed = True
    else:
        killed = False
    finally:
        RoundCheckpointer.save = real
    torch.cuda.synchronize()
    for k in total:
        total[k] += kd.LAUNCHES[k]
    status = SweepManifest.load(kw["state_dir"]).data["cells"]
    snaps = []

    def log(line):
        torch.cuda.synchronize()
        snaps.append((line, dict(kd.LAUNCHES)))

    kd.reset_launch_counts()
    resumed = run_sweep("fig5_gamma_min", resume=True, log=log, **kw)
    torch.cuda.synchronize()
    for k in total:
        total[k] += kd.LAUNCHES[k]
    preplan = next(c for line, c in snaps if ",preplan," in line)
    misses = [c["plan_cache"]["misses"] for c in resumed["cells"]]
    same = _same_artifact(clean, resumed)
    rounds = sum(len(c["diffusion_rounds"]) for c in clean["cells"])
    print(json.dumps({
        "check": "fig5_gamma_min durable sweep killed in its second cell, "
                 "resumed", "killed": killed,
        "status_at_kill": {k: v["status"] for k, v in status.items()},
        "resumed_preplan_bid_fused": preplan["bid_fused"],
        "resumed_bid_fused": kd.LAUNCHES["bid_fused"],
        "resumed_misses": misses, "equal_after_strip_volatile": same,
        "mix_tree_killed_plus_resumed": total["mix_tree"],
        "failed_cells": resumed["failed_cells"]}))
    if (not killed or status[first]["status"] != "done"
            or status[second]["status"] != "running" or not same
            or preplan["bid_fused"] or kd.LAUNCHES["bid_fused"] or any(misses)
            or resumed["failed_cells"] or total["mix_tree"] != rounds):
        _fail("fig5 durable sweep: kill / resume check failed")
    return total


def _sigterm_cli_runs() -> dict:
    """(c)'s two processes: the sweep CLI sent SIGTERM once a round
    checkpoint is committed, then rerun with --resume.  Starts and reads
    processes only (it runs alongside other phases, ``_Alongside``)."""
    import signal
    root = DURABLE_DIR / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    state, out = root / "state", root / "out"
    args = [sys.executable, "-m", "repro_torch.launch.sweep",
            "--sweep", "fig4_epsilon", "--executor", "fleet",
            "--checkpoint-every", "1", "--state-dir", str(state),
            "--out-dir", str(out)]

    def committed():
        return any(f.startswith("ckpt_") and f.endswith(".json")
                   for _, _, files in os.walk(state / "cells")
                   for f in files)

    t0 = time.perf_counter()
    proc = _popen(args, root / "killed.log")
    deadline = time.time() + 120
    while (time.time() < deadline and proc.poll() is None
           and not committed()):
        time.sleep(0.005)
    was_committed = committed()
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    killed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    resume = _popen(args + ["--resume"], root / "resumed.log")
    try:
        resume.wait(timeout=300)
    except subprocess.TimeoutExpired:
        resume.kill()
        resume.wait()
    resumed = None
    if resume.returncode == 0:
        with open(out / "BENCH_feddif_fig4_epsilon.json") as f:
            resumed = json.load(f)
    return {"checkpoint_committed": was_committed,
            "killed_returncode": proc.returncode,
            "resume_returncode": resume.returncode, "killed_s": killed_s,
            "resume_s": time.perf_counter() - t0, "resumed": resumed,
            "logs": str(root)}


def _sigterm_cli(torch, runs: _Alongside | None = None) -> None:
    """(c): the sweep CLI sent SIGTERM once a round checkpoint is
    committed, rerun with --resume (``_sigterm_cli_runs``, begun here
    unless ``runs`` already holds it), against a clean in-process run."""
    import signal
    from repro_torch.experiments import run_sweep
    clean = run_sweep("fig4_epsilon", executor="fleet", out_dir=None)
    r = (runs or _Alongside(_sigterm_cli_runs)).result()
    resumed = r.pop("resumed")
    same = resumed is not None and _same_artifact(clean, resumed)
    print(json.dumps({
        "check": "fig4_epsilon CLI: SIGTERM after a committed round "
                 "checkpoint, then --resume", **r,
        "equal_after_strip_volatile": same,
        "failed_cells": None if resumed is None else resumed["failed_cells"]}))
    if (not r["checkpoint_committed"]
            or r["killed_returncode"] != -signal.SIGTERM
            or r["resume_returncode"] != 0 or not same
            or resumed["failed_cells"]):
        _fail(f"fig4 CLI SIGTERM / --resume check failed (see {r['logs']})")


def _seed_vmap_vs_loop(torch, kd) -> None:
    """(d): fig3_alpha's α = 0.1 pair on the host executor at full width,
    SEED_VMAP_ROUNDS rounds, under both engines at each of
    SEED_VMAP_SEED_SETS."""
    from repro_torch.core.diffusion import PlanCache
    from repro_torch.experiments import expand_sweep, run_cell
    cells = [c.with_fl(rounds=SEED_VMAP_ROUNDS)
             for c in expand_sweep("fig3_alpha", smoke=False,
                                   executor="host") if c.value == 0.1]
    for seeds in SEED_VMAP_SEED_SETS:
        for cell in cells:
            recs, counts = {}, {}
            for engine in ("loop", "seed_vmap"):
                kd.reset_launch_counts()
                recs[engine] = run_cell(cell, seeds, PlanCache(),
                                        engine=engine)
                torch.cuda.synchronize()
                counts[engine] = {k: v for k, v in kd.LAUNCHES.items() if v}
            lp, vm = recs["loop"], recs["seed_vmap"]
            gap = max(abs(a - b) for ca, cb in zip(lp["accuracy"],
                                                   vm["accuracy"])
                      for a, b in zip(ca, cb))
            ok = {"engines": (lp["engine"], vm["engine"]) == ("loop",
                                                              "seed_vmap"),
                  "comm": lp["comm"] == vm["comm"],
                  "diffusion_rounds": lp["diffusion_rounds"]
                  == vm["diffusion_rounds"],
                  "iid_distance": lp["iid_distance"] == vm["iid_distance"],
                  "accuracy": gap <= SEED_VMAP_ACC,
                  "no_kernel": not counts["seed_vmap"]}
            print(json.dumps({
                "check": f"seed_vmap vs loop {cell.label}",
                "executor": "host", "clients": cell.spec.fl.num_clients,
                "rounds": SEED_VMAP_ROUNDS, "seeds": list(seeds),
                "loop_wall_s": lp["wall_clock_s"],
                "seed_vmap_wall_s": vm["wall_clock_s"],
                "loop_over_seed_vmap": lp["wall_clock_s"]
                / vm["wall_clock_s"],
                "max_accuracy_gap": gap, "bar": SEED_VMAP_ACC,
                "peak_accuracy": {"loop": lp["summary"]["peak_mean"],
                                  "seed_vmap": vm["summary"]["peak_mean"]},
                "launches": counts, "ok": ok}))
            if not all(ok.values()):
                _fail(f"seed_vmap vs loop {cell.label} seeds {seeds}: {ok}")


def _seed_vmap_card_vs_cpu(torch, kd) -> None:
    """(e): fig3_alpha's smoke FedDif cell under seed_vmap, card vs CPU."""
    from repro_torch.core.diffusion import PlanCache
    from repro_torch.experiments import expand_sweep, run_cell
    cell = next(c for c in expand_sweep("fig3_alpha")
                if c.strategy == "feddif")
    kd.reset_launch_counts()
    gpu = run_cell(cell, (0,), PlanCache(), engine="seed_vmap")
    torch.cuda.synchronize()
    launched = {k: v for k, v in kd.LAUNCHES.items() if v}
    cpu = run_cell(cell, (0,), PlanCache(), engine="seed_vmap", device="cpu")
    gap = max(abs(a - b) for a, b in zip(gpu["accuracy"][0],
                                         cpu["accuracy"][0]))
    ok = gpu["comm"] == cpu["comm"] and gap <= 0.05 and not launched
    print(json.dumps({"check": f"seed_vmap card vs CPU {cell.label}",
                      "comm_equal": gpu["comm"] == cpu["comm"],
                      "max_accuracy_gap": gap, "bar": 0.05,
                      "launches": launched, "ok": ok}))
    if not ok:
        _fail(f"seed_vmap card vs CPU {cell.label}: comm or accuracy apart")


def _parts_line(phase: str, t0: float, parts: dict, total: dict) -> None:
    print(json.dumps({"phase": phase, "seconds": time.perf_counter() - t0,
                      "part_seconds": parts,
                      "launches": {k: v for k, v in total.items() if v}}))


def durable_path(torch, port, sigterm: _Alongside | None = None) -> dict:
    """Phase 3d: durable runs and sweeps, and the seed-stacked replicate
    engine, on the card.  Returns the launches of (a) and (b).
    ``sigterm``: (c)'s processes, if main() began them earlier."""
    from repro_torch.kernels import diffusion as kd
    total = {k: 0 for k in kd.LAUNCHES}
    t0, parts = time.perf_counter(), {}
    ts = t0
    for executor, strategy, rounds, kill in DURABLE_RUNS:
        for k, v in _durable_run(torch, kd, port, executor, strategy,
                                 rounds, kill).items():
            total[k] += v
    parts["runs"], ts = time.perf_counter() - ts, time.perf_counter()
    for k, v in _durable_sweep(torch, kd).items():
        total[k] += v
    parts["sweep"], ts = time.perf_counter() - ts, time.perf_counter()
    _sigterm_cli(torch, sigterm)
    parts["sigterm_cli"], ts = time.perf_counter() - ts, time.perf_counter()
    _seed_vmap_vs_loop(torch, kd)
    _seed_vmap_card_vs_cpu(torch, kd)
    parts["seed_vmap"] = time.perf_counter() - ts
    _parts_line("durable_path", t0, parts, total)
    return total


def _sync(torch, device) -> None:
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _finite(torch, params) -> bool:
    from repro_torch.tree import tree_leaves
    return all(bool(torch.isfinite(x).all()) for x in tree_leaves(params))


def _timed_run(torch, kd, port, spec, device=None, **kw):
    """One ``run_experiment`` with the launch counts zeroed before it:
    returns the result, its counts and its wall seconds."""
    kd.reset_launch_counts()
    t0 = time.perf_counter()
    res = port.run_experiment(spec, device=device, **kw)
    _sync(torch, device)
    return res, dict(kd.LAUNCHES), time.perf_counter() - t0


def _others(counts: dict, *allowed: str) -> dict:
    return {k: v for k, v in counts.items() if v and k not in allowed}


def _appendix_cells(torch, kd, port, device=None) -> dict:
    """(a): the appendix_scenarios bench's full cells, then FedDif with the
    device planner under ``kld`` and ``w1_norm``.  Returns the launches."""
    import numpy as np
    total = {k: 0 for k in kd.LAUNCHES}
    ledgers = {}
    for label, change in APPENDIX_CELLS:
        fl = dict(APPENDIX_FL, **change)
        spec = port.ExperimentSpec(**APPENDIX_DATA, fl=port.FLConfig(**fl))
        res, counts, wall = _timed_run(torch, kd, port, spec, device)
        led = res.ledger
        rounds = fl["rounds"]
        mixes = rounds * (2 if fl["strategy"] == "gossip" else 1)
        print(json.dumps({
            "appendix_cell": label, "peak_accuracy": max(res.accuracy),
            "subframes": led.subframes,
            "transmitted_models": led.transmitted_models,
            "subframes_per_transmission":
                led.subframes / max(led.transmitted_models, 1),
            "mean_diffusion_rounds": float(np.mean(res.diffusion_rounds)),
            "diffusion_rounds": res.diffusion_rounds,
            "mean_round_wall_s": sum(res.round_wall_s) / rounds,
            "planner_s_per_round": res.planner_stats.get("seconds", 0.0)
            / max(res.planner_stats.get("plans", 0), 1),
            "energy_j": led.energy_j, "run_wall_s": wall,
            "launches": {k: v for k, v in counts.items() if v}}))
        if not _finite(torch, res.final_params):
            _fail(f"appendix {label}: non-finite parameters")
        if counts["mix_tree"] != mixes or _others(counts, "mix_tree"):
            _fail(f"appendix {label}: launches {counts}, want mix_tree "
                  f"{mixes} and nothing else")
        ledgers[label] = led
        for k in total:
            total[k] += counts[k]
    over, under = ledgers["baseline"], ledgers["underlay"]
    per = [x.subframes / max(x.transmitted_models, 1) for x in (over, under)]
    print(json.dumps({"check": "underlay vs overlay",
                      "subframes": [over.subframes, under.subframes],
                      "subframes_per_transmission": per}))
    if not per[1] > per[0]:
        _fail(f"underlay charges {per[1]} sub-frames per transmission, not "
              f"more than the overlay's {per[0]}")
    # The device planner: the Appendix-C metrics never reach bid_fused; a
    # value factor takes bid_value_fuse once per bid round.  Keyed control
    # streams (topology_seed) let the Appendix-C plans be held to the host
    # planner's.
    for metric, weight in (("kld", 0.0), ("kld", VALUE_WEIGHT),
                           ("w1_norm", 0.0)):
        fl = dict(APPENDIX_FL, rounds=2, metric=metric, topology_seed=7,
                  uncertainty_weight=weight)
        spec = port.ExperimentSpec(**APPENDIX_DATA,
                                   fl=port.FLConfig(**fl, planner="jax"))
        res, counts, _ = _timed_run(torch, kd, port, spec, device)
        bid_rounds = res.planner_stats.get("loop_iterations", 0)
        want = {"bid_fused": 0 if metric == "kld" else bid_rounds,
                "bid_value_fuse": bid_rounds if weight else 0}
        row = {"check": f"device planner, metric {metric}, value weight "
                        f"{weight}", "bid_rounds": bid_rounds,
               "bid_fused": counts["bid_fused"],
               "bid_value_fuse": counts["bid_value_fuse"],
               "diffusion_rounds": res.diffusion_rounds,
               "subframes": res.ledger.subframes}
        ok = (bid_rounds > 0 and not _others(counts, "mix_tree", *want)
              and all(counts[k] == v for k, v in want.items()))
        for k in total:
            total[k] += counts[k]
        if metric != "w1_norm":
            spec = port.ExperimentSpec(**APPENDIX_DATA,
                                       fl=port.FLConfig(**fl,
                                                        planner="host"))
            host = port.run_experiment(spec, device=device)
            row["host_planner"] = {"diffusion_rounds": host.diffusion_rounds,
                                   "subframes": host.ledger.subframes}
            row["same_plan_as_host"] = (
                host.diffusion_rounds == res.diffusion_rounds
                and host.ledger.as_dict() == res.ledger.as_dict())
            ok = ok and row["same_plan_as_host"]
        print(json.dumps(row))
        if not ok:
            _fail(f"device planner {metric} w={weight}: launches {counts} "
                  f"over {bid_rounds} bid rounds, want {want}: "
                  f"{json.dumps(row)}")
    return total


def _world_sweeps(torch, kd, port, device=None) -> dict:
    """(b): fig_scenarios' full grid with the host planner, its mobile and
    multicell FedDif cells with the device planner, and FedDif per scenario
    and plane for the round wall and planner seconds.  Returns the
    launches."""
    from repro_torch.core.diffusion import PlanCache
    from repro_torch.experiments import expand_sweep, run_cell
    total = {k: 0 for k in kd.LAUNCHES}

    def add(counts):
        for k in total:
            total[k] += counts[k]

    grid = _cut_sweep("fig_scenarios", SCENARIO_GRID_ROUNDS)
    with _ObservedRuns(torch, port) as runs:
        art, per_cell, wall = _sweep(
            torch, kd, runs, grid, smoke=False, executor="fleet",
            out_dir=APPENDIX_DIR / "sweeps", device=device)
        add(dict(kd.LAUNCHES))
        for cell, c in zip(art["cells"], per_cell):
            if c["bid_fused"]:
                _fail(f"fig_scenarios {cell['label']}: bid_fused launched "
                      f"with the host planner")
        print(json.dumps({"fig_scenarios_energy_j": {
            c["label"]: c["comm"]["energy_j"] for c in art["cells"]},
            "wall_s": wall}))
        host = {c["label"]: c for c in art["cells"]}
        for cell in expand_sweep(grid, smoke=False, executor="fleet",
                                 planner="jax"):
            if cell.strategy != "feddif" or cell.value not in ("mobile",
                                                               "multicell"):
                continue
            kd.reset_launch_counts()
            rec = run_cell(cell, (0,), PlanCache(), device=device)
            _sync(torch, device)
            counts = dict(kd.LAUNCHES)
            add(counts)
            want = host[cell.label]
            acc = max(abs(a - b) for a, b in zip(rec["accuracy"][0],
                                                 want["accuracy"][0]))
            same = {"subframes": rec["comm"]["subframes"]
                    == want["comm"]["subframes"],
                    "diffusion_rounds": rec["diffusion_rounds"]
                    == want["diffusion_rounds"],
                    "accuracy_within_0.05": acc <= 0.05,
                    "comm_equal": rec["comm"] == want["comm"]}
            print(json.dumps({
                "check": f"{cell.label} device vs host planner",
                "peak_accuracy": [rec["summary"]["peak_mean"],
                                  want["summary"]["peak_mean"]],
                "subframes": [rec["comm"]["subframes"],
                              want["comm"]["subframes"]],
                "energy_j": [rec["comm"]["energy_j"],
                             want["comm"]["energy_j"]],
                "max_accuracy_gap": acc, "same": same,
                "seconds": rec["wall_clock_s"],
                "launches": {k: v for k, v in counts.items() if v}}))
            if not (same["subframes"] and same["diffusion_rounds"]
                    and same["accuracy_within_0.05"]):
                _fail(f"{cell.label}: the device planner disagrees with the "
                      f"host planner: {same}")
            if not counts["bid_fused"]:
                _fail(f"{cell.label}: the device planner launched no "
                      f"bid_fused")
    # Round wall and planner seconds per scenario and plane, FedDif at the
    # grid's width, a few rounds each.
    for executor, planner in (("fleet", "host"), ("host", "host"),
                              ("fleet", "jax")):
        for cell in expand_sweep("fig_scenarios", smoke=False,
                                 executor=executor, planner=planner):
            if cell.strategy != "feddif" or (
                    planner == "jax" and cell.value not in ("mobile",
                                                            "multicell")):
                continue
            spec = cell.with_fl(rounds=SCENARIO_PROFILE_ROUNDS).spec
            res, counts, wall = _timed_run(torch, kd, port, spec, device)
            add(counts)
            st = res.planner_stats
            print(json.dumps({
                "scenario_profile": cell.value, "executor": executor,
                "planner": planner, "rounds": SCENARIO_PROFILE_ROUNDS,
                "mean_round_wall_s": sum(res.round_wall_s)
                / SCENARIO_PROFILE_ROUNDS,
                "round_wall_s": res.round_wall_s,
                "planner_s_per_round": st.get("seconds", 0.0)
                / max(st.get("plans", 0), 1),
                "diffusion_rounds": res.diffusion_rounds,
                "subframes": res.ledger.subframes,
                "energy_j": res.ledger.energy_j, "run_wall_s": wall,
                "launches": {k: v for k, v in counts.items() if v}}))
            if not _finite(torch, res.final_params):
                _fail(f"scenario profile {cell.label}: non-finite params")
    return total


def _world_resume(torch, kd, port, device=None) -> dict:
    """(c): a mobile and an energy-capped FedDif run, each killed after a
    round checkpoint and resumed bit-equal; fig7_scaling's smoke grid under
    churn.  Returns the launches."""
    from repro_torch.fl.resume import Preempted, RoundCheckpointer
    from repro_torch.train.checkpoint import load_metadata
    total = {k: 0 for k in kd.LAUNCHES}
    for scenario, change, rounds, kill in WORLD_RESUME:
        spec = port.ExperimentSpec(
            task="fcn", alpha=0.3, num_samples=6000,
            fl=port.FLConfig(executor="fleet", strategy="feddif",
                             rounds=rounds, num_clients=8, num_models=8,
                             seed=0, topology_seed=7, scenario=scenario,
                             checkpoint_every=1, **change))
        root = APPENDIX_DIR / "resume" / scenario
        shutil.rmtree(root, ignore_errors=True)
        clean, clean_counts, clean_s = _timed_run(
            torch, kd, port, spec, device, checkpoint_dir=str(root / "clean"))
        kd.reset_launch_counts()
        RoundCheckpointer.fail_after_save = kill
        try:
            port.run_experiment(spec, device=device,
                                checkpoint_dir=str(root / "killed"))
        except Preempted:
            preempted = True
        else:
            preempted = False
        finally:
            RoundCheckpointer.fail_after_save = None
        world = load_metadata(str(root / "killed"), kill)["world"]
        resumed = port.run_experiment(spec, device=device,
                                      checkpoint_dir=str(root / "killed"))
        _sync(torch, device)
        counts = dict(kd.LAUNCHES)
        same = {
            "params_bits": _bits_equal(torch, clean.params, resumed.params),
            "ledger": clean.ledger.as_dict() == resumed.ledger.as_dict(),
            "accuracy": clean.accuracy == resumed.accuracy,
            "loss": clean.loss == resumed.loss,
            "diffusion_rounds": clean.diffusion_rounds
            == resumed.diffusion_rounds,
            "launches": counts == clean_counts}
        budget = change.get("energy_budget_j")
        depleted = (None if budget is None
                    else sum(e >= budget for e in world["energy_j"]))
        print(json.dumps({
            "world_resume": f"fleet/feddif/fcn/{scenario}", "rounds": rounds,
            "killed_after_round": kill, "preempted": preempted,
            "world_rounds_in_checkpoint": world["rounds_advanced"],
            "energy_budget_j": budget,
            "depleted_in_checkpoint": depleted,
            "same": same, "peak_accuracy": max(resumed.accuracy),
            "energy_j": resumed.ledger.energy_j, "clean_s": clean_s,
            "launches": {k: v for k, v in counts.items() if v}}))
        if (not preempted or world["rounds_advanced"] != kill
                or not all(same.values()) or depleted == 0):
            _fail(f"world resume {scenario}: preempted {preempted}, "
                  f"depleted {depleted}, world rounds "
                  f"{world['rounds_advanced']}, same {same}")
        for k in total:
            total[k] += clean_counts[k] + counts[k]
    with _ObservedRuns(torch, port) as runs:
        art, per_cell, wall = _sweep(
            torch, kd, runs, "fig7_scaling", executor="fleet",
            out_dir=APPENDIX_DIR / "sweeps", device=device)
        for k in total:
            total[k] += kd.LAUNCHES[k]
    print(json.dumps({"fig7_scaling_smoke": {
        c["label"]: {"subframes": c["comm"]["subframes"],
                     "peak_accuracy": c["summary"]["peak_mean"]}
        for c in art["cells"]}, "wall_s": wall}))
    return total


def _phase_profile(torch, kd, port, device=None) -> None:
    """(d): one fleet FedDif round with ``profile_phases=True``."""
    spec = port.ExperimentSpec(
        task="fcn", alpha=0.3, num_samples=6000,
        fl=port.FLConfig(executor="fleet", strategy="feddif", rounds=1,
                         num_clients=8, num_models=8, seed=0,
                         profile_phases=True))
    res, counts, wall = _timed_run(torch, kd, port, spec, device)
    phases = res.phase_s
    print(json.dumps({"phase_profile": "fleet/feddif/fcn",
                      "phase_s": phases, "round_wall_s": res.round_wall_s,
                      "run_wall_s": wall}))
    if len(phases) != 1 or set(phases[0]) != {"train", "hop_collective",
                                              "mix", "plan"}:
        _fail(f"phase profile: {phases}")


def appendix_path(torch, port, device=None) -> dict:
    """Phase 3e: the Appendix-C knobs, the evolving world and churn on the
    card.  Returns the launches of (a)–(c)."""
    from repro_torch.kernels import diffusion as kd
    total = {k: 0 for k in kd.LAUNCHES}
    t0, parts = time.perf_counter(), {}
    for part in (_appendix_cells, _world_sweeps, _world_resume):
        ts = time.perf_counter()
        for k, v in part(torch, kd, port, device).items():
            total[k] += v
        parts[part.__name__] = time.perf_counter() - ts
    ts = time.perf_counter()
    _phase_profile(torch, kd, port, device)
    parts["_phase_profile"] = time.perf_counter() - ts
    _parts_line("appendix_path", t0, parts, total)
    return total


# ------------------------------------------------------------ async phase

def _async_engine(preset: str | None, plane: str, planner: str = "host",
                  **knobs):
    """An async ``EngineSpec`` on inner plane ``plane``: a preset's knobs
    (or the degenerate defaults) with ``knobs`` changed."""
    from repro_torch.fl.engine import ENGINE_PRESETS, AsyncSpec, EngineSpec
    base = ENGINE_PRESETS[preset].buffered if preset else AsyncSpec()
    return EngineSpec(mode="async", planner=planner, data_plane=plane,
                      buffered=dataclasses.replace(base, **knobs))


def _async_spec(port, engine=None, **change):
    fl = dict(ASYNC_FL, **change)
    return port.ExperimentSpec(**ASYNC_DATA,
                               fl=port.FLConfig(engine=engine, **fl))


def _params_close(torch, a, b, atol=2e-4, rtol=2e-3) -> bool:
    from repro_torch.tree import tree_leaves
    return all(bool(torch.allclose(x.float().cpu(), y.float().cpu(),
                                   atol=atol, rtol=rtol))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _async_curves(res) -> dict:
    h = res.history
    return {"virtual_s": h.virtual_s, "arrivals": h.arrivals,
            "staleness": h.staleness, "parked_hops": h.parked_hops}


def _async_degeneracy(torch, kd, port, device=None) -> dict:
    """(a): K = everything, zero delays, no discount against the sync
    executor of the same plane, FedAvg and FedDif at N = 20, 2 rounds:
    the host plane bit for bit, the fleet plane within its bar."""
    total = {k: 0 for k in kd.LAUNCHES}
    n = ASYNC_DEGENERATE_N
    for plane in ASYNC_PLANES:
        for strategy in ("fedavg", "feddif"):
            change = dict(strategy=strategy, rounds=2, num_clients=n,
                          num_models=n)
            sync, sc, ss = _timed_run(torch, kd, port, _async_spec(
                port, executor=plane, **change), device)
            asy, ac, as_ = _timed_run(torch, kd, port, _async_spec(
                port, _async_engine(None, plane), **change), device)
            same = {"ledger": sync.ledger.as_dict() == asy.ledger.as_dict(),
                    "diffusion_rounds": sync.diffusion_rounds
                    == asy.diffusion_rounds,
                    "virtual_s": asy.history.virtual_s == [0.0, 0.0],
                    "staleness": asy.history.staleness == [0.0, 0.0]}
            if plane == "host":
                same["params_bits"] = _bits_equal(torch, sync.params,
                                                  asy.params)
                same["accuracy"] = sync.accuracy == asy.accuracy
            else:
                same["params_within_bar"] = _params_close(torch, sync.params,
                                                          asy.params)
                same["accuracy_within_0.05"] = max(
                    abs(a - b) for a, b in zip(sync.accuracy, asy.accuracy)
                ) <= ASYNC_ACC
            print(json.dumps({
                "async_degeneracy": f"{plane}/{strategy}/fcn/N={n}",
                "same": same, "accuracy": [sync.accuracy, asy.accuracy],
                "virtual_s": asy.history.virtual_s,
                "arrivals": asy.history.arrivals,
                "run_wall_s": [ss, as_],
                "launches": {k: v for k, v in ac.items() if v}}))
            if not all(same.values()):
                _fail(f"async degeneracy {plane}/{strategy}: {same}")
            if any(ac.values()):
                _fail(f"async degeneracy {plane}/{strategy}: launched {ac}")
    return total


def _async_presets(torch, kd, port, device=None) -> dict:
    """(b): the ``async`` and ``async_barrier`` presets, FedDif, 4 rounds,
    on each inner plane: equal ledgers, the buffered arm's first tick
    before the barrier's, its staleness above 0 and the barrier's 0."""
    total = {k: 0 for k in kd.LAUNCHES}
    for plane in ASYNC_PLANES:
        arms = {}
        for preset in ("async_barrier", "async"):
            res, counts, wall = _timed_run(torch, kd, port, _async_spec(
                port, _async_engine(preset, plane)), device)
            if not _finite(torch, res.params):
                _fail(f"async {preset}/{plane}: non-finite params")
            for k in total:
                total[k] += counts[k]
            arms[preset] = (res, counts, wall)
        (bar, _, bar_s), (buf, _, buf_s) = arms["async_barrier"], arms["async"]
        target = 0.98 * min(max(bar.accuracy), max(buf.accuracy))
        for preset, (res, counts, wall) in arms.items():
            print(json.dumps({
                "async_ticks": f"{preset}/{plane}/feddif/fcn",
                **_async_curves(res), "accuracy": res.accuracy,
                "peak_accuracy": max(res.accuracy),
                "time_to_accuracy": {"target": target,
                                     "virtual_s":
                                         res.time_to_accuracy(target)},
                "round_wall_s": res.round_wall_s,
                "mean_round_wall_s": sum(res.round_wall_s)
                / len(res.round_wall_s),
                "ticks": len(res.history.virtual_s), "run_wall_s": wall,
                "launches": {k: v for k, v in counts.items() if v}}))
        checks = {"ledger": bar.ledger.as_dict() == buf.ledger.as_dict(),
                  "first_tick_earlier": buf.history.virtual_s[0]
                  < bar.history.virtual_s[0],
                  "barrier_fresh": max(bar.history.staleness) == 0.0,
                  "buffered_stale": max(buf.history.staleness) > 0.0}
        print(json.dumps({"check": f"async vs async_barrier, {plane}",
                          **checks, "speedup_to_target": (
                              None if not (bar.time_to_accuracy(target)
                                           and buf.time_to_accuracy(target))
                              else bar.time_to_accuracy(target)
                              / buf.time_to_accuracy(target))}))
        if not all(checks.values()):
            _fail(f"async presets on {plane}: {checks}")
    return total


def _async_kernels(torch, kd, port, device=None) -> dict:
    """(c): the kernels of the inner planes through the async plane, each
    launched as often as by the sync run of the same schedules (equal
    ledgers): feddif_stc on each plane, FedDif with int8 hops on each
    plane, FedDif with the device planner and learning-value bids (whose
    plans follow the global params: the degenerate engine keeps the sync
    run's, the ``async`` preset its own, where ``bid_fused`` must launch
    once per bid round)."""
    total = {k: 0 for k in kd.LAUNCHES}
    kernel_of = {"host": "stc_fused", "fleet": "stc_rows_fused"}
    cases = [(f"feddif_stc/{p}", "async", p, dict(strategy="feddif_stc"),
              (kernel_of[p],)) for p in ASYNC_PLANES]
    cases += [(f"feddif_int8/{p}", "async", p, dict(hop_quant="int8"),
               ("quant_roundtrip",)) for p in ASYNC_PLANES]
    values = dict(planner="jax", uncertainty_weight=VALUE_WEIGHT)
    cases += [(f"feddif_device_planner_values/host/{preset or 'degenerate'}",
               preset, "host", values, ("bid_fused", "bid_value_fuse"))
              for preset in (None, "async")]
    for label, preset, plane, change, kernels in cases:
        change = dict(change, rounds=ASYNC_KERNEL_ROUNDS)
        sync, sc, _ = _timed_run(torch, kd, port, _async_spec(
            port, executor=plane, **change), device)
        asy, ac, wall = _timed_run(torch, kd, port, _async_spec(
            port, _async_engine(preset, plane,
                                change.get("planner", "host")), **change),
            device)
        for k in total:
            total[k] += ac[k]
        want = {"quant_roundtrip": sum(asy.diffusion_rounds),
                "bid_fused": asy.planner_stats.get("loop_iterations", 0)}
        row = {"async_kernels": label, "preset": preset,
               "async": {k: ac[k] for k in kernels},
               "sync": {k: sc[k] for k in kernels},
               "ledger_equal": sync.ledger.as_dict() == asy.ledger.as_dict(),
               "diffusion_rounds": asy.diffusion_rounds, "run_wall_s": wall,
               "launches": {k: v for k, v in ac.items() if v}}
        row["want"] = {k: want[k] for k in kernels if k in want}
        if "bid_fused" in kernels:
            row["want"]["bid_value_fuse"] = 0
        # The value-driven plans of the async preset are its own.
        same_plans = not (preset and "bid_fused" in kernels)
        ok = (ac[kernels[0]] > 0
              and all(ac[k] == v for k, v in row["want"].items())
              and (not same_plans or row["ledger_equal"]
                   and all(ac[k] == sc[k] for k in kernels)))
        print(json.dumps(row))
        if not ok:
            _fail(f"async kernels {label}: {json.dumps(row)}")
    return total


def _async_resume(torch, kd, port, device=None) -> dict:
    """(d): K = 2, ``checkpoint_every=1``, killed after round 2 of 4 with
    contributions pending, on each inner plane; resumed bit-equal."""
    from repro_torch.fl.resume import Preempted, RoundCheckpointer
    from repro_torch.train.checkpoint import load_metadata
    total = {k: 0 for k in kd.LAUNCHES}
    rounds, kill = ASYNC_RESUME
    for plane in ASYNC_PLANES:
        spec = _async_spec(port, _async_engine(
            "async", plane, buffer_k=2, buffer_frac=None), rounds=rounds,
            checkpoint_every=1)
        root = ASYNC_DIR / "resume" / plane
        shutil.rmtree(root, ignore_errors=True)
        with _TimedSaves() as saves:
            clean, clean_counts, clean_s = _timed_run(
                torch, kd, port, spec, device,
                checkpoint_dir=str(root / "clean"))
        kd.reset_launch_counts()
        RoundCheckpointer.fail_after_save = kill
        try:
            port.run_experiment(spec, device=device,
                                checkpoint_dir=str(root / "killed"))
        except Preempted:
            preempted = True
        else:
            preempted = False
        finally:
            RoundCheckpointer.fail_after_save = None
        pending = load_metadata(str(root / "killed"), kill)["buffer"]["count"]
        resumed = port.run_experiment(spec, device=device,
                                      checkpoint_dir=str(root / "killed"))
        _sync(torch, device)
        counts = dict(kd.LAUNCHES)
        same = {"params_bits": _bits_equal(torch, clean.params,
                                           resumed.params),
                "ledger": clean.ledger.as_dict() == resumed.ledger.as_dict(),
                "accuracy": clean.accuracy == resumed.accuracy,
                "loss": clean.loss == resumed.loss,
                "diffusion_rounds": clean.diffusion_rounds
                == resumed.diffusion_rounds,
                "launches": counts == clean_counts,
                **{k: v == _async_curves(resumed)[k]
                   for k, v in _async_curves(clean).items()}}
        print(json.dumps({
            "async_resume": f"{plane}/feddif/fcn", "rounds": rounds,
            "killed_after_round": kill, "preempted": preempted,
            "pending_at_kill": pending, "same": same,
            "ticks": len(resumed.history.virtual_s),
            "clean_s": clean_s, "saves": len(saves.seconds),
            "s_per_save": sum(saves.seconds) / max(len(saves.seconds), 1),
            "max_s_per_save": max(saves.seconds, default=0.0),
            "bytes_per_save": saves.bytes,
            "launches": {k: v for k, v in counts.items() if v}}))
        if not preempted or pending <= 0 or not all(same.values()):
            _fail(f"async resume {plane}: preempted {preempted}, pending "
                  f"{pending}, same {same}")
        for k in total:
            total[k] += clean_counts[k] + counts[k]
    return total


def _async_population(torch, kd, port, device=None) -> dict:
    """(e): cohorts of 16 drawn from a population of 100,000, 2 rounds;
    the seconds of each cohort draw."""
    from repro_torch.fl.population import Population
    size, cohort, rounds = ASYNC_POPULATION
    real = Population.sample_cohort
    draws: list[float] = []

    def timed(self, t, k):
        t0 = time.perf_counter()
        try:
            return real(self, t, k)
        finally:
            draws.append(time.perf_counter() - t0)

    Population.sample_cohort = timed
    try:
        res, counts, wall = _timed_run(torch, kd, port, _async_spec(
            port, _async_engine("async", "auto", population=size),
            rounds=rounds, num_clients=cohort, num_models=cohort), device)
    finally:
        Population.sample_cohort = real
    print(json.dumps({
        "async_population": f"feddif/fcn, population {size}, cohort "
                            f"{cohort}", "rounds": rounds,
        "cohort_draws": len(draws),
        "s_per_cohort_draw": sum(draws) / max(len(draws), 1),
        "max_s_per_cohort_draw": max(draws, default=0.0),
        **_async_curves(res), "peak_accuracy": max(res.accuracy),
        "mean_round_wall_s": sum(res.round_wall_s) / rounds,
        "run_wall_s": wall,
        "launches": {k: v for k, v in counts.items() if v}}))
    if len(draws) != rounds or not _finite(torch, res.params):
        _fail(f"async population: {len(draws)} draws over {rounds} rounds")
    return dict(counts)


def _async_sweeps(torch, kd, port, device=None) -> dict:
    """(f): fig_async's full grid (N = 16, ASYNC_SWEEP_ROUNDS of its 10
    rounds, 5 % churn, fedavg / d2d_random_walk × async_barrier / async)
    with one line per cell, and
    its smoke grid on the card against the CPU."""
    from repro_torch.experiments import run_sweep
    total = {k: 0 for k in kd.LAUNCHES}
    with _ObservedRuns(torch, port) as runs:
        snaps = []

        def log(line):
            _sync(torch, device)
            snaps.append(dict(kd.LAUNCHES))

        kd.reset_launch_counts()
        t0 = time.perf_counter()
        art = run_sweep(_cut_sweep("fig_async", ASYNC_SWEEP_ROUNDS),
                        smoke=False, device=device, log=log,
                        out_dir=str(ASYNC_DIR / "sweeps"))
        wall = time.perf_counter() - t0
        for k in total:
            total[k] += kd.LAUNCHES[k]
        prev = {k: 0 for k in kd.LAUNCHES}
        for cell, snap in zip(art["cells"], snaps):
            counts = {k: snap[k] - prev[k] for k in snap}
            prev = snap
            curves = {k: v[0] for k, v in cell["async"].items()}
            print(json.dumps({
                "sweep": "fig_async", "cell": cell["label"],
                "executor": cell["executor"],
                "peak_accuracy": cell["summary"]["peak_mean"],
                "subframes": cell["comm"]["subframes"],
                "final_virtual_s": curves["virtual_s"][-1],
                **curves, "seconds": cell["wall_clock_s"],
                "launches": {k: v for k, v in counts.items() if v}}))
        finite = runs.finite
        print(json.dumps({"sweep_summary": "fig_async",
                          "cells": len(art["cells"]), "wall_s": wall,
                          "artifact": art["path"]}))
        if (art["failed_cells"] or len(art["cells"]) != 4
                or not all(finite) or len(finite) != 4):
            _fail(f"fig_async full grid: failed {art['failed_cells']}, "
                  f"finite {finite}")
        on = run_sweep("fig_async", device=device,
                       out_dir=str(ASYNC_DIR / "smoke_card"))
    cpu = run_sweep("fig_async", device="cpu",
                    out_dir=str(ASYNC_DIR / "smoke_cpu"))
    worst = 0.0
    for g, c in zip(on["cells"], cpu["cells"]):
        acc = max(abs(a - b) for a, b in zip(g["accuracy"][0],
                                             c["accuracy"][0]))
        worst = max(worst, acc)
        if (g["comm"] != c["comm"]
                or g["async"]["virtual_s"] != c["async"]["virtual_s"]
                or g["async"]["arrivals"] != c["async"]["arrivals"]
                or acc > ASYNC_ACC):
            _fail(f"fig_async smoke {g['label']}: card and CPU differ "
                  f"(accuracy gap {acc})")
    print(json.dumps({"check": "fig_async smoke card vs CPU",
                      "cells": len(on["cells"]), "comm_equal": True,
                      "virtual_s_equal": True, "arrivals_equal": True,
                      "max_accuracy_gap": worst, "bar": ASYNC_ACC}))
    return total


def async_path(torch, port, device=None) -> dict:
    """Phase 3f: the buffered-async plane on the card.  Returns the
    launches of (b)–(f)."""
    from repro_torch.kernels import diffusion as kd
    total = {k: 0 for k in kd.LAUNCHES}
    t0, parts = time.perf_counter(), {}
    _async_degeneracy(torch, kd, port, device)
    parts["_async_degeneracy"] = time.perf_counter() - t0
    for part in (_async_presets, _async_kernels, _async_resume,
                 _async_population, _async_sweeps):
        ts = time.perf_counter()
        for k, v in part(torch, kd, port, device).items():
            total[k] += v
        parts[part.__name__] = time.perf_counter() - ts
    _parts_line("async_path", t0, parts, total)
    return total


# ------------------------------------------------------------ serve phase

def _cache_bytes(cache) -> int:
    from repro_torch.tree import tree_leaves
    return sum(a.numel() * a.element_size() for a in tree_leaves(cache))


def _serve_prompts(vocab: int) -> list:
    import numpy as np
    rng = np.random.default_rng(0)
    lo, hi = SERVE_PROMPT
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                         ).astype(np.int32) for _ in range(SERVE_REQUESTS)]


def _no_launches(kd, what: str) -> None:
    fired = {k: v for k, v in kd.LAUNCHES.items() if v}
    if fired:
        _fail(f"{what}: decode launched kernels {fired}")


def _serve_engines(torch, kd, card: str) -> None:
    """(a): the full-width engines, 8 slots of 32,768 positions (the MoE
    configs at SERVE_LAYERS' depth, pixtral at SERVE_MAX_SEQS' 8,192)."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.models.zoo import build_model
    from repro_torch.serving import Request, SamplerConfig, ServingEngine
    shape = SHAPES["decode_32k"]
    runs = [(arch, {"temperature": 0.0}) for arch in SERVE_ARCHS]
    runs.insert(1, ("qwen3_0_6b", SERVE_SAMPLED))
    params = model = None
    for arch, samp in runs:
        cfg = get_config(arch)
        if arch in SERVE_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=SERVE_LAYERS[arch])
        if model is None or model.cfg.name != cfg.name:
            params = model = None
            gc.collect()
            torch.cuda.empty_cache()
            model = build_model(cfg)
            t0 = time.perf_counter()
            params = model.init(torch.Generator(device="cuda").manual_seed(0))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kd.reset_launch_counts()
        max_seq = SERVE_MAX_SEQS.get(arch, SERVE_MAX_SEQ)
        eng = ServingEngine(model, params, num_slots=SERVE_SLOTS,
                            max_seq=max_seq,
                            sampler=SamplerConfig(**samp), seed=0)
        prompts = _serve_prompts(cfg.vocab_size)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=SERVE_NEW))
        step_s, done = [], []
        t0 = time.perf_counter()
        while eng.queue or any(eng.slots):
            ts = time.perf_counter()
            done.extend(eng.step())
            step_s.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        _no_launches(kd, f"serve {arch}")
        gen = sum(len(r.output) for r in done)
        ingested = sum(len(p) for p in prompts)
        first = step_s[0]
        step_s.sort()
        line = {"serve": arch, "layers": cfg.num_layers,
                "sampler": samp, "card": card,
                "slots": SERVE_SLOTS, "max_seq": max_seq,
                "decode_32k": [shape.seq_len, shape.global_batch],
                "requests": len(done), "prompt_tokens": ingested,
                "generated_tokens": gen, "engine_steps": eng.steps,
                "seconds": wall, "ms_per_step": 1e3 * wall / eng.steps,
                "median_step_ms": 1e3 * step_s[len(step_s) // 2],
                "first_step_ms": 1e3 * first, "generated_tok_per_s": gen / wall,
                "tokens_per_s": (ingested + gen) / wall,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "cache_bytes": _cache_bytes(eng.cache),
                "cache_gb": _cache_bytes(eng.cache) / 1e9,
                "init_s": init_s, "launches": 0}
        print(json.dumps(line))
        if len(done) != SERVE_REQUESTS or any(
                len(r.output) != SERVE_NEW for r in done):
            _fail(f"serve {arch}: {len(done)} requests done")
        del eng
    del params, model
    gc.collect()
    torch.cuda.empty_cache()


def _serve_cli_run() -> list:
    return [_run_cli(f"serve{i}", [sys.executable, "-m",
                                   "repro_torch.launch.serve", *args], 600)
            for i, args in enumerate(SERVE_CLIS)]


def _serve_cli(card: str, run: _Alongside | None = None) -> None:
    """(b): ``python -m repro_torch.launch.serve`` at full width, each of
    SERVE_CLIS in turn (begun here unless ``run`` already holds them)."""
    for args, out in zip(SERVE_CLIS,
                         (run or _Alongside(_serve_cli_run)).result()):
        if out["returncode"] != 0:
            _fail(f"serve CLI {' '.join(args)} exited {out['returncode']}: "
                  f"{out['stderr'][-2000:]}")
        lines = out["stdout"].strip().splitlines()
        print(json.dumps({"serve_cli": " ".join(args), "card": card,
                          "seconds": out["seconds"], "output": lines}))
        if not any(x.startswith("decode:") and "tok/s aggregate" in x
                   for x in lines):
            _fail(f"serve CLI {' '.join(args)} printed no decode rate: "
                  f"{lines}")


def _kv_one_late(torch):
    """attn_decode (linear mode) with the new K/V written one position
    late: the mask still ends at ``pos``, so a step never sees its own K/V
    and the previous step's sits one slot past it."""
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L

    def wrong(p, spec, x, cache, pos, ring=False):
        b, cd, dev = x.shape[0], spec.compute_dtype, x.device
        pv = torch.as_tensor(pos, dtype=torch.int64, device=dev
                             ).reshape(-1).expand(b)
        q, k, v = A._project_qkv(p, spec, x, pv[:, None])
        s_max = cache["k"].shape[1]
        rows = torch.arange(b, device=dev)
        late = torch.clamp(pv + 1, max=s_max - 1)
        cache["k"][rows, late] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, late] = v[:, 0].to(cache["v"].dtype)
        mask = torch.arange(s_max, device=dev)[None] <= pv[:, None]
        sc = torch.einsum("bhgd,bkhd->bhgk", q[:, 0], cache["k"].to(cd)
                          ).float() * (1.0 / spec.head_dim ** 0.5)
        sc = torch.where(mask[:, None, None], sc, A.NEG_INF)
        o = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(sc, -1).to(cd),
                         cache["v"].to(cd))
        return L.dense(p["wo"], o.reshape(b, 1, -1), cd), cache
    return wrong


def _state_not_carried(real):
    """A Mamba decode step whose state starts from zero at every step."""
    def wrong(p, spec, x, cache):
        cache["h"].zero_()
        return real(p, spec, x, cache)
    return wrong


def _cut_config(arch: str, extra: dict, dtype: str):
    """A card-vs-CPU cut in ``dtype`` compute: 2 layers of the full-width
    config with ``extra``'s changes, or the smoke config (2 layers) where
    ``extra`` holds ``smoke``."""
    import dataclasses
    from repro_torch.configs import get_config, get_smoke_config
    extra = dict(extra)
    if extra.pop("smoke", False):
        return dataclasses.replace(get_smoke_config(arch),
                                   compute_dtype=dtype, **extra)
    return dataclasses.replace(get_config(arch), num_layers=2,
                               compute_dtype=dtype, **extra)


def _teacher_forced(torch, model, params, tokens, patches=(), frames=None):
    """Logits (S, B, V) fp32 on the CPU and the final cache of a decode
    fed ``tokens`` (B, S), under ``mock.patch`` pairs ``patches``; an
    audio model's cache built from ``frames``."""
    from unittest import mock
    first = () if frames is None else (frames,)
    out = []
    with contextlib.ExitStack() as stack:
        for target, fn in patches:
            stack.enter_context(mock.patch(target, fn))
        with torch.no_grad():
            cache = model.init_cache(params, *first, tokens.shape[0],
                                     tokens.shape[1])
            for t in range(tokens.shape[1]):
                lg, cache = model.decode_step(params, tokens[:, t:t + 1],
                                              cache, t)
                out.append(lg[:, 0].float().cpu())
    return torch.stack(out), cache


def _rel_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def _serve_card_vs_cpu(torch, kd, card: str) -> None:
    """(c): the 2-layer cuts on the card against the CPU, from one init;
    then the planted controls, which the same bars must reject.  An MoE
    cut's card runs take the CPU's experts at its router's near ties
    (_Routing)."""
    from unittest import mock
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_leaves, tree_map
    controls = {
        "kv_one_late": lambda: [("repro_torch.models.transformer."
                                 "attn_decode", _kv_one_late(torch))],
        "state_not_carried": lambda: [
            ("repro_torch.models.ssm.mamba1_decode",
             _state_not_carried(ssm_lib.mamba1_decode)),
            ("repro_torch.models.ssm.mamba2_decode",
             _state_not_carried(ssm_lib.mamba2_decode))]}
    b = 2
    for (arch, extra), dtype in itertools.product(ZOO_CUTS + ZOO_WIDE_CUTS,
                                                  SERVE_BARS):
        forced, greedy = (SERVE_WIDE_STEPS if (arch, extra) in ZOO_WIDE_CUTS
                          else (SERVE_FORCED, SERVE_GREEDY))
        steps = forced + greedy
        cfg = _cut_config(arch, extra, dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = model.init(gen)
        prompt = torch.randint(0, cfg.vocab_size, (b, forced),
                               generator=gen, device="cuda")
        p_cpu = tree_map(lambda x: x.cpu(), params)
        # The CPU decides the greedy tokens; every card run is fed them.
        tokens = prompt.cpu()
        want_cache = model.init_cache(p_cpu, b, steps)
        want = []
        routing = _Routing(moe_lib)
        moe = cfg.moe is not None

        def follow():
            return ([("repro_torch.models.moe._top_k", routing.follow())]
                    if moe else [])

        with torch.no_grad(), mock.patch.object(moe_lib, "_top_k",
                                                routing.record()):
            for t in range(steps):
                lg, want_cache = model.decode_step(
                    p_cpu, tokens[:, t:t + 1], want_cache, t)
                want.append(lg[:, 0])
                if forced - 1 <= t < steps - 1:
                    tokens = torch.cat([tokens, lg[:, -1].argmax(-1)[:, None]],
                                       dim=1)
        want = torch.stack(want)
        kd.reset_launch_counts()
        got, got_cache = _teacher_forced(torch, model, params,
                                         tokens.cuda(), follow())
        followed = [routing.followed, routing.max_gap]
        _no_launches(kd, f"decode {arch} cut")
        bars = SERVE_BARS[dtype]
        cache_err = max(_rel_err(torch, g.cpu(), w) for g, w in zip(
            tree_leaves(got_cache), tree_leaves(want_cache)))
        logit_err = _rel_err(torch, got, want)
        agree = int((got[forced - 1:-1].argmax(-1)
                     == tokens[:, forced:].T).sum())
        ok = logit_err <= bars["logits_rel"] and cache_err <= bars["cache_rel"]
        if dtype == "float32":
            ok = ok and agree == b * greedy
        line = {"check": f"serve card_vs_cpu {cfg.name} 2-layer cut {dtype}",
                "card": card, "batch": b, "forced": forced,
                "greedy": greedy, "bars": bars,
                "logits_rel_err": logit_err, "cache_rel_err": cache_err,
                "greedy_tokens_agree": agree, "ok": ok, "controls": {},
                **({"near_ties_followed_and_max_gap": followed}
                   if moe else {})}
        for name in SERVE_CONTROLS[arch]:
            bad, bad_cache = _teacher_forced(torch, model, params,
                                             tokens.cuda(),
                                             controls[name]() + follow())
            c_logit = _rel_err(torch, bad, want)
            c_cache = max(_rel_err(torch, g.cpu(), w) for g, w in zip(
                tree_leaves(bad_cache), tree_leaves(want_cache)))
            rejected = (c_logit > bars["logits_rel"]
                        or c_cache > bars["cache_rel"])
            line["controls"][name] = {"logits_rel_err": c_logit,
                                      "cache_rel_err": c_cache,
                                      "rejected": rejected}
            if not rejected:
                _fail(f"serve card_vs_cpu {arch} {dtype}: the bars did not "
                      f"reject the control {name}")
        print(json.dumps(line))
        if not ok:
            _fail(f"serve card_vs_cpu {arch} {dtype}: {json.dumps(line)}")
        del params, p_cpu, got_cache, want_cache
        gc.collect()
        torch.cuda.empty_cache()


def _serve_decode_vs_prefill(torch, kd, card: str) -> None:
    """(d): teacher-forced decode logits on the card against the prefill
    forward's (flash_attention, ssd_scan, ssm_scan), fp32 cuts."""
    import numpy as np
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    from repro_torch.models.zoo import build_model
    b, s = 2, SERVE_PREFILL_SEQ
    for arch, extra in ZOO_CUTS + ZOO_WIDE_CUTS:
        cfg = _cut_config(arch, extra, "float32")
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(2)
        params = model.init(gen)
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device="cuda")
        kd.reset_launch_counts()
        with torch.inference_mode():
            x = tf._embed_inputs(params, cfg, {"tokens": toks})
            pos = torch.arange(s, device="cuda")[None].expand(b, s)
            hid, _ = tf.forward_hidden(params, cfg, x, pos)
            want = (L.unembed_logits(params["embed"], hid, torch.float32)
                    if cfg.tie_embeddings else
                    L.dense(params["lm_head"], hid, torch.float32))
            want = want.transpose(0, 1).float().cpu()
        kernels = {k: v for k, v in kd.LAUNCHES.items() if v}
        kd.reset_launch_counts()
        got, _ = _teacher_forced(torch, model, params, toks)
        _no_launches(kd, f"decode {arch} vs prefill")
        err = (got - want).abs()
        excess = float((err - SERVE_PREFILL_TOL * (1 + want.abs())).max())
        line = {"check": f"serve decode_vs_prefill {cfg.name} 2-layer cut "
                         f"float32", "card": card, "batch": b, "seq": s,
                "prefill_launches": kernels,
                "max_abs_err": float(err.max()),
                "max_abs_logit": float(want.abs().max()),
                "atol": SERVE_PREFILL_TOL, "rtol": SERVE_PREFILL_TOL,
                "ok": bool(np.isfinite(excess) and excess <= 0)}
        print(json.dumps(line))
        if not line["ok"] or not kernels:
            _fail(f"serve decode_vs_prefill {arch}: {json.dumps(line)}")
        del params
        gc.collect()
        torch.cuda.empty_cache()


def _serve_engine_and_sampler(torch, kd, card: str) -> None:
    """(e): the engine's slot reuse and the sampler, on the card."""
    import numpy as np
    from repro_torch.core.threefry import PRNGKey, gumbel_t, split_t
    from repro_torch.models.zoo import build_model
    from repro_torch.serving import (Request, SamplerConfig, ServingEngine,
                                     sample)
    last_logits = None
    # The sampler check reads the last cut's logits: moonshot-smoke's.
    for arch, extra in ZOO_WIDE_CUTS + ZOO_CUTS:
        cfg = _cut_config(arch, extra, "float32")
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(3))
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in SERVE_ENGINE_PROMPTS]
        max_seq = max(SERVE_ENGINE_PROMPTS) + 4
        kd.reset_launch_counts()
        eng = ServingEngine(model, params, num_slots=2, max_seq=max_seq)
        for uid, pr in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=pr, max_new_tokens=4))
        got = {r.uid: r.output for r in eng.run()}
        alone = {}
        with torch.no_grad():
            for uid, pr in enumerate(prompts):
                cache = model.init_cache(params, 1, max_seq)
                out = []
                for t in range(len(pr) + 3):
                    tok = pr[t] if t < len(pr) else out[-1]
                    lg, cache = model.decode_step(
                        params, torch.tensor([[int(tok)]], device="cuda"),
                        cache, t)
                    if t >= len(pr) - 1:
                        out.append(int(lg[0, -1].argmax()))
                alone[uid] = out
                last_logits = lg[:, -1]
        _no_launches(kd, f"engine {arch}")
        ok = got == alone
        print(json.dumps({"check": f"serve engine slot reuse {cfg.name} "
                                   "2-layer cut float32", "card": card,
                          "slots": 2, "requests": len(prompts),
                          "engine_steps": eng.steps, "engine": got,
                          "unbatched": alone, "ok": ok}))
        if not ok:
            _fail(f"serve engine {arch}: engine {got} != unbatched {alone}")
        last_logits = torch.cat([last_logits, last_logits.flip(-1)])
        del eng, params
        gc.collect()
        torch.cuda.empty_cache()
    key = split_t(torch.from_numpy(PRNGKey(7).astype(np.int64)).cuda())[1]
    same_gumbel = torch.equal(
        gumbel_t(key, tuple(last_logits.shape)).cpu().view(torch.int32),
        gumbel_t(key.cpu(), tuple(last_logits.shape)).view(torch.int32))
    tokens, same_tokens = {}, True
    for kw in SERVE_SAMPLERS:
        a = sample(key, last_logits, SamplerConfig(**kw)).cpu()
        c = sample(key.cpu(), last_logits.cpu(), SamplerConfig(**kw))
        tokens[json.dumps(kw)] = [a.tolist(), c.tolist()]
        same_tokens = same_tokens and torch.equal(a, c)
    ok = same_gumbel and same_tokens
    print(json.dumps({"check": "serve sampler card vs CPU", "card": card,
                      "vocab": int(last_logits.shape[-1]),
                      "gumbel_bits_equal": same_gumbel,
                      "tokens_card_cpu": tokens, "ok": ok}))
    if not ok:
        _fail(f"serve sampler: card and CPU differ: {tokens}")


def _serve_powf(torch, card: str) -> None:
    """(f): ``xla_powf_t`` on the card bit-equal to the CPU (C8)."""
    from repro_torch.core.threefry import xla_powf_t
    gen = torch.Generator().manual_seed(4)
    n = SERVE_POWF_N
    y = torch.cat([torch.rand(n // 2, generator=gen) * 9.2 - 12.1,
                   torch.rand(n - n // 2, generator=gen) * 83.3 - 44.8])
    base = torch.where(torch.arange(n) % 4 == 0,
                       torch.rand(n, generator=gen) * 1e3, 10.0)
    t0 = time.perf_counter()
    got = xla_powf_t(base.cuda(), y.cuda())
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    want = xla_powf_t(base, y)
    diff = int((got.cpu().view(torch.int32) != want.view(torch.int32)).sum())
    print(json.dumps({"check": "serve xla_powf_t card vs CPU (C8)",
                      "card": card, "inputs": n, "bits_differ": diff,
                      "card_s": card_s, "ok": diff == 0}))
    if diff:
        _fail(f"xla_powf_t: {diff} of {n} differ between card and CPU")


def _serve_whisper(torch, kd, card: str) -> None:
    """(g) the audio family.  whisper_base at full width: its cache built
    from WHISPER_SLOTS rows of 1,500 frame embeddings (N(0, 1), bf16; the
    encoder's 6 flash_attention launches, counted apart) for WHISPER_TEXT
    positions, then WHISPER_FORCED teacher-forced and WHISPER_GREEDY greedy
    decode steps, each timed to a synchronize: ms a step (mean and
    median), tokens/s, cache and peak GB, no kernel launched by decode.
    Then at the D = 64 cut (WHISPER_CUTS' second), B = 2: SERVE_FORCED
    teacher-forced then SERVE_GREEDY greedy steps on the card against the
    CPU in fp32 and bf16 within SERVE_BARS (logits, and every self and
    cross cache leaf), the planted ``kv_one_late`` control rejected; and in
    fp32 the same tokens' teacher-forced decode against the prefill forward
    (its kernels) within SERVE_PREFILL_TOL."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as ed
    from repro_torch.models import layers as L
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_leaves, tree_map
    cfg = get_config(WHISPER)
    model = build_model(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, forced, greedy = WHISPER_SLOTS, WHISPER_FORCED, WHISPER_GREEDY
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = model.init(gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((b, cfg.num_frontend_tokens, cfg.d_model),
                         generator=gen, device="cuda").to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (b, forced), generator=gen,
                           device="cuda")
    torch.cuda.reset_peak_memory_stats()
    kd.reset_launch_counts()
    with torch.no_grad():
        t0 = time.perf_counter()
        cache = model.init_cache(params, frames, b, WHISPER_TEXT)
        torch.cuda.synchronize()
        cache_s = time.perf_counter() - t0
        cache_launches = {k: v for k, v in kd.LAUNCHES.items() if v}
        kd.reset_launch_counts()
        tok, step_s, finite = prompt[:, :1], [], True
        t0 = time.perf_counter()
        for t in range(forced + greedy):
            ts = time.perf_counter()
            lg, cache = model.decode_step(params, tok, cache, t)
            tok = (prompt[:, t + 1:t + 2] if t + 1 < forced
                   else lg[:, -1].argmax(-1, keepdim=True))
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
        finite = bool(torch.isfinite(lg).all())
    _no_launches(kd, f"decode {WHISPER}")
    first = step_s[0]
    step_s.sort()
    steps = forced + greedy
    line = {"serve": f"{WHISPER} decode", "card": card,
            "slots": b, "max_seq": WHISPER_TEXT,
            "frames": cfg.num_frontend_tokens, "forced": forced,
            "greedy": greedy, "seconds": wall,
            "ms_per_step": 1e3 * wall / steps,
            "median_step_ms": 1e3 * step_s[len(step_s) // 2],
            "first_step_ms": 1e3 * first, "tokens_per_s": b * steps / wall,
            "cache_build_s": cache_s, "cache_build_launches": cache_launches,
            "cache_gb": _cache_bytes(cache) / 1e9,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "init_s": init_s, "finite": finite, "launches": 0}
    print(json.dumps(line))
    if not finite or cache_launches != {"flash_attention": cfg.encoder_layers}:
        _fail(f"decode {WHISPER}: {json.dumps(line)}")
    del params, cache, frames
    gc.collect()
    torch.cuda.empty_cache()

    late = [("repro_torch.models.encdec.attn_decode", _kv_one_late(torch))]
    steps = SERVE_FORCED + SERVE_GREEDY
    for dtype in SERVE_BARS:
        label, change = WHISPER_CUTS[1]
        cfg = _whisper_cut(change, dtype)
        model = build_model(cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        params = model.init(gen)
        frames = torch.randn((2, cfg.num_frontend_tokens, cfg.d_model),
                             generator=gen, device="cuda")
        tokens = torch.randint(0, cfg.vocab_size, (2, SERVE_FORCED),
                               generator=gen, device="cuda").cpu()
        p_cpu = tree_map(lambda x: x.cpu(), params)
        # The CPU decides the greedy tokens; every card run is fed them.
        want = []
        with torch.no_grad():
            want_cache = model.init_cache(p_cpu, frames.cpu(), 2, steps)
            for t in range(steps):
                lg, want_cache = model.decode_step(
                    p_cpu, tokens[:, t:t + 1], want_cache, t)
                want.append(lg[:, 0])
                if SERVE_FORCED - 1 <= t < steps - 1:
                    tokens = torch.cat(
                        [tokens, lg[:, -1].argmax(-1)[:, None]], dim=1)
        want = torch.stack(want)
        kd.reset_launch_counts()
        got, got_cache = _teacher_forced(torch, model, params, tokens.cuda(),
                                         frames=frames)
        bad, bad_cache = _teacher_forced(torch, model, params, tokens.cuda(),
                                         late, frames)
        bars = SERVE_BARS[dtype]

        def errs(logits, cache):
            return (_rel_err(torch, logits, want),
                    max(_rel_err(torch, g.cpu(), w) for g, w in zip(
                        tree_leaves(cache), tree_leaves(want_cache))))

        logit_err, cache_err = errs(got, got_cache)
        c_logit, c_cache = errs(bad, bad_cache)
        agree = int((got[SERVE_FORCED - 1:-1].argmax(-1)
                     == tokens[:, SERVE_FORCED:].T).sum())
        ok = logit_err <= bars["logits_rel"] and cache_err <= bars["cache_rel"]
        if dtype == "float32":
            ok = ok and agree == 2 * SERVE_GREEDY
        rejected = c_logit > bars["logits_rel"] or c_cache > bars["cache_rel"]
        line = {"check": f"serve card_vs_cpu {label} {dtype}", "card": card,
                "batch": 2, "frames": cfg.num_frontend_tokens,
                "forced": SERVE_FORCED, "greedy": SERVE_GREEDY, "bars": bars,
                "logits_rel_err": logit_err, "cache_rel_err": cache_err,
                "greedy_tokens_agree": agree, "ok": ok,
                "controls": {"kv_one_late": {"logits_rel_err": c_logit,
                                             "cache_rel_err": c_cache,
                                             "rejected": rejected}}}
        print(json.dumps(line))
        if not ok:
            _fail(f"serve card_vs_cpu {label} {dtype}: {json.dumps(line)}")
        if not rejected:
            _fail(f"serve card_vs_cpu {label} {dtype}: the bars did not "
                  f"reject the control kv_one_late")
        if dtype == "float32":
            toks = tokens.cuda()
            kd.reset_launch_counts()
            with torch.inference_mode():
                enc = ed.encode(params, cfg, frames, remat=False)
                hid = ed._decode_hidden(params, cfg, toks, enc, remat=False)
                pre = L.unembed_logits(params["embed"], hid, torch.float32)
                pre = pre.transpose(0, 1).float().cpu()
            kernels = {k: v for k, v in kd.LAUNCHES.items() if v}
            kd.reset_launch_counts()
            dec, _ = _teacher_forced(torch, model, params, toks,
                                     frames=frames)
            err = (dec - pre).abs()
            excess = float((err - SERVE_PREFILL_TOL * (1 + pre.abs())).max())
            line = {"check": f"serve decode_vs_prefill {label} float32",
                    "card": card, "batch": 2, "seq": toks.shape[1],
                    "prefill_launches": kernels,
                    "max_abs_err": float(err.max()),
                    "max_abs_logit": float(pre.abs().max()),
                    "atol": SERVE_PREFILL_TOL, "rtol": SERVE_PREFILL_TOL,
                    "ok": bool(np.isfinite(excess) and excess <= 0)}
            print(json.dumps(line))
            if not line["ok"] or not kernels:
                _fail(f"serve decode_vs_prefill {label}: "
                      f"{json.dumps(line)}")
        del params, p_cpu, got_cache, want_cache, bad_cache
        gc.collect()
        torch.cuda.empty_cache()


def serve_path(torch, kd, cli: _Alongside | None = None) -> dict:
    """Phase 7: decode and serving on the card ((a)–(g)).  Decode reaches
    no kernel, so the main-path launches it adds are all 0 (whisper's
    cache build runs its encoder's kernels, counted apart).  ``cli``: (b)'s
    process, if main() began it earlier."""
    card = _card_line()
    t0 = time.perf_counter()
    parts = {}
    for name, fn in (("engines", lambda: _serve_engines(torch, kd, card)),
                     ("cli", lambda: _serve_cli(card, cli)),
                     ("card_vs_cpu", lambda: _serve_card_vs_cpu(torch, kd,
                                                                card)),
                     ("decode_vs_prefill",
                      lambda: _serve_decode_vs_prefill(torch, kd, card)),
                     ("engine_and_sampler",
                      lambda: _serve_engine_and_sampler(torch, kd, card)),
                     ("powf", lambda: _serve_powf(torch, card)),
                     ("whisper", lambda: _serve_whisper(torch, kd, card))):
        ts = time.perf_counter()
        fn()
        parts[name] = time.perf_counter() - ts
    kd.reset_launch_counts()
    print(json.dumps({"phase": "serve_path", "card": card,
                      "seconds": time.perf_counter() - t0,
                      "part_seconds": parts, "launches": {}}))
    return {k: 0 for k in kd.LAUNCHES}


# Phase 8, training.  (a) The two backward kernels against their plain
# twins on the card: flash_attention's at qwen3's (2, 4096, 16, 128),
# smollm's (2, 4096, 15, 64), zamba2's D = 80 (1, 4096, 32, 80), a
# 1000-key window at (1, 4096, 8, 128), fp32 at (2, 1024, 16, 128), and
# rows whose S is no multiple of the 64-row tile (one with Sq < Sk and a
# window, one fp32 at D = 12, non-causal); past D = 128 (gemma3's and
# pixtral's heads) gemma3's (1, 4096, 8, 256) causal and with its
# 1,024-key window, pixtral's (1, 5120, 32, 160), a ragged row with Sq <
# Sk at each, and fp32 at both, as (B, Sq, Sk, H, D, causal, window,
# dtype); the first row is the summary row.  The planted fault (a key
# tile dropped) runs at the first causal, unwindowed bf16 row of each
# head dim in ATTN_BWD_FAULT_DIMS.  Each gradient is held per element to rel·|plain| + rel_row·(its
# row's rms over D) + rel_max·max|plain|, and normwise to rel_l2
# (ATTN_BWD_BARS, as (rel, rel_row, rel_max, rel_l2)): bf16 rounds each
# result once (one ulp is ≤ 2^-7 of it) from fp32 sums in another order;
# the small rel_max term covers the rows whose exact gradient cancels to
# 0 (a query that sees one key has dS = 0), where only fp32 noise is left.
# The first bars, (2^-7, 0, 2^-7, 1e-2), let the planted fault through at
# 7.2x; the row term takes their place.  ssm_scan's backward at falcon's
# (1, 4096, 8192, 16) and three more shapes must be bit-equal.
ATTN_BWD_BARS = {"bfloat16": (2.0 ** -7, 2.0 ** -5, 2.0 ** -10, 1e-2),
                 "float32": (2e-5, 4e-5, 1e-5, 1e-5)}
ATTN_BWD_ROWS = (
    (2, 4096, 4096, 16, 128, True, None, "bfloat16"),   # qwen3
    (2, 4096, 4096, 15, 64, True, None, "bfloat16"),    # smollm
    (1, 4096, 4096, 32, 80, True, None, "bfloat16"),    # zamba2's D = 80
    (1, 4096, 4096, 8, 128, True, 1000, "bfloat16"),    # window 1000
    (2, 1024, 1024, 16, 128, True, None, "float32"),
    (1, 1000, 1000, 4, 80, True, None, "bfloat16"),     # S % 64 != 0
    (1, 300, 1000, 4, 64, True, 128, "bfloat16"),       # Sq < Sk, window
    (2, 200, 200, 2, 12, False, None, "float32"),       # non-causal, D 12
    (1, 4096, 4096, 8, 256, True, None, "bfloat16"),    # gemma3's global
    (1, 4096, 4096, 8, 256, True, 1024, "bfloat16"),    # gemma3's local
    (1, 5120, 5120, 32, 160, True, None, "bfloat16"),   # pixtral
    (1, 300, 1000, 4, 256, True, None, "bfloat16"),     # Sq < Sk, ragged
    (1, 300, 1000, 4, 160, True, 128, "bfloat16"),      # the same, window
    (1, 1024, 1024, 8, 256, True, None, "float32"),
    (1, 1000, 1000, 8, 160, True, 200, "float32"),
    (8, 1500, 1500, 8, 64, False, None, "bfloat16"),    # whisper's encoder
    (8, 448, 1500, 8, 64, False, None, "bfloat16"))     # its cross
ATTN_BWD_FAULT_DIMS = (128, 256, 160)
# The rows phase 2 profiles, (B, S, H, D), causal: the first three of
# ATTN_BWD_ROWS, gemma3's and pixtral's.
ATTN_BWD_ROWS_PROFILED = ((2, 4096, 16, 128), (2, 4096, 15, 64),
                          (1, 4096, 32, 80), (1, 4096, 8, 256),
                          (1, 5120, 32, 160))
SSM_BWD_ROWS = ((1, 4096, 8192, 16), (1, 256, 8192, 16), (2, 100, 1000, 16),
                (1, 37, 3, 5))
# ssd_scan's backward, (B, S, H, P, N, chunk) and inputs (_ssd_inputs, dy
# drawn N(0, 1)): zamba2's (1, 4096, 80, 64, 64, 128) (the summary row),
# its cut at S = 256, a ragged S at B = 2 with 8 heads, the smoke width
# (1, 37, 4, 32, 16, 16), zamba2's shape at near-unit decay, and B = 4 as
# the fleet step's client fold hands it.  dxh, da, db and dc each within
# SSD_BWD_BAR·(1 + max|plain|) of the plain twin (the forward's bar: fp32
# sums in another order, 3×TF32 products); a planted fault per row, every
# chunk handed the state gradient of the chunk after it (G one chunk
# late), must fail it by ≥ 10×.
SSD_BWD_ROWS = (((1, 4096, 80, 64, 64, 128), "model"),
                ((1, 256, 80, 64, 64, 128), "model"),
                ((2, 1000, 8, 64, 64, 128), "model"),
                ((1, 37, 4, 32, 16, 16), "model"),
                ((1, 4096, 80, 64, 64, 128), "near_unit"),
                ((4, 256, 80, 64, 64, 128), "model"))
SSD_BWD_BAR = 5e-5
# (b) make_train_step at full width: qwen3_0_6b, B = 2 × 4096 (one
# lm_batches batch), AdamW under warmup_cosine_lr, clip 1.0, 6 steps with
# remat, then one without; falcon_mamba_7b at 8 of its 64 layers (at 64 the
# fp32 params, gradients and momentum alone are ≈ 87 GB), B = 1 × 4096,
# SGD, 3 steps.  (c) launch/train at full width: smollm_360m in process,
# TRAIN_LAUNCH's round, 4 clients, 4 steps a round; the CLI once at
# --smoke.  (d)
# run_spmd_feddif (smollm-smoke, 4 clients, 2 rounds) on the card and on
# the CPU: equal ledgers, loss histories within SPMD_LOSS_BAR (bf16 compute
# on both; the CPU tests hold the port to the reference within 2e-3).
TRAIN_QWEN = {"arch": "qwen3_0_6b", "batch": 2, "seq": 4096, "steps": 6,
              "peak_lr": 3e-4, "warmup": 2}
TRAIN_FALCON = {"arch": "falcon_mamba_7b", "layers": 8, "batch": 1,
                "seq": 4096, "steps": 3, "lr": 1e-3}
# zamba2_2_7b at full width and depth (54 mamba2 layers through ssd_scan
# and its backward, 9 shared attention blocks at D = 80), B = 1 × 4096,
# AdamW under warmup_cosine_lr as qwen3's run (one warm-up step of the
# three: the first step's lr is 0), remat on.
TRAIN_ZAMBA2 = {"arch": "zamba2_2_7b", "batch": 1, "seq": 4096, "steps": 3,
                "peak_lr": 3e-4, "warmup": 1}
# gemma3_4b at 12 of its 34 layers (two bodies of 5 ``swa`` + 1 ``attn``:
# 10 windowed layers and 2 global, D = 256), B = 1 × 4096 (train_4k's
# sequence), AdamW under warmup_cosine_lr as zamba2's run; pixtral_12b at
# 4 of its 40 layers (D = 160), B = 1 × (1,024 seeded N(0, 1) patch
# embeddings + 4,096 tokens), SGD with momentum 0.9 (the paper's local
# optimizer) at a constant rate; clip 1.0 and remat, 3 timed steps.  The
# depth is cut so that the functional optimizer step fits the card: at 34
# layers gemma3's 3.88 B params under AdamW (7× the fp32 params) need ≈
# 108 GB, and at 40 pixtral's params and gradients alone ≈ 102 GB.
TRAIN_GEMMA3 = {"arch": "gemma3_4b", "layers": 12, "batch": 1, "seq": 4096,
                "steps": 3, "peak_lr": 3e-4, "warmup": 1}
TRAIN_PIXTRAL = {"arch": "pixtral_12b", "layers": 4, "batch": 1,
                 "seq": 4096, "patches": 1024, "steps": 3, "lr": 1e-3}
# The card-against-CPU step of phase 8b, at each of these smoke configs.
TRAIN_CARD_VS_CPU = ("qwen3_0_6b", "zamba2_2_7b", "mixtral_8x22b",
                     "gemma3_4b", "pixtral_12b")
# And at the head-dim cuts of tests/test_torch_zoo.py (HEAD_DIM_CUTS: the
# smoke configs at gemma3's head dim 256 with a 16-key window, and at
# pixtral's 160): one fp32 step (the CUDA-core kernels; params within
# 1e-5) and the bf16 gradients (the wgmma instances; each leaf within
# GRAD_BARS_BF16 of the CPU's, as max|Δg| / max|g| and ‖Δg‖ / ‖g‖, the
# bars tests/test_torch_zoo_grad.py holds the port to the reference by).
TRAIN_HEAD_DIM_CUTS = {
    "gemma3_4b@256": ("gemma3_4b", dict(
        name="gemma3-hd256", d_model=384, num_heads=2, num_kv_heads=1,
        head_dim=256, d_ff=256, sliding_window=16, local_global_ratio=1)),
    "pixtral_12b@160": ("pixtral_12b", dict(
        name="pixtral-hd160", d_model=320, num_heads=2, num_kv_heads=1,
        d_ff=256)),
}
GRAD_BARS_BF16 = (0.1, 0.05)
# whisper_base at full width and depth, B = 64 × (1,500 seeded N(0, 1)
# frame embeddings + WHISPER_TEXT tokens): train_4k's batch of 256 cut to
# 64 for the script's time; AdamW under warmup_cosine_lr as zamba2's run,
# clip 1.0 and remat, 3 timed steps.  Its card-against-CPU steps run at
# WHISPER_CUTS (one fp32 step each; the bf16 gradients at D = 64).
TRAIN_WHISPER = {"arch": WHISPER, "batch": 64, "seq": WHISPER_TEXT,
                 "steps": 3, "peak_lr": 3e-4, "warmup": 1}
# run_spmd_feddif's configs in phase 8d (their smoke configs).
SPMD_ARCHS = ("smollm_360m", "zamba2_2_7b")
# (1 round since the SSD backward's phase: 2 until then.)
TRAIN_LAUNCH = {"arch": "smollm_360m", "rounds": 1, "clients": 4,
                "steps_per_round": 4}
TRAIN_CLI = ["--smoke", "--rounds", "1", "--clients", "2",
             "--steps-per-round", "2"]
SPMD_LOSS_BAR = 1e-2


def _events_ms(torch, fn, reps: int) -> float:
    """Device ms per call from CUDA events around ``reps`` calls after one
    warm call: the calls here take milliseconds, so the host's share is
    negligible and no CUDA graph is needed (autograd's backward, the
    library's, is not captured)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _attn_bwd_err(torch, got, want, dt: str) -> dict:
    """Each of (dq, dk, dv) against its plain version under
    ATTN_BWD_BARS[dt]: the largest ratio of an element's error to its bar
    and the normwise relative error; ``bar_ratio`` is the worst of the
    three ratios, each normwise error taken against its bar too."""
    rel, rel_row, rel_max, rel_l2 = ATTN_BWD_BARS[dt]
    per, worst = {}, 0.0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        g, w = g.float(), w.float()
        err = (g - w).abs()
        bar = (rel * w.abs() + rel_row * w.pow(2).mean(-1, keepdim=True)
               .sqrt() + rel_max * w.abs().max())
        ratio = float(torch.where(err > 0, err / bar.clamp_min(1e-30),
                                  0.0).max())
        l2 = float(torch.linalg.vector_norm(g - w)
                   / torch.linalg.vector_norm(w).clamp_min(1e-30))
        per[name] = {"max_abs_err": float(err.max()), "bar_ratio": ratio,
                     "rel_l2_err": l2}
        worst = max(worst, ratio, l2 / rel_l2)
    return {"grads": per, "bar_ratio": worst,
            "bars": [rel, rel_row, rel_max, rel_l2],
            "max_abs_err": max(v["max_abs_err"] for v in per.values()),
            "ok": worst <= 1.0}


def _attn_bwd_route(dt: str, d: int) -> tuple[str, list[str]]:
    """The route one flash_attention_bwd call takes and the device kernels
    it launches once each (``bwd_kernel_launches``' names): bf16 on the
    tensor cores' ``wgmma`` instances of its head dim, fp32 on the CUDA
    cores; each after the Δ pass.  (torch.profiler, which phase 2 uses for
    their device µs, saw none of them in phase 8 of a full run, so the
    route is read from the library's launch counts.)"""
    if dt == "bfloat16":
        return "wgmma", ["fa_bwd_delta_kernel",
                         f"fa_bwd_dkdv_wgmma_kernel<{d}>",
                         f"fa_bwd_dq_wgmma_kernel<{d}>"]
    return "cuda_cores", ["fa_bwd_delta_kernel", "fa_bwd_dkdv_kernel",
                          "fa_bwd_dq_kernel"]


def profile_attention_bwd(torch) -> None:
    """Phase 2 (a measurement): the attention backward at the zoo's bf16
    shapes (qwen3, smollm, zamba2's D = 80, gemma3's D = 256 and pixtral's
    D = 160; ATTN_BWD_ROWS_PROFILED) under ``torch.profiler``,
    each device kernel's µs a launch beside the call's ms (CUDA events).
    It runs before any other profile: after phases 5 and 6 had profiled,
    the profiler recorded only the last of the call's three kernels."""
    from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for b, s, h, d in ATTN_BWD_ROWS_PROFILED:
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = flash_attention_cuda(q, k, v, return_lse=True)

        def fn():
            flash_attention_bwd_cuda(q, k, v, o, do, lse)

        print(json.dumps({"profile": "flash_attention_bwd",
                          "shape": [b, s, s, h, d], "dtype": "bfloat16",
                          "device_kernels_us": _cuda_kernels(torch, fn),
                          "ms": _events_ms(torch, fn, 10)}))
        del q, k, v, do, o, lse


def _cuda_kernels(torch, fn, calls: int = 3) -> dict[str, float]:
    """The attention backward's device kernels (by function name) that
    ``fn`` launches, each with its mean device µs a launch, from
    ``torch.profiler`` (CPU and CUDA activities, as ``profile_round``)
    over ``calls`` calls after a warm-up kernel: after an earlier profile
    in the same process a window's first kernels went unrecorded."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, seen = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in re.findall(r"fa_bwd_[a-z0-9_]*?kernel", ev.name):
            us[name] = us.get(name, 0.0) + (ev.time_range.end
                                            - ev.time_range.start)
            seen[name] = seen.get(name, 0) + 1
    return {name: us[name] / seen[name] for name in sorted(us)}


def _attn_bwd_tile_dropped(torch, q, k, v, do, tile: int = 64,
                           causal: bool = True, start: int | None = None):
    """The gradients of attention, by autograd of the plain form, with keys
    [start, start + tile) (start Sk/2 by default) hidden from every query:
    what a backward that dropped one key tile's contribution would return
    (their dK and dV 0, every dQ that saw them off)."""
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    qf, kf, vf = leaves
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    start = sk // 2 if start is None else start
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) / d ** 0.5
    q_pos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    hidden = (k_pos >= start) & (k_pos < start + tile)
    if causal:
        hidden = hidden | (k_pos > q_pos)
    p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
    del s
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    grads = torch.autograd.grad(out, leaves, do.float())
    return tuple(g.to(q.dtype) for g in grads)


def check_train_kernels(torch, kref) -> list[dict]:
    """Phase 8a: the backward kernels against their plain twins on the
    card (ATTN_BWD_ROWS, SSM_BWD_ROWS, SSD_BWD_ROWS), the same bits on two
    calls, and a planted fault per kernel that must fail its bar by ≥ 10×
    (ssd_scan's at every row: G one chunk late).  The
    attention backward takes the forward kernel's lse and its twin
    ``torch.logsumexp``'s; one call must launch the route's device kernels
    once each and no other (``_attn_bwd_route``: bf16 on the ``wgmma``
    instances of its head dim; the library's own counts,
    ``bwd_kernel_launches``).  The faults: flash_attention's gradients
    with the key tile [S/2, S/2 + 64) dropped, at the first causal,
    unwindowed bf16 row of each head dim in ATTN_BWD_FAULT_DIMS, and
    ssm_scan's ``dda`` from ``h_t`` in place of ``h_{t−1}`` at its
    summary row.  Kernel and plain ms, and for attention the library's
    (``scaled_dot_product_attention``'s backward alone, from a retained
    graph), by CUDA events.  The bound: the backward's five products
    (10·D flops a visible pair) at the dtype's peak against q, k, v, o, dO
    read and dq, dk, dv written once; ssm_scan's five (B, S, D, N) fp32
    tensors against three flops an element; ssd_scan's products
    (_ssd_bwd_flops) as fp32 FMAs (``bound_tc_ms``: three TF32 products
    each at the tensor cores' peak) against xh, dy, dxh, a, da, b, c, db,
    dc and the forward's saved states and decays, each once.  Each
    ssd_scan row carries ptxas' registers and spill bytes of its
    kernels."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (bwd_kernel_launches,
                                                     flash_attention_bwd_cuda,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ssd_scan import ssd_scan_bwd_cuda, ssd_scan_cuda
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd_cuda, ssm_scan_cuda
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []

    def record(row, control=None):
        print(json.dumps(row))
        if not row["ok"]:
            _fail(f"{row['name']} {row['shape']} disagrees with its plain "
                  f"twin beyond its bar: {json.dumps(row)}")
        if control is not None and not control["rejected"]:
            _fail(f"{row['name']} {row['shape']}: the planted fault "
                  f"passed within 10x of the bar: {json.dumps(control)}")
        rows.append(row)

    faulted = set()
    for b, sq, sk, h, d, causal, window, dt in ATTN_BWD_ROWS:
        dtype = getattr(torch, dt)
        q, do = (torch.randn((b, sq, h, d), generator=gen, device="cuda")
                 .to(dtype) for _ in range(2))
        k, v = (torch.randn((b, sk, h, d), generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        kw = dict(causal=causal, window=window)
        # The kernel takes the forward kernel's lse, the plain twin
        # torch.logsumexp's: a wrong lse shows as a gradient off its bar.
        o, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        lse_plain = kref.flash_attention_ref(q, k, v, return_lse=True,
                                             **kw)[1]
        got = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        again = flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        want = kref.flash_attention_bwd_ref(q, k, v, o, do, lse=lse_plain,
                                            **kw)
        torch.cuda.synchronize()
        before = bwd_kernel_launches()
        flash_attention_bwd_cuda(q, k, v, o, do, lse, **kw)
        after = bwd_kernel_launches()
        kernels = {k_: after[k_] - before[k_] for k_ in after
                   if after[k_] != before[k_]}
        route, want_kernels = _attn_bwd_route(dt, d)
        row = {"name": "flash_attention_bwd", "shape": [b, sq, sk, h, d],
               "dtype": dt, "causal": causal, "window": window,
               **_attn_bwd_err(torch, got, want, dt),
               "same_bits": all(torch.equal(x, y)
                                for x, y in zip(got, again)),
               "device_kernels": kernels, "route": route}
        if route == "wgmma":
            row["split"] = ("two passes over the query tiles (dK, then dV)"
                            if d > 128 else "one pass")
        row["ok"] = (row["ok"] and row["same_bits"]
                     and kernels == dict.fromkeys(want_kernels, 1))
        control = None
        if (dt == "bfloat16" and causal and window is None
                and d in ATTN_BWD_FAULT_DIMS and d not in faulted):
            faulted.add(d)
            fault = _attn_bwd_tile_dropped(torch, q, k, v, do)
            c = _attn_bwd_err(torch, fault, want, dt)
            control = {"fault": "key tile [S/2, S/2 + 64) dropped",
                       "bar_ratio": c["bar_ratio"],
                       "rejected": c["bar_ratio"] >= 10.0}
            row["control_tile_dropped"] = control
            del fault
        elif dt == "bfloat16" and not causal and sk % 64:
            fault = _attn_bwd_tile_dropped(torch, q, k, v, do, sk % 64,
                                           False, sk - sk % 64)
            c = _attn_bwd_err(torch, fault, want, dt)
            control = {"fault": f"the ragged last key tile [{sk - sk % 64}"
                                f", {sk}) dropped",
                       "bar_ratio": c["bar_ratio"],
                       "rejected": c["bar_ratio"] >= 10.0}
            row["control_tail_tile_dropped"] = control
            del fault
        pairs = b * h * _visible_pairs(sq, sk, causal, window)
        flops = 10.0 * d * pairs
        bound, by = _bound(q.element_size() * 4.0 * h * d * b * (sq + sk),
                           flops, BF16_FLOPS_PER_S if dt == "bfloat16"
                           else FP32_FLOPS_PER_S)
        del got, again, want
        big = sq * sk >= 2 ** 20
        row["ms"] = _events_ms(torch, lambda: flash_attention_bwd_cuda(
            q, k, v, o, do, lse, **kw), 5 if big else 20)
        row["plain_ms"] = _events_ms(torch, lambda: kref.flash_attention_bwd_ref(
            q, k, v, o, do, lse=lse_plain, **kw), 1 if big else 5)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                      for x in (q, k, v))
        dot = do.transpose(1, 2).contiguous()
        if window is None and (sq == sk or not causal):
            mask = None
        else:
            q_pos = torch.arange(sq, device="cuda")[:, None] + (sk - sq)
            k_pos = torch.arange(sk, device="cuda")[None, :]
            mask = k_pos <= q_pos
            if window is not None:
                mask &= k_pos > q_pos - window
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None)
        row["library_ms"] = _events_ms(torch, lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True),
            5 if big else 20)
        row.update({"bound_ms": bound, "bound_by": by, "flops": flops})
        del lib_out, qt, kt, vt, dot, q, k, v, o, do, lse, lse_plain
        record(row, control)
        torch.cuda.empty_cache()
    if faulted != set(ATTN_BWD_FAULT_DIMS):
        _fail(f"flash_attention_bwd: the planted fault ran at D in "
              f"{sorted(faulted)}, want {sorted(ATTN_BWD_FAULT_DIMS)}")

    for i, (b, s, d, n) in enumerate(SSM_BWD_ROWS):
        da = torch.exp(-torch.rand((b, s, d, n), generator=gen,
                                   device="cuda"))
        dbx = 0.1 * torch.randn((b, s, d, n), generator=gen, device="cuda")
        dhs = torch.randn((b, s, d, n), generator=gen, device="cuda")
        hs = ssm_scan_cuda(da, dbx)
        del dbx
        dda, ddbx = ssm_scan_bwd_cuda(da, hs, dhs)
        again = ssm_scan_bwd_cuda(da, hs, dhs)
        want = kref.ssm_scan_bwd_ref(da, hs, dhs)
        torch.cuda.synchronize()
        err = max(float((x - y).abs().max()) for x, y in zip((dda, ddbx),
                                                             want))
        tol = 1e-6 * (1.0 + max(float(y.abs().max()) for y in want))
        exact = all(torch.equal(x, y) for x, y in zip((dda, ddbx), want))
        same = all(torch.equal(x, y) for x, y in zip((dda, ddbx), again))
        row = {"name": "ssm_scan_bwd", "shape": [b, s, d, n],
               "max_abs_err": err, "tol": tol, "bit_exact": exact,
               "same_bits": same, "ok": exact and same and err <= tol}
        del again
        control = None
        if i == 0:
            fault_err = float((want[1] * hs - want[0]).abs().max())
            control = {"fault": "dda from h_t in place of h_{t-1}",
                       "max_abs_err": fault_err, "tol": tol,
                       "rejected": fault_err >= 10.0 * tol}
            row["control_h_t"] = control
        del dda, ddbx, want
        bound, by = _bound(20.0 * b * s * d * n, 3.0 * b * s * d * n)
        row["ms"] = _events_ms(torch, lambda: ssm_scan_bwd_cuda(da, hs, dhs),
                               5 if s > 1000 else 20)
        row["plain_ms"] = _events_ms(torch, lambda: kref.ssm_scan_bwd_ref(
            da, hs, dhs), 1 if s > 1000 else 3)
        row.update({"library_ms": None, "bound_ms": bound, "bound_by": by})
        del da, hs, dhs
        record(row, control)
        torch.cuda.empty_cache()

    from repro_torch.kernels import build
    ptxas = _ptxas_table(build.PTXAS_INFO.get("ssd_scan_bwd") or "",
                         SSD_BWD_KERNELS)
    for (b, s, h, p, n, chunk), kind in SSD_BWD_ROWS:
        xh, a, bm, cm = _ssd_inputs(torch, gen, (b, s, h, p, n), kind)
        dy = torch.randn((b, s, h, p), generator=gen, device="cuda")
        _, st, ac = ssd_scan_cuda(xh, a, bm, cm, chunk=chunk,
                                  return_state=True)
        kw = dict(states=st, acum=ac, chunk=chunk)
        got = ssd_scan_bwd_cuda(xh, a, bm, cm, dy, **kw)
        again = ssd_scan_bwd_cuda(xh, a, bm, cm, dy, **kw)
        want = kref.ssd_scan_bwd_ref(xh, a, bm, cm, dy, chunk)
        # The planted fault, from the plain stages: G one chunk late.
        acum, own = kref.ssd_chunk_states_ref(xh, a, bm, chunk)
        entering = kref.ssd_state_pass_ref(own, acum)
        grads = kref.ssd_bwd_pass_ref(
            kref.ssd_bwd_local_ref(dy, acum, cm, chunk), acum)
        late = torch.cat([grads[:, 1:], torch.zeros_like(grads[:, :1])], 1)
        fault = kref.ssd_bwd_chunks_ref(xh, acum, bm, cm, dy, entering, late,
                                        chunk)
        del acum, own, entering, grads, late
        torch.cuda.synchronize()
        per, worst, fault_ratio = {}, 0.0, 0.0
        for name, g, w, g2, f in zip(("dxh", "da", "db", "dc"), got, want,
                                     again, fault):
            tol = SSD_BWD_BAR * (1.0 + float(w.abs().max()))
            err = float((g - w).abs().max())
            per[name] = {"max_abs_err": err, "tol": tol,
                         "bar_ratio": err / tol,
                         "same_bits": bool(torch.equal(g, g2))}
            worst = max(worst, err / tol)
            fault_ratio = max(fault_ratio,
                              float((f - w).abs().max()) / tol)
        control = {"fault": "G one chunk late", "bar_ratio": fault_ratio,
                   "rejected": fault_ratio >= 10.0}
        row = {"name": "ssd_scan_bwd", "shape": [b, s, h, p, n, chunk],
               "inputs": kind, "grads": per, "bar_ratio": worst,
               "max_abs_err": max(v["max_abs_err"] for v in per.values()),
               "same_bits": all(v["same_bits"] for v in per.values()),
               "control_grad_late": control}
        row["ok"] = worst <= 1.0 and row["same_bits"]
        del got, again, want, fault
        flops = _ssd_bwd_flops(b, s, h, p, n, chunk)
        nbytes = 4.0 * (3 * b * s * h * p + 2 * b * s * h + 4 * b * s * n
                        + st.numel() + ac.numel())
        bound, by = _bound(nbytes, flops)
        bound_tc, by_tc = _bound(nbytes, 3.0 * flops, TF32_FLOPS_PER_S)
        big = s * h >= 100_000
        row["ms"] = _events_ms(torch, lambda: ssd_scan_bwd_cuda(
            xh, a, bm, cm, dy, **kw), 10 if big else 20)
        row["plain_ms"] = _events_ms(torch, lambda: kref.ssd_scan_bwd_ref(
            xh, a, bm, cm, dy, chunk), 2 if big else 5)
        row.update({"library_ms": None, "bound_ms": bound, "bound_by": by,
                    "bound_tc_ms": bound_tc, "bound_tc_by": by_tc,
                    "flops": flops,
                    "ptxas_spill_store_load_registers": ptxas})
        del xh, a, bm, cm, dy, st, ac
        record(row, control)
        torch.cuda.empty_cache()
    return rows


def _zoo_launches(cfg, steps: int, remat: bool) -> dict:
    """Each kernel's launches in ``steps`` train steps of ``cfg``'s layer
    plan: a layer's forward kernels once a step, twice under remat (the
    recompute), its backward kernels once."""
    from repro_torch.kernels.ssd_scan import BWD_LAUNCHES
    from repro_torch.models.transformer import build_plan
    fwd = 2 if remat else 1
    if cfg.family == "audio":
        # Each encoder layer one attention, each decoder layer two.
        n = (cfg.encoder_layers or cfg.num_layers) + 2 * cfg.num_layers
        return {"flash_attention": fwd * n * steps,
                "flash_attention_bwd": n * steps}
    kernels = {"attn": (("flash_attention",), ("flash_attention_bwd",)),
               "swa": (("flash_attention",), ("flash_attention_bwd",)),
               "shared": (("flash_attention",), ("flash_attention_bwd",)),
               "mamba1": (("ssm_scan",), ("ssm_scan_bwd",)),
               "mamba2": (("ssd_scan_state", "ssd_scan_pass", "ssd_scan"),
                          BWD_LAUNCHES)}
    want: dict = {}
    for kinds, count in build_plan(cfg):
        for kind in kinds:
            f, b = kernels[kind]
            for k in f:
                want[k] = want.get(k, 0) + fwd * count * steps
            for k in b:
                want[k] = want.get(k, 0) + count * steps
    return want


# The attention library's device-kernel and instance launches of phase
# 8b's counted steps (``_attn_instance_counts``), for the summary line.
TRAIN_INSTANCES: dict[str, int] = {}


def _attn_instance_counts(before: tuple | None = None) -> tuple:
    """The forward's and backward's library counts of each device kernel
    and instance; given an earlier reading, the launches since it (and
    those are added to TRAIN_INSTANCES)."""
    from repro_torch.kernels.flash_attention import (bwd_kernel_launches,
                                                     fwd_kernel_launches)
    now = (fwd_kernel_launches(), bwd_kernel_launches())
    if before is None:
        return now
    diff = {k: n[k] - b[k] for n, b in zip(now, before) for k in n
            if n[k] != b[k]}
    for k, v in diff.items():
        TRAIN_INSTANCES[k] = TRAIN_INSTANCES.get(k, 0) + v
    return diff


def _want_instances(cfg, steps: int) -> dict:
    """The attention instances ``steps`` remat train steps of ``cfg``
    launch in bf16 at a head dim of BF16_HEAD_DIMS: the forward's
    ``wgmma`` instance twice a layer a step, the backward's Δ, dK/dV and
    dQ instances once."""
    w = _zoo_launches(cfg, steps, True)
    d = cfg.resolved_head_dim
    return {f"flash_attention_wgmma_kernel<{d}>": w["flash_attention"],
            **dict.fromkeys(_attn_bwd_route("bfloat16", d)[1],
                            w["flash_attention_bwd"])}


def _train_run(torch, kd, label, model, params, opt, lr_fn, batch, steps,
               remat=True, clip=1.0) -> dict:
    """``steps`` train steps from ``params`` on one batch (an untimed step
    on a copy first), the counters zeroed before the timed steps: seconds
    a step (host clock, ending in a synchronize), tokens/s, the losses and
    gradient norms, and the peak memory (the collector run first).  Past
    the first timed step the run keeps no reference to ``params``: a
    caller that keeps none either (zamba2's) leaves the step its old state,
    gradients and new state, 7× the fp32 params under AdamW."""
    from repro_torch.train.trainstep import TrainState, make_train_step
    step = make_train_step(model, opt, lr_fn, clip_norm=clip, remat=remat)
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    warm, _ = step(TrainState(params, opt.init(params), zero), batch)
    del warm
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = TrainState(params, opt.init(params), zero)
    del params
    kd.reset_launch_counts()
    routes = _attn_instance_counts()
    losses, norms, secs = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    tokens = batch["tokens"].numel()
    # A vision batch's patch embeddings, an audio batch's frames.
    patches = sum(batch[k].shape[:2].numel()
                  for k in ("patch_embeddings", "frames") if k in batch)
    out = {"run": label, "remat": remat, "steps": steps,
           "step_s": secs, "mean_step_s": sum(secs) / steps,
           "tokens_per_s": tokens * steps / sum(secs),
           **({"positions_per_s": (tokens + patches) * steps / sum(secs)}
              if patches else {}),
           "losses": losses, "grad_norms": norms,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "launches": {k: v for k, v in kd.LAUNCHES.items() if v},
           "instances": _attn_instance_counts(routes)}
    print(json.dumps(out))
    if not all(math.isfinite(x) for x in losses + norms):
        _fail(f"{label}: a loss or gradient norm is not finite: {out}")
    return out


def train_step_path(torch, kd) -> dict:
    """Phase 8b: ``make_train_step`` at full width (TRAIN_QWEN,
    TRAIN_FALCON, TRAIN_ZAMBA2, then ``wide_attention_train``'s gemma3 and
    pixtral) and ``train_card_vs_cpu``'s steps on the card against the
    CPU (plain twins) from one init.  The qwen3 and zamba2 losses must
    fall over their steps and remat must lower qwen3's peak; each kernel
    launches as the layers say (_zoo_launches): the forward twice a layer
    a step with remat (the recompute), once without, the backward once."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.data.synthetic import lm_corpus
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as opt_lib
    launches = {name: 0 for name in kd.LAUNCHES}
    card = _card_line()

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    q = TRAIN_QWEN
    cfg = get_config(q["arch"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = lm_corpus(200_000, vocab=cfg.vocab_size, seed=0)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(lm_batches(
        tokens, q["batch"], q["seq"], seed=0)).items()}
    opt = opt_lib.adamw()
    lr_fn = opt_lib.warmup_cosine_lr(q["peak_lr"], q["warmup"], q["steps"])
    on = _train_run(torch, kd, f"train {q['arch']}", model, params, opt,
                    lr_fn, batch, q["steps"])
    off = _train_run(torch, kd, f"train {q['arch']}", model, params, opt,
                     lr_fn, batch, 1, remat=False)
    for run, remat in ((on, True), (off, False)):
        w = _zoo_launches(cfg, run["steps"], remat)
        if run["launches"] != w:
            _fail(f"train {q['arch']} remat={remat}: launches "
                  f"{run['launches']}, want {w}")
        add(run["launches"])
    if not on["losses"][-1] < on["losses"][0]:
        _fail(f"train {q['arch']}: the loss did not fall: {on['losses']}")
    if not on["peak_memory_gb"] < off["peak_memory_gb"]:
        _fail(f"train {q['arch']}: remat did not lower the peak: "
              f"{on['peak_memory_gb']} vs {off['peak_memory_gb']} GB")
    print(json.dumps({"train_summary": q["arch"], "card": card,
                      "peak_gb_remat": on["peak_memory_gb"],
                      "peak_gb_no_remat": off["peak_memory_gb"],
                      "loss_first_last": [on["losses"][0],
                                          on["losses"][-1]]}))
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()

    f = TRAIN_FALCON
    cfg = dc.replace(get_config(f["arch"]), num_layers=f["layers"])
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    tokens = lm_corpus(100_000, vocab=cfg.vocab_size, seed=1)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(lm_batches(
        tokens, f["batch"], f["seq"], seed=1)).items()}
    run = _train_run(torch, kd, f"train {f['arch']} at {f['layers']} of 64 "
                     f"layers", model, params, opt_lib.sgd(),
                     opt_lib.constant_lr(f["lr"]), batch, f["steps"])
    w = _zoo_launches(cfg, f["steps"], True)
    if run["launches"] != w:
        _fail(f"train {f['arch']}: launches {run['launches']}, want {w}")
    add(run["launches"])
    del params, batch, model
    gc.collect()
    torch.cuda.empty_cache()

    z = TRAIN_ZAMBA2
    cfg = get_config(z["arch"])
    model = build_model(cfg)
    tokens = lm_corpus(100_000, vocab=cfg.vocab_size, seed=2)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(lm_batches(
        tokens, z["batch"], z["seq"], seed=2)).items()}
    # The params go to the run alone: AdamW's functional step holds the
    # old and the new state at once (≈ 63 GiB of the card's 79).
    run = _train_run(torch, kd, f"train {z['arch']}", model,
                     model.init(torch.Generator(device="cuda").manual_seed(0)),
                     opt_lib.adamw(), opt_lib.warmup_cosine_lr(
                         z["peak_lr"], z["warmup"], z["steps"]),
                     batch, z["steps"])
    w = _zoo_launches(cfg, z["steps"], True)
    if run["launches"] != w:
        _fail(f"train {z['arch']}: launches {run['launches']}, want {w}")
    if not run["losses"][-1] < run["losses"][0]:
        _fail(f"train {z['arch']}: the loss did not fall: {run['losses']}")
    add(run["launches"])
    del batch, model
    gc.collect()
    torch.cuda.empty_cache()

    add(wide_attention_train(torch, kd, card))
    add(whisper_train(torch, kd, card))
    add(train_card_vs_cpu(torch, kd, card))
    return launches


def wide_attention_train(torch, kd, card: str) -> dict:
    """Phase 8b: gemma3_4b and pixtral_12b at full width, their depth cut
    (TRAIN_GEMMA3, TRAIN_PIXTRAL): the attention backward at D = 256 and
    160 on its ``wgmma`` instances.  Each run's launches and device
    kernels as the layers say, its loss falling; returns the launches."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.data.synthetic import lm_corpus
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as opt_lib
    launches = {name: 0 for name in kd.LAUNCHES}
    # The params go to the run alone, as zamba2's.
    g3, px = TRAIN_GEMMA3, TRAIN_PIXTRAL
    for spec, opt, lr_fn, seed in (
            (g3, opt_lib.adamw(), opt_lib.warmup_cosine_lr(
                g3["peak_lr"], g3["warmup"], g3["steps"]), 3),
            (px, opt_lib.sgd(momentum=0.9), opt_lib.constant_lr(px["lr"]),
             4)):
        full = get_config(spec["arch"])
        cfg = dc.replace(full, num_layers=spec["layers"])
        model = build_model(cfg)
        tokens = lm_corpus(100_000, vocab=cfg.vocab_size, seed=seed)
        batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(
            lm_batches(tokens, spec["batch"], spec["seq"], seed=seed)).items()}
        if cfg.frontend == "vision":
            batch["patch_embeddings"] = torch.randn(
                (spec["batch"], spec["patches"], cfg.d_model),
                generator=torch.Generator(device="cuda").manual_seed(seed),
                device="cuda")
        run = _train_run(
            torch, kd, f"train {spec['arch']} at {spec['layers']} of "
            f"{full.num_layers} layers", model,
            model.init(torch.Generator(device="cuda").manual_seed(0)), opt,
            lr_fn, batch, spec["steps"])
        w = _zoo_launches(cfg, spec["steps"], True)
        wi = _want_instances(cfg, spec["steps"])
        if run["launches"] != w:
            _fail(f"train {spec['arch']}: launches {run['launches']}, "
                  f"want {w}")
        if run["instances"] != wi:
            _fail(f"train {spec['arch']}: device kernels "
                  f"{run['instances']}, want {wi}")
        # AdamW's first step runs at lr 0 (one warm-up step): its loss
        # repeats once; no step may raise it.
        losses = run["losses"]
        if not (all(b_ <= a_ for a_, b_ in zip(losses, losses[1:]))
                and losses[-1] < losses[0]):
            _fail(f"train {spec['arch']}: the loss did not fall: {losses}")
        print(json.dumps({"train_summary": spec["arch"], "card": card,
                          "layers": cfg.num_layers,
                          "published_layers": full.num_layers,
                          "head_dim": cfg.resolved_head_dim,
                          "params": cfg.param_count(),
                          "mean_step_s": run["mean_step_s"],
                          "peak_memory_gb": run["peak_memory_gb"],
                          "losses": run["losses"]}))
        for k, v in run["launches"].items():
            launches[k] += v
        del batch, model
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def whisper_train(torch, kd, card: str) -> dict:
    """Phase 8b, the audio family: ``make_train_step`` of whisper_base at
    full width and depth (TRAIN_WHISPER: B = 64 × (1,500 seeded N(0, 1)
    frame embeddings + 448 tokens from ``lm_corpus`` / ``lm_batches``),
    AdamW under warmup_cosine_lr, clip 1.0, remat): the attention forward
    and backward at D = 64 on their ``wgmma<64>`` instances, non-causal in
    the encoder and the cross-attention.  Launches and device kernels as
    the layers say, the loss falling; returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.data.synthetic import lm_corpus
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as opt_lib
    w = TRAIN_WHISPER
    cfg = get_config(w["arch"])
    model = build_model(cfg)
    tokens = lm_corpus(200_000, vocab=cfg.vocab_size, seed=5)
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in next(lm_batches(
        tokens, w["batch"], w["seq"], seed=5)).items()}
    batch["frames"] = torch.randn(
        (w["batch"], cfg.num_frontend_tokens, cfg.d_model),
        generator=torch.Generator(device="cuda").manual_seed(5),
        device="cuda")
    run = _train_run(
        torch, kd, f"train {w['arch']}", model,
        model.init(torch.Generator(device="cuda").manual_seed(0)),
        opt_lib.adamw(), opt_lib.warmup_cosine_lr(w["peak_lr"], w["warmup"],
                                                  w["steps"]),
        batch, w["steps"])
    want = _zoo_launches(cfg, w["steps"], True)
    wi = _want_instances(cfg, w["steps"])
    if run["launches"] != want:
        _fail(f"train {w['arch']}: launches {run['launches']}, want {want}")
    if run["instances"] != wi:
        _fail(f"train {w['arch']}: device kernels {run['instances']}, "
              f"want {wi}")
    # The first step runs at lr 0 (one warm-up step): its loss repeats
    # once; no step may raise it.
    losses = run["losses"]
    if not (all(b_ <= a_ for a_, b_ in zip(losses, losses[1:]))
            and losses[-1] < losses[0]):
        _fail(f"train {w['arch']}: the loss did not fall: {losses}")
    print(json.dumps({"train_summary": w["arch"], "card": card,
                      "encoder_layers": cfg.encoder_layers,
                      "decoder_layers": cfg.num_layers,
                      "batch": w["batch"],
                      "frames": cfg.num_frontend_tokens, "text": w["seq"],
                      "mean_step_s": run["mean_step_s"],
                      "positions_per_s": run["positions_per_s"],
                      "peak_memory_gb": run["peak_memory_gb"],
                      "losses": losses}))
    del batch, model
    gc.collect()
    torch.cuda.empty_cache()
    return run["launches"]


def train_card_vs_cpu(torch, kd, card: str) -> dict:
    """Phase 8b: one fp32 step on the card against the CPU at each
    TRAIN_CARD_VS_CPU smoke config, then at each TRAIN_HEAD_DIM_CUTS cut
    in fp32 (one step) and bf16 (the gradients); returns the launches."""
    import dataclasses as dc
    from repro_torch.configs import get_smoke_config
    launches = {name: 0 for name in kd.LAUNCHES}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for arch in TRAIN_CARD_VS_CPU:
        add(_step_card_vs_cpu(torch, kd, dc.replace(
            get_smoke_config(arch), compute_dtype="float32"),
            f"{arch} smoke fp32", card))
    for name, (arch, change) in TRAIN_HEAD_DIM_CUTS.items():
        base = dc.replace(get_smoke_config(arch), **change)
        add(_step_card_vs_cpu(torch, kd, dc.replace(
            base, compute_dtype="float32"), f"{name} fp32", card))
        add(_grads_card_vs_cpu(torch, kd, dc.replace(
            base, compute_dtype="bfloat16"), f"{name} bf16", card))
    # The audio family: one fp32 step at each cut (whisper-smoke's D = 32
    # and the D = 64 cut on the CUDA-core kernels), the bf16 gradients at
    # D = 64 (the wgmma<64> instances).
    for name, change in WHISPER_CUTS:
        base = dc.replace(get_smoke_config(WHISPER), **change)
        add(_step_card_vs_cpu(torch, kd, dc.replace(
            base, compute_dtype="float32"), f"{name} fp32", card))
        if base.resolved_head_dim == 64:
            add(_grads_card_vs_cpu(torch, kd, dc.replace(
                base, compute_dtype="bfloat16"), f"{name} bf16", card))
    return launches


def _cut_batch(torch, cfg):
    """A (2, 64) token batch (labels the tokens shifted) from
    ``default_rng(0)``, a vision config's patch embeddings N(0, 1) ahead
    of it, an audio config's frame embeddings N(0, 1); CPU tensors."""
    import numpy as np
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(np.roll(toks, -1, axis=1))}
    if cfg.frontend is not None:
        key = {"vision": "patch_embeddings", "audio": "frames"}[cfg.frontend]
        batch[key] = torch.from_numpy(rng.normal(
            size=(2, cfg.num_frontend_tokens, cfg.d_model)).astype(
                np.float32))
    return batch


def _step_card_vs_cpu(torch, kd, cfg, label: str, card: str) -> dict:
    """One SGD step of ``cfg`` (fp32 compute) on the card and on the CPU
    (the plain twins) from one init: params within 1e-5, each kernel
    launched as the layers say (the fp32 attention runs the CUDA-core
    kernels).  Returns the card's launches."""
    from repro_torch.models.zoo import build_model
    from repro_torch.train import optimizer as opt_lib
    from repro_torch.train.trainstep import TrainState, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(0))
    cpu_batch = _cut_batch(torch, cfg)
    opt = opt_lib.sgd()
    step = make_train_step(model, opt, opt_lib.constant_lr(0.05))
    kd.reset_launch_counts()
    routes = _attn_instance_counts()
    got, _ = step(TrainState(tree_map(lambda x: x.cuda(), host),
                             opt.init(tree_map(lambda x: x.cuda(), host)),
                             torch.zeros((), dtype=torch.int32,
                                         device="cuda")),
                  {k: v.cuda() for k, v in cpu_batch.items()})
    counts = {k: v for k, v in kd.LAUNCHES.items() if v}
    routes = _attn_instance_counts(routes)
    ref, _ = step(TrainState(host, opt.init(host),
                             torch.zeros((), dtype=torch.int32)),
                  cpu_batch)
    err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        tree_leaves(got.params), tree_leaves(ref.params)))
    w = _zoo_launches(cfg, 1, True)
    print(json.dumps({"train_card_vs_cpu": label, "card": card,
                      "head_dim": cfg.resolved_head_dim,
                      "params_max_abs_err": err, "bar": 1e-5,
                      "launches": counts, "want_launches": w,
                      "device_kernels": routes}))
    if err > 1e-5:
        _fail(f"train step card vs CPU, {label}: params differ by {err} "
              f"> 1e-5")
    if counts != w:
        _fail(f"train step card vs CPU, {label}: launches {counts}, "
              f"want {w}")
    if any("wgmma" in k for k in routes):
        _fail(f"train step card vs CPU, {label}: fp32 reached a bf16 "
              f"kernel: {routes}")
    return counts


def _grads_card_vs_cpu(torch, kd, cfg, label: str, card: str) -> dict:
    """The gradients of ``cfg``'s loss (bf16 compute, remat) on the card
    and on the CPU (the plain twins) from one init: each leaf within
    GRAD_BARS_BF16 (max|Δg| / max|g|, ‖Δg‖ / ‖g‖), the attention through
    the ``wgmma`` instances of the cut's head dim.  Returns the card's
    launches."""
    from torch.func import grad_and_value
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_leaves, tree_map
    model = build_model(cfg)
    host = model.init(torch.Generator().manual_seed(0))
    cpu_batch = _cut_batch(torch, cfg)
    card_batch = {k: v.cuda() for k, v in cpu_batch.items()}

    def grads(params, batch):
        return grad_and_value(lambda p: model.loss(p, batch, remat=True))(
            params)

    kd.reset_launch_counts()
    routes = _attn_instance_counts()
    got, loss = grads(tree_map(lambda x: x.cuda(), host), card_batch)
    torch.cuda.synchronize()
    counts = {k: v for k, v in kd.LAUNCHES.items() if v}
    routes = _attn_instance_counts(routes)
    want, want_loss = grads(host, cpu_batch)
    max_bar, l2_bar = GRAD_BARS_BF16
    worst = [0.0, 0.0]
    for g, w_ in zip(tree_leaves(got), tree_leaves(want)):
        g, w_ = g.float().cpu(), w_.float()
        top = float(w_.abs().max())
        norm = float(torch.linalg.vector_norm(w_))
        if top > 0:
            worst[0] = max(worst[0], float((g - w_).abs().max()) / top)
        if norm > 0:
            worst[1] = max(worst[1], float(torch.linalg.vector_norm(g - w_))
                           / norm)
    w = _zoo_launches(cfg, 1, True)
    wi = _want_instances(cfg, 1)
    ok = worst[0] <= max_bar and worst[1] <= l2_bar
    print(json.dumps({"grads_card_vs_cpu": label, "card": card,
                      "head_dim": cfg.resolved_head_dim,
                      "loss": float(loss), "cpu_loss": float(want_loss),
                      "worst_max_rel": worst[0], "worst_l2_rel": worst[1],
                      "bars": list(GRAD_BARS_BF16), "launches": counts,
                      "want_launches": w, "device_kernels": routes,
                      "want_device_kernels": wi, "ok": ok}))
    if not ok:
        _fail(f"grads card vs CPU, {label}: {worst} past {GRAD_BARS_BF16}")
    if counts != w or routes != wi:
        _fail(f"grads card vs CPU, {label}: launches {counts} / {routes}, "
              f"want {w} / {wi}")
    return counts


# Phase 3's appendix and async paths each run in a process of its own
# (this script with ``--path NAME``), begun with the CLI checks after phase
# 2: both are host-bound FL runs that leave the card idle most of the time,
# so they overlap the main process's phase 3 on the host's other cores.
# Each child zeroes the launch counts before each run and reads them after,
# as in process, and its last line hands its totals to main().
CHILD_PATHS = ("appendix", "async")
PATHS_DIR = ROOT / "build" / "paths"


def _path_child(name: str) -> dict:
    """This script's ``name`` path run to its end in a child process."""
    t0 = time.perf_counter()
    out, err = PATHS_DIR / f"{name}.out", PATHS_DIR / f"{name}.err"
    proc = _popen([sys.executable, str(ROOT / "chip_smoke.py"), "--path",
                   name], out, err)
    try:
        proc.wait(timeout=1000)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    return {"returncode": proc.returncode, "stdout": out.read_text(),
            "stderr": err.read_text(), "seconds": time.perf_counter() - t0}


def _path_launches(name: str, child: _Alongside) -> dict:
    """Waits for the ``name`` path's child, prints its lines, fails with it
    and returns the launches it counted."""
    out = child.result()
    lines = out["stdout"].strip().splitlines()
    last = {}
    if lines and lines[-1].startswith('{"child_launches"'):
        last = json.loads(lines.pop())
    for line in lines:
        print(line)
    print(json.dumps({"part": f"{name}_path (child process)",
                      "seconds": out["seconds"],
                      "exit": out["returncode"]}))
    if out["returncode"] != 0 or "child_launches" not in last:
        _fail(f"the {name} path's process exited {out['returncode']}: "
              f"{out['stderr'][-3000:]}")
    return last["child_launches"]


def _child_main(name: str, torch, port) -> None:
    """``--path NAME``: one of CHILD_PATHS in this process; its lines, then
    ``{"child_launches": {...}}`` as the last line."""
    fn = {"appendix": appendix_path, "async": async_path}[name]
    print(json.dumps({"child_launches": fn(torch, port)}))


def _train_cli_run() -> dict:
    return _run_cli("train", [sys.executable, "-m",
                              "repro_torch.launch.train", *TRAIN_CLI], 600)


def launch_train_path(torch, kd, cli: _Alongside | None = None) -> dict:
    """Phase 8c: ``launch/train`` at full width in process (TRAIN_LAUNCH,
    the host plane's FedDif through the FL client's ``grad_and_value``):
    finite eval losses, the flash_attention backward launched; then the
    CLI once at --smoke as a subprocess (begun here unless ``cli`` already
    holds it), exit 0."""
    from repro_torch.launch.train import run_train
    card = _card_line()
    t = TRAIN_LAUNCH
    lines = []
    kd.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_train(t["arch"], smoke=False, rounds=t["rounds"],
                    clients=t["clients"],
                    steps_per_round=t["steps_per_round"], device="cuda",
                    log=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kd.LAUNCHES.items() if v}
    print(json.dumps({"launch_train": t, "card": card, "seconds": wall,
                      "round_wall_s": res.round_wall_s, "output": lines,
                      "launches": counts}))
    if not all(math.isfinite(x) for x in res.loss) or not counts.get(
            "flash_attention_bwd"):
        _fail(f"launch/train {t['arch']}: losses {res.loss}, launches "
              f"{counts}")
    launches = dict(counts)
    del res
    gc.collect()
    torch.cuda.empty_cache()
    out = (cli or _Alongside(_train_cli_run)).result()
    print(json.dumps({"train_cli": " ".join(TRAIN_CLI), "card": card,
                      "exit": out["returncode"], "seconds": out["seconds"],
                      "output": out["stdout"].strip().splitlines()}))
    if out["returncode"] != 0:
        _fail(f"train CLI exited {out['returncode']}: "
              f"{out['stderr'][-2000:]}")
    return launches


def spmd_path(torch, kd) -> dict:
    """Phase 8d: ``run_spmd_feddif`` (each SPMD_ARCHS smoke config, 4
    clients, 2 rounds) on the card and on the CPU from one init (drawn on
    the CPU): equal ledgers and diffusion rounds, loss histories within
    SPMD_LOSS_BAR, and on the card each layer's forward and backward
    kernels launched once per vmapped fleet step (not once per client)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.fl_spmd import run_spmd_feddif
    from repro_torch.models.zoo import build_model
    launches = {}
    for arch in SPMD_ARCHS:
        model = build_model(get_smoke_config(arch))
        init = model.init(torch.Generator().manual_seed(0))
        runs = {}
        for dev in ("cuda", "cpu"):
            lines = []
            kd.reset_launch_counts()
            t0 = time.perf_counter()
            _, hist, ledger = run_spmd_feddif(
                arch, clients=4, rounds=2, device=dev, log=lines.append,
                init_fn=lambda gen: init)
            runs[dev] = {"history": hist,
                         "seconds": time.perf_counter() - t0,
                         "ledger": [ledger.subframes,
                                    ledger.transmitted_models,
                                    ledger.transmitted_bits],
                         "dif_rounds": [int(ln.split("diffusion_rounds=")[1]
                                            .split()[0]) for ln in lines],
                         "launches": {k: v for k, v in kd.LAUNCHES.items()
                                      if v}}
        card, cpu = runs["cuda"], runs["cpu"]
        steps = sum(1 + r for r in card["dif_rounds"])
        want = _zoo_launches(model.cfg, steps, False)
        gap = max(abs(a - b) for a, b in zip(card["history"],
                                             cpu["history"]))
        print(json.dumps({"spmd_feddif": f"{arch} smoke, 4 clients, 2 rounds",
                          "card": _card_line(), "runs": runs,
                          "loss_gap": gap, "bar": SPMD_LOSS_BAR,
                          "fleet_steps": steps, "want_launches": want}))
        if card["ledger"] != cpu["ledger"] or card["dif_rounds"] != cpu[
                "dif_rounds"]:
            _fail(f"run_spmd_feddif {arch}: the card's ledger "
                  f"{card['ledger']} / rounds differ from the CPU's "
                  f"{cpu['ledger']}")
        if gap > SPMD_LOSS_BAR:
            _fail(f"run_spmd_feddif {arch}: loss histories {gap} apart")
        if card["launches"] != want:
            _fail(f"run_spmd_feddif {arch}: launches {card['launches']}, "
                  f"want {want}")
        for k, v in card["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def train_path(torch, kd, cli: _Alongside | None = None) -> dict:
    """Phase 8 (b)–(d); returns their launches (the main path's).
    ``cli``: (c)'s CLI process, if main() began it earlier."""
    t0 = time.perf_counter()
    launches = {name: 0 for name in kd.LAUNCHES}
    parts = {}
    for name, fn in (("train_step", train_step_path),
                     ("launch_train", lambda torch, kd: launch_train_path(
                         torch, kd, cli)),
                     ("spmd", spmd_path)):
        ts = time.perf_counter()
        for k, v in fn(torch, kd).items():
            launches[k] += v
        parts[name] = time.perf_counter() - ts
    print(json.dumps({"phase": "train_path", "card": _card_line(),
                      "seconds": time.perf_counter() - t0,
                      "part_seconds": parts,
                      "launches": {k: v for k, v in launches.items() if v}}))
    return launches


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
    if sys.argv[1:2] == ["--path"]:
        _child_main(sys.argv[2], torch, port)
        return

    card = _card_line()
    print(f"card: {card}")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}))
    print(json.dumps({"host": _host()}))

    build_s = build.build_all()
    print(json.dumps({"phase": "build", "seconds": build_s,
                      "sources": sorted(build.SOURCES.values())}))
    for name, log in sorted(build.PTXAS_INFO.items()):
        for line in log.splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line or "Performance" in line
                    or "setmaxnreg" in line):
                print(f"ptxas[{name}]: {line.strip()}")
    _check_wgmma_spills(build.PTXAS_INFO.get("flash_attention"))
    _check_bwd_spills(build.PTXAS_INFO.get("flash_attention_bwd"))
    _check_ssd_spills(build.PTXAS_INFO.get("ssd_scan"),
                      build.PTXAS_INFO.get("ssd_scan_bwd"))
    _check_mix_tree_spills(build.PTXAS_INFO.get("mix_aggregate"))

    # Each step's seconds on the host clock, so the script's budget can be
    # split by step; "part" lines split a step.
    t_prev = [time.perf_counter()]
    t_part = [time.perf_counter()]

    def mark(step: str) -> None:
        now = time.perf_counter()
        print(json.dumps({"step": step, "seconds": now - t_prev[0]}))
        t_prev[0] = t_part[0] = now

    def part(name: str) -> None:
        now = time.perf_counter()
        print(json.dumps({"part": name, "seconds": now - t_part[0]}))
        t_part[0] = now

    floor = launch_floor(torch)
    profile_attention_bwd(torch)
    part("profile_attention_bwd")
    rows = check_kernels(torch, kd, kq, kref, port)
    part("check_kernels")
    rows += check_mix_tree(torch, kd, kref, port,
                           torch.Generator(device="cuda").manual_seed(8),
                           floor["ms"])
    part("check_mix_tree")
    rows += check_stc_compress(torch, kref, port)
    mark("phase 2: kernel checks")
    # The CLI checks' processes and phase 3's child paths, begun now (after
    # phase 2's timings) and read by phases 3, 7 and 8.
    atexit.register(_stop_children)
    sigterm = _Alongside(_sigterm_cli_runs)
    serve_cli = _Alongside(_serve_cli_run)
    train_cli = _Alongside(_train_cli_run)
    children = {name: _Alongside(lambda name=name: _path_child(name))
                for name in CHILD_PATHS}
    launches = main_path(torch, kd, port)
    for k, v in hop_plane_path(torch, kd, port).items():
        launches[k] += v
    for k, v in host_plane_path(torch, kd, port).items():
        launches[k] += v
    mark("phase 3: main, hop and host planes")
    for k, v in sweep_path(torch, port).items():
        launches[k] += v
    mark("phase 3: sweeps")
    for k, v in durable_path(torch, port, sigterm).items():
        launches[k] += v
    for name, child in children.items():
        for k, v in _path_launches(name, child).items():
            launches[k] += v
    routing = stc_routing(torch, kd)
    routing.update({k: v for k, v in stc_rows_routing(torch, kd).items()
                    if k.startswith("stc_rows")})
    routing.update({k: v for k, v in quant_routing(torch, kd).items()
                    if k in ("quant_pack", "quant_unpack")})
    routing.update({k: v for k, v in bid_routing(torch, kd).items()
                    if k == "dol_bid_scores"})
    routing["mix_aggregate"] = mix_routing(torch, kd)["mix_aggregate"]
    mark("phase 3: durable, appendix, async and routing")
    card_vs_cpu(torch, port)
    card_vs_cpu(torch, port, "host")
    host_vs_fleet(torch, port)
    lm_card_vs_cpu(torch, port)
    part("card_vs_cpu, host_vs_fleet, lm_card_vs_cpu")
    old_chain_parity(torch, port)
    part("old_chain_parity")
    planners_card_vs_cpu(torch)
    mark("phase 4: parity")
    profile_round(torch, port)
    profile_round(torch, port, strategy="gossip")
    profile_round(torch, port, "jax", VALUE_WEIGHT)
    mark("phase 5: profiles")
    rows += check_lm_kernels(torch, kref)
    part("check_lm_kernels")
    for k, v in zoo_prefill(torch, kd).items():
        launches[k] += v
    part("zoo_prefill")
    for k, v in whisper_prefill(torch, kd).items():
        launches[k] += v
    part("whisper_prefill")
    zoo_card_vs_cpu(torch)
    whisper_card_vs_cpu(torch)
    part("zoo_card_vs_cpu")
    zoo_full_depth(torch)
    mark("phase 6: the zoo's prefill")
    serve_path(torch, kd, serve_cli)
    mark("phase 7: serve")
    rows += check_train_kernels(torch, kref)
    part("check_train_kernels")
    for k, v in train_path(torch, kd, train_cli).items():
        launches[k] += v
    mark("phase 8: training")

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
        "flash_attention_bwd": (
            "flash_attention_bwd.cu",
            "no pallas_call: the reference differentiates its inline XLA "
            "attention (src/repro/models/attention.py:121) with jax.grad"),
        "ssm_scan_bwd": (
            "ssm_scan.cu",
            "no pallas_call: the reference differentiates its inline XLA "
            "scan (src/repro/models/ssm.py:137) with jax.grad"),
        "ssd_scan_bwd": (
            "ssd_scan_bwd.cu",
            "no pallas_call: the reference differentiates its inline XLA "
            "chunked scan (src/repro/models/ssm.py:263) with jax.grad"),
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
    # zamba2's SSD (B, S, H, P, N, chunk) and falcon's scan (B, S, D, N);
    # the backward kernels at the training runs' shapes: qwen3's attention,
    # falcon's scan and zamba2's SSD.
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
                  "ssm_scan": [1, 4096, 8192, 16],
                  "flash_attention_bwd": [2, 4096, 4096, 16, 128],
                  "ssm_scan_bwd": [1, 4096, 8192, 16],
                  "ssd_scan_bwd": [1, 4096, 80, 64, 64, 128]}
    # Kernels that another kernel's wrapper launches in the same call: their
    # launches stand in that kernel's row, whose times cover them all.
    helpers = {"ssd_scan": ("ssd_scan_state", "ssd_scan_pass"),
               "ssd_scan_bwd": ("ssd_scan_bwd_local", "ssd_scan_bwd_pass",
                                "ssd_scan_bwd_main")}
    # Kernels that no main-path run launches, with the kernel that took
    # their work, and the routing check above that drove them (and failed
    # unless they launched as it expects): stc_fused (host plane) and
    # stc_rows_fused (fleet plane) took every FL leaf (n ≤ N_FUSED),
    # quant_roundtrip took both planes' int8 hops, bid_fused the device
    # planner's w1_norm bid rounds, and mix_tree the fleet plane's Eq.
    # 10/11.  bid_value_fuse is on the main path again: the device
    # planner's Appendix-C bid rounds with learning values launch it.
    host_stc = ("stc_fused", "for n <= N_FUSED", "the host-plane STC "
                "routing check's leaves past N_FUSED")
    fleet_stc = ("stc_rows_fused", "for n <= N_FUSED", "the fleet-plane STC "
                 "routing check's leaves past N_FUSED")
    wire = ("quant_roundtrip", "on both planes' int8 hops", "the quant "
            "routing check's pack_rows / unpack_rows call")
    bids = ("bid_fused", "on the device planner's w1_norm bid rounds",
            "the bid routing check's ops.dol_bid_scores call")
    mix = ("mix_tree", "on the fleet plane's MixOps and aggregations",
           "the mix routing check's ops.mix_aggregate call")
    off_path = {"mix_aggregate": mix,
                "dol_bid_scores": bids,
                "stc_reduce": host_stc, "stc_apply": host_stc,
                "stc_rows_reduce": fleet_stc, "stc_rows_apply": fleet_stc,
                "quant_pack": wire, "quant_unpack": wire}
    # The attention rows also carry each device kernel and instance's
    # launches in phase 8b's counted training steps (TRAIN_INSTANCES).
    instance_prefix = {"flash_attention": "flash_attention",
                       "flash_attention_bwd": "fa_bwd"}
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
            **({"instances_phase_8b": {
                k: v for k, v in TRAIN_INSTANCES.items()
                if k.startswith(instance_prefix[name])}}
               if name in instance_prefix else {}),
            **({"routing_launches": routing[name],
                "note": f"0 on the main path: {off_path[name][0]} replaced "
                        f"it {off_path[name][1]}; routing_launches are "
                        f"{off_path[name][2]}"}
               if name in off_path else {}),
            "ok": all(r["ok"] for r in rows if r["name"] == name)})
    print(json.dumps({"host_end": _host()}))
    print(json.dumps({"kernels": summary}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
